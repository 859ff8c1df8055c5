"""Columnar tables for the mini query engine, over torch tensors.

A Table is a frozen mapping column-name -> 1-D tensor, all the same length
and on one device.  Dictionary-encoded categoricals (int32 codes) and f32
decimals stand in for strings and fixed-point numbers, as in the JAX
package's ``engine/table.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch


@dataclass(frozen=True)
class Table:
    columns: dict[str, torch.Tensor]

    def __post_init__(self):
        lens = {k: v.shape[0] for k, v in self.columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged columns: {lens}")

    @classmethod
    def from_numpy(cls, columns: Mapping[str, np.ndarray], device: str | torch.device = "cuda") -> "Table":
        """A Table holding a copy of each numpy column on ``device``.

        This is how data made elsewhere (for example by the JAX package,
        ``np.asarray`` of each column) comes into the port unchanged.
        """
        return cls({n: torch.as_tensor(np.array(v), device=device) for n, v in columns.items()})

    # -- accessors -------------------------------------------------------------
    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    @property
    def num_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0] if self.columns else 0

    @property
    def names(self) -> list[str]:
        return sorted(self.columns)

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.columns.values())

    # -- construction ----------------------------------------------------------
    def with_columns(self, **cols: torch.Tensor) -> "Table":
        return Table({**self.columns, **cols})

    def select(self, *names: str) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def take(self, idx: torch.Tensor) -> "Table":
        idx = idx.long()
        return Table({n: c.index_select(0, idx) for n, c in self.columns.items()})

    def slice_rows(self, start: int, size: int) -> "Table":
        return Table({n: c.narrow(0, start, size) for n, c in self.columns.items()})

    def to(self, device: str | torch.device, non_blocking: bool = False) -> "Table":
        return Table({n: c.to(device, non_blocking=non_blocking) for n, c in self.columns.items()})

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.dtype}" for n, c in sorted(self.columns.items()))
        return f"Table[{self.num_rows} rows]({cols})"


def concat(tables: list[Table]) -> Table:
    names = tables[0].names
    return Table({n: torch.cat([t[n] for t in tables]) for n in names})
