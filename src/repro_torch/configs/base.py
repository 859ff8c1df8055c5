"""Architecture configs and input shape sets (the port's copy of the JAX
package's ``configs/base.py``).

Every architecture is a frozen `ArchConfig`, with the same fields and
defaults as the reference's.  `ARCHS` is the registry, the reference's ten
configurations; `get_arch` raises for any other name.  `tiny()` derives the reduced config
the CPU tests use.  `SHAPES` defines the four input-shape cells; `cells_for`
says which an arch takes.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class LayerKind:
    """One position of the repeating layer pattern."""

    mixer: str  # "attn" | "mamba"
    ffn: str  # "dense" | "moe" | "none"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    source: str = ""

    # layer pattern: repeating unit; len(pattern) * n_repeats + first_k_dense == n_layers
    pattern: tuple[LayerKind, ...] = (LayerKind("attn", "dense"),)
    first_k_dense: int = 0  # leading dense-attention layers outside the repeating unit

    # MoE (models/moe.py).  moe_groups dispatches the tokens in G groups, as
    # the reference does; moe_group_axis names the reference's mesh axis for
    # those groups and means nothing on one card: the port accepts it and
    # reads it nowhere.
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1
    moe_group_axis: str = ""

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # misc architecture knobs
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    rope: str = "rope"  # rope | mrope | none
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    rope_theta: float = 10_000.0
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    embed_inputs: bool = True  # False: model consumes precomputed embeddings
    logit_softcap: float = 0.0
    max_seq_len: int = 131_072

    # Distribution and memory knobs.  The port reads the dtypes, remat (the
    # body's repeating unit under torch.utils.checkpoint), fsdp and
    # zero3_gather (launch/mesh's rules and the dry run); unroll_layers means
    # nothing to its Python layer loop, which is always unrolled.
    fsdp: bool = False
    optimizer: str = "adamw"  # adamw | adafactor
    remat: str = "none"  # none | full | dots
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    unroll_layers: bool = False
    ce_vocab_chunk: int = 0
    zero3_gather: bool = False

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the reference pads it.
        Real token ids stay < vocab_size; padding columns ride in softmax."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return all(k.mixer != "attn" for k in self.pattern) and self.first_k_dense == 0

    @property
    def has_subquadratic_path(self) -> bool:
        """True if long-context decode is feasible (ssm / hybrid / linear attn)."""
        return any(k.mixer == "mamba" for k in self.pattern)

    @property
    def n_repeats(self) -> int:
        body = self.n_layers - self.first_k_dense
        if body % len(self.pattern):
            raise ValueError(f"{self.name}: {body} body layers do not divide into the pattern of {len(self.pattern)}")
        return body // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * (hq * dh) + 2 * d * (hkv * dh) + (hq * dh) * d
        dense_ffn = 3 * d * f if self.act == "swiglu" else 2 * d * f
        moe_ffn = self.n_experts * 3 * d * f + d * self.n_experts  # + router
        moe_ffn += self.n_shared_experts * 3 * d * f
        mamba = (
            d * (2 * self.d_inner + 2 * self.ssm_state + self.n_ssm_heads)
            + self.d_inner * d
            + self.ssm_conv * (self.d_inner + 2 * self.ssm_state)
            + 2 * self.n_ssm_heads
            + self.d_inner
        )
        total = 0
        kinds = [LayerKind("attn", "dense")] * self.first_k_dense + list(self.pattern) * self.n_repeats
        for k in kinds:
            total += attn if k.mixer == "attn" else mamba
            total += {"dense": dense_ffn, "moe": moe_ffn, "none": 0}[k.ffn]
            total += 2 * d  # two norms (approx; non-param LN counted anyway)
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.encoder_decoder:
            enc = self.n_encoder_layers * (attn + dense_ffn + 2 * d)
            xattn = self.n_layers * (attn + d)  # cross-attn per decoder layer
            total += enc + xattn
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only the routed experts)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * 3 * d * f
        n_moe_layers = sum(1 for k in self.pattern if k.ffn == "moe") * self.n_repeats
        return self.n_params() - n_moe_layers * inactive


# ---------------------------------------------------------------------------
# Input shape cells: seq_len x global_batch
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cells_for(cfg: ArchConfig) -> list[str]:
    """The shape cells an arch takes: long_500k only where decode is
    sub-quadratic (an SSM or hybrid), as the reference decides."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.has_subquadratic_path:
        cells.append("long_500k")
    return cells


# ---------------------------------------------------------------------------
ARCHS: dict[str, str] = {  # arch id -> module defining CONFIG
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).CONFIG


def all_archs() -> list[str]:
    return sorted(ARCHS)


def tiny(cfg: ArchConfig, **overrides: Any) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (the reference's)."""
    changes: dict[str, Any] = dict(
        n_layers=len(cfg.pattern) + cfg.first_k_dense,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        max_seq_len=512,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.is_moe:
        changes.update(n_experts=4, experts_per_token=2)
    if cfg.rope == "mrope":
        changes.update(mrope_sections=(2, 3, 3))  # sums to d_head//2 = 8
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8)
    if cfg.encoder_decoder:
        changes.update(n_encoder_layers=1)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
