"""Single-pass grouped filter+aggregate: program encoding and kernel launch.

A query becomes ONE pass over a ``[C, N]`` column block driven by two small
programs (see ``csrc/group_filter_agg.cu`` for the kernel):

  * a **predicate program** — K predicates, each a range test
    ``lo <= cols[a] < hi`` or a column compare ``cols[a] < cols[b]``, ANDed
    into the row mask;
  * an **aggregate program** — A aggregates, each the product of up to 3
    terms (``c`` / ``1-c`` / ``1+c`` / ``c <= const`` / ``c > const``).

The output is ``[G, A + 1]`` f32: per-group sums of each aggregate over the
passing rows, then their count.  Rows whose key is outside ``[0, G)`` drop
out.  The batched form takes B constant sets that share one opcode
structure and returns ``[B, G, A + 1]``; slot b is bit-equal to the
single-program result on program b.

The opcodes and encoders match the JAX package's
``kernels/group_filter_agg.py`` exactly, so both build the same tables.

The kernel answers all B programs from each staged tile of rows and sums
them on the tensor cores.  The host lays a program out once per structure
and B (:func:`device_program`): which value columns are formed once for
every program and which once per program (:func:`value_columns`, from
``agg_ops`` alone), the passes over the rows that cover them
(:func:`pass_plan`, :func:`plan_words`), the kernel's instantiation
(:func:`slot_tiles`, from B) and the blocks an SM runs
(:func:`blocks_per_sm`, from the structure alone, so that K1 and K2 split
the rows alike).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build

# Predicate opcodes (pred_ops[k, 0]).
PRED_RANGE = 0  # lo <= cols[a] < hi
PRED_LT = 1  # cols[a] < cols[b]

# Aggregate term modes (agg_ops[k, 2*t]).
TERM_NONE = 0  # 1.0 (unused term slot)
TERM_COL = 1  # cols[i]
TERM_ONE_MINUS = 2  # 1 - cols[i]
TERM_ONE_PLUS = 3  # 1 + cols[i]
TERM_LE = 4  # cols[i] <= const  (0/1 indicator)
TERM_GT = 5  # cols[i] > const   (0/1 indicator)

MAX_TERMS = 3
MAX_AGGS = 127

# The open bounds of a range predicate: below and above.
FLOAT_MIN = float(torch.finfo(torch.float32).min)
FLOAT_MAX = float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Program encoding: tiny int/float tables a query builds on the host.
def encode_predicates(preds) -> tuple[torch.Tensor, torch.Tensor]:
    """preds: sequence of ("range", col, lo, hi) | ("lt", col_a, col_b).

    ``lo``/``hi`` may be ``None`` for an open bound.  Returns
    (pred_ops [K, 3] i32, pred_consts [K, 2] f32) on the CPU; K >= 1 (an
    empty program encodes one always-true range predicate on column 0).
    """
    ops, consts = [], []
    for p in preds:
        kind = p[0]
        if kind == "range":
            _, col, lo, hi = p
            ops.append((PRED_RANGE, int(col), 0))
            consts.append((
                FLOAT_MIN if lo is None else float(lo),
                FLOAT_MAX if hi is None else float(hi),
            ))
        elif kind == "lt":
            _, a, b = p
            ops.append((PRED_LT, int(a), int(b)))
            consts.append((0.0, 0.0))
        else:
            raise ValueError(f"unknown predicate kind {kind!r}")
    if not ops:
        ops.append((PRED_RANGE, 0, 0))
        consts.append((FLOAT_MIN, FLOAT_MAX))
    return torch.tensor(ops, dtype=torch.int32), torch.tensor(consts, dtype=torch.float32)


_TERM_CODES = {
    "col": TERM_COL,
    "one_minus": TERM_ONE_MINUS,
    "one_plus": TERM_ONE_PLUS,
    "le": TERM_LE,
    "gt": TERM_GT,
}


def encode_aggregates(aggs) -> tuple[torch.Tensor, torch.Tensor]:
    """aggs: sequence of aggregates; each is a sequence of <= MAX_TERMS terms.

    A term is ("col", i) | ("one_minus", i) | ("one_plus", i)
    | ("le", i, const) | ("gt", i, const).  The aggregate's per-row value is
    the product of its terms.  Returns (agg_ops [A, 2*MAX_TERMS] i32,
    agg_consts [A, MAX_TERMS] f32) on the CPU.
    """
    if not aggs:
        raise ValueError("need at least one aggregate")
    ops = [[0] * (2 * MAX_TERMS) for _ in aggs]
    consts = [[0.0] * MAX_TERMS for _ in aggs]
    for a, terms in enumerate(aggs):
        if not 1 <= len(terms) <= MAX_TERMS:
            raise ValueError(f"aggregate {a}: need 1..{MAX_TERMS} terms, got {len(terms)}")
        for t, term in enumerate(terms):
            kind = _TERM_CODES.get(term[0])
            if kind is None:
                raise ValueError(f"unknown term kind {term[0]!r}")
            ops[a][2 * t] = kind
            ops[a][2 * t + 1] = int(term[1])
            if kind in (TERM_LE, TERM_GT):
                consts[a][t] = float(term[2])
    return torch.tensor(ops, dtype=torch.int32), torch.tensor(consts, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Launch.
#: Columns one program may read: the kernel stages each of them and the keys
#: in shared memory (two stages of 1,028 values an array) beside its sums.
MAX_COLS_READ = 16
#: The scan's blocks (tile strides): at most this many (two an SM of an
#: H100's 132, as many as its shared memory holds for a serving program),
#: or half as many again for a program whose blocks fit three an SM
#: (:func:`blocks_per_sm`), and the partial sums of one program at most
#: this many bytes.
MAX_BLOCKS = 264
PARTIAL_BUDGET_BYTES = 16 << 20
#: The kernel's shared memory, as csrc/group_filter_agg.cu lays it out: two
#: stages of 1,028 values for each column read and the keys, each of the 4
#: row warps' piece columns (132 words each) and memberships (512 words),
#: the predicates and their constants; and the most a block may take for
#: three to fit an SM (228 KB, less 1 KB each and the static arrays).
_STAGE_WORDS, _PIECE_WORDS, _MEMBER_WORDS = 2 * 1028, 132, 512
THREE_AN_SM_BYTES = 72 * 1024
#: One pass of the kernel answers at most this many programs (the bits of a
#: row's membership byte) and groups (its bytes); it forms at most
#: PASS_PIECES bf16 piece columns, and a program slot's sums cover at most
#: PASS_COLUMNS of them (the shared ones and its program's own: the n8 tiles
#: of sums kept in registers).  A wider program takes more passes, each a
#: scan of the block's rows again.
PASS_PROGRAMS = 8
PASS_GROUPS = 8
PASS_PIECES = 24
PASS_COLUMNS = 16
#: bf16 pieces a value takes on the tensor cores: a float's 24 significant
#: bits in three of 8; a column of 0s and 1s in one.
PIECES = 3

_I64, _I32, _PTR = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "group_filter_agg_tile_rows": ([], _I32),
    "group_filter_agg_param_consts": ([], _I32),
    "group_filter_agg_error_string": ([_I32], ctypes.c_char_p),
    "group_filter_agg_launch": (
        [_PTR, _I64, _PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _PTR,
         _I64, _PTR, _PTR], _I32
    ),
}


def used_columns(pred_ops: torch.Tensor, agg_ops: torch.Tensor) -> list[int]:
    """The columns a program reads, sorted: each predicate's column, a
    compare's second column, and the column of every term in use."""
    used = set()
    for kind, a, b in pred_ops.tolist():
        used.update((a, b) if kind == PRED_LT else (a,))
    for row in agg_ops.tolist():
        used.update(row[2 * t + 1] for t in range(MAX_TERMS) if row[2 * t] != TERM_NONE)
    return sorted(used)


def program_words(pred_ops: torch.Tensor, agg_ops: torch.Tensor) -> torch.Tensor:
    """The int32 words the kernel reads: the used columns, then ``pred_ops``
    and ``agg_ops`` with every column field replaced by its index in that
    list (a field the program does not read becomes 0)."""
    used = used_columns(pred_ops, agg_ops)
    slot = {c: i for i, c in enumerate(used)}
    preds = [(kind, slot[a], slot[b] if kind == PRED_LT else 0) for kind, a, b in pred_ops.tolist()]
    aggs = [
        [f for t in range(MAX_TERMS) for f in (row[2 * t], slot[row[2 * t + 1]] if row[2 * t] != TERM_NONE else 0)]
        for row in agg_ops.tolist()
    ]
    words = used + [f for p in preds for f in p] + [f for row in aggs for f in row]
    return torch.tensor(words, dtype=torch.int32)


def value_columns(agg_ops: torch.Tensor) -> tuple[tuple[int, bool], ...]:
    """How the kernel forms each aggregate's per-row values, then the
    count's, from ``agg_ops`` alone: (bf16 pieces, once per program).

    A term that reads a constant (``c <= k``, ``c > k``) makes the column
    one per program, since programs differ only in their constants; any
    other column is formed once for all of them.  A column whose terms are
    all such indicators (or unused) holds only 0 and 1, exact in one bf16
    piece; any other takes :data:`PIECES`.  The count is 1 on every row."""
    out = []
    for row in agg_ops.tolist():
        modes = {row[2 * t] for t in range(MAX_TERMS)}
        per_program = bool(modes & {TERM_LE, TERM_GT})
        out.append((1 if modes <= {TERM_NONE, TERM_LE, TERM_GT} else PIECES, per_program))
    out.append((1, False))
    return tuple(out)


def pass_plan(columns, num_groups: int, num_programs: int) -> list[tuple[int, int, list[tuple[int, int, int]]]]:
    """The kernel's passes: (group octet, program octet, instances), each
    instance (column j, program within the octet or -1 for all, pieces).
    A pass covers one octet of groups and one of programs, forms at most
    :data:`PASS_PIECES` piece columns, and gives each m16 tile of the
    kernel's sums (programs 2t and 2t + 1) at most :data:`PASS_COLUMNS`: the
    shared ones and those of its two programs.  No column is split across
    passes."""
    passes = []
    for q in range(-(-num_groups // PASS_GROUPS)):
        for o in range(-(-num_programs // PASS_PROGRAMS)):
            nb = min(PASS_PROGRAMS, num_programs - o * PASS_PROGRAMS)
            insts = [(j, bl, pieces) for j, (pieces, per_program) in enumerate(columns)
                     for bl in (range(nb) if per_program else (-1,))]
            chunk, own = [], [0] * (PASS_PROGRAMS + 1)  # own[-1]: the shared pieces
            for j, bl, pieces in insts:
                grown = own.copy()
                grown[bl] += pieces
                width = grown[-1] + max(grown[2 * t] + grown[2 * t + 1] for t in range(PASS_PROGRAMS // 2))
                if chunk and (width > PASS_COLUMNS or sum(grown) > PASS_PIECES):
                    passes.append((q, o, chunk))
                    chunk, grown = [], [0] * (PASS_PROGRAMS + 1)
                    grown[bl] += pieces
                chunk.append((j, bl, pieces))
                own = grown
            passes.append((q, o, chunk))
    return passes


def plan_words(passes, num_aggs: int, num_groups: int) -> tuple[list[int], int]:
    """The int32 words of a :func:`pass_plan` the kernel reads, and the n8
    tiles of piece columns the widest pass forms.

    For each pass 8 words: group octet, program octet, where its instance
    words start and how many, (n8 tiles of a slot's columns | 16 if some
    column is one program's | 32 where the program has one group and no
    column of one program's, so an m16 tile's rows are its programs), where
    its list of aggregates
    starts, (how many | how many of them are shared << 16), where its
    column rows start.  An instance word
    holds its column j (``num_aggs``: the count), program + 1 (0: every
    program), pieces, first piece column, the first of its columns among a
    slot's, and, at an aggregate's first column, how many columns the
    aggregate has (one a program of the pass, or one).  The list of
    aggregates gives the instance where each starts, the shared ones first
    (the kernel forms them in one loop of the same code); the count and any
    aggregate of no term, 1 on every row, are not listed.  The column rows
    give, for each m16 tile (programs 2t and 2t + 1) and each of its
    :data:`PASS_COLUMNS` columns, the piece column it reads: the shared
    ones, then program 2t's, then program 2t + 1's (one byte each)."""
    heads, insts_w, groups_w, rows_w, tiles = [], [], [], [], 1
    # One group and no column of one program's: every pass lays its programs
    # on one m16 tile's rows.
    one = num_groups == 1 and all(bl < 0 for _, _, insts in passes for _, bl, _ in insts)
    for q, o, insts in passes:
        shared, own = 0, [0] * PASS_PROGRAMS
        for _, bl, pieces in insts:
            if bl < 0:
                shared += pieces
            else:
                own[bl] += pieces
        pairs = PASS_PROGRAMS // 2
        width = max([shared] + [shared + own[2 * t] + own[2 * t + 1] for t in range(pairs)])
        rows = [0] * (pairs * PASS_COLUMNS)
        shape = -(-width // 8) | (16 if width > shared else 0) | (32 if one else 0)
        heads.append([q, o, len(insts_w), len(insts), shape, len(groups_w), 0, len(rows_w)])
        at_shared, at, col, firsts = 0, [0] * PASS_PROGRAMS, 0, ([], [])
        for i, (j, bl, pieces) in enumerate(insts):
            if bl < 0:
                vc0, at_shared = at_shared, at_shared + pieces
            else:
                vc0 = shared + (own[bl - 1] if bl & 1 else 0) + at[bl]
                at[bl] += pieces
            length = 0
            if i == 0 or insts[i - 1][0] != j:
                while i + length < len(insts) and insts[i + length][0] == j:
                    length += 1
                if j != num_aggs and not (bl < 0 and pieces == 1):  # the count and aggregates of no term are 1s
                    firsts[bl >= 0].append(i)
            insts_w.append(j | (bl + 1) << 8 | pieces << 12 | col << 16 | vc0 << 21 | length << 26)
            for x in range(pieces):
                for t in range(pairs):
                    if bl < 0 or t == bl // 2:
                        rows[t * PASS_COLUMNS + vc0 + x] = col + x
            col += pieces
        groups_w += firsts[0] + firsts[1]
        heads[-1][6] = len(firsts[0]) + len(firsts[1]) | len(firsts[0]) << 16
        rows_w += [int.from_bytes(bytes(rows[i:i + 4]), "little") for i in range(0, len(rows), 4)]
        tiles = max(tiles, -(-col // 8))
    at_insts = 8 * len(heads)
    at_groups = at_insts + len(insts_w)
    at_rows = at_groups + len(groups_w)
    for h in heads:
        h[2] += at_insts
        h[5] += at_groups
        h[7] += at_rows
    return [w for h in heads for w in h] + insts_w + groups_w + rows_w, tiles


def slot_tiles(passes, words, num_programs: int) -> int:
    """The m16 tiles of programs (two each) that the kernel's instantiation
    computes in every pass of ``passes`` (their :func:`plan_words`): the
    fewest of 1, 2 and ``PASS_PROGRAMS // 2`` that hold the widest pass.  A
    pass whose programs are one tile's rows (one group) takes one.  It
    depends on the number of programs, never on their constants."""
    widest = 1
    for p, (_, o, _) in enumerate(passes):
        if not words[8 * p + 4] & 32:
            widest = max(widest, -(-min(PASS_PROGRAMS, num_programs - PASS_PROGRAMS * o) // 2))
    return widest if widest <= 2 else PASS_PROGRAMS // 2


def sharing(columns, num_programs: int) -> dict[str, int]:
    """What one launch adds to ``kernels.ops.SHARED_TILE``: the program
    slots answered from each staged tile, and the value columns formed once
    for all of them against those formed for each program."""
    once = sum(1 for _, per_program in columns if not per_program)
    return {"slots": num_programs, "columns_once": once,
            "columns_per_program": (len(columns) - once) * num_programs}


def smem_bytes(used: int, num_preds: int, col_tiles: int) -> int:
    """The kernel's dynamic shared memory for a program (``smem_bytes`` in
    the source)."""
    return 4 * (_STAGE_WORDS * (used + 1) + 4 * (col_tiles * 8 * _PIECE_WORDS + _MEMBER_WORDS)
                + (4 + 2 * PASS_PROGRAMS) * num_preds)


def blocks_per_sm(one_tile: bool, used: int, num_preds: int, col_tiles: int) -> int:
    """Blocks of the scan an SM runs at once: three where the kernel's
    one-tile instantiation runs every launch of the program, whatever its
    number of programs (one group, no column of one program's), and its
    shared memory fits three; else two."""
    return 3 if one_tile and smem_bytes(used, num_preds, col_tiles) <= THREE_AN_SM_BYTES else 2


def grid_blocks(n: int, num_groups: int, num_aggs: int, tile_rows: int, per_sm: int = 2) -> int:
    """Blocks of the scan: one a tile, at most MAX_BLOCKS (half as many
    again at three an SM) and at most PARTIAL_BUDGET_BYTES of one program's
    partial sums.  It depends on the rows and the program's structure only,
    never on the number of programs, so K1 and K2 split the rows alike."""
    tiles = -(-n // tile_rows)
    cap = min(MAX_BLOCKS * per_sm // 2, PARTIAL_BUDGET_BYTES // (num_groups * (num_aggs + 1) * 4))
    return max(1, min(tiles, cap))


def _check_ops(num_cols: int, pred_ops: torch.Tensor, agg_ops: torch.Tensor, num_groups: int) -> None:
    k, a = pred_ops.shape[0], agg_ops.shape[0]
    if pred_ops.shape != (k, 3) or k < 1:
        raise ValueError(f"pred_ops must be [K>=1, 3], got {tuple(pred_ops.shape)}")
    if agg_ops.shape != (a, 2 * MAX_TERMS) or not 1 <= a <= MAX_AGGS:
        raise ValueError(f"agg_ops must be [1..{MAX_AGGS}, {2 * MAX_TERMS}], got {tuple(agg_ops.shape)}")
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    if not set(pred_ops[:, 0].tolist()) <= {PRED_RANGE, PRED_LT}:
        raise ValueError("unknown predicate opcode")
    if not set(agg_ops[:, 0::2].reshape(-1).tolist()) <= set(range(TERM_GT + 1)):
        raise ValueError("unknown term mode")
    col_fields = [c for row in pred_ops.tolist() for c in row[1:]]
    col_fields += [c for row in agg_ops.tolist() for c in row[1::2]]
    if not all(0 <= c < num_cols for c in col_fields):
        raise ValueError(f"program refers to a column outside [0, {num_cols})")
    if len(used_columns(pred_ops, agg_ops)) > MAX_COLS_READ:
        raise ValueError(f"program reads more than {MAX_COLS_READ} columns")


def _check_consts(pred_ops, pred_consts, agg_ops, agg_consts) -> None:
    k, a, b = pred_ops.shape[0], agg_ops.shape[0], pred_consts.shape[0]
    if pred_consts.shape != (b, k, 2) or agg_consts.shape != (b, a, MAX_TERMS) or b < 1:
        raise ValueError(
            f"consts must be [B, {k}, 2] and [B, {a}, {MAX_TERMS}], got "
            f"{tuple(pred_consts.shape)} and {tuple(agg_consts.shape)}"
        )


def check_program(
    num_cols: int,
    pred_ops: torch.Tensor,
    pred_consts: torch.Tensor,
    agg_ops: torch.Tensor,
    agg_consts: torch.Tensor,
    num_groups: int,
) -> None:
    """Raise on a program the kernel does not take.

    ``pred_consts``/``agg_consts`` carry a leading program dimension here
    (``[B, K, 2]`` / ``[B, A, MAX_TERMS]``).  Column indices are read on the
    host, so they must lie in ``[0, num_cols)``; at most MAX_COLS_READ
    distinct columns may be read, and every opcode must be one the encoders
    write.
    """
    _check_ops(num_cols, pred_ops, agg_ops, num_groups)
    _check_consts(pred_ops, pred_consts, agg_ops, agg_consts)


def _to_card(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor goes through pinned memory with an
    asynchronous copy, so the host does not wait for the stream."""
    return t if t.device == device else t.pin_memory().to(device, non_blocking=True)


class Program(NamedTuple):
    """A checked program on a device, for B programs of its structure."""

    words: torch.Tensor  # program_words, on the device
    used: int  # columns read
    plan: torch.Tensor  # plan_words of its passes, on the device
    passes: int
    col_tiles: int  # n8 tiles of piece columns of the widest pass
    slot_tiles: int  # m16 tiles of programs of the kernel's instantiation (slot_tiles())
    per_sm: int  # blocks an SM runs at once (blocks_per_sm())
    shared: dict[str, int]  # what a launch adds to kernels.ops.SHARED_TILE


# The checked, rewritten program on each device, by the ops' contents and
# the number of programs (a serving plan reuses its ops for every request).
_PROGRAMS: dict[tuple, Program] = {}
_MAX_PROGRAMS = 1024


def device_program(device, num_cols: int, pred_ops: torch.Tensor, agg_ops: torch.Tensor, num_groups: int,
                   num_programs: int = 1) -> Program:
    """The :class:`Program` of ``num_programs`` constant sets on ``pred_ops``
    and ``agg_ops``: checked, laid out (:func:`value_columns`,
    :func:`pass_plan`) and copied once per program structure, number of
    programs and device."""
    po = pred_ops.cpu().to(torch.int32).contiguous()
    ao = agg_ops.cpu().to(torch.int32).contiguous()
    key = (str(device), num_cols, num_groups, num_programs, tuple(po.shape), tuple(ao.shape),
           po.numpy().tobytes(), ao.numpy().tobytes())
    hit = _PROGRAMS.get(key)
    if hit is None:
        _check_ops(num_cols, po, ao, num_groups)
        if len(_PROGRAMS) >= _MAX_PROGRAMS:
            _PROGRAMS.clear()
        columns = value_columns(ao)
        passes = pass_plan(columns, num_groups, num_programs)
        words, col_tiles = plan_words(passes, ao.shape[0], num_groups)
        used = len(used_columns(po, ao))
        one_tile = bool(words[4] & 32)  # every pass lays its programs on one tile's rows
        hit = _PROGRAMS[key] = Program(
            _to_card(program_words(po, ao), device), used,
            _to_card(torch.tensor(words, dtype=torch.int32), device), len(passes), col_tiles,
            slot_tiles(passes, words, num_programs), blocks_per_sm(one_tile, used, po.shape[0], col_tiles),
            sharing(columns, num_programs))
    return hit


def pack_rows(rows, num_preds: int) -> np.ndarray:
    """B programs' constants as the kernel reads them, from one flat row a
    program (its ``pred_consts`` [K, 2], then its ``agg_consts``
    [A, MAX_TERMS], each row-major): one C-contiguous float32 array,
    ``pred_consts`` [B, K, 2] ravelled and then ``agg_consts``
    [B, A, MAX_TERMS] ravelled."""
    s = 2 * num_preds
    return np.array([c for r in rows for c in r[:s]] + [c for r in rows for c in r[s:]], dtype=np.float32)


def pack(pred_ops: torch.Tensor, pred_consts: torch.Tensor, agg_ops: torch.Tensor, agg_consts: torch.Tensor):
    """The reference's constants of B programs on ``pred_ops``/``agg_ops``,
    ``pred_consts`` [B, K, 2] and ``agg_consts`` [B, A, MAX_TERMS], joined
    as :func:`pack_rows` lays them out: a float32 numpy array where both are
    on the host, else a float32 tensor on their device.  The one place the
    pair becomes the kernel's format (:func:`unpack` the one place it is
    split again)."""
    _check_consts(pred_ops, pred_consts, agg_ops, agg_consts)
    if pred_consts.is_cpu and agg_consts.is_cpu:
        return np.concatenate((pred_consts.numpy().reshape(-1), agg_consts.numpy().reshape(-1)), dtype=np.float32)
    return torch.cat((pred_consts.reshape(-1), agg_consts.reshape(-1))).to(torch.float32)


def packed_programs(packed, num_preds: int, num_aggs: int, device: torch.device | None = None) -> int:
    """The programs whose constants ``packed`` holds (:func:`pack`'s
    layout); raises unless it is a C-contiguous float32 numpy array, or,
    given ``device``, a contiguous float32 1-D tensor on it, of whole
    programs, at least one."""
    width = 2 * num_preds + MAX_TERMS * num_aggs
    if isinstance(packed, torch.Tensor):
        ok = (packed.device == device and packed.dtype == torch.float32 and packed.dim() == 1
              and packed.is_contiguous())
    else:
        ok = (isinstance(packed, np.ndarray) and packed.dtype == np.float32 and packed.ndim == 1
              and packed.flags.c_contiguous)
    if not ok or len(packed) < width or len(packed) % width:
        raise ValueError(f"packed constants must be a C-contiguous float32 array, or a contiguous float32 "
                         f"1-D tensor on the columns' device, of B * {width} values, B >= 1")
    return len(packed) // width


def unpack(packed, num_preds: int, num_aggs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``pred_consts`` [B, K, 2] and ``agg_consts`` [B, A, MAX_TERMS] of
    packed constants (:func:`pack`), as tensors that share its memory."""
    on_device = isinstance(packed, torch.Tensor)
    b = packed_programs(packed, num_preds, num_aggs, packed.device if on_device else None)
    flat = packed if on_device else torch.from_numpy(packed)
    split = 2 * num_preds * b
    return flat[:split].view(b, num_preds, 2), flat[split:].view(b, num_aggs, MAX_TERMS)


def launch(
    cols: torch.Tensor,  # [C, N] f32 on a CUDA device, rows contiguous
    keys: torch.Tensor,  # [N] or [1, N] i32
    pred_ops: torch.Tensor,  # [K, 3] i32 (host)
    agg_ops: torch.Tensor,  # [A, 6] i32 (host)
    consts,  # B programs' constants as pack() lays them out: host numpy array or tensor on cols' device
    num_groups: int,
) -> tuple[torch.Tensor, Program]:
    """Run the CUDA kernel on B programs' constants (:func:`pack`'s format,
    B read from its size); returns ``[B, num_groups, A + 1]`` f32 on cols'
    device, and the :class:`Program` it ran.  Host constants travel in the
    launch's parameters where they fit, else by one pinned copy to the
    card; constants on the card by pointer."""
    if cols.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA tensor, got {cols.device}")
    if cols.dtype != torch.float32 or cols.dim() != 2:
        raise ValueError(f"cols must be [C, N] float32, got {tuple(cols.shape)} {cols.dtype}")
    c, n = cols.shape
    keys = keys.reshape(-1)
    if keys.device != cols.device or keys.dtype != torch.int32 or keys.numel() != n:
        raise ValueError("keys must be int32 with one entry per row, on cols' device")
    if cols.stride(1) != 1 or (c > 1 and cols.stride(0) < n):
        cols = cols.contiguous()  # the kernel takes any row stride, not a column stride
    k, a = pred_ops.shape[0], agg_ops.shape[0]
    b = packed_programs(consts, k, a, cols.device)
    prog = device_program(cols.device, c, pred_ops, agg_ops, num_groups, b)
    lib = build.bind("group_filter_agg", _SIGNATURES)
    if isinstance(consts, np.ndarray) and consts.size > _limits(lib)[1]:
        consts = _to_card(torch.from_numpy(consts), cols.device)
    return call(lib, cols, keys.contiguous(), prog, consts, k, a, b, num_groups), prog


def _limits(lib) -> tuple[int, int]:
    """(rows of a tile, constants that travel by value) of a built library."""
    if not hasattr(lib, "_gfa_limits"):
        lib._gfa_limits = (lib.group_filter_agg_tile_rows(), lib.group_filter_agg_param_consts())
    return lib._gfa_limits


def call(lib, cols, keys, prog: Program, consts, k, a, b, num_groups) -> torch.Tensor:
    """One launch of ``lib``'s ``group_filter_agg_launch`` on inputs
    :func:`launch` has checked and put on the card (``prog`` laid out for
    ``b`` programs), the constants a float32 numpy array (by value, in the
    launch's parameters) or a tensor on the card (by pointer).  The grid is
    :func:`grid_blocks`: the B programs share its blocks."""
    n = cols.shape[1]
    blocks = grid_blocks(n, num_groups, a, _limits(lib)[0], prog.per_sm)
    slots = num_groups * (a + 1)
    partials = torch.empty(blocks * b * slots, dtype=torch.float32, device=cols.device)
    out = torch.empty((b, num_groups, a + 1), dtype=torch.float32, device=cols.device)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    by_value = isinstance(consts, np.ndarray)
    err = lib.group_filter_agg_launch(
        cols.data_ptr(), cols.stride(0), keys.data_ptr(), n, prog.words.data_ptr(), prog.plan.data_ptr(),
        None if by_value else consts.data_ptr(), consts.ctypes.data if by_value else None,
        prog.used, k, a, num_groups, b, prog.passes, prog.col_tiles, prog.slot_tiles, partials.data_ptr(), blocks,
        out.data_ptr(), stream,
    )
    build.check_launch(lib, "group_filter_agg", err)
    return out
