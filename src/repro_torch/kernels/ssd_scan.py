"""Mamba2 SSD intra-chunk step (K8): launch of ``csrc/ssd_intra.cu``.

For every chunk of Q steps: ``y = (C B^T * decay * dt) x`` (causal within
the chunk) and the chunk's outgoing state ``[P, N]``, in float32 from x/B/C
in float32 or bfloat16.  Counterpart of the JAX package's
``kernels/ssd_scan.py``; the inter-chunk recurrence stays with the caller
(``models/ssm.ssd_chunked``), as it stays outside the Pallas kernel.

bfloat16 inputs run the tensor-core kernel, float32 inputs the CUDA-core
kernel (see the source's note).  The tensor-core kernel stages C and B
``chunk_width(Q, P, N)`` columns of N at a time; the CUDA-core kernel takes
``f32_block_heads(H, S / Q)`` heads a block and stages N in slices of
``F32_N_SLICE`` columns (``f32_smem_bytes`` mirrors its shared memory).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I32, _PTR = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "ssd_intra_error_string": ([_I32], ctypes.c_char_p),
    "ssd_intra_launch": (
        [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _PTR], _I32
    ),
}
#: The kernel's input types (x, B and C alike) and their codes in ``ssd_intra_launch``.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256
MAX_HEAD_DIM = 128
#: Shared memory the tensor-core kernel's block may take when the wrapper
#: sizes its N slice, and the most heads a block holds (``kTcHeads`` in the
#: source is 4; ``chip_variants.py`` builds copies with 1, 2 and 8).
SMEM_BUDGET = 224 * 1024
MAX_BLOCK_HEADS = 8


#: The CUDA-core (float32) kernel's constants (``kFT``, ``kFNS``,
#: ``kFMPitch``, ``kFMaxHeads`` and ``kFSlots`` in the source): steps of a
#: tile, N columns of a staged slice of B or C (and floats of its rows),
#: floats of a row of M^T, the most heads a block takes, and the blocks an
#: H100 holds at once (132 SMs x 2).
F32_TILE = 64
F32_N_SLICE = 128
F32_M_PITCH = 68
F32_MAX_BLOCK_HEADS = 16
F32_SLOTS = 264


def f32_block_heads(h: int, nc: int) -> int:
    """Heads a block of the CUDA-core kernel takes, from H and the chunks of a
    sequence alone (never B): the count that minimises the card's waves times
    a block's work, a head weighing 3 and the block's C B^T 2."""
    best, best_cost = 1, None
    for k in range(1, min(F32_MAX_BLOCK_HEADS, h) + 1):
        cost = -(-(-(-h // k) * nc) // F32_SLOTS) * (3 * k + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = k, cost
    return best


def f32_smem_bytes(q: int, p: int, heads: int) -> int:
    """Shared memory of one block of the CUDA-core kernel: B ``[64, 128]``; a
    region holding C ``[64, 128]``, or M^T ``[64, 68]`` then x * seg ``[64,
    Pt]``; two x buffers ``[64, Pt]``; dt, lcum and seg ``[heads, Qp]`` (Pt =
    64 for P <= 64, else 128; Qp = Q rounded up to 64).  N does not enter:
    B and C rows are 128 floats, N wider than that goes in slices."""
    pt = 64 if p <= 64 else 128
    qp = -(-q // F32_TILE) * F32_TILE
    region = max(F32_N_SLICE, F32_M_PITCH + pt)
    return 4 * (F32_TILE * F32_N_SLICE + F32_TILE * region + 2 * F32_TILE * pt + 3 * heads * qp)


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def smem_bytes(q: int, p: int, chunk_n: int) -> int:
    """Shared memory of one block of the tensor-core kernel (``tc_smem_bytes``
    in the source) at most: C and B ``[Qp, chunk_n + 8]`` bf16, a ring of two
    x buffers ``[Qp, Pp + 8]`` bf16, lcum, dt and seg ``[MAX_BLOCK_HEADS,
    Qp]`` f32 (Qp, Pp: Q and P rounded up to 16; 8 elements of padding a
    row) and the 4 warps' store tiles ``[16, 72]`` f32."""
    qp = _round16(q)
    return 4 * qp * (chunk_n + 8) + 4 * qp * (_round16(p) + 8) + 12 * MAX_BLOCK_HEADS * qp + 64 * 4 * 72


def chunk_width(q: int, p: int, n: int) -> int:
    """Columns of N the tensor-core kernel stages at a time: all of N rounded
    up to 16 where the block's shared memory stays within ``SMEM_BUDGET``,
    else the widest multiple of 16 that does (at least 16)."""
    qp = _round16(q)
    room = (SMEM_BUDGET - smem_bytes(q, p, 0) + 32 * qp) // (4 * qp) - 8
    return max(16, min(_round16(n), room // 16 * 16))


def check_shapes(x, bmat, cmat, dt, a, chunk: int) -> int:
    """Raise on shapes the kernel does not take (any device); returns Q."""
    if x.dim() != 4 or bmat.dim() != 3 or bmat.shape != cmat.shape:
        raise ValueError(f"need x [B, S, H, P] and B, C [B, S, N], got "
                         f"{tuple(x.shape)}, {tuple(bmat.shape)}, {tuple(cmat.shape)}")
    b, s, h, _ = x.shape
    if tuple(bmat.shape[:2]) != (b, s) or tuple(dt.shape) != (b, s, h) or tuple(a.shape) != (h,):
        raise ValueError(f"B/C [B, S, N], dt [B, S, H] and a [H] must match x {tuple(x.shape)}: "
                         f"{tuple(bmat.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}")
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"S = {s} must be a multiple of the chunk Q = {q}")
    return q


def launch(x, bmat, cmat, dt, a, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel; returns (y [B, S, H, P] f32, states [B, nc, H, P, N] f32)."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (bmat, cmat, dt, a)):
        raise ValueError(f"the kernel runs on CUDA tensors of one device, got {x.device}, "
                         f"{bmat.device}, {cmat.device}, {dt.device}, {a.device}")
    if x.dtype not in DTYPES or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise ValueError(f"x, B and C must all be float32 or bfloat16, got {x.dtype}, {bmat.dtype}, {cmat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt and a must be float32, got {dt.dtype}, {a.dtype}")
    q = check_shapes(x, bmat, cmat, dt, a, chunk)
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if q > MAX_CHUNK or p > MAX_HEAD_DIM or s // q > 65535 or b > 65535:
        raise ValueError(f"shape out of the kernel's range: Q={q} (<= {MAX_CHUNK}), P={p} (<= {MAX_HEAD_DIM}), "
                         f"S={s}, B={b}")
    x, bmat, cmat, dt, a = (t.contiguous() for t in (x, bmat, cmat, dt, a))

    lib = build.bind("ssd_intra", _SIGNATURES)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    states = torch.empty((b, s // q, h, p, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_intra_launch(
        x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(), a.data_ptr(), y.data_ptr(),
        states.data_ptr(), b, s, h, p, n, q, DTYPES[x.dtype], chunk_width(q, p, n), stream,
    )
    build.check_launch(lib, "ssd_intra", err)
    return y, states
