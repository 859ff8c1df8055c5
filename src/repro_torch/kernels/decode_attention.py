"""Flash-decoding attention (K7): launch of ``csrc/decode_attention.cu``.

One query token per sequence, ``q [B, Hq, dh]``, against its KV cache
``k, v [B, S, Hkv, dh]`` up to a per-sequence ``kv_len [B]``; float32 or
bfloat16, output in q's type.  Counterpart of the JAX package's
``kernels/decode_attention.py``.  The kernel masks the ragged tail of S
itself, so no shape is padded; the keys are cut into splits whose size
depends on S alone (:func:`split_size`), never on B, so a sequence's result
has the same bits in any batch.  The splits' partials and the kernels'
arrival counters live in a workspace kept per device and stream
(:data:`WORKSPACES`), so a call allocates only its output.  Both types are
one launch a call: the last block of a (sequence, KV head) to arrive
combines its splits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I32, _PTR, _F32 = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "decode_attention_error_string": ([_I32], ctypes.c_char_p),
    "decode_attention_launch": (
        [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
         _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _F32, _PTR], _I32
    ),
}
#: The kernel's input types and their codes in ``decode_attention_launch``.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Head dims each type's kernel takes: the CUDA-core (float32) kernel also
#: ``tiny``'s 16; the tensor-core (bfloat16) kernel steps dh by 16-wide k16
#: steps of two 8-column tiles and takes 32, 64 and 128.
HEAD_DIMS = {torch.float32: (16, 32, 64, 128), torch.bfloat16: (32, 64, 128)}
MAX_GROUP = 16  # query heads of one KV head
TILE = 64  # the unit of a split's keys
MAX_SPLITS = 16

#: (device, stream) -> (partials, arrival counters) of the launches there.
WORKSPACES: dict[tuple[torch.device, int], tuple[torch.Tensor, torch.Tensor]] = {}


def split_size(s: int) -> int:
    """Keys of one split: whole 64-key tiles, at most 16 splits over S (256
    keys at S = 4,096, so a block streams several tiles)."""
    tiles = -(-s // TILE)
    return TILE * -(-tiles // MAX_SPLITS)


def workspace(device: torch.device, stream: int, floats: int, counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch of the launches on one device and stream, grown on demand:
    ``floats`` float32 for the splits' partials and ``counters`` int32
    arrival counters, zeroed when made.  The kernel leaves every counter at
    0, and launches on one stream run in order, so nothing is cleared
    between calls."""
    ws, cnt = WORKSPACES.get((device, stream), (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(counters, dtype=torch.int32, device=device)
    WORKSPACES[(device, stream)] = (ws, cnt)
    return ws, cnt


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor) -> None:
    """Raise on shapes the kernel does not take (any device)."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, Hq, dh] and k, v [B, S, Hkv, dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, dh = q.shape
    _, s, hkv, dk = k.shape
    if k.shape[0] != b or dk != dh or hkv < 1 or hq % hkv:
        raise ValueError(f"batch and head dim must match and Hkv divide Hq: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be [B] = [{b}], got {tuple(kv_len.shape)}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel; returns [B, Hq, dh] in q's type on q's device.
    Types, shapes and head dims are checked before the device, so what a
    kernel does not take raises on any device."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_shapes(q, k, v, kv_len)
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head dim must be one of {HEAD_DIMS[q.dtype]} for {q.dtype}, got {dh}")
    if hq // hkv > MAX_GROUP or min(b, s) < 1 or max(b, hkv) > 65535:
        raise ValueError(f"shape out of the kernel's range: B={b} S={s} Hq={hq} Hkv={hkv}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the kernel runs on CUDA tensors of one device, got {q.device}, {k.device}, {v.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.data_ptr() % (16 if q.dtype == torch.float32 else 4) or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary and q on a 16-byte (float32) or 4-byte "
                         "(bfloat16) one: the kernels load 16 bytes of a cache row, and 4 or 2 q values, at a time")
    if kv_len.dtype != torch.int32 or kv_len.device != q.device or not kv_len.is_contiguous():
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    return call(build.bind("decode_attention", _SIGNATURES), q, k, v, kv_len, split_size(s))


def call(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, split: int) -> torch.Tensor:
    """One launch of ``lib``'s ``decode_attention_launch`` with ``split`` keys
    a split, on inputs :func:`launch` has checked; returns the output."""
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    nsplit = -(-s // split)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = workspace(q.device, stream, b * hq * nsplit * (dh + 2), b * hkv)
    out = torch.empty_like(q)
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), ws.data_ptr(), counters.data_ptr(),
        out.data_ptr(), b, s, hq, hkv, dh, split, nsplit, DTYPES[q.dtype], dh**-0.5, stream,
    )
    build.check_launch(lib, "decode_attention", err)
    return out
