"""GQA flash-attention forward (K6): launch of ``csrc/flash_attention.cu``.

``q [B, Sq, Hq, dh]`` against ``k, v [B, Sk, Hkv, dh]``, causal (Sq = Sk)
or not, float32 or bfloat16, output in q's type.  Counterpart of the JAX
package's ``kernels/flash_attention.py``; the kernel masks ragged tails of
Sq and Sk itself, so no block sizes are chosen and no shape is padded.
bfloat16 at dh 64 and 128 runs on the tensor cores with TMA loads, which
need 16-byte-aligned tensors; everything else on the CUDA cores.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I32, _PTR, _F32 = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "flash_attention_error_string": ([_I32], ctypes.c_char_p),
    "flash_attention_launch": (
        [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _F32, _PTR], _I32
    ),
}
#: The kernel's input types and their codes in ``flash_attention_launch``.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
#: Head dims whose bfloat16 inputs go to the tensor-core (TMA + wgmma) kernel.
TENSOR_CORE_HEAD_DIMS = (64, 128)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """Raise on shapes the kernel does not take (any device)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, Sq, Hq, dh] and k, v [B, Sk, Hkv, dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != dh or hkv < 1 or hq % hkv:
        raise ValueError(f"batch and head dim must match and Hkv divide Hq: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if causal and sq != sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {sq} and {sk}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Run the CUDA kernel; returns [B, Sq, Hq, dh] in q's type on q's device."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the kernel runs on CUDA tensors of one device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_shapes(q, k, v, causal)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {dh}")
    if min(b, sq, sk) < 1 or max(b, hq) > 65535:
        raise ValueError(f"shape out of the kernel's range: B={b} Sq={sq} Sk={sk} Hq={hq}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and dh in TENSOR_CORE_HEAD_DIMS:
        for label, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{label} must start 16-byte aligned for the TMA loads, got {t.data_ptr():#x}")

    lib = build.bind("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv, dh,
        int(causal), DTYPES[q.dtype], dh**-0.5, stream,
    )
    build.check_launch(lib, "flash_attention", err)
    return out
