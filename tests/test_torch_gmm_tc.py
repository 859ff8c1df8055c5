"""K5's tensor-core kernel (bf16 ``gmm_tc_kernel`` of ``csrc/gmm.cu``) on
the CPU, where it cannot run: which kernel a product goes to, the tile and
grid the launch takes, and the kernel's order of sums.

* The kernel is chosen from the type and the shape alone
  (``moe_gmm.kernel_for``): every expert product of Jamba-v0.1, Grok-1 and
  Kimi-K2, at a decode step (C = 8) and at a 2,048-token prompt, goes to the
  tensor cores; float32, and bf16 rows TMA cannot describe, to the CUDA
  cores; and a launch counts under the kernel chosen.
* The host's tile arithmetic (``moe_gmm.tc_plan``) is held to the constants
  of ``csrc/gmm.cu``: rows, columns, ring depth, grid and shared memory.
* A float32 emulation of the kernel's sums (64-deep stages in order, f32
  sums, one bf16 rounding at the store) is held to the JAX package's
  ``gmm`` (its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
  runs it) and to its oracle ``gmm_ref``, at small widths with the MoE
  shapes' ratios, within ``tests/test_kernels.py``'s bf16 tolerance."""
from __future__ import annotations

import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.kernels import build, moe_gmm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

MOE_ARCHS = ["jamba-v0.1-52b", "grok-1-314b", "kimi-k2-1t-a32b"]
BF16 = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py's bf16 tolerance


def source_constants(name: str) -> dict[str, int]:
    """The ``constexpr int kName = <number>;`` constants of csrc/<name>.cu."""
    text = (build.CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def moe_products(arch: str) -> list[tuple[int, int, int, int]]:
    """(E, C, d, f) of the arch's two expert products at C = 8 and at the C
    of a 2,048-token prompt: wi [E, C, d] x [E, d, 2 d_ff], wo [E, C, d_ff]
    x [E, d_ff, d]."""
    cfg = get_arch(arch)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return [s for c in (8, moe.capacity(2048, cfg)) for s in ((e, c, d, 2 * f), (e, c, f, d))]


# -- which kernel runs -------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_every_moe_product_goes_to_the_tensor_cores(arch):
    shapes = moe_products(arch)
    assert len(shapes) == 4 and {c for _, c, _, _ in shapes} == {8, moe.capacity(2048, get_arch(arch))}
    for shape in shapes:
        assert moe_gmm.kernel_for(torch.bfloat16, *shape) == "gmm_tc", shape


@pytest.mark.parametrize("shape", [(4, 2048, 256, 256), (2, 77, 33, 70), (1, 1, 1, 1), (16, 8, 4096, 28672),
                                   (3, 130, 24, 72)])
def test_float32_goes_to_the_cuda_cores(shape):
    assert moe_gmm.kernel_for(torch.float32, *shape) == "gmm"


@pytest.mark.parametrize("d,f", [(33, 70), (1, 1), (100, 200), (72, 70), (12, 16), (4096, 28676)])
def test_bf16_rows_tma_cannot_describe_go_to_the_cuda_cores(d, f):
    for c in (1, 8, 257):
        assert moe_gmm.kernel_for(torch.bfloat16, 2, c, d, f) == "gmm"


@pytest.mark.parametrize("e,c,d,f", [(1, 1, 8, 8), (384, 257, 72, 200), (3, 130, 24, 72), (2, 65, 8, 4096)])
def test_bf16_rows_of_16_byte_multiples_go_to_the_tensor_cores_at_any_e_and_c(e, c, d, f):
    assert moe_gmm.kernel_for(torch.bfloat16, e, c, d, f) == "gmm_tc"


@pytest.mark.parametrize("dtype,shape,want", [
    (torch.bfloat16, (2, 8, 64, 128), "gmm_tc"),
    (torch.bfloat16, (2, 77, 33, 70), "gmm"),
    (torch.float32, (2, 8, 64, 128), "gmm"),
])
def test_a_launch_counts_under_the_kernel_chosen(monkeypatch, dtype, shape, want):
    """ops.gmm's count is the kernel kernel_for names, one a launch (the
    launch itself stubbed: there is no card here)."""
    e, c, d, f = shape
    monkeypatch.setattr(kops, "_route", lambda cols, use_kernel: True)
    monkeypatch.setattr(moe_gmm, "launch", lambda lhs, rhs: torch.zeros((e, c, f), dtype=lhs.dtype))
    kops.reset_launches()
    kops.gmm(torch.zeros((e, c, d), dtype=dtype), torch.zeros((e, d, f), dtype=dtype))
    assert kops.LAUNCHES[want] == 1 and sum(kops.LAUNCHES.values()) == 1
    kops.reset_launches()


def test_the_tensor_core_entry_is_bound():
    assert "gmm_tc_launch" in moe_gmm._SIGNATURES
    c_interface = (build.CSRC / "gmm.cu").read_text().split('extern "C" {')[1]
    assert " gmm_tc_launch(" in c_interface and " gmm_launch(" in c_interface


# -- the host's tile arithmetic ----------------------------------------------------
def test_the_tiles_are_the_sources_constants():
    k = source_constants("gmm")
    assert (moe_gmm.TC_ROWS, moe_gmm.TC_K, moe_gmm.TC_BOX) == (k["kTcRows"], k["kTcK"], k["kTcBox"])
    assert moe_gmm.TC_TILES == {1: (k["kTcBN1"], k["kTcStages1"]), 2: (k["kTcBN2"], k["kTcStages2"])}
    # The CUDA-core kernel's tiles are its own.
    assert (k["kBM"], k["kBK"], k["kStages"], k["kBN"]) == (128, 16, 2, 64)


def _all_shapes():
    edges = [(e, c, 72, 200) for c in (1, 8, 9, 63, 64, 65, 128, 129, 130, 257) for e in (1, 384)]
    return [s for arch in MOE_ARCHS for s in moe_products(arch)] + edges + [(3, 130, 24, 72), (2, 1, 8, 8)]


@pytest.mark.parametrize("shape", _all_shapes())
def test_the_plan_covers_the_shape_in_the_card_s_limits(shape):
    e, c, d, f = shape
    p = moe_gmm.tc_plan(e, c, d, f)
    wg = 1 if c <= 64 else 2
    bn, stages = moe_gmm.TC_TILES[wg]
    assert (p.warpgroups, p.rows, p.columns, p.stages) == (wg, 64 * wg, bn, stages)
    # Every row, column and k is in exactly one tile; row tiles are the fastest grid axis.
    assert (p.grid[0] - 1) * p.rows < c <= p.grid[0] * p.rows
    assert (p.grid[1] - 1) * p.columns < f <= p.grid[1] * p.columns
    assert (p.k_steps - 1) * 64 < d <= p.k_steps * 64 and p.grid[2] == e
    assert p.grid[1] < 65536 and p.grid[2] < 65536
    # A stage: the token box [rows][64 k] and columns / 64 weight boxes [64 k][64], 128 bytes a row.
    stage = p.rows * 128 + p.columns // 64 * 64 * 128
    assert p.smem_bytes == p.stages * stage + 16 * p.stages + 1024 <= moe_gmm.SMEM_LIMIT
    # wgmma's N: a multiple of 64 (whole boxes) up to 256; one f32 accumulator a column pair a thread.
    assert p.columns % 64 == 0 and p.columns <= 256
    # The decode tile keeps >= 32 KB of weights a stage and >= 4 stages in flight.
    if wg == 1:
        assert p.columns * 64 * 2 >= 32 * 1024 and p.stages >= 4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_a_decode_step_is_one_row_tile_an_expert(arch):
    """At C = 8 the whole expert buffer is one 64-row tile (56 rows of
    zeros), so the weights are read once; at a long prompt's C the row
    tiles of one (expert, column tile) sit side by side in the grid."""
    for e, c, d, f in moe_products(arch):
        p = moe_gmm.tc_plan(e, c, d, f)
        if c <= 64:
            assert p.grid[0] == 1 and p.rows == 64
        else:
            assert p.grid[0] == -(-c // 128) and p.rows == 128


# -- the kernel's order of sums ------------------------------------------------------
def emulate(lhs: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """The tensor-core kernel's arithmetic in float32: bf16 inputs, each
    64-deep stage's products added to an f32 sum in stage order (zeros past
    d), one rounding to bf16 at the store.  Returns float32 values."""
    e, c, d = lhs.shape
    acc = np.zeros((e, c, rhs.shape[2]), np.float32)
    for k0 in range(0, d, 64):
        acc = acc + np.matmul(lhs[:, :, k0:k0 + 64], rhs[:, k0:k0 + 64, :]).astype(np.float32)
    return torch.from_numpy(acc).to(torch.bfloat16).to(torch.float32).numpy()


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (nearest even, as jnp and torch both round), in float32."""
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("c", [1, 8, 9, 56, 65, 130])
@pytest.mark.parametrize("e,d,f", [
    (4, 128, 256),   # wi: d -> 2 d_ff
    (8, 256, 128),   # wo: d_ff -> d
    (16, 192, 64),   # d not a multiple of the stage's 64 ... of 128
])
def test_emulated_order_matches_the_jax_gmm(e, c, d, f):
    rng = np.random.default_rng(e * 1000 + c * 10 + d)
    lhs = _bf16(rng.standard_normal((e, c, d), dtype=np.float32))
    rhs = _bf16(rng.standard_normal((e, d, f), dtype=np.float32))
    got = emulate(lhs, rhs)
    jl, jr = jnp.asarray(lhs, jnp.bfloat16), jnp.asarray(rhs, jnp.bfloat16)
    for want in (jref.gmm_ref(jl, jr), jkops.gmm(jl, jr)):  # the oracle, then the Pallas kernel (interpret)
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16)
    # and the port's plain version (widened f32 products in one call) on the same bits
    plain = kops.gmm(torch.from_numpy(lhs).to(torch.bfloat16), torch.from_numpy(rhs).to(torch.bfloat16))
    np.testing.assert_allclose(got, plain.to(torch.float32).numpy(), **BF16)


@pytest.mark.parametrize("d", [72, 200])
def test_emulated_zero_fill_past_d_changes_nothing(d):
    """TMA fills the last stage past d with zeros in both operands; the sum
    over a zero-padded k equals the sum over d alone (f32 sums of the same
    nonzero products, within f32 rounding before the bf16 store)."""
    rng = np.random.default_rng(d)
    lhs = _bf16(rng.standard_normal((3, 9, d), dtype=np.float32))
    rhs = _bf16(rng.standard_normal((3, d, 40), dtype=np.float32))
    pad = -d % 64
    lp = np.concatenate([lhs, np.zeros((3, 9, pad), np.float32)], axis=2)
    rp = np.concatenate([rhs, np.zeros((3, pad, 40), np.float32)], axis=1)
    np.testing.assert_allclose(emulate(lp, rp), emulate(lhs, rhs), rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(emulate(lp, rp), np.asarray(jref.gmm_ref(jnp.asarray(lhs, jnp.bfloat16),
                                                                        jnp.asarray(rhs, jnp.bfloat16)), np.float32),
                               **BF16)
