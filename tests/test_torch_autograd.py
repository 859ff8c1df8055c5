"""The kernel wrappers under autograd, on the CPU.

``gmm``, ``flash_attention`` and ``ssd_intra`` differentiate as their plain
versions do: on the CPU the wrapper is the plain version under ordinary
autograd, and on the card :class:`ops.PlainVJP` runs the kernel forward and
the plain version's vector-Jacobian product backward.  Here ``PlainVJP`` is
driven with the plain version standing in for the kernel, so its backward
(recompute from the saved inputs, the gradients of the inputs that need
them) is held to autograd's own gradient exactly.  The wrappers without a
gradient (K7 and the kernels off the LM path) raise on an input that
requires grad, unless ``use_kernel=False`` asks for the plain version."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import group_filter_agg as gfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def inputs(name: str, gen: torch.Generator):
    """(plain function, wrapper call, float inputs) of one kernel at a tiny shape."""
    if name == "gmm":
        return ref.gmm_ref, lambda *t, **kw: ops.gmm(*t, **kw), \
            (torch.randn((4, 6, 16), generator=gen), torch.randn((4, 16, 24), generator=gen))
    if name.startswith("flash"):
        causal = name == "flash_causal"
        sk = 9 if causal else 13
        return (lambda *t: ref.flash_attention_ref(*t, causal=causal),
                lambda *t, **kw: ops.flash_attention(*t, causal=causal, **kw),
                (torch.randn((2, 9, 4, 16), generator=gen), torch.randn((2, sk, 2, 16), generator=gen),
                 torch.randn((2, sk, 2, 16), generator=gen)))
    dt = torch.nn.functional.softplus(torch.randn((2, 16, 3), generator=gen))
    return (lambda *t: ref.ssd_intra_ref(*t, 8), lambda *t, **kw: ops.ssd_intra(*t, chunk=8, **kw),
            (torch.randn((2, 16, 3, 8), generator=gen), torch.randn((2, 16, 5), generator=gen),
             torch.randn((2, 16, 5), generator=gen), dt, -torch.exp(torch.linspace(0.0, 2.0, 3))))


def vjp(fn, xs, seed=1):
    """Gradients of sum(out * random cotangent) with respect to every input."""
    xs = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator().manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=gen)).sum() for o in outs)
    return torch.autograd.grad(loss, xs)


KERNELS = ["gmm", "flash_causal", "flash_cross", "ssd"]


@pytest.mark.parametrize("name", KERNELS)
def test_plain_vjp_backward_equals_autograd(name):
    """PlainVJP's recomputed backward gives autograd's gradient, bit for bit,
    with every output's cotangent (ssd_intra's y and states) taken."""
    plain, _, xs = inputs(name, torch.Generator().manual_seed(0))
    got = vjp(lambda *t: ops.PlainVJP.apply(plain, plain, *t), xs)
    want = vjp(plain, xs)
    assert len(got) == len(xs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", KERNELS)
def test_plain_vjp_skips_inputs_without_grad_and_unused_outputs(name):
    """Only the inputs that require grad get one; an output outside the loss
    contributes nothing."""
    plain, _, xs = inputs(name, torch.Generator().manual_seed(2))
    live = xs[0].clone().requires_grad_()
    out = ops.PlainVJP.apply(plain, plain, live, *xs[1:])
    first = out[0] if isinstance(out, tuple) else out
    (g,) = torch.autograd.grad(first.sum(), [live])
    want_in = xs[0].clone().requires_grad_()
    w_out = plain(want_in, *xs[1:])
    (w,) = torch.autograd.grad((w_out[0] if isinstance(w_out, tuple) else w_out).sum(), [want_in])
    assert torch.equal(g, w)


@pytest.mark.parametrize("name", KERNELS)
def test_wrappers_differentiate_as_the_plain_version_on_the_cpu(name):
    """On the CPU both routes are the plain version under autograd: the
    same gradients, no launch."""
    plain, wrapper, xs = inputs(name, torch.Generator().manual_seed(3))
    ops.reset_launches()
    for use_kernel in (True, False):
        got = vjp(lambda *t: wrapper(*t, use_kernel=use_kernel), xs)
        for g, w in zip(got, vjp(plain, xs)):
            assert torch.equal(g, w)
    assert set(ops.LAUNCHES.values()) == {0}


def test_no_gradient_wrappers_raise_on_inputs_that_require_grad():
    """K7, K1-K4 and the resource kernels have no gradient: an input that
    requires grad raises (nothing drops a gradient silently); under
    torch.no_grad() or with use_kernel=False they run."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = torch.randn((2, 4, 16), generator=gen), torch.randn((2, 8, 2, 16), generator=gen), \
        torch.randn((2, 8, 2, 16), generator=gen)
    with pytest.raises(ValueError, match="decode_attention has no gradient"):
        ops.decode_attention(q.requires_grad_(), k, v, 5)
    with torch.no_grad():
        ops.decode_attention(q, k, v, 5)
    (g,) = torch.autograd.grad(ops.decode_attention(q, k, v, 5, use_kernel=False).sum(), [q])
    assert torch.isfinite(g).all()

    cols = torch.rand((4, 64), generator=gen).requires_grad_()
    with pytest.raises(ValueError, match="filter_agg has no gradient"):
        ops.filter_agg(cols, 0.1, 0.9, 0.2, 0.8)
    with pytest.raises(ValueError, match="block_compact has no gradient"):
        ops.block_compact(cols, cols.detach()[0] > 0.5, 16)
    with pytest.raises(ValueError, match="block_compact has no gradient"):
        ops.block_compact(list(cols), cols.detach()[0] > 0.5, 16)
    pred_ops, pred_consts = gfa.encode_predicates([("range", 0, 0.1, 0.5)])
    agg_ops, agg_consts = gfa.encode_aggregates([[("col", 1)]])
    keys = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="group_filter_agg has no gradient"):
        ops.group_filter_agg(cols, keys, pred_ops, pred_consts, agg_ops, agg_consts, num_groups=1)
    packed = gfa.pack(pred_ops, pred_consts[None], agg_ops, agg_consts[None])
    with pytest.raises(ValueError, match="group_filter_agg_multi has no gradient"):
        ops.group_filter_agg_multi(cols, keys, pred_ops, agg_ops, packed, num_groups=1)
    x = torch.randn(1024, generator=gen).requires_grad_()
    with pytest.raises(ValueError, match="alu_chain has no gradient"):
        ops.alu_chain(x, "add", torch.tensor(1.0))
    with pytest.raises(ValueError, match="quantize has no gradient"):
        ops.quantize(x)
    qz, scale = ops.quantize(x.detach())
    with pytest.raises(ValueError, match="dequantize has no gradient"):
        ops.dequantize(qz, scale.requires_grad_())
    with pytest.raises(ValueError, match="int_matmul has no gradient"):  # an integer input never requires grad
        ops.int_matmul(torch.ones((2, 2)).requires_grad_(), torch.ones((2, 2)))
