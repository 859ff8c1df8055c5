"""The port's resource microbenchmarks (``compute_torch``, ``strings_torch``,
``memory_torch``, ``storage_torch``, ``index_offload_torch``,
``network_torch``, ``quantize_torch``) against the JAX package's tasks on
the CPU, at every point of each ``param_space``.

Both packages' ``measure`` is replaced by one that calls the timed callable
once and keeps it, its arguments and its output.  Sizes are cut to the same
small values in both modules.  Where the inputs are random, the reference's
go into the port (the compute vector, the strings, the index keys and
queries, the memory indices, the quantize input), so the outputs compare.

Tolerances: exact for integers, strings, bytes, quantize's q and scale,
dequantize, index lookups (int32, wrapped) and every ``Samples`` count;
float32 sums within 1e-6 relative (another order of summation); the
float32 matmul within 512 * 2^-24 relative, the worst-case rounding of a
512-term sum of positive terms taken in another order (read: 1.6e-6);
bfloat16 within ``tests/test_kernels.py``'s bf16 ``_tol`` (2e-2).
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.core.task import TaskContext as JTaskContext  # noqa: E402
from repro.tasks import compute as jcompute  # noqa: E402
from repro.tasks import index_offload as jindex  # noqa: E402
from repro.tasks import memory as jmemory  # noqa: E402
from repro.tasks import network as jnetwork  # noqa: E402
from repro.tasks import storage as jstorage  # noqa: E402
from repro.tasks.plugins import quantize as jquantize  # noqa: E402
from repro_torch.core.task import TaskContext  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.tasks import TASKS  # noqa: E402
from repro_torch.tasks import compute, index_offload, memory, network, storage  # noqa: E402
from repro_torch.tasks.plugins import quantize  # noqa: E402

F32_RTOL = 1e-6
MATMUL_F32_RTOL = 512 * 2.0**-24  # compute's n = 512 positive products a row
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def points(space: dict) -> list[dict]:
    keys = list(space)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(space[k] for k in keys))]


def ids(space: dict) -> list[str]:
    return ["-".join(str(v) for v in p.values()) for p in points(space)]


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def from_jax(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_same(got, want, tol: str = "exact") -> None:
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if tol == "exact":
        np.testing.assert_array_equal(g, w)
    elif tol == "f32":
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=0)
    elif tol == "matmul_f32":
        np.testing.assert_allclose(g, w, rtol=MATMUL_F32_RTOL, atol=0)
    else:
        np.testing.assert_allclose(g, w, **BF16_TOL)


def assert_samples_equal(got, want) -> None:
    assert got.ops_per_iter == want.ops_per_iter
    assert got.bytes_per_iter == want.bytes_per_iter
    assert got.items_per_iter == want.items_per_iter
    assert got.extra == want.extra
    assert got.times_s == want.times_s == [1e-3]


class Pair:
    """A reference task and its port, prepared once, whose ``measure`` keeps
    the timed callable, its arguments and its output."""

    def __init__(self, mp, jmod, tmod, jtask, ttask, sizes: dict):
        for name, value in sizes.items():
            mp.setattr(jmod, name, value)
            mp.setattr(tmod, name, value)
        self.seen: dict[str, dict] = {}
        for side, mod in (("ref", jmod), ("port", tmod)):
            mp.setattr(mod, "measure", self._capture(side))
        self.jtask, self.ttask = jtask, ttask
        self.jctx = JTaskContext(iters=1, warmup=0)
        self.tctx = TaskContext(iters=1, warmup=0, device="cpu")
        jtask.prepare(self.jctx)
        ttask.prepare(self.tctx)

    def _capture(self, side: str):
        def fake(fn, *args, iters=5, warmup=2, min_time_s=0.0):
            self.seen[side] = {"fn": fn, "args": args, "out": fn(*args)}
            return [1e-3]
        return fake

    def run(self, params: dict):
        """(reference Samples, its capture, port Samples, its capture)."""
        js = self.jtask.run(self.jctx, params)
        ts = self.ttask.run(self.tctx, params)
        return js, self.seen["ref"], ts, self.seen["port"]

    def close(self) -> None:
        self.ttask.clean(self.tctx)
        self.jtask.clean(self.jctx)


def pair(jmod, tmod, jtask, ttask, sizes):
    with pytest.MonkeyPatch.context() as mp:
        p = Pair(mp, jmod, tmod, jtask, ttask, sizes)
        try:
            yield p
        finally:
            p.close()


# ---------------------------------------------------------------------------
# The tasks as listed
RESOURCE_TASKS = {
    "compute_torch": (compute.ComputeTask, jcompute.ComputeTask),
    "strings_torch": (compute.StringTask, jcompute.StringTask),
    "memory_torch": (memory.MemoryTask, jmemory.MemoryTask),
    "storage_torch": (storage.StorageTask, jstorage.StorageTask),
    "index_offload_torch": (index_offload.IndexOffloadTask, jindex.IndexOffloadTask),
    "network_torch": (network.NetworkTask, jnetwork.NetworkTask),
    "quantize_torch": (quantize.QuantizeTask, jquantize.QuantizeTask),
}


@pytest.mark.parametrize("name", list(RESOURCE_TASKS))
def test_task_listed_with_reference_space_and_metrics(name):
    task, jtask = RESOURCE_TASKS[name]
    assert TASKS[name] is task and task.name == name == jtask.name + "_torch"
    assert task.param_space == jtask.param_space
    assert task.default_metrics == jtask.default_metrics


def test_module_constants_equal_reference():
    assert compute._VEC == jcompute._VEC and compute._CHAIN == jcompute._CHAIN == ref.CHAIN
    assert compute._N_STRINGS == jcompute._N_STRINGS and compute._STR_WIDTHS == jcompute._STR_WIDTHS
    assert list(compute._DTYPES) == list(jcompute._DTYPES)
    assert memory._SIZES == jmemory._SIZES and memory._ACCESSES == jmemory._ACCESSES
    assert storage._SIZES == jstorage._SIZES
    assert index_offload._SCALES == jindex._SCALES and index_offload._BATCH == jindex._BATCH
    assert network._SIZES == jnetwork._SIZES
    assert quantize._SIZES == jquantize._SIZES


@pytest.mark.parametrize("name", list(RESOURCE_TASKS))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    task = TASKS[name]()
    ctx = TaskContext()
    with pytest.raises((RuntimeError, AssertionError)):
        task.prepare(ctx)
        task.run(ctx, {})


# ---------------------------------------------------------------------------
# compute_torch
@pytest.fixture(scope="module")
def compute_pair():
    yield from pair(jcompute, compute, jcompute.ComputeTask(), compute.ComputeTask(), {"_VEC": 256})


@pytest.mark.parametrize("params", points(jcompute.ComputeTask.param_space),
                         ids=ids(jcompute.ComputeTask.param_space))
def test_compute_point_equals_reference(compute_pair, params):
    """Chains exact in every type; matmul exact for the integers (int8
    wraps), f32 within 512 * 2^-24 relative, bf16 within the bf16 _tol."""
    p = compute_pair
    p.tctx.scratch["f32"] = from_jax(p.jctx.scratch["f32"])  # the reference's vector
    js, jseen, ts, tseen = p.run(params)
    assert_samples_equal(ts, js)
    dtype = params["data_type"]
    if params["operation"] != "matmul":
        assert_same(tseen["out"], jseen["out"])
        return
    tol = "exact" if dtype.startswith("int") else "matmul_f32" if dtype == "float32" else "bf16"
    # the reference's matrices through the port's call, and the port's
    # (b a transposed view) through the reference's
    assert_same(tseen["fn"](*(from_jax(a) for a in jseen["args"])), jseen["out"], tol)
    a, b = tseen["args"]
    assert b.stride() == (1, a.shape[1])
    assert_same(tseen["out"], jseen["fn"](*(jnp.asarray(to_np(x)).astype(x_j.dtype)
                                            for x, x_j in zip(tseen["args"], jseen["args"]))), tol)


@pytest.fixture(scope="module")
def strings_pair():
    def equal_rows(ctx):
        # row 0 equal, row 1 different only in its last byte
        for w, (a, b) in list(ctx.scratch.items()):
            b = b.at[0].set(a[0]).at[1, :-1].set(a[1, :-1])
            ctx.scratch[w] = (a, b)
    gen = pair(jcompute, compute, jcompute.StringTask(), compute.StringTask(), {"_N_STRINGS": 64})
    p = next(gen)
    equal_rows(p.jctx)
    for w, ab in p.jctx.scratch.items():
        p.tctx.scratch[w] = tuple(from_jax(x) for x in ab)  # the reference's strings
    yield p
    next(gen, None)


@pytest.mark.parametrize("params", points(jcompute.StringTask.param_space),
                         ids=ids(jcompute.StringTask.param_space))
def test_strings_point_equals_reference(strings_pair, params):
    """Exact: byte differences, concatenations and transforms."""
    js, jseen, ts, tseen = strings_pair.run(params)
    assert_samples_equal(ts, js)
    assert_same(tseen["out"], jseen["out"])
    if params["operation"] == "cmp":
        assert int(tseen["out"][0]) == 0 and int(tseen["out"][1]) != 0


# ---------------------------------------------------------------------------
# memory_torch
@pytest.fixture(scope="module")
def memory_pair():
    sizes = {"_SIZES": {"16KB": 1 << 6, "4MB": 1 << 9, "1GB": 1 << 12}, "_ACCESSES": 32}
    yield from pair(jmemory, memory, jmemory.MemoryTask(), memory.MemoryTask(), sizes)


@pytest.mark.parametrize("params", points(jmemory.MemoryTask.param_space),
                         ids=ids(jmemory.MemoryTask.param_space))
def test_memory_point_equals_reference(memory_pair, params):
    """Sums within 1e-6 relative; fills and the written buffer exact (the
    reference's indices through the port's call)."""
    js, jseen, ts, tseen = memory_pair.run(params)
    assert_samples_equal(ts, js)
    kind = (params["pattern"], params["operation"])
    if kind == ("sequential", "read"):
        assert_same(tseen["out"], jseen["out"], "f32")
    elif kind == ("sequential", "write"):
        assert_same(tseen["out"], jseen["out"])
    elif kind == ("random", "read"):
        buf, idx = (from_jax(a) for a in jseen["args"])
        assert_same(tseen["fn"](buf, idx.to(torch.int64)), jseen["out"], "f32")
    else:
        n = memory._SIZES[params["object_size"]]
        buf, flat, vals = tseen["args"]
        want = torch.arange(n, dtype=torch.float32)
        want[flat] = 1.0
        assert torch.equal(buf, want)  # the port's own indices, written in place
        jbuf, jflat, jvals = (from_jax(a) for a in jseen["args"])
        written = tseen["fn"](jbuf.clone(), jflat.to(torch.int64), jvals)
        assert_same(written, jseen["out"])


# ---------------------------------------------------------------------------
# storage_torch
@pytest.fixture(scope="module")
def storage_pair():
    sizes = {"_SIZES": {"8KB": 64, "256KB": 256, "4MB": 1024, "64MB": 4096}}
    yield from pair(jstorage, storage, jstorage.StorageTask(), storage.StorageTask(), sizes)


@pytest.mark.parametrize("params", points(jstorage.StorageTask.param_space),
                         ids=ids(jstorage.StorageTask.param_space))
def test_storage_point_equals_reference(storage_pair, params):
    """Exact: copied buffers, and checkpoints the other package reads back."""
    p = storage_pair
    js, jseen, ts, tseen = p.run(params)
    assert_samples_equal(ts, js)
    io = params["io_type"]
    if io in ("h2d", "d2h"):
        assert len(tseen["out"]) == len(jseen["out"]) == params["depth"]
        for got, want in zip(tseen["out"], jseen["out"]):
            assert_same(got, want)
    elif io == "ckpt_write":
        nbytes, depth = storage._SIZES[params["access_size"]], params["depth"]
        d = f"{p.tctx.scratch['tmp']}/w{nbytes}_{depth}"
        like = {f"b{i}": jax.ShapeDtypeStruct((nbytes // 4,), jnp.float32) for i in range(depth)}
        got, step = jckpt.restore(d, like=like)
        assert step == 0
        for i in range(depth):
            assert_same(got[f"b{i}"], np.arange(nbytes // 4, dtype=np.float32))
    else:
        (got, step), (want, jstep) = tseen["out"], jseen["out"]
        assert step == jstep == 0 and sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k])


# ---------------------------------------------------------------------------
# index_offload_torch
@pytest.fixture(scope="module")
def index_pair():
    sizes = {"_SCALES": {"1M": 1 << 10, "16M": 1 << 12}, "_BATCH": 64}
    gen = pair(jindex, index_offload, jindex.IndexOffloadTask(), index_offload.IndexOffloadTask(), sizes)
    p = next(gen)
    for scale in jindex._SCALES:
        p.tctx.scratch[scale] = tuple(from_jax(a) for a in p.jctx.scratch[scale])  # the reference's index
    yield p
    next(gen, None)


@pytest.mark.parametrize("params", points(jindex.IndexOffloadTask.param_space),
                         ids=ids(jindex.IndexOffloadTask.param_space))
def test_index_offload_point_equals_reference(index_pair, params, monkeypatch):
    """Exact: the partitions' int32 sums (wrapped) and written values, with
    the reference's keys and queries fed to the port."""
    p = index_pair
    jkeys = p.jctx.scratch[params["scale"]][0]

    def ref_queries(gen, keys, count, pattern):
        assert torch.equal(keys, from_jax(jkeys))
        return from_jax(jindex._queries(jax.random.PRNGKey(13), jkeys, count, pattern))

    monkeypatch.setattr(index_offload, "_queries", ref_queries)
    js, jseen, ts, tseen = p.run(params)
    assert_samples_equal(ts, js)
    for got, want in zip(tseen["out"], jseen["out"]):
        assert_same(got, want)


def test_index_offload_own_index_and_queries():
    """The port's own index is sorted int32 with values 7 i; skewed queries
    crowd the low keys."""
    gen = torch.Generator().manual_seed(0)
    keys, values = index_offload._make_index(gen, 4096)
    assert keys.dtype == values.dtype == torch.int32
    assert torch.all(keys[1:] >= keys[:-1]) and torch.equal(values, torch.arange(4096, dtype=torch.int32) * 7)
    uni = index_offload._queries(gen, keys, 8192, "uniform")
    skew = index_offload._queries(gen, keys, 8192, "skewed")
    assert torch.isin(uni, keys).all() and torch.isin(skew, keys).all()
    assert (skew < keys[1024]).float().mean() > 0.4 > (uni < keys[1024]).float().mean()


# ---------------------------------------------------------------------------
# network_torch
@pytest.fixture
def network_pair():
    # per test: the group it makes is destroyed before the next test
    sizes = {"_SIZES": {"32KB": 8, "1MB": 32, "32MB": 64, "256MB": 128}}
    yield from pair(jnetwork, network, jnetwork.NetworkTask(), network.NetworkTask(), sizes)


@pytest.mark.parametrize("params", points(jnetwork.NetworkTask.param_space),
                         ids=ids(jnetwork.NetworkTask.param_space))
def test_network_point_equals_reference(network_pair, params):
    """Sums within 1e-6 relative; every other output exact; wire bytes and
    device count the reference's."""
    js, jseen, ts, tseen = network_pair.run(params)
    assert_samples_equal(ts, js)
    tol = "f32" if params["schedule"] == "xla" and params["collective"] in ("all_reduce", "reduce_scatter") else "exact"
    assert_same(tseen["out"], jseen["out"], tol)


def test_network_group_made_and_destroyed():
    import torch.distributed as dist

    assert not dist.is_initialized()
    task, ctx = network.NetworkTask(), TaskContext(iters=1, warmup=0, device="cpu")
    task.prepare(ctx)
    assert dist.is_initialized() and dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    task.clean(ctx)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# quantize_torch
@pytest.fixture(scope="module")
def quantize_pair():
    sizes = {"_SIZES": {"64KB": 1024, "1MB": 2048, "16MB": 4096, "256MB": 8192}}
    yield from pair(jquantize, quantize, jquantize.QuantizeTask(), quantize.QuantizeTask(), sizes)


@pytest.mark.parametrize("params", points(jquantize.QuantizeTask.param_space),
                         ids=ids(jquantize.QuantizeTask.param_space))
def test_quantize_point_equals_reference(quantize_pair, params):
    """Exact: q, scale and the dequantized floats, on the reference's input
    through the port's call and on the port's through the reference's."""
    js, jseen, ts, tseen = quantize_pair.run(params)
    assert_samples_equal(ts, js)
    got = tseen["fn"](*(from_jax(a) for a in jseen["args"]))
    want = jseen["fn"](*(jnp.asarray(to_np(a)) for a in tseen["args"]))
    for g, w in ((got, jseen["out"]), (tseen["out"], want)):
        for gi, wi in zip(*((g, w) if isinstance(g, tuple) else ((g,), (w,)))):
            assert_same(gi, wi)


# ---------------------------------------------------------------------------
# The plain versions of the three kernels against the reference
JDTYPES = {torch.int8: jnp.int8, torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def chain_input(dtype: torch.dtype, n: int = 512) -> np.ndarray:
    rng = np.random.default_rng(7)
    if dtype == torch.int8:
        return rng.integers(-128, 128, n).astype(np.int8)
    if dtype == torch.int32:
        return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return rng.uniform(-4.0, 4.0, n).astype(np.float32)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("dtype", list(JDTYPES), ids=lambda d: str(d).split(".")[-1])
def test_alu_chain_plain_equals_reference(dtype, op):
    """All 16 chains, exact, on inputs of both signs (int8 and int32 wrap,
    floor division of negatives, bf16 rounding every step)."""
    x = chain_input(dtype)
    want = jcompute._arith_fn(op, JDTYPES[dtype])(jnp.asarray(x).astype(JDTYPES[dtype]))
    xt = torch.from_numpy(x).to(dtype)
    got = kops.alu_chain(xt, op, compute.operand(dtype))
    assert_same(got, want)
    assert got.dtype == dtype


def test_alu_chain_operands():
    assert compute.operand(torch.bfloat16).item() == 1.0
    assert compute.operand(torch.float32).item() == np.float32(1.0009)
    assert compute.operand(torch.int8).item() == 3 == compute.operand(torch.int32).item()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32], ids=["int8", "int32"])
def test_int_matmul_plain_equals_reference(dtype, transposed):
    """Random int8 / int32 matrices at ragged shapes, exact (wrapping)."""
    rng = np.random.default_rng(3)
    info = np.iinfo(np.int8 if dtype == torch.int8 else np.int32)
    a = rng.integers(info.min, info.max + 1, (37, 70), dtype=np.int64).astype(info.dtype)
    b = rng.integers(info.min, info.max + 1, (70, 45), dtype=np.int64).astype(info.dtype)
    want = jnp.asarray(a) @ jnp.asarray(b)
    bt = torch.from_numpy(np.ascontiguousarray(b.T)).T if transposed else torch.from_numpy(b)
    got = kops.int_matmul(torch.from_numpy(a), bt)
    assert_same(got, want)


def test_int_matmul_task_inputs_wrap():
    """The task's all-ones inputs at n = 512: int8 wraps to 0, int32 gives 512."""
    for dtype, value in ((torch.int8, 0), (torch.int32, 512)):
        a = torch.ones((512, 512), dtype=dtype)
        assert torch.equal(kops.int_matmul(a, a.T), torch.full((512, 512), value, dtype=dtype))


def test_quantize_plain_equals_reference():
    """Random blocks, a zero block (scale 0), and quotients that tie at .5
    (round half to even), exact."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(8 * 1024) * rng.uniform(0.01, 100, 8).repeat(1024)).astype(np.float32)
    x[1024:2048] = 0.0
    tie = np.zeros(1024, np.float32)
    tie[:6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]  # scale 1: x / 1 ties
    x[2048:3072] = tie
    q, s = kops.quantize(torch.from_numpy(x))
    jq, js = jquantize.quantize(jnp.asarray(x))
    assert_same(q, jq)
    assert_same(s, js)
    assert q[2, :6].tolist() == [127, 2, -4, 0, 0, 126] and s[1, 0] == 0
    assert_same(kops.dequantize(q, s), jquantize.dequantize(jq, js))


@pytest.mark.parametrize("wrapper", ["alu_chain", "int_matmul", "quantize", "dequantize"])
def test_wrappers_take_the_plain_version_on_the_cpu(wrapper):
    """A CPU tensor goes to the plain version and launches nothing."""
    kops.reset_launches()
    x = torch.ones(1024)
    if wrapper == "alu_chain":
        out = kops.alu_chain(x, "add", torch.tensor(1.0))
        assert torch.equal(out, torch.full((1024,), 257.0))
    elif wrapper == "int_matmul":
        a = torch.ones((4, 4), dtype=torch.int32)
        assert torch.equal(kops.int_matmul(a, a), torch.full((4, 4), 4, dtype=torch.int32))
    elif wrapper == "quantize":
        q, s = kops.quantize(x)
        assert torch.equal(q, torch.full((1, 1024), 127, dtype=torch.int8))
    else:
        out = kops.dequantize(torch.full((1, 1024), 127, dtype=torch.int8), torch.tensor([[1 / 127]]))
        assert out.shape == (1024,)
    assert kops.LAUNCHES[wrapper] == 0


@pytest.mark.parametrize("wrapper", ["alu_chain", "int_matmul", "quantize", "dequantize"])
def test_wrappers_raise_off_cpu_and_cuda(wrapper):
    """A tensor on neither the CPU nor the card gets no plain version: the wrapper raises."""
    x = torch.empty(1024, device="meta")
    calls = {
        "alu_chain": lambda: kops.alu_chain(x, "add", torch.tensor(1.0)),
        "int_matmul": lambda: kops.int_matmul(x.reshape(32, 32).int(), x.reshape(32, 32).int()),
        "quantize": lambda: kops.quantize(x),
        "dequantize": lambda: kops.dequantize(x.reshape(1, 1024).to(torch.int8), torch.empty((1, 1), device="meta")),
    }
    with pytest.raises(ValueError, match="no kernel for device meta"):
        calls[wrapper]()


@pytest.mark.parametrize("module", ["alu_chain", "int_matmul", "quantize", "dequantize"])
def test_launches_take_cuda_tensors_only(module):
    """The launch modules refuse CPU tensors before building anything."""
    from repro_torch.kernels import alu_chain, int_matmul
    from repro_torch.kernels import quantize as qk

    calls = {
        "alu_chain": lambda: alu_chain.launch(torch.ones(8), "add", torch.tensor(1.0)),
        "int_matmul": lambda: int_matmul.launch(torch.ones((4, 4), dtype=torch.int32),
                                                torch.ones((4, 4), dtype=torch.int32)),
        "quantize": lambda: qk.launch_quantize(torch.ones(1024)),
        "dequantize": lambda: qk.launch_dequantize(torch.ones((1, 1024), dtype=torch.int8), torch.ones((1, 1))),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[module]()
