"""``app_step_torch`` (the port's ``AppStepTask``) on the CPU against the
JAX package's ``app_step``: the same parameter space and metrics, all 12
points run, and each point's timed call, given the reference's parameters
(``params_from_jax``) and batch, returns the reference's jitted answer: the
train kind's loss, the decode kind's logits at slot 8 of a fresh cache."""
from __future__ import annotations

import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import batch_like as jbatch_like  # noqa: E402
from repro.models.model import input_specs as jinput_specs  # noqa: E402
from repro.tasks.dbms import AppStepTask as JAppStepTask  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core.task import TaskContext  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.tasks import TASKS  # noqa: E402
from repro_torch.tasks.dbms import AppStepTask  # noqa: E402

RTOL = 1e-5  # f32 compute in both packages (tiny configs)
POINTS = list(itertools.product(*AppStepTask.param_space.values()))


def test_listed_with_the_reference_space_and_metrics():
    assert TASKS["app_step_torch"] is AppStepTask
    assert AppStepTask.param_space == JAppStepTask.param_space
    assert AppStepTask.default_metrics == JAppStepTask.default_metrics


@pytest.mark.parametrize("point", POINTS, ids=lambda p: "-".join(p))
def test_every_point_runs_on_the_cpu(point):
    task = AppStepTask()
    ctx = TaskContext(device="cpu", iters=2, warmup=1)
    params = dict(zip(task.param_space, point))
    res = task.execute_test(ctx, params)
    assert set(res.metrics) == set(task.default_metrics)
    assert all(np.isfinite(v) and v > 0 for v in res.metrics.values())


@pytest.mark.parametrize("arch", AppStepTask.param_space["arch"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_step_equals_the_reference_on_its_params_and_batch(arch, kind):
    """The port's timed call on the reference's parameters (PRNGKey(0)) and
    batch (``batch_like``) equals the reference's jitted call."""
    jcfg = jbase.tiny(jbase.get_arch(arch))
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cell = jbase.ShapeCell("t", 64, 2, "train") if kind == "train" else jbase.ShapeCell("d", 64, 2, "decode")
    jb = jbatch_like(jinput_specs(jcfg, cell))
    if kind == "train":
        want = jax.jit(lambda p, b: jm.loss(p, b)[0])(jp, jb)
    else:
        want = jax.jit(lambda p, b, c: jm.decode(p, b, c, jnp.int32(8))[0])(jp, jb, jm.init_cache(2, 64))
    fn, args, items = AppStepTask().step(TaskContext(device="cpu"), {"arch": arch, "kind": kind})
    assert items == (128 if kind == "train" else 2)
    cfg = base.tiny(base.get_arch(arch))
    port_params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    assert {k: tuple(v.shape) for k, v in batch.items()} == {k: tuple(v.shape) for k, v in args[1].items()}
    with torch.no_grad():
        got = fn(port_params, batch, *args[2:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
