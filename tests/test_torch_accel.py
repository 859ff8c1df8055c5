"""The port's accelerator plugin (the ``accel_torch`` task) against the JAX
package's ``pallas_accel`` on the CPU: the same workloads, sizes and
operation counts, and each workload's kernel route against its plain
version on the same inputs."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro.core.task import TaskContext as JTaskContext  # noqa: E402
from repro.tasks.plugins import pallas_accel as jaccel  # noqa: E402
from repro_torch.core.task import TaskContext  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.tasks import TASKS  # noqa: E402
from repro_torch.tasks.plugins import accel  # noqa: E402

WORKLOADS = ["attention", "gmm", "filter_agg"]


def test_task_constants_equal_reference():
    space, jspace = accel.AccelTask.param_space, jaccel.PallasAccelTask.param_space
    assert accel._SIZES == jaccel._SIZES
    assert space["workload"] == jspace["workload"] == WORKLOADS
    assert space["size"] == jspace["size"]
    assert space["impl"] == ["kernel", "torch"] and jspace["impl"] == ["kernel", "jnp"]
    assert accel.AccelTask.default_metrics == jaccel.PallasAccelTask.default_metrics
    assert TASKS["accel_torch"] is accel.AccelTask


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_ops_per_iter_equals_reference(workload, impl):
    """Size small: the port's ops_per_iter is the reference's formula."""
    params = {"workload": workload, "size": "small"}
    got = TASKS["accel_torch"]().run(TaskContext(iters=1, warmup=0, device="cpu"), {**params, "impl": impl})
    want = jaccel.PallasAccelTask().run(JTaskContext(iters=1, warmup=0), {**params, "impl": "jnp"})
    assert got.ops_per_iter == want.ops_per_iter > 0
    assert len(got.times_s) == 1 and got.times_s[0] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_execute_reports_the_default_metrics(workload):
    kops.reset_launches()
    m = TASKS["accel_torch"]().execute_test(
        TaskContext(iters=2, warmup=1, device="cpu"), {"workload": workload, "size": "small"}
    ).metrics
    assert set(m) == {"ops_per_s", "avg_latency_us"}
    assert m["ops_per_s"] > 0 and m["avg_latency_us"] > 0
    assert set(kops.LAUNCHES.values()) == {0}  # CPU tensors take the plain version


@pytest.mark.parametrize("workload", WORKLOADS)
def test_kernel_and_plain_impls_see_the_same_inputs(workload):
    """One seed gives both impls the same inputs; on the CPU both are the plain version."""
    got, ops = accel.workload(workload, 128, "cpu", use_kernel=True)
    want, ops_plain = accel.workload(workload, 128, "cpu", use_kernel=False)
    assert ops == ops_plain
    assert torch.equal(got(), want())


def test_unknown_workload_raises():
    with pytest.raises(ValueError):
        accel.workload("regex", 128, "cpu", use_kernel=True)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        TASKS["accel_torch"]().run(TaskContext(), {"workload": "gmm", "size": "small"})
