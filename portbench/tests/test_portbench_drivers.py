"""Each cell's driver runs end to end at a tiny scale on the CPU's plain routes."""
import pytest

from portbench.tests.helpers import REQUIRED, cells, last_line, run_cpu


@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_cell_prints_the_result_line(name, traced):
    result, out, err = run_cpu(name, traced=traced)
    line = last_line(out)
    assert line == result
    assert REQUIRED <= set(line)
    extra = set(line) - REQUIRED
    assert extra == ({"breakdown", "checks"} if traced else {"checks"})
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["count"] == 1
    # every number compared is printed beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(t.startswith("[check]") for t in tail)


@pytest.mark.parametrize("name", cells())
def test_untraced_run_reports_its_end_to_end_metrics(name):
    from portbench.harness.cell import cell_plan

    result, _, _ = run_cpu(name)
    assert set(result["metrics"]) == {m["name"] for m in cell_plan(name)["end_to_end"]}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_traced_serving_run_reads_its_front_end_metrics():
    result, _, _ = run_cpu("serve_mix_closed", traced=True)
    assert 1 <= result["metrics"]["batch_size.qps"]["value"] <= 8
    assert result["metrics"]["pass_host_ms.qps"]["value"] > 0
    # no device ops on the CPU: the device metrics are left out, never read as 0
    assert "device_idle.qps" not in result["metrics"] and "roofline.qps" not in result["metrics"]


def test_the_knee_sweep_drives_the_open_loop():
    """``sweep.py`` runs the open-loop driver at each rate, checks every answer."""
    import io
    import json

    from portbench import sweep

    out = io.StringIO()
    assert sweep.main(["--workload", "serve_mix_open", "--config", "tpch_sf5_serve", "--seed", "7", "--seconds", "0.4", "--rates", "200", "400",
                       "--device", "cpu", "--scale", "0.002"], out=out) == 0
    rows = [json.loads(ln[len("[sweep] "):]) for ln in out.getvalue().splitlines() if ln.startswith("[sweep] {")]
    assert [r["rate"] for r in rows] == [200, 400]
    assert all(r["offered"] > 0 and r["p95_ms"] > 0 for r in rows)
    assert "0 failed" in out.getvalue()
