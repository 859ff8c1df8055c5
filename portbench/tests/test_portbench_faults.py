"""The comparison fails a run whose timed path is broken underneath, and
fails the control: the reference one precision down in the program's place.

Each fault is planted in the port's kernel wrappers or server, on the CPU's
plain routes at a tiny scale; the rest of the run is the benchmark's own."""
import pytest
import torch

from portbench.control import control_numbers
from portbench.harness import cell
from portbench.tests.helpers import run_cpu

SERVE = ["serve_mix_closed"]
SCAN = ["scan_pushdown"]


def _wrap(monkeypatch, module, name, make):
    monkeypatch.setattr(module, name, make(getattr(module, name)))


def _kops():
    from repro_torch.kernels import ops

    return ops


def altered_sum(out):
    out = out.clone()
    out.view(-1)[0] *= 1.001
    return out


def altered_count(out):
    out = out.clone()
    out[..., -1] += 1
    return out


def half_rows(orig):
    """Half of the rows left out, the sums and counts scaled up from the rest."""
    def fn(cols, keys, *a, **k):
        n = cols.shape[1] // 2
        return orig(cols[:, :n], keys.reshape(-1)[:n], *a, **k) * 2
    return fn


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", [altered_sum, altered_count])
def test_serve_answer_altered_where_produced(monkeypatch, name, fault):
    kops = _kops()
    for wrapper in ("group_filter_agg", "group_filter_agg_multi"):
        _wrap(monkeypatch, kops, wrapper, lambda orig: lambda *a, **k: fault(orig(*a, **k)))
    assert run_cpu(name)[0]["correct"] is False


@pytest.mark.parametrize("name", SERVE)
def test_serve_half_of_the_rows_left_out(monkeypatch, name):
    kops = _kops()
    for wrapper in ("group_filter_agg", "group_filter_agg_multi"):
        _wrap(monkeypatch, kops, wrapper, half_rows)
    assert run_cpu(name)[0]["correct"] is False


@pytest.mark.parametrize("name", SERVE)
def test_serve_half_of_the_batch_left_out(monkeypatch, name):
    """Only the first half of a batch is computed; the rest get the first's answer."""
    from repro_torch.runtime.serve_query import QueryServer

    def make(orig):
        def execute(self, batch):
            head = orig(self, batch[: max(1, len(batch) // 2)])
            return head + [head[0]] * (len(batch) - len(head))
        return execute
    _wrap(monkeypatch, QueryServer, "_execute", make)
    assert run_cpu(name)[0]["correct"] is False


@pytest.mark.parametrize("name", SERVE)
def test_serve_pass_returns_its_state_unchanged(monkeypatch, name):
    """Every pass after the first returns the first pass's answers."""
    from repro_torch.runtime.serve_query import QueryServer

    def make(orig):
        first = {}

        def execute(self, batch):
            out = orig(self, batch)
            first.setdefault(batch[0].query, out[0])
            return [first[batch[0].query]] * len(batch)
        return execute
    _wrap(monkeypatch, QueryServer, "_execute", make)
    assert run_cpu(name)[0]["correct"] is False


@pytest.mark.parametrize("name", SCAN)
@pytest.mark.parametrize("kind", ["altered", "half_rows"])
def test_scan_faults(monkeypatch, name, kind):
    def make(orig):
        def fn(cols, mask, cap, **k):
            if kind == "half_rows":
                mask = mask.clone()
                mask.view(-1)[mask.numel() // 2:] = False
                packed, cnt = orig(cols, mask, cap, **k)
                return packed, cnt * 2
            packed, cnt = orig(cols, mask, cap, **k)
            return packed, cnt + 1
        return fn
    _wrap(monkeypatch, _kops(), "block_compact", make)
    assert run_cpu(name)[0]["correct"] is False


@pytest.mark.parametrize("name", SCAN)
def test_scan_plan_answers_from_a_cache(monkeypatch, name):
    """The plan's function scans once and returns that answer ever after."""
    from repro_torch.tasks import pushdown

    def make(orig):
        def make_plan(*a, **k):
            fn, memo = orig(*a, **k), []

            def cached():
                if not memo:
                    memo.append(fn())
                return memo[0]
            return cached
        return make_plan
    _wrap(monkeypatch, pushdown, "make_plan", make)
    assert run_cpu(name)[0]["correct"] is False


@pytest.mark.parametrize("name", SCAN)
def test_scan_kernel_skipped_after_the_first_call(monkeypatch, name):
    """Compaction runs once; later calls return its first output again."""
    def make(orig):
        first = []

        def fn(*a, **k):
            if not first:
                first.append(orig(*a, **k))
            return first[0]
        return fn
    _wrap(monkeypatch, _kops(), "block_compact", make)
    assert run_cpu(name)[0]["correct"] is False


def test_scan_calls_in_a_row_have_different_answers():
    """The table changes between calls, so every call's expected count
    differs from the one before."""
    from portbench.harness import record

    plan = cell.cell_plan("scan_pushdown")
    driver = cell.load_module(cell.PKG / "drivers" / "scan.py").Driver(plan["workload"], plan["config"], 5, "cpu",
                                                                        0.002)
    rec = record.Record()
    driver.setup(rec)
    driver.window(0.3, rec)
    sums, counts = driver.expected()
    assert len(counts) == rec.requests >= 3
    assert all(a != b for a, b in zip(counts, counts[1:]))
    assert list(counts) == list(driver.counts)


@pytest.mark.parametrize("name", SERVE + SCAN)
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 7])
def test_control_comes_out_not_correct(name, seed):
    plan = cell.cell_plan(name)
    correct, checks = control_numbers(plan["workload"], plan["config"], seed, device="cpu", scale=0.002,
                                      requests=300)
    assert correct is False, checks


def test_the_same_run_unbroken_is_correct():
    assert all(run_cpu(name)[0]["correct"] for name in SERVE + SCAN)
    assert torch.get_default_dtype() == torch.float32
