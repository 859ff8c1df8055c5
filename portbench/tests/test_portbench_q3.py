"""The Q3 cell (``serve_q3_closed``): it runs correct on the CPU's plain
routes at a small scale, and faults planted in the port's Q3 path, and the
control (the reference one precision down in the program's place), come
out not correct.  ``roofline.q3`` counts the base tables' bytes, whatever
the program's layout."""
import pytest
import torch

from portbench.harness import cell, peaks, q3
from portbench.harness.record import Record
from portbench.tests.helpers import last_line, run_cpu

NAME = "serve_q3_closed"


def _run(**kw):
    result, out, _ = run_cpu(NAME, **kw)
    assert last_line(out) == result
    return result


def test_the_cell_runs_correct_with_its_checks():
    result = _run(seconds=0.5)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 64
    assert set(result["checks"]) == {"missing", "wrong_keys", "max_rel_err"}
    assert result["checks"]["max_rel_err"]["value"] < 1e-6
    assert set(result["metrics"]) == {"qps", "setup_s"}


def test_traced_run_reads_the_serving_metrics_and_leaves_device_ones_out():
    result = _run(traced=True)
    assert result["correct"] is True
    assert result["metrics"]["batch_size.qps"]["value"] == 8.0
    # no device ops on the CPU: the device metrics are left out, never read as 0
    assert not {"roofline.q3", "device_idle.qps"} & set(result["metrics"])


def _kops():
    from repro_torch.kernels import ops

    return ops


def _plant(monkeypatch, fault):
    """Put ``fault`` around the batched K9 wrapper, and route the
    single-program wrapper through it (at B = 1 it gives the same bits)."""
    kops = _kops()
    multi = fault(kops.group_topk_agg_multi)
    monkeypatch.setattr(kops, "group_topk_agg_multi", multi)
    monkeypatch.setattr(kops, "group_topk_agg", lambda layout, code, hi, lo, **k: tuple(
        t[0] for t in multi(layout, [code], [hi], [lo], **k)))


def no_segment(orig):
    """The segment predicate dropped: every order's code made the program's."""
    def fn(layout, codes, his, los, **k):
        return orig(layout._replace(codes=torch.zeros_like(layout.codes)), [0] * len(codes), his, los, **k)
    return fn


def no_discount(orig):
    """Revenue without ``(1 - l_discount)``."""
    def fn(layout, codes, his, los, **k):
        rows = layout.rows.clone()
        rows[2] = 0
        return orig(layout._replace(rows=rows), codes, his, los, **k)
    return fn


def slot_zero(orig):
    """Every slot answered with slot 0's constants."""
    def fn(layout, codes, his, los, **k):
        b = len(codes)
        return orig(layout, [codes[0]] * b, [his[0]] * b, [los[0]] * b, **k)
    return fn


def far_swap(orig):
    """Ranks 1 and 6 swapped, keys, dates and revenues together."""
    def fn(*a, **k):
        out = tuple(t.clone() for t in orig(*a, **k))
        for t in out:
            t[..., [1, 6]] = t[..., [6, 1]]
        return out
    return fn


@pytest.mark.parametrize("fault", [no_segment, no_discount, slot_zero, far_swap])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    result = _run()
    assert result["correct"] is False and result["failed"] > 0


def test_an_order_split_in_two_groups_is_not_correct(monkeypatch):
    """The layout cuts each order of more than one line into two groups
    of one key, as a cut at a block's edge through an order would."""
    from repro_torch.kernels import group_topk_agg as gta

    make = gta.make_layout

    def split(test, value, discount, starts, keys, dates, codes, order=None):
        counts = starts[1:] - starts[:-1]
        cut = counts > 1
        mids = starts[:-1][cut] + counts[cut] // 2
        new_starts = torch.sort(torch.cat([starts, mids])).values
        owner = torch.searchsorted(starts, new_starts[:-1], right=True) - 1
        return make(test, value, discount, new_starts, keys[owner], dates[owner], codes[owner], order=order)

    monkeypatch.setattr(gta, "make_layout", split)
    result = _run()
    assert result["correct"] is False and result["checks"]["wrong_keys"]["value"] > 0


def test_the_control_is_not_correct():
    from portbench.harness.cell import cell_plan

    plan = cell_plan(NAME)
    driver = cell.load_module(cell.PKG / "drivers" / "closed_serve_q3.py")
    correct, checks = driver.control_numbers(plan["workload"], plan["config"], 2**31 + 7, device="cpu",
                                             scale=0.005, requests=200)
    assert correct is False
    assert checks["wrong_keys"]["value"] > 0 or checks["max_rel_err"]["value"] > checks["max_rel_err"]["limit"]


class _Trace:
    op_s = 0.004


def test_roofline_counts_the_base_tables_whatever_the_layout(monkeypatch):
    """The bytes a pass needs come from the tables' rows alone: a layout
    padded far wider reads the same count."""
    from repro_torch.kernels import group_topk_agg as gta

    plan = cell.cell_plan(NAME)
    driver_mod = cell.load_module(cell.PKG / "drivers" / "closed_serve_q3.py")
    counts = []
    for pad in (False, True):
        if pad:
            make = gta.make_layout
            monkeypatch.setattr(gta, "make_layout", lambda *a, **k: (lambda lay: lay._replace(
                rows=torch.cat([lay.rows, torch.zeros(3, 4096)], dim=1)))(make(*a, **k)))
        d = driver_mod.Driver(plan["workload"], plan["config"], 5, "cpu", 0.002)
        rec = Record()
        d.setup(rec)
        counts.append(rec.info["q3_pass_bytes"])
        li, od, cu = (next(iter(d.tables[n].values())).shape[0] for n in ("lineitem", "orders", "customer"))
        assert rec.info["q3_pass_bytes"] == q3.pass_bytes(li, od, cu) == 16 * li + 8 * od + 4 * cu
    assert counts[0] == counts[1]
    rec.passes, rec.device = ["q3"] * 3, _Trace()
    reader = cell.load_module(cell.PKG / "layer_metrics" / "roofline.q3.py")
    assert reader.read(rec) == pytest.approx(100 * 3 * counts[0] / peaks.HBM_BYTES_PER_S / 0.004)
    rec.passes = ["q1"]
    assert reader.read(rec) is None


def test_the_config_keeps_tpch_sf30():
    config = cell.cell_plan(NAME)["config"]
    assert config["scale_factor"] == 30 and config["reduced"] == []
    assert (config["lineitem_rows"], config["orders_rows"], config["customer_rows"]) == (180036450, 45000000, 4500000)
    from portbench.harness import datagen

    assert datagen.rows(30) == (180036450, 45000000) and datagen.CUSTOMERS_PER_SF * 30 == 4500000
    assert {"scale", "keys", "shippriority", "dates"} <= set(config["assumed"])
