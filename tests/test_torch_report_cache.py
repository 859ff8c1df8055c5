"""The port's report and result cache (``repro_torch.core.{report,cache}``)
against the JAX package's on the CPU: the same rows give the same CSV,
markdown, merged shard tables and speedup tables, character for character;
the same measurement identity gives the same cache key; and a cache file
written by either package reads back in the other."""
from __future__ import annotations

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core import box as jbox  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core import report as jreport  # noqa: E402
from repro_torch.core import box, cache, report  # noqa: E402

BOX = {
    "name": "r",
    "platforms": ["cpu-host", "dpu-sim"],
    "tasks": [
        {"task": "pushdown_torch", "params": {"selectivity": [0.01, 0.1], "plan": ["baseline", "pushdown"]}},
        {"task": "serving_torch", "params": {"query": ["q6"], "rate": [25.0, 100.0]}},
    ],
}


def rows_for(b, platforms=("cpu-host", "dpu-sim")) -> list[dict]:
    """Report rows as a multi-platform sweep of ``b`` emits them, with values
    that exercise every branch of the number format."""
    vals = [1234567.0, 0.0001234, 12.5, 0.0, float("nan"), 3.0, 250.125, 1e-7]
    out = []
    for plat in platforms:
        i = 0  # the same values at each platform's grid point, dilated on dpu-sim
        for spec in b.tasks:
            for params in spec.expand():
                row = {"task": spec.task, **{f"param:{k}": v for k, v in params.items()}}
                row["items_per_s"] = vals[i % len(vals)] * (3.5 if plat == "dpu-sim" else 1.0)
                row["avg_latency_us"] = vals[(i + 3) % len(vals)]
                row["platform"] = plat
                out.append(row)
                i += 1
    return out


@pytest.fixture()
def rows():
    return rows_for(box.Box.from_dict(BOX))


# -- report text -----------------------------------------------------------------
def test_csv_and_markdown_equal_reference(rows):
    assert report.to_csv(rows) == jreport.to_csv(rows)
    assert report.to_markdown(rows) == jreport.to_markdown(rows)
    assert report.to_csv([]) == jreport.to_csv([]) == ""
    assert report.to_markdown([]) == jreport.to_markdown([])
    assert report.to_csv(rows).splitlines()[0].startswith("platform,task,param:")


@pytest.mark.parametrize("platforms", [None, ["cpu-host", "dpu-sim"], ["dpu-sim"]])
def test_box_row_order_equals_reference(platforms):
    assert report.box_row_order(box.Box.from_dict(BOX), platforms) == jreport.box_row_order(
        jbox.Box.from_dict(BOX), platforms)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_merge_shard_reports_equals_reference(rows, n_shards):
    shards = [rows[i::n_shards][::-1] for i in range(n_shards)]  # scrambled order
    got = report.merge_shard_reports(shards, box=box.Box.from_dict(BOX))
    want = jreport.merge_shard_reports(shards, box=jbox.Box.from_dict(BOX))
    assert json.dumps(got) == json.dumps(want) == json.dumps(rows)  # NaN too
    # Without a box: the sorted order, the reference's.
    assert json.dumps(report.merge_shard_reports(shards)) == json.dumps(jreport.merge_shard_reports(shards))
    # A shard passed twice keeps each key at the box's multiplicity.
    dup = report.merge_shard_reports(shards + [shards[0]], box=box.Box.from_dict(BOX))
    assert json.dumps(dup) == json.dumps(rows)


def test_speedup_table_equals_reference(rows):
    got = report.speedup_table(rows, "items_per_s", "cpu-host")
    assert json.dumps(got) == json.dumps(jreport.speedup_table(rows, "items_per_s", "cpu-host"))  # NaN too
    ratios = [r["speedup:dpu-sim"] for r in got if r["speedup:dpu-sim"] == r["speedup:dpu-sim"]]
    assert ratios and ratios == pytest.approx([3.5] * len(ratios))


@pytest.mark.parametrize("fmt", ["json", "csv"])
def test_load_report_rows_equals_reference(rows, tmp_path, fmt):
    path = tmp_path / f"shard.{fmt}"
    if fmt == "json":
        path.write_text(json.dumps({"box": "r", "rows": rows[:4]}, default=str))
    else:
        path.write_text(report.to_csv(rows[:4]))
    got, want = report.load_report_rows(path), jreport.load_report_rows(path)
    assert json.dumps(got, default=str) == json.dumps(want, default=str)
    assert report.to_csv(got) == jreport.to_csv(want)


# -- cache keys and files ----------------------------------------------------------
KEYS = [
    dict(task="pushdown_torch", params={"plan": "pushdown", "selectivity": 0.1},
         platform={"name": "dpu-sim", "kind": "sim", "time_scale": 3.5, "flags": {"wimpy_cores": True}},
         iters=3, warmup=1, metrics=("items_per_s",)),
    dict(task="t", params={}, platform={"name": "cpu-host", "device": "cpu"}, iters=5, warmup=2,
         metrics=("a", "b"), fingerprint="0123456789abcdef"),
    dict(task="t", params={"x": [1, 2]}, platform={}, iters=1, warmup=0, metrics=(), min_time_s=0.5),
]


@pytest.mark.parametrize("kw", KEYS, ids=["pushdown", "fingerprint", "min_time"])
def test_cache_key_equals_reference(kw):
    assert cache.cache_key(**kw) == jcache.cache_key(**kw)


def test_cache_key_sensitivity():
    base = KEYS[0]
    k = cache.cache_key(**base)
    assert cache.cache_key(**{**base, "params": {"plan": "baseline", "selectivity": 0.1}}) != k
    assert cache.cache_key(**{**base, "platform": {**base["platform"], "device": "cpu"}}) != k
    assert cache.cache_key(**{**base, "warmup": 0}) != k
    assert cache.cache_key(**base, fingerprint="abc") != k


@pytest.mark.parametrize("writer,reader", [(cache, jcache), (jcache, cache)], ids=["port->ref", "ref->port"])
def test_cache_file_reads_across_packages(tmp_path, writer, reader):
    path = tmp_path / "c.json"
    w = writer.ResultCache(path)
    w.put("k1", {"m": 1.5}, task="t", params={"a": 1}, platform="cpu-host", elapsed_s=0.25)
    w.put("k2", {"m": 2.0}, task="t", params={"a": 2}, platform="dpu-sim", elapsed_s=0.75)
    w.flush()
    r = reader.ResultCache(path)
    assert r.get("k1") == {"m": 1.5} and r.get("k2") == {"m": 2.0} and r.get("k3") is None
    assert (r.hits, r.misses) == (2, 1)
    assert r.costs.get("t", "dpu-sim") == 0.75
    assert json.loads((tmp_path / "costs.json").read_text())["entries"] == {
        "t": {"cpu-host": {"ewma_s": 0.25, "n": 1}, "dpu-sim": {"ewma_s": 0.75, "n": 1}}}


@pytest.mark.parametrize("policy", [{"max_entries": 2}, {"max_age_s": 50.0}, {"max_entries": 0}])
def test_eviction_equals_reference(tmp_path, policy):
    now = time.time()
    kept = []
    for mod in (cache, jcache):
        path = tmp_path / mod.__name__ / "c.json"
        c = mod.ResultCache(path, **policy)
        for i, age in enumerate((200.0, 100.0, 10.0, 1.0)):
            c.put(f"k{i}", {"m": float(i)}, task="t", platform="p", elapsed_s=1.0 + i)
            c._entries[f"k{i}"]["saved_unix"] = now - age
        c.flush()
        kept.append((sorted(json.loads(path.read_text())["entries"]), c.evicted))
        # The EWMA sidecar outlives the evicted entries.
        # (EWMA at alpha 0.25 of 1, 2, 3, 4.)
        assert mod.ResultCache(path).costs.get("t", "p") == pytest.approx(2.265625)
    assert kept[0] == kept[1]


def test_ewma_store_equals_reference(tmp_path):
    stores = [cache.EwmaCostStore(tmp_path / "a.json"), jcache.EwmaCostStore(tmp_path / "b.json")]
    for s in stores:
        for task, plat, x in (("t", "p", 1.0), ("t", "p", 3.0), ("u", "q", "bad"), ("", "p", 1.0), ("t", "p", -1)):
            s.observe(task, plat, x)
        s.flush()
    assert stores[0].snapshot() == stores[1].snapshot() == {("t", "p"): {"ewma_s": 1.5, "n": 2}}
    assert json.loads((tmp_path / "a.json").read_text()) == json.loads((tmp_path / "b.json").read_text())
    with pytest.raises(ValueError, match="alpha"):
        cache.EwmaCostStore(tmp_path / "c.json", alpha=0.0)


def test_corrupt_and_foreign_version_files_read_as_empty(tmp_path):
    path = tmp_path / "c.json"
    path.write_text("{ not json")
    assert len(cache.ResultCache(path)) == 0
    path.write_text(json.dumps({"version": 99, "entries": {"k": {"metrics": {"m": 1}}}}))
    c = cache.ResultCache(path)
    assert len(c) == 0
    c.put("k", {"m": 2.0})
    c.flush()
    assert json.loads(path.read_text())["version"] == cache.CACHE_VERSION == jcache.CACHE_VERSION


def test_atomic_writes_leave_no_temporaries(tmp_path):
    path = tmp_path / "d" / "c.json"
    c = cache.ResultCache(path)
    for i in range(5):
        c.put(f"k{i}", {"m": float(i)}, task="t", platform="p", elapsed_s=0.1)
        c.flush()
    assert sorted(os.listdir(path.parent)) == ["c.json", "costs.json"]


def test_claims_publish_and_refresh(tmp_path):
    path = tmp_path / "c.json"
    a, b = cache.ResultCache(path), cache.ResultCache(path)
    assert a.try_claim("u1", "runner-a") and not b.try_claim("u1", "runner-b")
    assert b.claimed("u1") and b.claim_owner("u1") == "runner-a"
    a.put("u1", {"m": 7.0})
    a.publish("u1")
    assert b.get("u1") is None and b.refresh("u1") == {"m": 7.0} and b.get("u1") == {"m": 7.0}
    a.clear()
    assert not a.claimed("u1") and cache.ResultCache(path).get("u1") is None


def test_clear_does_not_create_a_file(tmp_path):
    path = tmp_path / "c.json"
    cache.ResultCache(path).clear()
    assert not path.exists()
