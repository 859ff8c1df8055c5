"""The port's sharding and cost model (``repro_torch.core.{shard,cost}``)
against the JAX package's on the CPU: the same keys land on the same shards
under every partition (hash, weighted, cost-balanced, ``@auto``), and the
same cache entries give the same cost estimates at every tier."""
from __future__ import annotations

import hashlib
import json
import random
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.core import cache as jcache  # noqa: E402
from repro.core import cost as jcost  # noqa: E402
from repro.core import platform as jplatform  # noqa: E402
from repro.core import shard as jshard  # noqa: E402
from repro_torch.core import cache, cost, platform, shard  # noqa: E402


def keys(n: int, seed: int = 0) -> list[str]:
    rng = random.Random(seed)
    return [hashlib.sha256(str(rng.random()).encode()).hexdigest() for _ in range(n)]


def costs_for(ks: list[str], seed: int = 1) -> dict[str, float]:
    rng = random.Random(seed)
    return {k: rng.choice([0.5, 1.0, 2.0, 100.0]) * rng.random() + 0.01 for k in ks}


# -- shard assignment ---------------------------------------------------------------
@pytest.mark.parametrize("count,weights", [(1, None), (3, None), (4, (0.1, 0.3, 0.3, 0.3)), (2, (0.25, 0.75)),
                                           (5, (1.0,) * 5)])
def test_shard_of_partition_and_ranks_equal_reference(count, weights):
    ks = keys(200)
    assert [shard.shard_of(k, count, weights) for k in ks] == [jshard.shard_of(k, count, weights) for k in ks]
    assert shard.partition(ks, count, weights) == jshard.partition(ks, count, weights)
    assert [shard.rank_shards(k, count, weights) for k in ks[:20]] == [
        jshard.rank_shards(k, count, weights) for k in ks[:20]]


@pytest.mark.parametrize("text", ["0/1", "1/3", "0/2@0.25", "1/2@0.75", "2/3@0.5:0.25:0.25", "0/4@auto"])
def test_shard_spec_parse_equals_reference(text):
    got, want = shard.ShardSpec.parse(text), jshard.ShardSpec.parse(text)
    assert (got.index, got.count, got.weights, str(got), got.is_auto) == (
        want.index, want.count, want.weights, str(want), want.is_auto)
    if not got.is_auto:
        ks = keys(64, seed=3)
        assert shard.assigned(ks, got) == jshard.assigned(ks, want)
        assert got.weight == want.weight


@pytest.mark.parametrize("text", ["3/2", "0/0", "0/2@", "0/2@1.5", "0/3@0.5:0.5", "0/2@fast", "x/2"])
def test_bad_shard_specs_raise_like_reference(text):
    for mod in (shard, jshard):
        with pytest.raises(ValueError):
            mod.ShardSpec.parse(text)


@pytest.mark.parametrize("count,weights,slack", [(2, None, 1.5), (3, (0.2, 0.4, 0.4), 1.5), (4, None, 1.0),
                                                 (3, "auto", 1.5), (2, (0.9, 0.1), 2.0)])
def test_cost_partition_equals_reference(count, weights, slack):
    ks = keys(120, seed=5)
    ks = ks + ks[:10]  # duplicates (overlapping task specs) count once per occurrence
    costs = costs_for(ks)
    got = shard.cost_partition(ks, count, weights, costs, slack)
    assert got == jshard.cost_partition(ks, count, weights, costs, slack)
    assert shard.cost_shard_map(ks, count, weights, costs, slack) == jshard.cost_shard_map(
        ks, count, weights, costs, slack)
    assert sorted(k for b in got for k in b) == sorted(ks)  # disjoint cover


EVIDENCE = [
    [{"capacity": 4, "ewma_s": 0.5}, {"capacity": 1, "ewma_s": 0.5}],
    [{"capacity": 2, "ewma_s": None}, None, {"capacity": "x", "ewma_s": 2.0}],
    [],
    [{"capacity": 8, "ewma_s": 1e-3}] * 4,
]


@pytest.mark.parametrize("i", range(len(EVIDENCE)))
@pytest.mark.parametrize("default_unit_s", [None, 0.25])
def test_resolve_auto_weights_equals_reference(i, default_unit_s):
    count = max(len(EVIDENCE[i]), 2)
    got = shard.resolve_auto_weights(count, EVIDENCE[i], default_unit_s=default_unit_s)
    assert got == jshard.resolve_auto_weights(count, EVIDENCE[i], default_unit_s=default_unit_s)
    assert sum(got) == pytest.approx(1.0)


def test_resolve_auto_weights_rejects_like_reference():
    for mod in (shard, jshard):
        with pytest.raises(ValueError):
            mod.resolve_auto_weights(0)
        with pytest.raises(ValueError):
            mod.resolve_auto_weights(8, grid=4)


# -- cost model ------------------------------------------------------------------------
def seeded_cache(mod, path):
    """One cache of each package over the same entries (and EWMA sidecar)."""
    c = mod.ResultCache(path / "c.json")
    rng = random.Random(9)
    for i in range(12):
        task = ("pushdown_torch", "serving_torch", "compute_torch")[i % 3]
        plat = ("cpu-host", "dpu-sim")[i % 2]
        c.put(f"k{i}", {"m": 1.0}, task=task, params={"i": i}, platform=plat, elapsed_s=rng.random() + 0.1)
    c.costs.observe("memory_torch", "dpu-sim", 0.4)  # EWMA-only evidence
    c.flush()
    return mod.ResultCache(path / "c.json")


CASES = [
    ("k3", "pushdown_torch", "cpu-host"),  # measured
    ("new", "pushdown_torch", "cpu-host"),  # task-platform mean
    ("new", "memory_torch", "dpu-sim"),  # ewma
    ("new", "compute_torch", "default"),  # task mean x scale
    ("new", "strings_torch", "dpu-sim"),  # heuristic
    ("new", "strings_torch", "cpu-host"),  # uniform
    (None, "", "dpu-sim"),
]


def test_cost_model_estimates_equal_reference(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    model = cost.CostModel(seeded_cache(cache, tmp_path / "a"))
    jmodel = jcost.CostModel(seeded_cache(jcache, tmp_path / "b"))
    assert (model.measured_points, model.mean_elapsed_s) == (jmodel.measured_points, jmodel.mean_elapsed_s)
    sources = []
    for key, task, plat in CASES:
        got = model.explain(key, task=task, platform=platform.get_platform(plat))
        want = jmodel.explain(key, task=task, platform=jplatform.get_platform(plat))
        assert got == want
        sources.append(got[1])
    assert sources[:6] == list(cost.SOURCES)
    units = [SimpleNamespace(skey=k, ckey=k, task_name=t, platform=platform.get_platform(p)) for k, t, p in CASES
             if k]
    junits = [SimpleNamespace(skey=k, ckey=k, task_name=t, platform=jplatform.get_platform(p)) for k, t, p in CASES
              if k]
    assert model.estimate_many(units) == jmodel.estimate_many(junits)
    assert cost.CostModel().explain("k3", task="t") == jcost.CostModel().explain("k3", task="t") == (1.0, "uniform")


def test_cost_model_reads_a_cache_written_by_the_reference(tmp_path):
    c = seeded_cache(jcache, tmp_path)
    model = cost.CostModel(cache.ResultCache(c.path))
    assert model.measured_points == 12
    assert json.loads((tmp_path / "costs.json").read_text())["entries"]["memory_torch"]["dpu-sim"]["ewma_s"] == 0.4
    assert model.explain("new", task="memory_torch", platform=platform.get_platform("dpu-sim")) == (0.4, "ewma")
