"""The port's training side on the CPU against the JAX package: the
synthetic data pipeline's batches, the straggler monitor on one time
series, tiny OLMo-1B training until its loss falls, the restart drill
through ``run_with_restarts``, gradient accumulation against one full batch,
a checkpoint the reference's ``train`` writes restored by the port's
``train``, and the ``launch.train`` entry point."""
from __future__ import annotations

import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.tree import tree_leaves  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402

LOSS_RTOL = 1e-5  # f32 compute in both packages
ACCUM_RTOL = 1e-5  # microbatch sums against one full batch: rounding only


def tiny_model(arch="olmo-1b", **kw):
    cfg = base.tiny(base.get_arch(arch), **kw)
    return cfg, Model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-72b", "seamless-m4t-medium", "mamba2-2.7b"])
def test_batches_have_the_reference_contract(arch):
    """Keys, shapes and types of the reference's batch for token, embedding
    with M-RoPE (Qwen2-VL), encoder-decoder and SSM configs; the labels'
    map; a batch is a pure function of (seed, step)."""
    cfg = base.tiny(base.get_arch(arch))
    data = pipeline.for_model(cfg, seq_len=32, global_batch=4, seed=3, device="cpu")
    jdata = jpipeline.for_model(jbase.tiny(jbase.get_arch(arch)), seq_len=32, global_batch=4, seed=3)
    got, want = data.batch_at(5), jdata.batch_at(5)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    tokens = got["tgt_tokens" if cfg.encoder_decoder else "inputs" if cfg.embed_inputs else "labels"]
    if cfg.embed_inputs or cfg.encoder_decoder:
        assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
        assert torch.equal(got["labels"], (31 * tokens + 7) % min(64, cfg.vocab_size))
    else:
        assert int(got["labels"].max()) < 64
    for name in ("frames", "inputs"):
        if name in got and got[name].dtype.is_floating_point:
            assert abs(float(got[name].std()) - 0.02) < 3e-3
    if "positions" in got:
        want_pos = torch.arange(32, dtype=torch.int32).expand(got["positions"].shape)
        assert torch.equal(got["positions"], want_pos)
    again, other = data.batch_at(5), data.batch_at(6)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["labels"], other["labels"])
    assert data.host_batch == 4


def test_straggler_monitor_equals_reference():
    """The same flags, count and callback arguments on one time series."""
    rng = np.random.default_rng(0)
    times = list(0.01 + 0.001 * rng.random(60))
    for i in (3, 8, 20, 21, 45):
        times[i] *= 5.0
    calls, jcalls = [], []
    mon = train_loop.StragglerMonitor(3.0, 20, lambda *a: calls.append(a))
    jmon = jtrain.StragglerMonitor(3.0, 20, lambda *a: jcalls.append(a))
    flags = [mon.observe(dt, i) for i, dt in enumerate(times)]
    assert flags == [jmon.observe(dt, i) for i, dt in enumerate(times)]
    assert mon.count == jmon.count == 4 and calls == jcalls  # step 3 comes before the 5-sample warmup


def test_tiny_olmo_trains_and_its_loss_falls():
    cfg, model = tiny_model()
    data = pipeline.for_model(cfg, seq_len=64, global_batch=8, device="cpu")
    res = train_loop.train(model, data, train_loop.TrainConfig(steps=20, warmup_steps=5, lr=3e-3))
    assert res.final_step == 20 and len(res.losses) == 20 and len(res.step_times) == 20
    assert all(np.isfinite(res.losses)) and np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.1
    assert all(p.dtype == torch.float32 for p in tree_leaves(res.params))  # the master weights


def test_run_with_restarts_survives_an_injected_failure(tmp_path):
    """failure_at=6 with a checkpoint every 4 steps: one restart, restored
    from step 4, 12 steps in all; the resumed run's losses equal an
    uninterrupted run's from step 4 on (batches are pure in the step)."""
    cfg, model = tiny_model()
    data = pipeline.for_model(cfg, seq_len=32, global_batch=4, device="cpu")
    tc = train_loop.TrainConfig(steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / "ck"), warmup_steps=2, lr=3e-3,
                                failure_at=6)
    res = train_loop.run_with_restarts(model, data, tc)
    assert (res.restarts, res.restored_from, res.final_step, len(res.losses)) == (1, 4, 12, 8)
    assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3])
    whole = train_loop.train(model, data, dataclasses.replace(tc, ckpt_dir=None, failure_at=None))
    np.testing.assert_allclose(res.losses, whole.losses[4:], rtol=1e-6)
    with pytest.raises(ValueError, match="checkpoint dir"):
        train_loop.run_with_restarts(model, data, dataclasses.replace(tc, ckpt_dir=None))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-72b", "mamba2-2.7b"])
def test_accumulation_equals_one_full_batch(arch):
    """accum_steps=2 over [2, B/2, ...] microbatches: the loss and every
    gradient of one full batch (M-RoPE positions split on their batch axis).
    Not for MoE: its capacity and load-balance loss depend on the tokens a
    forward sees."""
    cfg, model = tiny_model(arch)
    data = pipeline.for_model(cfg, seq_len=16, global_batch=4, device="cpu")
    batch = data.batch_at(0)
    probe = optim.Optimizer("probe", lambda p: (), lambda g, s, p, lr: (p, s, {"grads": g}))
    sched = optim.make_schedule("constant", peak_lr=1e-3)
    params = train_loop.master_params(model, 0)
    _, _, full = train_loop.make_train_step(model, probe, sched)(params, (), batch, 0)
    micro = train_loop.split_microbatches(batch, 2)
    assert all(v.shape[0] == 2 for v in micro.values())
    _, _, acc = train_loop.make_train_step(model, probe, sched, accum_steps=2)(params, (), micro, 0)
    np.testing.assert_allclose(float(acc["loss"]), float(full["loss"]), rtol=ACCUM_RTOL)
    for g, w in zip(tree_leaves(acc["grads"]), tree_leaves(full["grads"])):
        assert float((g - w).norm()) <= ACCUM_RTOL * max(float(w.norm()), 1e-12)


def test_port_train_restores_a_reference_checkpoint(tmp_path):
    """The reference's train writes tiny OLMo-1B's params and AdamW state at
    step 4; the port's train restores them leaf for leaf (restored_from 4),
    and its loss at the restored params equals the reference's on a shared
    batch; trained on to step 6, it writes a checkpoint the reference
    restores."""
    ck = str(tmp_path / "ck")
    jcfg = jbase.tiny(jbase.get_arch("olmo-1b"))
    jm = JModel(jcfg)
    jdata = jpipeline.for_model(jcfg, seq_len=16, global_batch=4)
    jtrain.train(jm, jdata, jtrain.TrainConfig(steps=4, ckpt_every=2, ckpt_dir=ck, warmup_steps=1))
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jopt = jax.eval_shape(jadamw.init, jparams)
    jtree, jstep = jckpt.restore(ck, like={"params": jparams, "opt": jopt})
    assert jstep == 4

    cfg, model = tiny_model()
    data = pipeline.for_model(cfg, seq_len=16, global_batch=4, device="cpu")
    res = train_loop.train(model, data, train_loop.TrainConfig(steps=4, ckpt_every=2, ckpt_dir=ck))
    assert res.restored_from == 4 and res.final_step == 4 and res.losses == []
    got, want = tree_leaves({"params": res.params, "opt": res.opt_state}), jax.tree_util.tree_leaves(jtree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.default_rng(1)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, 64, (2, 16)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()}
    jl, _ = jm.loss(jtree["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = model.loss(res.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)

    res = train_loop.train(model, data, train_loop.TrainConfig(steps=6, ckpt_every=2, ckpt_dir=ck))
    assert res.restored_from == 4 and res.final_step == 6 and len(res.losses) == 2
    back, step = jckpt.restore(ck, like={"params": jparams, "opt": jopt})
    assert step == 6
    for g, w in zip(tree_leaves({"params": res.params, "opt": res.opt_state}), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_launch_train_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch olmo-1b --tiny --steps 20
    --device cpu`` exits 0 with the reference's lines, its loss fallen; a
    mesh (``--data 2``) is refused."""
    assert launch_train.main(["--arch", "olmo-1b", "--tiny", "--steps", "20", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^arch=olmo-1b params=[\d.]+M device=cpu steps=20 batch=8x128$", out, re.M)
    done = re.search(r"^done: step=20 loss\[0\]=([\d.]+) loss\[-1\]=([\d.]+) restarts=0 ", out, re.M)
    assert done and float(done.group(2)) < float(done.group(1))
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "olmo-1b", "--tiny", "--device", "cpu", "--data", "2"])
    assert "no mesh" in capsys.readouterr().err
