"""The port's SlotServer and serving entry point against the JAX package's on
the CPU (Granite-3-8B, Mamba2-2.7B, the MoE models Jamba-v0.1, Grok-1 and
Kimi-K2, and OLMo-1B, InternLM2-20B and Mistral-Nemo-12B at tiny widths):
the same prompts and converted weights give the same completions; a batch
gives each request what it gets alone; budgets and max_len retire.  The
serving entry point refuses the two models that take no token prompts, as
the reference's does."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.runtime import requests as jrequests  # noqa: E402
from repro.runtime.serve_loop import Request as JRequest  # noqa: E402
from repro.runtime.serve_loop import SlotServer as JSlotServer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime import requests  # noqa: E402
from repro_torch.runtime.serve_loop import Request, SlotServer  # noqa: E402

ARCHS = ["granite-3-8b", "mamba2-2.7b", "jamba-v0.1-52b", "grok-1-314b", "kimi-k2-1t-a32b", "olmo-1b",
         "internlm2-20b", "mistral-nemo-12b"]


@pytest.fixture(scope="module")
def served():
    """Per arch: (JAX model, JAX params, port model, port params), vocab 128
    (the reference's own serving tests use a tiny model with vocab 128)."""
    out = {}
    for arch in ARCHS:
        jm = JModel(jbase.tiny(jbase.get_arch(arch), vocab_size=128))
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = base.tiny(base.get_arch(arch), vocab_size=128)
        out[arch] = (jm, jp, Model(cfg, device="cpu"), params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return out


def prompts(n, seed=5, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]


def run_port(model, params, reqs, n_slots, max_len=32):
    server = SlotServer(model, n_slots=n_slots, max_len=max_len)
    server.load(params)
    for uid, (prompt, budget) in enumerate(reqs):
        server.submit(Request(uid=uid, prompt=torch.from_numpy(prompt), max_new_tokens=budget))
    return {c.uid: c.tokens for c in server.run()}, server


@pytest.mark.parametrize("arch", ARCHS)
def test_completions_equal_reference(served, arch):
    jm, jp, model, params = served[arch]
    reqs = [(p, 4) for p in prompts(5)]
    got, _ = run_port(model, params, reqs, n_slots=3)
    jserver = JSlotServer(jm, n_slots=3, max_len=32)
    jserver.load(jp)
    for uid, (prompt, budget) in enumerate(reqs):
        jserver.submit(JRequest(uid=uid, prompt=jnp.asarray(prompt), max_new_tokens=budget))
    want = {c.uid: c.tokens for c in jserver.run()}
    assert got == want and len(got) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_equals_solo(served, arch):
    """For the MoE archs this holds because no slot drops: a decode step of
    up to 3 tokens has capacity 8 an expert, and each prompt is prefilled
    alone.  Where slots drop, a token's output depends on its batch."""
    _, _, model, params = served[arch]
    reqs = [(p, 4) for p in prompts(5, seed=6)]
    got, server = run_port(model, params, reqs, n_slots=3)
    assert set(got) == set(range(5)) and server.prefill_calls == 5
    for uid, req in enumerate(reqs):
        solo, _ = run_port(model, params, [req], n_slots=1)
        assert got[uid] == solo[0], f"uid={uid}"


def test_respects_budget(served):
    _, _, model, params = served["granite-3-8b"]
    got, server = run_port(model, params, [(np.arange(4, dtype=np.int32), 6)], n_slots=2)
    assert len(got[0]) == 6 and server.decode_calls == 5  # the first token comes from the prefill


def test_retires_at_max_len_like_reference(served):
    """A slot retires when its length reaches max_len - 1, as the reference's."""
    jm, jp, model, params = served["granite-3-8b"]
    prompt = np.arange(10, dtype=np.int32) % 128
    got, _ = run_port(model, params, [(prompt, 50)], n_slots=1, max_len=16)
    jserver = JSlotServer(jm, n_slots=1, max_len=16)
    jserver.load(jp)
    jserver.submit(JRequest(uid=0, prompt=jnp.asarray(prompt), max_new_tokens=50))
    assert got[0] == jserver.run()[0].tokens and len(got[0]) == 6  # 10 prompt slots, writes up to slot 14


def test_request_and_completion_mirror_reference():
    for ours, theirs in ((requests.Request, jrequests.Request), (requests.Completion, jrequests.Completion)):
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
        assert [f.default for f in dataclasses.fields(ours)] == [f.default for f in dataclasses.fields(theirs)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_tiny_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--tiny", "--device", "cpu", "--requests", "6", "--slots", "2",
                       "--max-new", "5"]) == 0
    assert "completed=6" in capsys.readouterr().out


def test_serve_entry_point_is_seeded_and_keeps_the_reference_defaults():
    args = serve.parse_args([])
    assert (args.requests, args.slots, args.max_len, args.max_new, args.seed, args.device) == (16, 4, 256, 16, 0, "cuda")
    cfg = base.tiny(base.get_arch("granite-3-8b"))
    a, b = serve.prompts(cfg, 8, 1, "cpu"), serve.prompts(cfg, 8, 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(4 <= len(x) < 32 and int(x.max()) < cfg.vocab_size for x in a)
    res = serve.serve(serve.parse_args(["--tiny", "--device", "cpu", "--requests", "3", "--slots", "3", "--max-new", "4"]))
    assert res.prefill_calls == 3 and res.decode_calls == 3 and res.new_tokens == 12


def test_serve_refuses_models_without_token_prompts(capsys):
    """An encoder-decoder gets the reference's message and code 2; a model of
    embeddings (Qwen2-VL) raises a ValueError: the SlotServer feeds int
    tokens, in the reference too."""
    assert serve.main(["--arch", "seamless-m4t-medium", "--tiny", "--device", "cpu"]) == 2
    assert "is encoder-decoder" in capsys.readouterr().out
    with pytest.raises(ValueError, match="embeddings"):
        serve.serve(serve.parse_args(["--arch", "qwen2-vl-72b", "--tiny", "--device", "cpu"]))
    with pytest.raises(ValueError, match="frames"):
        serve.serve(serve.parse_args(["--arch", "seamless-m4t-medium", "--tiny", "--device", "cpu"]))
