"""The port's checkpoints (``repro_torch.checkpoint``): the JAX package's
checkpoint tests (``tests/test_runtime.py``) on torch tensors, and
checkpoints written by one package and restored by the other, exactly."""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402


def nested():
    """Nested dicts (and a list) of f32 and int32 leaves, keys out of order."""
    return {
        "w": torch.arange(12.0).reshape(3, 4),
        "b": {"z": torch.arange(5, dtype=torch.int32) - 2, "a": torch.full((2, 2), 0.25)},
        "layers": [torch.ones(3), {"scale": torch.tensor([7], dtype=torch.int32)}],
    }


def jax_like(tree):
    return jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), t.numpy().dtype), tree,
                                  is_leaf=lambda x: isinstance(x, torch.Tensor))


def assert_tree_equal(got, want):
    g, w = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor)), \
        jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    ckpt.save(tmp_path, 7, tree)
    got, step = ckpt.restore(tmp_path, like=tree, device="cpu")
    assert step == 7
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"]["c"], tree["b"]["c"])
    assert got["b"]["c"].dtype == torch.int32


def test_checkpoint_retention_and_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (10, 20, 30, 40):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.committed_steps(tmp_path) == [30, 40]
    assert ckpt.latest_step(tmp_path) == 40


def test_checkpoint_crash_mid_save_invisible(tmp_path):
    """A stale .tmp staging dir (simulated crash) is never listed as committed."""
    tree = {"x": torch.zeros(2)}
    ckpt.save(tmp_path, 5, tree)
    stage = tmp_path / "step_00000009.tmp-999-123"
    stage.mkdir()
    (stage / "partial.npy").write_bytes(b"junk")
    assert ckpt.latest_step(tmp_path) == 5
    _, step = ckpt.restore(tmp_path, like=tree, device="cpu")
    assert step == 5


def test_async_checkpointer_commits(tmp_path):
    w = ckpt.AsyncCheckpointer(tmp_path, keep=3)
    w.save(3, {"x": torch.full((4,), 3.0)})
    w.wait()
    assert w.last_committed == 3
    got, _ = ckpt.restore(tmp_path, like={"x": torch.zeros(4)}, device="cpu")
    assert torch.equal(got["x"], torch.full((4,), 3.0))


def test_restore_rejects_wrong_template(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(2), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, like={"a": torch.zeros(2)}, device="cpu")


def test_bfloat16_leaf_raises(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.save(tmp_path, 1, {"a": torch.zeros(2, dtype=torch.bfloat16)})
    assert ckpt.committed_steps(tmp_path) == []


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    ckpt.save(tmp_path, 1, {"a": torch.zeros(2)})
    with pytest.raises((RuntimeError, AssertionError)):
        ckpt.restore(tmp_path, like={"a": torch.zeros(2)})


def test_manifest_matches_the_reference(tmp_path):
    """Paths, tree definition, files and leaf metadata as the JAX package writes them."""
    tree = nested()
    ckpt.save(tmp_path / "port", 2, tree)
    jckpt.save(tmp_path / "ref", 2, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree,
                                                           is_leaf=lambda x: isinstance(x, torch.Tensor)))
    port = json.loads((tmp_path / "port/step_00000002/manifest.json").read_text())
    ref = json.loads((tmp_path / "ref/step_00000002/manifest.json").read_text())
    assert port == ref


def test_port_writes_reference_reads(tmp_path):
    tree = nested()
    ckpt.save(tmp_path, 11, tree)
    got, step = jckpt.restore(tmp_path, like=jax_like(tree))
    assert step == 11
    assert_tree_equal(got, tree)
    assert isinstance(got["layers"], list) and got["b"]["z"].dtype == jnp.int32


def test_reference_writes_port_reads(tmp_path):
    tree = nested()
    jtree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree,
                                   is_leaf=lambda x: isinstance(x, torch.Tensor))
    jckpt.save(tmp_path, 4, jtree)
    jckpt.save(tmp_path, 9, jax.tree_util.tree_map(lambda x: x + 1, jtree))
    got, step = ckpt.restore(tmp_path, like=tree, device="cpu")
    assert step == 9
    assert_tree_equal(got, jax.tree_util.tree_map(lambda t: t + 1, tree,
                                                  is_leaf=lambda x: isinstance(x, torch.Tensor)))
    old, _ = ckpt.restore(tmp_path, 4, like=tree, device="cpu")
    assert_tree_equal(old, tree)
    assert isinstance(old["layers"][1]["scale"], torch.Tensor) and old["b"]["z"].dtype == torch.int32
