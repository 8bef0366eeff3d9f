"""The port's checkpoints against the JAX package's: one file format.

* A tree saved by the JAX package (``repro.checkpoint.save_pytree``)
  loads in the port bit for bit, and a tree saved by the port loads in
  the JAX package bit for bit: float32, int32 (a 0-d step counter),
  nested dicts, lists and tuples, ``None`` subtrees.  The manifest holds
  the JAX ``keystr`` paths in the JAX flatten order.
* A JAX DANA pod-round train state (``repro.launch.steps
  .init_train_state``, 2 pods) loads into the structure of the port's
  own train state, and the port's state into the JAX one's.
* bfloat16 leaves: the port keeps their 16-bit patterns (numpy reads a
  JAX bfloat16 leaf back as ``V2``, the same bits), so a JAX bfloat16
  checkpoint and the port's own load bit for bit into bfloat16 leaves.
* Structure and shape mismatches raise; writes leave no temporary file.
* ``CheckpointManager``: retention, restore of the latest or a given
  step, the metrics sidecar, an empty directory (as
  ``tests/test_checkpoint.py`` holds the JAX manager).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.configs import get_config as jget
from repro.launch import steps as jsteps
from repro.models.api import build_model as jbuild

from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.checkpoint.io import keystr_paths
from repro_torch.configs import get_config
from repro_torch.core.types import tree_leaves
from repro_torch.launch import steps
from repro_torch.models.api import build_model


def _jtree():
    rng = np.random.default_rng(0)
    return {"theta": {"unit": [{"mlp": {"w1": rng.standard_normal(
                (2, 3, 4)).astype(np.float32)}}],
                      "b": (rng.standard_normal(5).astype(np.float32), None)},
            "t": np.int32(7), "v": [np.arange(6, dtype=np.int32)]}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_keystr_paths_are_jax_keystr_in_flatten_order():
    tree = _jtree()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert keystr_paths(tree) == [jax.tree_util.keystr(p) for p, _ in flat]
    assert keystr_paths(tree)[2] == "['theta']['unit'][0]['mlp']['w1']"


def test_jax_save_port_load_and_back_bit_for_bit(tmp_path):
    tree = _jtree()
    jsave(str(tmp_path / "j.npz"), jax.tree.map(jnp.asarray, tree))
    got = load_pytree(str(tmp_path / "j.npz"), _torch(tree))
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(got)):
        assert isinstance(b, torch.Tensor) and b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)
    assert got["theta"]["b"][1] is None and got["t"].dim() == 0
    save_pytree(str(tmp_path / "p.npz"), got)
    back = jload(str(tmp_path / "p.npz"), jax.tree.map(jnp.asarray, tree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(b), a)
    assert sorted(os.listdir(tmp_path)) == ["j.npz", "p.npz"]


def test_train_states_cross_load(tmp_path):
    jcfg = dataclasses.replace(jget("qwen2-1.5b").reduced(), vocab_size=64)
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              vocab_size=64)
    jstate = jax.jit(lambda k: jsteps.init_train_state(jbuild(jcfg), k, 2))(
        jax.random.PRNGKey(0))
    state = steps.init_train_state(build_model(cfg),
                                   torch.Generator().manual_seed(0), 2, "cpu")
    jsave(str(tmp_path / "j.npz"), jstate)
    got = load_pytree(str(tmp_path / "j.npz"), state)
    for a, b in zip(jax.tree.leaves(jstate), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    save_pytree(str(tmp_path / "p.npz"), state)
    back = jload(str(tmp_path / "p.npz"), jstate)
    for a, b in zip(tree_leaves(state), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
    assert back["t"].dtype == jnp.int32


def test_bfloat16_leaves_keep_their_bits(tmp_path):
    x = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(1)
                          ).bfloat16()}
    save_pytree(str(tmp_path / "p.npz"), x)
    assert torch.equal(load_pytree(str(tmp_path / "p.npz"), x)["w"], x["w"])
    jw = jnp.asarray(np.arange(6, dtype=np.float32) / 7, jnp.bfloat16)
    jsave(str(tmp_path / "j.npz"), {"w": jw})
    got = load_pytree(str(tmp_path / "j.npz"),
                      {"w": torch.zeros(6, dtype=torch.bfloat16)})["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jw, np.float32))
    with pytest.raises(TypeError, match="bfloat16"):
        load_pytree(str(tmp_path / "j.npz"), {"w": torch.zeros(6)})


def test_non_contiguous_leaves_round_trip(tmp_path):
    x = {"a": torch.arange(6.0).reshape(2, 3).t(), "t": torch.tensor(3)}
    save_pytree(str(tmp_path / "p.npz"), x)
    got = load_pytree(str(tmp_path / "p.npz"), x)
    assert torch.equal(got["a"], x["a"]) and got["t"].dim() == 0
    np.testing.assert_array_equal(np.load(str(tmp_path / "p.npz"))["leaf_0"],
                                  x["a"].numpy())


def test_structure_and_shape_mismatch_raise(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_pytree(p, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="structure"):
        load_pytree(p, {"b": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(p, {"a": torch.ones(4)})


def test_corrupted_leaf_fails_its_crc(tmp_path):
    """A flipped byte in a leaf's data fails the entry's CRC on load, as
    in the JAX package's loader (both read with np.load)."""
    import zipfile
    p = str(tmp_path / "ck.npz")
    x = {"a": torch.arange(4096.0)}
    save_pytree(p, x)
    with zipfile.ZipFile(p) as zf:
        info = zf.getinfo("leaf_0.npy")
    raw = bytearray(open(p, "rb").read())
    raw[info.header_offset + 30 + len(info.filename) + 20 + 4000] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        load_pytree(p, x)
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        jload(p, {"a": jnp.zeros(4096)})


def test_manager_retention_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep_last=2)
    tree = {"w": torch.arange(4.0)}
    for step in (10, 20, 30):
        mgr.save(step, {"w": tree["w"] + step})
        mgr.log_metrics(step, loss=1.0 / step)
    assert mgr.steps() == [20, 30]          # retention pruned step 10
    assert mgr.latest_step() == 30
    restored, step = mgr.restore(tree)
    assert step == 30
    assert torch.equal(restored["w"], torch.arange(4.0) + 30)
    restored20, _ = mgr.restore(tree, step=20)
    assert torch.equal(restored20["w"], torch.arange(4.0) + 20)
    ms = mgr.read_metrics()
    assert [m["step"] for m in ms] == [10, 20, 30]
    assert ms[0]["loss"] == pytest.approx(0.1)
    # the JAX manager reads the port's directory
    from repro.checkpoint import CheckpointManager as JManager
    jtree, jstep = JManager(str(tmp_path / "ckpts")).restore(
        {"w": jnp.zeros(4)})
    assert jstep == 30
    np.testing.assert_array_equal(np.asarray(jtree["w"]), np.arange(4.0) + 30)


def test_manager_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"))
    tree, step = mgr.restore({"w": torch.zeros(2)})
    assert tree is None and step is None
    assert mgr.read_metrics() == [] and mgr.latest_step() is None
