"""Packed sequences in the port against the JAX package.

* ``pack_documents`` and ``PackedLMTask`` equal the JAX package's element
  by element (tokens, segments, positions, loss mask), on hypothesis
  documents and on the task's streams for several (seed, worker,
  counter).
* The four JAX packing tests (``tests/test_packing.py``) on the port: the
  packer's invariants, the task's determinism, the packed loss (finite,
  and finite with every target masked), and document isolation: a row
  packing two documents gives the second the logits it has alone, at
  bfloat16 within 3e-2 (the JAX test's tolerance) and at float32 within
  1e-4.
* qwen2-1.5b reduced on a packed batch (segments, restarting positions,
  the loss mask) at float32 on the JAX package's weights: logits within
  1e-4, the loss within 1e-5, every leaf's gradient within 1e-4
  relative L2 of ``jax.grad``; the pod-round step on packed batches
  against the JAX jitted step (C15's tolerances), the batch's leaves cut
  on their batch axis.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.packing import PackedLMTask as JPackedLMTask
from repro.data.packing import pack_documents as jpack
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.models.api import build_model as jbuild
from repro.models.common import softmax_xent_logits as jxent

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.types import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data.packing import PackedLMTask, pack_documents
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.models.api import build_model

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("tokens", "segments", "positions", "loss_mask")
F32_TOL = dict(rtol=0.0, atol=1e-4)
LOSS_TOL = dict(rtol=0.0, atol=1e-5)
GRAD_F32_REL = 1e-4
VOCAB = 128


def _equal_to_jax(pb, jpb):
    for name in FIELDS:
        a, b = getattr(pb, name), getattr(jpb, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


# ---------------------------------------------------------------------------
# the packer and the task
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.integers(16, 96), st.integers(1, 4))
def test_packing_invariants(seed, seq_len, batch):
    """JAX ``test_packing_invariants`` on the port, and the port's batch
    equal to JAX's."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 100, size=int(n))
            for n in rng.integers(4, seq_len, size=12)]
    pb = pack_documents(docs, seq_len, batch)
    _equal_to_jax(pb, jpack(docs, seq_len, batch))
    assert pb.tokens.shape == (batch, seq_len)
    for r in range(batch):
        segs = pb.segments[r]
        nz = segs[segs > 0]
        if len(nz):
            assert nz.max() == len(np.unique(nz))
        for sid in np.unique(nz):
            where = np.where(segs == sid)[0]
            assert (pb.positions[r, where] == np.arange(len(where))).all()
    crosses = (pb.segments[:, 1:] != pb.segments[:, :-1])
    assert not np.any(pb.loss_mask[:, :-1][crosses] > 0)
    assert not np.any(pb.loss_mask[:, :-1][pb.segments[:, 1:] == 0] > 0)


def test_packed_task_deterministic():
    task = PackedLMTask(seq_len=64, batch_size=2, seed=3)
    a, b, c = task.batch(1, 7), task.batch(1, 7), task.batch(2, 7)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, c.tokens)


@pytest.mark.parametrize("seed,worker,counter,seq,batch",
                         [(0, 0, 0, 128, 4), (3, 1, 7, 64, 2),
                          (5, 2, 11, 512, 8), (0, 0, 3, 32, 2)])
def test_packed_task_equals_jax(seed, worker, counter, seq, batch):
    kw = dict(vocab_size=VOCAB, seq_len=seq, batch_size=batch, seed=seed)
    pb = PackedLMTask(**kw).batch(worker, counter)
    _equal_to_jax(pb, JPackedLMTask(**kw).batch(worker, counter))
    t = pb.tensors("cpu")
    assert set(t) == set(FIELDS)
    assert t["segments"].dtype == torch.int32
    assert t["loss_mask"].dtype == torch.float32
    np.testing.assert_array_equal(t["positions"].numpy(), pb.positions)


# ---------------------------------------------------------------------------
# the packed loss and document isolation
# ---------------------------------------------------------------------------
def _qwen(vocab):
    return (dataclasses.replace(jget("qwen2-1.5b").reduced(),
                                vocab_size=vocab),
            dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                                vocab_size=vocab))


@pytest.fixture(scope="module")
def qwen():
    jcfg, cfg = _qwen(VOCAB)
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg))(jax.random.PRNGKey(1))
    return jcfg, cfg, jp, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _packed(seq=32, batch=2, seed=0, counter=0):
    pb = PackedLMTask(vocab_size=VOCAB, seq_len=seq, batch_size=batch,
                      seed=seed).batch(0, counter)
    return ({k: jnp.asarray(getattr(pb, k)) for k in FIELDS},
            pb.tensors("cpu"))


def test_packed_loss_runs_and_masks(qwen):
    """JAX ``test_packed_loss_runs_and_masks`` on the port (with the
    segments as well), its loss equal to JAX's at bfloat16 within 2e-2
    (C8's bf16 loss gap) and finite with every target masked."""
    jcfg, cfg, jp, p = qwen
    jb, b = _packed()
    model = build_model(cfg)
    with torch.no_grad():
        loss = model.loss(p, b)
        loss0 = model.loss(p, dict(b, loss_mask=torch.zeros_like(
            b["loss_mask"])))
    assert np.isfinite(float(loss)) and np.isfinite(float(loss0))
    jloss = jax.jit(jbuild(jcfg).loss)(jp, jb)
    assert abs(float(loss) - float(jloss)) < 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float32, 1e-4)])
def test_segment_attention_isolates_documents(dtype, tol):
    """JAX ``test_segment_attention_isolates_documents`` on the port."""
    _, cfg = _qwen(64)
    params = build_model(cfg).init(torch.Generator().manual_seed(1),
                                   device="cpu")
    rng = np.random.default_rng(5)
    d1 = rng.integers(1, 64, size=8).astype(np.int32)
    d2 = rng.integers(1, 64, size=8).astype(np.int32)
    batch = {"tokens": torch.from_numpy(np.concatenate([d1, d2])[None]),
             "segments": torch.tensor([[1] * 8 + [2] * 8]),
             "positions": torch.tensor([list(range(8)) * 2])}
    with torch.no_grad():
        packed, _ = lm.forward(params, cfg, batch, dtype=dtype)
        alone, _ = lm.forward(params, cfg, {"tokens": torch.from_numpy(
            d2[None])}, dtype=dtype)
    np.testing.assert_allclose(packed[0, 8:].float().numpy(),
                               alone[0].float().numpy(), rtol=tol, atol=tol)


def test_packed_forward_loss_and_gradients_match_jax_f32(qwen):
    jcfg, cfg, jp, p = qwen
    jb, b = _packed(seq=64, batch=3, counter=1)
    assert (b["segments"] == 0).any()

    jl, _ = jax.jit(lambda q, bb: jlm.forward(q, jcfg, bb,
                                              dtype=jnp.float32))(jp, jb)
    with torch.no_grad():
        logits, _ = lm.forward(p, cfg, b, dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **F32_TOL)

    def jloss32(params, batch):
        logits, _ = jlm.forward(params, jcfg, batch, dtype=jnp.float32)
        toks = batch["tokens"]
        labels = jnp.concatenate(
            [toks[:, 1:], jnp.full((toks.shape[0], 1), -1, jnp.int32)], 1)
        return jxent(logits, labels, mask=batch["loss_mask"])
    ref, jg = jax.jit(jax.value_and_grad(jloss32))(jp, jb)
    leaves, td = tree_flatten(p)
    xs = [l.detach().requires_grad_(True) for l in leaves]
    loss = lm.lm_loss(tree_unflatten(td, xs), cfg, b, dtype=torch.float32)
    np.testing.assert_allclose(float(loss.detach()), float(ref), **LOSS_TOL)
    gs = torch.autograd.grad(loss, xs)
    rel = [float(np.linalg.norm(np.asarray(a) - g.numpy())
                 / max(np.linalg.norm(np.asarray(a)), 1e-30))
           for a, g in zip(jax.tree.leaves(jg), gs)]
    assert len(rel) == len(leaves) and max(rel) < GRAD_F32_REL, rel


def test_pod_round_step_on_packed_batches_matches_jax_jit(qwen):
    """One pod's step against the JAX jitted step (C15: losses within
    5e-3, theta within 5e-4, momenta within 5 % relative L2), and two
    pods' split of a packed batch."""
    jcfg, cfg, _, _ = qwen
    jmodel, model = jbuild(jcfg), build_model(cfg)
    mesh = make_host_mesh((1, 1, 1), ("pod", "data", "model"))
    with mesh:
        jstep, *_ = jsteps.build_train_step(jmodel, mesh,
                                            jsteps.TrainSettings(lr=1e-2))
        jstate = jax.jit(lambda k: jsteps.init_train_state(jmodel, k, 1))(
            jax.random.PRNGKey(0))
        state = {k: lm_params_from_numpy(jax.tree.map(np.asarray, v), "cpu")
                 for k, v in jstate.items() if k != "t"}
        state["t"] = torch.tensor(0, dtype=torch.int32)
        jstep = jax.jit(jstep)
        step = steps.build_train_step(model, steps.TrainSettings(lr=1e-2))
        for i in range(3):
            jb, b = _packed(seq=32, batch=4, counter=10 + i)
            jstate, jm = jstep(jstate, jb)
            state, m = step(state, b)
            assert abs(float(m["loss"]) - float(jm["loss"])) < 5e-3
    for a, b in zip(jax.tree.leaves(jstate["theta"]),
                    tree_leaves(state["theta"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=5e-4)
    for a, b in zip(jax.tree.leaves(jstate["v"]), tree_leaves(state["v"])):
        a = np.asarray(a)
        assert np.linalg.norm(a - b.numpy()) <= 0.05 * max(
            np.linalg.norm(a), 1e-30)
    _, b = _packed(seq=32, batch=4)
    parts = steps._split(b, 2)
    for name in FIELDS:
        assert [tuple(x[name].shape) for x in parts] == [(2, 32)] * 2
        assert torch.equal(parts[1][name], b[name][2:])
