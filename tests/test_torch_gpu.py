"""The port's CUDA kernels against their plain versions on a card.

Marked ``gpu``: each test skips without a CUDA device (and needs
``nvcc``, which builds the kernel at first use).  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

The scan's cases cover each instance of its kernels (one or two
channels a lane, N of 8 or 16, float32 or bf16 inputs as ``apply_mamba``
passes them, strided B and C), and the plain staging path (D no
multiple of 8); ``send_view`` is held bit for bit at N=1 and to 1e-5
with rate weights, and reads a strided row range of its slab in place
(bit for bit the same call on a contiguous copy); ``rglru_scan`` bit for bit at every staging edge and
at decode; ``gap_update`` bit for bit on relaunch and to GAP_TOL at k =
1, 2 and 8, with repeated workers adjacent and apart; ``swa_attention``
at the sliding-window and small cases and at the full causal prefill
shapes of chatglm3-6b, granite-moe-3b-a800m, llama4-scout-17b-a16e and
qwen2-vl-7b.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.flat_update.send import (flat_send_view,
                                                  flat_send_view_ref)
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
from repro_torch.kernels.mamba_scan.kernel import layout_for
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
from repro_torch.kernels.swa_attention import (swa_attention,
                                               swa_attention_gqa)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scan_inputs(b, s, d, n, seed, device):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    delta = np.logaddexp(randn(b, s, d), 0.0).astype(np.float32) * 0.1
    arrs = (randn(b, s, d), delta, randn(b, s, n), randn(b, s, n),
            -np.abs(randn(d, n)), randn(b, d, n))
    return [torch.from_numpy(a).to(device) for a in arrs]


def _proj_split(b, s, n, dtype, seed, device, dt_rank=24):
    """B and C as ``apply_mamba`` passes them: column slices of one
    (B, S, dt_rank + 2N) projection cut with ``torch.split``."""
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.standard_normal(
        (b, s, dt_rank + 2 * n)).astype(np.float32)).to(device, dtype)
    return torch.split(proj, [dt_rank, n, n], dim=-1)[1:]


# (1, 256, 8192, 16): the Engine's one-request prefill at its largest
# bucket; (3, 50, 1000, 16): D no multiple of any group's block (32, 16
# or 8 channels); (2, 40, 1002, 16): D no multiple of 8 (plain staging)
@pytest.mark.parametrize("b,s,d,n", [(1, 8, 128, 16), (2, 32, 128, 16),
                                     (1, 16, 256, 8), (4, 1, 8192, 16),
                                     (2, 77, 200, 16), (1, 130, 64, 8),
                                     (1, 256, 8192, 16), (3, 50, 1004, 16),
                                     (2, 40, 1002, 16)])
def test_mamba_scan_kernel_matches_plain_version(cuda, b, s, d, n):
    """The state to 1e-6 (the same rounded operations), y to 1e-5 (the
    N-sum in another order); one launch per call."""
    arrs = _scan_inputs(b, s, d, n, s + d, cuda)
    reset_launches()
    y, last = mamba_scan(*arrs)
    assert launches(["mamba_scan"]) == {"mamba_scan": 1}
    ry, rlast = mamba_scan_ref(*arrs)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last, rlast, rtol=1e-6, atol=1e-6)


# B*D below and above the B*D from which a lane carries two channels:
# (1, 256, 8192, 16) is the Engine's one-request prefill, (4, 40, 8192,
# 16) falcon-mamba's prefill at a shorter prompt; D no multiple of the
# block or of 8 at both
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,n,per_lane", [
    (2, 37, 1000, 16, 1), (1, 20, 200, 8, 1), (2, 33, 1002, 16, 1),
    (1, 256, 8192, 16, 1), (4, 40, 8192, 16, 2), (4, 18, 8200, 8, 2),
    (5, 21, 8190, 16, 2)])
def test_mamba_scan_kernel_each_instance_matches_plain_version(
        cuda, dtype, b, s, d, n, per_lane):
    """Each instance of the chunked kernel (one or two channels a lane,
    picked by B*D; N of 8 or 16; float32 or bf16) on xc and B, C split
    from a projection, as ``apply_mamba`` passes them, against the plain
    version on the same inputs: the state bit for bit, y to 1e-5."""
    assert layout_for(b, d) == (4, per_lane)
    x, dl, _, _, a, h0 = _scan_inputs(b, s, d, n, per_lane + d, cuda)
    bm, cm = _proj_split(b, s, n, dtype, s, cuda)
    x = x.to(dtype)
    reset_launches()
    y, last = mamba_scan(x, dl, bm, cm, a, h0)
    assert launches(["mamba_scan"]) == {"mamba_scan": 1}
    ry, rlast = mamba_scan_ref(x, dl, bm, cm, a, h0)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    assert torch.equal(last, rlast)


@pytest.mark.parametrize("b,s,d", [(4, 1, 8192), (4, 64, 8192),
                                   (2, 19, 1000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_scan_kernel_takes_bf16_and_strided_inputs(cuda, b, s, d,
                                                         dtype):
    """xc and B, C column slices of a projection, all bf16 or all f32, as
    ``apply_mamba`` passes them, against the plain version on the same
    inputs (which widens them) and on contiguous float32 copies: the
    state to 1e-6, y to 1e-5; one launch."""
    n = 16
    x, dl, _, _, a, h0 = _scan_inputs(b, s, d, n, s + d, cuda)
    x = x.to(dtype)
    bm, cm = _proj_split(b, s, n, dtype, d, cuda)
    assert bm.stride(-1) == 1 and not bm.is_contiguous()
    reset_launches()
    y, last = mamba_scan(x, dl, bm, cm, a, h0)
    assert launches(["mamba_scan"]) == {"mamba_scan": 1}
    assert y.dtype == torch.float32
    for ins in ((x, bm, cm), (x.float(), bm.float().contiguous(),
                              cm.float().contiguous())):
        ry, rlast = mamba_scan_ref(ins[0], dl, ins[1], ins[2], a, h0)
        torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(last, rlast, rtol=1e-6, atol=1e-6)


def test_mamba_scan_kernel_refuses_what_it_does_not_take(cuda):
    x, dl, bm, cm, a, h0 = _scan_inputs(1, 4, 64, 16, 0, cuda)
    with pytest.raises(TypeError):
        mamba_scan(x.double(), dl, bm, cm, a, h0)
    with pytest.raises(TypeError):
        mamba_scan(x, dl.bfloat16(), bm, cm, a, h0)
    with pytest.raises(TypeError):
        mamba_scan(x, dl, bm.bfloat16(), cm, a, h0)      # b, c alike
    with pytest.raises(TypeError):                       # x, b, c alike
        mamba_scan(x.bfloat16(), dl, bm, cm, a, h0)
    with pytest.raises(TypeError):
        mamba_scan(x, dl, bm.bfloat16(), cm.bfloat16(), a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(x, dl, bm.transpose(1, 2).contiguous().transpose(1, 2),
                   cm, a, h0)
    x4, dl4, bm4, cm4, a4, h04 = _scan_inputs(1, 4, 64, 4, 0, cuda)
    with pytest.raises(ValueError, match="N in"):
        mamba_scan(x4, dl4, bm4, cm4, a4, h04)


def test_mamba_scan_kernel_refuses_a_b_with_a_strided_last_axis(cuda):
    """A column slice is taken (its last axis is contiguous); every
    other column is not; nor are B and C of different strides, nor a
    misaligned state."""
    x, dl, _, _, a, h0 = _scan_inputs(2, 6, 64, 16, 0, cuda)
    bm, cm = _proj_split(2, 6, 32, torch.float32, 0, cuda)
    mamba_scan(x, dl, bm[..., :16], cm[..., :16], a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(x, dl, bm[..., ::2], cm[..., :16], a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(x, dl, bm[..., :16], cm[..., ::2], a, h0)
    with pytest.raises(ValueError, match="same strides"):
        mamba_scan(x, dl, bm[..., :16], cm[..., :16].contiguous(), a, h0)
    flat = torch.empty(h0.numel() + 1, device=cuda)
    shifted = flat[1:].view_as(h0).copy_(h0)
    with pytest.raises(ValueError, match="aligned"):
        mamba_scan(x, dl, bm[..., :16], cm[..., :16], a, shifted)


# ---------------------------------------------------------------------------
# send_view
# ---------------------------------------------------------------------------
def _send_inputs(r, n, adaptive, seed, device):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    w = (torch.ones(n, device=device) if n == 1 else
         torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
         .to(device))
    return f(r, 128), f(n, r, 128), w, (f(r, 128).abs() * 0.01
                                        if adaptive else None)


@pytest.mark.parametrize("r", [1, 300, 4096])
@pytest.mark.parametrize("adaptive", [False, True])
def test_send_view_kernel_n1_is_bit_equal(cuda, r, adaptive):
    """N=1 (every unit-weight send): the same rounded operations as the
    plain version, bit for bit (IEEE sqrtf and division, -fmad=false);
    one launch per call."""
    theta, slab, w, u2 = _send_inputs(r, 1, adaptive, r, cuda)
    c = np.float32(0.05) * np.float32(0.9)
    reset_launches()
    out = flat_send_view(theta, slab, w, c, u2)
    assert launches(["send_view"]) == {"send_view": 1}
    assert torch.equal(out, flat_send_view_ref(theta, slab, w, c, u2=u2))


@pytest.mark.parametrize("adaptive", [False, True])
def test_send_view_kernel_weighted_matches_plain_version(cuda, adaptive):
    """N=4 rate weights: the N-way sum in another order than tensordot,
    held to chip_smoke.py's WEIGHTED_TOL (1e-5)."""
    theta, slab, w, u2 = _send_inputs(777, 4, adaptive, 3, cuda)
    c = np.float32(0.05) * np.float32(0.9)
    reset_launches()
    out = flat_send_view(theta, slab, w, c, u2)
    assert launches(["send_view"]) == {"send_view": 1}
    torch.testing.assert_close(out, flat_send_view_ref(theta, slab, w, c,
                                                       u2=u2),
                               rtol=1e-5, atol=1e-5)


def test_send_view_kernel_refuses_what_it_does_not_take(cuda):
    theta, slab, w, u2 = _send_inputs(64, 2, True, 0, cuda)
    reset_launches()
    with pytest.raises(TypeError, match="float32"):
        flat_send_view(theta.double(), slab, w, 1.0)
    with pytest.raises(ValueError, match="shape"):
        flat_send_view(theta, slab[:, :32], w, 1.0)
    with pytest.raises(ValueError, match="shape"):
        flat_send_view(theta, slab, w[:1], 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        flat_send_view(theta, slab.transpose(1, 2).contiguous()
                       .transpose(1, 2), w, 1.0)
    with pytest.raises(ValueError, match="cpu"):
        flat_send_view(theta, slab, w.cpu(), 1.0)
    with pytest.raises(ValueError, match="shape"):
        flat_send_view(theta, slab, w, 1.0, u2[:32])
    flat = torch.empty(theta.numel() + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        flat_send_view(flat[1:].view_as(theta), slab, w, 1.0)
    with pytest.raises(ValueError, match="empty|shape"):
        flat_send_view(theta[:0], slab[:, :0], w, 1.0)
    assert launches(["send_view"]) == {"send_view": 0}


@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("adaptive", [False, True])
def test_send_view_kernel_reads_a_strided_row_range(cuda, n, adaptive):
    """``slab[:, r0:r1]`` of a larger slab, read in place through the
    kernel's pitch: bit for bit the kernel on a contiguous copy and the
    full-slab call's rows; the plain version bit for bit at N=1, within
    WEIGHTED_TOL (1e-5) of the sum of magnitudes for the N-way sum."""
    theta, slab, w, u2 = _send_inputs(300, n, adaptive, n, cuda)
    c = np.float32(0.05) * np.float32(0.9)
    full = flat_send_view(theta, slab, w, c, u2)
    for r0, r1 in ((0, 8), (17, 131), (296, 300)):
        strided = slab[:, r0:r1]
        u = None if u2 is None else u2[r0:r1]
        reset_launches()
        out = flat_send_view(theta[r0:r1], strided, w, c, u)
        assert launches(["send_view"]) == {"send_view": 1}
        copy = flat_send_view(theta[r0:r1], strided.contiguous(), w, c, u)
        assert torch.equal(out, copy) and torch.equal(out, full[r0:r1])
        ref = flat_send_view_ref(theta[r0:r1], strided, w, c, u2=u)
        if n == 1:
            assert torch.equal(out, ref)
        else:
            # a reordered N-way sum: relative to the sum of magnitudes,
            # chip_smoke.py's max_err rule
            scale = flat_send_view_ref(theta[r0:r1].abs(), strided.abs(),
                                       w.abs(), -abs(c), u2=u)
            assert bool(((out - ref).abs() <= 1e-5 + 1e-5 * scale).all())


def test_send_view_kernel_refuses_other_slab_layouts(cuda):
    theta, slab, w, _ = _send_inputs(64, 4, False, 0, cuda)
    base = torch.zeros(4 * 64 * 128 + 64, device=cuda)
    reset_launches()
    with pytest.raises(ValueError, match="pitch"):       # not float4
        flat_send_view(theta, base.as_strided((4, 64, 128),
                                              (64 * 128 + 2, 128, 1)),
                       w, 1.0)
    with pytest.raises(ValueError, match="pitch"):       # workers overlap
        flat_send_view(theta, base.as_strided((4, 64, 128), (128, 128, 1)),
                       w, 1.0)
    wide = torch.zeros((4, 64, 256), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):  # rows apart
        flat_send_view(theta, wide[:, :, :128], w, 1.0)
    assert launches(["send_view"]) == {"send_view": 0}


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------
def _rglru_inputs(b, s, d, seed, device):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
    arrs = (a, rng.standard_normal((b, s, d)), rng.standard_normal((b, d)))
    return [torch.from_numpy(x.astype(np.float32)).to(device)
            for x in arrs]


# The staged scan takes 32 timesteps a stage, 4 stages in its ring and
# 32 channels a block: (1, 3072, 4096) the long prompt (B=1, long S, the
# ring wraps 24 times); (2, 5, 4096) S shorter than a stage; (2, 77,
# 1000) and (1, 130, 33) S not a multiple of a stage and D not a multiple
# of the 32-channel tile; (2, 40, 1002) and (1, 130, 33) D not a multiple
# of 4 (one float a thread staged); (4, 1, 4096) and (3, 1, 1001) a
# decode step through the step kernel, float4 and one float a thread
@pytest.mark.parametrize("b,s,d", [(1, 8, 128), (2, 64, 128), (2, 32, 256),
                                   (4, 1, 4096), (2, 77, 1000),
                                   (1, 130, 33), (1, 3072, 4096),
                                   (2, 5, 4096), (2, 40, 1002),
                                   (3, 1, 1001), (4, 512, 4096)])
def test_rglru_scan_kernel_equals_plain_version_bit_for_bit(cuda, b, s, d):
    """The product and the sum round separately on both sides
    (-fmad=false): every state is bit-equal; one launch per call."""
    a, x, h0 = _rglru_inputs(b, s, d, s + d, cuda)
    reset_launches()
    out, last = rglru_scan(a, x, h0)
    assert launches(["rglru_scan"]) == {"rglru_scan": 1}
    rout, rlast = rglru_scan_ref(a, x, h0)
    assert torch.equal(out, rout) and torch.equal(last, rlast)


def test_rglru_scan_kernel_takes_an_empty_sequence(cuda):
    a, x, h0 = _rglru_inputs(2, 0, 64, 1, cuda)
    out, last = rglru_scan(a, x, h0)
    assert out.shape == (2, 0, 64) and torch.equal(last, h0)


def test_rglru_scan_kernel_chains_bit_for_bit(cuda):
    a, x, h0 = _rglru_inputs(2, 100, 300, 5, cuda)
    out, last = rglru_scan(a, x, h0)
    o1, mid = rglru_scan(a[:, :37].contiguous(), x[:, :37].contiguous(), h0)
    o2, last2 = rglru_scan(a[:, 37:].contiguous(), x[:, 37:].contiguous(),
                           mid)
    assert torch.equal(torch.cat([o1, o2], 1), out)
    assert torch.equal(last2, last)


def test_rglru_scan_kernel_refuses_what_it_does_not_take(cuda):
    a, x, h0 = _rglru_inputs(1, 4, 64, 0, cuda)
    reset_launches()
    with pytest.raises(TypeError):
        rglru_scan(a.bfloat16(), x, h0)
    with pytest.raises(TypeError):
        rglru_scan(a, x.cpu(), h0)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a, x.transpose(1, 2).contiguous().transpose(1, 2), h0)
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, x, h0[:, :32])
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, x[:, :2].contiguous(), h0)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_cuda(a.cpu(), x.cpu(), h0.cpu())
    with pytest.raises(ValueError, match="rows"):
        big = torch.empty((65536, 1, 1), device=cuda)
        rglru_scan(big, big, big[:, 0])
    assert launches(["rglru_scan"]) == {"rglru_scan": 0}


# ---------------------------------------------------------------------------
# gap_update and the flat_update_batch wrapper
# ---------------------------------------------------------------------------
# the norms are sums over every element, taken in another order than
# torch.sum's (chip_smoke.GAP_TOL)
GAP_TOL = dict(rtol=1e-5, atol=1e-6)


def _gap_inputs(r, n, k, seed, device):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)
    theta = randn(r, 128)
    state = (theta, randn(n, r, 128) * 0.1,
             theta + 0.01 * randn(n, r, 128),
             torch.full((), 1e-3, device=device))
    scal = (np.linspace(0.05, 0.04, k).astype(np.float32),
            np.full(k, 0.9, np.float32), np.ones(k, np.float32),
            np.linspace(1.0, 0.9, k).astype(np.float32))
    return state, randn(k, r, 128), scal


# R=2048: 256 blocks; R=9000: 1,024 blocks striding twice, the second
# sweep ragged.  Adjacent repeats ([5, 5], [1, 1, ...]) take the next
# message's gap as exactly 0; repeats apart read the row an earlier
# launch wrote.
@pytest.mark.parametrize("r,ids", [(2048, [3]), (2048, [5, 5]),
                                   (9000, [3, 1, 3, 0, 2, 1, 5, 3]),
                                   (9000, [3, 1, 1, 0, 2, 1, 5, 5]),
                                   (2048, [2, 0, 2])])
def test_gap_update_kernel_is_reproducible_and_matches_plain_version(
        cuda, r, ids):
    """Twice on the same inputs bit for bit; within GAP_TOL of the plain
    version; k launches counted (k + 2 kernels run)."""
    from repro_torch.kernels.flat_update.kernel import flat_update_batch_gap
    from repro_torch.kernels.flat_update.ref import (
        flat_master_update_batch_ref)
    state, g, scal = _gap_inputs(r, 6, len(ids), r + len(ids), cuda)
    kw = dict(gap_ema=0.99, n_elems=r * 128 - 50, telemetry=True)
    runs = []
    reset_launches()
    for _ in range(2):
        out = list(flat_update_batch_gap(*(t.clone() for t in state), g,
                                         ids, *scal, **kw))
        out[4] = torch.stack(out[4])
        runs.append(out)
    assert launches(["gap_update"]) == {"gap_update": 2 * len(ids)}
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    theta, v, sent, avg = (t.clone() for t in state)
    ref = flat_master_update_batch_ref(
        theta, v, None, None, sent, avg, g, ids, scal[0], None, scal[1],
        scal[2], scal[3], nesterov=False, gap_aware=True, hat_mode="theta",
        **kw)
    ref = (ref[0], ref[1], ref[4], ref[5], torch.stack(ref[6]), ref[7])
    for a, b in zip(runs[0], ref):
        torch.testing.assert_close(a, b, **GAP_TOL)


def test_flat_update_wrappers_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.flat_update.kernel import (
        flat_update_batch, flat_update_batch_gap)
    (theta, v, sent, avg), g, scal = _gap_inputs(64, 3, 2, 0, cuda)
    ids = [0, 2]
    hcs = np.full(2, 0.01, np.float32)

    def batch(theta=theta, v=v, g=g, ids=ids, **kw):
        return flat_update_batch(theta, v, None, None, None, g, ids, *scal,
                                 hcs, nesterov=False, **kw)

    def gap(theta=theta, v=v, sent=sent, avg=avg, g=g, ids=ids):
        return flat_update_batch_gap(theta, v, sent, avg, g, ids, *scal,
                                     gap_ema=0.99, n_elems=64 * 128)
    reset_launches()
    for call in (batch, gap):
        with pytest.raises(TypeError, match="float32"):
            call(theta=theta.double())
        with pytest.raises(ValueError, match="shape"):
            call(v=v[:, :32])
        with pytest.raises(ValueError, match="contiguous"):
            call(theta=theta.t().contiguous().t())
        with pytest.raises(ValueError, match="aligned"):
            call(theta=torch.empty(64 * 128 + 1, device=cuda)[1:].view(
                64, 128))
        with pytest.raises(ValueError, match="is on"):
            call(g=g.cpu())
        with pytest.raises(ValueError, match="ids"):
            call(ids=[0, 3])
        with pytest.raises(ValueError, match="CUDA"):
            call(theta=theta.cpu())
    with pytest.raises(ValueError, match="hat_mode"):
        batch(hat_mode="v0")
    with pytest.raises(ValueError, match="avg_step"):
        gap(avg=avg.double())
    assert launches(["flat_update_batch", "gap_update"]) == {
        "flat_update_batch": 0, "gap_update": 0}


# ---------------------------------------------------------------------------
# swa_attention
# ---------------------------------------------------------------------------
def _swa_inputs(b, s, h, kh, hd, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]


SWA_CASES = [(1, 256, 2, 2, 64, 64), (1, 256, 2, 2, 64, 128),
             (2, 128, 4, 2, 32, 32), (2, 100, 16, 1, 256, 2048),
             (1, 300, 4, 1, 256, 40), (1, 77, 3, 3, 80, 1),
             # recurrentgemma-9b's prefill; a window no kv tile divides;
             # hd 20, no multiple of 8 (the kernels' scalar copy loops)
             (4, 512, 16, 1, 256, 2048), (1, 600, 4, 1, 128, 100),
             (2, 70, 2, 1, 20, 16),
             # the decoder-only families' prefills, full causal (window =
             # S): chatglm3-6b (a GQA group of 16), granite-moe-3b-a800m
             # (hd 64), llama4-scout-17b-a16e (40 heads), qwen2-vl-7b (its
             # 256-position vision prefix and a 512-token prompt)
             (4, 512, 32, 2, 128, 512), (4, 512, 24, 8, 64, 512),
             (4, 512, 40, 8, 128, 512), (4, 768, 28, 4, 128, 768)]


@pytest.mark.parametrize("b,s,h,kh,hd,window", SWA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_kernel_matches_plain_version(cuda, b, s, h, kh, hd,
                                                    window, dtype):
    """The JAX package's kernel tolerances (tests/test_kernels.py): 2e-5
    at float32 (sums in another order), 3e-2 at bfloat16 (one rounding
    of the output either side of a bfloat16 step, and the tensor-core
    kernel's P rounded to bfloat16 before the PV product); one launch
    per call, K/V not repeated."""
    q, k, v = _swa_inputs(b, s, h, kh, hd, dtype, s + hd, cuda)
    reset_launches()
    out = swa_attention(q, k, v, window)
    assert launches(["swa_attention"]) == {"swa_attention": 1}
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), swa_attention_gqa(
        q, k, v, window).float(), rtol=tol, atol=tol)


def test_swa_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _swa_inputs(1, 16, 4, 2, 32, torch.float32, 0, cuda)
    with pytest.raises(TypeError):
        swa_attention(q.double(), k.double(), v.double(), 8)
    with pytest.raises(TypeError):
        swa_attention(q, k.bfloat16(), v, 8)
    with pytest.raises(ValueError, match="contiguous"):
        swa_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                      8)
    with pytest.raises(ValueError, match="divide"):
        swa_attention(q, *_swa_inputs(1, 16, 4, 3, 32, torch.float32, 0,
                                      cuda)[1:], 8)
    with pytest.raises(ValueError, match="window"):
        swa_attention(q, k, v, 0)
    big = _swa_inputs(1, 4, 1, 1, 320, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        swa_attention(*big, 2)


# the enc-dec family's and packed sequences' masks: (B, S, T, H, K, hd,
# causal, window, segments)
SWA_MASK_CASES = [
    # seamless-m4t-large-v2: the encoder (non-causal, S == T), cross
    # attention over 512 frames, a ragged T, the longest encoder output
    (4, 512, 512, 16, 16, 64, False, None, False),
    (4, 512, 1000, 16, 16, 64, False, None, False),
    (1, 512, 4096, 16, 16, 64, False, None, False),
    # T below and above S at odd lengths, GQA, hd no multiple of 8
    (2, 77, 33, 4, 2, 64, False, None, False),
    (2, 70, 131, 2, 1, 20, False, None, False),
    # packed sequences: qwen2-1.5b causal, a sliding window, non-causal
    # with T < S, all with padding rows
    (4, 512, 512, 12, 2, 128, True, None, True),
    (2, 300, 300, 4, 1, 256, True, 40, True),
    (3, 200, 150, 4, 4, 64, False, None, True),
    (2, 130, 130, 4, 2, 32, True, None, True)]


def _segments(b, s, seed):
    """A PackedLMTask batch's segment ids (documents of mean length s/4,
    padding at the ends of rows), with the padding forced on."""
    from repro_torch.data.packing import PackedLMTask
    seg = PackedLMTask(seq_len=s, batch_size=b, mean_doc_len=max(s // 4, 4),
                       seed=seed).batch(0, seed).segments.copy()
    seg[:, -3:] = 0
    return seg


@pytest.mark.parametrize("b,s,t,h,kh,hd,causal,window,seg", SWA_MASK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_kernel_masks_match_plain_version(
        cuda, b, s, t, h, kh, hd, causal, window, seg, dtype):
    """Non-causal attention over T keys and segment masks, against the
    plain version with the tolerances above; a padding row takes the
    mean of V over all T keys (keys past T in the last tile never
    count)."""
    rng = np.random.default_rng(s + t)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=cuda, dtype=dtype)
        for shape in ((b, s, h, hd), (b, t, kh, hd), (b, t, kh, hd)))
    segments = torch.from_numpy(_segments(b, s, s)).to(cuda) if seg \
        else None
    reset_launches()
    out = swa_attention(q, k, v, window, causal=causal, segments=segments)
    assert launches(["swa_attention"]) == {"swa_attention": 1}
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    ref = swa_attention_gqa(q, k, v, window, causal, segments)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if seg:
        pad = segments == 0
        mean = v.float().mean(dim=1, keepdim=True).repeat_interleave(
            h // kh, dim=2).expand(b, s, h, hd)
        torch.testing.assert_close(out.float()[pad], mean[pad], rtol=tol,
                                   atol=tol)


def test_swa_attention_kernel_refuses_masks_no_block_asks_for(cuda):
    q, k, v = _swa_inputs(1, 16, 4, 2, 32, torch.float32, 0, cuda)
    seg = torch.ones((1, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="as many keys"):
        swa_attention(q, k[:, :8].contiguous(), v[:, :8].contiguous())
    with pytest.raises(ValueError, match="window"):
        swa_attention(q, k, v, 8, causal=False)
    with pytest.raises(ValueError, match="segments"):
        swa_attention(q, k, v, segments=seg[:, :8])
    with pytest.raises(TypeError, match="int32"):
        swa_attention(q, k, v, segments=seg.long())
    with pytest.raises(TypeError, match="int32"):
        swa_attention(q, k, v, segments=seg.cpu())


# ---------------------------------------------------------------------------
# gradients: kernel forward, the plain version's gradient backward
# ---------------------------------------------------------------------------
def _weighted_grads(fn, tensors, seed):
    """Outputs and input gradients of sum(out * W), W from numpy."""
    xs = [t.detach().clone().requires_grad_(True) for t in tensors]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(seed)
    loss = sum((o.float() * torch.from_numpy(rng.standard_normal(
        tuple(o.shape)).astype(np.float32)).to(o.device)).sum()
        for o in outs)
    loss.backward()
    return outs, [x.grad for x in xs]


def _check_grads(name, fn, plain, tensors, out_tol):
    """One launch (the forward); the outputs within the kernel's
    tolerance; the gradients those of the plain version on the same card
    tensors (the backward is its autograd: equal up to run-to-run
    reduction order, held to 1e-6)."""
    reset_launches()
    outs, grads = _weighted_grads(fn, tensors, 5)
    assert launches([name]) == {name: 1}
    routs, rgrads = _weighted_grads(plain, tensors, 5)
    assert launches([name]) == {name: 1}
    for o, r in zip(outs, routs):
        torch.testing.assert_close(o.float(), r.float(), **out_tol)
    for g, r in zip(grads, rgrads):
        assert g is not None and g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(), rtol=1e-6,
                                   atol=1e-6)


def test_mamba_scan_gradients_equal_plain_versions(cuda):
    _check_grads("mamba_scan", mamba_scan, mamba_scan_ref,
                 _scan_inputs(2, 33, 128, 16, 4, cuda),
                 dict(rtol=1e-5, atol=1e-5))


def test_rglru_scan_gradients_equal_plain_versions(cuda):
    _check_grads("rglru_scan", rglru_scan, rglru_scan_ref,
                 _rglru_inputs(2, 40, 300, 6, cuda),
                 dict(rtol=0.0, atol=0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [16, 256])
def test_swa_attention_gradients_equal_plain_versions(cuda, dtype, window):
    """GQA (K < H): the K and V gradients sum over each group."""
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    _check_grads("swa_attention",
                 lambda q, k, v: swa_attention(q, k, v, window),
                 lambda q, k, v: swa_attention_gqa(q, k, v, window),
                 _swa_inputs(2, 130, 4, 2, 64, dtype, 7, cuda),
                 dict(rtol=tol, atol=tol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["cross", "segments"])
def test_swa_attention_mask_gradients_equal_plain_versions(cuda, dtype,
                                                           mask):
    """Cross attention over T != S keys and segment masks: the segments
    ride along as a static argument and take no gradient."""
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    q, k, v = _swa_inputs(2, 130, 4, 2, 64, dtype, 8, cuda)
    if mask == "cross":
        k, v = (torch.cat([x, x[:, :50]], 1).contiguous() for x in (k, v))
        kw = dict(causal=False)
    else:
        kw = dict(segments=torch.from_numpy(_segments(2, 130, 3)).to(cuda))
    _check_grads("swa_attention",
                 lambda q, k, v: swa_attention(q, k, v, **kw),
                 lambda q, k, v: swa_attention_gqa(
                     q, k, v, None, kw.get("causal", True),
                     kw.get("segments")),
                 [q, k, v], dict(rtol=tol, atol=tol))
