"""Rows 1, 2, 3, 4 and 6 at the shapes their Pallas kernels take beyond the
published configurations: the port's plain versions (what the CUDA
kernels compute, held against them on the card by ``chip_smoke.py``'s
``[shapes]``) against the JAX package, whose Pallas kernels run in
interpret mode, on the same seeded numpy inputs; the host-side weight
padding of rows 3 and 6; and the wrappers' shape rules (``plan``
functions), which must accept every shape the Pallas kernels take.

Tolerances, those of each row's existing test:
* ROI-pool forward (row 2): bitwise, float32 and bf16;
* ROI-pool backward (row 4): bitwise in float32;
* block0 (row 3): float32 rtol/atol 1e-4, bf16 rtol/atol 1e-2, int8 output
  at most one step apart in under 1% of the values;
* 2-conv block0 (row 6): float32 atol 1e-4 of the largest output, bf16 2
  bf16 ulps of it, the int8 conv1's float output as
  ``tests/test_torch_quant.py`` holds it, int8 outputs one step in under
  1%;
* NMS (row 1): keep masks and slots bitwise;
* padded weights through the plain versions, sliced back: bitwise the
  unpadded result.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu.geometry.matching import compact_mask as j_compact
from frcnn_tpu.ops.pallas_nms import pallas_nms_keep_mask
from frcnn_tpu.ops.pallas_roi_pool import _backward as j_roi_backward
from frcnn_tpu.ops.pallas_roi_pool import pallas_adaptive_max_pool_valid
from frcnn_tpu_torch.models.quant import quantize_weight
from frcnn_tpu_torch.ops import block0_2conv_kernel as K2
from frcnn_tpu_torch.ops import block0_kernel as K1
from frcnn_tpu_torch.ops import nms_kernel
from frcnn_tpu_torch.ops import roi_pool as troi
from frcnn_tpu_torch.ops import roi_pool_kernel as KR
from tests.test_torch_quant import _inv, _jax_2conv, _jax_block0
from tests.test_torch_quant import _ring_planes, _steps
from tests.test_torch_vgg_large import _bf16_ulp

F32, BF16 = torch.float32, torch.bfloat16
# the module: the package exports the function ``nms`` under its name
tnms = importlib.import_module("frcnn_tpu_torch.ops.nms")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rects(rng, B, D, H, W):
    """Prepared rects: random, the whole map, and one smaller than the
    grid (overlapping bins); ~3/4 valid."""
    raw = np.concatenate([rng.integers(-2, W, (B, D, 1)),
                          rng.integers(-2, H, (B, D, 1)),
                          rng.integers(0, W + 3, (B, D, 1)),
                          rng.integers(0, H + 3, (B, D, 1))],
                         -1).astype(np.float32)
    raw[:, 0] = [0, 0, W, H]
    raw[:, 1] = [1, 1, 3, 4]
    rects = troi.prepare_roi_rects(
        _t(raw), _t(np.full((B, 1), float(W), np.float32)),
        _t(np.full((B, 1), float(H), np.float32))).numpy()
    valid = rng.uniform(size=(B, D)) > 0.25
    valid[:, 0] = True
    return rects, valid


# -- row 2: the ROI-pool forward ----------------------------------------------

# each case takes new bins and a new C (one Pallas compile per case)
@pytest.mark.parametrize("kh,kw,C,H,W,dt", [
    (9, 9, 12, 20, 30, BF16), (3, 16, 20, 20, 30, BF16),
    (14, 14, 13, 11, 13, F32)])
def test_roi_pool_forward_any_shape(kh, kw, C, H, W, dt):
    rng = np.random.default_rng(kh * 100 + kw + C)
    B, D = 2, 6
    fm = rng.integers(0, 4, (B, H, W, C)).astype(np.float32) / 4
    rects, valid = _rects(rng, B, D, H, W)
    jdt = jnp.float32 if dt == F32 else jnp.bfloat16
    ref = np.asarray(pallas_adaptive_max_pool_valid(
        jnp.asarray(fm, jdt), jnp.asarray(rects), jnp.asarray(valid), kh, kw,
        True).astype(jnp.float32))
    for fn in (troi.adaptive_max_pool, KR.adaptive_max_pool_valid):
        got = fn(_t(fm).to(dt), _t(rects), _t(valid), kh, kw)
        assert got.dtype == dt and got.shape == (B, D, kh, kw, C)
        np.testing.assert_array_equal(got.float().numpy(), ref)


# -- row 4: the ROI-pool backward ---------------------------------------------

@pytest.mark.parametrize("kh,kw,C,H,W", [
    (14, 9, 12, 20, 30),
    # a map 32768 wide; row bins of up to 35 rows (two-word tie masks)
    (6, 6, 4, 4, 32768), (6, 6, 20, 200, 5)])
def test_roi_pool_backward_any_shape(kh, kw, C, H, W):
    rng = np.random.default_rng(kh * 100 + kw + C + H)
    B, D = 1, 3
    fm = rng.integers(0, 4, (B, H, W, C)).astype(np.float32) / 4
    rects, valid = _rects(rng, B, D, H, W)
    g = rng.normal(size=(B, D, kh, kw, C)).astype(np.float32)
    args = (jnp.asarray(rects), jnp.asarray(valid), jnp.asarray(g), kh, kw,
            True)
    ref = np.asarray(j_roi_backward(jnp.asarray(fm), *args))
    for fn in (troi.adaptive_max_pool_backward,
               KR.adaptive_max_pool_valid_backward):
        got = fn(_t(fm), _t(rects), _t(valid), _t(g), kh, kw)
        assert got.dtype == F32
        np.testing.assert_array_equal(got.numpy(), ref)


# -- row 3: block0 ------------------------------------------------------------

@pytest.mark.parametrize("f,dt,out", [(8, BF16, "float"), (96, F32, "int8")])
def test_block0_any_filters(f, dt, out):
    cdt = jnp.float32 if dt == F32 else jnp.bfloat16
    lum4, chroma = _ring_planes(f, 2, 12, 16)
    rng = np.random.default_rng(f)
    w = rng.normal(0, 0.2, (3, 3, 3, f)).astype(np.float32)
    b = rng.normal(0, 0.1, (f,)).astype(np.float32)
    w27, bias = K1.block0_weights(_t(w).permute(3, 2, 0, 1), _t(b), dt)
    w27 = K1.pad_columns(w27, K1.plan(f, dt))    # as on a CUDA device
    assert w27.shape == (27, K1.plan(f, dt)) and bias.shape == (f,)
    planes = _t(lum4).to(dt), _t(chroma).to(dt)
    slope = torch.tensor([0.25])
    if out == "float":
        ref = _jax_block0(lum4, chroma, w, b, 0.25, cdt)
        got = K1.fused_block0(*planes, w27, bias, slope)
        assert got.dtype == dt and got.shape == (2, 6, 8, f)
        tol = 1e-4 if dt == F32 else 1e-2
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                                   atol=tol)
        return
    got = K1.block0_plain(*planes, w27, bias, slope)
    s = np.float32(float(got.abs().max()) / 127)
    ref8 = _jax_block0(lum4, chroma, w, b, 0.25, cdt, out_scale=s)
    got8 = K1.fused_block0(*planes, w27, bias, slope, inv_out=_inv(s))
    assert got8.dtype == torch.int8 and got8.shape == ref8.shape
    step, share = _steps(got8.numpy(), ref8)
    assert step <= 1 and share < 0.01


# -- row 6: the 2-conv block0 -------------------------------------------------

def _two_conv_case(f, seed):
    rng = np.random.default_rng(seed)
    w0 = rng.normal(0, 0.2, (3, 3, 3, f)).astype(np.float32)
    b0 = rng.normal(0, 0.1, (f,)).astype(np.float32)
    w1 = rng.normal(0, (2.0 / (9 * f)) ** 0.5, (3, 3, f, f)).astype(
        np.float32)
    b1 = rng.normal(0, 0.1, (f,)).astype(np.float32)
    return w0, b0, w1, b1


def _port_2conv_params(w0, b0, w1, b1, dt):
    """The kernel's weights, padded as on a CUDA device."""
    return K2.padded(K2.block0_2conv_weights(
        _t(w0).permute(3, 2, 0, 1), _t(b0), _t(w1).permute(3, 2, 0, 1),
        _t(b1), 0.25, 0.1, dt))


@pytest.mark.parametrize("f,dt", [(8, BF16), (72, F32)])
def test_block0_2conv_any_filters(f, dt):
    """F = 8 (padded to 64): the float conv1 mode; F = 72 (two groups of
    64): the int8 conv1 mode with an int8 output."""
    cdt = jnp.float32 if dt == F32 else jnp.bfloat16
    lum4, chroma = _ring_planes(f, 2, 8, 12)
    w0, b0, w1, b1 = _two_conv_case(f, f)
    p = _port_2conv_params(w0, b0, w1, b1, dt)
    assert p.w0.shape == (27, K2.plan(f)) and p.b0.shape == (f,)
    planes = _t(lum4).to(dt), _t(chroma).to(dt)
    if f <= K2.GROUP:
        ref = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, cdt)
        got = K2.fused_block0_2conv(*planes, *p)
        assert got.dtype == dt and got.shape == (2, 4, 6, f)
        err = np.abs(got.float().numpy() - ref)
        peak = np.abs(ref).max()
        assert err.max() <= (1e-4 * peak if dt == F32
                             else 2 * _bf16_ulp(peak))
        return
    wq, s_w = quantize_weight(_t(w1).permute(3, 2, 0, 1))
    y = torch.nn.functional.conv2d(
        K1.unpack_s2d(_t(lum4), _t(chroma)), _t(w0).permute(3, 2, 0, 1),
        _t(b0))
    s_y = np.float32(float(torch.where(y >= 0, y, 0.25 * y).abs().max())
                     / 127)
    wq9, ws = K2.block0_2conv_weights_q(wq, s_w, torch.tensor(s_y))
    wq9, ws = K2.pad_w1(wq9, K2.plan(f)), K1.pad_columns(ws, K2.plan(f))
    q = dict(w1_scale=ws, inv_y=_inv(s_y))
    fl = K2.fused_block0_2conv(*planes, p.w0, p.b0, wq9, p.b1, p.slopes, **q)
    s_o = np.float32(float(fl.abs().max()) / 127)
    ref8 = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, cdt,
                      w1q=wq.permute(2, 3, 1, 0).numpy(), s_w=s_w.numpy(),
                      s_y=s_y, out_scale=s_o)
    got8 = K2.fused_block0_2conv(*planes, p.w0, p.b0, wq9, p.b1, p.slopes,
                                 inv_out=_inv(s_o), **q)
    step, share = _steps(got8.numpy(), ref8)
    assert got8.dtype == torch.int8 and got8.shape == (2, 4, 6, f)
    assert step <= 1 and share < 0.01


# -- row 1: NMS past the largest staged image ---------------------------------

def test_nms_past_the_staged_limit():
    """N = 87553 (one past ``MAX_BOXES``: the kernel reads the boxes from
    device memory) with few picks: the plain keep mask and slots and the
    wrapper's CPU route against the Pallas kernel and its compaction."""
    n, thr, max_out = nms_kernel.MAX_BOXES + 1, 0.5, 6
    assert nms_kernel.plan(n)
    rng = np.random.default_rng(1)
    xy = rng.integers(0, 900, (1, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.integers(8, 60, (1, n, 2))], -1)
    boxes[:, 1::17] = boxes[:, 0:-1:17][:, :boxes[:, 1::17].shape[1]]
    valid = rng.random((1, n)) > 0.1
    ref = np.asarray(jax.jit(lambda b, v: pallas_nms_keep_mask(
        b, v, thr, max_out, interpret=True))(jnp.asarray(boxes),
                                             jnp.asarray(valid)))
    ref_slots = np.asarray(jax.vmap(lambda m: j_compact(m, max_out)[0])(
        jnp.asarray(ref)))
    assert ref.sum() == max_out
    for fn in (tnms.nms_keep_slots, nms_kernel.nms_keep_slots):
        keep, slots = fn(_t(boxes), _t(valid), thr, max_out)
        np.testing.assert_array_equal(keep.numpy(), ref)
        np.testing.assert_array_equal(slots.numpy(), ref_slots)


# -- the host-side padding ----------------------------------------------------

@pytest.mark.parametrize("f", [8, 24, 72])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_padded_weights_are_exact(f, dt):
    """Weights padded to the kernels' granules (zero filters, biases read
    as 0 past F) through the plain versions, sliced back to F, are bitwise
    the unpadded result, in every mode: the padded filters cannot reach
    the real ones."""
    g = torch.Generator().manual_seed(f)
    P = torch.randn(2, 10, 14, 3, generator=g)
    planes = tuple(x.to(dt) for x in K1.pack_padded(P))
    w0 = torch.randn(f, 3, 3, 3, generator=g) * 0.3
    b0 = torch.randn(f, generator=g) * 0.1
    w1 = torch.randn(f, f, 3, 3, generator=g) * 0.1
    b1 = torch.randn(f, generator=g) * 0.1
    slope, inv = torch.tensor([0.25]), torch.tensor([40.0])

    plain = K1.block0_weights(w0, b0, dt)
    padded = (K1.pad_columns(plain[0], K1.plan(f, dt)), plain[1])
    assert plain[0].shape == (27, f) and padded[0].shape[1] == K1.plan(f, dt)
    for kw in ({}, {"inv_out": inv}):
        a = K1.block0_plain(*planes, *plain, slope, **kw)
        b = K1.block0_plain(*planes, *padded, slope, **kw)
        assert a.shape[-1] == b.shape[-1] == f and torch.equal(a, b)

    plain = K2.block0_2conv_weights(w0, b0, w1, b1, 0.25, 0.1, dt)
    padded = K2.padded(plain)
    assert plain.w1.shape == (9, f, f)
    assert padded.w1.shape == (9, K2.plan(f), K2.plan(f))
    wq, s_w = quantize_weight(w1)
    qa = K2.block0_2conv_weights_q(wq, s_w, torch.tensor(0.02))
    qb = (K2.pad_w1(qa[0], K2.plan(f)), K1.pad_columns(qa[1], K2.plan(f)))
    for pa, pb, kw in ((plain, padded, {}), (plain, padded, {"inv_out": inv}),
                       (plain._replace(w1=qa[0]), padded._replace(w1=qb[0]),
                        {"inv_y": torch.tensor([50.0])})):
        ka, kb = dict(kw), dict(kw)
        if "inv_y" in kw:
            ka["w1_scale"], kb["w1_scale"] = qa[1], qb[1]
        a = K2.block0_2conv_plain(*planes, *pa, **ka)
        b = K2.block0_2conv_plain(*planes, *pb, **kb)
        assert a.shape[-1] == b.shape[-1] == f and torch.equal(a, b)


# -- the shape rules ----------------------------------------------------------

def test_plans_take_every_shape_the_pallas_kernels_take():
    """Every shape of the faults the port fixed (kh or kw past 8, C off
    the 16-byte vector, W of 32768 or more, row bins past 32 rows, any F,
    N past the staged limit) has a route; only what no kernel can be
    asked for raises."""
    # row 2: the vector instances keep the published shapes
    for dt in (F32, BF16):
        assert KR.forward_plan(384, 6, 6, dt) == KR.VECTOR
        assert KR.forward_plan(512, 6, 6, dt) == KR.VECTOR
        for C, kh, kw in ((384, 9, 9), (384, 14, 14), (384, 3, 16),
                          (13, 6, 6), (1, 1, 1), (7, 40, 2)):
            assert KR.forward_plan(C, kh, kw, dt) == KR.ANY
    # C = 12 and 20: off bf16's 8-channel vector, on float32's 4-channel one
    for C in (12, 20):
        assert KR.forward_plan(C, 6, 6, BF16) == KR.ANY
        assert KR.forward_plan(C, 6, 6, F32) == KR.VECTOR
    # row 4
    assert KR.backward_plan(224, 29, 50, 384, 6, 6) == (KR.VECTOR, 1)
    assert KR.backward_plan(224, 63, 30, 512, 6, 6) == (KR.VECTOR, 1)
    assert KR.backward_plan(224, 186, 50, 64, 6, 6) == (KR.VECTOR, 1)
    for args, words in (((64, 29, 50, 384, 9, 9), 1),
                        ((64, 29, 50, 384, 3, 16), 1),
                        ((64, 29, 50, 12, 6, 6), 1),
                        ((64, 4, 32768, 16, 6, 6), 1),
                        ((64, 187, 50, 64, 6, 6), 2),
                        ((64, 188, 50, 64, 6, 6), 2),
                        ((64, 400, 50, 64, 6, 6), 3),
                        ((64, 3000, 40, 64, 1, 1), 94),
                        ((5000, 29, 50, 384, 6, 6), 1)):
        assert KR.backward_plan(*args) == (KR.ANY, words), args
    # row 3: any F, padded to the kernel's granule
    assert [K1.plan(f, BF16) for f in (1, 8, 24, 64, 65, 96, 128)] == \
        [64, 64, 64, 64, 128, 128, 128]
    assert [K1.plan(f, F32) for f in (1, 8, 24, 64, 96)] == \
        [16, 16, 32, 64, 96]
    # row 6
    assert [K2.plan(f) for f in (1, 8, 32, 64, 65, 128, 200)] == \
        [64, 64, 64, 64, 128, 128, 256]
    # row 1: staged up to MAX_BOXES, read from device memory past it
    assert not nms_kernel.plan(512) and not nms_kernel.plan(87552)
    assert nms_kernel.plan(87553) and nms_kernel.plan(120000)
    assert nms_kernel.plan(nms_kernel.MAX_DIRECT)
    # what raises: empty grids and filters, N past the alive bitset
    for bad in (lambda: KR.forward_plan(0, 6, 6, F32),
                lambda: KR.forward_plan(16, 0, 6, F32),
                lambda: KR.backward_plan(8, 0, 10, 16, 6, 6),
                lambda: KR.backward_plan(8, 10, 10, 16, 6, 0),
                lambda: K1.plan(0, BF16), lambda: K2.plan(0),
                lambda: nms_kernel.plan(nms_kernel.MAX_DIRECT + 1)):
        with pytest.raises(ValueError):
            bad()
