"""The port's ops (each the plain version of a CUDA kernel, or the
normalization in front of them) against the JAX package, whose Pallas
kernels run in interpret mode as its own tests run them on the CPU.

Tolerances:
* normalization (``normalize_s2d``, ``normalize_image``): atol 1e-5
  (float32 sums over the image in another order);
* ``unwire_uint8``: rtol 1e-6 (a 3x3 matmul in another order);
* NMS: indices and validity exactly equal, score ties and IoU exactly at
  the threshold included; the keep mask and its slots (the CUDA kernel's
  two outputs) exactly equal to the Pallas kernel's mask and its JAX
  compaction, on the serving path's sizes, the kernel's 64-box chunk
  edges in N and max_out, NaN and infinite coordinates and an image with
  no valid box;
* ROI pool: exactly equal, small and overlapping bins and invalid rois
  included;
* ROI-pool backward (plain): against the Pallas ``_backward`` (interpret)
  and ``jax.vjp`` of ``adaptive_max_pool``, atol 1e-6 in float32 (sums in
  another order); in bf16 within one bf16 ulp of ``_backward``; ties,
  overlapping bins and invalid rois included, and the cases the CUDA
  kernel's two passes must get right (shared rows and bins, ties across
  rows and columns, map edges, an all-invalid image, one-cell-wide rois);
  the kernel's division by a count rounds as float32 division, exactly;
* first-max pool backward (plain): bitwise equal to ``jax.vjp`` of
  ``ceil_max_pool_2x2``, to ``_pool_bwd_pallas`` (interpret, even W) and
  to ``F.max_pool2d``'s own backward, float32 and bf16, with ties and odd
  H and W;
* block0 plain: rtol 1e-4 / atol 1e-4 in float32 against
  ``compute_s2d_block0`` (the fused kernel at compute dtype float32);
  against ``block0_nhwc`` (whose
  kernel computes from bf16 inputs and rounds its output to bf16) rtol
  1e-2 / atol 1e-2, one bf16 rounding step.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu.ops import color as jcolor
from frcnn_tpu.ops import normalization as jnorm
from frcnn_tpu.ops.nms import nms as j_nms
from frcnn_tpu.detect.detector import compute_s2d_block0
from frcnn_tpu.ops.pallas_block0 import block0_nhwc
from frcnn_tpu.ops.pallas_block0 import pack_s2d_np as j_pack_s2d_np
from frcnn_tpu.ops.pallas_nms import pallas_nms, pallas_nms_keep_mask
from frcnn_tpu.models.layers import ceil_max_pool_2x2 as j_pool
from frcnn_tpu.ops.pallas_pool_bwd import _pool_bwd_pallas
from frcnn_tpu.ops.pallas_roi_pool import _backward as j_roi_backward
from frcnn_tpu.ops.pallas_roi_pool import pallas_adaptive_max_pool_valid
from frcnn_tpu.ops.roi_pool import adaptive_max_pool as j_adaptive_max_pool
from frcnn_tpu.ops.roi_pool import prepare_roi_rects as j_prepare
from frcnn_tpu_torch.ops import block0_kernel, nms_kernel, roi_pool_kernel
from frcnn_tpu_torch.ops import pool_bwd as tpool
from frcnn_tpu_torch.ops import pool_bwd_kernel
from frcnn_tpu_torch.ops import color as tcolor
from frcnn_tpu_torch.ops import normalization as tnorm
from frcnn_tpu_torch.ops import roi_pool as troi
from tests.tiny import tiny_config

# the module: the package exports the function ``nms`` under its name
tnms = importlib.import_module("frcnn_tpu_torch.ops.nms")


@pytest.fixture(autouse=True)
def _no_tf32():
    """Float32 comparisons run in full float32 (no TF32) on any device."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- normalization --------------------------------------------------------------

SIZES = [(32, 48, [(32, 48), (25, 33), (10, 47)]),
         (64, 40, [(64, 40), (61, 7), (2, 40)])]


@pytest.mark.parametrize("H,W,true_sizes", SIZES)
@pytest.mark.parametrize("method", ["contrastive", "none"])
def test_normalize_s2d_and_image(H, W, true_sizes, method):
    rng = np.random.default_rng(H)
    B = len(true_sizes)
    img = rng.normal(0.3, 0.2, (B, H, W, 3)).astype(np.float32)
    th = np.array([s[0] for s in true_sizes], np.int32)
    tw = np.array([s[1] for s in true_sizes], np.int32)
    kw = dict(method=method, width=7, centering=True, scaling=True)

    got = tnorm.normalize_image(_t(img), _t(th), _t(tw), **kw).numpy()
    ref = jax.jit(jax.vmap(lambda x, h, w: jnorm.normalize_image(
        x, h, w, **kw)))(img, th, tw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)

    lum4, chroma = j_pack_s2d_np(img)
    gl, gc = tnorm.normalize_s2d(_t(lum4), _t(chroma), _t(th), _t(tw), **kw)
    rl, rc = jax.jit(jax.vmap(lambda a, c, h, w: jnorm.normalize_s2d(
        a, c, h, w, **kw)))(lum4, chroma, th, tw)
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=0, atol=1e-5)


def test_pack_s2d_and_unwire():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 10, 14, 3)).astype(np.uint8)
    ref = jcolor.unwire_uint8(x, "yuv")
    got = tcolor.unwire_uint8(x, "yuv")
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tcolor.unwire_uint8(_t(x), "yuv").numpy(),
                               ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tcolor.unwire_uint8(x, "rgb"),
                                  jcolor.unwire_uint8(x, "rgb"))
    for a, b in zip(block0_kernel.pack_s2d_np(ref), j_pack_s2d_np(ref)):
        np.testing.assert_array_equal(a, b)
    lum4, chroma = j_pack_s2d_np(ref)
    p = block0_kernel.unpack_s2d(_t(lum4), _t(chroma)).numpy()
    np.testing.assert_array_equal(
        p.transpose(0, 2, 3, 1), np.pad(ref, [(0, 0), (1, 1), (1, 1), (0, 0)]))


# -- NMS ------------------------------------------------------------------------

def _nms_case(seed, B, N):
    """Cluttered boxes with integer coordinates, duplicated boxes, equal
    scores, pairs at IoU exactly 0.25 and 0.1, and invalid entries."""
    rng = np.random.default_rng(seed)
    mins = rng.integers(0, 120, (B, N, 2))
    sizes = rng.integers(4, 50, (B, N, 2))
    boxes = np.concatenate([mins, mins + sizes], -1).astype(np.float32)
    boxes[:, 5::9] = boxes[:, 4::9][:, : boxes[:, 5::9].shape[1]]
    # +1-pixel areas 100 and 400 sharing 100: IoU 0.25; 100 and 1000: 0.1
    boxes[:, 0] = [300, 300, 309, 309]
    boxes[:, 1] = [300, 300, 309, 339]
    boxes[:, 2] = [400, 400, 409, 409]
    boxes[:, 3] = [400, 400, 409, 499]
    scores = rng.integers(0, 6, (B, N)).astype(np.float32) / 5.0
    valid = rng.uniform(size=(B, N)) > 0.15
    return boxes, scores, valid


@pytest.mark.parametrize("thr,max_out", [(0.25, 128), (0.1, 128),
                                         (0.5, 7), (0.25, 1)])
def test_nms_plain_matches_pallas_and_xla(thr, max_out):
    B, N = 6, 96
    boxes, scores, valid = _nms_case(int(thr * 100) + max_out, B, N)
    jb, js, jv = jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)
    ref_i, ref_v = jax.jit(lambda b, s, v: pallas_nms(
        b, s, v, thr, max_out, interpret=True))(jb, js, jv)
    xla_i, xla_v = jax.jit(jax.vmap(
        lambda b, s, v: j_nms(b, s, v, thr, max_out)))(jb, js, jv)
    for fn in (tnms.nms, nms_kernel.cuda_nms):
        got_i, got_v = fn(_t(boxes), _t(scores), _t(valid), thr, max_out)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(xla_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(xla_v))


def test_nms_keep_mask_at_threshold():
    """IoU exactly at the threshold survives, just above is suppressed;
    the keep mask equals the Pallas kernel's on sorted input."""
    boxes, _, _ = _nms_case(7, 2, 64)
    valid = np.ones((2, 64), bool)
    for thr in (0.25, 0.1, 0.2499):
        ref = np.asarray(pallas_nms_keep_mask(
            jnp.asarray(boxes), jnp.asarray(valid), thr, 64, interpret=True))
        got = nms_kernel.nms_keep_mask(_t(boxes), _t(valid), thr, 64).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got[:, 1].all() == (thr >= 0.25)
        assert got[:, 3].all() == (thr >= 0.1)


def _sparse_boxes(rng, B, N):
    """Boxes on a grid of disjoint cells, every third one with an
    overlapping twin: most survive, so the picks outnumber max_out."""
    k = np.arange(N)
    mins = np.stack([(k % 16) * 40, (k // 16) * 40], -1)[None].repeat(B, 0)
    mins = mins + rng.integers(0, 4, (B, N, 2))
    mins[:, 1::3] = mins[:, 0:-1:3][:, : mins[:, 1::3].shape[1]] + 3
    sizes = rng.integers(20, 34, (B, N, 2))
    return np.concatenate([mins, mins + sizes], -1).astype(np.float32)


def _nms_edge_case(name):
    """(boxes, scores, valid, thr, max_out) of one named case: the serving
    path's two calls, the kernel's 64-box chunk edges in N and in max_out
    (with more survivors than max_out), NaN coordinates and an image with
    no valid box."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("path"):
        N, thr = (512, 0.25) if name == "path_512" else (128, 0.1)
        boxes, scores, valid = _nms_case(N, 2, N)
        return boxes, scores, valid, thr, 128
    if name[0] == "n" and name[1:].isdigit():
        N = int(name[1:])
        boxes, scores, valid = _nms_case(N, 3, max(N, 4))
        return boxes[:, :N], scores[:, :N], valid[:, :N], 0.25, 128
    if name.startswith("max"):
        boxes = _sparse_boxes(rng, 2, 200)
        scores = rng.integers(0, 50, (2, 200)).astype(np.float32)
        return boxes, scores, np.ones((2, 200), bool), 0.25, int(name[3:])
    boxes, scores, valid = _nms_case(11, 3, 96)
    if name == "nan":
        # image 0: the first box in processing order is NaN (kept; its
        # NaN IoU suppresses every later box); image 1: NaN boxes later
        # in the order; image 2: an invalid box with a NaN and one with an
        # infinite coordinate (the Pallas kernel reads every pick's
        # coordinates through them: ``ops/nms.py::picked_coords``)
        scores[0, 7] = 9.0
        valid[0, 7] = True
        boxes[0, 7, 2] = np.nan
        boxes[1, 10::13, 1] = np.nan
        valid[2, 3:5] = False
        boxes[2, 3, 3] = np.nan
        boxes[2, 4, 0] = np.inf
    else:                                               # "empty_row"
        valid[1] = False
    return boxes, scores, valid, 0.1, 64


NMS_EDGE_CASES = ["path_512", "path_128", "n1", "n63", "n64", "n65",
                  "n200", "max1", "max63", "max64", "max65", "nan",
                  "empty_row"]


@pytest.mark.parametrize("name", NMS_EDGE_CASES)
def test_nms_keep_mask_and_slots_match_pallas(name):
    """The plain keep mask and its slots (the CUDA kernel's two outputs)
    equal the Pallas kernel's keep mask (interpret) and the JAX
    compaction of it; the indices equal ``pallas_nms``'s."""
    from frcnn_tpu.geometry.matching import compact_mask as j_compact

    boxes, scores, valid, thr, max_out = _nms_edge_case(name)
    perm = tnms.sort_desc_with_ref_ties(_t(scores), _t(valid)).numpy()
    bs = np.take_along_axis(boxes, perm[:, :, None], axis=1)
    vs = np.take_along_axis(valid, perm, axis=1)
    ref_keep = jax.jit(lambda b, v: pallas_nms_keep_mask(
        b, v, thr, max_out, interpret=True))(jnp.asarray(bs), jnp.asarray(vs))
    ref_slots = jax.vmap(lambda m: j_compact(m, max_out)[0])(ref_keep)
    for fn in (tnms.nms_keep_slots, nms_kernel.nms_keep_slots):
        keep, slots = fn(_t(bs), _t(vs), thr, max_out)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
        np.testing.assert_array_equal(slots.numpy(), np.asarray(ref_slots))
        assert slots.dtype == torch.int32
    if name == "nan":
        assert np.asarray(ref_keep)[0].sum() == 1
    if name.startswith("max"):
        assert (np.asarray(ref_slots) >= 0).all()      # the cap binds
    ref_i, ref_v = jax.jit(lambda b, s, v: pallas_nms(
        b, s, v, thr, max_out, interpret=True))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    for fn in (tnms.nms, nms_kernel.cuda_nms):
        got_i, got_v = fn(_t(boxes), _t(scores), _t(valid), thr, max_out)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


def test_sort_ties_and_class_offsets():
    from frcnn_tpu.ops.nms import _sort_desc_with_ref_ties, class_offset_boxes

    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, (4, 50)).astype(np.float32)
    s[0, :] = 1.0
    v = rng.uniform(size=(4, 50)) > 0.3
    got = tnms.sort_desc_with_ref_ties(_t(s), _t(v)).numpy()
    for b in range(4):
        ref = np.asarray(_sort_desc_with_ref_ties(jnp.asarray(s[b]),
                                                  jnp.asarray(v[b])))
        np.testing.assert_array_equal(got[b], ref)
    boxes = rng.uniform(0, 300, (2, 30, 4)).astype(np.float32)
    cls = rng.integers(0, 5, (2, 30)).astype(np.int32)
    np.testing.assert_array_equal(
        tnms.class_offset_boxes(_t(boxes), _t(cls), _t(v[:2, :30])).numpy(),
        np.asarray(class_offset_boxes(jnp.asarray(boxes), jnp.asarray(cls),
                                      jnp.asarray(v[:2, :30]))))


# -- ROI pool -------------------------------------------------------------------

@pytest.mark.parametrize("seed,H,W", [(0, 29, 50), (1, 7, 9), (2, 3, 4)])
def test_roi_pool_plain_matches_pallas(seed, H, W):
    rng = np.random.default_rng(seed)
    B, C, D = 2, 16, 24
    fm = rng.normal(size=(B, H, W, C)).astype(np.float32)
    fm[:, ::3, ::2, :4] = 0.5                       # ties inside bins
    raw = np.concatenate([rng.integers(-3, W, (B, D, 1)),
                          rng.integers(-3, H, (B, D, 1)),
                          rng.integers(0, W + 4, (B, D, 1)),
                          rng.integers(0, H + 4, (B, D, 1))],
                         -1).astype(np.float32)
    raw[:, :4] = [0, 0, 2, 3]                       # smaller than the grid
    fw = np.full((B, 1), float(W), np.float32)
    fh = np.full((B, 1), float(H), np.float32)
    rects = troi.prepare_roi_rects(_t(raw), _t(fw), _t(fh)).numpy()
    np.testing.assert_array_equal(
        rects, np.asarray(j_prepare(jnp.asarray(raw), fw, fh)))
    valid = rng.uniform(size=(B, D)) > 0.25
    ref = np.asarray(pallas_adaptive_max_pool_valid(
        jnp.asarray(fm), jnp.asarray(rects), jnp.asarray(valid), 6, 6, True))
    for fn in (troi.adaptive_max_pool, roi_pool_kernel.adaptive_max_pool_valid):
        got = fn(_t(fm), _t(rects), _t(valid), 6, 6).numpy()
        np.testing.assert_array_equal(got, ref)
    # bf16 maps: output in bf16, the same maxima
    got16 = troi.adaptive_max_pool(_t(fm).to(torch.bfloat16), _t(rects),
                                   _t(valid), 6, 6)
    ref16 = np.asarray(pallas_adaptive_max_pool_valid(
        jnp.asarray(fm, jnp.bfloat16), jnp.asarray(rects),
        jnp.asarray(valid), 6, 6, True).astype(jnp.float32))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), ref16)


def _roi_case(seed, H, W, B=2, C=16, D=24):
    rng = np.random.default_rng(seed)
    fm = rng.integers(0, 4, (B, H, W, C)).astype(np.float32) / 4  # ties
    raw = np.concatenate([rng.integers(-3, W, (B, D, 1)),
                          rng.integers(-3, H, (B, D, 1)),
                          rng.integers(0, W + 4, (B, D, 1)),
                          rng.integers(0, H + 4, (B, D, 1))],
                         -1).astype(np.float32)
    raw[:, :4] = [0, 0, 2, 3]                       # smaller than the grid
    rects = troi.prepare_roi_rects(
        _t(raw), _t(np.full((B, 1), float(W), np.float32)),
        _t(np.full((B, 1), float(H), np.float32))).numpy()
    valid = rng.uniform(size=(B, D)) > 0.25
    g = rng.normal(size=(B, D, 6, 6, C)).astype(np.float32)
    return fm, rects, valid, g


@pytest.mark.parametrize("seed,H,W", [(0, 29, 50), (1, 7, 9)])
def test_roi_pool_backward_plain_matches_jax(seed, H, W):
    fm, rects, valid, g = _roi_case(seed, H, W)
    got = troi.adaptive_max_pool_backward(_t(fm), _t(rects), _t(valid),
                                          _t(g), 6, 6)
    assert got.dtype == torch.float32
    ref = j_roi_backward(jnp.asarray(fm), jnp.asarray(rects),
                         jnp.asarray(valid), jnp.asarray(g), 6, 6, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # autodiff of the columns-first XLA formulation, one image at a time
    gm = g * valid[:, :, None, None, None]
    for b in range(fm.shape[0]):
        _, vjp = jax.vjp(lambda f: j_adaptive_max_pool(
            f, jnp.asarray(rects[b]), 6, 6), jnp.asarray(fm[b]))
        np.testing.assert_allclose(got[b].numpy(),
                                   np.asarray(vjp(jnp.asarray(gm[b]))[0]),
                                   rtol=0, atol=1e-6)
    # bf16 maps: float32 sums, one cast, within one bf16 ulp
    got16 = troi.adaptive_max_pool_backward(
        _t(fm).bfloat16(), _t(rects), _t(valid), _t(g), 6, 6)
    assert got16.dtype == torch.bfloat16
    ref16 = np.asarray(j_roi_backward(
        jnp.asarray(fm, jnp.bfloat16), jnp.asarray(rects), jnp.asarray(valid),
        jnp.asarray(g), 6, 6, True).astype(jnp.float32))
    ref16 = torch.from_numpy(np.array(ref16)).bfloat16()
    ulps = (got16.view(torch.int16).int() - ref16.view(torch.int16).int())
    assert int(ulps.abs().max()) <= 1


def _roi_edge_case(name, H=11, W=13, B=2, C=16, D=8):
    """Cases the two-pass kernel design has to get right: rois sharing
    rows and bins, ties across rows and columns of one bin, rois on the
    map's edges, an image with every slot invalid, one-cell-wide rois."""
    rng = np.random.default_rng(7)
    fm = rng.integers(0, 4, (B, H, W, C)).astype(np.float32) / 4
    rects = np.stack([rng.integers(0, W - 4, (B, D)),
                      rng.integers(0, H - 4, (B, D))], -1)
    rects = np.concatenate([rects, rects + rng.integers(1, 5, (B, D, 2))],
                           -1)
    valid = np.ones((B, D), bool)
    if name == "shared_rows_bins":
        rects[:, :4] = [[1, 2, 10, 9], [1, 2, 10, 9], [4, 2, 13, 9],
                        [2, 3, 5, 5]]
    elif name == "ties_rows_cols":
        fm[:, 2:8, 3:9, :] = np.where(
            rng.uniform(size=(B, 6, 6, C)) < 0.5, 1.0, fm[:, 2:8, 3:9, :])
        rects[:, :3] = [[2, 2, 9, 8], [3, 2, 6, 5], [0, 0, 13, 11]]
    elif name == "map_edges":
        rects[:, :4] = [[0, 0, W, H], [W - 1, H - 1, W, H],
                        [0, H - 3, W, H], [W - 4, 0, W, 5]]
    elif name == "image_all_invalid":
        valid[1] = False
        valid[0, ::3] = False
    elif name == "one_cell_wide":
        rects[:, :4] = [[4, 0, 5, H], [0, 3, W, 4], [6, 6, 7, 7],
                        [W - 1, 2, W, 9]]
    g = rng.normal(size=(B, D, 6, 6, C)).astype(np.float32)
    return fm, rects.astype(np.float32), valid, g


@pytest.mark.parametrize("name", ["shared_rows_bins", "ties_rows_cols",
                                  "map_edges", "image_all_invalid",
                                  "one_cell_wide"])
def test_roi_pool_backward_cases_match_jax(name):
    fm, rects, valid, g = _roi_edge_case(name)
    args = (jnp.asarray(rects), jnp.asarray(valid), jnp.asarray(g), 6, 6,
            True)
    got = troi.adaptive_max_pool_backward(_t(fm), _t(rects), _t(valid),
                                          _t(g), 6, 6)
    ref = np.asarray(j_roi_backward(jnp.asarray(fm), *args))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    if name == "image_all_invalid":
        assert not got[1].any()
    got16 = troi.adaptive_max_pool_backward(
        _t(fm).bfloat16(), _t(rects), _t(valid), _t(g), 6, 6)
    ref16 = torch.from_numpy(np.array(j_roi_backward(
        jnp.asarray(fm, jnp.bfloat16), *args).astype(jnp.float32)))
    ulps = got16.view(torch.int16).int() - ref16.bfloat16().view(
        torch.int16).int()
    assert int(ulps.abs().max()) <= 1


def _rn32(x):
    """A rational rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    f = np.float32(float(x))
    cands = (f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.uint32)) & 1))


def test_roi_pool_backward_division_rounds_as_ieee():
    """The ROI-pool backward kernel divides by a count n as Markstein's
    correction of x * y, y = 1/n rounded (csrc/roi_pool_bwd.cu
    ``div_count``): q = x * y, r = fma(-n, q, x), q + r * y, each rounded
    once; it must round as the float32 division x / n does."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    xs = np.concatenate([rng.standard_normal(120),
                         rng.integers(-400, 400, 60) / 4,
                         rng.standard_normal(60) * 1e-6]).astype(np.float32)
    for n in (1, 2, 3, 5, 6, 7, 9, 11, 12, 13, 17, 31, 100):
        y = _rn32(Fraction(1, n))
        for x in xs:
            q = x * y                                     # float32 product
            r = Fraction(float(x)) - n * Fraction(float(q))
            assert Fraction(float(np.float32(float(r)))) == r  # exact
            got = _rn32(Fraction(float(q)) + r * Fraction(float(y)))
            assert got == np.float32(x) / np.float32(n), (x, n)


def test_roi_pool_backward_tie_mask_bytes():
    """The kernel's row-tie masks hold a bit per row of a row bin: bins of
    vgg_small's 29-row map hold up to 6 rows, vgg_large's 63-row one 12, a
    3-row map 2, all in one 32-bit word per channel; past 32 rows the masks
    take more words (and the any-shape kernels), with no error."""
    assert roi_pool_kernel.tie_mask_rows(29, 6) == 6
    assert roi_pool_kernel.tie_mask_rows(63, 6) == 12
    assert roi_pool_kernel.tie_mask_rows(3, 6) == 2
    assert roi_pool_kernel.tie_mask_rows(186, 6) == 32
    assert roi_pool_kernel.tie_mask_rows(200, 6) == 35
    assert [roi_pool_kernel.tie_mask_words(h, 6)
            for h in (29, 186, 187, 200, 400)] == [1, 1, 2, 2, 3]


def test_roi_pool_grad_functions():
    """The differentiable pools (plain, and the kernel wrapper on CPU)
    send the cotangent through the plain backward."""
    fm, rects, valid, g = _roi_case(2, 9, 11)
    want = troi.adaptive_max_pool_backward(_t(fm), _t(rects), _t(valid),
                                           _t(g), 6, 6)
    for fn in (troi.adaptive_max_pool_grad,
               roi_pool_kernel.adaptive_max_pool_valid_grad):
        x = _t(fm).requires_grad_(True)
        out = fn(x, _t(rects), _t(valid), 6, 6)
        assert torch.equal(out.detach(), troi.adaptive_max_pool(
            _t(fm), _t(rects), _t(valid), 6, 6))
        out.backward(_t(g))
        assert torch.equal(x.grad, want)


POOL_CASES = [((2, 8, 16, 64), None), ((2, 8, 16, 64), 2),
              ((1, 7, 16, 64), 3), ((1, 9, 8, 128), None),
              ((2, 16, 6, 64), 2), ((1, 7, 9, 16), 2), ((2, 5, 3, 8), 1)]


@pytest.mark.parametrize("shape,ties", POOL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_backward_plain_matches_jax_and_torch(shape, ties, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    if ties:
        x = np.round(x * ties) / ties
    B, H, W, C = shape
    g = rng.normal(size=(B, -(-H // 2), -(-W // 2), C)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    tx, tg = _t(x).to(tdt), _t(g).to(tdt)
    got = tpool.ceil_max_pool_2x2_bwd(tx, tg)
    assert got.dtype == tdt and got.shape == tx.shape

    def same(ref):
        ref = torch.from_numpy(np.asarray(jnp.asarray(ref, jnp.float32)))
        assert torch.equal(got.float(), ref)

    _, vjp = jax.vjp(j_pool, jx)
    same(vjp(jg)[0])
    if W % 2 == 0:
        same(_pool_bwd_pallas(jx, jg, interpret=True))
    # torch's own max_pool2d backward, and the autograd wrapper, on NCHW
    xn = tx.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    torch.nn.functional.max_pool2d(xn, 2, 2, ceil_mode=True).backward(
        tg.permute(0, 3, 1, 2))
    assert torch.equal(xn.grad.permute(0, 2, 3, 1), got)
    xk = tx.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = pool_bwd_kernel.ceil_max_pool_2x2_firstmax(xk)
    assert torch.equal(out.detach(), torch.nn.functional.max_pool2d(
        xk.detach(), 2, 2, ceil_mode=True))
    out.backward(tg.permute(0, 3, 1, 2))
    assert torch.equal(xk.grad.permute(0, 2, 3, 1), got)


# -- block0 ---------------------------------------------------------------------

def test_block0_plain_matches_pallas():
    H, W = 26, 40
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, H, W, 3)).astype(np.float32)
    w = rng.normal(0, 0.2, (3, 3, 3, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, (64,)).astype(np.float32)
    slope = np.float32(0.25)
    w_oihw = _t(w.transpose(3, 2, 0, 1))
    lum4, chroma = block0_kernel.pack_s2d_np(x)
    tl, tc, ts = _t(lum4), _t(chroma), torch.tensor([slope])

    # float32: the serving producer at compute dtype f32 (interpret)
    w27, b32 = block0_kernel.block0_weights(w_oihw, _t(b), torch.float32)
    got = block0_kernel.fused_block0(tl, tc, w27, b32, ts).numpy()
    p0 = {"block0_conv0": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
          "block0_prelu0": {"slope": jnp.asarray([slope])}}
    cfg = tiny_config().replace(pallas_mode="interpret", input_layout="s2d")
    ref = np.asarray(compute_s2d_block0(cfg, object(), p0, jnp.asarray(lum4),
                                        jnp.asarray(chroma)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    # bf16: the drop-in block0_nhwc (bf16 inputs, bf16 output)
    got16 = block0_kernel.block0_nhwc(_t(x).bfloat16(), w_oihw, _t(b), slope)
    assert got16.dtype == torch.bfloat16
    ref16 = np.asarray(block0_nhwc(jnp.asarray(x), w, b, slope,
                                   interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got16.float().numpy(), ref16, rtol=1e-2,
                               atol=1e-2)


# -- CPU dispatch of the kernel wrappers ------------------------------------------

def _dispatch_case(name):
    """(wrapper, plain version, args, kernel handle) at a small size."""
    rng = np.random.default_rng(5)
    if name == "nms":
        boxes, _, _ = _nms_case(5, 2, 32)
        args = (_t(boxes), torch.ones(2, 32, dtype=torch.bool), 0.25, 16)
        return nms_kernel.nms_keep_mask, tnms.nms_keep_mask, args, \
            nms_kernel.KERNEL
    if name == "nms_slots":
        boxes, _, _ = _nms_case(5, 2, 70)
        valid = torch.ones(2, 70, dtype=torch.bool)
        valid[1, ::3] = False
        args = (_t(boxes), valid, 0.25, 65)
        return nms_kernel.nms_keep_slots, tnms.nms_keep_slots, args, \
            nms_kernel.KERNEL
    if name in ("roi_pool", "roi_pool_bwd"):
        fm = _t(rng.normal(size=(2, 9, 11, 8)).astype(np.float32))
        rects = torch.tensor([[[0, 0, 9, 7], [2, 1, 5, 8]]] * 2,
                             dtype=torch.float32)
        valid = torch.tensor([[True, False]] * 2)
        if name == "roi_pool":
            return roi_pool_kernel.adaptive_max_pool_valid, \
                troi.adaptive_max_pool, (fm, rects, valid, 6, 6), \
                roi_pool_kernel.KERNEL
        g = _t(rng.normal(size=(2, 2, 6, 6, 8)).astype(np.float32))
        return roi_pool_kernel.adaptive_max_pool_valid_backward, \
            troi.adaptive_max_pool_backward, (fm, rects, valid, g, 6, 6), \
            roi_pool_kernel.BWD_KERNEL
    if name == "roi_pool_bf16_portrait":
        # a tall map, C = 16 (two 16-byte vectors of bf16), rects smaller
        # than the grid and on the map's edges, one slot invalid
        fm = _t(rng.normal(size=(2, 13, 5, 16)).astype(np.float32))
        rects = torch.tensor([[[0, 0, 5, 13], [3, 9, 5, 13], [1, 2, 2, 3]],
                              [[4, 0, 5, 4], [0, 5, 5, 8], [2, 2, 4, 11]]],
                             dtype=torch.float32)
        valid = torch.tensor([[True, True, False], [True, True, True]])
        return roi_pool_kernel.adaptive_max_pool_valid, \
            troi.adaptive_max_pool, (fm.bfloat16(), rects, valid, 6, 6), \
            roi_pool_kernel.KERNEL
    if name == "pool_bwd":
        x = _t(np.round(rng.normal(size=(2, 7, 9, 8)) * 2).astype(np.float32))
        g = _t(rng.normal(size=(2, 4, 5, 8)).astype(np.float32))
        return pool_bwd_kernel.ceil_max_pool_2x2_bwd, \
            tpool.ceil_max_pool_2x2_bwd, (x, g), pool_bwd_kernel.KERNEL
    lum4, chroma = block0_kernel.pack_s2d_np(
        rng.normal(size=(1, 8, 12, 3)).astype(np.float32))
    w27, bias = block0_kernel.block0_weights(
        _t(rng.normal(size=(16, 3, 3, 3)).astype(np.float32)),
        torch.zeros(16), torch.float32)
    args = (_t(lum4), _t(chroma), w27, bias, torch.tensor([0.25]))
    if name == "block0_s8out":
        args += (torch.tensor([4.0]),)        # inv_out: the int8 mode
        return block0_kernel.fused_block0, block0_kernel.block0_plain, \
            args, block0_kernel.S8_KERNEL
    return block0_kernel.fused_block0, block0_kernel.block0_plain, args, \
        block0_kernel.KERNEL


@pytest.mark.parametrize("name", ["nms", "roi_pool", "block0",
                                  "roi_pool_bwd", "pool_bwd", "block0_s8out",
                                  "roi_pool_bf16_portrait", "nms_slots"])
def test_wrapper_runs_plain_version_on_cpu(name):
    """On CPU tensors each wrapper returns its plain version's result (a
    tensor, or a tuple of them) exactly and counts no launch."""
    wrapper, plain, args, kernel = _dispatch_case(name)
    before = kernel.launches
    got, want = wrapper(*args), plain(*args)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        assert torch.equal(g, w)
    assert kernel.launches == before
