"""The vgg_large slice: the plain 2-conv block0 against the JAX package's
Pallas kernel (interpret mode), pnet and detect at a narrow vgg_large-shaped
config in a landscape and a portrait bucket, the imagenet configs, anchor
fields and weights at full width.

Tolerances:
- 2-conv block0, float32: atol 1e-4 of the output's largest magnitude (the
  same sums in another order);
- 2-conv block0, bf16: 2 bf16 ulps of the output's largest magnitude: y0
  is rounded to bf16 in both packages from float32 sums taken in another
  order, so a y0 value may round the other way, and the output is rounded
  once from float32 sums taken in another order;
- pnet: atol 1e-4 (float32 convolutions in another order);
- detect: ``valid``, ``classes`` and ``proposals_valid`` equal, boxes atol
  1e-3, confidence and fg_score atol 1e-5 (``tests/test_torch_detect.py``);
- configs, anchor fields and the weight round trip: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import frcnn_tpu.config as jcfg
import frcnn_tpu_torch.config as tcfg
from frcnn_tpu.detect.detector import build_detect_fn, compute_s2d_block0
from frcnn_tpu.geometry.anchors import AnchorGenerator as JGen
from frcnn_tpu.models.factory import create_models as j_create
from frcnn_tpu.models.factory import init_params
from frcnn_tpu.ops.pallas_block0 import block0_weights, pack_s2d_np
from frcnn_tpu.ops.pallas_block0 import views_from_s2d
from frcnn_tpu.ops.pallas_block0_2conv import (
    block0_2conv_weights,
    fused_block0_2conv,
)
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
from frcnn_tpu_torch.models.factory import create_models
from frcnn_tpu_torch.ops import block0_2conv_kernel as K
from frcnn_tpu_torch.ops.block0_kernel import pack_padded, pack_s2d
from frcnn_tpu_torch.utils.weights import from_jax_params, to_jax_params
from tests.test_torch_detect import _mild_fg_params
from tests.tiny import tiny_config

LAND = (128, 160)
PORT = (160, 128)


@pytest.fixture(autouse=True)
def _no_tf32():
    """Float32 comparisons run in full float32 (no TF32) on any device."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# -- the 2-conv block0 ---------------------------------------------------------

def _rand(seed, B, H, W, f=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    w0 = rng.normal(0, 0.2, (3, 3, 3, f)).astype(np.float32)
    b0 = rng.normal(0, 0.1, (f,)).astype(np.float32)
    w1 = rng.normal(0, 0.08, (3, 3, f, f)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (f,)).astype(np.float32)
    return x, w0, b0, w1, b1


def _jax_2conv(lum4, chroma, w0, b0, w1, b1, s0, s1, cdt):
    """The Pallas kernel in interpret mode -> NHWC float32 numpy."""
    cv, lv = views_from_s2d(jnp.asarray(lum4), jnp.asarray(chroma),
                            out_dtype=cdt)
    wt0, bias0 = block0_weights(w0, b0)
    out = fused_block0_2conv(cv, lv, wt0, bias0, s0, block0_2conv_weights(w1),
                             b1, s1, interpret=True, compute_dtype=cdt)
    return np.asarray(out.astype(jnp.float32).transpose(0, 1, 3, 2))


def _port_params(w0, b0, w1, b1, s0, s1, dtype):
    """HWIO numpy weights -> the kernel's parameters (from OIHW)."""
    return K.block0_2conv_weights(
        torch.from_numpy(w0).permute(3, 2, 0, 1), torch.from_numpy(b0),
        torch.from_numpy(w1).permute(3, 2, 0, 1), torch.from_numpy(b1),
        s0, s1, dtype)


def _planes(lum4, chroma, dtype):
    return (torch.from_numpy(np.asarray(lum4)).to(dtype),
            torch.from_numpy(np.asarray(chroma)).to(dtype))


def _bf16_ulp(m):
    """One bf16 unit in the last place at magnitude ``m``."""
    return 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("hw", [(12, 16), (26, 40)])
def test_plain_2conv_matches_pallas_f32(hw):
    x, w0, b0, w1, b1 = _rand(0, 2, *hw)
    lum4, chroma = pack_s2d_np(x)
    ref = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, jnp.float32)
    p = _port_params(w0, b0, w1, b1, 0.25, 0.1, torch.float32)
    got = K.fused_block0_2conv(*_planes(lum4, chroma, torch.float32), *p)
    assert got.shape == (2, hw[0] // 2, hw[1] // 2, 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def _plain_with_float32_y0(lum4, chroma, w0, b0, w1, b1, slopes):
    """The plain version without its y0 rounding (a wrong port)."""
    f = w0.shape[1]
    p = K.unpack_s2d(lum4, chroma).float()
    y = F.conv2d(p, w0.float().reshape(3, 3, 3, f).permute(3, 2, 0, 1), b0)
    y = torch.where(y >= 0, y, slopes[0] * y)
    y = F.conv2d(y, w1.float().reshape(3, 3, f, f).permute(2, 3, 0, 1), b1,
                 padding=1)
    y = F.max_pool2d(torch.where(y >= 0, y, slopes[1] * y), 2, 2)
    return y.permute(0, 2, 3, 1).to(lum4.dtype)


@pytest.mark.parametrize("hw", [(12, 16), (26, 40)])
def test_plain_2conv_matches_pallas_bf16(hw):
    x, w0, b0, w1, b1 = _rand(1, 2, *hw)
    lum4, chroma = pack_s2d_np(x)
    ref = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, jnp.bfloat16)
    p = _port_params(w0, b0, w1, b1, 0.25, 0.1, torch.bfloat16)
    planes = _planes(lum4, chroma, torch.bfloat16)
    got = K.fused_block0_2conv(*planes, *p)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert err.max() <= 2 * _bf16_ulp(np.abs(ref).max())
    # the port rounds y0: without that rounding it lands further away
    wrong = _plain_with_float32_y0(*planes, *p).float().numpy()
    wrong_err = np.abs(wrong - ref)
    assert np.count_nonzero(wrong_err) > 10 * max(np.count_nonzero(err), 1)
    assert wrong_err.sum() > 10 * err.sum()


def test_halo_is_masked_with_a_nonzero_pad_ring():
    """The planes' pad ring feeds conv0 at the border, but y0 outside the
    image is conv1's zero padding. A tile that computes y0 over its halo
    from the planes without masking it gets prelu0(b0 + ...) there: that
    variant is far from the Pallas kernel, the plain version is not."""
    H, W = 12, 16
    _, w0, b0, w1, b1 = _rand(2, 2, H, W)
    rng = np.random.default_rng(3)
    P = torch.from_numpy(rng.normal(0, 1, (2, H + 2, W + 2, 3))
                         .astype(np.float32))
    l, c = pack_padded(P)
    lum4, chroma = l.numpy(), c.numpy()
    assert torch.equal(K.unpack_s2d(l, c).permute(0, 2, 3, 1), P)
    ref = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, jnp.float32)
    p = _port_params(w0, b0, w1, b1, 0.25, 0.1, torch.float32)
    got = K.fused_block0_2conv(l, c, *p)
    tol = 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)

    # unmasked halo: y0 over fine rows/columns -1 .. H/W from the planes
    # (zero beyond them), no padding for conv1
    k0 = p.w0.reshape(3, 3, 3, 64).permute(3, 2, 0, 1)
    y0 = F.conv2d(F.pad(K.unpack_s2d(l, c), (1, 1, 1, 1)), k0, p.b0)
    y0 = torch.where(y0 >= 0, y0, p.slopes[0] * y0)
    k1 = p.w1.reshape(3, 3, 64, 64).permute(2, 3, 0, 1)
    y1 = F.conv2d(y0, k1, p.b1)
    y1 = torch.where(y1 >= 0, y1, p.slopes[1] * y1)
    unmasked = F.max_pool2d(y1, 2, 2).permute(0, 2, 3, 1).numpy()
    assert np.abs(unmasked - ref).max() > 100 * tol


def test_nhwc_entry_and_cpu_wrapper():
    """On CPU tensors the wrapper is the plain version (no launch counted);
    the NHWC entry packs and runs it."""
    x, w0, b0, w1, b1 = _rand(4, 1, 8, 10, f=16)
    p = _port_params(w0, b0, w1, b1, 0.2, 0.3, torch.float32)
    xt = torch.from_numpy(x)
    lum4, chroma = pack_s2d(xt)
    before = K.KERNEL.launches
    got = K.fused_block0_2conv(lum4, chroma, *p)
    assert K.KERNEL.launches == before
    assert torch.equal(got, K.block0_2conv_plain(lum4, chroma, *p))
    nhwc = K.block0_2conv_nhwc(xt, p.w0.reshape(3, 3, 3, 16).permute(
        3, 2, 0, 1), p.b0, 0.2, p.w1.reshape(3, 3, 16, 16).permute(
        2, 3, 0, 1), p.b1, 0.3)
    assert torch.equal(nhwc, got)


# -- narrow vgg_large-shaped model ----------------------------------------------

def narrow_vgg_large(**overrides):
    """vgg_large's structure (conv_steps 2/2/3/3, 2-conv first block) at
    tiny widths, with a landscape and a portrait bucket."""
    base = tiny_config()
    widths = (8, 16, 24, 32)
    layers = tuple(dataclasses.replace(spec, filters=f, conv_steps=n)
                   for spec, f, n in zip(base.model.layers, widths,
                                         (2, 2, 3, 3)))
    cfg = base.replace(
        model=dataclasses.replace(base.model, name="vgg_large_narrow",
                                  layers=layers),
        shapes=dataclasses.replace(base.shapes, image_hw=LAND,
                                   portrait_hw=PORT))
    return cfg.replace(**overrides) if overrides else cfg


def _port_models(jc, params, stats):
    cfg = tcfg.Config.from_json(jc.to_json())
    pnet, cnet = create_models(cfg)
    state = from_jax_params(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, stats), cfg)
    pnet.load_state_dict(state["pnet"])
    cnet.load_state_dict(state["cnet"])
    return cfg, pnet, cnet


def test_narrow_vgg_large_pnet_matches_jax():
    """Both pnet entries: NHWC images through all four blocks, and the
    2-conv block0 output through ``block0_out=`` (both of block 0's convs
    skipped), each against flax on the same weights."""
    jc = jcfg.serving_config(narrow_vgg_large()).replace(
        pallas_mode="interpret")
    assert jc.input_layout == "s2d"
    params, stats = init_params(jc, jax.random.PRNGKey(1))
    params["pnet"]["block0_prelu1"]["slope"] = np.array([0.1], np.float32)
    cfg, pnet, _ = _port_models(jc, params, stats)
    jp, _ = j_create(jc)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, *LAND, 3)).astype(np.float32)

    maps, fm = jp.apply({"params": params["pnet"]}, x, train=False)
    with torch.no_grad():
        tmaps, tfm = pnet(torch.from_numpy(x))
    for a, b in zip(tmaps + [tfm], list(maps) + [fm]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)

    lum4, chroma = pack_s2d_np(x)
    jb0 = compute_s2d_block0(jc, jp, params["pnet"], jnp.asarray(lum4),
                             jnp.asarray(chroma))
    det = Detector(cfg, pnet, _port_models(jc, params, stats)[2],
                   device="cpu")
    tb0 = K.fused_block0_2conv(*_planes(lum4, chroma, torch.float32),
                               *det.block0_params)
    np.testing.assert_allclose(tb0.numpy(), np.asarray(jb0), rtol=0,
                               atol=1e-4 * float(np.abs(jb0).max()))
    maps, fm = jp.apply({"params": params["pnet"]}, None, train=False,
                        block0_out=jb0)
    with torch.no_grad():
        tmaps, tfm = pnet(None, block0_out=tb0)
    for a, b in zip(tmaps + [tfm], list(maps) + [fm]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def dual():
    """JAX serving detect (Pallas interpret) of the narrow config, one
    program per bucket, and a landscape and a portrait batch of packed
    planes (one image per batch smaller than its bucket)."""
    jc = jcfg.serving_config(narrow_vgg_large()).replace(
        pallas_mode="interpret")
    params, stats = init_params(jc, jax.random.PRNGKey(0))
    params = _mild_fg_params(params)
    jp, jcn = j_create(jc)
    rng = np.random.default_rng(7)
    batches = {}
    for hw, small in ((LAND, (100, 130)), (PORT, (130, 100))):
        H, W = hw
        imgs = rng.normal(0.3, 0.2, (2, H, W, 3)).astype(np.float32)
        imgs[:, 30:70, 40:90] += 0.8
        true_hw = np.array([[H, W], list(small)], np.int32)
        fn = jax.jit(build_detect_fn(jc, JGen(jc, image_hw=hw), jp, jcn))
        planes = pack_s2d_np(imgs)
        ref = fn(params, stats, tuple(map(jnp.asarray, planes)),
                 jnp.asarray(true_hw))
        batches[hw] = (planes, true_hw, ref)
    return jc, params, stats, batches


@pytest.mark.parametrize("hw", [LAND, PORT])
def test_narrow_vgg_large_detect_matches_jax(dual, hw):
    jc, params, stats, batches = dual
    cfg, pnet, cnet = _port_models(jc, params, stats)
    det = Detector(cfg, pnet, cnet, device="cpu")
    planes, true_hw, ref = batches[hw]
    got = det.detect(planes, true_hw)
    assert set(det._programs) == {LAND} | {hw}
    assert int(np.asarray(ref.proposals_valid).sum()) > 10
    assert int(np.asarray(ref.valid).sum()) > 0
    for f in ("valid", "classes", "proposals_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("boxes", "proposal_boxes", "proposals"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-3, err_msg=f)
    for f in ("confidence", "fg_score"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-5, err_msg=f)


def test_buckets_route_by_shape_and_reject_unconfigured(dual):
    """A portrait batch, packed or as NHWC frames, runs the portrait
    bucket's program; a size outside the configured buckets raises."""
    jc, params, stats, batches = dual
    cfg, pnet, cnet = _port_models(jc, params, stats)
    det = Detector(cfg, pnet, cnet, device="cpu")
    assert set(det._programs) == {LAND}
    planes, true_hw, _ = batches[PORT]
    packed = det.detect(planes, true_hw)
    assert set(det._programs) == {LAND, PORT}
    frames = (K.unpack_s2d(*_planes(*planes, torch.float32))
              [:, :, 1:-1, 1:-1].permute(0, 2, 3, 1).contiguous())
    for imgs in (frames, frames.numpy()):
        out = det.detect(imgs, true_hw)
        np.testing.assert_array_equal(out.valid.numpy(),
                                      packed.valid.numpy())
        np.testing.assert_allclose(out.boxes.numpy(), packed.boxes.numpy(),
                                   rtol=0, atol=1e-3)
    bad = pack_s2d_np(np.zeros((1, 96, 96, 3), np.float32))
    with pytest.raises(ValueError, match="bucket"):
        det.detect(bad, np.array([[96, 96]], np.int32))
    with pytest.raises(ValueError, match="bucket"):
        det.detect(np.zeros((1, 96, 96, 3), np.float32),
                   np.array([[96, 96]], np.int32))


# -- the imagenet configuration at full width ------------------------------------

def test_imagenet_serving_config_matches_jax():
    j = jcfg.serving_config(jcfg.imagenet_config())
    t = tcfg.serving_config(tcfg.imagenet_config())
    assert t.to_json() == j.to_json()
    assert t.input_layout == "s2d" and t.pallas_mode == "on"
    assert [tuple(b) for b in t.shapes.buckets()] == [(480, 1000),
                                                      (1000, 480)]
    assert tcfg.Config.from_json(j.to_json()) == t


@pytest.mark.parametrize("hw", [(480, 1000), (1000, 480)])
def test_imagenet_anchor_fields_match_jax(hw):
    jg = JGen(jcfg.imagenet_config(), image_hw=hw)
    tg = AnchorGenerator(tcfg.imagenet_config(), image_hw=hw)
    assert tuple(tg.image_hw) == tuple(jg.image_hw) == hw
    assert tg.tap_dims == jg.tap_dims and tg.fm_hw == jg.fm_hw
    for name in ("boxes", "tap", "aspect", "fy", "fx", "bin_x", "bin_y"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name),
                                      name)
    np.testing.assert_array_equal(tg.detect_order(),
                                  np.asarray(jg.detect_order()))


def test_vgg_large_weights_round_trip_at_full_width():
    """from_jax_params / to_jax_params over every vgg_large leaf (2- and
    3-conv blocks, 512-wide feature map, 256-wide anchor heads, 201
    classes), and a Detector of the imagenet serving config builds."""
    base = jcfg.imagenet_config()
    jc = base.replace(shapes=dataclasses.replace(
        base.shapes, image_hw=(96, 128), portrait_hw=None))
    params, stats = init_params(jc, jax.random.PRNGKey(2))
    cfg = tcfg.Config.from_json(jc.to_json())
    state = from_jax_params(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, stats), cfg)
    pnet, cnet = create_models(cfg)
    pnet.load_state_dict(state["pnet"])
    cnet.load_state_dict(state["cnet"])
    assert pnet.block2_conv2.weight.shape == (256, 256, 3, 3)
    assert pnet.block3_conv2.weight.shape == (512, 512, 3, 3)
    assert pnet.anchor0_conv.weight.shape == (256, 256, 3, 3)
    assert cnet.fc0.weight.shape == (1024, 6 * 6 * 512)
    assert cnet.cls_head.weight.shape == (201, 512)
    back_p, back_s = to_jax_params(pnet.state_dict(), cnet.state_dict(), cfg)
    flat = jax.tree_util.tree_flatten_with_path
    ref_p, ref_s = flat(params)[0], flat(stats)[0]
    assert [k for k, _ in flat(back_p)[0]] == [k for k, _ in ref_p]
    assert [k for k, _ in flat(back_s)[0]] == [k for k, _ in ref_s]
    for (k, a), (_, b) in zip(flat(back_p)[0] + flat(back_s)[0],
                              ref_p + ref_s):
        np.testing.assert_array_equal(a, np.asarray(b), str(k))

    det = Detector(tcfg.serving_config(tcfg.imagenet_config()), pnet, cnet,
                   device="cpu")
    assert isinstance(det.block0_params, K.Block0TwoConvParams)
    assert det.block0_params.w1.shape == (9, 64, 64)
    w1 = det.block0_params.w1
    assert w1.dtype == torch.bfloat16
    assert torch.equal(w1.reshape(3, 3, 64, 64).permute(2, 3, 0, 1),
                       pnet.block0_conv1.weight.to(torch.bfloat16))
    assert set(det._programs) == {(480, 1000)}
