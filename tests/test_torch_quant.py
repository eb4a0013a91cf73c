"""The int8 serving slice: ``models/quant.py``, ``ops/int8_conv.py``, the
int8 modes of the two block0 kernels' plain versions and the quantized
``Detector``, against the JAX package (Pallas kernels in interpret mode,
JAX functions run eagerly unless said otherwise).

Tolerances:
- int8 weights and their float32 scales: bitwise (the same float32
  operations on the same float32 weights);
- int8 convolution: int32 sums exact; the dequantized output equal to
  eager ``_qconv``, and from jitted ``_qconv`` (the scale an argument) at
  most one float32 ulp of the product plus one of the result apart: XLA
  contracts ``sums * scale + bias`` into one fused multiply-add, the port
  rounds the product and the sum apart, as eager JAX does;
- the int8 pnet forward, dynamic and static with ``pool_s8``: equal to
  eager ``quant_pnet_apply`` (exact sums, the same float32 operations);
- calibrated scales: rtol 1e-6, the same key sets; under s2d with block
  0's output taken from the JAX program (see detect below);
- the kernels' int8 outputs against the Pallas kernels: at most 1 step
  apart in under 1% of the values (a float32 sum taken in another order
  may move a value across a rounding boundary; the JAX tests allow the
  same); float outputs of the int8 conv1 mode: float32 atol 1e-4 of the
  largest output, bf16 2 bf16 ulps of it, beyond which under 1% of the
  values may move by at most 9 y0 steps (9 taps of one flipped y0 value:
  9 * s_y * max|w1|);
- detect: ``valid``, ``classes`` and ``proposals_valid`` equal, boxes
  atol 1e-3, confidence and fg_score atol 1e-5, with the JAX package's
  calibrated scales carried across and block 0's output taken from the
  JAX program: a single int8 step that the float32 sum order of conv0
  moves in block 0's output (1 of 81,920 values in the 2-conv case here)
  is requantized at every later conv and reaches ~1% of the anchor
  scores, so block 0 is held against the JAX producer on its own
  (``test_compute_s2d_block0_matches_jax``, at the int8 tolerance above)
  and the chain after it end to end.
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
import frcnn_tpu_torch.detect.detector as tdet
from frcnn_tpu.detect.detector import Detector as JDetector
from frcnn_tpu.detect.detector import compute_s2d_block0 as j_block0
from frcnn_tpu.models import quant as JQ
from frcnn_tpu.models.factory import create_models as j_create
from frcnn_tpu.models.factory import init_params
from frcnn_tpu.models.layers import ceil_max_pool_2x2 as j_pool
from frcnn_tpu.ops.pallas_block0 import block0_weights, pack_s2d_np
from frcnn_tpu.ops.pallas_block0 import fused_block0 as j_fused_block0
from frcnn_tpu.ops.pallas_block0 import views_from_s2d
from frcnn_tpu.ops.pallas_block0_2conv import (
    block0_2conv_weights,
    block0_2conv_weights_q_jnp,
)
from frcnn_tpu.ops.pallas_block0_2conv import (
    fused_block0_2conv as j_fused_2conv,
)
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.models import quant as TQ
from frcnn_tpu_torch.models.factory import create_models
from frcnn_tpu_torch.ops import block0_2conv_kernel as K2
from frcnn_tpu_torch.ops import block0_kernel as K1
from frcnn_tpu_torch.ops import int8_conv
from frcnn_tpu_torch.utils.weights import act_scales_from_jax, from_jax_params
from tests.test_torch_detect import _mild_fg_params
from tests.test_torch_vgg_large import LAND, PORT, narrow_vgg_large
from tests.tiny import tiny_config

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def narrow_vgg_small():
    """vgg_small's structure (conv_steps 1/2/2/2) at tiny widths."""
    base = tiny_config()
    layers = tuple(dataclasses.replace(spec, conv_steps=n)
                   for spec, n in zip(base.model.layers, (1, 2, 2, 2)))
    return base.replace(model=dataclasses.replace(
        base.model, name="vgg_small_narrow", layers=layers))


def _port_models(jc, params, stats):
    cfg = tcfg.Config.from_json(jc.to_json())
    pnet, cnet = create_models(cfg)
    state = from_jax_params(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, stats), cfg)
    pnet.load_state_dict(state["pnet"])
    cnet.load_state_dict(state["cnet"])
    return cfg, pnet, cnet


def _inv(s):
    return torch.ones(1) / torch.tensor([s], dtype=F32)


def _steps(got, ref):
    """(largest int8 step apart, share of values apart)."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    return int(d.max()), float((d > 0).mean())


# -- weights and the int8 convolution -----------------------------------------

@pytest.mark.parametrize("which", ["tiny", "vgg_small"])
def test_quantize_pnet_matches_jax_bitwise(which):
    jc = tiny_config() if which == "tiny" else jcfg.duplo_config()
    params, stats = init_params(jc, jax.random.PRNGKey(3))
    _, pnet, _ = _port_models(jc, params, stats)
    jq = JQ.quantize_pnet_params(params, jc.model)
    tq = TQ.quantize_pnet(pnet)
    assert sorted(jq) == sorted(tq)
    for name, j in jq.items():
        t = tq[name]
        if "slope" in j:
            np.testing.assert_array_equal(t["slope"].numpy(),
                                          np.asarray(j["slope"]))
            continue
        assert t["w_int8"].dtype == torch.int8
        np.testing.assert_array_equal(t["w_int8"].permute(2, 3, 1, 0).numpy(),
                                      np.asarray(j["w_int8"]), name)
        np.testing.assert_array_equal(t["scale"].numpy().view(np.int32),
                                      np.asarray(j["scale"]).view(np.int32))
        np.testing.assert_array_equal(t["bias"].numpy(), np.asarray(j["bias"]))


CONV_CASES = {  # name: (C, N, k, padding)
    "same3x3": (16, 24, 3, "SAME"),
    "valid3": (24, 32, 3, "VALID"),
    "valid5": (32, 32, 5, "VALID"),
    "valid7": (32, 32, 7, "VALID"),
    "out1x1_18": (32, 18, 1, "VALID"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_qconv_matches_jax(case):
    C, N, k, padding = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(0, 1, (2, 11, 13, C)).astype(np.float32)
    w = rng.normal(0, 0.1, (k, k, C, N)).astype(np.float32)
    b = rng.normal(0, 0.1, (N,)).astype(np.float32)
    jl = {"bias": jnp.asarray(b)}
    jl["w_int8"], jl["scale"] = JQ._quantize_weight(jnp.asarray(w))
    tl = TQ.QConv(*TQ.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1)),
                  torch.from_numpy(b))
    pad = ((k // 2, k // 2), (k // 2, k // 2)) if padding == "SAME" else (
        (0, 0), (0, 0))
    s_x = np.float32(np.abs(x).max() / 127)
    xq = JQ._quantize_act(jnp.asarray(x), s_x)
    tq = TQ.quantize_act(torch.from_numpy(x), torch.tensor(s_x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(xq))
    # the int32 sums
    jz = jax.lax.conv_general_dilated(
        xq, jl["w_int8"], (1, 1), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    tz = int8_conv.conv2d_int8(tq, tl.wmat, k, k, pad, N)
    assert tz.dtype == torch.int32
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    # dequantized: eager equal, jitted (one FMA) within 1 ulp
    got = TQ.qconv(torch.from_numpy(x), tl, pad, F32,
                   s_x=torch.tensor(s_x)).numpy()
    eager = np.asarray(JQ._qconv(jnp.asarray(x), jl, padding, jnp.float32,
                                 s_x=s_x))
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jax.jit(lambda a, s: JQ._qconv(
        a, jl, padding, jnp.float32, s_x=s))(jnp.asarray(x), s_x))
    prod = np.abs(tz.numpy().astype(np.float32) * (s_x * tl.scale.numpy()))
    assert (np.abs(got - jitted)
            <= np.spacing(prod) + np.spacing(np.abs(jitted))).all()
    # the pair form and the dynamic scale
    pair = TQ.qconv((tq, torch.tensor(s_x)), tl, pad, F32).numpy()
    np.testing.assert_array_equal(pair, got)
    dyn = TQ.qconv(torch.from_numpy(x), tl, pad, F32).numpy()
    np.testing.assert_array_equal(dyn, np.asarray(JQ._qconv(
        jnp.asarray(x), jl, padding, jnp.float32)))


def test_int8_conv_pads_to_the_product_shapes():
    """K = 27 (the NHWC first conv) and N = 18 (the anchor outputs) are
    padded to 32 and 24, fewer than 17 rows to 17; the sums stay exact."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 3, 4, 3), np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (18, 3, 3, 3), np.int8))
    wm = int8_conv.weight_matrix(w)
    assert wm.shape == (24, 32)
    assert not wm[18:].any() and not wm[:, 27:].any()
    cols = int8_conv.im2col(x, 3, 3, ((1, 1), (1, 1)))
    assert cols.shape == (17, 32) and not cols[12:].any()
    got = int8_conv.conv2d_int8(x, wm, 3, 3, ((1, 1), (1, 1)), 18)
    ref = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(), padding=1)
    assert torch.equal(got.double(), ref.permute(0, 2, 3, 1))


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_ceil_max_pool_matches_jax(dtype):
    """Odd edges padded with the max identity (int8 minimum, -inf)."""
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, (2, 7, 9, 5)).astype(dtype)
    got = TQ.ceil_max_pool_2x2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_pool(
        jnp.asarray(x))))


# -- the forward and calibration ----------------------------------------------

@pytest.fixture(scope="module")
def small():
    jc = narrow_vgg_small()
    params, stats = init_params(jc, jax.random.PRNGKey(0))
    cfg, pnet, cnet = _port_models(jc, params, stats)
    jq = JQ.quantize_pnet_params(params, jc.model)
    tq = TQ.quantize_pnet(pnet)
    qp = TQ.QuantizedPNet(cfg.model, tq, act_dtype=F32)
    rng = np.random.default_rng(2)
    H, W = jc.shapes.image_hw
    x = rng.normal(0, 1, (2, H, W, 3)).astype(np.float32)
    return jc, tq, jq, qp, x


def test_quant_forward_matches_jax(small):
    jc, tq, jq, qp, x = small
    outs = {}
    # dynamic scales
    outs["dynamic"] = (JQ.quant_pnet_apply(jq, jc.model, jnp.asarray(x),
                                           act_dtype=jnp.float32),
                       qp(torch.from_numpy(x)))
    # static scales from another batch, pool_s8
    xc = np.random.default_rng(3).normal(0, 1, x.shape).astype(np.float32)
    scales = JQ.calibrate_pnet_scales(jq, jc.model, jnp.asarray(xc),
                                      act_dtype=jnp.float32)
    static = TQ.QuantizedPNet(qp.model_cfg, tq, act_dtype=F32, pool_s8=True,
                              act_scales=act_scales_from_jax(scales))
    outs["static_pool_s8"] = (
        JQ.quant_pnet_apply(jq, jc.model, jnp.asarray(x), jnp.float32,
                            act_scales=scales, pool_s8=True),
        static(torch.from_numpy(x)))
    for name, ((jm, jf), (tm, tf)) in outs.items():
        for a, b in zip(list(tm) + [tf], list(jm) + [jf]):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_calibrate_pnet_scales_matches_jax(small):
    jc, _, jq, qp, x = small
    ref = JQ.calibrate_pnet_scales(jq, jc.model, jnp.asarray(x),
                                   act_dtype=jnp.float32)
    got = TQ.calibrate_pnet_scales(qp, torch.from_numpy(x))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)


CALIB = {  # name: (config, input_layout)
    "nhwc": (narrow_vgg_small, "nhwc"),
    "s2d_1conv": (narrow_vgg_small, "s2d"),
    "s2d_2conv": (narrow_vgg_large, "s2d"),
}


@pytest.mark.parametrize("case", sorted(CALIB))
def test_calibrate_quantized_pnet_matches_jax(case, monkeypatch):
    """The Detector's calibration through the config's serving producer,
    against the JAX Detector's."""
    make, layout = CALIB[case]
    jc = jcfg.serving_config(make()).replace(pallas_mode="interpret",
                                             input_layout=layout)
    params, stats = init_params(jc, jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    calib = rng.normal(0, 0.5, (2, *jc.shapes.image_hw, 3)).astype(np.float32)
    jd = JDetector(jc, params, stats, quantized=True, quant_calibration=calib)
    cfg, pnet, cnet = _port_models(jc, params, stats)
    if layout == "s2d":
        # block 0's float output of the JAX calibration (its jitted call)
        jp, _ = j_create(jc)
        lum4, chroma = pack_s2d_np(calib)
        b0 = jax.jit(lambda a, c: j_block0(
            jc, jp, params["pnet"], a, c, allow_quant_out=False))(
            jnp.asarray(lum4), jnp.asarray(chroma))
        _inject_block0(monkeypatch, torch.from_numpy(np.array(b0)))
    det = Detector(cfg, pnet, cnet, device="cpu", quantized=True,
                   quant_calibration=calib)
    ref, got = jd.pnet.act_scales, det.pnet.act_scales
    assert sorted(got) == sorted(ref)
    if layout == "s2d":
        assert "block1_conv0" in got and "block0_conv0" not in got
        assert ("block0_conv1" in got) == (case == "s2d_2conv")
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)


# -- the kernels' int8 modes: plain versions against the Pallas kernels -------

def _ring_planes(seed, B, H, W):
    """Planes of a padded image whose pad ring is random, not zero."""
    rng = np.random.default_rng(seed)
    P = torch.from_numpy(rng.normal(0, 1, (B, H + 2, W + 2, 3))
                         .astype(np.float32))
    l, c = K1.pack_padded(P)
    return l.numpy(), c.numpy()


def _jax_block0(lum4, chroma, w, b, slope, cdt, out_scale=None):
    cv, lv = views_from_s2d(jnp.asarray(lum4), jnp.asarray(chroma),
                            out_dtype=cdt)
    wt, bias = block0_weights(w, b)
    out = j_fused_block0(cv, lv, wt, bias, slope, interpret=True,
                         compute_dtype=cdt, out_scale=out_scale)
    out = out.astype(jnp.float32) if out_scale is None else out
    return np.asarray(out).transpose(0, 1, 3, 2)


def _port_block0(lum4, chroma, w, b, slope, dt, inv_out=None):
    w27, bias = K1.block0_weights(torch.from_numpy(w).permute(3, 2, 0, 1),
                                  torch.from_numpy(b), dt)
    return K1.fused_block0(torch.from_numpy(lum4).to(dt),
                           torch.from_numpy(chroma).to(dt), w27, bias,
                           torch.tensor([slope], dtype=F32), inv_out=inv_out)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_plain_block0_s8out_matches_pallas(dt):
    cdt = jnp.float32 if dt == F32 else jnp.bfloat16
    lum4, chroma = _ring_planes(5, 2, 26, 40)
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.2, (3, 3, 3, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, (64,)).astype(np.float32)
    fl = _jax_block0(lum4, chroma, w, b, 0.25, cdt)
    s = np.float32(np.abs(fl).max() / 127)
    ref = _jax_block0(lum4, chroma, w, b, 0.25, cdt, out_scale=s)
    got = _port_block0(lum4, chroma, w, b, 0.25, dt, inv_out=_inv(s))
    assert got.dtype == torch.int8 and got.shape == ref.shape
    step, share = _steps(got.numpy(), ref)
    assert step <= 1 and share < 0.01


def _two_conv_weights(seed, f=64):
    rng = np.random.default_rng(seed)
    w0 = rng.normal(0, 0.2, (3, 3, 3, f)).astype(np.float32)
    b0 = rng.normal(0, 0.1, (f,)).astype(np.float32)
    w1 = rng.normal(0, 0.08, (3, 3, f, f)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (f,)).astype(np.float32)
    return w0, b0, w1, b1


def _jax_2conv(lum4, chroma, w0, b0, w1, b1, s0, s1, cdt, w1q=None, s_w=None,
               s_y=None, out_scale=None):
    """The Pallas 2-conv kernel in interpret mode -> NHWC numpy (float32,
    or int8 under ``out_scale``); int8 conv1 with ``w1q`` (HWIO int8)."""
    cv, lv = views_from_s2d(jnp.asarray(lum4), jnp.asarray(chroma),
                            out_dtype=cdt)
    wt0, bias0 = block0_weights(w0, b0)
    kw = {}
    if w1q is not None:
        w1t = block0_2conv_weights_q_jnp(jnp.asarray(w1q))
        kw = dict(w1_scales=s_w, act_scale=s_y)
    else:
        w1t = block0_2conv_weights(w1)
    out = j_fused_2conv(cv, lv, wt0, bias0, s0, w1t, b1, s1, interpret=True,
                        compute_dtype=cdt, out_scale=out_scale, **kw)
    out = out.astype(jnp.float32) if out_scale is None else out
    return np.asarray(out).transpose(0, 1, 3, 2)


def _port_2conv(lum4, chroma, w0, b0, w1, b1, s0, s1, dt, w1q=None,
                s_w=None, s_y=None, inv_out=None):
    p = K2.block0_2conv_weights(
        torch.from_numpy(w0).permute(3, 2, 0, 1), torch.from_numpy(b0),
        torch.from_numpy(w1).permute(3, 2, 0, 1), torch.from_numpy(b1),
        s0, s1, dt)
    planes = (torch.from_numpy(lum4).to(dt), torch.from_numpy(chroma).to(dt))
    if w1q is None:
        return K2.fused_block0_2conv(*planes, *p, inv_out=inv_out)
    wq9, ws = K2.block0_2conv_weights_q(
        torch.from_numpy(w1q).permute(3, 2, 0, 1), torch.from_numpy(s_w),
        torch.tensor(s_y))
    return K2.fused_block0_2conv(*planes, p.w0, p.b0, wq9, p.b1, p.slopes,
                                 w1_scale=ws, inv_y=_inv(s_y),
                                 inv_out=inv_out)


def _bf16_ulp(m):
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _int8_conv1_case(seed, dt, H=12, W=16):
    """Planes with a random pad ring, weights, quantized w1 and a y0 scale
    from the float32 conv0 + PReLU."""
    lum4, chroma = _ring_planes(seed, 2, H, W)
    w0, b0, w1, b1 = _two_conv_weights(seed)
    wq, s_w = TQ.quantize_weight(torch.from_numpy(w1).permute(3, 2, 0, 1))
    p = torch.from_numpy(lum4), torch.from_numpy(chroma)
    y = F.conv2d(K1.unpack_s2d(*p), torch.from_numpy(w0).permute(3, 2, 0, 1),
                 torch.from_numpy(b0))
    y = torch.where(y >= 0, y, 0.25 * y)
    s_y = np.float32(float(y.abs().max()) / 127)
    w1q = wq.permute(2, 3, 1, 0).numpy()
    return lum4, chroma, w0, b0, w1, b1, w1q, s_w.numpy(), s_y


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("out", ["float", "int8"])
def test_plain_2conv_int8_conv1_matches_pallas(dt, out):
    cdt = jnp.float32 if dt == F32 else jnp.bfloat16
    lum4, chroma, w0, b0, w1, b1, w1q, s_w, s_y = _int8_conv1_case(6, dt)
    q = dict(w1q=w1q, s_w=s_w, s_y=s_y)
    fl = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, cdt, **q)
    if out == "float":
        got = _port_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, dt, **q)
        assert got.dtype == dt
        err = np.abs(got.float().numpy() - fl)
        peak = np.abs(fl).max()
        tol = 1e-4 * peak if dt == F32 else 2 * _bf16_ulp(peak)
        assert (err > tol).mean() < 0.01
        assert err.max() <= tol + 9 * s_y * np.abs(w1).max()
        return
    s_o = np.float32(np.abs(fl).max() / 127)
    ref = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, cdt,
                     out_scale=s_o, **q)
    got = _port_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, dt,
                      inv_out=_inv(s_o), **q)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    step, share = _steps(got.numpy(), ref)
    assert step <= 1 and share < 0.01


@pytest.mark.parametrize("dt", [F32, BF16])
def test_plain_2conv_float_conv1_s8out_matches_pallas(dt):
    """The float conv1 with an int8 output (``out_scale`` alone)."""
    cdt = jnp.float32 if dt == F32 else jnp.bfloat16
    lum4, chroma = _ring_planes(7, 2, 12, 16)
    w0, b0, w1, b1 = _two_conv_weights(7)
    fl = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, cdt)
    s_o = np.float32(np.abs(fl).max() / 127)
    ref = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, cdt,
                     out_scale=s_o)
    got = _port_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, dt,
                      inv_out=_inv(s_o))
    assert got.dtype == torch.int8
    step, share = _steps(got.numpy(), ref)
    assert step <= 1 and share < 0.01


# -- the numerics traps: a wrong variant fails against the Pallas kernels -----

def _recip_vs_div_values(s, n):
    """``n`` positive float32 values v under 127 s for which
    round(v * float32(1 / s)) and round(v / s) differ: the float32
    neighbours of the rounding boundaries (k + 1/2) s."""
    s = np.float32(s)
    inv = np.float32(1) / s
    near = [((np.arange(1, 126) + 0.5) * s).astype(np.float32)]
    for toward in (np.inf, -np.inf):
        v = near[0]
        for _ in range(8):
            v = np.nextafter(v, np.float32(toward))
            near.append(v)
    v = np.unique(np.concatenate(near))
    hit = v[np.round(v * inv) != np.round(v / s)]
    assert hit.size >= n, hit.size
    return hit[:n]


S_TRAP = 0.0123457


def test_trap_reciprocal_not_division():
    """The kernels quantize as round(v * (1/s)), ``quantize_act`` as
    round(v / s). Values v where the two round apart are planted in the
    kernels (zero conv weights, v as the bias) and in ``quantize_act``:
    each port site matches its JAX counterpart, the other form does not."""
    s = np.float32(S_TRAP)
    v = _recip_vs_div_values(s, 16)
    inv = np.float32(1) / s
    recip = np.clip(np.round(v * inv), -127, 127)
    div = np.clip(np.round(v / s), -127, 127)
    assert (recip != div).all()
    # quantize_act: the division form, as JAX's _quantize_act
    got = TQ.quantize_act(torch.from_numpy(v), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JQ._quantize_act(
        jnp.asarray(v), s)))
    np.testing.assert_array_equal(got, div)
    # block0 with out_scale: the reciprocal form
    lum4, chroma = _ring_planes(8, 1, 4, 6)
    w = np.zeros((3, 3, 3, 16), np.float32)
    ref = _jax_block0(lum4, chroma, w, v, 0.25, jnp.float32, out_scale=s)
    np.testing.assert_array_equal(ref[0, 0, 0], recip)
    got = _port_block0(lum4, chroma, w, v, 0.25, F32, inv_out=_inv(s))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the 2-conv kernel: its output (v as conv1's bias) and y0 (v as conv0's
    # bias, read back through an identity conv1 at s_w = 1)
    zeros0, zb = np.zeros((3, 3, 3, 16), np.float32), np.zeros(16, np.float32)
    eye = np.zeros((3, 3, 16, 16), np.int8)
    eye[1, 1] = np.eye(16, dtype=np.int8)
    w1 = np.zeros((3, 3, 16, 16), np.float32)
    q = dict(w1q=eye, s_w=np.ones(16, np.float32), s_y=s)
    ref = _jax_2conv(lum4, chroma, zeros0, zb, w1, v, 0.25, 0.1, jnp.float32,
                     out_scale=s, **q)
    np.testing.assert_array_equal(ref[0, 0, 0], recip)
    got = _port_2conv(lum4, chroma, zeros0, zb, w1, v, 0.25, 0.1, F32,
                      inv_out=_inv(s), **q)
    np.testing.assert_array_equal(got.numpy(), ref)
    ref = _jax_2conv(lum4, chroma, zeros0, v, w1, zb, 0.25, 0.1, jnp.float32,
                     **q)
    np.testing.assert_array_equal(ref[0, 0, 0], (recip * s).astype(np.float32))
    got = _port_2conv(lum4, chroma, zeros0, v, w1, zb, 0.25, 0.1, F32, **q)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[0, 0, 0] != (div * s).astype(np.float32)).all()


HALVES = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, -3.5] * 2,
                  np.float32)


def test_trap_round_half_to_even():
    """v * inv exactly k + 1/2 (s = 1, PReLU slope 1): the kernels round
    half to even, as jnp.round; half away from zero (``roundf``) differs."""
    even = np.round(HALVES)
    away = np.sign(HALVES) * np.floor(np.abs(HALVES) + 0.5)
    assert (even != away).sum() == 8
    lum4, chroma = _ring_planes(9, 1, 4, 6)
    w = np.zeros((3, 3, 3, 16), np.float32)
    ref = _jax_block0(lum4, chroma, w, HALVES, 1.0, jnp.float32,
                      out_scale=1.0)
    np.testing.assert_array_equal(ref[0, 0, 0], even)
    got = _port_block0(lum4, chroma, w, HALVES, 1.0, F32, inv_out=_inv(1.0))
    np.testing.assert_array_equal(got.numpy(), ref)
    # y0 of the int8 conv1 (HALVES as conv0's bias), read back exactly
    zeros0, zb = np.zeros((3, 3, 3, 16), np.float32), np.zeros(16, np.float32)
    eye = np.zeros((3, 3, 16, 16), np.int8)
    eye[1, 1] = np.eye(16, dtype=np.int8)
    q = dict(w1q=eye, s_w=np.ones(16, np.float32), s_y=np.float32(1))
    w1 = np.zeros((3, 3, 16, 16), np.float32)
    ref = _jax_2conv(lum4, chroma, zeros0, HALVES, w1, zb, 1.0, 1.0,
                     jnp.float32, **q)
    np.testing.assert_array_equal(ref[0, 0, 0], even)
    got = _port_2conv(lum4, chroma, zeros0, HALVES, w1, zb, 1.0, 1.0, F32,
                      **q)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_trap_y0_quantized_from_float32():
    """bf16 planes, int8 conv1: y0 is quantized from its float32 value.
    Values whose bf16 rounding lands on the other side of a rounding
    boundary (2.5000002 -> 2.5, 3.4999998 -> 3.5) tell it apart from a
    variant that rounds y0 to bf16 first, as the float mode holds it."""
    v = np.array([2.5000002, 3.4999998, -2.5000002, 1.4999999] * 4,
                 np.float32)
    in_f32 = np.round(v)
    via_bf16 = np.round(torch.from_numpy(v).to(BF16).float().numpy())
    assert (in_f32 != via_bf16).all()
    lum4, chroma = _ring_planes(10, 1, 4, 6)
    zeros0, zb = np.zeros((3, 3, 3, 16), np.float32), np.zeros(16, np.float32)
    eye = np.zeros((3, 3, 16, 16), np.int8)
    eye[1, 1] = np.eye(16, dtype=np.int8)
    w1 = np.zeros((3, 3, 16, 16), np.float32)
    q = dict(w1q=eye, s_w=np.ones(16, np.float32), s_y=np.float32(1))
    ref = _jax_2conv(lum4, chroma, zeros0, v, w1, zb, 1.0, 1.0, jnp.bfloat16,
                     **q)
    np.testing.assert_array_equal(ref[0, 0, 0], in_f32)
    got = _port_2conv(lum4, chroma, zeros0, v, w1, zb, 1.0, 1.0, BF16, **q)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_trap_halo_is_int8_zero():
    """Random pad ring, int8 conv1: y0 outside the image is int8 0. A
    variant that quantizes prelu0(b0 + ...) over the halo from the planes
    is far from the Pallas kernel; the plain version is not."""
    lum4, chroma, w0, b0, w1, b1, w1q, s_w, s_y = _int8_conv1_case(11, F32)
    q = dict(w1q=w1q, s_w=s_w, s_y=s_y)
    ref = _jax_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, jnp.float32,
                     **q)
    got = _port_2conv(lum4, chroma, w0, b0, w1, b1, 0.25, 0.1, F32, **q)
    tol = 1e-4 * np.abs(ref).max() + 9 * s_y * np.abs(w1).max()
    assert np.abs(got.numpy() - ref).max() <= tol
    # unmasked halo: conv0 over fine rows/columns -1 .. H/W, quantized,
    # conv1 without zero padding
    planes = torch.from_numpy(lum4), torch.from_numpy(chroma)
    y = F.conv2d(F.pad(K1.unpack_s2d(*planes), (1, 1, 1, 1)),
                 torch.from_numpy(w0).permute(3, 2, 0, 1),
                 torch.from_numpy(b0))
    y = torch.where(y >= 0, y, 0.25 * y)
    yq = torch.clamp(torch.round(y * _inv(s_y)), -127, 127)
    k1 = torch.from_numpy(w1q.astype(np.float32)).permute(3, 2, 0, 1)
    z = F.conv2d(yq.double(), k1.double()).float()
    z = z * torch.from_numpy(s_w * s_y)[None, :, None, None] \
        + torch.from_numpy(b1)[None, :, None, None]
    z = F.max_pool2d(torch.where(z >= 0, z, 0.1 * z), 2, 2)
    unmasked = z.permute(0, 2, 3, 1).numpy()
    assert np.abs(unmasked - ref).max() > 100 * 1e-4 * np.abs(ref).max()


def test_dequant_is_one_fused_multiply_add():
    """The Pallas kernel's ``z * wscale + b1`` rounds once on the CPU (XLA
    contracts it); values where one rounding and two round apart are
    planted (int8 y0 q, s_w, b1 through an identity conv1): the plain
    version matches the kernel, a product-then-sum variant does not."""
    rng = np.random.default_rng(12)
    q = rng.integers(1, 127, 4096).astype(np.float32)
    sw = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
    b = rng.uniform(-60, 60, 4096).astype(np.float32)
    fma = (q.astype(np.float64) * sw + b).astype(np.float32)
    two = (q * sw) + b
    pick = np.nonzero((fma != two) & (fma > 0))[0][:16]
    assert pick.size == 16
    q, sw, b = q[pick], sw[pick], b[pick]
    lum4, chroma = _ring_planes(13, 1, 4, 6)
    zeros0, zb = np.zeros((3, 3, 3, 16), np.float32), np.zeros(16, np.float32)
    eye = np.zeros((3, 3, 16, 16), np.int8)
    eye[1, 1] = np.eye(16, dtype=np.int8)
    w1 = np.zeros((3, 3, 16, 16), np.float32)
    kw = dict(w1q=eye, s_w=sw, s_y=np.float32(1))
    ref = _jax_2conv(lum4, chroma, zeros0, q, w1, b, 1.0, 1.0, jnp.float32,
                     **kw)
    np.testing.assert_array_equal(ref[0, 0, 0], fma[pick])
    got = _port_2conv(lum4, chroma, zeros0, q, w1, b, 1.0, 1.0, F32, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[0, 0, 0] != two[pick]).all()


# -- the detector -------------------------------------------------------------

def _calibrated(make, key, hw=None):
    """JAX serving config of ``make()``, weights, a JAX Detector with
    calibrated scales and the port's models."""
    jc = jcfg.serving_config(make()).replace(pallas_mode="interpret")
    params, stats = init_params(jc, jax.random.PRNGKey(key))
    params = _mild_fg_params(params)
    rng = np.random.default_rng(key)
    calib = rng.normal(0, 0.5, (2, *jc.shapes.image_hw, 3)).astype(np.float32)
    jd = JDetector(jc, params, stats, quantized=True, quant_calibration=calib)
    return jc, params, stats, jd


@pytest.mark.parametrize("case", ["1conv", "2conv"])
def test_compute_s2d_block0_matches_jax(case):
    """The producer of block 0 in the int8 chain: the port's int8 output
    and its scale against the JAX program's (the kernels' int8 tolerance),
    int8 conv1 in the 2-conv case."""
    make = narrow_vgg_small if case == "1conv" else narrow_vgg_large
    jc, params, stats, jd = _calibrated(make, 5)
    cfg, pnet, cnet = _port_models(jc, params, stats)
    det = Detector(cfg, pnet, cnet, device="cpu", quantized=True)
    det.pnet.set_act_scales(act_scales_from_jax(jd.pnet.act_scales))
    rng = np.random.default_rng(6)
    imgs = rng.normal(0.3, 0.3, (2, *jc.shapes.image_hw, 3)).astype(
        np.float32)
    lum4, chroma = pack_s2d_np(imgs)
    ref = j_block0(jc, jd.pnet, params["pnet"], jnp.asarray(lum4),
                   jnp.asarray(chroma))
    got = tdet.compute_s2d_block0(cfg, det.pnet, det.block0_params,
                                  torch.from_numpy(lum4),
                                  torch.from_numpy(chroma))
    assert isinstance(got, tuple) and got[0].dtype == torch.int8
    assert float(got[1]) == float(ref[1])
    step, share = _steps(got[0].numpy(), np.asarray(ref[0]))
    assert step <= 1 and share < 0.01


def _check_detect(got, ref):
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


def _inject_block0(monkeypatch, b0):
    """The port's detector takes ``b0`` as block 0's output, once."""
    calls = []

    def injected(cfg, qpnet, block0_params, lum4, chroma,
                 allow_quant_out=True):
        assert not calls, "block 0 ran twice"
        calls.append(lum4.shape)
        return b0
    monkeypatch.setattr(tdet, "compute_s2d_block0", injected)
    return calls


def _detect_with_block0_of(monkeypatch, det, jc, jd, params, planes, hw):
    """``det.detect`` with block 0's output taken from the JAX program on
    the same planes (normalized as the detector normalizes them)."""
    from frcnn_tpu.ops.normalization import normalize_s2d

    n = jc.normalization

    @jax.jit
    def block0(lum4, chroma, true_hw):
        lum4, chroma = jax.vmap(lambda a, c, t: normalize_s2d(
            a, c, t[0], t[1], method=n.method, width=n.width,
            centering=n.centering, scaling=n.scaling))(lum4, chroma, true_hw)
        return j_block0(jc, jd.pnet, params["pnet"], lum4, chroma)

    ref = block0(jnp.asarray(planes[0]), jnp.asarray(planes[1]),
                 jnp.asarray(hw))
    if isinstance(ref, tuple):
        b0 = (torch.from_numpy(np.array(ref[0])),
              det.pnet.act_scales["block1_conv0"])
    else:
        b0 = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    calls = _inject_block0(monkeypatch, b0)
    out = det.detect(planes, hw)
    assert len(calls) == 1
    return out


@pytest.fixture(scope="module")
def large_int8():
    return _calibrated(narrow_vgg_large, 0)


@pytest.mark.parametrize("case", ["small", "large_land", "large_port"])
def test_quantized_detect_matches_jax(case, large_int8, monkeypatch):
    """The calibrated static s8-pooled chain, the JAX scales carried."""
    if case == "small":
        jc, params, stats, jd = _calibrated(narrow_vgg_small, 0)
        hw = jc.shapes.image_hw
    else:
        jc, params, stats, jd = large_int8
        hw = LAND if case == "large_land" else PORT
    cfg, pnet, cnet = _port_models(jc, params, stats)
    det = Detector(cfg, pnet, cnet, device="cpu", quantized=True)
    det.pnet.set_act_scales(act_scales_from_jax(jd.pnet.act_scales))
    assert det.pnet.pool_s8 and cfg.quant_pool_s8
    rng = np.random.default_rng(7)
    imgs = rng.normal(0.3, 0.2, (2, *hw, 3)).astype(np.float32)
    imgs[:, 30:70, 40:90] += 0.8
    true_hw = np.array([list(hw), [hw[0] - 28, hw[1] - 30]], np.int32)
    planes = pack_s2d_np(imgs)
    ref = jd.detect(tuple(map(jnp.asarray, planes)), jnp.asarray(true_hw))
    got = _detect_with_block0_of(monkeypatch, det, jc, jd, params, planes,
                                 true_hw)
    _check_detect(got, ref)


def test_uncalibrated_quantized_detect_matches_jax(monkeypatch):
    """The dynamic-scale chain that ``main.py --serving fast`` builds:
    block 0 in float, every later conv at the abs-max of its input."""
    jc = jcfg.serving_config(narrow_vgg_small()).replace(
        pallas_mode="interpret")
    params, stats = init_params(jc, jax.random.PRNGKey(2))
    params = _mild_fg_params(params)
    jd = JDetector(jc, params, stats, quantized=True)
    cfg, pnet, cnet = _port_models(jc, params, stats)
    det = Detector(cfg, pnet, cnet, device="cpu", quantized=True)
    assert det.pnet.act_scales is None
    rng = np.random.default_rng(8)
    H, W = jc.shapes.image_hw
    imgs = rng.normal(0.3, 0.2, (2, H, W, 3)).astype(np.float32)
    imgs[:, 30:70, 40:90] += 0.8
    true_hw = np.array([[H, W], [100, 130]], np.int32)
    planes = pack_s2d_np(imgs)
    ref = jd.detect(tuple(map(jnp.asarray, planes)), jnp.asarray(true_hw))
    got = _detect_with_block0_of(monkeypatch, det, jc, jd, params, planes,
                                 true_hw)
    _check_detect(got, ref)


# -- the wrappers -------------------------------------------------------------

def test_wrappers_pick_the_mode_by_the_jax_rule_on_cpu():
    """int8 conv1 only with both ``w1_scale`` and ``inv_y``; an int8
    output whenever ``inv_out`` is given; every mode on CPU tensors is
    the plain version and counts no launch."""
    lum4, chroma, w0, b0, w1, b1, w1q, s_w, s_y = _int8_conv1_case(14, F32,
                                                                   8, 10)
    p = K2.block0_2conv_weights(
        torch.from_numpy(w0).permute(3, 2, 0, 1), torch.from_numpy(b0),
        torch.from_numpy(w1).permute(3, 2, 0, 1), torch.from_numpy(b1),
        0.25, 0.1, F32)
    wq9, ws = K2.block0_2conv_weights_q(
        torch.from_numpy(w1q).permute(3, 2, 0, 1), torch.from_numpy(s_w),
        torch.tensor(s_y))
    planes = torch.from_numpy(lum4), torch.from_numpy(chroma)
    inv_y, inv_o = _inv(s_y), _inv(0.05)
    before = (K1.KERNEL.launches, K1.S8_KERNEL.launches,
              K2.KERNEL.launches, K2.INT8_KERNEL.launches)
    flt = K2.fused_block0_2conv(*planes, *p)
    # one of the two int8 arguments alone: float conv1
    for kw in ({"w1_scale": ws}, {"inv_y": inv_y}):
        assert torch.equal(K2.fused_block0_2conv(*planes, *p, **kw), flt)
    q = K2.fused_block0_2conv(*planes, p.w0, p.b0, wq9, p.b1, p.slopes,
                              w1_scale=ws, inv_y=inv_y)
    assert q.dtype == F32 and not torch.equal(q, flt)
    assert torch.equal(q, K2.block0_2conv_plain(
        *planes, p.w0, p.b0, wq9, p.b1, p.slopes, ws, inv_y))
    for kw, w in (({}, p.w1), ({"w1_scale": ws, "inv_y": inv_y}, wq9)):
        o = K2.fused_block0_2conv(*planes, p.w0, p.b0, w, p.b1, p.slopes,
                                  inv_out=inv_o, **kw)
        assert o.dtype == torch.int8
        assert torch.equal(o, K2.block0_2conv_plain(
            *planes, p.w0, p.b0, w, p.b1, p.slopes, inv_out=inv_o, **kw))
    w27, bias = K1.block0_weights(p.w0.reshape(3, 3, 3, 64).permute(
        3, 2, 0, 1), p.b0, F32)
    slope = torch.tensor([0.25])
    o = K1.fused_block0(*planes, w27, bias, slope, inv_out=inv_o)
    assert o.dtype == torch.int8
    assert torch.equal(o, K1.block0_plain(*planes, w27, bias, slope, inv_o))
    assert torch.equal(K1.fused_block0(*planes, w27, bias, slope),
                       K1.block0_plain(*planes, w27, bias, slope))
    assert before == (K1.KERNEL.launches, K1.S8_KERNEL.launches,
                      K2.KERNEL.launches, K2.INT8_KERNEL.launches)
