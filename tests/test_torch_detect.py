"""The slice end to end: the port's ``Detector`` against the JAX package's
``build_detect_fn`` at the tiny serving config (s2d planes, Pallas kernels
in interpret mode, float32), same weights through ``from_jax_params``,
same packed inputs, B=2 with one image smaller than the bucket.

Tolerances: ``valid``, ``classes`` and ``proposals_valid`` equal; boxes
(refined, proposal and stage-1 survivors) atol 1e-3; confidence and
fg_score atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu.config import serving_config as j_serving
from frcnn_tpu.detect.detector import build_detect_fn
from frcnn_tpu.geometry.anchors import AnchorGenerator as JGen
from frcnn_tpu.models.factory import create_models as j_create
from frcnn_tpu.models.factory import init_params
from frcnn_tpu.ops.pallas_block0 import pack_s2d_np
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.detect.detector import build_detect_fn as build_port_fn
from frcnn_tpu_torch.models.factory import create_models
from frcnn_tpu_torch.utils.weights import from_jax_params
from tests.test_detector import _force_fg_params
from tests.tiny import tiny_config


@pytest.fixture(autouse=True)
def _no_tf32():
    """Float32 comparisons run in full float32 (no TF32) on any device."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _mild_fg_params(params):
    """Keep the anchor heads' random kernels (distinct scores and boxes)
    but bias the fg logits so a few hundred anchors pass the 0.95 gate,
    and bias the classifier away from background."""
    p = jax.tree.map(lambda x: x, params)
    cls = p["cnet"]["cls_head"]
    b = np.asarray(cls["bias"]).copy()
    b[-1] -= 2.0
    cls["bias"] = jnp.asarray(b)
    for ai in range(4):
        out = p["pnet"][f"anchor{ai}_out"]
        b = np.asarray(out["bias"]).copy()
        b[0::6] += 3.5
        out["bias"] = jnp.asarray(b)
        out["kernel"] = out["kernel"] * 0.3
    return p


@pytest.fixture(scope="module")
def setup():
    jc = j_serving(tiny_config()).replace(pallas_mode="interpret")
    assert jc.input_layout == "s2d"
    params, stats = init_params(jc, jax.random.PRNGKey(0))
    gen = JGen(jc)
    jp, jcn = j_create(jc)
    detect = jax.jit(build_detect_fn(jc, gen, jp, jcn))
    H, W = jc.shapes.image_hw
    rng = np.random.default_rng(0)
    imgs = rng.normal(0.3, 0.2, (2, H, W, 3)).astype(np.float32)
    imgs[:, 30:70, 40:100] += 0.8
    hw = np.array([[H, W], [100, 130]], np.int32)
    return jc, params, stats, detect, pack_s2d_np(imgs), hw


@pytest.mark.parametrize("weights", ["forced", "mild"])
def test_detect_matches_jax(setup, weights):
    jc, params, stats, detect, (lum4, chroma), hw = setup
    p = (_force_fg_params(jc, params) if weights == "forced"
         else _mild_fg_params(params))
    ref = detect(p, stats, (jnp.asarray(lum4), jnp.asarray(chroma)),
                 jnp.asarray(hw))

    cfg = Config.from_json(jc.to_json())
    pnet, cnet = create_models(cfg)
    state = from_jax_params(jax.tree.map(np.asarray, p),
                            jax.tree.map(np.asarray, stats), cfg)
    pnet.load_state_dict(state["pnet"])
    cnet.load_state_dict(state["cnet"])
    det = Detector(cfg, pnet, cnet, device="cpu")
    got = det.detect((lum4, chroma), hw)

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


def test_detect_nhwc_layout_matches_s2d(setup):
    """The NHWC entry (normalize_image + the plain block0 convolution)
    gives the detections of the s2d serving entry."""
    jc, params, stats, _, _, hw = setup
    p = _mild_fg_params(params)
    cfg = Config.from_json(jc.to_json())
    pnet, cnet = create_models(cfg)
    state = from_jax_params(jax.tree.map(np.asarray, p),
                            jax.tree.map(np.asarray, stats), cfg)
    pnet.load_state_dict(state["pnet"])
    cnet.load_state_dict(state["cnet"])
    H, W = jc.shapes.image_hw
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, H, W, 3)).astype(np.uint8)
    a = Detector(cfg, pnet, cnet, device="cpu").detect(imgs, hw)
    b = Detector(cfg.replace(input_layout="nhwc"), pnet, cnet,
                 device="cpu").detect(torch.from_numpy(imgs), hw)
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    np.testing.assert_array_equal(a.proposals_valid.numpy(),
                                  b.proposals_valid.numpy())
    np.testing.assert_allclose(a.boxes.numpy(), b.boxes.numpy(), rtol=0,
                               atol=1e-3)


def _port_models(setup):
    jc, params, stats = setup[:3]
    cfg = Config.from_json(jc.to_json())
    pnet, cnet = create_models(cfg)
    state = from_jax_params(jax.tree.map(np.asarray, _mild_fg_params(params)),
                            jax.tree.map(np.asarray, stats), cfg)
    pnet.load_state_dict(state["pnet"])
    cnet.load_state_dict(state["cnet"])
    return cfg, pnet, cnet


def test_detect_s2d_tensor_frames_match_numpy(setup):
    """uint8 frames given as a tensor are unwired and packed on the
    tensor's own device; they give the detections of the same frames as
    numpy, which are packed on the host."""
    cfg, pnet, cnet = _port_models(setup)
    H, W = cfg.shapes.image_hw
    imgs = np.random.default_rng(5).integers(0, 256, (2, H, W, 3),
                                             dtype=np.uint8)
    hw = setup[-1]
    det = Detector(cfg, pnet, cnet, device="cpu")
    a = det.detect(imgs, hw)
    b = det.detect(torch.from_numpy(imgs), hw)
    for f in ("valid", "classes", "proposals_valid"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), f)
    for f in ("boxes", "proposals"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   getattr(b, f).numpy(), rtol=0, atol=1e-3,
                                   err_msg=f)
    np.testing.assert_allclose(a.confidence.numpy(), b.confidence.numpy(),
                               rtol=0, atol=1e-5)


def test_detectors_on_shared_modules_are_independent(setup):
    """A bf16 Detector built on the same modules leaves a float32
    Detector's results, and the float32 modules, as they were."""
    cfg, pnet, cnet = _port_models(setup)
    _, _, _, _, (lum4, chroma), hw = setup
    planes = (torch.from_numpy(lum4), torch.from_numpy(chroma))
    f32 = Detector(cfg, pnet, cnet, device="cpu")
    before = f32.detect(planes, hw)
    bf16 = Detector(cfg.replace(compute_dtype="bfloat16"), pnet, cnet,
                    device="cpu")
    assert bf16.pnet.block1_conv0.weight.dtype == torch.bfloat16
    assert bf16.cnet.fc0.weight.dtype == torch.bfloat16
    assert bf16.cnet.bn0.running_var.dtype == torch.float32
    assert pnet.block1_conv0.weight.dtype == torch.float32
    assert cnet.fc0.weight.dtype == torch.float32
    bf16.detect(planes, hw)
    after = f32.detect(planes, hw)
    for f in before._fields:
        assert torch.equal(getattr(before, f), getattr(after, f)), f


@pytest.mark.parametrize("stage", ["b0", "decode", "nms", "pool", "cnet"])
def test_stop_after_checksums_match_jax(setup, stage):
    """The staged cuts of both programs checksum the same intermediates
    (rtol 1e-5: float32 sums over whole stage outputs)."""
    jc, params, stats, _, (lum4, chroma), hw = setup
    p = _mild_fg_params(params)
    jp, jcn = j_create(jc)
    ref = jax.jit(build_detect_fn(jc, JGen(jc), jp, jcn, stop_after=stage))(
        p, stats, (jnp.asarray(lum4), jnp.asarray(chroma)), jnp.asarray(hw))

    cfg = Config.from_json(jc.to_json())
    pnet, cnet = create_models(cfg)
    state = from_jax_params(jax.tree.map(np.asarray, p),
                            jax.tree.map(np.asarray, stats), cfg)
    pnet.load_state_dict(state["pnet"])
    cnet.load_state_dict(state["cnet"])
    det = Detector(cfg, pnet, cnet, device="cpu")
    fn = build_port_fn(cfg, det.gen, det.pnet, det.cnet, torch.device("cpu"),
                       det.block0_params, stop_after=stage)
    got = fn((torch.from_numpy(lum4), torch.from_numpy(chroma)),
             torch.from_numpy(hw))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
