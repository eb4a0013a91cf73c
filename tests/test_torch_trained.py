"""The port against the JAX package on a trained checkpoint:
``artifacts/ckpt/photo_partial.ckpt`` (vgg_small, 6 classes, step 20000),
each package's config from the checkpoint's ``config_json`` at its 450x800
bucket and the published gates (fg 0.95, confidence 0.2), the weights
carried by ``from_jax_params``, and two batches of B=2 photo scenes of the
checkpoint's own scale (``tests/trained_photo.py``: seed 0, up to 8 bricks
each; the second image of each batch 40 rows and 60 columns smaller than
the bucket). The int8 modes are in ``tests/test_torch_trained_*.py``.

float32, the serving config (s2d planes; the JAX package's Pallas kernels
in interpret mode, the port's plain versions):

- from the JAX package's normalized planes (handed to the port, as the
  int8 tests hand over block 0): ``valid``, ``classes`` and
  ``proposals_valid`` equal, boxes, ``proposal_boxes`` and ``proposals``
  atol 1e-3, ``confidence`` and ``fg_score`` atol 1e-5 (the tolerances of
  ``tests/test_torch_detect.py``);
- end to end (each package normalizes): the same discrete outputs, boxes
  and ``proposal_boxes`` atol 1e-3, ``fg_score`` atol 1e-5; ``proposals``
  atol 1e-2 and ``confidence`` atol 1e-4. The local contrastive
  normalization divides by the local standard deviation, which is small
  on the JPEG-flattened blocks of these scenes, so each package's float32
  planes lie up to a few 1e-3 from a float64 evaluation of the same
  function (on these frames: at most 2.4e-3 in the JAX package and
  3.6e-3 in the port, of values up to 3.3; on average 2.8e-6 and 3.0e-6);
  end to end that moves stage-1 proposals from the large anchors by up to
  4.7e-3 px and confidences by up to 2.9e-5 (measured on other photo
  scenes). ``test_normalization_is_as_close_to_float64_as_jax`` holds the
  port's float32 planes as close to float64 as the JAX package's: a mean
  absolute error at most 1.1 times the JAX package's (measured: 1.04 on
  the luma planes, 0.2 on the chroma planes), every value within 1e-2.

bf16 (``tools/eval_quant_parity.py::mode_table``'s "bf16": the
checkpoint's nhwc config; the JAX side its counterpart in
``tests/photo_reading.py``): detections matched per image by class at IoU
>= 0.5, both ways. Measured on these batches: 18 of 18 (share 1.0); the
test holds the share at 0.9 or more and every miss to a reason
(``trained_photo.compare``: a score within 0.01 (fg) or 0.1 (confidence)
of its gate, or a class flip on a proposal both packages pooled where no
class holds 0.6). A matched pair's confidence differs by up to 0.18 (a
detection at 0.742 in the JAX package and 0.560 in the port; 0.745 in
both in float32): both packages round
the class head's logits to bf16 before the log-softmax, and at logits of
16-32 one bf16 step is 0.125, so a confidence moves by a factor of up to
e^0.25 per step of its logit; hence the 0.1 band at the 0.2 gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frcnn_tpu_torch.detect.detector as tdet
from frcnn_tpu.config import serving_config as j_serving
from frcnn_tpu.detect.detector import Detector as JDetector
from frcnn_tpu.detect.detector import build_detect_fn
from frcnn_tpu.ops.color import unwire_uint8 as j_unwire
from frcnn_tpu.ops.normalization import normalize_s2d as j_normalize_s2d
from frcnn_tpu.ops.pallas_block0 import pack_s2d_np
from frcnn_tpu_torch.config import serving_config
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.ops.normalization import normalize_s2d
from frcnn_tpu_torch.tools.eval_quant_parity import mode_table
from tests import trained_photo as TP
from tests.photo_reading import jax_modes

BF16_BANDS = {"fg": 0.01, "confidence": 0.1}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def photo():
    jck, tck = TP.load()
    jbase, tbase = TP.configs(jck, tck, TP.HW)
    scenes = TP.scenes(TP.HW, 4, seed=0)
    batches = [TP.batch(scenes[0:2]), TP.batch(scenes[2:4])]
    pnet, cnet = TP.port_models(tbase, jck)
    return jck, jbase, tbase, batches, pnet, cnet


@pytest.fixture(scope="module")
def normalized(photo, float32):
    """Per batch: the packed planes, and the JAX package's normalized
    planes of them as numpy."""
    jc = float32[0]
    out = []
    for frames, true_hw in photo[3]:
        planes = _planes(jc, frames)
        out.append((planes, tuple(np.array(x) for x in _jax_normalized(
            jc, planes, true_hw))))
    return out


@pytest.fixture(scope="module")
def float32(photo):
    """The float32 serving configs, the JAX Detector and its program from
    normalized planes, the port's Detector."""
    jck, jbase, tbase, _, pnet, cnet = photo
    jc = j_serving(jbase).replace(pallas_mode="interpret",
                                  compute_dtype="float32")
    tc = serving_config(tbase).replace(compute_dtype="float32")
    assert jc.input_layout == tc.input_layout == "s2d"
    assert (jc.detect_fg_threshold, jc.detect_confidence) == (0.95, 0.2)
    jd = JDetector(jc, jck["params"], jck["batch_stats"])
    raw = jax.jit(build_detect_fn(jc, jd.gen, jd.pnet, jd.cnet,
                                  normalize_inputs=False))
    return jc, tc, jd, raw, Detector(tc, pnet, cnet, device="cpu")


def _planes(jc, frames):
    return pack_s2d_np(np.asarray(j_unwire(frames, jc.color_space)))


def _jax_normalized(jc, planes, true_hw):
    n = jc.normalization
    kw = dict(method=n.method, width=n.width, centering=n.centering,
              scaling=n.scaling)
    return jax.jit(jax.vmap(lambda a, c, t: j_normalize_s2d(
        a, c, t[0], t[1], **kw)))(*map(jnp.asarray, planes),
                                   jnp.asarray(true_hw))


def _nonempty(ref):
    assert int(np.asarray(ref.proposals_valid).sum()) >= 4
    assert int(np.asarray(ref.valid).sum()) >= 2


def _equal(got, ref, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)


def _close(got, ref, fields, atol):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("b", [0, 1])
def test_float32_detect_from_jax_planes_matches_jax(photo, float32,
                                                    normalized, b,
                                                    monkeypatch):
    jck, *_ = photo
    jc, tc, jd, raw, det = float32
    _, true_hw = photo[3][b]
    planes, jax_planes = normalized[b]
    ref = jax.tree.map(np.asarray, raw(
        jck["params"], jck["batch_stats"],
        tuple(map(jnp.asarray, jax_planes)), jnp.asarray(true_hw)))
    handed = tuple(map(torch.from_numpy, jax_planes))
    monkeypatch.setattr(tdet, "normalize_s2d", lambda *a, **k: handed)
    got = det.detect(planes, true_hw)
    _nonempty(ref)
    _equal(got, ref, ("valid", "classes", "proposals_valid"))
    _close(got, ref, ("boxes", "proposal_boxes", "proposals"), 1e-3)
    _close(got, ref, ("confidence", "fg_score"), 1e-5)


@pytest.mark.parametrize("b", [0, 1])
def test_float32_detect_matches_jax(photo, float32, b):
    jc, tc, jd, raw, det = float32
    frames, true_hw = photo[3][b]
    ref = TP.jax_detect(jd, frames, true_hw)
    got = det.detect(frames, true_hw)
    _nonempty(ref)
    _equal(got, ref, ("valid", "classes", "proposals_valid"))
    _close(got, ref, ("boxes", "proposal_boxes"), 1e-3)
    _close(got, ref, ("fg_score",), 1e-5)
    _close(got, ref, ("proposals",), 1e-2)
    _close(got, ref, ("confidence",), 1e-4)


def test_normalization_is_as_close_to_float64_as_jax(photo, float32,
                                                     normalized):
    """Each package's float32 normalized planes against the port's
    function evaluated in float64 on the same planes, over both batches:
    the port's mean absolute error at most 1.1 times the JAX package's,
    each plane; every value of either within 1e-2."""
    n = float32[0].normalization
    kw = dict(method=n.method, width=n.width, centering=n.centering,
              scaling=n.scaling)
    for (_, true_hw), (planes, jax_planes) in zip(photo[3], normalized):
        h, w = (torch.from_numpy(true_hw[:, i]) for i in (0, 1))
        exact = normalize_s2d(*(torch.from_numpy(p).double()
                                for p in planes), h, w, **kw)
        got = normalize_s2d(*map(torch.from_numpy, planes), h, w, **kw)
        for e, g, r in zip(exact, got, jax_planes):
            e = e.numpy()
            port, ref = np.abs(g.numpy() - e), np.abs(r - e)
            assert port.mean() <= 1.1 * ref.mean(), (port.mean(), ref.mean())
            assert max(port.max(), ref.max()) < 1e-2


def test_bf16_detections_match_jax(photo):
    jck, jbase, tbase, batches, pnet, cnet = photo
    jc, jkw = jax_modes(jbase, None)["bf16"]
    tc, tkw = mode_table(tbase, None)["bf16"]
    assert jc.compute_dtype == tc.compute_dtype == "bfloat16"
    jd = JDetector(jc, jck["params"], jck["batch_stats"], **jkw)
    det = Detector(tc, pnet, cnet, device="cpu", **tkw)
    matched = total = 0
    for frames, true_hw in batches:
        ref = TP.jax_detect(jd, frames, true_hw)
        got = det.detect(frames, true_hw)
        _nonempty(ref)
        m, n, misses, _ = TP.compare(ref, got, BF16_BANDS)
        assert all(miss[-1] for miss in misses), misses
        matched, total = matched + m, total + n
    assert total >= 12 and matched >= 0.9 * total, (matched, total)
