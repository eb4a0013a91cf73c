"""The port against the JAX package on vgg_large's trained checkpoint:
``artifacts/ckpt/imagenet_partial_final.ckpt`` (vgg_large, 6 classes,
step 3000), each package's config from the checkpoint's ``config_json``
(buckets 480x1000 and 1000x480) at the published gates (fg 0.95,
confidence 0.2), the weights carried by ``from_jax_params``, one photo
scene of the imagenet scale per bucket (``tests/trained_photo.py``: seed
0, up to 8 bricks). This check runs on the CPU only: the smoke on the
card carries the photo checkpoint alone.

float32, the serving config (s2d planes, the 2-conv block 0; the JAX
package's Pallas kernels in interpret mode, the port's plain versions):
``valid``, ``classes`` and ``proposals_valid`` equal, boxes,
``proposal_boxes`` and ``proposals`` atol 1e-3, ``confidence`` and
``fg_score`` atol 1e-5 (``tests/test_torch_detect.py``), in both
buckets, end to end. Measured: 5 and 6 proposals, 0 and 2 detections;
``proposals`` 5.2e-4 apart, the rest within 1e-7.

int8_static_s2d (``tools/eval_quant_parity.py::mode_table``; static
scales calibrated by each package on the same 2 normalized scenes of the
landscape bucket, held layer by layer by ``trained_photo.check_scales``):
detections matched by class at IoU >= 0.5, both ways, every miss with a
reason (``trained_photo.compare``), and stage-1 proposals matched at IoU
>= 0.5. The checkpoint is early (mAP 0.020 at step 3000,
``docs/accuracy/imagenet_r4_result.json``): its few detections sit at
confidences of 0.20-0.22, inside the int8 band of the 0.2 gate, so the
proposals carry most of the check. The case at the full buckets is
``slow`` (the JAX package's int8 chain and 2-conv kernel in interpret mode
there take ~18 min on a loaded 8-core host); measured there: 2 of 4
detections matched (each side holds one the other lacks, at confidences
0.218 and 0.202: the confidence gate), 20 of 23 proposals matched, the
static scales equal but for ``anchor2_out``, one bf16 step apart
(``trained_photo.check_scales``). The test holds detections at a share of
0.5 and proposals at 0.8.

The unmarked case runs the same config and weights at 240x500 and
500x240, two scenes per bucket (alone on one process the JAX package's
interpret-mode calls take as long at B=2 as at B=1), with the
confidence gate at 0 in both
packages: at the published 0.2 no detection passes at these buckets on
either side, and the int8 chain past the proposals (the pooled int8
features, the class head) would go unchecked. The fg gate stays at 0.95,
so the proposals are those of the published gate. Every pooled proposal
that the class head does not class background is then a detection, and
the comparison holds the class decision of each. Measured: 8 of 8
detections matched (4 per side, one per scene, confidences 0.17-0.18),
12 of 12 proposals, every scale equal; matched pairs 0.0108 apart in
confidence and 2.5e-4 in fg_score. The test holds at least 8 detections
in all, a share of 0.8 of detections and of proposals, and matched pairs
within ``trained_photo.INT8_BANDS`` (0.05 confidence, 0.01 fg_score).
"""

import dataclasses

import numpy as np
import pytest
import torch

from frcnn_tpu.config import serving_config as j_serving
from frcnn_tpu.detect.detector import Detector as JDetector
from frcnn_tpu_torch.config import serving_config
from frcnn_tpu_torch.detect.detector import Detector
from tests import trained_photo as TP

CKPT = TP.ROOT / "artifacts" / "ckpt" / "imagenet_partial_final.ckpt"
BUCKETS = ((480, 1000), (1000, 480))
SMALL = ((240, 500), (500, 240))


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def large():
    return TP.load(CKPT)


def _configs(jck, tck, buckets):
    out = []
    for c in TP.configs(jck, tck, buckets[0]):
        out.append(c.replace(shapes=dataclasses.replace(
            c.shapes, portrait_hw=tuple(buckets[1]))))
    return out


def _frames(buckets, n: int = 1):
    """``n`` scenes per bucket, as (frames [n, H, W, 3], true_hw)."""
    out = []
    for hw in buckets:
        x = TP.scenes(hw, n, seed=0, box_hi=380, scale="imagenet")
        out.append((x, np.array([hw] * n, np.int32)))
    return out


def test_float32_detect_matches_jax(large):
    jck, tck = large
    jbase, tbase = _configs(jck, tck, BUCKETS)
    jc = j_serving(jbase).replace(pallas_mode="interpret",
                                  compute_dtype="float32")
    tc = serving_config(tbase).replace(compute_dtype="float32")
    assert jc.input_layout == tc.input_layout == "s2d"
    assert tc.model.layers[0].conv_steps == 2
    jd = JDetector(jc, jck["params"], jck["batch_stats"])
    pnet, cnet = TP.port_models(tc, jck)
    det = Detector(tc, pnet, cnet, device="cpu")
    n_det = 0
    for frames, true_hw in _frames(BUCKETS):
        ref = TP.jax_detect(jd, frames, true_hw)
        got = det.detect(frames, true_hw)
        assert int(np.asarray(ref.proposals_valid).sum()) >= 4
        n_det += int(np.asarray(ref.valid).sum())
        for f in ("valid", "classes", "proposals_valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)), f)
        for f, atol in (("boxes", 1e-3), ("proposal_boxes", 1e-3),
                        ("proposals", 1e-3), ("confidence", 1e-5),
                        ("fg_score", 1e-5)):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)), rtol=0,
                                       atol=atol, err_msg=f)
    assert n_det >= 1


def _int8_case(large, buckets, n: int = 1, confidence: float = 0.2,
               **check):
    from frcnn_tpu_torch.tools.eval_quant_parity import mode_table
    from tests.photo_reading import jax_modes

    jck, tck = large
    jbase, tbase = (c.replace(detect_confidence=confidence)
                    for c in _configs(jck, tck, buckets))
    calib = TP.normalized(jbase, TP.scenes(buckets[0], 2, seed=1,
                                           box_hi=380, scale="imagenet"))
    jc, jkw = jax_modes(jbase, calib)["int8_static_s2d"]
    tc, tkw = mode_table(tbase, calib)["int8_static_s2d"]
    pnet, cnet = TP.port_models(tbase, jck)
    jd = JDetector(jc, jck["params"], jck["batch_stats"], **jkw)
    det = Detector(tc, pnet, cnet, device="cpu", **tkw)
    TP.check_scales(jd, det)
    assert "block0_conv1" in det.pnet.act_scales
    return TP.check_detections(jd, det, _frames(buckets, n), **check)


def test_int8_static_s2d_detections_match_jax(large):
    *_, (dc, df) = _int8_case(large, SMALL, n=2, confidence=0.0,
                              share=0.8, least=8, proposals=0.8)
    assert dc <= TP.INT8_BANDS["confidence"] and df <= TP.INT8_BANDS["fg"]


@pytest.mark.slow
def test_int8_static_s2d_detections_match_jax_at_the_buckets(large):
    _int8_case(large, BUCKETS, share=0.5, least=0, proposals=0.8)
