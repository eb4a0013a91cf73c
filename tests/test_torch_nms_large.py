"""Row 1 past 2048 boxes per image: the port's NMS against the JAX
package's where N > 2048 (the CUDA kernel's limit before it staged a
share of the image per block; the plain version now keeps O(B * N)
memory and walks one pick per image per trip, as the Pallas kernel does).

* The plain keep mask and slots (``ops/nms.py::nms_keep_slots``) and the
  kernel wrapper's CPU route (``nms_kernel.nms_keep_slots``) against the
  Pallas kernel in interpret mode and its compaction, bitwise, at N = 2049
  and 3000, B = 2, on seeded boxes with exact duplicates (ties), an image
  holding a NaN coordinate and invalid boxes.
* The public ``ops.nms`` and ``per_class_nms`` and ``cuda_nms``'s CPU route
  against ``frcnn_tpu.ops.nms.nms`` / ``per_class_nms`` (vmapped): indices
  and validity bitwise.
* The tiny serving ``Detector`` with ``max_proposals`` 2400 at a 192x256
  bucket (2868 anchors) against the JAX ``build_detect_fn`` with Pallas in
  interpret mode: ``valid``, ``classes``, ``proposals_valid`` equal, boxes
  within 1e-3, confidences within 1e-5 (``tests/test_torch_detect.py``'s
  rule).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu.config import serving_config as j_serving
from frcnn_tpu.detect.detector import build_detect_fn
from frcnn_tpu.geometry.anchors import AnchorGenerator as JGen
from frcnn_tpu.geometry.matching import compact_mask as j_compact
from frcnn_tpu.models.factory import create_models as j_create
from frcnn_tpu.models.factory import init_params
from frcnn_tpu.ops.nms import nms as j_nms
from frcnn_tpu.ops.nms import per_class_nms as j_per_class_nms
from frcnn_tpu.ops.pallas_block0 import pack_s2d_np
from frcnn_tpu.ops.pallas_nms import pallas_nms_keep_mask
from frcnn_tpu_torch import ops
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.models.factory import create_models
from frcnn_tpu_torch.ops import nms_kernel
from frcnn_tpu_torch.utils.weights import from_jax_params
from tests.test_detector import _force_fg_params
from tests.test_torch_detect import _mild_fg_params
from tests.tiny import tiny_config

tnms = importlib.import_module("frcnn_tpu_torch.ops.nms")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)


def _boxes(seed: int, b: int, n: int):
    """[b, n, 4] integer boxes over 1000x800 with every 17th box a
    duplicate of the one before, scores with ties, 10% invalid; image 1
    holds a NaN coordinate (every other pick of that image then reads it
    as NaN, as the Pallas kernel does)."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 900, (b, n, 2)).astype(np.float32)
    xy[..., 1] %= 700
    wh = rng.integers(8, 100, (b, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[:, 1::17] = boxes[:, 0:-1:17][:, :boxes[:, 1::17].shape[1]]
    scores = rng.integers(0, 50, (b, n)).astype(np.float32) / 50.0
    valid = rng.random((b, n)) > 0.1
    if b > 1:
        boxes[1, n - 7, 2] = np.nan
    return boxes, scores, valid


@pytest.mark.parametrize("n,thr,max_out", [(2049, 0.5, 2049),
                                           (3000, 0.25, 300)])
def test_keep_slots_match_pallas(n, thr, max_out):
    boxes, _, valid = _boxes(n, 2, n)
    ref = np.asarray(jax.jit(lambda b, v: pallas_nms_keep_mask(
        b, v, thr, max_out, interpret=True))(jnp.asarray(boxes),
                                             jnp.asarray(valid)))
    ref_slots = np.asarray(jax.vmap(lambda m: j_compact(m, max_out)[0])(
        jnp.asarray(ref)))
    assert ref[0].sum() > 64 and ref[1].sum() == 1
    for fn in (tnms.nms_keep_slots, nms_kernel.nms_keep_slots):
        keep, slots = fn(torch.from_numpy(boxes), torch.from_numpy(valid),
                         thr, max_out)
        np.testing.assert_array_equal(keep.numpy(), ref)
        np.testing.assert_array_equal(slots.numpy(), ref_slots)


@pytest.mark.parametrize("n", [2049, 3000])
def test_public_nms_matches_jax(n):
    boxes, scores, valid = _boxes(n + 1, 2, n)
    boxes[1, n - 7, 2] = 5.0                 # finite: both images pick many
    classes = np.random.default_rng(n).integers(0, 4, (2, n))
    jb, js, jv = (jnp.asarray(a) for a in (boxes, scores, valid))
    tb, ts, tv = (torch.from_numpy(a) for a in (boxes, scores, valid))
    for thr, max_out in ((0.25, 300), (0.7, 1000)):
        ref_i, ref_v = jax.jit(jax.vmap(
            lambda b, s, v: j_nms(b, s, v, thr, max_out)))(jb, js, jv)
        for fn in (ops.nms, nms_kernel.cuda_nms):
            idx, ok = fn(tb, ts, tv, thr, max_out)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
            np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_v))
        assert int(np.asarray(ref_v).sum(1).min()) > 64
    ref_i, ref_v = jax.jit(lambda b, s, c, v: j_per_class_nms(
        b, s, c, v, 4, 0.1, 500))(jb[0], js[0], jnp.asarray(classes[0]),
                                  jv[0])
    idx, ok = ops.per_class_nms(tb[0], ts[0],
                                torch.from_numpy(classes[0]), tv[0], 4, 0.1,
                                500)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_v))


HW = (192, 256)
K, D = 2400, 64


@pytest.fixture(scope="module")
def setup():
    base = tiny_config()
    jc = j_serving(base.replace(shapes=dataclasses.replace(
        base.shapes, image_hw=HW, max_proposals=K, max_detections=D)))
    jc = jc.replace(pallas_mode="interpret")
    assert jc.input_layout == "s2d"
    gen = JGen(jc)
    assert gen.boxes.shape[0] > K > 2048
    params, stats = init_params(jc, jax.random.PRNGKey(1))
    jp, jcn = j_create(jc)
    detect = jax.jit(build_detect_fn(jc, gen, jp, jcn))
    rng = np.random.default_rng(1)
    imgs = rng.normal(0.3, 0.2, (2, *HW, 3)).astype(np.float32)
    imgs[:, 40:120, 50:170] += 0.8
    hw = np.array([HW, [150, 200]], np.int32)
    return jc, params, stats, detect, pack_s2d_np(imgs), hw


@pytest.mark.parametrize("weights", ["forced", "mild"])
def test_detector_past_2048_proposals_matches_jax(setup, weights):
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
    if weights == "forced":       # every anchor of the full-size image
        assert int(det.last_counts["proposals_in"].max()) == K
    assert int(np.asarray(ref.proposals_valid).sum()) > 10
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
