"""Shared set-up of the trained-checkpoint tests
(``tests/test_torch_trained*.py``): the photo checkpoint
(``artifacts/ckpt/photo_partial.ckpt``: vgg_small, 6 classes, step 20000)
loaded by each package's own ``load_checkpoint``, each package's config
from its ``config_json``, photo scenes made by the port's scene code, and
the comparison of two packages' detections by class and box.
"""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PHOTO_CKPT = ROOT / "artifacts" / "ckpt" / "photo_partial.ckpt"
HW = (450, 800)            # the checkpoint's bucket
SMALL_HW = (224, 400)      # a quarter of its area
GATES = {"confidence": 0.2, "fg": 0.95}
CLEAR = 0.6                # a class flip needs a confidence below this


def load(path=PHOTO_CKPT):
    """(the JAX package's checkpoint, the port's) of ``path``."""
    from frcnn_tpu.utils.serialization import load_checkpoint as j_load
    from frcnn_tpu_torch.utils.serialization import load_checkpoint

    return j_load(str(path)), load_checkpoint(str(path))


def configs(jck, tck, hw):
    """Each package's config of its checkpoint's ``config_json``, at the
    bucket ``hw``."""
    from frcnn_tpu.config import Config as JConfig
    from frcnn_tpu_torch.config import Config

    out = []
    for cls, ck in ((JConfig, jck), (Config, tck)):
        c = cls.from_json(ck["config_json"])
        out.append(c.replace(shapes=dataclasses.replace(
            c.shapes, image_hw=tuple(hw))))
    return out


def port_models(cfg, jck):
    """The port's float32 pnet and cnet with the JAX checkpoint's
    weights (``from_jax_params``)."""
    from frcnn_tpu_torch.models.factory import models_from_state_dicts
    from frcnn_tpu_torch.utils.weights import from_jax_params

    return models_from_state_dicts(cfg, from_jax_params(
        jck["params"], jck["batch_stats"], cfg))


def scenes(hw, n: int, seed: int, max_boxes: int = 8, box_hi: int = 220,
           scale: str = "photo"):
    """``n`` photo scenes of ``hw`` (``make_photo_dataset``: the checkpoint's
    training distribution, up to ``max_boxes`` bricks each, none corrupt)
    as uint8 [n, H, W, 3]."""
    from frcnn_tpu_torch.data.codec import read_rgb
    from frcnn_tpu_torch.tools import train_synthetic_eval as TSE

    H, W = hw
    *_, box_lo, _hi, n_classes = TSE.SCALES[scale][:5]
    with tempfile.TemporaryDirectory() as d:
        TSE.make_photo_dataset(d, n, W, H, n_classes, box_lo,
                               min(box_hi, min(H, W) // 2), seed=seed,
                               max_boxes=max_boxes, n_corrupt=0)
        return np.stack([read_rgb(f"{d}/img{i:04d}.png", use_native=False)
                         for i in range(n)])


def batch(frames, cut=(40, 60)):
    """B=2 of the first two frames, the second smaller than the bucket by
    ``cut`` rows and columns (zeros past its true size): (frames,
    true_hw)."""
    x = frames[:2].copy()
    H, W = x.shape[1:3]
    x[1, H - cut[0]:] = 0
    x[1, :, W - cut[1]:] = 0
    return x, np.array([[H, W], [H - cut[0], W - cut[1]]], np.int32)


def normalized(jcfg, frames):
    """``frames`` (uint8) normalized at their full size by the JAX
    package, as float32 numpy: the one calibration batch both packages'
    Detectors take."""
    import jax
    import jax.numpy as jnp

    from frcnn_tpu.ops.color import unwire_uint8
    from frcnn_tpu.ops.normalization import normalize_image

    n = jcfg.normalization
    H, W = frames.shape[1:3]
    x = unwire_uint8(jnp.asarray(frames), jcfg.color_space)
    return np.asarray(jax.jit(jax.vmap(lambda im: normalize_image(
        im, H, W, method=n.method, width=n.width, centering=n.centering,
        scaling=n.scaling)))(x))


def jax_detect(det, frames, true_hw):
    """The JAX ``Detector`` on uint8 frames, packed host-side by numpy
    under s2d (its native packer is not built here); numpy outputs."""
    import jax
    import jax.numpy as jnp

    from frcnn_tpu.ops.color import unwire_uint8
    from frcnn_tpu.ops.pallas_block0 import pack_s2d_np

    if det.cfg.input_layout == "s2d":
        planes = pack_s2d_np(np.asarray(unwire_uint8(frames,
                                                     det.cfg.color_space)))
        x = tuple(map(jnp.asarray, planes))
    else:
        x = jnp.asarray(frames)
    return jax.tree.map(np.asarray, det.detect(x, jnp.asarray(true_hw)))


def _host(x):
    """A port's tensor or a JAX package's array as numpy."""
    return x.detach().numpy() if hasattr(x, "detach") else np.asarray(x)


def detections(res, i: int):
    """Image ``i``'s valid detections: (classes, boxes, confidence,
    fg_score) as numpy."""
    v = _host(res.valid)[i].astype(bool)
    return (_host(res.classes)[i][v],
            _host(res.boxes)[i][v].astype(np.float64),
            _host(res.confidence)[i][v].astype(np.float64),
            _host(res.fg_score)[i][v].astype(np.float64))


def _iou(a, b):
    from frcnn_tpu_torch.tools.eval_quant_parity import iou

    return iou(np.reshape(a, (-1, 4)), np.reshape(b, (-1, 4)))


def compare(ref, got, bands, iou_min: float = 0.5):
    """The JAX package's detections (``ref``) and the port's (``got``)
    matched per image by class at IoU >= ``iou_min``, both ways. Returns
    (matched, total, misses, (largest |confidence| and |fg_score|
    difference over matched pairs)); each miss is (side holding it,
    image, class, confidence, fg_score, reason), the reason one of:

    - "fg gate": its fg_score lies within ``bands["fg"]`` of 0.95, so
      rounding may move its anchor across the gate;
    - "confidence gate": its confidence lies within
      ``bands["confidence"]`` of 0.2;
    - "class flip": both packages pooled its proposal (the other side
      holds a proposal at IoU >= ``iou_min`` with its source proposal) and
      no class holds a clear majority there (confidence below
      ``CLEAR``), so the pooled features' rounding moved the argmax;
    - None: none of these (a fault)."""
    matched = total = 0
    misses, dc, df = [], 0.0, 0.0
    res = {"jax": ref, "port": got}
    for i in range(np.asarray(ref.valid).shape[0]):
        sides = {"jax": detections(ref, i), "port": detections(got, i)}
        for side, other in (("jax", "port"), ("port", "jax")):
            x, y = sides[side], sides[other]
            total += len(x[0])
            src = _host(res[side].proposal_boxes)[i][
                _host(res[side].valid)[i].astype(bool)]
            pv = _host(res[other].proposals_valid)[i].astype(bool)
            pooled = _host(res[other].proposals)[i][pv]
            for k in range(len(x[0])):
                iou = _iou(x[1][k], y[1])[0] if len(y[0]) else np.zeros(0)
                ok = (y[0] == x[0][k]) & (iou >= iou_min)
                if ok.any():
                    matched += 1
                    j = int(np.argmax(np.where(ok, iou, -1)))
                    dc = max(dc, abs(x[2][k] - y[2][j]))
                    df = max(df, abs(x[3][k] - y[3][j]))
                    continue
                why = None
                if abs(x[3][k] - GATES["fg"]) <= bands["fg"]:
                    why = "fg gate"
                elif abs(x[2][k] - GATES["confidence"]) <= bands["confidence"]:
                    why = "confidence gate"
                elif x[2][k] < CLEAR and len(pooled) and (
                        _iou(src[k], pooled)[0] >= iou_min).any():
                    why = "class flip"
                misses.append((side, i, int(x[0][k]), float(x[2][k]),
                               float(x[3][k]), why))
    return matched, total, misses, (dc, df)


# a matched pair's confidence moves by up to 5.2e-3 and its fg_score by up
# to 1.2e-4 between the packages' int8 chains (vgg_small at 224x400, every
# mode; vgg_large at 240x500: 1.1e-2 and 2.5e-4); the bands hold a few
# times that
INT8_BANDS = {"fg": 0.01, "confidence": 0.05}


def mode_case(mode: str, hw):
    """Both packages' Detectors of serving mode ``mode`` (the port's
    ``mode_table``, the JAX package's counterpart in
    ``tests/photo_reading.py``) at bucket ``hw``, static scales calibrated
    by each on the same 4 normalized photo scenes; and two B=2 batches of
    other scenes. Returns (JAX Detector, port Detector, batches)."""
    from frcnn_tpu.detect.detector import Detector as JDetector
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.tools.eval_quant_parity import mode_table
    from tests.photo_reading import jax_modes

    jck, tck = load()
    jbase, tbase = configs(jck, tck, hw)
    frames = scenes(hw, 8, seed=0)
    calib = normalized(jbase, frames[4:])
    jc, jkw = jax_modes(jbase, calib)[mode]
    tc, tkw = mode_table(tbase, calib)[mode]
    pnet, cnet = port_models(tbase, jck)
    jd = JDetector(jc, jck["params"], jck["batch_stats"], **jkw)
    det = Detector(tc, pnet, cnet, device="cpu", **tkw)
    return jd, det, [batch(frames[0:2]), batch(frames[2:4])]


def check_scales(jd, det):
    """The port's calibrated static scales against the JAX package's,
    layer by layer: the same layers, each scale (an abs-max over 127)
    within rtol 1e-6 (``tests/test_torch_quant.py``'s calibration
    tolerance) or one bf16 step of the abs-max apart. In a bf16 config the
    abs-max is a bf16 value, and the JAX program contracts a dequantizing
    ``sums * scale + bias`` into one fused multiply-add where the port
    rounds the product first (``ROADMAP.md``, the int8 chain), so a
    dequantized value on a bf16 rounding boundary may round to the
    neighbouring bf16 value. Returns the layers that differ."""
    import torch

    ref, got = jd.pnet.act_scales, det.pnet.act_scales
    assert ref is not None and sorted(got) == sorted(ref)
    differ = []
    for k in ref:
        r, g = float(ref[k]), float(got[k])
        if abs(g - r) <= 1e-6 * abs(r):
            continue
        m = torch.tensor(r * 127.0, dtype=torch.bfloat16)
        up = torch.tensor(np.inf, dtype=torch.bfloat16)
        step = float(torch.nextafter(m, up).float() - m.float())
        assert abs(g - r) * 127.0 <= step * (1 + 1e-6), (k, r, g)
        differ.append(k)
    return differ


def compare_proposals(ref, got, iou_min: float = 0.5):
    """Stage-1 proposals of both packages matched per image at IoU >=
    ``iou_min``, both ways: (matched, total)."""
    matched = total = 0
    for i in range(np.asarray(ref.valid).shape[0]):
        boxes = [_host(r.proposals)[i][_host(r.proposals_valid)[i].astype(
            bool)] for r in (ref, got)]
        for x, y in (boxes, boxes[::-1]):
            total += len(x)
            if len(x) and len(y):
                matched += int((_iou(x, y) >= iou_min).any(1).sum())
    return matched, total


def check_detections(jd, det, batches, share: float, bands=INT8_BANDS,
                     least: int = 8, proposals: float = 0.0):
    """Both packages' detections over ``batches``: at least ``least`` in
    all, a matched share of at least ``share`` (``compare``, both ways),
    every miss with a reason; and a share of at least ``proposals`` of
    their stage-1 proposals matched (``compare_proposals``). Returns
    (matched, total, misses, (proposals matched, proposals), (largest
    |confidence| and |fg_score| difference over matched pairs))."""
    matched = total = p_matched = p_total = 0
    dc = df = 0.0
    all_misses = []
    for frames, true_hw in batches:
        ref = jax_detect(jd, frames, true_hw)
        got = det.detect(frames, true_hw)
        m, n, misses, (c, f) = compare(ref, got, bands)
        matched, total = matched + m, total + n
        dc, df = max(dc, c), max(df, f)
        all_misses += misses
        m, n = compare_proposals(ref, got)
        p_matched, p_total = p_matched + m, p_total + n
    assert all(miss[-1] for miss in all_misses), all_misses
    assert total >= least and matched >= share * total, (matched, total,
                                                         all_misses)
    assert p_total > 0 and p_matched >= proposals * p_total, (p_matched,
                                                              p_total)
    return matched, total, all_misses, (p_matched, p_total), (dc, df)
