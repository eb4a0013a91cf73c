"""The port's evaluation (``detect/evaluation.py``) against the JAX
package's: the scoring functions on seeded random detection lists with
tied scores, and ``evaluate_map`` of a port ``Detector`` (CPU, weights
carried across by ``from_jax_params``) against the JAX ``Detector`` (the
tiny serving config, Pallas kernels in interpret mode) on the same image
files through each package's own batch iterator.

Tolerances: the scoring functions' results equal (the same float64
arithmetic in the same order); ``evaluate_map`` image, GT and detection
counts equal, mAP and recalls within 1e-4.

The files are ``make_dataset``'s rectangles with seeded noise (sigma 8
levels) added: on its flat backgrounds the divisive normalization divides
float-rounding noise by its 1e-4 floor, so the proposals of the two
packages differ by up to 0.03 px there and near-tied proposals can swap.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from frcnn_tpu.config import serving_config as j_serving
from frcnn_tpu.data.importers import create_duplo_manifest
from frcnn_tpu.data.pipeline import BatchIterator as JBatchIterator
from frcnn_tpu.detect import evaluation as j_eval
from frcnn_tpu.detect.detector import Detector as JDetector
from frcnn_tpu.models.factory import init_params
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.data.pipeline import BatchIterator
from frcnn_tpu_torch.detect import evaluation as t_eval
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.models.factory import models_from_state_dicts
from frcnn_tpu_torch.utils.weights import from_jax_params
from tests.test_e2e_synthetic import make_dataset
from tests.test_torch_detect import _mild_fg_params
from tests.tiny import tiny_config


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _random_lists(seed, n_images=6, n_classes=3):
    """Detections and GT boxes on a coarse grid (many IoU and score ties:
    scores are drawn from five values)."""
    rng = np.random.default_rng(seed)
    gts, dets = [], []
    for img in range(n_images):
        for _ in range(rng.integers(0, 5)):
            x, y = rng.integers(0, 8, 2) * 10.0
            w, h = rng.integers(1, 5, 2) * 10.0
            gts.append({"image": img, "class": int(rng.integers(n_classes)),
                        "box": [x, y, x + w, y + h]})
        for _ in range(rng.integers(0, 9)):
            if gts and rng.random() < 0.6:
                g = gts[rng.integers(len(gts))]
                box = [v + rng.integers(-1, 2) * 5.0 for v in g["box"]]
                img_id, c = g["image"], g["class"]
            else:
                x, y = rng.integers(0, 8, 2) * 10.0
                box = [x, y, x + 20.0, y + 20.0]
                img_id, c = img, int(rng.integers(n_classes))
            dets.append({"image": img_id, "class": c,
                         "score": float(rng.choice([0.2, 0.5, 0.5, 0.7, 0.9])),
                         "box": box})
    return dets, gts


@pytest.mark.parametrize("seed", range(6))
def test_scoring_matches_jax(seed):
    dets, gts = _random_lists(seed)
    for thr in (0.5, 0.3):
        assert (t_eval.compute_map(dets, gts, 3, thr)
                == j_eval.compute_map(dets, gts, 3, thr))
        a, b = (t_eval.matched_recall(dets, gts, thr),
                j_eval.matched_recall(dets, gts, thr))
        assert a == b or (np.isnan(a) and np.isnan(b))
        props = {}
        for d in dets:
            props.setdefault(d["image"], []).append(d["box"])
        a, b = (t_eval.proposal_coverage(props, gts, thr),
                j_eval.proposal_coverage(props, gts, thr))
        assert a == b or (np.isnan(a["proposal_recall"])
                          and np.isnan(b["proposal_recall"]))
    tp = (np.arange(9) % 3 == 0).astype(float)
    assert (t_eval._ap_from_pr(tp, 1 - tp, 5)
            == j_eval._ap_from_pr(tp, 1 - tp, 5))
    assert np.isnan(t_eval._ap_from_pr(tp, 1 - tp, 0))


@pytest.fixture(scope="module")
def jax_eval(tmp_path_factory):
    """Files, config, weights and the JAX evaluate_map result, shared."""
    tmp = tmp_path_factory.mktemp("torch_eval")
    make_dataset(tmp, n=12)
    rng = np.random.default_rng(7)
    for f in sorted(tmp.glob("img*.png")):
        a = np.asarray(Image.open(f)).astype(np.float64)
        a += rng.normal(0, 8, a.shape)
        Image.fromarray(np.clip(a, 0, 255).astype(np.uint8)).save(f)
    create_duplo_manifest("synthetic", str(tmp / "boxes.csv"), None,
                          str(tmp / "eval.json"), validation_size=0.5)
    jc = j_serving(tiny_config()).replace(
        pallas_mode="interpret", examples_base_path=str(tmp))
    params, stats = init_params(jc, jax.random.PRNGKey(0))
    params = _mild_fg_params(params)
    det = JDetector(jc, params, stats)
    it = JBatchIterator(jc, str(tmp / "eval.json"), seed=0)
    want = j_eval.evaluate_map(jc, det, it, max_images=6, batch=4,
                               iou_threshold=0.1, with_proposal_recall=True)
    return tmp, jc, params, stats, want


def test_evaluate_map_matches_jax(jax_eval):
    """Six validation images in batches of 4: the second batch is ragged
    and tiled to the fixed batch size."""
    tmp, jc, params, stats, want = jax_eval
    cfg = Config.from_json(jc.to_json())
    state = from_jax_params(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, stats), cfg)
    pnet, cnet = models_from_state_dicts(cfg, state)
    det = Detector(cfg, pnet, cnet, device="cpu")
    it = BatchIterator(cfg, str(tmp / "eval.json"), seed=0)
    got = t_eval.evaluate_map(cfg, det, it, max_images=6, batch=4,
                              iou_threshold=0.1, with_proposal_recall=True)
    assert want["num_images"] == 6 and want["num_detections"] > 0
    for k in ("num_images", "num_gt", "num_detections", "num_covered"):
        assert got[k] == want[k], k
    for k in ("mAP", "proposal_recall", "detection_recall"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert set(got["per_class"]) == set(want["per_class"])
    for c, ap in want["per_class"].items():
        assert abs(got["per_class"][c] - ap) <= 1e-4, c


def test_collect_detections_stops_on_an_empty_set(jax_eval):
    tmp, jc, params, stats, _ = jax_eval
    cfg = Config.from_json(jc.to_json())
    state = from_jax_params(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, stats), cfg)
    det = Detector(cfg, *models_from_state_dicts(cfg, state), device="cpu")
    manifest = {"ground_truth": {}, "training_set": ["x.png"],
                "validation_set": []}
    got = t_eval.evaluate_map(cfg, det, BatchIterator(cfg, manifest))
    assert got["num_images"] == 0 and got["mAP"] == 0.0
