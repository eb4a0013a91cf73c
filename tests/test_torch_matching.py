"""The port's training geometry (IoU, encode, the anchor field's image
mask, matching and sampling) against the JAX package on the tiny config.

Tolerances: IoU, anchor tables and masks exactly equal; ``encode`` rtol
1e-6 (XLA's ``log`` and torch's differ by an ulp); matching
and sampling (the port gets the exact Gumbel draws of ``jax.random``)
exactly equal on valid slots: the positive mask, the selected (anchor, gt)
pairs, the random and the nearby negatives, and the whole labeling of a
batch against ``label_one_image``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu.geometry import boxes as jB
from frcnn_tpu.geometry import matching as jM
from frcnn_tpu.geometry.anchors import AnchorGenerator as JGen
from frcnn_tpu.train.objective import label_one_image
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.geometry import boxes as tB
from frcnn_tpu_torch.geometry import matching as tM
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator as TGen
from frcnn_tpu_torch.train.objective import (
    AnchorTables,
    TrainBatch,
    label_batch,
)
from tests.tiny import tiny_config

TRUE_HW = [(128, 160), (100, 150), (128, 97)]


@pytest.fixture(scope="module")
def case():
    """Three images of different true sizes: one with three gt boxes (one
    padded out), one with a box that overlaps no anchor well (best-match
    fallback), one background slot."""
    jc = tiny_config()
    cfg = Config.from_json(jc.to_json())
    jgen, tgen = JGen(jc), TGen(cfg)
    G = jc.shapes.max_gt
    rng = np.random.default_rng(0)
    gt = np.zeros((3, G, 4), np.float32)
    mask = np.zeros((3, G), bool)
    gt[0, :3] = [[20, 30, 70, 75], [60, 10, 130, 60], [5, 5, 40, 30]]
    mask[0, :2] = True
    gt[1, 0] = [90, 40, 97, 52]             # small: best-match only
    gt[1, 1] = [10, 60, 70, 95]
    mask[1, :2] = True
    cls = rng.integers(0, jc.class_count, (3, G)).astype(np.int32)
    true_hw = np.asarray(TRUE_HW, np.int32)
    is_bg = np.array([False, False, True])
    return jc, cfg, jgen, tgen, gt, mask, cls, true_hw, is_bg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's steps here are tiny: one intra-op thread each keeps the
    test workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_boxes_iou_and_encode():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(0, 50, (40, 2)),
                        rng.uniform(50, 120, (40, 2))], -1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 60, (30, 2)),
                        rng.uniform(40, 130, (30, 2))], -1).astype(np.float32)
    b[0] = a[0]
    b[1] = 0.0                                          # empty box
    np.testing.assert_array_equal(
        tB.iou_matrix(_t(a), _t(b)).numpy(),
        np.asarray(jB.iou_matrix(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_allclose(
        tB.encode(_t(a[:30]), _t(b)).numpy(),
        np.asarray(jB.encode(jnp.asarray(a[:30]), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tB.area(_t(a)).numpy(),
                                  np.asarray(jB.area(jnp.asarray(a))))


def test_anchor_field_per_bucket_and_image_mask(case):
    jc, cfg, *_ = case
    for hw in [(128, 160), (160, 128)]:
        j, t = JGen(jc, image_hw=hw), TGen(cfg, image_hw=hw)
        assert t.image_hw == j.image_hw and t.tap_dims == j.tap_dims
        np.testing.assert_array_equal(t.boxes, j.boxes)
        th = np.array([hw[0], hw[0] - 30], np.int32)
        tw = np.array([hw[1] - 7, hw[1]], np.int32)
        got = t.inside_image_mask(_t(th), _t(tw)).numpy()
        for i in range(2):
            np.testing.assert_array_equal(
                got[i], np.asarray(j.inside_image_mask(th[i], tw[i])))


def _cand(jgen, hw):
    return jgen.fm_valid_mask(hw[0], hw[1]) & jgen.inside_image_mask(*hw)


def test_match_and_select_positives(case):
    jc, cfg, jgen, tgen, gt, mask, _, true_hw, _ = case
    boxes = jnp.asarray(jgen.boxes)
    cands = [_cand(jgen, hw) for hw in TRUE_HW]
    tcand = torch.stack([_t(np.asarray(c)) for c in cands])
    for best in (True, False):
        got = tM.match_positives(_t(tgen.boxes), tcand, _t(gt), _t(mask),
                                 0.5, 0.25, best)
        sel = tM.select_positive_pairs(got, jc.shapes.max_positives)
        for i in range(3):
            ref = jM.match_positives(boxes, cands[i], jnp.asarray(gt[i]),
                                     jnp.asarray(mask[i]), 0.5, 0.25, best)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
            rs = jM.select_positive_pairs(ref, jc.shapes.max_positives)
            v = np.asarray(rs.valid)
            np.testing.assert_array_equal(sel.valid[i].numpy(), v)
            assert int(sel.count[i]) == int(rs.count)
            np.testing.assert_array_equal(sel.anchor_idx[i].numpy()[v],
                                          np.asarray(rs.anchor_idx)[v])
            np.testing.assert_array_equal(sel.gt_idx[i].numpy()[v],
                                          np.asarray(rs.gt_idx)[v])
    # the small box of image 1 is matched by the best-match fallback only
    assert got[1, 0].sum() == 0 and sel.valid.sum() > 0


def test_sample_negatives_with_jax_noise(case):
    jc, cfg, jgen, tgen, gt, mask, _, true_hw, is_bg = case
    A = jgen.num_anchors
    boxes = jnp.asarray(jgen.boxes)
    range_id = jgen.tap * 3 + jgen.aspect
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (A,))) for k in keys])
    cands = [_cand(jgen, hw) for hw in TRUE_HW]
    thr = np.where(is_bg, 0.0, 0.25).astype(np.float32)
    req = np.where(is_bg, 3, 16)
    idx, valid = tM.sample_negatives(
        _t(noise), _t(tgen.boxes),
        torch.stack([_t(np.asarray(c)) for c in cands]),
        _t(range_id), 12, _t(gt), _t(mask), _t(thr),
        jc.shapes.max_negatives, _t(req))
    for i in range(3):
        ri, rv = jM.sample_negatives(
            keys[i], boxes, cands[i], jnp.asarray(range_id), 12,
            jnp.asarray(gt[i]), jnp.asarray(mask[i]), float(thr[i]),
            jc.shapes.max_negatives, int(req[i]))
        rv = np.asarray(rv)
        np.testing.assert_array_equal(valid[i].numpy(), rv)
        np.testing.assert_array_equal(idx[i].numpy()[rv], np.asarray(ri)[rv])
    assert valid[2].sum() == 3 and valid[0].sum() == 8


def test_nearby_negatives_with_jax_noise(case):
    jc, cfg, jgen, tgen, gt, mask, _, true_hw, _ = case
    A = jgen.num_anchors
    boxes = jnp.asarray(jgen.boxes)
    cands = [_cand(jgen, hw) for hw in TRUE_HW]
    pos = tM.match_positives(_t(tgen.boxes),
                             torch.stack([_t(np.asarray(c)) for c in cands]),
                             _t(gt), _t(mask), 0.5, 0.25, True)
    sel = tM.select_positive_pairs(pos, jc.shapes.max_positives)
    fm = [jgen.fm_valid_mask(*hw) for hw in TRUE_HW]
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (A,))) for k in keys])
    idx, valid = tM.nearby_negatives(
        _t(noise), _t(tgen.boxes), _t(tgen.bin_x), _t(tgen.bin_y),
        torch.stack([_t(np.asarray(m)) for m in fm]), sel.anchor_idx,
        sel.valid, 0.25, jc.shapes.max_nearby, sel.count)
    for i in range(3):
        ri, rv = jM.nearby_negatives(
            keys[i], boxes, jnp.asarray(jgen.bin_x), jnp.asarray(jgen.bin_y),
            fm[i], jnp.asarray(sel.anchor_idx[i].numpy()),
            jnp.asarray(sel.valid[i].numpy()), 0.25, jc.shapes.max_nearby,
            jnp.asarray(int(sel.count[i])))
        rv = np.asarray(rv)
        np.testing.assert_array_equal(valid[i].numpy(), rv)
        np.testing.assert_array_equal(idx[i].numpy()[rv], np.asarray(ri)[rv])
    assert valid[0].sum() > 0


def test_label_batch_matches_label_one_image(case):
    jc, cfg, jgen, tgen, gt, mask, cls, true_hw, is_bg = case
    A = jgen.num_anchors
    rngs = jax.random.split(jax.random.PRNGKey(7), 3)
    noise_neg, noise_near = [], []
    for r in rngs:
        _, r_neg, r_near = jax.random.split(r, 3)
        noise_neg.append(np.asarray(jax.random.gumbel(r_neg, (A,))))
        noise_near.append(np.asarray(jax.random.gumbel(r_near, (A,))))
    img = np.zeros((3, 128, 160, 3), np.float32)
    batch = TrainBatch(img, true_hw, gt, cls, mask, is_bg).to("cpu")
    got = label_batch(cfg, tgen, AnchorTables.of(tgen, "cpu"), batch,
                      _t(np.stack(noise_neg)), _t(np.stack(noise_near)))
    for i in range(3):
        ref = label_one_image(jc, jgen, rngs[i], jnp.asarray(true_hw[i]),
                              jnp.asarray(gt[i]), jnp.asarray(mask[i]),
                              jnp.asarray(is_bg[i]))
        pv, nv = np.asarray(ref.pos_valid), np.asarray(ref.neg_valid)
        np.testing.assert_array_equal(got.pos_valid[i].numpy(), pv)
        np.testing.assert_array_equal(got.neg_valid[i].numpy(), nv)
        for f, v in (("pos_anchor", pv), ("pos_gt", pv), ("neg_anchor", nv)):
            np.testing.assert_array_equal(getattr(got, f)[i].numpy()[v],
                                          np.asarray(getattr(ref, f))[v])
    assert got.pos_valid[:2].sum() > 0 and got.pos_valid[2].sum() == 0
