"""Port geometry against the JAX package: boxes, localizer, anchors,
compact_mask.

Tolerances: exact wherever both sides run the same float32 operations in
the same order; ``decode`` within rtol 1e-6 / atol 1e-5, since XLA's exp
and its fused multiply-add round differently from PyTorch's by an ulp.
The anchor tables are host numpy on both sides and compared exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frcnn_tpu.config as jcfg
from frcnn_tpu.geometry import boxes as jb
from frcnn_tpu.geometry.anchors import AnchorGenerator as JGen
from frcnn_tpu.geometry.matching import compact_mask as j_compact
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.geometry import boxes as tb
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator as TGen
from frcnn_tpu_torch.geometry.matching import compact_mask as t_compact
from tests.tiny import tiny_config


def _boxes(rng, n):
    xy = rng.uniform(-20, 300, (n, 2))
    wh = rng.uniform(0, 120, (n, 2))
    b = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    b[::7] = np.round(b[::7])        # integer boxes: exact +1-pixel ties
    return b


def test_boxes_decode_overlaps_iou():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 200), _boxes(rng, 200)
    t = rng.normal(0, 0.5, (200, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tb.decode(torch.from_numpy(a), torch.from_numpy(t)).numpy(),
        np.asarray(jb.decode(jnp.asarray(a), jnp.asarray(t))),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        tb.overlaps(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None])
        .numpy(), np.asarray(jb.overlaps(jnp.asarray(a)[:, None],
                                         jnp.asarray(b)[None])))
    np.testing.assert_array_equal(
        tb.iou_plus_one(torch.from_numpy(a)[:, None],
                        torch.from_numpy(b)[None]).numpy(),
        np.asarray(jb.iou_plus_one(jnp.asarray(a)[:, None],
                                   jnp.asarray(b)[None])))


@pytest.mark.parametrize("name", ["tiny", "duplo800", "imagenet"])
def test_anchor_tables_and_localizer(name):
    if name == "tiny":
        jc = tiny_config()
    elif name == "duplo800":
        jc = jcfg.duplo_config()
        jc = jc.replace(shapes=dataclasses.replace(jc.shapes,
                                                   image_hw=(450, 800)))
    else:
        jc = jcfg.imagenet_config()
    jg, tg = JGen(jc), TGen(Config.from_json(jc.to_json()))
    for f in ("boxes", "tap", "aspect", "fy", "fx", "bin_x", "bin_y"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), f)
    assert tg.tap_dims == jg.tap_dims and tg.fm_hw == jg.fm_hw
    np.testing.assert_array_equal(tg.detect_order(), jg.detect_order())

    # per-image true sizes: fm_valid_mask and the localizer's tensor paths
    H, W = jc.shapes.image_hw
    th = np.array([H, H - 37, 61, 2 * (H // 3)], np.int32)
    tw = np.array([W, W // 2 + 3, W - 1, 95], np.int32)
    perm = jg.detect_order()
    got = tg.fm_valid_mask(torch.from_numpy(th), torch.from_numpy(tw),
                           fy=tg.fy[perm], fx=tg.fx[perm]).numpy()
    for i in range(len(th)):
        ref = np.asarray(jg.fm_valid_mask(th[i], tw[i], fy=jg.fy[perm],
                                          fx=jg.fx[perm]))
        np.testing.assert_array_equal(got[i], ref)
    loc_j, loc_t = jg.fm_localizer, tg.fm_localizer
    fw, fh = loc_t.feature_map_size_t(torch.from_numpy(tw),
                                      torch.from_numpy(th))
    rw, rh = loc_j.feature_map_size_jax(jnp.asarray(tw), jnp.asarray(th))
    np.testing.assert_array_equal(fw.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(fh.numpy(), np.asarray(rh))
    rects = _boxes(np.random.default_rng(1), 300)
    np.testing.assert_array_equal(
        loc_t.input_to_feature_rect_t(torch.from_numpy(rects)).numpy(),
        np.asarray(loc_j.input_to_feature_rect_jax(jnp.asarray(rects))))
    for r in rects[:20].astype(np.float64):
        assert loc_t.input_to_feature_rect(*r) == \
            loc_j.input_to_feature_rect(*r)


@pytest.mark.parametrize("n,k", [(50, 8), (3000, 64), (40, 64)])
def test_compact_mask(n, k):
    rng = np.random.default_rng(n)
    for density in (0.0, 0.03, 0.5, 1.0):
        m = rng.uniform(size=(3, n)) < density
        got = t_compact(torch.from_numpy(m), k)
        for i in range(3):
            ref = j_compact(jnp.asarray(m[i]), k)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))
