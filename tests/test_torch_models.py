"""pnet and cnet of the port, with weights from ``from_jax_params``,
against flax ``apply`` on the same weights and inputs.

Tolerance: rtol 1e-4 / atol 1e-4 in float32 (convolution sums in another
order; the anchor maps carry up to ~1e2 in magnitude at full width).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import frcnn_tpu.config as jcfg
from frcnn_tpu.models.factory import create_models as j_create
from frcnn_tpu.models.factory import init_params
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.models.factory import create_models, init_models
from frcnn_tpu_torch.utils.weights import from_jax_params
from tests.tiny import tiny_config


@pytest.fixture(autouse=True)
def _no_tf32():
    """Float32 comparisons run in full float32 (no TF32) on any device."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _check_models(jc, hw, seed, n_rois=5):
    cfg = Config.from_json(jc.to_json())
    params, stats = init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # non-trivial batch-norm statistics and slopes
    stats = jax.tree.map(lambda x: x, stats)
    bn = stats["cnet"]["bn0"]
    bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2, bn["var"].shape).astype(np.float32)
    params["cnet"]["bn0"]["scale"] = rng.uniform(
        0.5, 1.5, bn["mean"].shape).astype(np.float32)
    params["pnet"]["block1_prelu0"]["slope"] = np.array([0.1], np.float32)

    jp, jcn = j_create(jc)
    tp, tcn = create_models(cfg)
    state = from_jax_params(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, stats), cfg)
    tp.load_state_dict(state["pnet"])
    tcn.load_state_dict(state["cnet"])

    x = rng.normal(0, 1, (2, hw[0], hw[1], 3)).astype(np.float32)
    maps, fm = jax.jit(lambda p, v: jp.apply({"params": p}, v, train=False))(
        params["pnet"], x)
    with torch.no_grad():
        tmaps, tfm = tp(torch.from_numpy(x))
    for a, b in zip(tmaps + [tfm], list(maps) + [fm]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)

    d = jc.roi_pooling.kh * jc.roi_pooling.kw * jc.model.layers[-1].filters
    pooled = rng.normal(0, 1, (2, n_rois, d)).astype(np.float32)
    reg, logp = jax.jit(lambda p, s, v: jcn.apply(
        {"params": p, "batch_stats": s}, v, None, train=False))(
        params["cnet"], stats["cnet"], pooled)
    with torch.no_grad():
        treg, tlogp = tcn(torch.from_numpy(pooled))
    np.testing.assert_allclose(treg.numpy(), np.asarray(reg), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(logp), rtol=1e-4,
                               atol=1e-4)


def test_tiny_models_match_flax():
    _check_models(tiny_config(), (128, 160), 0)


def test_vgg_small_full_width_models_match_flax():
    jc = jcfg.duplo_config(class_count=6)
    jc = jc.replace(compute_dtype="float32",
                    shapes=dataclasses.replace(jc.shapes,
                                               image_hw=(128, 160)))
    _check_models(jc, (128, 160), 1)


def test_seeded_init_shapes_and_scale():
    cfg = Config.from_json(tiny_config().to_json())
    a = init_models(cfg, torch.Generator().manual_seed(0))
    b = init_models(cfg, torch.Generator().manual_seed(0))
    for m1, m2 in zip(a, b):
        for (k, v1), v2 in zip(m1.state_dict().items(),
                               m2.state_dict().values()):
            assert torch.equal(v1, v2), k
    w = a[0].block1_conv0.weight.detach()
    assert abs(float(w.std()) - (2.0 / (9 * w.shape[0])) ** 0.5) < 0.03
