"""pnet and cnet of the port, with weights from ``from_jax_params``,
against flax ``apply`` on the same weights and inputs.

Tolerance: rtol 1e-4 / atol 1e-4 in float32 (convolution sums in another
order; the anchor maps carry up to ~1e2 in magnitude at full width).
Train-mode ``MaskedBatchNorm`` (output and new running statistics) and the
train-mode cnet with dropout zeroed against flax ``mutable=["batch_stats"]``:
rtol 1e-5. Dropout: statistics of the masks (whole channels for the
spatial form) and the 1/(1-p) scale.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import frcnn_tpu.config as jcfg
from frcnn_tpu.models.factory import create_models as j_create
from frcnn_tpu.models.factory import init_params
from frcnn_tpu.models.layers import MaskedBatchNorm as JBN
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.models.factory import create_models, init_models
from frcnn_tpu_torch.models.layers import (
    MaskedBatchNorm,
    apply_dropout,
    keep_mask,
)
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


def test_masked_batch_norm_train_matches_flax():
    rng = np.random.default_rng(0)
    F = 12
    x = rng.normal(1.0, 2.0, (3, 10, F)).astype(np.float32)
    mask = rng.uniform(size=(3, 10)) > 0.3
    mask[2, :] = False
    mask[2, 4] = True                     # one valid row: unbiased n-1 guard
    mean = rng.normal(0, 0.1, F).astype(np.float32)
    var = rng.uniform(0.5, 2, F).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, F).astype(np.float32)
    bias = rng.normal(0, 0.1, F).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    ref, upd = JBN(F).apply(variables, x, mask, use_running_average=False,
                            mutable=["batch_stats"])
    bn = MaskedBatchNorm(F)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    out, (new_mean, new_var) = bn(torch.from_numpy(x),
                                  torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(new_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)
    # the buffers are left as they were
    assert torch.equal(bn.running_mean, torch.from_numpy(mean))


def test_cnet_train_mode_matches_flax():
    import dataclasses as dc
    jc = tiny_config()
    jc = jc.replace(model=dc.replace(jc.model, class_layers=tuple(
        dc.replace(s, dropout=0.0) for s in jc.model.class_layers)))
    cfg = Config.from_json(jc.to_json())
    params, stats = init_params(jc, jax.random.PRNGKey(1))
    _, jcn = j_create(jc)
    _, tcn = create_models(cfg)
    state = from_jax_params(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, stats), cfg)
    tcn.load_state_dict(state["cnet"])
    rng = np.random.default_rng(3)
    d = jc.roi_pooling.kh * jc.roi_pooling.kw * jc.model.layers[-1].filters
    x = rng.normal(0, 1, (2, 9, d)).astype(np.float32)
    mask = rng.uniform(size=(2, 9)) > 0.3
    (reg, logp), upd = jcn.apply(
        {"params": params["cnet"], "batch_stats": stats["cnet"]}, x, mask,
        train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"])
    treg, tlogp, new = tcn(torch.from_numpy(x), torch.from_numpy(mask),
                           train=True)
    m = mask[..., None]
    np.testing.assert_allclose(treg.detach().numpy() * m,
                               np.asarray(reg) * m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlogp.detach().numpy() * m,
                               np.asarray(logp) * m, rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            new[f"bn0.running_{k}"].numpy(),
            np.asarray(upd["batch_stats"]["bn0"][k]), rtol=1e-5, atol=1e-7)


def test_dropout_masks_and_scale():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(64, 48, 3, 5) + 0.5
    y = apply_dropout(x, keep_mask((64, 48, 1, 1), 0.4, g, "cpu"), 0.4)
    kept = (y != 0).reshape(64, 48, -1)
    # whole channels: every cell of a (sample, channel) kept or dropped
    assert torch.equal(kept.all(-1), kept.any(-1))
    frac = 1 - kept.all(-1).float().mean()
    assert abs(float(frac) - 0.4) < 0.04
    k = kept.all(-1)[..., None, None].expand_as(x)
    assert torch.equal(y[k], x[k] / 0.6)
    z = apply_dropout(x, keep_mask(x.shape, 0.5, g, "cpu"), 0.5)
    assert abs(float((z == 0).float().mean()) - 0.5) < 0.02
    assert torch.equal(z[z != 0], x[z != 0] / 0.5)
    # the same generator state gives the same masks; a model layer of rate
    # 0 draws nothing
    a = keep_mask(x.shape, 0.5, torch.Generator().manual_seed(7), "cpu")
    b = keep_mask(x.shape, 0.5, torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(a, b)
    cfg = Config.from_json(tiny_config().to_json())
    pnet, _ = create_models(cfg)
    s = g.get_state()
    masks = pnet.dropout_masks(2, g, "cpu")
    assert [m is None for m in masks] == [
        spec.dropout == 0 for spec in cfg.model.layers]
    assert masks[1].shape == (2, cfg.model.layers[1].filters, 1, 1)
    assert not torch.equal(g.get_state(), s)
    s = g.get_state()
    no_drop = dataclasses.replace(cfg.model, class_layers=tuple(
        dataclasses.replace(c, dropout=0.0) for c in cfg.model.class_layers))
    _, cnet = create_models(cfg.replace(model=no_drop))
    assert cnet.dropout_masks((2, 5), g, "cpu") == [None, None]
    assert torch.equal(g.get_state(), s)