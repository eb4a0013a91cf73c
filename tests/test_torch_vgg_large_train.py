"""vgg_large training in the port: a narrow vgg_large-shaped config
(conv_steps 2/2/3/3, narrow widths) with a landscape and a portrait bucket.

- One step of the objective in each bucket against the JAX package's (the
  Pallas ROI pool in interpret mode, dropout zeroed, the JAX labels
  injected): losses and metrics rtol 1e-5, every gradient within 1e-6 +
  1e-4 of its tensor's largest magnitude (``tests/test_torch_train.py``),
  and with remat in the portrait bucket. A PReLU slope's gradient is one float32 sum of
  x * g over every negative activation of the batch, with heavy
  cancellation: in the portrait bucket anchor1's is 0.0136620 in float64,
  0.0136644 from the port and 0.0136712 from the JAX package (5e-4 of its
  magnitude; the float32 sums of both packages are off the float64 value
  by more than 1e-4 of it). Where a tensor is outside the tolerance of the
  JAX value, the test takes the port's objective with float64 convolutions
  as the exact value: the port must lie nearer to it than the JAX value
  does, and the JAX value within ten times the tolerance of it.
- The trainer routes each batch to its bucket's objective and rejects a
  size outside the configured buckets (``tests/test_dual_bucket.py``), and
  a ``Detector`` serves validation batches of both orientations.
- At full width, ``imagenet_config``'s trainer holds the parameters of
  ``vgg_large_model`` (64/128/256/512, a 6x6x512 ROI pool, 201 classes).
"""

import dataclasses

import numpy as np
import pytest
import torch

import frcnn_tpu_torch.train.objective as objective
from frcnn_tpu_torch.config import imagenet_config
from frcnn_tpu_torch.data.pipeline import BatchIterator
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.models.factory import models_from_state_dicts
from frcnn_tpu_torch.train.objective import TrainBatch, value_and_grad
from frcnn_tpu_torch.train.trainer import Trainer
from frcnn_tpu_torch.utils import weights
from tests.test_dual_bucket import make_mixed_dataset
from tests.test_torch_train import (
    _jax_value_and_grad,
    _port_cfg,
    _port_inputs,
)
from tests.test_torch_vgg_large import LAND, PORT, narrow_vgg_large


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers that run side by side would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hw,remat", [(LAND, False), (PORT, False),
                                      (PORT, True)])
def test_narrow_vgg_large_step_matches_jax(hw, remat):
    jc = narrow_vgg_large(pallas_mode="interpret")
    result = _jax_value_and_grad(remat, jc=jc, hw=hw)
    assert result[3].image.shape[1:3] == hw
    cfg = _port_cfg(result[0], pallas_mode="on")
    assert [s.conv_steps for s in cfg.model.layers] == [2, 2, 3, 3]
    (_, _, _, _, total, new_bs, metrics, grads, _) = result
    loss_fn, params, stats, batch, labels = _port_inputs(result, cfg,
                                                         "kernel")
    got, (nbs, m), g = value_and_grad(loss_fn, params, stats, batch,
                                      torch.Generator().manual_seed(0),
                                      labels=labels)
    np.testing.assert_allclose(float(got), total, rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, err_msg=k)
    assert float(m["reg_count"]) > 0
    for k in ("mean", "var"):
        np.testing.assert_allclose(nbs[f"cnet.bn0.running_{k}"].numpy(),
                                   new_bs["cnet"]["bn0"][k], rtol=1e-5,
                                   atol=1e-7)
    ref = weights.from_jax_tree(grads, cfg)
    exact = None
    for k, r in ref.items():
        tol = 1e-6 + 1e-4 * float(r.abs().max())
        err = float((g[k] - r).abs().max())
        if err <= tol:
            continue
        if exact is None:
            exact = _float64_gradients(result, cfg)
        port_err = float((g[k].double() - exact[k]).abs().max())
        jax_err = float((r.double() - exact[k]).abs().max())
        assert port_err < jax_err <= 10 * tol, (
            f"{k}: port {err:.3g} from JAX (tolerance {tol:.3g}); from the "
            f"float64 objective: port {port_err:.3g}, JAX {jax_err:.3g}")


def _float64_gradients(result, cfg):
    """The port objective's gradients with the convolutions, linears and
    their gradients in float64 (the loss math and batch norm stay float32):
    the value that the float32 sums round."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(objective, "compute_dtype", lambda c: torch.float64)
        loss_fn, params, stats, batch, labels = _port_inputs(result, cfg,
                                                             "kernel")
    params = {k: v.double() for k, v in params.items()}
    stats = {k: v.double() for k, v in stats.items()}
    batch = TrainBatch(batch.image.double(), *batch[1:])
    return value_and_grad(loss_fn, params, stats, batch,
                          torch.Generator().manual_seed(0), labels=labels)[2]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mixed")
    make_mixed_dataset(tmp)
    cfg = _port_cfg(narrow_vgg_large(), target_smaller_side=128,
                    max_pixel_size=192, examples_base_path=str(tmp),
                    pallas_mode="on")
    cfg = cfg.replace(augmentation=dataclasses.replace(
        cfg.augmentation, hflip=0.0, vflip=0.0))
    return tmp, cfg


def test_dual_bucket_training_steps(mixed):
    tmp, cfg = mixed
    it = BatchIterator(cfg, str(tmp / "mix.json"), seed=2)
    tr = Trainer(cfg, device="cpu", seed=0)
    stepped = set()
    for _ in range(8):
        b = it.next_training_batch()
        m = tr.run_step(b)
        assert np.isfinite(m["loss"]) and m["skipped"] == 0.0
        stepped.add(tuple(b.image.shape[1:3]))
        if stepped == {LAND, PORT}:
            break
    assert stepped == {LAND, PORT}
    assert set(tr._objectives) == {LAND, PORT}
    with pytest.raises(ValueError, match="bucket"):
        tr.objective((96, 96))


def test_dual_bucket_detector_and_validation(mixed):
    tmp, cfg = mixed
    it = BatchIterator(cfg, str(tmp / "mix.json"), seed=3)
    tr = Trainer(cfg, device="cpu", seed=1)
    det = Detector(cfg, *models_from_state_dicts(cfg, tr.state_dicts()),
                   device="cpu")
    shapes = set()
    for _ in range(4):
        imgs, hws, _ = it.padded_validation_batch(2)
        if imgs.shape[0] == 0:
            break
        assert tuple(imgs.shape[1:3]) in (LAND, PORT)
        shapes.add(tuple(imgs.shape[1:3]))
        out = det.detect(imgs, hws)
        assert out.boxes.shape == (imgs.shape[0], cfg.shapes.max_detections,
                                   4)
    assert shapes == {LAND, PORT}
    with pytest.raises(ValueError, match="bucket"):
        det.detect(np.zeros((1, 96, 96, 3), np.float32),
                   np.asarray([[96, 96]], np.int32))


def test_full_width_vgg_large_trainer():
    cfg = imagenet_config(compute_dtype="bfloat16", pallas_mode="on",
                          remat=True)
    tr = Trainer(cfg, device="cpu", seed=0)
    p = tr.params
    assert [p[f"pnet.block{b}_conv0.weight"].shape[0] for b in range(4)] == \
        [64, 128, 256, 512]
    assert all(f"pnet.block{b}_conv{n - 1}.weight" in p
               for b, n in enumerate((2, 2, 3, 3)))
    assert p["cnet.fc0.weight"].shape[1] == 6 * 6 * 512
    assert p["cnet.cls_head.weight"].shape[0] == 201
    assert all(v.dtype == torch.float32 for v in p.values())
    assert tr.pnet.pool_vjp == "kernel"
    assert cfg.shapes.images_per_step == 8
    assert set(map(tuple, cfg.shapes.buckets())) == {(480, 1000), (1000, 480)}
