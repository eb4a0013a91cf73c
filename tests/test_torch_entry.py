"""The port's flagship entry and the real-config stage of its dryrun
(``frcnn_tpu_torch/entry.py``, ``frcnn_tpu_torch/parallel/dryrun.py``)
against ``__graft_entry__.py``.

- ``entry()``'s config equals the one ``__graft_entry__.entry()`` builds
  (JSON equal); its example arguments have the JAX ones' shapes and
  dtypes; its program runs once on the CPU at 450x800 and gives finite
  detections of the expected shapes; the default device needs a card.
- The real-config stage (vgg_small, duplo thresholds, kernels on, remat,
  bf16) at a small bucket over 2 gloo processes equals one process on the
  whole batch at the bf16 tolerances of ``dryrun_real_config`` (metrics
  rtol 1e-6; gradients within 1e-6 + 2^-6 of each tensor's largest
  magnitude; statistics atol 1e-6; parameters where the gradient is past
  its tolerance). With a short budget the stage is skipped with the JAX
  one's note.
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

from frcnn_tpu_torch import entry as tentry
from frcnn_tpu_torch.parallel import dryrun

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_entry():
    """``__graft_entry__.entry()`` with the config it builds captured (its
    weights not initialised: ``init_params`` and ``build_detect_fn``
    stand-ins keep the config)."""
    import frcnn_tpu.detect.detector as jdet
    import frcnn_tpu.models.factory as jfac

    mp = pytest.MonkeyPatch()
    mp.setattr(jfac, "init_params", lambda cfg, key: (None, None))
    mp.setattr(jdet, "build_detect_fn", lambda cfg, *a, **k: cfg)
    try:
        cfg, args = graft.entry()
    finally:
        mp.undo()
    return cfg, args


def test_entry_config_equals_jax(jax_entry):
    want, _ = jax_entry
    assert json.loads(tentry.entry_config().to_json()) == \
        json.loads(want.to_json())


def test_entry_runs_on_the_cpu_with_the_jax_arguments(jax_entry):
    _, (_, _, images, true_hw) = jax_entry
    fn, args = tentry.entry(device="cpu")
    assert len(args) == 2
    for got, want in zip(args, (images, true_hw)):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        assert got.device.type == "cpu"
    out = fn(*args)
    D = tentry.entry_config().shapes.max_detections
    assert out.boxes.shape == (2, D, 4) and out.valid.shape == (2, D)
    for f in ("boxes", "confidence", "proposals"):
        assert torch.isfinite(getattr(out, f)).all(), f


def test_entry_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tentry.entry()


def test_entry_reexports_dryrun_multichip():
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip


def test_real_config_is_the_jax_stage(monkeypatch):
    """vgg_small, duplo thresholds, kernels, remat, bf16 at 224x800, or
    450x800 with FRCNN_DRYRUN_FULL=1; images_per_step max(n, 2)."""
    monkeypatch.delenv("FRCNN_DRYRUN_FULL", raising=False)
    cfg = dryrun.real_config(1)
    assert cfg.shapes.image_hw == (224, 800)
    assert cfg.shapes.images_per_step == 2
    assert (cfg.pallas_mode, cfg.remat, cfg.compute_dtype) == \
        ("on", True, "bfloat16")
    assert cfg.model.name == "vgg_small" and cfg.class_count == 16
    monkeypatch.setenv("FRCNN_DRYRUN_FULL", "1")
    assert dryrun.real_config(4).shapes.image_hw == (450, 800)
    assert dryrun.real_config(4).shapes.images_per_step == 4
    b = dryrun.real_batch(dryrun.real_config(2, (224, 800)))
    assert b.gt_boxes[0, :2].tolist() == [[80, 60, 280, 200],
                                          [400, 90, 560, 180]]
    assert b.gt_mask.sum() == 4 and not b.is_background.any()


def test_real_stage_over_two_processes_equals_one(capsys):
    metrics = dryrun.dryrun_real_config(2, hw=(128, 160))
    assert metrics["cls_count"] > 0 and metrics["skipped"] == 0
    assert ("dryrun_multichip(2) REAL CONFIG ok (vgg_small 128x160, "
            "kernels on, plain versions run (CPU tensors)"
            in capsys.readouterr().out)


def test_real_stage_is_skipped_when_the_budget_is_short(monkeypatch,
                                                        capsys):
    monkeypatch.setenv("FRCNN_DRYRUN_BUDGET_S", "100")
    monkeypatch.setenv("FRCNN_DRYRUN_REAL_EST_S", "170")
    monkeypatch.delenv("FRCNN_DRYRUN_FULL", raising=False)
    monkeypatch.setattr(dryrun, "dryrun_real_config",
                        lambda n: pytest.fail("the stage ran"))
    assert dryrun.real_stage(2, time.time()) is False
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): real-config stage SKIPPED" in out
    assert "of the 100s budget (< est. 170s)" in out
