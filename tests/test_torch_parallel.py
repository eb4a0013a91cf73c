"""Data parallelism in the port (``parallel/``) on the CPU over gloo.

- A data-parallel step of 4 processes (and of 2, ``dryrun_multichip(2)``)
  equals one process's step on the whole batch (``parallel/dryrun.py::check_against_single``):
  metrics (the losses and counts) rtol 1e-6; the summed gradients within
  1e-6 + 1e-4 of each tensor's largest magnitude (the train tests'
  tolerance: a convolution's backward over part of the batch sums in
  another order); batch-norm statistics and updated parameters atol 1e-6,
  the parameters where the single-process gradient is at least 1e-5 (below
  it a gradient is float32 rounding of a zero, which RMSprop's first
  update turns into a step of up to lr * sqrt(10)). Dropout is on in pnet
  and cnet, and the labels are drawn: every process draws the whole
  batch's noise and masks and keeps its rows. The last image of the batch
  is background-only, so the processes hold different example counts, and
  a mean of per-process normalized losses (a plain DDP mean) differs from
  the whole batch's loss, as the last test shows.
- ``ShardedDetector`` equals ``Detector`` and rejects an indivisible batch.
- ``dryrun_multichip(2)`` passes (its budget-gated real-config stage
  skipped here).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.geometry import matching as M
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
from frcnn_tpu_torch.models.factory import init_models
from frcnn_tpu_torch.parallel import dryrun
from frcnn_tpu_torch.parallel import mesh
from frcnn_tpu_torch.parallel.mesh import batch_rows
from frcnn_tpu_torch.parallel.serving import ShardedDetector
from frcnn_tpu_torch.train.objective import (
    AnchorTables,
    BatchShard,
    LabeledExamples,
    label_batch,
)
from frcnn_tpu_torch.train.trainer import Trainer
from tests.tiny import tiny_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers that run side by side would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n: int, **kw) -> Config:
    cfg = Config.from_json(tiny_config().to_json()).replace(**kw)
    return cfg.replace(shapes=dataclasses.replace(cfg.shapes,
                                                  images_per_step=n))


@pytest.mark.parametrize("n", [4])
def test_data_parallel_step_equals_one_process(n):
    cfg = _cfg(n, pallas_mode="on")
    assert any(s.dropout > 0 for s in cfg.model.layers)
    batch = dryrun.tiny_batch(cfg, seed=n)
    assert batch.is_background[-1] and not batch.is_background[0]
    results = dryrun.run_data_parallel(cfg, batch, n, seed=3)
    _, want, _ = dryrun.check_against_single(cfg, batch, results, seed=3)
    assert want["skipped"] == 0.0 and want["reg_count"] > 0


def test_a_plain_ddp_mean_differs_on_the_batch():
    """Each half of the batch normalized by its own counts: their mean is
    not the whole batch's loss (the background half holds fewer
    examples)."""
    cfg = _cfg(2)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model,
        layers=tuple(dataclasses.replace(s, dropout=0.0)
                     for s in cfg.model.layers),
        class_layers=tuple(dataclasses.replace(s, dropout=0.0)
                           for s in cfg.model.class_layers)))
    batch = dryrun.tiny_batch(cfg).to("cpu")
    gen = AnchorGenerator(cfg)
    g = torch.Generator().manual_seed(5)
    noise = [M.gumbel((2, gen.num_anchors), g) for _ in range(2)]
    labels = label_batch(cfg, gen, AnchorTables.of(gen, "cpu"), batch,
                         *noise)
    tr = Trainer(cfg, device="cpu", seed=0)
    whole = tr.compute_gradients(batch, labels)[1][1]
    halves = []
    for r in range(2):
        rows = batch_rows(2, r, 2)
        part = batch.__class__(*[x[rows] for x in batch])
        lab = LabeledExamples(*[x[rows] for x in labels])
        halves.append(tr.compute_gradients(part, lab)[1][1])
    counts = [float(h["cls_count"]) for h in halves]
    assert counts[0] != counts[1]
    assert sum(counts) == float(whole["cls_count"])
    mean = sum(float(h["pcls"]) for h in halves) / 2
    assert abs(mean - float(whole["pcls"])) > 1e-2 * float(whole["pcls"])


def test_batch_rows_rejects_an_indivisible_batch():
    assert batch_rows(8, 3, 4) == slice(6, 8)
    with pytest.raises(ValueError, match="divide"):
        batch_rows(6, 0, 4)
    with pytest.raises(ValueError, match="divide"):
        Trainer(_cfg(3), device="cpu",
                shard=BatchShard(0, 2, lambda t: t))


def test_process_group_helpers(monkeypatch):
    """Outside a group: rank 0 of 1; ``init_from_env`` joins the group the
    environment describes (here gloo, one process), whose ``batch_shard``
    sums over it."""
    assert (mesh.rank(), mesh.world_size()) == (0, 1)
    assert mesh.local_device("cpu") == torch.device("cpu")
    for k, v in (("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(mesh.free_port())),
                 ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    mesh.init_from_env("gloo")
    try:
        assert (mesh.rank(), mesh.world_size()) == (0, 1)
        shard = mesh.batch_shard()
        assert shard[:2] == (0, 1)
        t = torch.arange(3.0)
        assert torch.equal(shard.all_reduce(t), t)
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.local_device()


@pytest.fixture(scope="module")
def models():
    """Seeded tiny models with the anchor heads' fg logits and the
    classifier biased as ``tests/test_torch_detect.py::_mild_fg_params``
    biases them, so that detections pass the gates."""
    cfg = _cfg(2)
    pnet, cnet = init_models(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        cnet.cls_head.bias[-1] -= 2.0
        for ai in range(4):
            out = getattr(pnet, f"anchor{ai}_out")
            out.bias[0::6] += 3.5
            out.weight *= 0.3
    return cfg, (pnet, cnet)


def test_sharded_detector_equals_detector(models):
    cfg, (pnet, cnet) = models
    H, W = cfg.shapes.image_hw
    rng = np.random.default_rng(0)
    imgs = rng.normal(0.3, 0.2, (4, H, W, 3)).astype(np.float32)
    hw = np.tile(np.asarray([[H, W]], np.int32), (4, 1))
    hw[1] = [100, 130]
    want = Detector(cfg, pnet, cnet, device="cpu").detect(imgs, hw)
    sharded = ShardedDetector(cfg, pnet, cnet, devices=["cpu", "cpu"])
    got = sharded.detect(imgs, hw)
    assert int(want.valid.sum()) > 0
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="divide"):
        sharded.detect(imgs[:3], hw[:3])


def test_dryrun_multichip_2(capsys, monkeypatch):
    """The tiny and detect stages; the real-config stage is skipped by a
    budget of 0 s (it has its own test in ``tests/test_torch_entry.py``)."""
    monkeypatch.setenv("FRCNN_DRYRUN_BUDGET_S", "0")
    monkeypatch.delenv("FRCNN_DRYRUN_FULL", raising=False)
    dryrun.dryrun_multichip(2)
    out = capsys.readouterr().out
    assert "dryrun_multichip(2) train ok" in out
    assert "dryrun_multichip(2) detect ok" in out
    assert "dryrun_multichip(2): real-config stage SKIPPED" in out
