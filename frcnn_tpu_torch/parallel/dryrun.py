"""The port's counterpart of ``__graft_entry__.py::dryrun_multichip``: one
full data-parallel train step (loss, gradients, RMSprop update, batch-norm
statistics) over ``n`` gloo processes on the CPU, on a tiny config, held
against the same step in one process on the whole batch; then one batch
through a :class:`ShardedDetector` of ``n`` replicas against a
:class:`Detector`; then, if the time budget leaves room for it, the real-
config stage (:func:`dryrun_real_config`): one data-parallel step of
vgg_small with the duplo thresholds at 224x800, the kernels on and remat.

    python -m frcnn_tpu_torch.parallel.dryrun 2

The budget is the JAX one's, from the same environment variables:
``FRCNN_DRYRUN_BUDGET_S`` (default 300 s) for the whole run,
``FRCNN_DRYRUN_REAL_EST_S`` (default 170 s) for the real stage, which is
skipped with a note when less than that is left; ``FRCNN_DRYRUN_FULL=1``
runs it at 450x800 whatever the budget.

:func:`run_data_parallel` is the reusable part: it starts the processes
(``spawn``), joins each to a gloo group at a free localhost port, runs
``Trainer.run_step`` on the same whole batch in each, and returns every
process's metrics, parameters and statistics.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from frcnn_tpu_torch.config import (
    AnchorNetSpec,
    ClassLayerSpec,
    Config,
    LayerSpec,
    ModelConfig,
    StaticShapeConfig,
    duplo_config,
)
from frcnn_tpu_torch.train.objective import TrainBatch

JOIN_S = 300.0
REAL_HW = (224, 800)       # the real stage's bucket
FULL_HW = (450, 800)       # ... with FRCNN_DRYRUN_FULL=1
METRIC_KEYS = ("pcls", "preg", "dcls", "dreg", "loss", "cls_count",
               "reg_count", "skipped")


def tiny_config(images_per_step: int) -> Config:
    """The tiny config of ``__graft_entry__.py::_tiny_cfg``."""
    model = ModelConfig(
        name="tiny",
        layers=(LayerSpec(filters=8, conv_steps=1),
                LayerSpec(filters=16, conv_steps=1),
                LayerSpec(filters=24, conv_steps=1),
                LayerSpec(filters=32, conv_steps=1)),
        anchor_nets=(AnchorNetSpec(kW=3, n=32, input=3),
                     AnchorNetSpec(kW=3, n=32, input=4),
                     AnchorNetSpec(kW=5, n=32, input=4),
                     AnchorNetSpec(kW=7, n=32, input=4)),
        class_layers=(ClassLayerSpec(n=64, dropout=0.5, batch_norm=True),
                      ClassLayerSpec(n=32, dropout=0.5)),
    )
    return Config(
        class_count=3, scales=(16, 32, 64, 96), model=model,
        shapes=StaticShapeConfig(
            image_hw=(128, 160), images_per_step=images_per_step, max_gt=4,
            max_positives=16, max_negatives=8, max_nearby=16,
            max_proposals=64, max_detections=16),
        compute_dtype="float32",
    )


def tiny_batch(cfg: Config, seed: int = 0) -> TrainBatch:
    """A seeded numpy batch: noise images, one or two gt boxes per image,
    and the last image a background-only slot, so that the processes of a
    data-parallel step hold different example counts."""
    B = cfg.shapes.images_per_step
    H, W = cfg.shapes.image_hw
    G = cfg.shapes.max_gt
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, G, 4), np.float32)
    gt[:, 0] = [40, 40, 90, 80]
    gt[::2, 1] = [10, 70, 60, 120]
    mask = np.zeros((B, G), bool)
    mask[:, 0] = True
    mask[::2, 1] = True
    background = np.zeros(B, bool)
    background[-1] = True
    mask[-1] = False
    return TrainBatch(
        image=rng.normal(0.3, 0.2, size=(B, H, W, 3)).astype(np.float32),
        true_hw=np.tile(np.array([[H, W]], np.int32), (B, 1)),
        gt_boxes=gt,
        gt_classes=(np.arange(B * G, dtype=np.int32).reshape(B, G)
                    % cfg.class_count),
        gt_mask=mask,
        is_background=background,
    )


def real_config(n_devices: int, hw=None) -> Config:
    """The real stage's config (``__graft_entry__.py:257-270``): vgg_small
    with the duplo thresholds, bf16 compute, the kernels on
    (``pallas_mode="on"``; their plain versions on CPU tensors), remat,
    ``max(n_devices, 2)`` images per step, at ``hw``: by default 224x800,
    450x800 with ``FRCNN_DRYRUN_FULL=1``."""
    if hw is None:
        hw = FULL_HW if os.environ.get("FRCNN_DRYRUN_FULL") == "1" \
            else REAL_HW
    cfg = duplo_config()
    return cfg.replace(
        shapes=dataclasses.replace(cfg.shapes, image_hw=tuple(hw),
                                   images_per_step=max(n_devices, 2)),
        pallas_mode="on", remat=True)


def real_batch(cfg: Config, seed: int = 1) -> TrainBatch:
    """The real stage's seeded batch (``__graft_entry__.py:272-291``): two
    gt boxes per image, given at 224x800 and scaled down to a smaller
    bucket, classes ``arange(G) % class_count``."""
    B = cfg.shapes.images_per_step
    H, W = cfg.shapes.image_hw
    G = cfg.shapes.max_gt
    rng = np.random.default_rng(seed)
    sx, sy = min(1.0, W / REAL_HW[1]), min(1.0, H / REAL_HW[0])
    gt = np.zeros((B, G, 4), np.float32)
    gt[:, 0] = np.array([80, 60, 280, 200]) * [sx, sy, sx, sy]
    gt[:, 1] = np.array([400, 90, 560, 180]) * [sx, sy, sx, sy]
    mask = np.zeros((B, G), bool)
    mask[:, :2] = True
    return TrainBatch(
        image=rng.normal(0.3, 0.2, size=(B, H, W, 3)).astype(np.float32),
        true_hw=np.tile(np.array([[H, W]], np.int32), (B, 1)),
        gt_boxes=gt,
        gt_classes=np.stack([np.arange(G, dtype=np.int32)
                             % cfg.class_count] * B),
        gt_mask=mask,
        is_background=np.zeros((B,), bool),
    )


def _step(tr, batch):
    """``Trainer.run_step``'s update, keeping the gradients it applied:
    ``(metrics, grads)``."""
    _, (new_bs, metrics), grads = tr.compute_gradients(batch)
    metrics = dict(metrics, skipped=tr.apply_gradients(grads, new_bs))
    return {k: float(metrics[k]) for k in METRIC_KEYS}, grads


def _numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _worker(rank: int, n: int, port: int, cfg: Config, batch: TrainBatch,
            seed: int, out) -> None:
    from frcnn_tpu_torch.parallel.mesh import batch_shard
    from frcnn_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    try:
        tr = Trainer(cfg, device="cpu", seed=seed, shard=batch_shard())
        m, grads = _step(tr, batch)
        # numpy, not tensors: a tensor sent through a queue lives in the
        # sender's shared memory, gone once it exits
        out.put((rank, m, [_numpy(t) for t in (grads, tr.params,
                                                tr.batch_stats)]))
    except Exception as e:     # reported to the parent, which raises
        out.put((rank, repr(e), None))
    finally:
        dist.destroy_process_group()


def run_data_parallel(cfg: Config, batch: TrainBatch, n: int,
                      seed: int = 0) -> list:
    """One data-parallel train step of the whole ``batch`` over ``n`` gloo
    processes on the CPU. Returns ``[(metrics, grads, params,
    batch_stats)]`` by rank: the summed gradients that the step applied,
    and the state after it."""
    from frcnn_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, n, port, cfg, batch, seed, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(n):     # drain before joining
            rank, m, trees = out.get(timeout=JOIN_S)
            if trees is None:
                raise RuntimeError(f"data-parallel rank {rank} failed: {m}")
            results[rank] = (m, *[{k: torch.from_numpy(v)
                                   for k, v in t.items()} for t in trees])
    except queue.Empty:
        raise RuntimeError(f"data-parallel step: no result within "
                           f"{JOIN_S:.0f} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]


def check_against_single(cfg: Config, batch: TrainBatch, results: list,
                         seed: int = 0, rtol: float = 1e-6,
                         atol: float = 1e-6, noise_floor: float = 1e-5,
                         grad_rel: float = 1e-4):
    """Holds every process's step against one process's step on the whole
    batch: metrics within ``rtol``; the summed gradients within ``atol`` +
    ``grad_rel`` (1e-4, the ``[train]`` tolerance) of each tensor's
    largest magnitude (a convolution's backward over one image and over
    two sums in another order); the new batch-norm statistics and the
    updated parameters within ``atol``.

    The parameters are held where the single-process gradient is at least
    ``noise_floor``. Below it a gradient is float32 rounding of a zero
    (summed in another order it takes another rounding, as the gradient
    check allows), and RMSprop's first update, ``lr * g / (sqrt(0.1 g^2) +
    1e-8)``, turns such a value into an update of up to ``lr * sqrt(10)``
    whose size depends on that rounding. ``noise_floor=None``: each
    tensor's floor is its gradient tolerance (a gradient within it may
    take either sign). Returns the single-process trainer, its metrics and
    the count of parameters not held."""
    from frcnn_tpu_torch.train.trainer import Trainer

    one = Trainer(cfg, device="cpu", seed=seed)
    # with the workers' one thread: a convolution blocked for another
    # thread count sums in another order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, want_g = _step(one, batch)
    finally:
        torch.set_num_threads(threads)
    unheld = 0
    for rank, (m, grads, params, stats) in enumerate(results):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(m[k], want[k], rtol=rtol, atol=0,
                                       err_msg=f"rank {rank}: {k}")
        for what, tree, ref, rel in (
                ("gradient", grads, want_g, grad_rel),
                ("statistic", stats, one.batch_stats, 0.0)):
            assert tree.keys() == ref.keys()
            for k, v in tree.items():
                torch.testing.assert_close(
                    v, ref[k], rtol=0,
                    atol=atol + rel * float(ref[k].abs().max()),
                    msg=lambda s, k=k, w=what: f"rank {rank}: {w} {k}: {s}")
        assert params.keys() == one.params.keys()
        for k, v in params.items():
            floor = (atol + grad_rel * float(want_g[k].abs().max())
                     if noise_floor is None else noise_floor)
            held = want_g[k].abs() >= floor
            unheld += int((~held).sum()) if rank == 0 else 0
            torch.testing.assert_close(
                v[held], one.params[k][held], rtol=0, atol=atol,
                msg=lambda s, k=k: f"rank {rank}: parameter {k}: {s}")
    return one, want, unheld


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel train step over ``n_devices`` gloo processes on
    the tiny config, held against one process; then a sharded detect of
    the same batch over ``n_devices`` CPU replicas against one Detector;
    then the real stage where the budget allows (:func:`real_stage`)."""
    t0 = time.time()
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.models.factory import models_from_state_dicts
    from frcnn_tpu_torch.parallel.serving import ShardedDetector

    cfg = tiny_config(max(n_devices, 2))
    batch = tiny_batch(cfg)
    results = run_data_parallel(cfg, batch, n_devices)
    one, want, unheld = check_against_single(cfg, batch, results)
    print(f"dryrun_multichip({n_devices}) train ok: every process's step "
          f"== one process on the whole batch (metrics rtol 1e-6; gradients "
          f"atol 1e-6 + 1e-4 of each tensor's largest; statistics and "
          f"parameters atol 1e-6, {unheld} parameters with a gradient under "
          f"1e-5 not held): {want}", flush=True)

    pnet, cnet = models_from_state_dicts(cfg, one.state_dicts())
    sharded = ShardedDetector(cfg, pnet, cnet, devices=["cpu"] * n_devices)
    got = sharded.detect(batch.image, batch.true_hw)
    ref = Detector(cfg, pnet, cnet, device="cpu").detect(batch.image,
                                                         batch.true_hw)
    for f in ref._fields:
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   rtol=1e-5, atol=1e-4, msg=f)
    print(f"dryrun_multichip({n_devices}) detect ok: "
          f"{int(got.valid.sum())} detections over "
          f"{cfg.shapes.images_per_step} images on {n_devices} replicas "
          f"== one Detector", flush=True)
    real_stage(n_devices, t0)


def real_stage(n_devices: int, t0: float) -> bool:
    """Runs :func:`dryrun_real_config` if it plausibly fits what is left
    of the budget of a run started at ``t0`` (``time.time()``), or always
    with ``FRCNN_DRYRUN_FULL=1``; else prints the JAX one's skip note.
    Returns whether it ran."""
    budget = float(os.environ.get("FRCNN_DRYRUN_BUDGET_S", "300"))
    est = float(os.environ.get("FRCNN_DRYRUN_REAL_EST_S", "170"))
    elapsed = time.time() - t0
    remaining = budget - elapsed
    if os.environ.get("FRCNN_DRYRUN_FULL") == "1" or remaining >= est:
        dryrun_real_config(n_devices)
        return True
    print(
        f"dryrun_multichip({n_devices}): real-config stage SKIPPED — "
        f"tiny stage took {elapsed:.0f}s, leaving {remaining:.0f}s of the "
        f"{budget:.0f}s budget (< est. {est:.0f}s). Raise "
        f"FRCNN_DRYRUN_BUDGET_S or set FRCNN_DRYRUN_FULL=1 to force.",
        flush=True,
    )
    return False


def dryrun_real_config(n_devices: int, device: str = "cpu",
                       hw=None) -> dict:
    """The real stage (``__graft_entry__.py::_dryrun_real_config``): one
    data-parallel train step of :func:`real_config` on :func:`real_batch`.

    ``device="cpu"``: over ``n_devices`` gloo processes, held against one
    process on the whole batch (:func:`check_against_single`). The
    processes hold CPU tensors, so the kernels' wrappers run their plain
    versions there: this checks the configuration's data-parallel step,
    not the kernels (the JAX stage runs the Pallas bodies in interpret
    mode). The step computes in bf16: each process's
    convolution backward rounds its images' gradient to bf16 (8
    significant bits) before the float32 sum over the processes, where
    one process rounds the whole batch's once; so the gradients are held
    within 2^-6 of each tensor's largest magnitude, and the parameters
    where a gradient is past that (RMSprop's first update follows the
    gradient's sign). ``device="cuda"``: this process is one rank of the
    caller's ``torch.distributed`` group of ``n_devices`` processes, one
    card each; the step's metrics must be finite, as in the JAX stage.
    Returns the metrics."""
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY
    from frcnn_tpu_torch.parallel.mesh import batch_shard
    from frcnn_tpu_torch.train.trainer import Trainer

    cfg = real_config(n_devices, hw)
    batch = real_batch(cfg)
    H, W = cfg.shapes.image_hw
    t0 = time.time()
    if torch.device(device).type == "cpu":
        results = run_data_parallel(cfg, batch, n_devices)
        _, metrics, _ = check_against_single(cfg, batch, results,
                                             grad_rel=2.0 ** -6,
                                             noise_floor=None)
        how = f"{n_devices} gloo processes == one process"
        ran = "kernels on, plain versions run (CPU tensors)"
    else:
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the process group has "
                             f"{dist.get_world_size()} ranks, not "
                             f"{n_devices}")
        before = {n: k.launches for n, k in REGISTRY.items()}
        tr = Trainer(cfg, device=device, seed=0, shard=batch_shard())
        metrics = {k: v for k, v in tr.run_step(batch).items()
                   if k in METRIC_KEYS}
        how = f"rank {dist.get_rank()} of {n_devices} on {device}"
        launched = {n: k.launches - before.get(n, 0)
                    for n, k in REGISTRY.items()}
        ran = "kernels launched: " + (", ".join(
            f"{n} x{c}" for n, c in launched.items() if c) or "none")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"real-config step not finite: {metrics}")
    print(f"dryrun_multichip({n_devices}) REAL CONFIG ok (vgg_small {H}x{W}, "
          f"{ran}, remat, {how}, {time.time() - t0:.0f}s): {metrics}",
          flush=True)
    return metrics


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
