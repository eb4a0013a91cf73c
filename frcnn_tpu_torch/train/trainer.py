"""Training driver: the train step, loss history and snapshots.

Port of the JAX package's ``train/trainer.py`` (``graph_training``,
``main.lua:103-153``) on one device, or data-parallel over the processes
of a ``torch.distributed`` group (``parallel/mesh.py``), where the JAX
package shards the batch over a device mesh. Its deliberate improvements
over the reference carry over: the optimizer state is checkpointed, the lr
schedule applies, and a step whose update has a non-finite element changes
nothing (parameters, optimizer state and batch-norm statistics), reported as
``metrics["skipped"]``. The step runs eagerly with no host sync inside;
:meth:`Trainer.run_step` fetches its metrics once, :meth:`Trainer.run_chunk`
once for K steps (the same trajectory as K ``run_step`` calls).

Snapshots use the JAX package's checkpoint format, in both directions: its
``load_checkpoint`` reads a snapshot of this trainer, and this trainer
restores one of its ``Trainer``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
from frcnn_tpu_torch.models.factory import init_models
from frcnn_tpu_torch.parallel.mesh import batch_rows
from frcnn_tpu_torch.train.objective import (
    BatchShard,
    TrainBatch,
    build_objective,
    value_and_grad,
)
from frcnn_tpu_torch.train.optim import (
    make_optimizer,
    state_from_leaves,
    state_leaves,
)
from frcnn_tpu_torch.utils import weights
from frcnn_tpu_torch.utils.metrics import MetricsLogger, StepTimer
from frcnn_tpu_torch.utils.serialization import load_checkpoint, save_checkpoint

METRICS = ("pcls", "preg", "dcls", "dreg", "loss", "cls_count", "reg_count",
           "skipped")


@dataclass
class TrainingStats:
    """The four loss series of the reference (``objective.lua:211-214``)."""

    pcls: List[float] = field(default_factory=list)
    preg: List[float] = field(default_factory=list)
    dcls: List[float] = field(default_factory=list)
    dreg: List[float] = field(default_factory=list)

    def append(self, metrics: Dict[str, float]):
        self.pcls.append(float(metrics["pcls"]))
        self.preg.append(float(metrics["preg"]))
        self.dcls.append(float(metrics["dcls"]))
        self.dreg.append(float(metrics["dreg"]))

    def to_dict(self):
        return {"pcls": self.pcls, "preg": self.preg,
                "dcls": self.dcls, "dreg": self.dreg}

    @staticmethod
    def from_dict(d):
        return TrainingStats(
            pcls=list(d.get("pcls", [])), preg=list(d.get("preg", [])),
            dcls=list(d.get("dcls", [])), dreg=list(d.get("dreg", [])))


def _select(ok, new, old):
    """``new`` where the 0-d bool ``ok`` holds, else ``old``, over tensors,
    lists, dicts and NamedTuples of them."""
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, dict):
        return {k: _select(ok, v, old[k]) for k, v in new.items()}
    if hasattr(new, "_fields"):
        return type(new)(*[_select(ok, a, b) for a, b in zip(new, old)])
    return [_select(ok, a, b) for a, b in zip(new, old)]


def _rows(tree, rows: slice):
    """``rows`` of every tensor of a NamedTuple of tensors."""
    return type(tree)(*[x[rows] for x in tree])


class Trainer:
    """Float32 master parameters, the optimizer of ``cfg`` and the
    objective, on one device (CUDA unless ``device`` says otherwise).

    ``seed`` (default ``cfg.seed``) seeds the initialisation (a CPU
    generator) and, plus one, the device generator of the steps' draws
    (labeling noise, dropout masks). ``pool_vjp``: the backward of pnet's
    pools, "library" or "kernel" (``models/pnet.py``); by default the
    kernel when ``cfg.pallas_mode`` turns the kernels on (on the H100 it
    takes a third of the time of ``max_pool2d``'s backward, PERF.md), else
    the library backward.

    ``shard`` (``parallel/mesh.py::batch_shard``): train data-parallel. Every
    process holds the same parameters (same seed) and is given the same
    whole batch; it computes on its rows (``images_per_step`` must divide
    by the world size), the objective sums its sums and counts over the
    processes, the gradients are summed over them, and the skip of a
    non-finite update is decided on every process alike. The step then
    equals the single-process step on the whole batch.
    """

    def __init__(self, cfg: Config, device="cuda", seed: Optional[int] = None,
                 pool_vjp: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 shard: Optional[BatchShard] = None):
        if shard is not None and cfg.shapes.images_per_step % \
                shard.world_size:
            raise ValueError(f"images_per_step {cfg.shapes.images_per_step} "
                             f"does not divide over {shard.world_size} "
                             f"processes")
        self.cfg = cfg
        self.shard = shard
        self.device = torch.device(device)
        self.timer = StepTimer()
        self.metrics_logger = MetricsLogger(metrics_path)
        seed = cfg.seed if seed is None else seed
        if pool_vjp is None:
            pool_vjp = "library" if cfg.pallas_mode == "off" else "kernel"
        pnet, cnet = init_models(cfg, torch.Generator().manual_seed(seed),
                                 pool_vjp)
        self.pnet = pnet.to(self.device)
        self.cnet = cnet.to(self.device)
        self.params = {
            **{f"pnet.{k}": v.detach().clone()
               for k, v in self.pnet.named_parameters()},
            **{f"cnet.{k}": v.detach().clone()
               for k, v in self.cnet.named_parameters()}}
        self.batch_stats = {f"cnet.{k}": v.clone()
                            for k, v in self.cnet.named_buffers()}
        self.names = list(self.params)
        self.tx = make_optimizer(cfg)
        self.opt_state = self.tx.init(list(self.params.values()))
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.step = 0
        self.stats = TrainingStats()
        # one anchor field and objective per bucket, built at first use
        self._objectives = {}

    def objective(self, image_hw):
        """The loss function of one bucket (``train/objective.py``)."""
        hw = tuple(int(x) for x in image_hw)
        if hw not in self._objectives:
            if hw not in {tuple(b) for b in self.cfg.shapes.buckets()}:
                raise ValueError(f"batch bucket {hw} is not a configured "
                                 f"bucket")
            gen = AnchorGenerator(self.cfg, image_hw=hw)
            self._objectives[hw] = build_objective(self.cfg, gen, self.pnet,
                                                   self.cnet,
                                                   shard=self.shard)
        return self._objectives[hw]

    def compute_gradients(self, batch: TrainBatch, labels=None):
        """``(total, (new_batch_stats, metrics), grads)`` of the objective
        at the current parameters; draws from the trainer's generator.
        Data-parallel, ``batch`` (and ``labels``) are the whole batch's;
        ``total`` is this process's share, the rest the whole batch's."""
        batch = batch.to(self.device)
        loss_fn = self.objective(batch.image.shape[1:3])
        if self.shard is None:
            return value_and_grad(loss_fn, self.params, self.batch_stats,
                                  batch, self.generator, labels)
        rows = batch_rows(batch.image.shape[0], self.shard.rank,
                          self.shard.world_size)
        total, aux, grads = value_and_grad(
            loss_fn, self.params, self.batch_stats, _rows(batch, rows),
            self.generator, None if labels is None else _rows(labels, rows))
        flat = self.shard.all_reduce(torch.cat(
            [g.reshape(-1) for g in grads.values()]))
        out = {}
        for k, g in grads.items():
            out[k], flat = flat[:g.numel()].reshape(g.shape), flat[g.numel():]
        return total, aux, out

    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        new_batch_stats: Dict[str, torch.Tensor]):
        """One optimizer update, all or nothing: when any element of the
        update is non-finite, parameters, optimizer state and batch stats
        keep their old values. Returns ``skipped`` (0-d float32, 1.0 when
        skipped) without a host sync."""
        old = [self.params[n] for n in self.names]
        updates, new_opt = self.tx.update([grads[n] for n in self.names],
                                          self.opt_state, old)
        # guard on the update, not the loss: smooth-L1 and log-softmax can
        # give an inf objective with finite gradients, and skipping those
        # steps would freeze the parameters that produce it
        ok = torch.stack([torch.isfinite(u).all() for u in updates]).all()
        if self.shard is not None:
            # the updates agree on every process; the vote makes the
            # decision one even if an update's rounding did not
            ok = self.shard.all_reduce((~ok).to(torch.float32)) == 0
        new_params = torch._foreach_add(old, updates)
        self.params = dict(zip(self.names, _select(ok, new_params, old)))
        self.opt_state = _select(ok, new_opt, self.opt_state)
        self.batch_stats = _select(ok, new_batch_stats, self.batch_stats)
        return (~ok).to(torch.float32)

    def _step(self, batch: TrainBatch) -> Dict[str, torch.Tensor]:
        _, (new_bs, metrics), grads = self.compute_gradients(batch)
        metrics = dict(metrics)
        metrics["skipped"] = self.apply_gradients(grads, new_bs)
        return metrics

    def _record(self, values: List[float], step_time_s: float):
        self.step += 1
        m = dict(zip(METRICS, values))
        m["step_time_s"] = step_time_s
        self.stats.append(m)
        self.metrics_logger.log(self.step, m)
        return m

    def run_step(self, batch: TrainBatch) -> Dict[str, float]:
        """One train step; its metrics reach the host in one copy."""
        self.timer.start()
        m = self._step(batch)
        values = torch.stack([m[k] for k in METRICS]).tolist()
        return self._record(values, self.timer.stop())

    def run_chunk(self, batches: Sequence[TrainBatch]
                  ) -> List[Dict[str, float]]:
        """``len(batches)`` train steps with one metrics copy to the host
        for all of them; the same trajectory as as many :meth:`run_step`
        calls. Returns the per-step metrics (also in stats and the log)."""
        self.timer.start()
        ms = [self._step(b) for b in batches]
        values = torch.stack([torch.stack([m[k] for k in METRICS])
                              for m in ms]).tolist()
        elapsed = self.timer.stop()
        return [self._record(v, elapsed / len(batches)) for v in values]

    # -- weights and checkpoints ---------------------------------------------

    def state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{'pnet': ..., 'cnet': ...} state dicts of the current weights
        (float32; for ``load_state_dict`` of ``create_models``' modules)."""
        flat = {**self.params, **self.batch_stats}
        return {net: {k[len(net) + 1:]: v for k, v in flat.items()
                      if k.startswith(net + ".")} for net in ("pnet", "cnet")}

    def _to_flax_leaves(self, per_param: List[torch.Tensor]) -> list:
        named = dict(zip(self.names, per_param))
        return [weights.flax_layout(self.cfg, k, named[k])
                for k in weights.flax_order(self.cfg)]

    def _from_flax_leaves(self, leaves) -> List[torch.Tensor]:
        named = {k: weights.port_layout(self.cfg, k, a).to(self.device)
                 for k, a in zip(weights.flax_order(self.cfg), leaves)}
        return [named[n] for n in self.names]

    def save_snapshot(self, path: str, options: Optional[dict] = None):
        sd = self.state_dicts()
        params, batch_stats = weights.to_jax_params(sd["pnet"], sd["cnet"],
                                                    self.cfg)
        opt = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
               for x in state_leaves(self.opt_state, self._to_flax_leaves)]
        save_checkpoint(path, params=params, batch_stats=batch_stats,
                        opt_state=opt, step=self.step,
                        stats=self.stats.to_dict(), options=options or {},
                        config_json=self.cfg.to_json())

    def restore_snapshot(self, path: str):
        ckpt = load_checkpoint(path)
        sd = weights.from_jax_params(ckpt["params"], ckpt["batch_stats"],
                                     self.cfg)
        flat = {f"{net}.{k}": v.to(self.device)
                for net, d in sd.items() for k, v in d.items()}
        self.params = {n: flat[n] for n in self.names}
        self.batch_stats = {k: flat[k] for k in self.batch_stats}
        if ckpt.get("opt_state") is not None:
            self.opt_state = state_from_leaves(
                self.opt_state, list(ckpt["opt_state"]),
                self._from_flax_leaves)
        self.step = int(ckpt.get("step", 0))
        # resume the loss history like main.lua:115-117
        self.stats = TrainingStats.from_dict(ckpt.get("stats", {}))
        return ckpt
