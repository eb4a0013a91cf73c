"""Optimizers and the learning-rate schedule, as functions over lists of
tensors with explicit state.

Port of the JAX package's ``train/optim.py``. ``optim.rmsprop`` (the
reference's default, ``main.lua:133``):

  m <- alpha * m + (1 - alpha) * g^2
  p <- p - lr * g / (sqrt(m) + eps)        (eps OUTSIDE the sqrt, 1e-8)

``sgd`` (weight decay 5e-4, momentum 0.9) and ``nag`` are the optax chains
of the JAX package (``add_decayed_weights`` + ``sgd``; ``sgd(nesterov)``).
Schedules: ``halve5k`` halves the lr every 5000 steps (what
``main.lua:127-130`` intends), ``constant`` keeps it (what it does).

An optimizer is ``(init, update)``: ``init(params)`` gives the state,
``update(grads, state, params) -> (updates, new_state)``; parameters add
their updates. The state is a NamedTuple of tensors and per-parameter
tensor lists (nothing is written in place), so a step can choose between
the new and the old state on the device.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch

from frcnn_tpu_torch.config import Config


def lr_schedule(cfg: Config) -> Callable:
    """``schedule(step) -> lr``: a 0-d float32 tensor on the device of the
    0-d integer ``step``."""
    base = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return lambda step: torch.full((), base, dtype=torch.float32,
                                       device=step.device)

    def halve5k(step):
        return base * torch.pow(0.5, torch.floor(step.float() / 5000.0))

    return halve5k


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


class RmsPropState(NamedTuple):
    step: torch.Tensor           # 0-d int32
    m: List[torch.Tensor]


class TraceState(NamedTuple):
    trace: List[torch.Tensor]
    count: torch.Tensor          # 0-d int32, the schedule's step


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def torch_rmsprop(schedule: Callable, alpha: float = 0.9,
                  eps: float = 1e-8) -> Optimizer:
    """torch ``optim.rmsprop`` (eps outside the square root)."""

    def init(params):
        return RmsPropState(step=_step0(params),
                            m=[torch.zeros_like(p) for p in params])

    def update(grads, state, params=None):
        del params
        m = torch._foreach_mul(state.m, alpha)
        torch._foreach_add_(m, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - alpha))
        lr = schedule(state.step)
        updates = torch._foreach_div(
            torch._foreach_mul(grads, -lr),
            torch._foreach_add(torch._foreach_sqrt(m), eps))
        return list(updates), RmsPropState(step=state.step + 1, m=list(m))

    return Optimizer(init, update)


def sgd(schedule: Callable, momentum: float, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    """optax ``add_decayed_weights(weight_decay)`` (if nonzero) followed by
    ``sgd(schedule, momentum, nesterov)``: trace = g + momentum * trace;
    update = -lr * (trace, or g + momentum * trace with Nesterov)."""

    def init(params):
        return TraceState(trace=[torch.zeros_like(p) for p in params],
                          count=_step0(params))

    def update(grads, state, params=None):
        if weight_decay:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(params, weight_decay))
        trace = torch._foreach_add(
            grads, torch._foreach_mul(state.trace, momentum))
        if nesterov:
            upd = torch._foreach_add(grads, torch._foreach_mul(trace,
                                                               momentum))
        else:
            upd = trace
        step_size = -schedule(state.count)
        updates = torch._foreach_mul(upd, step_size)
        return list(updates), TraceState(trace=list(trace),
                                         count=state.count + 1)

    return Optimizer(init, update)


def make_optimizer(cfg: Config) -> Optimizer:
    sched = lr_schedule(cfg)
    if cfg.optimizer == "rmsprop":
        return torch_rmsprop(sched, alpha=cfg.rms_decay)
    if cfg.optimizer == "sgd":
        return sgd(sched, momentum=0.9, weight_decay=5e-4)
    if cfg.optimizer == "nag":
        return sgd(sched, momentum=cfg.rms_decay, nesterov=True)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def state_leaves(state, per_param: Callable) -> list:
    """The state as the flat leaf list of the JAX package's optax state
    (its checkpoint format): fields in order, a per-parameter list
    expanded through ``per_param(list) -> list`` (which puts it in flax
    tree order), a tensor as one leaf."""
    out = []
    for v in state:
        out.extend(per_param(v) if isinstance(v, list) else [v])
    return out


def state_from_leaves(template, leaves: list, per_param: Callable):
    """Inverse of :func:`state_leaves`: a state like ``template`` from
    ``leaves``; ``per_param(list) -> list`` maps a flax-ordered run of
    per-parameter leaves back, and scalar leaves take the template's dtype
    and device."""
    n_lists = sum(isinstance(v, list) for v in template)
    n_params = ((len(leaves) - (len(template) - n_lists)) // n_lists
                if n_lists else 0)
    fields, i = [], 0
    for v in template:
        if isinstance(v, list):
            if n_params != len(v):
                raise ValueError("optimizer state mismatch; cannot restore")
            fields.append(per_param(leaves[i:i + n_params]))
            i += n_params
        else:
            leaf = torch.as_tensor(np.array(leaves[i]))
            fields.append(leaf.to(v.device, v.dtype).reshape(v.shape))
            i += 1
    if i != len(leaves):
        raise ValueError("optimizer state mismatch; cannot restore")
    return type(template)(*fields)
