"""Model construction (the JAX package's ``models/factory.py``): pnet and
cnet from the declarative config, with a seeded initialisation that
follows the reference's scheme."""

from __future__ import annotations

import copy
import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.models.cnet import ClassificationNet
from frcnn_tpu_torch.models.layers import MaskedBatchNorm
from frcnn_tpu_torch.models.pnet import ProposalNet


def compute_dtype(cfg: Config) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg.compute_dtype]


def cnet_input_dim(cfg: Config) -> int:
    return (cfg.roi_pooling.kh * cfg.roi_pooling.kw
            * cfg.model.layers[-1].filters)


COMPUTE_MODULES = (nn.Conv2d, nn.Linear, nn.PReLU)


def create_models(cfg: Config, pool_vjp: str = "library"
                  ) -> Tuple[ProposalNet, ClassificationNet]:
    """pnet and cnet in eval mode and float32, their weights not yet
    initialised (load a state dict, or use :func:`init_models`).
    ``pool_vjp``: the backward of pnet's pools ("library" or "kernel", see
    ``models/pnet.py``; the JAX package's ``FRCNN_POOL_VJP``)."""
    pnet = ProposalNet(cfg.model, pool_vjp=pool_vjp)
    cnet = ClassificationNet(cfg.model, cfg.num_classes_with_bg,
                             cnet_input_dim(cfg))
    return pnet.eval(), cnet.eval()


def for_compute(module: nn.Module, dtype: torch.dtype, device) -> nn.Module:
    """A copy of ``module`` in eval mode on ``device`` with its conv,
    linear and PReLU parameters cast once to ``dtype``. Batch norm stays
    float32, as in the flax modules; ``module`` itself is left as it is."""
    m = copy.deepcopy(module).to(device).eval()
    for sub in m.modules():
        if isinstance(sub, COMPUTE_MODULES):
            sub.to(dtype)
    return m


def compute_param_names(module: nn.Module) -> frozenset:
    """Names (as in ``named_parameters``) of the conv, linear and PReLU
    parameters of ``module``: those that compute in the compute dtype."""
    return frozenset(
        f"{prefix}.{name}" if prefix else name
        for prefix, sub in module.named_modules()
        if isinstance(sub, COMPUTE_MODULES)
        for name, _ in sub.named_parameters(recurse=False))


def cast_for_compute(params: dict, names: frozenset, dtype) -> dict:
    """``params`` with the entries in ``names`` cast to ``dtype``, the rest
    (batch norm) as they are. The cast is differentiable, so a step that
    computes with the result sends float32 gradients to float32 masters
    (what flax's ``param_dtype=float32, dtype=bfloat16`` does per call)."""
    return {k: v.to(dtype) if k in names else v for k, v in params.items()}


@torch.no_grad()
def init_models(cfg: Config, generator: torch.Generator,
                pool_vjp: str = "library"):
    """Seeded initialisation: convs normal(0, sqrt(2/(kh*kw*out))) (MSRA
    fan-out, ``models/model_utilities.lua:60-71``) with zero bias; linears
    uniform(+-1/sqrt(fan_in)) for weight and bias (torch default); PReLU
    slopes 0.25; batch norm identity. Draws from ``generator`` (CPU)."""
    pnet, cnet = create_models(cfg, pool_vjp)
    for m in [*pnet.modules(), *cnet.modules()]:
        if isinstance(m, torch.nn.PReLU):
            m.weight.fill_(0.25)
    for m in pnet.modules():
        if isinstance(m, torch.nn.Conv2d):
            out_ch, _, kh, kw = m.weight.shape
            std = math.sqrt(2.0 / (kh * kw * out_ch))
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * std)
            m.bias.zero_()
    for m in cnet.modules():
        if isinstance(m, torch.nn.Linear):
            bound = 1.0 / math.sqrt(m.weight.shape[1])
            for p in (m.weight, m.bias):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1)
                        * bound)
        elif isinstance(m, MaskedBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return pnet, cnet


def models_from_state_dicts(cfg: Config, state_dicts: Dict[str, Dict]):
    """pnet and cnet of ``cfg`` (eval mode, float32, on the CPU) with
    ``state_dicts`` loaded: ``{'pnet': ..., 'cnet': ...}``, as
    ``Trainer.state_dicts()`` gives them, so that a ``Detector`` serves a
    trainer's weights without a file."""
    pnet, cnet = create_models(cfg)
    pnet.load_state_dict({k: v.detach().cpu()
                          for k, v in state_dicts["pnet"].items()})
    cnet.load_state_dict({k: v.detach().cpu()
                          for k, v in state_dicts["cnet"].items()})
    return pnet, cnet
