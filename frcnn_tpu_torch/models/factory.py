"""Model construction (the JAX package's ``models/factory.py``): pnet and
cnet from the declarative config, with a seeded initialisation that
follows the reference's scheme."""

from __future__ import annotations

import copy
import math
from typing import Tuple

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


def create_models(cfg: Config) -> Tuple[ProposalNet, ClassificationNet]:
    """pnet and cnet in eval mode and float32, their weights not yet
    initialised (load a state dict, or use :func:`init_models`)."""
    pnet = ProposalNet(cfg.model)
    cnet = ClassificationNet(cfg.model, cfg.num_classes_with_bg,
                             cnet_input_dim(cfg))
    return pnet.eval(), cnet.eval()


def for_compute(module: nn.Module, dtype: torch.dtype, device) -> nn.Module:
    """A copy of ``module`` in eval mode on ``device`` with its conv,
    linear and PReLU parameters cast once to ``dtype``. Batch norm stays
    float32, as in the flax modules; ``module`` itself is left as it is."""
    m = copy.deepcopy(module).to(device).eval()
    for sub in m.modules():
        if isinstance(sub, (nn.Conv2d, nn.Linear, nn.PReLU)):
            sub.to(dtype)
    return m


@torch.no_grad()
def init_models(cfg: Config, generator: torch.Generator):
    """Seeded initialisation: convs normal(0, sqrt(2/(kh*kw*out))) (MSRA
    fan-out, ``models/model_utilities.lua:60-71``) with zero bias; linears
    uniform(+-1/sqrt(fan_in)) for weight and bias (torch default); PReLU
    slopes 0.25; batch norm identity. Draws from ``generator`` (CPU)."""
    pnet, cnet = create_models(cfg)
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
