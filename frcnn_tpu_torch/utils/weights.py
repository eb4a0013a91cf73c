"""Weights bridge: the JAX package's flax parameter trees -> the port's
module state dicts.

Mappings: conv kernels HWIO -> OIHW; Dense kernels (in, out) -> Linear
weights (out, in); each PReLU's single (1,) slope; MaskedBatchNorm scale
and bias from ``params``, mean and var from ``batch_stats``. Block 0's
convolution keeps its OIHW place in the pnet state; the block0 kernel's
[27, F] layout is derived from it by
``ops/block0_kernel.py::block0_weights`` when a ``Detector`` is built.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from frcnn_tpu_torch.config import Config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax_params(params, batch_stats, cfg: Config) -> Dict[str, Dict]:
    """numpy (or array-like) flax trees {'pnet', 'cnet'} -> {'pnet': state
    dict of ProposalNet, 'cnet': state dict of ClassificationNet}."""
    p, c = params["pnet"], params["cnet"]
    pnet: Dict[str, torch.Tensor] = {}

    def conv(name):
        pnet[f"{name}.weight"] = _t(p[name]["kernel"]).permute(3, 2, 0, 1) \
            .contiguous()
        pnet[f"{name}.bias"] = _t(p[name]["bias"])

    def slope(state, tree, name):
        state[f"{name}.weight"] = _t(tree[name]["slope"]).reshape(1)

    for bi, spec in enumerate(cfg.model.layers):
        for si in range(spec.conv_steps):
            conv(f"block{bi}_conv{si}")
            slope(pnet, p, f"block{bi}_prelu{si}")
    for ai in range(len(cfg.model.anchor_nets)):
        conv(f"anchor{ai}_conv")
        slope(pnet, p, f"anchor{ai}_prelu")
        conv(f"anchor{ai}_out")

    cnet: Dict[str, torch.Tensor] = {}

    def dense(name):
        cnet[f"{name}.weight"] = _t(c[name]["kernel"]).t().contiguous()
        cnet[f"{name}.bias"] = _t(c[name]["bias"])

    stats = batch_stats.get("cnet", {})
    for li, spec in enumerate(cfg.model.class_layers):
        dense(f"fc{li}")
        if spec.batch_norm:
            bn = f"bn{li}"
            cnet[f"{bn}.weight"] = _t(c[bn]["scale"])
            cnet[f"{bn}.bias"] = _t(c[bn]["bias"])
            cnet[f"{bn}.running_mean"] = _t(stats[bn]["mean"])
            cnet[f"{bn}.running_var"] = _t(stats[bn]["var"])
        slope(cnet, c, f"prelu{li}")
    dense("reg_head")
    dense("cls_head")
    return {"pnet": pnet, "cnet": cnet}
