"""Weights bridge between the JAX package's flax trees and the port's
module state dicts, both ways.

Mappings: conv kernels HWIO <-> OIHW; Dense kernels (in, out) <-> Linear
weights (out, in); each PReLU's single (1,) slope; MaskedBatchNorm scale
and bias in ``params``, mean and var in ``batch_stats``. Block 0's
convolution keeps its OIHW place in the pnet state; the block0 kernel's
[27, F] layout is derived from it by
``ops/block0_kernel.py::block0_weights`` when a ``Detector`` is built.

Trees of parameter shape (gradients, optimizer moments) map through
:func:`to_jax_tree` / :func:`from_jax_tree`, keyed by the port's flat names
``"pnet.<name>"`` / ``"cnet.<name>"``; :func:`flax_order` gives those names
in flax's leaf order (sorted keys at every level), the order of the
optimizer state in a checkpoint.

The int8 weights need no bridge: ``models/quant.py::quantize_pnet`` gives
the JAX package's int8 weights and scales bit for bit from the same
float32 weights. Calibrated activation scales do:
:func:`act_scales_from_jax`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from frcnn_tpu_torch.config import Config


class _Entry(NamedTuple):
    net: str             # "pnet" | "cnet"
    name: str            # state-dict name in that module
    path: Tuple[str, ...]  # flax path below params (or batch_stats)/net
    layout: str          # "conv" | "dense" | "vec"
    stat: bool = False   # a batch_stats leaf (else params)

    @property
    def key(self) -> str:
        return f"{self.net}.{self.name}"


def _entries(cfg: Config) -> List[_Entry]:
    out: List[_Entry] = []

    def conv(name):
        out.append(_Entry("pnet", f"{name}.weight", (name, "kernel"), "conv"))
        out.append(_Entry("pnet", f"{name}.bias", (name, "bias"), "vec"))

    def slope(net, name):
        out.append(_Entry(net, f"{name}.weight", (name, "slope"), "vec"))

    def dense(name):
        out.append(_Entry("cnet", f"{name}.weight", (name, "kernel"),
                          "dense"))
        out.append(_Entry("cnet", f"{name}.bias", (name, "bias"), "vec"))

    for bi, spec in enumerate(cfg.model.layers):
        for si in range(spec.conv_steps):
            conv(f"block{bi}_conv{si}")
            slope("pnet", f"block{bi}_prelu{si}")
    for ai in range(len(cfg.model.anchor_nets)):
        conv(f"anchor{ai}_conv")
        slope("pnet", f"anchor{ai}_prelu")
        conv(f"anchor{ai}_out")
    for li, spec in enumerate(cfg.model.class_layers):
        dense(f"fc{li}")
        if spec.batch_norm:
            bn = f"bn{li}"
            out.append(_Entry("cnet", f"{bn}.weight", (bn, "scale"), "vec"))
            out.append(_Entry("cnet", f"{bn}.bias", (bn, "bias"), "vec"))
            out.append(_Entry("cnet", f"{bn}.running_mean", (bn, "mean"),
                              "vec", True))
            out.append(_Entry("cnet", f"{bn}.running_var", (bn, "var"),
                              "vec", True))
        slope("cnet", f"prelu{li}")
    dense("reg_head")
    dense("cls_head")
    return out


def _to_torch(layout: str, a) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if layout == "conv":
        return t.permute(3, 2, 0, 1).contiguous()
    if layout == "dense":
        return t.t().contiguous()
    return t.reshape(-1)


def _to_flax(layout: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    if layout == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if layout == "dense":
        return np.ascontiguousarray(a.T)
    return a.copy()


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def from_jax_params(params, batch_stats, cfg: Config) -> Dict[str, Dict]:
    """numpy (or array-like) flax trees {'pnet', 'cnet'} -> {'pnet': state
    dict of ProposalNet, 'cnet': state dict of ClassificationNet}."""
    out: Dict[str, Dict] = {"pnet": {}, "cnet": {}}
    for e in _entries(cfg):
        tree = batch_stats if e.stat else params
        out[e.net][e.name] = _to_torch(e.layout, _get(tree[e.net], e.path))
    return out


def to_jax_params(pnet_state, cnet_state, cfg: Config):
    """The port's state dicts -> (params, batch_stats) flax trees of numpy
    float32 arrays, as the JAX package's ``init_params`` lays them out."""
    params: dict = {"pnet": {}, "cnet": {}}
    stats: dict = {"cnet": {}}
    states = {"pnet": pnet_state, "cnet": cnet_state}
    for e in _entries(cfg):
        tree = stats if e.stat else params
        _put(tree, (e.net, *e.path), _to_flax(e.layout,
                                              states[e.net][e.name]))
    return params, stats


def to_jax_tree(named: Dict[str, torch.Tensor], cfg: Config) -> dict:
    """Parameter-shaped tensors keyed by the port's flat names (gradients,
    optimizer moments) -> a flax params-shaped tree of numpy arrays."""
    tree: dict = {}
    for e in _entries(cfg):
        if not e.stat:
            _put(tree, (e.net, *e.path), _to_flax(e.layout, named[e.key]))
    return tree


def from_jax_tree(tree, cfg: Config) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`to_jax_tree`: float32 CPU tensors by flat name."""
    return {e.key: _to_torch(e.layout, _get(tree, (e.net, *e.path)))
            for e in _entries(cfg) if not e.stat}


def flax_order(cfg: Config) -> List[str]:
    """The port's flat parameter names in flax's leaf order."""
    ps = [e for e in _entries(cfg) if not e.stat]
    return [e.key for e in sorted(ps, key=lambda e: (e.net, *e.path))]


def flax_layout(cfg: Config, key: str, t: torch.Tensor) -> np.ndarray:
    """One parameter-shaped tensor (flat name ``key``) in flax layout."""
    return _to_flax(_layout_of(cfg)[key], t)


def port_layout(cfg: Config, key: str, a) -> torch.Tensor:
    """One flax-layout array of the parameter ``key`` in the port's layout
    (a float32 CPU tensor)."""
    return _to_torch(_layout_of(cfg)[key], a)


def _layout_of(cfg: Config) -> Dict[str, str]:
    return {e.key: e.layout for e in _entries(cfg) if not e.stat}


def act_scales_from_jax(act_scales) -> Dict[str, torch.Tensor]:
    """A JAX ``act_scales`` dict ({conv name: float32 scalar}, numpy or
    JAX) -> the port's scale dict of float32 0-dim CPU tensors, bit for
    bit (``models/quant.py::QuantizedPNet.set_act_scales`` moves them)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32).reshape(()))
            for k, v in act_scales.items()}
