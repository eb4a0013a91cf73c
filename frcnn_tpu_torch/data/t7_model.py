"""Reference model-snapshot bridge: Torch7 flat weight vector <-> the
port's state dicts.

The port's copy of the JAX package's ``data/t7_model.py``, on
``{'pnet': state dict, 'cnet': state dict}`` (``Trainer.state_dicts()``,
``models/factory.py::models_from_state_dicts``) instead of flax trees.

The reference persists a trained network as ONE flat float tensor
(``utilities.lua:126-134``: ``save_model`` writes ``{version=0, weights,
options, stats}``; ``main.lua:92-97`` copies it back into the freshly built
nets' flattened parameters). The layout is
``combine_and_flatten_parameters(pnet, cnet)`` (``utilities.lua:136-147``):
``pnet:parameters()`` then ``cnet:parameters()``, each tensor row-major.

The pnet's module order is that of its nngraph ``gModule``, whose
``parameters()`` follow ``fg:topsort()``: per gModule OUTPUT in declaration
order (anchors 1..4, then the feature map), its not-yet-emitted producer
chain, deepest first. For anchor inputs (3, 4, 4, 4) that is b1 b2 b3 a1
b4 a2 a3 a4: ``order='nngraph'``, the default. Two legacy layouts stay
readable: ``blocks_first`` (blocks 1..4, then anchors 1..4) and
``interleaved`` (each anchor right after the block it reads).
``order='auto'`` picks by plausibility: a PReLU's single slope starts at
0.25 and stays in (0, 2) in any sanely trained net, while a misaligned
layout lands those scalars on arbitrary conv weights; ties prefer
``nngraph``. Export uses the same machinery, so import(export(p)) == p for
every order.

The port's conv weights ([out, in, kH, kW]) and Linear weights ([out, in])
are already in Torch's layout. The one permutation: the first cnet Linear
reads the flattened ROI pool, which Torch flattens channel first (c, y, x)
and the port (y, x, c), so fc0's input dimension is permuted.

Not in the file: batch-norm running statistics (Torch's ``parameters()``
holds only learnable tensors). Import keeps the template's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.data.t7 import TorchTensor, load, save

ORDERS = ("nngraph", "blocks_first", "interleaved")


def _pool_perm(kh: int, kw: int, c: int) -> np.ndarray:
    """perm[ours_flat_index] = torch_flat_index of the pooled features:
    ours j = (y * kw + x) * c + ch, Torch t = (ch * kh + y) * kw + x."""
    y, x, ch = np.meshgrid(np.arange(kh), np.arange(kw), np.arange(c),
                           indexing="ij")
    return ((ch * kh + y) * kw + x).reshape(-1)


def _spec_entries(cfg: Config, order: str) -> List[Tuple[str, str, tuple]]:
    """The flat layout: ``[(net, state-dict name, torch shape), ...]`` in
    file order."""
    m = cfg.model
    blocks: List[List[Tuple[str, tuple]]] = []
    in_ch = 3
    for bi, layer in enumerate(m.layers):
        entries = []
        ic = in_ch
        for si in range(layer.conv_steps):
            entries.append((f"block{bi}_conv{si}.weight",
                            (layer.filters, ic, layer.kH, layer.kW)))
            entries.append((f"block{bi}_conv{si}.bias", (layer.filters,)))
            entries.append((f"block{bi}_prelu{si}.weight", (1,)))
            ic = layer.filters
        in_ch = layer.filters
        blocks.append(entries)
    anchors: List[List[Tuple[str, tuple]]] = []
    for ai, a in enumerate(m.anchor_nets):
        src_filters = m.layers[a.input - 1].filters   # a.input is 1-based
        anchors.append([
            (f"anchor{ai}_conv.weight", (a.n, src_filters, a.kW, a.kW)),
            (f"anchor{ai}_conv.bias", (a.n,)),
            (f"anchor{ai}_prelu.weight", (1,)),
            (f"anchor{ai}_out.weight", (18, a.n, 1, 1)),
            (f"anchor{ai}_out.bias", (18,)),
        ])
    pnet: List[Tuple[str, tuple]] = []
    if order == "blocks_first":
        for b in blocks:
            pnet += b
        for a in anchors:
            pnet += a
    elif order == "nngraph":
        # gModule's topsort: per output in declaration order, its
        # not-yet-emitted producer chain deepest first (the conv blocks form
        # one path, so a chain is a block prefix)
        done = 0
        for ai, a in enumerate(m.anchor_nets):
            while done < a.input:
                pnet += blocks[done]
                done += 1
            pnet += anchors[ai]
        while done < len(blocks):        # the feature-map output
            pnet += blocks[done]
            done += 1
    elif order == "interleaved":
        emitted = [False] * len(anchors)
        for bi, b in enumerate(blocks):
            pnet += b
            for ai, a in enumerate(m.anchor_nets):
                if not emitted[ai] and a.input - 1 <= bi:
                    pnet += anchors[ai]
                    emitted[ai] = True
    else:
        raise ValueError(f"unknown order {order!r}")

    cnet: List[Tuple[str, tuple]] = []
    n_in = cfg.roi_pooling.kh * cfg.roi_pooling.kw * m.layers[-1].filters
    for li, spec in enumerate(m.class_layers):
        cnet.append((f"fc{li}.weight", (spec.n, n_in)))
        cnet.append((f"fc{li}.bias", (spec.n,)))
        if spec.batch_norm:
            cnet.append((f"bn{li}.weight", (spec.n,)))
            cnet.append((f"bn{li}.bias", (spec.n,)))
        cnet.append((f"prelu{li}.weight", (1,)))
        n_in = spec.n
    cnet.append(("reg_head.weight", (4, n_in)))
    cnet.append(("reg_head.bias", (4,)))
    cnet.append(("cls_head.weight", (cfg.class_count + 1, n_in)))
    cnet.append(("cls_head.bias", (cfg.class_count + 1,)))

    return ([("pnet", name, shape) for name, shape in pnet]
            + [("cnet", name, shape) for name, shape in cnet])


def flat_size(cfg: Config) -> int:
    return sum(int(np.prod(s)) for _, _, s in _spec_entries(cfg, "nngraph"))


def _perm(cfg: Config) -> np.ndarray:
    return _pool_perm(cfg.roi_pooling.kh, cfg.roi_pooling.kw,
                      cfg.model.layers[-1].filters)


def flatten_params(state_dicts: Dict[str, Dict], cfg: Config,
                   order: str = "nngraph") -> np.ndarray:
    """``{'pnet': ..., 'cnet': ...}`` state dicts -> the reference's flat
    float32 vector."""
    perm = _perm(cfg)
    chunks = []
    for net, name, tshape in _spec_entries(cfg, order):
        t = state_dicts[net][name].detach().to("cpu", torch.float32).numpy()
        if net == "cnet" and name == "fc0.weight":
            # undo the pooled-feature permutation of the input dimension
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            t = t[:, inv]
        if t.shape != tshape:
            raise ValueError(
                f"{net}.{name}: shape {t.shape} != expected torch shape "
                f"{tshape}: the config does not match the weights")
        chunks.append(t.reshape(-1))
    return np.concatenate(chunks).astype(np.float32)


def unflatten_params(flat: np.ndarray, cfg: Config,
                     state_template: Dict[str, Dict],
                     order: str = "nngraph") -> Dict[str, Dict]:
    """The reference's flat vector -> copies of ``state_template``'s state
    dicts with every covered entry replaced (float32 CPU tensors; the
    batch-norm running statistics are the template's). Raises on a length
    mismatch."""
    flat = np.asarray(flat, np.float32).reshape(-1)
    entries = _spec_entries(cfg, order)
    want = sum(int(np.prod(s)) for _, _, s in entries)
    if flat.size != want:
        raise ValueError(
            f"flat weight vector has {flat.size} elements; the config's "
            f"networks have {want}: wrong config/model for this snapshot")
    perm = _perm(cfg)
    out = {net: dict(sd) for net, sd in state_template.items()}
    pos = 0
    for net, name, tshape in entries:
        n = int(np.prod(tshape))
        t = flat[pos:pos + n].reshape(tshape)
        pos += n
        if net == "cnet" and name == "fc0.weight":
            t = t[:, perm]
        prev = out[net][name]
        t = t.reshape(tuple(prev.shape))
        out[net][name] = torch.from_numpy(np.ascontiguousarray(t))
    return out


def _slope_plausibility(flat: np.ndarray, cfg: Config, order: str) -> int:
    """Number of PReLU-slope slots that land in (0, 2) under ``order``."""
    flat = np.asarray(flat).reshape(-1)
    pos, hits = 0, 0
    for _, name, tshape in _spec_entries(cfg, order):
        if "prelu" in name:
            hits += int(0.0 < flat[pos] < 2.0)
        pos += int(np.prod(tshape))
    return hits


def diagnose_order(flat: np.ndarray, cfg: Config) -> Dict[str, int]:
    """PReLU-slope plausibility per candidate order; ``nngraph`` first so
    that ties resolve to the derived order."""
    return {o: _slope_plausibility(flat, cfg, o)
            for o in ("nngraph", "blocks_first")}


def choose_order(flat: np.ndarray, cfg: Config) -> str:
    scores = diagnose_order(flat, cfg)
    return max(scores, key=lambda k: scores[k])  # first wins on ties


def save_reference_model(path: str, state_dicts: Dict[str, Dict],
                         cfg: Config, options: Dict | None = None,
                         stats: Dict | None = None,
                         order: str = "nngraph") -> None:
    """Write a reference-loadable snapshot (``utilities.lua:126-134``)."""
    flat = flatten_params(state_dicts, cfg, order)
    weights = TorchTensor("torch.FloatTensor", [int(flat.size)], [1], 0,
                          flat.tolist())
    save(path, {"version": 0, "weights": weights,
                "options": options or {}, "stats": stats or {}})


def load_reference_model(path: str, cfg: Config,
                         state_template: Dict[str, Dict],
                         order: str = "auto"):
    """Read a reference snapshot. Returns ``(state_dicts, meta)``; meta
    holds the file's options, stats and version and the order diagnosis."""
    obj = load(path)
    try:
        weights = obj[b"weights"] if b"weights" in obj else obj["weights"]
    except (TypeError, KeyError):
        raise ValueError(f"{path} is not a reference model snapshot "
                         "(no 'weights' field)") from None
    flat = weights.numpy().astype(np.float32).reshape(-1)
    diagnosis = diagnose_order(flat, cfg)
    used = choose_order(flat, cfg) if order == "auto" else order
    state = unflatten_params(flat, cfg, state_template, used)

    def _get(k):
        return obj.get(k.encode(), obj.get(k))

    meta = {"order": used, "order_diagnosis": diagnosis,
            "options": _get("options"), "stats": _get("stats"),
            "version": _get("version")}
    return state, meta
