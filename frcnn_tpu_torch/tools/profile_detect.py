"""Stage-by-stage timing of the detect path on the card (the counterpart
of ``scripts/profile_detect.py``).

    python -m frcnn_tpu_torch.tools.profile_detect [batch] [loop_iters]
        [stage...] [mode=MODE] [large] [--hw HxW] [--device cuda|cpu]

Stages: norm s2dstages fwd fwdparts decode select nms pool poolparts cnet
tailparts full (default: norm fwd decode select nms pool cnet full).
MODE: a bench mode string (``frcnn_tpu_torch/bench.py``): ``int8[s]``
swaps the backbone for the quantized one (``s``: static scales calibrated
on the batch), ``pallas`` the kernels in for NMS and the ROI pool (also in
the isolated nms and pool stages), ``s2d`` the space-to-depth planes and
the fused block0 kernel into tailparts and full; ``large`` is vgg_large.
``--hw`` is the bucket (default 450x800), ``--device`` where it runs:
``cuda`` (the default) stops where there is no card.

Each stage's body runs ``1 + n // 4`` and ``1 + n`` times back to back
between two CUDA events, best of 3 trials each; the difference over
``n - n // 4`` calls is its time per call (``loop_time``), which cancels
the fixed cost as the JAX script's two loop lengths do. The JAX script
feeds a loop carry back into each body so that XLA cannot hoist work out
of its loop; eager PyTorch hoists nothing, so the bodies here take their
inputs as they are. The weights are the seeded initialisation (seed 0),
the images ``normal(0.3, 0.2)`` from ``numpy.random.default_rng(0)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch

from frcnn_tpu_torch.cli import require_device
from frcnn_tpu_torch.utils.metrics import loop_time

DEFAULT_STAGES = ("norm", "fwd", "decode", "select", "nms", "pool", "cnet",
                  "full")
STAGES = ("norm", "s2dstages", "fwd", "fwdparts", "decode", "select", "nms",
          "pool", "poolparts", "cnet", "tailparts", "full")


class Setup(NamedTuple):
    cfg: object            # the profiled Config (duplo at the bucket)
    mode: str
    gen: object            # AnchorGenerator of the bucket
    pnet_f32: object       # float32 modules with the seeded weights
    cnet_f32: object
    pnet: object           # for the program: compute-dtype copy, or int8
    cnet: object
    images: torch.Tensor   # [B, H, W, 3] float32 on the device
    true_hw: torch.Tensor  # [B, 2] int32 on the device
    rng: np.random.Generator
    device: torch.device


def setup(bs: int, mode: str = "bf16", hw=(450, 800), device="cuda",
          seed: int = 0) -> Setup:
    """The profiled config, weights and batch: ``duplo_config`` at ``hw``
    (vgg_large under ``large``, the kernels under ``pallas``), the seeded
    weights, and for ``int8*`` a ``QuantizedPNet`` (``pool_s8`` under
    ``s8p``; ``int8s`` calibrated on the raw batch, as the JAX script
    does)."""
    from frcnn_tpu_torch.config import duplo_config, vgg_large_model
    from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
    from frcnn_tpu_torch.models.factory import (
        compute_dtype,
        for_compute,
        init_models,
    )
    from frcnn_tpu_torch.models.quant import QuantizedPNet, quantize_pnet

    device = torch.device(device)
    cfg = duplo_config()
    cfg = cfg.replace(shapes=dataclasses.replace(cfg.shapes,
                                                 image_hw=tuple(hw)))
    if "large" in mode:
        cfg = cfg.replace(model=vgg_large_model())
    if "pallas" in mode:
        cfg = cfg.replace(pallas_mode="on")
    pnet_f, cnet_f = init_models(cfg, torch.Generator().manual_seed(seed))
    dt = compute_dtype(cfg)
    H, W = cfg.shapes.image_hw
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        rng.normal(0.3, 0.2, (bs, H, W, 3)).astype(np.float32)).to(device)
    true_hw = torch.tensor([[H, W]] * bs, dtype=torch.int32, device=device)
    pnet = for_compute(pnet_f, dt, device)
    if "int8" in mode:
        pnet = QuantizedPNet(cfg.model, quantize_pnet(pnet_f), act_dtype=dt,
                             pool_s8="s8p" in mode).to(device)
        if "int8s" in mode:
            pnet.calibrate(images)
    return Setup(cfg, mode, AnchorGenerator(cfg), pnet_f, cnet_f, pnet,
                 for_compute(cnet_f, dt, device), images, true_hw, rng,
                 device)


def _norm_kw(cfg) -> dict:
    n = cfg.normalization
    return dict(method=n.method, width=n.width, centering=n.centering,
                scaling=n.scaling)


def _s2d(S: Setup):
    """(s2d config, packed planes on the device, block0 kernel weights)."""
    from frcnn_tpu_torch.detect.detector import block0_weights_of
    from frcnn_tpu_torch.ops.block0_kernel import pack_s2d

    cfg = S.cfg.replace(input_layout="s2d")
    return cfg, pack_s2d(S.images), block0_weights_of(cfg, S.pnet_f32,
                                                       S.device)


def _program(S: Setup, stop_after=None):
    """``build_detect_fn`` of the setup (the s2d layout under ``s2d``) and
    its inputs."""
    from frcnn_tpu_torch.detect.detector import build_detect_fn

    cfg, imgs, b0 = S.cfg, S.images, None
    if "s2d" in S.mode:
        cfg, imgs, b0 = _s2d(S)
    fn = build_detect_fn(cfg, S.gen, S.pnet, S.cnet, S.device, b0,
                         stop_after=stop_after)
    return lambda: fn(imgs, S.true_hw)


def _random_rects(rng, bs, n, origin_hi, size):
    """[bs, n, 4] boxes: corners uniform in [0, origin_hi), sides uniform
    in ``size``."""
    r = np.concatenate([rng.uniform(0, origin_hi, (bs, n, 2)),
                        rng.uniform(size[0], size[1], (bs, n, 2))],
                       axis=2).astype(np.float32)
    r[:, :, 2:] += r[:, :, :2]
    return r


def stage_bodies(S: Setup, stages):
    """``[(label, body)]`` of the stages, in the JAX script's order; each
    body takes no argument and returns its output. ``cum[...]`` bodies are
    tailparts' prefixes of the real program, ``FULL`` the whole of it."""
    from frcnn_tpu_torch.detect.detector import select_proposals
    from frcnn_tpu_torch.geometry.matching import compact_mask
    from frcnn_tpu_torch.ops import block0_kernel, nms_kernel
    from frcnn_tpu_torch.ops.nms import plain_nms
    from frcnn_tpu_torch.ops import roi_pool as pool_plain
    from frcnn_tpu_torch.ops import roi_pool_kernel
    from frcnn_tpu_torch.ops.normalization import (
        normalize_image,
        normalize_s2d,
    )

    bad = set(stages) - set(STAGES)
    if bad:
        raise ValueError(f"unknown stages {sorted(bad)}; stages: {STAGES}")
    cfg, dev, bs = S.cfg, S.device, S.images.shape[0]
    s = cfg.shapes
    K, D = s.max_proposals, s.max_detections
    kh, kw = cfg.roi_pooling.kh, cfg.roi_pooling.kw
    h, w = S.true_hw[:, 0], S.true_hw[:, 1]
    pallas = "pallas" in S.mode
    nkw = _norm_kw(cfg)
    out = []

    if "norm" in stages:
        out.append(("normalize",
                    lambda: normalize_image(S.images, h, w, **nkw)))

    if "s2dstages" in stages:
        cfg2, (lum4, chroma), (w27, b, slope) = _s2d(S)
        if cfg2.model.layers[0].conv_steps != 1:
            raise SystemExit("s2dstages: the one-conv block0 (vgg_small)")
        cdt = w27.dtype

        def norm_s2d():
            return normalize_s2d(lum4, chroma, h, w, **nkw)

        def block0(lum4=lum4, chroma=chroma):
            return block0_kernel.fused_block0(lum4.to(cdt), chroma.to(cdt),
                                              w27, b, slope)

        out += [("normalize[s2d]", norm_s2d),
                ("block0[s2d]", block0),
                ("frontend[s2d]", lambda: block0(*norm_s2d()))]

    if "fwd" in stages:
        out.append(("pnet_fwd", lambda: S.pnet(S.images)))

    if "fwdparts" in stages:
        if "int8" not in S.mode:
            raise SystemExit("fwdparts: use with mode=int8[s][+...]")
        out += _fwdparts(S)

    if "decode" in stages:
        # the real program's prefix (normalize, pnet, decode, top-K)
        out.append(("fwd+decode+topk", _program(S, "select")))

    if "select" in stages:
        A = S.gen.num_anchors
        sc0 = torch.from_numpy(
            S.rng.normal(size=(bs, A)).astype(np.float32)).to(dev)
        keep0 = torch.from_numpy(S.rng.random((bs, A)) < 0.01).to(dev)
        out += [(f"select:top_k(A={A})",
                 lambda: select_proposals(keep0, sc0, K)),
                (f"select:compact(A={A})", lambda: compact_mask(keep0, K))]

    if "nms" in stages:
        rngk = np.random.default_rng(1)
        tb = torch.from_numpy(_random_rects(rngk, bs, K, 700,
                                            (20, 120))).to(dev)
        tsc = torch.from_numpy(
            rngk.uniform(-1, 0, (bs, K)).astype(np.float32)).to(dev)
        ones = torch.ones((bs, K), dtype=torch.bool, device=dev)
        nms = nms_kernel.cuda_nms if pallas else plain_nms
        out.append(("nms(K->D)" + ("[pallas]" if pallas else ""),
                    lambda: nms(tb, tsc, ones, 0.25, D)))

    if "pool" in stages or "poolparts" in stages:
        fm_loc = S.gen.fm_localizer
        C = cfg.model.layers[-1].filters
        fm = torch.from_numpy(S.rng.normal(
            size=(bs, *S.gen.fm_hw, C)).astype(np.float32)).to(dev)
        rects = torch.from_numpy(_random_rects(S.rng, bs, D, 600,
                                               (30, 200))).to(dev)
        fw, fh = fm_loc.feature_map_size_t(w, h)
        valid = torch.ones((bs, D), dtype=torch.bool, device=dev)

        def feature_rects():
            return pool_plain.roi_pool_feature_rects(
                fm_loc, rects, fw[:, None].float(), fh[:, None].float())

        kernel = roi_pool_kernel.adaptive_max_pool_valid
        if "pool" in stages:
            pool = kernel if pallas else pool_plain.adaptive_max_pool
            out.append((f"roi_pool({D})" + ("[pallas]" if pallas else ""),
                        lambda: pool(fm, feature_rects(), valid, kh, kw)))
        if "poolparts" in stages:
            fm16 = fm.to(torch.bfloat16)
            out += [
                ("transpose(fm bf16)",
                 lambda: fm16.transpose(1, 2).contiguous()),
                (f"pool({D})[f32]",
                 lambda: kernel(fm, feature_rects(), valid, kh, kw)),
                (f"pool({D})[bf16]",
                 lambda: kernel(fm16, feature_rects(), valid, kh, kw)),
                (f"pool({D})[bf16]+reshape",
                 lambda: kernel(fm16, feature_rects(), valid, kh,
                                kw).reshape(bs, D, -1).float().sum()),
            ]

    if "cnet" in stages:
        dcn = kh * kw * cfg.model.layers[-1].filters
        x = torch.from_numpy(S.rng.normal(
            size=(bs, D, dcn)).astype(np.float32)).to(dev)
        out.append(("cnet", lambda: S.cnet(x)))

    if "tailparts" in stages:
        cuts = ["fwd", "decode", "select", "nms", "pool", "cnet", None]
        if "s2d" in S.mode:
            cuts = ["b0"] + cuts
        out += [(f"cum[{cut or 'FULL'}]", _program(S, cut)) for cut in cuts]

    if "full" in stages:
        out.append(("FULL", _program(S)))
    return out


def _fwdparts(S: Setup):
    """Cumulative prefixes of the int8 backbone: blocks [0:k], then all
    blocks and heads [0:k] (``scripts/profile_detect.py:193-236``)."""
    from frcnn_tpu_torch.models.quant import _prelu, ceil_max_pool_2x2, qconv

    q, m = S.pnet, S.cfg.model
    scales = q.act_scales or {}
    valid = ((0, 0), (0, 0))

    def conv(x, name, pad):
        return qconv(x, q.convs[name], pad, q.act_dtype, s_x=scales.get(name))

    def partial(n_blocks, n_heads):
        x = S.images.to(q.act_dtype)
        outs = []
        for bi, spec in enumerate(m.layers[:n_blocks]):
            pad = ((spec.padH, spec.padH), (spec.padW, spec.padW))
            for si in range(spec.conv_steps):
                x = conv(x, f"block{bi}_conv{si}", pad)
                x = _prelu(x, q.slope(f"block{bi}_prelu{si}"))
            x = ceil_max_pool_2x2(x)
            outs.append(x)
        acc = x[0, 0, 0, :2].float().sum()
        for ai, aspec in enumerate(m.anchor_nets[:n_heads]):
            a = conv(outs[aspec.input - 1], f"anchor{ai}_conv", valid)
            a = _prelu(a, q.slope(f"anchor{ai}_prelu"))
            a = conv(a, f"anchor{ai}_out", valid)
            acc = acc + a[0, 0, 0, :2].float().sum()
        return acc

    nb = len(m.layers)
    return ([(f"blocks[0:{k}]", lambda k=k: partial(k, 0))
             for k in range(1, nb + 1)]
            + [(f"blocks+heads[0:{k}]", lambda k=k: partial(nb, k))
               for k in range(1, len(m.anchor_nets) + 1)])


@torch.no_grad()
def run(S: Setup, stages, n: int, out=print) -> dict:
    """Times every stage body; prints one line each, tailparts' deltas and
    the full program's throughput. Returns {label: seconds per call}."""
    times, prev = {}, 0.0
    for label, body in stage_bodies(S, stages):
        per = loop_time(body, n, label, S.device, out)
        times[label] = per
        if label.startswith("cum["):
            cut = label[4:-1]
            out(f"   delta[{'tail' if cut == 'FULL' else cut}] "
                f"{max(per - prev, 0.0) * 1e3:9.3f} ms")
            prev = per
        if label == "FULL":
            out(f"full-detect throughput ~= {S.images.shape[0] / per:.1f} "
                f"img/s")
    return times


def parse_hw(text: str):
    h, w = text.lower().split("x")
    return int(h), int(w)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("n", nargs="?", type=int, default=20)
    ap.add_argument("rest", nargs="*",
                    help="stages, mode=MODE, large")
    ap.add_argument("--hw", type=parse_hw, default=(450, 800))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    rest, mode = list(args.rest), "bf16"
    for a in list(rest):
        if a.startswith("mode="):
            mode = a[5:]
            rest.remove(a)
    if "large" in rest:
        rest.remove("large")
        mode += "+large"
    stages = set(rest) or set(DEFAULT_STAGES)
    S = setup(args.batch, mode, args.hw, args.device)
    print(f"mode={mode}")
    print(f"batch={args.batch} loop={args.n} bucket={args.hw[0]}x"
          f"{args.hw[1]} device={args.device}")
    run(S, stages, args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
