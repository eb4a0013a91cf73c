"""Micro-benchmark of block 0 (conv 3->64 k=3 at 450x800 + PReLU + 2x2
ceil max pool) in its formulations, on the card (the counterpart of
``scripts/bench_block0.py``).

    python -m frcnn_tpu_torch.tools.bench_block0 [batch] [iters] \\
        [variant...] [--device cuda|cpu] [--hw HxW]
    python -m frcnn_tpu_torch.tools.bench_block0 normparts [batch] \\
        [iters] [--device cuda|cpu] [--hw HxW]

Defaults: batch 16, 40 iterations, variants int8 bf16 pad8 im2col, 450x800
(``--hw`` takes even sizes; the JAX script has none). Inputs are the JAX
script's numpy draws (seed 0). Variants:

  int8      dynamic absmax scale, int8 conv (``ops/int8_conv.py``: im2col
            + ``torch._int_mm``), dequantize + bias to bf16, PReLU, pool
  bf16      cuDNN ``F.conv2d`` in bf16 + bias, PReLU,
            ``F.max_pool2d(ceil_mode=True)``
  pad8      bf16 conv with the channels zero-padded 3 -> 8
  im2col    9 shifted slices -> [B, H, W, 27] @ [27, 64], PReLU, pool
  s2d       pool(prelu(conv3x3(x))) as the max over the 4 pooling phases of
            a 2x2 valid conv on the space-to-depth image [B, H/2+1,
            W/2+1, 12] with the phase weights W2 [2, 2, 12, 256]
            (:func:`s2d_weights`), with its parity line against the float32
            conv + PReLU + pool
  s2dsplit  the s2d variant's packing, conv + max, and the same as an
            explicit im2col matmul, timed apart
  kernel    ``ops/block0_kernel.py::fused_block0`` (the hand-written CUDA
            kernel, ``csrc/block0.cu``) on the packed planes in float32, as
            the JAX script feeds its kernel, with its parity line; the same
            in bf16 (``kernel[bf16]``, the serving mode; the JAX script has
            no such line); and ``pack+kernel+T``, the packing included. The
            port's kernel writes NHWC, so the JAX label's transpose is no
            operation here.

``normparts`` splits ``ops/normalization.py::normalize_s2d`` as the JAX
script splits its own: ``full``, ``statsonly`` (method "none"),
``smooth1`` (one phased smoothing of the luminance planes) and
``smooth3`` (the three of the contrastive step), with the port's
``_s2d_masks`` in place of the JAX ``phase_masks``.

Each line is ``<label> <ms> ms/iter``: CUDA events over ``1 + iters//4``
and ``1 + iters`` calls, the best of 3 of each, differenced
(``utils/metrics.py::differenced_seconds``, the JAX script's two loop
lengths). The card's name and power limit follow on a line of their own.
With ``--device cpu`` the host clock times the CPU (the kernel variant
then runs the kernel's plain version).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from frcnn_tpu_torch.models.layers import prelu

DEFAULT_VARIANTS = ("int8", "bf16", "pad8", "im2col")
VARIANTS = (*DEFAULT_VARIANTS, "s2d", "s2dsplit", "kernel")


def s2d_weights(w: np.ndarray) -> np.ndarray:
    """The phase weights W2 [2, 2, 12, 4 * F] of HWIO ``w`` [3, 3, 3, F]
    (``scripts/bench_block0.py:143-153``): output group p = 2 ry + rx is
    pooling phase (ry, rx); input channel (2 qy + qx) * 3 + c of the s2d
    image is pixel (2i + qy, 2j + qx), channel c of the padded image."""
    f = w.shape[3]
    w2 = np.zeros((2, 2, 12, 4 * f), np.float32)
    for ry in range(2):
        for rx in range(2):
            p = 2 * ry + rx
            for ky in range(3):
                for kx in range(3):
                    cy, qy = divmod(ry + ky, 2)
                    cx, qx = divmod(rx + kx, 2)
                    for c in range(3):
                        ch = (qy * 2 + qx) * 3 + c
                        w2[cy, cx, ch, f * p:f * (p + 1)] += w[ky, kx, c]
    return w2


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, 3] (H, W even) -> the padded image's s2d NHWC
    [B, H/2+1, W/2+1, 12], channel (2 qy + qx) * 3 + c."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    b, hp, wp, _ = xp.shape
    xs = xp.reshape(b, hp // 2, 2, wp // 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
    return xs.reshape(b, hp // 2, wp // 2, 12)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def s2d_block0(xs, w2_oihw, b4, slope):
    """pool(prelu(conv3x3_same(x))) from the s2d image ``xs`` (NHWC, the
    dtype of the conv): 2x2 valid conv with the phase weights, bias,
    PReLU (``slope`` [1]), then the max over the 4 phase groups. Returns
    NHWC."""
    y = F.conv2d(_nchw(xs), w2_oihw)
    y = prelu((y.float() + b4[:, None, None]).to(xs.dtype), slope)
    b, c, h, w = y.shape
    return _nhwc(y.reshape(b, 4, c // 4, h, w).amax(dim=1))


def block0_reference(x, w_oihw, b, slope):
    """float32 conv3x3 same + bias + PReLU (``slope`` [1]) + ceil pool of
    NHWC ``x``; NHWC out."""
    y = F.conv2d(_nchw(x.float()), w_oihw.float(), b.float(), padding=1)
    return _nhwc(F.max_pool2d(prelu(y, slope), 2, 2, ceil_mode=True))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*",
                    help="[batch] [iters] [variant...], or normparts "
                    "[batch] [iters]")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", default="450x800")
    a = ap.parse_args(argv)
    h, w = (int(v) for v in a.hw.lower().split("x"))
    if h % 2 or w % 2:
        raise SystemExit(f"--hw {a.hw}: H and W must be even")
    return a, (h, w)


def main(argv=None) -> int:
    from frcnn_tpu_torch.bench import device_line
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.ops import block0_kernel as K
    from frcnn_tpu_torch.ops import int8_conv
    from frcnn_tpu_torch.utils.metrics import differenced_seconds

    a, (H, W) = _parse(argv)
    device = require_device(a.device)
    if a.args[:1] == ["normparts"]:
        return norm_parts(a.args[1:], device, (H, W))
    bs = int(a.args[0]) if len(a.args) > 0 else 16
    n = int(a.args[1]) if len(a.args) > 1 else 40
    variants = set(a.args[2:]) or set(DEFAULT_VARIANTS)
    unknown = variants - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: "
                         f"{list(VARIANTS)}")

    def loop_time(fn, label):
        per, _ = differenced_seconds(fn, n, device)
        print(f"{label:14s} {per * 1e3:9.3f} ms/iter", flush=True)
        return per

    rng = np.random.default_rng(0)
    xn = rng.normal(0, 1, (bs, H, W, 3)).astype(np.float32)
    wn = rng.normal(0, 0.1, (3, 3, 3, 64)).astype(np.float32)
    bn = rng.normal(0, 0.1, (64,)).astype(np.float32)
    slope = torch.tensor([0.25], device=device)
    x = torch.from_numpy(xn).to(device)                   # NHWC
    w = torch.from_numpy(wn).to(device).permute(3, 2, 0, 1)   # OIHW
    b = torch.from_numpy(bn).to(device)
    bf = torch.bfloat16

    if "int8" in variants:
        wq = torch.clamp(torch.round(w / 0.01), -127, 127).to(torch.int8)
        wmat = int8_conv.weight_matrix(wq)

        def body():
            s = torch.clamp(x.abs().amax() / 127.0, min=1e-12)
            xq = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            y = int8_conv.conv2d_int8(xq, wmat, 3, 3, ((1, 1), (1, 1)), 64)
            y = (y.float() * (s * 0.01) + b).to(bf)
            return F.max_pool2d(_nchw(prelu(y, slope)), 2, 2,
                                ceil_mode=True)
        loop_time(body, "int8")

    if "bf16" in variants:
        xb, wb = _nchw(x.to(bf)), w.to(bf)

        def body():
            y = F.conv2d(xb, wb, padding=1)
            y = (y.float() + b[:, None, None]).to(bf)
            return F.max_pool2d(prelu(y, slope), 2, 2, ceil_mode=True)
        loop_time(body, "bf16")

    if "pad8" in variants:
        w8 = F.pad(w, (0, 0, 0, 0, 0, 5)).to(bf)

        def body():
            x8 = _nchw(F.pad(x.to(bf), (0, 5)))
            y = F.conv2d(x8, w8, padding=1)
            y = (y.float() + b[:, None, None]).to(bf)
            return F.max_pool2d(prelu(y, slope), 2, 2, ceil_mode=True)
        loop_time(body, "pad8")

    if "im2col" in variants:
        wm = w.permute(2, 3, 1, 0).reshape(27, 64).to(bf)   # (ky, kx, c)

        def body():
            xp = F.pad(x.to(bf), (0, 0, 1, 1, 1, 1))
            cols = torch.cat([xp[:, dy:dy + H, dx:dx + W, :]
                              for dy in range(3) for dx in range(3)], -1)
            y = ((cols @ wm).float() + b).to(bf)           # [B, H, W, 64]
            return F.max_pool2d(_nchw(prelu(y, slope)), 2, 2,
                                ceil_mode=True)
        loop_time(body, "im2col")

    b4 = b.repeat(4)
    if "s2d" in variants:
        w2 = torch.from_numpy(s2d_weights(wn)).to(device)
        w2_oihw = w2.permute(3, 2, 0, 1).to(bf)
        ref = block0_reference(x, w, b, slope)
        got = s2d_block0(space_to_depth(x.to(bf)), w2_oihw, b4, slope)
        err = float((ref - got.float()).abs().max())
        print(f"s2d parity: max|diff|={err:.4f} (max|ref|="
              f"{float(ref.abs().max()):.2f}, bf16 path)", flush=True)
        loop_time(lambda: s2d_block0(space_to_depth(x.to(bf)), w2_oihw,
                                     b4, slope), "s2d")

    if "s2dsplit" in variants:
        w2c = torch.full((2, 2, 12, 256), 0.01, device=device).to(bf)
        w2c_oihw = w2c.permute(3, 2, 0, 1)
        xs_pre = space_to_depth(x.to(bf))
        loop_time(lambda: space_to_depth(x.to(bf)), "s2d:pack")
        loop_time(lambda: s2d_block0(xs_pre, w2c_oihw, b4, slope),
                  "s2d:conv+max")
        wmm = w2c.reshape(48, 256)
        ho, wo = H // 2, W // 2

        def body_mm():
            cols = torch.cat([xs_pre[:, dy:dy + ho, dx:dx + wo, :]
                              for dy in range(2) for dx in range(2)], -1)
            y = prelu(((cols @ wmm).float() + b4).to(bf), slope)
            return y.reshape(bs, ho, wo, 4, 64).amax(dim=3)
        loop_time(body_mm, "s2d:mm+max")

    if "kernel" in variants:
        ref = block0_reference(x, w, b, slope)
        for dt, label in ((torch.float32, "kernel"), (bf, "kernel[bf16]")):
            lum4, chroma = K.pack_s2d(x.to(dt))
            w27, bias = K.block0_weights(w, b, dt)
            got = K.fused_block0(lum4, chroma, w27, bias, slope)
            err = float((ref - got.float()).abs().max())
            print(f"{label} parity: max|diff|={err:.4f}", flush=True)
            loop_time(lambda: K.fused_block0(lum4, chroma, w27, bias,
                                             slope), label)
        w27, bias = K.block0_weights(w, b, torch.float32)
        loop_time(lambda: K.fused_block0(*K.pack_s2d(x), w27, bias, slope),
                  "pack+kernel+T")
    print(device_line(device), flush=True)
    return 0


def norm_parts(args, device, hw) -> int:
    """``normalize_s2d`` split into its parts
    (``scripts/bench_block0.py::norm_parts``)."""
    from frcnn_tpu_torch.bench import device_line
    from frcnn_tpu_torch.ops.block0_kernel import pack_s2d
    from frcnn_tpu_torch.ops.normalization import (
        _s2d_masks,
        _smooth_phased,
        gaussian1d,
        normalize_s2d,
    )
    from frcnn_tpu_torch.utils.metrics import differenced_seconds

    bs = int(args[0]) if len(args) > 0 else 16
    n = int(args[1]) if len(args) > 1 else 40
    H, W = hw
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.normal(0.3, 0.2, (bs, H, W, 3)).astype(np.float32)).to(device)
    th = torch.full((bs,), H, dtype=torch.int32, device=device)
    tw = torch.full((bs,), W, dtype=torch.int32, device=device)
    lum4, chroma = pack_s2d(x)
    Hc, Wc = lum4.shape[2], lum4.shape[3]
    k = gaussian1d(7)
    m4 = _s2d_masks(Hc, Wc, th, tw, lum4.dtype, device)[0]

    def t(label, fn):
        per, _ = differenced_seconds(fn, n, device)
        print(f"{label:14s} {per * 1e3:9.3f} ms/iter", flush=True)

    t("full", lambda: normalize_s2d(lum4, chroma, th, tw)[0])
    t("statsonly", lambda: normalize_s2d(lum4, chroma, th, tw,
                                         method="none")[0])
    t("smooth1", lambda: _smooth_phased(lum4, k))
    t("smooth3", lambda: _smooth_phased(_smooth_phased(lum4, k) * m4, k)
      + _smooth_phased(lum4 * lum4, k))
    print(device_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
