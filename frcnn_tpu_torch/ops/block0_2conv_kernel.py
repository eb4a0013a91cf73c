"""Fused two-conv first block (conv3x3 3->F + PReLU + conv3x3 F->F + PReLU +
2x2/2 max pool) from space-to-depth planes, on the hand-written CUDA kernel
``csrc/block0_2conv.cu``.

Port of ``frcnn_tpu/ops/pallas_block0_2conv.py``, vgg_large's block 0, in
every mode of the Pallas kernel. It takes the planes of
``ops/block0_kernel.py`` (lum4 ``[B, 4, Hc, Wc]``, chroma
``[B, Hc, 8, Wc]``, Hc = H/2+1, Wc = W/2+1) and returns NHWC
``[B, H/2, W/2, F]`` in the compute dtype (or int8), the channels_last
layout block 1's convolution reads.

Numerics, as in the Pallas kernel: both convolutions accumulate in float32
and add float32 biases; y0 = prelu0(conv0) is held in the compute dtype
between them; conv1's zero padding is y0 = 0 outside the H x W image (the
pad ring of the planes feeds conv0 at the border only); the pooled output
is rounded once.

The int8 modes (the int8 serving chain) follow the Pallas kernel's
arguments:

* int8 conv1, when both ``w1_scale`` and ``inv_y`` are given (its
  ``w1_scales`` and ``act_scale``): y0 is quantized from the float32
  conv0 + bias + PReLU value as ``clip(round(y0 * inv_y), -127, 127)``
  (``inv_y = 1 / s_y``, int8 0 outside the image), conv1 sums int8
  products in int32 with the int8 ``w1`` of :func:`block0_2conv_weights_q`,
  and each sum is dequantized as one fused multiply-add
  ``fma(float32(z), w1_scale[o], b1[o])`` with ``w1_scale = s_w * s_y``
  (what XLA makes of the Pallas kernel's ``z * wscale + b1`` on the CPU);
* int8 output whenever ``inv_out`` is given: the pooled float32 value is
  quantized as ``clip(round(m * inv_out), -127, 127)``.

The int8-conv1 kernel is its own ``CudaKernel`` (:data:`INT8_KERNEL`),
so its launches are counted apart from the float conv1's.

On a CPU tensor :func:`fused_block0_2conv` runs the plain version
(:func:`block0_2conv_plain`); on a CUDA tensor it launches the kernel or
raises. Any F: the weights are padded with zeros to a multiple of 64
(:func:`plan`) once per weight set (:func:`block0_2conv_weights` and
:func:`block0_2conv_weights_q`, or the wrapper where they are not), the
biases keep the F real filters, and the kernel stores only those. F = 64,
vgg_large's width, needs no padding; past 64 the kernel tiles conv1's
outputs in groups of 64 and recomputes conv0 per group.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from frcnn_tpu_torch.ops import int8_conv
from frcnn_tpu_torch.ops.block0_kernel import (
    pack_s2d,
    pad_columns,
    quantize_out,
    unpack_s2d,
)
from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr

GROUP = 64   # the kernel's channel group: F is padded to a multiple
_F32, _BF16, _S8 = torch.float32, torch.bfloat16, torch.int8
# lum4, chroma, w0, b0, w1, b1, slopes, w1_scale, inv_y, inv_out, out, then
# B, Hc, Wc, F; the pointers a mode does not read are null
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4

KERNEL = CudaKernel(
    name="fused_block0_2conv",
    entry="block0_2conv_kernel",
    symbols={(_F32, _F32): "frcnn_block0_2conv_f32",
             (_BF16, _BF16): "frcnn_block0_2conv_bf16",
             (_F32, _S8): "frcnn_block0_2conv_f32_s8",
             (_BF16, _S8): "frcnn_block0_2conv_bf16_s8"},
    argtypes=_ARGTYPES,
    source="frcnn_tpu_torch/csrc/block0_2conv.cu",
    replaces="frcnn_tpu/ops/pallas_block0_2conv.py:136 (_kernel of "
             "fused_block0_2conv, pallas_call at :432)",
)

INT8_KERNEL = CudaKernel(
    name="block0_2conv_int8",
    entry="block0_2conv_kernel",
    symbols={(_F32, _F32): "frcnn_block0_2conv_q_f32",
             (_BF16, _BF16): "frcnn_block0_2conv_q_bf16",
             (_F32, _S8): "frcnn_block0_2conv_q_f32_s8",
             (_BF16, _S8): "frcnn_block0_2conv_q_bf16_s8"},
    argtypes=_ARGTYPES,
    source="frcnn_tpu_torch/csrc/block0_2conv.cu",
    replaces="frcnn_tpu/ops/pallas_block0_2conv.py:136 (_kernel of "
             "fused_block0_2conv, int8 conv1 mode, :199-205 and :303-309, "
             ":414-418; pallas_call at :432)",
)


def plan(f: int) -> int:
    """The filters the kernel computes for F real ones: F rounded up to a
    multiple of 64. Raises for F < 1 only: the Pallas kernel takes any
    F."""
    if f < 1:
        raise ValueError(f"block0_2conv kernel: needs F >= 1, got {f}")
    return -(-f // GROUP) * GROUP


def pad_w1(w1, n: int):
    """conv1's [9, F, F] weights with zero output and input channels up to
    [9, n, n] (``w1`` itself when it has ``n``)."""
    f = w1.shape[-1]
    if f == n:
        return w1
    return F.pad(w1, (0, n - f, 0, n - f)).contiguous()


class Block0TwoConvParams(NamedTuple):
    """The kernel's weights: w0 [27, F] and w1 [9, F, F] in the compute
    dtype (or padded to [27, Fp] and [9, Fp, Fp], :func:`plan`), b0 and
    b1 [F] and the two PReLU slopes [2] in float32."""
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    slopes: torch.Tensor


def padded(p: Block0TwoConvParams) -> Block0TwoConvParams:
    """``p`` with w0 and w1 given zero filters up to :func:`plan`'s count
    (the biases keep F, the width of the output)."""
    fp = plan(p.b0.shape[0])
    return p._replace(w0=pad_columns(p.w0, fp), w1=pad_w1(p.w1, fp))


def block0_2conv_weights(w0_oihw, b0, w1_oihw, b1, slope0, slope1,
                         dtype) -> Block0TwoConvParams:
    """The kernel's layout from the float32 OIHW conv weights: conv0
    [F, 3, 3, 3] -> [27, F] (tap (ky*3+kx)*3+c, the HWIO kernel
    flattened); conv1 [F, F, 3, 3] -> [9, F, F] (tap dy*3+dx, output
    channel, input channel: each row is one tensor-core B operand). On a
    CUDA device, whose kernel reads them, :func:`padded` here, once per
    weight set."""
    f = w0_oihw.shape[0]
    if tuple(w0_oihw.shape[1:]) != (3, 3, 3) or tuple(w1_oihw.shape) != (
            f, f, 3, 3):
        raise ValueError(f"block0_2conv takes 3x3 convs 3->F->F, got "
                         f"{tuple(w0_oihw.shape)} and {tuple(w1_oihw.shape)}")
    w0 = w0_oihw.permute(2, 3, 1, 0).reshape(27, f)
    w1 = w1_oihw.permute(2, 3, 0, 1).reshape(9, f, f)
    dev = w0_oihw.device
    slopes = torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                          device=dev).reshape(())
                          for s in (slope0, slope1)])
    p = Block0TwoConvParams(w0.to(dtype).contiguous(),
                            b0.float().contiguous(),
                            w1.to(dtype).contiguous(),
                            b1.float().contiguous(), slopes)
    return padded(p) if dev.type == "cuda" else p


def block0_2conv_weights_q(w1_int8_oihw, w_scale, s_y):
    """The int8 conv1 mode's weights: int8 OIHW [F, F, 3, 3] (from
    ``models/quant.py::quantize_weight``) -> int8 [9, F, F] in the
    kernel's layout, and the dequant column ``w1_scale = s_w[o] * s_y``
    [F] as one float32 product (``pallas_block0_2conv.py:416-418``). On a
    CUDA device both get zeros up to :func:`plan`'s count here."""
    f = w1_int8_oihw.shape[0]
    if tuple(w1_int8_oihw.shape) != (f, f, 3, 3):
        raise ValueError(f"conv1 takes a 3x3 F->F int8 kernel, got "
                         f"{tuple(w1_int8_oihw.shape)}")
    w1q = w1_int8_oihw.permute(2, 3, 0, 1).reshape(9, f, f).contiguous()
    ws = (w_scale.float() * s_y).contiguous()
    if w1q.is_cuda:
        w1q, ws = pad_w1(w1q, plan(f)), pad_columns(ws, plan(f))
    return w1q, ws


def _int8_mode(w1_scale, inv_y) -> bool:
    """int8 conv1 only when both are given, as the Pallas kernel decides
    (``pallas_block0_2conv.py:365``)."""
    return w1_scale is not None and inv_y is not None


def block0_2conv_plain(lum4, chroma, w0, b0, w1, b1, slopes, w1_scale=None,
                       inv_y=None, inv_out=None):
    """Plain version of the kernel: same inputs, same output. conv0 in
    float32 over the padded image the planes hold, bias, PReLU; y0 rounded
    to the compute dtype (the dtype of the planes) and conv1 in float32
    with zero padding, or, in the int8 conv1 mode, y0 quantized and conv1
    as exact int32 sums (``ops/int8_conv.py``) dequantized by a fused
    multiply-add (taken in float64, exact but for a double rounding);
    then bias, PReLU, 2x2 max pool, rounded once or quantized under
    ``inv_out``. Padded weights (:func:`block0_2conv_weights`) are computed
    through with zero biases, as the kernel computes them, and the padded
    filters dropped."""
    f, fp = b0.shape[0], w0.shape[1]
    dt = lum4.dtype
    p = unpack_s2d(lum4, chroma).float()
    k0 = w0.float().reshape(3, 3, 3, fp).permute(3, 2, 0, 1)
    y = F.conv2d(p, k0, pad_columns(b0.float(), fp))
    y = torch.where(y >= 0, y, slopes[0].float() * y)
    b1p = pad_columns(b1.float(), fp)
    if _int8_mode(w1_scale, inv_y):
        yq = quantize_out(y.permute(0, 2, 3, 1), inv_y)
        k1 = int8_conv.weight_matrix(
            w1.reshape(3, 3, fp, fp).permute(2, 3, 0, 1))
        z = int8_conv.conv2d_int8(yq, k1, 3, 3, ((1, 1), (1, 1)), fp)
        y = (z.float().double() * pad_columns(w1_scale, fp).double()
             + b1p.double()).float().permute(0, 3, 1, 2)
    else:
        k1 = w1.float().reshape(3, 3, fp, fp).permute(2, 3, 0, 1)
        y = F.conv2d(y.to(dt).float(), k1, b1p, padding=1)
    y = torch.where(y >= 0, y, slopes[1].float() * y)
    y = F.max_pool2d(y, 2, 2).permute(0, 2, 3, 1)[..., :f]
    if inv_out is not None:
        return quantize_out(y, inv_out).contiguous()
    return y.to(dt).contiguous()


def block0_2conv_nhwc(x, w0_oihw, b0, slope0, w1_oihw, b1, slope1):
    """pool(prelu1(conv1(prelu0(conv0(x))))) of NHWC ``x`` (H, W even)
    through :func:`fused_block0_2conv` in the dtype of ``x``; returns NHWC
    [B, H/2, W/2, F]. The parity entry around the kernel."""
    lum4, chroma = pack_s2d(x)
    params = block0_2conv_weights(w0_oihw, b0, w1_oihw, b1, slope0, slope1,
                                  x.dtype)
    return fused_block0_2conv(lum4, chroma, *params)


def fused_block0_2conv(lum4, chroma, w0, b0, w1, b1, slopes, w1_scale=None,
                       inv_y=None, inv_out=None):
    """lum4 [B, 4, Hc, Wc] and chroma [B, Hc, 8, Wc] in the compute dtype
    (float32 or bfloat16), w0 [27, F] in the same dtype, w1 [9, F, F] in
    the same dtype (see :func:`block0_2conv_weights`) or, with
    ``w1_scale`` [F] and ``inv_y`` [1] float32, int8 (see
    :func:`block0_2conv_weights_q`), all three possibly padded (padded
    here where they are not), b0 and b1 [F] float32, slopes [2] float32,
    optionally ``inv_out`` [1] float32. Returns NHWC [B, Hc-1, Wc-1, F] in
    the compute dtype, or int8 under ``inv_out``."""
    if lum4.device.type == "cpu":
        return block0_2conv_plain(lum4, chroma, w0, b0, w1, b1, slopes,
                                  w1_scale, inv_y, inv_out)
    B, _, Hc, Wc = lum4.shape
    f = b0.shape[0]
    fp = plan(f)
    dt = lum4.dtype
    quant = _int8_mode(w1_scale, inv_y)
    w0, _, w1, _, _ = padded(Block0TwoConvParams(w0, b0, w1, b1, slopes))
    check_cuda("lum4", lum4, dt, (B, 4, Hc, Wc))
    check_cuda("chroma", chroma, dt, (B, Hc, 8, Wc))
    check_cuda("w0", w0, dt, (27, fp))
    check_cuda("b0", b0, torch.float32, (f,))
    check_cuda("w1", w1, torch.int8 if quant else dt, (9, fp, fp))
    check_cuda("b1", b1, torch.float32, (f,))
    check_cuda("slopes", slopes, torch.float32, (2,))
    null = ctypes.c_void_p(None)
    ws = iy = io = null
    if quant:
        w1_scale = pad_columns(w1_scale, fp)
        check_cuda("w1_scale", w1_scale, torch.float32, (fp,))
        check_cuda("inv_y", inv_y, torch.float32, (1,))
        ws, iy = ptr(w1_scale), ptr(inv_y)
    out_dt = dt
    if inv_out is not None:
        check_cuda("inv_out", inv_out, torch.float32, (1,))
        io, out_dt = ptr(inv_out), torch.int8
    out = torch.empty((B, Hc - 1, Wc - 1, f), dtype=out_dt,
                      device=lum4.device)
    (INT8_KERNEL if quant else KERNEL).launch(
        (dt, out_dt), ptr(lum4), ptr(chroma), ptr(w0), ptr(b0), ptr(w1),
        ptr(b1), ptr(slopes), ws, iy, io, ptr(out), B, Hc, Wc, f)
    return out
