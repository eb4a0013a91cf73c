"""Fused two-conv first block (conv3x3 3->F + PReLU + conv3x3 F->F + PReLU +
2x2/2 max pool) from space-to-depth planes, on the hand-written CUDA kernel
``csrc/block0_2conv.cu``.

Port of ``frcnn_tpu/ops/pallas_block0_2conv.py`` (float mode), vgg_large's
block 0. It takes the planes of ``ops/block0_kernel.py`` (lum4
``[B, 4, Hc, Wc]``, chroma ``[B, Hc, 8, Wc]``, Hc = H/2+1, Wc = W/2+1) and
returns NHWC ``[B, H/2, W/2, F]`` in the compute dtype, the channels_last
layout block 1's convolution reads.

Numerics, as in the Pallas kernel: both convolutions accumulate in float32
and add float32 biases; y0 = prelu0(conv0) is held in the compute dtype
between them; conv1's zero padding is y0 = 0 outside the H x W image (the
pad ring of the planes feeds conv0 at the border only); the pooled output
is rounded once.

On a CPU tensor :func:`fused_block0_2conv` runs the plain version
(:func:`block0_2conv_plain`); on a CUDA tensor it launches the kernel or
raises. The kernel takes F = 64 only, vgg_large's width.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from frcnn_tpu_torch.ops.block0_kernel import pack_s2d, unpack_s2d
from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr

KERNEL_F = 64

KERNEL = CudaKernel(
    name="fused_block0_2conv",
    entry="block0_2conv_kernel",
    symbols={torch.float32: "frcnn_block0_2conv_f32",
             torch.bfloat16: "frcnn_block0_2conv_bf16"},
    argtypes=[ctypes.c_void_p] * 8 + [ctypes.c_int] * 4,
    source="frcnn_tpu_torch/csrc/block0_2conv.cu",
    replaces="frcnn_tpu/ops/pallas_block0_2conv.py:136 (_kernel of "
             "fused_block0_2conv, pallas_call at :432)",
)


class Block0TwoConvParams(NamedTuple):
    """The kernel's weights: w0 [27, F] and w1 [9, F, F] in the compute
    dtype, b0 and b1 [F] and the two PReLU slopes [2] in float32."""
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    slopes: torch.Tensor


def block0_2conv_weights(w0_oihw, b0, w1_oihw, b1, slope0, slope1,
                         dtype) -> Block0TwoConvParams:
    """The kernel's layout from the float32 OIHW conv weights: conv0
    [F, 3, 3, 3] -> [27, F] (tap (ky*3+kx)*3+c, the HWIO kernel
    flattened); conv1 [F, F, 3, 3] -> [9, F, F] (tap dy*3+dx, output
    channel, input channel: each row is one tensor-core B operand)."""
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
    return Block0TwoConvParams(w0.to(dtype).contiguous(),
                               b0.float().contiguous(),
                               w1.to(dtype).contiguous(),
                               b1.float().contiguous(), slopes)


def block0_2conv_plain(lum4, chroma, w0, b0, w1, b1, slopes):
    """Plain version of the kernel: same inputs, same output. conv0 in
    float32 over the padded image the planes hold, bias, PReLU, y0 rounded
    to the compute dtype (the dtype of the planes); conv1 in float32 with
    zero padding, bias, PReLU, 2x2 max pool, rounded once."""
    f = w0.shape[1]
    dt = lum4.dtype
    p = unpack_s2d(lum4, chroma).float()
    k0 = w0.float().reshape(3, 3, 3, f).permute(3, 2, 0, 1)
    y = F.conv2d(p, k0, b0.float())
    y = torch.where(y >= 0, y, slopes[0].float() * y).to(dt).float()
    k1 = w1.float().reshape(3, 3, f, f).permute(2, 3, 0, 1)
    y = F.conv2d(y, k1, b1.float(), padding=1)
    y = torch.where(y >= 0, y, slopes[1].float() * y)
    y = F.max_pool2d(y, 2, 2)
    return y.permute(0, 2, 3, 1).to(dt).contiguous()


def block0_2conv_nhwc(x, w0_oihw, b0, slope0, w1_oihw, b1, slope1):
    """pool(prelu1(conv1(prelu0(conv0(x))))) of NHWC ``x`` (H, W even)
    through :func:`fused_block0_2conv` in the dtype of ``x``; returns NHWC
    [B, H/2, W/2, F]. The parity entry around the kernel."""
    lum4, chroma = pack_s2d(x)
    params = block0_2conv_weights(w0_oihw, b0, w1_oihw, b1, slope0, slope1,
                                  x.dtype)
    return fused_block0_2conv(lum4, chroma, *params)


def fused_block0_2conv(lum4, chroma, w0, b0, w1, b1, slopes):
    """lum4 [B, 4, Hc, Wc] and chroma [B, Hc, 8, Wc] in the compute dtype
    (float32 or bfloat16), w0 [27, F] and w1 [9, F, F] in the same dtype
    (see :func:`block0_2conv_weights`), b0 and b1 [F] float32, slopes [2]
    float32. Returns NHWC [B, Hc-1, Wc-1, F] in the compute dtype."""
    if lum4.device.type == "cpu":
        return block0_2conv_plain(lum4, chroma, w0, b0, w1, b1, slopes)
    B, _, Hc, Wc = lum4.shape
    f = w0.shape[1]
    dt = lum4.dtype
    if f != KERNEL_F:
        raise ValueError(f"block0_2conv kernel needs F={KERNEL_F}, got F={f}")
    check_cuda("lum4", lum4, dt, (B, 4, Hc, Wc))
    check_cuda("chroma", chroma, dt, (B, Hc, 8, Wc))
    check_cuda("w0", w0, dt, (27, f))
    check_cuda("b0", b0, torch.float32, (f,))
    check_cuda("w1", w1, dt, (9, f, f))
    check_cuda("b1", b1, torch.float32, (f,))
    check_cuda("slopes", slopes, torch.float32, (2,))
    out = torch.empty((B, Hc - 1, Wc - 1, f), dtype=dt, device=lum4.device)
    KERNEL.launch(dt, ptr(lum4), ptr(chroma), ptr(w0), ptr(b0), ptr(w1),
                  ptr(b1), ptr(slopes), ptr(out), B, Hc, Wc, f)
    return out
