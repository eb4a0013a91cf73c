"""Fused first conv block (conv3x3 C=3->F + PReLU + 2x2/2 max pool) from
space-to-depth planes, on the hand-written CUDA kernel ``csrc/block0.cu``.

Port of ``frcnn_tpu/ops/pallas_block0.py`` (float output mode). The planes
are the JAX package's host layout, built by :func:`pack_s2d_np`:

  lum4   [B, 4, Hc, Wc]  lum4[b, 2qy+qx, i, j]          = P[2i+qy, 2j+qx, 0]
  chroma [B, Hc, 8, Wc]  chroma[b, i, 2(2qy+qx)+c-1, j] = P[2i+qy, 2j+qx, c]

with P = pad(image, 1), Hc = H/2+1, Wc = W/2+1. The kernel reads them as
``ops/normalization.py::normalize_s2d`` emits them, so the serving path
never repacks. The output is NHWC ``[B, H/2, W/2, F]``; viewed as NCHW it
is channels_last, the layout block 1's convolution reads directly.

With ``inv_out`` (the ``out_scale`` mode of the Pallas kernel, the int8
serving chain) the pooled float32 value ``m`` is quantized in the kernel
as ``clip(round(m * inv_out), -127, 127)`` and the output is int8:
``inv_out`` is the float32 reciprocal ``1 / s`` of the next conv's input
scale, and the product by it (not a division by ``s``) is what the Pallas
kernel rounds. That mode is its own ``CudaKernel`` (:data:`S8_KERNEL`),
so its launches are counted apart.

The kernel computes bf16 planes on tensor cores (``wgmma``: one row of
an implicit GEMM per output pixel, its 48 patch values against the four
pooling phases' weights, which it re-tiles from ``w27`` itself) in slices
of 64 filters; float32 planes stay on CUDA cores in float32, 16 filters
at a time. Any F: :func:`block0_weights` pads ``w27`` with zero columns
to the kernel's granule (:func:`plan`) once per weight set, the bias keeps
the F real filters, and the kernel stores only those.

On a CPU tensor :func:`fused_block0` runs the plain version
(:func:`block0_plain`: unpack the planes, one float32 convolution, bias,
PReLU, pool); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from frcnn_tpu_torch.ops.cuda_lib import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    name="fused_block0",
    entry="block0_kernel",
    symbols={torch.float32: "frcnn_block0_f32",
             torch.bfloat16: "frcnn_block0_bf16"},
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 4,
    source="frcnn_tpu_torch/csrc/block0.cu",
    replaces="frcnn_tpu/ops/pallas_block0.py:58 (_kernel of fused_block0, "
             "pallas_call at :275)",
)

S8_KERNEL = CudaKernel(
    name="block0_s8out",
    entry="block0_kernel",
    symbols={torch.float32: "frcnn_block0_f32_s8",
             torch.bfloat16: "frcnn_block0_bf16_s8"},
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 4,
    source="frcnn_tpu_torch/csrc/block0.cu",
    replaces="frcnn_tpu/ops/pallas_block0.py:58 (_kernel of fused_block0, "
             "out_scale mode, :99-102; pallas_call at :275)",
)


def quantize_out(m, inv_out):
    """The kernels' output quantization: ``clip(round(m * inv_out), -127,
    127)`` as int8, ``m`` float32, ``inv_out`` [1] float32."""
    return torch.clamp(torch.round(m * inv_out), -127, 127).to(torch.int8)


def pack_s2d(x):
    """NHWC [B, H, W, 3] tensor (H, W even) -> contiguous (lum4, chroma)
    planes on the same device."""
    B, H, W, C = x.shape
    if C != 3 or H % 2 or W % 2:
        raise ValueError(f"pack_s2d needs [B, even H, even W, 3], got "
                         f"{tuple(x.shape)}")
    return pack_padded(F.pad(x, (0, 0, 1, 1, 1, 1)))


def pack_padded(p):
    """The planes of an already padded NHWC image P [B, H+2, W+2, 3],
    whose pad ring need not be zero (the inverse of :func:`unpack_s2d`)."""
    B, Hp, Wp, _ = p.shape
    Hc, Wc = Hp // 2, Wp // 2
    ph = p.reshape(B, Hc, 2, Wc, 2, 3)
    lum4 = ph[..., 0].permute(0, 2, 4, 1, 3).reshape(B, 4, Hc, Wc)
    chroma = ph[..., 1:].permute(0, 1, 2, 4, 5, 3).reshape(B, Hc, 8, Wc)
    return lum4.contiguous(), chroma.contiguous()


def pack_s2d_np(x):
    """:func:`pack_s2d` of a numpy batch, on the host before the device
    transfer; returns numpy planes."""
    return tuple(p.numpy() for p in pack_s2d(torch.from_numpy(np.asarray(x))))


def unpack_s2d(lum4, chroma):
    """Planes -> the padded image P as NCHW [B, 3, 2Hc, 2Wc]."""
    B, _, Hc, Wc = lum4.shape
    lum = lum4.reshape(B, 2, 2, Hc, Wc).permute(0, 3, 1, 4, 2)
    lum = lum.reshape(B, 1, 2 * Hc, 2 * Wc)
    ch = chroma.reshape(B, Hc, 2, 2, 2, Wc).permute(0, 4, 1, 2, 5, 3)
    ch = ch.reshape(B, 2, 2 * Hc, 2 * Wc)
    return torch.cat([lum, ch], dim=1)


def plan(f: int, dtype) -> int:
    """The filters the kernel computes for F real ones in planes of
    ``dtype``: F rounded up to a multiple of 64 for bfloat16 (the
    ``wgmma`` slices) or of 16 for float32 (the CUDA cores' groups).
    Raises for F < 1 or another dtype: the Pallas kernel takes any F."""
    if f < 1:
        raise ValueError(f"block0 kernel: needs F >= 1, got {f}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block0 kernel: float32 or bfloat16 planes, got "
                        f"{dtype}")
    g = 64 if dtype == torch.bfloat16 else 16
    return -(-f // g) * g


def pad_columns(w, n: int):
    """``w`` [..., F] with zero columns appended up to ``n`` (``w`` itself
    when it has ``n``)."""
    f = w.shape[-1]
    if f == n:
        return w
    if f > n:
        raise ValueError(f"pad_columns: {f} columns, more than {n}")
    return F.pad(w, (0, n - f)).contiguous()


def block0_weights(w_oihw, bias, dtype):
    """The kernel's weight layout: OIHW [F, 3, 3, 3] -> [27, F] in
    ``dtype`` (tap (ky*3+kx)*3+c, the HWIO kernel flattened), and the bias
    as float32 [F]. On a CUDA device, whose kernel reads them, ``w27``
    gets zero columns up to :func:`plan`'s count here, once per weight
    set; the bias keeps F, the width of the output."""
    f = w_oihw.shape[0]
    if tuple(w_oihw.shape[1:]) != (3, 3, 3):
        raise ValueError(f"block0 takes a 3x3 conv over 3 channels, got "
                         f"{tuple(w_oihw.shape)}")
    w27 = w_oihw.permute(2, 3, 1, 0).reshape(27, f).to(dtype).contiguous()
    if w27.is_cuda:
        w27 = pad_columns(w27, plan(f, dtype))
    return w27, bias.float().contiguous()


def block0_plain(lum4, chroma, w27, bias, slope, inv_out=None):
    """Plain version of the kernel: same inputs, same output. Computes in
    float32 from the inputs as given (the compute dtype), rounds once to
    that dtype, or quantizes to int8 under ``inv_out``. ``w27`` may be
    padded (:func:`block0_weights`): the padded filters are computed with a
    zero bias, as the kernel computes them, and dropped."""
    f, fp = bias.shape[0], w27.shape[1]
    p = unpack_s2d(lum4, chroma).float()
    w = w27.float().reshape(3, 3, 3, fp).permute(3, 2, 0, 1)
    y = F.conv2d(p, w, pad_columns(bias.float(), fp))
    y = torch.where(y >= 0, y, slope.float() * y)
    y = F.max_pool2d(y, 2, 2, ceil_mode=True).permute(0, 2, 3, 1)[..., :f]
    if inv_out is not None:
        return quantize_out(y, inv_out).contiguous()
    return y.to(lum4.dtype).contiguous()


def block0_nhwc(x, w_oihw, b, slope):
    """pool(prelu(conv3x3_same(x))) of NHWC ``x`` through
    :func:`fused_block0` in the dtype of ``x``; returns NHWC
    [B, H/2, W/2, F]. The parity entry around the kernel."""
    lum4, chroma = pack_s2d(x)
    w27, bias = block0_weights(w_oihw, b, x.dtype)
    return fused_block0(lum4, chroma, w27, bias,
                        torch.as_tensor(slope, dtype=torch.float32,
                                        device=x.device).reshape(1))


def fused_block0(lum4, chroma, w27, bias, slope, inv_out=None):
    """lum4 [B, 4, Hc, Wc] and chroma [B, Hc, 8, Wc] in the compute dtype
    (float32 or bfloat16), w27 [27, F] in the same dtype, or padded (see
    :func:`block0_weights`; padded here where it is not), bias [F]
    float32, slope [1] float32, and optionally ``inv_out`` [1] float32.
    Returns NHWC [B, Hc-1, Wc-1, F] in the compute dtype, or int8 under
    ``inv_out``."""
    if lum4.device.type == "cpu":
        return block0_plain(lum4, chroma, w27, bias, slope, inv_out)
    B, _, Hc, Wc = lum4.shape
    f = bias.shape[0]
    dt = lum4.dtype
    w27 = pad_columns(w27, plan(f, dt))
    check_cuda("lum4", lum4, dt, (B, 4, Hc, Wc))
    check_cuda("chroma", chroma, dt, (B, Hc, 8, Wc))
    check_cuda("w27", w27, dt, (27, plan(f, dt)))
    check_cuda("bias", bias, torch.float32, (f,))
    check_cuda("slope", slope, torch.float32, (1,))
    shape = (B, Hc - 1, Wc - 1, f)
    if inv_out is None:
        out = torch.empty(shape, dtype=dt, device=lum4.device)
        KERNEL.launch(dt, ptr(lum4), ptr(chroma), ptr(w27), ptr(bias),
                      ptr(slope), ptr(out), B, Hc, Wc, f)
        return out
    check_cuda("inv_out", inv_out, torch.float32, (1,))
    out = torch.empty(shape, dtype=torch.int8, device=lum4.device)
    S8_KERNEL.launch(dt, ptr(lum4), ptr(chroma), ptr(w27), ptr(bias),
                     ptr(slope), ptr(inv_out), ptr(out), B, Hc, Wc, f)
    return out
