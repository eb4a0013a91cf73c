"""Int8 serving path of the proposal network.

Port of the JAX package's ``models/quant.py``. Scheme: symmetric
per-output-channel int8 weights (:func:`quantize_weight`, once, from the
float32 module) and symmetric per-tensor int8 activations, at a scale
computed per call (abs-max, the dynamic chain) or calibrated once
(:func:`calibrate_pnet_scales`, the static chain). Each convolution sums
int8 products in int32 (``ops/int8_conv.py``) and is dequantized into the
bias, PReLU and pool epilogue in the activation dtype.

With ``pool_s8`` and static scales, a block's activation is quantized at
the scale of the conv that consumes the block's output and pooled in int8
(exact: ``round(x / s)`` is monotone, so the max commutes with it); the
consumer takes the ``(int8, scale)`` pair as it is, and the feature map is
dequantized for the ROI pool.

Tensors are NHWC, as in the JAX package. Every scale is a float32 tensor
on the device of the activations, never a Python number: CUDA PyTorch
divides by a Python (CPU) scalar as a multiply by its reciprocal, which is
not the ``x / s`` that the JAX functions compute.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from frcnn_tpu_torch.config import ModelConfig
from frcnn_tpu_torch.ops import int8_conv

SCALE_FLOOR = 1e-12


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as a true float32 division on the device of ``x``."""
    return x / torch.as_tensor(d, dtype=torch.float32, device=x.device)


def quantize_weight(w: torch.Tensor):
    """float32 OIHW [N, C, kh, kw] -> (int8 OIHW weights, float32 [N]
    scales): ``s = max(max|w| / 127, 1e-12)`` per output channel,
    ``clip(round(w / s), -127, 127)`` (``quant.py:29``)."""
    w = w.detach().float()
    s = torch.clamp_min(_div(w.abs().amax(dim=(1, 2, 3)), 127.0),
                        SCALE_FLOOR)
    wq = torch.clamp(torch.round(w / s[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), s


def quantize_act(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``clip(round(float32(x) / s), -127, 127)`` as int8: the division
    form of ``quant.py:58``."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """``max(max|x| / 127, 1e-12)`` as a float32 0-dim tensor."""
    return torch.clamp_min(_div(x.abs().amax().float(), 127.0), SCALE_FLOOR)


def ceil_max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 ceil-mode max pool of NHWC ``x`` of any dtype; an odd
    edge is padded with the max identity, the dtype's minimum for int8
    (``frcnn_tpu/models/layers.py:69-79``)."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        fill = (-torch.inf if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2), value=fill)
    B, H, W, C = x.shape
    return x.view(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _prelu(x, slope):
    return torch.where(x >= 0, x, slope.to(x.dtype) * x)


class QConv(nn.Module):
    """One quantized convolution: int8 OIHW weights and the product's
    matrix, per-output-channel float32 scales, the float32 bias."""

    def __init__(self, w_int8: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.register_buffer("w_int8", w_int8)
        self.register_buffer("wmat", int8_conv.weight_matrix(w_int8))
        self.register_buffer("scale", scale.float())
        self.register_buffer("bias", bias.detach().float())
        self.n_out, _, self.kh, self.kw = w_int8.shape


def qconv(x, layer: QConv, padding, act_dtype, s_x=None):
    """Quantize, int8 convolution with int32 sums, dequantize
    (``quant.py:65``): ``float32(sums) * (s_x * s_w) + bias`` in the
    activation dtype.

    ``x``: an NHWC float tensor, quantized at ``s_x`` (abs-max per call
    when None), or an ``(int8 NHWC, scale)`` pair taken as it is.
    ``padding``: ((top, bottom), (left, right))."""
    if isinstance(x, tuple):
        xq, s_x = x
    else:
        if s_x is None:
            s_x = dynamic_scale(x)
        xq = quantize_act(x, s_x)
    acc = int8_conv.conv2d_int8(xq, layer.wmat, layer.kh, layer.kw, padding,
                                layer.n_out)
    out = acc.float() * (s_x * layer.scale) + layer.bias
    return out.to(act_dtype)


def quantize_pnet(pnet) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's float32 ``ProposalNet`` -> {conv name: {"w_int8",
    "scale", "bias"}, PReLU name: {"slope"}}, the counterpart of
    ``quantize_pnet_params`` (``quant.py:37``): slopes and biases stay
    float32."""
    q: Dict[str, Dict[str, torch.Tensor]] = {}
    cfg = pnet.model_cfg

    def add_conv(name):
        conv = getattr(pnet, name)
        wq, s = quantize_weight(conv.weight)
        q[name] = {"w_int8": wq, "scale": s,
                   "bias": conv.bias.detach().float()}

    def add_prelu(name):
        q[name] = {"slope": getattr(pnet, name).weight.detach().float()}

    for bi, spec in enumerate(cfg.layers):
        for si in range(spec.conv_steps):
            add_conv(f"block{bi}_conv{si}")
            add_prelu(f"block{bi}_prelu{si}")
    for ai in range(len(cfg.anchor_nets)):
        add_conv(f"anchor{ai}_conv")
        add_conv(f"anchor{ai}_out")
        add_prelu(f"anchor{ai}_prelu")
    return q


class QuantizedPNet(nn.Module):
    """The int8 proposal network: counterpart of ``QuantizedPNetAdapter``
    (``quant.py:208``), called like ``ProposalNet`` by the detector.

    ``act_scales``: {conv name: float32 0-dim tensor}, static input scales
    (absent entries are computed per call); set by :meth:`calibrate` or
    :meth:`set_act_scales`. ``pool_s8`` only acts with static scales."""

    def __init__(self, model_cfg: ModelConfig, qparams: Dict,
                 act_dtype=torch.bfloat16, act_scales: Optional[Dict] = None,
                 pool_s8: bool = False):
        super().__init__()
        self.model_cfg = model_cfg
        self.act_dtype = act_dtype
        self.pool_s8 = pool_s8
        self.convs = nn.ModuleDict()
        for name, p in qparams.items():
            if "w_int8" in p:
                self.convs[name] = QConv(p["w_int8"], p["scale"], p["bias"])
            else:
                self.register_buffer(f"{name}_slope", p["slope"].float())
        self.act_scales = None
        if act_scales is not None:
            self.set_act_scales(act_scales)

    def set_act_scales(self, scales: Dict) -> "QuantizedPNet":
        """Static scales (tensors or numbers) as float32 0-dim tensors on
        the module's device."""
        dev = next(self.buffers()).device
        self.act_scales = {
            k: (v if isinstance(v, torch.Tensor) else torch.tensor(float(v)))
            .to(dev, torch.float32).reshape(())
            for k, v in scales.items()}
        return self

    def slope(self, name: str) -> torch.Tensor:
        return getattr(self, f"{name}_slope")

    def forward(self, x, block0_out=None, record: Optional[Dict] = None):
        """NHWC ``x`` [B, H, W, 3] (or None with ``block0_out``) ->
        (anchor maps [B, Hi, Wi, 18] each, feature map [B, Hf, Wf, C]) in
        the activation dtype: ``quant_pnet_apply`` (``quant.py:103``).

        ``block0_out``: the first block's output (a float NHWC tensor or
        an ``(int8, scale)`` pair); block 0 is then skipped. ``record``: a
        dict that receives each dynamically computed scale (calibration);
        it turns the static scales and ``pool_s8`` off."""
        cfg, dt = self.model_cfg, self.act_dtype
        scales = None if record is not None else self.act_scales
        pool_s8 = self.pool_s8 and scales is not None

        def conv(h, name, pad):
            if isinstance(h, tuple):
                return qconv(h, self.convs[name], pad, dt)
            s_x = None if scales is None else scales.get(name)
            if s_x is None and record is not None:
                s_x = dynamic_scale(h)
                record[name] = s_x
            return qconv(h, self.convs[name], pad, dt, s_x=s_x)

        def next_consumer_scale(bi):
            if bi + 1 < len(cfg.layers):
                return scales.get(f"block{bi + 1}_conv0")
            for ai, aspec in enumerate(cfg.anchor_nets):
                if aspec.input - 1 == bi:
                    return scales.get(f"anchor{ai}_conv")
            return None

        block_outputs = []
        if block0_out is not None:
            h = (block0_out if isinstance(block0_out, tuple)
                 else block0_out.to(dt))
            block_outputs.append(h)
        else:
            h = x.to(dt)
        for bi, spec in enumerate(cfg.layers):
            if block0_out is not None and bi == 0:
                continue
            pad = ((spec.padH, spec.padH), (spec.padW, spec.padW))
            for si in range(spec.conv_steps):
                h = conv(h, f"block{bi}_conv{si}", pad)
                h = _prelu(h, self.slope(f"block{bi}_prelu{si}"))
            s_next = next_consumer_scale(bi) if pool_s8 else None
            if s_next is not None:
                h = (ceil_max_pool_2x2(quantize_act(h, s_next)), s_next)
            else:
                h = ceil_max_pool_2x2(h)
            block_outputs.append(h)

        valid = ((0, 0), (0, 0))
        anchor_maps = []
        for ai, aspec in enumerate(cfg.anchor_nets):
            a = conv(block_outputs[aspec.input - 1], f"anchor{ai}_conv",
                     valid)
            a = _prelu(a, self.slope(f"anchor{ai}_prelu"))
            anchor_maps.append(conv(a, f"anchor{ai}_out", valid))
        fm = block_outputs[-1]
        if isinstance(fm, tuple):
            fm = (fm[0].float() * fm[1]).to(dt)
        return anchor_maps, fm

    @torch.no_grad()
    def calibrate(self, images, block0_out=None, extra_scales=None):
        """Record static scales from a calibration batch
        (:func:`calibrate_pnet_scales`) and keep them, with
        ``extra_scales`` added."""
        scales = calibrate_pnet_scales(self, images, block0_out=block0_out)
        if extra_scales:
            scales.update(extra_scales)
        return self.set_act_scales(scales)


@torch.no_grad()
def calibrate_pnet_scales(qpnet: QuantizedPNet, images,
                          block0_out=None) -> Dict[str, torch.Tensor]:
    """{conv name: scale} recorded through the dynamic quantized forward
    over ``images`` (``quant.py:188``, at its default margin of 1);
    ``block0_out``: the first block's output from the serving producer
    (its own convs are then not recorded)."""
    record: Dict[str, torch.Tensor] = {}
    qpnet(images, block0_out=block0_out, record=record)
    return record
