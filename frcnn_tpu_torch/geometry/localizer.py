"""Receptive-field mapping between input-image space and feature-map space.

Port of the JAX package's ``geometry/localizer.py``: the layer list comes
from the declarative model config, the arithmetic is ``Localizer.lua``'s
(float cascade, valid-convolution shrink per layer, snap to integers at
the end). The host methods work on Python scalars; the ``*_t`` methods are
their tensor versions for per-image true sizes on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from frcnn_tpu_torch.config import ModelConfig


@dataclass(frozen=True)
class LayerInfo:
    """Spatial parameters of one conv/pool layer (``Localizer.lua:29-37``)."""

    kW: int
    kH: int
    dW: int = 1
    dH: int = 1
    padW: int = 0
    padH: int = 0
    ceil_mode: bool = False  # pools round up, convs down

    def out_size(self, in_w: int, in_h: int) -> Tuple[int, int]:
        """Output spatial size (W, H) of this layer."""
        def one(n, k, d, p):
            if self.ceil_mode:
                o = -(-(n + 2 * p - k) // d) + 1
                # the last window must start inside the (padded) input
                if (o - 1) * d >= n + p:
                    o -= 1
            else:
                o = (n + 2 * p - k) // d + 1
            return o

        return (one(in_w, self.kW, self.dW, self.padW),
                one(in_h, self.kH, self.dH, self.padH))


def _block_layers(model: ModelConfig, num_blocks: int) -> List[LayerInfo]:
    """Conv and pool layers of the first ``num_blocks`` backbone blocks."""
    layers: List[LayerInfo] = []
    for spec in model.layers[:num_blocks]:
        for _ in range(spec.conv_steps):
            layers.append(LayerInfo(kW=spec.kW, kH=spec.kH, dW=1, dH=1,
                                    padW=spec.padW, padH=spec.padH))
        layers.append(LayerInfo(kW=2, kH=2, dW=2, dH=2, ceil_mode=True))
    return layers


def layer_infos_for_tap(model: ModelConfig, tap_index: int) -> List[LayerInfo]:
    """Layers seen from anchor map ``tap_index``: the backbone blocks up to
    the anchor net's input block, then its kxk valid conv and 1x1 conv."""
    spec = model.anchor_nets[tap_index]
    layers = _block_layers(model, spec.input)
    layers.append(LayerInfo(kW=spec.kW, kH=spec.kW))
    layers.append(LayerInfo(kW=1, kH=1))
    return layers


def layer_infos_for_feature_map(model: ModelConfig) -> List[LayerInfo]:
    """Layers seen from the shared feature map (all backbone blocks)."""
    return _block_layers(model, len(model.layers))


class Localizer:
    """Maps rects between input space and one feature-map space."""

    def __init__(self, layers: Sequence[LayerInfo]):
        self.layers = list(layers)
        # feature_to_input is affine: input = scale * feature + offset
        z = self.feature_to_input_rect(0.0, 0.0, 0.0, 0.0)
        o = self.feature_to_input_rect(1.0, 1.0, 1.0, 1.0)
        self.scale_x = o[0] - z[0]
        self.scale_y = o[1] - z[1]
        self.offset_min_x, self.offset_min_y = z[0], z[1]
        self.offset_max_x, self.offset_max_y = z[2], z[3]

    def feature_to_input_rect(self, min_x, min_y, max_x, max_y,
                              layer_index: Optional[int] = None):
        """``Localizer:featureToInputRect`` (``Localizer.lua:69-79``) through
        the first ``layer_index`` layers (default: all of them)."""
        n = len(self.layers) if layer_index is None else layer_index
        for l in reversed(self.layers[:n]):
            min_x = min_x * l.dW - l.padW
            min_y = min_y * l.dH - l.padH
            max_x = max_x * l.dW - l.padW + l.kW - l.dW
            max_y = max_y * l.dH - l.padH + l.kH - l.dH
        return (min_x, min_y, max_x, max_y)

    def input_to_feature_rect(self, min_x, min_y, max_x, max_y,
                              layer_index: Optional[int] = None):
        """``Localizer:inputToFeatureRect`` (``Localizer.lua:41-67``) on
        host scalars through the first ``layer_index`` layers (default: all
        of them); returns integer (floor-min, ceil-max) coordinates."""
        n = len(self.layers) if layer_index is None else layer_index
        for l in self.layers[:n]:
            if l.dW < l.kW:
                min_x -= l.kW - l.dW
                max_x += l.kW - l.dW
                min_y -= l.kH - l.dH
                max_y += l.kH - l.dH
            min_x += l.padW
            max_x += l.padW
            min_y += l.padH
            max_y += l.padH
            min_x = min_x / l.dW
            min_y = min_y / l.dH
            max_x = max(math.ceil((max_x - l.kW) / l.dW) + 1, min_x + 1)
            max_y = max(math.ceil((max_y - l.kH) / l.dH) + 1, min_y + 1)
        return (math.floor(min_x), math.floor(min_y),
                math.ceil(max_x), math.ceil(max_y))

    def input_to_feature_rect_t(self, rects):
        """Tensor version of :meth:`input_to_feature_rect` on ``[..., 4]``
        float rects (float32 arithmetic, as the JAX package's
        ``input_to_feature_rect_jax``)."""
        min_x, min_y, max_x, max_y = rects.unbind(-1)
        for l in self.layers:
            if l.dW < l.kW:
                min_x = min_x - (l.kW - l.dW)
                max_x = max_x + (l.kW - l.dW)
                min_y = min_y - (l.kH - l.dH)
                max_y = max_y + (l.kH - l.dH)
            min_x = (min_x + l.padW) / l.dW
            min_y = (min_y + l.padH) / l.dH
            max_x = torch.maximum(
                torch.ceil((max_x + l.padW - l.kW) / l.dW) + 1, min_x + 1)
            max_y = torch.maximum(
                torch.ceil((max_y + l.padH - l.kH) / l.dH) + 1, min_y + 1)
        return torch.stack([torch.floor(min_x), torch.floor(min_y),
                            torch.ceil(max_x), torch.ceil(max_y)], dim=-1)

    def feature_map_size(self, in_w: int, in_h: int) -> Tuple[int, int]:
        """Static (W, H) of the feature map for an input of (in_w, in_h)."""
        w, h = in_w, in_h
        for l in self.layers:
            w, h = l.out_size(w, h)
        return w, h

    def feature_map_size_t(self, in_w, in_h):
        """Tensor version of :meth:`feature_map_size` for per-image true
        sizes (convs floor, 2x2/2 pools ceil). Returns int32 (w, h)."""
        w = torch.as_tensor(in_w).to(torch.float32)
        h = torch.as_tensor(in_h).to(torch.float32)
        for l in self.layers:
            rnd = torch.ceil if l.ceil_mode else torch.floor
            w = rnd((w + 2 * l.padW - l.kW) / l.dW) + 1
            h = rnd((h + 2 * l.padH - l.kH) / l.dH) + 1
        return w.to(torch.int32), h.to(torch.int32)
