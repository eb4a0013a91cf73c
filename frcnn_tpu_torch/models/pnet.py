"""Proposal network: VGG-style backbone + 4 multi-scale anchor heads.

Port of the JAX package's ``models/pnet.py``. Block ``bi`` is
``conv_steps`` 3x3/1/1 convolutions with PReLU (in training a
SpatialDropout after the block's first conv only, ``model_utilities.lua:22``)
and a 2x2/2 ceil max pool; anchor head ``i`` is a kxk valid conv + PReLU +
1x1 conv to 18 channels on the output of block ``anchor_nets[i].input``.

``pool_vjp`` picks the pools' backward: ``"library"`` is ``F.max_pool2d``'s
own (the JAX package's default ``"xla"``), ``"kernel"`` the first-max CUDA
kernel of ``ops/pool_bwd_kernel.py`` (its ``"pallas"``); the forward values
are the same either way.

The module computes in the dtype of its parameters: float32 as built,
or the compute dtype once ``models/factory.py::for_compute`` has cast a
copy (what the flax modules do at each call, done once). Parameters are
left uninitialised here (``skip_init``): load a state dict or use
``models/factory.py::init_models``. Inputs and outputs
are NHWC, as in the JAX package; inside, the tensors are NCHW views of
channels_last memory, so no layout copy is made between the NHWC block0
kernel output and the convolutions.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from frcnn_tpu_torch.config import ModelConfig
from frcnn_tpu_torch.models.layers import (
    apply_dropout,
    ceil_max_pool_2x2,
    keep_mask,
    prelu,
)
from frcnn_tpu_torch.ops.pool_bwd_kernel import ceil_max_pool_2x2_firstmax

ANCHOR_CHANNELS = 3 * (2 + 4)  # 3 aspects x (2 cls + 4 reg) = 18
POOL_VJPS = {"library": ceil_max_pool_2x2,
             "kernel": ceil_max_pool_2x2_firstmax}


class ProposalNet(nn.Module):
    def __init__(self, model_cfg: ModelConfig, pool_vjp: str = "library"):
        super().__init__()
        if pool_vjp not in POOL_VJPS:
            raise ValueError(f"pool_vjp must be one of {sorted(POOL_VJPS)}, "
                             f"got {pool_vjp!r}")
        self.model_cfg = model_cfg
        self.pool_vjp = pool_vjp
        cin = 3
        for bi, spec in enumerate(model_cfg.layers):
            for si in range(spec.conv_steps):
                self.add_module(f"block{bi}_conv{si}", skip_init(
                    nn.Conv2d, cin, spec.filters, (spec.kH, spec.kW),
                    padding=(spec.padH, spec.padW)))
                self.add_module(f"block{bi}_prelu{si}", skip_init(nn.PReLU))
                cin = spec.filters
        for ai, aspec in enumerate(model_cfg.anchor_nets):
            c_in = model_cfg.layers[aspec.input - 1].filters
            self.add_module(f"anchor{ai}_conv",
                            skip_init(nn.Conv2d, c_in, aspec.n, aspec.kW))
            self.add_module(f"anchor{ai}_prelu", skip_init(nn.PReLU))
            self.add_module(f"anchor{ai}_out", skip_init(
                nn.Conv2d, aspec.n, ANCHOR_CHANNELS, 1))

    def dropout_masks(self, batch: int, generator: torch.Generator,
                      device) -> list:
        """The spatial-dropout keep masks of one training forward, drawn
        from ``generator`` block by block: [batch, filters, 1, 1] bool for
        each block, None for a block whose rate is 0 (which draws
        nothing)."""
        return [keep_mask((batch, spec.filters, 1, 1), spec.dropout,
                          generator, device) if spec.dropout > 0 else None
                for spec in self.model_cfg.layers]

    def forward(self, x, block0_out=None, train: bool = False, masks=None):
        """x: NHWC [B, H, W, 3] -> (anchor maps [B, Hi, Wi, 18] each,
        feature map [B, Hf, Wf, C_last]), in the compute dtype.

        ``block0_out``: NHWC output of the first block (from the fused
        block0 kernel); block 0's layers are then skipped. ``train``: apply
        the spatial dropouts with ``masks`` (:meth:`dropout_masks`)."""
        dt = self.block0_conv0.weight.dtype
        pool = POOL_VJPS[self.pool_vjp]
        if block0_out is not None:
            h = block0_out.to(dt).permute(0, 3, 1, 2)
            block_outputs = [h]
        else:
            h = x.to(dt).permute(0, 3, 1, 2)
            block_outputs = []
        for bi, spec in enumerate(self.model_cfg.layers):
            if block0_out is not None and bi == 0:
                continue
            for si in range(spec.conv_steps):
                h = getattr(self, f"block{bi}_conv{si}")(h)
                h = prelu(h, getattr(self, f"block{bi}_prelu{si}").weight)
                if train and si == 0 and spec.dropout > 0:
                    if masks is None:
                        raise ValueError("a training forward with dropout "
                                         "needs its masks")
                    h = apply_dropout(h, masks[bi], spec.dropout)
            h = pool(h)
            block_outputs.append(h)

        anchor_maps = []
        for ai, aspec in enumerate(self.model_cfg.anchor_nets):
            a = getattr(self, f"anchor{ai}_conv")(
                block_outputs[aspec.input - 1])
            a = prelu(a, getattr(self, f"anchor{ai}_prelu").weight)
            a = getattr(self, f"anchor{ai}_out")(a)
            anchor_maps.append(a.permute(0, 2, 3, 1))
        return anchor_maps, block_outputs[-1].permute(0, 2, 3, 1)
