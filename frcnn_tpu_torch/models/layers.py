"""Building blocks of the reference's Torch modules.

Port of the JAX package's ``models/layers.py``:

* :func:`prelu` — ``nn.PReLU()``: one slope shared by all channels;
* :func:`ceil_max_pool_2x2` — ``SpatialMaxPooling(2,2,2,2):ceil()``: an odd
  extent gets a last window of one cell (as padding with -inf would);
* :class:`MaskedBatchNorm` — batch norm computed in float32 and returned in
  the compute dtype: running statistics in eval, per-image masked batch
  statistics in training;
* :func:`keep_mask` / :func:`apply_dropout` — flax ``nn.Dropout`` (kept
  values scaled by 1/(1-p)) with a mask drawn ahead from an explicit
  ``torch.Generator``: [B, C, 1, 1] drops whole channels per sample (the
  spatial form). The models take the masks (``dropout_masks``); the
  objective draws them all before the forward, so that a rematerialised
  forward replays them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def prelu(x, slope):
    """``where(x >= 0, x, slope * x)`` with the (1,)-shaped slope cast to
    the dtype of ``x`` (one fused ``F.prelu`` pass)."""
    return F.prelu(x, slope.to(x.dtype))


def ceil_max_pool_2x2(x):
    """2x2 stride-2 ceil-mode max pool of NCHW ``x``."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def keep_mask(shape, rate: float, generator, device):
    """A bool mask of ``shape``, each value True with probability 1-rate,
    drawn from ``generator`` (on ``device``)."""
    keep = torch.full(shape, 1.0 - rate, device=device)
    return torch.bernoulli(keep, generator=generator).to(torch.bool)


def apply_dropout(x, keep, rate: float):
    """``x / (1-rate)`` where ``keep`` (broadcast against ``x``) holds,
    else 0."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MaskedBatchNorm(nn.Module):
    """Batch norm of ``[..., R, F]`` rows with torch defaults (eps 1e-5,
    momentum 0.1), computed in float32, returned in the dtype of ``x``.

    Eval: the running statistics. Training (``train=True``): the statistics
    of the valid rows (``mask [..., R]``) of each leading group, i.e. per
    image, as the reference runs cnet on one image's ROIs at a time
    (``objective.lua:164``); biased variance to normalize. Training returns
    ``(out, (new_mean, new_var))``: the running statistics moved once by the
    mean over images of the per-image mean and unbiased variance (the JAX
    package's divergence from the reference's per-image momentum steps).
    The buffers are not written: the caller keeps or drops the new ones
    (which carry no gradient).
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask=None, train: bool = False):
        xf = x.float()
        if not train:
            inv = torch.rsqrt(self.running_var + self.eps)
            out = (xf - self.running_mean) * inv * self.weight + self.bias
            return out.to(x.dtype)
        if mask is None:
            mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        m = mask.to(torch.float32)[..., None]
        n = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
        mean = (xf * m).sum(dim=-2, keepdim=True) / n
        var = (m * (xf - mean) ** 2).sum(dim=-2, keepdim=True) / n
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        feats = x.shape[-1]
        mom = self.momentum
        new_mean = (1 - mom) * self.running_mean \
            + mom * mean.detach().reshape(-1, feats).mean(dim=0)
        new_var = (1 - mom) * self.running_var \
            + mom * unbiased.detach().reshape(-1, feats).mean(dim=0)
        out = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        return out.to(x.dtype), (new_mean, new_var)
