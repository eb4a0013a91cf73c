"""Mask compaction (the JAX package's ``geometry/matching.py::compact_mask``).

Only what the detect path needs; the training-time matching and sampling
are a later slice.
"""

from __future__ import annotations

import torch


def compact_mask(mask: torch.Tensor, k: int):
    """Indices of the first ``k`` True entries of ``mask`` along its last
    axis, in order, padded with -1. Batched over leading axes.

    Returns (indices [..., k] int32, valid [..., k] bool, count [...] int32).
    """
    n = mask.shape[-1]
    # a stable sort of (not mask) brings the True entries first, in order
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    if k > n:
        order = torch.nn.functional.pad(order, (0, k - n))
    order = order[..., :k]
    total = mask.sum(dim=-1)
    j = torch.arange(k, device=mask.device)
    valid = j < total[..., None]
    out = torch.where(valid, order, torch.full_like(order, -1))
    count = torch.clamp(total, max=k)
    return out.to(torch.int32), valid, count.to(torch.int32)
