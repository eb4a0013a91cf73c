"""Loss primitives of the reference's Torch criterions
(``objective.lua:24-27``), as the JAX package's ``train/losses.py``:
CrossEntropyCriterion on the 2-logit fg/bg head, SmoothL1Criterion
(callers reduce by sum) and ClassNLLCriterion on log-probabilities."""

from __future__ import annotations

import torch


def smooth_l1(pred, target):
    """Elementwise Huber with delta 1 (torch SmoothL1): 0.5 d^2 if |d| < 1
    else |d| - 0.5. No reduction: callers mask and sum."""
    d = pred - target
    ad = torch.abs(d)
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def cross_entropy_fg_bg(logits2, is_fg):
    """Per-example 2-class cross entropy: logits2 [..., 2] (channel 0 = fg,
    ``objective.lua:104-106, 131-133``); ``is_fg`` (bool or a bool tensor
    [...]) selects the target class (fg = 0, bg = 1)."""
    logp = torch.log_softmax(logits2, dim=-1)
    is_fg = torch.as_tensor(is_fg, device=logits2.device)
    return torch.where(is_fg, -logp[..., 0], -logp[..., 1])


def nll_loss(log_probs, targets):
    """Per-example negative log likelihood: log_probs [..., C], integer
    targets [...]."""
    return -torch.gather(log_probs, -1,
                         targets.to(torch.int64)[..., None])[..., 0]
