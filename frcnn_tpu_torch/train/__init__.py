"""Training: the joint objective, optimizers and the trainer."""

from frcnn_tpu_torch.train.losses import (
    cross_entropy_fg_bg,
    nll_loss,
    smooth_l1,
)
from frcnn_tpu_torch.train.objective import TrainBatch, build_objective

__all__ = [
    "smooth_l1",
    "cross_entropy_fg_bg",
    "nll_loss",
    "TrainBatch",
    "build_objective",
]
