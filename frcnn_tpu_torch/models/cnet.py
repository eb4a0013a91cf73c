"""Classification head: MLP over pooled ROI features with a 4-dim box
refinement head and a log-softmax class head.

Port of the JAX package's ``models/cnet.py``: Linear -> (BatchNorm) ->
PReLU -> (Dropout, in training) per hidden layer, then ``Linear(prev, 4)``
and ``Linear(prev, C+1)`` + LogSoftMax. The input is the pooled ROI
``[B, D, kh, kw, C]`` flattened in (y, x, c) order, the order of the
JAX package's fc0 kernel rows. It computes in the dtype of its Linear
parameters, and batch norm in float32 (see ``models/pnet.py``). Linear and
PReLU parameters are left uninitialised (``skip_init``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from frcnn_tpu_torch.config import ModelConfig
from frcnn_tpu_torch.models.layers import (
    MaskedBatchNorm,
    apply_dropout,
    keep_mask,
    prelu,
)


class ClassificationNet(nn.Module):
    def __init__(self, model_cfg: ModelConfig, num_classes_with_bg: int,
                 in_features: int):
        super().__init__()
        self.model_cfg = model_cfg
        n = in_features
        for li, spec in enumerate(model_cfg.class_layers):
            self.add_module(f"fc{li}", skip_init(nn.Linear, n, spec.n))
            if spec.batch_norm:
                self.add_module(f"bn{li}", MaskedBatchNorm(spec.n))
            self.add_module(f"prelu{li}", skip_init(nn.PReLU))
            n = spec.n
        self.reg_head = skip_init(nn.Linear, n, 4)
        self.cls_head = skip_init(nn.Linear, n, num_classes_with_bg)

    def dropout_masks(self, rows_shape, generator: torch.Generator,
                      device) -> list:
        """The dropout keep masks of one training forward on ``[*rows_shape,
        D]`` rows, drawn from ``generator`` layer by layer: [*rows_shape,
        n] bool for each hidden layer, None for a layer whose rate is 0
        (which draws nothing)."""
        return [keep_mask((*rows_shape, spec.n), spec.dropout, generator,
                          device) if spec.dropout > 0 else None
                for spec in self.model_cfg.class_layers]

    def forward(self, x, mask=None, train: bool = False, masks=None):
        """x: [..., R, D] -> (reg [..., R, 4] float32, log_probs
        [..., R, C+1] float32).

        ``train``: batch norm over the valid rows (``mask`` [..., R], None =
        all valid) of each leading group, and dropout with ``masks``
        (:meth:`dropout_masks`); then a third output, the new batch-norm
        running statistics ``{"bn<i>.running_mean": ...,
        "bn<i>.running_var": ...}`` (the buffers themselves are not
        written)."""
        x = x.to(self.reg_head.weight.dtype)
        new_stats = {}
        for li, spec in enumerate(self.model_cfg.class_layers):
            x = getattr(self, f"fc{li}")(x)
            if spec.batch_norm:
                bn = getattr(self, f"bn{li}")
                if train:
                    x, (new_stats[f"bn{li}.running_mean"],
                        new_stats[f"bn{li}.running_var"]) = bn(x, mask, True)
                else:
                    x = bn(x)
            x = prelu(x, getattr(self, f"prelu{li}").weight)
            if train and spec.dropout > 0:
                if masks is None:
                    raise ValueError("a training forward with dropout needs "
                                     "its masks")
                x = apply_dropout(x, masks[li], spec.dropout)
        reg = self.reg_head(x).float()
        log_probs = F.log_softmax(self.cls_head(x).float(), dim=-1)
        if train:
            return reg, log_probs, new_stats
        return reg, log_probs
