"""Proposal and classification networks."""

from frcnn_tpu_torch.models.cnet import ClassificationNet
from frcnn_tpu_torch.models.factory import create_models, init_models
from frcnn_tpu_torch.models.pnet import ProposalNet

# init_models: the JAX package's init_params (seeded modules, not a tree)
__all__ = ["ProposalNet", "ClassificationNet", "create_models",
           "init_models"]
