"""Normalization, NMS, ROI pooling and the fused first block, each kernel beside its plain PyTorch version."""
