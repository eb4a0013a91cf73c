"""Batched detection."""

from frcnn_tpu_torch.detect.detector import DetectionResult, Detector

__all__ = ["Detector", "DetectionResult"]
