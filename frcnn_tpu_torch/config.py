"""Experiment configuration of the PyTorch port.

The same frozen dataclasses and the same JSON schema as the JAX package's
``frcnn_tpu/config.py`` (a config written by either package loads in the
other). The port keeps its own copy so that it never imports the JAX
package. Fields that select TPU code paths (``pallas_mode``,
``input_layout``, ``s2d_block0_int8``, ``quant_pool_s8``,
``s2d_block0_layout``, ``remat``) are carried for schema compatibility; the
port reads ``pallas_mode`` ("off" runs the plain PyTorch versions of the
kernels everywhere, anything else the hand-written CUDA kernels on CUDA
tensors), ``input_layout``, and for the int8 serving chain
``quant_pool_s8`` and ``s2d_block0_int8``; the training objective reads
``remat`` (pnet recomputed in the backward pass, ``train/objective.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class NormalizationConfig:
    """Input normalization (reference ``config/duplo.lua:6``)."""

    method: str = "contrastive"  # 'contrastive' | 'none'
    width: int = 7               # gaussian kernel width for contrastive norm
    centering: bool = True       # per-channel mean subtraction
    scaling: bool = True         # per-channel std division


@dataclass(frozen=True)
class AugmentationConfig:
    """Data augmentation probabilities (reference ``config/duplo.lua:7``)."""

    vflip: float = 0.0
    hflip: float = 0.0
    random_scaling: float = 0.0
    aspect_jitter: float = 0.0


@dataclass(frozen=True)
class RoiPoolingConfig:
    """Adaptive max-pool output grid (reference ``config/duplo.lua:9``)."""

    kw: int = 6
    kh: int = 6


@dataclass(frozen=True)
class LayerSpec:
    """One conv block of the backbone: ``conv_steps`` conv+PReLU layers
    followed by a ceil-mode 2x2/2 max-pool."""

    filters: int
    kW: int = 3
    kH: int = 3
    padW: int = 1
    padH: int = 1
    dropout: float = 0.0
    conv_steps: int = 1


@dataclass(frozen=True)
class AnchorNetSpec:
    """One anchor head: conv(kW x kW -> n) + PReLU + 1x1 conv -> 18 channels
    (3 aspects x (2 cls + 4 reg)); attaches to backbone block ``input``
    (1-based like the reference)."""

    kW: int
    n: int
    input: int


@dataclass(frozen=True)
class ClassLayerSpec:
    """One hidden layer of the classifier head."""

    n: int
    dropout: float = 0.0
    batch_norm: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Declarative model architecture."""

    name: str = "vgg_small"
    layers: Tuple[LayerSpec, ...] = ()
    anchor_nets: Tuple[AnchorNetSpec, ...] = ()
    class_layers: Tuple[ClassLayerSpec, ...] = ()
    anchor_net_filters_cls: int = 256


def vgg_small_model() -> ModelConfig:
    """Reference ``models/vgg_small.lua:3-24``."""
    return ModelConfig(
        name="vgg_small",
        layers=(
            LayerSpec(filters=64, dropout=0.0, conv_steps=1),
            LayerSpec(filters=128, dropout=0.4, conv_steps=2),
            LayerSpec(filters=256, dropout=0.4, conv_steps=2),
            LayerSpec(filters=384, dropout=0.4, conv_steps=2),
        ),
        anchor_nets=(
            AnchorNetSpec(kW=3, n=256, input=3),
            AnchorNetSpec(kW=3, n=256, input=4),
            AnchorNetSpec(kW=5, n=256, input=4),
            AnchorNetSpec(kW=7, n=256, input=4),
        ),
        class_layers=(
            ClassLayerSpec(n=1024, dropout=0.5, batch_norm=True),
            ClassLayerSpec(n=512, dropout=0.5),
        ),
    )


def vgg_large_model() -> ModelConfig:
    """Reference ``models/vgg_large.lua:3-24``."""
    return ModelConfig(
        name="vgg_large",
        layers=(
            LayerSpec(filters=64, dropout=0.0, conv_steps=2),
            LayerSpec(filters=128, dropout=0.4, conv_steps=2),
            LayerSpec(filters=256, dropout=0.4, conv_steps=3),
            LayerSpec(filters=512, dropout=0.4, conv_steps=3),
        ),
        anchor_nets=(
            AnchorNetSpec(kW=3, n=256, input=3),
            AnchorNetSpec(kW=3, n=256, input=4),
            AnchorNetSpec(kW=5, n=256, input=4),
            AnchorNetSpec(kW=7, n=256, input=4),
        ),
        class_layers=(
            ClassLayerSpec(n=1024, dropout=0.5, batch_norm=True),
            ClassLayerSpec(n=512, dropout=0.5),
        ),
    )


@dataclass(frozen=True)
class StaticShapeConfig:
    """Fixed-shape envelope: every dynamic list of the reference becomes a
    padded tensor with a validity mask; these are the pad sizes."""

    # Input image bucket after resize (H, W); images are padded
    # bottom/right to it and the true (h, w) travels alongside.
    image_hw: Tuple[int, int] = (450, 800)
    # Optional second bucket for portrait images (H, W).
    portrait_hw: Tuple[int, int] | None = None
    images_per_step: int = 8
    max_gt: int = 32            # ground-truth boxes per image
    max_positives: int = 96     # positive anchor examples per image
    max_negatives: int = 32     # random negative examples per image
    max_nearby: int = 96        # nearby-aversion negatives per image
    # Detection-time caps
    max_proposals: int = 512    # proposals entering first NMS
    max_detections: int = 128   # survivors entering the classifier head

    @property
    def max_roi_examples(self) -> int:
        return self.max_positives + self.max_negatives + self.max_nearby

    def buckets(self):
        """All configured buckets, primary first."""
        out = [tuple(self.image_hw)]
        if self.portrait_hw is not None:
            out.append(tuple(self.portrait_hw))
        return out

    def bucket_for(self, h: int, w: int) -> Tuple[int, int]:
        """Smallest configured bucket that fits an (h, w) image; falls back
        to the primary bucket (caller crops) if none fits."""
        fitting = [b for b in self.buckets() if h <= b[0] and w <= b[1]]
        if fitting:
            return min(fitting, key=lambda b: b[0] * b[1])
        return tuple(self.image_hw)


@dataclass(frozen=True)
class Config:
    """Experiment config, superset of the reference's ``config/*.lua``."""

    class_count: int = 16            # excluding background
    target_smaller_side: int = 450
    scales: Tuple[int, ...] = (32, 64, 128, 256)
    max_pixel_size: int = 1000
    normalization: NormalizationConfig = field(default_factory=NormalizationConfig)
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    color_space: str = "yuv"         # 'rgb' | 'yuv' | 'lab' | 'hsv'
    roi_pooling: RoiPoolingConfig = field(default_factory=RoiPoolingConfig)
    examples_base_path: str = ""
    background_base_path: str = ""
    batch_size: int = 256
    positive_threshold: float = 0.5
    negative_threshold: float = 0.25
    best_match: bool = True
    nearby_aversion: bool = True

    model: ModelConfig = field(default_factory=vgg_small_model)
    shapes: StaticShapeConfig = field(default_factory=StaticShapeConfig)

    learning_rate: float = 1e-4
    rms_decay: float = 0.9
    optimizer: str = "rmsprop"       # 'rmsprop' | 'sgd' | 'nag'
    lr_schedule: str = "halve5k"     # 'halve5k' | 'constant'
    total_steps: int = 50_000
    snapshot_interval: int = 1000
    plot_interval: int = 100
    seed: int = 0

    # Compute dtype of the conv/matmul paths; params stay float32.
    compute_dtype: str = "bfloat16"
    remat: bool = False
    # Wire format of host->device images: uint8 RGB when True.
    uint8_wire: bool = False
    # 'off': plain PyTorch versions of the kernels on every device;
    # 'on' / 'interpret': the hand-written kernels on CUDA tensors.
    pallas_mode: str = "off"
    # Final-stage gate: exp(class logprob) > detect_confidence.
    detect_confidence: float = 0.2
    # Stage-1 gate: P(fg) > detect_fg_threshold.
    detect_fg_threshold: float = 0.95
    # Serving input layout: 'nhwc' images or 's2d' host-packed
    # space-to-depth planes (lum4 [B,4,Hc,Wc], chroma [B,Hc,8,Wc]).
    input_layout: str = "nhwc"
    s2d_block0_int8: bool = True
    quant_pool_s8: bool = False
    s2d_block0_layout: str = "zg"

    @property
    def num_classes_with_bg(self) -> int:
        return self.class_count + 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        d["normalization"] = NormalizationConfig(**d["normalization"])
        d["augmentation"] = AugmentationConfig(**d["augmentation"])
        d["roi_pooling"] = RoiPoolingConfig(**d["roi_pooling"])
        m = d["model"]
        m["layers"] = tuple(LayerSpec(**x) for x in m["layers"])
        m["anchor_nets"] = tuple(AnchorNetSpec(**x) for x in m["anchor_nets"])
        m["class_layers"] = tuple(ClassLayerSpec(**x) for x in m["class_layers"])
        d["model"] = ModelConfig(**m)
        sh = dict(d["shapes"])
        sh["image_hw"] = tuple(sh["image_hw"])
        if sh.get("portrait_hw") is not None:
            sh["portrait_hw"] = tuple(sh["portrait_hw"])
        d["shapes"] = StaticShapeConfig(**sh)
        d["scales"] = tuple(d["scales"])
        return Config(**d)


def duplo_config(**overrides) -> Config:
    """Reference ``config/duplo.lua``: 16 classes, scales {32,64,128,256},
    450/1000 px, yuv, 6x6 ROI grid, thresholds 0.5/0.25; the bucket is the
    landscape resize envelope 450x1000."""
    cfg = Config(
        class_count=16,
        target_smaller_side=450,
        scales=(32, 64, 128, 256),
        max_pixel_size=1000,
        augmentation=AugmentationConfig(vflip=0.5, hflip=0.5),
        batch_size=256,
        positive_threshold=0.5,
        negative_threshold=0.25,
        model=vgg_small_model(),
        shapes=StaticShapeConfig(image_hw=(450, 1000)),
    )
    return cfg.replace(**overrides) if overrides else cfg


def imagenet_config(**overrides) -> Config:
    """Reference ``config/imagenet.lua``: 200 classes, scales {48,96,192,384},
    480 px, thresholds 0.6/0.25, with a portrait bucket."""
    cfg = Config(
        class_count=200,
        target_smaller_side=480,
        scales=(48, 96, 192, 384),
        max_pixel_size=1000,
        augmentation=AugmentationConfig(vflip=0.0, hflip=0.25),
        batch_size=300,
        positive_threshold=0.6,
        negative_threshold=0.25,
        model=vgg_large_model(),
        shapes=StaticShapeConfig(image_hw=(480, 1000),
                                 portrait_hw=(1000, 480)),
    )
    return cfg.replace(**overrides) if overrides else cfg


def serving_config(base: Config = None, **overrides) -> Config:
    """The serving form of ``base`` (default :func:`duplo_config`): kernels
    on, host-packed space-to-depth input where the first block is a
    3x3/1/1 block of 1 or 2 convs and every bucket is even-sized, and the
    int8 s8-pooled flag set: with it, ``Detector(..., quantized=True,
    quant_calibration=...)`` serves the full int8 stack (static scales,
    int8 pooling, block 0's int8 kernel modes); without ``quantized`` the
    ``Detector`` serves the float path."""
    cfg = base if base is not None else duplo_config()
    spec0 = cfg.model.layers[0]
    s2d_ok = (
        spec0.conv_steps in (1, 2)
        and (spec0.kH, spec0.kW, spec0.padH, spec0.padW) == (3, 3, 1, 1)
        and all(h % 2 == 0 and w % 2 == 0
                for h, w in cfg.shapes.buckets())
    )
    cfg = cfg.replace(pallas_mode="on",
                      input_layout="s2d" if s2d_ok else "nhwc",
                      quant_pool_s8=True)
    return cfg.replace(**overrides) if overrides else cfg


CONFIGS = {"duplo": duplo_config, "imagenet": imagenet_config}
