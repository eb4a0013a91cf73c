"""Batched detection: pixels to per-class NMS in one pass per batch.

Port of the JAX package's ``detect/detector.py`` (float path):

  1. normalize (``normalize_s2d`` on host-packed planes, or
     ``normalize_image`` on NHWC images);
  2. pnet: the fused block0 kernel on the planes (the 2-conv kernel
     where the first block has two convolutions, as in vgg_large), then
     blocks 1-3 and the anchor heads;
  3. dense decode, keep P(fg) > ``detect_fg_threshold`` inside the image
     and the true-size anchor maps;
  4. top-K (K = ``max_proposals``) by score;
  5. proposal NMS at IoU 0.25 (NMS kernel);
  6. 6x6 ROI adaptive max pool of the survivors (ROI pool kernel);
  7. cnet;
  8. refine, keep non-background with confidence > ``detect_confidence``;
  9. per-class NMS at IoU 0.1 (NMS kernel).

``cfg.pallas_mode`` picks the kernels: "off" runs their plain PyTorch
versions on every device; otherwise the kernel wrappers run, which launch
the CUDA kernels on CUDA tensors and the plain versions on CPU tensors.
Unlike the JAX package, the s2d layout also runs with "off" (the plain
block0 reads the planes too).

``Detector(..., quantized=True)`` serves the int8 chain
(``models/quant.py``): int8 weights quantized once from the float32 pnet,
int8 activations at per-call abs-max scales, or at static scales when
``quant_calibration`` images are given (:func:`calibrate_quantized_pnet`).
With static scales and ``cfg.quant_pool_s8`` (the serving config's
setting) the s2d block0 kernel emits int8 at block 1's input scale
(:func:`compute_s2d_block0`), and the 2-conv block0 also runs its conv1
on int8.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.geometry import boxes as B
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator
from frcnn_tpu_torch.models.factory import compute_dtype, for_compute
from frcnn_tpu_torch.models.quant import QuantizedPNet, quantize_pnet
from frcnn_tpu_torch.ops import (
    block0_2conv_kernel,
    block0_kernel,
    nms_kernel,
    roi_pool_kernel,
)
from frcnn_tpu_torch.ops.nms import class_offset_boxes, plain_nms
from frcnn_tpu_torch.ops import roi_pool as pool_plain
from frcnn_tpu_torch.ops.color import unwire_uint8
from frcnn_tpu_torch.ops.normalization import normalize_image, normalize_s2d

PROPOSAL_NMS_IOU = 0.25     # Detector.lua:81
CLASS_NMS_IOU = 0.1         # Detector.lua:133
STAGES = ("b0", "fwd", "decode", "select", "nms", "pool", "cnet")


def select_proposals(keep, score, k: int):
    """Up to ``k`` gate-passing anchors per image, exact top-k by score,
    ties to the lower anchor index (the order of ``lax.top_k``).

    keep [B, A] bool, score [B, A]. Returns (indices [B, k] int64,
    valid [B, k] bool)."""
    masked = torch.where(keep, score, torch.full_like(score, -torch.inf))
    top_s, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return idx[:, :k], top_s[:, :k] > -torch.inf


class DetectionResult(NamedTuple):
    boxes: torch.Tensor            # [B, D, 4] refined (r2)
    proposal_boxes: torch.Tensor   # [B, D, 4] stage-1 proposals (r)
    classes: torch.Tensor          # [B, D] int32, 0-based
    confidence: torch.Tensor       # [B, D] probability
    fg_score: torch.Tensor         # [B, D] stage-1 P(fg)
    valid: torch.Tensor            # [B, D] bool
    proposals: torch.Tensor        # [B, D, 4] all stage-1 NMS survivors
    proposals_valid: torch.Tensor  # [B, D] bool


def take_rows(x, idx):
    """Gather rows ``idx`` [B, K] along axis 1 of ``x`` [B, N, ...]."""
    idx = idx.long()
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _cut_sum(*tensors):
    """Float32 sum of every finite entry: a checksum of a truncated run."""
    tot = 0.0
    for t in tensors:
        tf = t.float()
        tot = tot + torch.where(torch.isfinite(tf), tf,
                                torch.zeros_like(tf)).sum()
    return tot


def block0_weights_of(cfg: Config, pnet, device):
    """The block0 kernel's weights of ``pnet`` (the float32 module: the
    kernels take float32 biases) on ``device``, in the compute dtype:
    (w27, bias, slope) for a one-conv first block,
    ``Block0TwoConvParams`` for two."""
    dt = compute_dtype(cfg)

    def param(name):
        return getattr(pnet, name).weight.detach().to(device)

    def bias(name):
        return getattr(pnet, name).bias.detach().to(device)

    if cfg.model.layers[0].conv_steps == 2:
        return block0_2conv_kernel.block0_2conv_weights(
            param("block0_conv0"), bias("block0_conv0"),
            param("block0_conv1"), bias("block0_conv1"),
            param("block0_prelu0").float(), param("block0_prelu1").float(),
            dt)
    w27, b = block0_kernel.block0_weights(param("block0_conv0"),
                                          bias("block0_conv0"), dt)
    return w27, b, param("block0_prelu0").float().reshape(1)


def compute_s2d_block0(cfg: Config, pnet, block0_params, lum4, chroma,
                       allow_quant_out: bool = True):
    """The first block from normalized planes in the compute dtype ->
    NHWC [B, H/2, W/2, F] (``frcnn_tpu/detect/detector.py:104-191``).

    ``block0_params``: (w27, bias, slope) of a one-conv first block, or
    ``Block0TwoConvParams``, from the float32 modules. ``pnet``: a
    ``ProposalNet`` (float modes) or a ``QuantizedPNet``. With an s8-pooled
    ``QuantizedPNet`` whose static scales hold ``block1_conv0`` and
    ``allow_quant_out``, the kernel quantizes its output at that scale and
    this returns the ``(int8 NHWC, scale)`` pair block 1's conv takes as
    it is. A 2-conv first block runs its conv1 on int8 when the scales
    also hold ``block0_conv1`` and ``cfg.s2d_block0_int8`` is set.
    Calibration passes ``allow_quant_out=False``, so that it records
    scales from float activations. ``cfg.pallas_mode == "off"`` runs the
    plain versions."""
    kernels = cfg.pallas_mode != "off"
    scales = getattr(pnet, "act_scales", None) or {}
    dev = lum4.device

    def inv(s):
        return torch.ones(1, device=dev) / s.reshape(1)

    s_out = None
    if allow_quant_out and getattr(pnet, "pool_s8", False):
        s_out = scales.get("block1_conv0")
    quant_kw = {} if s_out is None else {"inv_out": inv(s_out)}
    if cfg.model.layers[0].conv_steps == 2:
        p = block0_params
        w1, s_y = p.w1, scales.get("block0_conv1")
        if s_y is not None and cfg.s2d_block0_int8:
            q1 = pnet.convs["block0_conv1"]
            w1, w1_scale = block0_2conv_kernel.block0_2conv_weights_q(
                q1.w_int8, q1.scale, s_y)
            quant_kw.update(w1_scale=w1_scale, inv_y=inv(s_y))
        fn = (block0_2conv_kernel.fused_block0_2conv if kernels
              else block0_2conv_kernel.block0_2conv_plain)
        b0 = fn(lum4, chroma, p.w0, p.b0, w1, p.b1, p.slopes, **quant_kw)
    else:
        fn = (block0_kernel.fused_block0 if kernels
              else block0_kernel.block0_plain)
        b0 = fn(lum4, chroma, *block0_params, **quant_kw)
    return b0 if s_out is None else (b0, s_out)


@torch.no_grad()
def calibrate_quantized_pnet(cfg: Config, qpnet: QuantizedPNet, pnet,
                             block0_params, calib_images) -> None:
    """Record static int8 scales into ``qpnet`` through the config's own
    serving path (``frcnn_tpu/detect/detector.py:194-243``), so that each
    conv is calibrated on what serving feeds it. ``calib_images``:
    [N, H, W, 3] normalized images (numpy or tensor), run on the device
    of ``qpnet``.

    - NHWC layout: the dynamic quantized forward records every scale.
    - s2d layout: the batch is packed and block0 computed by the serving
      producer (:func:`compute_s2d_block0`, float output); the scales
      downstream of it are recorded from that, block 0's own convs not at
      all. A 2-conv first block also gets ``block0_conv1``'s scale (the
      kernel's y0 quantization) from an NHWC conv0 + PReLU in the compute
      dtype, with ``pnet``'s (compute-dtype) conv0."""
    dev = next(qpnet.buffers()).device
    calib = torch.as_tensor(calib_images).to(dev, torch.float32)
    if cfg.input_layout != "s2d":
        qpnet.calibrate(calib)
        return
    cdt = compute_dtype(cfg)
    lum4, chroma = (p.to(cdt) for p in block0_kernel.pack_s2d(calib))
    b0 = compute_s2d_block0(cfg, qpnet, block0_params, lum4, chroma,
                            allow_quant_out=False)
    extra = {}
    spec0 = cfg.model.layers[0]
    if spec0.conv_steps == 2:
        conv0 = pnet.block0_conv0
        x = calib.to(cdt).permute(0, 3, 1, 2)
        y = torch.nn.functional.conv2d(x, conv0.weight.to(cdt),
                                       padding=(spec0.padH, spec0.padW))
        y = y + conv0.bias.to(cdt)[None, :, None, None]
        slope = pnet.block0_prelu0.weight.reshape(()).to(cdt)
        y = torch.where(y >= 0, y, slope * y)
        extra["block0_conv1"] = torch.clamp_min(
            y.abs().amax().float() / torch.full((), 127.0, device=dev),
            1e-12)
    qpnet.calibrate(None, block0_out=b0, extra_scales=extra)


def build_detect_fn(cfg: Config, gen: AnchorGenerator, pnet, cnet,
                    device, block0_params=None,
                    stop_after: str | None = None, counts=None):
    """Returns ``detect(images, true_hw) -> DetectionResult``.

    ``images``: NHWC [B, H, W, 3] tensor for ``input_layout='nhwc'``; the
    (lum4, chroma) plane pair for ``'s2d'``. ``true_hw``: [B, 2] tensor.
    ``pnet``: a ``ProposalNet`` or a ``QuantizedPNet``.
    ``block0_params``: the block0 kernel's weights (s2d only): (w27, bias,
    slope) for a one-conv first block, ``Block0TwoConvParams`` for two.
    ``stop_after`` (one of :data:`STAGES`) ends the run after that stage
    and returns a checksum of its outputs, for staged comparisons.
    ``counts``: optional dict that receives ``proposals_in`` [B], the
    gate-passing proposals entering the stage-1 NMS.
    """
    if stop_after is not None and stop_after not in STAGES:
        raise ValueError(f"stop_after must be one of {STAGES}")
    s = cfg.shapes
    kh, kw = cfg.roi_pooling.kh, cfg.roi_pooling.kw
    perm = gen.detect_order()
    anchor_boxes = torch.from_numpy(gen.boxes[perm]).to(device)
    fy_d = torch.from_numpy(gen.fy[perm]).to(device)
    fx_d = torch.from_numpy(gen.fx[perm]).to(device)
    K, D = s.max_proposals, s.max_detections
    fm_loc = gen.fm_localizer
    bg = cfg.class_count
    conf_gate = cfg.detect_confidence
    fg_gate = cfg.detect_fg_threshold
    kernels = cfg.pallas_mode != "off"
    s2d = cfg.input_layout == "s2d"
    cdt = compute_dtype(cfg)
    spec0 = cfg.model.layers[0]
    if s2d:
        if spec0.conv_steps not in (1, 2) or (spec0.kH, spec0.kW, spec0.padH,
                                              spec0.padW) != (3, 3, 1, 1):
            raise ValueError("the s2d block0 covers a first block of one or "
                             "two 3x3/1/1 convs")
        if gen.image_hw[0] % 2 or gen.image_hw[1] % 2:
            raise ValueError("the s2d layout needs an even-sized bucket")
    if kernels:
        batched_nms = nms_kernel.cuda_nms
        batched_pool = roi_pool_kernel.adaptive_max_pool_valid
    else:
        batched_nms = plain_nms
        batched_pool = pool_plain.adaptive_max_pool
    norm_kw = dict(method=cfg.normalization.method,
                   width=cfg.normalization.width,
                   centering=cfg.normalization.centering,
                   scaling=cfg.normalization.scaling)

    @torch.no_grad()
    def detect(images, true_hw):
        h = true_hw[:, 0]
        w = true_hw[:, 1]
        if s2d:
            lum4, chroma = normalize_s2d(images[0].float(), images[1].float(),
                                         h, w, **norm_kw)
            b0 = compute_s2d_block0(cfg, pnet, block0_params,
                                    lum4.to(cdt).contiguous(),
                                    chroma.to(cdt).contiguous())
            if stop_after == "b0":
                return _cut_sum(b0[0] if isinstance(b0, tuple) else b0)
            anchor_maps, fm = pnet(None, block0_out=b0)
        else:
            images = unwire_uint8(images, cfg.color_space)
            anchor_maps, fm = pnet(normalize_image(images.float(), h, w,
                                                   **norm_kw))
        if stop_after == "fwd":
            return _cut_sum(*anchor_maps, fm)
        bsz = anchor_maps[0].shape[0]
        pred = torch.cat([m.reshape(bsz, -1, 6) for m in anchor_maps],
                         dim=1).float()                       # [B, A, 6]
        logp = torch.log_softmax(pred[..., 0:2], dim=-1)
        score = logp[..., 0]
        p_fg = torch.exp(score)
        decoded = B.decode(anchor_boxes[None], pred[..., 2:6])
        zero = torch.zeros_like(w, dtype=torch.float32)
        img_rect = torch.stack([zero, zero, w.float(), h.float()], dim=-1)
        keep = ((p_fg > fg_gate)
                & B.overlaps(decoded, img_rect[:, None, :])
                & gen.fm_valid_mask(h, w, fy=fy_d, fx=fx_d))
        if counts is not None:
            counts["proposals_in"] = torch.clamp(keep.sum(dim=1), max=K)
        if stop_after == "decode":
            return _cut_sum(decoded, score, keep)

        top_idx, top_valid = select_proposals(keep, score, K)
        top_boxes = take_rows(decoded, top_idx)
        top_scores = torch.where(top_valid, take_rows(score, top_idx),
                                 torch.full_like(top_valid, -torch.inf,
                                                 dtype=torch.float32))
        if stop_after == "select":
            return _cut_sum(top_boxes, top_scores, top_idx)

        nms_idx, prop_valid = batched_nms(top_boxes, top_scores, top_valid,
                                          PROPOSAL_NMS_IOU, D)
        cand = take_rows(top_idx, nms_idx.clamp(min=0))
        prop_boxes = take_rows(decoded, cand)
        prop_score = take_rows(p_fg, cand)
        if stop_after == "nms":
            return _cut_sum(prop_boxes, prop_score, nms_idx, prop_valid)

        fw, fh = fm_loc.feature_map_size_t(w, h)
        fr = pool_plain.roi_pool_feature_rects(
            fm_loc, prop_boxes, fw[:, None].float(), fh[:, None].float())
        pooled = batched_pool(fm.contiguous(), fr, prop_valid, kh, kw)
        pooled = pooled.reshape(bsz, D, -1)
        if stop_after == "pool":
            return _cut_sum(pooled)
        creg, clogp = cnet(pooled)
        if stop_after == "cnet":
            return _cut_sum(creg, clogp)

        refined = B.decode(prop_boxes, creg)
        cls = torch.argmax(clogp, dim=-1)
        conf = torch.exp(clogp.amax(dim=-1))
        accept = prop_valid & (cls != bg) & (conf > conf_gate)
        shifted = class_offset_boxes(refined, cls, accept)
        fin_idx, f_valid = batched_nms(
            shifted, torch.log(torch.clamp(conf, min=1e-20)), accept,
            CLASS_NMS_IOU, D)
        f_src = fin_idx.clamp(min=0)
        vb = f_valid[:, :, None]
        zf = torch.zeros((), device=refined.device)
        return DetectionResult(
            boxes=torch.where(vb, take_rows(refined, f_src), zf),
            proposal_boxes=torch.where(vb, take_rows(prop_boxes, f_src), zf),
            classes=torch.where(f_valid, take_rows(cls, f_src),
                                torch.zeros((), dtype=cls.dtype,
                                            device=cls.device)
                                ).to(torch.int32),
            confidence=torch.where(f_valid, take_rows(conf, f_src), zf),
            fg_score=torch.where(f_valid, take_rows(prop_score, f_src), zf),
            valid=f_valid,
            proposals=torch.where(prop_valid[:, :, None], prop_boxes, zf),
            proposals_valid=prop_valid,
        )

    return detect


class Detector:
    """The detect programs for one config, on one device: one per
    configured bucket (``cfg.shapes.buckets()``), the primary bucket's
    built at once, a portrait bucket's at its first batch.

    ``pnet``/``cnet``: the port's float32 modules with their weights
    loaded (for example from ``utils/weights.py::from_jax_params``). The
    Detector keeps its own copies, on ``device`` and cast once to the
    config's compute dtype (``models/factory.py::for_compute``), so
    Detectors built on the same modules do not change each other. Entry
    points run on CUDA unless the caller passes ``device="cpu"``.

    ``quantized=True`` swaps pnet for the int8 ``QuantizedPNet``, its
    weights quantized once from ``pnet``; ``quant_calibration``: optional
    [N, H, W, 3] normalized images from which static scales are
    calibrated on ``device`` (else every conv takes the abs-max scale of
    its input per call).
    """

    def __init__(self, cfg: Config, pnet, cnet, device="cuda",
                 quantized: bool = False, quant_calibration=None):
        self.cfg = cfg
        self.device = torch.device(device)
        dt = compute_dtype(cfg)
        self.pnet = for_compute(pnet, dt, self.device)
        self.cnet = for_compute(cnet, dt, self.device)
        self.block0_params = None
        if cfg.input_layout == "s2d":
            self.block0_params = block0_weights_of(cfg, pnet, self.device)
        if quantized:
            qpnet = QuantizedPNet(cfg.model, quantize_pnet(pnet), act_dtype=dt,
                                  pool_s8=cfg.quant_pool_s8).to(self.device)
            if quant_calibration is not None:
                calibrate_quantized_pnet(cfg, qpnet, self.pnet,
                                         self.block0_params,
                                         quant_calibration)
            self.pnet = qpnet
        self.last_counts = {}
        self._programs = {}
        self.gen = AnchorGenerator(cfg)
        self._programs[tuple(self.gen.image_hw)] = self._build(self.gen)

    def _build(self, gen: AnchorGenerator):
        return build_detect_fn(self.cfg, gen, self.pnet, self.cnet,
                               self.device, self.block0_params,
                               counts=self.last_counts)

    def _program_for(self, image_hw):
        """The detect program of bucket ``image_hw`` (H, W), built at its
        first use; a size outside the configured buckets raises
        ``ValueError``."""
        hw = tuple(int(x) for x in image_hw)
        if hw not in self._programs:
            buckets = [tuple(b) for b in self.cfg.shapes.buckets()]
            if hw not in buckets:
                raise ValueError(f"image bucket {hw} is not one of the "
                                 f"configured buckets {buckets}")
            self._programs[hw] = self._build(
                AnchorGenerator(self.cfg, image_hw=hw))
        return self._programs[hw]

    def detect(self, images, true_hw) -> DetectionResult:
        """``images``: NHWC [B, H, W, 3] (numpy or tensor; uint8 RGB or
        float in the config's color space). With ``input_layout='s2d'``
        the space-to-depth pack runs where the frames are: on the host
        (numpy) for numpy or CPU frames, before the transfer; on the card
        for CUDA frames. An already-packed (lum4, chroma) pair is taken as
        is. The batch goes to the program of its bucket: H and W of the
        frames, or ((Hc-1)*2, (Wc-1)*2) of a packed pair."""
        true_hw = torch.as_tensor(true_hw).to(self.device)
        if self.cfg.input_layout == "s2d":
            if isinstance(images, (tuple, list)):
                lum4, chroma = images
                hw = ((chroma.shape[1] - 1) * 2, (chroma.shape[3] - 1) * 2)
            elif isinstance(images, torch.Tensor):
                hw = images.shape[1:3]
                x = unwire_uint8(images, self.cfg.color_space)
                lum4, chroma = block0_kernel.pack_s2d(x.float())
            else:
                hw = np.shape(images)[1:3]
                x = unwire_uint8(np.asarray(images), self.cfg.color_space)
                lum4, chroma = block0_kernel.pack_s2d_np(
                    np.asarray(x, np.float32))
            fn = self._program_for(hw)
            lum4 = torch.as_tensor(lum4).to(self.device, non_blocking=True)
            chroma = torch.as_tensor(chroma).to(self.device,
                                                non_blocking=True)
            return fn((lum4, chroma), true_hw)
        fn = self._program_for(np.shape(images)[1:3])
        return fn(torch.as_tensor(images).to(self.device), true_hw)
