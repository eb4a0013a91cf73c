"""Host-side input pipeline (the JAX package's ``data/pipeline.py``):
decode, resize, augment, pad to fixed shapes.

Replaces ``BatchIterator.lua``. Division of labor:

* host (this module): PNG/JPEG decode (``data/codec.py``), color-space
  conversion, aspect-kept resize (``find_target_size``,
  ``utilities.lua:188-203``), random scaling/crop/flips
  (``BatchIterator.lua:101-140``), ROI transforms in lockstep, padding to
  the fixed image bucket, GT padding;
* device (train step / detect): per-channel centering/scaling and the
  contrastive luminance normalization (``BatchIterator.lua:142-161``) —
  masked to the true image region — plus all anchor labeling
  (``BatchIterator.lua:198-225``).

Epoch behavior mirrors the reference: independent shuffled orders for
training/validation/background lists, reshuffled when exhausted
(``randomize_order``/``next_entry``, ``BatchIterator.lua:7-25``). Fault
tolerance mirrors ``pcall`` decode guards: corrupt files are skipped and
logged (``BatchIterator.lua:177-196``). One ``random.Random(seed +
shard_index)`` makes every draw (shuffles, flips, scaling, crop offsets)
in the order of the JAX package, so the same seed gives the same batches.

Batches are CPU tensors: :class:`TrainBatch` fields and the validation
batch come from ``torch.from_numpy``; the trainer and the detector move
them to their device. No device work happens here.

Fixed-shape divergence (documented): the reference accumulates images until
>= cfg.batch_size anchor examples are gathered (variable image count per
step, ``BatchIterator.lua:272-274``); here each step carries a fixed
``images_per_step`` slots, the first one a background image when background
files exist (the reference adds one per batch too, ``BatchIterator.lua:252-270``).
Loss normalization uses true example counts, preserving loss semantics.
"""

from __future__ import annotations

import logging
import math
import os
import queue
import random
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.data import codec
from frcnn_tpu_torch.data import native as _native
from frcnn_tpu_torch.data.importers import load_manifest
from frcnn_tpu_torch.ops.color import convert_color
from frcnn_tpu_torch.train.objective import TrainBatch

log = logging.getLogger("frcnn_tpu_torch.data")


def find_target_size(orig_w: int, orig_h: int, target_smaller_side: int,
                     max_pixel_size: int) -> Tuple[int, int]:
    """Resize target keeping the smaller side at ``target_smaller_side`` and
    capping the larger side (``utilities.lua:188-203``)."""
    if orig_h < orig_w:
        w = min(orig_w * target_smaller_side / orig_h, max_pixel_size)
        h = math.floor(orig_h * w / orig_w + 0.5)
        w = math.floor(w + 0.5)
    else:
        h = min(orig_h * target_smaller_side / orig_w, max_pixel_size)
        w = math.floor(orig_w * h / orig_h + 0.5)
        h = math.floor(h + 0.5)
    assert w >= 1 and h >= 1
    return w, h


def load_image(path: str, color_space: str = "rgb",
               base_path: str = "",
               use_native: Optional[bool] = None) -> np.ndarray:
    """Decode to float32 RGB [0,1] then convert color space
    (``load_image``, ``utilities.lua:205-218``). Raises on corrupt files —
    callers catch and skip. ``use_native`` as :func:`codec.read_rgb`'s."""
    if base_path and not path.startswith("/"):
        path = os.path.join(base_path, path)
    arr = codec.read_rgb(path, use_native).astype(np.float32) / 255.0
    return convert_color(arr, color_space)


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` (``Resample.c``) for its bilinear
    filter: per output index the first source index and the normalized
    float64 taps ``[out_size, k]`` (zero past each index's tap count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale            # the bilinear filter's support
    inv = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    rows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        taps = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * inv)
            taps.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for t in taps:
            total += t
        if total != 0.0:
            taps = [t / total for t in taps]
        first[xx] = xmin
        rows.append(taps)
    k = np.zeros((out_size, max(len(r) for r in rows)), np.float64)
    for xx, r in enumerate(rows):
        k[xx, :len(r)] = r
    return first, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's float32 resampling along ``axis``: per output
    value a float64 sum from 0.0 over the taps in order, rounded to
    float32."""
    n = img.shape[axis]
    if n == out_size:
        return img                          # Pillow skips the pass
    first, k = _bilinear_coeffs(n, out_size)
    shape = list(img.shape)
    shape[axis] = out_size
    k_shape = [1] * img.ndim
    k_shape[axis] = out_size
    acc = np.zeros(shape, np.float64)
    term = np.empty(shape, np.float64)
    src = np.empty(shape, np.float32)
    for t in range(k.shape[1]):
        np.take(img, np.minimum(first + t, n - 1), axis=axis, out=src)
        np.multiply(src, k[:, t].reshape(k_shape), out=term)
        acc += term
    return acc.astype(np.float32)


def _resample_axis_u8(img: np.ndarray, out_size: int, axis: int):
    """One pass of Pillow's 8-bit resampling (``ImagingResample*_8bpc``)
    along ``axis`` of uint8 ``img``: the taps in fixed point with 22
    fraction bits (rounded away from zero), an integer sum from one half,
    shifted and clipped to uint8."""
    n = img.shape[axis]
    if n == out_size:
        return img
    first, k = _bilinear_coeffs(n, out_size)
    kk = np.trunc(k * (1 << 22) + np.where(k < 0, -0.5, 0.5)).astype(
        np.int64)
    k_shape = [1] * img.ndim
    k_shape[axis] = out_size
    acc = np.full([out_size if d == axis else s
                   for d, s in enumerate(img.shape)], 1 << 21, np.int64)
    for t in range(kk.shape[1]):
        src = np.take(img, np.minimum(first + t, n - 1), axis=axis)
        acc += src.astype(np.int64) * kk[:, t].reshape(k_shape)
    return np.clip(acc >> 22, 0, 255).astype(np.uint8)


def resize_uint8(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize of uint8 [h, w, C] as Pillow's ``Image.resize(
    BILINEAR)`` computes it on a uint8 image: the taps of
    :func:`resize_image`, in fixed point, rounded to uint8 after each
    pass (horizontal first)."""
    img = np.asarray(img, np.uint8)
    return _resample_axis_u8(_resample_axis_u8(img, max(1, int(new_w)), 1),
                             max(1, int(new_h)), 0)


def _box_blur_radius(radius: float, passes: int) -> np.float32:
    """Pillow's ``_gaussian_blur_radius``: the extended box radius whose
    ``passes`` box blurs have the variance of a Gaussian of standard
    deviation ``radius`` (float32 arithmetic, two steps in double)."""
    f = np.float32
    sigma2 = f(f(radius) * f(radius)) / f(passes)
    big_l = f(np.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(np.floor((float(big_l) - 1.0) / 2.0))
    a = (f(2) * small_l + f(1)) * (small_l * (small_l + f(1))
                                   - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (small_l + f(1)) * (small_l + f(1))))
    return small_l + a


def _box_blur_pass(img: np.ndarray, radius: np.float32, axis: int):
    """One pass of Pillow's extended box blur (``ImagingLineBoxBlur``) of
    uint8 ``img`` along ``axis``: 2r + 1 taps of weight ww and the two next
    ones of weight fw in 24-bit fixed point, edge pixels repeated, rounded
    to uint8."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r + 1, r + 1)
    p = np.pad(img.astype(np.int64), pad, mode="edge")
    c = np.cumsum(p, axis=axis)
    hi = np.take(c, np.arange(2 * r + 1, 2 * r + 1 + n), axis=axis)
    lo = np.take(c, np.arange(n), axis=axis)
    far = (np.take(p, np.arange(n), axis=axis)
           + np.take(p, np.arange(2 * r + 2, 2 * r + 2 + n), axis=axis))
    bulk = (hi - lo) * ww + far * fw
    return ((bulk + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float):
    """uint8 [h, w, C] blurred as Pillow's ``ImageFilter.GaussianBlur(
    radius)`` blurs it: three extended box blurs along the rows, then three
    along the columns, each rounded to uint8."""
    img = np.asarray(img, np.uint8)
    if radius == 0:
        return img.copy()
    fr = _box_blur_radius(radius, 3)
    for axis in (1, 0):
        for _ in range(3):
            img = _box_blur_pass(img, fr, axis)
    return img


def resize_image(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize (image.scale default) of float32 [h, w, C]: what
    Pillow's ``Image.resize(BILINEAR)`` computes on each channel in mode
    "F" (antialiased on downscale), horizontal pass first."""
    new_w = max(1, int(new_w))
    new_h = max(1, int(new_h))
    img = np.asarray(img, np.float32)
    return _resample_axis(_resample_axis(img, new_w, 1), new_h, 0)


# --- numpy box helpers (host path; device math lives in geometry.boxes) -----

def _clip_box(b, w, h):
    return [
        min(max(b[0], 0.0), w), min(max(b[1], 0.0), h),
        max(min(b[2], w), 0.0), max(min(b[3], h), 0.0),
    ]


def _transform_rois(rois: List[dict], f, img_w: float, img_h: float,
                    new_w: float, new_h: float) -> List[dict]:
    """Apply ``f(rect) -> rect`` to each ROI, clip to the new image, drop
    empties (``transform_example``, ``BatchIterator.lua:27-47``)."""
    out = []
    for roi in rois:
        r = f(list(roi["rect"]))
        if r is None:
            continue
        r = _clip_box(r, new_w, new_h)
        if r[0] == r[2] and r[1] == r[3]:
            continue
        if r[2] <= r[0] or r[3] <= r[1]:
            continue
        out.append({**roi, "rect": r})
    return out


def _train_batch(*arrays) -> TrainBatch:
    """A :class:`TrainBatch` of CPU tensors over the numpy fields."""
    return TrainBatch(*(torch.from_numpy(a) for a in arrays))


class _OrderedSet:
    """Shuffled cyclic iteration over a file list
    (``randomize_order``/``next_entry``)."""

    def __init__(self, items: Sequence[str], rng: random.Random):
        self.items = list(items)
        self.rng = rng
        self.order: List[int] = []
        self.i = 0
        self._reshuffle()

    def _reshuffle(self):
        self.order = list(range(len(self.items)))
        self.rng.shuffle(self.order)
        self.i = 0

    def __len__(self):
        return len(self.items)

    def next(self) -> str:
        if self.i >= len(self.items):
            self._reshuffle()
        item = self.items[self.order[self.i]]
        self.i += 1
        return item


class PrefetchingIterator:
    """Background-thread batch prefetcher (depth-N queue) so host decode
    overlaps device steps — the reference loads synchronously inside the
    optimizer closure (``objective.lua:64``). The worker only runs
    ``iterator.next_training_batch()`` (host code: CPU tensors); an
    exception there is re-raised by the next :meth:`next_training_batch`.
    """

    def __init__(self, iterator: "BatchIterator", depth: int = 2):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            while not self._stop.is_set():
                try:
                    batch = self._it.next_training_batch()
                except Exception as e:  # surface in the consumer
                    self._q.put(e)
                    return
                self._q.put(batch)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_training_batch(self) -> TrainBatch:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the worker: it ends after the batch it is assembling."""
        self._stop.set()
        for _ in range(1200):                # 60 s
            try:   # drain, so that a blocked put returns
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            if not self._thread.is_alive():
                return
        raise RuntimeError("the prefetch worker did not stop")


class BatchIterator:
    """Yields fixed-shape :class:`TrainBatch` structures.

    When the native C++ host pipeline (csrc/host_pipeline.cpp) is available
    and the config is compatible (no random scaling; rgb/yuv color space —
    YUV is linear so it commutes with the linear resampler), whole batches
    are decoded+resized+converted in one GIL-releasing threaded call.
    """

    def __init__(self, cfg: Config, manifest, seed: Optional[int] = None,
                 use_native: Optional[bool] = None,
                 shard_index: int = 0, num_shards: int = 1,
                 num_threads: int = 0):
        """``shard_index``/``num_shards``: multi-host input sharding — each
        process iterates a disjoint stride of the training list (DCN-side
        data split; the device mesh handles the ICI-side DP).
        ``num_threads``: the native library's decode threads per batch (0:
        one per image, up to the CPU count)."""
        if isinstance(manifest, str):
            manifest = load_manifest(manifest)
        self.cfg = cfg
        self.manifest = manifest
        self.ground_truth = manifest["ground_truth"]
        self.rng = random.Random(
            (seed if seed is not None else cfg.seed) + shard_index
        )
        train_list = manifest["training_set"][shard_index::num_shards] or \
            manifest["training_set"]
        self.training = _OrderedSet(train_list, self.rng)
        self.validation = _OrderedSet(manifest["validation_set"], self.rng)
        self.background = _OrderedSet(
            manifest.get("background_files", []), self.rng
        )
        native_ok = (
            cfg.augmentation.random_scaling == 0
            and cfg.color_space in ("rgb", "yuv", "", None)
        )
        if cfg.uint8_wire:
            assert cfg.color_space in ("rgb", "yuv", "", None), (
                "uint8_wire supports rgb/yuv color spaces only"
            )
        self._pending: dict = {}         # bucket -> [(img, rois, isbg)]
        self._pending_native: dict = {}  # bucket -> [(canvas, hw, rois, isbg)]
        self._val_pending: List[dict] = []
        if use_native is None:
            self.use_native = native_ok and _native.available()
        else:
            self.use_native = use_native and native_ok and _native.available()
        self._native = _native
        self.num_threads = num_threads

    # -- per-image processing -------------------------------------------------

    def process_image(self, img: np.ndarray, rois: List[dict],
                      augment: bool = True) -> Tuple[np.ndarray, List[dict]]:
        """Resize + augment one image with its ROIs in lockstep
        (``BatchIterator:processImage``, ``BatchIterator.lua:101-140``).
        Returns the processed image at its TRUE size (no padding) and
        transformed ROIs. Normalization happens on device."""
        cfg = self.cfg
        aug = cfg.augmentation
        h, w = img.shape[:2]
        tw, th = find_target_size(
            w, h, cfg.target_smaller_side, cfg.max_pixel_size
        )
        scale_x = tw / w
        scale_y = th / h

        if augment and aug.random_scaling and aug.random_scaling > 0:
            # Intended behavior: jitter around the base scale. (The
            # reference's formula drops the base term and can go negative,
            # BatchIterator.lua:113-114 — a bug on a path its configs never
            # enable; not replicated.)
            scale_x = scale_x * (1.0 + (self.rng.random() - 0.5) * aug.random_scaling)
            scale_y = scale_x * (1.0 + (self.rng.random() - 0.5) * aug.aspect_jitter)

        new_w = max(1, round(w * scale_x))
        new_h = max(1, round(h * scale_y))
        img = resize_image(img, new_w, new_h)
        sx, sy = new_w / w, new_h / h
        rois = _transform_rois(
            rois, lambda r: [r[0] * sx, r[1] * sy, r[2] * sx, r[3] * sy],
            w, h, new_w, new_h,
        )

        # crop back to target if we upscaled past it (BatchIterator.lua:117-129)
        ih, iw = img.shape[:2]
        if iw > tw or ih > th:
            cw, ch = min(tw, iw), min(th, ih)
            x0 = math.floor(self.rng.random() * (iw - cw))
            y0 = math.floor(self.rng.random() * (ih - ch))
            img = img[y0 : y0 + ch, x0 : x0 + cw]
            rois = _transform_rois(
                rois,
                lambda r: [r[0] - x0, r[1] - y0, r[2] - x0, r[3] - y0],
                iw, ih, cw, ch,
            )

        ih, iw = img.shape[:2]
        # Safety clamp to the best-fitting compile bucket (same mechanics as
        # the crop above). With the default configs the buckets cover the
        # full resize envelope (landscape via image_hw; portrait via
        # portrait_hw when set), so this only fires for portrait inputs
        # without a portrait bucket or user-shrunk buckets — the reference
        # keeps those full-size (utilities.lua:188-203); we crop and warn.
        Hb, Wb = self.cfg.shapes.bucket_for(ih, iw)
        if iw > Wb or ih > Hb:
            log.warning(
                "image exceeds the compile bucket (%dx%d > %dx%d): cropping",
                iw, ih, Wb, Hb,
            )
            cw, ch = min(Wb, iw), min(Hb, ih)
            img = img[:ch, :cw]
            rois = _transform_rois(rois, lambda r: list(r), iw, ih, cw, ch)
            ih, iw = ch, cw

        if augment and aug.hflip and self.rng.random() < aug.hflip:
            img = img[:, ::-1]
            rois = _transform_rois(
                rois, lambda r: [iw - r[2], r[1], iw - r[0], r[3]], iw, ih, iw, ih
            )
        if augment and aug.vflip and self.rng.random() < aug.vflip:
            img = img[::-1, :]
            rois = _transform_rois(
                rois, lambda r: [r[0], ih - r[3], r[2], ih - r[1]], iw, ih, iw, ih
            )
        return np.ascontiguousarray(img), rois

    def _load_processed(self, fn: str, base_path: str, with_rois: bool,
                        augment: bool = True):
        """Decode + process with the reference's skip rules. Returns
        (img, rois) or None if the image must be skipped."""
        try:
            # uint8 wire: stay in float RGB on the host (resize/flip are
            # color-space-agnostic); the device converts after /255
            space = "rgb" if self.cfg.uint8_wire else self.cfg.color_space
            img = load_image(fn, space, base_path)
        except (OSError, ValueError) as e:  # corrupt or missing file —
            # pcall guard analog; a JPEG without the native library raises
            # RuntimeError, which is no file's fault and propagates
            log.warning("Invalid image '%s': %s", fn, e)
            return None
        if img.ndim != 3 or img.shape[2] != 3:
            log.warning("Skipping '%s': unexpected channels", fn)
            return None
        rois = []
        if with_rois:
            entry = self.ground_truth.get(fn)
            rois = [dict(r) for r in (entry["rois"] if entry else [])]
        img, rois = self.process_image(img, rois, augment=augment)
        if img.shape[0] < 128 or img.shape[1] < 128:
            log.warning(
                "Skipping '%s': too small after processing (%dx%d)",
                fn, img.shape[1], img.shape[0],
            )
            return None
        return img, rois

    # -- batching --------------------------------------------------------------

    def _pad_slot(self, img: np.ndarray, rois: List[dict], bucket=None):
        s = self.cfg.shapes
        H, W = bucket if bucket is not None else s.image_hw
        G = s.max_gt
        h, w = img.shape[:2]
        if self.cfg.uint8_wire:
            # quantize AFTER the float resize — one 1/255 rounding total
            canvas = np.zeros((H, W, 3), np.uint8)
            canvas[:h, :w] = np.clip(
                np.round(img[:H, :W] * 255.0), 0, 255
            ).astype(np.uint8)
        else:
            canvas = np.zeros((H, W, 3), np.float32)
            canvas[:h, :w] = img[:H, :W]
        gt_boxes = np.zeros((G, 4), np.float32)
        gt_cls = np.zeros((G,), np.int32)
        gt_mask = np.zeros((G,), bool)
        if len(rois) > G:
            log.warning("truncating %d ROIs to %d", len(rois), G)
            rois = rois[:G]
        for i, r in enumerate(rois):
            gt_boxes[i] = r["rect"]
            gt_cls[i] = r["class_index"]
            gt_mask[i] = True
        return canvas, (h, w), gt_boxes, gt_cls, gt_mask

    # -- native fast path ------------------------------------------------------

    def _resolve(self, fn: str, base: str) -> str:
        return fn if fn.startswith("/") or not base else os.path.join(base, fn)

    def _peek_bucket(self, path: str):
        """Predict an image's compile bucket from its header dimensions
        (``codec.image_size`` reads only the header — no decode).
        Unreadable headers fall to the primary bucket; the native decode
        reports the real failure."""
        s = self.cfg.shapes
        if s.portrait_hw is None:
            return tuple(s.image_hw)
        try:
            ow, oh = codec.image_size(path)
        except (OSError, ValueError):
            return tuple(s.image_hw)
        tw, th = find_target_size(
            ow, oh, self.cfg.target_smaller_side, self.cfg.max_pixel_size
        )
        return s.bucket_for(th, tw)

    def _native_slots(self, n: int, background: bool, augment: bool = True):
        """Decode+process ``n`` images through the C++ pipeline (threaded),
        with skip-and-top-up for corrupt/small files. Returns slot tuples
        (canvas, (h, w), rois, bucket). With a portrait bucket configured,
        names are routed by a header peek and decoded per bucket group."""
        cfg = self.cfg
        slots = []
        guard = 0
        src = self.background if background else self.training
        base = cfg.background_base_path if background else cfg.examples_base_path
        while len(slots) < n and guard < 10 * n + 20:
            guard += 1
            want = n - len(slots)
            names = [src.next() for _ in range(want)]
            paths = [self._resolve(f, base) for f in names]
            aug = cfg.augmentation
            flips = np.zeros((want, 2), np.int32)
            if augment:
                for i in range(want):
                    flips[i, 0] = aug.hflip > 0 and self.rng.random() < aug.hflip
                    flips[i, 1] = aug.vflip > 0 and self.rng.random() < aug.vflip
            groups: dict = {}
            for i, p in enumerate(paths):
                groups.setdefault(self._peek_bucket(p), []).append(i)
            for bucket, idxs in groups.items():
                # uint8 wire: decode stays in float RGB (the device does
                # the color conversion after /255); quantized at assembly
                space = "rgb" if cfg.uint8_wire else cfg.color_space
                out = self._native.load_process_batch(
                    [paths[i] for i in idxs], bucket,
                    cfg.target_smaller_side, cfg.max_pixel_size,
                    space, flips=flips[idxs], num_threads=self.num_threads,
                )
                canvases, out_hw, status = out
                for gi, i in enumerate(idxs):
                    if status[gi] != 0:
                        log.warning("Invalid image '%s' (native rc=%d)",
                                    names[i], status[gi])
                        continue
                    h, w, oh, ow = (int(v) for v in out_hw[gi])
                    if h < 128 or w < 128:
                        log.warning("Skipping '%s': too small (%dx%d)",
                                    names[i], w, h)
                        continue
                    rois = []
                    if not background:
                        entry = self.ground_truth.get(names[i])
                        # scale at the FULL resize target (the native path
                        # crops at the bucket boundary, it does not squash),
                        # then clip to the kept extent
                        tw_full, th_full = find_target_size(
                            ow, oh, cfg.target_smaller_side, cfg.max_pixel_size
                        )
                        sx, sy = tw_full / ow, th_full / oh
                        raw = [dict(r) for r in (entry["rois"] if entry else [])]
                        rois = _transform_rois(
                            raw,
                            lambda r: [r[0] * sx, r[1] * sy, r[2] * sx, r[3] * sy],
                            ow, oh, w, h,
                        )
                        if flips[i, 0]:
                            rois = _transform_rois(
                                rois, lambda r: [w - r[2], r[1], w - r[0], r[3]],
                                w, h, w, h,
                            )
                        if flips[i, 1]:
                            rois = _transform_rois(
                                rois, lambda r: [r[0], h - r[3], r[2], h - r[1]],
                                w, h, w, h,
                            )
                    slots.append((canvases[gi], (h, w), rois, bucket))
        return slots

    def next_training_batch(self) -> TrainBatch:
        s = self.cfg.shapes
        B = s.images_per_step
        if self.use_native:
            return self._next_training_batch_native()
        if s.portrait_hw is not None:
            return self._next_training_batch_bucketed()
        slots = []
        # one background slot per batch when available (BatchIterator.lua:252-270)
        if len(self.background) > 0 and B > 1:
            for _ in range(10):
                got = self._load_processed(
                    self.background.next(), self.cfg.background_base_path,
                    with_rois=False,
                )
                if got is not None:
                    slots.append((got[0], [], True))
                    break

        attempts = 0
        while len(slots) < B:
            attempts += 1
            if attempts > 20 * B + 20:
                raise RuntimeError(
                    "could not assemble a training batch: too many "
                    "unreadable/undersized images"
                )
            got = self._load_processed(
                self.training.next(), self.cfg.examples_base_path, with_rois=True
            )
            if got is None:
                continue
            slots.append((got[0], got[1], False))
        return self._assemble_bucket(tuple(s.image_hw), slots)

    def _next_training_batch_bucketed(self) -> TrainBatch:
        """Dual-bucket assembly: each processed image routes to the compile
        bucket that fits it (landscape ``image_hw`` / portrait
        ``portrait_hw``); a batch is emitted when one bucket collects
        ``images_per_step`` slots, so every train step stays fixed-shape.
        One background slot is kept pending across buckets when background
        files exist (the emitted batch carries it when orientations match —
        a slight relaxation of the reference's one-per-batch,
        ``BatchIterator.lua:252-270``)."""
        s = self.cfg.shapes
        B = s.images_per_step

        def bg_pending():
            return any(
                isbg for slots in self._pending.values()
                for (_, _, isbg) in slots
            )

        attempts = 0
        while True:
            attempts += 1
            if attempts > 40 * B + 40:
                raise RuntimeError(
                    "could not assemble a training batch: too many "
                    "unreadable/undersized images"
                )
            if len(self.background) > 0 and B > 1 and not bg_pending():
                got = self._load_processed(
                    self.background.next(), self.cfg.background_base_path,
                    with_rois=False,
                )
                if got is not None:
                    img = got[0]
                    b = s.bucket_for(*img.shape[:2])
                    self._pending.setdefault(b, []).append((img, [], True))
            got = self._load_processed(
                self.training.next(), self.cfg.examples_base_path,
                with_rois=True,
            )
            if got is not None:
                img, rois = got
                b = s.bucket_for(*img.shape[:2])
                self._pending.setdefault(b, []).append((img, rois, False))
            for bucket, slots in self._pending.items():
                if len(slots) >= B:
                    # background slot first, like the non-bucketed path
                    slots.sort(key=lambda t: not t[2])
                    take, self._pending[bucket] = slots[:B], slots[B:]
                    return self._assemble_bucket(bucket, take)

    def _assemble_bucket(self, bucket, slots) -> TrainBatch:
        """slots: [(img at its true size, rois, is_background)]."""
        imgs, hws, boxes, clss, masks, isbg = [], [], [], [], [], []
        for (img, rois, bg) in slots:
            canvas, hw, gb, gc, gm = self._pad_slot(img, rois, bucket)
            imgs.append(canvas)
            hws.append(hw)
            boxes.append(gb)
            clss.append(gc)
            masks.append(gm)
            isbg.append(bg)
        return _train_batch(np.stack(imgs), np.asarray(hws, np.int32),
                            np.stack(boxes), np.stack(clss), np.stack(masks),
                            np.asarray(isbg, bool))

    def _next_training_batch_native(self) -> TrainBatch:
        s = self.cfg.shapes
        B = s.images_per_step
        if s.portrait_hw is None:
            n_bg = 1 if (len(self.background) > 0 and B > 1) else 0
            slots = []
            if n_bg:
                slots += [(c, hw, [], True) for (c, hw, _, _b) in
                          self._native_slots(n_bg, background=True)]
            slots += [(c, hw, rois, False) for (c, hw, rois, _b) in
                      self._native_slots(B - len(slots), background=False)]
            return self._assemble_native(tuple(s.image_hw), slots)

        # dual-bucket: route decoded slots into per-bucket queues, emit the
        # first bucket that fills (same policy as the python bucketed path)
        pend = self._pending_native

        def bg_pending():
            return any(t[3] for sl in pend.values() for t in sl)

        guard = 0
        while True:
            guard += 1
            if guard > 20 * B + 20:
                raise RuntimeError(
                    "could not assemble a training batch: too many "
                    "unreadable/undersized images"
                )
            if len(self.background) > 0 and B > 1 and not bg_pending():
                for (c, hw, _, b) in self._native_slots(1, background=True):
                    pend.setdefault(b, []).append((c, hw, [], True))
            for (c, hw, rois, b) in self._native_slots(B, background=False):
                pend.setdefault(b, []).append((c, hw, rois, False))
            for bucket, sl in pend.items():
                if len(sl) >= B:
                    sl.sort(key=lambda t: not t[3])  # background slot first
                    take, pend[bucket] = sl[:B], sl[B:]
                    return self._assemble_native(bucket, take)

    def _assemble_native(self, bucket, slots) -> TrainBatch:
        """slots: [(canvas@bucket, (h, w), rois, is_background)]."""
        B = len(slots)
        H, W = bucket
        G = self.cfg.shapes.max_gt
        wire8 = self.cfg.uint8_wire
        imgs = np.zeros((B, H, W, 3), np.uint8 if wire8 else np.float32)
        hws = np.zeros((B, 2), np.int32)
        gt_boxes = np.zeros((B, G, 4), np.float32)
        gt_cls = np.zeros((B, G), np.int32)
        gt_mask = np.zeros((B, G), bool)
        isbg = np.zeros((B,), bool)
        for b, (canvas, hw, rois, bg) in enumerate(slots):
            if wire8:
                # quantize AFTER the float resize (one 1/255 rounding
                # total — same rule as the Python path)
                np.clip(np.round(canvas * 255.0), 0, 255, out=canvas)
                imgs[b] = canvas.astype(np.uint8)
            else:
                imgs[b] = canvas
            hws[b] = hw
            isbg[b] = bg
            if len(rois) > G:
                log.warning("truncating %d ROIs to %d", len(rois), G)
                rois = rois[:G]
            for i, r in enumerate(rois):
                gt_boxes[b, i] = r["rect"]
                gt_cls[b, i] = r["class_index"]
                gt_mask[b, i] = True
        return _train_batch(imgs, hws, gt_boxes, gt_cls, gt_mask, isbg)

    def next_validation(self, count: int = 1):
        """List of dicts {image (float32 numpy at its true size), rois} —
        ``nextValidation``
        (``BatchIterator.lua:279-317``). No augmentation. Returns fewer than
        ``count`` items (possibly none) when the validation set is empty or
        unreadable."""
        out = []
        guard = 0
        if len(self.validation) == 0:
            log.warning("validation set is empty")
            return out
        while len(out) < count and guard < count * 20:
            guard += 1
            got = self._load_processed(
                self.validation.next(), self.cfg.examples_base_path,
                with_rois=True, augment=False,
            )
            if got is None:
                continue
            out.append({"image": got[0], "rois": got[1]})
        return out

    def padded_validation_batch(self, count: int):
        """Fixed-shape batch for the detector: ``(images [n, H, W, 3],
        true_hw [n, 2] int32, rois per image)``, images and true_hw as CPU
        tensors. With an empty or fully unreadable validation set, returns
        correctly-shaped EMPTY tensors (batch 0) instead of crashing —
        callers iterate zero images.

        With a portrait bucket configured, each returned batch is
        orientation-homogeneous (the detector compiles one program per
        bucket); mixed draws are queued for subsequent calls."""
        s = self.cfg.shapes
        if len(self._val_pending) < count:
            items = self.next_validation(count)
            self._val_pending.extend(items)
        if not self._val_pending:
            H, W = s.image_hw
            dt = torch.uint8 if self.cfg.uint8_wire else torch.float32
            return (torch.zeros((0, H, W, 3), dtype=dt),
                    torch.zeros((0, 2), dtype=torch.int32), [])
        bucket = s.bucket_for(*self._val_pending[0]["image"].shape[:2])
        take, rest = [], []
        for it in self._val_pending:
            b = s.bucket_for(*it["image"].shape[:2])
            (take if b == bucket and len(take) < count else rest).append(it)
        self._val_pending = rest
        imgs, hws, all_rois = [], [], []
        for it in take:
            canvas, hw, *_ = self._pad_slot(it["image"], it["rois"], bucket)
            imgs.append(canvas)
            hws.append(hw)
            all_rois.append(it["rois"])
        return (torch.from_numpy(np.stack(imgs)),
                torch.from_numpy(np.asarray(hws, np.int32)), all_rois)
