"""The port's host data layer against the JAX package's: color conversion,
Torch7 files, the importers, the PIL-free codec, the resampler, the batch
iterators (Python path, native path, uint8 wire, dual bucket, corrupt
files, validation batches), the prefetcher, and a CPU trainer fed from
image files.

Tolerances: manifests, t7 objects, decoded bytes, integer and bool batch
fields equal; color conversion within 1e-6; resize within 1e-6 (it is
bitwise in practice: the same taps and float64 sums as Pillow); batch
boxes within 1e-5; batch images bitwise on the native path (the same
library, the same calls) and within 1e-6 on the Python path. Datasets are
``tests/test_e2e_synthetic.py::make_dataset`` images (200x160) written by
PIL, with the ``tests/tiny.py`` config.
"""

import dataclasses
import io
import json
import os
import struct
import time
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from frcnn_tpu.config import AugmentationConfig
from frcnn_tpu.data import importers as j_imp
from frcnn_tpu.data import t7 as j_t7
from frcnn_tpu.data.pipeline import BatchIterator as JBatchIterator
from frcnn_tpu.data.pipeline import resize_image as j_resize
from frcnn_tpu.ops import color as j_color
from frcnn_tpu.utils import plotting as j_plotting
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.data import codec, native
from frcnn_tpu_torch.data import importers as t_imp
from frcnn_tpu_torch.data import t7 as t_t7
from frcnn_tpu_torch.data.pipeline import BatchIterator, PrefetchingIterator
from frcnn_tpu_torch.data.pipeline import resize_image
from frcnn_tpu_torch.models.factory import models_from_state_dicts
from frcnn_tpu_torch.ops import block0_kernel
from frcnn_tpu_torch.ops import color as t_color
from frcnn_tpu_torch.train.trainer import Trainer
from frcnn_tpu_torch.utils import drawing, plotting
from frcnn_tpu_torch.utils.metrics import profiler_trace
from tests.test_dual_bucket import dual_cfg, make_mixed_dataset
from tests.test_e2e_synthetic import make_dataset
from tests.test_importers import CSV, XML
from tests.ref_native import need_native as _need_native
from tests.ref_native import reference_native  # noqa: F401 (fixture)
from tests.test_t7 import _reference_traindata
from tests.tiny import tiny_config

# Every test loads the JAX package's native library from the port's build.
pytestmark = pytest.mark.usefixtures("reference_native")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_data")
    make_dataset(tmp, n=10)
    return tmp


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_data_mixed")
    make_mixed_dataset(tmp)
    return tmp


# -- color ---------------------------------------------------------------------

@pytest.mark.parametrize("space", ["rgb", "yuv", "lab", "hsv"])
def test_convert_color_matches_jax(space):
    rng = np.random.default_rng(1)
    img = rng.random((17, 23, 3), dtype=np.float32)
    img[0, :3] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 1, 1]]   # grays: hue 0
    want = j_color.convert_color(img, space)
    got = t_color.convert_color(img, space)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_color.yuv2rgb(t_color.rgb2yuv(img)), img,
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        t_color.convert_color(img, "xyz")


# -- t7 ------------------------------------------------------------------------

def _t7_sample(mod):
    shared = mod.LuaTable({1: "a", 2: "b"})
    tensor = mod.TorchTensor("torch.FloatTensor", [2, 3], [3, 1], 0,
                             [float(i) for i in range(6)])
    return mod.LuaTable({
        "n": 3, "x": 2.5, "s": "text", "flag": True, "no": False,
        "list": shared, "again": shared, "tensor": tensor,
        "rect": mod.TorchObject("Rect", mod.LuaTable(
            {"minX": 1, "minY": 2, "maxX": 3, "maxY": 4})),
    })


def _t7_plain(x):
    """A t7 object as plain comparable Python values."""
    if isinstance(x, dict):
        return {k: _t7_plain(v) for k, v in x.items()}
    if hasattr(x, "torch_class") and hasattr(x, "size"):
        return (x.torch_class, x.numpy().tolist())
    if hasattr(x, "torch_class"):
        return (x.torch_class, _t7_plain(x.state))
    return x


def test_t7_round_trips_match_jax(tmp_path):
    """The JAX writer's file loads the same in both readers; the port's
    writer writes the same bytes, which the JAX reader loads back."""
    pj, pt = tmp_path / "j.t7", tmp_path / "t.t7"
    j_t7.save(str(pj), _t7_sample(j_t7))
    t_t7.save(str(pt), _t7_sample(t_t7))
    assert pj.read_bytes() == pt.read_bytes()
    want = _t7_plain(j_t7.load(str(pj)))
    assert _t7_plain(t_t7.load(str(pj))) == want
    assert _t7_plain(j_t7.load(str(pt))) == want
    back = t_t7.load(str(pj))
    assert back["list"] is back["again"]            # memoized by heap index
    assert back["list"].list() == ["a", "b"]
    with open(pt, "rb") as f:
        data = f.read()
    with pytest.raises(EOFError):
        t_t7.T7Reader(io.BytesIO(data[:-3])).read()


# -- importers -----------------------------------------------------------------

def _manifests(kind, tmp_path):
    if kind == "csv":
        (tmp_path / "boxes.csv").write_text(CSV)
        bg = tmp_path / "bg"
        bg.mkdir()
        for n in ("b2.jpg", "b1.png"):
            (bg / n).write_bytes(b"x")
        args = ("toy", str(tmp_path / "boxes.csv"), str(bg))
        return (j_imp.create_duplo_manifest(*args, validation_size=0.5,
                                            seed=3),
                t_imp.create_duplo_manifest(*args, validation_size=0.5,
                                            seed=3))
    if kind == "imagenet":
        for split, name in (("train/sub", "a1.xml"), ("train/sub", "a2.xml"),
                            ("val", "v1.xml")):
            d = tmp_path / "Annotations/DET" / split
            d.mkdir(parents=True, exist_ok=True)
            (d / name).write_text(XML)
        bg = tmp_path / "Data/DET/train/extra0"
        bg.mkdir(parents=True)
        (bg / "b.JPEG").write_bytes(b"x")
        (bg / "c.txt").write_bytes(b"x")
        args = ("toy-det", str(tmp_path), "Annotations/DET/train",
                "Annotations/DET/val", "Data/DET/train", "Data/DET/val")
        return (j_imp.create_imagenet_manifest(
                    *args, background_dirs=["Data/DET/train/extra0"]),
                t_imp.create_imagenet_manifest(
                    *args, background_dirs=["Data/DET/train/extra0"]))
    path = str(tmp_path / "duplo.t7")
    j_t7.save(path, _reference_traindata())
    return (j_imp.create_manifest_from_t7(path),
            t_imp.create_manifest_from_t7(path))


@pytest.mark.parametrize("kind", ["csv", "imagenet", "t7"])
def test_importers_match_jax(tmp_path, kind):
    want, got = _manifests(kind, tmp_path)
    assert got == want
    assert got["training_set"] and got["ground_truth"]
    out = str(tmp_path / "m.json")
    t_imp.save_manifest(got, out)
    assert t_imp.load_manifest(out) == json.loads(json.dumps(want))
    assert j_imp.load_manifest(out) == t_imp.load_manifest(out)


# -- codec ---------------------------------------------------------------------

def _picture(h=37, w=53, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    img[10:20] = (40, 90, 200)            # flat rows: PIL picks other filters
    img[:, 30:35] = img[:, 29:30]
    return img


@pytest.mark.parametrize("fmt", ["png", "jpeg", "jpeg-progressive"])
def test_image_size_matches_pil(tmp_path, fmt):
    """PNG's IHDR; a baseline JPEG's SOF0 and a progressive one's SOF2,
    each after an EXIF segment."""
    p = tmp_path / f"x.{fmt.split('-')[0]}"
    kw = {} if fmt == "png" else {"exif": Image.Exif().tobytes(),
                                  "progressive": fmt == "jpeg-progressive"}
    Image.fromarray(_picture(41, 67)).save(p, **kw)
    with Image.open(p) as im:
        assert codec.image_size(str(p)) == im.size == (67, 41)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNGx")
    with pytest.raises(ValueError):
        codec.image_size(str(bad))
    trunc = tmp_path / "trunc.jpeg"
    trunc.write_bytes(p.read_bytes()[:4] if fmt != "png" else b"\xff\xd8")
    with pytest.raises(ValueError):
        codec.image_size(str(trunc))


@pytest.mark.parametrize("decoder", ["native", "numpy"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "P16", "1"])
def test_read_rgb_matches_pil(tmp_path, mode, decoder):
    """Bitwise PIL's ``convert("RGB")``, through both decoders. PIL writes
    with adaptive filtering (all five filter types); a palette of 16
    colors is written at 4 bits per index and mode 1 at 1 bit."""
    if decoder == "native":
        _need_native()
    im = Image.fromarray(_picture())
    if mode.startswith("P"):
        im = im.quantize(16 if mode == "P16" else 200)
    else:
        im = im.convert(mode)
    p = tmp_path / "x.png"
    im.save(p)
    with Image.open(p) as ref:
        want = np.asarray(ref.convert("RGB"))
    got = codec.read_rgb(str(p), use_native=decoder == "native")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _png_with_filter(img: np.ndarray, ft: int) -> bytes:
    """An 8-bit RGB PNG whose rows all use PNG filter type ``ft``."""
    h, w = img.shape[:2]
    x = img.reshape(h, 3 * w).astype(int)
    rows = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros(3 * w, int)
        left = np.concatenate([np.zeros(3, int), x[y, :-3]])
        upleft = np.concatenate([np.zeros(3, int), up[:-3]])
        if ft == 0:
            pred = np.zeros_like(left)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        rows.append(bytes([ft]) + ((x[y] - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (codec.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
def test_png_filter_types_match_pil(tmp_path, ft):
    """Each of the five PNG filter types, every row, through the numpy
    reader: bitwise PIL."""
    p = tmp_path / "f.png"
    p.write_bytes(_png_with_filter(_picture(), ft))
    with Image.open(p) as ref:
        want = np.asarray(ref.convert("RGB"))
    np.testing.assert_array_equal(want, _picture())
    np.testing.assert_array_equal(codec.read_rgb(str(p), use_native=False),
                                  want)


def test_read_rgb_faults(tmp_path):
    """Corrupt files raise ValueError; a JPEG without the native library
    decodes through ``data/jpeg.py``, bitwise PIL's, and a truncated one
    raises ValueError."""
    p = tmp_path / "x.png"
    Image.fromarray(_picture()).save(p)
    data = p.read_bytes()
    (tmp_path / "trunc.png").write_bytes(data[:len(data) // 2])
    (tmp_path / "crc.png").write_bytes(data[:40] + bytes([data[40] ^ 1])
                                       + data[41:])
    (tmp_path / "junk.png").write_bytes(b"\x89PNGx")
    Image.fromarray(_picture()).save(tmp_path / "x.jpg")
    jpg = (tmp_path / "x.jpg").read_bytes()
    (tmp_path / "trunc.jpg").write_bytes(jpg[:len(jpg) // 2])
    for name in ("trunc.png", "crc.png", "junk.png", "trunc.jpg"):
        with pytest.raises(ValueError):
            codec.read_rgb(str(tmp_path / name), use_native=False)
    with Image.open(tmp_path / "x.jpg") as ref:
        np.testing.assert_array_equal(
            codec.read_rgb(str(tmp_path / "x.jpg"), use_native=False),
            np.asarray(ref.convert("RGB")))


def test_failed_build_is_reported(tmp_path, monkeypatch):
    """A library that does not build: ``available()`` is False and
    ``build_error()`` keeps the compiler's error; the codec falls to the
    numpy PNG reader and JPEG decoder (a JPEG decodes as PIL decodes it),
    the batch iterator takes the Python path and gives the same batch from
    a JPEG as from a PNG of PIL's decode of it, and the native calls
    raise."""
    bad = tmp_path / "host_pipeline.cpp"
    bad.write_text("#include <no_such_header_jpeglib.h>\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    for k, v in (("lib", None), ("error", None), ("tried", False)):
        monkeypatch.setattr(native._State, k, v)
    assert not native.available()
    assert "no_such_header_jpeglib.h" in native.build_error()
    assert os.listdir(tmp_path / "build") == ["lock"]
    assert codec.decoder().startswith("numpy")
    Image.fromarray(_picture()).save(tmp_path / "x.jpg")
    with Image.open(tmp_path / "x.jpg") as ref:
        np.testing.assert_array_equal(codec.read_rgb(str(tmp_path / "x.jpg")),
                                      np.asarray(ref.convert("RGB")))
    Image.fromarray(_picture()).save(tmp_path / "x.png")
    with Image.open(tmp_path / "x.png") as ref:
        np.testing.assert_array_equal(codec.read_rgb(str(tmp_path / "x.png")),
                                      np.asarray(ref))
    with pytest.raises(RuntimeError, match="not available"):
        native.load_process(str(tmp_path / "x.png"), (37, 53), 37, 53)
    cfg = Config.from_json(tiny_config().replace(
        examples_base_path=str(tmp_path),
        augmentation=AugmentationConfig()).to_json())
    Image.fromarray(_picture(160, 200)).save(tmp_path / "big.jpg")
    with Image.open(tmp_path / "big.jpg") as im:
        im.convert("RGB").save(tmp_path / "big.png")
    batches = []
    for name in ("big.jpg", "big.png"):
        roi = {"rect": [10.0, 20.0, 90.0, 120.0], "class_name": "a",
               "class_index": 0}
        manifest = {"ground_truth": {name: {"image_file_name": name,
                                            "rois": [roi]}},
                    "training_set": [name], "validation_set": []}
        it = BatchIterator(cfg, manifest, seed=0, use_native=True)
        assert not it.use_native
        batches.append(it.next_training_batch())
    a, b = batches
    assert bool(a.gt_mask.any())
    for f in ("image", "true_hw", "gt_boxes", "gt_mask", "gt_classes"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_native_resample_and_pack():
    """The library's resampler against ``resize_image`` (float32 taps and
    sums in C++, float64 in Pillow's order here: within 1e-5) and its s2d
    pack against the port's (bitwise: a copy)."""
    _need_native()
    img = np.random.default_rng(3).random((45, 70, 3), dtype=np.float32)
    for dh, dw in ((30, 50), (60, 90)):
        np.testing.assert_allclose(native.resample(img, dh, dw),
                                   resize_image(img, dw, dh), rtol=0,
                                   atol=1e-5)
    batch = np.random.default_rng(4).random((2, 6, 10, 3), dtype=np.float32)
    for a, b in zip(native.pack_s2d_batch(batch),
                    block0_kernel.pack_s2d_np(batch)):
        np.testing.assert_array_equal(a, b)


def test_jpeg_through_native_matches_pil(tmp_path):
    """Where the library is built, JPEG decodes through libjpeg; PIL
    decodes through its own libjpeg, so the bytes agree closely."""
    _need_native()
    p = tmp_path / "x.jpg"
    Image.fromarray(_picture(64, 80)).save(p, quality=92)
    with Image.open(p) as ref:
        want = np.asarray(ref.convert("RGB")).astype(int)
    got = codec.read_rgb(str(p))
    assert np.abs(got.astype(int) - want).max() <= 2


def test_write_png_reads_back_bitwise(tmp_path):
    img = _picture(29, 31)
    p = tmp_path / "w.png"
    codec.write_png(str(p), img)
    with Image.open(p) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(codec.read_rgb(str(p), use_native=False),
                                  img)
    with pytest.raises(ValueError):
        codec.write_png(str(p), img.astype(np.float32))


def test_save_image_png_only(tmp_path):
    img = np.zeros((20, 30, 3), np.float32)
    drawing.draw_rectangle(img, (2, 3, 12, 15), drawing.GREEN)
    drawing.save_image(img, str(tmp_path / "o.png"))
    with Image.open(tmp_path / "o.png") as im:
        got = np.asarray(im)
    assert got[3, 5].tolist() == [0, 255, 0] and got[8, 6].tolist() == [0] * 3
    with pytest.raises(ValueError, match="PNG only"):
        drawing.save_image(img, str(tmp_path / "o.jpg"))


# -- resize --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (160, 200, 128, 160),     # down
    (37, 53, 90, 120),        # up
    (100, 60, 50, 150),       # mixed: rows down, columns up
    (48, 64, 48, 40),         # one axis unchanged
])
def test_resize_matches_jax(shape):
    h, w, nh, nw = shape
    img = np.random.default_rng(2).normal(0.4, 0.3, (h, w, 3)).astype(
        np.float32)
    want = j_resize(img, nw, nh)
    got = resize_image(img, nw, nh)
    assert got.shape == want.shape == (nh, nw, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- batch iterators -----------------------------------------------------------

def _assert_same_batch(a, b, native_path):
    for f in ("true_hw", "gt_classes", "gt_mask", "is_background"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), f)
    np.testing.assert_allclose(b.gt_boxes.numpy(), np.asarray(a.gt_boxes),
                               rtol=0, atol=1e-5)
    want, got = np.asarray(a.image), b.image.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if native_path or want.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for x in b:
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"


CASES = {
    # name: (dataset, use_native, config changes)
    "python_flips": ("dataset", False, {}),
    "native_flips": ("dataset", True, {}),
    "uint8_wire": ("dataset", True, {"uint8_wire": True}),
    "uint8_wire_python": ("dataset", False, {"uint8_wire": True}),
    "dual_bucket_python": ("mixed", False, {}),
    "dual_bucket_native": ("mixed", True, {}),
    "corrupt_python": ("corrupt", False, {}),
    "corrupt_native": ("corrupt", True, {}),
}


@pytest.fixture(scope="module")
def corrupt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_data_corrupt")
    manifest = make_dataset(tmp, n=10)
    junk, trunc = manifest["training_set"][:2]
    (tmp / junk).write_bytes(b"\x89PNGx")
    data = (tmp / trunc).read_bytes()
    (tmp / trunc).write_bytes(data[:len(data) // 3])
    return tmp


def _case_cfg(case, tmp):
    kind, use_native, changes = CASES[case]
    if kind == "mixed":
        jc = dual_cfg(tmp).replace(
            augmentation=AugmentationConfig(hflip=0.5, vflip=0.5))
        manifest = str(tmp / "mix.json")
    else:
        jc = tiny_config().replace(examples_base_path=str(tmp))
        manifest = str(tmp / "manifest.json")
    jc = jc.replace(**changes)
    return jc, Config.from_json(jc.to_json()), manifest, use_native


@pytest.mark.parametrize("case", list(CASES))
def test_batch_iterator_matches_jax(request, case, caplog):
    if CASES[case][1]:
        _need_native()
    tmp = request.getfixturevalue(CASES[case][0])
    jc, cfg, manifest, use_native = _case_cfg(case, tmp)
    j = JBatchIterator(jc, manifest, seed=5, use_native=use_native)
    t = BatchIterator(cfg, manifest, seed=5, use_native=use_native)
    assert j.use_native == t.use_native == use_native
    buckets = set()
    for _ in range(6):
        a, b = j.next_training_batch(), t.next_training_batch()
        _assert_same_batch(a, b, use_native)
        buckets.add(tuple(b.image.shape[1:3]))
    if CASES[case][0] == "mixed":
        assert buckets == {(128, 160), (160, 128)}
    if CASES[case][0] == "corrupt":
        skipped = [r.getMessage() for r in caplog.records
                   if r.name == "frcnn_tpu_torch.data"]
        for name in json.loads(open(manifest).read())["training_set"][:2]:
            assert any(name in m for m in skipped), (name, skipped)


@pytest.mark.parametrize("kind", ["dataset", "mixed"])
def test_padded_validation_batch_matches_jax(request, kind):
    tmp = request.getfixturevalue(kind)
    if kind == "mixed":
        jc, manifest = dual_cfg(tmp), str(tmp / "mix.json")
    else:
        jc = tiny_config().replace(examples_base_path=str(tmp))
        manifest = str(tmp / "manifest.json")
    cfg = Config.from_json(jc.to_json())
    j = JBatchIterator(jc, manifest, seed=2)
    t = BatchIterator(cfg, manifest, seed=2)
    for n in (3, 2, 4):
        (ja, jh, jr), (ta, th, tr) = (j.padded_validation_batch(n),
                                      t.padded_validation_batch(n))
        assert isinstance(ta, torch.Tensor) and ta.dtype == torch.float32
        np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(th.numpy(), jh)
        assert tr == jr
    empty = dict(json.loads((tmp / os.path.basename(manifest)).read_text()),
                 validation_set=[])
    imgs, hws, rois = BatchIterator(cfg, empty).padded_validation_batch(2)
    assert imgs.shape == (0, *cfg.shapes.image_hw, 3) and rois == []


def test_native_selection_follows_the_config(dataset):
    """``use_native=None`` takes the library where it is built and the
    config allows it (no random scaling, rgb/yuv); otherwise Python."""
    cfg = Config.from_json(tiny_config().replace(
        examples_base_path=str(dataset)).to_json())
    m = str(dataset / "manifest.json")
    assert BatchIterator(cfg, m).use_native == native.available()
    lab = cfg.replace(color_space="lab")
    assert not BatchIterator(lab, m).use_native
    scaled = cfg.replace(augmentation=dataclasses.replace(
        cfg.augmentation, random_scaling=0.2))
    assert not BatchIterator(scaled, m, use_native=True).use_native


def test_random_scaling_matches_jax(dataset):
    """The Python path's scaling and crop draws, in the JAX order."""
    jc = tiny_config().replace(
        examples_base_path=str(dataset),
        augmentation=AugmentationConfig(hflip=0.5, vflip=0.5,
                                        random_scaling=0.4,
                                        aspect_jitter=0.2))
    cfg = Config.from_json(jc.to_json())
    m = str(dataset / "manifest.json")
    j, t = JBatchIterator(jc, m, seed=9), BatchIterator(cfg, m, seed=9)
    assert not t.use_native
    for _ in range(4):
        _assert_same_batch(j.next_training_batch(), t.next_training_batch(),
                           False)


def test_shards_match_jax(dataset):
    jc = tiny_config().replace(examples_base_path=str(dataset))
    cfg = Config.from_json(jc.to_json())
    m = str(dataset / "manifest.json")
    use = native.available()
    for k in range(2):
        j = JBatchIterator(jc, m, seed=1, shard_index=k, num_shards=2,
                           use_native=use)
        t = BatchIterator(cfg, m, seed=1, shard_index=k, num_shards=2,
                          use_native=use)
        assert j.use_native == t.use_native == use
        assert t.training.items == j.training.items
        _assert_same_batch(j.next_training_batch(), t.next_training_batch(),
                           use)


# -- prefetching and training from files ---------------------------------------

def test_prefetching_yields_the_bare_sequence(dataset):
    cfg = Config.from_json(tiny_config().replace(
        examples_base_path=str(dataset)).to_json())
    m = str(dataset / "manifest.json")
    bare = BatchIterator(cfg, m, seed=4)
    pre = PrefetchingIterator(BatchIterator(cfg, m, seed=4), depth=2)
    try:
        for _ in range(4):
            a, b = bare.next_training_batch(), pre.next_training_batch()
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    finally:
        pre.close()
    assert not pre._thread.is_alive()


def test_prefetching_reraises_the_worker_exception():
    class Failing:
        def __init__(self):
            self.n = 0

        def next_training_batch(self):
            self.n += 1
            if self.n > 2:
                raise OSError("disk gone")
            return self.n

    pre = PrefetchingIterator(Failing(), depth=1)
    assert [pre.next_training_batch() for _ in range(2)] == [1, 2]
    with pytest.raises(OSError, match="disk gone"):
        pre.next_training_batch()
    pre._thread.join(timeout=10)
    assert not pre._thread.is_alive()


def test_cpu_trainer_steps_from_files(dataset, tmp_path):
    """Two CPU train steps from the prefetcher: finite losses, nothing
    skipped; the weights serve a Detector-ready pair of modules and
    survive a snapshot."""
    cfg = Config.from_json(tiny_config().replace(
        examples_base_path=str(dataset)).to_json())
    pre = PrefetchingIterator(BatchIterator(cfg, str(dataset /
                                                     "manifest.json"),
                                            seed=0))
    try:
        tr = Trainer(cfg, device="cpu", seed=0)
        ms = [tr.run_step(pre.next_training_batch()) for _ in range(2)]
    finally:
        pre.close()
    for m in ms:
        assert m["skipped"] == 0
        assert all(np.isfinite(m[k]) for k in ("pcls", "preg", "dcls",
                                               "dreg"))
    pnet, cnet = models_from_state_dicts(cfg, tr.state_dicts())
    for net, mod in (("pnet", pnet), ("cnet", cnet)):
        for k, v in mod.state_dict().items():
            assert torch.equal(v, tr.state_dicts()[net][k]), k
    tr.save_snapshot(str(tmp_path / "s.ckpt"))
    tr2 = Trainer(cfg, device="cpu", seed=1)
    tr2.restore_snapshot(str(tmp_path / "s.ckpt"))
    assert tr2.step == 2


# -- utils ---------------------------------------------------------------------

def test_plot_training_progress_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    stats = {k: [float(i) + j for i in range(5)]
             for j, k in enumerate(("pcls", "preg", "dcls", "dreg"))}
    fn = plotting.plot_training_progress(str(tmp_path / "t"), stats)
    j_plotting.plot_training_progress(str(tmp_path / "j"), stats)
    assert os.path.exists(fn) and fn.endswith("t_progress.png")
    assert ((tmp_path / "t_progress.csv").read_text()
            == (tmp_path / "j_progress.csv").read_text())


def test_profiler_trace(tmp_path):
    with profiler_trace(None):
        pass
    assert not list(tmp_path.iterdir())
    with profiler_trace(str(tmp_path / "tr")):
        torch.ones(64).sum()
        time.sleep(0.001)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
