"""The port's JPEG decoder (``data/jpeg.py``, through ``codec.read_rgb``
and ``pipeline.load_image`` with ``use_native=False``) against the JAX
package's ``load_image`` (PIL's ``Image.open(p).convert("RGB")``).

Every committed fixture of ``frcnn_tpu_torch/tools/jpeg_fixtures`` and
every variant PIL writes here (qualities, chroma subsamplings,
progressive, restart markers, odd sizes, gray, CMYK, YCCK, RGB,
optimized and 16-bit tables) decodes bitwise: the float32 images are
equal, and the RGB bytes hash to the SHA-256 in the fixtures'
SOURCES.md. Truncated files, arithmetic coding, lossless, hierarchical
and 12-bit frames raise ``ValueError`` (PIL raises too, or decodes a
kind the port refuses).
"""

import hashlib
import io
import re

import numpy as np
import pytest
from PIL import Image

from frcnn_tpu.data.pipeline import load_image as j_load_image
from frcnn_tpu_torch.data import codec, jpeg
from frcnn_tpu_torch.data.pipeline import load_image
from tests import jpeg_fixtures as fx


def _sources() -> dict:
    out = {}
    for ln in (fx.OUT / "SOURCES.md").read_text().splitlines():
        m = re.match(r"^\| `([^`]+\.jpg)` \|.*\| `([0-9a-f]{64}|raises)` \|$",
                     ln)
        if m:
            out[m.group(1)] = m.group(2)
    return out


SOURCES = _sources()


def test_sources_list_every_fixture():
    assert sorted(SOURCES) == sorted(fx.FIXTURES)
    assert sorted(p.name for p in fx.OUT.glob("*.jpg")) == sorted(fx.FIXTURES)
    assert sum(p.stat().st_size for p in fx.OUT.iterdir()) < 400_000


@pytest.mark.parametrize("name", [n for n in fx.FIXTURES
                                  if n != "truncated.jpg"])
def test_fixture_matches_jax_load_image(name):
    path = str(fx.OUT / name)
    want = j_load_image(path)
    got = load_image(path, use_native=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    rgb = codec.read_rgb(path, use_native=False)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == SOURCES[name]
    assert fx.sha256_of_pil(fx.OUT.joinpath(name).read_bytes()) \
        == SOURCES[name]


def test_truncated_fixture_raises():
    path = str(fx.OUT / "truncated.jpg")
    with pytest.raises(OSError):
        j_load_image(path)
    with pytest.raises(ValueError, match="truncated"):
        load_image(path, use_native=False)
    assert SOURCES["truncated.jpg"] == "raises"


def _crop(h: int, w: int, y: int = 40, x: int = 60) -> np.ndarray:
    return fx.photo("flower.png")[y:y + h, x:x + w]


def _write(tmp_path, name, img, mode="RGB", **kw) -> str:
    p = tmp_path / name
    Image.fromarray(img).convert(mode).save(p, "JPEG", **kw)
    return str(p)


VARIANTS = {
    **{f"q{q}_{ss}": ((120, 160), "RGB", {"quality": q, "subsampling": i})
       for q in (50, 75, 95) for i, ss in enumerate(("444", "422", "420"))},
    "q100": ((64, 96), "RGB", {"quality": 100}),
    "q1": ((64, 96), "RGB", {"quality": 1}),
    "optimized": ((96, 130), "RGB", {"quality": 80, "optimize": True}),
    "table16": ((64, 80), "RGB", {"qtables": [[300] * 64, [1000] * 64]}),
    "progressive_420": ((119, 161), "RGB", {"quality": 80,
                                            "progressive": True}),
    "progressive_422": ((70, 91), "RGB", {"quality": 60, "subsampling": 1,
                                          "progressive": True}),
    "progressive_444": ((61, 93), "RGB", {"quality": 90, "subsampling": 0,
                                          "progressive": True}),
    "restart_blocks": ((100, 150), "RGB", {"quality": 80,
                                           "restart_marker_blocks": 1}),
    "restart_rows": ((100, 150), "RGB", {"quality": 80,
                                         "restart_marker_rows": 2}),
    "restart_progressive": ((100, 150), "RGB",
                            {"quality": 80, "progressive": True,
                             "restart_marker_blocks": 5}),
    **{f"odd_{h}x{w}": ((h, w), "RGB", {"quality": 90})
       for h, w in ((1, 1), (2, 2), (3, 17), (17, 3), (33, 65), (65, 33))},
    "odd_422_9x5": ((9, 5), "RGB", {"quality": 90, "subsampling": 1}),
    "gray": ((77, 123), "L", {"quality": 80}),
    "gray_progressive": ((33, 47), "L", {"quality": 70,
                                         "progressive": True}),
    "gray_odd": ((1, 9), "L", {"quality": 70}),
    "cmyk": ((90, 120), "CMYK", {"quality": 85}),
    "cmyk_progressive": ((41, 57), "CMYK", {"quality": 85,
                                            "progressive": True}),
    "rgb": ((90, 120), "RGB", {"quality": 85, "keep_rgb": True}),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_jax_load_image(tmp_path, name):
    (h, w), mode, kw = VARIANTS[name]
    path = _write(tmp_path, f"{name}.jpg", _crop(h, w), mode, **kw)
    want = j_load_image(path)
    got = load_image(path, use_native=False)
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_ycck_matches_pil(tmp_path):
    """A CMYK file whose Adobe marker says YCCK (transform 2): libjpeg
    converts its three first components from YCC, as the port does."""
    path = tmp_path / "ycck.jpg"
    data = fx.make("ycck.jpg")
    path.write_bytes(data)
    np.testing.assert_array_equal(load_image(str(path), use_native=False),
                                  j_load_image(str(path)))


def _baseline(tmp_path) -> bytes:
    p = _write(tmp_path, "b.jpg", _crop(40, 56), quality=75)
    return open(p, "rb").read()


def _patch_sof(data: bytes, marker: int = None, precision: int = None):
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("marker,what", [
    (0xC9, "SOF9 (arithmetic coding)"),
    (0xCA, "SOF10 (arithmetic coding, progressive)"),
    (0xC3, "SOF3 (lossless)"),
    (0xC5, "SOF5 (hierarchical)"),
])
def test_refused_frames_raise(tmp_path, marker, what):
    p = tmp_path / "x.jpg"
    p.write_bytes(_patch_sof(_baseline(tmp_path), marker=marker))
    with pytest.raises(ValueError, match=re.escape(what)):
        codec.read_rgb(str(p), use_native=False)


def test_twelve_bit_and_truncated_scans_raise(tmp_path):
    data = _baseline(tmp_path)
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode(_patch_sof(data, precision=12))
    sos = data.index(b"\xff\xda")
    for cut in (sos + 30, (sos + len(data)) // 2, len(data) - 2):
        with pytest.raises(ValueError, match="truncated"):
            jpeg.decode(data[:cut])
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data[:cut])).load()
    with pytest.raises(ValueError, match="no SOI"):
        jpeg.decode(b"\xff\xd9")


def test_decoder_reports_the_numpy_path(monkeypatch):
    from frcnn_tpu_torch.data import native

    monkeypatch.setattr(native, "available", lambda: False)
    assert codec.decoder() == ("numpy/zlib PNG reader and numpy JPEG "
                               "decoder (data/jpeg.py)")
    name = "q50_420.jpg"
    rgb = codec.read_rgb(str(fx.OUT / name))
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == SOURCES[name]


# -- sampling factors Pillow does not write: a small baseline encoder ---------

def _pil_huffman_tables() -> dict:
    """{(class, id): (counts, symbols)} of the DHT segments Pillow writes
    (libjpeg's standard tables)."""
    buf = io.BytesIO()
    Image.fromarray(_crop(16, 16)).save(buf, "JPEG", quality=75)
    data, pos, out = buf.getvalue(), 2, {}
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + n]
        if data[pos + 1] == 0xC4:
            i = 0
            while i < len(seg):
                counts = list(seg[i + 1:i + 17])
                out[(seg[i] >> 4, seg[i] & 15)] = (
                    counts, list(seg[i + 17:i + 17 + sum(counts)]))
                i += 17 + sum(counts)
        pos += 2 + n
    return out


def _canonical(counts, symbols) -> dict:
    codes, code, k = {}, 0, 0
    for n, c in enumerate(counts, 1):
        for _ in range(c):
            codes[symbols[k]] = (code, n)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _encode(img: np.ndarray, factors, quality: int = 80) -> bytes:
    """A baseline JPEG of ``img`` (uint8 RGB, or gray [h, w]) whose
    components have the sampling ``factors`` [(h, v), ...]: planes padded
    by edge replication to whole MCUs and box-averaged to each component's
    sampling, libjpeg's integer FDCT and quantization
    (``codec._fdct_pass``), Pillow's Huffman tables, one interleaved scan
    (one component: its own blocks in raster order)."""
    from frcnn_tpu_torch.data.codec import (
        _CHROMA_Q,
        _LUMA_Q,
        _fdct_pass,
        _rgb_to_ycc,
        quant_table,
    )
    from frcnn_tpu_torch.data.jpeg import _NATURAL

    h, w = img.shape[:2]
    planes = ([img.astype(np.int64)] if img.ndim == 2
              else list(_rgb_to_ycc(img.astype(np.int64))))
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    tables = _pil_huffman_tables()
    qt = [quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)]
    blocks = []
    for i, (p, (fh, fv)) in enumerate(zip(planes, factors)):
        p = np.pad(p, ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)),
                   mode="edge")
        rv, rh = vmax // fv, hmax // fh
        p = p.reshape(p.shape[0] // rv, rv, p.shape[1] // rh, rh).mean(
            (1, 3)).round().astype(np.int64)
        b = (p - 128).reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8)
        coef = _fdct_pass(_fdct_pass(b.transpose(0, 2, 1, 3), -1, False), -2,
                          True)
        d = 8 * qt[min(i, 1)]
        q = np.where(coef < 0, -((d // 2 - coef) // d), (coef + d // 2) // d)
        blocks.append(q.reshape(*q.shape[:2], 64)[..., _NATURAL])
    bits = []

    def put(code, n):
        bits.extend((code >> (n - 1 - j)) & 1 for j in range(n))

    def coded(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    dc = [_canonical(*tables[(0, 0)]), _canonical(*tables[(0, 1)])]
    ac = [_canonical(*tables[(1, 0)]), _canonical(*tables[(1, 1)])]
    pred = [0] * len(planes)

    def block(i, z):
        t = min(i, 1)
        s, v = coded(int(z[0]) - pred[i])
        pred[i] = int(z[0])
        put(*dc[t][s])
        put(v, s)
        run = 0
        for k in range(1, 64):
            if z[k] == 0:
                run += 1
                continue
            while run > 15:
                put(*ac[t][0xF0])
                run -= 16
            s, v = coded(int(z[k]))
            put(*ac[t][run << 4 | s])
            put(v, s)
            run = 0
        if run:
            put(*ac[t][0x00])

    if len(planes) == 1:
        for by in range(-(-h // 8)):
            for bx in range(-(-w // 8)):
                block(0, blocks[0][by, bx])
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                for i, (fh, fv) in enumerate(factors):
                    for v in range(fv):
                        for u in range(fh):
                            block(i, blocks[i][my * fv + v, mx * fh + u])
    bits.extend([1] * (-len(bits) % 8))
    body = np.packbits(np.array(bits, np.uint8)).tobytes()
    body = body.replace(b"\xff", b"\xff\x00")

    def segment(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(
            2, "big") + payload

    n = len(planes)
    out = b"\xff\xd8"
    for t in range(min(n, 2)):
        out += segment(0xDB, bytes([t]) + bytes(
            qt[t].ravel()[_NATURAL].astype(np.uint8)))
    out += segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(
        2, "big") + bytes([n]) + b"".join(
        bytes([i + 1, fh << 4 | fv, min(i, 1)])
        for i, (fh, fv) in enumerate(factors)))
    for (tc, th), (counts, syms) in sorted(tables.items()):
        if th < min(n, 2):
            out += segment(0xC4, bytes([tc << 4 | th] + counts + syms))
    out += segment(0xDA, bytes([n]) + b"".join(
        bytes([i + 1, min(i, 1) << 4 | min(i, 1)]) for i in range(n))
        + bytes([0, 63, 0]))
    return out + body + b"\xff\xd9"


SAMPLINGS = {
    "h1v2": ((37, 29), [(1, 2), (1, 1), (1, 1)]),
    "h2v1": ((29, 37), [(2, 1), (1, 1), (1, 1)]),
    "h4v1_411": ((24, 70), [(4, 1), (1, 1), (1, 1)]),
    "h1v4": ((70, 24), [(1, 4), (1, 1), (1, 1)]),
    "h3v1": ((20, 50), [(3, 1), (1, 1), (1, 1)]),
    "luma_below_chroma": ((33, 41), [(1, 1), (2, 2), (2, 2)]),
    "mixed_h2v2_h1v2": ((40, 45), [(2, 2), (1, 1), (2, 1)]),
    "h1v2_narrow": ((17, 2), [(1, 2), (1, 1), (1, 1)]),
    "gray_2x2": ((27, 35), [(2, 2)]),
}


@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_sampling_factors_match_pil(name):
    (h, w), factors = SAMPLINGS[name]
    img = _crop(h, w, 100, 120)
    if len(factors) == 1:
        img = img[..., 1]
    data = _encode(img, factors)
    want = fx.pil_rgb(data)
    got = jpeg.decode(data)
    assert want.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
