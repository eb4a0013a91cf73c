"""Image files without PIL: header sizes, decode to RGB bytes, PNG output.

* :func:`image_size` reads ``(w, h)`` from a PNG's IHDR chunk or a JPEG's
  first start-of-frame marker, without decoding.
* :func:`read_rgb` decodes to uint8 RGB ``[h, w, 3]``. Where the native
  host library builds (``data/native.py``, libjpeg/libpng), it decodes
  PNG and JPEG: the library's pipeline at scale 1 (its resampling taps are
  then exactly 1 and 0) into a canvas of the image's own size, from which
  ``rint(canvas * 255)`` is the decoded byte. Otherwise, or with
  ``use_native=False``, PNG goes through the numpy/zlib reader here (bit
  depths 1-16, not interlaced, color types 0/2/3/4/6, the five filter
  types) and JPEG through ``data/jpeg.py`` (baseline, extended and
  progressive Huffman, bitwise PIL's decode). Alpha is dropped and gray is
  repeated, as PIL's ``convert("RGB")`` does.
* :func:`write_png` writes uint8 RGB with zlib and filter 0.
* :func:`jpeg_roundtrip` is a JPEG save and open in memory, as PIL's.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from frcnn_tpu_torch.data import jpeg, native
from frcnn_tpu_torch.data.jpeg import (
    _CONST_BITS,
    _F0541,
    _F0765,
    _F1847,
    _PASS1_BITS,
    _descale,
    _fancy_upsample,
    _fix,
    _idct_pass,
    _odd_rotation,
    _ycc_to_rgb,
)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# JPEG start-of-frame markers: C0-CF except DHT (C4), JPG (C8), DAC (CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# samples per pixel by PNG color type: gray, RGB, palette, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def image_size(path: str) -> Tuple[int, int]:
    """``(w, h)`` from the file's header (PNG or JPEG). Raises
    ``ValueError`` for an unknown format or a truncated header."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == PNG_SIGNATURE:
            if len(head) < 24 or head[12:16] != b"IHDR":
                raise ValueError(f"{path}: truncated PNG header")
            w, h = struct.unpack(">II", head[16:24])
            return w, h
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither PNG nor JPEG")
        f.seek(2)
        while True:
            b = f.read(1)
            if not b:
                raise ValueError(f"{path}: no JPEG start-of-frame marker")
            if b != b"\xff":
                continue
            m = f.read(1)
            while m == b"\xff":                 # fill bytes
                m = f.read(1)
            if not m:
                raise ValueError(f"{path}: truncated JPEG header")
            m = m[0]
            if m == 0x01 or m == 0xD8 or 0xD0 <= m <= 0xD7:
                continue                         # markers with no length
            if m in (0xD9, 0xDA):
                raise ValueError(f"{path}: no JPEG start-of-frame marker")
            seg = f.read(2)
            if len(seg) < 2:
                raise ValueError(f"{path}: truncated JPEG header")
            n = struct.unpack(">H", seg)[0]
            if m in _SOF:
                frame = f.read(5)
                if len(frame) < 5:
                    raise ValueError(f"{path}: truncated JPEG header")
                h, w = struct.unpack(">HH", frame[1:5])
                return w, h
            f.seek(n - 2, 1)


def decoder() -> str:
    """The decoder :func:`read_rgb` uses by default."""
    if native.available():
        return "native (libjpeg/libpng, csrc/host_pipeline.cpp)"
    return "numpy/zlib PNG reader and numpy JPEG decoder (data/jpeg.py)"


def read_rgb(path: str, use_native: Optional[bool] = None) -> np.ndarray:
    """Decode ``path`` to uint8 RGB [h, w, 3]. ``use_native`` (default:
    where the library is available) picks the native decoder; False, or a
    library that is not available, gives the numpy PNG reader and the
    numpy JPEG decoder. Raises ``ValueError`` for a file that does not
    decode: corrupt or truncated, or a JPEG of a kind ``data/jpeg.py``
    refuses (arithmetic, lossless, hierarchical, 12-bit)."""
    if use_native is None:
        use_native = native.available()
    if use_native:
        return _read_native(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return jpeg.decode(data)
    raise ValueError(f"{path}: neither PNG nor JPEG")


def _read_native(path: str) -> np.ndarray:
    w, h = image_size(path)
    got = native.load_process(path, (h, w), min(h, w), max(h, w))
    if got is None:
        raise ValueError(f"{path}: the native decoder refused the file")
    canvas, kept, orig = got
    if kept != (h, w) or orig != (h, w):
        raise ValueError(f"{path}: header size {(h, w)}, decoded {orig}")
    return np.rint(canvas * np.float32(255.0)).astype(np.uint8)


# -- the numpy PNG reader ------------------------------------------------------

def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) < n or len(crc) < 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``rows`` [h, 1 + row_bytes]."""
    h, n = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    for y in range(h):
        ft, x = rows[y, 0], rows[y, 1:]
        if ft == 0:
            out[y] = x
        elif ft == 1:
            out[y] = np.cumsum(x.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ft == 2:
            out[y] = x + prev
        elif ft in (3, 4):
            cur, up = bytearray(x.tobytes()), prev.tobytes()
            for i in range(n):
                left = cur[i - bpp] if i >= bpp else 0
                if ft == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ft}")
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The numpy/zlib PNG decoder behind :func:`read_rgb`."""
    ihdr, plte, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG IHDR of the wrong length")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG color type {ctype}, bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNG needs the native host library")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    row_bytes = (w * bits + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    if len(raw) < h * (1 + row_bytes):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, h * (1 + row_bytes)).reshape(
        h, 1 + row_bytes)
    px = _unfilter(rows, max(1, bits // 8))
    if depth == 16:          # the high byte, as libpng's strip_16
        s = px.reshape(h, w, ch, 2)[..., 0]
    elif depth == 8:
        s = px.reshape(h, w, ch)
    else:                    # gray or palette indices of 1, 2 or 4 bits
        b = np.unpackbits(px, axis=1)[:, :w * depth].reshape(h, w, depth)
        s = (b * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(
            np.uint8)[..., None]
        if ctype == 0:
            s = s * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if plte is None or int(s.max(initial=0)) >= len(plte):
            raise ValueError("PNG palette index out of range")
        return plte[s[..., 0]]
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write uint8 RGB [h, w, 3] as an 8-bit RGB PNG (filter 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [h, w, 3], not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = img.reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + chunk(b"IEND", b""))


# -- the JPEG round trip (in memory) ------------------------------------------

# the IJG example quantization tables (JPEG Annex K), natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.int64).reshape(8, 8)
def _fdct_pass(d, axis: int, last: bool):
    """One pass of ``jpeg_fdct_islow`` along ``axis`` (length 8)."""
    g = [np.take(d, i, axis=axis) for i in range(8)]
    t0, t7, t1, t6 = g[0] + g[7], g[0] - g[7], g[1] + g[6], g[1] - g[6]
    t2, t5, t3, t4 = g[2] + g[5], g[2] - g[5], g[3] + g[4], g[3] - g[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    n = _CONST_BITS + _PASS1_BITS if last else _CONST_BITS - _PASS1_BITS
    z1 = (t12 + t13) * _F0541
    o4, o5, o6, o7 = _odd_rotation(t4, t5, t6, t7)
    even = ((lambda v: _descale(v, _PASS1_BITS)) if last
            else (lambda v: v << _PASS1_BITS))
    out = [even(t10 + t11), o7, z1 + t13 * _F0765, o6, even(t10 - t11), o5,
           z1 - t12 * _F1847, o4]
    return np.stack([v if i in (0, 4) else _descale(v, n)
                     for i, v in enumerate(out)], axis=axis)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``'s table: the
    base table scaled by the quality, rounded, within [1, 255]."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _rgb_to_ycc(p: np.ndarray):
    """libjpeg's fixed-point RGB -> YCbCr (``jccolor.c``) of int64 RGB."""
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off
          + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off
          + half - 1) >> 16
    return y, cb, cr


def _dct_roundtrip(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Each 8x8 block of the int64 plane (sides multiples of 8) as libjpeg
    codes and decodes it: level shift, the integer forward DCT (rows, then
    columns; the coefficients come out 8x the JPEG ones), quantization by
    8q rounded half away from zero, dequantization, the integer inverse
    DCT (columns, then rows), +128 and the clip to [0, 255]."""
    h, w = plane.shape
    b = (plane - 128).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    coef = _fdct_pass(_fdct_pass(b, -1, False), -2, True)
    d = 8 * q
    qc = np.where(coef < 0, -((d // 2 - coef) // d), (coef + d // 2) // d)
    rec = _idct_pass(_idct_pass(qc * q, -2, False), -1, True)
    return np.clip(rec + 128, 0, 255).transpose(0, 2, 1, 3).reshape(h, w)


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """uint8 RGB [h, w, 3] as a baseline JPEG of ``quality`` decodes: what
    PIL's ``save(quality=q)`` and then ``open`` give (libjpeg's defaults:
    YCbCr, 4:2:0 chroma, the IJG tables scaled by the quality, the integer
    DCTs, fancy upsampling), in memory, without a JPEG library. The
    encoder's edges: columns repeated at full resolution to the MCU width
    of 16, rows repeated to an even count, each plane's rows then repeated
    to a multiple of 8 (libjpeg pads the downsampled planes, not the
    image). Chroma is box-downsampled with libjpeg's alternating rounding
    bias; the color conversions are its fixed-point ones. It equals
    PIL's round trip bitwise on the photographs of ``tools/photos`` and on
    random images (``tests/test_torch_accuracy_tools.py``): this follows
    libjpeg's C code, which its SIMD paths match bit for bit."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"jpeg_roundtrip takes uint8 [h, w, 3], not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    p = np.pad(img, ((0, h % 2), (0, -w % 16), (0, 0)), mode="edge")
    y, cb, cr = _rgb_to_ycc(p.astype(np.int64))
    bias = np.where(np.arange(p.shape[1] // 2) % 2 == 0, 1, 2)

    def down(c):                     # h2v2: 2x2 sums, bias 1, 2, 1, 2, ...
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        return (s + bias) >> 2

    def pad8(c):
        return np.pad(c, ((0, -c.shape[0] % 8), (0, -c.shape[1] % 8)),
                      mode="edge")

    lq = quant_table(_LUMA_Q, quality)
    cq = quant_table(_CHROMA_Q, quality)
    y = _dct_roundtrip(pad8(y), lq)[:h, :w]
    hc, wc = -(-h // 2), -(-w // 2)
    cb, cr = (_fancy_upsample(_dct_roundtrip(pad8(down(c)), cq)[:hc, :wc])
              [:h, :w] for c in (cb, cr))
    return _ycc_to_rgb(y, cb, cr)
