"""Image files without PIL: header sizes, decode to RGB bytes, PNG output.

* :func:`image_size` reads ``(w, h)`` from a PNG's IHDR chunk or a JPEG's
  first start-of-frame marker, without decoding.
* :func:`read_rgb` decodes to uint8 RGB ``[h, w, 3]``. Where the native
  host library builds (``data/native.py``, libjpeg/libpng), it decodes
  PNG and JPEG: the library's pipeline at scale 1 (its resampling taps are
  then exactly 1 and 0) into a canvas of the image's own size, from which
  ``rint(canvas * 255)`` is the decoded byte. Otherwise PNG goes through
  the numpy/zlib reader here (bit depths 1-16, not interlaced, color
  types 0/2/3/4/6, the five filter types), and JPEG raises, quoting why
  the library did not build. PNG is lossless, so both decoders give the
  same bytes; alpha is dropped and gray is repeated, as PIL's
  ``convert("RGB")`` does.
* :func:`write_png` writes uint8 RGB with zlib and filter 0.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from frcnn_tpu_torch.data import native

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
    return "numpy/zlib PNG reader (no JPEG)"


def read_rgb(path: str, use_native: Optional[bool] = None) -> np.ndarray:
    """Decode ``path`` to uint8 RGB [h, w, 3]. ``use_native`` (default:
    where the library is available) picks the native decoder; False
    forces the numpy PNG reader. Raises ``ValueError`` for a file that
    does not decode, and ``RuntimeError`` for a JPEG without the
    library."""
    if use_native is None:
        use_native = native.available()
    if use_native:
        return _read_native(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        raise RuntimeError(
            f"{path}: JPEG needs the native host library, which is not "
            f"available: {native.build_error()}")
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
