"""The JPEG fixtures of ``frcnn_tpu_torch/tools/jpeg_fixtures``: how each
is made with Pillow from a crop of ``frcnn_tpu_torch/tools/photos``, and
the SOURCES.md that lists them with the SHA-256 of PIL's decode (what
``chip_smoke.py`` holds the port's decoder to where there is no PIL).

Regenerate the files and SOURCES.md with ``python -m tests.jpeg_fixtures``.
"""

from __future__ import annotations

import hashlib
import io
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
PHOTOS = ROOT / "frcnn_tpu_torch" / "tools" / "photos"
OUT = ROOT / "frcnn_tpu_torch" / "tools" / "jpeg_fixtures"

# name: (photo, (y, x, h, w) crop, PIL mode, save keywords, patch)
FIXTURES = {
    "frame_q90_420_500x375.jpg": ("china.png", (26, 70, 375, 500), "RGB",
                                  {"quality": 90}, None),
    "q50_420.jpg": ("flower.png", (150, 200, 120, 160), "RGB",
                    {"quality": 50}, None),
    "q75_422.jpg": ("flower.png", (100, 300, 120, 160), "RGB",
                    {"quality": 75, "subsampling": 1}, None),
    "q95_444.jpg": ("grace_hopper.png", (60, 180, 120, 160), "RGB",
                    {"quality": 95, "subsampling": 0}, None),
    "odd_q95_420_101x77.jpg": ("china.png", (200, 300, 77, 101), "RGB",
                               {"quality": 95}, None),
    "progressive_420_161x119.jpg": ("grace_hopper.png", (200, 100, 119, 161),
                                    "RGB", {"quality": 80,
                                            "progressive": True}, None),
    "progressive_444_93x61.jpg": ("flower.png", (30, 40, 61, 93), "RGB",
                                  {"quality": 85, "progressive": True,
                                   "subsampling": 0}, None),
    "restart_blocks.jpg": ("china.png", (100, 400, 100, 150), "RGB",
                           {"quality": 80, "restart_marker_blocks": 3},
                           None),
    "restart_rows_progressive.jpg": ("flower.png", (250, 60, 100, 150),
                                     "RGB", {"quality": 80,
                                             "progressive": True,
                                             "restart_marker_rows": 1},
                                     None),
    "gray_123x77.jpg": ("grace_hopper.png", (300, 200, 77, 123), "L",
                        {"quality": 80}, None),
    "gray_progressive_47x33.jpg": ("china.png", (10, 10, 33, 47), "L",
                                   {"quality": 70, "progressive": True},
                                   None),
    "cmyk.jpg": ("flower.png", (200, 420, 90, 120), "CMYK",
                 {"quality": 85}, None),
    "ycck.jpg": ("flower.png", (200, 420, 90, 120), "CMYK",
                 {"quality": 85}, "ycck"),
    "rgb.jpg": ("china.png", (250, 500, 90, 120), "RGB",
                {"quality": 85, "keep_rgb": True}, None),
    "tiny_1x1.jpg": ("grace_hopper.png", (100, 100, 1, 1), "RGB",
                     {"quality": 90}, None),
    "tiny_5x3.jpg": ("grace_hopper.png", (100, 100, 3, 5), "RGB",
                     {"quality": 90}, None),
    "truncated.jpg": ("china.png", (26, 70, 120, 160), "RGB",
                      {"quality": 75}, "truncate"),
}
PATCHES = {
    "ycck": "APP14 Adobe transform byte set from 0 (CMYK) to 2 (YCCK)",
    "truncate": "cut to its first 60% of bytes, inside the scan",
}


def photo(name: str) -> np.ndarray:
    with Image.open(PHOTOS / name) as im:
        return np.asarray(im.convert("RGB"))


def make(name: str) -> bytes:
    """The bytes of fixture ``name`` as Pillow writes them."""
    src, (y, x, h, w), mode, kw, patch = FIXTURES[name]
    buf = io.BytesIO()
    Image.fromarray(photo(src)[y:y + h, x:x + w]).convert(mode).save(
        buf, "JPEG", **kw)
    data = buf.getvalue()
    if patch == "ycck":
        i = data.index(b"Adobe")        # APP14's data, after its length
        j = i + 11
        assert data[i - 4:i - 2] == b"\xff\xee" and data[j] == 0
        data = data[:j] + b"\x02" + data[j + 1:]
    elif patch == "truncate":
        data = data[:len(data) * 6 // 10]
    return data


def pil_rgb(data: bytes) -> np.ndarray:
    """PIL's decode of JPEG bytes: ``Image.open(f).convert("RGB")``."""
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def sha256_of_pil(data: bytes) -> str:
    """The SHA-256 of PIL's RGB bytes, or "raises" where PIL raises."""
    try:
        rgb = pil_rgb(data)
    except OSError:
        return "raises"
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def sources_md() -> str:
    import PIL
    from PIL import features

    lines = [
        "# JPEG fixtures of the port's decoder",
        "",
        "Crops of `tools/photos` (licences and attribution in its "
        "`SOURCES.md`), written",
        f"by Pillow {PIL.__version__} over libjpeg-turbo "
        f"{features.version('libjpeg_turbo')} with",
        "`Image.fromarray(photo[y:y + h, x:x + w]).convert(mode)"
        ".save(f, \"JPEG\", **kw)` and",
        "made again by `python -m tests.jpeg_fixtures`. The last column is "
        "the SHA-256 of",
        "`np.asarray(Image.open(f).convert(\"RGB\")).tobytes()`, PIL's "
        "decode, which",
        "`data/jpeg.py` gives bit for bit (`tests/test_torch_jpeg.py`; on "
        "the card, where",
        "there is no PIL, `chip_smoke.py`'s `[data]` phase holds the decode "
        "to this column).",
        "",
        "| File | Photo, crop (y, x, h, w), mode | Pillow's `save` keywords, "
        "patch | SHA-256 of PIL's RGB |",
        "| --- | --- | --- | --- |",
    ]
    for name, (src, crop, mode, kw, patch) in FIXTURES.items():
        kws = ", ".join(f"{k}={v!r}" for k, v in kw.items())
        if patch:
            kws += f"; then {PATCHES[patch]}"
        lines.append(f"| `{name}` | `{src}` {crop}, {mode} | {kws} | "
                     f"`{sha256_of_pil((OUT / name).read_bytes())}` |")
    return "\n".join(lines) + "\n"


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for name in FIXTURES:
        (OUT / name).write_bytes(make(name))
    (OUT / "SOURCES.md").write_text(sources_md())


if __name__ == "__main__":
    main()
