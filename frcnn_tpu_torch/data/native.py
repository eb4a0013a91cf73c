"""ctypes bindings for the native host pipeline ``csrc/host_pipeline.cpp``
(the JAX package's ``data/native.py``):

* :func:`load_process` — decode + resize + color + flip + pad one file,
* :func:`load_process_batch` — a whole batch in one GIL-releasing call on
  a C++ thread pool,
* :func:`resample` — the bare Pillow-compatible triangle resampler,
* :func:`pack_s2d_batch` — the space-to-depth pack of the serving layout.

The library is built at first use (never at import) with ``g++``, the flags
and libraries of ``csrc/Makefile``, into ``frcnn_tpu_torch/_build/host/``,
under a file lock so that concurrent processes build it once. The shared
source is only read. ``available()`` is False where the toolchain or
libjpeg/libpng are missing; :func:`build_error` then says why, and the
callers that need the library quote it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "host_pipeline.cpp")
_BUILD_DIR = os.path.join(_ROOT, "frcnn_tpu_torch", "_build", "host")
# csrc/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")

COLOR_SPACES = {"rgb": 0, "": 0, None: 0, "yuv": 1, "lab": 2, "hsv": 3}


class _State:
    """The loaded library, or the reason there is none (one per process)."""

    lock = threading.Lock()
    lib = None
    error: Optional[str] = None
    tried = False


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXXFLAGS + LDLIBS).encode())
    return os.path.join(_BUILD_DIR, f"libfrcnn_host-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile the library to ``path`` unless it is there; raises
    ``RuntimeError`` with the compiler's output."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ["g++", *CXXFLAGS, "-shared", "-o", tmp, _SRC, *LDLIBS]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=240)
            if r.returncode != 0:
                raise RuntimeError(f"g++ exited {r.returncode} on {_SRC}:\n"
                                   f"{(r.stderr or r.stdout).strip()[-2000:]}")
            os.replace(tmp, path)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _declare(lib) -> None:
    c_int, c_float = ctypes.c_int, ctypes.c_float
    p_int = ctypes.POINTER(ctypes.c_int)
    p_float = ctypes.POINTER(ctypes.c_float)
    lib.frcnn_load_process.restype = c_int
    lib.frcnn_load_process.argtypes = [
        ctypes.c_char_p, p_float, c_int, c_int, c_int, c_int, c_int, c_int,
        c_int, c_float, c_float, p_int, p_int, p_int, p_int]
    lib.frcnn_load_process_batch.restype = None
    lib.frcnn_load_process_batch.argtypes = [
        ctypes.c_char_p, c_int, p_float, c_int, c_int, c_int, c_int, c_int,
        p_int, p_float, p_int, p_int, c_int]
    lib.frcnn_resample.restype = None
    lib.frcnn_resample.argtypes = [p_float, c_int, c_int, p_float, c_int,
                                   c_int]
    lib.frcnn_pack_s2d_batch.restype = None
    lib.frcnn_pack_s2d_batch.argtypes = [p_float, c_int, c_int, c_int,
                                         p_float, p_float, c_int]


def _load():
    with _State.lock:
        if not _State.tried:
            _State.tried = True
            try:
                path = _lib_path()
                _build(path)
                lib = ctypes.CDLL(path)
                _declare(lib)
                _State.lib = lib
            except (OSError, RuntimeError) as e:
                _State.error = str(e)
        return _State.lib


def available() -> bool:
    """Whether the library built and loaded (builds it at the first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is)."""
    _load()
    return _State.error


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native host pipeline is not available: "
                           f"{_State.error}")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def load_process(path: str, canvas_hw: Tuple[int, int],
                 target_smaller_side: int, max_pixel_size: int,
                 color_space: str = "rgb", hflip: bool = False,
                 vflip: bool = False, jitter=(1.0, 1.0)):
    """Decode, resize (kept at the full target scale, cropped to the
    canvas at its top left), convert, flip and pad one file. Returns
    ``(canvas [H, W, 3] float32, (h, w) kept, (orig_h, orig_w))``, or None
    when the file does not decode. Raises where the library is missing."""
    lib = _require()
    H, W = canvas_hw
    canvas = np.zeros((H, W, 3), np.float32)
    oh, ow, gh, gw = (ctypes.c_int() for _ in range(4))
    rc = lib.frcnn_load_process(
        os.fsencode(path), _fptr(canvas), H, W, target_smaller_side,
        max_pixel_size, COLOR_SPACES[color_space], int(hflip), int(vflip),
        float(jitter[0]), float(jitter[1]),
        ctypes.byref(oh), ctypes.byref(ow), ctypes.byref(gh),
        ctypes.byref(gw))
    if rc != 0:
        return None
    return canvas, (oh.value, ow.value), (gh.value, gw.value)


def load_process_batch(paths: Sequence[str], canvas_hw: Tuple[int, int],
                       target_smaller_side: int, max_pixel_size: int,
                       color_space: str = "rgb",
                       flips: Optional[np.ndarray] = None,
                       jitter: Optional[np.ndarray] = None,
                       num_threads: int = 0):
    """:func:`load_process` over ``paths`` on a thread pool. Returns
    ``(canvases [n, H, W, 3], out_hw [n, 4] = (h, w, orig_h, orig_w),
    status [n])``; rows with status != 0 did not decode."""
    lib = _require()
    n = len(paths)
    H, W = canvas_hw
    canvases = np.zeros((n, H, W, 3), np.float32)
    out_hw = np.zeros((n, 4), np.int32)
    status = np.zeros((n,), np.int32)
    flips = np.ascontiguousarray(
        flips if flips is not None else np.zeros((n, 2)), np.int32)
    jitter = np.ascontiguousarray(
        jitter if jitter is not None else np.ones((n, 2)), np.float32)
    if flips.shape != (n, 2) or jitter.shape != (n, 2):
        raise ValueError(f"flips {flips.shape} and jitter {jitter.shape} "
                         f"must be [{n}, 2]")
    blob = b"".join(os.fsencode(p) + b"\0" for p in paths)
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    lib.frcnn_load_process_batch(
        blob, n, _fptr(canvases), H, W, target_smaller_side, max_pixel_size,
        COLOR_SPACES[color_space], _iptr(flips), _fptr(jitter),
        _iptr(out_hw), _iptr(status), num_threads)
    return canvases, out_hw, status


def resample(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """The library's triangle resampler on [sh, sw, 3] float32."""
    lib = _require()
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"resample takes [h, w, 3], not {src.shape}")
    sh, sw = src.shape[:2]
    dst = np.zeros((dh, dw, 3), np.float32)
    lib.frcnn_resample(_fptr(src), sh, sw, _fptr(dst), dh, dw)
    return dst


def pack_s2d_batch(images: np.ndarray, num_threads: int = 0):
    """Space-to-depth pack of [B, H, W, 3] float32 NHWC into the serving
    layout (lum4 [B, 4, Hc, Wc], chroma [B, Hc, 8, Wc]; the layout of
    ``ops/block0_kernel.py::pack_s2d_np``)."""
    lib = _require()
    images = np.ascontiguousarray(images, np.float32)
    B, H, W, C = images.shape
    if H % 2 or W % 2 or C != 3:
        raise ValueError(f"pack_s2d_batch takes even H, W and 3 channels, "
                         f"not {images.shape}")
    Hc, Wc = H // 2 + 1, W // 2 + 1
    lum4 = np.empty((B, 4, Hc, Wc), np.float32)
    chroma = np.empty((B, Hc, 8, Wc), np.float32)
    if num_threads <= 0:
        num_threads = min(B, os.cpu_count() or 1)
    lib.frcnn_pack_s2d_batch(_fptr(images), B, H, W, _fptr(lum4),
                             _fptr(chroma), num_threads)
    return lum4, chroma
