"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` exports ``extern "C"`` launchers that take raw device
pointers, sizes and a ``cudaStream_t``, launch on that stream and return
``cudaGetLastError()``; the ``csrc/*.cuh`` headers they share are part of
the build's hash. No source includes a PyTorch header, so plain ``nvcc``
calls build them into one shared library in seconds: one compile per
source, all started together, then one link; it is loaded with
``ctypes``. The build happens at first use, never at import, into
``frcnn_tpu_torch/_build/<hash of sources and flags>/`` (git-ignored): the
link writes a temporary name that is then moved into place, so a
concurrent or interrupted build never leaves a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libfrcnn_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# more nvcc flags, set before the first launch: ("-DFRCNN_PHASE_STAMPS",)
# builds the 2-conv block0 kernel with its phase stamps
# (frcnn_tpu_torch/tools/phase_split.py); a build of its own either way
EXTRA_FLAGS: tuple = ()

NVCC_TIMEOUT_S = 240    # a cold build of the kernels takes ~10-25 s

_lib = None
REGISTRY = {}           # name -> CudaKernel, filled as wrapper modules import


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def headers():
    """The headers the sources include: part of the build's hash."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library unless a library of
    the same sources and flags exists; returns its path."""
    srcs = sources()
    flags = (*NVCC_FLAGS, *EXTRA_FLAGS)
    digest = hashlib.sha256(" ".join(flags).encode())
    for s in srcs + headers():
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    out = out_dir / LIB_NAME
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    compile_flags = [f for f in flags if f != "-shared"]
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", str(o),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, o in zip(srcs, objs)]
    logs, failed, failed_logs = [], [], []
    try:
        for src, p in zip(srcs, procs):
            left = max(1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0))
            logs.append(f"== {src.name}\n" + p.communicate(timeout=left)[0])
            if p.returncode != 0:
                failed.append(f"{src.name} ({p.returncode})")
                failed_logs.append(logs[-1])
        if not failed:
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True, timeout=NVCC_TIMEOUT_S)
            logs.append("== link\n" + link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(f"link ({link.returncode})")
                failed_logs.append(logs[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    (out_dir / "nvcc.log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        # each failed step's own output (its errors come first)
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n"
                           + "".join(x[:4000] for x in failed_logs))
    os.replace(tmp, out)
    print(f"[frcnn_tpu_torch] nvcc built {len(srcs)} sources into "
          f"{out.relative_to(PACKAGE_DIR)} in {seconds:.1f} s", flush=True)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.frcnn_error_string.argtypes = [ctypes.c_int]
        lib.frcnn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class CudaKernel:
    """One exported launcher of the kernel library, with its launch count.

    ``launches`` counts successful launches and nothing else; ``source``
    and ``replaces`` name the CUDA file and the TPU kernel it ports;
    ``entry`` is the ``__global__`` function's name (how ``nvcc -Xptxas -v``
    reports its registers). Every instance is listed in :data:`REGISTRY`.
    """

    def __init__(self, name: str, symbols: dict, argtypes: list,
                 source: str, replaces: str, entry: str):
        if name in REGISTRY:
            raise ValueError(f"kernel {name!r} is registered twice")
        REGISTRY[name] = self
        self.name = name
        self.entry = entry
        self.symbols = symbols          # mode key -> exported symbol
        self.argtypes = argtypes + [ctypes.c_void_p]   # ... stream
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, key, *args) -> None:
        """Launch the symbol of mode ``key`` (the dtype, or a tuple of
        dtypes where a kernel has more than one mode per dtype)."""
        if key not in self.symbols:
            raise TypeError(f"{self.name}: no kernel for {key}")
        fn = getattr(library(), self.symbols[key])
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(*args, stream)
        if rc != 0:
            msg = library().frcnn_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg}")
        self.launches += 1


def check_cuda(name: str, t: torch.Tensor, dtype, shape):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def ptxas_entry(line: str):
    """The registered kernel that an ``nvcc -Xptxas -v`` line about an
    entry function names (its Itanium-mangled identifier, length-prefixed,
    so ``pool_bwd_kernel`` never matches ``roi_pool_bwd_kernel``), or
    None."""
    for k in REGISTRY.values():
        if f"{len(k.entry)}{k.entry}" in line:
            return k
    return None
