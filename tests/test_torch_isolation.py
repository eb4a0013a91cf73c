"""The port stands alone: no module of frcnn_tpu_torch and not chip_smoke.py
imports jax, flax, msgpack, PIL or the JAX package, and each kernel
wrapper carries a launch counter and names the TPU kernel it replaces."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "PIL", "frcnn_tpu")
WRAPPERS = ("frcnn_tpu_torch.ops.nms_kernel",
            "frcnn_tpu_torch.ops.roi_pool_kernel",
            "frcnn_tpu_torch.ops.block0_kernel",
            "frcnn_tpu_torch.ops.block0_2conv_kernel",
            "frcnn_tpu_torch.ops.pool_bwd_kernel",
            "frcnn_tpu_torch.ops.matmul_kernel")


def _port_files():
    return sorted((ROOT / "frcnn_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant):
                    yield a.value


def test_no_forbidden_imports_in_the_port():
    files = _port_files()
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_the_jax_side_blocked():
    block = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    code = (f"import sys; {block}; "
            "import frcnn_tpu_torch.detect.detector, chip_smoke, "
            "frcnn_tpu_torch.utils.serialization, "
            "frcnn_tpu_torch.utils.weights, "
            "frcnn_tpu_torch.models.quant, frcnn_tpu_torch.ops.int8_conv, "
            "frcnn_tpu_torch.train.trainer, "
            "frcnn_tpu_torch.data.pipeline, frcnn_tpu_torch.data.importers, "
            "frcnn_tpu_torch.detect.evaluation, "
            "frcnn_tpu_torch.utils.drawing, "
            "frcnn_tpu_torch.ops.matmul_kernel, "
            "frcnn_tpu_torch.tools.probe_int8_dot, "
            "frcnn_tpu_torch.tools.bench_block0, "
            "frcnn_tpu_torch.tools.bench_pool_bwd, "
            "frcnn_tpu_torch.tools.bench_scan, "
            "frcnn_tpu_torch.tools.train_synthetic_eval; print('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("module", WRAPPERS)
def test_wrapper_counter_and_source_note(module):
    """Every kernel of the wrapper module (the ROI pool's has two)."""
    from frcnn_tpu_torch.ops.cuda_lib import REGISTRY, CudaKernel

    mod = importlib.import_module(module)
    kernels = [v for v in vars(mod).values() if isinstance(v, CudaKernel)]
    assert mod.KERNEL in kernels
    for k in kernels:
        assert REGISTRY[k.name] is k
        assert isinstance(k.launches, int)
        src = (ROOT / k.source).read_text()
        assert '#include <torch' not in src and "ATen" not in src
        assert f"void {k.entry}(" in src or f"{k.entry}(const" in src
        tpu_file, line = k.replaces.split(" ")[0].split(":")
        assert f"Replaces: {tpu_file}::" in src.replace("\n//", "")
        tpu_src = (ROOT / tpu_file).read_text().splitlines()
        assert tpu_src[int(line) - 1].startswith(
            ("def _kernel", "def _bwd_kernel", "def _mm_kernel")), k.replaces
        assert "pl.pallas_call(" in "\n".join(tpu_src)
