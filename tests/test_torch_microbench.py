"""The three micro-benchmarks (``frcnn_tpu_torch/tools/bench_block0.py``,
``bench_pool_bwd.py``, ``bench_scan.py``) against the JAX scripts.

- The ported scans (``hillis_cummax``, ``hillis_cumsum_i32``,
  ``matmul_cumsum_flat``, the odd/even ``associative_scan``) equal the
  JAX script's functions (and ``jax.lax.associative_scan``) and
  ``torch.cummax`` / ``torch.cumsum``, bitwise, on seeded inputs; the seven
  timed cases agree with each other.
- The s2d phase weights equal the JAX script's numpy loop, run as its
  source reads; the s2d formulation equals the direct conv + PReLU + pool
  in float32 (1e-5) and within bf16 rounding in bf16.
- ``bench_pool_bwd.SHAPES`` equals the JAX ``SHAPES``.
- Each tool runs end to end on the CPU at a tiny size, and each needs a
  card by default.
"""

import importlib
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu_torch.tools import bench_block0, bench_pool_bwd, bench_scan

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from scripts import bench_scan as j_scan  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 301])
def test_associative_scan_matches_jax(n):
    x = np.random.default_rng(n).normal(size=(2, 3, n)).astype(np.float32)
    want = np.asarray(jax.lax.associative_scan(jnp.maximum, jnp.asarray(x),
                                               axis=2))
    got = bench_scan.associative_scan(torch.maximum, torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), torch.cummax(torch.from_numpy(x), dim=2).values.numpy())
    # the recursion on another axis and with another operator
    got_sum = bench_scan.associative_scan(torch.add, torch.from_numpy(
        (x > 0).astype(np.int32)), -1)
    np.testing.assert_array_equal(got_sum.numpy(), np.cumsum(x > 0, axis=2))


@pytest.mark.parametrize("n", [1, 7, 300])
def test_hillis_scans_match_jax(n):
    x = np.random.default_rng(n).normal(size=(2, 4, n)).astype(np.float32)
    xi = (x > 0).astype(np.int32)
    got = bench_scan.hillis_cummax(torch.from_numpy(x), dim=2).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_scan.hillis_cummax(jnp.asarray(x), axis=2)))
    np.testing.assert_array_equal(
        got, torch.cummax(torch.from_numpy(x), dim=2).values.numpy())
    got = bench_scan.hillis_cumsum_i32(torch.from_numpy(xi), dim=2).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_scan.hillis_cumsum_i32(jnp.asarray(xi), axis=2)))
    np.testing.assert_array_equal(got, np.cumsum(xi, axis=2))


@pytest.mark.parametrize("n,block", [(5, 2048), (5000, 2048), (333, 16)])
def test_matmul_cumsum_flat_matches_jax(n, block):
    f = (np.random.default_rng(n).random(n) < 0.3).astype(np.float32)
    got = bench_scan.matmul_cumsum_flat(torch.from_numpy(f), block).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_scan.matmul_cumsum_flat(jnp.asarray(f), block)))
    np.testing.assert_array_equal(
        got, torch.cumsum(torch.from_numpy(f), 0).numpy())
    # the batch axis the JAX script's vmap adds
    fb = torch.from_numpy(np.stack([f, f[::-1].copy()]))
    np.testing.assert_array_equal(
        bench_scan.matmul_cumsum_flat(fb, block).numpy(),
        torch.cumsum(fb, -1).numpy())


def test_scan_cases_agree():
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.normal(size=(2, 32, 500)).astype(np.float32))
    flat = torch.from_numpy(
        (rng.random((2, 32 * 500)) < 0.01).astype(np.float32))
    r = {k: float(fn(rows, flat)) for k, fn in bench_scan.cases().items()}
    assert len(r) == 7
    assert r["rowmax assoc"] == r["rowmax torch.cummax"] == r["rowmax hillis"]
    assert r["rowsum torch.cumsum(i32)"] == r["rowsum hillis(i32)"] > 0
    assert r["flatsum torch.cumsum"] == r["flatsum matmul"] > 0


def _jax_w2_loop(w):
    """``scripts/bench_block0.py``'s W2 loop (:143-153), run as written."""
    src = (ROOT / "scripts" / "bench_block0.py").read_text().splitlines()
    first = next(i for i, ln in enumerate(src)
                 if ln.strip().startswith("W2 = np.zeros((2, 2, 12"))
    last = next(i for i in range(first, len(src))
                if src[i].strip().startswith("W2j ="))
    scope = {"np": np, "w": w}
    exec(textwrap.dedent("\n".join(src[first:last])), scope)
    return scope["W2"]


def test_s2d_weights_match_jax_loop():
    w = np.random.default_rng(1).normal(0, 0.1, (3, 3, 3, 64)).astype(
        np.float32)
    np.testing.assert_array_equal(bench_block0.s2d_weights(w),
                                  _jax_w2_loop(w))


def test_s2d_formulation_matches_direct_conv():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (2, 12, 18, 3)).astype(np.float32))
    wn = rng.normal(0, 0.1, (3, 3, 3, 64)).astype(np.float32)
    b = torch.from_numpy(rng.normal(0, 0.1, (64,)).astype(np.float32))
    w = torch.from_numpy(wn).permute(3, 2, 0, 1)
    slope = torch.tensor([0.25])
    ref = bench_block0.block0_reference(x, w, b, slope)
    w2 = torch.from_numpy(bench_block0.s2d_weights(wn)).permute(3, 2, 0, 1)
    got = bench_block0.s2d_block0(bench_block0.space_to_depth(x), w2,
                                  b.repeat(4), slope)
    assert got.shape == ref.shape == (2, 6, 9, 64)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    got16 = bench_block0.s2d_block0(
        bench_block0.space_to_depth(x.bfloat16()), w2.bfloat16(),
        b.repeat(4), slope).float()
    # bf16 inputs and weights (8 bits), one rounding of the sum to bf16
    torch.testing.assert_close(got16, ref, rtol=2 ** -6,
                               atol=2 ** -6 * float(ref.abs().max()))


def test_pool_bwd_shapes_match_jax(monkeypatch):
    # the JAX script reads its argv when imported
    monkeypatch.setattr(sys, "argv", ["bench_pool_bwd.py"])
    j_pool = importlib.import_module("scripts.bench_pool_bwd")
    assert bench_pool_bwd.SHAPES == j_pool.SHAPES
    assert bench_pool_bwd.shapes(8) == j_pool.SHAPES


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_bench_block0_runs_on_the_cpu(capsys):
    assert bench_block0.main(["2", "3", *bench_block0.VARIANTS, "--device",
                              "cpu", "--hw", "16x24"]) == 0
    lines = _lines(capsys)
    labels = [ln.split()[0] for ln in lines if ln.endswith("ms/iter")]
    assert labels == ["int8", "bf16", "pad8", "im2col", "s2d", "s2d:pack",
                      "s2d:conv+max", "s2d:mm+max", "kernel", "kernel[bf16]",
                      "pack+kernel+T"]
    parity = [ln for ln in lines if "parity" in ln]
    assert len(parity) == 3
    # the kernel's plain version in float32: the direct conv's sums
    assert float(parity[1].split("=")[1]) < 1e-4
    assert lines[-1] == "cpu"


def test_bench_block0_normparts_runs_on_the_cpu(capsys):
    assert bench_block0.main(["normparts", "2", "3", "--device", "cpu",
                              "--hw", "16x24"]) == 0
    lines = _lines(capsys)
    assert [ln.split()[0] for ln in lines[:-1]] == [
        "full", "statsonly", "smooth1", "smooth3"]


def test_bench_pool_bwd_runs_on_the_cpu(capsys):
    assert bench_pool_bwd.main(["2", "2", "--device", "cpu", "--scale",
                                "25"]) == 0
    lines = _lines(capsys)
    timed = [ln for ln in lines if ln.endswith(" ms") and ":" in ln
             and not ln.startswith(("#", "TOTAL"))]
    assert len(timed) == 8
    assert [ln.split()[0] for ln in timed] == ["ss", "pallas"] * 4
    assert lines[-2].startswith("TOTAL ss: ") and lines[-1] == "cpu"


def test_bench_scan_runs_on_the_cpu(capsys):
    assert bench_scan.main(["3", "--device", "cpu", "--anchors", "200",
                            "--batch", "2"]) == 0
    lines = _lines(capsys)
    assert [ln.rsplit(None, 4)[0] for ln in lines[:-1]] == list(
        bench_scan.cases())
    assert all(ln.endswith("ms/iter (batch 2)") for ln in lines[:-1])
    assert lines[-1] == "cpu"


def test_tools_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench_block0.main, bench_pool_bwd.main, bench_scan.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main([])
