"""Row 7, the int8 matmul probe's product, against the JAX probe.

``frcnn_tpu_torch/ops/matmul.py::mm_plain`` and the kernel's wrapper
``ops/matmul_kernel.py::mm`` on CPU tensors (where the wrapper runs the
plain version) against ``scripts/probe_int8_dot.py::pallas_mm`` in
interpret mode, on the same numpy inputs:

- s8 x s8 -> s32: bitwise, also where the int32 sums wrap (K = 133,200);
- bf16 x bf16 -> f32 on integer values: bitwise (every partial sum an
  integer below 2^24);
- bf16 on normal values: within 2^-20 * sum_k |a_ik b_kj| (the two sum in
  another order).

``tools/probe_int8_dot.py`` prints its records on the CPU, exits nonzero
when the kernel differs from the plain version, and needs a card by
default.

The wrapper's route by shape (``matmul_kernel.route``: the TMA/``wgmma``
kernel where TMA can read both operands, else ``mma.sync``) and its
layouts: an int8 B may be the K-contiguous view ``w.t()`` of a contiguous
``[N, K]`` (the int8 chain's call), bitwise the contiguous B's product;
other strides raise, on the CPU too.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu_torch.ops import matmul_kernel
from frcnn_tpu_torch.ops.matmul import mm_plain, wrap_int32
from frcnn_tpu_torch.tools import probe_int8_dot as P

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts.probe_int8_dot import pallas_mm  # noqa: E402

SHAPES = [(64, 96, 40), (33, 70, 17), (128, 256, 128)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape, dtype=np.int8)


def _pallas(a, b, acc):
    return np.asarray(pallas_mm(a, b, acc, interpret=True))


def _both(a, b):
    """(plain, wrapper) of torch CPU tensors, as numpy."""
    return mm_plain(a, b).numpy(), matmul_kernel.mm(a, b).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_s8_matches_pallas(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * k * n)
    a, b = _ints(rng, (m, k)), _ints(rng, (k, n))
    want = _pallas(jnp.asarray(a), jnp.asarray(b), jnp.int32)
    for got in _both(torch.from_numpy(a), torch.from_numpy(b)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_integer_values_match_pallas(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a, b = _ints(rng, (m, k)), _ints(rng, (k, n))
    want = _pallas(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                   jnp.float32)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    for got in _both(ta, tb):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_normal_values_within_tolerance(shape):
    m, k, n = shape
    rng = np.random.default_rng(7 * m + k)
    ja = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32), jnp.bfloat16)
    jb = jnp.asarray(rng.normal(size=(k, n)).astype(np.float32), jnp.bfloat16)
    want = _pallas(ja, jb, jnp.float32)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).bfloat16()
    tol = 2.0 ** -20 * (ta.double().abs() @ tb.double().abs()).numpy()
    for got in _both(ta, tb):
        assert (np.abs(got.astype(np.float64) - want) <= tol).all()
        assert np.abs(got - want).max() > 0 or k < 8    # sums do differ


def test_s8_sums_wrap_as_pallas():
    """K = 133,200 > 2^31 / 127^2: int32 sums of 127 x 127 wrap."""
    k = 133_200
    rng = np.random.default_rng(3)
    a = np.full((1, k), 127, np.int8)
    b = _ints(rng, (k, 4))
    b[:, 0], b[:, 1] = 127, -127
    want = _pallas(jnp.asarray(a), jnp.asarray(b), jnp.int32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert (np.abs(exact[0, :2]) >= 2 ** 31).all()
    for got in _both(torch.from_numpy(a), torch.from_numpy(b)):
        np.testing.assert_array_equal(got, want)
    assert (want[0, :2] != exact[0, :2]).all()


def test_wrap_int32():
    v = torch.tensor([0.0, 2.0 ** 31 - 1, 2.0 ** 31, -2.0 ** 31, -2.0 ** 31
                      - 1, 2.0 ** 32 + 5, -7.0], dtype=torch.float64)
    got = wrap_int32(v)
    want = np.array([0, 2 ** 31 - 1, -2 ** 31, -2 ** 31, 2 ** 31 - 1, 5, -7],
                    np.int64).astype(np.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_counts_no_launch_on_cpu_and_checks_operands():
    k = matmul_kernel.KERNEL
    before = k.launches
    a = torch.ones(5, 3, dtype=torch.int8)
    matmul_kernel.mm(a, torch.ones(3, 2, dtype=torch.int8))
    matmul_kernel.mm(a.bfloat16(), torch.ones(3, 2, dtype=torch.bfloat16))
    assert k.launches == before
    with pytest.raises(TypeError):
        matmul_kernel.mm(a, torch.ones(3, 2, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        matmul_kernel.mm(a.float(), torch.ones(3, 2))
    with pytest.raises(ValueError):
        matmul_kernel.mm(a, torch.ones(4, 2, dtype=torch.int8))


@pytest.mark.parametrize("shape", [(64, 96, 40), (33, 70, 17)])
def test_tool_prints_its_records_on_the_cpu(shape, capsys):
    assert P.main([*map(str, shape), "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[0])
    m, k, n = shape
    assert rec == {"probe": "int8_dot", "M": m, "K": k, "N": n,
                   "device": "cpu", "builds": None, "exact": True,
                   "exact_bf16": True, "bf16_max_abs_err": 0.0,
                   **({} if P.int_mm_allowed(m, k, n) else {
                       "int_mm": rec.get("int_mm")})}
    names = [json.loads(ln)["probe"] for ln in lines[1:-1]]
    want = ["cuda_s8s8s32", "cuda_bf16", "torch_s8s8s32", "torch_bf16"]
    if not P.int_mm_allowed(m, k, n):
        want.remove("torch_s8s8s32")
    assert names == want
    for ln in lines[1:-1]:
        r = json.loads(ln)
        assert r["ms"] > 0 and r["tops"] >= 0
    assert lines[-1] == "cpu"


def test_tool_exits_nonzero_when_the_kernel_differs(monkeypatch, capsys):
    """No failure is caught into a record: a wrong s8 product exits 1."""
    monkeypatch.setattr(matmul_kernel, "mm", lambda a, b: mm_plain(a, b) + (
        1 if a.dtype == torch.int8 else 0))
    assert P.main(["33", "70", "17", "2", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[0])["exact"] is False
    assert "s8 mode" in out.err


def test_tool_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        P.main([])


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts ``nbytes`` past a
    64-byte aligned allocation."""
    n = nbytes // t.element_size()
    flat = torch.zeros(t.numel() + n, dtype=t.dtype)
    out = flat[n:].view(t.shape)
    out.copy_(t)
    return out


# (dtype, M, K, N, B K-contiguous, A offset bytes, B offset bytes, route)
ROUTE_CASES = [
    (torch.int8, 1024, 1024, 1024, False, 0, 0, "tma"),
    (torch.int8, 720000 // 1000, 1152, 128, True, 0, 0, "tma"),
    (torch.int8, 33, 70, 17, False, 0, 0, "sync"),        # K off the grain
    (torch.int8, 64, 96, 40, False, 0, 0, "tma"),         # B transposed
    (torch.int8, 64, 96, 40, True, 0, 0, "tma"),
    (torch.int8, 17, 133200, 32, False, 0, 0, "tma"),
    (torch.int8, 64, 96, 40, False, 16, 1, "tma"),        # B copied
    (torch.int8, 64, 96, 40, False, 8, 0, "sync"),        # A misaligned
    (torch.int8, 64, 96, 40, True, 0, 8, "sync"),         # B misaligned
    (torch.int8, 4, 0, 8, False, 0, 0, "sync"),           # K = 0
    (torch.bfloat16, 64, 96, 40, False, 0, 0, "tma"),
    (torch.bfloat16, 1024, 1024, 1024, False, 0, 0, "tma"),
    (torch.bfloat16, 64, 96, 36, False, 0, 0, "sync"),    # 72-byte B rows
    (torch.bfloat16, 64, 100, 40, False, 0, 0, "sync"),   # 200-byte A rows
    (torch.bfloat16, 64, 96, 40, False, 0, 2, "sync"),    # B misaligned
]


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "-".join(map(str, c[1:])))
def test_route_by_shape_and_alignment(case):
    dtype, m, k, n, kmajor, off_a, off_b, want = case
    a = _offset(torch.zeros(m, k, dtype=dtype), off_a)
    if kmajor:
        b = _offset(torch.zeros(n, k, dtype=dtype), off_b).t()
    else:
        b = _offset(torch.zeros(k, n, dtype=dtype), off_b)
    assert a.data_ptr() % 64 == off_a % 64
    assert matmul_kernel.b_kmajor(a, b) == (kmajor and k > 0 and n > 1)
    assert matmul_kernel.route(a, b) == want
    if want == "sync":
        with pytest.raises(ValueError, match="TMA route"):
            matmul_kernel.mm(a, b, via="tma")


@pytest.mark.parametrize("shape", [(64, 96, 40), (33, 144, 17), (130, 256, 24)])
def test_s8_k_contiguous_b_matches_pallas(shape):
    """B as the K-contiguous view w.t() of a contiguous [N, K] (the int8
    chain's torch._int_mm(cols, wmat.t())): the wrapper's product, bitwise
    the Pallas kernel's on the contiguous B, on both routes."""
    m, k, n = shape
    rng = np.random.default_rng(11 * m + n)
    a, w = _ints(rng, (m, k)), _ints(rng, (n, k))
    b = np.ascontiguousarray(w.T)
    want = _pallas(jnp.asarray(a), jnp.asarray(b), jnp.int32)
    view = torch.from_numpy(w).t()
    assert not view.is_contiguous() and view.stride() == (1, k)
    assert matmul_kernel.b_kmajor(torch.from_numpy(a), view)
    for via in (None, "tma", "sync"):
        got = matmul_kernel.mm(torch.from_numpy(a), view, via=via)
        np.testing.assert_array_equal(got.numpy(), want)


def _strided_views():
    k, n = 32, 16
    big = torch.arange(4 * k * k).to(torch.int8).view(2 * k, 2 * k)
    yield "every other column", torch.int8, big[:k, :2 * n:2]
    yield "every other row", torch.int8, big[:2 * k:2, :n]
    yield "K-contiguous, padded rows", torch.int8, big[:n, :k].t()
    yield "bf16 K-contiguous", torch.bfloat16, big[:n, :k].t().bfloat16()
    yield "bf16 every other column", torch.bfloat16, big.bfloat16()[
        :k, :2 * n:2]


@pytest.mark.parametrize("name,dtype,b", list(_strided_views()),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_other_b_strides_raise(name, dtype, b):
    if name == "bf16 K-contiguous":
        b = b.contiguous().t().contiguous().t()
        assert b.stride() == (1, b.shape[0]) and b.shape == (32, 16)
    a = torch.ones(8, 32, dtype=dtype)
    assert not b.is_contiguous()
    with pytest.raises(ValueError, match="strides"):
        matmul_kernel.route(a, b)
    with pytest.raises(ValueError, match="strides"):
        matmul_kernel.mm(a, b)


def test_via_names_a_route():
    a = torch.ones(5, 16, dtype=torch.int8)
    b = torch.ones(16, 3, dtype=torch.int8)
    for via in (None, "tma", "sync"):
        assert matmul_kernel.mm(a, b, via=via).sum() == 5 * 3 * 16
    with pytest.raises(ValueError, match="not one of"):
        matmul_kernel.mm(a, b, via="cublas")


@pytest.mark.parametrize("kmajor", [False, True])
def test_s8_sums_wrap_as_pallas_on_the_tma_route(kmajor):
    """(17, 133200, 32): K x 127^2 >= 2^31 from K = 133,144 and N = 32 on
    the 16-byte grain, so the TMA route takes it (B transposed, or read as
    a K-contiguous view)."""
    m, k, n = 17, 133_200, 32
    rng = np.random.default_rng(5)
    a = _ints(rng, (m, k))
    a[0] = 127
    b = _ints(rng, (k, n))
    b[:, 0], b[:, 1] = 127, -127
    want = _pallas(jnp.asarray(a), jnp.asarray(b), jnp.int32)
    exact = a[:1].astype(np.float64) @ b.astype(np.float64)
    assert (np.abs(exact[0, :2]) >= 2 ** 31).all()
    assert (want[0, :2] != exact[0, :2]).all()
    tb = torch.from_numpy(b)
    if kmajor:
        tb = tb.t().contiguous().t()
    ta = torch.from_numpy(a)
    assert matmul_kernel.route(ta, tb) == "tma"
    np.testing.assert_array_equal(matmul_kernel.mm(ta, tb).numpy(), want)


def test_neither_route_counts_a_launch_on_cpu():
    before = (matmul_kernel.KERNEL.launches,
              matmul_kernel.SYNC_KERNEL.launches)
    for via in ("tma", "sync"):
        matmul_kernel.mm(torch.ones(4, 16, dtype=torch.int8),
                         torch.ones(16, 8, dtype=torch.int8), via=via)
    assert before == (matmul_kernel.KERNEL.launches,
                      matmul_kernel.SYNC_KERNEL.launches)
    assert matmul_kernel.KERNEL.entry == "mm_tma_kernel"
    assert matmul_kernel.SYNC_KERNEL.entry == "mm_kernel"


@pytest.mark.parametrize("shape,route", [((64, 96, 40), "tma"),
                                         ((33, 70, 17), "sync")])
def test_tool_names_the_route_and_leaves_device_time_to_the_card(
        shape, route, capsys):
    assert P.main([*map(str, shape), "2", "--device", "cpu"]) == 0
    recs = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()[1:-1]]
    for r in recs:
        assert r["device_ms"] is None and r["device_tops"] is None
        assert ("route" in r) == r["probe"].startswith("cuda_")
    assert {r["route"] for r in recs if "route" in r} == {route}
