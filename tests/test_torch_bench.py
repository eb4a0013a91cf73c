"""The port's bench (``frcnn_tpu_torch/bench.py``) against ``bench.py``.

- ``bench_config`` serialized to JSON equals the JAX one's for every mode
  string (the modes of ``tests/test_bench_modes.py`` and the bare ones);
  ``metric_name`` equal string for string.
- The timed program (``bench_program``) on the tiny config with the JAX
  weights carried across (``from_jax_params``) and the stress biases on
  both sides, against the JAX ``build_detect_fn`` of ``bench.py``'s
  ``run_bench`` on the same batch. Float modes at the tolerances of
  ``tests/test_torch_detect.py``: ``valid``, ``classes`` and
  ``proposals_valid`` equal, boxes atol 1e-3, confidence and fg_score atol
  1e-5. ``int8s``: the calibrated scales within 1e-6 relative, then the
  detections at the int8 detect tolerances of ``tests/test_torch_quant.py``
  (the same as above), with the JAX scales carried across and the JAX
  program's normalized batch handed to the port's pnet: a float32
  rounding difference in the normalization moves an int8 step of the
  first convolution's input, which every later requantization carries
  (``tests/test_torch_quant.py`` hands block 0's output over for the same
  reason).
- ``best`` measures the head of the JAX chain and nothing else: when it
  raises, the bench prints one error record and exits non-zero; without a
  card the default device stops it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from frcnn_tpu.detect.detector import build_detect_fn as j_build
from frcnn_tpu.geometry.anchors import AnchorGenerator as JGen
from frcnn_tpu.models.factory import create_models as j_create
from frcnn_tpu.models.factory import init_params
from frcnn_tpu_torch import bench
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.detect import detector as tdet
from frcnn_tpu_torch.models.factory import models_from_state_dicts
from frcnn_tpu_torch.utils.weights import from_jax_params
from tests.tiny import tiny_config

MODES = ("bf16", "pallas", "s2d", "s8p", "int8", "int8s",
         "int8s+pallas+s2d", "int8s+pallas+s2d+s8p",
         "large+int8s+pallas+s2d", "imagenet+int8s+pallas+s2d",
         "imagenet+int8s", "large+int8s",
         "large+int8s+pallas+s2d+b0bf16", "large+int8s+pallas+s2d+b0roll")
B = 2


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """One torch thread, full float32 on any device, and the JAX bench's
    interpret switch off."""
    monkeypatch.delenv("FRCNN_BENCH_INTERPRET", raising=False)
    n = torch.get_num_threads()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32


@pytest.mark.parametrize("mode", MODES)
def test_bench_config_matches_jax(mode):
    want = json.loads(jbench.bench_config(mode).to_json())
    assert json.loads(bench.bench_config(mode).to_json()) == want


@pytest.mark.parametrize("mode", MODES)
def test_metric_name_matches_jax(mode):
    assert bench.metric_name(mode) == jbench.metric_name(mode)


def _away_from_background(params):
    """The classifier biased away from background on both sides, so that
    the random head detects something past the 0.2 gate."""
    p = jax.tree.map(lambda x: x, params)
    cls = p["cnet"]["cls_head"]
    b = np.asarray(cls["bias"]).copy()
    b[-1] -= 2.0
    cls["bias"] = jnp.asarray(b)
    return p


def _jax_stress(params):
    """``bench.py:179-187``."""
    p = jax.tree.map(lambda x: x, params)
    for ai in range(4):
        b = np.zeros(18, np.float32)
        b[0::6] = 6.0
        p["pnet"][f"anchor{ai}_out"]["bias"] = jnp.asarray(b)
    return p


def _jax_program(jc, mode, params, stats):
    """``bench.py::run_bench``'s program and inputs on ``jc``; returns
    (detections, the quantized adapter or None)."""
    from frcnn_tpu.models.factory import compute_dtype
    from frcnn_tpu.models.quant import (
        QuantizedPNetAdapter,
        quantize_pnet_params,
    )
    from frcnn_tpu.ops.normalization import normalize_image
    from frcnn_tpu.ops.pallas_block0 import pack_s2d

    gen = JGen(jc)
    pnet, cnet = j_create(jc)
    H, W = jc.shapes.image_hw
    raw = jnp.asarray(np.random.default_rng(0).normal(
        0.3, 0.2, size=(B, H, W, 3)).astype(np.float32))
    hw = jnp.tile(jnp.asarray([[H, W]], jnp.int32), (B, 1))
    images = pack_s2d(raw) if "s2d" in mode else raw
    adapter = norm = None
    if "int8" in mode:
        adapter = QuantizedPNetAdapter(
            jc.model, quantize_pnet_params(params, jc.model),
            act_dtype=compute_dtype(jc), pool_s8="s8p" in mode)
        nc = jc.normalization
        norm = jax.vmap(lambda im, t: normalize_image(
            im, t[0], t[1], method=nc.method, width=nc.width,
            centering=nc.centering, scaling=nc.scaling))(raw, hw)
        adapter.calibrate(norm)
        pnet = adapter
    detect = j_build(jc, gen, pnet, cnet)
    if "int8" not in mode:
        # eager for the int8 chain: under jit XLA contracts its dequantize
        # into one fused multiply-add, which moves int8 steps downstream
        detect = jax.jit(detect)
    return detect(params, stats, images, hw), adapter, norm


def _check(got, ref):
    assert int(np.asarray(ref.proposals_valid).sum()) > 10
    assert int(np.asarray(ref.valid).sum()) > 0
    for f in ("valid", "classes", "proposals_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("boxes", "proposal_boxes", "proposals"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-3, err_msg=f)
    for f in ("confidence", "fg_score"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("mode", ["bf16", "pallas+s2d", "int8s"])
def test_bench_program_matches_jax(mode, monkeypatch):
    jc = tiny_config()
    if "pallas" in mode or "s2d" in mode:
        jc = jc.replace(pallas_mode="interpret")
    if "s2d" in mode:
        jc = jc.replace(input_layout="s2d")
    params, stats = init_params(jc, jax.random.PRNGKey(0))
    params = _away_from_background(params)
    ref, adapter, norm = _jax_program(jc, mode, _jax_stress(params), stats)

    cfg = Config.from_json(jc.to_json())
    models = models_from_state_dicts(cfg, from_jax_params(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats),
        cfg))
    made, real = [], tdet.Detector

    def capture(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(tdet, "Detector", capture)
    fn, args = bench.bench_program(cfg, mode, B, "cpu", models=models)
    if adapter is not None:
        got_scales = made[0].pnet.act_scales
        assert set(got_scales) == set(adapter.act_scales)
        for k, v in adapter.act_scales.items():
            np.testing.assert_allclose(float(got_scales[k]), float(v),
                                       rtol=1e-6, err_msg=k)
        made[0].pnet.set_act_scales(
            {k: float(v) for k, v in adapter.act_scales.items()})
        monkeypatch.setattr(tdet, "normalize_image",
                            lambda *a, **k: torch.from_numpy(
                                np.array(norm)))
    _check(fn(*args), ref)


def test_stress_weights_bias_every_fg_logit():
    from frcnn_tpu_torch.models.factory import init_models

    cfg = Config.from_json(tiny_config().to_json())
    pnet, _ = init_models(cfg, torch.Generator().manual_seed(0))
    for ai in range(4):
        torch.nn.init.normal_(getattr(pnet, f"anchor{ai}_out").bias)
    bench.stress_weights(pnet)
    want = torch.zeros(18)
    want[[0, 6, 12]] = 6.0
    for ai in range(4):
        assert torch.equal(getattr(pnet, f"anchor{ai}_out").bias.detach(),
                           want)


def test_best_measures_its_head_and_does_not_fall_back(monkeypatch, capsys):
    calls = []

    def failing(batch_size, iters, mode, device="cuda"):
        calls.append(mode)
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(bench, "measure", failing)
    rc = bench.main(["8", "8", "best", "--device", "cpu"])
    assert rc != 0
    assert calls == [bench.BEST] == ["int8s+pallas+s2d+s8p"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["value"] == 0 and "kernel launch failed" in rec["error"]
    assert rec["metric"] == jbench.metric_name(bench.BEST)


def test_default_device_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        bench.main(["8", "8", "bf16"])
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["value"] == 0 and "no CUDA device" in rec["error"]


def test_measure_on_cpu_prints_a_record(monkeypatch):
    """``measure``'s record through the real timing loop, on a tiny
    config: images/s, the device and no kernel launch on CPU tensors."""
    jc = tiny_config().replace(pallas_mode="on")
    monkeypatch.setattr(bench, "bench_config",
                        lambda mode: Config.from_json(jc.to_json()))
    rec = bench.measure(B, 4, "pallas", "cpu")
    assert rec["value"] > 0 and rec["unit"] == "images/sec/chip"
    assert rec["device"] == "cpu" and rec["kernels"] == {}
