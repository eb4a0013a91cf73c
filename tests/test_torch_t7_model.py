"""The port's reference model-snapshot bridge (``data/t7_model.py``) against
the JAX package's, on the tiny config: the flat vector of every order
bitwise the JAX package's, files written by either package read by the
other to the same weights bitwise (and byte for byte the same file), the
orders, the errors, and detect on imported weights equal to detect on the
originals (``tests/test_t7_model.py``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from frcnn_tpu.data import t7_model as jt7
from frcnn_tpu.models.factory import init_params
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.data import t7_model as tt7
from frcnn_tpu_torch.data.t7 import save
from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.models.factory import models_from_state_dicts
from frcnn_tpu_torch.utils.weights import from_jax_params
from tests.tiny import tiny_config

ORDERS = ["nngraph", "blocks_first", "interleaved"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers that run side by side would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jc = tiny_config()
    params, stats = init_params(jc, jax.random.PRNGKey(7))
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(np.asarray, stats)
    cfg = Config.from_json(jc.to_json())
    return jc, cfg, params, stats, from_jax_params(params, stats, cfg)


def _state_equal(a, b):
    assert a.keys() == b.keys()
    for net in a:
        assert a[net].keys() == b[net].keys()
        for k in a[net]:
            assert torch.equal(a[net][k], b[net][k]), (net, k)


@pytest.mark.parametrize("order", ORDERS)
def test_flatten_roundtrip_exact_and_bitwise_jax(setup, order):
    jc, cfg, params, _, state = setup
    flat = tt7.flatten_params(state, cfg, order)
    assert flat.shape == (tt7.flat_size(cfg),) == (jt7.flat_size(jc),)
    np.testing.assert_array_equal(flat, jt7.flatten_params(params, jc, order))
    _state_equal(tt7.unflatten_params(flat, cfg, state, order), state)


def test_orders_differ(setup):
    _, cfg, _, _, state = setup
    a = tt7.flatten_params(state, cfg, "blocks_first")
    b = tt7.flatten_params(state, cfg, "nngraph")
    assert a.shape == b.shape and not np.array_equal(a, b)
    np.testing.assert_array_equal(
        b, tt7.flatten_params(state, cfg, "interleaved"))


def _sequence(cfg, order):
    seq = []
    for net, name, _ in tt7._spec_entries(cfg, order):
        if net != "pnet":
            continue
        tag = name.split(".")[0]
        key = "b" + tag[5] if tag.startswith("block") else "a" + tag[6]
        if not seq or seq[-1] != key:
            seq.append(key)
    return seq


def test_nngraph_order_is_output_major(setup):
    jc, cfg, *_ = setup
    assert _sequence(cfg, "nngraph") == ["b0", "b1", "b2", "a0", "b3", "a1",
                                         "a2", "a3"]
    # the same entries, in the same order, as the JAX layout
    for order in ORDERS:
        got = [(net, shape) for net, _, shape in tt7._spec_entries(cfg, order)]
        want = [(net, shape) for net, _, shape in jt7._spec_entries(jc, order)]
        assert got == want


def test_nngraph_differs_from_interleaved_when_declaration_order_flips(setup):
    _, cfg, *_ = setup
    nets = list(cfg.model.anchor_nets)
    nets[0] = dataclasses.replace(nets[0], input=4)
    nets[1] = dataclasses.replace(nets[1], input=3)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                anchor_nets=tuple(nets)))
    ng = [n for net, n, _ in tt7._spec_entries(cfg, "nngraph")
          if net == "pnet"]
    il = [n for net, n, _ in tt7._spec_entries(cfg, "interleaved")
          if net == "pnet"]
    assert ng != il
    first_anchor = next(n for n in ng if n.startswith("anchor"))
    assert first_anchor.startswith("anchor0")
    last_block = max(i for i, n in enumerate(ng) if n.startswith("block"))
    first_anch = min(i for i, n in enumerate(ng) if n.startswith("anchor"))
    assert last_block < first_anch


@pytest.mark.parametrize("order", ORDERS)
def test_files_cross_load_bitwise(setup, tmp_path, order):
    """A .t7 written by the JAX package loads in the port to the same
    weights, and the reverse; the two files are the same bytes."""
    jc, cfg, params, _, state = setup
    jpath, tpath = str(tmp_path / "jax.t7"), str(tmp_path / "port.t7")
    jt7.save_reference_model(jpath, params, jc, order=order,
                             options={"lr": 1e-4}, stats={"i": 3})
    tt7.save_reference_model(tpath, state, cfg, order=order,
                             options={"lr": 1e-4}, stats={"i": 3})
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    loaded, meta = tt7.load_reference_model(jpath, cfg, state, order=order)
    _state_equal(loaded, state)
    back, _ = jt7.load_reference_model(tpath, jc, params, order=order)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert meta["order"] == order


def test_file_roundtrip_and_auto_order(setup, tmp_path):
    jc, cfg, params, _, state = setup
    for order in ("blocks_first", "nngraph"):
        path = str(tmp_path / f"model_{order}.t7")
        tt7.save_reference_model(path, state, cfg, order=order)
        loaded, meta = tt7.load_reference_model(path, cfg, state,
                                                order="auto")
        assert meta["order"] == order, meta["order_diagnosis"]
        _state_equal(loaded, state)
        assert meta["order_diagnosis"][order] == max(
            meta["order_diagnosis"].values())
        _, jmeta = jt7.load_reference_model(path, jc, params, order="auto")
        assert jmeta["order_diagnosis"] == meta["order_diagnosis"]


def test_size_mismatch_raises(setup):
    _, cfg, _, _, state = setup
    flat = tt7.flatten_params(state, cfg)
    with pytest.raises(ValueError, match="wrong config"):
        tt7.unflatten_params(flat[:-10], cfg, state)


def test_not_a_model_snapshot(setup, tmp_path):
    _, cfg, _, _, state = setup
    path = str(tmp_path / "not_model.t7")
    save(path, {"something": 1.0})
    with pytest.raises(ValueError, match="not a reference model"):
        tt7.load_reference_model(path, cfg, state)


def test_detect_outputs_match_on_imported_weights(setup, tmp_path):
    """import(export(weights)) detects exactly what the weights detect."""
    _, cfg, _, _, state = setup
    path = str(tmp_path / "m.t7")
    tt7.save_reference_model(path, state, cfg)
    imported, _ = tt7.load_reference_model(path, cfg, state)
    H, W = cfg.shapes.image_hw
    rng = np.random.default_rng(0)
    imgs = rng.normal(0.3, 0.2, (1, H, W, 3)).astype(np.float32)
    hw = np.asarray([[H, W]], np.int32)
    o1 = Detector(cfg, *models_from_state_dicts(cfg, state),
                  device="cpu").detect(imgs, hw)
    o2 = Detector(cfg, *models_from_state_dicts(cfg, imported),
                  device="cpu").detect(imgs, hw)
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
