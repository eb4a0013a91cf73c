"""The port's training slice against the JAX package on the tiny config:
losses, the objective and its gradients, optimizers and schedules, the
trainer's step, skip and chunking, and checkpoints in both directions.

Tolerances:
* losses (``smooth_l1``, ``cross_entropy_fg_bg``, ``nll_loss``): rtol 1e-6;
* the objective with dropout rates zeroed and the JAX package's labels
  injected: total and metrics rtol 1e-5, the new batch-norm statistics
  rtol 1e-5, every gradient (mapped through ``utils/weights.py``) within
  atol 1e-6 + rtol 1e-4 of the largest magnitude of its tensor; for each
  ROI-pool route (plain, kernel wrapper) and pool backward ("library",
  "kernel"). The rtol is taken per tensor, not per element, because the
  linear layers' gradients are float32 sums over the batch's ROI rows with
  heavy cancellation: in one element of fc0's, the terms' magnitudes add
  to 0.46 for a result of -0.0032, and the JAX package's float32 sum lies
  1.6e-6 from the float64 sum of the same terms (the port's 7e-9), over a
  per-element rtol 1e-4 / atol 1e-6;
* optimizers (rmsprop, sgd, nag) under both schedules, across the halving
  at step 5000, against optax: rtol 1e-6;
* ``run_chunk(K)`` against K ``run_step`` calls: bitwise;
* checkpoints written by either package: bitwise after the restore.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frcnn_tpu.geometry.anchors import AnchorGenerator as JGen
from frcnn_tpu.models.factory import create_models as j_create
from frcnn_tpu.models.factory import init_params
from frcnn_tpu.parallel.mesh import make_mesh
from frcnn_tpu.train import losses as jL
from frcnn_tpu.train import optim as jO
from frcnn_tpu.train.objective import build_objective as j_build
from frcnn_tpu.train.objective import label_one_image
from frcnn_tpu.train.trainer import Trainer as JTrainer
from frcnn_tpu.utils.serialization import load_checkpoint as j_load
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.geometry.anchors import AnchorGenerator as TGen
from frcnn_tpu_torch.models.factory import create_models
from frcnn_tpu_torch.train import losses as tL
from frcnn_tpu_torch.train import optim as tO
from frcnn_tpu_torch.train.objective import (
    LabeledExamples,
    TrainBatch,
    build_objective,
    value_and_grad,
)
from frcnn_tpu_torch.train.trainer import Trainer
from frcnn_tpu_torch.utils import weights
from tests.test_objective import make_batch
from tests.tiny import tiny_config


@pytest.fixture(autouse=True)
def _no_tf32():
    """Float32 comparisons run in full float32 (no TF32) on any device."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's steps here are tiny: one intra-op thread each keeps the
    test workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_batch(jc, seed):
    return TrainBatch(*[np.array(x) for x in make_batch(
        jc, np.random.default_rng(seed))])


def _port_cfg(jc, **kw):
    return Config.from_json(jc.to_json()).replace(**kw)


# -- losses ---------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    p = rng.normal(0, 2, (50, 4)).astype(np.float32)
    q = rng.normal(0, 2, (50, 4)).astype(np.float32)
    np.testing.assert_allclose(tL.smooth_l1(_t(p), _t(q)).numpy(),
                               np.asarray(jL.smooth_l1(p, q)), rtol=1e-6)
    logits = rng.normal(0, 3, (50, 2)).astype(np.float32)
    fg = rng.uniform(size=50) > 0.5
    for is_fg in (True, False, fg):
        np.testing.assert_allclose(
            tL.cross_entropy_fg_bg(_t(logits), is_fg if isinstance(
                is_fg, bool) else _t(is_fg)).numpy(),
            np.asarray(jL.cross_entropy_fg_bg(logits, is_fg)), rtol=1e-6)
    logp = np.asarray(jax.nn.log_softmax(rng.normal(size=(50, 7))), np.float32)
    tgt = rng.integers(0, 7, 50).astype(np.int32)
    np.testing.assert_allclose(tL.nll_loss(_t(logp), _t(tgt)).numpy(),
                               np.asarray(jL.nll_loss(logp, tgt)), rtol=1e-6)


# -- the objective ----------------------------------------------------------------

def _no_dropout(jc):
    m = jc.model
    return jc.replace(model=dataclasses.replace(
        m, layers=tuple(dataclasses.replace(s, dropout=0.0)
                        for s in m.layers),
        class_layers=tuple(dataclasses.replace(s, dropout=0.0)
                           for s in m.class_layers)))


def _jax_value_and_grad(remat: bool, jc=None, hw=None):
    """One JAX value_and_grad of the objective of ``jc`` (default: the tiny
    config with XLA's ROI pool and SelectAndScatter pool backward) with
    dropout zeroed, in bucket ``hw`` (default: the primary), pnet under
    jax.checkpoint when ``remat``, and the labels it drew."""
    jc = _no_dropout(jc or tiny_config()).replace(remat=remat)
    if hw is not None:
        jc = jc.replace(shapes=dataclasses.replace(jc.shapes, image_hw=hw))
    gen = JGen(jc)
    jp, jcn = j_create(jc)
    params, stats = init_params(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    bn = stats["cnet"]["bn0"]
    stats = {"cnet": {"bn0": {
        "mean": rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32),
        "var": rng.uniform(0.5, 2, bn["var"].shape).astype(np.float32)}}}
    batch = make_batch(jc, np.random.default_rng(1))
    key = jax.random.PRNGKey(5)
    loss_fn = j_build(jc, gen, jp, jcn)
    (total, (new_bs, metrics)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, stats, batch, key)
    # the labels, drawn as loss_fn draws them
    label_keys = jax.random.split(jax.random.split(key, 3)[0],
                                  batch.image.shape[0])
    labels = jax.vmap(lambda r, hw, gb, gm, bg: label_one_image(
        jc, gen, r, hw, gb, gm, bg))(label_keys, batch.true_hw,
                                     batch.gt_boxes, batch.gt_mask,
                                     batch.is_background)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (jc, to_np(params), to_np(stats), batch, float(total),
            to_np(new_bs), to_np(metrics), to_np(grads), to_np(labels))


@pytest.fixture(scope="module")
def jax_objective():
    return _jax_value_and_grad(remat=False)


@pytest.fixture(scope="module")
def jax_remat_objective():
    return _jax_value_and_grad(remat=True)


def _port_inputs(jax_result, cfg, pool_vjp):
    """The port's objective of ``cfg`` (in the JAX run's bucket) and its
    inputs, made from the JAX run's parameters, statistics, batch and
    labels."""
    jc, params, stats, batch, *_, labels = jax_result
    pnet, cnet = create_models(cfg, pool_vjp)
    sd = weights.from_jax_params(params, stats, cfg)
    tparams = {f"{net}.{k}": v for net, m in (("pnet", pnet), ("cnet", cnet))
               for k, v in sd[net].items()
               if k in dict(m.named_parameters())}
    tstats = {f"cnet.{k}": v for k, v in sd["cnet"].items()
              if k.endswith(("running_mean", "running_var"))}
    tlabels = LabeledExamples(*[_t(getattr(labels, f)).to(
        torch.int64 if getattr(labels, f).dtype == np.int32 else torch.bool)
        for f in LabeledExamples._fields])
    gen = TGen(cfg, image_hw=tuple(jc.shapes.image_hw))
    loss_fn = build_objective(cfg, gen, pnet, cnet)
    tbatch = TrainBatch(*[np.asarray(x) for x in batch]).to("cpu")
    return loss_fn, tparams, tstats, tbatch, tlabels


def _assert_matches_jax(jax_result, cfg, pool_vjp):
    (jc, params, stats, batch, total, new_bs, metrics, grads,
     labels) = jax_result
    loss_fn, tparams, tstats, tbatch, tlabels = _port_inputs(
        jax_result, cfg, pool_vjp)
    got, (nbs, m), g = value_and_grad(loss_fn, tparams, tstats, tbatch,
                                      torch.Generator().manual_seed(0),
                                      labels=tlabels)
    np.testing.assert_allclose(float(got), total, rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, err_msg=k)
    assert float(m["reg_count"]) > 0 and float(m["cls_count"]) > 0
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            nbs[f"cnet.bn0.running_{k}"].numpy(),
            new_bs["cnet"]["bn0"][k], rtol=1e-5, atol=1e-7)
    tree = weights.to_jax_tree(g, cfg)
    ref_leaves = jax.tree_util.tree_leaves_with_path(grads)
    got_leaves = jax.tree.leaves(tree)
    assert len(ref_leaves) == len(got_leaves) == len(g)
    for (path, ref), a in zip(ref_leaves, got_leaves):
        np.testing.assert_allclose(
            a, ref, rtol=0, atol=1e-6 + 1e-4 * float(np.abs(ref).max()),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode,pool_vjp", [("off", "library"),
                                           ("on", "kernel"),
                                           ("on", "library"),
                                           ("off", "kernel")])
def test_objective_and_gradients_match_jax(jax_objective, mode, pool_vjp):
    _assert_matches_jax(jax_objective, _port_cfg(jax_objective[0],
                                                 pallas_mode=mode), pool_vjp)


@pytest.mark.parametrize("mode,pool_vjp", [("off", "library"),
                                           ("on", "kernel")])
def test_remat_matches_jax_remat_objective(jax_remat_objective, mode,
                                           pool_vjp):
    """The port's remat objective (torch.utils.checkpoint over pnet)
    against the JAX remat objective (jax.checkpoint), at the tolerances
    above."""
    result = jax_remat_objective
    cfg = _port_cfg(result[0], pallas_mode=mode)
    assert cfg.remat
    _assert_matches_jax(result, cfg, pool_vjp)


def _port_step(cfg, pool_vjp="kernel", bwd_cut=()):
    """The port's objective, its value and gradients on the tiny config
    with dropout ON (masks from the generator), float32, CPU."""
    pnet, cnet = create_models(cfg, pool_vjp)
    tr = Trainer(cfg, device="cpu", seed=4, pool_vjp=pool_vjp)
    loss_fn = build_objective(cfg, TGen(cfg), pnet, cnet, bwd_cut=bwd_cut)
    batch = _np_batch(tiny_config(), 13)
    return value_and_grad(loss_fn, tr.params, tr.batch_stats,
                          batch.to("cpu"), torch.Generator().manual_seed(3))


def test_remat_on_and_off_are_bitwise_equal():
    """Remat replays pnet's dropout masks (drawn before the checkpointed
    region): the same generator gives bitwise the same loss, metrics,
    statistics and gradients, through the kernel pool backward too."""
    cfg = _port_cfg(tiny_config(), pallas_mode="on")
    assert any(s.dropout > 0 for s in cfg.model.layers)
    a = _port_step(cfg)
    b = _port_step(cfg.replace(remat=True))
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert a[2].keys() == b[2].keys()
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k
    assert any(float(g.abs().max()) > 0 for k, g in a[2].items()
               if k.startswith("pnet."))


def test_bwd_cut_keeps_forward_and_zeroes_the_cut_gradients():
    cfg = _port_cfg(tiny_config(), pallas_mode="on")
    full = _port_step(cfg)
    fm = _port_step(cfg, bwd_cut=("fm",))
    both = _port_step(cfg, bwd_cut=("fm", "maps"))
    for cut in (fm, both):
        assert torch.equal(cut[0], full[0])
        for k in full[1][1]:
            assert torch.equal(cut[1][1][k], full[1][1][k]), k
        for k, g in full[2].items():     # cnet's gradients are untouched
            if k.startswith("cnet."):
                assert torch.equal(cut[2][k], g), k
    # "fm": the anchor heads keep their gradients, the backbone loses the
    # ROI-pool path's share
    for k, g in full[2].items():
        if k.startswith("pnet.anchor"):
            assert torch.equal(fm[2][k], g), k
    assert not torch.equal(fm[2]["pnet.block3_conv0.weight"],
                           full[2]["pnet.block3_conv0.weight"])
    # "fm" + "maps": no pnet backward at all
    for k, g in both[2].items():
        if k.startswith("pnet."):
            assert not g.any(), k
    with pytest.raises(ValueError):
        build_objective(cfg, TGen(cfg), *create_models(cfg), bwd_cut=("x",))


# -- optimizers -------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["rmsprop", "sgd", "nag"])
@pytest.mark.parametrize("schedule", ["halve5k", "constant"])
def test_optimizers_match_optax(optimizer, schedule):
    jc = tiny_config().replace(optimizer=optimizer, lr_schedule=schedule,
                               learning_rate=0.05)
    cfg = _port_cfg(jc)
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jtx, ttx = jO.make_optimizer(jc), tO.make_optimizer(cfg)
    jstate = jtx.init(params)
    leaves, tdef = jax.tree.flatten(jstate)
    # start at step 4998 so that three steps cross the halving at 5000
    leaves = [jnp.asarray(4998, x.dtype) if x.dtype == jnp.int32 else x
              for x in leaves]
    jstate = jax.tree.unflatten(tdef, leaves)
    tparams = [_t(p) for p in params]
    tstate = ttx.init(tparams)
    tstate = tstate._replace(**{tstate._fields[
        [isinstance(v, torch.Tensor) for v in tstate].index(True)]:
        torch.tensor(4998, dtype=torch.int32)})
    jparams = list(params)
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        upd, jstate = jtx.update(grads, jstate, jparams)
        jparams = [p + u for p, u in zip(jparams, upd)]
        tupd, tstate = ttx.update([_t(g) for g in grads], tstate, tparams)
        tparams = [p + u for p, u in zip(tparams, tupd)]
        for a, b in zip(tparams, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        got = tO.state_leaves(tstate, lambda v: [x.numpy() for x in v])
        for a, b in zip(got, jax.tree.leaves(jstate)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6)
    sched_j, sched_t = jO.lr_schedule(jc), tO.lr_schedule(cfg)
    for step in (0, 4999, 5000, 12345):
        assert float(sched_t(torch.tensor(step, dtype=torch.int32))) == \
            float(sched_j(jnp.asarray(step, jnp.int32)))


# -- the trainer ------------------------------------------------------------------

def _state(tr):
    return ({k: v.clone() for k, v in tr.params.items()},
            {k: v.clone() for k, v in tr.batch_stats.items()},
            [x.clone() for x in tO.state_leaves(tr.opt_state, list)])


def _assert_same_state(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


def test_trainer_runs_on_cuda_unless_told():
    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    # the pool backward follows the kernel switch unless given
    jc = tiny_config()
    for mode, want in (("on", "kernel"), ("off", "library")):
        tr = Trainer(_port_cfg(jc, pallas_mode=mode), device="cpu")
        assert tr.pnet.pool_vjp == want
    tr = Trainer(_port_cfg(jc, pallas_mode="on"), device="cpu",
                 pool_vjp="library")
    assert tr.pnet.pool_vjp == "library"


def test_run_chunk_equals_run_steps():
    jc = tiny_config()
    cfg = _port_cfg(jc, pallas_mode="on")
    batches = [_np_batch(jc, 10), _np_batch(jc, 11)]
    a = Trainer(cfg, device="cpu", seed=0, pool_vjp="kernel")
    ma = [a.run_step(b) for b in batches]
    c = Trainer(cfg, device="cpu", seed=0, pool_vjp="kernel")
    mc = c.run_chunk(batches)
    _assert_same_state(_state(a), _state(c))
    for x, y in zip(ma, mc):
        assert {k: v for k, v in x.items() if k != "step_time_s"} == \
            {k: v for k, v in y.items() if k != "step_time_s"}
        assert x["skipped"] == 0.0 and np.isfinite(x["loss"])
    assert a.step == c.step == 2 and a.stats.to_dict() == c.stats.to_dict()
    assert any(not torch.equal(v, Trainer(cfg, device="cpu", seed=0)
                               .params[k]) for k, v in a.params.items())


def test_nonfinite_update_is_skipped():
    jc = tiny_config()
    tr = Trainer(_port_cfg(jc), device="cpu", seed=1)
    tr.run_step(_np_batch(jc, 3))          # nonzero optimizer state
    before = _state(tr)
    _, (new_bs, _), grads = tr.compute_gradients(_np_batch(jc, 4))
    grads["cnet.fc0.weight"][0, 0] = torch.inf
    skipped = tr.apply_gradients(grads, new_bs)
    assert float(skipped) == 1.0
    _assert_same_state(before, _state(tr))
    # end to end: a NaN image poisons every gradient; nothing changes
    bad = _np_batch(jc, 5)
    bad.image[0, 3, 3] = np.nan
    m = tr.run_step(bad)
    assert m["skipped"] == 1.0
    _assert_same_state(before, _state(tr))
    assert tr.run_step(_np_batch(jc, 6))["skipped"] == 0.0


def test_bf16_step_keeps_float32_masters():
    jc = tiny_config().replace(compute_dtype="bfloat16")
    tr = Trainer(_port_cfg(jc), device="cpu", seed=2)
    m = tr.run_step(_np_batch(jc, 7))
    assert m["skipped"] == 0.0 and all(np.isfinite(m[k]) for k in m)
    assert all(v.dtype == torch.float32 for v in tr.params.values())
    assert all(v.dtype == torch.float32
               for v in tO.state_leaves(tr.opt_state, list)[1:])


# -- checkpoints ----------------------------------------------------------------

def test_port_snapshot_loads_in_jax(tmp_path):
    jc = tiny_config()
    cfg = _port_cfg(jc)
    tr = Trainer(cfg, device="cpu", seed=3)
    tr.run_step(_np_batch(jc, 8))
    tr.run_step(_np_batch(jc, 9))
    path = str(tmp_path / "port.ckpt")
    tr.save_snapshot(path, options={"name": "port"})
    ck = j_load(path)
    sd = tr.state_dicts()
    params, stats = weights.to_jax_params(sd["pnet"], sd["cnet"], cfg)
    for a, b in zip(jax.tree.leaves(ck["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(ck["batch_stats"]),
                    jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)
    m_tree = weights.to_jax_tree(dict(zip(tr.names, tr.opt_state.m)), cfg)
    want = [np.asarray(tr.opt_state.step)] + jax.tree.leaves(m_tree)
    assert len(ck["opt_state"]) == len(want)
    for a, b in zip(ck["opt_state"], want):
        np.testing.assert_array_equal(a, b)
    assert ck["step"] == 2 and ck["stats"] == tr.stats.to_dict()
    assert ck["options"] == {"name": "port"}
    assert Config.from_json(ck["config_json"]) == cfg
    # and the JAX trainer takes it up
    jtr = JTrainer(jc, mesh=make_mesh(n_devices=1))
    jtr.restore_snapshot(path)
    for a, b in zip(jax.tree.leaves(jtr.params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(jtr.opt_state.step) == 2 and jtr.step == 2
    for a, b in zip(jax.tree.leaves(jtr.opt_state.m), jax.tree.leaves(m_tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jtr.stats.to_dict() == tr.stats.to_dict()


def test_jax_snapshot_restores_in_port(tmp_path):
    jc = tiny_config()
    jtr = JTrainer(jc, mesh=make_mesh(n_devices=1),
                   rng=jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    jtr.opt_state = jO.RmsPropState(
        step=jnp.asarray(7, jnp.int32),
        m=jax.tree.map(lambda x: jnp.asarray(
            rng.uniform(0, 1e-3, x.shape), jnp.float32), jtr.params))
    jtr.batch_stats = jax.tree.map(lambda x: jnp.asarray(
        rng.uniform(0.5, 2, x.shape), jnp.float32), jtr.batch_stats)
    jtr.step = 5
    jtr.stats.pcls = [1.5, 1.25]
    jtr.stats.dreg = [0.5, 0.75]
    path = str(tmp_path / "jax.ckpt")
    jtr.save_snapshot(path)
    cfg = _port_cfg(jc)
    tr = Trainer(cfg, device="cpu", seed=0)
    tr.restore_snapshot(path)
    sd = tr.state_dicts()
    params, stats = weights.to_jax_params(sd["pnet"], sd["cnet"], cfg)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jtr.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(jtr.batch_stats)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(tr.opt_state.step) == 7 and tr.step == 5
    m_tree = weights.to_jax_tree(dict(zip(tr.names, tr.opt_state.m)), cfg)
    for a, b in zip(jax.tree.leaves(m_tree),
                    jax.tree.leaves(jtr.opt_state.m)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tr.stats.to_dict() == jtr.stats.to_dict()
    # the restored trainer steps on
    assert tr.run_step(_np_batch(jc, 12))["skipped"] == 0.0
    assert int(tr.opt_state.step) == 8
