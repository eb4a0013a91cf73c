"""``python -m frcnn_tpu_torch train`` over several processes on the CPU
(gloo), as ``main.py train`` spreads a step over every local device.

- The rule: ``parallel/mesh.py::data_parallel_size(8, n)`` is the mesh size
  of the JAX ``Trainer`` built on the 8 virtual CPU devices of
  ``tests/conftest.py``, for ``images_per_step`` 1-8.
- ``--devices 2`` against ``--devices 1`` on the ``tests/test_torch_cli.py``
  workdir (tiny config, 8 noisy synthetic PNGs, ``images_per_step`` 2):
  per-step metrics rtol 1e-5, the counts and the skip flag equal; the
  step-2 snapshot's parameters within 1e-6 where each step's one-process
  gradient is at least 1e-5 (``parallel/dryrun.py::check_against_single``:
  below that a gradient is float32 rounding of a zero, which RMSprop turns
  into a step of up to lr * sqrt(10)); one metrics file and one snapshot,
  of rank 0; the file names and record keys of ``main.py train`` over its
  2-device mesh. ``--chunk 2`` equals ``--chunk 1`` bitwise under two
  ranks, and a two-rank snapshot continues in one process.
- ``torchrun``'s variables set in-process (world size 1, as the card's
  smoke runs it): the rank path equals the plain run bitwise and leaves no
  process group behind; a group the caller joined stays joined.
- ``tools/train_synthetic_eval.py`` over two ranks against one process.
- A rank that raises stops ``launch`` with no rank left running; a missing
  card stops ``train`` before anything runs.
"""

import json
import multiprocessing as mp
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import main as jax_cli
from frcnn_tpu.train.trainer import Trainer as JaxTrainer
from frcnn_tpu_torch import cli
from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.data.pipeline import BatchIterator
from frcnn_tpu_torch.parallel import mesh
from frcnn_tpu_torch.tools import train_synthetic_eval as TSE
from frcnn_tpu_torch.train.trainer import Trainer
from frcnn_tpu_torch.utils.serialization import load_checkpoint
from tests.test_torch_cli import workdir  # noqa: F401  (fixture)
from tests.tiny import tiny_config

NOISE_FLOOR = 1e-5      # check_against_single's
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_process():
    """One intra-op thread here and in every spawned rank: the test
    workers that run side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def _train(tmp, cfg_path, name, *extra, device="cpu"):
    cli.main(["--device", device, "train", "--cfg", cfg_path, "--train",
              str(tmp / "manifest.json"), "--name", name, "--snapshot", "2",
              *extra])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _params(cfg, path):
    tr = Trainer(cfg, device="cpu")
    tr.restore_snapshot(str(path))
    return tr.params


@pytest.fixture(scope="module")
def runs(workdir):  # noqa: F811
    """The two-rank and one-process runs of 3 steps, in the workdir."""
    tmp, cfg_path = workdir
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t = time.perf_counter()
        _train(tmp, cfg_path, "dp", "--steps", str(STEPS), "--devices", "2")
        dp_s = time.perf_counter() - t
        _train(tmp, cfg_path, "one", "--steps", str(STEPS), "--devices", "1")
    finally:
        os.chdir(cwd)
    return tmp, cfg_path, dp_s


@pytest.mark.parametrize("images_per_step", range(1, 9))
def test_the_rule_is_the_jax_trainers(images_per_step):
    import dataclasses

    cfg = tiny_config()
    cfg = cfg.replace(shapes=dataclasses.replace(
        cfg.shapes, images_per_step=images_per_step))
    assert len(jax.devices()) == 8
    assert JaxTrainer(cfg).mesh.devices.size == \
        mesh.data_parallel_size(8, images_per_step)


def test_two_ranks_equal_one_process(runs):
    tmp, cfg_path, _ = runs
    dp, one = (_records(tmp / f"{n}_metrics.jsonl") for n in ("dp", "one"))
    assert [r["step"] for r in dp] == [1, 2, 3]
    for a, b in zip(dp, one):
        for k in ("cls_count", "reg_count", "skipped", "step"):
            assert a[k] == b[k], k
        for k in ("pcls", "preg", "dcls", "dreg", "loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    # rank 0 alone writes: one metrics file, one snapshot, one plot
    assert sorted(p.name for p in tmp.glob("dp_*")) == [
        "dp_000002.ckpt", "dp_metrics.jsonl", "dp_progress.csv",
        "dp_progress.png"]

    # the one-process trajectory replayed, for its gradients
    cfg = Config.from_json(open(cfg_path).read())
    tr = Trainer(cfg, device="cpu")
    it = BatchIterator(cfg, str(tmp / "manifest.json"), seed=cfg.seed)
    held = None
    for _ in range(2):
        _, (bs, _), grads = tr.compute_gradients(it.next_training_batch())
        tr.apply_gradients(grads, bs)
        step_held = {k: g.abs() >= NOISE_FLOOR for k, g in grads.items()}
        held = step_held if held is None else {
            k: held[k] & step_held[k] for k in held}
    want = _params(cfg, tmp / "one_000002.ckpt")
    for k, v in tr.params.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    got = _params(cfg, tmp / "dp_000002.ckpt")
    # most of them: the rest have no gradient to speak of (an anchor or
    # class row no example reaches)
    assert sum(int(h.sum()) for h in held.values()) > 0.5 * sum(
        h.numel() for h in held.values())
    for k, v in got.items():
        torch.testing.assert_close(v[held[k]], want[k][held[k]], rtol=0,
                                   atol=1e-6, msg=k)


def test_files_and_keys_are_main_pys(runs, monkeypatch):
    tmp, cfg_path, _ = runs
    monkeypatch.chdir(tmp)
    jax_cli.main(["--platform", "cpu", "train", "--cfg", cfg_path,
                  "--train", str(tmp / "manifest.json"), "--name", "jx",
                  "--steps", str(STEPS), "--snapshot", "2"])
    names = {n: sorted(p.name[len(n):] for p in tmp.glob(f"{n}_*"))
             for n in ("jx", "dp")}
    assert names["dp"] == names["jx"]
    jx, dp = (_records(tmp / f"{n}_metrics.jsonl") for n in ("jx", "dp"))
    assert len(jx) == len(dp) == STEPS
    assert [sorted(r) for r in dp] == [sorted(r) for r in jx]


def test_the_rule_picks_the_ranks(workdir, monkeypatch):
    """--devices 3 for images_per_step 2 gives 2 ranks; by default every
    visible card (four here, pretended) is offered to the rule; more than
    are visible stops."""
    tmp, cfg_path = workdir
    monkeypatch.chdir(tmp)
    calls = []
    monkeypatch.setattr(mesh, "launch",
                        lambda fn, world, dev, *a: calls.append((world, dev)))
    _train(tmp, cfg_path, "rule", "--steps", "1", "--devices", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    _train(tmp, cfg_path, "rule", "--steps", "1", device="cuda")
    assert calls == [(2, "cpu"), (2, "cuda")]
    with pytest.raises(SystemExit, match="only 4 CUDA"):
        _train(tmp, cfg_path, "rule", "--steps", "1", "--devices", "5",
               device="cuda")
    assert not list(tmp.glob("rule_*"))


def test_chunked_two_ranks_equal_per_step(runs, monkeypatch):
    tmp, cfg_path, _ = runs
    monkeypatch.chdir(tmp)
    _train(tmp, cfg_path, "dpc", "--steps", str(STEPS), "--devices", "2",
           "--chunk", "2")
    a, b = (_records(tmp / f"{n}_metrics.jsonl") for n in ("dpc", "dp"))
    for x, y in zip(a, b, strict=True):
        x.pop("step_time_s"), y.pop("step_time_s")
        assert x == y
    ca, cb = (load_checkpoint(str(tmp / f"{n}_000002.ckpt"))
              for n in ("dpc", "dp"))
    for x, y in zip(jax.tree.leaves(ca["params"]),
                    jax.tree.leaves(cb["params"]), strict=True):
        np.testing.assert_array_equal(x, y)


def test_a_two_rank_snapshot_continues_in_one_process(runs, monkeypatch):
    tmp, cfg_path, _ = runs
    monkeypatch.chdir(tmp)
    _train(tmp, cfg_path, "cont", "--steps", str(STEPS), "--devices", "1",
           "--restore", str(tmp / "dp_000002.ckpt"))
    (rec,) = _records(tmp / "cont_metrics.jsonl")
    assert rec["step"] == 3 and rec["skipped"] == 0.0
    assert all(np.isfinite(rec[k]) for k in ("pcls", "preg", "dcls", "dreg"))


def test_torchrun_variables_take_the_rank_path(runs, monkeypatch):
    """World size 1 through the rank path equals the plain run bitwise
    and destroys the group it joined; a group the caller joined stays."""
    tmp, cfg_path, _ = runs
    monkeypatch.chdir(tmp)
    monkeypatch.setattr(mesh, "launch", None)     # nothing is spawned
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(mesh.free_port())).items():
        monkeypatch.setenv(k, v)
    _train(tmp, cfg_path, "grp", "--steps", "2")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method="env://")
    try:
        _train(tmp, cfg_path, "grp2", "--steps", "2")
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    for name in ("grp", "grp2"):
        want = _records(tmp / "one_metrics.jsonl")[:2]
        got = _records(tmp / f"{name}_metrics.jsonl")
        for x, y in zip(got, want, strict=True):
            x.pop("step_time_s"), y.pop("step_time_s")
            assert x == y
        a, b = (load_checkpoint(str(tmp / f"{n}_000002.ckpt"))
                for n in (name, "one"))
        for x, y in zip(jax.tree.leaves(a["params"]),
                        jax.tree.leaves(b["params"]), strict=True):
            np.testing.assert_array_equal(x, y)


def test_the_tool_trains_over_two_ranks(tmp_path):
    common = ["--scale", "tiny", "--steps", "3", "--images", "12",
              "--device", "cpu", "--chunk", "2", "--eval-count", "2",
              "--demo-count", "1"]
    for n in ("1", "2"):
        assert TSE.main([*common, "--devices", n,
                         "--out", str(tmp_path / n)]) == 0
    one, two = (_records(tmp_path / n / "metrics.jsonl") for n in "12")
    assert [r["step"] for r in two] == [1, 2, 3]
    for a, b in zip(two, one, strict=True):
        assert (a["cls_count"], a["skipped"]) == (b["cls_count"],
                                                  b["skipped"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    for name in ("final.ckpt", "result.json", "demo1.png"):
        assert (tmp_path / "2" / name).exists(), name
    assert json.loads((tmp_path / "2" / "result.json").read_text())[
        "steps"] == 3


def _rank_1_raises():
    """Rank 1 raises; rank 0 waits for it to join the group."""
    if os.environ["RANK"] == "1":
        raise RuntimeError("rank 1 fails")
    mesh.init_from_env("gloo")


def test_a_failing_rank_stops_the_launch():
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 1"):
        mesh.launch(_rank_1_raises, 2, "cpu")
    assert time.perf_counter() - t < 60
    assert mp.active_children() == []


def test_no_card_stops_before_anything_runs(workdir, monkeypatch):
    tmp, cfg_path = workdir
    monkeypatch.chdir(tmp)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(mesh, "launch", None)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _train(tmp, cfg_path, "nocard", "--steps", "1", "--devices", "2",
               device="cuda")
    assert not list(tmp.glob("nocard_*"))
