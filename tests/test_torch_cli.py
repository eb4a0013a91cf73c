"""The port's CLI (``python -m frcnn_tpu_torch``) end to end on the
synthetic dataset with ``--device cpu`` (``tests/test_cli.py``):
import-duplo -> train 2 steps (snapshot, plot, metrics) -> demo ->
evaluate; the chunked loop against the per-step loop; the
export/import-t7-model cycle; ``evaluate`` on a checkpoint written by the
JAX package against ``main.py --platform cpu evaluate`` on it; import-t7
and import-imagenet against ``main.py``'s manifests; and the default
``--device cuda`` stopping where there is no card.

Tolerances: the chunked and per-step loops' metrics equal and their
snapshots bitwise; the export/import cycle bitwise; the two CLIs'
evaluate JSON: counts equal, mAP and per-class AP within 1e-6.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import main as jax_cli
from frcnn_tpu.data import t7 as j_t7
from frcnn_tpu.models.factory import init_params
from frcnn_tpu.utils.serialization import save_checkpoint as j_save
from frcnn_tpu_torch import cli
from frcnn_tpu_torch.utils.serialization import load_checkpoint
from tests.test_e2e_synthetic import make_dataset
from tests.test_importers import XML
from tests.test_t7 import _reference_traindata
from tests.test_torch_detect import _mild_fg_params
from tests.tiny import tiny_config


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers that run side by side would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    make_dataset(tmp, n=8)
    # seeded noise on the flat backgrounds (tests/test_torch_evaluation.py)
    rng = np.random.default_rng(7)
    for f in sorted(tmp.glob("img*.png")):
        a = np.asarray(Image.open(f)).astype(np.float64)
        a += rng.normal(0, 8, a.shape)
        Image.fromarray(np.clip(a, 0, 255).astype(np.uint8)).save(f)
    cfg = tiny_config().replace(
        target_smaller_side=128, max_pixel_size=192,
        examples_base_path=str(tmp), snapshot_interval=2, plot_interval=2)
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    return tmp, str(cfg_path)


def _run(*argv):
    cli.main(["--device", "cpu", *argv])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_import_and_train_and_demo(workdir, monkeypatch):
    tmp, cfg_path = workdir
    monkeypatch.chdir(tmp)
    _run("import-duplo", "--csv", str(tmp / "boxes.csv"),
         "--out", str(tmp / "m2.json"), "--name", "synthetic")
    assert os.path.exists(tmp / "m2.json")

    _run("train", "--cfg", cfg_path, "--train", str(tmp / "m2.json"),
         "--name", "cli_test", "--steps", "2")
    assert os.path.exists(tmp / "cli_test_000002.ckpt")
    assert os.path.exists(tmp / "cli_test_progress.png")
    assert os.path.exists(tmp / "cli_test_progress.csv")
    recs = _records(tmp / "cli_test_metrics.jsonl")
    assert len(recs) == 2 and "pcls" in recs[0] and "step_time_s" in recs[0]
    assert load_checkpoint(str(tmp / "cli_test_000002.ckpt"))["step"] == 2

    _run("demo", "--cfg", cfg_path, "--train", str(tmp / "m2.json"),
         "--restore", str(tmp / "cli_test_000002.ckpt"),
         "--out", str(tmp / "demo"), "--count", "2")
    for i in (1, 2):
        with open(tmp / "demo" / f"output{i}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_train_chunked_loop_equals_per_step(workdir, monkeypatch):
    """--chunk 2: snapshots at chunk boundaries named with the true step,
    one metrics record per step, and the trajectory of --chunk 1 (the
    decode threads, ``--threads``, change nothing)."""
    tmp, cfg_path = workdir
    monkeypatch.chdir(tmp)
    for name, chunk, threads in (("cli_chunk", "2", "2"),
                                 ("cli_step", "1", "0")):
        _run("train", "--cfg", cfg_path, "--train", str(tmp / "manifest.json"),
             "--name", name, "--steps", "5", "--chunk", chunk,
             "--threads", threads)
    # interval 2, chunks end at steps 2, 4, 5: snapshots at 2 and 4
    assert os.path.exists(tmp / "cli_chunk_000002.ckpt")
    assert os.path.exists(tmp / "cli_chunk_000004.ckpt")
    assert not os.path.exists(tmp / "cli_chunk_000005.ckpt")
    a = _records(tmp / "cli_chunk_metrics.jsonl")
    b = _records(tmp / "cli_step_metrics.jsonl")
    assert [r["step"] for r in a] == [1, 2, 3, 4, 5]
    for x, y in zip(a, b):
        x.pop("step_time_s"), y.pop("step_time_s")
        assert x == y
    ca = load_checkpoint(str(tmp / "cli_chunk_000004.ckpt"))
    cb = load_checkpoint(str(tmp / "cli_step_000004.ckpt"))
    for x, y in zip(jax.tree.leaves(ca["params"]),
                    jax.tree.leaves(cb["params"])):
        np.testing.assert_array_equal(x, y)


def test_t7_model_export_import_cycle(workdir, monkeypatch):
    tmp, cfg_path = workdir
    monkeypatch.chdir(tmp)
    src = str(tmp / "cli_test_000002.ckpt")
    assert os.path.exists(src)
    _run("export-t7-model", "--cfg", cfg_path, "--restore", src,
         "--out", str(tmp / "exported.t7"))
    _run("import-t7-model", "--cfg", cfg_path, "--t7",
         str(tmp / "exported.t7"), "--out", str(tmp / "imported.ckpt"))
    a = load_checkpoint(src)
    b = load_checkpoint(str(tmp / "imported.ckpt"))
    for x, y in zip(jax.tree.leaves(a["params"]),
                    jax.tree.leaves(b["params"])):
        np.testing.assert_array_equal(x, y)
    assert b["options"]["order"] == "nngraph"


def test_evaluate_runs(workdir, monkeypatch, capsys):
    tmp, cfg_path = workdir
    monkeypatch.chdir(tmp)
    capsys.readouterr()
    _run("evaluate", "--cfg", cfg_path, "--train", str(tmp / "manifest.json"),
         "--count", "2")
    result = json.loads(capsys.readouterr().out)
    assert "mAP" in result and result["num_images"] == 2


def test_evaluate_on_a_jax_checkpoint_matches_main(workdir, monkeypatch,
                                                   capsys):
    tmp, cfg_path = workdir
    monkeypatch.chdir(tmp)
    params, stats = init_params(tiny_config(), jax.random.PRNGKey(0))
    ckpt = str(tmp / "jax.ckpt")
    j_save(ckpt, params=_mild_fg_params(params), batch_stats=stats, step=0)
    argv = ["evaluate", "--cfg", cfg_path, "--train",
            str(tmp / "manifest.json"), "--restore", ckpt, "--count", "4"]
    capsys.readouterr()
    jax_cli.main(["--platform", "cpu", *argv])
    want = json.loads(capsys.readouterr().out)
    _run(*argv)
    got = json.loads(capsys.readouterr().out)
    assert want["num_images"] == 4 and want["num_detections"] > 0
    assert got.keys() == want.keys()
    for k in ("num_images", "num_gt", "num_detections"):
        assert got[k] == want[k], k
    assert abs(got["mAP"] - want["mAP"]) <= 1e-6
    assert got["per_class"].keys() == want["per_class"].keys()
    for c, ap in want["per_class"].items():
        assert abs(got["per_class"][c] - ap) <= 1e-6, c


def test_import_t7_and_imagenet_match_main(tmp_path):
    """The two importers of the reference's formats write the manifests
    ``main.py`` writes."""
    j_t7.save(str(tmp_path / "duplo.t7"), _reference_traindata())
    anno = tmp_path / "det/Annotations/DET/train/sub"
    anno.mkdir(parents=True)
    (anno / "a1.xml").write_text(XML)
    (tmp_path / "det/Annotations/DET/val").mkdir(parents=True)
    bg = tmp_path / "det/Data/DET/train/ILSVRC2013_train_extra0"
    bg.mkdir(parents=True)
    (bg / "b.JPEG").write_bytes(b"x")
    for argv in (["import-t7", "--t7", str(tmp_path / "duplo.t7")],
                 ["import-imagenet", "--base-dir", str(tmp_path / "det")]):
        _run(*argv, "--out", str(tmp_path / "port.json"))
        jax_cli.main(["--platform", "cpu", *argv, "--out",
                      str(tmp_path / "jax.json")])
        got, want = (json.loads((tmp_path / f"{w}.json").read_text())
                     for w in ("port", "jax"))
        assert got == want and want["ground_truth"], argv[0]


def test_default_device_is_cuda_and_never_falls_back(workdir, monkeypatch):
    tmp, cfg_path = workdir
    monkeypatch.chdir(tmp)
    assert cli.parser().parse_args(["import-t7", "--t7", "x", "--out",
                                    "y"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cmd in ("train", "evaluate", "demo"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main([cmd, "--cfg", cfg_path, "--train",
                      str(tmp / "manifest.json")])
