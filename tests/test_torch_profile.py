"""The port's stage profilers (``frcnn_tpu_torch/tools/profile_detect.py``,
``profile_train.py``) on the CPU at a 128x160 bucket, B=2.

- Every stage body of both profilers runs (the detect stages in the
  ``pallas+s2d`` mode, ``fwdparts`` in ``int8s+pallas+s2d+s8p``), and the
  command lines print one line per stage.
- ``full`` (the profiled program) equals a ``Detector``'s detections on
  the same frames, field for field (the same operations).
- ``bwdparts``: each cut's gradients equal the objective's ``bwd_cut``
  gradients on the same draws; the cut of the anchor maps and the feature
  map leaves no pnet gradient, the feature map's cut alone leaves one.
"""

import pytest
import torch

from frcnn_tpu_torch.detect.detector import Detector
from frcnn_tpu_torch.tools import profile_detect as PD
from frcnn_tpu_torch.tools import profile_train as PT
from frcnn_tpu_torch.train.objective import build_objective, value_and_grad

HW = (128, 160)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def detect_setup():
    return PD.setup(2, "pallas+s2d", HW, "cpu")


def test_every_detect_stage_runs(detect_setup):
    stages = [s for s in PD.STAGES if s != "fwdparts"]
    labels = []
    with torch.no_grad():
        for label, body in PD.stage_bodies(detect_setup, stages):
            assert body() is not None, label
            labels.append(label)
    assert {"normalize", "normalize[s2d]", "block0[s2d]", "frontend[s2d]",
            "pnet_fwd", "fwd+decode+topk", "nms(K->D)[pallas]",
            "roi_pool(128)[pallas]", "pool(128)[bf16]+reshape", "cnet",
            "cum[b0]", "cum[FULL]", "FULL"} <= set(labels)


def test_fwdparts_needs_int8_and_runs_on_it():
    with pytest.raises(SystemExit, match="int8"):
        PD.stage_bodies(PD.setup(2, "bf16", HW, "cpu"), ["fwdparts"])
    S = PD.setup(2, "int8s+pallas+s2d+s8p", HW, "cpu")
    with torch.no_grad():
        bodies = PD.stage_bodies(S, ["fwdparts"])
        assert [label for label, _ in bodies][-1] == "blocks+heads[0:4]"
        for label, body in bodies:
            assert torch.isfinite(body()), label


def test_full_equals_the_detector(detect_setup):
    S = detect_setup
    got = dict(PD.stage_bodies(S, ["full"]))["FULL"]()
    cfg = S.cfg.replace(input_layout="s2d")
    want = Detector(cfg, S.pnet_f32, S.cnet_f32, device="cpu").detect(
        S.images, S.true_hw)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_profile_detect_command_line(capsys):
    assert PD.main(["2", "1", "norm", "select", "mode=pallas",
                    "--hw", "128x160", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mode=pallas" in out and "ms/iter" in out
    assert "select:top_k" in out and "select:compact" in out


@pytest.fixture(scope="module")
def train_setup():
    return PT.setup(2, HW, pallas=True, device="cpu")


def test_every_train_stage_runs(train_setup):
    labels = [label for label, body in
              PT.stage_bodies(train_setup, PT.STAGES)
              if body() is not None]
    assert labels == ["norm", "norm+pnet", "label", "norm+pnet+label+pool",
                      "iou[GxA]", "pos(match+select)", "neg(sample)",
                      "near(pos+nearby)", "grad[sg fm+maps]", "grad[sg fm]",
                      "grad[full]", "objective fwd", "fwd+bwd",
                      "train step"]
    assert train_setup.trainer.step == 0   # the bodies do not record


def test_bwdparts_are_the_objective_cuts(train_setup):
    S = train_setup
    tr = S.trainer
    gen = PT._generator_of(S.cfg, S.cfg.shapes.image_hw)
    bodies = dict(PT.stage_bodies(S, ["bwdparts"]))
    pnet_grads = {}
    for label, cut in PT.BWD_CUTS:
        tr.generator.manual_seed(11)
        _, _, got = bodies[f"grad[{label}]"]()
        tr.generator.manual_seed(11)
        _, _, want = value_and_grad(
            build_objective(S.cfg, gen, tr.pnet, tr.cnet, bwd_cut=cut),
            tr.params, tr.batch_stats, S.batch, tr.generator)
        for k in want:
            assert torch.equal(got[k], want[k]), (label, k)
        pnet_grads[label] = sum(float(g.abs().sum()) for k, g in got.items()
                                if k.startswith("pnet."))
    assert pnet_grads["sg fm+maps"] == 0
    assert pnet_grads["sg fm"] > 0 and pnet_grads["full"] > 0


def test_profile_train_command_line(capsys):
    assert PT.main(["2", "1", "loss", "--hw", "128x160", "--device",
                    "cpu"]) == 0
    assert "objective fwd (2 img):" in capsys.readouterr().out


def test_profilers_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (PD.main, PT.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["2", "1"])
