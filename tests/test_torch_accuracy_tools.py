"""The port's accuracy tools (``frcnn_tpu_torch/tools/``:
``train_synthetic_eval``, ``eval_quant_parity``, ``sweep_conf_gate``,
``recall_attribution``, ``analyze_detections``) against the JAX scripts.

- ``make_dataset`` at the tiny scale (seed 0, 4 images) writes the same
  CSV text as the JAX script's, and its PNGs (``data/codec.py``) decode to
  the pixels of the PNGs PIL writes there.
- Every scale's config (tiny, duplo, photo, imagenet, imagenet_smoke)
  equals the JAX one (JSON).
- ``make_photo_dataset`` (landscape, and mixed orientation as the
  imagenet scales call it), with the JAX function given the port's three
  photographs: the same CSV rows but for the extension (``.png`` for
  ``.jpg``), and the pixels of PIL's decode of the JAX script's JPEG files,
  bitwise (the bound asked for was mean |d| <= 1.5 and p99 <= 12 grey
  levels); the corrupt files skipped by the batch iterator on the numpy
  PNG reader (the card's path). Its
  no-photograph branch runs too (the JAX branch raises on this Pillow: it
  draws on the read-only array of ``np.asarray(image)``).
- PIL's steps in numpy, each bitwise PIL's: ``jpeg_roundtrip`` against
  PIL's save and open at quality 55, 75 and 94, ``gaussian_blur`` against
  ``ImageFilter.GaussianBlur`` (asked: one grey level), ``resize_uint8``
  against Pillow's uint8 bilinear resize.
- The quant-parity mode table selects the JAX table's config fields and
  Detector options, mode by mode.
- On a fixed seeded set of detections, proposals and ground truth: the
  gate re-scoring, the recall-attribution row and the confusion tally
  equal what the JAX scripts compute inline from the JAX package's
  ``detect/evaluation.py``.
- The tools run end to end on the CPU: a short tiny training run, then
  the parity, sweep, attribution and analysis tools on its checkpoint.
"""

import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from frcnn_tpu.detect import evaluation as j_eval
from frcnn_tpu_torch.data.codec import read_rgb
from frcnn_tpu_torch.tools import analyze_detections as AD
from frcnn_tpu_torch.tools import eval_quant_parity as QP
from frcnn_tpu_torch.tools import recall_attribution as RA
from frcnn_tpu_torch.tools import sweep_conf_gate as SG
from frcnn_tpu_torch.tools import train_synthetic_eval as TSE

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts import analyze_detections as j_analyze  # noqa: E402
from scripts import train_synthetic_eval as j_tse  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_dataset_matches_jax(tmp_path):
    img_w, img_h, box_lo, box_hi, n_classes = j_tse.SCALES["tiny"][:5]
    args = (4, img_w, img_h, n_classes, box_lo, box_hi)
    a = j_tse.make_dataset(str(tmp_path / "jax"), *args, seed=0)
    b = TSE.make_dataset(str(tmp_path / "port"), *args, seed=0)
    assert Path(b).read_text() == Path(a).read_text()
    assert len(Path(b).read_text().splitlines()) >= 4
    for i in range(4):
        name = f"img{i:04d}.png"
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        got = read_rgb(str(tmp_path / "port" / name), use_native=False)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / name)), want)
    # a second call finds the completed generation and writes nothing
    mtime = os.path.getmtime(tmp_path / "port" / "img0000.png")
    assert TSE.make_dataset(str(tmp_path / "port"), *args, seed=0) == b
    assert os.path.getmtime(tmp_path / "port" / "img0000.png") == mtime


@pytest.mark.parametrize("scale", ["tiny", "duplo", "photo", "imagenet",
                                   "imagenet_smoke"])
def test_scale_configs_match_jax(scale):
    *_, n, j_fn, _ = j_tse.SCALES[scale]
    *_, n2, t_fn, _ = TSE.scale_spec(scale)
    assert n == n2
    assert json.loads(t_fn(n).to_json()) == json.loads(j_fn(n).to_json())
    assert TSE.scale_spec(scale)[:4] == j_tse.SCALES[scale][:4]


PHOTO_WH = (160, 120)     # scenes cut small: the tolerance is per pixel


def _pil_jpeg(img, quality):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))




@pytest.mark.parametrize("mixed", [False, True], ids=["landscape", "mixed"])
def test_make_photo_dataset_matches_jax(mixed, tmp_path, monkeypatch):
    from frcnn_tpu_torch.data.importers import create_duplo_manifest
    from frcnn_tpu_torch.data.pipeline import BatchIterator

    monkeypatch.setattr(j_tse, "_bundled_photos", TSE._bundled_photos)
    n = 6
    args = (n, *PHOTO_WH, 3, 24, 60)
    a = j_tse.make_photo_dataset(str(tmp_path / "jax"), *args, seed=0,
                                 mixed_orientation=mixed)
    b = TSE.make_photo_dataset(str(tmp_path / "port"), *args, seed=0,
                               mixed_orientation=mixed)
    rows = Path(b).read_text()
    assert rows == Path(a).read_text().replace(".jpg", ".png")
    assert len(rows.splitlines()) >= n
    shapes = set()
    for i in range(n):
        got_path = tmp_path / "port" / f"img{i:04d}.png"
        if i < 2:        # the JAX script's corrupt bytes, under .png names
            assert got_path.read_bytes() == TSE.CORRUPT_BYTES == (
                tmp_path / "jax" / f"img{i:04d}.jpg").read_bytes()
            continue
        with Image.open(tmp_path / "jax" / f"img{i:04d}.jpg") as im:
            want = np.asarray(im.convert("RGB"))
        got = read_rgb(str(got_path), use_native=False)
        assert got.shape == want.shape
        shapes.add(got.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"scene {i}")
    assert len(shapes) == (2 if mixed else 1)
    # every scene of the CSV read back; the corrupt ones skipped
    manifest = create_duplo_manifest("photo", b, None, validation_size=n,
                                     seed=0)
    cfg = TSE.imagenet_smoke_cfg(3).replace(
        examples_base_path=str(tmp_path / "port"))
    names = manifest["validation_set"]
    bad = [x for x in names if x in ("img0000.png", "img0001.png")]
    items = BatchIterator(cfg, manifest, seed=0,
                          use_native=False).next_validation(
        len(names) - len(bad))
    assert len(items) == len(names) - len(bad) and bad


def test_make_photo_dataset_without_photographs(tmp_path, monkeypatch):
    args = (3, *PHOTO_WH, 3, 24, 60)
    b = TSE.make_photo_dataset(str(tmp_path / "b"), *args, seed=1)
    monkeypatch.setattr(TSE, "_bundled_photos", lambda: [])
    a = TSE.make_photo_dataset(str(tmp_path / "a"), *args, seed=1)
    assert Path(a).read_text() != Path(b).read_text()
    img = read_rgb(str(tmp_path / "a" / "img0002.png"), use_native=False)
    assert img.shape == (PHOTO_WH[1], PHOTO_WH[0], 3) and img.std() > 5
    # the same arguments again: found on disk, not rewritten
    mtime = os.path.getmtime(tmp_path / "a" / "img0002.png")
    assert TSE.make_photo_dataset(str(tmp_path / "a"), *args, seed=1) == a
    assert os.path.getmtime(tmp_path / "a" / "img0002.png") == mtime


@pytest.mark.parametrize("quality", [55, 75, 94])
def test_jpeg_roundtrip_matches_pil(quality):
    from frcnn_tpu_torch.data.codec import jpeg_roundtrip

    photos = TSE._bundled_photos()
    # odd sizes: edge blocks, the chroma planes' last odd column and row
    for img in (*photos, photos[1][17:150, 33:251]):
        img = np.ascontiguousarray(img)
        np.testing.assert_array_equal(jpeg_roundtrip(img, quality),
                                      _pil_jpeg(img, quality),
                                      err_msg=f"{img.shape} q={quality}")


def test_gaussian_blur_matches_pil():
    from PIL import ImageFilter

    from frcnn_tpu_torch.data.pipeline import gaussian_blur

    rng = np.random.default_rng(0)
    img = TSE._bundled_photos()[2][:90, :130].copy()
    noise = rng.integers(0, 256, (23, 31, 3)).astype(np.uint8)
    # the scenes' radii (0.25-1), and wider boxes than the image (4.0)
    for radius in (*rng.uniform(0.25, 1.0, 6), 1.7, 4.0):
        for x in (img, noise):
            want = np.asarray(Image.fromarray(x).filter(
                ImageFilter.GaussianBlur(float(radius))))
            got = gaussian_blur(x, float(radius))
            np.testing.assert_array_equal(got, want, err_msg=str(radius))


def test_resize_uint8_matches_pil():
    from frcnn_tpu_torch.data.pipeline import resize_uint8

    img = TSE._bundled_photos()[2][:90, :130].copy()
    for w, h in ((160, 120), (57, 200), (400, 33)):
        want = np.asarray(Image.fromarray(img).resize((w, h),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(resize_uint8(img, w, h), want)


def _jax_mode_table(cfg):
    """``scripts/eval_quant_parity.py:88-118`` on the CPU: (config,
    Detector options) by mode, ``calib`` standing for the batch."""
    pcfg = cfg.replace(pallas_mode="interpret")
    scfg = pcfg.replace(input_layout="s2d")
    static = dict(quantized=True, quant_calibration="calib")
    return {
        "bf16": (cfg, {}),
        "bf16_pallas": (pcfg, {}),
        "bf16_pallas_s2d": (scfg, {}),
        "int8_dynamic": (cfg, dict(quantized=True)),
        "int8_static": (cfg, static),
        "int8_static_pallas": (pcfg, static),
        "int8_static_s2d": (scfg, static),
        "int8_static_s2d_s8p": (scfg.replace(quant_pool_s8=True), static),
    }


@pytest.mark.parametrize("mode", list(_jax_mode_table(
    j_tse.tiny_cfg(3))))
def test_quant_parity_mode_table_matches_jax(mode):
    jcfg, jkw = _jax_mode_table(j_tse.tiny_cfg(3))[mode]
    tcfg, tkw = QP.mode_table(TSE.tiny_cfg(3), "calib")[mode]
    assert (tcfg.pallas_mode != "off") == (jcfg.pallas_mode != "off")
    assert tcfg.replace(pallas_mode="x") == type(tcfg).from_json(
        jcfg.replace(pallas_mode="x").to_json())
    assert tkw == jkw
    assert ("bf16", "int8_dynamic", "int8_static", "int8_static_s2d") == \
        QP.HEADLINE


def _fixed_detections(seed=0, n_img=6, C=3):
    """Seeded ground truth, detections near it (jittered boxes, random
    classes and scores) plus false positives, and stage-1 proposals."""
    rng = np.random.default_rng(seed)
    gts, dets, props = [], [], {}
    for i in range(n_img):
        props[i] = []
        for _ in range(int(rng.integers(1, 4))):
            x, y = rng.uniform(0, 120, 2)
            w, h = rng.uniform(20, 60, 2)
            box = [x, y, x + w, y + h]
            c = int(rng.integers(0, C))
            gts.append({"image": i, "class": c, "box": box})
            for _ in range(int(rng.integers(0, 3))):
                j = (np.asarray(box) + rng.normal(0, 6, 4)).tolist()
                cls = c if rng.random() < 0.7 else int(rng.integers(0, C))
                dets.append({"image": i, "class": cls,
                             "score": float(rng.uniform(0.02, 1.0)),
                             "box": j})
                props[i].append((np.asarray(box)
                                 + rng.normal(0, 10, 4)).tolist())
        for _ in range(int(rng.integers(0, 3))):
            x, y = rng.uniform(0, 150, 2)
            dets.append({"image": i, "class": int(rng.integers(0, C)),
                         "score": float(rng.uniform(0.02, 1.0)),
                         "box": [x, y, x + 30, y + 30]})
    return dets, gts, props


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_rescoring_matches_jax(seed):
    dets, gts, _ = _fixed_detections(seed)
    floor = 0.02
    want = []
    for t in SG.THRESHOLDS:        # scripts/sweep_conf_gate.py:83-96
        if t < floor:
            continue
        sub = [d for d in dets if d["score"] > t]
        want.append({"threshold": t,
                     "mAP": j_eval.compute_map(sub, gts, 3)["mAP"],
                     "recall": j_eval.matched_recall(sub, gts),
                     "num_detections": len(sub)})
    assert SG.rescore(dets, gts, 3, floor) == want
    assert want[0]["num_detections"] > want[-1]["num_detections"]


@pytest.mark.parametrize("seed", [0, 1])
def test_recall_attribution_row_matches_jax(seed):
    dets, gts, props = _fixed_detections(seed)
    floor, cap, fg = 0.02, 4, 0.5
    # scripts/recall_attribution.py:92-120
    cov = j_eval.proposal_coverage(props, gts)
    counts = np.array([len(v) for v in props.values()])
    want = {
        "fg_threshold": fg, "num_images": len(props), "num_gt": len(gts),
        "proposal_recall": cov["proposal_recall"],
        "gt_covered_by_proposals": cov["num_covered"],
        "proposals_per_image": {
            "mean": float(counts.mean()), "max": int(counts.max()),
            "cap": cap, "at_cap": int((counts >= cap).sum())},
        "by_conf_gate": {},
    }
    for t in RA.CONF_GATES:
        sub = [d for d in dets if d["score"] > t]
        want["by_conf_gate"][str(t)] = {
            "mAP": j_eval.compute_map(sub, gts, 3)["mAP"],
            "detection_recall": j_eval.matched_recall(sub, gts),
            "num_detections": len(sub)}
    got = RA.attribution_row(fg, dets, gts, len(props), props, cap, 3,
                             floor)
    assert got == want
    assert 0 < got["proposal_recall"] <= 1


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_tally_matches_jax(seed):
    dets, gts, _ = _fixed_detections(seed)
    C, iou_thr = 3, 0.5
    tally = AD.Tally(C, iou_thr)
    # scripts/analyze_detections.py:71-113, per image
    conf = np.zeros((C, C + 1), np.int64)
    ious, fp, n_det, n_gt = [], 0, 0, 0
    for i in sorted({g["image"] for g in gts}):
        img_dets = [(d["box"], d["class"]) for d in dets
                    if d["image"] == i]
        rois = [{"rect": g["box"], "class_index": g["class"]}
                for g in gts if g["image"] == i]
        tally.add(img_dets, rois)
        n_det += len(img_dets)
        matched = set()
        for r in rois:
            n_gt += 1
            best, bc, bi = 0.0, C, -1
            for di, (bx, c) in enumerate(img_dets):
                if di in matched:
                    continue
                v = j_analyze._iou(bx, r["rect"])
                if v > best:
                    best, bc, bi = v, c, di
            if best >= iou_thr and bi >= 0:
                conf[r["class_index"], bc] += 1
                matched.add(bi)
                ious.append(best)
            else:
                conf[r["class_index"], C] += 1
        fp += sum(1 for di in range(len(img_dets)) if di not in matched)
    np.testing.assert_array_equal(tally.conf, conf)
    assert (tally.ious, tally.fp, tally.n_det, tally.n_gt) == \
        (ious, fp, n_det, n_gt)
    matched_n = int(conf[:, :C].sum())
    assert tally.summary() == {
        "recall": matched_n / max(n_gt, 1),
        "class_acc_matched": int(np.trace(conf[:, :C])) / max(matched_n, 1),
        "false_positives": fp,
        "mean_matched_iou": float(np.mean(ious)) if ious else 0.0}
    assert matched_n > 0 and fp > 0


def test_tools_run_end_to_end_on_the_cpu(tmp_path, capsys):
    run = str(tmp_path / "run")
    assert TSE.main(["--scale", "tiny", "--steps", "12", "--images", "12",
                     "--out", run, "--device", "cpu", "--chunk", "4",
                     "--eval-count", "3", "--demo-count", "1"]) == 0
    for name in ("final.ckpt", "result.json", "loss_curve.csv",
                 "demo1.png", "metrics.jsonl", "dataset/manifest.json"):
        assert os.path.exists(os.path.join(run, name)), name
    assert len(Path(run, "loss_curve.csv").read_text().splitlines()) == 13
    result = json.loads(Path(run, "result.json").read_text())
    assert result["steps"] == 12 and result["num_images"] == 3

    assert QP.main(["--run", run, "--scale", "tiny", "--device", "cpu",
                    "--eval-count", "3", "--calib-count", "2"]) == 0
    parity = json.loads(Path(run, "quant_parity.json").read_text())
    assert set(QP.HEADLINE) <= set(parity) and parity["_step"] == 12
    assert parity["bf16"]["mAP_delta_vs_bf16"] == 0

    assert SG.main(["--run", run, "--scale", "tiny", "--device", "cpu",
                    "--eval-count", "3"]) == 0
    sweep = json.loads(Path(run, "gate_sweep.json").read_text())
    assert [r["threshold"] for r in sweep["sweep"]] == list(SG.THRESHOLDS)

    assert RA.main(["--run", run, "--scale", "tiny", "--device", "cpu",
                    "--eval-count", "3", "--fg", "0.5,0.95"]) == 0
    rows = json.loads(Path(run, "recall_attribution.json").read_text())
    assert [r["fg_threshold"] for r in rows["rows"]] == [0.5, 0.95]

    capsys.readouterr()
    assert AD.main(["--ckpt", os.path.join(run, "final.ckpt"), "--manifest",
                    os.path.join(run, "dataset", "manifest.json"),
                    "--count", "3", "--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"recall", "class_acc_matched", "false_positives",
                         "mean_matched_iou"}


def test_tools_need_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((TSE.main, ["--out", str(tmp_path)]),
                       (QP.main, ["--run", str(tmp_path)]),
                       (SG.main, ["--run", str(tmp_path)]),
                       (RA.main, ["--run", str(tmp_path)]),
                       (AD.main, ["--ckpt", "x", "--manifest", "y"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
