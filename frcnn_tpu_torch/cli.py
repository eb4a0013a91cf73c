"""The port's command line: the JAX package's ``main.py`` (the reference's
``main.lua``) on PyTorch.

    python -m frcnn_tpu_torch [--device cuda|cpu] <subcommand> ...

(or ``frcnn-tpu-torch`` once the package is installed). The same
subcommands, flags, defaults and ``--cfg``/``--model`` overrides as
``main.py``:

  train            ``graph_training`` (main.lua:103-153)
  demo             ``evaluation_demo`` (main.lua:183-216), PNG output
  evaluate         mAP on the validation split
  import-duplo     create-duplo-traindata.lua
  import-imagenet  create-imagenet-traindata.lua
  import-t7        a reference training-data .t7 -> manifest
  import-t7-model  a reference network snapshot -> checkpoint
  export-t7-model  checkpoint -> reference network snapshot

``--device`` (default ``cuda``) takes the place of ``main.py``'s
``--platform``: train, demo and evaluate run on the card, and stop when
there is none; ``--device cpu`` is the only way onto the CPU. The kernels
follow the config (``pallas_mode``): a config JSON with ``"pallas_mode":
"on"`` trains through them, ``--serving fast`` serves through them. On the
CPU the kernels' plain versions run.

``train`` spreads its steps over every local card, as ``main.py train``
spreads them over every local device: over the largest count of them, up
to ``--devices``, that divides ``images_per_step``, one process per card
(``parallel/mesh.py::launch``). Each process takes its rows of the same
whole batch, so the trajectory is the one-process trajectory. Under
``torchrun`` (``RANK``/``WORLD_SIZE`` set) each process is one rank and
nothing is spawned again:

    torchrun --nproc-per-node N -m frcnn_tpu_torch train ...

Checkpoints are the JAX package's format both ways, so either CLI
continues or serves the other's snapshots.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

log = logging.getLogger("frcnn_tpu_torch.main")


def build_config(args):
    from frcnn_tpu_torch.config import (
        CONFIGS,
        Config,
        vgg_large_model,
        vgg_small_model,
    )

    if args.cfg in CONFIGS:
        cfg = CONFIGS[args.cfg]()
    elif os.path.exists(args.cfg):
        with open(args.cfg) as f:
            cfg = Config.from_json(f.read())
    else:
        raise SystemExit(f"unknown config {args.cfg!r}")

    overrides = {}
    if args.model:
        models = {"vgg_small": vgg_small_model, "vgg_large": vgg_large_model}
        if args.model not in models:
            raise SystemExit(f"unknown model {args.model!r}")
        overrides["model"] = models[args.model]()
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    if args.rms_decay is not None:
        overrides["rms_decay"] = args.rms_decay
    if args.opti is not None:
        overrides["optimizer"] = args.opti
    if args.seed:
        overrides["seed"] = args.seed
    if args.snapshot is not None:
        overrides["snapshot_interval"] = args.snapshot
    if args.plot is not None:
        overrides["plot_interval"] = args.plot
    return cfg.replace(**overrides) if overrides else cfg


def _require_file(path: str, what: str):
    if path and not os.path.exists(path):
        raise SystemExit(f"{what} not found: {path!r}")


def require_device(name: str):
    """``torch.device(name)``; a CUDA device that is not there stops the
    command with a ``SystemExit`` (no fallback to the CPU)."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; "
                         f"pass --device cpu to run on the CPU")
    return device


def device_count(device, requested) -> int:
    """``--devices``: how many local devices a data-parallel step may use.
    By default every visible card under CUDA (``main.py`` takes every
    device JAX sees), one process on the CPU; asking for more cards than
    are visible stops the command."""
    import torch

    if requested is not None and requested < 1:
        raise SystemExit(f"--devices {requested}: at least 1")
    if device.type != "cuda":
        return 1 if requested is None else requested
    visible = torch.cuda.device_count()
    if requested is None:
        return visible
    if requested > visible:
        raise SystemExit(f"--devices {requested}: only {visible} CUDA "
                         f"device(s) are visible")
    return requested


def setup_logging(rank: int = 0):
    """INFO lines on rank 0, WARNING and above on the other ranks."""
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="[%(asctime)s] %(message)s")
    if rank:
        logging.getLogger().setLevel(logging.WARNING)


def in_rank():
    """Whether this process is one rank of a group that ``torchrun`` or
    ``parallel/mesh.py::launch`` started (its variables are set)."""
    return "WORLD_SIZE" in os.environ


def cmd_train(args):
    """The training loop with loss lines, periodic plots and snapshots,
    restart-safe (``graph_training``), data-parallel over
    ``data_parallel_size(--devices, images_per_step)`` processes."""
    from frcnn_tpu_torch.parallel.mesh import data_parallel_size, launch

    _require_file(args.train, "training manifest")
    _require_file(args.restore, "checkpoint")
    device = require_device(args.device)
    if in_rank():
        _train_rank(args, device.type)
        return
    cfg = build_config(args)
    world = data_parallel_size(device_count(device, args.devices),
                               cfg.shapes.images_per_step)
    if world == 1:
        _train(args, cfg, device, args.threads)
        return
    log.info("data-parallel training over %d %s processes", world,
             device.type)
    launch(cmd_train, world, device.type, args)


def _train_rank(args, device_type: str):
    """One rank of a data-parallel run: joins the group (unless the
    caller has), trains its rows of every batch on its local device and,
    on rank 0 alone, logs, plots and writes the metrics and snapshots."""
    from frcnn_tpu_torch.parallel import mesh

    setup_logging(int(os.environ["RANK"]))
    with mesh.rank_group(device_type) as device:
        _train(args, build_config(args), device,
               args.threads or mesh.host_threads(), shard=mesh.batch_shard())


def _train(args, cfg, device, threads: int, shard=None):
    """Training on ``device`` with ``threads`` decode threads per batch;
    data-parallel, this process's ``shard``
    (``parallel/mesh.py::batch_shard``): every rank assembles the same
    whole batch (same seed) and the Trainer takes its rows."""
    from frcnn_tpu_torch.data.pipeline import (
        BatchIterator,
        PrefetchingIterator,
    )
    from frcnn_tpu_torch.train.trainer import Trainer
    from frcnn_tpu_torch.utils.plotting import plot_training_progress

    lead = shard is None or shard.rank == 0
    log.info("config: %s classes=%d scales=%s", args.cfg, cfg.class_count,
             cfg.scales)
    it = BatchIterator(cfg, args.train, seed=cfg.seed, num_threads=threads)
    m = it.manifest
    log.info(
        "Training data loaded. Dataset: '%s'; Total files: %d; classes: %d; "
        "Background: %d",
        m.get("dataset_name"), len(m["ground_truth"]), len(m["class_names"]),
        len(m.get("background_files", [])),
    )

    trainer = Trainer(cfg, device=device, shard=shard,
                      metrics_path=f"{args.name}_metrics.jsonl" if lead
                      else None)
    if args.restore:
        trainer.restore_snapshot(args.restore)
        log.info("restored %s at step %d", args.restore, trainer.step)

    source = PrefetchingIterator(it, depth=args.prefetch) if args.prefetch \
        else it
    try:
        _train_loop(args, cfg, trainer, source, plot_training_progress,
                    lead)
    finally:
        if source is not it:
            source.close()
        trainer.metrics_logger.close()


def _train_loop(args, cfg, trainer, source, plot, lead: bool):
    """``lead``: this process plots and writes the snapshots (rank 0)."""
    steps = args.steps or cfg.total_steps
    chunk = max(1, args.chunk)
    t_report = time.perf_counter()
    pending = None  # bucket-switch carry (dual-bucket configs)
    while trainer.step < steps:
        k = min(chunk, steps - trainer.step)
        batches = [pending] if pending is not None else []
        pending = None
        while len(batches) < k:
            b = source.next_training_batch()
            # the batches of one chunk share a bucket; a bucket switch
            # (portrait image) ends the chunk
            if batches and b.image.shape[1:3] != batches[0].image.shape[1:3]:
                pending = b
                break
            batches.append(b)
        chunk_metrics = (trainer.run_chunk(batches) if len(batches) > 1
                         else [trainer.run_step(batches[0])])
        base = trainer.step - len(chunk_metrics)
        for j, metrics in enumerate(chunk_metrics):
            i = base + j + 1
            log.info(
                "%d: loss: %f  prop: cls %.4f reg %.4f; det: cls %.4f reg "
                "%.4f (examples: %d)",
                i, metrics["loss"], metrics["pcls"], metrics["preg"],
                metrics["dcls"], metrics["dreg"], int(metrics["cls_count"]),
            )
            if metrics.get("skipped"):
                log.warning("step %d: non-finite update — skipped", i)
            if lead and cfg.plot_interval and i % cfg.plot_interval == 0:
                plot(args.name, trainer.stats)
        # snapshots at chunk boundaries, named with the true step
        if lead and cfg.snapshot_interval and (
            trainer.step // cfg.snapshot_interval
            > base // cfg.snapshot_interval
        ):
            path = f"{args.name}_{trainer.step:06d}.ckpt"
            options = {
                k2: v for k2, v in vars(args).items()
                if isinstance(v, (str, int, float, bool, type(None)))
            }
            trainer.save_snapshot(path, options=options)
            log.info("snapshot %s (%.1fs since last report)",
                     path, time.perf_counter() - t_report)
            t_report = time.perf_counter()


def _state_dicts(cfg, restore):
    """``{'pnet', 'cnet'}`` state dicts: the checkpoint's, else the seeded
    initialisation of ``cfg.seed``."""
    import torch

    from frcnn_tpu_torch.models.factory import init_models
    from frcnn_tpu_torch.utils import weights
    from frcnn_tpu_torch.utils.serialization import load_checkpoint

    if restore:
        ckpt = load_checkpoint(restore)
        return weights.from_jax_params(ckpt["params"], ckpt["batch_stats"],
                                       cfg)
    pnet, cnet = init_models(cfg, torch.Generator().manual_seed(cfg.seed))
    return {"pnet": pnet.state_dict(), "cnet": cnet.state_dict()}


def _make_detector(cfg, restore, device, serving: str = "reference"):
    """``serving='fast'``: ``serving_config(cfg)`` (the kernels, the
    space-to-depth input where the model allows it) and the int8 backbone
    with dynamic scales; the default is the plain path of ``cfg``."""
    from frcnn_tpu_torch.detect.detector import Detector
    from frcnn_tpu_torch.models.factory import models_from_state_dicts

    _require_file(restore, "checkpoint")
    pnet, cnet = models_from_state_dicts(cfg, _state_dicts(cfg, restore))
    if serving == "fast":
        from frcnn_tpu_torch.config import serving_config

        return Detector(serving_config(cfg), pnet, cnet, device=device,
                        quantized=True)
    return Detector(cfg, pnet, cnet, device=device)


def cmd_demo(args):
    """Detect on random validation images, draw the stage-1 proposal boxes
    (main.lua:209) and save PNGs (``evaluation_demo``)."""
    import numpy as np

    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.ops.color import yuv2rgb
    from frcnn_tpu_torch.utils.drawing import GREEN, draw_rectangle, save_image

    _require_file(args.train, "training manifest")
    device = require_device(args.device)
    cfg = build_config(args)
    it = BatchIterator(cfg, args.train, seed=cfg.seed,
                       num_threads=args.threads)
    det = _make_detector(cfg, args.restore, device, serving=args.serving)
    os.makedirs(args.out, exist_ok=True)

    for i in range(args.count):
        imgs, hws, _ = it.padded_validation_batch(1)
        if imgs.shape[0] == 0:
            log.warning("validation set empty/unreadable — stopping demo")
            break
        out = det.detect(imgs, hws)
        h, w = int(hws[0][0]), int(hws[0][1])
        img = np.asarray(imgs[0][:h, :w]).copy()
        if img.dtype == np.uint8:      # uint8 wire: already RGB
            img = img.astype(np.float32) / 255.0
        elif cfg.color_space == "yuv":
            img = yuv2rgb(img)
        valid = out.valid[0].cpu().numpy()
        boxes = out.proposal_boxes[0].cpu().numpy()
        for b in boxes[valid]:
            draw_rectangle(img, b, GREEN)
        path = os.path.join(args.out, f"output{i + 1}.png")
        save_image(img, path)
        log.info("%s: %d detections", path, int(valid.sum()))


def cmd_evaluate(args):
    from frcnn_tpu_torch.data.pipeline import BatchIterator
    from frcnn_tpu_torch.detect.evaluation import evaluate_map

    _require_file(args.train, "training manifest")
    device = require_device(args.device)
    cfg = build_config(args)
    it = BatchIterator(cfg, args.train, seed=cfg.seed,
                       num_threads=args.threads)
    det = _make_detector(cfg, args.restore, device, serving=args.serving)
    result = evaluate_map(cfg, det, it, max_images=args.count)
    print(json.dumps(result, indent=2))


def cmd_import_duplo(args):
    from frcnn_tpu_torch.data.importers import create_duplo_manifest

    _require_file(args.csv, "CSV file")
    m = create_duplo_manifest(
        args.name or "duplo", args.csv, args.background, args.out,
        validation_size=args.val_size, seed=args.seed or 0,
    )
    log.info(
        "Total images: %d; classes: %d; train: %d; val: %d; background: %d",
        len(m["ground_truth"]), len(m["class_names"]),
        len(m["training_set"]), len(m["validation_set"]),
        len(m["background_files"]),
    )


def cmd_import_t7(args):
    """Convert a reference training-data .t7 file to a JSON manifest."""
    from frcnn_tpu_torch.data.importers import create_manifest_from_t7

    _require_file(args.t7, "t7 file")
    m = create_manifest_from_t7(args.t7, args.out)
    log.info(
        "Converted '%s': images: %d; classes: %d; train: %d; val: %d; "
        "background: %d", m["dataset_name"],
        len(m["ground_truth"]), len(m["class_names"]),
        len(m["training_set"]), len(m["validation_set"]),
        len(m["background_files"]),
    )


def cmd_import_t7_model(args):
    """Convert a reference network snapshot (the flat weight vector of
    ``utilities.lua:126-134``) into a checkpoint."""
    from frcnn_tpu_torch.data.t7_model import load_reference_model
    from frcnn_tpu_torch.utils import weights
    from frcnn_tpu_torch.utils.serialization import save_checkpoint

    _require_file(args.t7, "t7 model snapshot")
    cfg = build_config(args)
    state, meta = load_reference_model(args.t7, cfg, _state_dicts(cfg, ""),
                                       order=args.order)
    params, batch_stats = weights.to_jax_params(state["pnet"], state["cnet"],
                                                cfg)
    save_checkpoint(args.out, params=params, batch_stats=batch_stats,
                    step=0, options={"imported_from": args.t7,
                                     "order": meta["order"]})
    log.info(
        "Imported '%s' (order=%s, diagnosis=%s) -> %s. NOTE: the reference "
        "format carries no BatchNorm running stats (torch parameters() "
        "excludes them; its own restore resets them too): cnet batch stats "
        "are freshly initialized; fine-tune or run training batches to "
        "re-estimate.",
        args.t7, meta["order"], meta["order_diagnosis"], args.out,
    )


def cmd_export_t7_model(args):
    """Export a checkpoint as a reference-loadable .t7 snapshot (the flat
    weight vector ``load_model`` of ``main.lua:80-101`` reads)."""
    from frcnn_tpu_torch.data.t7_model import save_reference_model

    _require_file(args.restore, "checkpoint")
    cfg = build_config(args)
    save_reference_model(args.out, _state_dicts(cfg, args.restore), cfg,
                         order=args.order)
    log.info("Exported %s -> %s (order=%s)", args.restore, args.out,
             args.order)


def cmd_import_imagenet(args):
    from frcnn_tpu_torch.data.importers import create_imagenet_manifest

    if not os.path.isdir(args.base_dir):
        raise SystemExit(f"ILSVRC base dir not found: {args.base_dir!r}")
    m = create_imagenet_manifest(
        args.name or "ILSVRC2015_DET", args.base_dir,
        "Annotations/DET/train", "Annotations/DET/val",
        "Data/DET/train", "Data/DET/val",
        background_dirs=[
            f"Data/DET/train/ILSVRC2013_train_extra{i}" for i in range(11)
        ],
        output_path=args.out,
    )
    log.info(
        "Total images: %d; classes: %d; train: %d; val: %d; background: %d",
        len(m["ground_truth"]), len(m["class_names"]),
        len(m["training_set"]), len(m["validation_set"]),
        len(m["background_files"]),
    )


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="frcnn_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, train_required=True):
        sp.add_argument("--cfg", default="duplo",
                        help="config preset or JSON file")
        sp.add_argument("--model", default=None, help="vgg_small | vgg_large")
        sp.add_argument("--name", default="experiment", help="snapshot prefix")
        sp.add_argument("--train", required=train_required,
                        help="training manifest JSON")
        sp.add_argument("--restore", default="", help="checkpoint to load")
        sp.add_argument("--snapshot", type=int, default=None,
                        help="snapshot interval (default 1000)")
        sp.add_argument("--plot", type=int, default=None,
                        help="plot interval (default 100)")
        sp.add_argument("--lr", type=float, default=None)
        sp.add_argument("--rms_decay", type=float, default=None)
        sp.add_argument("--opti", default=None, help="rmsprop | sgd | nag")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--threads", type=int, default=0,
                        help="native loader threads (0 = the cores, shared "
                        "out over the data-parallel ranks)")
        sp.add_argument("--prefetch", type=int, default=2,
                        help="batches prefetched ahead (0 = synchronous)")

    sp = sub.add_parser("train", help="joint RPN+classifier training")
    common(sp)
    sp.add_argument("--steps", type=int, default=None,
                    help="override total steps (default 50000)")
    sp.add_argument("--chunk", type=int, default=1,
                    help="train steps per metrics copy to the host "
                    "(Trainer.run_chunk; identical trajectory to --chunk 1)")
    sp.add_argument("--devices", type=int, default=None,
                    help="at most this many local devices, one process "
                    "each (default: every visible card; 1 on the CPU); "
                    "the step spreads over the largest count that "
                    "divides images_per_step")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("demo", help="draw detections on validation images")
    common(sp)
    sp.add_argument("--out", default="demo_out")
    sp.add_argument("--count", type=int, default=50)
    sp.add_argument("--serving", default="reference",
                    choices=["reference", "fast"],
                    help="fast = kernels + s2d layout + int8 backbone")
    sp.set_defaults(fn=cmd_demo)

    sp = sub.add_parser("evaluate", help="mAP on the validation split")
    common(sp)
    sp.add_argument("--count", type=int, default=200)
    sp.add_argument("--serving", default="reference",
                    choices=["reference", "fast"],
                    help="fast = kernels + s2d layout + int8 backbone")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("import-duplo", help="CSV -> manifest")
    sp.add_argument("--csv", required=True)
    sp.add_argument("--background", default=None)
    sp.add_argument("--out", required=True)
    sp.add_argument("--name", default="duplo")
    sp.add_argument("--val-size", type=float, default=0.2)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_import_duplo)

    sp = sub.add_parser("import-t7",
                        help="reference training-data .t7 -> manifest")
    sp.add_argument("--t7", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_import_t7)

    sp = sub.add_parser(
        "import-t7-model",
        help="reference network snapshot (flat weights) -> our checkpoint")
    common(sp, train_required=False)
    sp.add_argument("--t7", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--order", default="auto",
                    choices=["auto", "nngraph", "blocks_first", "interleaved"],
                    help="pnet gModule parameter order (see "
                    "data/t7_model.py; 'auto' checks the derived 'nngraph' "
                    "order by PReLU-slope plausibility)")
    sp.set_defaults(fn=cmd_import_t7_model)

    sp = sub.add_parser("export-t7-model",
                        help="our checkpoint -> reference-loadable .t7")
    common(sp, train_required=False)
    sp.add_argument("--out", required=True)
    sp.add_argument("--order", default="nngraph",
                    choices=["nngraph", "blocks_first", "interleaved"])
    sp.set_defaults(fn=cmd_export_t7_model)

    sp = sub.add_parser("import-imagenet",
                        help="ILSVRC2015 DET XML -> manifest")
    sp.add_argument("--base-dir", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--name", default="ILSVRC2015_DET")
    sp.set_defaults(fn=cmd_import_imagenet)

    p.add_argument("--device", default="cuda",
                   help="device of train, demo and evaluate: 'cuda' "
                   "(default; stops without a card) or 'cpu'")
    return p


def main(argv=None):
    setup_logging()
    args = parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
