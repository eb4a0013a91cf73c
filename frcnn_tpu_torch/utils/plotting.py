"""Training-progress plot (the JAX package's ``utils/plotting.py``) —
``plot_training_progress`` (``main.lua:59-78``): the four loss series
(pcls, preg, dcls, dreg) to ``<prefix>_progress.png``. matplotlib
(imported at the call) replaces gnuplot; a CSV sidecar is written for
tooling."""

from __future__ import annotations

import csv


def plot_training_progress(prefix: str, stats) -> str:
    """stats: TrainingStats or dict of the four series."""
    series = stats.to_dict() if hasattr(stats, "to_dict") else dict(stats)
    fn = f"{prefix}_progress.png"

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = range(1, len(series["pcls"]) + 1)
    fig, ax = plt.subplots(figsize=(8, 5))
    for name in ("pcls", "preg", "dcls", "dreg"):
        ax.plot(xs, series[name], label=name, linewidth=0.8)
    ax.set_title("Training progress over time")
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.set_xlim(0, max(len(series["pcls"]), 1))
    ax.set_ylim(0, 10)  # same fixed loss window as the reference plot
    ax.legend()
    fig.savefig(fn, dpi=100)
    plt.close(fig)

    with open(f"{prefix}_progress.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["iteration", "pcls", "preg", "dcls", "dreg"])
        for i in range(len(series["pcls"])):
            w.writerow(
                [i + 1, series["pcls"][i], series["preg"][i],
                 series["dcls"][i], series["dreg"][i]]
            )
    return fn
