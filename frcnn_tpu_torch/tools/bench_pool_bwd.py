"""The 2x2 ceil-pool backward alone, per backbone shape: the library's
backward against the hand-written first-max kernel, on the card (the
counterpart of ``scripts/bench_pool_bwd.py``).

    python -m frcnn_tpu_torch.tools.bench_pool_bwd [iters] [batch] \\
        [--device cuda|cpu] [--scale S]

The four pre-pool activations of vgg_small at 450x800 (:data:`SHAPES`,
NHWC, bf16; the JAX script's ``SHAPES``). The labels keep the JAX
script's names: ``ss`` is the library backward (autograd through
``F.max_pool2d(ceil_mode=True)``, its ``max_pool2d_with_indices_backward``:
the JAX script's XLA SelectAndScatter), ``pallas`` the kernel
(``ops/pool_bwd_kernel.py::ceil_max_pool_2x2_bwd``, ``csrc/pool_bwd.cu``).
Inputs are normal draws from a seeded generator on the device (the
activations' values do not matter to the routing's time). Each line is
the best of 3 runs of ``iters`` calls, each run timed by CUDA
events, per call; the cotangent is the same each call (nothing to hoist in
eager PyTorch). Then the JAX script's ``TOTAL`` line and the card's name
and power limit. ``--scale`` divides H and W (a CPU run at a tiny size;
the JAX script has none). With ``--device cpu`` the host clock times the
CPU and the kernel's wrapper runs its plain version.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

B = 8
# pre-pool activations of the four vgg_small blocks (duplo at 450x800)
SHAPES = [
    (B, 450, 800, 64),
    (B, 225, 400, 128),
    (B, 113, 200, 256),
    (B, 57, 100, 384),
]


def shapes(batch: int, scale: int = 1):
    return [(batch, -(-h // scale), -(-w // scale), c)
            for _, h, w, c in SHAPES]


def main(argv=None) -> int:
    from frcnn_tpu_torch.bench import device_line
    from frcnn_tpu_torch.cli import require_device
    from frcnn_tpu_torch.ops.pool_bwd_kernel import ceil_max_pool_2x2_bwd
    from frcnn_tpu_torch.utils.metrics import seconds

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", type=int, nargs="?", default=30)
    ap.add_argument("batch", type=int, nargs="?", default=B)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1)
    a = ap.parse_args(argv)
    device = require_device(a.device)

    def timed(label, fn):
        t0 = time.perf_counter()
        fn()
        print(f"# {label} first call: {time.perf_counter() - t0:.1f}s",
              flush=True)
        best = min(seconds(fn, a.iters, device) for _ in range(3))
        print(f"{label}: {best / a.iters * 1e3:.3f} ms", flush=True)
        return best / a.iters

    gen = torch.Generator(device).manual_seed(0)
    total = {"ss": 0.0, "pallas": 0.0}
    for shape in shapes(a.batch, a.scale):
        b, h, w, c = shape
        x = torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)
        g = torch.randn((b, (h + 1) // 2, (w + 1) // 2, c), generator=gen,
                        device=device).to(torch.bfloat16)
        # NCHW views of the NHWC tensors: channels_last, as pnet holds them
        xl = x.permute(0, 3, 1, 2).requires_grad_(True)
        gl = g.permute(0, 3, 1, 2)
        y = F.max_pool2d(xl, 2, 2, ceil_mode=True)

        def ss_bwd():
            return torch.autograd.grad(y, xl, gl, retain_graph=True)[0]

        name = f"[{b},{h},{w},{c}]"
        total["ss"] += timed(f"ss     {name}", ss_bwd)
        total["pallas"] += timed(f"pallas {name}",
                                 lambda: ceil_max_pool_2x2_bwd(x, g))
        del x, g, xl, gl, y
    print(f"TOTAL ss: {total['ss'] * 1e3:.3f} ms  "
          f"pallas: {total['pallas'] * 1e3:.3f} ms", flush=True)
    print(device_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
