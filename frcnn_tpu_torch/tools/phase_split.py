"""Where the 2-conv block0 kernel's time goes, by phase, on the card.

    python -m frcnn_tpu_torch.tools.phase_split

Builds the kernels with ``-DFRCNN_PHASE_STAMPS`` (``csrc/block0_2conv.cu``
then stamps ``clock64()`` after each phase of its tile loop; a build
directory of its own), runs the kernel through its wrapper at B=8,
480x1000 on planes with a random pad ring, in three modes (bf16 planes with
float conv1; bf16 planes with int8 conv1 and int8 output; float32 planes),
and prints each phase's share of the blocks' cycles beside the kernel's
CUDA-event time with the stamps on. Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import torch

from frcnn_tpu_torch.models.quant import quantize_weight
from frcnn_tpu_torch.ops import block0_2conv_kernel as K
from frcnn_tpu_torch.ops import cuda_lib
from frcnn_tpu_torch.ops.block0_kernel import pack_padded

# the kernel's stamp rows: [blocks][phases], the last phase the total
STAMP_BLOCKS, STAMP_PHASES = 1024, 8
PHASES = ("prologue", "patch wait", "unstage", "next patch", "conv0",
          "conv1+pool", "store")


def _time_ms(fn, reps: int = 15) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase_split runs on a CUDA card only")
    cuda_lib.EXTRA_FLAGS = ("-DFRCNN_PHASE_STAMPS",)
    lib = cuda_lib.library()
    lib.frcnn_block0_2conv_stamps.argtypes = [ctypes.c_void_p]
    lib.frcnn_block0_2conv_stamps.restype = ctypes.c_int
    host = torch.zeros(STAMP_BLOCKS, STAMP_PHASES, dtype=torch.int64)

    B, H, W, Fo = 8, 480, 1000, 64
    gen = torch.Generator().manual_seed(0)
    padded = torch.randn(B, H + 2, W + 2, 3, generator=gen).cuda()
    std = (2.0 / (9 * Fo)) ** 0.5
    w0 = (torch.randn(Fo, 3, 3, 3, generator=gen) * std).cuda()
    w1 = (torch.randn(Fo, Fo, 3, 3, generator=gen) * std).cuda()
    b0 = (torch.randn(Fo, generator=gen) * 0.1).cuda()
    b1 = (torch.randn(Fo, generator=gen) * 0.1).cuda()
    w1q, s_w = quantize_weight(w1)
    s_y = torch.full((), 0.05, device="cuda")
    wq9, ws = K.block0_2conv_weights_q(w1q, s_w, s_y)
    inv_y = torch.ones(1, device="cuda") / s_y.reshape(1)
    inv_out = torch.full((1,), 20.0, device="cuda")
    modes = {}
    for dt in (torch.bfloat16, torch.float32):
        p = K.block0_2conv_weights(w0, b0, w1, b1, 0.25, 0.1, dt)
        lum4, chroma = (x.to(dt) for x in pack_padded(padded))
        name = str(dt)[6:]
        modes[f"{name} float conv1"] = (
            lambda l=lum4, c=chroma, p=p: K.fused_block0_2conv(l, c, *p))
        if dt == torch.bfloat16:
            qa = (p.w0, p.b0, wq9, p.b1, p.slopes)
            modes[f"{name} int8 conv1, int8 out"] = (
                lambda l=lum4, c=chroma, qa=qa: K.fused_block0_2conv(
                    l, c, *qa, w1_scale=ws, inv_y=inv_y, inv_out=inv_out))
    for mode, run in modes.items():
        ms = _time_ms(run)
        rc = lib.frcnn_block0_2conv_stamps(ctypes.c_void_p(host.data_ptr()))
        if rc:
            raise RuntimeError(f"reading the stamps failed ({rc})")
        s = host.double()
        s = s[s[:, -1] > 0]
        total = float(s[:, -1].sum())
        parts = ", ".join(f"{n} {100 * float(s[:, i].sum()) / total:.1f}%"
                          for i, n in enumerate(PHASES))
        print(f"[phase-split] {mode}, B={B} {H}x{W}: {ms:.4f} ms (CUDA "
              f"events, stamps on), {s.shape[0]} blocks, "
              f"{float(s[:, -1].mean()):.0f} cycles per block: {parts}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
