"""Kernel benchmark: the CUDA ``majx_sense`` and bit-plane GEMM against
their plain PyTorch versions (port of ``benchmarks/kernel_bench.py``).

At the reference's shapes: ``majx_sense`` on 16 events x 8 rows x 4,096
columns (one calibration iteration's sensing), and the bit-plane GEMM at
B 8 over a 2048 x 2048 4-bit projection in dense planes (the ``ops``
entry, which sends B > 1 to the batch-tiled kernel), in both modes.  Each
row has its measured time and the modeled ``ops`` and ``bytes`` of the
function (each input read once, each output written once); every kernel
output equals its plain version's on the same inputs, or the run raises.

On the card the times are CUDA events with the L2 flushed
(``autotune.median_time``); on the CPU the kernel rows run the plain
versions and the times are host times of the CPU, never a device's.

    python -m repro_torch.benchmarks.kernel_bench [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.core.rng import generator
from repro_torch.devices import resolve_device
from repro_torch.kernels import ops, ref, sense
from repro_torch.kernels.autotune import median_time

from .common import emit, hold_to_plain, parse_scale

SENSE = (16, 8, 4096)           # T events, R rows, C columns
GEMM = dict(b=8, k=2048, n=2048, wb=4)
REPS = 20                       # timed calls per row on the card (2 on a CPU)


def run(scale=None, device=None) -> list[dict]:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    gen = generator(0, "kernel-bench", device=dev)
    rows, kernels, plains = [], [], []

    def row(kernel, mode, shape, fn, ops_, bytes_):
        ms = 1e3 * median_time(fn, dev, reps=REPS if on_card else 2)[0]
        rows.append({"kernel": kernel, "mode": mode, "shape": shape,
                     "device": str(dev), "ms": ms, "ops": ops_,
                     "bytes": bytes_, "equal_to_plain": True})

    # majx_sense: one calibration iteration's sensing workload
    t, r, c = SENSE
    charge = torch.rand((t, r, c), generator=gen, device=dev)
    offs = 0.03 * torch.randn(c, generator=gen, device=dev)
    noise = torch.randn((t, c), generator=gen, device=dev)
    got = ops.majx_sense(charge, offs, noise)
    want = sense.majx_sense_plain(charge, offs, noise)
    kernels.append(got)
    plains.append(want)
    nbytes, nops = (t * r * c + 2 * t * c + c) * 4, t * c * (5 * r + 9)
    shape = f"{t}x{r}x{c}"
    row("majx_sense", "cuda" if on_card else "plain (cpu)", shape,
        lambda: ops.majx_sense(charge, offs, noise), nops, nbytes)
    row("majx_sense", "plain", shape,
        lambda: sense.majx_sense_plain(charge, offs, noise), nops, nbytes)

    # the bit-plane GEMM: a batched decode projection
    b, k, n, wb = GEMM["b"], GEMM["k"], GEMM["n"], GEMM["wb"]
    x = torch.randint(-127, 128, (b, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (k, n), generator=gen,
                      device=dev, dtype=torch.int32)
    planes = ref.pack_bitplanes(w, wb)
    want = ref.bitplane_gemv_ref(x, planes)
    shape = f"{b}x{k}x{n}@{wb}b"
    nbytes, nops = wb * k * n + b * k + b * n * 4, 2 * b * k * n
    for mode in ("planes", "folded"):
        got = ops.bitplane_gemv(x, planes, mode=mode)
        kernels.append(got)
        plains.append(want)
        row("bitplane_gemm", mode, shape,
            lambda m=mode: ops.bitplane_gemv(x, planes, mode=m), nops, nbytes)
    row("bitplane_gemm", "plain", shape,
        lambda: ref.bitplane_gemv_ref(x, planes), nops, nbytes)
    hold_to_plain("kernel_bench", kernels, plains)
    return rows


def report(scale=None, device=None) -> list[dict]:
    rows = run(scale, device)
    emit("kernel_bench", rows,
         header="kernels vs plain versions; ms: CUDA events with the L2 "
                "flushed on a GPU, the host clock on the CPU")
    for r in rows:
        print(f"  {r['kernel']:<14s} {r['mode']:<12s} {r['shape']:<18s} "
              f"{r['ms']:9.4f} ms on {r['device']}")
    return rows


def main(argv=None) -> int:
    scale, device = parse_scale(argv, description=__doc__)
    report(scale, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
