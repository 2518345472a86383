"""Whether a block of a product's output columns rounds as the whole
product's columns, and what the float64 accumulation of a float32
product costs.

For each shape (rows x contracted x columns, zamba2-7b's widths at a
decode lane's 8 rows and a prefill chunk's 1,024) it prints the share of
elements in which the 4 column blocks of ``x @ w`` (each block its own
product, as one "model" position computes it) differ from the whole
product's columns: in float32, and in float64 rounded once to float32
(``models/layers.product``).  Then CUDA-event times (median of 20) of
one float32 product three ways: in float32, in float64 converting the
weight on the call (the port's float32 path), and in float64 from a
weight converted beforehand.

    python -m repro_torch.benchmarks.column_blocks [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

SHAPES = ((8, 3584, 14336), (8, 3584, 32000), (8, 14336, 3584),
          (8, 3584, 112), (1024, 3584, 14336), (1024, 7168, 3584))


def _blocks(x: torch.Tensor, w: torch.Tensor, m: int = 4) -> torch.Tensor:
    n = w.shape[1]
    step = -(-n // m)
    return torch.cat([x @ w[:, lo:lo + step].contiguous()
                      for lo in range(0, n, step)], dim=-1)


def mismatch(x: torch.Tensor, w: torch.Tensor) -> dict:
    """The share of elements whose 4-block product differs from the
    whole product, float32 and float64-rounded-once."""
    f32 = (_blocks(x, w) != x @ w).float().mean()
    xd, wd = x.double(), w.double()
    f64 = (_blocks(xd, wd).float() != (xd @ wd).float()).float().mean()
    return {"float32": float(f32), "float64": float(f64)}


def _time(fn, dev, reps: int = 20) -> float | None:
    """Median CUDA-event milliseconds of ``fn``; None off a CUDA device."""
    for _ in range(3):
        fn()
    if dev.type != "cuda":
        return None
    ts = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for m, k, n in SHAPES:
        x = torch.randn(m, k, generator=g, device=dev)
        w = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
        wd = w.double()
        row = dict(shape=[m, k, n], blocks_differ=mismatch(x, w), ms=dict(
            float32=_time(lambda: x @ w, dev),
            float64_cast_per_call=_time(
                lambda: (x.double() @ w.double()).float(), dev),
            float64_weight_cast_before=_time(
                lambda: (x.double() @ wd).float(), dev)))
        rows.append(row)
        print(json.dumps(row))
        del x, w, wd
    return {"rows": rows}


if __name__ == "__main__":
    main()
