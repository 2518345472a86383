"""Roofline of the dry run's records (port of ``benchmarks/roofline.py``)
at the NVIDIA H100's rates.

Reads ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__<variant>].json``
(written by ``python -m repro_torch.launch.dryrun``) and derives, per
cell:

    compute term    = flops_per_device / 989.4e12            [s]
    memory term     = bytes_per_device / 3.35e12             [s]
    collective term = collective_bytes_per_device / 450e9    [s]

The rates are NVIDIA's data sheet for the H100 80GB HBM3 (SXM5) at its
700 W limit: dense bf16 tensor-core FLOP/s, HBM3 bandwidth, and NVLink 4
per direction (one card's whole NVLink, so the collective term is a lower
bound where a transfer would cross a slower link).  All three use the
first lane's per-position counts (``launch/cost_analysis.py``).

MODEL_FLOPS uses 6 N D for training (forward and backward) and 2 N D for
inference cells (forward only), N = active parameters, D = tokens the step
processes; useful_ratio = MODEL_FLOPS / (counted flops x positions).  The
collective term takes every kind the records count, the "model" group's
all-reduces and all-gathers among them.  Where the "model" axis splits
compute (the record's ``scheme``: every family but the hybrid) each
position does its share; elsewhere (zamba2-7b) every position of a lane
does the lane's whole work, and on the (data 16, model 16) meshes the
ratio sits near 1/16.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.configs import SHAPES, get

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

PEAK_FLOPS = 989.4e12   # bf16 dense / card (H100 SXM5, 700 W)
HBM_BW = 3.35e12        # B/s / card (HBM3)
LINK_BW = 450e9         # B/s / card (NVLink 4, one direction)


def model_flops_per_device(arch: str, shape: str, n_devices: int) -> float:
    spec = get(arch)
    cell = SHAPES[shape]
    n = spec.n_active_params
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        mult = 6.0
    elif cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = cell.global_batch
        mult = 2.0
    return mult * n * tokens / n_devices


def terms(rec: dict) -> dict:
    """The record's compute, memory and collective seconds."""
    return {"compute": rec.get("flops_per_device", 0.0) / PEAK_FLOPS,
            "memory": rec.get("bytes_per_device", 0.0) / HBM_BW,
            "collective": rec.get("collectives", {}).get("total_bytes", 0.0)
            / LINK_BW}


def analyze_record(rec: dict) -> dict:
    arch, shape = rec["arch"], rec["shape"]
    nd = rec["n_devices"]
    flops = rec.get("flops_per_device", 0.0)
    t = terms(rec)
    dom = max(t, key=t.get)
    mf = model_flops_per_device(arch, shape, nd)
    bound = max(t.values())
    return {
        "arch": arch, "shape": shape,
        "variant": rec.get("variant", "base"),
        "mesh": rec["mesh"], "chips": nd,
        "compute_s": t["compute"], "memory_s": t["memory"],
        "collective_s": t["collective"],
        "dominant": dom,
        "model_flops_per_dev": mf,
        "useful_ratio": mf / flops if flops else 0.0,
        # ideal compute time at peak on the model's flops over the modeled
        # step time (the dominant term)
        "roofline_frac": (mf / PEAK_FLOPS) / bound if bound else 0.0,
        "peak_gib": rec.get("peak_bytes_per_device", 0) / 2**30,
    }


def load(mesh: str, variant: str | None = None) -> list[dict]:
    rows = []
    for p in sorted((ART / mesh).glob("*.json")):
        if p.name.endswith(".error.json"):
            continue
        rec = json.loads(p.read_text())
        if not rec.get("ok"):
            continue
        v = rec.get("variant", "base")
        if variant is not None and v != variant:
            continue
        rows.append(dict(analyze_record(rec),
                         split=rec.get("scheme", "").endswith(
                             "splits compute")))
    return rows


def fmt_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | variant | compute_s | memory_s | collective_s | "
           "dominant | useful | roofline | peak GiB | model axis |")
    sep = "|" + "---|" * 11
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['variant']} "
            f"| {r['compute_s']:.3g} | {r['memory_s']:.3g} "
            f"| {r['collective_s']:.3g} | {r['dominant']} "
            f"| {r['useful_ratio']:.3g} | {r['roofline_frac']:.3g} "
            f"| {r['peak_gib']:.2f} "
            f"| {'splits compute' if r.get('split') else 'storage only'} |")
    return "\n".join(out)


def hint(mesh: str) -> str:
    return (f"no dry-run artifacts under {ART / mesh} — run "
            "PYTHONPATH=src python -m repro_torch.launch.dryrun first")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default="base",
                    help="'base' (default), a variant name, or 'all'")
    args = ap.parse_args(argv)
    variant = None if args.variant == "all" else args.variant
    rows = load(args.mesh, variant)
    if not rows:
        print(hint(args.mesh))
        return
    print(fmt_table(rows))
    worst = min(rows, key=lambda r: r["roofline_frac"])
    coll = max(rows, key=lambda r: r["collective_s"])
    print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
          f"({worst['roofline_frac']:.3g})")
    print(f"most collective-bound:  {coll['arch']}/{coll['shape']} "
          f"({coll['collective_s']:.3g}s)")


if __name__ == "__main__":
    main()
