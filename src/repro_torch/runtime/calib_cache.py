"""Persistent per-device calibration tables (port of
``repro/runtime/calib_cache.py``, numpy only, the same ``fleet-calib-v2``
on-disk layout so either package reads what the other wrote):

  <root>/<device_id>/<table_key>/
      levels.npy        [G, n_cols] int32 ladder level per column
      ecr.npy           [G] float32 measured per-subarray ECR (optional)
      masks.npy         [G, n_cols] bool error-prone mask (optional)
      placements/       <name>.npz ``pud-placement-v2`` placements
      manifest.json     format, grid shape, frac_counts, params fingerprint,
                        crc32, metadata, calibration age block

Writes go to a ``.tmp-<pid>`` directory/file and are renamed into place;
loads report a miss (None) on any mismatch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import re
import shutil
import time
import zlib

import numpy as np

FORMAT = "fleet-calib-v2"


def params_fingerprint(params) -> str:
    """Stable hash of every physics constant that shapes the table."""
    blob = json.dumps(dataclasses.asdict(params), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def table_key(cfg, params) -> str:
    """Cache key: ladder configuration + grid shape + physics fingerprint."""
    frac = "".join(str(f) for f in cfg.frac_counts)
    shape = "x".join(str(s) for s in cfg.grid_shape + (cfg.n_cols,))
    return f"T{frac}__{shape}__{params_fingerprint(params)}"


@dataclasses.dataclass
class CalibrationTable:
    """One loaded cache entry."""

    device_id: str
    levels: np.ndarray                # [G, n_cols] int32
    ecr: np.ndarray | None            # [G] float32
    masks: np.ndarray | None          # [G, n_cols] bool (True = error-prone)
    metadata: dict
    calibrated_at: float | None = None       # wall time of identification
    assumed_temp_c: float | None = None      # operating temp the table assumes
    params_fingerprint: str | None = None    # physics fingerprint of the entry

    def age_days(self, now: float | None = None) -> float | None:
        """Days since identification, or None for an entry without age
        metadata."""
        if self.calibrated_at is None:
            return None
        return max(0.0, ((time.time() if now is None else now)
                         - self.calibrated_at) / 86400.0)


def _safe_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


class CalibrationTableCache:
    def __init__(self, directory: str | os.PathLike):
        self.directory = pathlib.Path(directory)

    def _entry_dir(self, device_id: str, cfg, params) -> pathlib.Path:
        return self.directory / device_id / table_key(cfg, params)

    def save(self, device_id: str, cfg, params, levels: np.ndarray,
             ecr: np.ndarray | None = None,
             masks: np.ndarray | None = None,
             metadata: dict | None = None,
             calibrated_at: float | None = None,
             assumed_temp_c: float | None = None) -> pathlib.Path:
        final = self._entry_dir(device_id, cfg, params)
        for stale in final.parent.glob(final.name + ".tmp-*"):
            shutil.rmtree(stale, ignore_errors=True)
        tmp = final.with_name(final.name + f".tmp-{os.getpid()}")
        tmp.mkdir(parents=True)
        levels = np.asarray(levels, np.int32)
        np.save(tmp / "levels.npy", levels)
        manifest = {
            "format": FORMAT,
            "device_id": device_id,
            "frac_counts": list(cfg.frac_counts),
            "grid_shape": list(cfg.grid_shape),
            "n_cols": cfg.n_cols,
            "params_fingerprint": params_fingerprint(params),
            "crc32": zlib.crc32(levels.tobytes()),
            "metadata": metadata or {},
            "calibration": {
                "calibrated_at": float(time.time() if calibrated_at is None
                                       else calibrated_at),
                "assumed_temp_c": (None if assumed_temp_c is None
                                   else float(assumed_temp_c)),
            },
        }
        if ecr is not None:
            np.save(tmp / "ecr.npy", np.asarray(ecr, np.float32))
        if masks is not None:
            np.save(tmp / "masks.npy", np.asarray(masks, bool))
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        final.parent.mkdir(parents=True, exist_ok=True)
        os.rename(tmp, final)
        return final

    def save_placement(self, device_id: str, cfg, params, name: str,
                       placement) -> pathlib.Path:
        """Persist one placement under its table entry (atomic replace)."""
        from repro_torch.pud.placement import save_placement_npz
        entry = self._entry_dir(device_id, cfg, params)
        if not (entry / "manifest.json").exists():
            raise FileNotFoundError(
                f"no calibration table for {device_id!r} at {entry}; "
                "save the table before its placements")
        d = entry / "placements"
        d.mkdir(exist_ok=True)
        final = d / f"{_safe_name(name)}.npz"
        for stale in d.glob(final.name + ".tmp-*"):
            stale.unlink(missing_ok=True)
        tmp = final.with_name(final.name + f".tmp-{os.getpid()}")
        save_placement_npz(tmp, placement)
        os.replace(tmp, final)
        return final

    def load(self, device_id: str, cfg, params,
             verify: bool = False) -> CalibrationTable | None:
        """Return the table, or None (miss) on absence or any mismatch."""
        d = self._entry_dir(device_id, cfg, params)
        manifest_path = d / "manifest.json"
        if not manifest_path.exists():
            return None
        try:
            manifest = json.loads(manifest_path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        if manifest.get("format") != FORMAT:
            return None
        if manifest.get("params_fingerprint") != params_fingerprint(params):
            return None
        if tuple(manifest.get("frac_counts", ())) != tuple(cfg.frac_counts):
            return None
        try:
            levels = np.load(d / "levels.npy")
        except (OSError, ValueError):
            return None
        want_shape = (cfg.n_subarrays_total, cfg.n_cols)
        if tuple(levels.shape) != want_shape:
            return None
        if verify and zlib.crc32(levels.tobytes()) != manifest.get("crc32"):
            return None
        ecr = None
        if (d / "ecr.npy").exists():
            try:
                ecr = np.load(d / "ecr.npy")
            except (OSError, ValueError):
                ecr = None
        masks = None
        if (d / "masks.npy").exists():
            try:
                masks = np.load(d / "masks.npy")
            except (OSError, ValueError):
                masks = None
            if masks is not None and tuple(masks.shape) != want_shape:
                masks = None
        calib = manifest.get("calibration") or {}
        return CalibrationTable(device_id=device_id, levels=levels, ecr=ecr,
                                masks=masks,
                                metadata=manifest.get("metadata", {}),
                                calibrated_at=calib.get("calibrated_at"),
                                assumed_temp_c=calib.get("assumed_temp_c"),
                                params_fingerprint=manifest.get(
                                    "params_fingerprint"))

    def load_placement(self, device_id: str, cfg, params, name: str):
        """One persisted Placement, or None on absence/corruption/mismatch."""
        from repro_torch.pud.placement import load_placement_npz
        path = (self._entry_dir(device_id, cfg, params) / "placements"
                / f"{_safe_name(name)}.npz")
        if not path.exists():
            return None
        placement = load_placement_npz(path)
        if placement is None:
            return None
        if (placement.n_cols_per_subarray != cfg.n_cols
                or placement.n_subarrays != cfg.n_subarrays_total):
            return None
        return placement

    def placements(self, device_id: str, cfg, params) -> list[str]:
        """Names of the placements persisted for one table entry."""
        d = self._entry_dir(device_id, cfg, params) / "placements"
        return sorted(p.stem for p in d.glob("*.npz")
                      if ".tmp-" not in p.name) if d.exists() else []

    # -- inspection ---------------------------------------------------------

    def entries(self) -> list[dict]:
        """Manifests of every valid entry under the cache root."""
        out = []
        if not self.directory.exists():
            return out
        for manifest in sorted(self.directory.glob("*/*/manifest.json")):
            if ".tmp-" in manifest.parent.name:   # crashed/in-flight save
                continue
            try:
                out.append(json.loads(manifest.read_text()))
            except (OSError, json.JSONDecodeError):
                continue
        return out

    def evict(self, device_id: str) -> int:
        """Drop every table of one device; returns the number removed."""
        d = self.directory / device_id
        if not d.exists():
            return 0
        n = sum(1 for m in d.glob("*/manifest.json")
                if ".tmp-" not in m.parent.name)
        shutil.rmtree(d)
        return n


# ---------------------------------------------------------------------------
# CLI: inspect/evict persisted device tables without writing any Python.
#
#     python -m repro_torch.runtime.calib_cache --root DIR --list
#     python -m repro_torch.runtime.calib_cache --root DIR --stats
#     python -m repro_torch.runtime.calib_cache --root DIR --evict DEVICE
#
# numpy only: an operator can inspect a serving host's cache from any
# Python, without torch or a GPU.
# ---------------------------------------------------------------------------


def _dir_bytes(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _entry_rows(root: pathlib.Path) -> list[dict]:
    rows = []
    for manifest in sorted(root.glob("*/*/manifest.json")):
        entry = manifest.parent
        if ".tmp-" in entry.name:
            continue
        try:
            m = json.loads(manifest.read_text())
        except (OSError, json.JSONDecodeError):
            m = {}
        placements = entry / "placements"
        rows.append({
            "calibrated_at": (m.get("calibration") or {}).get("calibrated_at"),
            "device_id": entry.parent.name,
            "table_key": entry.name,
            "format": m.get("format", "?"),
            "grid_shape": m.get("grid_shape"),
            "n_cols": m.get("n_cols"),
            "frac_counts": m.get("frac_counts"),
            "n_placements": (sum(1 for p in placements.glob("*.npz")
                                 if ".tmp-" not in p.name)
                             if placements.exists() else 0),
            "bytes": _dir_bytes(entry),
        })
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.calib_cache",
        description="Inspect a persistent calibration-table cache.")
    ap.add_argument("--root", required=True, metavar="DIR",
                    help="cache root (the --calib-cache directory)")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--list", action="store_true",
                   help="one line per persisted table entry")
    g.add_argument("--stats", action="store_true",
                   help="aggregate counts and on-disk size")
    g.add_argument("--evict", metavar="DEVICE",
                   help="drop every table of one device")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.root)
    if args.evict:
        n = CalibrationTableCache(root).evict(args.evict)
        print(f"evicted {n} table(s) of device {args.evict!r}")
        return 0
    rows = _entry_rows(root) if root.exists() else []
    if args.list:
        if not rows:
            print(f"no cache entries under {root}")
            return 0
        for r in rows:
            grid = "x".join(str(s) for s in (r["grid_shape"] or ["?"]))
            frac = "".join(str(f) for f in (r["frac_counts"] or ["?"]))
            at = r["calibrated_at"]
            age = (f"age {(time.time() - at) / 86400.0:.1f}d"
                   if at else "age unknown")
            print(f"{r['device_id']:<12s} {r['table_key']:<40s} "
                  f"{r['format']:<15s} grid {grid} x {r['n_cols']} cols "
                  f"T{frac}  {r['n_placements']} placement(s)  {age}  "
                  f"{r['bytes'] / 1024:.1f} KiB")
        return 0
    devices = {r["device_id"] for r in rows}
    print(f"cache root       {root}")
    print(f"devices          {len(devices)}")
    print(f"table entries    {len(rows)}")
    print(f"placements       {sum(r['n_placements'] for r in rows)}")
    print("on-disk size     "
          f"{(_dir_bytes(root) if root.exists() else 0) / 1024:.1f} KiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
