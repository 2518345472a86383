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
    calibrated_at: float | None = None
    assumed_temp_c: float | None = None
    params_fingerprint: str | None = None


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
