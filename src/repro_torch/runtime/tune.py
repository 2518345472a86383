"""Persistent kernel-tuning cache (port of ``repro/runtime/tune.py``):
versioned, atomic, keyed by tuning key, kernel sources and card.

The tuner (``kernels/autotune.py``) times candidate launch plans on the
card, which takes seconds per key; the winners hold until the kernel
sources change or the card does, so serving loads them instead:

    <root>/<safe_key>__<card>-<SMs>sm.json
        {"format", "key", "kernels_fingerprint", "device": {"name", "sms"},
         "plan": {...}, "stats": {...}}

Writes go to a ``.tmp-<pid>`` file and ``os.replace`` into place; a load
checks the format, the key, the fingerprint of the port's kernel sources
(:func:`kernels_fingerprint`) and the card (its name and SM count), and
reads any mismatch, a torn or corrupt file as a miss (None), never as an
error.  A winner measured on another card is a miss, never a hit.

    python -m repro_torch.runtime.tune --root DIR --list | --stats |
        --evict KEY|all
    python -m repro_torch.runtime.tune --fingerprint
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re

FORMAT = "pud-tuning-v1"

#: The port's kernel sources whose bytes define a plan's validity: the
#: CUDA kernels, their host plans and the tuner and dispatch around them.
KERNEL_SOURCES = ("csrc/calib_iter.cu", "csrc/placed_gemm.cu",
                  "csrc/plane_gemm.cu", "csrc/simra_sense.cu",
                  "kernels/placed_gemm.py", "kernels/plane_gemm.py",
                  "kernels/autotune.py", "kernels/backends.py",
                  "kernels/ops.py")

PACKAGE = pathlib.Path(__file__).resolve().parents[1]


def kernels_fingerprint(package: str | os.PathLike | None = None) -> str:
    """Short hash of ``KERNEL_SOURCES`` under ``package`` (default: this
    package's directory)."""
    root = pathlib.Path(package) if package is not None else PACKAGE
    h = hashlib.sha256()
    for name in KERNEL_SOURCES:
        h.update(name.encode())
        h.update((root / name).read_bytes())
    return h.hexdigest()[:16]


def device_tag(device) -> dict:
    """{"name", "sms"} of a torch device: the card's name and SM count, or
    ``{"name": "cpu", "sms": 0}`` (no tuned plan is saved for it)."""
    import torch

    from repro_torch import devices
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": device.type, "sms": 0}
    return {"name": torch.cuda.get_device_name(device),
            "sms": devices.sm_count(device)}


def _safe_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


class TuningCache:
    """One directory of persisted tuning winners for one card, keyed by
    ``kernels.autotune.tuning_key`` strings.  ``device`` is a
    :func:`device_tag` dict; without one every load misses (inspection
    only)."""

    def __init__(self, directory: str | os.PathLike,
                 fingerprint: str | None = None, device: dict | None = None):
        self.directory = pathlib.Path(directory)
        self.fingerprint = fingerprint or kernels_fingerprint()
        self.device = dict(device) if device is not None else None

    def _path(self, key: str) -> pathlib.Path:
        dev = self.device or {"name": "none", "sms": 0}
        return self.directory / (f"{_safe_name(key)}__"
                                 f"{_safe_name(dev['name'])}-"
                                 f"{dev['sms']}sm.json")

    def save(self, key: str, plan, stats: dict | None = None
             ) -> pathlib.Path:
        """Persist one winner atomically; ``plan`` is a ``TunedPlan`` (or
        anything with ``to_dict``) or a field dict."""
        if self.device is None:
            raise ValueError("TuningCache.save needs the device the plan "
                             "was measured on")
        final = self._path(key)
        final.parent.mkdir(parents=True, exist_ok=True)
        for stale in final.parent.glob(final.name + ".tmp-*"):
            stale.unlink(missing_ok=True)     # crashed earlier saves
        entry = {
            "format": FORMAT,
            "key": key,
            "kernels_fingerprint": self.fingerprint,
            "device": self.device,
            "plan": plan.to_dict() if hasattr(plan, "to_dict") else dict(plan),
            "stats": stats or {},
        }
        tmp = final.with_name(final.name + f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps(entry, indent=1))
        os.replace(tmp, final)
        return final

    def load_entry(self, key: str) -> dict | None:
        """The raw entry, or None (a miss) when it is absent, torn or
        corrupt, or another format, key, kernel fingerprint or card."""
        if self.device is None:
            return None
        path = self._path(key)
        try:
            entry = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None
        if not isinstance(entry, dict) or entry.get("format") != FORMAT:
            return None
        if entry.get("key") != key or entry.get("device") != self.device:
            return None
        if entry.get("kernels_fingerprint") != self.fingerprint:
            return None                       # kernels changed: re-tune
        if not isinstance(entry.get("plan"), dict):
            return None
        return entry

    def load(self, key: str):
        """The persisted ``TunedPlan`` of ``key``, or None on any miss."""
        entry = self.load_entry(key)
        if entry is None:
            return None
        from repro_torch.kernels.autotune import TunedPlan
        try:
            return TunedPlan.from_dict(entry["plan"])
        except (TypeError, ValueError):       # unknown fields: stale entry
            return None

    def entries(self) -> list[dict]:
        """Every readable entry under the root, any card (invalid files
        skipped)."""
        out = []
        if not self.directory.exists():
            return out
        for path in sorted(self.directory.glob("*.json")):
            try:
                entry = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(entry, dict) and entry.get("format") == FORMAT:
                out.append(entry)
        return out

    def evict(self, key: str | None = None) -> int:
        """Drop one key's entries (every card's) or, with None, all of
        them; returns the number removed."""
        if not self.directory.exists():
            return 0
        pattern = "*.json" if key is None else f"{_safe_name(key)}__*.json"
        n = 0
        for path in self.directory.glob(pattern):
            path.unlink()
            n += 1
        return n

    def stats(self) -> dict:
        entries = self.entries()
        current = [e for e in entries
                   if e.get("kernels_fingerprint") == self.fingerprint]
        size = sum(f.stat().st_size for f in self.directory.glob("*.json")) \
            if self.directory.exists() else 0
        return {"entries": len(entries), "current": len(current),
                "stale": len(entries) - len(current), "bytes": size,
                "fingerprint": self.fingerprint}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.tune",
        description="Inspect a persistent kernel-tuning cache.")
    ap.add_argument("--root", metavar="DIR",
                    help="cache root (a session's <cache_dir>/tuning)")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--list", action="store_true",
                   help="one line per persisted tuning entry")
    g.add_argument("--stats", action="store_true",
                   help="counts and on-disk size")
    g.add_argument("--evict", metavar="KEY",
                   help="drop one tuning key ('all' drops every entry)")
    g.add_argument("--fingerprint", action="store_true",
                   help="print the kernel-source fingerprint and exit")
    args = ap.parse_args(argv)

    if args.fingerprint:
        print(kernels_fingerprint())
        return 0
    if not args.root:
        ap.error("--root is required for --list/--stats/--evict")
    cache = TuningCache(args.root)
    if args.evict:
        n = cache.evict(None if args.evict == "all" else args.evict)
        print(f"evicted {n} tuning entr{'y' if n == 1 else 'ies'}")
        return 0
    if args.list:
        entries = cache.entries()
        if not entries:
            print(f"no tuning entries under {cache.directory}")
            return 0
        for e in entries:
            stale = ("" if e.get("kernels_fingerprint") == cache.fingerprint
                     else "  [stale]")
            dev = e.get("device") or {}
            speed = e.get("stats", {}).get("speedup")
            speed = (f"  {speed:.2f}x" if isinstance(speed, (int, float))
                     else "")
            print(f"{e.get('key', '?'):<48s} {dev.get('name', '?')} "
                  f"({dev.get('sms', '?')} SMs) {json.dumps(e.get('plan'))}"
                  f"{speed}{stale}")
        return 0
    s = cache.stats()
    print(f"cache root       {cache.directory}")
    print(f"entries          {s['entries']}")
    print(f"current          {s['current']}")
    print(f"stale            {s['stale']}")
    print(f"on-disk size     {s['bytes'] / 1024:.1f} KiB")
    print(f"fingerprint      {s['fingerprint']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
