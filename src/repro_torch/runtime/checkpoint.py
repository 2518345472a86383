"""Fault-tolerant checkpoints: atomic, async, keep-k (port of
``repro/runtime/checkpoint.py``, on the reference's on-disk layout, so
either package restores the other's checkpoints bit for bit).

  * A checkpoint is a directory ``step_<N>/`` holding one ``.npy`` per
    leaf of a tree of nested dicts, named by its ``/``-joined path in
    sorted-key order with ``__`` for ``/``, and ``manifest.json``:
    ``format: full-v1``, the step, the caller's metadata, every leaf's file,
    shape and true dtype, and ``crc32`` over the stored bytes in leaf order.
  * bfloat16 has no numpy dtype here (no ``ml_dtypes``): a bfloat16 leaf is
    stored as its ``uint16`` bit view (``t.view(torch.int16)``) and read
    back the same way, which is how the reference stores it too.
  * **Atomicity**: a save writes ``step_<N>.tmp-<pid>/`` and renames it into
    place; ``LATEST`` is written then renamed.  A crash mid-save leaves a
    ``.tmp-*`` directory that restore ignores and the next save removes.
  * **Async**: ``save_async`` copies the tree to host memory at once, then
    writes on a background thread; ``wait()`` joins it and raises what it
    raised, and a second save joins the first.
  * **Keep-k**: after a save only the newest ``keep`` steps stay (LATEST is
    moved before anything is deleted); a lost ``LATEST`` falls back to a
    scan of the directory.

Sharded trees (``runtime/sharding.ShardedTensor`` leaves) are saved as
whole leaves, so a checkpoint written on one mesh restores on another or
on one device; ``restore(..., shardings=)`` cuts the leaves back into
shards as it reads them.

Only one process writes (``should_write``); every process may restore.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import shutil
import threading
import time
import zlib

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_SEP = "/"


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} in sorted-key order, paths ``/``-joined."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
        return out
    return {prefix[:-len(_SEP)]: tree}


def _unflatten_into(template, leaves: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], leaves, f"{prefix}{k}{_SEP}")
                for k in sorted(template)}
    key = prefix[:-len(_SEP)]
    if key not in leaves:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    v = leaves[key]
    want = getattr(template, "shape", None)
    if want is not None and tuple(v.shape) != tuple(want):
        raise ValueError(
            f"leaf {key!r}: checkpoint shape {tuple(v.shape)} != model "
            f"{tuple(want)}")
    return v


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf as written to disk (a copy even of a CPU
    tensor: the optimizer updates its leaves in place while an async save
    writes): bfloat16 as its uint16 bits.  A ``ShardedTensor`` is
    gathered whole on the host, so the layout does not depend on the
    mesh."""
    from .sharding import gather, is_sharded
    if is_sharded(x):
        x = gather(x, "cpu")
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x, order="C")


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


@dataclasses.dataclass
class CheckpointManager:
    directory: str | os.PathLike
    keep: int = 3
    should_write: bool = True          # False on non-zero hosts

    def __post_init__(self):
        self.directory = pathlib.Path(self.directory)
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []
        #: {"step", "bytes", "seconds"} of every completed write
        self.writes: list[dict] = []
        if self.should_write:
            self.directory.mkdir(parents=True, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, metadata: dict | None = None) -> None:
        """Synchronous atomic save."""
        self._write(step, self._snapshot(tree), metadata or {})

    def save_async(self, step: int, tree, metadata: dict | None = None
                   ) -> None:
        """Copy to host memory now, write on a background thread."""
        self.wait()
        host = self._snapshot(tree)

        def work():
            try:
                self._write(step, host, metadata or {})
            except BaseException as e:  # raised again by wait()
                self._error.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    @staticmethod
    def _snapshot(tree) -> dict:
        """{path: (host array, true dtype)} in leaf order."""
        out = {}
        for key, leaf in _flatten(tree).items():
            dtype = (str(leaf.dtype).removeprefix("torch.")
                     if hasattr(leaf, "dtype") and
                     isinstance(leaf.dtype, torch.dtype)
                     else str(np.asarray(leaf).dtype))
            out[key] = (_to_host(leaf), dtype)
        return out

    def _write(self, step: int, host: dict, metadata: dict) -> None:
        if not self.should_write:
            return
        t0 = time.perf_counter()
        final = self.directory / f"step_{step}"
        tmp = self.directory / f"step_{step}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"format": "full-v1", "step": step, "metadata": metadata,
                    "leaves": {}}
        crc, nbytes = 0, 0
        for key, (arr, true_dtype) in host.items():
            fname = key.replace(_SEP, "__") + ".npy"
            np.save(tmp / fname, arr)
            crc = zlib.crc32(arr, crc)
            nbytes += arr.nbytes
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": true_dtype}
        manifest["crc32"] = crc
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._point_latest(step)
        self._gc()
        self.writes.append({"step": step, "bytes": nbytes,
                            "seconds": time.perf_counter() - t0})

    def _point_latest(self, step: int) -> None:
        ptr = self.directory / "LATEST"
        tmp = self.directory / f"LATEST.tmp-{os.getpid()}"
        tmp.write_text(str(step))
        os.rename(tmp, ptr)

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)
        for p in self.directory.glob("*.tmp-*"):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        if not self.directory.exists():
            return []
        out = []
        for p in self.directory.iterdir():
            m = _STEP_RE.match(p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        ptr = self.directory / "LATEST"
        if ptr.exists():
            s = int(ptr.read_text().strip())
            if (self.directory / f"step_{s}" / "manifest.json").exists():
                return s
        steps = self.all_steps()   # LATEST lost or torn: scan
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, device=None,
                verify: bool = False, shardings=None):
        """Restore into the structure of ``template`` (a tree of tensors or
        arrays with the leaves' shapes; meta tensors do).  Leaves come back
        as tensors of their stored dtype on ``device`` (the CPU by
        default).  ``shardings``: a tree of ``runtime.sharding.
        NamedSharding`` of the template's structure; each leaf is then
        read on the host and cut straight into its per-position shards
        (``ShardedTensor``; the reference's elastic ``device_put``), so no
        whole leaf is put on a card.  ``verify`` recomputes the crc.
        Returns (tree, step, metadata)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        d = self.directory / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        device = torch.device(device or "cpu")
        cuts = _flatten(shardings) if shardings is not None else {}
        leaves, crc = {}, 0
        for key, info in manifest["leaves"].items():
            arr = np.load(d / info["file"])
            if verify:
                crc = zlib.crc32(arr, crc)
            if key in cuts:
                from . import sharding as shd
                leaves[key] = shd.put(_to_tensor(arr, info["dtype"], "cpu"),
                                      cuts[key])
            else:
                leaves[key] = _to_tensor(arr, info["dtype"], device)
        if verify and crc != manifest.get("crc32"):
            raise IOError(f"checkpoint step_{step} failed crc verification")
        return (_unflatten_into(template, leaves), step,
                manifest.get("metadata", {}))
