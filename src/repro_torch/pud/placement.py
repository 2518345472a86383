"""Physical column placement: calibration masks -> the serving layout
(port of ``repro/pud/placement.py``; numpy only, identical results).

``plan_placement`` maps every packed projection's logical columns onto
error-free physical columns of the ``(channel, bank, subarray)`` grid by
greedy first fit (consecutive usable columns, spilling into the next
subarray).  A tensor's N columns split into blocks of ``block_cols``; each
block's physical span, faulty columns included, becomes one window block,
padded to the per-tensor stride ``window_block``.  ``local_cols`` (what the
packs' ``col_ids`` store) are absolute window positions.

Persisted placements use the reference's ``pud-placement-v2`` npz format,
so either package reads what the other wrote.  ``shard_column_slices``
splits a tensor's columns among model shards on window-block boundaries
(host arithmetic, held by ``analysis/contracts.check_shard_slices``).

Fault injection models serving from the faulty device: ``corrupt_planes``
makes every bit stored on an error-prone window column read its stuck
value, ``inject_read_faults`` does so for every placed pack of a serving
tree, and ``refresh_fault_state`` re-reads the windows' fault state from
new masks.  With ``avoid_faulty=True`` no ``col_ids`` entry addresses a
corrupted column, so decoding is bit-identical; the identity layout
computes on faulty columns and breaks.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import zipfile

import numpy as np
import torch

from repro_torch.kernels.ops import N_BLOCK, largest_divisor

PLACEMENT_FORMAT = "pud-placement-v2"

#: Logical columns per window block: the kernels' N tile.
PLACE_BLOCK = N_BLOCK


class PlacementError(RuntimeError):
    """Raised when the error-free capacity cannot hold the requested layout."""


@dataclasses.dataclass(frozen=True)
class PlacementRequest:
    """Column demand of one packable projection."""

    name: str                 # tensor path, e.g. "layers_0_dense/mixer/wi"
    n_cols: int               # logical (output) columns per slice
    n_slices: int = 0         # leading stacked-layer count; 0 = unstacked
    block_cols: int = 0       # forced window-block width; 0 = derive

    @property
    def total_cols(self) -> int:
        return self.n_cols * max(1, self.n_slices)


def requests_fingerprint(requests: list[PlacementRequest]) -> str:
    """Stable short hash of a request list (keys persisted placements)."""
    blob = json.dumps([
        (r.name, r.n_cols, r.n_slices) if not r.block_cols
        else (r.name, r.n_cols, r.n_slices, r.block_cols)
        for r in requests])
    return hashlib.sha256(blob.encode()).hexdigest()[:10]


def shard_column_slices(n_cols: int,
                        n_shards: int) -> tuple[tuple[tuple[int, int], ...],
                                                int]:
    """Split a tensor's N columns across model shards on block boundaries.

    Returns ``(((lo, hi), ...), block_cols)``: one half-open column span
    per shard and the block width the split keeps whole, the full tensor's
    ``largest_divisor(n_cols, PLACE_BLOCK)`` (the unsharded allocator's).
    Every shard owns whole window blocks, earlier shards taking the
    remainder blocks; with fewer blocks than shards the last shards own
    none.  ``analysis/contracts.check_shard_slices`` checks the result.
    """
    if n_cols <= 0 or n_shards <= 0:
        raise PlacementError(
            f"shard_column_slices needs positive n_cols/n_shards, got "
            f"{n_cols}/{n_shards}")
    block_cols = largest_divisor(n_cols, PLACE_BLOCK)
    base, extra = divmod(n_cols // block_cols, n_shards)
    spans, lo = [], 0
    for i in range(n_shards):
        hi = lo + (base + (1 if i < extra else 0)) * block_cols
        spans.append((lo, hi))
        lo = hi
    return tuple(spans), block_cols


@dataclasses.dataclass
class TensorPlacement:
    """Column index maps of one placed tensor (block-aligned windows).

    Unstacked tensors use ``[N]`` maps, stacked ones ``[L, N]``.
    """

    phys_cols: np.ndarray      # [L?, N] int32 global physical column ids
    block_cols: int            # logical columns per block
    window_block: int          # window stride per block (>= max span)
    block_starts: np.ndarray   # [L?, NB] int32 physical origin per block
    faulty: np.ndarray         # [L?, W] bool — error-prone cols in window
    stuck: np.ndarray          # [L?, W] int8 — read value of faulty cols

    @property
    def n_blocks(self) -> int:
        return self.block_starts.shape[-1]

    @property
    def region_size(self) -> int:
        """Materialized window length W = n_blocks * window_block."""
        return self.n_blocks * self.window_block

    @property
    def local_cols(self) -> np.ndarray:
        """[L?, N] absolute window positions (what ``col_ids`` store)."""
        n = self.phys_cols.shape[-1]
        blk = np.arange(n) // self.block_cols
        base = (blk * self.window_block).astype(np.int64)
        if self.phys_cols.ndim == 1:
            starts = self.block_starts[blk]
        else:
            starts = self.block_starts[:, blk]
        return (base + self.phys_cols - starts).astype(np.int32)


@dataclasses.dataclass
class Placement:
    """Device-wide placement: per-tensor maps + capacity accounting."""

    entries: dict[str, TensorPlacement]
    grid_shape: tuple[int, int, int]
    n_cols_per_subarray: int
    used_per_subarray: np.ndarray      # [G] int32 columns holding weights
    usable_per_subarray: np.ndarray    # [G] int32 allocatable columns
    avoid_faulty: bool

    @property
    def n_subarrays(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def used_total(self) -> int:
        return int(self.used_per_subarray.sum())

    @property
    def usable_total(self) -> int:
        return int(self.usable_per_subarray.sum())

    @property
    def occupancy(self) -> float:
        """Fraction of allocatable (error-free) columns holding weights."""
        return self.used_total / max(1, self.usable_total)

    @property
    def spilled_tensors(self) -> list[str]:
        """Tensors whose slices cross a subarray boundary."""
        n = self.n_cols_per_subarray
        return [name for name, tp in self.entries.items()
                if (tp.phys_cols // n).min() != (tp.phys_cols // n).max()]

    def capacity_report(self) -> dict:
        used = self.used_per_subarray
        return {
            "n_subarrays": self.n_subarrays,
            "n_cols_per_subarray": self.n_cols_per_subarray,
            "usable_cols": self.usable_total,
            "used_cols": self.used_total,
            "occupancy": self.occupancy,
            "occupied_subarrays": int((used > 0).sum()),
            "spilled_tensors": self.spilled_tensors,
            "avoid_faulty": self.avoid_faulty,
        }


# ---------------------------------------------------------------------------
# Allocator
# ---------------------------------------------------------------------------


def _stuck_values(global_cols: np.ndarray,
                  sense_offsets: np.ndarray | None) -> np.ndarray:
    """Stuck read value of faulty columns: negative offset reads 1; from a
    warm cache (no offsets) a deterministic per-column value."""
    if sense_offsets is not None:
        flat = np.asarray(sense_offsets).reshape(-1)
        return (flat[global_cols] < 0).astype(np.int8)
    return (global_cols % 2).astype(np.int8)


def _slice_blocks(cols: np.ndarray, block_cols: int):
    """Split one slice's columns into blocks; returns (starts, spans)."""
    nb = cols.size // block_cols
    chunks = cols.reshape(nb, block_cols)
    starts = chunks[:, 0].astype(np.int64)
    spans = (chunks[:, -1] - chunks[:, 0] + 1).astype(np.int64)
    return starts, spans


def _window_masks(starts: np.ndarray, spans: np.ndarray, window_block: int,
                  flat_faulty: np.ndarray,
                  sense_offsets) -> tuple[np.ndarray, np.ndarray]:
    """Faulty/stuck masks of one slice's materialized window.

    Window position j*window_block + t backs physical column starts[j] + t
    when t < spans[j]; positions past a block's span are pure padding.
    """
    nb = starts.size
    n_total = flat_faulty.size
    faulty = np.zeros(nb * window_block, bool)
    stuck = np.zeros(nb * window_block, np.int8)
    for j in range(nb):
        t = np.arange(min(int(spans[j]), window_block), dtype=np.int64)
        phys = starts[j] + t
        t = t[phys < n_total]
        phys = phys[phys < n_total]
        faulty[j * window_block + t] = flat_faulty[phys]
        stuck[j * window_block + t] = _stuck_values(phys, sense_offsets)
    return faulty, stuck


def plan_placement(masks, requests: list[PlacementRequest], *,
                   avoid_faulty: bool = True,
                   sense_offsets=None) -> Placement:
    """Greedy first-fit allocation of every request onto the column grid.

    ``masks`` [G, n_cols] bool (True = error-prone).  ``avoid_faulty=False``
    builds the identity layout.  Raises ``PlacementError`` when demand
    exceeds usable capacity.
    """
    masks = np.asarray(masks, bool)
    g, n_cols = masks.shape
    flat_faulty = masks.reshape(-1)
    if avoid_faulty:
        usable_ids = np.nonzero(~flat_faulty)[0].astype(np.int64)
    else:
        usable_ids = np.arange(g * n_cols, dtype=np.int64)

    demand = sum(r.total_cols for r in requests)
    if demand > usable_ids.size:
        raise PlacementError(
            f"placement demand {demand} columns exceeds usable capacity "
            f"{usable_ids.size} ({g} subarrays x {n_cols} cols, "
            f"avoid_faulty={avoid_faulty})")

    entries: dict[str, TensorPlacement] = {}
    cursor = 0
    for req in requests:
        n_slices = max(1, req.n_slices)
        block_cols = req.block_cols or largest_divisor(req.n_cols,
                                                       PLACE_BLOCK)
        if block_cols > PLACE_BLOCK or req.n_cols % block_cols:
            raise PlacementError(
                f"request {req.name!r}: forced block_cols {block_cols} "
                f"must divide n_cols {req.n_cols} and stay within "
                f"PLACE_BLOCK {PLACE_BLOCK}")
        slice_cols, slice_starts, slice_spans = [], [], []
        for _ in range(n_slices):
            cols = usable_ids[cursor:cursor + req.n_cols]
            cursor += req.n_cols
            starts, spans = _slice_blocks(cols, block_cols)
            slice_cols.append(cols.astype(np.int32))
            slice_starts.append(starts)
            slice_spans.append(spans)
        window_block = int(max(s.max() for s in slice_spans))

        faulty, stuck = [], []
        for starts, spans in zip(slice_starts, slice_spans):
            f, s = _window_masks(starts, spans, window_block, flat_faulty,
                                 sense_offsets)
            faulty.append(f)
            stuck.append(s)

        if req.n_slices:
            tp = TensorPlacement(
                phys_cols=np.stack(slice_cols),
                block_cols=block_cols, window_block=window_block,
                block_starts=np.stack(slice_starts).astype(np.int32),
                faulty=np.stack(faulty), stuck=np.stack(stuck))
        else:
            tp = TensorPlacement(
                phys_cols=slice_cols[0],
                block_cols=block_cols, window_block=window_block,
                block_starts=slice_starts[0].astype(np.int32),
                faulty=faulty[0], stuck=stuck[0])
        entries[req.name] = tp

    used = np.zeros(g * n_cols, bool)
    used[usable_ids[:cursor]] = True
    usable_per = (~masks).sum(axis=1) if avoid_faulty \
        else np.full(g, n_cols)
    return Placement(
        entries=entries,
        grid_shape=(1, 1, g),
        n_cols_per_subarray=n_cols,
        used_per_subarray=used.reshape(g, n_cols).sum(axis=1)
                              .astype(np.int32),
        usable_per_subarray=np.asarray(usable_per, np.int32),
        avoid_faulty=avoid_faulty,
    )


def plan_for_grid(masks, requests, grid_shape, **kw) -> Placement:
    """``plan_placement`` with the true (channels, banks, subarrays) shape."""
    p = plan_placement(masks, requests, **kw)
    return dataclasses.replace(p, grid_shape=tuple(grid_shape))


def refresh_fault_state(placement: Placement, masks,
                        sense_offsets=None) -> Placement:
    """Every entry's faulty / stuck window masks recomputed from new
    ``masks`` [G, C] (drift changes which columns err, not where tensors
    live).  The column maps and the capacity accounting stay as planned."""
    flat_faulty = np.asarray(masks, bool).reshape(-1)
    entries: dict[str, TensorPlacement] = {}
    for name, tp in placement.entries.items():
        stacked = tp.phys_cols.ndim == 2
        slices = tp.phys_cols if stacked else tp.phys_cols[None]
        faulty, stuck = [], []
        for cols in slices:
            starts, spans = _slice_blocks(np.asarray(cols, np.int64),
                                          tp.block_cols)
            f, s = _window_masks(starts, spans, tp.window_block,
                                 flat_faulty, sense_offsets)
            faulty.append(f)
            stuck.append(s)
        entries[name] = dataclasses.replace(
            tp, faulty=np.stack(faulty) if stacked else faulty[0],
            stuck=np.stack(stuck) if stacked else stuck[0])
    return dataclasses.replace(placement, entries=entries)


def corrupt_planes(planes: torch.Tensor, tp: TensorPlacement
                   ) -> torch.Tensor:
    """``planes`` [L?, WB, K(/8), W] with every bit on an error-prone
    window column of ``tp`` replaced by its stuck read (every plane and
    row of the column).  Bit-packed words of a stuck-1 column read 0xFF,
    of a stuck-0 column 0x00."""
    dev = planes.device
    faulty = torch.from_numpy(np.asarray(tp.faulty, bool)).to(dev)
    stuck = torch.from_numpy(np.asarray(tp.stuck, np.int8)).to(dev)
    if planes.dtype == torch.uint8:
        stuck = stuck.to(torch.uint8) * 0xFF
    else:
        stuck = stuck.to(planes.dtype)
    return torch.where(faulty[..., None, None, :],
                       stuck[..., None, None, :], planes)


def inject_read_faults(packed_params: dict, placement: Placement) -> dict:
    """A copy of the serving tree ``packed_params`` (``pack_model``'s
    ``params``) with the planes of every placed pack corrupted by
    ``corrupt_planes``; unplaced packs and other leaves are shared."""
    from .packed import as_packed_tensor, is_pack

    def walk(tree, path):
        out = {}
        for key, sub in tree.items():
            if key.endswith("_pud") and is_pack(sub) \
                    and sub.get("col_ids") is not None:
                name = "/".join(path + (key[: -len("_pud")],))
                tp = placement.entries.get(name)
                if tp is None:
                    raise KeyError(
                        f"packed tensor {name!r} has no placement entry "
                        f"(have: {sorted(placement.entries)})")
                pt = as_packed_tensor(sub)
                out[key] = pt.replace(planes=corrupt_planes(pt.planes, tp))
            elif isinstance(sub, dict):
                out[key] = walk(sub, path + (key,))
            else:
                out[key] = sub
        return out

    return walk(packed_params, ())


# ---------------------------------------------------------------------------
# Serialization (used by runtime/calib_cache.py)
# ---------------------------------------------------------------------------


def save_placement_npz(path, placement: Placement) -> None:
    """Write a Placement to ``path`` as a single .npz (no pickle)."""
    meta = {
        "format": PLACEMENT_FORMAT,
        "names": list(placement.entries),
        "block_cols": [placement.entries[n].block_cols
                       for n in placement.entries],
        "window_blocks": [placement.entries[n].window_block
                          for n in placement.entries],
        "grid_shape": list(placement.grid_shape),
        "n_cols_per_subarray": placement.n_cols_per_subarray,
        "avoid_faulty": placement.avoid_faulty,
    }
    arrays = {
        "meta": np.array(json.dumps(meta)),
        "used": np.asarray(placement.used_per_subarray, np.int32),
        "usable": np.asarray(placement.usable_per_subarray, np.int32),
    }
    for i, name in enumerate(placement.entries):
        tp = placement.entries[name]
        arrays[f"e{i}_phys"] = np.asarray(tp.phys_cols, np.int32)
        arrays[f"e{i}_start"] = np.asarray(tp.block_starts, np.int32)
        arrays[f"e{i}_faulty"] = np.asarray(tp.faulty, bool)
        arrays[f"e{i}_stuck"] = np.asarray(tp.stuck, np.int8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_placement_npz(path) -> Placement | None:
    """Read a v2 Placement back; None on any corruption or format mismatch."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("format") != PLACEMENT_FORMAT:
                return None
            entries = {}
            for i, name in enumerate(meta["names"]):
                entries[name] = TensorPlacement(
                    phys_cols=z[f"e{i}_phys"],
                    block_cols=int(meta["block_cols"][i]),
                    window_block=int(meta["window_blocks"][i]),
                    block_starts=z[f"e{i}_start"],
                    faulty=z[f"e{i}_faulty"],
                    stuck=z[f"e{i}_stuck"])
            return Placement(
                entries=entries,
                grid_shape=tuple(meta["grid_shape"]),
                n_cols_per_subarray=int(meta["n_cols_per_subarray"]),
                used_per_subarray=z["used"],
                usable_per_subarray=z["usable"],
                avoid_faulty=bool(meta["avoid_faulty"]))
    except (OSError, ValueError, KeyError, EOFError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return None
