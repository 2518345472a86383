"""Typed packs: the PUD serving weight format (port of ``repro/pud/packed.py``).

``PackedTensor`` is one projection in the bit-plane layout: WB planes over
columns, the per-output-channel dequant scale and, when placed, the
``col_ids`` gather map into the physical window.  ``PackedModel`` is a whole
serving tree (bf16 leaves plus ``<name>_pud`` packs) with its packing
metadata.  The port builds typed packs only; ``as_packed_tensor`` reads a
reference-style ``{"planes", "scale", "col_ids"?}`` mapping into one.

``ShardedPackedTensor`` is one projection split column-wise over the
"model" axis of a serving mesh: one ``PackedTensor`` per shard, each on its
own device, padded to a common per-device shape.

``save_packed_npz`` / ``load_packed_npz`` keep the reference's
``pud-pack-v2`` archive, so either package reads what the other wrote.
A pack's autotuned launch plans (``tile_plan``, ``kernels/autotune``) are
the port's own: the reference's loader reads any non-null ``tile_plan``
through its ``TunedTile``, which refuses the port's fields and would turn
the whole archive into a miss.  So the entry keeps ``"tile_plan": null``
and the port writes its plans under ``PLAN_KEY``, which the reference
ignores; the port reads a reference archive's ``tile_plan`` as None.
"""
from __future__ import annotations

import dataclasses
import json
import zipfile

import numpy as np
import torch

_FIELDS = ("planes", "scale", "col_ids")

LAYOUT_DENSE = "dense"        # [L?, WB, K, N/W] int8, one byte per bit
LAYOUT_BITPACK = "bitpack8"   # [L?, WB, ceil(K/8), N/W] uint8, 8 bits/byte

#: .npz archive tag.  The loader also reads "pud-pack-v1", the dense-era
#: archives without per-entry layout metadata (each pack's layout follows
#: its plane dtype).
PACK_FORMAT = "pud-pack-v2"

#: Archive entry key of the port's launch plans (the reference's own
#: ``tile_plan`` stays null)
PLAN_KEY = "repro_torch_tile_plan"


@dataclasses.dataclass(eq=False)
class PackedTensor:
    """One projection in the PUD bit-plane layout.

    planes   [L?, WB, Kw, N|W]  uint8 words (bitpack8) or int8 bits (dense)
    scale    [L?, N]            float32 per-output-channel dequant scale
    col_ids  [L?, N]            int32 logical -> window column map, or None
    backend       execution backend stamped by the packer
    layout        plane storage format tag
    logical_k     K before byte padding (bitpack8 only)
    window_block  placed packs: window columns per logical N block
    tile_plan     autotuned launch plans (``kernels/autotune.py``): a
                  ``TunedPlan`` for every call or ``(row class, TunedPlan)``
                  pairs, stamped by ``PUDSession.tune``; None: heuristic
    """

    planes: torch.Tensor
    scale: torch.Tensor
    col_ids: torch.Tensor | None = None
    backend: str | None = None
    layout: str = LAYOUT_DENSE
    logical_k: int | None = None
    window_block: int | None = None
    tile_plan: object | None = None

    @property
    def placed(self) -> bool:
        return self.col_ids is not None

    @property
    def bitpacked(self) -> bool:
        return self.layout == LAYOUT_BITPACK

    @property
    def n_bits(self) -> int:
        return self.planes.shape[-3]

    @property
    def k(self) -> int:
        """Logical reduction length (un-padded K)."""
        if self.layout == LAYOUT_BITPACK:
            return self.logical_k or self.planes.shape[-2] * 8
        return self.planes.shape[-2]

    @property
    def n(self) -> int:
        return self.scale.shape[-1]

    @property
    def stored_bytes(self) -> int:
        total = self.planes.numel() * self.planes.element_size()
        total += self.scale.numel() * self.scale.element_size()
        if self.col_ids is not None:
            total += self.col_ids.numel() * self.col_ids.element_size()
        return total

    @property
    def dense_equiv_bytes(self) -> int:
        """Bytes of the same pack in the dense one-byte-per-bit layout."""
        shape = self.planes.shape
        k_axis = self.k if self.layout == LAYOUT_BITPACK else shape[-2]
        lead = 1
        for d in shape[:-2]:
            lead *= int(d)
        total = lead * k_axis * shape[-1]
        total += self.scale.numel() * self.scale.element_size()
        if self.col_ids is not None:
            total += self.col_ids.numel() * self.col_ids.element_size()
        return total

    def replace(self, **kw) -> "PackedTensor":
        return dataclasses.replace(self, **kw)

    def get(self, key: str, default=None):
        """The mapping view of the reference's packs: ``planes``,
        ``scale`` or ``col_ids``, or ``default`` where it is absent."""
        value = getattr(self, key) if key in _FIELDS else None
        return default if value is None else value

    def keys(self) -> tuple[str, ...]:
        return tuple(f for f in _FIELDS if getattr(self, f) is not None)

    def items(self) -> tuple:
        return tuple((k, getattr(self, k)) for k in self.keys())

    def layer(self, index: int) -> "PackedTensor":
        """Slice of a stacked pack at one layer (what the reference's layer
        ``lax.scan`` hands each iteration)."""
        return self.replace(
            planes=self.planes[index], scale=self.scale[index],
            col_ids=None if self.col_ids is None else self.col_ids[index])


@dataclasses.dataclass(eq=False)
class ShardedPackedTensor:
    """One projection split column-wise across the "model" axis of a mesh.

    Shard ``s`` owns the whole placement windows of logical columns
    ``[lo_s, hi_s)`` (``shard_widths[s]`` wide, a multiple of
    ``block_cols``; ``pud.placement.shard_column_slices``), packed with that
    shard's own calibration and placement state.  ``shards[s]`` is that
    pack, a ``PackedTensor`` on ``devices[s]``, padded to the common
    per-device shape of the reference's stacked children:

      planes   [L?, WB, Kw, R]  R = the common padded window (placed) or
                                the padded column count (logical layout)
      scale    [L?, Np]         Np = the widest shard, padded with 1.0
      col_ids  [L?, Np]         padded entries point at their own
                                (zero-plane) window block, or None

    Padding columns back zero planes and are sliced away after each
    shard's GEMM; a zero-width shard (fewer blocks than shards) is all
    padding and runs nothing.  ``stacked()`` gives the reference's
    ``[L?, S, ...]`` arrays.  ``devices`` is None for a pack built without
    a mesh, which packs but does not execute (as the reference's pack
    without a mesh).
    """

    shards: tuple[PackedTensor, ...]
    shard_widths: tuple[int, ...] = ()
    block_cols: int = 0
    backend: str | None = None
    layout: str = LAYOUT_BITPACK
    logical_k: int | None = None
    window_block: int | None = None
    tile_plan: object | None = None
    devices: tuple | None = None

    @property
    def placed(self) -> bool:
        return self.shards[0].col_ids is not None

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_bits(self) -> int:
        return self.shards[0].n_bits

    @property
    def k(self) -> int:
        return self.shards[0].k

    @property
    def n(self) -> int:
        """Logical output columns across all shards (un-padded)."""
        return sum(self.shard_widths)

    n_cols = n

    @property
    def padded_n(self) -> int:
        """Np: the per-shard padded column count each device computes."""
        return self.shards[0].n

    @property
    def stored_bytes(self) -> int:
        return sum(s.stored_bytes for s in self.shards)

    @property
    def dense_equiv_bytes(self) -> int:
        return sum(s.dense_equiv_bytes for s in self.shards)

    def replace(self, **kw) -> "ShardedPackedTensor":
        return dataclasses.replace(self, **kw)

    def map_shards(self, fn, **kw) -> "ShardedPackedTensor":
        """The same pack with ``fn`` applied to every shard."""
        return self.replace(shards=tuple(fn(s) for s in self.shards), **kw)

    def layer(self, index: int) -> "ShardedPackedTensor":
        """Layer ``index`` of a stacked pack, every shard kept: the
        reference's layer scan slices ``[L, S, ...]`` to ``[S, ...]``."""
        return self.map_shards(lambda s: s.layer(index))

    def stacked(self) -> tuple:
        """(planes [L?, S, WB, Kw, R], scale [L?, S, Np], col_ids [L?, S,
        Np] or None) on the CPU: the reference's stacked children."""
        def stack(name):
            parts = [getattr(s, name) for s in self.shards]
            if parts[0] is None:
                return None
            return torch.stack([p.cpu() for p in parts],
                               dim=parts[0].dim() - (3 if name == "planes"
                                                     else 1))
        return stack("planes"), stack("scale"), stack("col_ids")


def is_pack(value) -> bool:
    """Is ``value`` a pack: a ``PackedTensor``, a ``ShardedPackedTensor``
    or a mapping that holds planes and a scale?"""
    if isinstance(value, (PackedTensor, ShardedPackedTensor)):
        return True
    return isinstance(value, dict) and "planes" in value and "scale" in value


def as_packed_tensor(pack) -> PackedTensor:
    """A ``PackedTensor`` (or ``ShardedPackedTensor``) passes through; a
    ``{"planes", "scale", "col_ids"?}`` mapping becomes one.  A mapping
    carries no layout tag, so the plane dtype decides: uint8 planes are
    bit-packed words (logical K = Kw * 8), anything else the dense
    one-byte-per-bit layout."""
    if isinstance(pack, (PackedTensor, ShardedPackedTensor)):
        return pack
    planes = pack["planes"]
    layout = LAYOUT_BITPACK if planes.dtype == torch.uint8 else LAYOUT_DENSE
    return PackedTensor(planes=planes, scale=pack["scale"],
                        col_ids=pack.get("col_ids"), layout=layout)


def _per_layer(fn, planes: torch.Tensor) -> torch.Tensor:
    """``fn`` on [WB, ., N] planes, or on each layer of stacked [L, WB, .,
    N] planes."""
    if planes.dim() == 4:
        return torch.stack([fn(p) for p in planes])
    return fn(planes)


def to_dense(pt) -> PackedTensor:
    """Bit-exact conversion to the dense one-byte-per-bit layout (tuned
    plans are per layout, so a converted pack carries none)."""
    from repro_torch.kernels.ref import unpack_plane_words
    pt = as_packed_tensor(pt)
    if pt.layout == LAYOUT_DENSE:
        return pt
    if isinstance(pt, ShardedPackedTensor):
        return pt.map_shards(to_dense, layout=LAYOUT_DENSE, logical_k=None,
                             tile_plan=None)
    dense = _per_layer(lambda w: unpack_plane_words(w, pt.k), pt.planes)
    return pt.replace(planes=dense.contiguous(), layout=LAYOUT_DENSE,
                      logical_k=None, tile_plan=None)


def to_bitpacked(pt) -> PackedTensor:
    """Bit-exact conversion of a dense pack to bit-packed words."""
    from repro_torch.kernels.ref import pack_plane_words
    pt = as_packed_tensor(pt)
    if pt.layout == LAYOUT_BITPACK:
        return pt
    if isinstance(pt, ShardedPackedTensor):
        return pt.map_shards(to_bitpacked, layout=LAYOUT_BITPACK,
                             logical_k=pt.k, tile_plan=None)
    words = _per_layer(pack_plane_words, pt.planes)
    return pt.replace(planes=words, layout=LAYOUT_BITPACK,
                      logical_k=pt.planes.shape[-2], tile_plan=None)


@dataclasses.dataclass(eq=False)
class PackedModel:
    """A whole serving tree packed for the PUD path."""

    params: dict
    packed_names: tuple[str, ...] = ()
    skipped_names: tuple[str, ...] = ()
    weight_bits: int = 4
    placed: bool = False

    @property
    def report(self) -> dict:
        return {"packed": list(self.packed_names),
                "skipped": list(self.skipped_names),
                "bits": self.weight_bits, "placed": self.placed}

    @property
    def tensors(self) -> dict[str, PackedTensor]:
        """Flat view: tensor path -> its pack (computed once)."""
        cached = self.__dict__.get("_tensors")
        if cached is not None:
            return cached
        out: dict[str, PackedTensor] = {}

        def walk(tree, path):
            for key, sub in tree.items():
                if key.endswith("_pud") and isinstance(
                        sub, (PackedTensor, ShardedPackedTensor)):
                    out["/".join(path + (key[: -len("_pud")],))] = sub
                elif isinstance(sub, dict):
                    walk(sub, path + (key,))

        walk(self.params, ())
        self.__dict__["_tensors"] = out
        return out

    def tensor(self, name: str) -> PackedTensor:
        """One pack by its report name or a unique path suffix."""
        return self.tensors[self.name_of(name)]

    def name_of(self, name: str) -> str:
        """The report name of a pack named by itself or a unique path
        suffix."""
        tensors = self.tensors
        if name in tensors:
            return name
        hits = [k for k in tensors if k.endswith(name)]
        if len(hits) == 1:
            return hits[0]
        raise KeyError(
            f"packed tensor {name!r} "
            + (f"is ambiguous: {sorted(hits)}" if hits
               else f"not found (have: {sorted(tensors)})"))


def packed_bytes(params) -> dict:
    """Storage accounting: bf16 bytes vs packed bit-plane bytes."""
    if isinstance(params, PackedModel):
        params = params.params
    stats = {"bf16_bytes": 0, "stored_bytes": 0, "dense_equiv_bytes": 0}

    def walk(tree):
        for k, v in tree.items():
            if k.endswith("_pud") and isinstance(
                    v, (PackedTensor, ShardedPackedTensor)):
                stats["stored_bytes"] += v.stored_bytes
                stats["dense_equiv_bytes"] += v.dense_equiv_bytes
            elif isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                stats["bf16_bytes"] += v.numel() * v.element_size()

    walk(params)
    return stats


# ---------------------------------------------------------------------------
# Serialization: one .npz per PackedModel (versioned, no pickle)
# ---------------------------------------------------------------------------


def plan_to_json(tile_plan):
    """TunedPlan | ((class, TunedPlan), ...) | None -> a JSON value."""
    if tile_plan is None:
        return None
    if hasattr(tile_plan, "to_dict"):
        return tile_plan.to_dict()
    return [[cls, plan.to_dict()] for cls, plan in tile_plan]


def plan_from_json(value):
    """The inverse of :func:`plan_to_json`; unknown fields raise."""
    if value is None:
        return None
    from repro_torch.kernels.autotune import TunedPlan
    if isinstance(value, dict):
        return TunedPlan.from_dict(value)
    return tuple((cls, TunedPlan.from_dict(d)) for cls, d in value)


def save_packed_npz(path, pm: PackedModel) -> None:
    """Write a ``PackedModel``'s packs to ``path`` as one ``pud-pack-v2``
    .npz with per-tensor layout metadata and the port's launch plans
    (under ``PLAN_KEY``).  Only the packed projections serialize; the bf16
    leaves are not part of the archive.  A sharded pack writes its
    stacked ``[L?, S, ...]`` arrays, as the reference's does (and loads
    back, as there, as one ``PackedTensor`` of that geometry)."""
    tensors = pm.tensors
    meta = {
        "format": PACK_FORMAT,
        "names": list(tensors),
        "weight_bits": pm.weight_bits,
        "placed": pm.placed,
        "entries": {
            name: {"layout": pt.layout, "logical_k": pt.logical_k,
                   "window_block": pt.window_block, "backend": pt.backend,
                   "tile_plan": None,
                   PLAN_KEY: plan_to_json(pt.tile_plan)}
            for name, pt in tensors.items()
        },
    }
    arrays = {"meta": np.array(json.dumps(meta))}
    for i, pt in enumerate(tensors.values()):
        if isinstance(pt, ShardedPackedTensor):
            planes, scale, col_ids = pt.stacked()
        else:
            planes, scale, col_ids = pt.planes, pt.scale, pt.col_ids
        arrays[f"t{i}_planes"] = planes.cpu().numpy()
        arrays[f"t{i}_scale"] = scale.cpu().numpy()
        if col_ids is not None:
            arrays[f"t{i}_col_ids"] = col_ids.cpu().numpy().astype(np.int32)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_packed_npz(path, device=None) -> dict[str, PackedTensor] | None:
    """Read an archive's packs back as {name: PackedTensor} on ``device``
    (default the GPU; raises without one).  A ``pud-pack-v1`` archive
    loads with each pack's layout taken from its plane dtype; an unknown
    format tag or a corrupt file reads as None.  A recorded backend the
    port does not have (the reference's ``pallas``) loads as None, the
    default; so does the reference's ``tile_plan`` (its ``TunedTile``
    names TPU tiles).  The port's plans load from ``PLAN_KEY``."""
    from repro_torch.devices import resolve_device
    from repro_torch.kernels.backends import backend_names
    device = resolve_device(device)
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("format") not in (PACK_FORMAT, "pud-pack-v1"):
                return None
            entries = meta.get("entries", {})
            out = {}
            for i, name in enumerate(meta["names"]):
                planes = torch.from_numpy(z[f"t{i}_planes"]).to(device)
                col_ids = (torch.from_numpy(z[f"t{i}_col_ids"]).to(device)
                           if f"t{i}_col_ids" in z else None)
                pt = PackedTensor(
                    planes=planes,
                    scale=torch.from_numpy(z[f"t{i}_scale"]).to(device),
                    col_ids=col_ids,
                    layout=(LAYOUT_BITPACK if planes.dtype == torch.uint8
                            else LAYOUT_DENSE))
                e = entries.get(name, {})
                if e:                       # v2: explicit layout metadata
                    backend = e.get("backend")
                    pt = pt.replace(layout=e.get("layout", pt.layout),
                                    logical_k=e.get("logical_k"),
                                    window_block=e.get("window_block"),
                                    backend=(backend if backend
                                             in backend_names() else None),
                                    tile_plan=plan_from_json(e.get(PLAN_KEY)))
                out[name] = pt
            return out
    except (OSError, ValueError, TypeError, KeyError, EOFError,
            json.JSONDecodeError, zipfile.BadZipFile):
        return None
