"""Serving-time weight packer (port of ``repro/pud/packer.py``:
``packing_requests``, ``pack_model`` (and its tuple-returning
``pack_for_serving``), the placed-window pack, and the tensor-parallel
``pack_linear_sharded`` / ``pack_model_sharded``).

``pack_model`` walks a parameter tree and replaces the projections matched
by ``PUDGemvConfig.packable`` with ``PackedTensor`` bit-plane packs, which
``models.layers.linear`` dispatches to the bit-plane GEMM.  Entries are a
bare key ("wi") or "scope.key" ("mixer.wi", matching when "mixer" is on the
tree path).  Attention weights flatten their head axes to one column axis.
Stacked layers pack per slice: [L, K, N] -> planes [L, WB, ceil(K/8), N].

With a ``Placement`` every pack is emitted in its physical, block-aligned
window layout: each slice's dense planes are scattered into the window
positions its logical columns were placed on, then bit-packed, plus the
``col_ids`` gather map.  Faulty window columns hold zeros and are never
addressed.  Request names and their order match the reference's, which is
what ``requests_fingerprint`` and first-fit allocation depend on.

``pack_model_sharded`` splits every projection's N columns over the
"model" shards on the full tensor's window-block boundaries
(``shard_column_slices``): each shard quantizes and packs its own slice,
placed with its own ``Placement`` or logical, pads to the common
per-device shape and moves to its device (``ShardedPackedTensor``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import pack_plane_words

from .gemv import PUDGemvConfig, pack_linear
from .packed import (LAYOUT_BITPACK, PackedModel, PackedTensor,
                     ShardedPackedTensor)
from .placement import (Placement, PlacementRequest, TensorPlacement,
                        shard_column_slices)


def _match(packable: tuple[str, ...], key: str, path: tuple[str, ...]) -> bool:
    """Does ``key`` at ``path`` belong to the packable set?"""
    for entry in packable:
        if "." in entry:
            scope, name = entry.rsplit(".", 1)
            if key == name and scope in path:
                return True
        elif key == entry:
            return True
    return False


def _canonical(key: str, path: tuple[str, ...], w: torch.Tensor):
    """Matched projection -> canonical [K, N] / [L, K, N] view, or None."""
    if "attn" in path:
        if key in ("wq", "wk", "wv"):
            if w.dim() == 3:       # [D, H, Dh]
                return w.reshape(w.shape[0], -1)
            if w.dim() == 4:       # [L, D, H, Dh]
                return w.reshape(w.shape[0], w.shape[1], -1)
        elif key == "wo":
            if w.dim() == 3:       # [H, Dh, D]
                return w.reshape(-1, w.shape[-1])
            if w.dim() == 4:       # [L, H, Dh, D]
                return w.reshape(w.shape[0], -1, w.shape[-1])
        return None
    if w.dim() in (2, 3):
        return w
    return None


def _pack_stacked(w: torch.Tensor, n_bits: int,
                  backend: str | None) -> PackedTensor:
    """[L, K, N] (or [K, N]) weights -> logical (unplaced) ``PackedTensor``."""
    if w.dim() == 2:
        return pack_linear(w, n_bits, backend)
    packs = [pack_linear(w[i], n_bits) for i in range(w.shape[0])]
    return PackedTensor(planes=torch.stack([p.planes for p in packs]),
                        scale=torch.stack([p.scale for p in packs]),
                        backend=backend, layout=packs[0].layout,
                        logical_k=packs[0].logical_k)


def _pack_placed(w: torch.Tensor, n_bits: int, tp: TensorPlacement,
                 backend: str | None) -> PackedTensor:
    """Physically placed pack: planes scattered into the column window.

    Returns planes [L?, WB, ceil(K/8), W] uint8 words, scale [L?, N],
    col_ids [L?, N] int32 (absolute window positions) and ``window_block``,
    where W = ``tp.region_size``.
    """
    local = torch.from_numpy(tp.local_cols).to(w.device)

    def one(w2, loc):
        pk = pack_linear(w2, n_bits, bitpack=False)
        planes = torch.zeros(pk.planes.shape[:2] + (tp.region_size,),
                             dtype=torch.int8, device=w2.device)
        planes[:, :, loc.long()] = pk.planes
        return pk.scale, pack_plane_words(planes), loc.to(torch.int32)

    kw = dict(backend=backend, layout=LAYOUT_BITPACK,
              logical_k=w.shape[-2], window_block=tp.window_block)
    if w.dim() == 2:
        scale, planes, ids = one(w, local)
        return PackedTensor(planes=planes, scale=scale, col_ids=ids, **kw)
    parts = [one(w[i], local[i]) for i in range(w.shape[0])]
    return PackedTensor(planes=torch.stack([p[1] for p in parts]),
                        scale=torch.stack([p[0] for p in parts]),
                        col_ids=torch.stack([p[2] for p in parts]), **kw)


def _pack_any(w, n_bits: int, name: str, placement: Placement | None,
              backend: str | None) -> PackedTensor:
    if placement is None:
        return _pack_stacked(w, n_bits, backend)
    tp = placement.entries.get(name)
    if tp is None:
        raise KeyError(
            f"placement has no entry for packed tensor {name!r}; plan it "
            "from packing_requests() of the same params/config "
            f"(have: {sorted(placement.entries)})")
    return _pack_placed(w, n_bits, tp, backend)


def _pad_last(a: torch.Tensor, axis: int, target: int,
              value=0) -> torch.Tensor:
    """Trailing pad of axis ``axis`` (-1 or -2) up to ``target``."""
    grow = target - a.shape[axis]
    if grow <= 0:
        return a
    pad = (0, grow) if axis == -1 else (0, 0, 0, grow)
    return torch.nn.functional.pad(a, pad, value=value)


def _pad_col_ids(ids: torch.Tensor, n_max: int, block_cols: int,
                 window_block: int) -> torch.Tensor:
    """Extend a col_ids map to ``n_max`` columns of the padded geometry:
    each padded column points at the start of its own padded window block,
    which holds zero planes (so the block-slice contract still holds)."""
    n_i = ids.shape[-1]
    if n_max <= n_i:
        return ids
    pad = (torch.arange(n_i, n_max, dtype=torch.int32, device=ids.device)
           // block_cols) * window_block
    pad = pad.expand(ids.shape[:-1] + (n_max - n_i,))
    return torch.cat([ids, pad], dim=-1)


def _normalize_placed_shard(pk: PackedTensor, bc: int, w_common: int,
                            nb_max: int, n_max: int):
    """Re-window one shard's placed pack onto the common padded geometry:
    block j's window columns move from ``j * wb_i + t`` to ``j * w_common
    + t`` (the window axis is the planes' last, untouched by bit-packing),
    then blocks pad to ``nb_max`` and columns to ``n_max``."""
    wb_i = pk.window_block
    nb_i = pk.col_ids.shape[-1] // bc
    planes = pk.planes                       # [L?, WB, Kw, nb_i * wb_i]
    pl = planes.reshape(planes.shape[:-1] + (nb_i, wb_i))
    pl = _pad_last(_pad_last(pl, -1, w_common), -2, nb_max)
    pl = pl.reshape(planes.shape[:-1] + (nb_max * w_common,))
    j = pk.col_ids // wb_i
    ids = (j * w_common + pk.col_ids - j * wb_i).to(torch.int32)
    ids = _pad_col_ids(ids, n_max, bc, w_common)
    scale = _pad_last(pk.scale, -1, n_max, value=1.0)
    return pl, scale, ids


def _to_device(pt: PackedTensor, device) -> PackedTensor:
    return pt.replace(
        planes=pt.planes.to(device), scale=pt.scale.to(device),
        col_ids=None if pt.col_ids is None else pt.col_ids.to(device))


def pack_linear_sharded(w: torch.Tensor, n_shards: int, *, n_bits: int = 4,
                        placements=None, name: str | None = None,
                        backend: str | None = None,
                        devices=None) -> ShardedPackedTensor:
    """Pack one canonical [K, N] / [L, K, N] projection across model shards.

    The N axis splits on the full tensor's window-block boundaries
    (``shard_column_slices``), so every shard owns whole placement windows;
    each shard's slice packs on its own: with that shard's ``Placement``
    (looked up under ``name``) when ``placements`` is given, logically
    otherwise.  Shards pad to a common per-device shape and shard ``m``
    moves to ``devices[m]`` (packing happens on ``w``'s device).  Without
    ``devices`` the pack stays on ``w``'s device and cannot execute.
    """
    n = w.shape[-1]
    spans, bc = shard_column_slices(n, n_shards)
    widths = tuple(hi - lo for lo, hi in spans)
    placed = placements is not None
    lead = tuple(w.shape[:-2])                   # () or (L,)
    dev = w.device

    packs: list[PackedTensor | None] = []
    for m, (lo, hi) in enumerate(spans):
        if hi == lo:
            packs.append(None)
            continue
        wi = w[..., lo:hi]
        if placed:
            tp = placements[m].entries[name]
            if tp.block_cols != bc:
                raise ValueError(
                    f"shard {m} placement of {name!r} planned block_cols="
                    f"{tp.block_cols}, the sharded split uses {bc} — plan "
                    "per-shard placements with the forced block width")
            packs.append(_pack_placed(wi, n_bits, tp, backend))
        else:
            packs.append(_pack_stacked(wi, n_bits, backend))

    live = [p for p in packs if p is not None]
    ref = live[0]
    logical_k = ref.logical_k
    wb, kw_words = ref.planes.shape[-3], ref.planes.shape[-2]
    n_max = max(widths)
    kw = dict(backend=backend, layout=LAYOUT_BITPACK, logical_k=logical_k)

    shards = []
    if placed:
        w_common = max(p.window_block for p in live)
        nb_max = n_max // bc
        region = nb_max * w_common
        pad_ids = ((torch.arange(n_max, dtype=torch.int32, device=dev) // bc)
                   * w_common).expand(lead + (n_max,))
        for p in packs:
            if p is None:
                planes = torch.zeros(lead + (wb, kw_words, region),
                                     dtype=torch.uint8, device=dev)
                scale = torch.ones(lead + (n_max,), dtype=torch.float32,
                                   device=dev)
                ids = pad_ids
            else:
                planes, scale, ids = _normalize_placed_shard(
                    p, bc, w_common, nb_max, n_max)
            shards.append(PackedTensor(planes=planes.contiguous(),
                                       scale=scale.contiguous(),
                                       col_ids=ids.contiguous(),
                                       window_block=w_common, **kw))
    else:
        w_common = None
        for p in packs:
            if p is None:
                planes = torch.zeros(lead + (wb, kw_words, n_max),
                                     dtype=torch.uint8, device=dev)
                scale = torch.ones(lead + (n_max,), dtype=torch.float32,
                                   device=dev)
            else:
                planes = _pad_last(p.planes, -1, n_max)
                scale = _pad_last(p.scale, -1, n_max, value=1.0)
            shards.append(PackedTensor(planes=planes.contiguous(),
                                       scale=scale.contiguous(), **kw))
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        shards = [_to_device(s, d) for s, d in zip(shards, devices)]
    return ShardedPackedTensor(
        shards=tuple(shards), shard_widths=widths, block_cols=bc,
        window_block=w_common, devices=devices, **kw)


def pack_model_sharded(params: dict, cfg: PUDGemvConfig = PUDGemvConfig(),
                       *, n_shards: int, placements=None,
                       include_unembed: bool = True,
                       devices=None) -> PackedModel:
    """Tensor-parallel ``pack_model``: every pack is a
    ``ShardedPackedTensor`` whose shard ``m`` lives on ``devices[m]``.

    ``placements`` gives one per-shard ``Placement`` (planned on that
    shard's own masks over its column slice of every request;
    ``PUDFleetSession.pack``); None packs the logical layout.  The float
    weights of packed projections are dropped as ``pack_model`` drops
    them, so the single-device model code serves the tree unchanged:
    ``pud_linear`` dispatches on the pack type.
    """
    packed_names: list[str] = []
    skipped: list[str] = []

    def one(w, name):
        return pack_linear_sharded(
            w, n_shards, n_bits=cfg.weight_bits, placements=placements,
            name=name, backend=cfg.backend, devices=devices)

    def walk(tree, path):
        out = {}
        for key, sub in tree.items():
            p = path + (key,)
            if isinstance(sub, dict):
                out[key] = walk(sub, p)
                continue
            if isinstance(sub, torch.Tensor) and _match(cfg.packable, key,
                                                        path):
                w = _canonical(key, path, sub)
                if w is not None:
                    name = "/".join(p)
                    out[key + "_pud"] = one(w, name)
                    packed_names.append(name)
                    continue
                skipped.append("/".join(p))
            out[key] = sub
        return out

    packed = walk(params, ())
    if include_unembed and "unembed" in packed:
        w = packed["unembed"].pop("w")
        packed["unembed"]["w_pud"] = one(w, "unembed/w")
        packed_names.append("unembed/w")
    return PackedModel(params=packed,
                       packed_names=tuple(packed_names),
                       skipped_names=tuple(skipped),
                       weight_bits=cfg.weight_bits,
                       placed=placements is not None)


def packing_requests(params: dict, cfg: PUDGemvConfig = PUDGemvConfig(),
                     include_unembed: bool = True) -> list[PlacementRequest]:
    """Column demand of every projection ``pack_model`` would pack, in the
    reference's order and with its names."""
    reqs: list[PlacementRequest] = []

    def walk(tree, path):
        for key, sub in tree.items():
            p = path + (key,)
            if isinstance(sub, dict):
                walk(sub, p)
            elif (isinstance(sub, torch.Tensor)
                  and _match(cfg.packable, key, path)):
                w = _canonical(key, path, sub)
                if w is None:
                    continue
                if w.dim() == 2:
                    reqs.append(PlacementRequest("/".join(p), w.shape[1], 0))
                else:
                    reqs.append(PlacementRequest(
                        "/".join(p), w.shape[2], w.shape[0]))

    walk(params, ())
    if include_unembed and "w" in params.get("unembed", {}):
        reqs.append(PlacementRequest(
            "unembed/w", params["unembed"]["w"].shape[1], 0))
    return reqs


def pack_model(params: dict, cfg: PUDGemvConfig = PUDGemvConfig(),
               include_unembed: bool = True,
               placement: Placement | None = None) -> PackedModel:
    """Pack a parameter tree for PUD serving; returns a ``PackedModel``.

    The float weights of packed projections are dropped from the returned
    tree (the input tree is left as it is).  With ``placement`` every pack
    is emitted in its physical column layout.
    """
    packed_names: list[str] = []
    skipped: list[str] = []

    def walk(tree, path):
        out = {}
        for key, sub in tree.items():
            p = path + (key,)
            if isinstance(sub, dict):
                out[key] = walk(sub, p)
                continue
            if isinstance(sub, torch.Tensor) and _match(cfg.packable, key,
                                                        path):
                w = _canonical(key, path, sub)
                if w is not None:
                    name = "/".join(p)
                    out[key + "_pud"] = _pack_any(
                        w, cfg.weight_bits, name, placement, cfg.backend)
                    packed_names.append(name)
                    continue
                skipped.append("/".join(p))
            out[key] = sub
        return out

    packed = walk(params, ())
    if include_unembed and "unembed" in packed:
        w = packed["unembed"].pop("w")
        packed["unembed"]["w_pud"] = _pack_any(
            w, cfg.weight_bits, "unembed/w", placement, cfg.backend)
        packed_names.append("unembed/w")
    return PackedModel(params=packed,
                       packed_names=tuple(packed_names),
                       skipped_names=tuple(skipped),
                       weight_bits=cfg.weight_bits,
                       placed=placement is not None)


def pack_for_serving(params: dict, cfg: PUDGemvConfig = PUDGemvConfig(),
                     include_unembed: bool = True,
                     placement: Placement | None = None
                     ) -> tuple[dict, dict]:
    """The reference's older entry: (serving params tree, report dict) of
    ``pack_model``."""
    pm = pack_model(params, cfg, include_unembed=include_unembed,
                    placement=placement)
    return pm.params, pm.report
