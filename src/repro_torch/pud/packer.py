"""Serving-time weight packer (port of ``repro/pud/packer.py``, single
device: ``packing_requests``, ``pack_model`` and the placed-window pack).

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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import pack_plane_words

from .gemv import PUDGemvConfig, pack_linear
from .packed import LAYOUT_BITPACK, PackedModel, PackedTensor
from .placement import Placement, PlacementRequest, TensorPlacement


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

