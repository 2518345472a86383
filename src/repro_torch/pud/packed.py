"""Typed packs: the PUD serving weight format (port of ``repro/pud/packed.py``).

``PackedTensor`` is one projection in the bit-plane layout: WB planes over
columns, the per-output-channel dequant scale and, when placed, the
``col_ids`` gather map into the physical window.  ``PackedModel`` is a whole
serving tree (bf16 leaves plus ``<name>_pud`` packs) with its packing
metadata.  Only typed packs exist in the port; the reference's legacy dict
packs are not supported.
"""
from __future__ import annotations

import dataclasses

import torch

LAYOUT_DENSE = "dense"        # [L?, WB, K, N/W] int8, one byte per bit
LAYOUT_BITPACK = "bitpack8"   # [L?, WB, ceil(K/8), N/W] uint8, 8 bits/byte


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
    """

    planes: torch.Tensor
    scale: torch.Tensor
    col_ids: torch.Tensor | None = None
    backend: str | None = None
    layout: str = LAYOUT_DENSE
    logical_k: int | None = None
    window_block: int | None = None

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

    def layer(self, index: int) -> "PackedTensor":
        """Slice of a stacked pack at one layer (what the reference's layer
        ``lax.scan`` hands each iteration)."""
        return self.replace(
            planes=self.planes[index], scale=self.scale[index],
            col_ids=None if self.col_ids is None else self.col_ids[index])


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
        """Flat view: tensor path -> its PackedTensor (computed once)."""
        cached = self.__dict__.get("_tensors")
        if cached is not None:
            return cached
        out: dict[str, PackedTensor] = {}

        def walk(tree, path):
            for key, sub in tree.items():
                if key.endswith("_pud") and isinstance(sub, PackedTensor):
                    out["/".join(path + (key[: -len("_pud")],))] = sub
                elif isinstance(sub, dict):
                    walk(sub, path + (key,))

        walk(self.params, ())
        self.__dict__["_tensors"] = out
        return out

    def tensor(self, name: str) -> PackedTensor:
        """One pack by its report name or a unique path suffix."""
        tensors = self.tensors
        if name in tensors:
            return tensors[name]
        hits = [k for k in tensors if k.endswith(name)]
        if len(hits) == 1:
            return tensors[hits[0]]
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
            if k.endswith("_pud") and isinstance(v, PackedTensor):
                stats["stored_bytes"] += v.stored_bytes
                stats["dense_equiv_bytes"] += v.dense_equiv_bytes
            elif isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                stats["bf16_bytes"] += v.numel() * v.element_size()

    walk(params)
    return stats
