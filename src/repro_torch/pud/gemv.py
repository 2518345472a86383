"""PUD GeMV serving path: low-bit linear layers in the bit-plane layout
(port of the numeric half of ``repro/pud/gemv.py``: ``pack_linear`` and
``pud_linear``, plus the weight-traffic accounting; the DDR4 rate models are
not ported yet).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ops import pud_matmul
from repro_torch.kernels.ref import pack_bitplanes, pack_plane_words

from .packed import LAYOUT_BITPACK, PackedTensor, packed_bytes

# Default packable set: FFN projections.  Entries are "scope.name" (scope =
# any path component) or a bare name.
FFN_PACKABLE = ("mixer.wi", "mixer.wg", "mixer.wo")
# Attention projections (head axes flattened to one column axis).
ATTN_PACKABLE = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")


@dataclasses.dataclass(frozen=True)
class PUDGemvConfig:
    weight_bits: int = 4
    mode: str = "folded"         # "planes" (faithful) | "folded" (optimized)
    packable: tuple[str, ...] = FFN_PACKABLE
    # Named execution backend (kernels/backends.py); None = the pack's own.
    backend: str | None = None


def pack_linear(w: torch.Tensor, n_bits: int = 4, backend: str | None = None,
                bitpack: bool = True) -> PackedTensor:
    """[K, N] float weights -> per-output-channel-quantized bit-planes.

    Symmetric per channel in the weights' own dtype: scale = max|w| / qmax,
    q = clip(round(w / scale)) (round half to even), as the reference does
    when it packs eagerly.  ``bitpack=True`` stores [WB, ceil(K/8), N] uint8
    words, otherwise dense [WB, K, N] int8 planes.
    """
    qmax = (1 << (n_bits - 1)) - 1
    eps = torch.tensor(1e-8, dtype=w.dtype, device=w.device)
    div = torch.tensor(float(qmax), dtype=w.dtype, device=w.device)
    scale = torch.maximum(w.abs().amax(dim=0), eps) / div          # [N]
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax - 1, qmax)
    planes = pack_bitplanes(q.to(torch.int32), n_bits)
    if not bitpack:
        return PackedTensor(planes=planes, scale=scale.to(torch.float32),
                            backend=backend)
    return PackedTensor(planes=pack_plane_words(planes),
                        scale=scale.to(torch.float32), backend=backend,
                        layout=LAYOUT_BITPACK, logical_k=w.shape[0])


def pud_linear(x: torch.Tensor, packed: PackedTensor,
               cfg: PUDGemvConfig = PUDGemvConfig(),
               backend: str | None = None) -> torch.Tensor:
    """x [..., K] float -> [..., N] float32 through the bit-plane GEMM.

    Backend resolution: ``backend`` > ``cfg.backend`` > the pack's stamp >
    the default (``cuda``).
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = pud_matmul(x2, packed.planes, packed.scale, mode=cfg.mode,
                   col_ids=packed.col_ids,
                   backend=backend or cfg.backend or packed.backend,
                   layout=packed.layout, logical_k=packed.logical_k,
                   window_block=packed.window_block)
    return y.reshape(lead + (y.shape[-1],))


# Peak weight-staging bandwidth of the paper's 4-channel DDR4-2133 system
# (8 B/transfer x 2133 MT/s per channel) — the reference's constant.
WEIGHT_STAGING_BW_BYTES_S = 4 * 8 * 2133e6


def weight_traffic(packed) -> dict:
    """Per-token weight-traffic terms of a packed serving tree."""
    stats = packed_bytes(packed)
    stored = stats["stored_bytes"]
    dense = stats["dense_equiv_bytes"]
    return {
        "stored_bytes_per_token": stored,
        "dense_equiv_bytes_per_token": dense,
        "traffic_reduction": dense / max(1, stored),
        "staging_bound_tok_s": WEIGHT_STAGING_BW_BYTES_S / max(1, stored),
    }
