"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

These are the ground truth every CUDA kernel is held against, and what the
kernel wrappers run for tensors that lie on the CPU.  They run on any
device.

Integer GEMMs go through a float64 matmul: PyTorch has no int32 matmul on
CUDA, and every product and partial sum here is an integer far below 2^53
(|x| <= 128, |w| <= 128, K <= 2^20), so float64 accumulation is exact.
"""
from __future__ import annotations

import torch

from repro_torch.pud.physics import NEUTRAL, PhysicsParams, f32


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 of [T, R, C], row by row in row order (a library
    reduction may reassociate; the kernel and the reference do not)."""
    acc = t[:, 0]
    for r in range(1, t.shape[1]):
        acc = acc + t[:, r]
    return acc


def majx_sense_ref(
    charge: torch.Tensor,        # [T, R, C] float32 cell charges (V_DD)
    sense_offset: torch.Tensor,  # [C] float32
    noise: torch.Tensor,         # [T, C] float32 standard normal
    params: PhysicsParams = PhysicsParams(),
    n_fracs: int = 0,
) -> torch.Tensor:
    """Sensed bits [T, C] float32 of T SiMRA events over C columns.

    The reference's operations one for one, each rounded to float32: the
    constant ``sd^2 + sf^2 * n_fracs`` is a Python double rounded once, as
    the reference's weakly typed scalar arithmetic gives it.
    """
    n_rows = charge.shape[1]
    half = f32(NEUTRAL, charge)
    two = f32(2.0, charge)
    v = ((row_sum(charge) * f32(params.c_cell_ff, charge)
          + f32(NEUTRAL * params.c_bitline_ff, charge))
         / f32(n_rows * params.c_cell_ff + params.c_bitline_ff, charge))
    d = two * (charge - half)
    swing_sq = row_sum(d * d)
    var = (f32(params.sigma_dynamic ** 2
               + params.sigma_frac ** 2 * float(n_fracs), charge)
           + f32(params.sigma_transfer ** 2, charge) * swing_sq)
    sigma = torch.sqrt(var)
    return ((v + sigma * noise) > half + sense_offset[None, :]).to(
        torch.float32)


def calib_iter_ref(
    inputs: torch.Tensor,        # [..., S, M, C] operand bits (uint8 or float)
    noise: torch.Tensor,         # [..., S, C] standard normal, float32
    levels: torch.Tensor,        # [..., C] int32
    sense_offset: torch.Tensor,  # [..., C] float32
    params: PhysicsParams,
    n_fracs: int,
    level_qsum: tuple[float, ...],
    level_swing: tuple[float, ...],
    threshold: float,
    maj_inputs: int = 5,
    const_charge_sum: float = 0.0,
    const_swing_sq: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Algorithm-1 iteration per column; returns (new levels, bias).

    Leading dimensions (e.g. the fleet's subarray axis) are batch axes.
    Each float operation rounds on its own, in the reference's order.
    """
    q = inputs.to(torch.float32)
    idx = levels.long()
    qsum = torch.tensor(level_qsum, dtype=torch.float32,
                        device=q.device)[idx]
    swing = torch.tensor(level_swing, dtype=torch.float32,
                         device=q.device)[idx]
    half, two = f32(NEUTRAL, q), f32(2.0, q)
    ones = q.sum(dim=-2)                                   # [..., S, C]
    charge_sum = ones + qsum[..., None, :] + f32(const_charge_sum, q)
    v = params.bitline_voltage(charge_sum, params.n_simra_rows)
    swing_sq = (((two * (q - half)) ** 2).sum(dim=-2)
                + swing[..., None, :] + f32(const_swing_sq, q))
    sigma = params.sensing_sigma(float(n_fracs), swing_sq)
    out = ((v + sigma * noise) > (half + sense_offset[..., None, :])).to(
        torch.float32)
    truth = (ones > f32(maj_inputs // 2, q)).to(torch.float32)
    bias = (out - truth).sum(dim=-2) / f32(q.shape[-3], q)
    thr = f32(threshold, q)
    step = (torch.where(bias > thr, -1, 0)
            + torch.where(bias < -thr, 1, 0))
    new_levels = torch.clamp(levels + step, 0, len(level_qsum) - 1)
    return new_levels.to(torch.int32), bias


def signed_weights(planes: torch.Tensor) -> torch.Tensor:
    """[WB, K, N] {0,1} planes -> [K, N] int32 offset-binary weights."""
    wb = planes.shape[0]
    weights = torch.zeros(planes.shape[1:], dtype=torch.int32,
                          device=planes.device)
    for b in range(wb):
        weights += planes[b].to(torch.int32) << b
    return weights - (1 << (wb - 1))


def bitplane_gemv_ref(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """[B, K] int8 x [WB, K, N] bit-planes -> [B, N] int32 signed GeMV."""
    w = signed_weights(planes)
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(
        torch.int32)


def bitplane_gemv_placed_ref(x: torch.Tensor, planes: torch.Tensor,
                             col_ids: torch.Tensor) -> torch.Tensor:
    """Placed version: gather logical columns out of the physical window
    [WB, K, P] with ``col_ids`` [N], then the plain bit-plane GeMV."""
    return bitplane_gemv_ref(x, planes.index_select(2, col_ids.long()))


def pack_bitplanes(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Signed int weights [K, N] in [-2^{b-1}, 2^{b-1}) -> [WB, K, N] int8
    offset-binary bit-planes (u = w + 2^{WB-1})."""
    u = w.to(torch.int32) + (1 << (n_bits - 1))
    shifts = torch.arange(n_bits, dtype=torch.int32, device=w.device)
    return ((u[None] >> shifts[:, None, None]) & 1).to(torch.int8)


def pack_plane_words(planes: torch.Tensor) -> torch.Tensor:
    """Dense bit-planes [WB, K, N] in {0,1} -> [WB, ceil(K/8), N] uint8.

    Eight consecutive K rows fold into one byte, LSB-first: bit j of word
    i is the plane bit at k = i*8 + j.  K pads with zero bits.
    """
    wb, k, n = planes.shape
    kw = -(-k // 8)
    p = planes.to(torch.uint8)
    if kw * 8 != k:
        p = torch.nn.functional.pad(p, (0, 0, 0, kw * 8 - k))
    p = p.reshape(wb, kw, 8, n)
    words = torch.zeros((wb, kw, n), dtype=torch.uint8, device=planes.device)
    for j in range(8):
        words |= p[:, :, j, :] << j
    return words


def unpack_plane_words(words: torch.Tensor, k: int | None = None
                       ) -> torch.Tensor:
    """[WB, Kw, N] uint8 words -> dense [WB, k, N] int8 bit-planes (the
    exact inverse of ``pack_plane_words``; ``k`` drops the byte padding)."""
    wb, kw, n = words.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (words[:, :, None, :] >> shifts[None, None, :, None]) & 1
    planes = bits.reshape(wb, kw * 8, n).to(torch.int8)
    return planes[:, : (kw * 8 if k is None else k), :]


def pack_plane_words_n(planes: torch.Tensor) -> torch.Tensor:
    """The rejected word axis: [WB, K, N] {0,1} -> [WB, K, ceil(N/32)]
    uint32, 32 consecutive N columns per word, LSB-first (kept for the
    round-trip tests that justify packing along K: words along N would
    break column addressing, the placement gathers and per-channel
    scales)."""
    wb, k, n = planes.shape
    nw = -(-n // 32)
    p = planes.to(torch.int64)
    if nw * 32 != n:
        p = torch.nn.functional.pad(p, (0, nw * 32 - n))
    shifts = torch.arange(32, dtype=torch.int64, device=planes.device)
    words = (p.reshape(wb, k, nw, 32) << shifts).sum(dim=3)
    return words.to(torch.uint32)


def unpack_plane_words_n(words: torch.Tensor, n: int | None = None
                         ) -> torch.Tensor:
    """Inverse of ``pack_plane_words_n``: [WB, K, Nw] uint32 -> [WB, K, n]
    int8 (``n`` drops the padding columns)."""
    wb, k, nw = words.shape
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    planes = bits.reshape(wb, k, nw * 32).to(torch.int8)
    return planes[:, :, : (nw * 32 if n is None else n)]


def densify(x: torch.Tensor, planes: torch.Tensor, layout: str,
            logical_k: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, dense [WB, K, N] planes) of a pack in either layout: bit-words
    unpack to ``logical_k`` rows and x pads with zeros to match."""
    if layout == "bitpack8":
        planes = unpack_plane_words(planes, logical_k)
        if planes.shape[1] != x.shape[1]:
            x = torch.nn.functional.pad(x, (0, planes.shape[1] - x.shape[1]))
    return x, planes
