"""Multi-level charging offset ladders (port of ``repro/core/offsets.py``).

A MAJ5 in an 8-row SiMRA leaves three non-operand rows.  Storing a bit in
each and applying f_i Frac ops to row i gives the offset ladder of
configuration T_{f1,f2,f3}: 2^3 sign patterns of +-0.5 * alpha^f_i
cell-charge units around neutral, deduplicated and sorted.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.pud.physics import NEUTRAL, PhysicsParams


@dataclasses.dataclass(frozen=True)
class OffsetLadder:
    """Static description of a T_{x,y,z,...} configuration's ladder."""

    frac_counts: tuple[int, ...]
    offsets_units: tuple[float, ...]     # sorted distinct offsets
    bits_table: tuple[tuple[int, ...], ...]  # bit pattern per level
    n_fracs: int

    @property
    def n_levels(self) -> int:
        return len(self.offsets_units)

    @property
    def n_rows(self) -> int:
        return len(self.frac_counts)

    def offsets_volts(self, params: PhysicsParams) -> np.ndarray:
        return np.asarray(self.offsets_units) * params.cell_weight

    def row_charges(self, params: PhysicsParams) -> np.ndarray:
        """[n_levels, n_rows] float32 cell charge per calibration row."""
        out = np.zeros((self.n_levels, self.n_rows), np.float32)
        for lvl, bits in enumerate(self.bits_table):
            for i, (b, f) in enumerate(zip(bits, self.frac_counts)):
                out[lvl, i] = NEUTRAL + (b - NEUTRAL) * params.frac_alpha**f
        return out


def make_ladder(frac_counts: tuple[int, ...],
                params: PhysicsParams) -> OffsetLadder:
    """Enumerate the 2^n_rows sign patterns, dedupe, sort by offset."""
    deltas = [0.5 * params.frac_alpha**f for f in frac_counts]
    entries: dict[float, tuple[int, ...]] = {}
    for bits in itertools.product((0, 1), repeat=len(frac_counts)):
        off = sum((b - 0.5) * 2 * d for b, d in zip(bits, deltas))
        off = round(off, 9)
        entries.setdefault(off, bits)
    offs = sorted(entries)
    return OffsetLadder(
        frac_counts=tuple(frac_counts),
        offsets_units=tuple(offs),
        bits_table=tuple(entries[o] for o in offs),
        n_fracs=sum(frac_counts),
    )


def levels_to_charges(ladder: OffsetLadder, levels: torch.Tensor,
                      params: PhysicsParams) -> torch.Tensor:
    """Per-column levels [n_cols] -> calibration row charges [n_rows, n_cols]."""
    table = torch.from_numpy(ladder.row_charges(params)).to(levels.device)
    return table[levels.long()].T


def baseline_charges(x_fracs: int, n_cols: int, params: PhysicsParams,
                     device=None) -> torch.Tensor:
    """B_{x,0,0}: one constant-1 row Frac'd x times, plus constants 0 and 1."""
    neutralish = NEUTRAL + 0.5 * params.frac_alpha**x_fracs
    col = torch.tensor([neutralish, 0.0, 1.0], dtype=torch.float32,
                       device=device)
    return col[:, None].expand(3, n_cols)


def neutral_level(ladder: OffsetLadder) -> int:
    """Ladder index whose offset is closest to zero (calibration start)."""
    return int(np.argmin(np.abs(np.asarray(ladder.offsets_units))))
