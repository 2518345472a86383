"""MAJ-based bit-serial arithmetic on PUD, dual-rail (port of
``repro/pud/bitserial.py``): the simulated MAJ context, adder and
multiplier graphs, and their command costs.

    AND(x, y)  = MAJ3(x, y, 0)
    OR(x, y)   = MAJ3(x, y, 1)
    cout       = MAJ3(a, b, cin)
    sum        = MAJ5(a, b, cin, !cout, !cout)

Operands are stored as value and complement (commodity DRAM has no NOT);
every MAJX is an 8-row SiMRA whose 3 non-operand rows hold the baseline
constants or PUDTune calibration data, so errors compound over the graph.
Noise comes from an explicit ``torch.Generator`` where the reference takes
a key; each MAJX draws its own.

Operands are staged once, MVDRAM-style; the carry and sum rails chain in
place, so each MAJX pays only for its non-operand row copies, Fracs and
the SiMRA:

    standalone MAJ5 : 7 RowCopies (3 operands + 1 dup pair + 3 calib) + SiMRA
    staged MAJ5     : 4 RowCopies (1 dup pair + 3 calib) + SiMRA
    staged MAJ3     : 5 RowCopies (0/1 const pair + 3 calib) + SiMRA
    staged AND/OR   : 6 RowCopies (operand const + 0/1 pair + 3 calib) + SiMRA
"""
from __future__ import annotations

import dataclasses

import torch

from .device import maj_outputs
from .physics import PhysicsParams
from .timing import OpCounts


@dataclasses.dataclass(frozen=True)
class MajContext:
    """Executes MAJX ops against a (simulated) calibrated subarray.

    All bit tensors have shape [..., n_cols]; leading dims are trials.
    """

    params: PhysicsParams
    sense_offset: torch.Tensor   # [n_cols]
    calib_charge: torch.Tensor   # [3, n_cols] non-operand row charge
    n_fracs: int                 # Fracs applied per MAJX execution

    def _maj(self, inputs, gen, const_sum, const_swing):
        return maj_outputs(torch.stack(inputs, dim=-2), self.calib_charge,
                           self.sense_offset, gen, self.params,
                           self.n_fracs, const_charge_sum=const_sum,
                           const_swing_sq=const_swing)

    # 5 operand rows + 3 calib rows = 8-row SiMRA.
    def maj5(self, a, b, c, d, e, gen):
        return self._maj((a, b, c, d, e), gen, 0.0, 0.0)

    # 3 operand rows + 0/1 constant pair + 3 calib rows.
    def maj3(self, a, b, c, gen):
        return self._maj((a, b, c), gen, 1.0, 2.0)

    # AND = MAJ3(x, y, const 0); one more constant row than maj3.
    def and_(self, x, y, gen):
        return self._maj((x, y), gen, 1.0, 3.0)

    # OR = MAJ3(x, y, const 1).
    def or_(self, x, y, gen):
        return self._maj((x, y), gen, 2.0, 3.0)


def full_adder(ctx: MajContext, a, ab, b, bb, c, cb, gen,
               want_sum_bar=True):
    """One dual-rail full adder. Returns (s, sb, cout, coutb).

    4 MAJX ops (3 if the sum complement is not needed downstream).
    """
    cout = ctx.maj3(a, b, c, gen)
    coutb = ctx.maj3(ab, bb, cb, gen)
    s = ctx.maj5(a, b, c, coutb, coutb, gen)
    sb = ctx.maj5(ab, bb, cb, cout, cout, gen) if want_sum_bar else None
    return s, sb, cout, coutb


def add_n(ctx: MajContext, a_bits, ab_bits, b_bits, bb_bits, gen,
          want_sum_bar=False):
    """Ripple-carry add of two n-bit dual-rail integers (LSB first).

    a_bits: [n, ..., n_cols].  Returns (sum_bits [n, ...], sum_bar,
    carry_out, carry_out_bar).  The complement rail is always simulated;
    ``want_sum_bar`` only controls whether it is returned.
    """
    c, cb = torch.zeros_like(a_bits[0]), torch.ones_like(a_bits[0])
    sums, sbars = [], []
    for i in range(a_bits.shape[0]):
        s, sb, c, cb = full_adder(ctx, a_bits[i], ab_bits[i], b_bits[i],
                                  bb_bits[i], c, cb, gen, want_sum_bar=True)
        sums.append(s)
        sbars.append(sb)
    return (torch.stack(sums), torch.stack(sbars) if want_sum_bar else None,
            c, cb)


def mul8_truncated(ctx: MajContext, a_bits, ab_bits, b_bits, bb_bits, gen):
    """8-bit x 8-bit -> low 8 bits (fixed-point truncated product).

    Shift-and-add: partial product row j (p_i = a_i AND b_j, complements by
    OR on the complement rails) ripple-adds into the accumulator at offset
    j over its true width 8 - j.  The reference runs all 8 lanes of every
    row and keeps the first 8 - j (one compiled body for ``lax.scan``); the
    lanes it discards never reach the result, so this schedule has the
    same error statistics and the command count of ``mul8_counts``.
    """
    acc = [ctx.and_(a_bits[i], b_bits[0], gen) for i in range(8)]
    accb = [ctx.or_(ab_bits[i], bb_bits[0], gen) for i in range(8)]
    for j in range(1, 8):
        width = 8 - j
        p = [ctx.and_(a_bits[i], b_bits[j], gen) for i in range(width)]
        pb = [ctx.or_(ab_bits[i], bb_bits[j], gen) for i in range(width)]
        c, cb = torch.zeros_like(acc[0]), torch.ones_like(acc[0])
        for i in range(width):
            acc[j + i], accb[j + i], c, cb = full_adder(
                ctx, acc[j + i], accb[j + i], p[i], pb[i], c, cb, gen,
                want_sum_bar=True)
    return torch.stack(acc)


def maj5_standalone_counts(n_fracs: int) -> OpCounts:
    return OpCounts(rowcopies=7, fracs=n_fracs, simras=1)


def maj5_staged_counts(n_fracs: int) -> OpCounts:
    return OpCounts(rowcopies=4, fracs=n_fracs, simras=1)


def maj3_staged_counts(n_fracs: int) -> OpCounts:
    return OpCounts(rowcopies=5, fracs=n_fracs, simras=1)


def andor_staged_counts(n_fracs: int) -> OpCounts:
    return OpCounts(rowcopies=6, fracs=n_fracs, simras=1)


def full_adder_counts(n_fracs: int, want_sum_bar=True) -> OpCounts:
    c = 2 * maj3_staged_counts(n_fracs) + maj5_staged_counts(n_fracs)
    if want_sum_bar:
        c = c + maj5_staged_counts(n_fracs)
    return c


def add8_counts(n_fracs: int) -> OpCounts:
    # Standalone ADD does not need the sum complement rail.
    return 8 * full_adder_counts(n_fracs, want_sum_bar=False)


def mul8_counts(n_fracs: int) -> OpCounts:
    counts = OpCounts()
    for j in range(8):
        width = 8 - j
        counts = counts + 2 * width * andor_staged_counts(n_fracs)
        if j > 0:
            counts = counts + width * full_adder_counts(n_fracs,
                                                        want_sum_bar=True)
    return counts


# ---------------------------------------------------------------------------
# Bit/int conversion helpers (LSB first).
# ---------------------------------------------------------------------------


def int_to_bits(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """[...]: int -> [n_bits, ...] float32 bits, LSB first."""
    shifts = torch.arange(n_bits, dtype=x.dtype, device=x.device)
    bits = (x[None, ...] >> shifts.reshape((-1,) + (1,) * x.dim())) & 1
    return bits.to(torch.float32)


def bits_to_int(bits: torch.Tensor) -> torch.Tensor:
    """[n_bits, ...] bits -> [...] int32, LSB first."""
    n = bits.shape[0]
    weights = (2 ** torch.arange(n, dtype=torch.int32, device=bits.device)
               ).reshape((-1,) + (1,) * (bits.dim() - 1))
    return (bits.to(torch.int32) * weights).sum(dim=0, dtype=torch.int32)
