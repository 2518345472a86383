"""Command costs of MAJ-based bit-serial arithmetic on PUD (port of the
counting half of ``repro/pud/bitserial.py``; the simulated adder and
multiplier graphs are not ported).

Operands are stored dual-rail and staged once, MVDRAM-style; the carry and
sum rails chain in place, so each MAJX pays only for its non-operand row
copies, Fracs and the SiMRA:

    standalone MAJ5 : 7 RowCopies (3 operands + 1 dup pair + 3 calib) + SiMRA
    staged MAJ5     : 4 RowCopies (1 dup pair + 3 calib) + SiMRA
    staged MAJ3     : 5 RowCopies (0/1 const pair + 3 calib) + SiMRA
    staged AND/OR   : 6 RowCopies (operand const + 0/1 pair + 3 calib) + SiMRA
"""
from __future__ import annotations

from .timing import OpCounts


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
