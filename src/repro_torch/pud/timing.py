"""DDR4 command-level latency model for PUD operation sequences (port of
``repro/pud/timing.py``; pure host arithmetic, the same numbers).

The paper (Sec. IV-A) derives throughput for a 4-channel DDR4-2133 system with
16-bank-parallel PUD "under ACT power constraints".  The binding constraint at
that parallelism is tFAW: at most 4 ACTs per rolling tFAW window per rank, so a
wave of 16 banks each issuing an n-ACT operation sequence takes

    t_wave = max( 16 * n_act * tFAW / 4 ,  per-bank serial time )

One global ``controller_overhead`` multiplier absorbs command-bus, tRCD/tWR
recovery and scheduling slack; it is calibrated once against the paper's
baseline MAJ5 operating point (B_{3,0,0} = 0.89 TOPS at 46.6 % ECR) and every
other latency is derived from command counts.

ACT counts per PUD primitive (ComputeDRAM/FracDRAM command sequences):
  RowCopy (AAP)   : ACT -> PRE -> ACT            = 2 ACTs
  Frac            : ACT -> early PRE             = 1 ACT
  SiMRA (APA)     : ACT -> PRE -> ACT (glitch)   = 2 ACTs
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DDR4Timing:
    """DDR4-2133 (JEDEC) timing, ns."""

    tck_ns: float = 0.9375
    tras_ns: float = 33.0
    trp_ns: float = 13.2
    trcd_ns: float = 13.2
    trrd_s_ns: float = 3.7
    tfaw_ns: float = 25.0
    # Calibrated once against the paper's B_{3,0,0} MAJ5 throughput
    # (0.89 TOPS at 46.6% ECR -> 2.52 us wave latency for the 19-ACT
    # standalone MAJ5). Covers command bus + controller slack.
    controller_overhead: float = 1.325

    @property
    def trc_ns(self) -> float:
        return self.tras_ns + self.trp_ns

    @property
    def act_rate_ns(self) -> float:
        """Minimum average spacing between ACTs under the tFAW power window."""
        return self.tfaw_ns / 4.0


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """The paper's evaluation system (Sec. IV-A)."""

    n_channels: int = 4
    n_banks_parallel: int = 16
    n_cols_per_subarray: int = 65536
    timing: DDR4Timing = dataclasses.field(default_factory=DDR4Timing)


@dataclasses.dataclass(frozen=True)
class OpCounts:
    """Command counts of one PUD operation sequence (per bank)."""

    rowcopies: int = 0
    fracs: int = 0
    simras: int = 0

    @property
    def acts(self) -> int:
        return 2 * self.rowcopies + self.fracs + 2 * self.simras

    def __add__(self, other: "OpCounts") -> "OpCounts":
        return OpCounts(
            self.rowcopies + other.rowcopies,
            self.fracs + other.fracs,
            self.simras + other.simras,
        )

    def __mul__(self, k: int) -> "OpCounts":
        return OpCounts(self.rowcopies * k, self.fracs * k, self.simras * k)

    __rmul__ = __mul__


def maj5_counts(frac_counts: tuple[int, int, int]) -> OpCounts:
    """MAJ5 with PUDTune/baseline non-operand rows (Fig. 1 flow).

    RowCopies: operands a, b, c (3; carry-in reuse is *not* assumed here),
    one AAP copy driving the duplicated operand pair (MAJ5 uses the
    not-carry twice -> 1 copy to 2 rows), and 3 non-operand-row copies
    (calibration data or neutral+constants — identical count for baseline
    and PUDTune). One SiMRA; Frac count = sum of the row configuration.
    """
    return OpCounts(rowcopies=3 + 1 + 3, fracs=sum(frac_counts), simras=1)


def maj3_counts(frac_counts: tuple[int, int, int]) -> OpCounts:
    """MAJ3 with 8-row SiMRA: 3 operand copies, the 0/1 constant pair
    (2 copies), 3 calibration/neutral copies, one SiMRA."""
    return OpCounts(rowcopies=3 + 2 + 3, fracs=sum(frac_counts), simras=1)


def wave_latency_ns(counts: OpCounts, sys: SystemConfig) -> float:
    """Latency for all ``n_banks_parallel`` banks to finish one op sequence.

    Power-limited term: total ACTs across banks spaced by tFAW/4.
    Serial term: one bank's sequence at tRC per ACT-pair (never binding at
    16-bank parallelism, kept for small-bank configs).
    """
    t = sys.timing
    power_ns = counts.acts * sys.n_banks_parallel * t.act_rate_ns
    serial_ns = (
        counts.rowcopies * (t.tras_ns + t.trp_ns + 2 * t.tck_ns)
        + counts.fracs * (0.45 * t.tras_ns + t.trp_ns)
        + counts.simras * (t.tras_ns + t.trp_ns + 2 * t.tck_ns)
    )
    return max(power_ns, serial_ns) * t.controller_overhead


def throughput_ops(
    counts: OpCounts, error_free_cols: float, sys: SystemConfig
) -> float:
    """Paper Eq. 1, generalized: ops/s for the full 4-channel system."""
    lat_s = wave_latency_ns(counts, sys) * 1e-9
    return error_free_cols * sys.n_banks_parallel * sys.n_channels / lat_s
