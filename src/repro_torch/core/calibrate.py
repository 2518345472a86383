"""Algorithm 1 configuration (port of ``repro/core/calibrate.py``).

Only ``CalibrationConfig`` is ported so far; the fleet engine
(``core/fleet.py``) runs the iterations.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    n_iterations: int = 20      # paper Sec. IV-A
    n_samples: int = 512        # random samples per iteration
    # Bias threshold of Algorithm 1: below 1/n_samples, so one observed
    # error already steps the level.
    threshold: float = 0.0009
    maj_inputs: int = 5
    # constant (non-operand, non-calibration) rows: MAJ3 uses a 0/1 pair
    const_charge_sum: float = 0.0
    const_swing_sq: float = 0.0
