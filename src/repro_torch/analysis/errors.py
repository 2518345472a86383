"""Structured contract errors shared by the checker and the kernel
wrappers (port of ``repro/analysis/errors.py``).

An import leaf (stdlib only): the wrappers raise ``ContractViolation`` when
a tuned launch plan fails its check, and ``analysis/contracts.py`` imports
the kernel modules to recompute their plans, so the exception lives here
to keep that loop open.
"""
from __future__ import annotations


class ContractViolation(ValueError):
    """A kernel-contract invariant does not hold for a call or a plan.

    Subclasses ``ValueError``, so call sites that catch the wrappers' bare
    errors keep working.  The fields name what failed:

      kernel     the entry ("gemv", "gemm_placed", ..., or "autotune")
      invariant  the stable id of the failed check
      tile       the block coordinate the violation localizes to, or None
    """

    def __init__(self, kernel: str, invariant: str, message: str,
                 *, tile=None):
        self.kernel = kernel
        self.invariant = invariant
        self.tile = tile
        where = f" (tile {tile})" if tile is not None else ""
        super().__init__(f"[{kernel}] {invariant}: {message}{where}")
