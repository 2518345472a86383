"""Sub-seeds of a run's ``--seed``: every input of a run (weights, the
simulated DRAM device, traffic, the sample compared) draws from its own
63-bit seed, so a seed of any size gives the same inputs every time."""
from __future__ import annotations

import hashlib


def sub_seed(seed: int, *salt) -> int:
    """A 63-bit seed of ``seed`` folded with ``salt``."""
    blob = ":".join(str(s) for s in (int(seed),) + salt).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "little") >> 1
