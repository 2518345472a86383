"""Explicit random streams: ``torch.Generator``s in place of ``jax.random``
keys.

The reference derives every stream with ``fold_in(key, salt)``; the port
derives a 63-bit seed from ``(seed, salt...)`` with SHA-256 and seeds a
generator on the target device.  The streams differ from the reference's
bit for bit (parity tests feed both packages numpy-drawn inputs instead);
what carries over is that each subarray and each phase has its own stream,
independent of how many others run beside it.
"""
from __future__ import annotations

import hashlib

import torch


def derive_seed(seed: int, *salt) -> int:
    """Deterministic 63-bit seed of ``seed`` folded with ``salt``."""
    blob = ":".join(str(s) for s in (int(seed),) + salt).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "little") >> 1


def generator(seed: int, *salt, device=None) -> torch.Generator:
    """A generator on ``device`` seeded from ``derive_seed(seed, *salt)``."""
    gen = torch.Generator(device=torch.device(device or "cpu"))
    gen.manual_seed(derive_seed(seed, *salt))
    return gen
