"""Fused Algorithm-1 iteration: CUDA kernel wrapper, plain version, counter.

Replaces the Pallas kernel ``repro/kernels/majx.py: calib_iter_fused``.  The
kernel source is ``csrc/calib_iter.cu``; ``calib_iter_plain`` is the plain
PyTorch version (``kernels/ref.calib_iter_ref``) it is held against.

``calib_iter`` takes a fleet at once: ``inputs [..., S, M, C]`` with any
leading subarray axes.  A CUDA tensor launches the kernel (and raises on
anything the kernel does not take); a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.pud.physics import NEUTRAL, PhysicsParams

from . import build
from .ref import calib_iter_ref

calib_iter_plain = calib_iter_ref

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             ctypes.POINTER(_F), ctypes.POINTER(_F), _I,
             _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P]


def _lib():
    lib = build.load("calib_iter")
    fn = lib.calib_iter_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"calib_iter: {msg}")


def calib_iter(inputs: torch.Tensor, noise: torch.Tensor,
               levels: torch.Tensor, sense_offset: torch.Tensor,
               params: PhysicsParams, n_fracs: int,
               level_qsum: tuple[float, ...], level_swing: tuple[float, ...],
               threshold: float, maj_inputs: int = 5,
               const_charge_sum: float = 0.0, const_swing_sq: float = 0.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused iteration; returns (new levels [..., C] int32, bias
    [..., C] float32), equal to ``calib_iter_plain`` bit for bit."""
    args = (params, n_fracs, level_qsum, level_swing, threshold, maj_inputs,
            const_charge_sum, const_swing_sq)
    if not inputs.is_cuda:
        return calib_iter_plain(inputs, noise, levels, sense_offset, *args)

    _require(inputs.dtype == torch.uint8,
             f"operand bits must be uint8 in {{0, 1}}, got {inputs.dtype}")
    _require(inputs.dim() >= 3, f"inputs must be [..., S, M, C], got "
             f"{tuple(inputs.shape)}")
    *lead, s, m, c = inputs.shape
    lead = tuple(lead)
    _require(noise.shape == lead + (s, c) and noise.dtype == torch.float32,
             f"noise must be float32 {lead + (s, c)}, got "
             f"{noise.dtype} {tuple(noise.shape)}")
    _require(levels.shape == lead + (c,) and levels.dtype == torch.int32,
             f"levels must be int32 {lead + (c,)}")
    _require(sense_offset.shape == lead + (c,)
             and sense_offset.dtype == torch.float32,
             f"sense_offset must be float32 {lead + (c,)}")
    for t in (noise, levels, sense_offset):
        _require(t.device == inputs.device, "all tensors on one device")
    for t in (inputs, noise, levels, sense_offset):
        _require(t.is_contiguous(), "tensors must be contiguous")
    n_levels = len(level_qsum)
    _require(1 <= n_levels <= 8 and len(level_swing) == n_levels,
             f"ladder must have 1..8 levels, got {n_levels}")
    g = int(np.prod(lead)) if lead else 1

    f = np.float32
    var_const = (f(params.sigma_dynamic ** 2)
                 + f(params.sigma_frac ** 2) * f(n_fracs))
    qsum = (_F * 8)(*[float(f(q)) for q in level_qsum])
    swing = (_F * 8)(*[float(f(w)) for w in level_swing])
    levels_out = torch.empty_like(levels)
    bias = torch.empty(lead + (c,), dtype=torch.float32, device=inputs.device)
    fn = _lib()
    with torch.cuda.device(inputs.device):
        stream = torch.cuda.current_stream(inputs.device).cuda_stream
        rc = fn(inputs.data_ptr(), noise.data_ptr(), levels.data_ptr(),
                sense_offset.data_ptr(), levels_out.data_ptr(),
                bias.data_ptr(), g, s, m, c, qsum, swing, n_levels,
                float(f(params.c_cell_ff)),
                float(f(NEUTRAL * params.c_bitline_ff)),
                float(f(params.c_total_ff(params.n_simra_rows))),
                float(f(NEUTRAL)), float(var_const),
                float(f(params.sigma_transfer ** 2)),
                float(f(const_charge_sum)), float(f(const_swing_sq)),
                float(f(threshold)), float(f(-threshold)),
                int(maj_inputs // 2), stream)
    if rc != 0:
        raise RuntimeError(f"calib_iter kernel launch failed: CUDA error {rc}")
    calib_iter.launches += 1
    return levels_out, bias


calib_iter.launches = 0
