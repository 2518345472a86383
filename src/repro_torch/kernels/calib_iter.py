"""Fused Algorithm-1 iteration: CUDA kernel wrapper, plain version, counter.

Replaces the Pallas kernel ``repro/kernels/majx.py: calib_iter_fused``.  The
kernel source is ``csrc/calib_iter.cu``; ``calib_iter_plain`` is the plain
PyTorch version (``kernels/ref.calib_iter_ref``) it is held against.

``calib_iter`` takes a fleet at once: ``inputs [..., S, M, C]`` with any
leading subarray axes.  A CUDA tensor launches the kernel (and raises on
anything the kernel does not take); a CPU tensor runs the plain version.

Each thread of the kernel owns ``COLS`` adjacent columns of one subarray
and a table of their M + 1 bitline voltages in shared memory.
``plan_launch`` makes every choice of a launch on the host (vector path or
byte path, threads per block, shared bytes, blocks); the kernel only checks
it, so the CPU tests reach the plan.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.pud.physics import NEUTRAL, PhysicsParams

from . import build
from .placed_gemm import SMEM_MAX, _cdiv
from .ref import calib_iter_ref

calib_iter_plain = calib_iter_ref

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             ctypes.POINTER(_F), ctypes.POINTER(_F), _I,
             _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P, _I, _P]

COLS = 4                  # adjacent columns per thread
THREADS = (256, 128, 64, 32)  # threads per block, first choice first
SMEM_DEFAULT = 48 * 1024  # shared bytes a block gets without opting in
MAX_M = 255               # a byte holds each column's count of ones


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch of ``csrc/calib_iter.cu`` covers a [G, C] grid.

    ``vec``: the vector path (32-bit operand words, 16-byte noise, levels
    and offsets), else the byte path; ``threads`` per block, each owning
    ``COLS`` columns; ``smem_bytes`` the voltage table, (M + 1) x ``COLS``
    floats per thread; ``blocks`` covering G x ceil(C / ``COLS``) threads.
    """
    vec: bool
    threads: int
    smem_bytes: int
    blocks: int

    #: field order of the C ``Plan`` struct
    FIELDS = ("vec", "threads", "smem_bytes", "blocks")

    def c_array(self):
        vals = [int(getattr(self, f)) for f in self.FIELDS]
        return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=256)
def plan_launch(g: int, m: int, c: int, aligned: bool) -> Plan:
    """The launch plan of one iteration over ``g`` subarrays of ``c``
    columns with ``m`` operands; ``aligned``: every base pointer is
    16-byte aligned (the operand bits 4-byte).

    The vector path runs where ``c`` is a multiple of ``COLS`` as well;
    anything else takes the byte path in the same kernel.  The block is the
    first of ``THREADS`` whose table fits the default shared memory, else
    the smallest (opting in above it).
    """
    if not 1 <= m <= MAX_M:
        raise ValueError(f"calib_iter: 1..{MAX_M} operands per sample, "
                         f"got {m}")
    per_thread = (m + 1) * COLS * 4
    threads = next((t for t in THREADS if t * per_thread <= SMEM_DEFAULT),
                   THREADS[-1])
    return Plan(aligned and c % COLS == 0, threads, threads * per_thread,
                _cdiv(g * _cdiv(c, COLS), threads))


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
    _require(s > 0 and m > 0 and c > 0, "empty operand")
    g = int(np.prod(lead)) if lead else 1

    f = np.float32
    var_const = (f(params.sigma_dynamic ** 2)
                 + f(params.sigma_frac ** 2) * f(n_fracs))
    qsum = (_F * 8)(*[float(f(q)) for q in level_qsum])
    swing = (_F * 8)(*[float(f(w)) for w in level_swing])
    levels_out = torch.empty_like(levels)
    bias = torch.empty(lead + (c,), dtype=torch.float32, device=inputs.device)
    aligned = (inputs.data_ptr() % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in
                       (noise, levels, sense_offset, levels_out, bias)))
    arr = plan_launch(g, m, c, aligned).c_array()
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
                int(maj_inputs // 2), arr, len(arr), stream)
    if rc != 0:
        raise RuntimeError(f"calib_iter kernel launch failed: CUDA error {rc}")
    calib_iter.launches += 1
    return levels_out, bias


calib_iter.launches = 0
