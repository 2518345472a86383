"""Cost counter of the dry run: the counterpart of the reference's
``repro/launch/hlo_analysis.py``.

The reference parses XLA's optimised, SPMD-partitioned HLO text and
multiplies each ``while`` body by its known trip count.  The port has no
HLO to parse, so ``parse_computations``, the regular expressions,
``_TRIP`` and ``_COND_BODY`` have no counterpart here.  Instead
``CostMode`` is a ``TorchDispatchMode`` over a function run on meta
tensors (shapes and dtypes, no storage, no device): it sees every aten op
that eager PyTorch would dispatch, after autograd, and counts

  * flops -- the reference's: matrix products only (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot``: what ``@``,
    ``einsum`` and ``linear`` lower to) at 2 M N K, plus convolutions,
    counted here (``conv_flops``): forward 2 x output elements x window x
    (in channels / groups), backward that count for each gradient it
    computes (input, weight).  Nothing else counts, as in the reference;
  * traffic bytes -- for every dispatched op that is not a view, its
    tensor operands' bytes plus its results' bytes.  Each op is a kernel
    in eager mode, so this is the port's own traffic model; the
    reference's counts XLA's fusions at their boundaries instead.  Both
    ignore reuse in cache, so this is an upper bound on HBM bytes;
  * peak live bytes -- each new (non-view, not in-place) output storage
    adds its ``untyped_storage().nbytes()`` when it is made and is taken
    off by ``weakref.finalize`` when it is freed.  Tensors made before the
    mode (parameters, moments, caches) are the caller's ``resident``
    bytes.  Meta storages all have ``data_ptr() == 0``, so storages are
    told apart by their ``StorageImpl`` (``_cdata``), never by pointer.

Eager loops run every iteration, so there is no trip count to apply; the
dry run's one multiplier is its microbatch count (``launch/dryrun.py``).
Collective bytes are what ``runtime/sharding.count_transfers`` records
while the function runs: the gathers and the reduce-scatter of the
sharded step, and the all-reduces and all-gathers of a lane's "model"
group (``models/sharding_ctx.ModelGroup``: a ring's 2 (M - 1) / M and
(M - 1) / M of the buffer per position).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.runtime import sharding as shd

COLLECTIVES = shd.COLLECTIVES

aten = torch.ops.aten


def _mm(args, out) -> float:            # [M, K] x [K, N]
    return 2.0 * out.numel() * args[0].shape[-1]


def _addmm(args, out) -> float:         # bias + [M, K] x [K, N]
    return 2.0 * out.numel() * args[1].shape[-1]


#: op -> flops from (positional args, first output)
MATMULS = {
    aten.mm.default: _mm,
    aten.bmm.default: _mm,
    aten.mv.default: _mm,
    aten.dot.default: lambda a, o: 2.0 * a[0].numel(),
    aten.addmm.default: _addmm,
    aten.baddbmm.default: _addmm,
    aten.addmv.default: _addmm,
}


def conv_flops(out_elems: int, weight_shape) -> float:
    """2 x output elements x window x (in channels / groups): the
    weight is [C_out, C_in / groups, *window]."""
    return 2.0 * out_elems * math.prod(weight_shape[1:])


def _conv(args, out) -> float:
    return conv_flops(out.numel(), args[1].shape)


def _conv_backward(args, out) -> float:
    # (grad_output, input, weight, ..., output_mask): the forward's count
    # for each of grad_input and grad_weight that is computed
    grad_out, weight, mask = args[0], args[2], args[-1]
    return conv_flops(grad_out.numel(), weight.shape) * sum(mask[:2])


CONVS = {aten.convolution.default: _conv,
         aten.convolution_backward.default: _conv_backward}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict = None
    collective_counts: dict = None

    def __post_init__(self):
        self.collective_bytes = self.collective_bytes or dict.fromkeys(
            COLLECTIVES, 0.0)
        self.collective_counts = self.collective_counts or dict.fromkeys(
            COLLECTIVES, 0.0)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts flops, traffic bytes, position-crossing bytes and peak live
    bytes of what runs inside it (module docstring).  ``resident``: the
    bytes live before the block.  ``cost`` is the running ``Cost``,
    ``peak`` the peak live bytes, ``by_op`` {op name: [calls, flops,
    bytes]}."""

    def __init__(self, resident: int = 0):
        super().__init__()
        self.cost = Cost()
        self.live = self.peak = int(resident)
        self.by_op: dict[str, list] = {}
        self._mult = 1
        self._transfers = None

    def __enter__(self):
        self._transfers = shd.count_transfers()
        self._rec = self._transfers.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._transfers.__exit__(*exc)
        for k in COLLECTIVES:
            self.cost.collective_bytes[k] = float(self._rec.bytes[k])
            self.cost.collective_counts[k] = float(self._rec.counts[k])
        return out

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs in the block ``n`` times (a loop's identical
        iterations, traced once); peak bytes are not multiplied."""
        before = dict(self._rec.bytes), dict(self._rec.counts)
        self._mult = n
        try:
            yield
        finally:
            self._mult = 1
            for now, was in zip((self._rec.bytes, self._rec.counts), before):
                for k in COLLECTIVES:
                    now[k] += (n - 1) * (now[k] - was[k])

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        # a storage is told apart by its StorageImpl (``_cdata``), unique
        # while the inputs are alive
        in_st = {a.untyped_storage()._cdata for a in ins}
        new = [o for o in outs if o.untyped_storage()._cdata not in in_st]
        if func.is_view or (not new and outs
                            and not func._schema.is_mutable):
            return out                   # a view: no kernel, no bytes
        flops = 0.0
        if func in MATMULS:
            flops = MATMULS[func](args, outs[0])
        elif func in CONVS:
            flops = CONVS[func](args, outs[0])
        flops *= self._mult
        nbytes = self._mult * (sum(_nbytes(t) for t in ins)
                               + sum(_nbytes(t) for t in outs))
        self.cost.flops += flops
        self.cost.bytes += nbytes
        row = self.by_op.setdefault(str(func), [0, 0.0, 0])
        row[0] += self._mult
        row[1] += flops
        row[2] += nbytes
        seen = set()
        for o in new:
            st = o.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def analyze(fn, *args, resident: int = 0, **kwargs):
    """(``Cost`` and peak live bytes of ``fn(*args, **kwargs)``, its
    result); run ``fn`` on meta tensors."""
    with CostMode(resident) as cm:
        result = fn(*args, **kwargs)
    return cm.cost, cm.peak, result


def summarize(cost: Cost) -> dict:
    """The reference's ``summarize`` keys, from a ``Cost``."""
    return {
        "flops": cost.flops,
        "bytes": cost.bytes,
        "collective_bytes": dict(cost.collective_bytes),
        "collective_counts": dict(cost.collective_counts),
        "total_collective_bytes": cost.total_collective_bytes,
    }
