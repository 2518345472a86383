"""ServingEngine: continuous-batching request scheduler, and the
data-parallel ``FleetServingEngine`` over it (port of
``repro/runtime/engine.py``).

  * **Requests** enter a queue (``submit``); each is one prompt, a token
    budget and an optional deadline.
  * **Slots**: the engine owns ``batch_size`` decode slots and one cache
    whose leaves carry the batch on axis 1: ``{group: {"k", "v": [L,
    batch_size, max_len, ...]}}`` (MLA models: the latents ``"ckv"``,
    ``"kr"``), or the SSM's ``{"conv", "state"}`` (no sequence axis, so no
    prefix cache); every slot holds at most one in-flight request.  A
    model whose cache has the batch elsewhere (the hybrid's Mamba2
    segments) is refused (``engine_refusal``).
  * **Continuous batching**: admission and eviction happen at step
    granularity.  Before every decode step free slots are filled from the
    queue; after it finished requests are evicted and their slots freed at
    once.
  * **Bucketed prefill**: a prompt is zero-padded at the tail to the next
    power of two and prefilled alone (batch 1); its logits are read at the
    true last token, and its cache goes into the slot's lane of the shared
    cache.  The pad rows' K/V stay in the lane, hidden by the per-row causal
    mask and overwritten as the request decodes.  Models whose padded
    prefill is not exact (``supports_chunked_prefill`` False or absent:
    MoE routing is sequence-global, the SSM's state would take in the pad
    tokens) prefill at the exact prompt length instead.
  * **Chunked prefill** (``chunk_prefill=N``): a slot spends several steps
    prefilling, one N-token chunk per step resumed into a private batch-1
    cache (``model.prefill_chunk``), interleaved with the decode waves of
    the other slots, before its first token.  Every chunk attends over the
    prompt's whole bucket, so it finishes bit-identical to whole prefill.
  * **Prefix cache** (``prefix_cache=True``): completed prefills are kept
    in an LRU (``runtime/prefix_cache.py``) keyed on (params version,
    prompt hash); a repeated prompt skips prefill (full hit), and a shared
    system prompt resumes chunked prefill after the cached prefix (partial
    hit).  ``stage_params`` invalidates it.
  * **SLO admission** (``slo=``): admission is priced on a virtual clock
    that advances by the modeled step time of the session's placement rate
    model (``step_seconds``) per working step: requests admit
    earliest-deadline first, hopeless ones are shed at admission, expired
    in-flight ones are shed mid-run; completions carry ``slo_met``.
  * **Per-slot positions**: one decode wave runs all slots at once with a
    [B] vector of cache lengths (``models/attention.gqa_decode``); free and
    prefilling slots decode a dummy token at length 0, in their own lane
    only.
  * **Spans** (``runtime/tracing.py``, always on, host stamps only):
    ``engine.queue`` per request from ``submit`` to its admission;
    ``engine.admit`` per admission (children ``model.prefill``, the model
    call's enqueue, and ``engine.first_token``, the wait for its first
    token); ``engine.decode`` per wave (child ``model.decode_step``, the
    enqueue; the rest is the wait for the wave's tokens).  Each carries
    the step index.  The wave's span times ``decode_wall_s`` and the
    watchdog's step.  ``scheduler_report()["counters"]`` holds the
    tracer's counters and its next sequence number.

Every per-row computation (activation quantization, the integer bit-plane
kernels, attention masks, RMSNorm) is independent of the other rows, so a
request's tokens do not depend on what else is in the batch, as far as the
device's float operations are themselves independent of the row count.

Batch size: with a ``PUDSession``, the default is its rate model's optimum
(``optimal_batch_size``).  PyTorch runs eagerly under
``torch.inference_mode()``; caches are updated in place, so the jit trace
counters of the reference become counts of distinct prefill shapes.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from . import tracing
from .prefix_cache import PrefixCache
from .watchdog import StepWatchdog

DEFAULT_MAX_BATCH = 32

#: Modeled decode-step wall time when no rate model is available (the SLO
#: virtual clock only; never a measurement).
DEFAULT_STEP_MS = 5.0

#: ``run`` raises after this many consecutive steps with queued or active
#: work but no progress (a ``prefill_budget`` below the chunk size is the
#: one configuration that can starve forever).
_STALL_LIMIT = 8


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _prompt_np(tokens) -> np.ndarray:
    """A prompt as a contiguous [S] int32 host array (hashing, lookups)."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.detach().to("cpu", torch.int32).numpy()
    return np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))


@dataclasses.dataclass
class Request:
    """One generation request: a prompt, a token budget and optionally a
    deadline (milliseconds from submit, on the engine's modeled clock)."""

    request_id: int
    tokens: Any                   # [S] int prompt tokens (array-like)
    max_new_tokens: int
    deadline_ms: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(torch.as_tensor(self.tokens).shape[-1])


@dataclasses.dataclass
class Completion:
    """A finished request: generated tokens plus scheduling metadata."""

    request_id: int
    tokens: list[int]             # generated tokens (length = max_new_tokens)
    slot: int
    admitted_step: int            # engine step index at admission
    finished_step: int            # engine step index after the last token
    logits: torch.Tensor | None = None   # [gen, V] when collect_logits
    slo_met: bool | None = None   # None when the request had no deadline
    shed: bool = False            # dropped by the SLO policy / shed_request


@dataclasses.dataclass
class SLOConfig:
    """Admission policy for requests with deadlines.

    ``step_time_ms`` overrides the modeled per-step time of the virtual
    clock; by default it is the session's placement rate model
    (``step_seconds`` at the engine's batch size), else
    ``DEFAULT_STEP_MS``.  A modeled clock keeps the policy deterministic
    and independent of host jitter.
    """

    default_deadline_ms: float | None = None  # for requests without one
    step_time_ms: float | None = None         # virtual-clock override
    shed_on_admit: bool = True                # shed hopeless requests
    shed_admitted: bool = True                # evict expired in-flight ones


@dataclasses.dataclass
class _PrefillState:
    """A slot's chunked-prefill progress (phase "prefill")."""

    tokens: torch.Tensor          # [bucket] int32 prompt, zero-padded
    prompt: np.ndarray            # [prompt_len] int32 host copy
    bucket: int                   # pow2 prefill length (kv rows attended)
    chunk: int                    # chunk length (divides the bucket)
    pos: int                      # positions < pos are in the cache
    cache: Any                    # private batch-1 KV tree [L,1,max_len,..]

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class _Slot:
    request: Request
    admitted_step: int
    generated: list[int]
    logits: list[torch.Tensor]
    phase: str = "decode"         # "prefill" | "decode"
    pf: _PrefillState | None = None
    deadline_vms: float | None = None   # virtual-clock deadline


def _tree_device(tree) -> torch.device | None:
    """Device of the first tensor in a parameter tree (None if it has
    none)."""
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, dict) and (dev := _tree_device(v)) is not None:
            return dev
    return None


def _map_cache(fn, cache: dict) -> dict:
    """``fn`` over every leaf of a cache tree (nested dicts of tensors or
    ``ParamDef``s): the transformer's {group: {leaf}}, the SSM's flat
    {"conv", "state"}."""
    return {k: _map_cache(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in cache.items()}


def _cache_leaves(cache: dict, path=()):
    """(path, leaf) of every leaf of a cache tree, in tree order."""
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _tracer_snapshot() -> dict:
    """The tracer's counters and the sequence number of its next span:
    two reports bracket the spans and counts of the steps between them."""
    return dict(tracing.counters(), seq=tracing.next_seq())


def engine_refusal(model) -> str | None:
    """Why ``ServingEngine`` cannot serve ``model``, or None.

    The engine keeps one cache for all slots and installs a batch-1
    prefill into a slot's lane on axis 1, so every cache leaf must carry
    the batch on axis 1 (its logical axes, ``cache_defs``).  The hybrid's
    Mamba2 segment caches are [uses, per_segment, B, ...]: the reference's
    engine fails on that model too (``jax.lax.scan`` of its decode step
    raises "scan got values with different leading axis sizes"), so the
    port refuses it."""
    off = [("/".join(path), d.axes) for path, d in
           _cache_leaves(model.cache_defs(1, 1))
           if len(d.axes) < 2 or d.axes[1] != "batch"]
    if off:
        name, axes = off[0]
        return (f"the continuous-batching engine needs the batch on axis 1 "
                f"of every cache leaf; {getattr(model.cfg, 'name', model)}'s "
                f"{name} has axes {axes} (the reference's engine fails on "
                "such a cache: on the hybrid, scan got values with "
                "different leading axis sizes)")
    return None


def _has_sequence_axis(model) -> bool:
    """Whether every cache leaf keeps sequence rows on axis 2 (the prefix
    cache trims and pads that axis); the SSM's (conv window, state) cache
    does not."""
    return all(len(d.axes) > 2 and d.axes[2] == "kv_seq"
               for _, d in _cache_leaves(model.cache_defs(1, 1)))


class ServingEngine:
    """Continuous-batching decode engine for one model + serving params.

    ``params`` is the serving tree (``PackedModel.params`` for the PUD path
    or a bf16 tree); ``session`` is the ``PUDSession`` whose packed model is
    served: it gives the default batch size, the DRAM-side rate models of
    ``perf_report`` and the SLO clock's step time.  The model must expose
    ``prefill(params, tokens, max_len=, last_idx=)`` and ``decode_step(
    params, cache, tokens, cur_len)`` taking a [B] ``cur_len``; chunked
    prefill also needs ``prefill_chunk`` and ``cache_defs`` (the dense
    transformer has all of them).

    Scheduler extensions, all off by default (the default is the
    step-granular FIFO engine):

    ``chunk_prefill``     chunk length in tokens (rounded up to a power of
                          two); prompts prefill one chunk per step.
    ``prefill_budget``    at most this many prefill tokens per step across
                          slots (None: one chunk per prefilling slot).
    ``prefix_cache``      True (a default ``PrefixCache``) or an instance.
    ``slo``               ``SLOConfig``, or a float: its
                          ``default_deadline_ms``; EDF admission, shedding.
    ``heartbeat``         a ``Heartbeat`` told the step index after every
                          working step.
    """

    def __init__(self, model, params, *, max_len: int, session=None,
                 batch_size: int | None = None,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 collect_logits: bool = False,
                 watchdog: StepWatchdog | None = None,
                 heartbeat=None,
                 chunk_prefill: int | None = None,
                 prefill_budget: int | None = None,
                 prefix_cache: bool | PrefixCache = False,
                 slo: SLOConfig | float | None = None):
        refusal = engine_refusal(model)
        if refusal is not None:
            raise ValueError(refusal)
        if batch_size is None:
            batch_size = self._default_batch_size(session, max_batch)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.model = model
        self.params = params
        self.session = session
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.collect_logits = collect_logits
        self.device = _tree_device(params)
        if self.device is None:
            raise ValueError("parameter tree holds no tensor")
        self._bucketed = bool(getattr(model, "supports_chunked_prefill",
                                      False))
        if chunk_prefill is not None:
            if not self._bucketed:
                raise ValueError(
                    "chunk_prefill requires a model with bit-exact chunked "
                    "prefill (supports_chunked_prefill); MoE routing is "
                    "sequence-global, and the SSM has no prefill_chunk")
            if chunk_prefill < 1:
                raise ValueError(
                    f"chunk_prefill must be >= 1, got {chunk_prefill}")
            chunk_prefill = min(_next_pow2(int(chunk_prefill)), self.max_len)
        self.chunk_prefill = chunk_prefill
        self.prefill_budget = prefill_budget
        if prefix_cache is not False and not _has_sequence_axis(model):
            raise ValueError(
                "prefix_cache keeps a prompt's cache rows on axis 2, and "
                f"{getattr(model.cfg, 'name', model)}'s cache has no "
                "sequence axis (an SSM's conv window and state); the "
                "reference's engine raises on such a hit (dynamic_update_"
                "slice of the padded window into the slot's cache)")
        if prefix_cache is True:
            prefix_cache = PrefixCache()
        elif prefix_cache is False:
            prefix_cache = None
        self._prefix_cache = prefix_cache
        if isinstance(slo, (int, float)):
            slo = SLOConfig(default_deadline_ms=float(slo))
        self._slo = slo

        self._queue: collections.deque[Request] = collections.deque()
        # each queued request's open ``engine.queue`` span, by request id
        self._queue_spans: dict[int, tracing.span] = {}
        self._slots: list[_Slot | None] = [None] * self.batch_size
        self._cache = None                       # allocated on first admit
        # host-side slot state, copied to the device once per step
        self._tokens = torch.zeros((self.batch_size, 1), dtype=torch.int32)
        self._lens = torch.zeros((self.batch_size,), dtype=torch.int32)
        self._completions: list[Completion] = []
        self._step_idx = 0
        self._active_slot_steps = 0              # sum of live slots per step
        self._decode_wall_s = 0.0

        # SLO virtual clock: modeled milliseconds, one modeled step time
        # per working step.
        self._vtime_ms = 0.0
        self._step_ms = self._resolve_step_ms()
        self._deadlines: dict[int, float | None] = {}
        self._slo_stats = {"shed_on_admit": 0, "shed_admitted": 0,
                           "met": 0, "missed": 0}
        self._last_step_worked = False

        # Prefix-cache keys carry the params version, bumped on every hot
        # swap (which also drops every entry).
        self._params_version = 0
        self._prefix_invalidated_entries = 0

        # Distinct prefill shapes run (the reference counts its compiled
        # variants: the same numbers for a fresh engine).
        self._prefill_buckets: set[int] = set()
        self._chunk_shapes: set[tuple[int, int]] = set()
        self._prefill_chunks = 0                 # chunk calls run
        self._prefilled_tokens = 0               # kv rows computed

        # Every decode step is bracketed by the watchdog (EMA step time,
        # stragglers, optional hang callback; none by default, so no
        # monitor thread starts) and, with a heartbeat, announced after it.
        self.watchdog = watchdog if watchdog is not None else StepWatchdog()
        self.heartbeat = heartbeat
        self._hangs = 0
        user_hang = self.watchdog.on_hang
        if user_hang is not None:
            def _counted_hang(waited_s, _cb=user_hang):
                self._hangs += 1
                _cb(waited_s)
            self.watchdog.on_hang = _counted_hang

        # Double-buffered serving tree: ``stage_params`` parks a new tree
        # and the next ``step()`` swaps it in before admission, so no step
        # sees a half-replaced pack.
        self._staged_params = None
        self._swap_steps: list[int] = []

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def _default_batch_size(session, max_batch: int) -> int:
        """The session's rate-model optimum, else a small fixed default."""
        if session is not None:
            pm = session.placement_perf_model() or session.tuned_perf_model()
            if hasattr(pm, "optimal_batch_size"):
                return max(1, pm.optimal_batch_size(max_batch))
        return max(1, min(4, max_batch))

    def _resolve_step_ms(self) -> float:
        """Modeled decode-step milliseconds of the SLO virtual clock."""
        if self._slo is not None and self._slo.step_time_ms is not None:
            return float(self._slo.step_time_ms)
        if self.session is not None:
            pm = (self.session.placement_perf_model()
                  or self.session.tuned_perf_model())
            if pm is not None and hasattr(pm, "step_seconds"):
                fpt = self.session.flops_per_token()
                if fpt:
                    return pm.step_seconds(fpt, self.batch_size) * 1e3
        return DEFAULT_STEP_MS

    def _bucket(self, s: int) -> int:
        """pow2 prompt-length bucket, clamped to the cache length (the
        exact length for models without exact padded prefill)."""
        if not self._bucketed:
            return s
        return min(self.max_len, _next_pow2(max(1, s)))

    # -- queue / scheduler ---------------------------------------------------

    def submit(self, request: Request) -> None:
        if request.prompt_len + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request.request_id}: prompt_len "
                f"{request.prompt_len} + max_new_tokens "
                f"{request.max_new_tokens} exceeds max_len {self.max_len}")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        deadline = request.deadline_ms
        if deadline is None and self._slo is not None:
            deadline = self._slo.default_deadline_ms
        self._deadlines[request.request_id] = (
            None if deadline is None else self._vtime_ms + float(deadline))
        self._queue.append(request)
        self._queue_spans[request.request_id] = tracing.span(
            "engine.queue", request=request.request_id, step=self._step_idx,
            detached=True).start()

    def _dequeued(self, req: Request, **attrs) -> None:
        """Close ``req``'s ``engine.queue`` span: it leaves the queue."""
        q = self._queue_spans.pop(req.request_id, None)
        if q is not None:
            q.stop(**attrs)

    def submit_all(self, requests) -> None:
        for r in requests:
            self.submit(r)

    @property
    def n_pending(self) -> int:
        return len(self._queue)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    @property
    def prefill_trace_count(self) -> int:
        """Distinct prefill shapes run: whole buckets plus (chunk, bucket)
        pairs."""
        return len(self._prefill_buckets) + len(self._chunk_shapes)

    # -- batch-1 caches ------------------------------------------------------

    def _zero_cache1(self) -> dict:
        """A fresh batch-1 KV cache for a prefilling slot."""
        defs = self.model.cache_defs(1, self.max_len)
        return _map_cache(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                                device=self.device), defs)

    @staticmethod
    def _trim_cache1(cache1: dict, length: int) -> dict:
        """A copy of the first ``length`` sequence rows (leaf axis 2)."""
        return _map_cache(lambda c: c[:, :, :length].clone(), cache1)

    def _pad_cache1(self, cache1: dict) -> dict:
        """A trimmed batch-1 cache zero-padded back to ``max_len`` rows."""
        def pad(c):
            out = torch.zeros(c.shape[:2] + (self.max_len,) + c.shape[3:],
                              dtype=c.dtype, device=c.device)
            out[:, :, :c.shape[2]] = c
            return out
        return _map_cache(pad, cache1)

    # -- prefix cache --------------------------------------------------------

    def _candidate_lengths(self, s: int) -> list[int]:
        """Reusable prefix lengths of an ``s``-token prompt, longest first:
        the whole prompt, then (with chunking, which resumes the suffix)
        the chunk-aligned proper prefixes."""
        lengths = [s]
        if self.chunk_prefill is not None:
            c = self.chunk_prefill
            lengths += list(range((s - 1) // c * c, 0, -c))
        return lengths

    def prefix_probe(self, tokens) -> int:
        """Longest cached prefix of ``tokens`` (0 without a cache); does
        not change the cache's state or counters."""
        if self._prefix_cache is None:
            return 0
        tokens = _prompt_np(tokens)
        return self._prefix_cache.probe(
            self._params_version, tokens,
            self._candidate_lengths(int(tokens.shape[0])))

    def _prefix_insert(self, tokens_np: np.ndarray, cache1: dict,
                       logits_row: torch.Tensor) -> None:
        """Store a completed prefill: the whole prompt with its logits row,
        and every chunk-aligned proper prefix, each trimmed to its exact
        length so that bucket-padding rows are never reused."""
        if self._prefix_cache is None:
            return
        s = int(tokens_np.shape[0])
        v = self._params_version
        self._prefix_cache.insert(v, tokens_np, self._trim_cache1(cache1, s),
                                  logits_row)
        if self.chunk_prefill is not None:
            for length in range((s - 1) // self.chunk_prefill
                                * self.chunk_prefill, 0,
                                -self.chunk_prefill):
                self._prefix_cache.insert(
                    v, tokens_np[:length],
                    self._trim_cache1(cache1, length), None)

    def _probe_resume_point(self, req: Request) -> int:
        if self._prefix_cache is None:
            return 0
        return self.prefix_probe(req.tokens)

    # -- admission -----------------------------------------------------------

    def _estimate_steps(self, req: Request, resume_from: int = 0) -> int:
        """Modeled scheduling steps to finish ``req`` from admission."""
        if self.chunk_prefill is not None:
            remaining = max(0, req.prompt_len - resume_from)
            prefill_steps = -(-remaining // self.chunk_prefill)
        else:
            prefill_steps = 1
        return prefill_steps + req.max_new_tokens - 1

    def _shed_completion(self, req: Request, slot: int = -1,
                         generated=None, logits=None) -> None:
        self._completions.append(Completion(
            request_id=req.request_id, tokens=list(generated or []),
            slot=slot, admitted_step=self._step_idx,
            finished_step=self._step_idx, logits=logits, slo_met=False,
            shed=True))
        self._slo_stats["missed"] += 1

    def _admission_order(self) -> list[Request]:
        """The queue in admission order: FIFO, or earliest deadline first
        (stable; requests without a deadline last) under an SLO policy."""
        q = list(self._queue)
        if self._slo is None:
            return q

        def key(pair):
            i, r = pair
            d = self._deadlines.get(r.request_id)
            return (d if d is not None else float("inf"), i)
        return [r for _, r in sorted(enumerate(q), key=key)]

    def _admit(self) -> int:
        """Fill free slots from the queue; returns how many were admitted.

        Per candidate, in admission order: shed it when its deadline is
        already out of reach at the modeled step time
        (``SLOConfig.shed_on_admit``), else admit it (``_admit_slot``).
        """
        free = self.free_slots
        if not free or not self._queue:
            return 0
        candidates = self._admission_order()
        taken: list[Request] = []      # leaving the queue: admitted or shed
        admitted = 0
        ci = 0
        for slot in free:
            while ci < len(candidates):
                req = candidates[ci]
                ci += 1
                taken.append(req)
                if self._slo is not None and self._slo.shed_on_admit:
                    deadline = self._deadlines.get(req.request_id)
                    resume = self._probe_resume_point(req)
                    eta = (self._vtime_ms
                           + self._estimate_steps(req, resume) * self._step_ms)
                    if deadline is not None and eta > deadline:
                        self._slo_stats["shed_on_admit"] += 1
                        self._dequeued(req, shed=True)
                        self._shed_completion(req)
                        continue
                self._dequeued(req)
                with tracing.span("engine.admit", request=req.request_id,
                                  step=self._step_idx):
                    self._admit_slot(slot, req)
                admitted += 1
                break
        if taken:
            # by identity: a Request holding a tensor has no usable __eq__
            taken_ids = {id(r) for r in taken}
            self._queue = collections.deque(
                r for r in self._queue if id(r) not in taken_ids)
        return admitted

    def _admit_slot(self, slot: int, req: Request) -> None:
        """A full prefix hit starts decoding at once; with chunking the slot
        enters the prefilling phase (resumed after a partial hit);
        otherwise a batch-1 whole prefill (bucketed) runs now."""
        tokens_np = _prompt_np(req.tokens)
        s = req.prompt_len
        entry = None
        if self._prefix_cache is not None:
            entry = self._prefix_cache.lookup(
                self._params_version, tokens_np, self._candidate_lengths(s))
        if entry is not None and entry.n_tokens == s and \
                entry.logits is not None:
            self._start_decode(slot, req, self._pad_cache1(entry.cache),
                               entry.logits)
            return

        sb = self._bucket(s)
        padded = torch.zeros((sb,), dtype=torch.int32, device=self.device)
        padded[:s] = torch.from_numpy(tokens_np).to(self.device)
        if self.chunk_prefill is not None:
            if entry is not None and entry.n_tokens < s:   # partial hit
                resume, cache1 = entry.n_tokens, self._pad_cache1(entry.cache)
            else:
                resume, cache1 = 0, self._zero_cache1()
            self._slots[slot] = _Slot(
                request=req, admitted_step=self._step_idx, generated=[],
                logits=[], phase="prefill",
                pf=_PrefillState(tokens=padded, prompt=tokens_np, bucket=sb,
                                 chunk=min(self.chunk_prefill, sb),
                                 pos=resume, cache=cache1),
                deadline_vms=self._deadlines.get(req.request_id))
            return

        # an exact-length prompt's last row is its last token: only a
        # bucketed prefill needs last_idx (which the SSM does not take)
        kw = {"last_idx": s - 1} if self._bucketed else {}
        with tracing.span("model.prefill"):
            logits, cache1 = self.model.prefill(
                self.params, padded[None], max_len=self.max_len, **kw)
        self._prefill_buckets.add(sb)
        self._prefilled_tokens += sb
        row = logits[0]
        self._prefix_insert(tokens_np, cache1, row)
        self._start_decode(slot, req, cache1, row)

    def _start_decode(self, slot: int, req: Request, cache1: dict,
                      logits_row: torch.Tensor) -> None:
        """Install a completed batch-1 prefill into lane ``slot`` and begin
        decoding with its first token."""
        if self._cache is None:
            self._cache = _map_cache(
                lambda c: torch.zeros(c.shape[:1] + (self.batch_size,)
                                      + c.shape[2:], dtype=c.dtype,
                                      device=c.device), cache1)
        lanes = dict(_cache_leaves(self._cache))
        for path, c in _cache_leaves(cache1):
            lanes[path][:, slot] = c[:, 0]
        with tracing.span("engine.first_token"):
            first = int(torch.argmax(logits_row))
        st = self._slots[slot]
        if st is None:                 # whole-prefill / full-hit admission
            st = _Slot(request=req, admitted_step=self._step_idx,
                       generated=[], logits=[],
                       deadline_vms=self._deadlines.get(req.request_id))
            self._slots[slot] = st
        st.phase, st.pf = "decode", None
        st.generated.append(first)
        if self.collect_logits:
            st.logits.append(logits_row)
        self._tokens[slot, 0] = first
        self._lens[slot] = req.prompt_len
        if len(st.generated) >= req.max_new_tokens:
            # degenerate budget: the prefill token already finishes it
            self._evict(slot)

    # -- chunked prefill -----------------------------------------------------

    def _advance_chunks(self) -> int:
        """One prefill chunk per prefilling slot, at most
        ``prefill_budget`` tokens per step; returns the tokens prefilled."""
        if self.chunk_prefill is None:
            return 0
        budget = self.prefill_budget
        progressed = 0
        for slot, st in enumerate(self._slots):
            if st is None or st.phase != "prefill":
                continue
            pf = st.pf
            c = pf.chunk
            if budget is not None and budget - progressed < c:
                continue               # out of budget: hold, no progress
            start = pf.pos
            is_last = start + c >= pf.prompt_len
            last_local = (pf.prompt_len - 1 - start) if is_last else c - 1
            logits, pf.cache = self.model.prefill_chunk(
                self.params, pf.tokens[None, start:start + c], pf.cache,
                start, kv_len=pf.bucket, last_idx=last_local)
            self._chunk_shapes.add((c, pf.bucket))
            pf.pos = start + c
            progressed += c
            self._prefill_chunks += 1
            self._prefilled_tokens += c
            if is_last:
                row = logits[0]
                self._prefix_insert(pf.prompt, pf.cache, row)
                self._start_decode(slot, st.request, pf.cache, row)
        return progressed

    # -- eviction / shedding -------------------------------------------------

    def _evict(self, slot: int, shed: bool = False) -> None:
        st = self._slots[slot]
        deadline = st.deadline_vms
        slo_met: bool | None = None
        if shed:
            slo_met = False
            self._slo_stats["missed"] += 1
        elif deadline is not None:
            slo_met = self._vtime_ms <= deadline
            self._slo_stats["met" if slo_met else "missed"] += 1
        self._completions.append(Completion(
            request_id=st.request.request_id,
            tokens=list(st.generated),
            slot=slot,
            admitted_step=st.admitted_step,
            finished_step=self._step_idx,
            logits=torch.stack(st.logits) if st.logits else None,
            slo_met=slo_met,
            shed=shed))
        self._slots[slot] = None
        self._lens[slot] = 0

    def _shed_expired(self) -> int:
        """Evict in-flight requests whose deadline has passed on the virtual
        clock (``SLOConfig.shed_admitted``); a prefilling slot's private
        cache is dropped."""
        if self._slo is None or not self._slo.shed_admitted:
            return 0
        shed = 0
        for slot, st in enumerate(self._slots):
            if st is None or st.deadline_vms is None:
                continue
            if self._vtime_ms > st.deadline_vms:
                self._slo_stats["shed_admitted"] += 1
                self._evict(slot, shed=True)
                shed += 1
        return shed

    def shed_request(self, request_id: int) -> bool:
        """Drop a request wherever it is: queued, prefilling or decoding.

        Returns True when found.  An in-flight request completes with its
        tokens so far and ``shed=True``; a prefilling slot's private cache
        is dropped (nothing of it reached the batch cache).
        """
        for req in self._queue:
            if req.request_id == request_id:
                self._queue = collections.deque(
                    r for r in self._queue if r is not req)
                self._dequeued(req, shed=True)
                self._shed_completion(req)
                return True
        for slot, st in enumerate(self._slots):
            if st is not None and st.request.request_id == request_id:
                self._evict(slot, shed=True)
                return True
        return False

    # -- params hot swap -----------------------------------------------------

    def stage_params(self, params) -> None:
        """Stage a replacement serving tree; the next ``step()`` swaps it in
        before admission, so every request sees a consistent pack.  Staging
        again before the swap replaces the staged tree.  The swap bumps the
        params version and drops every prefix-cache entry: a prefix computed
        under the old pack is stale."""
        self._staged_params = params

    @property
    def swap_pending(self) -> bool:
        return self._staged_params is not None

    # -- step loop -----------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> list[Completion]:
        """One scheduling step: swap staged params, shed expired requests,
        admit, advance prefill chunks, run one batched decode wave over the
        decoding slots, evict finished requests.

        Returns the requests that finished on this step.
        """
        done_before = len(self._completions)
        if self._staged_params is not None:
            self.params = self._staged_params
            self._staged_params = None
            self._swap_steps.append(self._step_idx)
            self._params_version += 1
            if self._prefix_cache is not None:
                self._prefix_invalidated_entries += \
                    self._prefix_cache.invalidate()
        self._shed_expired()
        self._admit()
        chunked = self._advance_chunks()
        live = [i for i, s in enumerate(self._slots)
                if s is not None and s.phase == "decode"]
        if live:
            self._active_slot_steps += len(live)
            self.watchdog.start_step(self._step_idx)
            with tracing.span("engine.decode", step=self._step_idx,
                              rows=len(live)) as wave:
                with tracing.span("model.decode_step"):
                    logits, self._cache = self.model.decode_step(
                        self.params, self._cache,
                        self._tokens.to(self.device),
                        self._lens.to(self.device))
                nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu()
            # one clock for the wave: its span times it for the report
            # and for the watchdog
            dt = (wave.end_ns - wave.start_ns) * 1e-9
            self._decode_wall_s += dt
            self.watchdog.end_step(dt=dt)
            self._step_idx += 1
            for i in live:
                st = self._slots[i]
                st.generated.append(int(nxt[i]))
                if self.collect_logits:
                    st.logits.append(logits[i])
                self._tokens[i, 0] = nxt[i]
                self._lens[i] += 1
        worked = bool(live) or chunked > 0 or \
            len(self._completions) > done_before
        if worked:
            self._vtime_ms += self._step_ms
        for i in live:
            st = self._slots[i]
            if st is not None and \
                    len(st.generated) >= st.request.max_new_tokens:
                self._evict(i)
        self._last_step_worked = worked
        # beat after the evictions: a supervisor reads end-of-step state
        if worked and self.heartbeat is not None:
            self.heartbeat.beat(self._step_idx, active=self.n_active,
                                completed=len(self._completions))
        return self._completions[done_before:]

    def run(self, requests=None) -> list[Completion]:
        """Drain the queue (plus ``requests``, if given) to completion;
        returns all completions sorted by request_id.  Raises when the
        scheduler stalls: queued or active work but no progress for
        ``_STALL_LIMIT`` steps in a row (a ``prefill_budget`` below the
        chunk size)."""
        if requests is not None:
            self.submit_all(requests)
        stalls = 0
        while self._queue or self.n_active:
            self.step()
            stalls = 0 if self._last_step_worked else stalls + 1
            if stalls >= _STALL_LIMIT:
                raise RuntimeError(
                    f"scheduler stalled: {self.n_pending} pending / "
                    f"{self.n_active} active but no progress for "
                    f"{stalls} steps (prefill_budget "
                    f"{self.prefill_budget} < chunk {self.chunk_prefill}?)")
        return sorted(self._completions, key=lambda c: c.request_id)

    # -- reporting -----------------------------------------------------------

    def scheduler_report(self) -> dict:
        """Scheduler counters: slot occupancy, steps, measured decode rate,
        watchdog, prefill, prefix-cache and SLO counters, and under
        ``counters`` the tracer's (process-wide) counters with its next
        sequence number, ``seq``."""
        steps = self._step_idx
        gen_tokens = sum(len(c.tokens) for c in self._completions)
        occ = (self._active_slot_steps / (steps * self.batch_size)
               if steps else 0.0)
        rep = {
            "batch_size": self.batch_size,
            "steps": steps,
            "completed": len(self._completions),
            "pending": self.n_pending,
            "active": self.n_active,
            "generated_tokens": gen_tokens,
            "slot_occupancy": occ,
            "decode_wall_s": self._decode_wall_s,
            "wall_tok_s": (gen_tokens / self._decode_wall_s
                           if self._decode_wall_s else 0.0),
            "stragglers": len(self.watchdog.stragglers),
            "step_ema_s": self.watchdog.ema_s,
            "hangs": self._hangs,
            "swaps": len(self._swap_steps),
            "swap_steps": list(self._swap_steps),
            "prefill_traces": len(self._prefill_buckets),
            "chunk_traces": len(self._chunk_shapes),
            "prefill_chunks": self._prefill_chunks,
            "prefilled_tokens": self._prefilled_tokens,
            "counters": _tracer_snapshot(),
        }
        if self._prefix_cache is not None:
            pc = self._prefix_cache.stats()
            pc["invalidated_entries"] = self._prefix_invalidated_entries
            rep["prefix_cache"] = pc
        if self._slo is not None:
            rep["slo"] = dict(self._slo_stats, step_ms=self._step_ms)
        return rep

    def perf_report(self, flops_per_token: float | None = None) -> dict:
        """Scheduler counters + the session's batch-aware DRAM-side rates."""
        rep = self.scheduler_report()
        if self.session is not None:
            rep.update(self.session.perf_report(
                flops_per_token, batch_size=self.batch_size))
        return rep


class FleetServingEngine:
    """Data-parallel fleet of ``ServingEngine``s over per-lane sharded
    packs.

    One inner engine per "data" lane of a ``PUDFleetSession``.  Requests
    go to the lane whose prefix cache holds the longest prefix of the
    prompt (``prefix_probe``: repeated system prompts land where their KV
    already lives), round-robin otherwise; every lane keeps the
    single-engine semantics, so a request's tokens and logits equal a
    single-device ``ServingEngine``'s over the same requests, for every
    family that engine serves (the dense and MoE transformers and the
    SSM; the hybrid is refused as it refuses it).  Scheduler
    extensions pass through to every lane; ``prefix_cache=True`` builds
    one cache per lane (entries hold lane-local KV and must not cross
    lanes).  The model-parallel dimension lives inside each lane's params:
    every packed projection is a ``ShardedPackedTensor`` that runs on its
    shards' devices (``kernels.ops.pud_matmul_sharded``).
    """

    def __init__(self, model, lane_params, *, max_len: int,
                 fleet=None, sessions=None, batch_size: int | None = None,
                 **kw):
        if not lane_params:
            raise ValueError("need at least one data lane")
        if sessions is None and fleet is not None:
            # lane d's default batch size derives from its shard-0 session
            sessions = [row[0] for row in fleet.sessions]
        if sessions is None:
            sessions = [None] * len(lane_params)
        if isinstance(kw.get("prefix_cache"), PrefixCache) and \
                len(lane_params) > 1:
            raise ValueError(
                "a shared PrefixCache cannot span lanes (entries hold "
                "lane-local KV); pass prefix_cache=True for per-lane caches")
        self.fleet = fleet
        self.lanes = [
            ServingEngine(model, p, session=s, max_len=max_len,
                          batch_size=batch_size, **kw)
            for p, s in zip(lane_params, sessions)]
        self._next_lane = 0

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    @property
    def batch_size(self) -> int:
        return self.lanes[0].batch_size

    @property
    def n_pending(self) -> int:
        return sum(lane.n_pending for lane in self.lanes)

    @property
    def n_active(self) -> int:
        return sum(lane.n_active for lane in self.lanes)

    def submit(self, request: Request) -> int:
        """Place the request on the lane with the longest cached prefix of
        its prompt, else round-robin; returns the lane index."""
        best, best_len = None, 0
        for i, lane in enumerate(self.lanes):
            n = lane.prefix_probe(request.tokens)
            if n > best_len:
                best, best_len = i, n
        if best is None:
            best = self._next_lane
            self._next_lane = (best + 1) % len(self.lanes)
        self.lanes[best].submit(request)
        return best

    def submit_all(self, requests) -> None:
        for r in requests:
            self.submit(r)

    def stage_lane_params(self, lane: int, params) -> None:
        """Per-lane hot swap (drift recovery repacks one lane only)."""
        self.lanes[lane].stage_params(params)

    def step(self) -> list[Completion]:
        """Step every lane that has work; returns this step's
        completions."""
        done: list[Completion] = []
        for lane in self.lanes:
            if lane._queue or lane.n_active or lane.swap_pending:
                done.extend(lane.step())
        return done

    def run(self, requests=None) -> list[Completion]:
        """Drain every lane; all completions sorted by request_id."""
        if requests is not None:
            self.submit_all(requests)
        while any(lane._queue or lane.n_active for lane in self.lanes):
            self.step()
        comps = [c for lane in self.lanes for c in lane._completions]
        return sorted(comps, key=lambda c: c.request_id)

    # -- reporting -----------------------------------------------------------

    def scheduler_report(self) -> dict:
        """Fleet-merged counters plus the per-lane reports; the tracer's
        counters once, at the top."""
        reps = [lane.scheduler_report() for lane in self.lanes]
        for r in reps:
            del r["counters"]
        rep = {
            "n_lanes": len(self.lanes),
            "batch_size": self.batch_size,
            "steps": max(r["steps"] for r in reps),
            "completed": sum(r["completed"] for r in reps),
            "pending": sum(r["pending"] for r in reps),
            "active": sum(r["active"] for r in reps),
            "generated_tokens": sum(r["generated_tokens"] for r in reps),
            "slot_occupancy": (sum(r["slot_occupancy"] for r in reps)
                               / len(reps)),
            "lanes": reps,
            "counters": _tracer_snapshot(),
        }
        pcs = [r["prefix_cache"] for r in reps if "prefix_cache" in r]
        if pcs:
            hits = sum(p["hits"] for p in pcs)
            misses = sum(p["misses"] for p in pcs)
            rep["prefix_cache"] = {
                "entries": sum(p["entries"] for p in pcs),
                "bytes": sum(p["bytes"] for p in pcs),
                "hits": hits,
                "misses": misses,
                "hit_rate": (hits / (hits + misses)
                             if hits + misses else 0.0),
                "inserts": sum(p["inserts"] for p in pcs),
                "evictions": sum(p["evictions"] for p in pcs),
                "invalidations": sum(p["invalidations"] for p in pcs),
            }
        return rep

    def perf_report(self, flops_per_token: float | None = None) -> dict:
        """Merged scheduler counters + the fleet's aggregate rate model."""
        rep = self.scheduler_report()
        if self.fleet is not None:
            rep.update(self.fleet.perf_report(
                flops_per_token, batch_size=self.batch_size))
        return rep
