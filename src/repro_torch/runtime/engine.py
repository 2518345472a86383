"""ServingEngine: continuous-batching request scheduler (port of
``repro/runtime/engine.py``, its default FIFO configuration).

  * **Requests** enter a queue (``submit``); each is one prompt plus a
    token budget.
  * **Slots**: the engine owns ``batch_size`` decode slots and one KV cache
    ``{group: {"k", "v": [L, batch_size, max_len, ...]}}``; every slot holds
    at most one in-flight request.
  * **Continuous batching**: admission and eviction happen at step
    granularity.  Before every decode step free slots are filled from the
    queue, in FIFO order; after it finished requests are evicted and their
    slots freed at once.
  * **Bucketed prefill**: a prompt is zero-padded at the tail to the next
    power of two and prefilled alone (batch 1); its logits are read at the
    true last token, and its cache goes into the slot's lane of the shared
    cache.  The pad rows' K/V stay in the lane, hidden by the per-row causal
    mask and overwritten as the request decodes.  Models whose padded
    prefill is not exact (``supports_chunked_prefill`` False: MoE routing
    is sequence-global) prefill at the exact prompt length instead.
  * **Per-slot positions**: one decode wave runs all slots at once with a
    [B] vector of cache lengths (``models/attention.gqa_decode``); free
    slots decode a dummy token at length 0, in their own lane only.

Every per-row computation (activation quantization, the integer bit-plane
kernels, attention masks, RMSNorm) is independent of the other rows, so a
request's tokens do not depend on what else is in the batch, as far as the
device's float operations are themselves independent of the batch size.

Batch size: with a ``PUDSession``, the default is its rate model's optimum
(``optimal_batch_size``).  PyTorch runs eagerly under
``torch.inference_mode()``; the cache is updated in place.  Chunked
prefill, the prefix cache, SLO admission and the multi-device fleet engine
are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import torch

from .watchdog import StepWatchdog

DEFAULT_MAX_BATCH = 32


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class Request:
    """One generation request: a prompt and a token budget."""

    request_id: int
    tokens: Any                   # [S] int prompt tokens (array-like)
    max_new_tokens: int

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


@dataclasses.dataclass
class _Slot:
    request: Request
    admitted_step: int
    generated: list[int]
    logits: list[torch.Tensor]


def _tree_device(tree) -> torch.device | None:
    """Device of the first tensor in a parameter tree (None if it has
    none)."""
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, dict) and (dev := _tree_device(v)) is not None:
            return dev
    return None


class ServingEngine:
    """Continuous-batching decode engine for one model + serving params.

    ``params`` is the serving tree (``PackedModel.params`` for the PUD path
    or a bf16 tree); ``session`` is the ``PUDSession`` whose packed model is
    served: it gives the default batch size and the DRAM-side rate models
    of ``perf_report``.  The model must expose ``prefill(params, tokens,
    max_len=, last_idx=)`` and ``decode_step(params, cache, tokens,
    cur_len)`` taking a [B] ``cur_len`` (the dense transformer does).
    """

    def __init__(self, model, params, *, max_len: int, session=None,
                 batch_size: int | None = None,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 collect_logits: bool = False,
                 watchdog: StepWatchdog | None = None):
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

        self._queue: collections.deque[Request] = collections.deque()
        self._slots: list[_Slot | None] = [None] * self.batch_size
        self._cache = None                       # allocated on first admit
        # host-side slot state, copied to the device once per step
        self._tokens = torch.zeros((self.batch_size, 1), dtype=torch.int32)
        self._lens = torch.zeros((self.batch_size,), dtype=torch.int32)
        self._completions: list[Completion] = []
        self._step_idx = 0
        self._active_slot_steps = 0              # sum of live slots per step
        self._decode_wall_s = 0.0
        self._prefill_buckets: set[int] = set()  # distinct prefill shapes
        self._prefilled_tokens = 0               # kv rows computed

        # Every decode step is bracketed by the watchdog (EMA step time,
        # stragglers, optional hang callback; none by default, so no
        # monitor thread starts).
        self.watchdog = watchdog if watchdog is not None else StepWatchdog()
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

    @staticmethod
    def _default_batch_size(session, max_batch: int) -> int:
        """The session's rate-model optimum, else a small fixed default."""
        if session is not None:
            pm = session.placement_perf_model() or session.tuned_perf_model()
            if hasattr(pm, "optimal_batch_size"):
                return max(1, pm.optimal_batch_size(max_batch))
        return max(1, min(4, max_batch))

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
        self._queue.append(request)

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
        """Distinct prefill shapes run (the reference counts compiled
        variants: the same number for a fresh engine)."""
        return len(self._prefill_buckets)

    def _admit(self) -> None:
        """Fill free slots from the queue, FIFO."""
        for slot in self.free_slots:
            if not self._queue:
                break
            self._admit_slot(slot, self._queue.popleft())

    def _admit_slot(self, slot: int, req: Request) -> None:
        """Batch-1 prefill (bucketed), inserted into lane ``slot``."""
        prompt = torch.as_tensor(req.tokens).reshape(-1).to(
            device=self.device, dtype=torch.int32)
        s = req.prompt_len
        sb = self._bucket(s)
        padded = torch.zeros((1, sb), dtype=torch.int32, device=self.device)
        padded[0, :s] = prompt
        logits, cache1 = self.model.prefill(self.params, padded,
                                            max_len=self.max_len,
                                            last_idx=s - 1)
        self._prefill_buckets.add(sb)
        self._prefilled_tokens += sb
        if self._cache is None:
            self._cache = {
                g: {n: torch.zeros(c.shape[:1] + (self.batch_size,)
                                   + c.shape[2:], dtype=c.dtype,
                                   device=c.device)
                    for n, c in kv.items()}
                for g, kv in cache1.items()}
        for g, kv in cache1.items():
            for n, c in kv.items():
                self._cache[g][n][:, slot] = c[:, 0]
        row = logits[0]
        first = int(torch.argmax(row))
        st = _Slot(request=req, admitted_step=self._step_idx,
                   generated=[first], logits=[])
        if self.collect_logits:
            st.logits.append(row)
        self._slots[slot] = st
        self._tokens[slot, 0] = first
        self._lens[slot] = s
        if len(st.generated) >= req.max_new_tokens:
            # degenerate budget: the prefill token already finishes it
            self._evict(slot)

    def _evict(self, slot: int) -> None:
        st = self._slots[slot]
        self._completions.append(Completion(
            request_id=st.request.request_id,
            tokens=list(st.generated),
            slot=slot,
            admitted_step=st.admitted_step,
            finished_step=self._step_idx,
            logits=torch.stack(st.logits) if st.logits else None))
        self._slots[slot] = None
        self._lens[slot] = 0

    # -- params hot swap -----------------------------------------------------

    def stage_params(self, params) -> None:
        """Stage a replacement serving tree; the next ``step()`` swaps it in
        before admission, so every request sees a consistent pack.  Staging
        again before the swap replaces the staged tree."""
        self._staged_params = params

    # -- step loop -----------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> list[Completion]:
        """One scheduling step: swap staged params, admit, run one batched
        decode wave over all slots, evict finished requests.

        Returns the requests that finished on this step.
        """
        done_before = len(self._completions)
        if self._staged_params is not None:
            self.params = self._staged_params
            self._staged_params = None
            self._swap_steps.append(self._step_idx)
        self._admit()
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if live:
            self._active_slot_steps += len(live)
            self.watchdog.start_step(self._step_idx)
            t0 = time.time()
            logits, self._cache = self.model.decode_step(
                self.params, self._cache, self._tokens.to(self.device),
                self._lens.to(self.device))
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu()
            self._decode_wall_s += time.time() - t0
            self.watchdog.end_step()
            self._step_idx += 1
            for i in live:
                st = self._slots[i]
                st.generated.append(int(nxt[i]))
                if self.collect_logits:
                    st.logits.append(logits[i])
                self._tokens[i, 0] = nxt[i]
                self._lens[i] += 1
            for i in live:
                if len(self._slots[i].generated) >= \
                        self._slots[i].request.max_new_tokens:
                    self._evict(i)
        return self._completions[done_before:]

    def run(self, requests=None) -> list[Completion]:
        """Drain the queue (plus ``requests``, if given) to completion;
        returns all completions sorted by request_id."""
        if requests is not None:
            self.submit_all(requests)
        while self._queue or self.n_active:
            self.step()
        return sorted(self._completions, key=lambda c: c.request_id)

    # -- reporting -----------------------------------------------------------

    def scheduler_report(self) -> dict:
        """Scheduler counters: slot occupancy, steps, measured decode rate,
        watchdog and prefill counters."""
        steps = self._step_idx
        gen_tokens = sum(len(c.tokens) for c in self._completions)
        occ = (self._active_slot_steps / (steps * self.batch_size)
               if steps else 0.0)
        return {
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
            "prefill_traces": self.prefill_trace_count,
            "prefilled_tokens": self._prefilled_tokens,
        }

    def perf_report(self, flops_per_token: float | None = None) -> dict:
        """Scheduler counters + the session's batch-aware DRAM-side rates."""
        rep = self.scheduler_report()
        if self.session is not None:
            rep.update(self.session.perf_report(
                flops_per_token, batch_size=self.batch_size))
        return rep
