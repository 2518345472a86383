"""The one traffic generator: a mix file of parameters (``traffic/<mix>.json``)
turned into a deterministic stream of requests for a seed.

A mix file holds::

    {"loop": "closed", "clients": 64,
     "prompt": {"median": 1536, "sigma": 0.6, "min": 256, "max": 4096,
                "multiple": 12},
     "output": {"median": 64, "sigma": 0.6, "min": 16, "max": 256},
     "pool": 512, "first_output": "residual"}

Lengths are lognormal (``median``, ``sigma`` of the log), clipped to
[``min``, ``max``] and rounded to a ``multiple`` (default 1).  Every seed
gets the same lengths in the same order: a pool of ``pool`` prompt
lengths and ``pool`` output lengths at the quantiles (i + 0.5) / pool,
each pass over the pool in an order fixed here, not by the seed.  So every
run does the same work; the seed draws the prompts' tokens (uniform over
the configuration's vocabulary, per request) and, elsewhere, the weights
and the simulated device.  With ``first_output: "residual"`` each
client's first request (the ones in flight when the run starts) keeps a
share (j + 0.5) / clients of its output length, the shares in a fixed
order too, so that completions start spread out as in steady state.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

from .seeds import sub_seed

#: Orders the lengths of every run alike, whatever its seed.
ORDER_SEED = 0


def _quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of the clipped
    lognormal ``spec``, rounded to its multiple."""
    nd = statistics.NormalDist()
    mult = int(spec.get("multiple", 1))
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = float(spec["median"]) * math.exp(float(spec["sigma"]) * z)
        x = min(max(x, lo), hi)
        x = int(round(x / mult)) * mult
        out.append(min(max(x, -(-lo // mult) * mult), hi // mult * mult))
    return np.asarray(out, dtype=np.int64)


@dataclasses.dataclass
class Item:
    index: int               # position in the stream (submission order)
    prompt_len: int
    max_new_tokens: int


class Traffic:
    """The request stream of one mix under one seed."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        if mix.get("loop", "closed") != "closed":
            raise ValueError(f"unsupported loop {mix.get('loop')!r}")
        self.mix = mix
        self.vocab = int(vocab)
        self.seed = int(seed)
        self.clients = int(mix["clients"])
        self.pool = int(mix.get("pool", 512))
        self._prompts = _quantile_lengths(mix["prompt"], self.pool)
        self._outputs = _quantile_lengths(mix["output"], self.pool)
        self._orders: dict[tuple[str, int], np.ndarray] = {}
        self._residual = mix.get("first_output") == "residual"
        rng = np.random.default_rng(sub_seed(ORDER_SEED, "first"))
        self._shares = (rng.permutation(self.clients) + 0.5) / self.clients

    @property
    def max_prompt(self) -> int:
        return int(self._prompts.max())

    @property
    def max_output(self) -> int:
        return int(self._outputs.max())

    def _order(self, kind: str, cycle: int) -> np.ndarray:
        key = (kind, cycle)
        if key not in self._orders:
            rng = np.random.default_rng(sub_seed(ORDER_SEED, kind, cycle))
            self._orders[key] = rng.permutation(self.pool)
        return self._orders[key]

    def item(self, k: int) -> Item:
        """The ``k``-th request submitted (0-based)."""
        cycle, j = divmod(int(k), self.pool)
        s = int(self._prompts[self._order("prompt", cycle)[j]])
        n = int(self._outputs[self._order("output", cycle)[j]])
        if self._residual and k < self.clients:
            lo = int(self.mix["output"]["min"])
            n = max(lo, int(math.ceil(n * float(self._shares[k]))))
        return Item(k, s, n)

    def tokens(self, k: int) -> np.ndarray:
        """The ``k``-th request's prompt: [prompt_len] int32 ids."""
        it = self.item(k)
        rng = np.random.default_rng(sub_seed(self.seed, "tokens", k))
        return rng.integers(0, self.vocab, size=it.prompt_len,
                            dtype=np.int64).astype(np.int32)
