"""PrefixCache: LRU reuse of prefill KV state across requests (port of
``repro/runtime/prefix_cache.py``).

After a prompt's prefill completes, the engine stores its KV cache, trimmed
to the exact token count so that no bucket-padding rows can reach a reader,
under

    (params_version, sha1(prompt tokens), n_tokens)

and later requests reuse it two ways:

  * **full hit**: an entry covering the whole new prompt (with its logits
    row); the engine copies the stored cache into a batch lane and starts
    decoding with no prefill work;
  * **partial hit**: an entry covering a chunk-aligned proper prefix (a
    shared system prompt); chunked prefill resumes at ``start = len(entry)``
    and pays only for the distinct suffix.

Guards: the engine bumps ``params_version`` on every ``stage_params`` hot
swap and ``invalidate()`` drops every entry; every lookup re-verifies the
stored tokens against the query's prefix (a hash collision or a cached
prompt longer than the query reads as a miss); prefixes below
``min_tokens`` are not stored.

Entries keep their KV tensors where the engine computed them (its device);
a stored entry holds exactly the rows a whole-bucket prefill produced for
those positions, so resuming from it is bit-identical to a miss.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

#: Prefixes shorter than this are never cached (bookkeeping > savings).
DEFAULT_MIN_TOKENS = 4

#: Default entry capacity.
DEFAULT_CAPACITY = 32


def _token_key(tokens: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(tokens, np.int32).tobytes()
                        ).hexdigest()


def _nbytes(tree: Any) -> int:
    """Bytes of every tensor in a (nested dict) KV tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return 0


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: the KV tree plus reuse metadata.

    ``cache`` leaves are [L, 1, n_tokens, KV, Dh], trimmed to the exact
    prefix length.  ``logits`` is the last position's logits row [V], kept
    for full-prompt entries only (a partial prefix's resumed chunk
    recomputes the real last position).
    """

    tokens: np.ndarray            # [n_tokens] int32, for exact verification
    cache: Any                    # KV tree, sequence axis trimmed
    logits: torch.Tensor | None
    nbytes: int

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])


class PrefixCache:
    """LRU over ``PrefixEntry``s keyed on (params version, token hash, len).

    Not thread-safe; the engine calls it from its scheduling loop only.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 min_tokens: int = DEFAULT_MIN_TOKENS,
                 max_bytes: int | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.min_tokens = int(min_tokens)
        self.max_bytes = max_bytes
        self._entries: collections.OrderedDict[tuple, PrefixEntry] = \
            collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    # -- lookup --------------------------------------------------------------

    def _get(self, version: int, tokens: np.ndarray,
             length: int) -> PrefixEntry | None:
        """Verified fetch of the entry covering ``tokens[:length]``."""
        if length < self.min_tokens or length > tokens.shape[0]:
            return None
        prefix = np.ascontiguousarray(tokens[:length], np.int32)
        entry = self._entries.get((version, _token_key(prefix), length))
        if entry is None:
            return None
        if entry.n_tokens != length or \
                not np.array_equal(entry.tokens, prefix):
            return None               # fail closed: collision, stale shape
        return entry

    def lookup(self, version: int, tokens, lengths) -> PrefixEntry | None:
        """Longest verified entry covering a prefix of ``tokens``.

        ``lengths``: candidate prefix lengths, best first (the engine
        passes the full prompt, then chunk-aligned lengths descending).
        Counts one hit or one miss per call; a hit refreshes LRU recency.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        for length in lengths:
            entry = self._get(version, tokens, int(length))
            if entry is not None:
                key = (version, _token_key(entry.tokens), entry.n_tokens)
                self._entries.move_to_end(key)
                self.hits += 1
                return entry
        self.misses += 1
        return None

    def probe(self, version: int, tokens, lengths) -> int:
        """Longest covered prefix length, without touching LRU state or
        the hit and miss counters."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        for length in lengths:
            if self._get(version, tokens, int(length)) is not None:
                return int(length)
        return 0

    # -- insert / evict ------------------------------------------------------

    def insert(self, version: int, tokens, cache,
               logits: torch.Tensor | None = None) -> bool:
        """Store a prefix; False when below ``min_tokens`` or already
        present (first writer wins: the values are identical)."""
        tokens = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1))
        n = int(tokens.shape[0])
        if n < self.min_tokens:
            return False
        key = (version, _token_key(tokens), n)
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        entry = PrefixEntry(tokens=tokens, cache=cache, logits=logits,
                            nbytes=_nbytes(cache))
        self._entries[key] = entry
        self._bytes += entry.nbytes
        self.inserts += 1
        self._shrink()
        return True

    def _shrink(self) -> None:
        while len(self._entries) > self.capacity or (
                self.max_bytes is not None and self._bytes > self.max_bytes
                and len(self._entries) > 1):
            _, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes
            self.evictions += 1

    def invalidate(self) -> int:
        """Drop every entry (params hot swap); returns how many."""
        n = len(self._entries)
        self._entries.clear()
        self._bytes = 0
        if n:
            self.invalidations += 1
        return n

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
        }
