"""Deterministic, resumable, host-partitioned data stream (port of
``repro/runtime/data.py``).

No corpus ships with the repo, so batches are synthetic but learnable:
packed rows of a mixture of Markov chains, as in the reference.

  * **Determinism**: the batch at step ``s`` for host ``h`` is a pure
    function of ``(seed, s, h)``: its generators are seeded from those
    three and a domain tag (``core.rng.generator``).  The draws run on the
    CPU, so the stream is the same whatever device trains on it; the
    numbers differ from the reference's ``jax.random`` stream, the
    semantics do not.
  * **Resumability**: the state is ``(seed, next_step)``; it rides in the
    checkpoint's metadata and a restore continues the exact stream.
  * **Host partitioning**: each host draws only its ``host_batch`` rows.
  * **Packing**: one document length per row in [64, 512), EOS at every
    position where ``pos % doc_len == doc_len - 1``; labels are the next
    token and ``mask`` drops the last column.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.rng import generator


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    n_chains: int = 8          # Markov mixture components
    order2_frac: float = 0.5   # fraction of order-2 positions
    eos_id: int = 1

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


def _chain_tables(cfg: DataConfig) -> torch.Tensor:
    """[n_chains, min(vocab, 512)] per-chain next-token logits (static)."""
    gen = generator(cfg.seed, "data-tables")
    return torch.randn((cfg.n_chains, min(cfg.vocab, 512)),
                       generator=gen) * 2.0


class DataPipeline:
    """Iterator with explicit state: ``state()`` / ``from_state``.  Batches
    are CPU tensors {"tokens", "labels": [host_batch, seq_len] int32,
    "mask": float32}."""

    def __init__(self, cfg: DataConfig, next_step: int = 0):
        self.cfg = cfg
        self.next_step = next_step
        self._tables = _chain_tables(cfg)

    # -- state (rides in checkpoint metadata) --------------------------------

    def state(self) -> dict:
        return {"seed": self.cfg.seed, "next_step": self.next_step}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: dict) -> "DataPipeline":
        if state["seed"] != cfg.seed:
            raise ValueError(f"pipeline seed changed mid-run: "
                             f"{state['seed']} -> {cfg.seed}")
        return cls(cfg, next_step=int(state["next_step"]))

    # -- batch generation -----------------------------------------------------

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step, host): the determinism contract."""
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        v = self._tables.shape[1]

        def gen(tag):
            return generator(cfg.seed, "data", step, cfg.host_id, tag)

        # per-row mixture component
        chain = torch.randint(0, cfg.n_chains, (b,), generator=gen("chain"))
        probs = torch.softmax(self._tables[chain], dim=-1)        # [b, v]

        # order-1 draws with an order-2 "echo": with prob order2_frac,
        # token t repeats the order-1 draw at t - 2 (+1 mod v), a pattern a
        # transformer learns quickly and a unigram model cannot
        toks = torch.multinomial(probs, s, replacement=True,
                                 generator=gen("tokens"))         # [b, s]
        echo = (torch.roll(toks, 2, dims=1) + 1) % v
        use_echo = torch.rand((b, s), generator=gen("echo")) \
            < cfg.order2_frac
        pos = torch.arange(s)[None, :]
        toks = torch.where((pos >= 2) & use_echo, echo, toks)

        # document packing: EOS every doc_len tokens, one length per row
        doc_len = torch.randint(64, 512, (b, 1), generator=gen("doc_len"))
        is_eos = (pos % doc_len) == (doc_len - 1)
        toks = torch.where(is_eos, cfg.eos_id, toks).to(torch.int32)

        labels = torch.roll(toks, -1, dims=1)
        mask = torch.ones((b, s), dtype=torch.float32)
        mask[:, -1] = 0.0
        return {"tokens": toks, "labels": labels, "mask": mask}

    def __next__(self) -> dict:
        b = self.batch_at(self.next_step)
        self.next_step += 1
        return b

    def __iter__(self):
        return self


def eval_batches(cfg: DataConfig, n: int, seed_offset: int = 10_000):
    """Fixed held-out batches (the stream of ``seed + seed_offset``)."""
    pipe = DataPipeline(dataclasses.replace(cfg, seed=cfg.seed + seed_offset))
    return [pipe.batch_at(i) for i in range(n)]
