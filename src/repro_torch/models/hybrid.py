"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* transformer
block (port of ``repro/models/hybrid.py``).

zamba2-7b has 81 positions: every 6th (5, 11, ..., 77: 13 uses) runs the
one shared attention + FFN block, specialised per use by a LoRA on the FFN
up-projection; the other 68 are Mamba2 blocks.  The parameters are a
doubly stacked ``segments`` tree ([13, 5, ...] Mamba2 blocks beside a
[13, ...] LoRA), the ``shared`` block, and a 3-block Mamba2 ``tail``.
Python loops walk the segments, the blocks within a segment, and the
tail, where the reference nests scans.

Decode: the Mamba2 states are O(1); the shared block keeps a KV cache per
use, 13 caches over the same weights, so memory and per-step work grow
with the sequence.  The cache is ``{"seg_mamba": {"conv", "state"}
[13, 5, B, ...], "shared_kv": {"k", "v"} [13, B, max_len, KV, Dh],
"tail_mamba": {"conv", "state"} [3, B, ...]}``: the segment caches carry
the batch on axis 2, which the serving engine refuses (so does the
reference's engine, which fails on this model).

With attention packing the shared block's wq / wk / wv / wo are packed
once and serve every use; its FFN sits under ``shared/ffn``, outside the
packable ``mixer`` scope, so it stays in bf16 as in the reference.

``train_loss`` rematerialises under ``cfg.remat`` as the reference's
nested ``jax.checkpoint``s do: every segment (its Mamba2 blocks and the
shared block's use) and, inside it and in the tail, every Mamba2 block.

Inside a "model" group (``sharding_ctx.use_group``) the blocks split:
the Mamba2 mixers their heads (``ssm._mamba2_split``), the shared block
its attention heads and FFN (``attention.gqa_attention_split``,
``layers.ffn``), each use's LoRA as ``_ffn_with_lora`` says, and a
prefill's cache leaves come as ``ModelBlocks`` where the rules split them
(``model_split``).  In float32 every sum the split divides accumulates in
float64 and rounds once, split or not (``layers``' module docstring), so a
split lane gives the unsplit lane's bits and the sharded train step's
gradients the one-device step's (``tests/test_torch_split_exact.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from . import attention as attn_mod
from .attention import AttnConfig
from .layers import (chunked_softmax_xent, column_parallel,
                     contract_parallel, embed, embed_defs, ffn, ffn_defs,
                     logits_last, product, remat, rmsnorm, rmsnorm_defs,
                     row_parallel, sum_product, unembed_defs)
from .layers import shared as shared_form
from .params import ParamDef, stack_defs
from .sharding_ctx import is_blocks, set_layer
from .ssm import SSMConfig, mamba2_defs
from .ssm_lm import mamba_cache_defs, mamba_stack_decode, mamba_stack_full
from .transformer import _cache_leaf, _put_rows, layer_slice, layer_slices


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_blocks: int            # total positions (81)
    shared_every: int        # every Nth position is the shared block (6)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_state: int
    ssm_head_dim: int = 64
    lora_rank: int = 64
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    loss_chunk: int = 512
    kv_chunk: int = 1024
    ssd_chunk: int = 128

    @property
    def n_shared_uses(self) -> int:
        return self.n_blocks // self.shared_every          # 13

    @property
    def mamba_per_segment(self) -> int:
        return self.shared_every - 1                        # 5

    @property
    def n_tail(self) -> int:
        return (self.n_blocks
                - self.n_shared_uses * self.shared_every)   # 81 - 78 = 3

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def ssm_config(self) -> SSMConfig:
        return SSMConfig(self.d_model, 2 * self.d_model, self.d_state,
                         self.ssm_head_dim, chunk=self.ssd_chunk)

    def attn_config(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                          self.hd, self.rope_theta, kv_chunk=self.kv_chunk)


class HybridLM:
    #: a data lane's "model" positions split its compute
    #: (``runtime/steps.lane_group``)
    model_split = True

    def __init__(self, cfg: HybridConfig):
        self.cfg = cfg
        self.ssm = cfg.ssm_config()

    def _mamba_defs(self) -> dict:
        return {"ln": rmsnorm_defs(self.cfg.d_model),
                "mamba": mamba2_defs(self.ssm, self.cfg.dtype)}

    def _lora_defs(self) -> dict:
        """Per-use LoRA on the shared FFN's up-projection (the attention
        projections stay fully shared)."""
        c, r = self.cfg, self.cfg.lora_rank
        return {
            "ffn_a": ParamDef((c.d_model, r), ("embed", None), dtype=c.dtype,
                              init="scaled"),
            "ffn_b": ParamDef((r, c.d_ff), (None, "mlp"), dtype=c.dtype,
                              init="zeros"),
        }

    def param_defs(self) -> dict:
        c = self.cfg
        shared = {
            "ln1": rmsnorm_defs(c.d_model),
            "attn": attn_mod.gqa_defs(c.attn_config(), c.dtype),
            "ln2": rmsnorm_defs(c.d_model),
            "ffn": ffn_defs(c.d_model, c.d_ff, True, c.dtype),
        }
        return {
            "embed": embed_defs(c.vocab, c.d_model, c.dtype),
            "segments": stack_defs(
                {"mamba": stack_defs(self._mamba_defs(),
                                     c.mamba_per_segment),
                 "lora": self._lora_defs()},
                c.n_shared_uses),
            "shared": shared,
            "tail": stack_defs(self._mamba_defs(), c.n_tail),
            "final_norm": rmsnorm_defs(c.d_model),
            "unembed": unembed_defs(c.d_model, c.vocab, c.dtype),
        }

    def cache_defs(self, batch: int, max_len: int) -> dict:
        c = self.cfg
        seg = mamba_cache_defs(self.ssm, c.mamba_per_segment, batch, c.dtype)
        kv_shape = (c.n_shared_uses, batch, max_len, c.n_kv_heads, c.hd)
        axes = ("stack", "batch", "kv_seq", "kv_heads", "head_dim")
        return {
            "seg_mamba": {k: ParamDef((c.n_shared_uses,) + d.shape,
                                      ("stack",) + d.axes, d.dtype, d.init)
                          for k, d in seg.items()},
            "shared_kv": {n: ParamDef(kv_shape, axes, dtype=c.dtype,
                                      init="zeros") for n in ("k", "v")},
            "tail_mamba": mamba_cache_defs(self.ssm, c.n_tail, batch,
                                           c.dtype),
        }

    # -- shared transformer block with per-use LoRA --------------------------

    def _ffn_with_lora(self, shared, lora, hn: torch.Tensor) -> torch.Tensor:
        """The shared FFN plus the use's rank-r correction of its
        up-projection, taken through the raw ``wo``.

        Split over "model" (``ffn_b`` and ``wo`` over "mlp"): ``ffn_a``,
        which every position holds whole, over its contracted D
        (``contract_parallel``, as GSPMD splits it); ``ffn_b``
        column-parallel; the correction through each position's rows of
        ``wo`` with an all-reduce of its own, not the FFN's.  Each sum is
        rounded once to the compute dtype and the two are added in it, as
        the unsplit ``f + delta @ wo`` rounds its two products; one shared
        all-reduce would round their sum once instead.  wi, wg and
        ``ffn_a`` read hn's ``shared`` form."""
        x, dtype = shared_form(hn), hn.dtype
        f = ffn(shared["ffn"], x)
        wb, wo = lora["ffn_b"], shared["ffn"]["wo"]
        if is_blocks(wb):
            a = contract_parallel(x, lora["ffn_a"])
            return f + row_parallel(column_parallel(a, wb), wo, dtype)
        return f + sum_product(product(sum_product(x, lora["ffn_a"]), wb),
                               wo)

    def _segment_full(self, shared, seg, h, positions):
        """One segment in training: its Mamba2 blocks (each rematerialised
        under ``cfg.remat``), then the shared block with its LoRA."""
        c = self.cfg
        h, _, _ = mamba_stack_full(self.ssm, seg["mamba"], h,
                                   c.mamba_per_segment, c.remat)
        return self._shared_block_full(shared, seg["lora"], h, positions)[0]

    def _shared_block_full(self, shared, lora, h, positions):
        hn = rmsnorm(shared["ln1"], h)
        a, kv = attn_mod.gqa_attention(shared["attn"],
                                       self.cfg.attn_config(), hn, positions)
        h = h + a
        hn = rmsnorm(shared["ln2"], h)
        return h + self._ffn_with_lora(shared, lora, hn), kv

    def _shared_block_decode(self, shared, lora, h, k_cache, v_cache,
                             cur_len):
        hn = rmsnorm(shared["ln1"], h)
        h = h + attn_mod.gqa_decode(shared["attn"], self.cfg.attn_config(),
                                    hn, k_cache, v_cache, cur_len)
        hn = rmsnorm(shared["ln2"], h)
        return h + self._ffn_with_lora(shared, lora, hn)

    # -- forward -------------------------------------------------------------

    def train_loss(self, params, batch: dict, rng=None):
        """batch: {"tokens", "labels", optional "mask"} -> (xent,
        {"xent"})."""
        c = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        h = embed(params["embed"], tokens).to(c.dtype)
        shared = params["shared"]
        for seg in layer_slices(params["segments"], c.n_shared_uses):
            h = remat(c.remat, self._segment_full, shared, seg, h, positions)
        if c.n_tail:
            h, _, _ = mamba_stack_full(self.ssm, params["tail"], h, c.n_tail,
                                       c.remat)
        h = rmsnorm(params["final_norm"], h)
        loss, _ = chunked_softmax_xent(params["unembed"], h, batch["labels"],
                                       batch.get("mask"),
                                       chunk=min(c.loss_chunk, s))
        return loss, {"xent": loss}

    def prefill(self, params, tokens: torch.Tensor,
                max_len: int | None = None):
        """Process a whole prompt: (logits [B, V] float32 of its last
        position, cache with the shared block's K/V at rows [0, S))."""
        c = self.cfg
        b, s = tokens.shape
        max_len = max_len or s
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        h = embed(params["embed"], tokens).to(c.dtype)
        shared = params["shared"]
        cache = {k: {n: _cache_leaf(d.shape, d.axes, d.dtype, h.device)
                     for n, d in leaves.items()}
                 for k, leaves in self.cache_defs(b, max_len).items()}
        seg_c, kv = cache["seg_mamba"], cache["shared_kv"]
        for u in range(c.n_shared_uses):
            seg = layer_slice(params["segments"], u)
            h, conv, state = mamba_stack_full(self.ssm, seg["mamba"], h,
                                              c.mamba_per_segment)
            set_layer(seg_c["conv"], u, conv)
            set_layer(seg_c["state"], u, state)
            h, (k, v) = self._shared_block_full(shared, seg["lora"], h,
                                                positions)
            _put_rows(kv["k"], u, s, k)
            _put_rows(kv["v"], u, s, v)
        if c.n_tail:        # the smoke config has no tail
            h, conv, state = mamba_stack_full(self.ssm, params["tail"], h,
                                              c.n_tail)
            cache["tail_mamba"] = {"conv": conv, "state": state}
        h = rmsnorm(params["final_norm"], h)
        return logits_last(params["unembed"], h[:, -1]), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, cur_len):
        """tokens [B, 1] at position ``cur_len`` (an int or a [B] tensor)
        -> (logits [B, V], cache updated in place)."""
        c = self.cfg
        h = embed(params["embed"], tokens).to(c.dtype)
        shared = params["shared"]
        sm, kv = cache["seg_mamba"], cache["shared_kv"]
        for u in range(c.n_shared_uses):
            seg = layer_slice(params["segments"], u)
            h = mamba_stack_decode(self.ssm, seg["mamba"], h,
                                   {"conv": layer_slice(sm["conv"], u),
                                    "state": layer_slice(sm["state"], u)},
                                   c.mamba_per_segment)
            h = self._shared_block_decode(shared, seg["lora"], h,
                                          layer_slice(kv["k"], u),
                                          layer_slice(kv["v"], u), cur_len)
        h = mamba_stack_decode(self.ssm, params["tail"], h,
                               cache["tail_mamba"], c.n_tail)
        h = rmsnorm(params["final_norm"], h)
        return logits_last(params["unembed"], h[:, -1]), cache
