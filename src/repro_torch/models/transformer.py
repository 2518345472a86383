"""Decoder-only transformer LM covering the dense, MoE and MLA families
(port of ``repro/models/transformer.py``), and the text backbone of the
VLM.

The parameter tree is the reference's: layers are stacked per homogeneous
run under ``layers_<g>_<kind>`` with a leading layer axis, and packed
projections appear as ``<name>_pud`` ``PackedTensor``s beside (or instead
of) their float weights.  The forward walks the layers in a Python loop
over the stacked leaves unbound along the layer axis (``layer_slices``).
Layers group into homogeneous runs (deepseek-v2-lite: ``layers_0_dense``
then ``layers_1_moe``).

Entry points: ``param_defs()``, ``cache_defs(batch, max_len)``,
``train_loss(params, batch, rng=None)`` -> (xent + aux_loss_weight x the
MoE aux loss, {"xent", "aux"}), with each layer rematerialised in the
backward pass under ``cfg.remat`` (``layers.remat``),
``apply_backbone(params, h, positions)`` from embeddings (the VLM's
prefix, through ``_backbone``, which ``prefill`` runs too),
``prefill(params, tokens, max_len, last_idx)`` -> (logits [B, V] of the last
or the ``last_idx`` row, cache), ``prefill_chunk(params, tokens, cache,
start, kv_len=, last_idx=)`` -> (logits [B, V], cache), one chunk of a
prompt resumed into a cache, and ``decode_step(params, cache, tokens,
cur_len)`` -> (logits [B, V], cache), with ``cur_len`` an int or a [B]
tensor of per-row lengths.  The chunk and the decode step update the cache
in place.  MoE models prefill whole prompts only (``prefill_chunk``
raises): their routing is sequence-global.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.pud.packed import PackedTensor, ShardedPackedTensor

from . import attention as attn_mod
from .attention import AttnConfig, MLAConfig
from .layers import (chunked_softmax_xent, embed, embed_defs, ffn, ffn_defs,
                     logits_last, remat, rmsnorm, rmsnorm_defs, unembed_defs)
from .moe import MoEConfig, moe_defs, moe_ffn
from .params import ParamDef, stack_defs
from .sharding_ctx import ModelBlocks, is_blocks, model_group


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    activation: str = "silu"
    gated_ffn: bool = True
    qk_norm: bool = False
    rope_theta: float = 10000.0
    embed_scale: bool = False            # gemma-style sqrt(d) embed scaling
    zero_centered_norm: bool = False     # gemma-style (1 + scale) RMSNorm
    # attention family
    attention: str = "gqa"               # "gqa" | "mla"
    mla_kv_rank: int = 512
    mla_qk_nope: int = 128
    mla_qk_rope: int = 64
    mla_v_dim: int = 128
    # MoE (n_experts 0: dense)
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    loss_chunk: int = 512
    kv_chunk: int = 1024
    aux_loss_weight: float = 0.01

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_config(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                          self.hd, self.rope_theta, self.qk_norm,
                          kv_chunk=self.kv_chunk)

    def mla_config(self) -> MLAConfig:
        return MLAConfig(self.d_model, self.n_heads, self.mla_kv_rank,
                         self.mla_qk_nope, self.mla_qk_rope, self.mla_v_dim,
                         self.rope_theta, kv_chunk=self.kv_chunk)

    def moe_config(self) -> MoEConfig:
        d_ff = self.moe_d_ff or self.d_ff
        return MoEConfig(self.d_model, self.n_experts, self.top_k, d_ff,
                         self.n_shared_experts, self.n_shared_experts * d_ff,
                         activation=self.activation)

    def groups(self) -> list[tuple[str, int]]:
        """Homogeneous layer runs: [(kind, count)]."""
        if not self.is_moe:
            return [("dense", self.n_layers)]
        out = []
        if self.first_dense_layers:
            out.append(("dense", self.first_dense_layers))
        out.append(("moe", self.n_layers - self.first_dense_layers))
        return out


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter (sub)tree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, (PackedTensor, ShardedPackedTensor, ModelBlocks)):
        return tree.layer(i)
    return tree[i]


def layer_slices(tree, n: int) -> list:
    """The ``n`` layers of a stacked (sub)tree, each as ``layer_slice``
    gives it.  Tensors are unbound once, so the backward pass stacks their
    layers' gradients in one operation (``tree[i]`` per layer would
    scatter each into a zeroed copy of the whole stack)."""
    if isinstance(tree, dict):
        per_key = {k: layer_slices(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if isinstance(tree, (PackedTensor, ShardedPackedTensor)):
        return [tree.layer(i) for i in range(n)]
    if isinstance(tree, ModelBlocks):
        return tree.layers(n)
    return list(tree.unbind(0))


def _cache_leaf(shape, axes, dtype, device):
    """A zero cache leaf of a prefill: whole, or inside a "model" group
    whose rules split it (kv heads or kv_seq on "model", evenly) one
    zero block per position (``ModelBlocks``)."""
    g = model_group()
    dim = None if g is None else g.split_dim(axes, shape)
    if dim is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    parts = []
    for k in g.active:
        lo, hi = g.bounds(shape[dim], k)
        part = list(shape)
        part[dim] = hi - lo
        parts.append(torch.zeros(part, dtype=dtype, device=g.devices[k]))
    return ModelBlocks(parts, dim, shape[dim], tuple(g.active), g.size)


def _put_rows(leaf, i: int, s: int, r) -> None:
    """Layer ``i``'s rows [0, s) of a prefill cache leaf from its
    attention's rows ``r`` (whole, or ``ModelBlocks`` over the kv heads);
    a split leaf takes each position's block (kv heads, or rows of its
    sequence block)."""
    if not is_blocks(leaf):
        if is_blocks(r):
            r = model_group().all_gather(r.parts, 2, r.size)
        leaf[i, :, :s] = r
        return
    g = model_group()
    if is_blocks(r) and leaf.dim != 3:
        r = g.all_gather(r.parts, 2, r.size)
    for j, part in enumerate(leaf.parts):
        lo, hi = leaf.bounds(j)
        if leaf.dim == 2:                   # the sequence (kv_seq)
            n = max(0, min(hi, s) - lo)
            part[i, :, :n] = g.to(r[:, lo:lo + n], leaf.index[j])
        elif is_blocks(r):                  # kv heads, split alike
            part[i, :, :s] = r.parts[j]
        else:
            part[i, :, :s] = g.to(r[:, :, lo:hi], leaf.index[j])


class TransformerLM:
    #: the "model" axis splits this family's compute (``runtime/steps``)
    model_split = True

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg

    # -- parameter / cache metadata -----------------------------------------

    def _layer_defs(self, kind: str) -> dict:
        cfg = self.cfg
        if cfg.attention == "mla":
            attn = attn_mod.mla_defs(cfg.mla_config(), cfg.dtype)
        else:
            attn = attn_mod.gqa_defs(cfg.attn_config(), cfg.dtype)
        if kind == "moe":
            mixer = moe_defs(cfg.moe_config(), cfg.dtype)
        else:
            mixer = ffn_defs(cfg.d_model, cfg.d_ff, cfg.gated_ffn, cfg.dtype)
        return {
            "ln1": rmsnorm_defs(cfg.d_model),
            "attn": attn,
            "ln2": rmsnorm_defs(cfg.d_model),
            "mixer": mixer,
        }

    def param_defs(self) -> dict:
        cfg = self.cfg
        defs = {
            "embed": embed_defs(cfg.vocab, cfg.d_model, cfg.dtype),
            "final_norm": rmsnorm_defs(cfg.d_model),
            "unembed": unembed_defs(cfg.d_model, cfg.vocab, cfg.dtype),
        }
        for gi, (kind, count) in enumerate(cfg.groups()):
            defs[f"layers_{gi}_{kind}"] = stack_defs(self._layer_defs(kind),
                                                     count)
        return defs

    def _cache_leaves(self, count: int, batch: int,
                      max_len: int) -> dict[str, tuple]:
        """{leaf: (shape, axes)} of one group's cache: the latents ckv / kr
        for MLA, keys and values otherwise."""
        cfg = self.cfg
        if cfg.attention == "mla":
            axes = ("stack", "batch", "kv_seq", None)
            return {"ckv": ((count, batch, max_len, cfg.mla_kv_rank), axes),
                    "kr": ((count, batch, max_len, cfg.mla_qk_rope), axes)}
        kv_shape = (count, batch, max_len, cfg.n_kv_heads, cfg.hd)
        axes = ("stack", "batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": (kv_shape, axes), "v": (kv_shape, axes)}

    def cache_defs(self, batch: int, max_len: int) -> dict:
        return {f"layers_{gi}_{kind}": {
            n: ParamDef(shape, axes, dtype=self.cfg.dtype, init="zeros")
            for n, (shape, axes) in self._cache_leaves(count, batch,
                                                       max_len).items()}
            for gi, (kind, count) in enumerate(self.cfg.groups())}

    # -- forward -------------------------------------------------------------

    def _norm(self, p, h):
        return rmsnorm(p, h, zero_centered=self.cfg.zero_centered_norm)

    def _mix(self, kind: str, p, h_norm):
        """The layer's FFN: (output, MoE aux loss; 0.0 for dense)."""
        cfg = self.cfg
        if kind == "moe":
            return moe_ffn(p, cfg.moe_config(), h_norm)
        return ffn(p, h_norm, cfg.activation), 0.0

    def _ffn_residual(self, kind: str, lp, h):
        return h + self._mix(kind, lp["mixer"], self._norm(lp["ln2"], h))[0]

    def _embed_tokens(self, params, tokens):
        cfg = self.cfg
        h = embed(params["embed"], tokens).to(cfg.dtype)
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                                 device=h.device)
        return h

    @property
    def supports_chunked_prefill(self) -> bool:
        """Whether bucketed (pow2-padded) or chunked prefill is exact for
        this config.  MoE routing is sequence-global (capacity depends on
        the sequence length and top-C selection competes across all its
        positions), so MoE models keep the exact-length whole prompt."""
        return not self.cfg.is_moe

    def _layer(self, kind: str, lp, h, positions):
        """One layer over a full sequence: (h, its attention's cache rows
        (k, v) or MLA's (ckv, kr), MoE aux loss)."""
        cfg = self.cfg
        hn = self._norm(lp["ln1"], h)
        if cfg.attention == "mla":
            a, rows = attn_mod.mla_attention(lp["attn"], cfg.mla_config(), hn,
                                             positions)
        else:
            a, rows = attn_mod.gqa_attention(lp["attn"], cfg.attn_config(), hn,
                                             positions)
        h = h + a
        f, aux_l = self._mix(kind, lp["mixer"], self._norm(lp["ln2"], h))
        return h + f, rows, aux_l

    def _backbone(self, params, h: torch.Tensor, positions: torch.Tensor,
                  collect_cache: bool = False, max_len: int | None = None):
        """Every layer group over the embeddings h [B, S, D] (tokens or a
        wrapper's prefix, as the VLM's).  Returns (h before the final
        norm, cache, MoE aux loss summed over the layers): with
        ``collect_cache`` the cache {group: leaves [L, B, max_len, ...]}
        holds rows [0, S) ("k" / "v", or MLA's latents "ckv" / "kr"),
        else it is None and each layer is rematerialised under
        ``cfg.remat``."""
        cfg = self.cfg
        b, s = h.shape[:2]
        cache = {} if collect_cache else None
        aux = 0.0
        for gi, (kind, count) in enumerate(cfg.groups()):
            name = f"layers_{gi}_{kind}"
            leaves = None
            if collect_cache:
                leaves = {n: _cache_leaf(shape, axes, cfg.dtype, h.device)
                          for n, (shape, axes) in self._cache_leaves(
                              count, b, max_len or s).items()}
                cache[name] = leaves
            for i, lp in enumerate(layer_slices(params[name], count)):
                h, rows, aux_l = remat(cfg.remat and not collect_cache,
                                       self._layer, kind, lp, h, positions)
                if leaves is not None:
                    for leaf, r in zip(leaves.values(), rows):
                        _put_rows(leaf, i, s, r)
                aux = aux + aux_l
        return h, cache, aux

    def apply_backbone(self, params, h: torch.Tensor,
                       positions: torch.Tensor):
        """The hidden-state pipeline for wrappers (the VLM): (final-normed
        h [B, S, D], MoE aux loss)."""
        h, _, aux = self._backbone(params, h, positions)
        return self._norm(params["final_norm"], h), aux

    def train_loss(self, params, batch: dict, rng=None):
        """batch: {"tokens", "labels": [B, S] int, optional "mask" [B, S]}
        -> (xent + aux_loss_weight x aux, {"xent", "aux"}); ``rng`` is
        unused (the reference's signature)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        h, _, aux = self._backbone(params, self._embed_tokens(params, tokens),
                                   positions)
        h = self._norm(params["final_norm"], h)
        loss, _ = chunked_softmax_xent(params["unembed"], h, batch["labels"],
                                       batch.get("mask"),
                                       chunk=min(cfg.loss_chunk, s))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        return loss + cfg.aux_loss_weight * aux, {"xent": loss, "aux": aux}

    def prefill(self, params, tokens: torch.Tensor,
                max_len: int | None = None, last_idx: int | None = None):
        """Process a full prompt; returns (logits [B, V] float32, cache
        {group: leaves [L, B, max_len, ...]}: "k" / "v", or MLA's latents
        "ckv" / "kr").

        ``last_idx`` is the row whose logits are returned (the true last
        prompt position of a prompt zero-padded to a length bucket); by
        default the final row."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        h, cache, _ = self._backbone(params, self._embed_tokens(params,
                                                                tokens),
                                     positions, collect_cache=True,
                                     max_len=max_len)
        h = self._norm(params["final_norm"], h)
        h_last = h[:, -1] if last_idx is None else h[:, int(last_idx)]
        return logits_last(params["unembed"], h_last), cache

    def prefill_chunk(self, params, tokens: torch.Tensor, cache, start: int,
                      *, kv_len: int, last_idx: int | None = None):
        """Resume a prompt into an existing cache: one prefill chunk.

        tokens: [B, C], the prompt positions [start, start + C); ``cache``
        a decode cache (``cache_defs`` layout, leaves [L, B, Smax, ...])
        holding the earlier chunks at their positions, updated in place.
        Attention reads the first ``kv_len`` cache rows (the prompt's pow2
        bucket), so every row equals a whole-bucket prefill's
        (``attention.gqa_prefill_chunk``, ``mla_prefill_chunk``).
        ``last_idx``: the chunk-local row whose logits are returned (the
        prompt's last token); by default the chunk's last row.  Returns
        (logits [B, V] float32, cache).  MoE configs raise
        (``supports_chunked_prefill``).
        """
        cfg = self.cfg
        if not self.supports_chunked_prefill:
            raise NotImplementedError(
                "chunked prefill is not bit-exact for MoE configs "
                "(sequence-global router capacity); use whole-prompt "
                "prefill")
        h = self._embed_tokens(params, tokens)
        for gi, (kind, count) in enumerate(cfg.groups()):
            name = f"layers_{gi}_{kind}"
            c = cache[name]
            for i in range(count):
                lp = layer_slice(params[name], i)
                hn = self._norm(lp["ln1"], h)
                if cfg.attention == "mla":
                    a = attn_mod.mla_prefill_chunk(
                        lp["attn"], cfg.mla_config(), hn, c["ckv"][i],
                        c["kr"][i], start, kv_len)
                else:
                    a = attn_mod.gqa_prefill_chunk(
                        lp["attn"], cfg.attn_config(), hn, c["k"][i],
                        c["v"][i], start, kv_len)
                h = self._ffn_residual(kind, lp, h + a)
        h = self._norm(params["final_norm"], h)
        h_last = h[:, -1] if last_idx is None else h[:, int(last_idx)]
        return logits_last(params["unembed"], h_last), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, cur_len):
        """tokens: [B, 1] at position ``cur_len`` (an int, or a [B] tensor
        of per-row positions) -> (logits [B, V], cache)."""
        cfg = self.cfg
        h = self._embed_tokens(params, tokens)
        for gi, (kind, count) in enumerate(cfg.groups()):
            name = f"layers_{gi}_{kind}"
            c = cache[name]
            for i in range(count):
                lp = layer_slice(params[name], i)
                hn = self._norm(lp["ln1"], h)
                if cfg.attention == "mla":
                    a = attn_mod.mla_decode(
                        lp["attn"], cfg.mla_config(), hn,
                        layer_slice(c["ckv"], i), layer_slice(c["kr"], i),
                        cur_len)
                else:
                    a = attn_mod.gqa_decode(
                        lp["attn"], cfg.attn_config(), hn,
                        layer_slice(c["k"], i), layer_slice(c["v"], i),
                        cur_len)
                h = self._ffn_residual(kind, lp, h + a)
        h = self._norm(params["final_norm"], h)
        return logits_last(params["unembed"], h[:, -1]), cache
