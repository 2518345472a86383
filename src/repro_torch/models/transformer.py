"""Decoder-only transformer LM, dense GQA family (port of the dense half of
``repro/models/transformer.py``; MoE and MLA are not ported yet).

The parameter tree is the reference's: layers are stacked per homogeneous
run under ``layers_<g>_<kind>`` with a leading layer axis, and packed
projections appear as ``<name>_pud`` ``PackedTensor``s beside (or instead
of) their float weights.  The forward walks the layers in a Python loop,
slicing layer ``i`` out of every stacked leaf.

Entry points: ``param_defs()``, ``cache_defs(batch, max_len)``,
``prefill(params, tokens, max_len, last_idx)`` -> (logits [B, V] of the last
or the ``last_idx`` row, cache) and ``decode_step(params, cache, tokens,
cur_len)`` -> (logits [B, V], cache), with ``cur_len`` an int or a [B]
tensor of per-row lengths.  The decode step updates the cache in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.pud.packed import PackedTensor

from . import attention as attn_mod
from .attention import AttnConfig
from .layers import (embed, embed_defs, ffn, ffn_defs, logits_last, rmsnorm,
                     rmsnorm_defs, unembed_defs)
from .params import ParamDef, stack_defs


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
    dtype: torch.dtype = torch.bfloat16
    kv_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_config(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                          self.hd, self.rope_theta, self.qk_norm,
                          kv_chunk=self.kv_chunk)

    def groups(self) -> list[tuple[str, int]]:
        """Homogeneous layer runs: [(kind, count)]."""
        return [("dense", self.n_layers)]


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter (sub)tree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, PackedTensor):
        return tree.layer(i)
    return tree[i]


class TransformerLM:
    def __init__(self, cfg: LMConfig):
        self.cfg = cfg

    # -- parameter / cache metadata -----------------------------------------

    def _layer_defs(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": rmsnorm_defs(cfg.d_model),
            "attn": attn_mod.gqa_defs(cfg.attn_config(), cfg.dtype),
            "ln2": rmsnorm_defs(cfg.d_model),
            "mixer": ffn_defs(cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                              cfg.dtype),
        }

    def param_defs(self) -> dict:
        cfg = self.cfg
        defs = {
            "embed": embed_defs(cfg.vocab, cfg.d_model, cfg.dtype),
            "final_norm": rmsnorm_defs(cfg.d_model),
            "unembed": unembed_defs(cfg.d_model, cfg.vocab, cfg.dtype),
        }
        for gi, (kind, count) in enumerate(cfg.groups()):
            defs[f"layers_{gi}_{kind}"] = stack_defs(self._layer_defs(),
                                                     count)
        return defs

    def cache_defs(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        caches = {}
        for gi, (kind, count) in enumerate(cfg.groups()):
            kv_shape = (count, batch, max_len, cfg.n_kv_heads, cfg.hd)
            axes = ("stack", "batch", "kv_seq", "kv_heads", "head_dim")
            caches[f"layers_{gi}_{kind}"] = {
                "k": ParamDef(kv_shape, axes, dtype=cfg.dtype, init="zeros"),
                "v": ParamDef(kv_shape, axes, dtype=cfg.dtype, init="zeros"),
            }
        return caches

    # -- forward -------------------------------------------------------------

    def _norm(self, p, h):
        return rmsnorm(p, h, zero_centered=self.cfg.zero_centered_norm)

    def _embed_tokens(self, params, tokens):
        cfg = self.cfg
        h = embed(params["embed"], tokens).to(cfg.dtype)
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                                 device=h.device)
        return h

    @property
    def supports_chunked_prefill(self) -> bool:
        """Whether bucketed (pow2-padded) prefill is exact for this config:
        True for the dense family (only MoE routing is sequence-global)."""
        return True

    def prefill(self, params, tokens: torch.Tensor,
                max_len: int | None = None, last_idx: int | None = None):
        """Process a full prompt; returns (logits [B, V] float32, cache
        {group: {"k", "v": [L, B, max_len, KV, Dh]}}).

        ``last_idx`` is the row whose logits are returned (the true last
        prompt position of a prompt zero-padded to a length bucket); by
        default the final row."""
        cfg = self.cfg
        b, s = tokens.shape
        max_len = max_len or s
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        h = self._embed_tokens(params, tokens)
        cache = {}
        for gi, (kind, count) in enumerate(cfg.groups()):
            name = f"layers_{gi}_{kind}"
            ck = torch.zeros((count, b, max_len, cfg.n_kv_heads, cfg.hd),
                             dtype=cfg.dtype, device=h.device)
            cv = torch.zeros_like(ck)
            for i in range(count):
                lp = layer_slice(params[name], i)
                a, (k, v) = attn_mod.gqa_attention(
                    lp["attn"], cfg.attn_config(), self._norm(lp["ln1"], h),
                    positions)
                ck[i, :, :s] = k
                cv[i, :, :s] = v
                h = h + a
                h = h + ffn(lp["mixer"], self._norm(lp["ln2"], h),
                            cfg.activation)
            cache[name] = {"k": ck, "v": cv}
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
            for i in range(count):
                lp = layer_slice(params[name], i)
                a = attn_mod.gqa_decode(
                    lp["attn"], cfg.attn_config(), self._norm(lp["ln1"], h),
                    cache[name]["k"][i], cache[name]["v"][i], cur_len)
                h = h + a
                h = h + ffn(lp["mixer"], self._norm(lp["ln2"], h),
                            cfg.activation)
        h = self._norm(params["final_norm"], h)
        return logits_last(params["unembed"], h[:, -1]), cache
