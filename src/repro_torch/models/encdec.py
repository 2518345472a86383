"""Encoder-decoder transformer, the whisper-large-v3 backbone (port of
``repro/models/encdec.py``).

The conv / mel frontend is a stub, as in the reference: the caller gives
frame embeddings [B, n_frames, d_model] (after the conv).  The encoder
adds fixed sinusoidal positions and runs non-causal self-attention and an
ungated GELU FFN (``gelu_tanh``); the decoder runs causal self-attention
(RoPE), cross-attention over the encoder output and the same FFN.

The decode cache is ``{"self_k", "self_v": [L, B, max_len, KV, Dh] (grow
with decode), "cross_k", "cross_v": [L, B, n_frames, KV, Dh]}``: the
cross K/V are computed once at prefill and stay as they are.

With attention packing the encoder's ``enc_layers/attn`` projections are
packed (they run once per prompt, on B x n_frames rows); the decoder's
``self_attn`` / ``cross_attn`` are in no packable scope and stay in bf16,
as in the reference.

``train_loss(params, batch)`` takes the batch's ``"frames"``; every encoder
and decoder layer is rematerialised under ``cfg.remat``.

Inside a lane's "model" group (``sharding_ctx.use_group``) every attention
splits its q heads, padded to a multiple of the axis (whisper's 20 on 16
to 32): the encoder's non-causal pass, the decoder's self-attention and
its cross-attention over the encoder's K/V (``attention.encoder_kv``,
``gqa_attention_split``, ``gqa_decode_split``), and both FFNs their "mlp"
dim; the cache leaves come as ``ModelBlocks`` where the rules split them
(the self K/V over kv heads or "kv_seq", the cross K/V over kv heads, the
frames whole).
"""
from __future__ import annotations

import dataclasses

import torch

from . import attention as attn_mod
from .attention import AttnConfig
from .layers import (chunked_softmax_xent, embed, embed_defs, ffn, ffn_defs,
                     logits_last, remat, rmsnorm, rmsnorm_defs, unembed_defs)
from .params import ParamDef, stack_defs
from .transformer import _cache_leaf, _put_rows, layer_slice, layer_slices


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    loss_chunk: int = 512
    kv_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def attn_config(self, causal: bool = True) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                          self.hd, self.rope_theta, causal=causal,
                          kv_chunk=self.kv_chunk)


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """[n, d] float32 positions: sin then cos of pos / 10000^(2i / d)."""
    pos = torch.arange(n, device=device)[:, None].to(torch.float32)
    dim = torch.arange(d // 2, device=device)[None, :].to(torch.float32)
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM:
    #: the "model" axis splits this family's compute (``runtime/steps``)
    model_split = True

    def __init__(self, cfg: EncDecConfig):
        self.cfg = cfg

    def param_defs(self) -> dict:
        c = self.cfg
        enc_layer = {
            "ln1": rmsnorm_defs(c.d_model),
            "attn": attn_mod.gqa_defs(c.attn_config(False), c.dtype),
            "ln2": rmsnorm_defs(c.d_model),
            "ffn": ffn_defs(c.d_model, c.d_ff, gated=False, dtype=c.dtype),
        }
        dec_layer = {
            "ln1": rmsnorm_defs(c.d_model),
            "self_attn": attn_mod.gqa_defs(c.attn_config(True), c.dtype),
            "lnx": rmsnorm_defs(c.d_model),
            "cross_attn": attn_mod.gqa_defs(c.attn_config(False), c.dtype),
            "ln2": rmsnorm_defs(c.d_model),
            "ffn": ffn_defs(c.d_model, c.d_ff, gated=False, dtype=c.dtype),
        }
        return {
            "embed": embed_defs(c.vocab, c.d_model, c.dtype),
            "enc_layers": stack_defs(enc_layer, c.n_enc_layers),
            "enc_norm": rmsnorm_defs(c.d_model),
            "dec_layers": stack_defs(dec_layer, c.n_dec_layers),
            "final_norm": rmsnorm_defs(c.d_model),
            "unembed": unembed_defs(c.d_model, c.vocab, c.dtype),
        }

    def cache_defs(self, batch: int, max_len: int) -> dict:
        c = self.cfg
        kv = (c.n_dec_layers, batch, max_len, c.n_kv_heads, c.hd)
        xkv = (c.n_dec_layers, batch, c.n_frames, c.n_kv_heads, c.hd)
        axes = ("stack", "batch", "kv_seq", "kv_heads", "head_dim")
        xaxes = ("stack", "batch", "frames", "kv_heads", "head_dim")
        return {
            "self_k": ParamDef(kv, axes, dtype=c.dtype, init="zeros"),
            "self_v": ParamDef(kv, axes, dtype=c.dtype, init="zeros"),
            "cross_k": ParamDef(xkv, xaxes, dtype=c.dtype, init="zeros"),
            "cross_v": ParamDef(xkv, xaxes, dtype=c.dtype, init="zeros"),
        }

    # -- encoder -------------------------------------------------------------

    def _enc_layer(self, lp, h, positions):
        acfg = self.cfg.attn_config(False)
        hn = rmsnorm(lp["ln1"], h)
        kv = attn_mod.encoder_kv(lp["attn"], acfg, hn)
        a, _ = attn_mod.gqa_attention(lp["attn"], acfg, hn, positions,
                                      kv_override=kv)
        h = h + a
        return h + ffn(lp["ffn"], rmsnorm(lp["ln2"], h), "gelu")

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, n_frames, d_model] (the stub frontend's output) ->
        the encoder output [B, n_frames, d_model]."""
        c = self.cfg
        b, n = frames.shape[:2]
        h = (frames + _sinusoid(n, c.d_model, frames.device)[None]).to(
            c.dtype)
        positions = torch.arange(n, device=frames.device).expand(b, n)
        for lp in layer_slices(params["enc_layers"], c.n_enc_layers):
            h = remat(c.remat, self._enc_layer, lp, h, positions)
        return rmsnorm(params["enc_norm"], h)

    # -- decoder -------------------------------------------------------------

    def _dec_layer(self, lp, h, memory, positions):
        """(h, self K/V (k, v), cross K/V)."""
        c = self.cfg
        self_cfg, cross_cfg = c.attn_config(True), c.attn_config(False)
        a, kv = attn_mod.gqa_attention(
            lp["self_attn"], self_cfg, rmsnorm(lp["ln1"], h), positions)
        h = h + a
        xkv = attn_mod.encoder_kv(lp["cross_attn"], cross_cfg, memory)
        a, _ = attn_mod.gqa_attention(
            lp["cross_attn"], cross_cfg, rmsnorm(lp["lnx"], h),
            positions, kv_override=xkv)
        h = h + a
        return h + ffn(lp["ffn"], rmsnorm(lp["ln2"], h), "gelu"), kv, xkv

    def _decoder_full(self, params, tokens: torch.Tensor,
                      memory: torch.Tensor, cache: dict | None = None):
        """The decoder over a whole prompt; with ``cache`` (``cache_defs``
        leaves), its self K/V rows [0, S) and the cross K/V are written
        there, else each layer is rematerialised under ``cfg.remat``.
        Returns the final-normed hidden states [B, S, D]."""
        c = self.cfg
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        h = embed(params["embed"], tokens).to(c.dtype)
        for i, lp in enumerate(layer_slices(params["dec_layers"],
                                            c.n_dec_layers)):
            h, (k, v), xkv = remat(c.remat and cache is None, self._dec_layer,
                                   lp, h, memory, positions)
            if cache is not None:
                _put_rows(cache["self_k"], i, s, k)
                _put_rows(cache["self_v"], i, s, v)
                for n, r in zip(("cross_k", "cross_v"), xkv):
                    _put_rows(cache[n], i, c.n_frames, r)
        return rmsnorm(params["final_norm"], h)

    def train_loss(self, params, batch: dict, rng=None):
        """batch: {"frames" [B, n_frames, d_model], "tokens", "labels",
        optional "mask"} -> (xent, {"xent"})."""
        memory = self.encode(params, batch["frames"])
        h = self._decoder_full(params, batch["tokens"], memory)
        loss, _ = chunked_softmax_xent(
            params["unembed"], h, batch["labels"], batch.get("mask"),
            chunk=min(self.cfg.loss_chunk, batch["tokens"].shape[1]))
        return loss, {"xent": loss}

    def prefill(self, params, tokens: torch.Tensor, frames: torch.Tensor,
                max_len: int | None = None):
        """Encode ``frames``, then run the decoder over the prompt: (logits
        [B, V] float32 of its last position, cache)."""
        b, s = tokens.shape
        memory = self.encode(params, frames)
        cache = {n: _cache_leaf(d.shape, d.axes, d.dtype, memory.device)
                 for n, d in self.cache_defs(b, max_len or s).items()}
        h = self._decoder_full(params, tokens, memory, cache)
        return logits_last(params["unembed"], h[:, -1]), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, cur_len):
        """tokens [B, 1] at position ``cur_len`` (an int or a [B] tensor)
        -> (logits [B, V], cache; the self K/V written in place)."""
        c = self.cfg
        h = embed(params["embed"], tokens).to(c.dtype)
        self_cfg, cross_cfg = c.attn_config(True), c.attn_config(False)
        for i in range(c.n_dec_layers):
            lp = layer_slice(params["dec_layers"], i)
            h = h + attn_mod.gqa_decode(
                lp["self_attn"], self_cfg, rmsnorm(lp["ln1"], h),
                layer_slice(cache["self_k"], i),
                layer_slice(cache["self_v"], i), cur_len)
            h = h + attn_mod.gqa_decode(
                lp["cross_attn"], cross_cfg, rmsnorm(lp["lnx"], h),
                layer_slice(cache["cross_k"], i),
                layer_slice(cache["cross_v"], i), cur_len, cross=True)
            h = h + ffn(lp["ffn"], rmsnorm(lp["ln2"], h), "gelu")
        h = rmsnorm(params["final_norm"], h)
        return logits_last(params["unembed"], h[:, -1]), cache
