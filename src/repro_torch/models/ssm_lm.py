"""Attention-free SSM language model, the mamba2-1.3b family (port of
``repro/models/ssm_lm.py``).

A stack of Mamba2 / SSD blocks with pre-RMSNorm residuals over stacked
layer parameters, walked in a Python loop.  Decode carries a (conv
window, SSM state) per layer: O(1) in the sequence length.  The cache is
the flat tree ``{"conv": [L, B, W - 1, C], "state": [L, B, H, P, N]
float32}``: the batch on axis 1, as the serving engine needs, but no
sequence axis, so the engine's prefix cache (which keeps sequence rows)
does not apply to it.  Prompts prefill whole, at their exact length.
``train_loss`` runs the whole batch through the stack at once, each block
rematerialised under ``cfg.remat``.

Inside a lane's "model" group (``sharding_ctx.use_group``) every block's
mixer splits its heads over the positions (``ssm._mamba2_split``), the
cache leaves come as ``ModelBlocks`` (the conv window in ceil(C / M)
channel blocks, the state over its heads), and the logits and the loss
take the vocab-parallel forms (or, a vocab that does not divide the axis,
the contracted D split: ``layers.contract_parallel``).
"""
from __future__ import annotations

import dataclasses

import torch

from .layers import (chunked_softmax_xent, embed, embed_defs, logits_last,
                     remat, rmsnorm, rmsnorm_defs, unembed_defs)
from .params import ParamDef, stack_defs
from .sharding_ctx import cat, set_layer, stack
from .ssm import SSMConfig, mamba2_block, mamba2_decode, mamba2_defs
from .transformer import layer_slice, layer_slices


@dataclasses.dataclass(frozen=True)
class SSMLMConfig:
    name: str
    n_layers: int
    d_model: int
    d_state: int
    vocab: int
    d_inner: int | None = None
    head_dim: int = 64
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    loss_chunk: int = 512
    ssd_chunk: int = 128

    def ssm_config(self) -> SSMConfig:
        return SSMConfig(self.d_model, self.d_inner or 2 * self.d_model,
                         self.d_state, self.head_dim, chunk=self.ssd_chunk)


def mamba_cache_defs(s: SSMConfig, n: int, batch: int, dtype) -> dict:
    """The (conv window, SSM state) cache of ``n`` stacked Mamba2 blocks."""
    return {
        "conv": ParamDef((n, batch, s.d_conv - 1, s.conv_channels),
                         ("stack", "batch", None, "ssm"), dtype=dtype,
                         init="zeros"),
        "state": ParamDef((n, batch, s.n_heads, s.head_dim, s.d_state),
                          ("stack", "batch", "ssm", None, None),
                          dtype=torch.float32, init="zeros"),
    }


def _mamba_residual(ssm: SSMConfig, lp, h: torch.Tensor):
    out, (conv, state) = mamba2_block(lp["mamba"], ssm, rmsnorm(lp["ln"], h))
    return h + out, conv, state


def mamba_stack_full(ssm: SSMConfig, stacked, h: torch.Tensor, n: int,
                     rematerialise: bool = False):
    """``n`` pre-norm Mamba2 residual blocks over a full sequence, each
    rematerialised in the backward pass with ``rematerialise``.  Returns
    (h, conv tails [n, B, W - 1, C], final states [n, B, H, P, N]; each
    ``ModelBlocks`` where a "model" group splits the cache leaf)."""
    convs, states = [], []
    for lp in layer_slices(stacked, n):
        h, conv, state = remat(rematerialise, _mamba_residual, ssm, lp, h)
        convs.append(conv)
        states.append(state)
    return h, stack(convs), stack(states)


def mamba_stack_decode(ssm: SSMConfig, stacked, h: torch.Tensor,
                       cache: dict, n: int) -> torch.Tensor:
    """``n`` Mamba2 residual blocks on one token; the blocks' windows and
    states in ``cache`` (``{"conv", "state"}``, leading axis n; tensors or
    ``ModelBlocks``) are replaced in place."""
    for i in range(n):
        lp = layer_slice(stacked, i)
        out, (conv, state) = mamba2_decode(
            lp["mamba"], ssm, rmsnorm(lp["ln"], h),
            (layer_slice(cache["conv"], i), layer_slice(cache["state"], i)))
        h = h + out
        set_layer(cache["conv"], i, conv)
        set_layer(cache["state"], i, state)
    return h


class SSMLM:
    #: the "model" axis splits this family's compute (``runtime/steps``)
    model_split = True

    def __init__(self, cfg: SSMLMConfig):
        self.cfg = cfg
        self.ssm = cfg.ssm_config()

    def param_defs(self) -> dict:
        c = self.cfg
        layer = {"ln": rmsnorm_defs(c.d_model),
                 "mamba": mamba2_defs(self.ssm, c.dtype)}
        return {
            "embed": embed_defs(c.vocab, c.d_model, c.dtype),
            "layers": stack_defs(layer, c.n_layers),
            "final_norm": rmsnorm_defs(c.d_model),
            "unembed": unembed_defs(c.d_model, c.vocab, c.dtype),
        }

    def cache_defs(self, batch: int, max_len: int) -> dict:
        return mamba_cache_defs(self.ssm, self.cfg.n_layers, batch,
                                self.cfg.dtype)

    def train_loss(self, params, batch: dict, rng=None):
        """batch: {"tokens", "labels", optional "mask"} -> (xent,
        {"xent"}); the whole batch runs through the stack at once."""
        c = self.cfg
        tokens = batch["tokens"]
        h = embed(params["embed"], tokens).to(c.dtype)
        h, _, _ = mamba_stack_full(self.ssm, params["layers"], h, c.n_layers,
                                   c.remat)
        h = rmsnorm(params["final_norm"], h)
        loss, _ = chunked_softmax_xent(params["unembed"], h, batch["labels"],
                                       batch.get("mask"),
                                       chunk=min(c.loss_chunk,
                                                 tokens.shape[1]))
        return loss, {"xent": loss}

    def prefill(self, params, tokens: torch.Tensor,
                max_len: int | None = None):
        """Process whole prompts: (logits [B, V] float32 of their last
        position, cache).  ``max_len`` is accepted for the serving
        protocol; the cache does not depend on it.

        Each row runs the stack on its own, at batch 1, as the serving
        engine prefills a request: a row's logits and cache then do not
        depend on the batch.  On the GPU cuBLAS picks a bf16 GEMM's
        algorithm, and with it the summation order, by the row count:
        mamba2-1.3b's ``wo`` (K 4,096) over 4 x 32 rows rounds differently
        from 32 rows on the H100, and the engine's tokens then leave
        lockstep's."""
        rows = []
        for r in range(tokens.shape[0]):
            h = embed(params["embed"], tokens[r:r + 1]).to(self.cfg.dtype)
            h, conv, state = mamba_stack_full(self.ssm, params["layers"], h,
                                              self.cfg.n_layers)
            h = rmsnorm(params["final_norm"], h)
            rows.append((logits_last(params["unembed"], h[:, -1]), conv,
                         state))
        logits, conv, state = zip(*rows)
        return (torch.cat(logits),
                {"conv": cat(conv, 1), "state": cat(state, 1)})

    def decode_step(self, params, cache, tokens: torch.Tensor,
                    cur_len=None):
        """tokens [B, 1] -> (logits [B, V], cache updated in place);
        ``cur_len`` (an int or a [B] tensor) is not needed: the state
        holds the position."""
        h = embed(params["embed"], tokens).to(self.cfg.dtype)
        h = mamba_stack_decode(self.ssm, params["layers"], h, cache,
                               self.cfg.n_layers)
        h = rmsnorm(params["final_norm"], h)
        return logits_last(params["unembed"], h[:, -1]), cache
