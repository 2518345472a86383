"""VLM wrapper, the pixtral-12b backbone (port of
``repro/models/multimodal.py``): a text decoder with a projected patch
prefix.

The ViT frontend is a stub, as in the reference: the caller gives patch
embeddings [B, n_patches, d_vit].  A two-layer MLP projector, ``gelu(
patches @ w1) @ w2`` with the tanh GELU of ``jax.nn.gelu``'s default
(``gelu_tanh``), maps them into the text model's embedding space, and
they are prepended to the prompt's embeddings.  The cache therefore spans
patches + text: decode positions start at prompt + n_patches, and a
serving ``max_len`` counts the patches too.  The text backbone is
``TransformerLM`` (its FFN under ``mixer``, packed as the dense archs').
``train_loss`` takes the batch's ``"patches"`` and scores the text
positions only.

Inside a lane's "model" group (``sharding_ctx.use_group``) the text
backbone splits as ``TransformerLM`` does, and the logits and the loss take
the vocab-parallel forms; the projector has no "model" dim (``w1`` (None,
"embed"), ``w2`` ("embed", None)) and every position computes it whole
(replicated work).
"""
from __future__ import annotations

import dataclasses

import torch

from .layers import chunked_softmax_xent, gelu_tanh, logits_last, rmsnorm
from .params import ParamDef
from .transformer import LMConfig, TransformerLM


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    lm: LMConfig
    n_patches: int = 256
    d_vit: int = 1024


class VLM:
    #: the "model" axis splits this family's compute (``runtime/steps``)
    model_split = True

    def __init__(self, cfg: VLMConfig):
        self.cfg = cfg
        self.lm = TransformerLM(cfg.lm)

    def param_defs(self) -> dict:
        c = self.cfg
        defs = self.lm.param_defs()
        defs["projector"] = {
            "w1": ParamDef((c.d_vit, c.lm.d_model), (None, "embed"),
                           dtype=c.lm.dtype, init="scaled"),
            "w2": ParamDef((c.lm.d_model, c.lm.d_model), ("embed", None),
                           dtype=c.lm.dtype, init="scaled"),
        }
        return defs

    def cache_defs(self, batch: int, max_len: int) -> dict:
        return self.lm.cache_defs(batch, max_len)

    def _prefix(self, params, patches: torch.Tensor) -> torch.Tensor:
        p, dtype = params["projector"], self.cfg.lm.dtype
        h = gelu_tanh(patches.to(dtype) @ p["w1"].to(dtype))
        return h @ p["w2"].to(dtype)

    def _embed_all(self, params, patches: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
        prefix = self._prefix(params, patches)               # [B, P, D]
        text = self.lm._embed_tokens(params, tokens)         # [B, S, D]
        return torch.cat([prefix, text], dim=1)

    def train_loss(self, params, batch: dict, rng=None):
        """batch: {"patches" [B, P, d_vit], "tokens", "labels": [B, St],
        optional "mask"} -> (xent over the text positions + the LM's
        aux_loss_weight x aux, {"xent", "aux"})."""
        c = self.cfg
        h = self._embed_all(params, batch["patches"], batch["tokens"])
        b, s, _ = h.shape
        positions = torch.arange(s, device=h.device).expand(b, s)
        h, aux = self.lm.apply_backbone(params, h, positions)
        h_text = h[:, c.n_patches:]
        loss, _ = chunked_softmax_xent(
            params["unembed"], h_text, batch["labels"], batch.get("mask"),
            chunk=min(c.lm.loss_chunk, h_text.shape[1]))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        return loss + c.lm.aux_loss_weight * aux, {"xent": loss, "aux": aux}

    def prefill(self, params, tokens: torch.Tensor, patches: torch.Tensor,
                max_len: int | None = None):
        """(logits [B, V] float32 of the last text position, cache over
        patches + text, rows [0, n_patches + S))."""
        h = self._embed_all(params, patches, tokens)
        b, s, _ = h.shape
        positions = torch.arange(s, device=h.device).expand(b, s)
        h, cache, _ = self.lm._backbone(params, h, positions,
                                        collect_cache=True,
                                        max_len=max_len or s)
        h = rmsnorm(params["final_norm"], h)      # the reference's plain norm
        return logits_last(params["unembed"], h[:, -1]), cache

    def decode_step(self, params, cache, tokens: torch.Tensor, cur_len):
        """As ``TransformerLM.decode_step``; ``cur_len`` counts the
        patches."""
        return self.lm.decode_step(params, cache, tokens, cur_len)
