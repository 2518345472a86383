"""Attention: GQA and MLA (DeepSeek's multi-head latent attention), each
full-sequence (chunked softmax), one prefill chunk resumed into a cache,
and one-token decode against a cache, at one position for all rows or at a
position per row; and the encoder-decoder's attention: a non-causal pass
over keys and values given from outside (``kv_override``), the encoder's
K/V (``encoder_kv``), and cross-attention decode against a static cache
(port of ``repro/models/attention.py``).

Layouts are the reference's: q/k/v [B, S, H, Dh], caches [B, Smax, KV, Dh]
(MLA: the latents ckv [B, Smax, R] and kr [B, Smax, dr]), weights wq/wk/wv
[D, H, Dh] and wo [H, Dh, D].  Score and PV products accumulate in float32
as the reference's ``preferred_element_type`` does.  The decode step and
the prefill chunk write their cache rows in place.  The full-sequence
attention and the prefill chunk pad their heads to the installed rules'
"model" axis, as the reference does (``_pad_heads``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import (compute_dtype, contract_parallel, product, rmsnorm,
                     rmsnorm_defs, rope, shared, sum_product)
from .params import ParamDef
from .sharding_ctx import (ModelBlocks, accum_dtype, is_blocks, model_group,
                           padded_head_count)


def head_proj(p, name: str, x: torch.Tensor, heads: int,
              hdim: int) -> torch.Tensor:
    """x [..., D] @ [D, H, Dh] -> [..., H, Dh] (``layers.product``; x may
    come ``shared``), PUD-packed aware."""
    packed = p.get(name + "_pud")
    if packed is not None:
        from repro_torch.pud.gemv import pud_linear
        dtype = compute_dtype(x)
        y = pud_linear(x.to(dtype), packed).to(dtype)
        return y.reshape(y.shape[:-1] + (heads, hdim))
    return product(x, p[name], "...d,dhk->...hk")


def merge_proj(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """x [..., H, Dh] @ [H, Dh, D] -> [..., D] (``layers.sum_product``:
    the split divides the heads), PUD-packed aware."""
    packed = p.get(name + "_pud")
    if packed is not None:
        from repro_torch.pud.gemv import pud_linear
        flat = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
        return pud_linear(flat, packed).to(x.dtype)
    return sum_product(x, p[name], "...hk,hkd->...d")


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    causal: bool = True
    kv_chunk: int = 1024


def gqa_defs(cfg: AttnConfig, dtype=torch.bfloat16) -> dict:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim"),
                       dtype=dtype, init="scaled"),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                       dtype=dtype, init="scaled"),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                       dtype=dtype, init="scaled"),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed"),
                       dtype=dtype, init="scaled"),
    }
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_defs(hd)
        defs["k_norm"] = rmsnorm_defs(hd)
    return defs


def _flash(q, k, v, *, causal: bool, kv_chunk: int, q_offset: int = 0):
    """Chunked softmax attention with a running (max, sum, accumulator).

    q: [B, Sq, H, D]; k, v: [B, Skv, KV, D] with H = KV * G.  Returns
    [B, Sq, H, D] in q's dtype.  GQA repeats kv to the full head count.
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = torch.tensor(d ** -0.5, dtype=torch.float32, device=q.device)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    n_chunks = max(1, skv // kv_chunk)
    if skv % n_chunks:
        raise ValueError(f"kv length {skv} does not split into {n_chunks}")
    cl = skv // n_chunks
    qf = q.to(torch.float32)
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    qpos = q_offset + torch.arange(sq, device=q.device)
    for idx in range(n_chunks):
        kb = k[:, idx * cl:(idx + 1) * cl].to(torch.float32)
        vb = v[:, idx * cl:(idx + 1) * cl]
        s = torch.einsum("bqhd,bphd->bhqp", qf, kb) * scale
        if causal:
            kpos = idx * cl + torch.arange(cl, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s,
                            torch.tensor(float("-inf"), device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqp,bphd->bhqd", p.to(vb.dtype).to(torch.float32),
                          vb.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _pad_heads(q, k, v):
    """Activation-level head padding (``sharding_ctx.padded_head_count``):
    when the installed rules' "model" axis does not divide the head count,
    k / v expand to the full head count (the GQA grouping, done eagerly)
    and q / k / v pad with zero heads to the next multiple.  Returns (q, k,
    v, true head count); the caller trims the output to that count before
    ``wo``.  Heads are independent, so the real heads' values do not move;
    without rules nothing changes."""
    h_true = q.shape[2]
    hp = padded_head_count(h_true)
    if hp != h_true:
        g = h_true // k.shape[2]
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        pad = (0, 0, 0, hp - h_true)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    return q, k, v, h_true


def gqa_attention(p, cfg: AttnConfig, x: torch.Tensor,
                  positions: torch.Tensor, kv_override=None):
    """Full-sequence attention (prefill). x: [B, S, D].

    Returns (out [B, S, D], (k, v)) with k, v [B, S, KV, Dh] for the cache.
    ``kv_override``: (k, v) [B, Skv, KV, Dh] from an encoder
    (``encoder_kv``): q is neither roped nor masked, and the (k, v)
    returned are the override's.  Under rules whose "model" axis does
    not divide the head count the heads are padded (``_pad_heads``); the
    cache keeps the true kv-head count.
    """
    g = model_group()
    if g is not None:
        return gqa_attention_split(g, p, cfg, x, positions, kv_override)
    x = shared(x)                 # wq, wk and wv read it
    q = head_proj(p, "wq", x, cfg.n_heads, cfg.head_dim)
    if kv_override is None:
        k = head_proj(p, "wk", x, cfg.n_kv_heads, cfg.head_dim)
        v = head_proj(p, "wv", x, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q)
            k = rmsnorm(p["k_norm"], k)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        causal = cfg.causal
    else:
        k, v = kv_override
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q)
        causal = False
    cache_kv = (k, v)
    q, k, v, h_true = _pad_heads(q, k, v)
    out = _flash(q, k, v, causal=causal,
                 kv_chunk=min(cfg.kv_chunk, k.shape[1]))
    return merge_proj(p, "wo", out[:, :, :h_true]), cache_kv


def encoder_kv(p, cfg: AttnConfig, memory: torch.Tensor):
    """Cross-attention K/V [B, Sm, KV, Dh] of encoder output memory [B, Sm,
    D]: projected, neither normalised nor roped.  Inside a "model" group
    each is whole or ``ModelBlocks`` of the positions' kv heads (as
    ``gqa_attention_split`` returns its cache rows)."""
    g = model_group()
    memory = shared(memory)
    if g is not None:
        return tuple(_rows_blocks(g, _proj_split(g, memory, p[n]),
                                  cfg.n_kv_heads) for n in ("wk", "wv"))
    k = head_proj(p, "wk", memory, cfg.n_kv_heads, cfg.head_dim)
    v = head_proj(p, "wv", memory, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def gqa_prefill_chunk(p, cfg: AttnConfig, x: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      start: int, kv_len: int) -> torch.Tensor:
    """Chunked-prefill attention: resume a prompt into an existing KV cache.

    x: [B, C, D], the chunk's hidden states at absolute positions [start,
    start + C); cache_k/v: [B, Smax, KV, Dh] holding every earlier chunk's
    keys and values at their positions.  The chunk's keys and values are
    written at ``start`` in place, and attention runs over the first
    ``kv_len`` cache rows (the prompt's pow2 bucket) with the causal mask
    anchored at ``q_offset=start``: row p sees exactly the keys 0..p that a
    whole-bucket prefill shows it, over the same ``kv_len``-row chunking
    of the softmax, so each row equals the whole prefill's.  The heads are
    padded as in ``gqa_attention``.  Returns out [B, C, D].
    """
    b, c, _ = x.shape
    start = int(start)
    positions = start + torch.arange(c, device=x.device).expand(b, c)
    dtype, x = x.dtype, shared(x)
    q = head_proj(p, "wq", x, cfg.n_heads, cfg.head_dim)
    k_new = head_proj(p, "wk", x, cfg.n_kv_heads, cfg.head_dim)
    v_new = head_proj(p, "wv", x, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k_new = rmsnorm(p["k_norm"], k_new)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)
    cache_k[:, start:start + c] = k_new.to(cache_k.dtype)
    cache_v[:, start:start + c] = v_new.to(cache_v.dtype)
    k = cache_k[:, :kv_len].to(dtype)
    v = cache_v[:, :kv_len].to(dtype)
    q, k, v, h_true = _pad_heads(q, k, v)
    out = _flash(q, k, v, causal=True, kv_chunk=min(cfg.kv_chunk, kv_len),
                 q_offset=start)
    return merge_proj(p, "wo", out[:, :, :h_true])


def _write_rows(cache: torch.Tensor, lens: torch.Tensor,
                new: torch.Tensor) -> None:
    """Write ``new[i]`` at row ``lens[i]`` of lane i of ``cache`` [B, Smax,
    ...] in place.  A lane whose length is already ``Smax`` keeps its last
    row (rewritten with its own value): the reference drops that write
    (``mode="drop"``)."""
    smax = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = torch.clamp(lens, max=smax - 1)
    keep = (lens >= smax).reshape((-1,) + (1,) * (cache.dim() - 2))
    cache[rows, at] = torch.where(keep, cache[rows, at], new.to(cache.dtype))


def gqa_decode(p, cfg: AttnConfig, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, cur_len: "int | torch.Tensor",
               cross: bool = False) -> torch.Tensor:
    """One-token decode. x: [B, 1, D]; cache_k/v: [B, Smax, KV, Dh].

    ``cur_len`` is the cache fill: an int (all rows at that position) or a
    [B] integer tensor of per-row lengths (continuous batching: each slot at
    its own position, with a per-row RoPE, cache write and causal mask).
    Rows are independent either way.  The new key/value row is written into
    the caches in place; a row whose length is already ``Smax`` writes
    nothing (the reference drops that write).  ``cross``: the caches hold
    an encoder's K/V: q is not roped, nothing is written and every one of
    the ``Smax`` rows is attended.  Returns out [B, 1, D].
    """
    g = model_group()
    if g is not None:
        return gqa_decode_split(g, p, cfg, x, cache_k, cache_v, cur_len,
                                cross)
    b, smax = cache_k.shape[0], cache_k.shape[1]
    per_slot = isinstance(cur_len, torch.Tensor) and cur_len.dim() == 1
    if per_slot:
        lens = cur_len.to(device=x.device, dtype=torch.int64)
    else:
        cur_len = int(cur_len)
    x = shared(x)
    q = head_proj(p, "wq", x, cfg.n_heads, cfg.head_dim)
    if cross:
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q)
        mask = None
    else:
        k_new = head_proj(p, "wk", x, cfg.n_kv_heads, cfg.head_dim)
        v_new = head_proj(p, "wv", x, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q)
            k_new = rmsnorm(p["k_norm"], k_new)
        pos = (lens[:, None] if per_slot else
               torch.full((b, 1), cur_len, dtype=torch.int64,
                          device=x.device))
        q = rope(q, pos, cfg.rope_theta)
        k_new = rope(k_new, pos, cfg.rope_theta)
        if per_slot:
            _write_rows(cache_k, lens, k_new[:, 0])
            _write_rows(cache_v, lens, v_new[:, 0])
            mask = (torch.arange(smax, device=x.device)[None, :]
                    < (lens + 1)[:, None])[:, None, None, :]
        else:
            cache_k[:, cur_len:cur_len + 1] = k_new.to(cache_k.dtype)
            cache_v[:, cur_len:cur_len + 1] = v_new.to(cache_v.dtype)
            mask = (torch.arange(smax, device=x.device)
                    < cur_len + 1)[None, None, None, :]
    return merge_proj(p, "wo", _decode_core(q, cache_k, cache_v, mask))


def _decode_core(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, mask) -> torch.Tensor:
    """One query row per sequence q [B, 1, H, Dh] against the cache [B,
    S, KV, Dh] (H = KV x G), float32 scores (``_scores``), the softmax's
    weights rounded to the cache dtype (``_softmax``), the product with the
    values one precision above it; returns [B, 1, H, Dh] in the cache
    dtype."""
    b, h, d = q.shape[0], q.shape[2], q.shape[3]
    kvh = cache_k.shape[2]
    g = h // kvh
    qr = q.reshape(b, kvh, g, d).to(torch.float32)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32, device=q.device)
    s = _scores(qr, cache_k, scale)
    if mask is not None:
        s = torch.where(mask, s,
                        torch.tensor(float("-inf"), device=q.device))
    acc = accum_dtype(cache_v.dtype)
    w = _softmax(s, cache_v.dtype)
    o = torch.einsum("bkgp,bpkd->bkgd", w.to(cache_v.dtype).to(acc),
                     cache_v.to(acc)).to(cache_v.dtype)
    return o.reshape(b, 1, h, d)


def _scores(qr: torch.Tensor, cache_k: torch.Tensor, scale) -> torch.Tensor:
    """float32 scores [B, KV, G, S] of the query rows qr [B, KV, G, Dh]
    against the keys [B, S, KV, Dh], times ``scale``: the product one
    precision above the cache dtype, rounded to float32.  (The batched
    product of a block of the kv heads, or of the rows, rounds otherwise
    than the whole one in float32.)"""
    acc = accum_dtype(cache_k.dtype)
    return torch.einsum("bkgd,bpkd->bkgp", qr.to(acc), cache_k.to(acc)).to(
        torch.float32) * scale


def _softmax(s: torch.Tensor, dtype) -> torch.Tensor:
    """The softmax of float32 scores ``s`` over their last dim against a
    cache of ``dtype``: bf16 through ``torch.softmax``; float32 as a cache
    split over its sequence takes it (``_seq_softmax_pv``: the max, the
    exponentials' sum in float64 rounded once), so that the two agree."""
    if accum_dtype(dtype) != torch.float64:
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    kv_chunk: int = 1024

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_defs(cfg: MLAConfig, dtype=torch.bfloat16) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": ParamDef((d, h, cfg.qk_dim), ("embed", "heads", None),
                       dtype=dtype, init="scaled"),
        "wdkv": ParamDef((d, cfg.kv_lora_rank), ("embed", None), dtype=dtype,
                         init="scaled"),
        "kv_norm": rmsnorm_defs(cfg.kv_lora_rank),
        "wkr": ParamDef((d, cfg.qk_rope_dim), ("embed", None), dtype=dtype,
                        init="scaled"),
        "wuk": ParamDef((cfg.kv_lora_rank, h, cfg.qk_nope_dim),
                        (None, "heads", None), dtype=dtype, init="scaled"),
        "wuv": ParamDef((cfg.kv_lora_rank, h, cfg.v_head_dim),
                        (None, "heads", None), dtype=dtype, init="scaled"),
        "wo": ParamDef((h, cfg.v_head_dim, d), ("heads", None, "embed"),
                       dtype=dtype, init="scaled"),
    }


def _mla_group(p):
    """The enclosing "model" group where MLA runs split (its q heads on
    "model"), None where it runs whole."""
    g = model_group()
    if g is not None and not is_blocks(p["wq"]):
        raise NotImplementedError(
            "MLA on a \"model\" group needs its heads split over it "
            f"({p['wq'].shape[1]} heads, {g.size} positions)")
    return g


def _mla_query(p, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope [B, S, H, dn], q_rope [B, S, H, dr] rotated)."""
    q = head_proj(p, "wq", x, cfg.n_heads, cfg.qk_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(p, cfg: MLAConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """(c_kv [B, S, R] normalised, k_rope [B, S, dr] rotated)."""
    c_kv = rmsnorm(p["kv_norm"], x @ p["wdkv"].to(x.dtype))
    k_rope = rope((x @ p["wkr"].to(x.dtype))[:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_flash(p, cfg: MLAConfig, q_nope, q_rope, ckv, kr, *, kv_chunk: int,
               q_offset: int = 0) -> torch.Tensor:
    """Causal attention over keys and values re-expanded from the latents
    ckv [B, S, R] / kr [B, S, dr]; v is zero-padded to ``qk_dim`` for
    ``_flash`` and trimmed after it, as the reference does.  Returns the
    merged output [B, Sq, D]."""
    dtype = q_nope.dtype
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wuk"].to(dtype))
    v = torch.einsum("bsr,rhk->bshk", ckv, p["wuv"].to(dtype))
    h = cfg.n_heads
    k = torch.cat([k_nope, kr[:, :, None, :].expand(-1, -1, h, -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    vpad = F.pad(v, (0, cfg.qk_dim - cfg.v_head_dim))
    out = _flash(q, k, vpad, causal=True, kv_chunk=kv_chunk,
                 q_offset=q_offset)
    return merge_proj(p, "wo", out[..., :cfg.v_head_dim])


def mla_attention(p, cfg: MLAConfig, x: torch.Tensor,
                  positions: torch.Tensor):
    """Full-sequence MLA (prefill).  Returns (out [B, S, D], (c_kv [B, S,
    R], k_rope [B, S, dr])) for the latent cache."""
    g = _mla_group(p)
    if g is not None:
        return mla_attention_split(g, p, cfg, x, positions)
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    c_kv, k_rope = _mla_latents(p, cfg, x, positions)
    out = _mla_flash(p, cfg, q_nope, q_rope, c_kv, k_rope,
                     kv_chunk=min(cfg.kv_chunk, x.shape[1]))
    return out, (c_kv, k_rope)


def mla_prefill_chunk(p, cfg: MLAConfig, x: torch.Tensor,
                      cache_ckv: torch.Tensor, cache_kr: torch.Tensor,
                      start: int, kv_len: int) -> torch.Tensor:
    """Chunked-prefill MLA: resume a prompt into the latent cache.

    x: [B, C, D] at absolute positions [start, start + C); cache_ckv [B,
    Smax, R] and cache_kr [B, Smax, dr].  The chunk's latents are written
    at ``start`` in place, and keys and values are re-expanded from the
    first ``kv_len`` cached latents: the up-projection a whole-bucket
    prefill applies, so each row equals the whole prefill's (see
    ``gqa_prefill_chunk``).  Returns out [B, C, D].
    """
    b, c, _ = x.shape
    start = int(start)
    positions = start + torch.arange(c, device=x.device).expand(b, c)
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    c_new, kr_new = _mla_latents(p, cfg, x, positions)
    cache_ckv[:, start:start + c] = c_new.to(cache_ckv.dtype)
    cache_kr[:, start:start + c] = kr_new.to(cache_kr.dtype)
    return _mla_flash(p, cfg, q_nope, q_rope,
                      cache_ckv[:, :kv_len].to(x.dtype),
                      cache_kr[:, :kv_len].to(x.dtype),
                      kv_chunk=min(cfg.kv_chunk, kv_len), q_offset=start)


def mla_decode(p, cfg: MLAConfig, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor,
               cur_len: "int | torch.Tensor") -> torch.Tensor:
    """One-token absorbed-matmul MLA decode: attention runs in the latent
    space (W_uk folded into the query, W_uv applied after), O(S (R + dr))
    per step.  x: [B, 1, D]; cache_ckv [B, Smax, R], cache_kr [B, Smax,
    dr]; ``cur_len`` an int or a [B] tensor, as in ``gqa_decode`` (a lane
    at ``Smax`` writes nothing).  Returns out [B, 1, D].

    The scores are products of bf16 values accumulated in float32 and stay
    float32 through the scale and the mask, as the reference's
    ``preferred_element_type=float32`` einsums are.
    """
    g = _mla_group(p)
    if g is not None:
        return mla_decode_split(g, p, cfg, x, cache_ckv, cache_kr, cur_len)
    b, smax, _ = cache_ckv.shape
    per_slot = isinstance(cur_len, torch.Tensor) and cur_len.dim() == 1
    if per_slot:
        lens = cur_len.to(device=x.device, dtype=torch.int64)
        pos = lens[:, None]
    else:
        cur_len = int(cur_len)
        pos = torch.full((b, 1), cur_len, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_query(p, cfg, x, pos)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]
    c_new, kr_new = _mla_latents(p, cfg, x, pos)
    if per_slot:
        _write_rows(cache_ckv, lens, c_new[:, 0])
        _write_rows(cache_kr, lens, kr_new[:, 0])
        valid = (lens + 1)[:, None]
    else:
        cache_ckv[:, cur_len:cur_len + 1] = c_new.to(cache_ckv.dtype)
        cache_kr[:, cur_len:cur_len + 1] = kr_new.to(cache_kr.dtype)
        valid = cur_len + 1
    f32 = torch.float32
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, p["wuk"].to(x.dtype))
    s = (torch.einsum("bhr,bpr->bhp", q_lat.to(f32), cache_ckv.to(f32))
         + torch.einsum("bhk,bpk->bhp", q_rope.to(f32), cache_kr.to(f32)))
    s = s * torch.tensor(cfg.qk_dim ** -0.5, dtype=f32, device=x.device)
    mask = torch.arange(smax, device=x.device)[None, :] < valid   # [B|1, Smax]
    s = torch.where(mask[:, None, :], s,
                    torch.tensor(float("-inf"), device=x.device))
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhp,bpr->bhr", w.to(cache_ckv.dtype).to(f32),
                         cache_ckv.to(f32)).to(cache_ckv.dtype)
    o = torch.einsum("bhr,rhk->bhk", o_lat.to(x.dtype), p["wuv"].to(x.dtype))
    return merge_proj(p, "wo", o)[:, None]


# ---------------------------------------------------------------------------
# The split over a lane's "model" positions (``sharding_ctx.ModelGroup``)
# ---------------------------------------------------------------------------
#
# GQA: the q heads (padded as ``_pad_heads`` pads them) are cut in blocks,
# each position taking whole heads, with the key / value heads they attend:
# its own block where the rules split the kv heads, else the heads it needs
# from k / v projected whole.  A projection every position holds whole is
# split over its contracted "embed" dim (float32 partials, ``psum``), as
# GSPMD partitions it in the reference's SPMD records.  ``wo`` is
# row-parallel over the heads.  A decode cache split over its sequence
# ("kv_seq" on "model") is attended block by block: every position holds
# all the q heads, its block's scores, and the softmax's max and sum are
# all-reduced before its partial product with the values (two passes, so
# the weights round to the cache dtype as the unsplit softmax's do).  The
# encoder-decoder's attention splits alike: an encoder's K/V
# (``encoder_kv``) by the positions' kv heads or projected whole, the
# non-causal pass over them by q heads, and cross-attention decode against
# the static K/V cache (whole or over its kv heads) by padded q heads.
# MLA splits its q heads and their ``wuk`` / ``wuv`` / ``wo`` blocks; its
# latent projections stay whole on every position, and a latent cache
# split over "kv_seq" is attended block by block in the latent space.

def _each(fn, x):
    """``fn`` over a tensor, or over each position's block of a list."""
    return [fn(t) for t in x] if isinstance(x, list) else fn(x)


def _proj_split(g, x: torch.Tensor, w):
    """Per position its heads [..., h, Dh] of x @ w (``ModelBlocks`` w:
    column-parallel), or the whole [..., H, Dh] (w held whole: its
    contracted D split, ``layers.contract_parallel``); x may come
    ``shared``."""
    if is_blocks(w):
        return [product(g.to(x, k), wp, "...d,dhk->...hk")
                for k, wp in zip(w.index, w.parts)]
    d, h, k = w.shape
    return contract_parallel(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _q_blocks(g, q, n_heads: int) -> list:
    """Per active position (its q heads, lo, hi): its block of q's head
    dim, a list already (split wq), or cut from the whole q padded with
    zero heads to a multiple of the group (``padded_head_count`` of the
    group's axis) and cut in blocks of whole heads."""
    if isinstance(q, list):
        return [(qk, *g.bounds(n_heads, k)) for qk, k in zip(q, g.active)]
    hp = -(-n_heads // g.size) * g.size
    if hp != n_heads:
        q = F.pad(q, (0, 0, 0, hp - n_heads))
    return [(g.to(q[..., lo:hi, :], k), lo, hi) for k in g.active
            for lo, hi in [g.bounds(hp, k)]]


def _kv_heads(t: torch.Tensor, lo: int, hi: int, n_heads: int,
              group: int):
    """The key / value heads of t [..., KV, Dh] that q heads [lo, hi)
    attend (head h reads kv head h // group), with their group size: a
    slice where the block is whole groups or lies in one group, else one
    kv head per q head, zero heads for padded q heads (>= ``n_heads``)."""
    real = max(0, min(hi, n_heads) - lo)
    if real == hi - lo and hi > lo:
        if lo % group == 0 and (hi - lo) % group == 0:
            return t[..., lo // group:hi // group, :], group
        if lo // group == (hi - 1) // group:
            return t[..., lo // group:lo // group + 1, :], hi - lo
    idx = torch.arange(lo, lo + real, device=t.device) // group
    sel = t.index_select(t.dim() - 2, idx)
    if real < hi - lo:
        sel = F.pad(sel, (0, 0, 0, hi - lo - real))
    return sel, 1


def _merge_split(g, w, outs: list, blocks: list, n_heads: int,
                 dtype) -> torch.Tensor:
    """Row-parallel ``wo`` [H, Dh, D]: each position's heads' outputs
    [..., h, Dh] times its rows of wo (its ``ModelBlocks`` part, or the
    real heads' rows of a whole wo), partials in ``accum_dtype(dtype)``,
    ``psum``."""
    parts, acc = [], accum_dtype(dtype)
    for j, (o, (lo, hi)) in enumerate(zip(outs, blocks)):
        if is_blocks(w):
            wk = w.parts[j]
        else:
            real = max(0, min(hi, n_heads) - lo)
            o = o[..., :real, :]
            wk = g.to(w[lo:lo + real], g.active[j])
        parts.append(torch.einsum("...hk,hkd->...d", o.to(acc), wk.to(acc)))
    return g.psum(parts, dtype)


def _norm_rope(p, name: str, t, positions, theta: float, qk_norm: bool):
    """``rmsnorm`` (``qk_norm``) then ``rope`` of a tensor or of each
    position's block, with the replicated scale and positions moved to the
    block's device."""
    def f(x):
        if qk_norm:
            x = rmsnorm({"scale": p[name]["scale"].to(x.device)}, x)
        return rope(x, positions.to(x.device), theta)
    return _each(f, t)


def _rows_blocks(g, t, size: int):
    """Cache rows of a projection: whole, or ``ModelBlocks`` of the
    positions' kv-head blocks (dim 2 of [B, S, KV, Dh])."""
    if isinstance(t, list):
        return ModelBlocks(t, 2, size, tuple(g.active), g.size)
    return t


def gqa_attention_split(g, p, cfg: AttnConfig, x: torch.Tensor,
                        positions: torch.Tensor, kv_override=None):
    """``gqa_attention`` split over ``g``: (out [B, S, D], (k, v) rows,
    each whole or ``ModelBlocks`` over the kv heads).  ``kv_override``:
    an encoder's (k, v) as ``encoder_kv`` gives them inside the group (no
    RoPE, no mask); they come back as the rows."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dtype, x = x.dtype, shared(x)          # wq, wk and wv read it
    q = _proj_split(g, x, p["wq"])
    causal = cfg.causal
    if kv_override is None:
        k = _proj_split(g, x, p["wk"])
        v = _proj_split(g, x, p["wv"])
        q = _norm_rope(p, "q_norm", q, positions, cfg.rope_theta,
                       cfg.qk_norm)
        k = _norm_rope(p, "k_norm", k, positions, cfg.rope_theta,
                       cfg.qk_norm)
    else:
        k, v = (list(t.parts) if is_blocks(t) else t for t in kv_override)
        if cfg.qk_norm:
            q = _each(lambda t: rmsnorm({"scale": p["q_norm"]["scale"].to(
                t.device)}, t), q)
        causal = False
    blocks = _q_blocks(g, q, h)
    outs = []
    for j, (qk, lo, hi) in enumerate(blocks):
        if isinstance(k, list):
            kk, vv = k[j], v[j]
        else:
            kk, _ = _kv_heads(g.to(k, g.active[j]), lo, hi, h, h // kv)
            vv, _ = _kv_heads(g.to(v, g.active[j]), lo, hi, h, h // kv)
        outs.append(_flash(qk, kk, vv, causal=causal,
                           kv_chunk=min(cfg.kv_chunk, kk.shape[1])))
    out = _merge_split(g, p["wo"], outs, [b[1:] for b in blocks], h, dtype)
    if kv_override is not None:
        return out, kv_override
    return out, (_rows_blocks(g, k, kv), _rows_blocks(g, v, kv))


def _write_block(part: torch.Tensor, lo: int, lens: torch.Tensor,
                 new: torch.Tensor) -> None:
    """Write ``new[i]`` at global row ``lens[i]`` into a cache block
    [B, n, ...] that holds rows [lo, lo + n), where it falls inside."""
    n = part.shape[1]
    rows = torch.arange(part.shape[0], device=part.device)
    lens = lens.to(part.device)
    inside = ((lens >= lo) & (lens < lo + n)).reshape(
        (-1,) + (1,) * (part.dim() - 2))
    at = torch.clamp(lens - lo, 0, n - 1)
    part[rows, at] = torch.where(inside, new.to(part.device, part.dtype),
                                 part[rows, at])


def _write_new(g, cache, lens: torch.Tensor, new, cur, size) -> None:
    """Write the new rows (whole [B, ...] or per-position blocks over the
    heads) into a cache that is whole, split over its kv heads (dim 2) or
    over its sequence (dim 1): at ``cur`` (an int: every row's fill) or,
    where it is None, at each row's ``lens``."""
    def write(part, lo, rows):
        if cur is None:
            if lo is None:
                _write_rows(part, lens, rows)
            else:
                _write_block(part, lo, lens, rows)
        elif lo is None or lo <= cur < lo + part.shape[1]:
            at = cur - (lo or 0)
            part[:, at:at + 1] = rows[:, None].to(part.device, part.dtype)
    if not is_blocks(cache):
        write(cache, None, g.all_gather(new, 1, size)
              if isinstance(new, list) else new)
        return
    for j, part in enumerate(cache.parts):
        lo, hi = cache.bounds(j)
        if cache.dim == 1:
            write(part, lo, g.all_gather(new, 1, size)
                  if isinstance(new, list) else new)
        else:
            write(part, None, new[j] if isinstance(new, list)
                  else new[:, lo:hi])


def _block_mask(s: torch.Tensor, lo: int, valid) -> torch.Tensor:
    """Scores s [B, ..., n] of the cache rows [lo, lo + n), the rows at or
    past ``valid`` [B|1, 1] set to -inf."""
    rows = lo + torch.arange(s.shape[-1], device=s.device)
    mask = (rows[None, :] < valid.to(s.device)).reshape(
        (valid.shape[0],) + (1,) * (s.dim() - 2) + (s.shape[-1],))
    return torch.where(mask, s, torch.tensor(float("-inf"), device=s.device))


def _seq_softmax_pv(g, ss: list, vs: list, eq: str, dtype) -> torch.Tensor:
    """Each position's masked float32 scores ``ss`` over its block of a
    cache split over its sequence, and its block of the values ``vs``: the
    max and the sum of exponentials all-reduced, the weights rounded to the
    values' dtype, the partial products (``eq``) ``psum``'d to ``dtype``;
    the sums one precision above the values' dtype (``_softmax``)."""
    acc = accum_dtype(vs[0].dtype)
    gmax = g.pmax([s.amax(dim=-1) for s in ss])
    es = [torch.exp(s - g.to(gmax, k)[..., None])
          for s, k in zip(ss, g.active)]
    total = g.psum([e.to(acc).sum(dim=-1) for e in es])
    parts = []
    for e, v, k in zip(es, vs, g.active):
        w = (e / g.to(total, k)[..., None]).to(v.dtype)
        parts.append(torch.einsum(eq, w.to(acc), v.to(acc)))
    return g.psum(parts, dtype)


def _decode_lens(x: torch.Tensor, cur_len):
    """(per-row fills [B] int64, the int fill or None where it is per
    row, the attended rows' bound [B|1, 1])."""
    b = x.shape[0]
    if isinstance(cur_len, torch.Tensor) and cur_len.dim() == 1:
        lens = cur_len.to(device=x.device, dtype=torch.int64)
        return lens, None, (lens + 1)[:, None]
    cur = int(cur_len)
    return (torch.full((b,), cur, dtype=torch.int64, device=x.device), cur,
            torch.full((1, 1), cur + 1, dtype=torch.int64, device=x.device))


def gqa_decode_split(g, p, cfg: AttnConfig, x: torch.Tensor, cache_k,
                     cache_v, cur_len, cross: bool = False) -> torch.Tensor:
    """``gqa_decode`` split over ``g``; the caches are whole tensors or
    ``ModelBlocks`` over their kv heads (dim 2) or sequence (dim 1).
    ``cross``: an encoder's static K/V, whole or over their kv heads (q
    not roped, nothing written, every row attended), the q heads padded
    as ``gqa_attention_split`` pads them."""
    b = x.shape[0]
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lens, cur, valid = _decode_lens(x, cur_len)
    pos = lens[:, None]
    dtype, x = x.dtype, shared(x)
    q = _proj_split(g, x, p["wq"])
    if cross:
        if cfg.qk_norm:
            q = _each(lambda t: rmsnorm({"scale": p["q_norm"]["scale"].to(
                t.device)}, t), q)
    else:
        q = _norm_rope(p, "q_norm", q, pos, cfg.rope_theta, cfg.qk_norm)
        k_new = _norm_rope(p, "k_norm", _proj_split(g, x, p["wk"]), pos,
                           cfg.rope_theta, cfg.qk_norm)
        v_new = _proj_split(g, x, p["wv"])
        _write_new(g, cache_k, lens, _each(lambda u: u[:, 0], k_new), cur,
                   kv)
        _write_new(g, cache_v, lens, _each(lambda u: u[:, 0], v_new), cur,
                   kv)
    if is_blocks(cache_k) and cache_k.dim == 1:
        qf = g.all_gather(q, 2, h) if isinstance(q, list) else q
        qr = qf.reshape(b, kv, h // kv, d).to(torch.float32)
        scale = torch.tensor(d ** -0.5, dtype=torch.float32, device=x.device)
        ss = [_block_mask(_scores(g.to(qr, k), cache_k.parts[j],
                                  g.to(scale, k)), cache_k.bounds(j)[0],
                          valid) for j, k in enumerate(g.active)]
        o = _seq_softmax_pv(g, ss, cache_v.parts, "bkgp,bpkd->bkgd",
                            cache_v.parts[0].dtype).reshape(b, 1, h, d)
        blocks = [(g.to(o[:, :, lo:hi], k), lo, hi) for k in g.active
                  for lo, hi in [g.bounds(h, k)]]
    else:
        blocks = _q_blocks(g, q, h)
        smax = (cache_k.parts[0] if is_blocks(cache_k) else
                cache_k).shape[1]
        mask = None if cross else (torch.arange(smax, device=x.device)[
            None, :] < valid)[:, None, None, :]
        outs = []
        for j, (qk, lo, hi) in enumerate(blocks):
            kdev = g.active[j]
            if is_blocks(cache_k):
                ck, cv = cache_k.parts[j], cache_v.parts[j]
            else:
                ck, _ = _kv_heads(g.to(cache_k, kdev), lo, hi, h, h // kv)
                cv, _ = _kv_heads(g.to(cache_v, kdev), lo, hi, h, h // kv)
            outs.append(_decode_core(qk, ck, cv, None if mask is None
                                     else g.to(mask, kdev)))
        blocks = [(o, lo, hi) for o, (_, lo, hi) in zip(outs, blocks)]
    return _merge_split(g, p["wo"], [o for o, _, _ in blocks],
                        [(lo, hi) for _, lo, hi in blocks], h, dtype)


def mla_attention_split(g, p, cfg: MLAConfig, x: torch.Tensor,
                        positions: torch.Tensor):
    """``mla_attention`` split over ``g``'s q heads (with their ``wuk`` /
    ``wuv`` / ``wo`` blocks); the latents are whole on every position.
    Returns (out [B, S, D], (c_kv, k_rope) whole)."""
    dn, dv, h = cfg.qk_nope_dim, cfg.v_head_dim, cfg.n_heads
    qs = _proj_split(g, x, p["wq"])
    c_kv, k_rope = _mla_latents(p, cfg, x, positions)
    outs, blocks = [], []
    for j, k in enumerate(g.active):
        qk, dtype = qs[j], x.dtype
        q_rope = rope(qk[..., dn:], positions.to(qk.device), cfg.rope_theta)
        ckv, kr = g.to(c_kv, k), g.to(k_rope, k)
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wuk"].parts[j].to(
            dtype))
        v = torch.einsum("bsr,rhk->bshk", ckv, p["wuv"].parts[j].to(dtype))
        kk = torch.cat([k_nope, kr[:, :, None, :].expand(
            -1, -1, qk.shape[-2], -1)], dim=-1)
        out = _flash(torch.cat([qk[..., :dn], q_rope], dim=-1), kk,
                     F.pad(v, (0, cfg.qk_dim - dv)), causal=True,
                     kv_chunk=min(cfg.kv_chunk, x.shape[1]))
        outs.append(out[..., :dv])
        blocks.append(g.bounds(h, k))
    return (_merge_split(g, p["wo"], outs, blocks, h, x.dtype),
            (c_kv, k_rope))


def mla_decode_split(g, p, cfg: MLAConfig, x: torch.Tensor, cache_ckv,
                     cache_kr, cur_len) -> torch.Tensor:
    """``mla_decode`` split over ``g``'s q heads; the latent caches are
    whole or ``ModelBlocks`` over their sequence (dim 1), attended block by
    block in the latent space with every head (the heads' latent queries
    all-gathered)."""
    dn, h = cfg.qk_nope_dim, cfg.n_heads
    f32 = torch.float32
    lens, cur, valid = _decode_lens(x, cur_len)
    pos = lens[:, None]
    qs = _proj_split(g, x, p["wq"])
    c_new, kr_new = _mla_latents(p, cfg, x, pos)
    _write_new(g, cache_ckv, lens, c_new[:, 0], cur, None)
    _write_new(g, cache_kr, lens, kr_new[:, 0], cur, None)
    scale = torch.tensor(cfg.qk_dim ** -0.5, dtype=f32, device=x.device)
    q_lat, q_rope = [], []
    for j, qk in enumerate(qs):
        q_lat.append(torch.einsum("bhk,rhk->bhr", qk[:, 0, :, :dn],
                                  p["wuk"].parts[j].to(x.dtype)))
        q_rope.append(rope(qk[..., dn:], pos.to(qk.device),
                           cfg.rope_theta)[:, 0])

    def scores(ql, qr, ckv, kr):
        return (torch.einsum("bhr,bpr->bhp", ql.to(f32), ckv.to(f32))
                + torch.einsum("bhk,bpk->bhp", qr.to(f32), kr.to(f32))
                ) * scale.to(ql.device)

    blocks = [g.bounds(h, k) for k in g.active]
    if is_blocks(cache_ckv):
        ql, qr = g.all_gather(q_lat, 1, h), g.all_gather(q_rope, 1, h)
        ss = [_block_mask(scores(g.to(ql, k), g.to(qr, k), cache_ckv.parts[j],
                                 cache_kr.parts[j]), cache_ckv.bounds(j)[0],
                          valid) for j, k in enumerate(g.active)]
        o_lat = _seq_softmax_pv(g, ss, cache_ckv.parts, "bhp,bpr->bhr",
                                cache_ckv.parts[0].dtype)
        o_lats = [g.to(o_lat[:, lo:hi], k)
                  for k, (lo, hi) in zip(g.active, blocks)]
    else:
        o_lats = []
        for j, k in enumerate(g.active):
            ckv, kr = g.to(cache_ckv, k), g.to(cache_kr, k)
            s = _block_mask(scores(q_lat[j], q_rope[j], ckv, kr), 0, valid)
            w = torch.softmax(s, dim=-1)
            o_lats.append(torch.einsum("bhp,bpr->bhr", w.to(ckv.dtype).to(
                f32), ckv.to(f32)).to(ckv.dtype))
    outs = [torch.einsum("bhr,rhk->bhk", o.to(x.dtype),
                         p["wuv"].parts[j].to(x.dtype))
            for j, o in enumerate(o_lats)]
    return _merge_split(g, p["wo"], outs, blocks, h, x.dtype)[:, None]
