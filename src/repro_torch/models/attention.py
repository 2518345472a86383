"""GQA attention: full-sequence (chunked softmax) and one-token decode
against a KV cache, at one position for all rows or at a position per row
(port of the GQA half of ``repro/models/attention.py``; MLA and chunked
prefill are not ported yet).

Layouts are the reference's: q/k/v [B, S, H, Dh], caches [B, Smax, KV, Dh],
weights wq/wk/wv [D, H, Dh] and wo [H, Dh, D].  Score and PV products
accumulate in float32 as the reference's ``preferred_element_type`` does.
The decode step writes the new key/value row into the cache in place.
"""
from __future__ import annotations

import dataclasses

import torch

from .layers import rmsnorm, rmsnorm_defs, rope
from .params import ParamDef


def head_proj(p, name: str, x: torch.Tensor, heads: int,
              hdim: int) -> torch.Tensor:
    """x [..., D] @ [D, H, Dh] -> [..., H, Dh], PUD-packed aware."""
    packed = p.get(name + "_pud")
    if packed is not None:
        from repro_torch.pud.gemv import pud_linear
        y = pud_linear(x, packed).to(x.dtype)
        return y.reshape(y.shape[:-1] + (heads, hdim))
    return torch.einsum("...d,dhk->...hk", x, p[name].to(x.dtype))


def merge_proj(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """x [..., H, Dh] @ [H, Dh, D] -> [..., D], PUD-packed aware."""
    packed = p.get(name + "_pud")
    if packed is not None:
        from repro_torch.pud.gemv import pud_linear
        flat = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
        return pud_linear(flat, packed).to(x.dtype)
    return torch.einsum("...hk,hkd->...d", x, p[name].to(x.dtype))


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


def gqa_attention(p, cfg: AttnConfig, x: torch.Tensor,
                  positions: torch.Tensor):
    """Full-sequence causal attention (prefill). x: [B, S, D].

    Returns (out [B, S, D], (k, v)) with k, v [B, S, KV, Dh] for the cache.
    """
    q = head_proj(p, "wq", x, cfg.n_heads, cfg.head_dim)
    k = head_proj(p, "wk", x, cfg.n_kv_heads, cfg.head_dim)
    v = head_proj(p, "wv", x, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _flash(q, k, v, causal=cfg.causal,
                 kv_chunk=min(cfg.kv_chunk, k.shape[1]))
    return merge_proj(p, "wo", out), (k, v)


def gqa_decode(p, cfg: AttnConfig, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor,
               cur_len: "int | torch.Tensor") -> torch.Tensor:
    """One-token decode. x: [B, 1, D]; cache_k/v: [B, Smax, KV, Dh].

    ``cur_len`` is the cache fill: an int (all rows at that position) or a
    [B] integer tensor of per-row lengths (continuous batching: each slot at
    its own position, with a per-row RoPE, cache write and causal mask).
    Rows are independent either way.  The new key/value row is written into
    the caches in place; a row whose length is already ``Smax`` writes
    nothing (the reference drops that write).  Returns out [B, 1, D].
    """
    b, smax = cache_k.shape[0], cache_k.shape[1]
    per_slot = isinstance(cur_len, torch.Tensor) and cur_len.dim() == 1
    if per_slot:
        lens = cur_len.to(device=x.device, dtype=torch.int64)
    else:
        cur_len = int(cur_len)
    q = head_proj(p, "wq", x, cfg.n_heads, cfg.head_dim)
    k_new = head_proj(p, "wk", x, cfg.n_kv_heads, cfg.head_dim)
    v_new = head_proj(p, "wv", x, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k_new = rmsnorm(p["k_norm"], k_new)
    pos = (lens[:, None] if per_slot else
           torch.full((b, 1), cur_len, dtype=torch.int64, device=x.device))
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    if per_slot:
        # Rows at Smax keep their last cache row: it is rewritten with its
        # own value, which matches the reference's dropped write.
        rows = torch.arange(b, device=x.device)
        at = torch.clamp(lens, max=smax - 1)
        keep = (lens >= smax)[:, None, None]
        cache_k[rows, at] = torch.where(keep, cache_k[rows, at],
                                        k_new[:, 0].to(cache_k.dtype))
        cache_v[rows, at] = torch.where(keep, cache_v[rows, at],
                                        v_new[:, 0].to(cache_v.dtype))
        valid = lens + 1
    else:
        cache_k[:, cur_len:cur_len + 1] = k_new.to(cache_k.dtype)
        cache_v[:, cur_len:cur_len + 1] = v_new.to(cache_v.dtype)
    h, kvh, d = q.shape[2], cache_k.shape[2], q.shape[3]
    g = h // kvh
    qr = q.reshape(b, kvh, g, d).to(torch.float32)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32, device=x.device)
    s = torch.einsum("bkgd,bpkd->bkgp", qr,
                     cache_k.to(torch.float32)) * scale
    if per_slot:
        mask = (torch.arange(smax, device=x.device)[None, :]
                < valid[:, None])[:, None, None, :]
    else:
        mask = (torch.arange(smax, device=x.device)
                < cur_len + 1)[None, None, None, :]
    s = torch.where(mask, s, torch.tensor(float("-inf"), device=x.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgp,bpkd->bkgd",
                     w.to(cache_v.dtype).to(torch.float32),
                     cache_v.to(torch.float32)).to(cache_v.dtype)
    return merge_proj(p, "wo", o.reshape(b, 1, h, d))
