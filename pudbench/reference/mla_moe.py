"""Plain reference of a DeepSeek-V2 decoder (MLA attention, a leading
dense FFN, routed experts with shared ones) served by the engine, judged
from its own replay of every batch the engine ran.

The experts of a decode wave compete for capacity across the wave's rows
(each expert takes its top-C tokens of the group by router score, C =
int(T x k x capacity_factor / E) + 1), so a request's logits depend on the
other rows of each wave.  The replay therefore takes the waves as the
engine ran them, layer by layer: every request's prompt (one group of
its own, at batch 1), then every decode wave in order, its rows the slots
as the closed loop filled them (``job.schedule``), each fed the token the
engine served before (``job.served``).  Projections named in
``job.packed`` are the 4-bit products of ``quant.Packed``; the rest are
bf16 products (``precision``), norms, rotations, scores and softmax in
float32.

Sizes come from the configuration file's keys (the published
``config.json`` names); weights from the benchmark's tree (the names of
the port's parameter tree, which is the benchmark's input).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import rmsnorm, rope, silu, top_k
from .precision import Precision
from .quant import Packed


class _Cfg:
    def __init__(self, s: dict):
        self.d = s["hidden_size"]
        self.h = s["num_attention_heads"]
        self.r = s["kv_lora_rank"]
        self.dn = s["qk_nope_head_dim"]
        self.dr = s["qk_rope_head_dim"]
        self.dv = s["v_head_dim"]
        self.e = s["n_routed_experts"]
        self.k = s["num_experts_per_tok"]
        self.cf = s["capacity_factor"]
        self.n_layers = s["num_hidden_layers"]
        self.n_dense = s["first_k_dense_replace"]
        self.eps = s["rms_norm_eps"]
        self.theta = float(s["rope_theta"])
        self.norm_topk = bool(s["norm_topk_prob"])
        self.kv_chunk = int(s.get("attention_kv_chunk", 1024))
        if s.get("rope_scaling") is not None:
            raise NotImplementedError("rope_scaling is not modelled")


def _layer_names(c: _Cfg) -> list:
    return ([("layers_0_dense", i) for i in range(c.n_dense)]
            + [("layers_1_moe", i) for i in range(c.n_layers - c.n_dense)])


def _slice(tree, i):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


class _Layer:
    """One layer's weights as the reference multiplies them."""

    def __init__(self, c: _Cfg, p: dict, group: str, packed: set,
                 prec: Precision):
        self.c, self.p, self.prec = c, p, prec

        def proj(path, w):
            return Packed(w) if f"{group}/{path}" in packed else None
        m = p["mixer"]
        self.moe = "router" in m
        ffn = m["shared"] if self.moe else m
        scope = "mixer/shared" if self.moe else "mixer"
        self.ffn = {n: (proj(f"{scope}/{n}", ffn[n]), ffn[n])
                    for n in ("wi", "wg", "wo")}

    def _lin(self, name, x):
        pk, w = self.ffn[name]
        if pk is not None:
            return pk(x).to(x.dtype)
        return self.prec.mm(x, w)

    def ffn_out(self, x):
        h = self._lin("wi", x)
        h = silu(self._lin("wg", x)) * h
        return self._lin("wo", h)

    # -- attention -----------------------------------------------------------

    def _q(self, x, pos):
        c, a = self.c, self.p["attn"]
        q = self.prec.mm(x, a["wq"].reshape(c.d, -1)).reshape(
            x.shape[:-1] + (c.h, c.dn + c.dr))
        return q[..., :c.dn], rope(q[..., c.dn:], pos, c.theta)

    def latents(self, x, pos):
        c, a = self.c, self.p["attn"]
        ckv = rmsnorm(self.prec.mm(x, a["wdkv"]), a["kv_norm"]["scale"],
                      c.eps)
        kr = rope(self.prec.mm(x, a["wkr"])[..., None, :], pos,
                  c.theta)[..., 0, :]
        return ckv, kr

    def _out(self, o):
        c = self.c
        return self.prec.mm(o.reshape(o.shape[:-2] + (c.h * c.dv,)),
                            self.p["attn"]["wo"].reshape(c.h * c.dv, c.d))

    def attend_prompt(self, x):
        """x [S, D] -> (attention out [S, D], (ckv [S, R], kr [S, dr])).
        Keys and values are re-expanded from the latents; the causal
        softmax over all S keys runs online over ``n = S // kv_chunk``
        blocks of ``S // n`` keys, the last taking any remainder (a
        running max, sum and accumulator in float32, each block's weights
        rounded to bf16 before the product with the values), and the
        values are zero-padded to the query width."""
        c, a, f32 = self.c, self.p["attn"], torch.float32
        s = x.shape[0]
        pos = torch.arange(s, device=x.device)
        qn, qr = self._q(x, pos)
        ckv, kr = self.latents(x, pos)
        kn = self.prec.einsum("sr,rhk->shk", ckv, a["wuk"])
        v = self.prec.einsum("sr,rhk->shk", ckv, a["wuv"])
        dq = c.dn + c.dr
        q = torch.cat([qn, qr], dim=-1)[None].to(f32)
        k = torch.cat([kn, kr[:, None, :].expand(-1, c.h, -1)], dim=-1)[None]
        v = F.pad(v, (0, dq - c.dv))[None]
        n = max(1, s // min(c.kv_chunk, s))
        edges = [i * (s // n) for i in range(n)] + [s]
        scale = torch.tensor(dq ** -0.5, dtype=f32, device=x.device)
        m = torch.full((1, c.h, s), float("-inf"), dtype=f32, device=x.device)
        l = torch.zeros((1, c.h, s), dtype=f32, device=x.device)
        acc = torch.zeros((1, c.h, s, dq), dtype=f32, device=x.device)
        for lo, hi in zip(edges[:-1], edges[1:]):
            kb = k[:, lo:hi].to(f32)
            vb = v[:, lo:hi]
            sc = torch.einsum("bqhd,bphd->bhqp", q, kb) * scale
            kpos = torch.arange(lo, hi, device=x.device)
            sc = torch.where(pos[:, None] >= kpos[None, :], sc,
                             torch.tensor(float("-inf"), device=x.device))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            e = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + e.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqp,bphd->bhqd", e.to(vb.dtype).to(f32), vb.to(f32))
            m = m_new
        o = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(
            0, 2, 1, 3).to(x.dtype)[0]
        return self._out(o[..., :c.dv]), (ckv, kr)

    def attend_wave(self, x, pos, cache_ckv, cache_kr):
        """One decode wave: x [B, D] at positions pos [B]; the new latents
        go to row pos of each slot's cache [B, Smax, .] before the rows
        [0, pos] are attended."""
        c, a, f32 = self.c, self.p["attn"], torch.float32
        b = x.shape[0]
        qn, qr = self._q(x[:, None], pos[:, None])
        ckv, kr = self.latents(x[:, None], pos[:, None])
        rows = torch.arange(b, device=x.device)
        cache_ckv[rows, pos] = ckv[:, 0]
        cache_kr[rows, pos] = kr[:, 0]
        n = cache_ckv.shape[1]
        ck, kk = cache_ckv.to(f32), cache_kr.to(f32)
        ql = self.prec.einsum("bhk,rhk->bhr", qn[:, 0], a["wuk"])
        sc = (torch.einsum("bhr,bpr->bhp", ql.to(f32), ck)
              + torch.einsum("bhk,bpk->bhp", qr[:, 0].to(f32), kk))
        sc = sc * torch.tensor((c.dn + c.dr) ** -0.5, dtype=f32,
                               device=x.device)
        valid = torch.arange(n, device=x.device)[None, :] <= pos[:, None]
        sc = torch.where(valid[:, None, :], sc,
                         torch.tensor(float("-inf"), device=x.device))
        w = torch.softmax(sc, dim=-1)
        ol = torch.einsum("bhp,bpr->bhr", w.to(x.dtype).to(f32),
                          ck).to(x.dtype)
        o = self.prec.einsum("bhr,rhk->bhk", ol, a["wuv"])
        return self._out(o)

    # -- experts -------------------------------------------------------------

    def experts(self, x):
        """One group of tokens x [T, D] through the routed experts (with
        capacity) and the shared ones -> [T, D]."""
        c, m, f32 = self.c, self.p["mixer"], torch.float32
        t = x.shape[0]
        probs = torch.softmax(x.to(f32) @ m["router"].to(f32), dim=-1)
        topv, topi = top_k(probs, c.k)
        if c.norm_topk:
            topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
        score = torch.zeros_like(probs).scatter_(1, topi, topv)
        cap = min(max(c.k, int(t * c.k * c.cf / c.e) + 1), t)
        gate, idx = top_k(score.t(), cap)                       # [E, C]
        keep = gate > 0
        ranked = torch.sort(topi, dim=-1).values                # [T, k]
        ex = torch.arange(c.e, device=x.device)[:, None].expand(c.e, cap)
        slot = (ranked[idx] < ex[..., None]).sum(-1)
        slot = torch.where(keep, slot, torch.full_like(slot, c.k))
        xe = x[idx]                                             # [E, C, D]
        bmm = (lambda u, w: torch.bmm(self.prec.cast(u),
                                      self.prec.cast(w.to(u.dtype))))
        h = silu(bmm(xe, m["wg"])) * bmm(xe, m["wi"])
        ye = bmm(h, m["wo"]) * (gate.to(x.dtype) * keep.to(x.dtype))[..., None]
        parts = torch.zeros((t, c.k + 1, c.d), dtype=f32, device=x.device)
        parts[idx, slot] = ye.to(f32)
        y = parts[:, 0]
        for j in range(1, c.k):
            y = y + parts[:, j]
        return y.to(x.dtype) + self.ffn_out(x)

    def mix(self, x):
        return self.experts(x) if self.moe else self.ffn_out(x)


def logits(sizes: dict, weights: dict, job, precision: str = "bf16"):
    """{request id: float32 logits [n, V]} for each request of
    ``job.compare``: row j is what the reference gives where the engine
    served that request's token j (its prompt's last position, then each
    decode wave it was in)."""
    c = _Cfg(sizes)
    prec = Precision(precision)
    packed = set(job.packed)
    dev = weights["embed"]["table"].device
    dt = weights["embed"]["table"].dtype
    sched, served, b, n_waves = job.schedule, job.served, job.batch, \
        job.n_waves
    ids = sorted(sched)
    # the rows of every wave: (request, position) per slot
    row_req = torch.full((n_waves, b), -1, dtype=torch.long)
    row_pos = torch.zeros((n_waves, b), dtype=torch.long)
    row_tok = torch.zeros((n_waves, b), dtype=torch.long)
    starts: dict[int, list] = {}
    for k in ids:
        slot, adm, s = sched[k]
        toks = served[k]
        starts.setdefault(adm, []).append(k)
        for j in range(len(toks) - 1):
            w = adm + j
            if w >= n_waves:
                break
            row_req[w, slot], row_pos[w, slot], row_tok[w, slot] = \
                k, s + j, toks[j]
    if bool((row_req < 0).any()):
        raise ValueError("a wave ran with a free slot; the replay models "
                         "full waves only")
    emb = weights["embed"]["table"]
    pre = {k: emb[torch.as_tensor(job.prompts[k], device=dev).long()]
           for k in ids}
    wave = emb[row_tok.to(dev)]                                 # [W, B, D]
    pos = row_pos.to(dev)
    max_len = job.max_len
    for group, i in _layer_names(c):
        lay = _Layer(c, _slice(weights[group], i), group, packed, prec)
        lp = lay.p
        lat = {}
        for k in ids:
            x = pre[k]
            a, lat[k] = lay.attend_prompt(
                rmsnorm(x, lp["ln1"]["scale"], c.eps))
            x = x + a
            pre[k] = x + lay.mix(rmsnorm(x, lp["ln2"]["scale"], c.eps))
        ckv = torch.zeros((b, max_len, c.r), dtype=dt, device=dev)
        kr = torch.zeros((b, max_len, c.dr), dtype=dt, device=dev)
        for w in range(n_waves):
            for k in starts.get(w, ()):
                slot, _, s = sched[k]
                ckv[slot, :s], kr[slot, :s] = lat[k]
            x = wave[w]
            a = lay.attend_wave(rmsnorm(x, lp["ln1"]["scale"], c.eps),
                                pos[w], ckv, kr)
            x = x + a
            wave[w] = x + lay.mix(rmsnorm(x, lp["ln2"]["scale"], c.eps))
        del lat, ckv, kr, lay
    unembed = Packed(weights["unembed"]["w"]) if "unembed/w" in packed \
        else None
    fn = weights["final_norm"]["scale"]
    out = {}
    for k in job.compare:
        slot, adm, s = sched[k]
        n = len(served[k])
        rows = [pre[k][-1]] + [wave[adm + j, slot] for j in range(n - 1)]
        h = rmsnorm(torch.stack(rows), fn, c.eps)
        out[k] = (unembed(h).to(h.dtype) if unembed is not None
                  else prec.mm(h, weights["unembed"]["w"])).to(torch.float32)
    return out
