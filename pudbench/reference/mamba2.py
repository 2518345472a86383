"""Plain reference of a Mamba2 language model (SSD, one group of B and C,
a scalar decay per head), judged request by request: each compared
request's prompt through the chunked SSD (its conv window's tail and the
final state kept), then the tokens the engine served, one recurrent step
each, every step run over a batch of the engine's width (the compared
requests, zero rows beside them) as the engine's decode waves were; the
logits at every position where the engine served a token.

Rows of a decode wave do not interact (no routing, a state per slot), so
the other requests of the engine's waves do not enter.  bf16 products
(``precision``), the conv and gate in bf16, dt, decays, the SSD and the
state in float32; the unembed is the 4-bit product of ``quant.Packed``
when ``job.packed`` names it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import rmsnorm, silu
from .precision import Precision
from .quant import Packed


def softplus(x):
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


class _Dims:
    def __init__(self, s: dict):
        ssm = s["ssm_cfg"]
        self.d = s["d_model"]
        self.di = ssm["expand"] * s["d_model"]
        self.n = ssm["d_state"]
        self.p = ssm["headdim"]
        self.h = self.di // self.p
        self.w = ssm["d_conv"]
        self.chunk = ssm["chunk_size"]
        self.eps = s["norm_epsilon"]


def ssd(c: _Dims, xs, bb, cc, dt, a_log, dt_bias, d_skip):
    """The chunked SSD over one sequence: xs [1, L, H P] and B, C [1, L,
    N] after the conv, dt [1, L, H] float32 before its bias.  Returns (y
    [1, L, H, P] float32, final state [1, H, P, N] float32).  Steps past
    L (to a whole chunk) are no-ops: zero inputs, dt = -1e9."""
    f32 = torch.float32
    b, l, h = dt.shape
    q = min(c.chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        xs, bb, cc = (F.pad(t, (0, 0, 0, pad)) for t in (xs, bb, cc))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e9)
    lp = l + pad
    dt = softplus(dt.to(f32) + dt_bias.to(f32))
    a = -torch.exp(a_log.to(f32))
    la = (dt * a).reshape(b, nc, q, h)
    xh = (xs.reshape(b, lp, h, c.p) * dt[..., None]).reshape(b, nc, q, h,
                                                             c.p)
    bc = bb.reshape(b, nc, q, c.n).to(f32)
    cg = cc.reshape(b, nc, q, c.n).to(f32)
    cs = torch.cumsum(la, dim=2)
    dmat = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    dmat = torch.where(tri[None, None, :, :, None], torch.exp(dmat),
                       torch.zeros((), dtype=f32, device=xs.device))
    g = torch.einsum("bcqn,bcsn->bcqs", cg, bc)
    y = torch.einsum("bcqsh,bcshp->bcqhp", g[..., None] * dmat, xh)
    to_end = torch.exp(cs[:, :, -1:, :] - cs)
    chunk_states = torch.einsum("bcsn,bcshp->bchpn", bc,
                                to_end[..., None] * xh)
    lam = torch.exp(cs[:, :, -1, :])
    state = torch.zeros((b, h, c.p, c.n), dtype=f32, device=xs.device)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * lam[:, i, :, None, None] + chunk_states[:, i]
    prev = torch.stack(prev, dim=1)
    y = y + torch.einsum("bcqn,bchpn->bcqhp", cg, prev) * \
        torch.exp(cs)[..., None]
    y = y.reshape(b, lp, h, c.p)[:, :l]
    y = y + d_skip.to(f32)[None, None, :, None] * xs[:, :l].reshape(
        b, l, h, c.p).to(f32)
    return y, state


class _Block:
    def __init__(self, c: _Dims, p: dict, prec: Precision):
        self.c, self.p, self.prec = c, p, prec

    def _inputs(self, x):
        p, mm = self.p, self.prec.mm
        return (mm(x, p["wz"]), mm(x, p["wx"]), mm(x, p["wB"]),
                mm(x, p["wC"]), mm(x, p["wdt"]).to(torch.float32))

    def _out(self, y, z):
        c = self.c
        y = y.reshape(y.shape[:2] + (c.di,)).to(z.dtype) * silu(z)
        y = rmsnorm(y, self.p["norm"]["scale"], c.eps)
        return self.prec.mm(y, self.p["wo"])

    def prompt(self, x):
        """x [1, L, D] -> (out, (conv tail [1, W - 1, C], state))."""
        c, p = self.c, self.p
        z, xs, bb, cc, dt = self._inputs(x)
        xbc = torch.cat([xs, bb, cc], dim=-1)
        tail = xbc[:, -(c.w - 1):, :]
        ch = xbc.shape[-1]
        conv = F.conv1d(F.pad(xbc.transpose(1, 2), (c.w - 1, 0)),
                        p["conv"].to(x.dtype).t().reshape(ch, 1, c.w),
                        groups=ch).transpose(1, 2)
        xs, bb, cc = torch.split(silu(conv), [c.di, c.n, c.n], dim=-1)
        y, state = ssd(c, xs, bb, cc, dt, p["a_log"], p["dt_bias"],
                       p["d_skip"])
        return self._out(y, z), (tail, state)

    def step(self, x, window, state):
        """One token per row: x [B, 1, D], the conv window [B, W - 1, C]
        and the state [B, H, P, N] -> (out [B, 1, D], window, state)."""
        c, p, f32 = self.c, self.p, torch.float32
        z, xs, bb, cc, dt = self._inputs(x)
        win = torch.cat([window.to(x.dtype),
                         torch.cat([xs, bb, cc], dim=-1)], dim=1)
        u = silu((win * p["conv"].to(x.dtype)[None]).sum(dim=1))
        xs_t, b_t, c_t = torch.split(u, [c.di, c.n, c.n], dim=-1)
        b = x.shape[0]
        dt_t = softplus(dt[:, 0] + p["dt_bias"])
        a_t = torch.exp(dt_t * (-torch.exp(p["a_log"])))
        xh = (xs_t.reshape(b, c.h, c.p) * dt_t[..., None]).to(f32)
        state = (state * a_t[..., None, None]
                 + xh[..., None] * b_t.to(f32)[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", state, c_t.to(f32))
        y = y + p["d_skip"][None, :, None] * xs_t.reshape(b, c.h, c.p).to(f32)
        return self._out(y[:, None], z), win[:, 1:], state


def logits(sizes: dict, weights: dict, job, precision: str = "bf16"):
    """{request id: float32 logits [n, V]} for each request of
    ``job.compare`` (row j: where the engine served its token j)."""
    c = _Dims(sizes)
    prec = Precision(precision)
    emb = weights["embed"]["table"]
    dev, dt = emb.device, emb.dtype
    lay = weights["layers"]
    n_layers = sizes["n_layer"]
    blocks = []
    for i in range(n_layers):
        p = {k: (v[i] if not isinstance(v, dict)
                 else {kk: vv[i] for kk, vv in v.items()})
             for k, v in lay["mamba"].items()}
        blocks.append(_Block(c, p, prec))
    ln = lay["ln"]["scale"]
    fn = weights["final_norm"]["scale"]
    unembed = Packed(weights["unembed"]["w"]) if "unembed/w" in job.packed \
        else None

    def head(h):
        h = rmsnorm(h, fn, c.eps)
        return (unembed(h).to(h.dtype) if unembed is not None
                else prec.mm(h, weights["unembed"]["w"])).to(torch.float32)

    ids = list(job.compare)
    rows = max(job.batch, len(ids))
    windows = torch.zeros((n_layers, rows, c.w - 1, c.di + 2 * c.n),
                          dtype=dt, device=dev)
    states = torch.zeros((n_layers, rows, c.h, c.p, c.n),
                         dtype=torch.float32, device=dev)
    out = {k: [] for k in ids}
    for r, k in enumerate(ids):
        h = emb[torch.as_tensor(job.prompts[k], device=dev).long()][None]
        for i, blk in enumerate(blocks):
            o, (tail, st) = blk.prompt(rmsnorm(h, ln[i], c.eps))
            h = h + o
            windows[i, r], states[i, r] = tail[0], st[0]
        out[k].append(head(h[:, -1]))
    steps = max(len(job.served[k]) for k in ids) - 1
    for j in range(steps):
        tok = torch.zeros((rows,), dtype=torch.long, device=dev)
        for r, k in enumerate(ids):
            if j < len(job.served[k]) - 1:
                tok[r] = int(job.served[k][j])
        h = emb[tok][:, None]
        for i, blk in enumerate(blocks):
            o, windows[i], states[i] = blk.step(
                rmsnorm(h, ln[i], c.eps), windows[i], states[i])
            h = h + o
        lg = head(h[:, 0])
        for r, k in enumerate(ids):
            if j < len(job.served[k]) - 1:
                out[k].append(lg[r:r + 1])
    return {k: torch.cat(v) for k, v in out.items()}
