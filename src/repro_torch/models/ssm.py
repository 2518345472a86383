"""Mamba2 block through the SSD (state-space duality) chunked algorithm
(port of ``repro/models/ssm.py``).

Prefill runs the chunked form: within a chunk a quadratic,
attention-like term, across chunks a recurrence over the chunk states
(a Python loop where the reference scans).  Decode runs the O(1)
recurrence with a (conv window, SSM state) cache.  ngroups = 1 (B and C
shared across heads), one scalar decay per head.

The dtype flow is the reference's: the input projections, the conv and
the gate run in the activation dtype; dt, the decays, the SSD products
and the state in float32.  The projections are bare matmuls, as the
reference's are, so the packer matches none of them (``mamba.w*`` is in
no packable scope).  Three-operand einsums contract in a fixed order: the
two elementwise factors first, then one product over the contracted axis;
float32 sums in another order than the reference's XLA kernels keep
logits within 1e-4 of it (``tests/test_torch_ssm.py``).  The reference's
sharding hints have no counterpart on one device.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import rmsnorm, rmsnorm_defs, silu, softplus
from .params import ParamDef


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int
    d_state: int
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 128

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of "
                             f"head_dim {self.head_dim}")
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.d_state


def mamba2_defs(cfg: SSMConfig, dtype=torch.bfloat16) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    return {
        "wz": ParamDef((d, di), ("embed", "ssm"), dtype=dtype, init="scaled"),
        "wx": ParamDef((d, di), ("embed", "ssm"), dtype=dtype, init="scaled"),
        "wB": ParamDef((d, n), ("embed", None), dtype=dtype, init="scaled"),
        "wC": ParamDef((d, n), ("embed", None), dtype=dtype, init="scaled"),
        "wdt": ParamDef((d, h), ("embed", "ssm"), dtype=dtype, init="scaled"),
        "conv": ParamDef((cfg.d_conv, cfg.conv_channels), (None, "ssm"),
                         dtype=dtype, init="scaled"),
        "a_log": ParamDef((h,), ("ssm",), dtype=torch.float32, init="zeros"),
        "d_skip": ParamDef((h,), ("ssm",), dtype=torch.float32, init="ones"),
        "dt_bias": ParamDef((h,), ("ssm",), dtype=torch.float32,
                            init="zeros"),
        "norm": rmsnorm_defs(di),
        "wo": ParamDef((di, d), ("ssm", "embed"), dtype=dtype, init="scaled"),
    }


def _causal_conv(xbc: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xbc: [B, L, C]; kernel: [W, C] -> [B, L, C].

    ``F.conv1d`` with one group per channel over [B, C, L] left-padded by
    W - 1: a cross-correlation, as the reference's
    ``conv_general_dilated``, so the kernel is not flipped."""
    w, c = kernel.shape
    x = F.pad(xbc.transpose(1, 2), (w - 1, 0))
    weight = kernel.to(xbc.dtype).t().reshape(c, 1, w)
    return F.conv1d(x, weight, groups=c).transpose(1, 2)


def _proj_inputs(p, cfg: SSMConfig, x: torch.Tensor):
    dtype = x.dtype
    z = x @ p["wz"].to(dtype)
    xs = x @ p["wx"].to(dtype)
    bb = x @ p["wB"].to(dtype)
    cc = x @ p["wC"].to(dtype)
    dt = (x @ p["wdt"].to(dtype)).to(torch.float32)
    return z, xs, bb, cc, dt


def _gate_out(p, cfg: SSMConfig, y: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    """float32 y [B, L, H, P] -> gated, normalised and projected [B, L, D]."""
    b, l = y.shape[:2]
    y = y.reshape(b, l, cfg.d_inner).to(dtype)
    y = rmsnorm(p["norm"], y * silu(z))
    return y @ p["wo"].to(dtype)


def mamba2_block(p, cfg: SSMConfig, x: torch.Tensor):
    """Full-sequence SSD. x: [B, L, D] -> (y [B, L, D], (conv tail
    [B, W - 1, C] in x's dtype, final SSM state [B, H, P, N] float32)).

    A sequence that is not a multiple of the chunk is padded with no-op
    steps: zero inputs and dt = -1e9, whose softplus is 0 (no decay, no
    contribution to the state)."""
    b, l, _ = x.shape
    q = min(cfg.chunk, l)
    nc, h, pd, n = -(-l // q), cfg.n_heads, cfg.head_dim, cfg.d_state
    f32 = torch.float32

    z, xs, bb, cc, dt = _proj_inputs(p, cfg, x)
    xbc = torch.cat([xs, bb, cc], dim=-1)
    conv_tail = xbc[:, -(cfg.d_conv - 1):, :]        # decode cache seed
    xbc = silu(_causal_conv(xbc, p["conv"]))
    xs, bb, cc = torch.split(xbc, [cfg.d_inner, n, n], dim=-1)

    pad = nc * q - l
    if pad:
        xs, bb, cc = (F.pad(t, (0, 0, 0, pad)) for t in (xs, bb, cc))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e9)
    lpad = l + pad

    dt = softplus(dt + p["dt_bias"])                               # [B,L,H]
    a = -torch.exp(p["a_log"])                                     # [H]
    la = (dt * a).reshape(b, nc, q, h)                             # log decay
    xh = (xs.reshape(b, lpad, h, pd) * dt[..., None]).reshape(
        b, nc, q, h, pd)                                           # dt * x
    bc = bb.reshape(b, nc, q, n).to(f32)
    cg = cc.reshape(b, nc, q, n).to(f32)

    cs = torch.cumsum(la, dim=2)                                   # [B,C,Q,H]
    # intra-chunk: decay L[t, s] = exp(cs_t - cs_s) for t >= s; a where,
    # not a product with the mask: the upper triangle's exp may be inf
    dmat = cs[:, :, :, None, :] - cs[:, :, None, :, :]             # [B,C,Q,S,H]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    dmat = torch.where(tri[None, None, :, :, None], torch.exp(dmat),
                       torch.zeros((), dtype=f32, device=x.device))
    g = torch.einsum("bcqn,bcsn->bcqs", cg, bc)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", g[..., None] * dmat, xh)

    # chunk states, then the recurrence over chunks
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)                # [B,C,Q,H]
    s_chunk = torch.einsum("bcsn,bcshp->bchpn", bc,
                           decay_to_end[..., None] * xh)           # [B,C,H,P,N]
    lam = torch.exp(cs[:, :, -1, :])                               # [B,C,H]
    hstate = torch.zeros((b, h, pd, n), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * lam[:, c, :, None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                           # [B,C,H,P,N]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cg, h_prev) \
        * torch.exp(cs)[..., None]

    y = (y_intra + y_inter).reshape(b, lpad, h, pd)[:, :l]
    y = y + p["d_skip"][None, None, :, None] * xs[:, :l].reshape(
        b, l, h, pd).to(f32)
    return _gate_out(p, cfg, y, z, x.dtype), (conv_tail, hstate)


def mamba2_init_cache(cfg: SSMConfig, batch: int, dtype=torch.bfloat16,
                      device=None):
    conv = torch.zeros((batch, cfg.d_conv - 1, cfg.conv_channels),
                       dtype=dtype, device=device)
    state = torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                        dtype=torch.float32, device=device)
    return conv, state


def mamba2_decode(p, cfg: SSMConfig, x: torch.Tensor, cache):
    """One-token recurrence. x: [B, 1, D]; cache = (conv window [B, W - 1,
    C], SSM state [B, H, P, N] float32).  Returns (y [B, 1, D], (new
    window, new state)); the cache tensors are not written.

    The conv is the window times the kernel summed over the window in the
    activation dtype, as the reference's ``(window * kernel).sum(1)``."""
    conv_win, h_state = cache
    b = x.shape[0]
    n, h, pd = cfg.d_state, cfg.n_heads, cfg.head_dim
    f32 = torch.float32

    z, xs, bb, cc, dt = _proj_inputs(p, cfg, x)
    xbc = torch.cat([xs, bb, cc], dim=-1)                          # [B,1,C]
    window = torch.cat([conv_win.to(x.dtype), xbc], dim=1)         # [B,W,C]
    conv_out = (window * p["conv"].to(x.dtype)[None]).sum(dim=1)
    xbc_t = silu(conv_out)                                         # [B,C]
    xs_t, b_t, c_t = torch.split(xbc_t, [cfg.d_inner, n, n], dim=-1)

    dt_t = softplus(dt[:, 0] + p["dt_bias"])                       # [B,H]
    a_t = torch.exp(dt_t * (-torch.exp(p["a_log"])))               # [B,H]
    xh = (xs_t.reshape(b, h, pd) * dt_t[..., None]).to(f32)
    h_state = (h_state * a_t[..., None, None]
               + xh[..., None] * b_t.to(f32)[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h_state, c_t.to(f32))
    y = y + p["d_skip"][None, :, None] * xs_t.reshape(b, h, pd).to(f32)
    out = _gate_out(p, cfg, y[:, None], z, x.dtype)
    return out, (window[:, 1:], h_state)
