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
sharding hints become the split over a lane's "model" positions (the
section at the end of this file).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import (product, rmsnorm, rmsnorm_defs, row_parallel, shared,
                     silu, softplus, sum_product)
from .params import ParamDef
from .sharding_ctx import (ModelBlocks, accum_dtype, block_bounds, is_blocks,
                           model_group)


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
    """(z, xs, B, C, dt float32) of x, the five products reading x's
    ``shared`` form."""
    x = shared(x)
    return (product(x, p["wz"]), product(x, p["wx"]), product(x, p["wB"]),
            product(x, p["wC"]), product(x, p["wdt"]).to(torch.float32))


def _norm_wide(hs: list, scales: list, n: int, total) -> list:
    """The gated RMSNorm where the compute dtype is float32, of the blocks
    ``hs`` [..., n_k] of a dim of ``n`` (one block: unsplit) with their
    blocks of the scale: the float64 sums of squares of every block added
    by ``total`` (a ``psum``, or the one block's sum) and rounded once to
    float32, and one rsqrt factor that every block reads in its float64
    form, so that the gradient's sum over the dim is float64 too.  The
    products round to float32 as float32 products do."""
    hw = [shared(h) for h in hs]
    sq = total([(h ** 2).sum(dim=-1, keepdim=True) for h in hw])
    r = shared(torch.rsqrt(sq / n + 1e-6))
    return [(h * r.to(h.device)).to(torch.float32) * s
            for h, s in zip(hw, scales)]


def _gate_out(p, cfg: SSMConfig, y: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    """float32 y [B, L, H, P] -> gated, normalised and projected [B, L, D]
    (a float32 model normalises as its split does: ``_norm_wide``)."""
    b, l = y.shape[:2]
    y = y.reshape(b, l, cfg.d_inner).to(dtype) * silu(z)
    if accum_dtype(dtype) == torch.float64:
        y = _norm_wide([y], [p["norm"]["scale"]], cfg.d_inner,
                       lambda parts: parts[0].to(torch.float32))[0]
    else:
        y = rmsnorm(p["norm"], y)
    return sum_product(y, p["wo"])


def _ssd(cfg: SSMConfig, xs: torch.Tensor, bb: torch.Tensor,
         cc: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
         dt_bias: torch.Tensor, d_skip: torch.Tensor):
    """The chunked SSD of ``h`` heads (all of them, or a position's block):
    xs [B, L, h P], bb / cc [B, L, N] after the conv (or their ``shared``
    form), dt [B, L, h] float32 before its bias, the heads' a_log /
    dt_bias / d_skip [h].  Returns (y [B, L, h, P] float32, final state
    [B, h, P, N] float32).

    The SSD computes one precision above xs's dtype (``accum_dtype``:
    float32 under bf16, as the reference, float64 for a float32 model) and
    rounds y and the state once to float32.  Its gradients with respect to
    B and C (and C.B's broadcast) sum over the heads, which the split
    divides among positions, and those of the per-head dt_bias, decay and
    skip sum over the batch and time with the heads as the innermost dim,
    in an order that depends on how many heads a position holds: in float64
    every such sum rounds to the same float32 split or not.

    A sequence that is not a multiple of the chunk is padded with no-op
    steps: zero inputs and dt = -1e9, whose softplus is 0 (no decay, no
    contribution to the state)."""
    b, l, h = dt.shape
    q = min(cfg.chunk, l)
    nc, pd, n = -(-l // q), cfg.head_dim, cfg.d_state
    acc = accum_dtype(xs.dtype)           # the SSD's working precision
    pad = nc * q - l
    if pad:
        xs, bb, cc = (F.pad(t, (0, 0, 0, pad)) for t in (xs, bb, cc))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e9)
    lpad = l + pad

    dt = softplus(dt.to(acc) + dt_bias.to(acc))                    # [B,L,h]
    a = -torch.exp(a_log.to(acc))                                  # [h]
    la = (dt * a).reshape(b, nc, q, h)                             # log decay
    xh = (xs.reshape(b, lpad, h, pd) * dt[..., None]).reshape(
        b, nc, q, h, pd)                                           # dt * x
    bc = bb.reshape(b, nc, q, n).to(acc)
    cg = cc.reshape(b, nc, q, n).to(acc)

    cs = torch.cumsum(la, dim=2)                                   # [B,C,Q,h]
    # intra-chunk: decay L[t, s] = exp(cs_t - cs_s) for t >= s; a where,
    # not a product with the mask: the upper triangle's exp may be inf.
    # The exp is float32's, whose overflow (and the NaN it leaves in the
    # backward pass) the reference's has too
    dmat = cs[:, :, :, None, :] - cs[:, :, None, :, :]             # [B,C,Q,S,h]
    tri = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    dmat = torch.where(tri[None, None, :, :, None],
                       torch.exp(dmat.to(torch.float32)).to(acc),
                       torch.zeros((), dtype=acc, device=xs.device))
    g = torch.einsum("bcqn,bcsn->bcqs", cg, bc)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", g[..., None] * dmat, xh)

    # chunk states, then the recurrence over chunks
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)                # [B,C,Q,h]
    s_chunk = torch.einsum("bcsn,bcshp->bchpn", bc,
                           decay_to_end[..., None] * xh)           # [B,C,h,P,N]
    lam = torch.exp(cs[:, :, -1, :])                               # [B,C,h]
    hstate = torch.zeros((b, h, pd, n), dtype=acc, device=xs.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * lam[:, c, :, None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                           # [B,C,h,P,N]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cg, h_prev) \
        * torch.exp(cs)[..., None]

    y = (y_intra + y_inter).reshape(b, lpad, h, pd)[:, :l]
    y = y + d_skip.to(acc)[None, None, :, None] * xs[:, :l].reshape(
        b, l, h, pd).to(acc)
    return y.to(torch.float32), hstate.to(torch.float32)


def mamba2_block(p, cfg: SSMConfig, x: torch.Tensor):
    """Full-sequence SSD. x: [B, L, D] -> (y [B, L, D], (conv tail
    [B, W - 1, C] in x's dtype, final SSM state [B, H, P, N] float32)).
    Inside a "model" group the heads split (``_mamba2_split``), and the
    tail and state come as the cache leaves lay them out."""
    g = _split_group(p)
    if g is not None:
        return _mamba2_split(g, p, cfg, x)
    n = cfg.d_state
    z, xs, bb, cc, dt = _proj_inputs(p, cfg, x)
    xbc = torch.cat([xs, bb, cc], dim=-1)
    conv_tail = xbc[:, -(cfg.d_conv - 1):, :]        # decode cache seed
    xbc = silu(_causal_conv(xbc, p["conv"]))
    xs, bb, cc = torch.split(xbc, [cfg.d_inner, n, n], dim=-1)
    y, hstate = _ssd(cfg, xs, bb, cc, dt, p["a_log"], p["dt_bias"],
                     p["d_skip"])
    return _gate_out(p, cfg, y, z, x.dtype), (conv_tail, hstate)


def mamba2_init_cache(cfg: SSMConfig, batch: int, dtype=torch.bfloat16,
                      device=None):
    conv = torch.zeros((batch, cfg.d_conv - 1, cfg.conv_channels),
                       dtype=dtype, device=device)
    state = torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                        dtype=torch.float32, device=device)
    return conv, state


def _ssd_step(xs_t: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
              dt: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
              d_skip: torch.Tensor, h_state: torch.Tensor):
    """One step of the recurrence for ``h`` heads: xs_t [B, h P], b_t /
    c_t [B, N] after the conv, dt [B, h] float32 before its bias, the
    state [B, h, P, N] float32.  Returns (y [B, h, P] float32, state)."""
    b, h, pd, _ = h_state.shape
    f32 = torch.float32
    dt_t = softplus(dt + dt_bias)                                  # [B,h]
    a_t = torch.exp(dt_t * (-torch.exp(a_log)))                    # [B,h]
    xh = (xs_t.reshape(b, h, pd) * dt_t[..., None]).to(f32)
    h_state = (h_state * a_t[..., None, None]
               + xh[..., None] * b_t.to(f32)[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h_state, c_t.to(f32))
    y = y + d_skip[None, :, None] * xs_t.reshape(b, h, pd).to(f32)
    return y, h_state


def mamba2_decode(p, cfg: SSMConfig, x: torch.Tensor, cache):
    """One-token recurrence. x: [B, 1, D]; cache = (conv window [B, W - 1,
    C], SSM state [B, H, P, N] float32).  Returns (y [B, 1, D], (new
    window, new state)); the cache tensors are not written.  Inside a
    "model" group the heads split (``_mamba2_decode_split``) and the cache
    leaves come as the rules lay them out.

    The conv is the window times the kernel summed over the window in the
    activation dtype, as the reference's ``(window * kernel).sum(1)``."""
    g = _split_group(p)
    if g is not None:
        return _mamba2_decode_split(g, p, cfg, x, cache)
    conv_win, h_state = cache
    n = cfg.d_state
    z, xs, bb, cc, dt = _proj_inputs(p, cfg, x)
    xbc = torch.cat([xs, bb, cc], dim=-1)                          # [B,1,C]
    window = torch.cat([conv_win.to(x.dtype), xbc], dim=1)         # [B,W,C]
    conv_out = (window * p["conv"].to(x.dtype)[None]).sum(dim=1)
    xbc_t = silu(conv_out)                                         # [B,C]
    xs_t, b_t, c_t = torch.split(xbc_t, [cfg.d_inner, n, n], dim=-1)
    y, h_state = _ssd_step(xs_t, b_t, c_t, dt[:, 0], p["a_log"],
                           p["dt_bias"], p["d_skip"], h_state)
    out = _gate_out(p, cfg, y[:, None], z, x.dtype)
    return out, (window[:, 1:], h_state)


# ---------------------------------------------------------------------------
# The split over a lane's "model" positions (``sharding_ctx.ModelGroup``)
# ---------------------------------------------------------------------------
#
# Position k takes whole heads ("ssm" on "model"): its columns of wz / wx /
# wdt, its heads' a_log / dt_bias / d_skip, their SSD and state, and its
# rows of wo (row-parallel: partial products, ``psum``).  B and C (ngroups
# = 1: every head reads them) are cut over d_state, as GSPMD partitions the
# reference's SPMD program: each position projects its columns of the whole
# wB / wC and convolves them, and the group all-gathers the convolved B and
# C.  So position k's conv channels are its xs block and its B and C blocks
# (``_channels``).  The conv kernel and the conv cache keep the reference's
# layout, blocks of ceil(C / M) over the concatenated [xs | B | C] channels,
# which does not line up with those (mamba2-1.3b on 16: 272 channels a
# block against 256 xs + 8 + 8): the channels a position needs from
# another's block, or holds for another's, cross in "collective-permute"s
# (``_read``, ``_store``).  The gated RMSNorm normalises over the whole
# d_inner: the positions' sums of squares are all-reduced before each
# scales its block.  The head-independent C.B product of the chunked SSD
# is computed whole on every position (replicated work).  Where the compute
# dtype is float32 every sum that crosses the positions, forward or
# backward, is float64 and rounds once, as the unsplit mixer's is: the
# projections read x's ``shared`` form, every position's SSD reads the
# gathered B and C in theirs, and the norm is ``_norm_wide``.

def _split_group(p):
    """The enclosing "model" group where the mixer runs split (its heads
    and conv channels split over it), None where it runs whole."""
    g = model_group()
    if g is not None and not all(is_blocks(p[n]) for n in ("wx", "wdt",
                                                           "conv")):
        raise NotImplementedError(
            "the Mamba2 mixer on a \"model\" group needs its heads and "
            f"conv channels split over it ({p['wdt'].shape[-1]} heads, "
            f"{p['conv'].shape[-1]} channels, {g.size} positions)")
    return g


def _channels(cfg: SSMConfig, m: int, k: int) -> list:
    """Position ``k``'s conv channels, [(lo, hi)] of [xs | B | C]: its xs
    block (whole heads), its blocks of B and of C."""
    di, n = cfg.d_inner, cfg.d_state
    xlo, xhi = block_bounds(di, m, k)
    blo, bhi = block_bounds(n, m, k)
    return [(xlo, xhi), (di + blo, di + bhi), (di + n + blo, di + n + bhi)]


def _read(g, leaf, k: int, ranges: list) -> torch.Tensor:
    """Position ``k``'s channels ``ranges`` of ``leaf``'s last dim
    (``ModelBlocks`` in ceil(C / M) blocks), in that order, each piece from
    the position whose block holds it (traced for one position, another's
    piece is left unwritten)."""
    like, pieces = leaf.parts[0], []
    for lo, hi in ranges:
        for j in range(leaf.count):
            blo, bhi = block_bounds(leaf.size, leaf.count, j)
            a, b = max(lo, blo), min(hi, bhi)
            if a >= b:
                continue
            if j in leaf.index:
                piece = leaf.parts[leaf.index.index(j)][..., a - blo:b - blo]
            else:
                piece = like.new_empty(like.shape[:-1] + (b - a,))
            pieces.append(g.permute(piece, j, k))
    return torch.cat(pieces, dim=-1)


def _store(g, cfg: SSMConfig, held: list) -> ModelBlocks:
    """Channels the active positions hold (``held``: per active position
    its ``_channels``, concatenated) in the cache's layout, ``ModelBlocks``
    of the positions' ceil(C / M) blocks; each channel from the position
    that holds it."""
    m, c = g.size, cfg.conv_channels
    segs = []                    # (lo, hi, holder, offset in its channels)
    for k in range(m):
        off = 0
        for lo, hi in _channels(cfg, m, k):
            segs.append((lo, hi, k, off))
            off += hi - lo
    segs.sort()
    like = held[0]

    def assemble(tlo: int, thi: int, dst: int) -> torch.Tensor:
        pieces = []
        for lo, hi, k, off in segs:
            a, b = max(lo, tlo), min(hi, thi)
            if a >= b:
                continue
            if k in g.active:
                piece = held[g.active.index(k)][..., off + a - lo:
                                                off + b - lo]
            else:
                piece = like.new_empty(like.shape[:-1] + (b - a,))
            pieces.append(g.permute(piece, k, dst))
        return torch.cat(pieces, dim=-1)
    return ModelBlocks([assemble(*block_bounds(c, m, k), k)
                        for k in g.active], like.dim() - 1, c,
                       tuple(g.active), m)


def _split_inputs(g, p, cfg: SSMConfig, x: torch.Tensor):
    """Per active position (z, xs, B block, C block, dt) of x [B, L, D]:
    column-parallel over its heads, and its d_state columns of wB / wC,
    every product reading x's ``shared`` form."""
    x, out = shared(x), []
    for j, k in enumerate(g.active):
        xk = g.to(x, k)
        blo, bhi = block_bounds(cfg.d_state, g.size, k)
        out.append((product(xk, p["wz"].parts[j]),
                    product(xk, p["wx"].parts[j]),
                    product(xk, g.to(p["wB"][:, blo:bhi], k)),
                    product(xk, g.to(p["wC"][:, blo:bhi], k)),
                    product(xk, p["wdt"].parts[j]).to(torch.float32)))
    return out


def _gather_bc(g, cfg: SSMConfig, convolved: list, width: int):
    """The whole convolved B and C [..., N] from the positions' d_state
    blocks (each [..., xs width | B block | C block])."""
    n = cfg.d_state
    bs, cs = [], []
    for t in convolved:
        nb = (t.shape[-1] - width) // 2
        bs.append(t[..., width:width + nb])
        cs.append(t[..., width + nb:])
    return g.all_gather(bs, -1, n), g.all_gather(cs, -1, n)


def _heads(p, j: int):
    """The ``j``-th active position's heads' (a_log, dt_bias, d_skip)."""
    return tuple(p[n].parts[j] for n in ("a_log", "dt_bias", "d_skip"))


def _gate_out_split(g, p, cfg: SSMConfig, ys: list, zs: list, dtype):
    """``_gate_out`` over the positions' heads: the gated RMSNorm's mean of
    squares from a ``psum`` of their partial sums (float32 under bf16; a
    float32 model's as ``_norm_wide`` takes it), each position's slice of
    the replicated scale, then wo row-parallel."""
    hs = []
    for y, z in zip(ys, zs):
        hs.append(y.reshape(y.shape[:2] + (-1,)).to(dtype) * silu(z))
    scale = p["norm"]["scale"]
    scales = [g.to(scale[slice(*block_bounds(cfg.d_inner, g.size, k))], k)
              for k in g.active]
    if accum_dtype(dtype) == torch.float64:
        return row_parallel(_norm_wide(hs, scales, cfg.d_inner, g.psum),
                            p["wo"], dtype)
    sq = g.psum([(h.to(torch.float32) ** 2).sum(dim=-1, keepdim=True)
                 for h in hs])
    normed = []
    for k, h, sk in zip(g.active, hs, scales):
        var = g.to(sq, k) / cfg.d_inner
        hf = h.to(torch.float32) * torch.rsqrt(var + 1e-6)
        normed.append((hf * sk).to(dtype))
    return row_parallel(normed, p["wo"], dtype)


def _mamba2_split(g, p, cfg: SSMConfig, x: torch.Tensor):
    """``mamba2_block`` over ``g``'s heads: (y, (conv tail, state)) as the
    cache leaves lay them out: ``ModelBlocks`` of the conv's channel
    blocks and of the state's heads."""
    w = cfg.d_conv
    inputs = _split_inputs(g, p, cfg, x)
    tails, convolved = [], []
    for k, (_, xs, bb, cc, _) in zip(g.active, inputs):
        xbc = torch.cat([xs, bb, cc], dim=-1)
        tails.append(xbc[:, -(w - 1):, :])
        kernel = _read(g, p["conv"], k, _channels(cfg, g.size, k))
        convolved.append(silu(_causal_conv(xbc, kernel)))
    width = inputs[0][1].shape[-1]
    # every position's SSD reads B and C: their gradients add in float64
    bb, cc = (shared(t) for t in _gather_bc(g, cfg, convolved, width))
    ys, states = [], []
    for j, (k, t, (_, _, _, _, dt)) in enumerate(zip(g.active, convolved,
                                                     inputs)):
        y, st = _ssd(cfg, t[..., :width], g.to(bb, k), g.to(cc, k), dt,
                     *_heads(p, j))
        ys.append(y)
        states.append(st)
    out = _gate_out_split(g, p, cfg, ys, [i[0] for i in inputs], x.dtype)
    return out, (_store(g, cfg, tails), _state_blocks(g, cfg, states))


def _state_blocks(g, cfg: SSMConfig, states: list) -> ModelBlocks:
    """The positions' states [B, h, P, N] over the heads."""
    return ModelBlocks(states, 1, cfg.n_heads, tuple(g.active), g.size)


def _mamba2_decode_split(g, p, cfg: SSMConfig, x: torch.Tensor, cache):
    """``mamba2_decode`` over ``g``'s heads; the window and the state
    (``ModelBlocks`` of the conv's channel blocks and of the heads) come
    back laid out alike."""
    conv_win, h_state = cache
    inputs = _split_inputs(g, p, cfg, x)
    windows, convolved = [], []
    for k, (_, xs, bb, cc, _) in zip(g.active, inputs):
        ranges = _channels(cfg, g.size, k)
        xbc = torch.cat([xs, bb, cc], dim=-1)
        window = torch.cat([_read(g, conv_win, k, ranges).to(x.dtype), xbc],
                           dim=1)
        kernel = _read(g, p["conv"], k, ranges)
        windows.append(window[:, 1:])
        convolved.append(silu((window * kernel.to(x.dtype)[None]).sum(
            dim=1)))
    width = inputs[0][1].shape[-1]
    b_t, c_t = _gather_bc(g, cfg, convolved, width)
    ys, states = [], []
    for j, (k, t, (_, _, _, _, dt)) in enumerate(zip(g.active, convolved,
                                                     inputs)):
        y, st = _ssd_step(t[..., :width], g.to(b_t, k), g.to(c_t, k),
                          dt[:, 0], *_heads(p, j), h_state.parts[j])
        ys.append(y[:, None])
        states.append(st)
    out = _gate_out_split(g, p, cfg, ys, [i[0] for i in inputs], x.dtype)
    return out, (_store(g, cfg, windows), _state_blocks(g, cfg, states))
