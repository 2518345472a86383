"""Shared layer library (port of ``repro/models/layers.py``): RMSNorm,
projections with PUD dispatch, embeddings, RoPE, the gated FFN and the
chunked cross-entropy of training.

Plain functions over a parameter dict and tensors, in the reference's
dtype flow: norms compute in float32 and return the input dtype, RoPE
rotates in float32, projections run in the activation dtype.

Inside a lane's "model" group (``sharding_ctx.use_group``) a weight the
rules split arrives as ``ModelBlocks``, and the products take their split
forms: column-parallel (each position multiplies by its block of output
columns), row-parallel (each position's block of the contracted dim, its
float32 partial product, ``psum``), the vocab-parallel ``logits_last`` and
``chunked_softmax_xent`` (max, sum of exponentials and the target's logit
all-reduced over the group).  A weight the group holds whole takes
``contract_parallel`` where GSPMD splits it (the unembed of a vocab that
does not divide the axis): its contracted dim in blocks, ``psum``.

Precision: a sum the split divides accumulates one precision above the
compute dtype (``sharding_ctx.accum_dtype``) and rounds once, split or
not.  bf16: float32 partial products, ``psum`` in float32, rounded once to
bf16 (the unsplit bf16 GEMM accumulates in float32 too).  float32: the
row-parallel and contract-parallel partials are float64, and their
unsplit counterparts (``sum_product``: every wo, the LoRA's ffn_a)
accumulate in float64 and round once, so that the split step gives the
unsplit step's bits.  A column-parallel ``product`` divides no sum in
its forward pass where a block of the output columns gets the whole
product's bits: on the CPU in float32; on CUDA, where it does not, in
float64.  Its backward does divide one, the gradient of its input summed
over the output columns, so a float32 ``product`` takes its gradients in
float64, and an activation that several products (or positions) read
comes to them in its float64 form (``shared``): autograd adds their
float64 gradients in float64 and rounds once, at that cast.  Not exact
on the CPU: a head projection that a layout splits over "embed" (heads
the axis does not divide, ``attention._proj_split``) against its unsplit
float32 product.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .params import ParamDef
from .sharding_ctx import (accum_dtype, is_blocks, lane_stats, model_group,
                           use_group)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU in the reference's operation order
    (``jax.nn.gelu(approximate=True)``): every operation in x's dtype, with
    sqrt(2 / pi) rounded to that dtype first.  ``F.gelu`` computes in
    float32 and rounds once, which moves 43% of bf16 outputs by one ulp
    against the reference; this order moves 0.25% (its ``tanh``)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
    return x * cdf


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU in the reference's operation order (``jax.nn.silu`` is ``x *
    logistic(x)``, and XLA expands the logistic as ``1 / (1 + exp(-x))``):
    every operation in x's dtype.  ``F.silu`` computes in float32 and
    rounds once, which moves 39% of bf16 outputs by an ulp against the
    reference; this order moves none on the CPU."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Softplus in the reference's operation order (``jax.nn.softplus`` is
    ``logaddexp(x, 0)``: ``max(x, 0) + log1p(exp(-|x|))``, a NaN passed
    through), in x's dtype.  ``F.softplus`` returns x itself above its
    threshold of 20 and computes ``log1p(exp(x))`` below it, which rounds
    differently."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


ACT = {
    "silu": silu,
    "gelu": gelu_tanh,
    "relu": F.relu,
}


def shared(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the form in which several products (or positions) read it:
    a float32 activation in float64 (exact), so that autograd sums its
    readers' float64 gradients in float64 and rounds once, at this cast;
    any other dtype as it is (bf16 readers' gradients add in bf16, as
    they always have).  A float64 ``x`` is already shared."""
    return x.to(torch.float64) if x.dtype == torch.float32 else x


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The compute dtype of an activation: float32 for one in its float64
    ``shared`` form (the models compute in bf16 or float32 only)."""
    return torch.float32 if x.dtype == torch.float64 else x.dtype


class _WideProduct(torch.autograd.Function):
    """``x @ w`` of float32 values (x [..., D] float32 or its float64
    ``shared`` form, w [D, N] float32), rounded once to float32: in
    float32, or (``wide``) accumulated in float64.  Both gradients
    accumulate in float64: x's is returned in x's dtype (unrounded for a
    shared x), w's rounded once to float32."""

    @staticmethod
    def forward(ctx, x, w, wide):
        ctx.save_for_backward(x, w)
        if wide:
            return (x.to(torch.float64) @ w.to(torch.float64)).to(
                torch.float32)
        return x.to(torch.float32) @ w

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        f64, dx, dw = torch.float64, None, None
        dy = dy.to(f64)
        if ctx.needs_input_grad[0]:
            dx = (dy @ w.to(f64).t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.reshape(-1, x.shape[-1]).to(f64).t()
                  @ dy.reshape(-1, dy.shape[-1])).to(w.dtype)
        return dx, dw, None


def _product(x: torch.Tensor, w: torch.Tensor, eq: str | None,
             wide: bool) -> torch.Tensor:
    """``x @ w`` (or ``torch.einsum(eq, x, w)``, which contracts x's last
    dims with w's first ones) in x's compute dtype: bf16 as torch
    multiplies it; float32 through ``_WideProduct``."""
    dtype = compute_dtype(x)
    if accum_dtype(dtype) != torch.float64:
        ws = w.to(dtype)
        return x @ ws if eq is None else torch.einsum(eq, x, ws)
    k = 1                            # the contracted dims: w's first k
    if eq is not None:
        ins, out_sub = eq.split("->")
        k = sum(c not in out_sub for c in ins.split(",")[1])
    tail = w.shape[k:]
    out = _WideProduct.apply(x.flatten(-k), w.to(dtype).reshape(
        math.prod(w.shape[:k]), math.prod(tail)), wide)
    return out.unflatten(-1, tail) if len(tail) > 1 else out


def product(x: torch.Tensor, w: torch.Tensor, eq: str | None = None):
    """``x @ w`` for a product whose output columns the split divides
    (column-parallel; ``eq``: the head projections' einsum).  float32:
    gradients in float64 (x may come ``shared``); the forward multiplies
    in float32 on the CPU, whose GEMM gives a block of the output columns
    the whole product's bits, and in float64 on CUDA, where cuBLAS picks
    its float32 kernel by the output width and a column block rounds
    otherwise than the whole product in 88-97% of its elements (an H100,
    PERF.md §6).  On the CPU a float64 forward would move the float32
    models off the reference's float32 products (gemma-7b's engine
    logits 4.5e-4, past their parity test's 1e-4)."""
    return _product(x, w, eq, x.is_cuda)


def sum_product(x: torch.Tensor, w, eq: str | None = None):
    """``x @ w`` for a product whose contracted dims (``eq``: the merge of
    heads) the split divides: a ``ModelBlocks`` w takes its split form
    (``matmul``); a whole one is its unsplit counterpart, float32
    accumulated in float64 both ways and rounded once, as the split's
    ``psum`` of float64 partials is."""
    if is_blocks(w):
        return matmul(x, w)
    return _product(x, w, eq, True)


def rmsnorm_defs(dim: int) -> dict:
    return {"scale": ParamDef((dim,), ("norm",), init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = p["scale"] + 1.0 if zero_centered else p["scale"]
    return (x * scale).to(dtype)


def dense_defs(d_in: int, d_out: int, axes: tuple,
               dtype=torch.bfloat16) -> dict:
    return {"w": ParamDef((d_in, d_out), axes, dtype=dtype, init="scaled")}


def dense(p, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, p["w"])


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` one precision above x's compute dtype (float32 for bf16,
    float64 for float32): one position's unrounded share of a split
    product."""
    acc = accum_dtype(x.dtype)
    return x.to(acc) @ w.to(acc)


def column_parallel(x: torch.Tensor, w) -> list:
    """Each active position's ``x @`` its block of ``w``'s output columns
    (``ModelBlocks`` on the last dim), rounded to x's compute dtype, on its
    device; the positions read x's ``shared`` form."""
    g, xs = model_group(), shared(x)
    return [product(g.to(xs, k), wp) for k, wp in zip(w.index, w.parts)]


def row_parallel(parts: list, w, dtype) -> torch.Tensor:
    """The positions' inputs (blocks of the contracted dim, aligned with
    ``w``'s ``ModelBlocks`` on its first dim) times their blocks of ``w``:
    partial products in ``accum_dtype(dtype)``, ``psum``, rounded once to
    ``dtype``.

    Positions on one device run their products as one batched product: a
    layer that ends here (the FFN's ``wo``) and is rematerialised stops its
    recompute before that product, as one position's program stops before
    its own, so the lane recomputes what its positions' programs do."""
    g, acc = model_group(), accum_dtype(dtype)
    if len({h.device for h in parts}) > 1 or len({tuple(
            wp.shape) for wp in w.parts}) > 1:
        return g.psum([partial_product(h, wp) for h, wp in
                       zip(parts, w.parts)], dtype)
    lead = parts[0].shape[:-1]
    hs = torch.stack([h.reshape(-1, h.shape[-1]) for h in parts])
    out = torch.bmm(hs.to(acc), torch.stack(list(w.parts)).to(acc))
    return g.psum([o.reshape(lead + (o.shape[-1],)) for o in out.unbind(0)],
                  dtype)


def contract_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` [D, N] for a weight every position of the group holds
    whole, as GSPMD partitions such a product in the reference's SPMD
    records: each position's block of the contracted D (of x's ``shared``
    form), a partial product one precision up, ``psum``, rounded once to
    x's compute dtype."""
    g, xs = model_group(), shared(x)
    d, parts = x.shape[-1], []
    for k in g.active:
        lo, hi = g.bounds(d, k)
        parts.append(partial_product(g.to(xs[..., lo:hi], k),
                                     g.to(w[lo:hi], k)))
    return g.psum(parts, compute_dtype(x))


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` (``product``); a ``ModelBlocks`` ``w`` [D_in, D_out]
    takes its split form: column-parallel then gathered (output columns
    split), or row-parallel over x's blocks of D_in (input rows split)."""
    if not is_blocks(w):
        return product(x, w)
    g = model_group()
    if w.dim == w.parts[0].dim() - 1:
        return g.all_gather(column_parallel(x, w), -1, w.size)
    xs = shared(x)
    parts = [g.to(xs[..., slice(*w.bounds(j))], k)
             for j, k in enumerate(w.index)]
    return row_parallel(parts, w, compute_dtype(x))


def embed_defs(vocab: int, d_model: int, dtype=torch.bfloat16) -> dict:
    return {"table": ParamDef((vocab, d_model), ("vocab_in", "embed"),
                              dtype=dtype, init="normal")}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed_defs(d_model: int, vocab: int, dtype=torch.bfloat16) -> dict:
    return {"w": ParamDef((d_model, vocab), ("embed", "vocab"), dtype=dtype,
                          init="scaled")}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rotary_dims: int | None = None) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S].  Rotates the first
    ``rotary_dims`` (default all) dims in float32."""
    d = x.shape[-1] if rotary_dims is None else rotary_dims
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    angles = positions[..., :, None].to(torch.float32) * freq
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :d], x[..., d:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if d < x.shape[-1] else out


def ffn_defs(d_model: int, d_ff: int, gated: bool = True,
             dtype=torch.bfloat16) -> dict:
    defs = {
        "wi": ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype,
                       init="scaled"),
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed"), dtype=dtype,
                       init="scaled"),
    }
    if gated:
        defs["wg"] = ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype,
                              init="scaled")
    return defs


def linear(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """Projection dispatch: the PUD bit-plane GEMM when ``<name>_pud``
    (a ``PackedTensor``) is present, a plain matmul otherwise."""
    packed = p.get(name + "_pud")
    if packed is not None:
        from repro_torch.pud.gemv import pud_linear
        dtype = compute_dtype(x)
        return pud_linear(x.to(dtype), packed).to(dtype)
    return matmul(x, p[name])


def _ffn_split(p, x: torch.Tensor, act) -> torch.Tensor:
    """The gated FFN with its "mlp" dim split: wi / wg column-parallel, the
    activation on each position's block, wo row-parallel."""
    hs = column_parallel(x, p["wi"])
    if "wg" in p:
        hs = [act(gk) * h for gk, h in zip(column_parallel(x, p["wg"]), hs)]
    else:
        hs = [act(h) for h in hs]
    return row_parallel(hs, p["wo"], compute_dtype(x))


def ffn(p, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """The (gated) FFN; x may come ``shared`` (wi and wg read it)."""
    act = ACT[activation]
    x = shared(x)
    if is_blocks(p.get("wi")):
        return _ffn_split(p, x, act)
    h = linear(p, "wi", x)
    if "wg" in p or "wg_pud" in p:
        h = act(linear(p, "wg", x)) * h
    else:
        h = act(h)
    return (linear(p, "wo", h) if "wo_pud" in p
            else sum_product(h, p["wo"]))


def logits_last(unembed_p, h_last: torch.Tensor) -> torch.Tensor:
    """Decode-time logits for the last position only. h_last: [B, D].
    A vocab split over "model" gives each position its block of the
    logits, gathered whole; a vocab the group holds whole (it does not
    divide the axis) is split over D (``contract_parallel``)."""
    w = unembed_p.get("w")
    g = model_group()
    if is_blocks(w):
        return g.all_gather([part.to(torch.float32) for part in
                             column_parallel(h_last, w)], -1, w.size)
    if g is not None and w is not None:
        return contract_parallel(h_last, w).to(torch.float32)
    return linear(unembed_p, "w", h_last).to(torch.float32)


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, rematerialised in the backward pass when ``enabled``
    and autograd is recording (``torch.utils.checkpoint``, the counterpart
    of ``jax.checkpoint``): only the inputs are kept, the activations inside
    are recomputed.  The values are the same either way."""
    if enabled and torch.is_grad_enabled():
        group = model_group()
        if group is None:
            return checkpoint(fn, *args, use_reentrant=False)

        def run(*a):            # the recompute runs in the backward pass
            with use_group(group):
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False)
    return fn(*args)


def _logsumexp(logits: torch.Tensor, dtype) -> torch.Tensor:
    """``logsumexp`` over the last dim of float32 logits computed in
    ``dtype``: bf16 through ``torch.logsumexp``; float32 as the
    vocab-parallel loss takes it (the max, the exponentials' sum in
    float64 rounded once, its log plus the max), so that the two agree."""
    if accum_dtype(dtype) != torch.float64:
        return torch.logsumexp(logits, dim=-1)
    m = logits.detach().amax(dim=-1)
    total = torch.exp(logits - m[..., None]).to(torch.float64).sum(dim=-1)
    return torch.log(total.to(torch.float32)) + m


def _chunk_loss(hc: torch.Tensor, w: torch.Tensor, yc: torch.Tensor,
                mc: torch.Tensor):
    """One chunk's masked loss sum and count; inside a "model" group the
    whole vocab's logits are split over D (``contract_parallel``)."""
    logits = (product(hc, w) if model_group() is None
              else contract_parallel(hc, w)).to(torch.float32)
    logz = _logsumexp(logits, hc.dtype)
    gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def _chunk_loss_split(hc: torch.Tensor, yc: torch.Tensor,
                      mc: torch.Tensor, w):
    """``_chunk_loss`` with the vocab split: each position's block of the
    logits; the max, the sum of exponentials (accumulated one precision
    above hc's dtype) and the target's logit all-reduced over the group."""
    g, acc = model_group(), accum_dtype(hc.dtype)
    logits = [part.to(torch.float32) for part in column_parallel(hc, w)]
    gmax = g.pmax([lg.detach().amax(dim=-1) for lg in logits])
    sums, gold = [], []
    for j, (k, lg) in enumerate(zip(w.index, logits)):
        sums.append(torch.exp(lg - g.to(gmax, k)[..., None]).to(acc).sum(
            dim=-1))
        lo, hi = w.bounds(j)
        y = g.to(yc, k).long()
        inside = (y >= lo) & (y < hi)
        at = torch.clamp(y - lo, 0, max(hi - lo - 1, 0))
        pick = (torch.gather(lg, -1, at[..., None])[..., 0] if hi > lo
                else torch.zeros(y.shape, device=lg.device))
        gold.append(torch.where(inside, pick, torch.zeros_like(pick)))
    logz = torch.log(g.psum(sums)) + gmax
    return ((logz - g.psum(gold)) * mc).sum(), mc.sum()


def chunked_softmax_xent(unembed_p, h: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor | None = None, chunk: int = 512):
    """Cross-entropy without materialising [B, S, V] logits.

    Loops over sequence chunks; each chunk's [B, chunk, V] float32 logits
    are recomputed in the backward pass (``torch.utils.checkpoint``).
    h: [B, S, D]; labels: [B, S] int; mask: [B, S] (1 = count).  S is padded
    to a chunk multiple with zero weight.  Returns (mean loss, total
    weight), float32 0-d tensors."""
    b, s, _ = h.shape
    w = unembed_p["w"]
    m = (torch.ones(labels.shape, dtype=torch.float32, device=h.device)
         if mask is None else mask.to(torch.float32))
    if s % chunk:
        pad = chunk - s % chunk
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        m = F.pad(m, (0, pad))
        s += pad
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        if is_blocks(w):              # the vocab split over "model"
            loss, n = remat(True, _chunk_loss_split, h[:, sl], labels[:, sl],
                            m[:, sl], w)
        else:
            loss, n = remat(True, _chunk_loss, h[:, sl], w, labels[:, sl],
                            m[:, sl])
        tot, cnt = tot + loss, cnt + n
    stats = lane_stats()
    if stats is not None:           # a data lane of the sharded step
        stats.xent.append((tot, cnt.detach()))
    return tot / torch.clamp(cnt, min=1.0), cnt
