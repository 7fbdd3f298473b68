"""Softmax attention: the CUDA kernels (csrc/attention.cu,
csrc/attention_generic.cu) and their plain versions.

Port of mtt_tpu/kernels/attention.py:

- ``fused_attention_ln_qkv``, the pre-norm front half: the TPU's
  ``_attn_ln_qkv_cached_kernel`` (non-tap blocks) and the emit variant
  ``_attn_ln_qkv_emit_pallas`` = ``_ln_kernel`` + ``_attn_ln_qkv_kernel(ln=False,
  emit=True)`` (tap blocks), with the softmax helpers ``_fast_exp2_probs``
  and ``_resolve_safe``. On the card the call is three hand-written
  launches: LN rows, the qkv projection (tensor cores, bias added in f32 and
  rounded once), and the attention core, which streams K/V tiles per (query
  tile, head, batch item) and never writes scores to device memory.
- ``fused_attention_qkv`` (``_attn_qkv_kernel``): attention over a packed
  head-major qkv. It is the function of the attention core above, so on the
  card it launches the same ``attn_core_kernel`` under its own count.
- ``attention_ln_qkv_composed``: the JAX package's XLA composition of the
  front half (``_attn_ln_qkv_xla``), LN and the product in torch, then
  ``fused_attention_qkv``. ``fused_attention_ln_qkv`` does not route to it:
  the card's front-half kernels have no VMEM budget to fall back from.
- ``fused_attention`` (``_attn_kernel``): max-subtracted attention over
  separate (B, N, H, D) q, k, v with any key count and head dims up to 128,
  a kernel of its own (csrc/attention_generic.cu).

The weight of the front half is the nn.Linear layout (3C, C) whose rows are
HEAD-MAJOR (H, 3, D): the transpose of the JAX package's (C, 3C) kernel with
head-major columns.

The front half's gradient ports the JAX custom VJP (attention.py:697-736):
it recomputes LN and qkv (through the forward's own kernels on the card,
uncounted), runs the attention-core backward (``_attn_bwd_kernel``,
csrc/attention_bwd.cu, plain twin ``attn_core_bwd_plain``), then closes the
qkv-projection and LN gradients in ``torch.matmul`` plus ``layernorm_vjp``.
The emit variant also takes the cotangents of its qkv and xn outputs, which
the tap blocks' raw scores feed. The gradients of ``fused_attention_qkv``
and ``fused_attention`` are the JAX package's XLA VJPs (``_qkv_bwd``,
``_bwd``) in plain torch on every device: an f32 softmax, f32 products,
each gradient rounded once.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from mtt_tpu_torch.kernels import _build
from mtt_tpu_torch.kernels.layernorm import (layernorm_cuda, layernorm_plain,
                                             layernorm_vjp)

LOG2E = 1.4426950408889634
EXP2_CLAMP = 126.0
EXP2_FLOOR = -120.0


def resolve_safe(safe: bool | None) -> bool:
    """MTT_ATTN_SAFE_SOFTMAX, when set, overrides: "0" forces the fast exp2
    path, any other value the max-subtracted one. Otherwise the caller
    decides (eval forwards pass False)."""
    env = os.environ.get("MTT_ATTN_SAFE_SOFTMAX")
    if env is not None and env != "":
        return env != "0"
    return bool(safe)


def exp2_clamp_hi(n_keys: int) -> float:
    """Upper logit clamp of the fast path: log2(n_keys) headroom keeps the row
    sum of clamped probabilities finite."""
    return EXP2_CLAMP - math.ceil(math.log2(n_keys))


def fast_exp2_probs(logits: torch.Tensor, safe: bool,
                    n_keys: int | None = None) -> torch.Tensor:
    """exp2 probabilities (unnormalised) of pre-scaled (log2 e folded) f32
    logits: max-subtracted when safe, else clamped to [-120, hi]."""
    if safe:
        return torch.exp2(logits - logits.amax(-1, keepdim=True))
    hi = exp2_clamp_hi(n_keys) if n_keys else EXP2_CLAMP - 16
    return torch.exp2(logits.clamp(EXP2_FLOOR, hi))


def scaled_log2e(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """scale * log2 e rounded to the activation dtype (attention.py:404)."""
    return torch.tensor(scale * LOG2E, dtype=dtype)


def qkv_proj_plain(xn, w, b):
    """qkv bias added in f32, rounded once."""
    return (F.linear(xn.float(), w.float()) + b.float()).to(xn.dtype)


def attention_qkv_plain(qkv, heads: int, scale: float, safe: bool = False):
    """softmax(q k^T * scale) v per head from the head-major qkv (B, N,
    H*3*D) -> the head concat (B, N, H*D), at the TPU kernel's rounding
    points (attention.py:230-254): q * s2 in the activation dtype, P cast to
    v's dtype before P.V, division by the row sum after."""
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    q5 = qkv.view(B, N, heads, 3, D)
    q = q5[:, :, :, 0] * scaled_log2e(scale, qkv.dtype).to(qkv.device)
    k, v = q5[:, :, :, 1], q5[:, :, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = fast_exp2_probs(logits, safe, N)
    s = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / s).to(qkv.dtype).permute(0, 2, 1, 3).reshape(B, N, heads * D)


def attention_ln_qkv_plain(x, gamma, beta, w, b, heads: int, scale: float,
                           eps: float = 1e-6, need_qkv: bool = False,
                           safe: bool = False):
    """Same function and rounding points as the TPU kernels: qkv bias added
    in f32 then cast, then ``attention_qkv_plain``."""
    xn = layernorm_plain(x, gamma, beta, eps)
    qkv = qkv_proj_plain(xn, w, b)
    out = attention_qkv_plain(qkv, heads, scale, safe)
    return (out, qkv, xn) if need_qkv else out


def attn_core_bwd_plain(qkv, g, heads: int, scale: float):
    """dqkv of softmax(q k^T * scale) v from the head-major qkv (B, N, H*3*D)
    and dOut (B, N, H*D). Rounding points of ``_attn_bwd_kernel``
    (attention.py:603-644): max-subtracted softmax in f32 with the scale
    applied to the f32 logits; r = sum(dp * p); dl = p (dp - r) and p cast
    to the dtype before the dq/dk and dv products; dq, dk scaled in f32,
    each output rounded once."""
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    dt = qkv.dtype
    q5 = qkv.view(B, N, heads, 3, D).float()
    q, k, v = q5[:, :, :, 0], q5[:, :, :, 1], q5[:, :, :, 2]
    gf = g.reshape(B, N, heads, D).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v)
    r = (dp * p).sum(-1, keepdim=True)
    dl = (p * (dp - r)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    return torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)], 3).reshape(
        B, N, C3)


def attn_core_bwd_cuda(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                       scale: float):
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    if D != 64:
        raise ValueError(f"the attention backward kernel takes head dim 64, "
                         f"got {D}")
    if qkv.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError("the attention backward kernel takes bfloat16")
    if g.shape != (B, N, heads * D) or not g.is_contiguous() \
            or not qkv.is_contiguous():
        raise ValueError(f"dOut must be contiguous (B, N, H*D) = "
                         f"{(B, N, heads * D)}, got {tuple(g.shape)}")
    dqkv = torch.empty_like(qkv)
    # per (batch, head, query row): log2 of the softmax denominator and
    # r = sum(dp p), rows padded to a multiple of the kernels' 64-row tile
    stats = torch.empty(2, B, heads, -(-N // 64) * 64, dtype=torch.float32,
                        device=qkv.device)
    _build.check(_build.lib().mtt_attn_bwd_bf16(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, N,
        heads, float(scale), _build.stream()), "mtt_attn_bwd_bf16")
    return dqkv


def _check(x, gamma, beta, w, b, heads):
    if x.dim() != 3 or not x.is_floating_point():
        raise ValueError(f"x must be a floating (B, N, C) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    C = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != C or w.shape[0] % (3 * heads):
        raise ValueError(f"w must be (H*3*D, {C}) for {heads} heads, got "
                         f"{tuple(w.shape)}")
    if b.shape != (w.shape[0],) or gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError("bias must be (H*3*D,) and gamma/beta (C,)")
    for t in (x, w, b, gamma, beta):
        if not t.is_contiguous():
            raise ValueError("attention inputs must be contiguous")
        if t.device != x.device:
            raise ValueError("attention inputs must be on one device")
    if w.dtype != x.dtype:
        raise TypeError(f"w dtype {w.dtype} differs from x dtype {x.dtype}")


def qkv_proj_cuda(xn: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    M, K = xn.numel() // xn.shape[-1], xn.shape[-1]
    N = w.shape[0]
    if K % 32 or N % 128:
        raise ValueError(f"the qkv kernel needs C % 32 == 0 and 3C % 128 == 0,"
                         f" got C={K}, 3C={N}")
    qkv = torch.empty(*xn.shape[:-1], N, dtype=xn.dtype, device=xn.device)
    bf = b.float().contiguous()
    _build.check(_build.lib().mtt_qkv_proj_bf16(
        xn.data_ptr(), w.data_ptr(), bf.data_ptr(), qkv.data_ptr(), M, N, K,
        _build.stream()), "mtt_qkv_proj_bf16")
    return qkv


def attn_core_cuda(qkv: torch.Tensor, heads: int, scale: float, safe: bool):
    """The attention core (``attn_core_kernel``): head dim 64, bf16, a
    contiguous head-major (B, N, H*3*D) qkv."""
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    if D != 64:
        raise ValueError(f"the attention kernel takes head dim 64, got {D}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bfloat16, got "
                        f"{qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("the attention kernel takes a contiguous qkv")
    out = torch.empty(B, N, heads * D, dtype=qkv.dtype, device=qkv.device)
    s2 = float(scaled_log2e(scale, qkv.dtype))
    _build.check(_build.lib().mtt_attn_core_bf16(
        qkv.data_ptr(), out.data_ptr(), B, N, heads, s2, exp2_clamp_hi(N),
        int(safe), _build.stream()), "mtt_attn_core_bf16")
    return out


class _AttentionLnQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, heads, scale, eps, need_qkv, impl,
                safe):
        ctx.save_for_backward(x, gamma, beta, w, b)
        ctx.cfg = (heads, scale, eps, impl)
        ctx.set_materialize_grads(False)
        if impl == "plain":
            return attention_ln_qkv_plain(x, gamma, beta, w, b, heads, scale,
                                          eps, need_qkv, safe)
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernels take bfloat16, got "
                            f"{x.dtype}")
        xn = layernorm_cuda(x, gamma, beta, eps)
        if need_qkv:
            # tap layers: LN(x) is an output, a launch of the public LN entry
            # point, as attention.py:550 calls fused_layernorm
            _build.COUNTS["layernorm"] += 1
        qkv = qkv_proj_cuda(xn, w, b)
        out = attn_core_cuda(qkv, heads, scale, safe)
        _build.COUNTS["attention_emit" if need_qkv else "attention_cached"] += 1
        return (out, qkv, xn) if need_qkv else out

    @staticmethod
    def backward(ctx, g_out, g_qkv=None, g_xn=None):
        x, gamma, beta, w, b = ctx.saved_tensors
        heads, scale, eps, impl = ctx.cfg
        B, N, C = x.shape
        if impl == "plain":
            xn = layernorm_plain(x, gamma, beta, eps)
            qkv = qkv_proj_plain(xn, w, b)
        else:
            xn = layernorm_cuda(x, gamma, beta, eps)
            qkv = qkv_proj_cuda(xn, w, b)
        if g_out is None:
            dqkv = torch.zeros_like(qkv)
        elif impl == "plain":
            dqkv = attn_core_bwd_plain(qkv, g_out, heads, scale)
        else:
            dqkv = attn_core_bwd_cuda(qkv, g_out.contiguous(), heads, scale)
            _build.COUNTS["attention_bwd"] += 1
        if g_qkv is not None:
            dqkv = dqkv + g_qkv
        dxn = torch.matmul(dqkv, w).float()
        if g_xn is not None:
            dxn = dxn + g_xn.float()
        d2 = dqkv.reshape(B * N, -1)
        dw = torch.matmul(d2.t(), xn.reshape(B * N, C)).to(w.dtype)
        db = d2.float().sum(0).to(b.dtype)
        dx, dgamma, dbeta = layernorm_vjp(x, gamma, dxn, eps)
        return dx, dgamma, dbeta, dw, db, *[None] * 6


def fused_attention_ln_qkv(x, gamma, beta, w, b, heads: int,
                           scale: float | None = None, eps: float = 1e-6,
                           need_qkv: bool = False, impl: str | None = None,
                           safe: bool | None = None):
    """softmax-attention of LN(x) @ w.T + b over (B, N, C), w rows head-major.
    Returns the pre-projection head concat (B, N, H*D), or with ``need_qkv``
    the tuple (out, qkv (B, N, H*3*D), xn = LN(x)) for tap layers.

    The fast softmax (safe False) is exact while the scaled logits stay
    inside the clamp, which LN-bounded q/k of trained ViTs do; see
    mtt_tpu/kernels/attention.py:fused_attention_qkv for the precondition."""
    _check(x, gamma, beta, w, b, heads)
    if scale is None:
        scale = (w.shape[0] // heads // 3) ** -0.5
    return _AttentionLnQkv.apply(x, gamma, beta, w, b, heads, scale, eps,
                                 need_qkv, _build.resolve_impl(impl, x),
                                 resolve_safe(safe))


# ---- row 13: attention over a packed head-major qkv -------------------------

def attention_qkv_bwd_plain(qkv, g, heads: int, scale: float):
    """dqkv of the attention over the head-major qkv (B, N, H*3*D) for dOut
    (B, N, H*D): the JAX custom VJP ``_qkv_bwd`` (attention.py:307-327),
    which is ``_bwd``'s function on the q, k, v slices of the packed tensor
    (``attention_generic_bwd_plain``). Unlike ``attn_core_bwd_plain`` (the
    TPU backward kernel's function) nothing is rounded to the dtype on the
    way."""
    B, N, C3 = qkv.shape
    q, k, v = qkv.view(B, N, heads, 3, -1).unbind(3)
    grads = attention_generic_bwd_plain(q, k, v, g.reshape(B, N, heads, -1),
                                        scale)
    return torch.stack(grads, 3).reshape(B, N, C3)


def _check_qkv(qkv, heads: int):
    if qkv.dim() != 3 or not qkv.is_floating_point():
        raise ValueError(f"qkv must be a floating (B, N, H*3*D) tensor, got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    if qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv width {qkv.shape[-1]} is not H*3*D for "
                         f"{heads} heads")


class _AttentionQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale, impl, safe):
        ctx.save_for_backward(qkv)
        ctx.cfg = (heads, scale)
        if impl == "plain":
            return attention_qkv_plain(qkv, heads, scale, safe)
        out = attn_core_cuda(qkv, heads, scale, safe)
        _build.COUNTS["attention_qkv"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return (attention_qkv_bwd_plain(qkv, g, *ctx.cfg), None, None, None,
                None)


def fused_attention_qkv(qkv, heads: int, scale: float | None = None,
                        impl: str | None = None, safe: bool | None = None):
    """Attention over a packed qkv (B, N, H*3*D) in head-major column order
    (each head's q, k, v contiguous); returns the head concat (B, N, H*D).
    Port of mtt_tpu/kernels/attention.py:fused_attention_qkv, whose
    precondition holds here too: the fast exp2 softmax (safe False) is exact
    while the scaled logits stay inside its clamp, as they do for q and k
    projected from LayerNormed activations; ``MTT_ATTN_SAFE_SOFTMAX``
    overrides ``safe`` (``resolve_safe``)."""
    _check_qkv(qkv, heads)
    if scale is None:
        scale = (qkv.shape[-1] // heads // 3) ** -0.5
    return _AttentionQkv.apply(qkv, heads, scale,
                               _build.resolve_impl(impl, qkv),
                               resolve_safe(safe))


def attention_ln_qkv_composed(x, gamma, beta, w, b, heads: int,
                              scale: float | None = None, eps: float = 1e-6,
                              need_qkv: bool = False, impl: str | None = None,
                              safe: bool | None = None):
    """The JAX package's fallback composition of the front half
    (``_attn_ln_qkv_xla``, attention.py:504-520): LayerNorm in f32 rounded
    to the dtype, ``xn @ w.T + b`` in the dtype (two roundings, as XLA's
    product then bias add), then ``fused_attention_qkv``. Arguments and
    outputs as ``fused_attention_ln_qkv``; gradients by autograd through the
    composition."""
    _check(x, gamma, beta, w, b, heads)
    if scale is None:
        scale = (w.shape[0] // heads // 3) ** -0.5
    xn = layernorm_plain(x, gamma, beta, eps)
    qkv = torch.matmul(xn, w.t()) + b.to(x.dtype)
    out = fused_attention_qkv(qkv, heads, scale, impl=impl, safe=safe)
    return (out, qkv, xn) if need_qkv else out


# ---- row 14: attention over separate (B, N, H, D) q, k, v ------------------

def attention_generic_plain(q, k, v, scale: float):
    """softmax(q k^T * scale) v over (B, Nq, H, D) q and (B, Nk, H, D) k, v
    at the TPU kernel's rounding points (attention.py:118-165): the scale
    rounded to the dtype and folded into q, rounded again; f32 logits; the
    max-subtracted natural exp; P cast to v's dtype before P.V; the division
    by the f32 row sum after."""
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / s).to(q.dtype).transpose(1, 2).contiguous()


def attention_generic_bwd_plain(q, k, v, g, scale: float):
    """(dq, dk, dv) of ``fused_attention``: the JAX custom VJP ``_bwd``
    (attention.py:202-225), XLA there and plain torch here: an f32 softmax
    of the unrounded scale times the f32 logits, f32 products, each gradient
    rounded once to its input's dtype."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, -1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_generic(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, N, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D) \
            or k.shape[1] < 1:
        raise ValueError(f"k and v must be (B, Nk, H, D) = ({B}, Nk, {H}, "
                         f"{D}) with Nk >= 1, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for t in (q, k, v):
        if not t.is_floating_point() or t.dtype != q.dtype:
            raise TypeError(f"q, k, v must share one floating dtype, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")


def attention_generic_cuda(q, k, v, scale: float):
    """The kernel reads q, k, v through their (B, N, H) strides: the last
    axis contiguous, every stride and the base 16-byte aligned. It takes
    bf16 and head dims that are multiples of 8 up to 128."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the generic attention kernel takes bfloat16, got "
                        f"{q.dtype}")
    if D % 8 or D > 128:
        raise ValueError(f"the generic attention kernel takes head dims that "
                         f"are multiples of 8 up to 128, got {D}")
    for t in (q, k, v):
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"the generic attention kernel needs the last "
                             f"axis contiguous and 16-byte aligned strides, "
                             f"got strides {t.stride()}")
    out = torch.empty(B, Nq, H, D, dtype=q.dtype, device=q.device)
    sq, sk, sv = (t.stride()[:3] for t in (q, k, v))
    _build.check(_build.lib().mtt_attn_generic_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Nq, Nk,
        H, D, *sq, *sk, *sv, float(torch.tensor(scale, dtype=q.dtype)),
        _build.stream()), "mtt_attn_generic_bf16")
    return out


class _AttentionGeneric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, impl):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if impl == "plain":
            return attention_generic_plain(q, k, v, scale)
        out = attention_generic_cuda(q, k, v, scale)
        _build.COUNTS["attention_generic"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return (*attention_generic_bwd_plain(*ctx.saved_tensors, g, ctx.scale),
                None, None)


def fused_attention(q, k, v, scale: float | None = None,
                    impl: str | None = None):
    """Multi-head attention over (B, Nq, H, D) q and (B, Nk, H, D) k, v with
    a max-subtracted softmax (exact at any logit magnitude); returns (B, Nq,
    H, D). Port of mtt_tpu/kernels/attention.py:fused_attention. The scale
    defaults to D ** -0.5."""
    _check_generic(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _AttentionGeneric.apply(q, k, v, float(scale),
                                   _build.resolve_impl(impl, q))
