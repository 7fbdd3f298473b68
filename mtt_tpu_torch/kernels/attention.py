"""Pre-norm attention front half: the CUDA kernels (csrc/attention.cu) and the
plain version.

Port of mtt_tpu/kernels/attention.py ``fused_attention_ln_qkv``:
``_attn_ln_qkv_cached_kernel`` (non-tap blocks) and the emit variant
``_attn_ln_qkv_emit_pallas`` = ``_ln_kernel`` + ``_attn_ln_qkv_kernel(ln=False,
emit=True)`` (tap blocks), with the softmax helpers ``_fast_exp2_probs`` and
``_resolve_safe``.

On the card the call is three hand-written launches: LN rows, the qkv
projection (tensor cores, bias added in f32 and rounded once), and the
attention core, which streams K/V tiles per (query tile, head, batch item) and
never writes scores to device memory. The projection and the attention are
both tensor-core bound at ViT-L shapes; see the source note in attention.cu.

The weight is the nn.Linear layout (3C, C) whose rows are HEAD-MAJOR (H, 3, D):
the transpose of the JAX package's (C, 3C) kernel with head-major columns.

The gradient ports the JAX custom VJP (attention.py:697-736): it recomputes LN
and qkv (through the forward's own kernels on the card, uncounted), runs the
attention-core backward (``_attn_bwd_kernel``, csrc/attention_bwd.cu, plain
twin ``attn_core_bwd_plain``), then closes the qkv-projection and LN
gradients. Those closing products are XLA in JAX and ``torch.matmul`` plus
``layernorm_vjp`` in plain torch here. The emit variant also takes the
cotangents of its qkv and xn outputs, which the tap blocks' raw scores feed.
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


def attention_ln_qkv_plain(x, gamma, beta, w, b, heads: int, scale: float,
                           eps: float = 1e-6, need_qkv: bool = False,
                           safe: bool = False):
    """Same function and rounding points as the TPU kernels: qkv bias added
    in f32 then cast; q * s2 in the activation dtype; P cast to v's dtype
    before P.V; division by the row sum after."""
    B, N, C = x.shape
    D = w.shape[0] // heads // 3
    xn = layernorm_plain(x, gamma, beta, eps)
    qkv = qkv_proj_plain(xn, w, b)
    q5 = qkv.view(B, N, heads, 3, D)
    q = q5[:, :, :, 0] * scaled_log2e(scale, x.dtype).to(x.device)
    k, v = q5[:, :, :, 1], q5[:, :, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = fast_exp2_probs(logits, safe, N)
    s = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (o / s).to(x.dtype).permute(0, 2, 1, 3).reshape(B, N, heads * D)
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
    # per (batch, head, query row): softmax max, row sum and r = sum(dp p)
    stats = torch.empty(3, B, heads, N, dtype=torch.float32,
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
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    if D != 64:
        raise ValueError(f"the attention kernel takes head dim 64, got {D}")
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
