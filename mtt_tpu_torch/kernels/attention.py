"""Softmax attention: the CUDA kernels (csrc/attention.cu,
csrc/attention_generic.cu) and their plain versions.

Port of mtt_tpu/kernels/attention.py:

- ``fused_attention_ln_qkv``, the pre-norm front half: the TPU's
  ``_attn_ln_qkv_cached_kernel`` (non-tap blocks) and the emit variant
  ``_attn_ln_qkv_emit_pallas`` = ``_ln_kernel`` + ``_attn_ln_qkv_kernel(ln=False,
  emit=True)`` (tap blocks), with the softmax helpers ``_fast_exp2_probs``
  and ``_resolve_safe``. On the card the call is three hand-written
  launches: LN rows, the qkv projection (the shared wgmma GEMM of
  csrc/gemm.cu, bias added in f32 and rounded once), and the attention
  core (``mtt_attn_core_bf16``), which streams K/V tiles per (query tile,
  head, batch item) and keeps the scores in registers. The safe softmax
  takes the max over all keys in a first pass before P is rounded, as the
  TPU kernel does.
- ``fused_attention_qkv`` (``_attn_qkv_kernel``): attention over a packed
  head-major qkv. It is the function of the attention core above, so on the
  card it launches the same core under its own count.
- ``attention_ln_qkv_composed``: the JAX package's XLA composition of the
  front half (``_attn_ln_qkv_xla``), LN and the product in torch, then
  ``fused_attention_qkv``. ``fused_attention_ln_qkv`` does not route to it:
  the card's front-half kernels have no VMEM budget to fall back from.
- ``fused_attention`` (``_attn_kernel``): max-subtracted attention over
  separate (B, N, H, D) q, k, v with any key count and head dims up to 128.
  The core of the rows above and this one are one kernel template
  (csrc/attention_generic.cu) under three softmax policies: fast, safe and
  generic.

Every launch has an f32 form, taken for an f32 activation (the
TaskPrompter-ViT eval forward at JAX's default dtype): the LayerNorm
kernel's, the f32 GEMM's (csrc/gemm_f32.cu) and the f32 core
(csrc/attention_f32.cu, the Generic, Fast and Safe policies; Generic and
Safe with one online pass over the keys), both 3xTF32 on the tensor cores,
each counted under ``<name>_f32``. At f32 every rounding point above is the
identity, so the plain versions are the f32 forms' references as they stand
(the exact max there; the kernel's running max moves results by f32
rounding only). The backward kernel has no f32 form yet (ROADMAP.md item
1.14).

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


def check_attn_head_dim(D: int, what: str) -> None:
    """Raises unless the attention core (csrc/attention_generic.cu) and its
    backward (csrc/attention_bwd.cu) take head dim ``D``: at most 128 (the
    widest tile whose fragments fit the registers). The kernels read
    16-byte rows of whole mma.sync k steps, padded to their head-dim tiles
    (16 or 32, 64, 80, 128); a head dim that is not a multiple of 8 is
    zero-padded to one by the wrapper (``pad_heads``). ViT-L and ViT-B have
    64, ViT-T 16."""
    if D < 1 or D > 128:
        raise ValueError(f"{what} takes head dims up to 128 (zero-padded to "
                         f"a multiple of 8 from 8 to 128), got {D}")


def pad_heads(t: torch.Tensor, heads: int, parts: int, D: int, DP: int):
    """The head-major (B, N, heads * parts * D) tensor with each head's
    ``parts`` slices of D (q, k, v: 3; the output: 1) zero-padded to DP."""
    B, N = t.shape[:2]
    return _build.pad_to(t.reshape(B, N, heads, parts, D), DP).reshape(
        B, N, heads * parts * DP)


def unpad_heads(t: torch.Tensor, heads: int, parts: int, D: int, DP: int):
    """``pad_heads`` undone: the first D columns of each slice, contiguous."""
    B, N = t.shape[:2]
    return t.reshape(B, N, heads, parts, DP)[..., :D].reshape(
        B, N, heads * parts * D)


def attn_core_bwd_padded(qkv, g, heads: int, scale: float, run):
    """``run(qkv, g, heads, scale)`` at the head dim rounded up to a
    multiple of 8: q, k, v and dOut zero-padded, which adds exact zeros to
    every score and product; the padded columns of dqkv are dropped. The
    scale is the caller's, for the true head dim."""
    D = qkv.shape[-1] // heads // 3
    return _build.run_padded_head(
        run, D, (qkv, g, heads, scale),
        lambda DP: (pad_heads(qkv, heads, 3, D, DP),
                    pad_heads(g, heads, 1, D, DP), heads, scale),
        lambda dqkv, DP: unpad_heads(dqkv, heads, 3, D, DP))


def _attn_core_bwd_launch(qkv, g, heads, scale):
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    dqkv = torch.empty_like(qkv)
    # per (batch, head, query row): log2 of the softmax denominator and
    # r = sum(dp p), rows padded to a multiple of the kernels' 64-row tile
    stats = torch.empty(2, B, heads, -(-N // 64) * 64, dtype=torch.float32,
                        device=qkv.device)
    _build.check(_build.lib().mtt_attn_bwd_bf16(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), B, N,
        heads, D, float(scale), _build.stream()), "mtt_attn_bwd_bf16")
    return dqkv


def attn_core_bwd_cuda(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                       scale: float):
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    check_attn_head_dim(D, "the attention backward kernel")
    if qkv.dtype == torch.float32:
        raise _build.no_f32_form("the attention backward kernel (row 7)")
    if qkv.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError("the attention backward kernel takes bfloat16")
    if g.shape != (B, N, heads * D) or not g.is_contiguous() \
            or not qkv.is_contiguous():
        raise ValueError(f"dOut must be contiguous (B, N, H*D) = "
                         f"{(B, N, heads * D)}, got {tuple(g.shape)}")
    return attn_core_bwd_padded(qkv, g, heads, scale, _attn_core_bwd_launch)


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


def qkv_proj_padded(xn, w, b, run):
    """``run(xn, w, b)`` with C and the qkv width rounded up to multiples of
    8, every operand zero-padded (nothing is copied where both are
    multiples already); the output's first columns."""
    K, N = xn.shape[-1], w.shape[0]
    KP, NP = _build.round8(K), _build.round8(N)
    if (KP, NP) == (K, N):
        return run(xn, w, b)
    qkv = run(_build.pad_to(xn, KP), _build.pad_to(w, NP, KP),
              _build.pad_to(b, NP))
    return qkv if NP == N else qkv[..., :N].contiguous()


def _qkv_proj_launch(xn, w, b):
    K, N = xn.shape[-1], w.shape[0]
    M = xn.numel() // K
    # the bf16 GEMM reads the bias as stored; the f32 one takes f32
    flags = () if xn.dtype == torch.float32 else (_build.param_flags(b),)
    _build.check_aligned("the qkv projection", xn, w, b)
    qkv = torch.empty(*xn.shape[:-1], N, dtype=xn.dtype, device=xn.device)
    name = "mtt_qkv_proj_" + ("bf16" if flags else "f32")
    _build.check(getattr(_build.lib(), name)(
        xn.data_ptr(), w.data_ptr(), b.data_ptr(), qkv.data_ptr(), M, N, K,
        *flags, _build.stream()), name)
    return qkv


def qkv_proj_cuda(xn: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One launch of the shared GEMM with its bias epilogue: xn (..., C) .
    w^T + b. bf16 (csrc/gemm.cu): summed in f32 and rounded once, the bias
    read in its stored dtype; f32 (csrc/gemm_f32.cu): every operand f32,
    nothing rounded. Any row count and widths (zero-padded to multiples of
    8 where they are not: ``qkv_proj_padded``)."""
    form = _build.form(xn, "the qkv projection")
    if w.dtype != xn.dtype or (form == "f32" and b.dtype != xn.dtype):
        raise TypeError(f"the qkv projection takes its weights in the "
                        f"activation dtype {xn.dtype}, got {w.dtype} and "
                        f"{b.dtype}")
    return qkv_proj_padded(xn, w, b, _qkv_proj_launch)


def attn_core_padded(qkv, heads: int, scale: float, safe: bool, run):
    """``run(qkv, heads, scale, safe)`` at the head dim rounded up to a
    multiple of 8: each head's q, k and v zero-padded, which adds exact
    zeros to every score and to P.V; the output's padded columns are
    dropped. The scale is the caller's, for the true head dim."""
    D = qkv.shape[-1] // heads // 3
    return _build.run_padded_head(
        run, D, (qkv, heads, scale, safe),
        lambda DP: (pad_heads(qkv, heads, 3, D, DP), heads, scale, safe),
        lambda out, DP: unpad_heads(out, heads, 1, D, DP))


def _attn_core_launch(qkv, heads, scale, safe):
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    out = torch.empty(B, N, heads * D, dtype=qkv.dtype, device=qkv.device)
    s2 = float(scaled_log2e(scale, qkv.dtype))
    name = "mtt_attn_core_" + ("f32" if qkv.dtype == torch.float32
                               else "bf16")
    _build.check(getattr(_build.lib(), name)(
        qkv.data_ptr(), out.data_ptr(), B, N, heads, D, s2, exp2_clamp_hi(N),
        int(safe), _build.stream()), name)
    return out


def attn_core_cuda(qkv: torch.Tensor, heads: int, scale: float, safe: bool):
    """The attention core under its Fast or Safe softmax policy: bf16
    (``mtt_attn_core_bf16``, csrc/attention_generic.cu, tensor cores) or
    f32 (``mtt_attn_core_f32``, csrc/attention_f32.cu, scores and P.V as
    3xTF32, the softmax in f32); a contiguous head-major (B, N, H*3*D) qkv,
    D up to 128
    (zero-padded to a multiple of 8 where it is not: ``attn_core_padded``)."""
    B, N, C3 = qkv.shape
    D = C3 // heads // 3
    check_attn_head_dim(D, "the attention kernel")
    _build.form(qkv, "the attention kernel")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the attention kernel takes a contiguous, 16-byte "
                         "aligned qkv")
    return attn_core_padded(qkv, heads, scale, safe, _attn_core_launch)


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
        _build.form(x, "the attention kernels")
        xn = layernorm_cuda(x, gamma, beta, eps)
        if need_qkv:
            # tap layers: LN(x) is an output, a launch of the public LN entry
            # point, as attention.py:550 calls fused_layernorm
            _build.count("layernorm", x.dtype)
        qkv = qkv_proj_cuda(xn, w, b)
        out = attn_core_cuda(qkv, heads, scale, safe)
        _build.count("attention_emit" if need_qkv else "attention_cached",
                     x.dtype)
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
        _build.count("attention_qkv", qkv.dtype)
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


def attention_generic_padded(q, k, v, scale: float, run):
    """``run(q, k, v, scale)`` at the head dim rounded up to a multiple of
    8: q, k and v zero-padded (exact zeros in every score and product), the
    output's padded columns dropped; the scale is the caller's."""
    D = q.shape[-1]
    return _build.run_padded_head(
        run, D, (q, k, v, scale),
        lambda DP: (*(_build.pad_to(t, DP) for t in (q, k, v)), scale),
        lambda out, DP: out[..., :D].contiguous())


def _attention_generic_launch(q, k, v, scale):
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    per16 = 16 // q.element_size()      # elements in 16 bytes
    for t in (q, k, v):
        if t.stride(-1) != 1 or any(st % per16 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"the generic attention kernel needs the last "
                             f"axis contiguous and 16-byte aligned strides, "
                             f"got strides {t.stride()}")
    out = torch.empty(B, Nq, H, D, dtype=q.dtype, device=q.device)
    sq, sk, sv = (t.stride()[:3] for t in (q, k, v))
    name = "mtt_attn_generic_" + ("f32" if q.dtype == torch.float32
                                  else "bf16")
    _build.check(getattr(_build.lib(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Nq, Nk,
        H, D, *sq, *sk, *sv, float(torch.tensor(scale, dtype=q.dtype)),
        _build.stream()), name)
    return out


def attention_generic_cuda(q, k, v, scale: float):
    """The kernel reads q, k, v through their (B, N, H) strides: the last
    axis contiguous, every stride and the base 16-byte aligned. It takes
    bf16 (csrc/attention_generic.cu) or f32 (csrc/attention_f32.cu, its
    Generic policy) and head dims up to 128; one that is not a multiple of
    8 runs zero-padded to one (``attention_generic_padded``)."""
    D = q.shape[-1]
    _build.form(q, "the generic attention kernel")
    if D > 128:
        raise ValueError(f"the generic attention kernel takes head dims up "
                         f"to 128 (zero-padded to multiples of 8), got {D}")
    return attention_generic_padded(q, k, v, scale,
                                    _attention_generic_launch)


class _AttentionGeneric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, impl):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if impl == "plain":
            return attention_generic_plain(q, k, v, scale)
        out = attention_generic_cuda(q, k, v, scale)
        _build.count("attention_generic", q.dtype)
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
