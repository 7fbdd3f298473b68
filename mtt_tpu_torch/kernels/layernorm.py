"""Row LayerNorm: the CUDA kernel (csrc/layernorm.cu) and its plain version.

Port of mtt_tpu/kernels/layernorm.py (``_ln_kernel``, ``fused_layernorm``).
Statistics and affine run in f32; the result is cast to the input dtype once
(at f32 the kernel's f32 form rounds nothing).
On the H100 the op is bound by device memory (one read, one write of x); the
kernel keeps each row in the registers of one warp (or, at C <= 128, of a
half or a quarter of one; past 4096 columns, of a block of four warps) so x
is read exactly once, and reads gamma and beta in their stored dtype (bf16
or f32), so no cast kernel runs per call. The
same launch is the first stage of the attention front halves and of the MLP
half-block.

The gradient is the JAX package's custom VJP (layernorm.py:89-106): an f32
recompute of the statistics in plain torch, as JAX computes it in XLA. It has
no kernel of its own on either side.
"""

from __future__ import annotations

import torch

from mtt_tpu_torch.kernels import _build


def ln_f32(x, gamma, beta, eps: float) -> torch.Tensor:
    """LayerNorm in f32, not rounded (mlp.py:_ln_f32): the recompute that
    the hand-written backwards start from."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    xc = xf - m
    v = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(v + eps) * gamma.float() + beta.float()


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    return ln_f32(x, gamma, beta, eps).to(x.dtype)


def layernorm_vjp(x, gamma, dy, eps: float):
    """(dx, dgamma, dbeta) of the f32 LayerNorm at x for the cotangent dy
    (f32 or the activation dtype); dx in x's dtype, dgamma/dbeta in gamma's.
    Plain torch: the backward of mtt_tpu/kernels/layernorm.py:_bwd, which
    JAX computes in XLA."""
    xf = x.float()
    gf = dy.float()
    m = xf.mean(-1, keepdim=True)
    xc = xf - m
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    lead = tuple(range(x.dim() - 1))
    dgamma = (gf * xhat).sum(lead)
    dbeta = gf.sum(lead)
    dxhat = gf * gamma.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def _check(x, gamma, beta):
    if not x.is_floating_point():
        raise TypeError(f"LayerNorm needs a floating-point input, got {x.dtype}")
    C = x.shape[-1]
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"gamma/beta must have shape ({C},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    if not x.is_contiguous():
        raise ValueError("LayerNorm needs a contiguous input")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("x, gamma and beta must be on one device")


MAX_C = 16384    # the widest row the kernel takes (csrc/layernorm.cu)


def check_layernorm_width(C: int) -> None:
    """Raises unless the kernel takes rows of C columns: up to 4096 in one
    warp's registers, past that up to MAX_C in a block of four warps
    (InvPT's task-merged stage norm is 2880 wide at embed_dim 512, 5440 at
    1024); C rounded up to a multiple of 8, as the MLP half-block pads it,
    stays within MAX_C. Rows that are not whole 16-byte chunks (830 and 1660
    at embed_dim 600) take 2-byte loads."""
    if C <= 0 or _build.round8(C) > MAX_C:
        raise ValueError(
            f"the LayerNorm kernel takes 1 <= C <= {MAX_C} (a row in one "
            f"warp's registers up to 4096, in four warps' past it), got "
            f"C={C}")


def layernorm_cuda(x, gamma, beta, eps: float = 1e-6) -> torch.Tensor:
    """Launches the kernel in its form for x's dtype (bf16, or f32: the same
    statistics, nothing rounded); counts nothing (callers count)."""
    C = x.shape[-1]
    form = _build.form(x, "the LayerNorm kernel")
    check_layernorm_width(C)
    y = torch.empty_like(x)
    rows = x.numel() // C
    g, b = gamma.contiguous(), beta.contiguous()
    flags = _build.param_flags(g, b)
    _build.check_aligned("the LayerNorm kernel", x, g, b)
    name = f"mtt_layernorm_{form}"
    _build.check(getattr(_build.lib(), name)(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, C,
        float(eps), flags, _build.stream()), name)
    return y


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, impl):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if impl == "plain":
            return layernorm_plain(x, gamma, beta, eps)
        y = layernorm_cuda(x, gamma, beta, eps)
        _build.count("layernorm", x.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        return (*layernorm_vjp(x, gamma, dy, ctx.eps), None, None)


def fused_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6, impl: str | None = None) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape)."""
    _check(x, gamma, beta)
    return _LayerNorm.apply(x, gamma, beta, eps, _build.resolve_impl(impl, x))
