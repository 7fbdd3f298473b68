"""Row LayerNorm: the CUDA kernel (csrc/layernorm.cu) and its plain version.

Port of mtt_tpu/kernels/layernorm.py (``_ln_kernel``, ``fused_layernorm``).
Statistics and affine run in f32; the result is cast to the input dtype once.
On the H100 the op is bound by device memory (one read, one write of x); the
kernel keeps each row in one warp's registers so x is read exactly once.
"""

from __future__ import annotations

import torch

from mtt_tpu_torch.kernels import _build


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    xc = xf - m
    v = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(v + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


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


def layernorm_cuda(x, gamma, beta, eps: float = 1e-6) -> torch.Tensor:
    """Launches the kernel; counts nothing (callers count)."""
    C = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the LayerNorm kernel takes bfloat16, got {x.dtype}")
    if C % 8 or C > 2048:
        raise ValueError(f"the LayerNorm kernel needs C % 8 == 0 and C <= 2048, "
                         f"got C={C}")
    y = torch.empty_like(x)
    rows = x.numel() // C
    g = gamma.float().contiguous()
    b = beta.float().contiguous()
    _build.check(_build.lib().mtt_layernorm_bf16(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, C,
        float(eps), _build.stream()), "mtt_layernorm_bf16")
    return y


def fused_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6, impl: str | None = None) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape)."""
    _check(x, gamma, beta)
    if _build.resolve_impl(impl, x) == "plain":
        return layernorm_plain(x, gamma, beta, eps)
    y = layernorm_cuda(x, gamma, beta, eps)
    _build.COUNTS["layernorm"] += 1
    return y
