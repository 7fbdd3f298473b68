"""Pre-norm MLP half-block x + fc2(gelu(fc1(LN(x)))): the CUDA kernel
(csrc/mlp.cu) and its plain version.

Port of mtt_tpu/kernels/mlp.py ``fused_mlp_ln_res`` (``_mlp_ln_res_kernel``
and the batch-blocked ``_mlp_ln_res_bb_kernel``, one function) with the A&S
erf GELU ``_erf_poly`` / ``_gelu_erf_poly``. On the H100 the call is
tensor-core work (138 GFLOP at ViT-L shapes); the kernel keeps the (rows, 4C)
hidden activation out of device memory, see the source note in mlp.cu.

Weights are the nn.Linear layouts: w1 (hidden, C), w2 (C, hidden).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mtt_tpu_torch.kernels import _build
from mtt_tpu_torch.kernels.layernorm import layernorm_plain


def erf_poly(z: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf, |err| <= 1.5e-7."""
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(z) * (1.0 - poly * torch.exp(-az * az))


def gelu_erf_poly(h: torch.Tensor) -> torch.Tensor:
    """Exact-form GELU on the A&S erf."""
    return 0.5 * h * (1.0 + erf_poly(h * (2.0 ** -0.5)))


def mlp_ln_res_plain(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6):
    """Rounding points of the TPU kernel: LN(x) cast to the dtype; fc1 and
    GELU in f32, cast before fc2; fc2 + b2 + x in f32, cast once."""
    xn = layernorm_plain(x, gamma, beta, eps)
    h = F.linear(xn.float(), w1.float()) + b1.float()
    g = gelu_erf_poly(h).to(x.dtype)
    out = F.linear(g.float(), w2.float()) + b2.float() + x.float()
    return out.to(x.dtype)


def _check(x, gamma, beta, w1, b1, w2, b2):
    if not x.is_floating_point():
        raise TypeError(f"the MLP needs a floating-point input, got {x.dtype}")
    C = x.shape[-1]
    Hd = w1.shape[0]
    if w1.shape != (Hd, C) or w2.shape != (C, Hd):
        raise ValueError(f"w1 must be (hidden, {C}) and w2 ({C}, hidden), got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    if b1.shape != (Hd,) or b2.shape != (C,) or gamma.shape != (C,) \
            or beta.shape != (C,):
        raise ValueError("b1 must be (hidden,), b2/gamma/beta (C,)")
    for t in (x, gamma, beta, w1, b1, w2, b2):
        if not t.is_contiguous():
            raise ValueError("MLP inputs must be contiguous")
        if t.device != x.device:
            raise ValueError("MLP inputs must be on one device")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("w1/w2 must have the dtype of x")


def mlp_ln_res_cuda(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6):
    C = x.shape[-1]
    Hd = w1.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the MLP kernel takes bfloat16, got {x.dtype}")
    if C not in (768, 1024) or Hd % 128:
        raise ValueError(f"the MLP kernel takes C in (768, 1024) and hidden % "
                         f"128 == 0, got C={C}, hidden={Hd}")
    out = torch.empty_like(x)
    f32 = [t.float().contiguous() for t in (gamma, beta, b1, b2)]
    _build.check(_build.lib().mtt_mlp_ln_res_bf16(
        x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), w1.data_ptr(),
        f32[2].data_ptr(), w2.data_ptr(), f32[3].data_ptr(), out.data_ptr(),
        x.numel() // C, C, Hd, float(eps), _build.stream()),
        "mtt_mlp_ln_res_bf16")
    return out


def fused_mlp_ln_res(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6,
                     impl: str | None = None):
    """Pre-norm MLP half-block over (..., C): x + MLP(LN(x))."""
    _check(x, gamma, beta, w1, b1, w2, b2)
    if _build.resolve_impl(impl, x) == "plain":
        return mlp_ln_res_plain(x, gamma, beta, w1, b1, w2, b2, eps)
    out = mlp_ln_res_cuda(x, gamma, beta, w1, b1, w2, b2, eps)
    _build.COUNTS["mlp"] += 1
    return out
