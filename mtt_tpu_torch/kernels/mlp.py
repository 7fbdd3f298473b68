"""Transformer MLPs fc2(gelu(fc1(.))): the CUDA kernels (csrc/mlp.cu) and
their plain versions.

Port of mtt_tpu/kernels/mlp.py:
  * ``fused_mlp_ln_res``, the pre-norm half-block x + MLP(LN(x))
    (``_mlp_ln_res_kernel`` and the batch-blocked ``_mlp_ln_res_bb_kernel``,
    one function), which every eval block runs;
  * ``fused_mlp`` (``_mlp_kernel``), the MLP alone, which the training blocks
    with drop-path run after a separate LayerNorm;
with the A&S erf GELU ``_erf_poly`` / ``_gelu_erf_poly``. On the H100 both are
tensor-core work (138 GFLOP for the half-block at ViT-L eval shapes). The
half-block runs as three launches cut at its two bf16 rounding points: the
LayerNorm kernel, then two launches of the shared hand-written wgmma GEMM
(csrc/gemm.cu) with fused epilogues (fc1 + b1 + GELU; fc2 + b2 + x), the
hidden layer going through device memory; its plain version is the same
three stages. The MLP alone is the last two of them, with fc2's epilogue
adding b2 only (see the source note in mlp.cu). Both read their parameters
as stored (bf16 or f32): no cast is launched.

The half-block has an f32 form (``mtt_mlp_ln_res_f32``: the LayerNorm
kernel at f32, then the f32 GEMM of csrc/gemm_f32.cu twice, 3xTF32 on the
tensor cores, nothing rounded but f32 sums), counted under ``mlp_ln_res_f32``; the MLP alone has none yet
(ROADMAP.md item 1.14) and raises at f32.

The gradients are the JAX package's hand-written backwards (mlp.py:201-222
for ``fused_mlp``, :499-540 for ``fused_mlp_ln_res``), computed in plain torch
as JAX computes them in XLA: they recompute the hidden layer, and their large
products go to ``torch.matmul``. Neither backward has a kernel in JAX.

Weights are the nn.Linear layouts: w1 (hidden, C), w2 (C, hidden).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mtt_tpu_torch.kernels import _build
from mtt_tpu_torch.kernels.layernorm import (check_layernorm_width,
                                             layernorm_plain, layernorm_vjp,
                                             ln_f32)

_INV_SQRT2PI = (2.0 * 3.141592653589793) ** -0.5


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


# erf(z)/z as a degree-9 polynomial in z^2 on [0, 3], constant term first
# (mtt_tpu/kernels/mlp.py:_ERF_Z2_COEFFS)
_ERF_Z2_COEFFS = (
    1.1283768672e+00, -3.7607042872e-01, 1.1261189222e-01,
    -2.6508064540e-02, 4.9304063297e-03, -7.1228464379e-04,
    7.6191207693e-05, -5.5816809050e-06, 2.4628598067e-07,
    -4.8841998736e-09)


def gelu_erf_poly_fast(h: torch.Tensor) -> torch.Tensor:
    """The up4 head's polynomial-only GELU (_gelu_erf_poly_fast, |err| <=
    2.1e-4): no divide and no exp, for f32 h."""
    z = h * (2.0 ** -0.5)
    zc = z.clamp(-3.0, 3.0)
    u = zc * zc
    p = torch.full_like(u, _ERF_Z2_COEFFS[-1])
    for c in _ERF_Z2_COEFFS[-2::-1]:
        p = p * u + c
    return 0.5 * h * (1.0 + zc * p)


def _flat(x):
    return x.reshape(-1, x.shape[-1])


def mlp_fc1_gelu_plain(x, w1, b1):
    """The first GEMM's function: fc1 + b1 and the GELU in f32, rounded to
    x's dtype once (mlp.py:96, :303)."""
    h = F.linear(x.float(), w1.float()) + b1.float()
    return gelu_erf_poly(h).to(x.dtype)


def mlp_fc2_plain(h, w2, b2, res=None):
    """The second GEMM's function: fc2 + b2 (+ res) summed in f32 in that
    order, rounded to h's dtype once (mlp.py:105, :309-310)."""
    out = F.linear(h.float(), w2.float()) + b2.float()
    if res is not None:
        out = out + res.float()
    return out.to(h.dtype)


def mlp_fc_plain(x, w1, b1, w2, b2):
    """Rounding points of ``_mlp_kernel``: fc1 + b1 and GELU in f32, cast to
    the dtype before fc2; fc2 + b2 in f32, cast once."""
    return mlp_fc2_plain(mlp_fc1_gelu_plain(x, w1, b1), w2, b2)


def mlp_fc_vjp(x, w1, b1, w2, g):
    """mlp.py:_bwd (fused_mlp) in f32: exact-erf GELU and its derivative
    Phi(h) + h phi(h) on the recomputed pre-activation."""
    xf, gf = _flat(x).float(), _flat(g).float()
    w1f, w2f = w1.float(), w2.float()
    pre = xf @ w1f.t() + b1.float()
    h = F.gelu(pre)
    dh = gf @ w2f
    dpre = dh * (0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
                 + pre * torch.exp(-0.5 * pre * pre) * _INV_SQRT2PI)
    dx = (dpre @ w1f).reshape(x.shape)
    return (dx.to(x.dtype), (dpre.t() @ xf).to(w1.dtype),
            dpre.sum(0).to(b1.dtype), (gf.t() @ h).to(w2.dtype),
            gf.sum(0).to(b1.dtype))


def mlp_ln_res_vjp(x, gamma, beta, w1, b1, w2, g, eps: float):
    """mlp.py:_mlp_ln_res_bwd: recompute LN and the hidden layer, h, the GELU
    output and dh rounded to the activation dtype, products accumulated in
    f32, the residual cotangent added last."""
    dt = x.dtype
    xf = _flat(x)
    xn = ln_f32(xf, gamma, beta, eps).to(dt).float()
    w1f, w2f = w1.float(), w2.float()
    h = xn @ w1f.t() + b1.float()
    hf = h.to(dt).float()
    a = gelu_erf_poly(h).to(dt).float()
    gf = _flat(g).to(dt).float()
    dact = gf @ w2f
    cdf = 0.5 * (1.0 + erf_poly(hf * 2.0 ** -0.5))
    dh = (dact * (cdf + hf * torch.exp(-0.5 * hf * hf) * _INV_SQRT2PI)
          ).to(dt).float()
    dxn = dh @ w1f
    dx, dgamma, dbeta = layernorm_vjp(xf, gamma, dxn, eps)
    dx = (dx + gf.to(dx.dtype)).to(dt).reshape(x.shape)
    return (dx, dgamma, dbeta, (dh.t() @ xn).to(w1.dtype),
            dh.sum(0).to(b1.dtype), (gf.t() @ a).to(w2.dtype),
            _flat(g).float().sum(0).to(b1.dtype))


def mlp_ln_res_plain(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6):
    """Rounding points of the TPU kernel: LN(x) cast to the dtype; fc1 and
    GELU in f32, cast before fc2; fc2 + b2 + x in f32, cast once. Written as
    the kernel's three launches, each stage the plain version of one."""
    xn = layernorm_plain(x, gamma, beta, eps)
    h = mlp_fc1_gelu_plain(xn, w1, b1)
    return mlp_fc2_plain(h, w2, b2, res=x)


def _check(x, w1, b1, w2, b2, gamma=None, beta=None):
    if not x.is_floating_point():
        raise TypeError(f"the MLP needs a floating-point input, got {x.dtype}")
    C = x.shape[-1]
    Hd = w1.shape[0]
    if w1.shape != (Hd, C) or w2.shape != (C, Hd):
        raise ValueError(f"w1 must be (hidden, {C}) and w2 ({C}, hidden), got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    ln = () if gamma is None else (gamma, beta)
    if b1.shape != (Hd,) or b2.shape != (C,) \
            or any(t.shape != (C,) for t in ln):
        raise ValueError("b1 must be (hidden,), b2/gamma/beta (C,)")
    for t in (x, w1, b1, w2, b2, *ln):
        if not t.is_contiguous():
            raise ValueError("MLP inputs must be contiguous")
        if t.device != x.device:
            raise ValueError("MLP inputs must be on one device")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("w1/w2 must have the dtype of x")


def mlp_ln_res_padded(x, gamma, beta, w1, b1, w2, b2, eps, run):
    """``run(x, gamma, beta, w1, b1, w2, b2, eps, C)`` with C and hidden
    rounded up to multiples of 8: x, w1, b1, w2 and b2 zero-padded
    (``_build.pad_to``; nothing is copied where both are multiples already),
    gamma and beta as they are, C the true width, over which ``run``
    normalises; the output's first C columns. ``run`` is the kernel launch;
    the tests pass the plain stages."""
    C, Hd = x.shape[-1], w1.shape[0]
    CP, HP = _build.round8(C), _build.round8(Hd)
    if (CP, HP) == (C, Hd):
        return run(x, gamma, beta, w1, b1, w2, b2, eps, C)
    out = run(_build.pad_to(x, CP), gamma, beta, _build.pad_to(w1, HP, CP),
              _build.pad_to(b1, HP), _build.pad_to(w2, CP, HP),
              _build.pad_to(b2, CP), eps, C)
    return out if CP == C else out[..., :C].contiguous()


def _mlp_ln_res_launch(x, gamma, beta, w1, b1, w2, b2, eps, C):
    """x (..., CP) with CP = C rounded up to 8, its columns past C zero; the
    bf16 form or the f32 one (``mtt_mlp_ln_res_f32``, which takes f32
    biases) by x's dtype."""
    CP, Hd = x.shape[-1], w1.shape[0]
    M = x.numel() // CP
    out = torch.empty_like(x)
    if M == 0:
        return out
    xn = torch.empty_like(x)
    h = x.new_empty(M, Hd)
    params = [t.contiguous() for t in (gamma, beta, b1, b2)]
    flags = _build.param_flags(*params)
    _build.check_aligned("the MLP-LN-residual kernels", x, w1, w2, *params)
    g, b, bias1, bias2 = params
    name = "mtt_mlp_ln_res_" + ("f32" if x.dtype == torch.float32 else "bf16")
    _build.check(getattr(_build.lib(), name)(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
        bias1.data_ptr(), w2.data_ptr(), bias2.data_ptr(), xn.data_ptr(),
        h.data_ptr(), out.data_ptr(), M, C, Hd, float(eps), flags,
        _build.stream()), name)
    return out


def mlp_ln_res_cuda(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6):
    """The LayerNorm launch and the two GEMMs; the scratch xn (rows, C) and
    h (rows, hidden) come from torch.empty. bf16: parameters are read in
    their stored dtype (bf16 or f32), no cast is launched; f32: the f32
    forms (csrc/mlp.cu: mtt_mlp_ln_res_f32), the weights and biases f32.
    Widths that are not multiples of 8 run zero-padded
    (``mlp_ln_res_padded``): the LayerNorm counts the true C and writes
    zeros past it."""
    form = _build.form(x, "the MLP kernel")
    check_layernorm_width(x.shape[-1])
    if form == "f32" and (b1.dtype != x.dtype or b2.dtype != x.dtype):
        raise TypeError("the MLP kernel's f32 form takes f32 biases")
    return mlp_ln_res_padded(x, gamma, beta, w1, b1, w2, b2, eps,
                             _mlp_ln_res_launch)


def mlp_fc_padded(x, w1, b1, w2, b2, run):
    """``run(x, w1, b1, w2, b2)`` with C and hidden rounded up to multiples
    of 8, every operand zero-padded (nothing is copied where both are
    multiples already); the output's first C columns."""
    C, Hd = x.shape[-1], w1.shape[0]
    CP, HP = _build.round8(C), _build.round8(Hd)
    if (CP, HP) == (C, Hd):
        return run(x, w1, b1, w2, b2)
    out = run(_build.pad_to(x, CP), _build.pad_to(w1, HP, CP),
              _build.pad_to(b1, HP), _build.pad_to(w2, CP, HP),
              _build.pad_to(b2, CP))
    return out if CP == C else out[..., :C].contiguous()


def _mlp_fc_launch(x, w1, b1, w2, b2):
    C, Hd = x.shape[-1], w1.shape[0]
    M = x.numel() // C
    out = torch.empty_like(x)
    if M == 0:
        return out
    h = x.new_empty(M, Hd)
    flags = _build.param_flags(b1, b2)
    _build.check_aligned("the MLP kernels", x, w1, b1, w2, b2)
    _build.check(_build.lib().mtt_mlp_fc_bf16(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), h.data_ptr(), out.data_ptr(), M, C, Hd, flags,
        _build.stream()), "mtt_mlp_fc_bf16")
    return out


def mlp_fc_cuda(x, w1, b1, w2, b2):
    """Two launches of the shared GEMM: fc1 + b1 + GELU into the scratch h
    (rows, hidden) from torch.empty, then fc2 + b2. Any row count and
    widths (zero-padded to multiples of 8 where they are not:
    ``mlp_fc_padded``); the biases read in their stored dtype."""
    if x.dtype == torch.float32:
        raise _build.no_f32_form("the MLP kernel (row 8)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the MLP kernel takes bfloat16, got {x.dtype}")
    return mlp_fc_padded(x, w1, b1, w2, b2, _mlp_fc_launch)


class _MlpLnRes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps, impl):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2)
        ctx.eps = eps
        if impl == "plain":
            return mlp_ln_res_plain(x, gamma, beta, w1, b1, w2, b2, eps)
        out = mlp_ln_res_cuda(x, gamma, beta, w1, b1, w2, b2, eps)
        _build.count("mlp_ln_res", x.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*mlp_ln_res_vjp(*ctx.saved_tensors, g, ctx.eps), None, None)


class _MlpFc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, impl):
        ctx.save_for_backward(x, w1, b1, w2)
        if impl == "plain":
            return mlp_fc_plain(x, w1, b1, w2, b2)
        out = mlp_fc_cuda(x, w1, b1, w2, b2)
        _build.COUNTS["mlp_fc"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return (*mlp_fc_vjp(*ctx.saved_tensors, g), None)


def fused_mlp_ln_res(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6,
                     impl: str | None = None):
    """Pre-norm MLP half-block over (..., C): x + MLP(LN(x))."""
    _check(x, w1, b1, w2, b2, gamma, beta)
    return _MlpLnRes.apply(x, gamma, beta, w1, b1, w2, b2, eps,
                           _build.resolve_impl(impl, x))


def fused_mlp(x, w1, b1, w2, b2, impl: str | None = None):
    """Transformer MLP over (..., C): fc2(gelu(fc1(x))), no LN, no residual.
    The JAX wrapper zero-pads C and hidden to multiples of 128 for its
    tiling, which does not change the function; the port's wrapper pads
    them to multiples of 8 where they are not (the GEMM's TMA rows)."""
    _check(x, w1, b1, w2, b2)
    return _MlpFc.apply(x, w1, b1, w2, b2, _build.resolve_impl(impl, x))
