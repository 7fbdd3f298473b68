"""Fused up4 ConvHead: the CUDA kernels (csrc/head_up4.cu) and their plain
versions.

Port of mtt_tpu/kernels/head_up4.py ``fused_up4_head`` (``_head_kernel_stencil``,
the default, whose function ``_head_kernel`` and ``_head_kernel_stencil2``
share): conv3x3-SAME(bilinear_upsample4(x)) with the channel contraction at
low resolution, the folded-BN affine, the GELU and the 1x1, with the (B,
4gh, 4gw, n) f32 logits the only output. The 1x1 bias is the
caller's, as in JAX.

Rounding points, kept by the kernels and the plain versions alike: Gm and the
width mix rounded to the activation dtype; the height mix, the affine and the
GELU in f32; the GELU output rounded to the dtype; the 1x1 accumulated in f32.
The TPU kernel sums its per-chunk logits in bf16 (a VMEM budget); the port
keeps them in f32.

On the card the head is two launches cut at the first rounding: Gm (B gh gw,
9 D) on the port's shared wgmma GEMM, into a scratch from ``torch.empty``,
then the mix kernel from Gm to the logits. Their plain versions are
``head_up4_gm_plain`` and ``head_up4_mix_plain``, whose composition is
``head_up4_plain``. The wrapper pads the input and output channels to 8 (TMA
reads rows whose pitch is a multiple of 16 bytes) and the logits to 16 for
the tensor-core tiles, with zeros that add nothing.

At f32 (the TaskPrompter-ViT eval forward at JAX's default dtype) the two
launches are the f32 GEMM (csrc/gemm_f32.cu) and the mix kernel at f32
(``mtt_head_up4_f32``), counted under ``head_up4_f32``: every rounding point
above is the identity there. The GELU follows JAX's gate, which runs the
Pallas kernel at bf16 only: at bf16 the TPU kernel's fast polynomial
(|err| <= 2.1e-4), at f32 the A&S erf (|err| <= 1.5e-7) of JAX's f32 head,
its XLA twin ``_head_xla`` (head_up4.py:460-479); kernel and plain version
alike.

The gradient is torch autograd through ``head_up4_plain``, as the JAX custom
VJP differentiates its XLA composition (head_up4.py:496-519); the training
head does not call this kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mtt_tpu_torch.kernels import _build
from mtt_tpu_torch.kernels.mlp import gelu_erf_poly, gelu_erf_poly_fast
from mtt_tpu_torch.models.layers import (_up4_shift_stack_np, on_device,
                                         up4_conv3x3_factored, up4_conv3x3_gm,
                                         up4_conv3x3_mix)

MAX_LOGITS = 128   # the mix kernel keeps every logit of a pixel in registers


def _affine_gelu_1x1(Y, inv, addv, kp, dt):
    # JAX's gate: the Pallas kernel's fast GELU at bf16, _head_xla's A&S erf
    # at f32
    gelu = gelu_erf_poly if dt == torch.float32 else gelu_erf_poly_fast
    t = gelu(Y * inv.float()[:, None, None]
             + addv.float()[:, None, None]).to(dt)
    return torch.einsum("bdWH,dn->bHWn", t.float(), kp.to(dt).float())


def head_up4_plain(x, kc, inv, addv, kp):
    """x (B, gh, gw, C); kc (3, 3, C, D) HWIO; inv/addv (D,) f32 folded BN;
    kp (D, n) -> (B, 4gh, 4gw, n) f32 logits without the 1x1 bias. The XLA
    twin ``_head_xla``, with the kernel's fast GELU at bf16."""
    return _affine_gelu_1x1(up4_conv3x3_factored(x, kc), inv, addv, kp,
                            x.dtype)


# the first launch's function: Gm = x . kc over the 9 taps, rounded to x's
# dtype once; (B, gh, gw, 3, 3, D)
head_up4_gm_plain = up4_conv3x3_gm


def head_up4_mix_plain(gm, inv, addv, kp):
    """The second launch's function, from Gm (B, gh, gw, 3, 3, D) to the f32
    logits (B, 4gh, 4gw, n)."""
    return _affine_gelu_1x1(up4_conv3x3_mix(gm), inv, addv, kp, gm.dtype)


def _check(x, kc, inv, addv, kp):
    if x.dim() != 4 or not x.is_floating_point():
        raise ValueError(f"x must be a floating (B, gh, gw, C) map, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, gh, gw, C = x.shape
    D = kc.shape[-1]
    n = kp.shape[-1]
    if kc.shape != (3, 3, C, D) or inv.shape != (D,) or addv.shape != (D,) \
            or kp.shape != (D, n):
        raise ValueError(f"kc must be (3, 3, {C}, D), inv/addv (D,), kp "
                         f"(D, n); got {tuple(kc.shape)}, {tuple(inv.shape)}, "
                         f"{tuple(addv.shape)}, {tuple(kp.shape)}")
    for t in (kc, inv, addv, kp):
        if t.device != x.device:
            raise ValueError("up4 head inputs must be on one device")


def check_head_up4_shape(gh: int, gw: int, n: int) -> None:
    """Raises unless the kernels take the head: the grids the JAX kernel
    admits (head_up4.py:_ok), sides multiples of 4 and at least 8, square or
    not (NYUD's 28x36), and at most MAX_LOGITS logits, at any width."""
    if gh % 4 or gw % 4 or gh < 8 or gw < 8:
        raise ValueError(f"the up4 head kernel takes grids with sides % 4 == "
                         f"0 and >= 8, got {gh}x{gw}")
    if n > MAX_LOGITS:
        raise ValueError(f"the up4 head kernel takes at most {MAX_LOGITS} "
                         f"logits, got {n}")


@functools.lru_cache(maxsize=32)
def _bands(g: int) -> np.ndarray:
    """(4g, 3, 3) band of the shifted upsample stack: [W, l, dw] is the
    weight of low-res column W // 4 + dw - 1 through tap l (0 off the map)."""
    S = _up4_shift_stack_np(g)                       # (g, 3, 4g)
    out = np.zeros((4 * g, 3, 3), np.float32)
    for W in range(4 * g):
        for dw in range(3):
            w = W // 4 + dw - 1
            if 0 <= w < g:
                out[W, :, dw] = S[w, :, W]
    return out


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def head_up4_cuda(x, kc, inv, addv, kp):
    """Two launches: Gm on the shared GEMM into a (B gh gw, 9 DP) scratch of
    x's dtype, then the mix kernel over that dtype (at f32: Gm from the
    3xTF32 f32 GEMM, the width mix and t unrounded, the A&S erf GELU, the
    1x1 in f32 on the CUDA cores). Unlike
    the TPU, which sends a head whose
    VMEM estimate fails ``_ok`` (NYUD's 40-class semseg at C = 768) to the
    XLA composition, the card takes every width. Per call the wrapper lays
    out what the kernels read: kc as (9 DP, CP), K-major for the GEMM, and
    kp padded to (DP, NP); x is padded only where C % 8 != 0 (PASCAL's
    350)."""
    B, gh, gw, C = x.shape
    D = kc.shape[-1]
    n = kp.shape[-1]
    check_head_up4_shape(gh, gw, n)
    form = _build.form(x, "the up4 head kernel")
    dt = x.dtype
    CP, DP, NP = _pad8(C), _pad8(D), -(-n // 16) * 16
    xa = (x if CP == C else F.pad(x, (0, CP - C))).contiguous()
    wg = kc.to(dt).permute(0, 1, 3, 2)                # (3, 3, D, C)
    if CP != C or DP != D:
        wg = F.pad(wg, (0, CP - C, 0, DP - D))
    wg = wg.contiguous()
    kpp = F.pad(kp.to(dt), (0, NP - n, 0, DP - D)).contiguous()
    invf, addvf = inv.float().contiguous(), addv.float().contiguous()
    swb = on_device(_bands, gw, x.device)
    shb = on_device(_bands, gh, x.device)
    _build.check_aligned("the up4 head kernels", xa, wg, kpp, invf, addvf)
    gm = x.new_empty(B * gh * gw, 9 * DP)
    out = torch.empty(B, 4 * gh, 4 * gw, n, dtype=torch.float32,
                      device=x.device)
    name = f"mtt_head_up4_{form}"
    _build.check(getattr(_build.lib(), name)(
        xa.data_ptr(), wg.data_ptr(), kpp.data_ptr(), invf.data_ptr(),
        addvf.data_ptr(), swb.data_ptr(), shb.data_ptr(), gm.data_ptr(),
        out.data_ptr(), B, gh, gw, CP, D, DP, n, NP, _build.stream()), name)
    return out


class _HeadUp4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kc, inv, addv, kp, impl):
        ctx.save_for_backward(x, kc, inv, addv, kp)
        if impl == "plain":
            return head_up4_plain(x, kc, inv, addv, kp)
        out = head_up4_cuda(x, kc, inv, addv, kp)
        _build.count("head_up4", x.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = head_up4_plain(*args)
        return (*torch.autograd.grad(y, args, g), None)


def fused_up4_head(x, kc, inv, addv, kp, impl: str | None = None):
    """conv3x3-SAME(bilinear_upsample4(x)) -> folded-BN affine -> GELU ->
    1x1, fused; see the module docstring. Returns (B, 4gh, 4gw, n) f32."""
    _check(x, kc, inv, addv, kp)
    return _HeadUp4.apply(x, kc, inv, addv, kp, _build.resolve_impl(impl, x))
