"""Fused up4 ConvHead: the CUDA kernel (csrc/head_up4.cu) and its plain
version.

Port of mtt_tpu/kernels/head_up4.py ``fused_up4_head`` (``_head_kernel_stencil``,
the default, whose function ``_head_kernel`` and ``_head_kernel_stencil2``
share): conv3x3-SAME(bilinear_upsample4(x)) with the channel contraction at
low resolution, the folded-BN affine, the fast polynomial GELU and the 1x1,
with only the (B, 4gh, 4gw, n) f32 logits reaching device memory. The 1x1
bias is the caller's, as in JAX.

Rounding points, kept by the kernel and the plain version alike: Gm and the
width mix rounded to the activation dtype; the height mix, the affine and the
GELU in f32; the GELU output rounded to the dtype; the 1x1 accumulated in f32.
The TPU kernel sums its per-chunk logits in bf16 (a VMEM budget); the port
keeps them in f32. The TPU wrapper zero-pads the output channels to its
128-lane chunks (head_up4.py:361-374); the CUDA wrapper pads them to the
kernel's 32-channel chunks, and the input channels to 16 for the tensor-core
tiles, with zeros that add nothing.

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
from mtt_tpu_torch.kernels.mlp import gelu_erf_poly_fast
from mtt_tpu_torch.models.layers import (_up4_shift_stack_np, on_device,
                                         up4_conv3x3_factored)

_DC = 32     # output channels per kernel chunk (csrc/head_up4.cu)
_NC = 32     # logits per kernel block


def head_up4_plain(x, kc, inv, addv, kp):
    """x (B, gh, gw, C); kc (3, 3, C, D) HWIO; inv/addv (D,) f32 folded BN;
    kp (D, n) -> (B, 4gh, 4gw, n) f32 logits without the 1x1 bias. The XLA
    twin ``_head_xla`` with the kernel's fast GELU."""
    dt = x.dtype
    Y = up4_conv3x3_factored(x, kc)                   # (B, D, W4, H4) f32
    t = gelu_erf_poly_fast(Y * inv.float()[:, None, None]
                           + addv.float()[:, None, None]).to(dt)
    return torch.einsum("bdWH,dn->bHWn", t.float(), kp.to(dt).float())


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


def head_up4_cuda(x, kc, inv, addv, kp):
    """The kernel takes the grids the JAX kernel admits (head_up4.py:_ok):
    sides multiples of 4 and at least 8, square or not (NYUD's 28x36), and
    at most 128 logits, at any width (above C = 512 it streams the input
    channels, see csrc/head_up4.cu). Anything else raises. Unlike the TPU,
    which sends a head whose VMEM estimate fails ``_ok`` (NYUD's 40-class
    semseg at C = 768) to the XLA composition, the card takes every width
    here."""
    B, gh, gw, C = x.shape
    D = kc.shape[-1]
    n = kp.shape[-1]
    if gh % 4 or gw % 4 or gh < 8 or gw < 8:
        raise ValueError(f"the up4 head kernel takes grids with sides % 4 == "
                         f"0 and >= 8, got {gh}x{gw}")
    if n > 128:
        raise ValueError(f"the up4 head kernel takes at most 128 logits, got "
                         f"{n}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the up4 head kernel takes bfloat16, got {x.dtype}")
    dt = x.dtype
    CP = -(-C // 16) * 16
    DP = -(-D // _DC) * _DC
    NP = -(-n // _NC) * _NC
    xp = F.pad(x, (0, CP - C)).contiguous()
    # wf (DP/32, CP, 3, 3, 32): the kernel per chunk of 32 output channels
    kcp = F.pad(kc.to(dt), (0, DP - D, 0, CP - C))
    wf = kcp.reshape(3, 3, CP, DP // _DC, _DC).permute(3, 2, 0, 1, 4) \
        .contiguous()
    swb = on_device(_bands, gw, x.device)
    shb = on_device(_bands, gh, x.device)
    invp = F.pad(inv.float(), (0, DP - D)).contiguous()
    addvp = F.pad(addv.float(), (0, DP - D)).contiguous()
    kpp = F.pad(kp.to(dt), (0, NP - n, 0, DP - D)).contiguous()
    out = torch.empty(B, 4 * gh, 4 * gw, n, dtype=torch.float32,
                      device=x.device)
    _build.check(_build.lib().mtt_head_up4_bf16(
        xp.data_ptr(), wf.data_ptr(), swb.data_ptr(), shb.data_ptr(),
        invp.data_ptr(), addvp.data_ptr(), kpp.data_ptr(), out.data_ptr(), B,
        gh, gw, CP, DP, n, _build.stream()), "mtt_head_up4_bf16")
    return out


class _HeadUp4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kc, inv, addv, kp, impl):
        ctx.save_for_backward(x, kc, inv, addv, kp)
        if impl == "plain":
            return head_up4_plain(x, kc, inv, addv, kp)
        out = head_up4_cuda(x, kc, inv, addv, kp)
        _build.COUNTS["head_up4"] += 1
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
