"""Building blocks of the port, NHWC at the public functions.

Port of the parts of mtt_tpu/models/layers.py that the TaskPrompter-ViT and
InvPT forwards run in eval and in training: ``FusedLN``, ``Mlp`` (its ``ln=``
path and the plain MLP of the drop-path blocks), ``PatchEmbed``,
``dot_product_attention``, ``Attention`` (with and without its fused
pre-norm) and ``ViTBlock`` with per-sample ``drop_path``, ``ConvBNAct``,
``interpolate`` and ``upsample2x``, the flax BatchNorm in both modes, and the
factored conv3x3(upsample4) of the up4 head with its shift matrices. Parameter names
follow the JAX package's module tree; leaves use torch's names and layouts
(nn.Linear (out, in), nn.Conv2d OIHW), so ``models/convert_jax.py`` maps one
to the other.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.kernels.attention import (fused_attention,
                                             fused_attention_ln_qkv,
                                             fused_attention_qkv)
from mtt_tpu_torch.kernels.layernorm import fused_layernorm
from mtt_tpu_torch.kernels.mlp import fused_mlp, fused_mlp_ln_res

BN_MOMENTUM = 0.9     # flax's: running = 0.9 running + 0.1 batch (torch 0.1)


class FusedLN(nn.Module):
    """LayerNorm over the last axis through the LayerNorm kernel."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x, impl: Optional[str] = None):
        return fused_layernorm(x, self.weight, self.bias, self.eps, impl=impl)


class Mlp(nn.Module):
    """Transformer MLP fc1 -> GELU -> fc2. With ``ln`` the pre-norm residual
    half-block x + MLP(LN(x)) runs as one kernel (the JAX ``Mlp(...,
    ln=...)`` path); without it the MLP alone runs as one kernel (the JAX
    ``fused_mlp`` path of the drop-path blocks)."""

    def __init__(self, dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)

    def forward(self, x, ln: Optional[FusedLN] = None,
                impl: Optional[str] = None):
        if ln is None:
            return fused_mlp(x, self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias, impl=impl)
        return fused_mlp_ln_res(x, ln.weight, ln.bias, self.fc1.weight,
                                self.fc1.bias, self.fc2.weight, self.fc2.bias,
                                ln.eps, impl=impl)


class PatchEmbed(nn.Module):
    """Image (B, H, W, 3) -> tokens (B, H/p * W/p, C) by a strided conv."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3, *,
                 device=None, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size,
                              device=device, dtype=dtype)

    def forward(self, x) -> Tuple[torch.Tensor, Tuple[int, int]]:
        p = self.patch_size
        B, H, W, _ = x.shape
        if H % p or W % p:
            raise ValueError(
                f"PatchEmbed: input {H}x{W} must be divisible by "
                f"patch_size={p} (the reference's strided conv silently "
                f"truncated the remainder; pad or resize the input)")
        x = x.to(self.proj.weight.dtype).permute(0, 3, 1, 2)
        y = self.proj(x)                              # (B, C, gh, gw)
        gh, gw = H // p, W // p
        return y.flatten(2).transpose(1, 2), (gh, gw)


def drop_path(x, rate: float, generator: Optional[torch.Generator]):
    """Stochastic depth per sample (``DropPath``): a kept sample is scaled by
    1 / keep, a dropped one is zero. The draws come from ``generator``."""
    if generator is None:
        raise ValueError("training with drop-path needs a torch.Generator "
                         "for its masks: pass generator=... (or build the "
                         "model with drop_path_rate=0)")
    keep = 1.0 - rate
    mask = (torch.rand(x.shape[0], generator=generator,
                       device=generator.device) < keep).to(x.device)
    return torch.where(mask.view(-1, *[1] * (x.dim() - 1)), x / keep,
                       torch.zeros_like(x))


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          impl: Optional[str] = None):
    """Softmax attention over (B, N, H, D) tensors with an f32 max-subtracted
    softmax, through the generic attention kernel (layers.py:195-202)."""
    return fused_attention(q, k, v, scale=scale, impl=impl)


class Attention(nn.Module):
    """ViT multi-head self-attention. With ``ln`` (the pre-norm blocks) LN,
    the qkv projection (rows head-major (H, 3, D)) and the attention run
    through the front-half kernels; without it the qkv projection is a plain
    product and the attention runs over the packed qkv (layers.py:234-240).
    Then the output projection. Training forwards take the max-subtracted
    softmax."""

    def __init__(self, dim: int, num_heads: int, *, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device, dtype=dtype)
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x, ln: Optional[FusedLN] = None, train: bool = False,
                impl: Optional[str] = None):
        D = x.shape[-1] // self.num_heads
        if ln is None:
            out = fused_attention_qkv(self.qkv(x), self.num_heads, D ** -0.5,
                                      impl=impl, safe=train)
        else:
            out = fused_attention_ln_qkv(
                x, ln.weight, ln.bias, self.qkv.weight, self.qkv.bias,
                self.num_heads, D ** -0.5, ln.eps, impl=impl, safe=train)
        return self.proj(out)


class ViTBlock(nn.Module):
    """Pre-norm transformer block: x + Attn(LN(x)); x + MLP(LN(x)). In eval
    (and without drop-path) the second half is the fused MLP half-block; a
    training block with drop-path runs LayerNorm, the plain MLP and the
    per-sample mask."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.drop_path = drop_path
        self.norm1 = FusedLN(dim, **kw)
        self.attn = Attention(dim, num_heads, **kw)
        self.norm2 = FusedLN(dim, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x, train: bool = False, impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        h = self.attn(x, self.norm1, train, impl)
        if not train or self.drop_path == 0.0:
            return self.mlp(x + h, self.norm2, impl=impl)
        x = x + drop_path(h, self.drop_path, generator)
        h = self.mlp(self.norm2(x, impl=impl), impl=impl)
        return x + drop_path(h, self.drop_path, generator)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def bn_eval(x, bn: nn.BatchNorm2d):
    """Eval BatchNorm in f32 on an NCHW tensor, cast back to its dtype."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    add = bn.bias.float() - bn.running_mean.float() * inv
    return (x.float() * inv[:, None, None] + add[:, None, None]).to(x.dtype)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean, var) -> None:
    """flax running averages (momentum 0.9) of the batch mean and the BIASED
    batch variance; torch's own update would use the unbiased one."""
    bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
    bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    bn.num_batches_tracked += 1


def bn_train(x, bn: nn.BatchNorm2d):
    """Training BatchNorm as flax computes it, on an NCHW tensor: batch
    statistics in f32 with the fast variance E[x^2] - E[x]^2 clipped at 0
    (flax ``_compute_stats``), normalised in f32, cast back to x's dtype;
    the running statistics are updated as a side effect."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    update_running_stats(bn, mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias.float()[:, None, None]
    return y.to(x.dtype)


def batch_norm(x, bn: nn.BatchNorm2d, train: bool):
    return bn_train(x, bn) if train else bn_eval(x, bn)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm (running statistics, or batch statistics in
    training) -> activation, NHWC in and out."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 use_bias: bool = False,
                 act: Optional[Callable] = F.relu, *, device=None,
                 dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size,
                              padding=kernel_size // 2, bias=use_bias,
                              device=device, dtype=dtype)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1, device=device,
                                 dtype=dtype)
        self.act = act

    def forward(self, x, train: bool = False):
        y = batch_norm(self.conv(to_nchw(x)), self.bn, train)
        if self.act is not None:
            y = self.act(y)
        return to_nhwc(y)


def interpolate(x, size: Tuple[int, int]):
    """Half-pixel bilinear resize of an NHWC map, no antialias (JAX
    ``interpolate`` == torch align_corners=False)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(to_nchw(x), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return to_nhwc(y)


def upsample2x(x):
    """2x bilinear upsample, NHWC."""
    return interpolate(x, (2 * x.shape[1], 2 * x.shape[2]))


def conv1x1(conv: nn.Conv2d, x):
    """A 1x1 ``nn.Conv2d`` applied to an NHWC map as a product over the last
    axis: the same function without the two layout changes."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


@functools.lru_cache(maxsize=128)
def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel bilinear weights, the sampling of
    ``interpolate`` for upsampling (mtt_tpu/models/layers.py:310-323)."""
    o = np.arange(n_out)
    c = (o + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(c).astype(int)
    frac = (c - lo).astype(np.float32)
    hi = np.clip(lo + 1, 0, n_in - 1)
    lo = np.clip(lo, 0, n_in - 1)
    M = np.zeros((n_out, n_in), np.float32)
    np.add.at(M, (o, lo), 1.0 - frac)
    np.add.at(M, (o, hi), frac)
    return M


@functools.lru_cache(maxsize=64)
def _upf_shift_stack_np(g: int, f: int) -> np.ndarray:
    """(g, 3, f*g) stacked shifted-upsample mix matrices: entry [w, l, W] is
    the weight with which low-res column w reaches high-res column W through
    conv tap l (offset l - 1). Out-of-range rows are zero, which is the
    conv's SAME zero padding (mtt_tpu/models/layers.py:530-543)."""
    U = _linear_resize_matrix(g, f * g)              # (fg, g)
    S = np.zeros((3, f * g, g), np.float32)
    for k in range(3):
        d = k - 1
        lo, hi = max(0, -d), min(f * g, f * g - d)
        S[k, lo:hi] = U[lo + d:hi + d]
    return S.transpose(2, 0, 1).copy()               # (g, 3, fg)


def _up4_shift_stack_np(g: int) -> np.ndarray:
    return _upf_shift_stack_np(g, 4)


@functools.lru_cache(maxsize=64)
def on_device(make, g, device: torch.device) -> torch.Tensor:
    """``make(g)`` (a cached numpy table; ``g`` an int or a tuple) as a tensor
    on ``device``, copied once: a copy from pageable host memory waits for
    the device's queue."""
    return torch.from_numpy(make(g)).to(device)


def up4_conv3x3_gm(x, kernel):
    """The channel contraction of the factored conv3x3(upsample4): Gm = x .
    W[k, l] for the 9 taps, in x's dtype. x (B, gh, gw, C), kernel HWIO (3,
    3, C, D) -> (B, gh, gw, 3, 3, D)."""
    B, gh, gw, C = x.shape
    D = kernel.shape[-1]
    Wf = kernel.to(x.dtype).permute(2, 0, 1, 3).reshape(C, 9 * D)
    return torch.matmul(x.reshape(-1, C), Wf).reshape(B, gh, gw, 3, 3, D)


def up4_conv3x3_mix(G6):
    """The width mix of Gm (B, gh, gw, 3, 3, D), rounded to its dtype, then
    the height mix in f32, through the shifted upsample matrices; returns
    channel-major (B, D, 4gw, 4gh) f32."""
    gh, gw = G6.shape[1:3]
    Sw = on_device(_up4_shift_stack_np, gw, G6.device).to(G6.dtype)
    Sh = on_device(_up4_shift_stack_np, gh, G6.device)
    M = torch.einsum("bhwkld,wlW->bhkdW", G6, Sw)
    return torch.einsum("bhkdW,hkH->bdWH", M.float(), Sh)


def up4_conv3x3_factored(x, kernel):
    """Exact conv3x3-SAME(bilinear_upsample4(x)) with the channel contraction
    at low resolution (mtt_tpu/models/layers.py:550-584): Gm = x . W[k, l]
    for the 9 taps, then the width and height mixes through the shifted
    upsample matrices. Rounds where the JAX composition rounds: Gm and the
    width mix to x's dtype, the height mix in f32. x (B, gh, gw, C), kernel
    HWIO (3, 3, C, D); returns channel-major (B, D, 4gw, 4gh) f32. A torch
    composition, as it is XLA in JAX; the training head runs it."""
    return up4_conv3x3_mix(up4_conv3x3_gm(x, kernel))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights with the JAX package's initialisers: LeCun
    truncated normal for Linear/Conv weights, zero biases, unit LN/BN/GN
    scales and BN variances; ``pos_embed``, InvPT's ``fuse_attn_kernel`` and
    Swin's ``relative_position_bias_table`` N(0, 0.02) and ``task_prompts``
    N(1, 1), all truncated at two sigma. The detection head's own: the
    deformable conv's ``offset_mask`` zero (no deformation at first), its
    kernel He normal, the class bias at prior probability 0.01 and unit
    per-level ``scales``."""

    def trunc_(t, std, mean=0.0):
        with torch.no_grad():
            tmp = torch.empty(t.shape, device=t.device, dtype=torch.float32)
            nn.init.trunc_normal_(tmp, mean, std, mean - 2 * std,
                                  mean + 2 * std, generator=generator)
            t.copy_(tmp)

    for name, p in module.named_parameters():
        *owner, leaf = name.split(".")
        owner = owner[-1] if owner else ""
        if leaf in ("pos_embed", "fuse_attn_kernel",
                    "relative_position_bias_table"):
            trunc_(p, 0.02)
        elif leaf == "task_prompts":
            trunc_(p, 1.0, 1.0)
        elif leaf == "scales":
            nn.init.ones_(p)
        elif owner == "offset_mask":
            nn.init.zeros_(p)
        elif owner == "dcn" and leaf == "weight":
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device)
                        * (2.0 / p.shape[1]) ** 0.5)
        elif owner == "conv_cls" and leaf == "bias":
            nn.init.constant_(p, -4.595)
        elif leaf == "weight" and p.dim() >= 2:
            fan_in = math.prod(p.shape[1:])
            if isinstance(module.get_submodule(name.rsplit(".", 1)[0]),
                          nn.ConvTranspose2d):      # weight (in, out, kh, kw)
                fan_in = p.shape[0] * math.prod(p.shape[2:])
            # flax lecun_normal: truncated normal, variance 1 / fan_in
            trunc_(p, (1.0 / fan_in) ** 0.5 / 0.87962566103423978)
        elif leaf == "weight":
            nn.init.ones_(p)
        else:
            nn.init.zeros_(p)
    for name, buf in module.named_buffers():
        if name.endswith("running_var"):
            buf.fill_(1.0)
        elif name.endswith("running_mean"):
            buf.zero_()
