"""Building blocks of the port, NHWC at the public functions.

Port of the parts of mtt_tpu/models/layers.py that the TaskPrompter-ViT eval
forward runs: ``FusedLN``, ``Mlp`` on its ``ln=`` path, ``PatchEmbed``,
``ConvBNAct`` in eval, and ``interpolate``. Parameter names follow the JAX
package's module tree; leaves use torch's names and layouts (nn.Linear
(out, in), nn.Conv2d OIHW), so ``models/convert_jax.py`` maps one to the other.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.kernels.layernorm import fused_layernorm
from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res


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
    """Transformer MLP fc1 -> GELU -> fc2; the pre-norm residual half-block
    x + MLP(LN(x)) runs as one kernel (the JAX ``Mlp(..., ln=...)`` path)."""

    def __init__(self, dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)

    def forward(self, x, ln: FusedLN, impl: Optional[str] = None):
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


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def bn_eval(x, bn: nn.BatchNorm2d):
    """Eval BatchNorm in f32 on an NCHW tensor, cast back to its dtype."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    add = bn.bias.float() - bn.running_mean.float() * inv
    return (x.float() * inv[:, None, None] + add[:, None, None]).to(x.dtype)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm (running statistics) -> activation, NHWC in and out."""

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

    def forward(self, x):
        y = bn_eval(self.conv(to_nchw(x)), self.bn)
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


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights with the JAX package's initialisers: LeCun
    truncated normal for Linear/Conv weights, zero biases, unit LN/BN
    scales and BN variances; ``pos_embed`` N(0, 0.02) and ``task_prompts``
    N(1, 1), both truncated at two sigma."""

    def trunc_(t, std, mean=0.0):
        with torch.no_grad():
            tmp = torch.empty(t.shape, device=t.device, dtype=torch.float32)
            nn.init.trunc_normal_(tmp, mean, std, mean - 2 * std,
                                  mean + 2 * std, generator=generator)
            t.copy_(tmp)

    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            trunc_(p, 0.02)
        elif leaf == "task_prompts":
            trunc_(p, 1.0, 1.0)
        elif leaf == "weight" and p.dim() >= 2:
            fan_in = math.prod(p.shape[1:])
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
