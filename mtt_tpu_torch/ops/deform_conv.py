"""Modulated deformable convolution (DCNv2) as gather + matmul (port of
mtt_tpu/ops/deform_conv.py: ``bilinear_gather``, ``DeformConv2d``).

Predicted per-position offsets deform the 3x3 sampling grid; bilinear
sampling is 4 gathers and their weights, and the kernel is applied as one
(K*C, Cout) product over the stacked taps. A torch composition, as it is XLA
in the JAX package (no TPU kernel there).

Sampling positions and bilinear weights are computed in f32 whatever the
activation dtype (the JAX module takes them in the activation dtype; in bf16
a position above 128 would lose its fraction).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.models.layers import to_nchw, to_nhwc


def bilinear_gather(x, py, px):
    """Sample x (B, H, W, C) at fractional positions py / px (B, ...) with
    zero padding outside. Returns (B, ..., C) in x's dtype."""
    B, H, W, C = x.shape
    pos_shape = py.shape
    py, px = py.float(), px.float()
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = (py - y0)[..., None], (px - x0)[..., None]
    # gathered from an f32 copy: the same values, and the gradient's
    # scatter-add (up to 36 samples a pixel) accumulates in f32, not bf16
    flat = x.reshape(B, H * W, C).float()

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        vals = flat.gather(1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        return vals.reshape(*pos_shape, C) * inb[..., None]

    out = ((1 - wy) * (1 - wx) * gather(y0, x0)
           + (1 - wy) * wx * gather(y0, x0 + 1)
           + wy * (1 - wx) * gather(y0 + 1, x0)
           + wy * wx * gather(y0 + 1, x0 + 1))
    return out.to(x.dtype)


class DeformConv2d(nn.Module):
    """3x3 modulated deformable conv, NHWC: offsets (y, x) per tap and a
    sigmoid mask come from a plain conv. ``weight`` is (Cout, K*C) with
    tap-major columns (the JAX (K*C, Cout) kernel, transposed)."""

    def __init__(self, in_dim: int, features: int, kernel_size: int = 3, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.kernel_size = kernel_size
        K = kernel_size * kernel_size
        self.offset_mask = nn.Conv2d(in_dim, 3 * K, kernel_size,
                                     padding=kernel_size // 2, **kw)
        self.weight = nn.Parameter(torch.zeros(features, K * in_dim, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))

    def forward(self, x):
        B, H, W, C = x.shape
        ks = self.kernel_size
        K, r = ks * ks, ks // 2
        om = to_nhwc(self.offset_mask(to_nchw(x)))
        off = om[..., :2 * K].reshape(B, H, W, K, 2).float()
        mask = torch.sigmoid(om[..., 2 * K:])             # (B, H, W, K)

        taps = torch.arange(-r, r + 1, device=x.device, dtype=torch.float32)
        ky, kx = torch.meshgrid(taps, taps, indexing="ij")
        yy = torch.arange(H, device=x.device, dtype=torch.float32)
        xx = torch.arange(W, device=x.device, dtype=torch.float32)
        py = yy[None, :, None, None] + ky.reshape(-1) + off[..., 0]
        px = xx[None, None, :, None] + kx.reshape(-1) + off[..., 1]

        # every tap's samples in one gather, then one product over the
        # tap-major K*C axis: f32 accumulation across the taps, one rounding,
        # as the JAX module's per-tap f32 partial sums give
        samples = bilinear_gather(x, py, px) * mask[..., None]  # (B,H,W,K,C)
        return F.linear(samples.reshape(B, H, W, K * C), self.weight) \
            + self.bias
