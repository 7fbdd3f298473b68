"""Per-task prediction heads (port of mtt_tpu/models/heads.py ``ConvHead``,
``MLPHead``, ``MLPHeadParams`` and ``DEConvHead``).

``MLPHead`` is InvPT's head, one 1x1 conv ``linear_pred``; ``params()`` hands
its weights to the head-fused tail kernel, which then computes the head (one
module and one tree for both forms).

``ConvHead``:

3x3 conv + BN + exact GELU -> 1x1 logits. Three modes with one parameter tree:

- ``up4="factored"`` (the default, as on the JAX wrapper): the input is the
  patch-grid feature map and the head computes conv3x3(upsample4(x)) without
  materialising the upsampled map. Eval folds BN and the conv bias into one
  affine and runs the fused up4 head kernel (kernels/head_up4.py); training
  runs the factored composition ``up4_conv3x3_factored`` with batch
  statistics (heads.py:93-131).
- ``up4="phase"``: the same function from a patch-grid input through the 16
  phase convs at low resolution with exact border strips
  (``layers.up4_conv3x3_main`` and ``up4_conv3x3_borders``;
  heads.py:133-189), plain torch as it is XLA in JAX. Eval folds BN and the
  conv bias into one affine, runs the per-phase 1x1 and scatters the border
  strips, pushed through the same epilogue, into the logits; training fixes
  the borders on the conv output before it takes the batch moments.
- ``up4="dense"``: the input is already upsampled 4x (or, on the InvPT and
  Swin wrappers, is the feature map itself) and the head runs ``ConvBNAct``
  and a 1x1 conv on it (cuDNN), the JAX ``ConvHead``'s default.

``DEConvHead`` is the Cityscapes-3D head: a 2x2 stride-2 transposed conv, BN,
GELU, a 3x3 conv, BN, GELU and the 1x1 logits (cuDNN, as it is XLA in the JAX
package); in training both BNs take batch statistics (``layers.bn_train``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.kernels.head_up4 import fused_up4_head
from mtt_tpu_torch.models.layers import (ConvBNAct, batch_moments,
                                         batch_norm, conv1x1, depth_to_space4,
                                         scatter_up4_borders, to_nchw,
                                         to_nhwc, up4_conv3x3_borders,
                                         up4_conv3x3_factored,
                                         up4_conv3x3_main,
                                         update_running_stats)

UP4_MODES = ("factored", "phase", "dense")


class MLPHead(nn.Module):
    """1x1 conv to logits, NHWC."""

    def __init__(self, in_dim: int, num_classes: int, *, device=None,
                 dtype=None):
        super().__init__()
        self.linear_pred = nn.Conv2d(in_dim, num_classes, 1, device=device,
                                     dtype=dtype)

    def params(self):
        """(wh (in_dim, n), bh (n,)) for ``fused_ms_tail_head``."""
        return self.linear_pred.weight[:, :, 0, 0].t(), self.linear_pred.bias

    def forward(self, x, train: bool = False, impl=None):
        return conv1x1(self.linear_pred, x)


class ConvHead(nn.Module):
    """3x3 conv + BN + GELU -> 1x1 logits, NHWC."""

    def __init__(self, in_dim: int, num_classes: int, up4: str = "factored",
                 *, device=None, dtype=None):
        super().__init__()
        if up4 not in UP4_MODES:
            raise ValueError(f"ConvHead up4={up4!r}: one of {UP4_MODES}")
        self.up4 = up4
        self.mt_proj = ConvBNAct(in_dim, in_dim, 3, use_bias=True,
                                 act=F.gelu, device=device, dtype=dtype)
        self.linear_pred = nn.Conv2d(in_dim, num_classes, 1, device=device,
                                     dtype=dtype)

    def forward(self, x, train: bool = False, impl=None):
        if self.up4 == "dense":
            return to_nhwc(self.linear_pred(to_nchw(self.mt_proj(x, train))))
        dt = x.dtype
        conv, bn = self.mt_proj.conv, self.mt_proj.bn
        kc = conv.weight.permute(2, 3, 1, 0)                 # HWIO
        kp = self.linear_pred.weight[:, :, 0, 0].t()         # (C, n)
        bp = self.linear_pred.bias.float()

        def folded(m, v):
            """BN of (conv + bias) as one f32 affine (heads.py:100-104)."""
            inv = torch.rsqrt(v + bn.eps) * bn.weight.float()
            return inv, bn.bias.float() - m * inv + conv.bias.float() * inv

        if self.up4 == "phase":
            return self._phase(x, kc, kp, bp, folded, train)
        if not train:
            inv, addv = folded(bn.running_mean.float(), bn.running_var.float())
            logits = fused_up4_head(x, kc, inv, addv, kp, impl=impl)
            return (logits + bp).to(dt)
        # training (heads.py:107-131): batch statistics of conv + bias in f32,
        # centred variance, running averages, exact GELU, 1x1 in f32
        Y = up4_conv3x3_factored(x, kc).to(dt)               # (B, C, W4, H4)
        yf = (Y + conv.bias.to(dt)[None, :, None, None]).float()
        m, v = batch_moments(yf, (0, 2, 3), centred=True)
        update_running_stats(bn, m, v)
        inv, addv = folded(m, v)
        y = F.gelu(Y * inv.to(dt)[None, :, None, None]
                   + addv.to(dt)[None, :, None, None])
        logits = torch.einsum("bcwh,cn->bwhn", y.float(), kp.to(dt).float())
        return (logits + bp).to(dt).transpose(1, 2)          # (B, H4, W4, n)

    def _phase(self, x, kc, kp, bp, folded, train: bool):
        """The phase form (heads.py:133-189): (B, gh, gw, C) ->
        (B, 4gh, 4gw, n)."""
        dt = x.dtype
        B, gh, gw, C = x.shape
        n = kp.shape[1]
        conv, bn = self.mt_proj.conv, self.mt_proj.bn
        kpd = kp.to(dt).float()

        def logits(y):
            """The 1x1 of every phase on the flat phase channels, in f32."""
            z = torch.einsum("bhwpc,cn->bhwpn", y.reshape(B, gh, gw, 16, C)
                             .float(), kpd)
            return (z + bp).to(dt).reshape(B, gh, gw, 16 * n)

        main = up4_conv3x3_main(x, kc)                       # (B,gh,gw,16C)
        borders = up4_conv3x3_borders(x, kc)
        if train:
            # the borders fixed on the conv output first, so that the batch
            # moments are those of the whole high-res map
            y = scatter_up4_borders(main, *borders, C) \
                + conv.bias.to(dt).repeat(16)
            m, v = batch_moments(y.float().reshape(B, gh, gw, 16, C),
                                 (0, 1, 2, 3), centred=True)
            update_running_stats(bn, m, v)
            inv = torch.rsqrt(v + bn.eps) * bn.weight.float()
            y = y * inv.repeat(16).to(dt) \
                + (bn.bias.float() - m * inv).repeat(16).to(dt)
            return depth_to_space4(logits(F.gelu(y)), n)
        # eval: BN and the conv bias one affine, the same pointwise epilogue
        # on the main map and on the border strips, the strips scattered
        # into the logits
        inv, addv = folded(bn.running_mean.float(), bn.running_var.float())
        y = logits(F.gelu(main * inv.repeat(16).to(dt)
                          + addv.repeat(16).to(dt)))

        def epilogue(strip):                                 # (B, L, C)
            s = F.gelu(strip * inv.to(dt) + addv.to(dt))
            return s @ kp.to(dt) + bp.to(dt)

        y = scatter_up4_borders(y, *[epilogue(s) for s in borders], n)
        return depth_to_space4(y, n)


class DEConvHead(nn.Module):
    """Deconv 2x upsample + conv stack -> 1x1 logits, NHWC."""

    def __init__(self, in_dim: int, num_classes: int, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mid = in_dim // 2
        self.deconv = nn.ConvTranspose2d(in_dim, mid, 2, stride=2, **kw)
        self.bn1 = nn.BatchNorm2d(mid, eps=1e-5, momentum=0.1, **kw)
        self.conv = nn.Conv2d(mid, mid, 3, padding=1, **kw)
        self.bn2 = nn.BatchNorm2d(mid, eps=1e-5, momentum=0.1, **kw)
        self.linear_pred = nn.Conv2d(mid, num_classes, 1, **kw)

    def forward(self, x, train: bool = False, impl=None):
        y = F.gelu(batch_norm(self.deconv(to_nchw(x)), self.bn1, train))
        y = F.gelu(batch_norm(self.conv(y), self.bn2, train))
        return conv1x1(self.linear_pred, to_nhwc(y))


HEADS = {"mlp": MLPHead, "conv": ConvHead, "deconv": DEConvHead}
