"""Per-task prediction heads (port of mtt_tpu/models/heads.py ``ConvHead``).

Only the dense mode runs here: 3x3 conv + BN + exact GELU -> 1x1 logits on the
4x-upsampled features. It computes the same function with the same parameter
tree as the JAX package's factored up4 head (pinned by tests/test_models.py),
whose fused kernel (kernels/head_up4.py) is the next slice of the port.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.models.layers import ConvBNAct, to_nchw, to_nhwc


class ConvHead(nn.Module):
    """3x3 conv + BN + GELU -> 1x1 logits, NHWC, eval mode."""

    def __init__(self, in_dim: int, num_classes: int, up4: str = "dense", *,
                 device=None, dtype=None):
        super().__init__()
        if up4 != "dense":
            raise NotImplementedError(
                f"ConvHead up4={up4!r} needs the fused up4 head kernel, which "
                "is the next slice of the port (ROADMAP.md); use 'dense'")
        self.mt_proj = ConvBNAct(in_dim, in_dim, 3, use_bias=True,
                                 act=F.gelu, device=device, dtype=dtype)
        self.linear_pred = nn.Conv2d(in_dim, num_classes, 1, device=device,
                                     dtype=dtype)

    def forward(self, x):
        return to_nhwc(self.linear_pred(to_nchw(self.mt_proj(x))))
