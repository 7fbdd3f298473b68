"""FPN neck, 5 levels with extra convs on the outputs (port of
mtt_tpu/detection/fpn.py ``FPN``), NHWC, a torch composition."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.models.layers import conv1x1, to_nchw, to_nhwc


def same_pad_stride2(x, k: int = 3):
    """Zero padding of an NCHW map for a stride-2 conv as XLA's "SAME" places
    it: in all max((ceil(n / 2) - 1) * 2 + k - n, 0) rows, the smaller half
    first, so an even size pads (0, 1) where torch's padding=1 pads (1, 1)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):                 # F.pad: last axis first
        total = max((-(-n // 2) - 1) * 2 + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, relu_before_extra_convs: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.n_in = len(in_channels)
        self.num_outs = num_outs
        self.relu_before_extra_convs = relu_before_extra_convs
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", nn.Conv2d(c, out_channels, 1, **kw))
            self.add_module(f"fpn_conv_{i}", nn.Conv2d(
                out_channels, out_channels, 3, padding=1, **kw))
        for i in range(num_outs - self.n_in):
            self.add_module(f"extra_conv_{i}", nn.Conv2d(
                out_channels, out_channels, 3, stride=2, **kw))

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        """inputs: NHWC maps, finest first -> ``num_outs`` NHWC levels."""
        lat = [to_nchw(conv1x1(getattr(self, f"lateral_{i}"), x))
               for i, x in enumerate(inputs)]
        # top-down pathway; nearest-exact samples at floor((i + 0.5) * scale),
        # as jax.image.resize "nearest" does
        for i in range(self.n_in - 1, 0, -1):
            size = tuple(lat[i - 1].shape[2:])
            up = lat[i] if tuple(lat[i].shape[2:]) == size else \
                F.interpolate(lat[i], size=size, mode="nearest-exact")
            lat[i - 1] = lat[i - 1] + up
        outs = [getattr(self, f"fpn_conv_{i}")(lat[i])
                for i in range(self.n_in)]
        for i in range(self.num_outs - self.n_in):
            src = outs[-1]
            if i > 0 and self.relu_before_extra_convs:
                src = F.relu(src)
            outs.append(getattr(self, f"extra_conv_{i}")(
                same_pad_stride2(src)))
        return [to_nhwc(o) for o in outs]
