"""FCOS3D-style monocular 3D detection head with its FPN neck (port of
mtt_tpu/detection/fcos3d_head.py: ``ConvGN``, ``BranchTower``,
``FCOS3DHead``, ``DetectionHead``), NHWC at the public functions.

Shared across the FPN levels: stacked cls / reg conv towers with GroupNorm
(DCNv2 on the last tower conv), branch heads for class scores, grouped box
regression (offset 2, depth 1, size 3, rot 3, bbox2d 4), 3 x 2-bin direction
classification and centerness; per-level learnable scales on offset, depth,
size (and bbox2d); depth and size exp-activated, bbox2d relu-activated. A
torch composition (cuDNN convolutions), as it is XLA in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.detection.fpn import FPN
from mtt_tpu_torch.models.layers import conv1x1, to_nchw, to_nhwc
from mtt_tpu_torch.ops.deform_conv import DeformConv2d

GN_EPS = 1e-6          # flax GroupNorm's default (torch's is 1e-5)


class ConvGN(nn.Module):
    """3x3 conv (or DCNv2) -> GroupNorm -> ReLU, NHWC."""

    def __init__(self, in_dim: int, features: int, use_dcn: bool = False,
                 groups: int = 32, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if use_dcn:
            self.dcn = DeformConv2d(in_dim, features, **kw)
        else:
            self.conv = nn.Conv2d(in_dim, features, 3, padding=1, **kw)
        self.use_dcn = use_dcn
        self.gn = nn.GroupNorm(groups, features, eps=GN_EPS, **kw)

    def forward(self, x):
        y = to_nchw(self.dcn(x)) if self.use_dcn else self.conv(to_nchw(x))
        return to_nhwc(F.relu(self.gn(y)))


class BranchTower(nn.Module):
    """Stack of ConvGN layers shared across FPN levels."""

    def __init__(self, in_dim: int, channels: Sequence[int], groups: int = 32,
                 *, device=None, dtype=None):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"conv_{i}", ConvGN(in_dim, c, groups=groups,
                                                device=device, dtype=dtype))
            in_dim = c
        self.out_dim = in_dim

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"conv_{i}")(x)
        return x


class FCOS3DHead(nn.Module):
    def __init__(self, num_classes: int = 6, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 3,
                 group_reg_dims: Sequence[int] = (2, 1, 3, 3, 4),
                 cls_branch: Sequence[int] = (256, 128),
                 reg_branch: Sequence[Sequence[int]] = ((256,),) * 5,
                 dir_branch: Sequence[int] = (256,),
                 centerness_branch: Sequence[int] = (256,),
                 num_levels: int = 5, dcn_on_last_conv: bool = True,
                 norm_groups: int = 32, pred_bbox2d: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stacked_convs = stacked_convs
        self.group_reg_dims = tuple(group_reg_dims)
        self.pred_bbox2d = pred_bbox2d
        self.scales = nn.Parameter(torch.ones(
            num_levels, 3 + (1 if pred_bbox2d else 0), **kw))
        for tower in ("cls_tower", "reg_tower"):
            for i in range(stacked_convs):
                self.add_module(f"{tower}_{i}", ConvGN(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    use_dcn=dcn_on_last_conv and i == stacked_convs - 1,
                    groups=norm_groups, **kw))
        self.cls_branch = BranchTower(feat_channels, cls_branch, norm_groups,
                                      **kw)
        self.conv_cls = nn.Conv2d(self.cls_branch.out_dim, num_classes, 1,
                                  **kw)
        for gi, dims in enumerate(self.group_reg_dims):
            tower = BranchTower(feat_channels, reg_branch[gi], norm_groups,
                                **kw)
            self.add_module(f"reg_branch_{gi}", tower)
            self.add_module(f"conv_reg_{gi}", nn.Conv2d(tower.out_dim, dims,
                                                        1, **kw))
        self.dir_branch = BranchTower(feat_channels, dir_branch, norm_groups,
                                      **kw)
        self.conv_dir_cls = nn.Conv2d(self.dir_branch.out_dim, 6, 1, **kw)
        self.ctr_branch = BranchTower(feat_channels, centerness_branch,
                                      norm_groups, **kw)
        self.conv_centerness = nn.Conv2d(self.ctr_branch.out_dim, 1, 1, **kw)

    def forward(self, feats: List[torch.Tensor]):
        """feats: FPN level features. Returns per-level lists (cls_scores,
        bbox_preds, dir_preds, centernesses), NHWC."""
        cls_out, bbox_out, dir_out, ctr_out = [], [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for i in range(self.stacked_convs):
                cls_feat = getattr(self, f"cls_tower_{i}")(cls_feat)
                reg_feat = getattr(self, f"reg_tower_{i}")(reg_feat)
            cls_out.append(conv1x1(self.conv_cls, self.cls_branch(cls_feat)))
            bbox = torch.cat(
                [conv1x1(getattr(self, f"conv_reg_{gi}"),
                         getattr(self, f"reg_branch_{gi}")(reg_feat))
                 for gi in range(len(self.group_reg_dims))], dim=-1)
            dir_out.append(conv1x1(self.conv_dir_cls,
                                   self.dir_branch(reg_feat)))
            ctr_out.append(conv1x1(self.conv_centerness,
                                   self.ctr_branch(reg_feat)))
            # per-level scales on offset, depth, size (and bbox2d); depth and
            # size exp-activated, bbox2d relu-activated
            s = self.scales[lvl]
            parts = [bbox[..., 0:2] * s[0], torch.exp(bbox[..., 2:3] * s[1]),
                     torch.exp(bbox[..., 3:6] * s[2]) + 1e-6, bbox[..., 6:9]]
            if self.pred_bbox2d:
                parts.append(F.relu(bbox[..., 9:13] * s[3]))
            bbox_out.append(torch.cat(parts, dim=-1))
        return cls_out, bbox_out, dir_out, ctr_out


class DetectionHead(nn.Module):
    """FPN neck + FCOS3D head on the backbone's multi-scale ``3ddet``
    feature list."""

    def __init__(self, det_cfg: dict, in_channels: Sequence[int], *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        neck = det_cfg["neck"]
        self.fpn = FPN(in_channels, neck["out_channels"], neck["num_outs"],
                       neck["relu_before_extra_convs"], **kw)
        self.fcos3d = FCOS3DHead(
            num_classes=det_cfg["num_classes"],
            in_channels=neck["out_channels"],
            feat_channels=det_cfg["feat_channels"],
            stacked_convs=det_cfg["stacked_convs"],
            group_reg_dims=tuple(det_cfg["group_reg_dims"]),
            cls_branch=tuple(det_cfg["cls_branch"]),
            reg_branch=tuple(tuple(b) for b in det_cfg["reg_branch"]),
            dir_branch=tuple(det_cfg["dir_branch"]),
            centerness_branch=tuple(det_cfg["centerness_branch"]),
            num_levels=det_cfg["fpn_scale_no"],
            dcn_on_last_conv=det_cfg["dcn_on_last_conv"],
            norm_groups=det_cfg["norm_groups"],
            pred_bbox2d=det_cfg["pred_bbox2d"], **kw)

    def forward(self, feats: List[torch.Tensor]):
        return self.fcos3d(self.fpn(feats))
