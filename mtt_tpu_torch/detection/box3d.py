"""3D box geometry on tensors (port of the parts of mtt_tpu/detection/box3d.py
that decoding runs). Box code: [x, y, z, l, w, h, rot0, rot1, yaw] in the
camera frame, BEV footprint (x, z, w, l, yaw)."""

from __future__ import annotations

import math

import torch


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Limit val into [-offset * period, (1 - offset) * period)."""
    return val - torch.floor(val / period + offset) * period


def bbox_bev(boxes):
    """(N, 9) camera boxes -> (N, 5) BEV [cx, cz, w, l, yaw]."""
    return boxes[:, [0, 2, 4, 3, 8]]


def xywhr_to_corners(bev):
    """(N, 5) [cx, cy, w, h, yaw] -> (N, 4, 2) corner points, elementwise in
    f32 (no matrix product: the polygon clipping downstream needs exact
    corners)."""
    c, s = torch.cos(bev[:, 4]), torch.sin(bev[:, 4])
    hw, hh = bev[:, 2] / 2, bev[:, 3] / 2
    lx = torch.stack([-hw, hw, hw, -hw], dim=1)           # (N, 4)
    ly = torch.stack([-hh, -hh, hh, hh], dim=1)
    gx = lx * c[:, None] - ly * s[:, None] + bev[:, None, 0]
    gy = lx * s[:, None] + ly * c[:, None] + bev[:, None, 1]
    return torch.stack([gx, gy], dim=-1)


def distance2bbox(points, distance):
    """(l, t, r, b) distances -> xyxy boxes."""
    return torch.stack([points[..., 0] - distance[..., 0],
                        points[..., 1] - distance[..., 1],
                        points[..., 0] + distance[..., 2],
                        points[..., 1] + distance[..., 3]], dim=-1)


def points_img2cam(points, K):
    """(u, v, depth) rows -> camera-frame 3D points, K the (3, 3) or (3, 4)
    camera matrix."""
    Kp = torch.eye(4, dtype=points.dtype, device=points.device)
    Kp[:K.shape[0], :K.shape[1]] = K.to(points)
    inv = torch.linalg.inv(Kp).T
    unnorm = torch.cat([points[:, :2] * points[:, 2:3], points[:, 2:3],
                        torch.ones_like(points[:, :1])], dim=1)
    return (unnorm @ inv)[:, :3]
