"""3D box geometry on tensors (port of mtt_tpu/detection/box3d.py): period
limiting, BEV footprints and their corners, the 2D box of FCOS distances,
projection and unprojection between the image and the camera frame, Euler
angles to quaternions and the 8 corners of a 3D box. Box code: [x, y, z, l,
w, h, rot0, rot1, yaw] in the camera frame, BEV footprint (x, z, w, l,
yaw)."""

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


def points_cam2img(points_3d, K):
    """Camera-frame 3D points (..., 3) -> pixel coordinates (..., 2), the
    depth floored at 1e-6."""
    pts = points_3d @ K.T
    return pts[..., :2] / torch.clamp(pts[..., 2:3], min=1e-6)


def euler_to_quaternion(yaw, pitch, roll):
    """ZYX-convention Euler angles -> (..., 4) quaternions (w, x, y, z)."""
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], -1)


def corners_3d(boxes):
    """(N, 9) camera boxes -> (N, 8, 3) corners: the (w, h, l) half-extents
    with every sign combination, rotated by the yaw about the camera's y
    axis (the gravity axis), then moved to the centre; for the wireframes."""
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], dtype=boxes.dtype,
                         device=boxes.device)
    local = signs[None] * boxes[:, None, [4, 5, 3]] / 2.0
    c, s = torch.cos(boxes[:, 8]), torch.sin(boxes[:, 8])
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, zeros, s], -1),
                     torch.stack([zeros, ones, zeros], -1),
                     torch.stack([-s, zeros, c], -1)], dim=1)
    return torch.einsum("nij,nvj->nvi", R, local) + boxes[:, None, :3]
