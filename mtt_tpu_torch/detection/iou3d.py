"""Rotated-BEV IoU and greedy NMS at fixed shapes, as tensor code on the
boxes' device (port of mtt_tpu/detection/iou3d.py).

Pairwise rotated-rectangle intersection by vertex collection: contained
corners plus the 16 possible edge-edge intersections (a fixed set of 24
candidates), sorted by angle around their centroid, shoelace area; written
over a leading pair axis where JAX uses ``vmap``. All of it in f32. Greedy
NMS gives the keep mask of JAX's fixed-trip sweep, for several score columns
(classes) at once, in a few rounds over the whole mask: on the rotated IoU
(``nms_bev``) or on the axis-aligned one of the footprints
(``nms_normal_bev``).
"""

from __future__ import annotations

import torch

from mtt_tpu_torch.detection.box3d import xywhr_to_corners

_EPS = 1e-8
PAIR_CHUNK = 1 << 18     # pairs per pass of boxes_overlap_bev (memory bound)


def _point_in_box(pts, box):
    """pts (n, 4, 2) inside rotated boxes (n, 5) [cx, cy, w, h, yaw]."""
    c, s = torch.cos(box[:, 4])[:, None], torch.sin(box[:, 4])[:, None]
    d = pts - box[:, None, :2]
    lx = d[..., 0] * c + d[..., 1] * s
    ly = -d[..., 0] * s + d[..., 1] * c
    return (lx.abs() <= box[:, 2:3] / 2 + 1e-6) & \
        (ly.abs() <= box[:, 3:4] / 2 + 1e-6)


def _seg_intersections(ca, cb):
    """All 16 edge-edge intersection points between quads ca, cb (n, 4, 2)
    -> points (n, 16, 2), valid (n, 16). The degeneracy guard is relative:
    near-parallel edges have |den| ~ |r||q| sin(angle), so an absolute eps
    would misjudge tiny boxes or big far-away ones."""
    a0 = ca.repeat_interleave(4, dim=1)
    a1 = torch.roll(ca, -1, 1).repeat_interleave(4, dim=1)
    b0 = cb.repeat(1, 4, 1)
    b1 = torch.roll(cb, -1, 1).repeat(1, 4, 1)
    r, q = a1 - a0, b1 - b0
    den = r[..., 0] * q[..., 1] - r[..., 1] * q[..., 0]
    scale = torch.sqrt((r * r).sum(-1) * (q * q).sum(-1))
    degenerate = den.abs() < torch.clamp(1e-5 * scale, min=_EPS)
    safe_den = torch.where(degenerate, torch.ones_like(den), den)
    d0 = b0 - a0
    t = (d0[..., 0] * q[..., 1] - d0[..., 1] * q[..., 0]) / safe_den
    u = (d0[..., 0] * r[..., 1] - d0[..., 1] * r[..., 0]) / safe_den
    valid = ~degenerate & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    return a0 + t[..., None] * r, valid


def _pair_intersection_area(box_a, box_b):
    """Intersection areas of n pairs of rotated BEV boxes (n, 5). All
    geometry is relative to the midpoint of the two centres: BEV coordinates
    reach ~100 m, and f32 cancellation on far corners would feed the
    near-parallel determinant divisions."""
    mid = (box_a[:, :2] + box_b[:, :2]) / 2
    box_a = torch.cat([box_a[:, :2] - mid, box_a[:, 2:]], dim=1)
    box_b = torch.cat([box_b[:, :2] - mid, box_b[:, 2:]], dim=1)
    ca, cb = xywhr_to_corners(box_a), xywhr_to_corners(box_b)
    ipts, ival = _seg_intersections(ca, cb)
    pts = torch.cat([ca, cb, ipts], dim=1)                 # (n, 24, 2)
    valid = torch.cat([_point_in_box(ca, box_b), _point_in_box(cb, box_a),
                       ival], dim=1)                       # (n, 24)

    nval = valid.sum(1)
    centroid = (pts * valid[..., None]).sum(1) / nval.clamp(min=1)[:, None]
    ang = torch.atan2(pts[..., 1] - centroid[:, None, 1],
                      pts[..., 0] - centroid[:, None, 0])
    ang = torch.where(valid, ang, torch.full_like(ang, 1e9))  # invalid last
    order = torch.argsort(ang, dim=1, stable=True)
    sp = pts.gather(1, order[..., None].expand(-1, -1, 2))
    sv = valid.gather(1, order)
    # the invalid tail collapses onto the first vertex, so its shoelace
    # terms vanish
    sp = torch.where(sv[..., None], sp, sp[:, :1])
    rolled = torch.roll(sp, -1, 1)
    cross = sp[..., 0] * rolled[..., 1] - sp[..., 1] * rolled[..., 0]
    area = 0.5 * cross.sum(1).abs()
    return torch.where(nval >= 3, area, torch.zeros_like(area))


def boxes_overlap_bev(boxes_a, boxes_b):
    """(N, 5) x (M, 5) rotated boxes -> (N, M) intersection areas."""
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    ia = torch.arange(N, device=boxes_a.device).repeat_interleave(M)
    ib = torch.arange(M, device=boxes_a.device).repeat(N)
    out = [_pair_intersection_area(boxes_a[ia[s:s + PAIR_CHUNK]],
                                   boxes_b[ib[s:s + PAIR_CHUNK]])
           for s in range(0, N * M, PAIR_CHUNK)]
    return torch.cat(out).reshape(N, M)


def boxes_iou_bev(boxes_a, boxes_b):
    """(N, 5) x (M, 5) -> (N, M) rotated IoU."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)


def boxes_iou_aligned(boxes):
    """Axis-aligned pairwise IoU matrix on BEV footprints (N, 5)."""
    x1, y1 = boxes[:, 0] - boxes[:, 2] / 2, boxes[:, 1] - boxes[:, 3] / 2
    x2, y2 = boxes[:, 0] + boxes[:, 2] / 2, boxes[:, 1] + boxes[:, 3] / 2
    area = (x2 - x1) * (y2 - y1)
    iw = torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None],
                                                              x1[None])
    ih = torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None],
                                                              y1[None])
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    return inter / torch.clamp(area[:, None] + area[None] - inter, min=_EPS)


def _greedy_nms_from_iou(iou, scores, iou_thr: float, valid):
    """Greedy suppression on a precomputed (N, N) IoU matrix. ``scores`` and
    ``valid`` are (N,) or (C, N): C independent sweeps (one per class) over
    the same matrix run as one. Returns the keep mask in their shape.

    The sequential sweep "box i, if still alive, kills every later box over
    the threshold against it" is run as a fixed-point iteration over the
    whole mask: alive[j] = valid[j] and no alive i before j suppresses j.
    After t rounds the first t boxes (in score order) hold their final
    value, so it reaches the sweep's result, its only fixed point, in at
    most N rounds, and in practice in as many as the longest chain of
    suppressions (a handful). One comparison on the host a round ends it."""
    single = scores.dim() == 1
    if single:
        scores, valid = scores[None], valid[None]
    C, N = scores.shape
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    # over[c, i, j]: box j (in class c's order) is suppressed by an earlier i
    over = iou[order[:, :, None], order[:, None, :]] > iou_thr
    over &= torch.ones(N, N, dtype=torch.bool, device=iou.device).triu(1)
    over = over.float()
    valid_o = valid.gather(1, order)
    alive = valid_o
    for _ in range(N):
        hit = torch.bmm(alive.float()[:, None], over)[:, 0] > 0
        new = valid_o & ~hit
        if torch.equal(new, alive):
            break
        alive = new
    keep = torch.zeros_like(alive).scatter(1, order, alive)
    return keep[0] if single else keep


def nms_bev(boxes, scores, iou_thr: float, valid=None):
    """Rotated-BEV greedy NMS of boxes (N, 5) [cx, cy, w, h, yaw] by
    ``scores`` (N,) or (C, N); returns the keep mask in the scores' shape.
    ``valid`` (default: all) marks the boxes that take part."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    return _greedy_nms_from_iou(boxes_iou_bev(boxes, boxes), scores, iou_thr,
                                valid)


def nms_normal_bev(boxes, scores, iou_thr: float, valid=None):
    """``nms_bev`` on the axis-aligned IoU of the BEV footprints."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    return _greedy_nms_from_iou(boxes_iou_aligned(boxes), scores, iou_thr,
                                valid)
