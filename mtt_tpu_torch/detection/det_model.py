"""FCOS3D box decoding at fixed output sizes (port of the serving half of
mtt_tpu/detection/det_model.py: ``level_points``, ``decode_bboxes_single``).

Top-k candidates before NMS, offset -> projected centre, image -> camera
unprojection, yaw from the 2-bin direction classes, per-class rotated-BEV NMS
over one shared IoU matrix, fixed output capacity. Tensor code on the head
outputs' device, f32 throughout. Target assignment and the losses belong to
training and are not ported yet.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from mtt_tpu_torch.detection.box3d import (bbox_bev, distance2bbox,
                                           limit_period, points_img2cam)
from mtt_tpu_torch.detection.iou3d import (_greedy_nms_from_iou,
                                           boxes_iou_aligned, boxes_iou_bev)


@functools.lru_cache(maxsize=16)
def level_points(feat_sizes: Tuple[Tuple[int, int], ...],
                 strides: Tuple[float, ...], device=None):
    """Concatenated (P, 2) pixel-centre points, (P,) strides and (P,) level
    ids of the FPN levels (tuples in, so that one set of levels is built and
    copied to the device once)."""
    pts, strs, lvls = [], [], []
    for i, ((h, w), s) in enumerate(zip(feat_sizes, strides)):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pts.append(np.stack([xs.reshape(-1) * s, ys.reshape(-1) * s], -1)
                   + s // 2)
        strs.append(np.full((h * w,), s, np.float32))
        lvls.append(np.full((h * w,), i, np.int64))
    return (torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(device),
            torch.from_numpy(np.concatenate(strs)).to(device),
            torch.from_numpy(np.concatenate(lvls)).to(device))


def _top_k(values, k: int):
    """The k largest values and their indices, the lower index first among
    equals (as ``jax.lax.top_k``; ``torch.topk`` leaves ties in any order,
    and the suppressed candidates all tie at -1)."""
    v, i = torch.sort(values, descending=True, stable=True)
    return v[:k], i[:k]


@torch.no_grad()
def decode_bboxes_single(head_out_i, K, det_cfg: dict, strides,
                         scale_factor=1.0) -> Dict[str, torch.Tensor]:
    """Decode one image's detections with fixed output size.

    head_out_i: per-level lists (cls (H, W, C), bbox (H, W, R), dir
    (H, W, 6), ctr (H, W, 1)); K the camera matrix. Returns a dict with
    boxes3d (n, 9), bboxes2d (n, 4), scores (n,), labels (n,), centers2d
    (n, 3) and valid (n,), n = ``max_per_img``."""
    cls_scores, bbox_preds, dir_preds, ctrs = head_out_i
    dev = cls_scores[0].device
    feat_sizes = tuple(tuple(c.shape[0:2]) for c in cls_scores)
    points, strides_pt, _ = level_points(feat_sizes, tuple(strides), dev)
    nc = det_cfg["num_classes"]
    n_reg = sum(det_cfg["group_reg_dims"])
    test_cfg = det_cfg["test_cfg"]

    scores = torch.sigmoid(torch.cat(
        [c.reshape(-1, nc).float() for c in cls_scores]))
    bbox = torch.cat([b.reshape(-1, n_reg).float() for b in bbox_preds])
    dirp = torch.cat([d.reshape(-1, 3, 2).float() for d in dir_preds])
    ctr = torch.sigmoid(torch.cat([c.reshape(-1).float() for c in ctrs]))

    if det_cfg["norm_on_bbox"]:
        bbox = bbox.clone()
        bbox[:, :2] *= strides_pt[:, None]
        if det_cfg["pred_bbox2d"]:
            bbox[:, -4:] *= strides_pt[:, None]

    max_scores = (scores * ctr[:, None]).amax(dim=1)
    k = min(int(test_cfg["nms_pre"]), max_scores.shape[0])
    topk = _top_k(max_scores, k)[1]
    scores, bbox, dirp, ctr = scores[topk], bbox[topk], dirp[topk], ctr[topk]
    pts = points[topk]

    # offset -> projected centre, then unproject to the camera frame
    sf = torch.as_tensor(scale_factor, dtype=torch.float32, device=dev)
    centers2d = (pts - bbox[:, :2]) / sf
    c3 = torch.cat([centers2d, bbox[:, 2:3]], dim=1)
    cam_xyz = points_img2cam(c3, torch.as_tensor(K, dtype=torch.float32,
                                                 device=dev))
    box3d = torch.cat([cam_xyz, bbox[:, 3:9]], dim=1)        # (k, 9)

    dir_score = dirp.argmax(dim=-1)                           # (k, 3)
    off = det_cfg["dir_offset"]
    rot = limit_period(box3d[:, 6:9] - off, 0, math.pi)
    box3d = torch.cat([box3d[:, :6], rot + off + math.pi * dir_score], dim=1)

    bev = bbox_bev(box3d)
    nms_scores = (scores * ctr[:, None]).T.contiguous()       # (nc, k)
    score_thr = float(test_cfg["score_thr"])
    # the (k, k) BEV IoU matrix does not depend on the class: computed once,
    # and the nc greedy sweeps over it run as one
    iou_mat = boxes_iou_bev(bev, bev) if test_cfg["use_rotate_nms"] \
        else boxes_iou_aligned(bev)
    keep = _greedy_nms_from_iou(iou_mat, nms_scores,
                                float(test_cfg["nms_thr"]),
                                nms_scores > score_thr)
    sc_cat = torch.where(keep, nms_scores,
                         torch.full_like(nms_scores, -1.0)).reshape(-1)
    kp_cat = keep.reshape(-1)

    kk = min(int(test_cfg["max_per_img"]), sc_cat.shape[0])
    top_sc, top_i = _top_k(sc_cat, kk)
    idx_in_k = top_i % k
    return {
        "boxes3d": box3d[idx_in_k],
        "bboxes2d": (distance2bbox(pts, bbox[:, -4:])[idx_in_k]
                     if det_cfg["pred_bbox2d"]
                     else torch.zeros(kk, 4, device=dev)),
        "scores": top_sc,
        "labels": top_i // k,
        "centers2d": c3[idx_in_k],
        "valid": kp_cat[top_i] & (top_sc > score_thr),
    }
