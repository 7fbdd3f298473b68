"""FCOS3D training targets and loss, and box decoding at fixed output sizes
(port of mtt_tpu/detection/det_model.py: ``level_points``,
``get_targets_single``, ``direction_targets``, ``detection_loss``,
``build_detection_criterion``, ``decode_bboxes_single``).

Training: padded ground truth (``max_boxes`` slots a image, ``det_valid``
marks the real ones) and one (points x boxes) cost matrix per image, written
out over the batch where JAX maps ``get_targets_single``; FCOS centre
sampling, per-level regress ranges, the nearest centre wins; focal loss on
the classes, smooth-L1 on offset, depth, size, sin-encoded rotation and 2D
box with code weights, softmax CE on the 2-bin directions, BCE on the
centerness. Images without a labelled box drop out of the class loss and of
its average factor, as the reference removes them from the batch. The
average factors (positives and labelled images) count every rank's batch.

Serving: top-k candidates before NMS, offset -> projected centre, image ->
camera unprojection, yaw from the 2-bin direction classes, per-class
rotated-BEV NMS over one shared IoU matrix, fixed output capacity. Tensor
code on the head outputs' device, f32 throughout.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from mtt_tpu_torch.detection import det_losses as L
from mtt_tpu_torch.detection.box3d import (bbox_bev, distance2bbox,
                                           limit_period, points_img2cam)
from mtt_tpu_torch.detection.det_params import INF
from mtt_tpu_torch.detection.iou3d import (_greedy_nms_from_iou,
                                           boxes_iou_aligned, boxes_iou_bev)
from mtt_tpu_torch.parallel.mesh import all_reduce_sum


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


def get_targets(points, strides_pt, regress_lo, regress_hi, gt: dict,
                cfg: dict):
    """Targets of a padded ground-truth batch: gt holds bboxes2d (B, M, 4)
    xyxy, labels (B, M), boxes3d (B, M, 9), centers2d (B, M, 2), depths (B, M)
    and valid (B, M). Returns labels (B, P) (num_classes for background),
    box targets (B, P, 9 [+4]) and centerness (B, P)."""
    xs = points[None, :, 0:1]                             # (1, P, 1)
    ys = points[None, :, 1:2]
    dx = xs - gt["centers2d"][:, None, :, 0]              # (B, P, M)
    dy = ys - gt["centers2d"][:, None, :, 1]
    dist = torch.sqrt(dx ** 2 + dy ** 2)

    # centre sampling: within radius * stride of the projected centre
    rad = strides_pt[None, :, None] * cfg["center_sample_radius"]
    inside_center = (dx.abs() < rad) & (dy.abs() < rad)

    # regress range on the largest distance to the 2D box's sides
    b = gt["bboxes2d"][:, None]                           # (B, 1, M, 4)
    left, top = xs - b[..., 0], ys - b[..., 1]
    right, bottom = b[..., 2] - xs, b[..., 3] - ys
    max_reg = torch.maximum(torch.maximum(left, right),
                            torch.maximum(top, bottom))
    in_range = (max_reg >= regress_lo[None, :, None]) \
        & (max_reg <= regress_hi[None, :, None])

    valid = gt["valid"][:, None, :] != 0
    cost = torch.where(inside_center & in_range & valid, dist,
                       torch.full_like(dist, INF))
    min_dist = cost.amin(-1)                              # (B, P)
    # ties go to the first box, as jnp.argmin gives them
    min_idx = cost.argmin(-1, keepdim=True)               # (B, P, 1)

    def pick(arr):                                        # (B, M, ...) by box
        idx = min_idx.reshape(*min_idx.shape[:2], *[1] * (arr.dim() - 2))
        return arr.gather(1, idx.expand(-1, -1, *arr.shape[2:]))

    labels = torch.where(min_dist < INF, pick(gt["labels"]).long(),
                         cfg["num_classes"])
    sel_dx = dx.gather(2, min_idx)[..., 0]
    sel_dy = dy.gather(2, min_idx)[..., 0]
    parts = [sel_dx[..., None], sel_dy[..., None],
             pick(gt["depths"])[..., None], pick(gt["boxes3d"])[..., 3:]]
    if cfg["pred_bbox2d"]:
        parts.append(torch.stack([s.gather(2, min_idx)[..., 0] for s in
                                  (left, top, right, bottom)], -1))
    tgt = torch.cat(parts, -1)

    rel = torch.sqrt(sel_dx ** 2 + sel_dy ** 2) / (1.414 * strides_pt)
    centerness = torch.exp(-cfg["centerness_alpha"] * rel)

    if cfg["norm_on_bbox"]:
        st = strides_pt[None, :, None]
        if cfg["pred_bbox2d"]:
            tgt = torch.cat([tgt[..., :2] / st, tgt[..., 2:-4],
                             tgt[..., -4:] / st], -1)
        else:
            tgt = torch.cat([tgt[..., :2] / st, tgt[..., 2:]], -1)
    return labels, tgt, centerness


def direction_targets(rot_targets, dir_offset: float = 0.0,
                      num_bins: int = 2):
    """(P, 3) rotation targets -> (P, 3) bin ids."""
    offset_rot = limit_period(rot_targets - dir_offset, 0, 2 * math.pi)
    bins = torch.floor(offset_rot / (2 * math.pi / num_bins)).long()
    return bins.clamp(0, num_bins - 1)


def detection_loss(head_out, batch, det_cfg: dict, strides
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-level FCOS3D loss over a padded ground-truth batch (the
    ``det_*`` keys). Returns the total and its components."""
    cls_scores, bbox_preds, dir_preds, centernesses = head_out
    B = cls_scores[0].shape[0]
    dev = cls_scores[0].device
    nc = det_cfg["num_classes"]
    feat_sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
    points, strides_pt, lvl_ids = level_points(feat_sizes, tuple(strides),
                                               dev)
    rr = torch.tensor(det_cfg["regress_ranges"], dtype=torch.float32,
                      device=dev)
    gt = {k: batch[f"det_{k}"] for k in ("bboxes2d", "labels", "boxes3d",
                                         "centers2d", "depths", "valid")}
    labels, tgt, ctr_tgt = get_targets(points, strides_pt, rr[lvl_ids, 0],
                                       rr[lvl_ids, 1], gt, det_cfg)

    def flat(levels, c):
        return torch.cat([x.reshape(B, -1, c) for x in levels], 1
                         ).reshape(-1, c)

    n_reg = sum(det_cfg["group_reg_dims"])
    cls_f = flat(cls_scores, nc)
    bbox_f = flat(bbox_preds, n_reg).float()
    dir_f = flat(dir_preds, 6).reshape(-1, 3, 2)
    ctr_f = flat(centernesses, 1).reshape(-1)
    labels_f = labels.reshape(-1)
    tgt_f = tgt.reshape(-1, tgt.shape[-1])

    posf = ((labels_f >= 0) & (labels_f < nc)).float()
    # the reference's average factor is num_pos + num_imgs after it removed
    # the images without a labelled box: count only images with one. Both
    # counts are summed over the ranks, as every normaliser of the loss
    labelled = (batch["det_valid"] > 0).any(1)
    n_pos, n_img = all_reduce_sum(torch.stack(
        [posf.sum(), labelled.float().sum()])).unbind()
    avg = torch.clamp_min(n_pos + n_img, 1.0)

    out = {}
    # a label-less image's points leave the class loss entirely
    cls_w = labelled[:, None].expand_as(labels).float().reshape(-1)
    lc = det_cfg["loss_cls"]
    out["loss_cls"] = L.sigmoid_focal_loss(
        cls_f, labels_f, nc, gamma=lc["gamma"], alpha=lc["alpha"],
        weight=cls_w, avg_factor=avg, loss_weight=lc["loss_weight"])

    cw = torch.tensor(det_cfg["code_weight"], dtype=torch.float32,
                      device=dev)
    eq_sum = torch.clamp_min(n_pos, 1e-6)
    beta = det_cfg["loss_bbox"]["beta"]

    # sin-difference encoding of the rotations, channels 6:9
    sin_p = torch.sin(bbox_f[:, 6:9]) * torch.cos(tgt_f[:, 6:9])
    sin_t = torch.cos(bbox_f[:, 6:9]) * torch.sin(tgt_f[:, 6:9])
    pred_enc = torch.cat([bbox_f[:, :6], sin_p, bbox_f[:, 9:]], -1)
    tgt_enc = torch.cat([tgt_f[:, :6], sin_t, tgt_f[:, 9:]], -1)

    def group_loss(lo, hi):
        return L.smooth_l1_loss(pred_enc[:, lo:hi], tgt_enc[:, lo:hi],
                                beta=beta, weight=posf[:, None] * cw[lo:hi],
                                avg_factor=eq_sum)

    out["loss_offset"] = group_loss(0, 2)
    out["loss_depth"] = group_loss(2, 3)
    out["loss_size"] = group_loss(3, 6)
    out["loss_rotsin"] = group_loss(6, 9)
    if det_cfg["pred_bbox2d"]:
        out["loss_bbox2d"] = group_loss(n_reg - 4, n_reg)
    if det_cfg["use_direction_classifier"]:
        dir_tgt = direction_targets(tgt_f[:, 6:9], det_cfg["dir_offset"])
        out["loss_dir"] = sum(L.softmax_ce_loss(dir_f[:, r], dir_tgt[:, r],
                                                weight=posf,
                                                avg_factor=eq_sum)
                              for r in range(3))
    out["loss_centerness"] = L.binary_ce_loss(ctr_f, ctr_tgt.reshape(-1),
                                              weight=posf, avg_factor=eq_sum)
    return sum(out.values()), out


def build_detection_criterion(det_cfg: dict):
    """criterion(head_out, batch) -> (total, components)."""
    strides = tuple(det_cfg["strides"])
    return lambda head_out, batch: detection_loss(head_out, batch, det_cfg,
                                                  strides)


def _top_k(values, k: int):
    """The k largest values and their indices, the lower index first among
    equals (as ``jax.lax.top_k``; ``torch.topk`` leaves ties in any order,
    and the suppressed candidates all tie at -1)."""
    v, i = torch.sort(values, descending=True, stable=True)
    return v[:k], i[:k]


@torch.no_grad()
def decode_candidates(head_out_i, K, det_cfg: dict, strides,
                      scale_factor=1.0) -> Dict[str, torch.Tensor]:
    """The first half of ``decode_bboxes_single``: one image's top
    ``nms_pre`` candidates, before the NMS. Returns boxes3d (k, 9), centers2d
    (k, 3), bboxes2d (k, 4), nms_scores (C, k) (class score x centerness)
    and iou (k, k), the BEV IoU matrix the NMS sweeps over."""
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
    # the (k, k) BEV IoU matrix does not depend on the class: computed once,
    # and the nc greedy sweeps over it run as one
    return {"boxes3d": box3d, "centers2d": c3,
            "bboxes2d": (distance2bbox(pts, bbox[:, -4:])
                         if det_cfg["pred_bbox2d"]
                         else torch.zeros(k, 4, device=dev)),
            "nms_scores": (scores * ctr[:, None]).T.contiguous(),  # (nc, k)
            "iou": (boxes_iou_bev(bev, bev) if test_cfg["use_rotate_nms"]
                    else boxes_iou_aligned(bev))}


@torch.no_grad()
def decode_bboxes_single(head_out_i, K, det_cfg: dict, strides,
                         scale_factor=1.0) -> Dict[str, torch.Tensor]:
    """Decode one image's detections with fixed output size.

    head_out_i: per-level lists (cls (H, W, C), bbox (H, W, R), dir
    (H, W, 6), ctr (H, W, 1)); K the camera matrix. Returns a dict with
    boxes3d (n, 9), bboxes2d (n, 4), scores (n,), labels (n,), centers2d
    (n, 3) and valid (n,), n = ``max_per_img``."""
    c = decode_candidates(head_out_i, K, det_cfg, strides, scale_factor)
    test_cfg = det_cfg["test_cfg"]
    nms_scores = c["nms_scores"]
    k = nms_scores.shape[1]
    score_thr = float(test_cfg["score_thr"])
    keep = _greedy_nms_from_iou(c["iou"], nms_scores,
                                float(test_cfg["nms_thr"]),
                                nms_scores > score_thr)
    sc_cat = torch.where(keep, nms_scores,
                         torch.full_like(nms_scores, -1.0)).reshape(-1)
    kp_cat = keep.reshape(-1)

    kk = min(int(test_cfg["max_per_img"]), sc_cat.shape[0])
    top_sc, top_i = _top_k(sc_cat, kk)
    idx_in_k = top_i % k
    return {
        "boxes3d": c["boxes3d"][idx_in_k],
        "bboxes2d": c["bboxes2d"][idx_in_k],
        "scores": top_sc,
        "labels": top_i // k,
        "centers2d": c["centers2d"][idx_in_k],
        "valid": kp_cat[top_i] & (top_sc > score_thr),
    }
