"""Cityscapes-3D official-style 3D detection evaluation on the host, in
numpy (the port's own copy of mtt_tpu/detection/eval3d.py).

A reimplementation of the cityscapesscripts evaluator the reference ships
(evalObjectDetection3d.py):

  * predictions matched to GT per class by greedy max-IoU matching on
    MODAL 2D boxes with min IoU 0.7;
  * AP: precision/recall over a confidence-threshold sweep
    (arange(0, 1.01, 1/num_conf)), monotonic precision envelope, area
    over distinct recalls;
  * DDTP metrics at the per-class working point (the threshold with best
    precision*recall): BEV center distance score 1 - d/100, size
    similarity prod(min(s/s', s'/s)), orientation similarities
    (1+cos dYaw)/2 and 0.5 + (cos dPitch + cos dRoll)/4, each averaged in
    5 m depth bins over 0-100 m then AUC = mean over populated bins;
  * Detection Score DS = AP * (CD + SS + OS_Yaw + OS_PitchRoll) / 4,
    mDS = mean over classes.

Operates on in-memory per-image records or on-disk JSON folders in the
official gtBbox3d format. The 2D IoU runs in the native library
(``iou3d_native``); where JAX falls back to numpy on any exception, the port
raises, and takes the numpy version only for ``impl="plain"``.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from mtt_tpu_torch.detection import iou3d_native
from mtt_tpu_torch.detection.cs_geometry import EVAL_LABELS


def _iou_matrix(a: np.ndarray, b: np.ndarray, impl=None) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy IoU with the official +1-pixel area convention
    (cityscapesscripts objectDetectionHelpers.calcIouMatrix: widths are
    x2 - x1 + 1): the max corners shifted by +1, then the plain IoU of
    ``iou3d_native`` (the native library; its numpy version for
    ``impl="plain"``)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    a = np.asarray(a, np.float64).copy()
    b = np.asarray(b, np.float64).copy()
    a[:, 2:] += 1.0
    b[:, 2:] += 1.0
    return iou3d_native.iou_matrix_2d(a, b, impl=impl)


def _greedy_matches(iou: np.ndarray, min_iou: float):
    """Iterative max-IoU matching (evalObjectDetection3d.py:512-557)."""
    iou = iou.copy()
    gt_m, pr_m = [], []
    while iou.size and iou.max() > min_iou:
        r, c = np.unravel_index(np.argmax(iou), iou.shape)
        gt_m.append(int(r))
        pr_m.append(int(c))
        iou[r, :] = 0.0
        iou[:, c] = 0.0
    return gt_m, pr_m


def _ypr(quat_wxyz) -> np.ndarray:
    """(w,x,y,z) -> (yaw, pitch, roll) with pyquaternion 0.9.x's exact
    sign convention (the official evaluator calls
    Quaternion(rotation).yaw_pitch_roll, evalObjectDetection3d.py:658;
    note pyquaternion's yaw/roll signs differ from scipy's 'ZYX')."""
    q = np.asarray(quat_wxyz, np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    yaw = np.arctan2(2 * (w * z - x * y), 1 - 2 * (y * y + z * z))
    pitch = np.arcsin(np.clip(2 * (w * y + x * z), -1.0, 1.0))
    roll = np.arctan2(2 * (w * x - y * z), 1 - 2 * (x * x + y * y))
    return np.asarray([yaw, pitch, roll])


class Box3dEvaluator:
    def __init__(self, labels: Sequence[str] = EVAL_LABELS,
                 min_iou: float = 0.7, max_depth: int = 100,
                 step_size: int = 5, num_conf: int = 50, impl=None):
        self.labels = list(labels)
        self.impl = impl
        self.min_iou = min_iou
        self.max_depth = max_depth
        self.step = step_size
        self.thresholds = np.arange(0.0, 1.01, 1.0 / num_conf)
        self.depth_bins = list(range(0, max_depth + 1, step_size))
        self.gts: Dict[str, List[dict]] = {}
        self.preds: Dict[str, List[dict]] = {}
        self.ignores: Dict[str, List[np.ndarray]] = {}

    # --- data ingestion -------------------------------------------------
    @staticmethod
    def _norm_obj(o: dict) -> Optional[dict]:
        """Normalise an official-format object dict."""
        if "3d" not in o:
            return None
        c = np.asarray(o["3d"]["center"], np.float64)
        # official JSON 2D boxes are [x, y, w, h] (CsBbox2d stores xywh and
        # exposes the xyxy property bbox_modal); convert for IoU
        m = np.asarray(o["2d"]["modal"], np.float64)
        return {
            "label": o["label"],
            "center": c,
            "dims": np.asarray(o["3d"]["dimensions"], np.float64),
            "rotation": np.asarray(o["3d"]["rotation"], np.float64),
            "modal": np.asarray([m[0], m[1], m[0] + m[2], m[1] + m[3]]),
            "score": float(o.get("score", 1.0)),
            # CsBbox3d.depth is the INT BEV distance (astype(int) in
            # cityscapesscripts.helpers.annotation); binning must match
            "depth": float(int(np.hypot(c[0], c[1]))),
        }

    def add_image(self, name: str, gt_objects: List[dict],
                  pred_objects: List[dict], ignore_objects: List[dict] = ()):
        self.gts[name] = [g for g in (self._norm_obj(o) for o in gt_objects)
                          if g and g["label"] in self.labels]
        self.preds[name] = [p for p in (self._norm_obj(o) for o in pred_objects)
                            if p and p["label"] in self.labels]
        # official "ignore" regions: 2D boxes that absorb would-be FPs
        # (evalObjectDetection3d.py:485-502)
        ign = []
        for o in ignore_objects:
            r = o.get("2d", o.get("bbox"))
            if r is not None:
                r = np.asarray(r, np.float64)     # official xywh -> xyxy
                ign.append(np.asarray([r[0], r[1], r[0] + r[2],
                                       r[1] + r[3]]))
        self.ignores[name] = ign

    def load_folders(self, gt_folder: str, pred_folder: str):
        for root, _, names in os.walk(gt_folder):
            for nm in sorted(names):
                if not nm.endswith(".json"):
                    continue
                base = nm.replace("_gtBbox3d.json", "").replace(".json", "")
                with open(os.path.join(root, nm)) as f:
                    gt = json.load(f)
                preds = []
                for cand in (base + ".json", base + "_predBbox3d.json"):
                    pred_path = os.path.join(pred_folder, cand)
                    if os.path.isfile(pred_path):
                        with open(pred_path) as f:
                            preds = json.load(f).get("objects", [])
                        break
                self.add_image(base, gt.get("objects", []), preds,
                               gt.get("ignore", []))

    # --- evaluation ------------------------------------------------------
    def _match_at(self, score_thr: float):
        """Per image, per class: tp gt idx, tp pred idx, fp pred, fn gt."""
        out = {}
        for name in self.gts:
            rec = {}
            for lbl in self.labels:
                gt_idx = [i for i, g in enumerate(self.gts[name])
                          if g["label"] == lbl]
                pr_idx = [i for i, p in enumerate(self.preds.get(name, []))
                          if p["label"] == lbl and p["score"] >= score_thr]
                gt_b = np.asarray([self.gts[name][i]["modal"] for i in gt_idx]) \
                    if gt_idx else np.zeros((0, 4))
                pr_b = np.asarray([self.preds[name][i]["modal"] for i in pr_idx]) \
                    if pr_idx else np.zeros((0, 4))
                gm, pm = _greedy_matches(
                    _iou_matrix(gt_b, pr_b, self.impl), self.min_iou)
                tp_gt = [gt_idx[i] for i in gm]
                tp_pr = [pr_idx[i] for i in pm]
                fp_pr = [i for i in pr_idx if i not in tp_pr]
                # FPs overlapping an ignore region (intersection over pred
                # area > min_iou) are absorbed (:485-502; matchIgnores=True
                # means one ignore box can absorb many preds)
                ign = self.ignores.get(name, [])
                if fp_pr and len(ign):
                    # intersection / pred area with the official +1-pixel
                    # convention (calcOverlapMatrix)
                    ib = np.asarray(ign, np.float64).copy()
                    pb = np.asarray([self.preds[name][i]["modal"]
                                     for i in fp_pr], np.float64)
                    ib[:, 2:] += 1.0
                    pb = pb.copy()
                    pb[:, 2:] += 1.0
                    ix1 = np.maximum(ib[:, None, 0], pb[None, :, 0])
                    iy1 = np.maximum(ib[:, None, 1], pb[None, :, 1])
                    ix2 = np.minimum(ib[:, None, 2], pb[None, :, 2])
                    iy2 = np.minimum(ib[:, None, 3], pb[None, :, 3])
                    inter = (np.maximum(ix2 - ix1, 0)
                             * np.maximum(iy2 - iy1, 0))
                    pa = np.maximum((pb[:, 2] - pb[:, 0])
                                    * (pb[:, 3] - pb[:, 1]), 1e-9)
                    ov = (inter / pa[None, :]).max(axis=0)
                    fp_pr = [i for i, o in zip(fp_pr, ov)
                             if o <= self.min_iou]
                rec[lbl] = {
                    "tp_gt": tp_gt, "tp_pr": tp_pr,
                    "fp_pr": fp_pr,
                    "fn_gt": [i for i in gt_idx if i not in tp_gt],
                }
            out[name] = rec
        return out

    def evaluate(self) -> Dict:
        per_thr = {s: self._match_at(s) for s in self.thresholds}

        results: Dict = {"AP": {}, "Center_Dist": {}, "Size_Similarity": {},
                         "OS_Yaw": {}, "OS_Pitch_Roll": {},
                         "Detection_Score": OrderedDict()}
        working = {}
        pr_curves = {}

        for lbl in self.labels:
            recalls, precisions, aucs = [], [], []
            per_depth_pr = {s: {} for s in self.thresholds}
            for s in self.thresholds:
                tp = fp = fn = 0
                tp_d = {d: 0 for d in self.depth_bins}
                fp_d = {d: 0 for d in self.depth_bins}
                fn_d = {d: 0 for d in self.depth_bins}
                for name, rec in per_thr[s].items():
                    r = rec[lbl]
                    tp += len(r["tp_gt"])
                    fp += len(r["fp_pr"])
                    fn += len(r["fn_gt"])
                    for i in r["tp_gt"]:
                        d = self.gts[name][i]["depth"]
                        if d < self.max_depth:
                            tp_d[int(d / self.step) * self.step] += 1
                    for i in r["fp_pr"]:
                        d = self.preds[name][i]["depth"]
                        if d < self.max_depth:
                            fp_d[int(d / self.step) * self.step] += 1
                    for i in r["fn_gt"]:
                        d = self.gts[name][i]["depth"]
                        if d < self.max_depth:
                            fn_d[int(d / self.step) * self.step] += 1
                p = tp / (tp + fp) if tp else 0.0
                rcl = tp / (tp + fn) if tp else 0.0
                recalls.append(rcl)
                precisions.append(p)
                aucs.append(p * rcl)
                per_depth_pr[s] = (tp_d, fp_d, fn_d)

            # AP via monotonic precision envelope (:1000-1020)
            order = np.argsort(recalls)
            rs = np.concatenate([[0], np.asarray(recalls)[order], [1]])
            ps = np.concatenate([[0], np.asarray(precisions)[order], [0]])
            for i in range(len(ps) - 2, -1, -1):
                ps[i] = max(ps[i], ps[i + 1])
            idx = np.where(rs[1:] != rs[:-1])[0] + 1
            ap = float(np.sum((rs[idx] - rs[idx - 1]) * ps[idx]))
            results["AP"][lbl] = {"auc": ap}
            pr_curves[lbl] = {"recall": recalls, "precision": precisions}
            working[lbl] = float(self.thresholds[int(np.argmax(aucs))])

        # DDTP metrics at the working point
        for lbl in self.labels:
            wd = {k: {d: [] for d in self.depth_bins}
                  for k in ("Center_Dist", "Size_Similarity", "OS_Yaw",
                            "OS_Pitch_Roll")}
            matches = self._match_at(working[lbl])
            for name, rec in matches.items():
                r = rec[lbl]
                for gi, pi in zip(r["tp_gt"], r["tp_pr"]):
                    g, p = self.gts[name][gi], self.preds[name][pi]
                    d = g["depth"]
                    if d >= self.max_depth:
                        continue
                    bin_ = int(d / self.step) * self.step
                    cd = np.hypot(*(g["center"][:2] - p["center"][:2]))
                    wd["Center_Dist"][bin_].append(
                        1.0 - min(cd / self.max_depth, 1.0))
                    wd["Size_Similarity"][bin_].append(float(np.prod(
                        np.minimum(g["dims"] / p["dims"], p["dims"] / g["dims"]))))
                    gy = _ypr(g["rotation"])
                    py = _ypr(p["rotation"])
                    wd["OS_Yaw"][bin_].append((1 + np.cos(gy[0] - py[0])) / 2)
                    wd["OS_Pitch_Roll"][bin_].append(
                        0.5 + (np.cos(gy[1] - py[1]) + np.cos(gy[2] - py[2])) / 4)
            for k, bins in wd.items():
                vals = [np.mean(v) for v in bins.values() if len(v) > 0]
                results[k][lbl] = {"auc": float(np.mean(vals)) if len(vals) > 1 else 0.0}

        for lbl in self.labels:
            v = {k: results[k][lbl]["auc"]
                 for k in ("AP", "Center_Dist", "Size_Similarity", "OS_Yaw",
                           "OS_Pitch_Roll")}
            results["Detection_Score"][lbl] = v["AP"] * (
                v["Center_Dist"] + v["Size_Similarity"] + v["OS_Yaw"] +
                v["OS_Pitch_Roll"]) / 4.0

        # means run over classes that HAVE ground truth only
        # (evalObjectDetection3d.py:798-805 accept_cats)
        gt_counts = {l: sum(1 for objs in self.gts.values()
                            for g in objs if g["label"] == l)
                     for l in self.labels}
        accept = [l for l in self.labels if gt_counts[l] > 0] or self.labels
        results["GT_stats"] = gt_counts
        results["mDetection_Score"] = float(np.mean(
            [results["Detection_Score"][l] for l in accept]))
        results["mAP"] = float(np.mean(
            [results["AP"][l]["auc"] for l in accept]))
        results["working_confidence"] = working
        results["pr_curves"] = pr_curves
        return results


def evaluate_3d_detection(gt_folder: str, pred_folder: str,
                          labels=EVAL_LABELS, min_iou=0.7) -> Dict:
    """Scores the official-format JSON folders (det_eval.py:20-45)."""
    ev = Box3dEvaluator(labels, min_iou)
    ev.load_folders(gt_folder, pred_folder)
    return ev.evaluate()
