"""Task metric meters (port of mtt_tpu/evaluation/meters.py:35-282).

Each meter is (init, update, score): ``init`` makes its state, a dict of
tensors on the device; ``update`` is a pure function of (state, predictions,
labels) that stays on the device (no host synchronisation); ``score`` reads
the state to the host and computes the metric in float64, as the JAX meters
do.

Semantics and quirks are the JAX package's, which mirror the reference:
  * ConfusionMeter - per-class tp/fp/fn -> mIoU;
  * NormalsMeter - mean angular error 2 atan2(|p - g|, |p + g|) in degrees;
  * SaliencyMeter - max-F over 19 thresholds, beta^2 = 0.3, the [0, 1]
    prediction squashed through a second sigmoid before it is thresholded;
  * DepthMeter - rmse / log_rmse / abs_rel / sq_rel, with the strict
    Cityscapes bounds and no clamp of the prediction where a range is set;
  * EdgeMeter - the balanced-BCE loss proxy, fed probabilities as logits.

Counts are int64 where the JAX states count in f32 (equal while a JAX count
is exact, below 2^24): the confusion counts come from one scatter-add over
the joint (label, prediction) bins instead of two one-hot tensors (330 MB
each in f32 for NYUD's 40 classes on a batch of 8 at 448x576). Sums of
per-pixel values stay f32, summed per batch as JAX sums them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import numpy as np
import torch

from mtt_tpu_torch.losses.loss_functions import balanced_bce_loss
from mtt_tpu_torch.parallel.mesh import all_reduce_


def _squeeze_label(pred, gt):
    return gt[..., 0] if gt.dim() == pred.dim() + 1 else gt


def _count(mask) -> torch.Tensor:
    return mask.sum(dtype=torch.int64)


class ConfusionMeter:
    """tp/fp/fn per class -> mIoU."""

    def __init__(self, n_classes: int, ignore_index: int = 255):
        self.n_classes = n_classes
        self.ignore_index = ignore_index

    def init(self, device=None):
        z = torch.zeros(self.n_classes, dtype=torch.int64, device=device)
        return {"tp": z, "fp": z.clone(), "fn": z.clone()}

    def update(self, state, pred, gt):
        """pred (B, H, W) class ids; gt (B, H, W) or (B, H, W, 1). A label
        or prediction outside [0, n) counts for no class, as a zero one-hot
        row does in JAX; an ignored label drops the pixel."""
        gt = _squeeze_label(pred, gt).long()
        pred = pred.long()
        n = self.n_classes
        valid = gt != self.ignore_index
        g = torch.where(valid & (gt >= 0) & (gt < n), gt, n)
        q = torch.where(valid & (pred >= 0) & (pred < n), pred, n)
        idx = (g * (n + 1) + q).reshape(-1)
        cm = torch.zeros((n + 1) * (n + 1), dtype=torch.int64,
                         device=idx.device)
        cm.scatter_add_(0, idx, torch.ones((), dtype=torch.int64,
                                           device=idx.device).expand_as(idx))
        cm = cm.view(n + 1, n + 1)
        tp = cm.diagonal()[:n]
        return {"tp": state["tp"] + tp,
                "fp": state["fp"] + cm[:, :n].sum(0) - tp,
                "fn": state["fn"] + cm[:n].sum(1) - tp}

    def score(self, state) -> Dict[str, Any]:
        tp, fp, fn = (state[k].cpu().numpy().astype(np.float64)
                      for k in ("tp", "fp", "fn"))
        jac = tp / np.maximum(tp + fp + fn, 1e-8)
        return {"mIoU": float(jac.mean())}


class NormalsMeter:
    def __init__(self, ignore_index: int = 255):
        self.ignore_index = ignore_index

    def init(self, device=None):
        return {"sum_deg": torch.zeros((), device=device),
                "count": torch.zeros((), dtype=torch.int64, device=device)}

    def update(self, state, pred, gt):
        """pred in [0, 255] (post-processed), gt in [-1, 1]; NHWC."""
        pred = 2.0 * pred.float() / 255.0 - 1.0
        gt = gt.float()
        valid = (gt != self.ignore_index).all(-1)

        def _norm(v):
            n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            return torch.where(n == 0, 0.0, v / torch.where(n == 0, 1.0, n))

        p, g = _norm(pred), _norm(gt)
        diff = torch.linalg.vector_norm(p - g, dim=-1)
        summ = torch.linalg.vector_norm(p + g, dim=-1)
        deg = 2.0 * torch.atan2(diff, summ) * (180.0 / math.pi)
        deg = torch.where(valid, deg, 0.0)
        return {"sum_deg": state["sum_deg"] + deg.sum(dtype=torch.float32),
                "count": state["count"] + _count(valid)}

    def score(self, state):
        return {"mean": float(state["sum_deg"]) / max(int(state["count"]), 1)}


class SaliencyMeter:
    """Labels are {0, 1} (the datasets threshold the distilled saliency at
    0.5) or ``ignore_index``."""

    def __init__(self, ignore_index: int = 255, threshold_step: float = 0.05,
                 beta_squared: float = 0.3):
        self.ignore_index = ignore_index
        self.thresholds = np.arange(threshold_step, 1.0, threshold_step)
        self.beta_squared = beta_squared

    def init(self, device=None):
        z = torch.zeros(len(self.thresholds), dtype=torch.int64,
                        device=device)
        return {"tp": z, "pp": z.clone(), "ap": z.clone()}

    def update(self, state, pred, gt):
        """pred in [0, 255], the probability of salient (B, H, W)."""
        gt = _squeeze_label(pred, gt)
        # the reference squashes the [0, 1] prediction through a sigmoid
        # AGAIN before thresholding (eval_sal.py:42-43), so the effective
        # thresholds are logit(t) for t in (0.5, 0.73); kept deliberately
        probs = torch.sigmoid(pred.float() / 255.0)
        valid = gt != self.ignore_index
        pos = valid & (gt != 0)
        th = torch.as_tensor(self.thresholds, dtype=torch.float32,
                             device=probs.device)
        f_pred = (probs[None] >= th[:, None, None, None]) & valid[None]
        axes = tuple(range(1, f_pred.dim()))
        tp = (f_pred & pos[None]).sum(axes, dtype=torch.int64)
        pp = f_pred.sum(axes, dtype=torch.int64)
        return {"tp": state["tp"] + tp, "pp": state["pp"] + pp,
                "ap": state["ap"] + _count(pos)}

    def score(self, state):
        tp, pp, ap = (state[k].cpu().numpy().astype(np.float64)
                      for k in ("tp", "pp", "ap"))
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = tp / pp
            recall = tp / ap
            num = (1 + self.beta_squared) * precision * recall
            den = self.beta_squared * precision + recall
            f = num / den
        f = np.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0)
        return {"maxF": float(f.max())}


class DepthMeter:
    def __init__(self, ignore_index: int = 255, max_depth: float | None = None,
                 min_depth: float | None = None):
        self.ignore_index = ignore_index
        self.max_depth = max_depth
        self.min_depth = min_depth

    def init(self, device=None):
        z = torch.zeros((), device=device)
        return {"rmse": z, "log_rmse": z.clone(), "abs_rel": z.clone(),
                "sq_rel": z.clone(),
                "n": torch.zeros((), dtype=torch.int64, device=device)}

    def update(self, state, pred, gt):
        pred, gt = pred.float(), gt.float()
        if gt.dim() == 4:
            gt = gt[..., 0]
        if pred.dim() == 4:
            pred = pred[..., 0]
        valid = gt != self.ignore_index
        if self.max_depth is not None:
            # the Cityscapes eval range: STRICT bounds, no clamp of the
            # prediction (TaskPrompter/evaluation/eval_depth.py:36-42)
            valid = valid & (gt > (self.min_depth or 0.0)) \
                & (gt < self.max_depth)
        gt = gt.clamp_min(1e-9)
        pred = pred.clamp_min(1e-9)
        d = torch.where(valid, gt - pred, 0.0)
        ld = torch.where(valid, torch.log(gt) - torch.log(pred), 0.0)
        f32 = torch.float32
        return {
            "rmse": state["rmse"] + (d ** 2).sum(dtype=f32),
            "log_rmse": state["log_rmse"] + (ld ** 2).sum(dtype=f32),
            "abs_rel": state["abs_rel"]
            + torch.where(valid, d.abs() / gt, 0.0).sum(dtype=f32),
            "sq_rel": state["sq_rel"]
            + torch.where(valid, d ** 2 / gt, 0.0).sum(dtype=f32),
            "n": state["n"] + _count(valid),
        }

    def score(self, state):
        n = max(int(state["n"]), 1)
        return {"rmse": float(np.sqrt(float(state["rmse"]) / n)),
                "log_rmse": float(np.sqrt(float(state["log_rmse"]) / n)),
                "abs_rel": float(state["abs_rel"]) / n,
                "sq_rel": float(state["sq_rel"]) / n}


class EdgeMeter:
    """The in-framework proxy: balanced-BCE loss on the [0, 255] sigmoid
    outputs (eval_edge.py:13-44); odsF comes from the external SEISM
    pipeline, as in the reference."""

    def __init__(self, pos_weight: float, ignore_index: int = 255):
        self.pos_weight = pos_weight
        self.ignore_index = ignore_index

    def init(self, device=None):
        return {"loss": torch.zeros((), device=device),
                "n": torch.zeros((), dtype=torch.int64, device=device)}

    def update(self, state, pred, gt):
        gt = _squeeze_label(pred, gt)
        valid = gt != self.ignore_index
        # the reference feeds *probabilities* straight into BCEWithLogits
        # (InvPT/evaluation/eval_edge.py:30-36); kept for metric parity, NOT
        # to be "fixed" to a logit transform
        logits = pred.float() / 255.0
        label = torch.where(valid, gt.float(), 255.0)
        loss = balanced_bce_loss(logits[..., None], label[..., None],
                                 self.ignore_index,
                                 pos_weight=self.pos_weight,
                                 across_ranks=False)
        n = _count(valid)
        return {"loss": state["loss"] + loss.float() * n.float(),
                "n": state["n"] + n}

    def score(self, state):
        return {"loss": float(state["loss"]) / max(int(state["n"]), 1)}


_SEMSEG_CLASSES = {"PASCALContext": 21, "NYUD": 40, "Cityscapes3D": 19}


def get_single_task_meter(p: dict, database: str, task: str):
    """Meter factory (evaluate_utils.py:37-66). The edge weight is the
    ``edge_w`` of the config's task dictionary, as the losses read it; the
    Cityscapes-3D depth range is the JAX config's 0-80 m."""
    ignore = p.get("ignore_index", 255)
    if task == "semseg":
        return ConfusionMeter(_SEMSEG_CLASSES[database], ignore)
    if task == "human_parts":
        return ConfusionMeter(7, ignore)
    if task == "normals":
        return NormalsMeter(ignore)
    if task == "sal":
        return SaliencyMeter(ignore, threshold_step=0.05, beta_squared=0.3)
    if task == "depth":
        if database == "Cityscapes3D":
            return DepthMeter(ignore, max_depth=80.0, min_depth=0.0)
        return DepthMeter(ignore)
    if task == "edge":
        w = p.get("task_dictionary", {}).get("edge_w", p.get("edge_w", 0.95))
        return EdgeMeter(pos_weight=w, ignore_index=ignore)
    raise NotImplementedError(task)


class PerformanceMeter:
    """Multi-task wrapper (evaluate_utils.py:15-35) over the meters, for the
    tasks of ``p["train_db_name"]`` but ``3ddet``; the states live on
    ``device``."""

    def __init__(self, p: dict, tasks: Sequence[str], device=None):
        self.device = device
        self.tasks = [t for t in tasks if t != "3ddet"]
        self.meters = {t: get_single_task_meter(p, p["train_db_name"], t)
                       for t in self.tasks}
        self.reset()

    def reset(self):
        self.states = {t: self.meters[t].init(self.device)
                       for t in self.tasks}

    def update(self, pred, gt):
        self.states = self.update_states(self.states, pred, gt)

    def update_states(self, states, pred, gt):
        """The pure form: new states from ``states``, which stay as they
        are."""
        return {t: self.meters[t].update(states[t], pred[t], gt[t])
                for t in self.tasks}

    def all_reduce_(self) -> None:
        """Sums every state over the ranks in place (one flattened
        reduction per dtype: the f32 sums and the int64 counts), so that
        every rank scores the whole eval set; nothing on one rank."""
        all_reduce_([v for t in self.tasks for v in self.states[t].values()])

    def get_score(self, verbose: bool = False):
        out = {t: self.meters[t].score(self.states[t]) for t in self.tasks}
        if verbose:
            for t, v in out.items():
                print(f"[eval] {t}: {v}")
        return out
