"""Multi-task weighted-sum loss (port of mtt_tpu/losses/loss_schemes.py:19-51),
with InvPT's intermediate supervision on the preliminary predictions. The
``3ddet`` route is the FCOS3D criterion on the detection head's output and
the batch's ``det_*`` ground truth."""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from mtt_tpu_torch.detection.det_model import build_detection_criterion
from mtt_tpu_torch.detection.det_params import default_det_params
from mtt_tpu_torch.losses.loss_functions import get_loss_fn


def build_criterion(p: dict, tasks: Sequence[str]) -> Callable:
    """criterion(pred, gt) -> {task: loss, "total": sum_t w_t loss_t}, with
    the weights of ``p["loss_kwargs"]["loss_weights"]``. Under ``3ddet`` the
    detection loss's components ride along as ``3ddet.<component>`` (not in
    the total twice: the ``3ddet`` entry is their sum). The detection
    settings are ``p["det_cfg"]``, by default ``default_det_params()``.
    Under ``intermediate_supervision`` each task that the model puts in
    ``pred["inter_preds"]`` adds ``inter_<task>``, its loss on that
    prediction, to the total at the task's weight, after the task terms (the
    JAX order)."""
    inter_sup = bool(p.get("intermediate_supervision", False))
    weights = {t: float(p["loss_kwargs"]["loss_weights"][t]) for t in tasks}
    loss_fns = {t: get_loss_fn(t, p) for t in tasks if t != "3ddet"}
    det_loss = build_detection_criterion(p.get("det_cfg")
                                         or default_det_params()) \
        if "3ddet" in tasks else None

    def criterion(pred: Dict[str, torch.Tensor],
                  gt: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out, parts = {}, {}
        total = 0.0
        for t in tasks:
            if t == "3ddet":
                out[t], comps = det_loss(pred[t], gt)
                parts.update({f"3ddet.{k}": v for k, v in comps.items()})
            else:
                out[t] = loss_fns[t](pred[t], gt[t])
            total = total + weights[t] * out[t]
        if inter_sup and "inter_preds" in pred:
            for t, v in pred["inter_preds"].items():
                out[f"inter_{t}"] = lt = loss_fns[t](v, gt[t])
                total = total + weights[t] * lt
        out["total"] = total
        out.update(parts)
        return out

    return criterion
