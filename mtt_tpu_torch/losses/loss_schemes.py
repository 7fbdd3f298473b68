"""Multi-task weighted-sum loss (port of mtt_tpu/losses/loss_schemes.py:19-51,
the 2D tasks without intermediate supervision: TaskPrompter has none)."""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from mtt_tpu_torch.losses.loss_functions import get_loss_fn


def build_criterion(p: dict, tasks: Sequence[str]) -> Callable:
    """criterion(pred, gt) -> {task: loss, "total": sum_t w_t loss_t}, with
    the weights of ``p["loss_kwargs"]["loss_weights"]``."""
    if p.get("intermediate_supervision", False):
        raise NotImplementedError("intermediate supervision (InvPT) is not "
                                  "ported yet")
    weights = {t: float(p["loss_kwargs"]["loss_weights"][t]) for t in tasks}
    loss_fns = {t: get_loss_fn(t, p) for t in tasks}

    def criterion(pred: Dict[str, torch.Tensor],
                  gt: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {t: loss_fns[t](pred[t], gt[t]) for t in tasks}
        out["total"] = sum(weights[t] * out[t] for t in tasks)
        return out

    return criterion
