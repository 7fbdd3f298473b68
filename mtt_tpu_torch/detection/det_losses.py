"""Detection losses (port of mtt_tpu/detection/det_losses.py): focal,
smooth-L1, softmax CE, binary CE and GIoU, in f32.

Every function takes an optional element-wise ``weight`` and an
``avg_factor`` (mmdet's reduction: sum(loss * weight) / avg_factor, or the
mean without one). Labels of the focal loss run over [0, num_classes], the
last being the background, whose one-hot row is all zeros as
``jax.nn.one_hot`` gives it (``F.one_hot`` raises on it, so the one-hot is
taken over num_classes + 1 columns and the last is dropped).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce(loss, weight=None, avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / torch.clamp_min(torch.as_tensor(
        avg_factor, dtype=loss.dtype, device=loss.device), 1e-6)


def one_hot(labels, num_classes: int):
    """f32 one-hot over ``num_classes``; labels equal to num_classes (the
    background) give a zero row."""
    return F.one_hot(labels.long(), num_classes + 1)[..., :num_classes].float()


def sigmoid_focal_loss(logits, labels, num_classes: int, gamma: float = 2.0,
                       alpha: float = 0.25, weight=None, avg_factor=None,
                       loss_weight: float = 1.0):
    """Multi-class sigmoid focal loss (mmdet's convention)."""
    logits = logits.float()
    target = one_hot(labels, num_classes)
    p = torch.sigmoid(logits)
    pt = p * target + (1 - p) * (1 - target)
    focal = (alpha * target + (1 - alpha) * (1 - target)) * (1 - pt) ** gamma
    ce = -(target * F.logsigmoid(logits)
           + (1 - target) * F.logsigmoid(-logits))
    return loss_weight * _reduce((focal * ce).sum(-1), weight, avg_factor)


def smooth_l1_loss(pred, target, beta: float = 1.0 / 9.0, weight=None,
                   avg_factor=None, loss_weight: float = 1.0):
    diff = (pred.float() - target.float()).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return loss_weight * _reduce(loss, weight, avg_factor)


def softmax_ce_loss(logits, labels, weight=None, avg_factor=None,
                    loss_weight: float = 1.0):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -(logp * F.one_hot(labels.long(), logits.shape[-1])).sum(-1)
    return loss_weight * _reduce(nll, weight, avg_factor)


def binary_ce_loss(logits, targets, weight=None, avg_factor=None,
                   loss_weight: float = 1.0):
    logits, targets = logits.float(), targets.float()
    loss = -(targets * F.logsigmoid(logits)
             + (1 - targets) * F.logsigmoid(-logits))
    return loss_weight * _reduce(loss, weight, avg_factor)


def giou_loss(pred, target, weight=None, avg_factor=None,
              loss_weight: float = 1.0, eps: float = 1e-7):
    """GIoU loss on (..., 4) xyxy boxes."""
    px1, py1, px2, py2 = pred.float().unbind(-1)
    tx1, ty1, tx2, ty2 = target.float().unbind(-1)
    pa = (px2 - px1).clamp_min(0) * (py2 - py1).clamp_min(0)
    ta = (tx2 - tx1).clamp_min(0) * (ty2 - ty1).clamp_min(0)
    iw = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp_min(0)
    ih = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp_min(0)
    inter = iw * ih
    union = pa + ta - inter + eps
    carea = (torch.maximum(px2, tx2) - torch.minimum(px1, tx1)) \
        * (torch.maximum(py2, ty2) - torch.minimum(py1, ty1)) + eps
    giou = inter / union - (carea - union) / carea
    return loss_weight * _reduce(1 - giou, weight, avg_factor)
