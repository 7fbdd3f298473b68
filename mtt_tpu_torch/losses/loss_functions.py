"""Per-task losses, ignore-region aware (port of
mtt_tpu/losses/loss_functions.py:20-132).

All take NHWC predictions and labels, compute in f32 and mask by
``ignore_index``. Each normaliser (the valid count, the balanced weights'
counts) is summed over the ranks (``parallel.mesh.all_reduce_sum``), as
GSPMD sums it over the sharded batch in JAX: a rank's loss is its own sum
over the global normaliser, so the ranks' losses add up to the loss of one
process on the whole batch, and their gradients to its gradient.
  * cross_entropy_loss  - mean over valid pixels, optional binary balancing
  * balanced_bce_loss   - HED-style positive weighting for edges
  * l1_loss             - masked L1, optional L2-normalisation (normals)
  * depth_l1_loss       - L1 with invalid-area masking
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mtt_tpu_torch.parallel.mesh import all_reduce_sum


def cross_entropy_loss(logits, label, ignore_index: int = 255,
                       balanced: bool = False):
    """Softmax CE averaged over valid pixels. logits (B, H, W, K); label
    (B, H, W) or (B, H, W, 1) with integer values. ``balanced`` weights
    class 1 by the frequency of class 0 and back (saliency)."""
    if label.dim() == logits.dim():
        label = label[..., 0]
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    n_valid = all_reduce_sum(valid.sum()).clamp_min(1)
    if balanced:
        pos = all_reduce_sum(torch.where(valid, safe, 0).sum())
        w_pos = (n_valid - pos) / n_valid
        nll = nll * torch.where(safe == 1, w_pos, 1.0 - w_pos)
    return torch.where(valid, nll, 0.0).sum() / n_valid


def balanced_bce_loss(logits, label, ignore_index: int = 255,
                      pos_weight: float | None = None,
                      across_ranks: bool = True):
    """Balanced binary CE: w = #neg / #valid (or ``pos_weight``), positives
    weighted w / (1 - w), the mean over valid pixels times (1 - w). The
    counts are this rank's alone without ``across_ranks`` (the edge meter's
    per-batch loss, which it weights by its own count)."""
    total = all_reduce_sum if across_ranks else (lambda t: t)
    logits = logits.float()
    if label.dim() == logits.dim() - 1:
        label = label[..., None]
    label = label.float()
    valid = label != ignore_index
    lab = torch.where(valid, label, 0.0)
    n_valid = total(valid.sum()).clamp_min(1).float()
    if pos_weight is None:
        w = total(torch.where(valid, 1.0 - lab, 0.0).sum()) / n_valid
    else:
        w = torch.tensor(pos_weight, dtype=torch.float32, device=logits.device)
    pw = w / torch.clamp_min(1.0 - w, 1e-6)
    per = -(pw * lab * F.logsigmoid(logits)
            + (1.0 - lab) * F.logsigmoid(-logits))
    return torch.where(valid, per, 0.0).sum() / n_valid * (1.0 - w)


def l1_loss(pred, label, ignore_index: int = 255, normalize: bool = False):
    """Masked L1; a pixel is valid when all its channels differ from
    ``ignore_index``. ``normalize`` L2-normalises the predictions."""
    pred = pred.float()
    label = label.float()
    if normalize:
        norm = torch.linalg.vector_norm(pred, dim=-1, keepdim=True)
        pred = pred / norm.clamp_min(1e-12)
    valid = (label != ignore_index).all(-1, keepdim=True)
    diff = torch.where(valid, (pred - label).abs(), 0.0)
    return diff.sum() / all_reduce_sum(valid.sum()).clamp_min(1)


def depth_l1_loss(pred, label, ignore_invalid_area: bool = True):
    """Depth L1 masking label == 255, and also -1 with
    ``ignore_invalid_area``."""
    pred = pred.float()
    label = label.float()
    valid = label != 255.0
    if ignore_invalid_area:
        valid = valid & (label != -1.0)
    diff = torch.where(valid, (pred - label).abs(), 0.0)
    return diff.sum() / all_reduce_sum(valid.sum()).clamp_min(1)


def get_loss_fn(task: str, p: dict):
    """Per-task loss selector. The edge weight is the ``edge_w`` of the
    config's task dictionary, which the JAX config hoists to ``p.edge_w``
    (mtt_tpu/config/config.py:130)."""
    ignore = p.get("ignore_index", 255)
    if task in ("semseg", "human_parts"):
        return lambda pred, gt: cross_entropy_loss(pred, gt, ignore)
    if task == "sal":
        return lambda pred, gt: cross_entropy_loss(pred, gt, ignore,
                                                   balanced=True)
    if task == "edge":
        w = p["task_dictionary"].get("edge_w")
        return lambda pred, gt: balanced_bce_loss(pred, gt, ignore,
                                                  pos_weight=w)
    if task == "normals":
        return lambda pred, gt: l1_loss(pred, gt, ignore, normalize=True)
    if task == "depth":
        inv = p.get("ignore_invalid_area_depth", False)
        return lambda pred, gt: depth_l1_loss(pred, gt,
                                              ignore_invalid_area=inv)
    raise NotImplementedError(f"Undefined loss for task {task}")
