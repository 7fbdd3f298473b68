"""Optimizer and learning-rate schedule (port of mtt_tpu/utils/optim.py:16-49).

The optax chain there is: clip by global norm, add the L2 weight decay to the
gradient, Adam (or SGD's momentum trace), then scale by the learning rate of
the poly schedule counted from step 0. In torch that is the clip on the
gradients, then ``torch.optim.Adam(weight_decay=...)`` (which adds wd * param
to the clipped gradient before its moments, as ``add_decayed_weights`` does)
or ``torch.optim.SGD(momentum, nesterov, weight_decay, dampening=0)``, whose
buffer starts at the first gradient as optax's ``trace`` does from zero and
whose nesterov update g + momentum * buffer is optax's, then a
``LambdaLR`` whose factor for the k-th update (k from 0) is
(1 - k / max_iter) ** 0.9, as optax's count starts at 0. The clip is
optax's ``clip_by_global_norm`` written out: where the global norm g of all
gradients reaches max_norm, every gradient becomes (t / g) * max_norm;
below it they stay as they are.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

import torch


def poly_factor(max_iter: int, power: float = 0.9):
    return lambda step: (1.0 - step / max_iter) ** power


def grad_clip_norm(p: dict) -> Optional[float]:
    """max_norm of ``grad_clip_param`` (a dict, or the dict literal that the
    YAML files store), or None."""
    clip = p.get("grad_clip_param")
    if not clip:
        return None
    if isinstance(clip, str):
        clip = ast.literal_eval(clip)
    return float(clip["max_norm"])


def build_optimizer(params: Iterable[torch.Tensor], p: dict):
    """(optimizer, scheduler) over ``params``; call ``clip_gradients`` before
    ``optimizer.step()`` and ``scheduler.step()`` after it."""
    kwargs = p.get("optimizer_kwargs", {})
    lr = float(kwargs.get("lr", 1e-4))
    wd = float(kwargs.get("weight_decay", 0.0))
    name = p.get("optimizer", "adam")
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(kwargs.get("momentum", 0.9)),
                              nesterov=bool(kwargs.get("nesterov", False)),
                              weight_decay=wd, dampening=0.0)
    else:
        raise NotImplementedError(f"optimizer {name!r}")
    factor = poly_factor(int(p.get("max_iter", 40000))) \
        if p.get("scheduler") == "poly" else (lambda step: 1.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


@torch.no_grad()
def clip_gradients(params, p: dict) -> None:
    """Clips the gradients of ``params`` in place as optax does, without a
    transfer to the host: the divisor and factor are 1 below max_norm."""
    max_norm = grad_clip_norm(p)
    grads = [w.grad for w in params if w.grad is not None]
    if max_norm is None or not grads:
        return
    # the norm summed in f64 and rounded once: optax's f32 sum carries its
    # own rounding, which no other summation order repeats. Foreach ops: a
    # few launches for all the gradients, as clip_grad_norm_ makes
    norms = torch._foreach_norm(grads, 2.0, dtype=torch.float64)
    norm = torch.linalg.vector_norm(torch.stack(norms)).float()
    below = norm < max_norm
    torch._foreach_div_(grads, torch.where(below, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(below, 1.0, max_norm))
