"""The training step (port of mtt_tpu/utils/train_utils.py:59-82,
``make_train_step``): forward in train mode, the multi-task criterion,
backward, gradient clipping, Adam with L2 decay, the poly schedule, and the
BatchNorm running statistics (updated by the forward).

Precision: the model computes in its parameters' dtype (bf16 for training on
the card; the kernels take bf16) while the trainer keeps an f32 master copy
of every parameter, on which the optimizer and its state live, as the JAX
package keeps f32 parameters and casts them to ``--dtype bfloat16`` at use.
After each update the master is rounded into the model. BatchNorm running
statistics stay f32 in the model. With an f32 model the master is the
model's own parameters, and nothing is copied.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from mtt_tpu_torch.inference import preprocess
from mtt_tpu_torch.losses.loss_schemes import build_criterion
from mtt_tpu_torch.utils.optim import build_optimizer, clip_gradients


class Trainer:
    """Owns the optimizer state of one model. ``step(batch)`` is one
    training step; ``backward`` and ``update`` are its two halves.
    ``generator`` draws the drop-path masks."""

    def __init__(self, model: torch.nn.Module, p: dict, tasks: Sequence[str],
                 dtype: torch.dtype, generator: torch.Generator):
        self.model = model
        self.p = p
        self.dtype = dtype
        self.criterion = build_criterion(p, tasks)
        self.generator = generator
        params = list(model.parameters())
        self._own_master = dtype != torch.float32
        if not self._own_master:
            self.master = params
        else:
            self.master = [w.detach().float().clone().requires_grad_()
                           for w in params]
            for w in params:
                w.data = w.data.to(dtype)
        for buf in model.buffers():
            if buf.is_floating_point():
                buf.data = buf.data.float()
        self.optimizer, self.scheduler = build_optimizer(self.master, p)

    def backward(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Forward in train mode and backward; the gradients land on the
        model's parameters. Returns the detached losses."""
        self.model.zero_grad(set_to_none=True)
        out = self.model(batch["image"].to(self.dtype), train=True,
                         generator=self.generator)
        losses = self.criterion(out, batch)
        losses["total"].backward()
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def update(self) -> None:
        """Clip, Adam with L2 decay and the schedule on the f32 master,
        then the master rounded into the model."""
        params = list(self.model.parameters())
        if self._own_master:
            for m, w in zip(self.master, params):
                m.grad = None if w.grad is None else w.grad.float()
        clip_gradients(self.master, self.p)
        self.optimizer.step()
        self.scheduler.step()
        if self._own_master:
            for m, w in zip(self.master, params):
                w.copy_(m)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        losses = self.backward(batch)
        self.update()
        return losses


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A synthetic batch on the device (every array, the ``det_*`` ground
    truth included), the image ImageNet-normalised as the JAX transforms
    normalise it (mtt_tpu/data/transforms.py:158)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out["image"] = preprocess(out["image"])
    return out
