"""The training step (port of mtt_tpu/utils/train_utils.py:59-82,
``make_train_step``): forward in train mode, the multi-task criterion,
backward, gradient clipping, Adam with L2 decay, the poly schedule, and the
BatchNorm running statistics (updated by the forward). The eval step and
``test_phase`` (train_utils.py:85-98, 296-337): an eval-mode forward, each
task's post-processing and the meters' update, all on the device, with the
scores read once at the end.

Precision: the model computes in its parameters' dtype (bf16 for training on
the card; the kernels take bf16) while the trainer keeps an f32 master copy
of every parameter, on which the optimizer and its state live, as the JAX
package keeps f32 parameters and casts them to ``--dtype bfloat16`` at use.
After each update the master is rounded into the model. BatchNorm running
statistics stay f32 in the model. With an f32 model the master is the
model's own parameters, and nothing is copied.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from mtt_tpu_torch.evaluation.meters import PerformanceMeter
from mtt_tpu_torch.inference import preprocess
from mtt_tpu_torch.losses.loss_schemes import build_criterion
from mtt_tpu_torch.utils.optim import build_optimizer, clip_gradients
from mtt_tpu_torch.utils.postprocess import get_output


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


@torch.no_grad()
def eval_step(model, meter: PerformanceMeter, batch: Dict[str, torch.Tensor],
              states):
    """(model, meter, batch, meter states) -> (post-processed predictions,
    new meter states): an eval-mode forward in the model's dtype, then
    ``get_output`` and the meter update for each of the meter's tasks.
    InvPT's ``inter_preds`` are not scored."""
    dtype = next(model.parameters()).dtype
    out = model(batch["image"].to(dtype), train=False)
    processed = {t: get_output(out[t], t) for t in meter.tasks}
    return processed, meter.update_states(states, processed, batch)


def test_phase(p: dict, model, batches: Iterable[Dict],
               meter: Optional[PerformanceMeter] = None,
               save_tasks: Optional[Sequence[str]] = None) -> Dict:
    """The scores of ``model`` over ``batches`` (an iterable of batches:
    numpy ones as ``SyntheticMT.batch`` makes them go through ``to_device``,
    tensor ones are taken as normalised and on the model's device), with the
    meter states on the model's device until the end. ``meter`` defaults to
    a ``PerformanceMeter`` of ``p`` over the model's tasks; it is reset
    first and holds the final states after. Saving predictions
    (``save_tasks``) and the 3D detection evaluation are ROADMAP.md item
    1.7 and raise."""
    if save_tasks:
        raise NotImplementedError("saving task predictions is not ported "
                                  "yet (ROADMAP.md item 1.7)")
    if "3ddet" in model.tasks:
        raise NotImplementedError("the 3D detection evaluation is not "
                                  "ported yet (ROADMAP.md item 1.7)")
    device = next(model.parameters()).device
    if meter is None:
        meter = PerformanceMeter(p, model.tasks, device)
    meter.reset()
    states = meter.states
    for batch in batches:
        if not torch.is_tensor(batch["image"]):
            batch = to_device(batch, device)
        _, states = eval_step(model, meter, batch, states)
    meter.states = states
    return meter.get_score(verbose=False)
