"""The training step (port of mtt_tpu/utils/train_utils.py:59-82,
``make_train_step``): forward in train mode, the multi-task criterion,
backward, gradient clipping, Adam (or SGD) with L2 decay, the poly schedule,
and the BatchNorm running statistics (updated by the forward). The eval step
and ``test_phase`` (train_utils.py:85-98, 296-337): an eval-mode forward,
each task's post-processing and the meters' update, all on the device, with
the scores read once at the end, the edge maps written for the external
evaluation, and the Cityscapes-3D detections of the same forward decoded,
exported and scored (``detection/det_eval.py``). The loop ``train_phase``
(train_utils.py:167-248) with its log lines, TensorBoard scalars, periodic
eval and checkpoints (``Trainer.save_checkpoint`` / ``restore_checkpoint``,
train_utils.py:143-165), the detections of each epoch's first training
batch (``_train_det_vis``, :251-287), and ``StepProfiler`` (:340-358).

Precision: the model computes in its parameters' dtype (bf16 for training on
the card; the kernels take bf16) while the trainer keeps an f32 master copy
of every parameter, on which the optimizer and its state live, as the JAX
package keeps f32 parameters and casts them to ``--dtype bfloat16`` at use.
After each update the master is rounded into the model. BatchNorm running
statistics stay f32 in the model. With an f32 model the master is the
model's own parameters, and nothing is copied.

Over several ranks (``parallel/mesh.py``; one process a card, no DDP
wrapper), the trainer broadcasts rank 0's parameters, buffers and drop-path
generator at construction; the forward takes global BatchNorm moments and
the losses global normalisers, so each rank's loss is its share of the
global one; after the backward ``all_reduce_grads`` sums the gradients,
before the master copy and the clip, and the logged losses are summed too.
Every rank then takes the same update, and the ranks' parameters stay equal
to the bit. Rank 0 alone writes the log lines, TensorBoard, the results and
the checkpoints; ``test_phase`` sums the meter states and merges the
detection records of every rank.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from mtt_tpu_torch.data.loader import device_put_batch, prefetch_to_device
from mtt_tpu_torch.detection.det_eval import DetRecordAccumulator
from mtt_tpu_torch.detection.export import save_image_predictions
from mtt_tpu_torch.evaluation.meters import PerformanceMeter
from mtt_tpu_torch.evaluation.save_preds import (save_task_predictions,
                                                 write_png)
from mtt_tpu_torch.inference import preprocess
from mtt_tpu_torch.losses.loss_schemes import build_criterion
from mtt_tpu_torch.parallel.mesh import (all_reduce_, all_reduce_grads,
                                         barrier, broadcast_, data_shard_info)
from mtt_tpu_torch.utils.optim import build_optimizer, clip_gradients
from mtt_tpu_torch.utils.postprocess import get_output
from mtt_tpu_torch.utils.visualization import draw_boxes3d, save_visualizations


class Trainer:
    """Owns the optimizer state of one model. ``step(batch)`` is one
    training step; ``backward`` and ``update`` are its two halves.
    ``generator`` draws the drop-path masks. ``step_count`` counts the
    updates (the JAX ``state.step``); ``log`` takes the loop's lines. In a
    process group, every rank builds one over its own copy of the model,
    and rank 0's parameters, buffers and generator state are copied into
    every rank's."""

    def __init__(self, model: torch.nn.Module, p: dict, tasks: Sequence[str],
                 dtype: torch.dtype, generator: torch.Generator,
                 log_fn=print):
        self.model = model
        self.p = p
        self.dtype = dtype
        self.log = log_fn
        self.step_count = 0
        self.criterion = build_criterion(p, tasks)
        self.generator = generator
        params = list(model.parameters())
        if data_shard_info()[0] > 1:
            state = generator.get_state().to(params[0].device)
            broadcast_(params + list(model.buffers()) + [state])
            generator.set_state(state.cpu())
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
        model's parameters, summed over the ranks. Returns the detached
        losses, summed over the ranks (each rank's is its share)."""
        self.model.zero_grad(set_to_none=True)
        out = self.model(batch["image"].to(self.dtype), train=True,
                         generator=self.generator)
        losses = self.criterion(out, batch)
        losses["total"].backward()
        all_reduce_grads(self.model.parameters())
        losses = {k: v.detach() for k, v in losses.items()}
        all_reduce_(list(losses.values()))
        return losses

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
        self.step_count += 1
        if self._own_master:
            for m, w in zip(self.master, params):
                w.copy_(m)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        losses = self.backward(batch)
        self.update()
        return losses

    @property
    def device(self) -> torch.device:
        return self.master[0].device

    def save_checkpoint(self, ckpt_dir: str) -> str:
        """``<ckpt_dir>/step_<n>.pt``, then ``latest.txt`` naming it: the
        step, the f32 master weights by parameter name (a bf16 model is
        rounded from them on restore), the optimizer and scheduler states,
        the model's buffers (the BN running statistics) and the drop-path
        generator's state. Rank 0 writes it (every rank holds the same
        state), and every rank waits for it. Returns the file's path."""
        path = os.path.join(ckpt_dir, f"step_{self.step_count}.pt")
        if data_shard_info()[1] == 0:
            self._write_checkpoint(ckpt_dir, path)
        barrier()
        return path

    def _write_checkpoint(self, ckpt_dir: str, path: str) -> None:
        os.makedirs(ckpt_dir, exist_ok=True)
        names = [n for n, _ in self.model.named_parameters()]
        state = {"step": self.step_count,
                 "master": {n: m.detach() for n, m in zip(names,
                                                          self.master)},
                 "optimizer": self.optimizer.state_dict(),
                 "scheduler": self.scheduler.state_dict(),
                 "buffers": dict(self.model.named_buffers()),
                 "generator": self.generator.get_state()}
        torch.save(state, path)
        with open(os.path.join(ckpt_dir, "latest.txt"), "w") as f:
            f.write(str(self.step_count))

    def restore_checkpoint(self, ckpt_dir: str) -> Optional[int]:
        """Loads the checkpoint ``latest.txt`` names onto the trainer's
        device (each rank onto its own) and returns its step; None without
        ``latest.txt``."""
        latest = os.path.join(ckpt_dir, "latest.txt")
        if not os.path.isfile(latest):
            return None
        with open(latest) as f:
            step = int(f.read().strip())
        dev = self.device

        def place(storage, location):
            # the optimizer's step counts and the generator state stay on
            # the host, where they were saved; the rest goes to the device
            if location == "cpu":
                return storage
            return storage.cpu() if dev.type == "cpu" else \
                storage.cuda(dev.index)

        state = torch.load(os.path.join(ckpt_dir, f"step_{step}.pt"),
                           map_location=place, weights_only=True)
        names = [n for n, _ in self.model.named_parameters()]
        buffers = dict(self.model.named_buffers())
        if set(state["master"]) != set(names) or \
                set(state["buffers"]) != set(buffers):
            raise ValueError(f"checkpoint step_{step}.pt does not match the "
                             f"model's parameters and buffers")
        with torch.no_grad():
            for n, m in zip(names, self.master):
                m.copy_(state["master"][n])
            if self._own_master:
                for m, w in zip(self.master, self.model.parameters()):
                    w.copy_(m)
            for n, b in buffers.items():
                b.copy_(state["buffers"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])
        self.step_count = int(state["step"])
        return self.step_count


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
    new meter states, the detection head's output or None): an eval-mode
    forward in the model's dtype, then ``get_output`` and the meter update
    for each of the meter's tasks. InvPT's ``inter_preds`` are not scored;
    the ``3ddet`` head output is handed back for the caller to decode."""
    dtype = next(model.parameters()).dtype
    out = model(batch["image"].to(dtype), train=False)
    processed = {t: get_output(out[t], t) for t in meter.tasks}
    return (processed, meter.update_states(states, processed, batch),
            out.get("3ddet"))


def test_phase(p: dict, model, batches: Iterable[Dict],
               meter: Optional[PerformanceMeter] = None,
               save_tasks: Optional[Sequence[str]] = None,
               vis_tasks: Optional[Sequence[str]] = None) -> Dict:
    """The scores of ``model`` over ``batches`` (a loader, or any iterable
    of batches: numpy ones as the loader gives them, normalised by the
    transforms, go through ``device_put_batch``; tensor ones are taken as on
    the model's device; raw ``SyntheticMT.batch`` arrays go through
    ``to_device`` first), with the meter states on the model's device until
    the end. ``meter`` defaults to a ``PerformanceMeter`` of ``p`` over the
    model's tasks; it is reset first and holds the final states after. The
    post-processed maps of ``save_tasks`` are written under
    ``p["save_dir"]`` by the batches' ``meta``, pad samples left out, and
    those of ``vis_tasks`` rendered (``render_task``, with the palette of
    ``p["train_db_name"]``) under ``save_dir/vis_<task>``: from the same
    forward as the scores.

    A ``3ddet`` model (its ``det_cfg`` set) also scores its detections: each
    batch's head output, from the forward the meters take, decodes on the
    device with every image's ``K_matrix`` (the batches carry ``meta`` and
    the ``det_*`` ground truth); with a ``save_dir`` in ``p`` each image's
    official-format JSON goes under ``save_dir/3ddet``; ``scores["3ddet"]``
    holds the evaluator's ``mDetection_Score`` and ``mAP``.

    Over several ranks each rank runs its own shard of the eval set (the
    sampler pads the short shards with samples no meter counts) and writes
    its own images' files; the meter states are summed over the ranks and
    the detection records merged, so every rank returns the scores of the
    whole set."""
    device = next(model.parameters()).device
    if meter is None:
        meter = PerformanceMeter(p, model.tasks, device)
    det_acc = None
    if "3ddet" in model.tasks:
        det_cfg = getattr(model, "det_cfg", None)
        if det_cfg is None:
            raise ValueError("scoring the 3ddet task needs the model's "
                             "det_cfg (the decode's settings)")
        det_acc = DetRecordAccumulator(det_cfg, save_dir=p.get("save_dir"))
    meter.reset()
    states = meter.states
    for batch in batches:
        host = batch
        if not torch.is_tensor(batch["image"]):
            batch = device_put_batch(batch, device)
        processed, states, det_out = eval_step(model, meter, batch, states)
        if det_acc is not None:
            det_acc.add_batch(det_out, host)
        for t in save_tasks or ():
            if t in processed and "meta" in batch:
                save_task_predictions(p["save_dir"], t,
                                      processed[t].float().cpu().numpy(),
                                      batch["meta"])
        for t in vis_tasks or ():
            if t in processed and "meta" in batch:
                save_visualizations(p["save_dir"], t,
                                    processed[t].float().cpu().numpy(),
                                    batch["meta"],
                                    database=p["train_db_name"])
    meter.states = states
    meter.all_reduce_()
    scores = meter.get_score(verbose=False)
    if det_acc is not None:
        det = det_acc.evaluate()
        scores["3ddet"] = {"mDetection_Score": det["mDetection_Score"],
                           "mAP": det["mAP"]}
    return scores


def train_phase(p: dict, trainer: Trainer, train_loader, val_loader=None,
                max_iter: Optional[int] = None,
                val_interval: Optional[int] = None, log_every: int = 50
                ) -> list:
    """The iteration loop from ``trainer.step_count`` to ``max_iter``
    (default ``p["max_iter"]``) over the epochs of ``train_loader``, each
    batch's copy queued ahead on the trainer's device: every ``log_every``
    iterations a log line with the losses and imgs/s, a history entry and
    the TensorBoard scalars (``loss/<name>``, ``lr``, ``imgs_per_sec``);
    every ``val_interval`` iterations and at ``max_iter``, ``test_phase``
    over ``val_loader`` with the edge maps saved (when edge is a task),
    ``results_iter<it>.json`` and ``perf/`` scalars, and a checkpoint in
    ``p["checkpoint"]``. For a ``3ddet`` model with a ``save_dir`` (unless
    ``p["train_vis_3ddet"]`` is false), the first batch of each epoch is
    also decoded before its step (``_train_det_vis``). Returns the history.
    A resumed loop starts again at epoch 0's first batch, as the JAX loop
    does. Over several ranks every rank steps on its own shard and
    evaluates; rank 0 alone logs (imgs/s of the global batch), writes
    TensorBoard, the results and the detections, and the checkpoints."""
    from mtt_tpu_torch.utils.tb_writer import SummaryWriter
    max_iter = max_iter or int(p.get("max_iter", 40000))
    val_interval = val_interval or int(p.get("val_interval", 1000))
    it = trainer.step_count
    epoch = 0
    history = []
    profiler = StepProfiler()
    world, rank = data_shard_info()
    tb = SummaryWriter(os.path.join(p["save_dir"], "tb")) \
        if "save_dir" in p and rank == 0 else None
    save_tasks = ("edge",) if "edge" in trainer.model.tasks else None
    det_vis = ("3ddet" in trainer.model.tasks and "save_dir" in p
               and p.get("train_vis_3ddet", True) and rank == 0)
    t0 = time.time()
    try:
        while it < max_iter:
            train_loader.set_epoch(epoch)
            first_in_epoch = det_vis
            for batch in prefetch_to_device(train_loader, trainer.device):
                if first_in_epoch:
                    # the weights before the step, as the reference draws
                    _train_det_vis(p, trainer, batch, epoch)
                    first_in_epoch = False
                profiler.maybe_start(it)
                losses = trainer.step(batch)
                profiler.maybe_stop(it)
                it += 1
                if it % log_every == 0 and rank == 0:
                    host = {k: float(v) for k, v in losses.items()}
                    rate = log_every * world * batch["image"].shape[0] / (
                        time.time() - t0)
                    t0 = time.time()
                    trainer.log(f"iter {it} total {host['total']:.4f} "
                                f"({rate:.2f} imgs/s) " +
                                " ".join(f"{k}={v:.4f}" for k, v in
                                         host.items() if k != "total"))
                    history.append({"iter": it, **host})
                    if tb is not None:
                        tb.add_scalars(host, it, prefix="loss/")
                        tb.add_scalar("lr", trainer.optimizer.param_groups[
                            0]["lr"], it)
                        tb.add_scalar("imgs_per_sec", rate, it)
                        tb.flush()
                if it % val_interval == 0 or it >= max_iter:
                    if val_loader is not None:
                        scores = test_phase(p, trainer.model, val_loader,
                                            save_tasks=save_tasks)
                        if rank == 0:
                            _log_scores(p, trainer, tb, scores, it)
                    trainer.save_checkpoint(p["checkpoint"])
                    if it >= max_iter:
                        return history
            epoch += 1
        return history
    finally:
        if tb is not None:
            tb.close()


def _log_scores(p: dict, trainer: Trainer, tb, scores: Dict, it: int):
    """The eval's log line, ``results_iter<it>.json`` and ``perf/``
    scalars."""
    from mtt_tpu_torch.utils.tb_writer import flatten_scores
    trainer.log(f"eval@{it}: {json.dumps(scores)}")
    with open(os.path.join(p["save_dir"], f"results_iter{it}.json"),
              "w") as f:
        json.dump(scores, f)
    if tb is not None:
        tb.add_scalars(flatten_scores(scores), it, prefix="perf/")
        tb.flush()


@torch.no_grad()
def _train_det_vis(p: dict, trainer: Trainer, batch: Dict, epoch: int):
    """The detections of a training batch, under ``save_dir/train/3ddet``
    with the prefix ``b<epoch>_``: each image's official-format JSON, and a
    wireframe PNG (``<name>_<boxes>.png``) of each image with a box. An
    eval-mode forward of the batch on the trainer's model; a batch without
    camera intrinsics in ``meta`` is left alone."""
    metas = batch.get("meta")
    if not metas or "camera" not in metas[0] or "K_matrix" not in metas[0]:
        return
    out_dir = os.path.join(p["save_dir"], "train", "3ddet")
    os.makedirs(out_dir, exist_ok=True)
    model = trainer.model
    out = model(batch["image"].to(trainer.dtype), train=False)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    images = None
    for i, meta, dec, objs in DetRecordAccumulator(
            model.det_cfg).decode_batch(out["3ddet"], batch):
        fname = f"b{epoch}_{meta['img_name']}"
        save_image_predictions(out_dir, fname, objs)
        n_boxes = int(dec["valid"].sum())
        if n_boxes > 0:
            if images is None:
                images = batch["image"].float().cpu().numpy()
            img = np.clip((images[i] * std + mean) * 255.0, 0,
                          255).astype(np.uint8)
            vis = draw_boxes3d(img, dec["boxes3d"], meta["K_matrix"],
                               valid=dec["valid"])
            write_png(os.path.join(out_dir, f"{fname}_{n_boxes}.png"), vis)


class StepProfiler:
    """A ``torch.profiler`` trace of steps ``start_at`` .. ``start_at +
    steps`` when MTT_PROFILE_DIR names a directory: the Chrome trace lands
    there as ``trace_steps<a>-<b>.json`` (CUDA activity included on the
    card)."""

    def __init__(self):
        self.dir = os.environ.get("MTT_PROFILE_DIR")
        self._prof = None

    def maybe_start(self, step: int, start_at: int = 10, steps: int = 5):
        if self.dir and self._prof is None and step == start_at:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._start, self._stop_at = step, step + steps

    def maybe_stop(self, step: int):
        if self._prof is not None and step >= self._stop_at:
            self._prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(
                self.dir, f"trace_steps{self._start}-{step}.json"))
            self._prof = None
