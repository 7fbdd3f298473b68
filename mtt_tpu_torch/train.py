"""Training entry point of the port: TaskPrompter-ViT-L on PASCAL-Context or
NYUD-v2, InvPT-ViT-L on PASCAL-Context or NYUD-v2, or TaskPrompter-Swin-B on
Cityscapes-3D, on seeded synthetic batches; then, with ``--eval N``, the
task scores over N synthetic batches at the config's ``valBatch``.

    python -m mtt_tpu_torch.train --config pascal_vitl --steps 3 --batch 2
    python -m mtt_tpu_torch.train --config nyud_invpt_vitl --steps 3 --eval 2

``train_steps`` builds the model from a config dict (``CONFIGS``: the keys of
configs/pascal/taskprompter_vitLp16.yml, configs/nyud/taskprompter_vitLp16.yml,
configs/pascal/invpt_vitLp16.yml, configs/nyud/invpt_vitLp16.yml or
configs/cityscapes3d/taskprompter_swinB.yml that the port reads), fills it
with seeded random weights, and takes ``steps`` training steps in bf16 with
f32 master weights, returning the losses of each step (InvPT: with the
``inter_<task>`` terms; Cityscapes-3D: with the detection loss's
components); ``train_and_score`` then scores the trained model. They run on
the card unless the caller passes another device.
The training loop with its YAML configs, transforms, loaders, periodic eval
and checkpoints is ``python -m mtt_tpu_torch.main`` (over several cards:
``torchrun ... -m mtt_tpu_torch.main --multihost``).
"""

from __future__ import annotations

import argparse
import json

import torch

from mtt_tpu_torch.data.synthetic import SyntheticMT
from mtt_tpu_torch.models.layers import init_weights
from mtt_tpu_torch.models.wrappers import (CS3D_SWINB, DB_SCALES,
                                           INVPT_PASCAL_VITL, NYUD_INVPT_VITL,
                                           NYUD_TASKPROMPTER_VITL,
                                           build_model, default_device,
                                           task_table)
from mtt_tpu_torch.utils.train_utils import Trainer, test_phase, to_device

# configs/pascal/taskprompter_vitLp16.yml, the keys the port reads
PASCAL_VITL = {
    "model": "TaskPrompter", "backbone": "TaskPrompter_vitL", "head": "conv",
    "embed_dim": 300, "final_embed_dim": 350, "prompt_len": 1,
    "chan_nheads": 1, "use_ctr": True, "train_db_name": "PASCALContext",
    "val_db_name": "PASCALContext", "trBatch": 2, "ignore_index": 255,
    "valBatch": 6, "max_iter": 40000, "optimizer": "adam",
    "optimizer_kwargs": {"lr": 0.00002, "weight_decay": 0.000001},
    "scheduler": "poly", "grad_clip_param": {"max_norm": 10, "norm_type": 2},
    "task_dictionary": {"include_semseg": True, "include_human_parts": True,
                        "include_sal": True, "include_edge": True,
                        "include_normals": True, "edge_w": 0.95},
    "loss_kwargs": {"loss_weights": {"semseg": 1.0, "human_parts": 2.0,
                                     "sal": 5.0, "edge": 50.0,
                                     "normals": 10.0}},
}


# configs/cityscapes3d/taskprompter_swinB.yml: the model keys (CS3D_SWINB)
# and the training keys the port reads (no weight decay; remat: False)
CS3D_SWINB_TRAIN = {
    **CS3D_SWINB, "trBatch": 1, "ignore_index": 255, "max_iter": 40000,
    "optimizer": "adam", "optimizer_kwargs": {"lr": 0.00002},
    "scheduler": "poly", "grad_clip_param": {"max_norm": 10, "norm_type": 2},
    "ignore_invalid_area_depth": True,
    "loss_kwargs": {"loss_weights": {"semseg": 100.0, "depth": 1.0,
                                     "3ddet": 1.0}},
}
# the training keys of configs/pascal/invpt_vitLp16.yml and
# configs/nyud/invpt_vitLp16.yml, which agree: intermediate supervision, no
# gradient clip
_INVPT_TRAIN = {
    "trBatch": 2, "valBatch": 6, "ignore_index": 255,
    "intermediate_supervision": True, "max_iter": 40000, "optimizer": "adam",
    "optimizer_kwargs": {"lr": 0.00002, "weight_decay": 0.000001},
    "scheduler": "poly",
}
# configs/pascal/invpt_vitLp16.yml
INVPT_PASCAL_VITL_TRAIN = {
    **INVPT_PASCAL_VITL, **_INVPT_TRAIN,
    "loss_kwargs": PASCAL_VITL["loss_kwargs"],
}
_NYUD_LOSS = {"loss_weights": {"semseg": 1.0, "depth": 1.0, "normals": 10,
                               "edge": 50.0}}
# configs/nyud/invpt_vitLp16.yml
NYUD_INVPT_VITL_TRAIN = {**NYUD_INVPT_VITL, **_INVPT_TRAIN,
                         "loss_kwargs": _NYUD_LOSS}
# configs/nyud/taskprompter_vitLp16.yml: the model keys
# (NYUD_TASKPROMPTER_VITL) and the training keys the port reads
NYUD_VITL = {
    **NYUD_TASKPROMPTER_VITL, "trBatch": 2, "valBatch": 6,
    "ignore_index": 255, "intermediate_supervision": False,
    "max_iter": 40000, "optimizer": "adam",
    "optimizer_kwargs": {"lr": 0.00001, "weight_decay": 1e-6},
    "scheduler": "poly", "grad_clip_param": {"max_norm": 10, "norm_type": 2},
    "ignore_invalid_area_depth": True, "loss_kwargs": _NYUD_LOSS,
}
CONFIGS = {"pascal_vitl": PASCAL_VITL, "nyud_vitl": NYUD_VITL,
           "pascal_invpt_vitl": INVPT_PASCAL_VITL_TRAIN,
           "nyud_invpt_vitl": NYUD_INVPT_VITL_TRAIN,
           "cs3d_swinb": CS3D_SWINB_TRAIN}


def make_trainer(p: dict, seed: int = 0, device=None):
    """(trainer, synthetic dataset): the model of ``p`` with seeded random
    weights at the training database's scale, computing in bf16; the 2D
    labels at ``dd_label_map_size`` where the config has one."""
    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    size = DB_SCALES[p["train_db_name"]][0]
    model = build_model(p, img_size=size, device=device,
                        dtype=torch.float32)
    init_weights(model, gen)
    tasks, num_out = task_table(p["train_db_name"], p["task_dictionary"])
    trainer = Trainer(model, p, tasks, torch.bfloat16, gen)
    det_cfg = getattr(model, "det_cfg", None)
    return trainer, SyntheticMT(
        tasks, num_out, size, seed,
        max_boxes=det_cfg["max_boxes"] if det_cfg else 64,
        label_size=p.get("dd_label_map_size"))


def _take_steps(trainer: Trainer, data: SyntheticMT, steps: int,
                batch_size: int) -> list:
    dev = next(trainer.model.parameters()).device
    out = []
    for i in range(steps):
        losses = trainer.step(to_device(data.batch(i * batch_size,
                                                   batch_size), dev))
        out.append({k: float(v) for k, v in losses.items()})
    return out


def train_steps(p: dict, steps: int, batch_size: int, seed: int = 0,
                device="cuda") -> list:
    """Takes ``steps`` training steps on batches ``i * batch_size ..`` of
    the seeded synthetic set; returns each step's losses."""
    trainer, data = make_trainer(p, seed, device)
    return _take_steps(trainer, data, steps, batch_size)


def train_and_score(p: dict, steps: int, batch_size: int,
                    eval_batches: int, seed: int = 0, device="cuda"):
    """``train_steps``, then the scores of the trained model
    (``test_phase``) on ``eval_batches`` batches of ``p["valBatch"]``
    samples that follow the training ones: (each step's losses, scores)."""
    trainer, data = make_trainer(p, seed, device)
    losses = _take_steps(trainer, data, steps, batch_size)
    n, start = p["valBatch"], steps * batch_size
    dev = next(trainer.model.parameters()).device
    return losses, test_phase(p, trainer.model,
                              (to_device(data.batch(start + j * n, n), dev)
                               for j in range(eval_batches)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    default="pascal_vitl")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=None,
                    help="images a step (default: the config's trBatch)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval", type=int, default=0, metavar="N",
                    help="after the steps, score the model on N synthetic "
                         "batches of the config's valBatch (one JSON line)")
    args = ap.parse_args(argv)
    p = CONFIGS[args.config]
    if args.eval and "valBatch" not in p:
        ap.error(f"--eval: config {args.config} has no valBatch")
    batch = args.batch or p["trBatch"]
    if args.eval:
        steps, scores = train_and_score(p, args.steps, batch, args.eval,
                                        args.seed)
    else:
        steps, scores = train_steps(p, args.steps, batch, args.seed), None
    for i, losses in enumerate(steps):
        print(json.dumps({"step": i, **losses}), flush=True)
    if scores is not None:
        print(json.dumps({"eval_batches": args.eval,
                          "valBatch": p["valBatch"], "scores": scores}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
