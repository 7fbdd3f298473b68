"""Training entry point of the port: TaskPrompter-ViT-L on PASCAL-Context or
TaskPrompter-Swin-B on Cityscapes-3D, on seeded synthetic batches.

    python -m mtt_tpu_torch.train --config pascal_vitl --steps 3 --batch 2
    python -m mtt_tpu_torch.train --config cs3d_swinb --steps 3

``train_steps`` builds the model from a config dict (the keys of
configs/pascal/taskprompter_vitLp16.yml, ``PASCAL_VITL``, or of
configs/cityscapes3d/taskprompter_swinB.yml, ``CS3D_SWINB_TRAIN``), fills it
with seeded random weights, and takes ``steps`` training steps in bf16 with
f32 master weights, returning the losses of each step (for Cityscapes-3D
also the detection loss's components). It runs on the card unless the
caller passes another device. Checkpoints, meters, real data loaders and
multi-card training are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import torch

from mtt_tpu_torch.data.synthetic import SyntheticMT
from mtt_tpu_torch.models.layers import init_weights
from mtt_tpu_torch.models.wrappers import (CS3D_SWINB, DB_SCALES,
                                           build_model, default_device,
                                           task_table)
from mtt_tpu_torch.utils.train_utils import Trainer, to_device

# configs/pascal/taskprompter_vitLp16.yml, the keys the port reads
PASCAL_VITL = {
    "model": "TaskPrompter", "backbone": "TaskPrompter_vitL", "head": "conv",
    "embed_dim": 300, "final_embed_dim": 350, "prompt_len": 1,
    "chan_nheads": 1, "use_ctr": True, "train_db_name": "PASCALContext",
    "val_db_name": "PASCALContext", "trBatch": 2, "ignore_index": 255,
    "max_iter": 40000, "optimizer": "adam",
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
CONFIGS = {"pascal_vitl": PASCAL_VITL, "cs3d_swinb": CS3D_SWINB_TRAIN}


def make_trainer(p: dict, seed: int = 0, device=None):
    """(trainer, synthetic dataset): the model of ``p`` with seeded random
    weights at the training database's scale, computing in bf16; the 2D
    labels at ``dd_label_map_size`` where the config has one."""
    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    size = DB_SCALES[p["train_db_name"]]
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


def train_steps(p: dict, steps: int, batch_size: int, seed: int = 0,
                device="cuda") -> List[Dict[str, float]]:
    """Takes ``steps`` training steps on batches ``i * batch_size ..`` of
    the seeded synthetic set; returns each step's losses."""
    trainer, data = make_trainer(p, seed, device)
    dev = next(trainer.model.parameters()).device
    out = []
    for i in range(steps):
        losses = trainer.step(to_device(data.batch(i * batch_size,
                                                   batch_size), dev))
        out.append({k: float(v) for k, v in losses.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    default="pascal_vitl")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=None,
                    help="images a step (default: the config's trBatch)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    p = CONFIGS[args.config]
    batch = args.batch or p["trBatch"]
    for i, losses in enumerate(train_steps(p, args.steps, batch,
                                           args.seed)):
        print(json.dumps({"step": i, **losses}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
