"""Training and full-eval CLI of the port (the JAX package's main.py).

    python -m mtt_tpu_torch.main \\
        --config_exp configs/pascal/taskprompter_vitLp16.yml \\
        --run_mode train [--overfit] [--max_iter N] [--val_interval N]

``create_config`` reads the YAML experiment; ``common_config`` builds the
transforms, the (synthetic) datasets and the loaders; the model is built
with seeded random weights (no pretrained backbone is in the repository) and
trained by ``train_phase``, which evaluates and checkpoints every
``val_interval`` iterations under ``work_dirs/<version_name>``. A restart
resumes from the checkpoint ``latest.txt`` names; ``--run_mode infer``
scores the restored model with ``test_phase`` (with ``--vis``, from the
same forward it also renders each 2D task's map of every val image under
``save_dir/vis_<task>``). Batches are ``trBatch`` and
``valBatch`` for one card. The compute dtype defaults to bf16, with f32
master weights; ``--dtype float32`` runs on the card for ``--run_mode
infer`` of a TaskPrompter-ViT config (its eval forward has f32 kernels), with
TF32 off for the call (``utils/precision.py``); f32 training and InvPT or
Swin at f32 are refused before anything is built (ROADMAP.md item 1.14).
``main(argv, device=None)`` runs on the card unless the caller passes
another device.

Data-parallel over N cards, one process each (``parallel/mesh.py``)::

    torchrun --nproc_per_node N -m mtt_tpu_torch.main --multihost \
        --config_exp configs/pascal/taskprompter_vitLp16.yml

``--multihost`` joins torchrun's process group (NCCL, rank r on
``cuda:LOCAL_RANK``; ``main(argv, device="cpu")`` takes gloo); each rank
loads its shard of every split (``data_shard_info``), ``trBatch`` and
``valBatch`` stay per card (a step's global batch is ``trBatch`` x N, as
JAX reads them per device), and rank 0 alone writes the log file, the
results and the checkpoints. Without torchrun's environment it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="multi-task training")
    ap.add_argument("--config_exp", required=True)
    ap.add_argument("--trained_model", default=None,
                    help="accepted as JAX's main.py accepts it; JAX's main "
                         "reads it nowhere, and neither does this one (a "
                         "checkpoint is resumed from the config's "
                         "checkpoint directory)")
    ap.add_argument("--run_mode", choices=["train", "infer"], default="train")
    ap.add_argument("--overfit", action="store_true",
                    help="64-image overfit sanity mode")
    ap.add_argument("--max_iter", type=int, default=None)
    ap.add_argument("--val_interval", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="bfloat16",
                    help="compute dtype (the master weights stay f32); on "
                         "the card float32 runs --run_mode infer of a "
                         "TaskPrompter-ViT config (ROADMAP.md item 1.14)")
    ap.add_argument("--debug_eval", action="store_true",
                    help="run a full eval pass before training")
    ap.add_argument("--vis", action="store_true",
                    help="save per-task visualisations in infer mode")
    ap.add_argument("--multihost", action="store_true",
                    help="data-parallel under torchrun: join its process "
                         "group, one card a rank")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> int:
    args = parse_args(argv)
    from mtt_tpu_torch.utils.precision import exact_f32
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    with exact_f32(dtype == torch.float32):
        return _main(args, dtype, device)


def _main(args, dtype, device) -> int:
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model, default_device
    from mtt_tpu_torch.parallel.mesh import data_shard_info, init_distributed
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils.logger import install
    from mtt_tpu_torch.utils.precision import check_card_dtype
    from mtt_tpu_torch.utils.train_utils import (Trainer, test_phase,
                                                 train_phase)

    # a process group of this call's own is left again at its end
    own_group = args.multihost and not torch.distributed.is_initialized()
    device = init_distributed(device) if args.multihost \
        else default_device(device)
    nshards, shard = data_shard_info()
    if device.type == "cuda":
        # before anything is built: an infer-mode config makes no directory
        check_card_dtype(create_config(args.config_exp, {"run_mode": "infer"}),
                         args.run_mode, dtype)
    p = create_config(args.config_exp, {"run_mode": args.run_mode})
    if args.max_iter:
        p["max_iter"] = args.max_iter
    if args.val_interval:
        p["val_interval"] = args.val_interval
    if args.run_mode != "infer" and shard == 0:
        install(os.path.join(p["output_dir"], "log_file.txt"))
    print(f"[main] config {args.config_exp} tasks={p.TASKS.NAMES} "
          f"device={device} dtype={args.dtype} rank {shard} of {nshards}",
          flush=True)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(p, img_size=tuple(p.TRAIN.SCALE), device=device,
                        dtype=torch.float32)
    init_weights(model, gen)
    p["trBatch"] = int(p["trBatch"])        # one card, one process
    p["valBatch"] = int(p["valBatch"])
    train_tf, val_tf = cc.get_transformations(p)
    train_ds = cc.get_dataset(p, "train", train_tf, overfit=args.overfit)
    val_ds = cc.get_dataset(p, "val", val_tf, overfit=args.overfit)
    train_loader = cc.get_train_dataloader(p, train_ds, nshards, shard)
    val_loader = cc.get_test_dataloader(p, val_ds, nshards, shard)
    trainer = Trainer(model, p, p.TASKS.NAMES, dtype, gen)

    restored = trainer.restore_checkpoint(p["checkpoint"])
    if restored is not None:
        print(f"[main] resumed from step {restored}", flush=True)

    if args.run_mode == "train":
        if args.debug_eval:
            scores = test_phase(p, model, val_loader)
            if shard == 0:
                print(f"[main] debug smoke eval before training\n"
                      f"{json.dumps(scores)}", flush=True)
        t0 = time.time()
        train_phase(p, trainer, train_loader, val_loader)
        print(f"[main] training done in {time.time() - t0:.1f}s", flush=True)
    else:
        vis = [t for t in model.tasks if t != "3ddet"] if args.vis else None
        scores = test_phase(p, model, val_loader, vis_tasks=vis)
        if shard == 0:
            print(json.dumps(scores, indent=2), flush=True)
    if own_group:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
