"""Data-parallel runs of the port over several processes, for its tests.

The tests start one process a rank with torchrun's environment:

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_worker.py JOBS.pt OUT_DIR [DEVICE]

Each rank joins the group (gloo; ``parallel.mesh.init_distributed``), runs
the jobs that JOBS.pt names in order, and saves what they return to
``OUT_DIR/rank<r>.pt``. The same job functions run in the test's own
process without a group for the one-rank references. This module imports
torch, numpy and the port only: a rank never imports JAX, nor a test module.

The batches (``global_batch``) are made so that a per-rank statistic shows:
rank 1's images are three times rank 0's, most of its labels are ignored,
it has fewer edge positives, and fewer boxes (one image without any).
"""

from __future__ import annotations

import os
import sys

import torch

THREADS = 2                     # as tests/torch_threads.py
TIMEOUT_S = 60.0                # the group's: a lost rank fails in a minute
GLOBAL_B = 4                    # two samples a rank

PASCAL = ("semseg", "human_parts", "sal", "normals", "edge")
PASCAL_OUT = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3,
              "edge": 1}
NYUD = ("semseg", "depth", "normals", "edge")
NYUD_OUT = {"semseg": 40, "depth": 1, "normals": 3, "edge": 1}
CS3D = ("semseg", "depth", "3ddet")
CS3D_OUT = {"semseg": 19, "depth": 1, "3ddet": 18}
SWIN_IMG, SWIN_LABELS = (64, 128), (32, 64)
# the tiny Swin of tests/test_torch_swin_model.py at depths (2, 2, 2, 2)
SWIN = dict(tar_dim=12, final_dim=20, chan_embed_dim=16, embed_dim=16,
            depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2), window_size=4)
DROP = 0.3                      # the backbones' drop-path rate

_TRAIN = {"ignore_index": 255, "intermediate_supervision": False,
          "optimizer": "adam",
          "optimizer_kwargs": {"lr": 0.001, "weight_decay": 0.01},
          "scheduler": "poly", "max_iter": 10}
TASKPROMPTER_P = {
    **_TRAIN, "train_db_name": "PASCALContext",
    "grad_clip_param": {"max_norm": 1, "norm_type": 2},
    "task_dictionary": {"edge_w": 0.95},
    "loss_kwargs": {"loss_weights": {"semseg": 1.0, "human_parts": 2.0,
                                     "sal": 5.0, "edge": 50.0,
                                     "normals": 10.0}},
}
INVPT_P = {
    **_TRAIN, "train_db_name": "NYUD", "intermediate_supervision": True,
    "task_dictionary": {"edge_w": 0.95},
    "loss_kwargs": {"loss_weights": {"semseg": 1.0, "depth": 1.0,
                                     "normals": 10.0, "edge": 50.0}},
}


def tiny_det_cfg():
    """The tiny FCOS3D head of tests/test_torch_detection.py, 6 classes."""
    from mtt_tpu_torch.detection.det_params import default_det_params
    d = default_det_params(6)
    d.update(feat_channels=16, cls_branch=(16, 8), reg_branch=((16,),) * 5,
             dir_branch=(16,), centerness_branch=(16,), norm_groups=4,
             max_boxes=8)
    d["neck"]["out_channels"] = 16
    return d


def swin_p():
    return {**_TRAIN, "train_db_name": "Cityscapes3D",
            "grad_clip_param": {"max_norm": 1.0, "norm_type": 2},
            "ignore_invalid_area_depth": True, "det_cfg": tiny_det_cfg(),
            "loss_kwargs": {"loss_weights": {"semseg": 100.0, "depth": 1.0,
                                             "3ddet": 1.0}}}


# kind -> (tasks, outputs, image size, label size, training config)
KINDS = {
    "taskprompter": (PASCAL, PASCAL_OUT, (64, 64), None, TASKPROMPTER_P),
    "invpt": (NYUD, NYUD_OUT, (128, 128), None, INVPT_P),
    "swin": (CS3D, CS3D_OUT, SWIN_IMG, SWIN_LABELS, None),
}
KINDS["swin_remat"] = KINDS["swin"]     # the tiny Swin with remat on


def build(kind: str, drop: float = DROP, seed: int = 0, remat: bool = False):
    """The kind's ViT-T / tiny-Swin model on the CPU with seeded weights
    (``init_weights``), drop-path at ``drop`` (InvPT's decoder keeps its
    0.15); ``remat`` (InvPT and the Swin; on for ``swin_remat``) checkpoints
    the blocks (and the Swin's heads)."""
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import (TaskPrompterNet,
                                               TaskPrompterSwinNet,
                                               TransformerNet)
    tasks, out, img, labels, _ = KINDS[kind]
    if kind == "taskprompter":
        model = TaskPrompterNet(tasks, out, img, "TaskPrompter_vitT",
                                tar_dim=24, final_dim=28, use_ctr=True,
                                drop_path_rate=drop, device="cpu")
    elif kind == "invpt":
        model = TransformerNet(tasks, out, img, "vitT", embed_dim=32,
                               pred_out=16, drop_path_rate=drop,
                               remat=remat, device="cpu")
    else:
        model = TaskPrompterSwinNet(tasks, out, img, det_cfg=tiny_det_cfg(),
                                    target_size=labels, drop_path_rate=drop,
                                    remat=remat or kind == "swin_remat",
                                    device="cpu", **SWIN)
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed + 1)
        for name, w in model.named_parameters():
            # biases and norms off their constant init, so that their
            # gradients are not all alike
            if w.dim() == 1 and "conv_cls" not in name:
                w.add_(0.1 * torch.randn(w.shape, generator=gen))
    return model


def config(kind: str) -> dict:
    return KINDS[kind][4] or swin_p()


def global_batch(kind: str, seed: int = 3) -> dict:
    """The global batch of ``GLOBAL_B`` seeded synthetic samples
    (normalised, on the CPU), rank 1's half (samples 2 and 3) skewed: its
    images x3, 80% of its pixels' labels ignored, 70% of its edge positives
    cleared, and one box left on sample 2, none on sample 3."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.utils.train_utils import to_device
    tasks, out, img, labels, _ = KINDS[kind]
    swin = labels is not None
    kw = dict(max_boxes=8, label_size=labels) if swin else {}
    b = to_device(SyntheticMT(tasks, out, img, seed=seed, **kw)
                  .batch(0, GLOBAL_B), "cpu")
    half = GLOBAL_B // 2
    gen = torch.Generator().manual_seed(seed)
    b["image"][half:] *= 3.0
    for t in tasks:
        if t == "3ddet":
            continue
        lab = b[t][half:]
        if t == "edge":
            clear = torch.rand(lab.shape, generator=gen) < 0.7
            lab[clear & (lab == 1)] = 0.0
        drop = torch.rand(lab.shape[:3], generator=gen) < 0.8
        lab[drop] = 255.0
    if swin:
        valid = b["det_valid"]
        first = valid[half].nonzero()[0, 0]
        valid[half] = 0.0
        valid[half, first] = 1.0
        valid[half + 1] = 0.0
    return b


def mask_kinks(model, batch: dict, seed: int = 5, eps: float = 1e-4):
    """``batch`` with the labels of the pixels where an L1 term sits within
    ``eps`` of its kink set to the ignore value, from a train-mode forward
    of ``model`` (a copy is left as it was) with the trainer's drop-path
    draws: there the two sides' f32 rounding could take the two sides of the
    kink (as tests/test_torch_invpt_train.py does)."""
    import copy
    model = copy.deepcopy(model)
    with torch.no_grad():
        out = model(batch["image"], train=True,
                    generator=torch.Generator().manual_seed(seed))
    preds = [out] + ([out["inter_preds"]] if "inter_preds" in out else [])
    for pr in preds:
        if "normals" in pr:
            n = pr["normals"].float()
            n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True
                                             ).clamp_min(1e-12)
            near = ((n - batch["normals"]).abs() < eps).any(-1)
            batch["normals"][near] = 255.0
        if "depth" in pr:
            near = ((pr["depth"].float() - batch["depth"]).abs() < eps)[..., 0]
            batch["depth"][near] = 255.0
    return batch


def shard(batch: dict, world: int, rank: int) -> dict:
    n = GLOBAL_B // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def train_step(kind: str, batch: dict, seed: int = 5, state=None) -> dict:
    """One f32 ``Trainer`` step of ``build(kind)`` (or of the weights in
    ``state``, drop-path off) on this rank's shard of ``batch``: the
    losses, the gradients before the clip, and after the update the
    parameters and the BN running statistics."""
    from mtt_tpu_torch.parallel.mesh import data_shard_info
    from mtt_tpu_torch.utils.train_utils import Trainer
    if state is None:
        model = build(kind)
    else:
        model = build(kind, drop=0.0)
        model.load_state_dict(state)
    trainer = Trainer(model, config(kind), KINDS[kind][0], torch.float32,
                      torch.Generator().manual_seed(seed),
                      log_fn=lambda s: None)
    losses = trainer.backward(shard(batch, *data_shard_info()))
    grads = {n: w.grad.clone() for n, w in model.named_parameters()
             if w.grad is not None}
    trainer.update()
    return {"losses": losses, "grads": grads,
            "params": {n: w.detach().clone()
                       for n, w in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers()
                      if "running" in n}}


def eval_scores(save_dir: str, n_images: int = 5, val_batch: int = 3):
    """``test_phase`` of the tiny Swin (semseg, depth, 3ddet; drop-path
    off, the class prior at 0.5 so that boxes reach the evaluator) over a
    seeded synthetic val set of ``n_images`` through the Cityscapes-3D val
    transforms and this rank's loader shard (``valBatch`` 3: over 2 ranks,
    rank 1's shard ends in a pad sample)."""
    from mtt_tpu_torch.config.config import Config
    from mtt_tpu_torch.data.cityscapes3d import CS3DValTransforms
    from mtt_tpu_torch.data.loader import MultiTaskLoader
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.detection.det_eval import (DetRecordAccumulator,
                                                  _gt_objects_from_batch)
    from mtt_tpu_torch.parallel.mesh import data_shard_info
    from mtt_tpu_torch.utils.train_utils import test_phase
    model = build("swin", drop=0.0)
    with torch.no_grad():
        model.det_head.fcos3d.conv_cls.bias.zero_()
    tf = CS3DValTransforms(Config.wrap({"dd_label_map_size": SWIN_LABELS,
                                        "TRAIN": {"SCALE": SWIN_IMG}}))
    ds = SyntheticMT(CS3D, CS3D_OUT, SWIN_IMG, seed=7, max_boxes=8,
                     length=n_images, transform=tf)
    world, rank = data_shard_info()
    loader = MultiTaskLoader(ds, val_batch, shuffle=False, num_workers=1,
                             drop_last=False, num_shards=world,
                             shard_index=rank)
    p = dict(swin_p(), save_dir=save_dir)
    batches = list(loader)
    # records whose predictions are the ground truth less its last box,
    # so that the merged evaluation scores matches, not only misses
    acc = DetRecordAccumulator(p["det_cfg"])
    for batch in batches:
        for i, meta in enumerate(batch["meta"]):
            if not meta.get("pad"):
                gt = _gt_objects_from_batch(batch, i)
                acc.records.append((meta["img_name"], gt, gt[:-1]))
    return {"scores": test_phase(p, model, batches),
            "records": acc.evaluate(),
            "pads": sum(bool(m.get("pad")) for b in batches
                        for m in b["meta"]),
            "files": sorted(os.listdir(os.path.join(save_dir, "3ddet")))}


def collectives(device) -> dict:
    """``all_reduce_sum`` forward and gradient, and ``all_reduce_grads``
    with a gradient that rank 1 lacks and one that no rank has, on
    ``device``: rank r holds x = r + 1 + arange(4)."""
    from mtt_tpu_torch.parallel import mesh
    world, rank = mesh.data_shard_info()
    x = (torch.arange(4.0, device=device) + rank + 1).requires_grad_()
    y = mesh.all_reduce_sum(x)
    (y * (rank + 1.0)).sum().backward()
    a = torch.nn.Parameter(torch.zeros(3, device=device))
    b = torch.nn.Parameter(torch.zeros(2, device=device, dtype=torch.bfloat16))
    c = torch.nn.Parameter(torch.zeros(5, device=device))
    a.grad = torch.full((3,), rank + 1.0, device=device)
    if rank == 0:
        b.grad = torch.ones(2, device=device, dtype=torch.bfloat16)
    mesh.all_reduce_grads([a, b, c], bucket=4)
    return {"y": y.detach().cpu(), "x_grad": x.grad.cpu(),
            "a": a.grad.cpu(), "b": b.grad.cpu(), "c": c.grad,
            "b_dtype": b.grad.dtype}


def main_multihost(tmp: str) -> dict:
    """``mtt_tpu_torch.main --multihost`` on the CPU: configs/pascal/
    taskprompter_vitLp16.yml at ViT-T width and 32x32, the val set cut to 8
    images, 2 iterations with an eval and a checkpoint at 2. Returns the
    checkpoints this rank wrote and the run's files."""
    from mtt_tpu_torch.config.config import DB_SCALES
    from mtt_tpu_torch.main import main
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils.train_utils import Trainer
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "configs", "pascal",
                           "taskprompter_vitLp16.yml")) as f:
        text = f.read()
    for old, new in (("backbone: TaskPrompter_vitL",
                      "backbone: TaskPrompter_vitT"),
                     ("embed_dim: 300", "embed_dim: 24"),
                     ("final_embed_dim: 350", "final_embed_dim: 28")):
        text = text.replace(old, new)
    # both ranks write the file: each writes its own copy and renames it in
    # place, so that neither reads the file while the other truncates it
    yml = os.path.join(tmp, "exp.yml")
    with open(f"{yml}.{os.getpid()}", "w") as f:
        f.write(text)
    os.replace(f"{yml}.{os.getpid()}", yml)
    DB_SCALES["PASCALContext"] = ((32, 32), (32, 32))
    real_dataset = cc.get_dataset

    def cut(p, split, *a, **kw):
        ds = real_dataset(p, split, *a, **kw)
        if split != "train":
            ds.length = 8
        return ds
    cc.get_dataset = cut
    writes = []
    real = Trainer._write_checkpoint
    Trainer._write_checkpoint = lambda self, *a: (writes.append(a[1]),
                                                  real(self, *a))
    os.chdir(tmp)
    rc = main(["--config_exp", yml, "--multihost", "--max_iter", "2",
               "--val_interval", "2", "--dtype", "float32"], device="cpu")
    out = os.path.join(tmp, "work_dirs", "TaskPrompter_pascal_vitLp16")
    return {"rc": rc, "writes": writes,
            "files": sorted(os.path.relpath(os.path.join(d, f), out)
                            for d, _, fs in os.walk(out) for f in fs)}


def run_job(job: dict):
    name = job["name"]
    if name == "train_step":
        return train_step(job["kind"], job["batch"], state=job.get("state"))
    if name == "eval":
        return eval_scores(job["save_dir"])
    if name == "collectives":
        return collectives(job["device"])
    if name == "main":
        return main_multihost(job["tmp"])
    raise ValueError(f"unknown job {name!r}")


def worker(jobs_path: str, out_dir: str, device: str = "cpu") -> None:
    """One rank: gloo on the CPU; on the card NCCL on ``cuda:LOCAL_RANK``
    when there is a card a rank, else gloo on the one card."""
    from mtt_tpu_torch.parallel.mesh import init_distributed
    torch.set_num_threads(THREADS)
    if device == "cuda" and torch.cuda.device_count() >= int(
            os.environ["WORLD_SIZE"]):
        dev = init_distributed(timeout_s=TIMEOUT_S)
    else:
        dev = init_distributed(device="cuda:0" if device == "cuda"
                               else device, backend="gloo",
                               timeout_s=TIMEOUT_S)
    rank = torch.distributed.get_rank()
    jobs = torch.load(jobs_path, weights_only=False)
    results = [run_job(dict(j, device=dev)) for j in jobs]
    torch.distributed.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(jobs: list, out_dir: str, world: int = 2, device: str = "cpu"):
    """Starts ``world`` ranks on ``jobs`` (saved to ``out_dir/jobs.pt``);
    returns the processes, for ``join``."""
    import subprocess
    path = os.path.join(out_dir, "jobs.pt")
    torch.save(jobs, path)
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [repo, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, out_dir,
             device], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def join(procs, out_dir: str, timeout: float) -> list:
    """Waits for every rank (at most ``timeout`` seconds in all, then kills
    them) and returns each rank's results; raises with the output of any
    rank that failed."""
    import subprocess
    import time
    end = time.monotonic() + timeout
    logs, failed = [], []
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=max(end - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, _ = proc.communicate()
            failed.append(r)
        logs.append(out)
        if proc.returncode != 0:
            failed.append(r)
    if failed:
        raise RuntimeError(f"ranks {sorted(set(failed))} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{log[-4000:]}" for r, log in enumerate(logs)))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


if __name__ == "__main__":
    worker(*sys.argv[1:])
