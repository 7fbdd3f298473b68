"""Transforms, datasets and loaders from a config (port of
mtt_tpu/utils/common_config.py).

With a data root on disk (the config's ``db_paths`` entry of the database,
else ``MTT_DATA_ROOT``) the dataset is its reader (``data/datasets.py:
PASCALContext``, ``NYUD_MT``; ``data/cityscapes3d.py: Cityscapes3D``);
without one it is ``SyntheticMT`` through the real transforms, 256
training and 64 eval samples (64 and 64 with ``overfit``), as in the JAX
package.
"""

from __future__ import annotations

import os
from typing import Optional

from mtt_tpu_torch.data.loader import MultiTaskLoader
from mtt_tpu_torch.data.synthetic import SyntheticMT
from mtt_tpu_torch.data.transforms import TrainTransforms, ValTransforms

_DB_DIRS = {"PASCALContext": "PASCALContext", "NYUD": "NYUD_MT",
            "Cityscapes3D": "Cityscapes3D"}


def get_transformations(p):
    """(train, val) transform pipelines of the config's database."""
    db = p["train_db_name"]
    depth_ignore = -1.0 if p.get("ignore_invalid_area_depth", False) \
        else 255.0
    if db in ("NYUD", "PASCALContext"):
        return (TrainTransforms(p.TRAIN.SCALE, depth_ignore),
                ValTransforms(p.TEST.SCALE, depth_ignore))
    if db == "Cityscapes3D":
        from mtt_tpu_torch.data.cityscapes3d import (CS3DTrainTransforms,
                                                     CS3DValTransforms)
        return CS3DTrainTransforms(p), CS3DValTransforms(p)
    return None, None


def _db_root(p, db: str) -> Optional[str]:
    root = p.get("db_paths", {}).get(db) or os.environ.get("MTT_DATA_ROOT",
                                                           "")
    if root and os.path.isdir(str(root)):
        return str(root)
    return None


def get_dataset(p, split: str, transforms=None, overfit: bool = False):
    """The reader of the config's database and split under its data root,
    or the synthetic stand-in when no root is on disk."""
    db = p["train_db_name"]
    tasks = p.TASKS.NAMES
    root = _db_root(p, _DB_DIRS.get(db, db))
    if root is None:
        num_out = {t: p.TASKS.NUM_OUTPUT[t] for t in tasks}
        size = p.TRAIN.SCALE if split == "train" else p.TEST.SCALE
        return SyntheticMT(tasks, num_out, size=tuple(size),
                           length=64 if (overfit or split != "train")
                           else 256, transform=transforms)
    if db == "PASCALContext":
        from mtt_tpu_torch.data.datasets import PASCALContext
        return PASCALContext(
            root, split=["train"] if split == "train" else "val",
            transform=transforms, overfit=overfit,
            do_semseg="semseg" in tasks, do_edge="edge" in tasks,
            do_normals="normals" in tasks, do_sal="sal" in tasks,
            do_human_parts="human_parts" in tasks)
    if db == "NYUD":
        from mtt_tpu_torch.data.datasets import NYUD_MT
        return NYUD_MT(root, split=split, transform=transforms,
                       overfit=overfit, do_edge="edge" in tasks,
                       do_semseg="semseg" in tasks,
                       do_normals="normals" in tasks,
                       do_depth="depth" in tasks)
    if db == "Cityscapes3D":
        from mtt_tpu_torch.data.cityscapes3d import Cityscapes3D
        return Cityscapes3D(root, split=split, p=p, transform=transforms,
                            overfit=overfit)
    raise NotImplementedError(db)


def get_train_dataloader(p, dataset, num_shards: int = 1,
                         shard_index: int = 0):
    return MultiTaskLoader(dataset, batch_size=int(p["trBatch"]),
                           shuffle=True, num_workers=int(p.get("nworkers", 2)),
                           num_shards=num_shards, shard_index=shard_index,
                           drop_last=True)


def get_test_dataloader(p, dataset, num_shards: int = 1,
                        shard_index: int = 0):
    return MultiTaskLoader(dataset, batch_size=int(p["valBatch"]),
                           shuffle=False, num_workers=int(p.get("nworkers", 2)),
                           num_shards=num_shards, shard_index=shard_index,
                           drop_last=False)
