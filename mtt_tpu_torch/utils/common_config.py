"""Transforms, datasets and loaders from a config (port of
mtt_tpu/utils/common_config.py).

The dataset readers are not ported (ROADMAP.md item 1.8): without a data
root (``db_paths`` or ``MTT_DATA_ROOT``) the datasets are ``SyntheticMT``
through the real transforms, 256 training and 64 eval samples (64 and 64
with ``overfit``), as in the JAX package; with a root on disk
``get_dataset`` raises rather than fall back to synthetic data.
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
    """The synthetic stand-in of the config's database and split."""
    db = p["train_db_name"]
    root = _db_root(p, _DB_DIRS.get(db, db))
    if root is not None:
        raise NotImplementedError(
            f"a {db} data root is on disk ({root}), but the dataset readers "
            f"are not ported yet (ROADMAP.md item 1.8)")
    tasks = p.TASKS.NAMES
    num_out = {t: p.TASKS.NUM_OUTPUT[t] for t in tasks}
    size = p.TRAIN.SCALE if split == "train" else p.TEST.SCALE
    return SyntheticMT(tasks, num_out, size=tuple(size),
                       length=64 if (overfit or split != "train") else 256,
                       transform=transforms)


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
