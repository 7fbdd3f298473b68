"""The Cityscapes-3D detection evaluation of the eval loop (port of
mtt_tpu/detection/det_eval.py).

``test_phase`` hands each batch's detection-head output (from the forward
that also feeds the 2D meters) and the batch to ``DetRecordAccumulator``:
the whole batch decodes on the model's device through
``inference.decode_3ddet``, each image with its own ``K_matrix``, and comes
to the host in one copy; each image's detections become official-format
JSON objects (written under ``save_dir/3ddet`` when one is given), its
ground truth is rebuilt from the padded ``det_*`` arrays, and
``evaluate`` scores all records with ``Box3dEvaluator``. Batch-padding
samples (``meta["pad"]``) are left out. Over several ranks, ``evaluate``
gathers every rank's records on rank 0 in rank order (no shared directory,
where JAX merges per-rank files), scores them there once, and every rank
returns rank 0's scores, the whole dict (JAX's other processes get mDS and
mAP alone).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from mtt_tpu_torch.detection.cs_geometry import (EVAL_LABELS, box_s_to_v,
                                                 euler_zxy_to_quat_s)
from mtt_tpu_torch.detection.eval3d import Box3dEvaluator
from mtt_tpu_torch.detection.export import (bbox_to_json_objects,
                                            save_image_predictions)
from mtt_tpu_torch.parallel.mesh import data_shard_info

# the decoded fields in the order of the one host copy, and their widths
_FIELDS = (("boxes3d", 9), ("bboxes2d", 4), ("centers2d", 3), ("scores", 0),
           ("labels", 0), ("valid", 0))
_GT_KEYS = ("det_valid", "det_boxes3d", "det_bboxes2d", "det_labels")


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _gt_objects_from_batch(batch, i) -> list:
    """Evaluator GT records of sample ``i`` from the padded det_* arrays
    (numpy)."""
    out = []
    cam = batch["meta"][i]["camera"]
    for j in range(batch["det_valid"].shape[1]):
        if not batch["det_valid"][i][j]:
            continue
        b3d = batch["det_boxes3d"][i][j]
        q_s = euler_zxy_to_quat_s(b3d[6:9])
        c_v, q_v = box_s_to_v(b3d[:3], q_s, cam["sensor_T_ISO_8855"])
        x0, y0, x1, y1 = [float(x) for x in batch["det_bboxes2d"][i][j]]
        out.append({
            "label": EVAL_LABELS[int(batch["det_labels"][i][j])],
            # object dicts carry official-format xywh 2D boxes
            "2d": {"modal": [x0, y0, x1 - x0, y1 - y0]},
            "3d": {"center": [float(x) for x in c_v],
                   "dimensions": [float(x) for x in b3d[3:6]],
                   "rotation": [float(x) for x in q_v]},
        })
    return out


class DetRecordAccumulator:
    """Per-image detection records of the eval loop: ``add_batch`` takes the
    detection head's per-level output of a batch (on the model's device) and
    the batch (``meta`` with each sample's ``K_matrix``, ``camera`` and
    ``img_name``, and the ``det_*`` arrays); ``evaluate`` scores every
    record."""

    def __init__(self, det_cfg: dict, save_dir: Optional[str] = None):
        self.det_cfg = det_cfg
        self.save_dir = save_dir
        self.records = []

    def decode_batch(self, head_out, batch):
        """Yields (index, meta, dec, objs) for every sample of the batch
        but the pad ones: dec the decoded numpy arrays (boxes3d, bboxes2d,
        centers2d, scores, labels, valid), objs the official-format JSON
        objects."""
        from mtt_tpu_torch.inference import decode_3ddet
        metas = batch.get("meta")
        if metas is None:
            raise ValueError("decoding a batch's detections needs its meta "
                             "(each image's K_matrix, camera and img_name)")
        rows = [i for i in range(min(len(metas), head_out[0][0].shape[0]))
                if not metas[i].get("pad")]
        if not rows:
            return
        dev = head_out[0][0].device
        idx = torch.tensor(rows, device=dev)
        head = tuple([t.index_select(0, idx) for t in lvls]
                     for lvls in head_out)
        K = torch.from_numpy(np.stack([np.asarray(metas[i]["K_matrix"],
                                                  np.float32)
                                       for i in rows])).to(dev)
        dec = decode_3ddet(head, K, self.det_cfg)
        # one copy to the host for the whole batch
        packed = torch.cat([dec[k].float().reshape(len(rows), -1, max(w, 1))
                            for k, w in _FIELDS], dim=-1).cpu().numpy()
        fields, at = {}, 0
        for k, w in _FIELDS:
            v = packed[..., at:at + max(w, 1)]
            fields[k] = v if w else v[..., 0]
            at += max(w, 1)
        fields["labels"] = fields["labels"].astype(np.int64)
        fields["valid"] = fields["valid"] > 0.5
        for n, i in enumerate(rows):
            meta = metas[i]
            d = {k: v[n] for k, v in fields.items()}
            objs = bbox_to_json_objects(d["boxes3d"], d["bboxes2d"],
                                        d["scores"], d["labels"], d["valid"],
                                        meta["camera"])
            yield i, meta, d, objs

    def add_batch(self, head_out, batch):
        gt = None
        for i, meta, _, objs in self.decode_batch(head_out, batch):
            if gt is None:          # the ground truth on the host, once
                gt = {k: _host(batch[k]) for k in _GT_KEYS}
                gt["meta"] = batch["meta"]
            if self.save_dir is not None:
                save_image_predictions(os.path.join(self.save_dir, "3ddet"),
                                       meta["img_name"], objs)
            self.records.append(
                (meta["img_name"], _gt_objects_from_batch(gt, i), objs))

    def evaluate(self) -> Dict:
        """The evaluator's scores of every rank's records."""
        world, rank = data_shard_info()
        if world == 1:
            return self._score(self.records)
        shards = [None] * world if rank == 0 else None
        dist.gather_object(self.records, shards, dst=0)
        out = [self._score([r for s in shards for r in s])
               if rank == 0 else None]
        dist.broadcast_object_list(out, src=0)
        return out[0]

    @staticmethod
    def _score(records) -> Dict:
        ev = Box3dEvaluator(EVAL_LABELS, min_iou=0.7)
        for name, gt, pred in records:
            ev.add_image(name, gt, pred)
        return ev.evaluate()


@torch.no_grad()
def evaluate_detection(model, batches: Iterable[Dict],
                       save_dir: Optional[str] = None) -> Dict:
    """A detection-only pass over ``batches`` (each with the image on the
    model's device, ``meta`` and the ``det_*`` arrays): the forward, the
    records and the evaluator's scores. The eval loop scores detections
    inside ``test_phase`` instead, from the forward it shares with the 2D
    meters."""
    dtype = next(model.parameters()).dtype
    acc = DetRecordAccumulator(model.det_cfg, save_dir)
    for batch in batches:
        out = model(batch["image"].to(dtype), train=False)
        acc.add_batch(out["3ddet"], batch)
    return acc.evaluate()
