"""Cityscapes-3D sample helpers and transforms on the host, in numpy (port of
mtt_tpu/data/cityscapes3d.py): the gtFine label ids encoded to the 19 train
classes, a gtBbox3d.json turned into padded S-frame ground-truth arrays,
and the transforms (the image to ``TRAIN.SCALE`` by cv2's linear resize and
ImageNet-normalised, semseg and depth to ``dd_label_map_size`` by nearest
neighbour, both with ``data/transforms.py: resize``, cv2's float path bit
for bit). The dataset reader, which decodes the images, is ROADMAP.md item
1.8: ``common_config.get_dataset`` raises with a data root on disk.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

from mtt_tpu_torch.data.transforms import resize
from mtt_tpu_torch.detection.cs_geometry import (EVAL_LABELS, LABEL_TO_ID,
                                                 box_v_to_s, projection_matrix,
                                                 rotation_s_to_euler_zxy)

VOID_CLASSES = (0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1)
VALID_CLASSES = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                 28, 31, 32, 33)
CLASS_MAP = {c: i for i, c in enumerate(VALID_CLASSES)}


def encode_segmap(mask: np.ndarray, ignore_index: int = 255) -> np.ndarray:
    out = np.full_like(mask, ignore_index)
    for raw, train in CLASS_MAP.items():
        out[mask == raw] = train
    return out


def load_det_json(det_path: str, max_boxes: int
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray, Dict]:
    """gtBbox3d.json -> (padded S-frame GT arrays, the camera matrix K, the
    camera dict of ``meta``) (cityscapes3d.py:290-352)."""
    with open(det_path) as f:
        bj = json.load(f)
    sensor = bj["sensor"]
    K = projection_matrix(sensor["fx"], sensor["fy"], sensor["u0"],
                          sensor["v0"]).astype(np.float32)
    ext = np.asarray(sensor["sensor_T_ISO_8855"], np.float32)

    out = {
        "det_bboxes2d": np.zeros((max_boxes, 4), np.float32),
        "det_bboxes2d_amodal": np.zeros((max_boxes, 4), np.float32),
        "det_labels": np.zeros((max_boxes,), np.int32),
        "det_boxes3d": np.zeros((max_boxes, 9), np.float32),
        "det_centers2d": np.zeros((max_boxes, 2), np.float32),
        "det_depths": np.zeros((max_boxes,), np.float32),
        "det_valid": np.zeros((max_boxes,), np.float32),
    }
    n = 0
    for obj in bj["objects"]:
        if obj["label"] not in EVAL_LABELS or n >= max_boxes:
            continue
        center_v = np.asarray(obj["3d"]["center"], np.float64)
        quat_v = np.asarray(obj["3d"]["rotation"], np.float64)  # (w,x,y,z)
        dims = np.asarray(obj["3d"]["dimensions"], np.float32)  # L,W,H
        c_s, q_s = box_v_to_s(center_v, quat_v, ext)
        center_2d = K @ c_s
        depth = float(center_2d[2])
        if depth <= 0:
            continue
        uv = (center_2d[:2] / depth).astype(np.float32)
        rot_zxy = rotation_s_to_euler_zxy(q_s)

        out["det_boxes3d"][n, :3] = c_s.astype(np.float32)
        out["det_boxes3d"][n, 3:6] = dims
        out["det_boxes3d"][n, 6:9] = rot_zxy
        out["det_centers2d"][n] = uv
        out["det_depths"][n] = depth
        out["det_labels"][n] = LABEL_TO_ID[obj["label"]]
        bb = obj["2d"]

        def _xywh_to_xyxy(r):
            # official JSON 2D boxes are [x, y, w, h]
            # (cityscapesscripts CsBbox2d); internal targets are xyxy
            r = np.asarray(r, np.float32)
            return np.asarray([r[0], r[1], r[0] + r[2], r[1] + r[3]],
                              np.float32)

        out["det_bboxes2d"][n] = _xywh_to_xyxy(bb["modal"])
        out["det_bboxes2d_amodal"][n] = _xywh_to_xyxy(
            bb.get("amodal", bb["modal"]))
        out["det_valid"][n] = 1.0
        n += 1
    return out, K, {"fx": sensor["fx"], "fy": sensor["fy"],
                    "u0": sensor["u0"], "v0": sensor["v0"],
                    "sensor_T_ISO_8855": sensor["sensor_T_ISO_8855"]}


class CS3DValTransforms:
    """Normalise the image at ``TRAIN.SCALE``; labels to
    ``dd_label_map_size``. The camera matrix in ``meta`` stays that of the
    original pixel grid: the detection strides of the config account for
    the resize."""

    def __init__(self, p):
        self.size = tuple(p["dd_label_map_size"])
        self.img_size = tuple(p["TRAIN"]["SCALE"])

    def __call__(self, sample, rng=None):
        img = sample["image"].astype(np.float32)
        if img.shape[:2] != self.img_size:
            img = resize(img, self.img_size[::-1], "linear")
        img = img / 255.0
        img = (img - np.array([0.485, 0.456, 0.406], np.float32)) / \
            np.array([0.229, 0.224, 0.225], np.float32)
        sample["image"] = img
        for k in ("semseg", "depth"):
            arr = np.squeeze(np.asarray(sample[k], np.float32))
            if arr.shape[:2] != self.size:
                arr = resize(arr, self.size[::-1], "nearest")
            sample[k] = arr[..., None]
        return sample


# the reference applies no geometric augmentation to Cityscapes-3D training
# (a geometric one would move the 3D boxes' projected centres): train == val
CS3DTrainTransforms = CS3DValTransforms
