"""The Cityscapes-3D dataset on the host, in numpy (port of
mtt_tpu/data/cityscapes3d.py): the reader of a data root on disk
(``Cityscapes3D``: leftImg8bit images, gtFine label ids encoded to the 19
train classes, disparity (d - 1) / 256 with -1 where invalid and 0 on sky,
the camera of each frame's gtBbox3d.json, its boxes as padded S-frame
ground-truth arrays), and the transforms (the image to ``TRAIN.SCALE`` by
cv2's linear resize and ImageNet-normalised, semseg and depth to
``dd_label_map_size`` by nearest neighbour, both with ``data/transforms.py:
resize``, cv2's float path bit for bit). The PNGs are decoded by
``data/image_io.read_image`` in the mode of the cv2 call the JAX reader
makes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from mtt_tpu_torch.data.image_io import read_image
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


class Cityscapes3D:
    """Frames of one split under ``root`` (the official layout:
    ``leftImg8bit``, ``gtFine``, ``disparity``, ``gtBbox3d``); the training
    split keeps only frames with boxes of the evaluated classes, and
    ``overfit`` keeps 16 frames."""

    def __init__(self, root: str, split: str = "train", p=None,
                 transform=None, overfit: bool = False,
                 max_boxes: int = 64, ignore_index: int = 255):
        self.root = root
        self.split = split
        self.p = p
        self.transform = transform
        self.ignore_index = ignore_index
        self.max_boxes = (p.det_cfg.get("max_boxes", max_boxes)
                          if p is not None and "det_cfg" in p else max_boxes)
        self.dd_label_map_size = (tuple(p["dd_label_map_size"]) if p
                                  else (512, 1024))

        img_base = os.path.join(root, "leftImg8bit", split)
        self.files: List[str] = []
        for dirpath, _, names in os.walk(img_base):
            for nm in sorted(names):
                if nm.endswith(".png"):
                    self.files.append(os.path.join(dirpath, nm))
        self.files.sort()

        if split == "train":
            self.files = [f for f in self.files if self._has_boxes(f)]
        if overfit:
            self.files = self.files[:16]

    def _paths(self, img_path: str) -> Dict[str, str]:
        city = img_path.split(os.sep)[-2]
        base = os.path.basename(img_path)[:-len("leftImg8bit.png")]
        return {
            "semseg": os.path.join(self.root, "gtFine", self.split, city,
                                   base + "gtFine_labelIds.png"),
            "depth": os.path.join(self.root, "disparity", self.split, city,
                                  base + "disparity.png"),
            "det": os.path.join(self.root, "gtBbox3d", self.split, city,
                                base + "gtBbox3d.json"),
        }

    def _has_boxes(self, img_path: str) -> bool:
        det = self._paths(img_path)["det"]
        if not os.path.isfile(det):
            return False
        with open(det) as f:
            bj = json.load(f)
        return any(o["label"] in EVAL_LABELS for o in bj["objects"])

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx, rng=None):
        img_path = self.files[idx]
        paths = self._paths(img_path)
        img = read_image(img_path, "cv2_color").astype(np.float32)
        H, W = img.shape[:2]
        sample: Dict = {"image": img}

        lbl = read_image(paths["semseg"], "cv2_unchanged")
        sample["semseg"] = encode_segmap(lbl.astype(np.int32),
                                         self.ignore_index).astype(np.float32)

        disp = read_image(paths["depth"], "cv2_unchanged").astype(np.float32)
        disp[disp > 0] = (disp[disp > 0] - 1) / 256.0
        disp[disp == 0] = -1.0
        disp[lbl == 10] = 0.0  # sky: disparity 0
        sample["depth"] = disp

        det, K, cam = load_det_json(paths["det"], self.max_boxes)
        sample.update(det)
        sample["meta"] = {
            "img_name": os.path.basename(img_path)[:-4],
            "img_size": (H, W),
            "K_matrix": K,
            "camera": cam,
            "scale_factor": np.array([1.0, 1.0], np.float32),
        }
        if self.transform is not None:
            sample = self.transform(sample, rng or np.random.default_rng())
        return sample


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
