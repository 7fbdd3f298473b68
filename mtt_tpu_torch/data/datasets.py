"""PASCAL-Context (5 tasks) and NYUD-v2 (4 tasks) from a data root on disk
(port of mtt_tpu/data/datasets.py), in numpy on the host: the same
directory layouts, file lists, label semantics and samples, bit for bit
before the transforms.

  PASCAL: edges from the .mat label map's Laplacian, thinned; semseg PNG
  (VOC12 or pascal-context folder, a palette PNG's indices); human parts
  from the .mat annotation with the 6-part merge table and the parts cache
  JSON; distilled normals masked to the NYU-compatible classes; distilled
  saliency thresholded at 0.5; ``overfit`` keeps 64 images.
  NYUD: semseg 40 classes shifted by -1 with 255 ignored; depth .npy;
  normals PNG to [-1, 1]; edge PNG / 255.

Images and labels are decoded by ``data/image_io.read_image`` in the mode
of the PIL call the JAX reader makes (``"pil_rgb"`` for images, ``"pil"``
for labels); the .mat files by ``scipy.io.loadmat``. cv2's Laplacian and
resizes are the numpy ones here and in ``data/transforms.py``: a label
map that is not the image's size is resized by nearest neighbour (cv2's
bit for bit), normals by cubic (within a few f32 ulps of cv2's).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import scipy.io as sio

from mtt_tpu_torch.data.image_io import read_image
from mtt_tpu_torch.data.transforms import resize


def laplacian(a: np.ndarray) -> np.ndarray:
    """``cv2.Laplacian(a, cv2.CV_64F)`` (ksize 1) of a 2D map: the
    4-neighbour stencil under BORDER_REFLECT_101, in f64 (exact on
    integer-valued maps such as label ids)."""
    a = np.asarray(a, np.float64)
    p = np.pad(a, 1, mode="reflect")
    return (p[:-2, 1:-1] + p[2:, 1:-1]) + (p[1:-1, :-2] + p[1:-1, 2:]) \
        - 4.0 * a


def zhang_suen_thin(mask: np.ndarray, max_iter: int = 100) -> np.ndarray:
    """The JAX package's thinning of a binary mask (its replacement of
    skimage's ``thin``): Zhang-Suen sub-iterations over the 8 neighbours
    taken with ``np.roll``, so the map wraps around at its borders as
    there; float32 0/1."""
    img = mask.astype(np.uint8).copy()
    if img.sum() == 0:
        return img.astype(np.float32)

    def neighbors(im):
        p2 = np.roll(im, -1, 0)
        p6 = np.roll(im, 1, 0)
        p4 = np.roll(im, -1, 1)
        p8 = np.roll(im, 1, 1)
        p3 = np.roll(p2, -1, 1)
        p5 = np.roll(p6, -1, 1)
        p7 = np.roll(p6, 1, 1)
        p9 = np.roll(p2, 1, 1)
        return p2, p3, p4, p5, p6, p7, p8, p9

    for _ in range(max_iter):
        changed = False
        for step in (0, 1):
            p2, p3, p4, p5, p6, p7, p8, p9 = neighbors(img)
            seq = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
            a = sum(((seq[i] == 0) & (seq[i + 1] == 1)).astype(np.uint8)
                    for i in range(8))
            b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
            if step == 0:
                cond = (a == 1) & (b >= 2) & (b <= 6) & \
                    (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond = (a == 1) & (b >= 2) & (b <= 6) & \
                    (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            rm = cond & (img == 1)
            if rm.any():
                img[rm] = 0
                changed = True
        if not changed:
            break
    return img.astype(np.float32)


class PASCALContext:
    """5-task PASCAL-Context: images with edge, semseg, human parts,
    normals and saliency labels."""

    HUMAN_PART_6 = {  # the 6-part merge table
        "hair": 1, "head": 1, "lear": 1, "lebrow": 1, "leye": 1, "lfoot": 6,
        "lhand": 4, "llarm": 4, "llleg": 6, "luarm": 3, "luleg": 5, "mouth": 1,
        "neck": 2, "nose": 1, "rear": 1, "rebrow": 1, "reye": 1, "rfoot": 6,
        "rhand": 4, "rlarm": 4, "rlleg": 6, "ruarm": 3, "ruleg": 5, "torso": 2}
    HUMAN_PARTS_CATEGORY = 15

    def __init__(self, root: str, split="val", transform=None, retname=True,
                 overfit=False, do_edge=True, do_human_parts=False,
                 do_semseg=False, do_normals=False, do_sal=False,
                 db_info_dir: Optional[str] = None):
        self.root = root
        self.transform = transform
        self.retname = retname
        self.split = sorted([split] if isinstance(split, str) else list(split))
        self.do_edge, self.do_human_parts = do_edge, do_human_parts
        self.do_semseg, self.do_normals, self.do_sal = (do_semseg, do_normals,
                                                        do_sal)

        image_dir = os.path.join(root, "JPEGImages")
        self.edge_gt_dir = os.path.join(root, "pascal-context", "trainval")
        part_gt_dir = os.path.join(root, "human_parts")
        splits_dir = os.path.join(root, "ImageSets", "Context")

        self.im_ids: List[str] = []
        self.images, self.edges, self.semsegs = [], [], []
        self.parts, self.normals, self.sals = [], [], []
        for splt in self.split:
            with open(os.path.join(splits_dir, splt + ".txt")) as f:
                lines = f.read().splitlines()
            for line in lines:
                self.im_ids.append(line.strip())
                self.images.append(os.path.join(image_dir, line + ".jpg"))
                self.edges.append(os.path.join(self.edge_gt_dir,
                                               line + ".mat"))
                self.semsegs.append(self._semseg_fname(line))
                self.parts.append(os.path.join(part_gt_dir, line + ".mat"))
                self.normals.append(os.path.join(root, "normals_distill",
                                                 line + ".png"))
                self.sals.append(os.path.join(root, "sal_distill",
                                              line + ".png"))

        if self.do_normals:
            self.normals_valid_classes = self._normals_valid_classes(
                db_info_dir)
        if self.do_human_parts:
            self._prepare_parts_index(part_gt_dir)

        if overfit:
            n = 64
            for attr in ("im_ids", "images", "edges", "semsegs", "parts",
                         "normals", "sals"):
                setattr(self, attr, getattr(self, attr)[:n])
            if self.do_human_parts:
                self.has_human_parts = self.has_human_parts[:n]

    def _semseg_fname(self, name: str) -> str:
        voc = os.path.join(self.root, "semseg", "VOC12", name + ".png")
        ctx = os.path.join(self.root, "semseg", "pascal-context",
                           name + ".png")
        return voc if os.path.isfile(voc) else ctx

    def _normals_valid_classes(self, db_info_dir):
        """The NYU-compatible context classes whose distilled normals are
        valid."""
        db_info_dir = db_info_dir or os.path.join(self.root, "db_info")
        with open(os.path.join(db_info_dir, "nyu_classes.json")) as f:
            cls_nyu = json.load(f)
        with open(os.path.join(db_info_dir, "context_classes.json")) as f:
            cls_context = json.load(f)
        valid = [cls_context[c] for c in cls_nyu
                 if c in cls_context and c != "unknown"]
        valid.append(cls_context["tvmonitor"])
        return set(valid)

    def _prepare_parts_index(self, part_gt_dir):
        """The cache of which images hold annotated humans
        (``ImageSets/Parts/<splits>.txt``, JSON), written at first use."""
        cache = os.path.join(self.root, "ImageSets", "Parts",
                             "".join(self.split) + ".txt")
        if os.path.isfile(cache):
            with open(cache) as f:
                self.part_obj_dict = json.load(f)
        else:
            self.part_obj_dict = {}
            for im_id, pth in zip(self.im_ids, self.parts):
                cats = []
                if os.path.isfile(pth):
                    mat = sio.loadmat(pth)["anno"][0][0][1][0]
                    for obj in mat:
                        if len(obj[3]) != 0:
                            cats.append(int(obj[1][0][0]))
                self.part_obj_dict[im_id] = cats
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            with open(cache, "w") as f:
                json.dump(self.part_obj_dict, f)
        self.has_human_parts = [
            1 if self.HUMAN_PARTS_CATEGORY in self.part_obj_dict.get(i, [])
            else 0 for i in self.im_ids]

    def _load_edge(self, idx):
        lbl = sio.loadmat(self.edges[idx])["LabelMap"]
        return zhang_suen_thin(np.abs(laplacian(lbl)) > 0)

    def _load_human_parts(self, idx, hw):
        if not self.has_human_parts[idx]:
            return np.zeros(hw, np.float32)
        mat = sio.loadmat(self.parts[idx])["anno"][0][0][1][0]
        target = None
        for obj in mat:
            if int(obj[1][0][0]) == self.HUMAN_PARTS_CATEGORY and \
                    len(obj[3]) != 0:
                if target is None:
                    target = np.zeros(obj[2].shape, np.float32)
                for part in obj[3][0]:
                    name = str(part[0][0])
                    target[part[1].astype(bool)] = self.HUMAN_PART_6[name]
        return target if target is not None else np.zeros(hw, np.float32)

    def _load_normals(self, idx):
        img = np.array(read_image(self.normals[idx], "pil"), np.float32)
        img = 2.0 * img / 255.0 - 1.0
        labels = sio.loadmat(os.path.join(
            self.edge_gt_dir, self.im_ids[idx] + ".mat"))["LabelMap"]
        out = np.zeros_like(img)
        for x in np.unique(labels):
            if int(x) in self.normals_valid_classes:
                out[labels == x, :] = img[labels == x, :]
        return out

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None) -> Dict:
        img = np.array(read_image(self.images[idx], "pil_rgb"), np.float32)
        sample = {"image": img}
        hw = img.shape[:2]

        def fit(arr, mode="nearest"):
            if arr.shape[:2] != hw:
                arr = resize(arr, hw[::-1], mode)
            return arr

        if self.do_edge:
            sample["edge"] = fit(self._load_edge(idx))[..., None]
        if self.do_human_parts:
            sample["human_parts"] = fit(
                self._load_human_parts(idx, hw))[..., None]
        if self.do_semseg:
            sample["semseg"] = fit(np.array(
                read_image(self.semsegs[idx], "pil"), np.float32))[..., None]
        if self.do_normals:
            sample["normals"] = fit(self._load_normals(idx), "cubic")
        if self.do_sal:
            sal = np.array(read_image(self.sals[idx], "pil"),
                           np.float32) / 255.0
            sample["sal"] = fit((sal > 0.5).astype(np.float32))[..., None]
        if self.retname:
            sample["meta"] = {"img_name": self.im_ids[idx], "img_size": hw}
        if self.transform is not None:
            sample = self.transform(sample, rng or np.random.default_rng())
        return sample


class NYUD_MT:
    """4-task NYUD-v2: images with edge, semseg, normals and depth
    labels."""

    def __init__(self, root: str, split="val", transform=None, retname=True,
                 overfit=False, do_edge=False, do_semseg=False,
                 do_normals=False, do_depth=False):
        self.root = root
        self.transform = transform
        self.retname = retname
        self.split = [split] if isinstance(split, str) else sorted(split)
        self.do_edge, self.do_semseg = do_edge, do_semseg
        self.do_normals, self.do_depth = do_normals, do_depth

        self.im_ids, self.images = [], []
        self.edges, self.semsegs, self.normals, self.depths = [], [], [], []
        for splt in self.split:
            with open(os.path.join(root, "gt_sets", splt + ".txt")) as f:
                lines = f.read().splitlines()
            for line in lines:
                self.im_ids.append(line.strip())
                self.images.append(os.path.join(root, "images",
                                                line + ".png"))
                self.edges.append(os.path.join(root, "edge", line + ".png"))
                self.semsegs.append(os.path.join(root, "segmentation",
                                                 line + ".png"))
                self.normals.append(os.path.join(root, "normals",
                                                 line + ".png"))
                self.depths.append(os.path.join(root, "depth", line + ".npy"))
        if overfit:
            self.images = self.images[:64]
            self.im_ids = self.im_ids[:64]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        img = np.array(read_image(self.images[idx], "pil_rgb"), np.float32)
        sample = {"image": img}
        hw = img.shape[:2]
        if self.do_edge:
            e = np.array(read_image(self.edges[idx], "pil"),
                         np.float32) / 255.0
            sample["edge"] = e[..., None]
        if self.do_semseg:
            s = np.array(read_image(self.semsegs[idx], "pil"),
                         np.float32) - 1
            s[s == -1] = 255
            sample["semseg"] = s[..., None]
        if self.do_normals:
            n = np.array(read_image(self.normals[idx], "pil"), np.float32)
            sample["normals"] = 2.0 * n / 255.0 - 1.0
        if self.do_depth:
            d = np.load(self.depths[idx]).astype(np.float32)
            sample["depth"] = d[..., None]
        if self.retname:
            sample["meta"] = {"img_name": self.im_ids[idx], "img_size": hw}
        if self.transform is not None:
            sample = self.transform(sample, rng or np.random.default_rng())
        return sample
