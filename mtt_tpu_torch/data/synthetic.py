"""Deterministic synthetic multi-task samples (the port's own copy of
mtt_tpu/data/synthetic.py:SyntheticMT).

Procedural images and per-task labels with the shapes, dtypes and ignore
conventions of PASCAL-Context / NYUD-v2 / Cityscapes-3D, made with numpy from
``seed * 100003 + idx`` with the draws in the JAX package's order, so both
packages see the same samples, the ``3ddet`` boxes included: 1-5 boxes a
image in ``max_boxes`` padded slots (``det_bboxes2d``, ``det_labels``,
``det_boxes3d``, ``det_centers2d``, ``det_depths``, ``det_valid``). With
``label_size`` the 2D labels are resampled to it by nearest neighbour (the
source pixel floor(i * size / label_size), as cv2.INTER_NEAREST picks it):
the Cityscapes-3D configs supervise at ``dd_label_map_size``. Stands in for
the datasets, which are not in the repository.

As a dataset (the JAX contract): ``len`` is ``length``, and
``ds[idx]`` / ``ds.__getitem__(idx, rng)`` is one sample with its ``meta``
(``img_name``, ``img_size``; under ``3ddet`` also the camera), passed
through ``transform(sample, rng)`` when there is one (``rng`` defaults to
``np.random.default_rng(idx)``). ``batch`` stacks the untransformed arrays of
consecutive samples, without ``meta``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class SyntheticMT:
    def __init__(self, tasks: Sequence[str], num_outputs: Dict[str, int],
                 size: Tuple[int, int] = (512, 512), seed: int = 0,
                 max_boxes: int = 64,
                 label_size: Optional[Tuple[int, int]] = None,
                 length: int = 64, transform=None):
        unknown = set(tasks) - {"semseg", "human_parts", "sal", "edge",
                                "normals", "depth", "3ddet"}
        if unknown:
            raise NotImplementedError(f"no synthetic labels for {unknown}")
        self.tasks = list(tasks)
        self.num_outputs = num_outputs
        self.size = tuple(size)
        self.seed = seed
        self.max_boxes = max_boxes
        self.label_size = tuple(label_size) if label_size else None
        self.length = length
        self.transform = transform

    def __len__(self) -> int:
        return self.length

    def _resample(self, lab: np.ndarray) -> np.ndarray:
        if self.label_size is None or self.label_size == self.size:
            return lab
        (h, w), (lh, lw) = self.size, self.label_size
        iy = np.floor(np.arange(lh) * (h / lh)).astype(np.int64)
        ix = np.floor(np.arange(lw) * (w / lw)).astype(np.int64)
        return lab[iy][:, ix]

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Dict:
        """The sample's arrays with its ``meta``, through
        ``transform``."""
        sample = self._arrays(idx)
        h, w = self.size
        sample["meta"] = {"img_name": f"synth_{idx:06d}", "img_size": (h, w)}
        if "3ddet" in self.tasks:
            sample["meta"]["K_matrix"] = np.array(
                [[1000.0, 0, w / 2], [0, 1000.0, h / 2], [0, 0, 1]],
                np.float32)
            sample["meta"]["camera"] = {
                "fx": 1000.0, "fy": 1000.0, "u0": w / 2.0, "v0": h / 2.0,
                "sensor_T_ISO_8855": [[1, 0, 0, 0], [0, 1, 0, 0],
                                      [0, 0, 1, 0]]}
        if self.transform is not None:
            sample = self.transform(sample,
                                    rng or np.random.default_rng(idx))
        return sample

    def _arrays(self, idx: int) -> Dict[str, np.ndarray]:
        """{"image": (H, W, 3) float32 RGB in [0, 255], task: (h, w, c)} and
        under ``3ddet`` the ``det_*`` arrays."""
        g = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        phase = g.uniform(0, 6.28, size=3).astype(np.float32)
        img = np.stack([
            127 + 120 * np.sin(xx / (17 + 5 * c) + phase[c]) *
            np.cos(yy / (23 + 3 * c) + phase[c]) for c in range(3)], -1)
        sample = {"image": img.astype(np.float32)}
        blob = ((xx - g.uniform(0, w)) ** 2 + (yy - g.uniform(0, h)) ** 2) < \
            g.uniform(min(h, w) / 8, min(h, w) / 2) ** 2
        for t in self.tasks:
            if t in ("semseg", "human_parts"):
                k = self.num_outputs[t]
                lab = (np.floor(xx / w * k) + blob).clip(0, k - 1)
                sample[t] = lab.astype(np.float32)[..., None]
            elif t == "sal":
                sample[t] = blob.astype(np.float32)[..., None]
            elif t == "edge":
                b = blob.astype(np.float32)
                e = np.abs(np.diff(b, axis=0, prepend=0)) + \
                    np.abs(np.diff(b, axis=1, prepend=0))
                sample[t] = (e > 0).astype(np.float32)[..., None]
            elif t == "normals":
                n = np.stack([np.sin(xx / 31), np.cos(yy / 37),
                              np.ones_like(xx)], -1)
                n /= np.linalg.norm(n, axis=-1, keepdims=True)
                sample[t] = n.astype(np.float32)
            elif t == "depth":
                sample[t] = (1.0 + 5.0 * (np.sin(xx / 41) * np.cos(yy / 43)
                                          + 1)).astype(np.float32)[..., None]
            else:                                   # 3ddet
                sample.update(self._boxes(g, h, w))
            if t in sample:
                sample[t] = self._resample(sample[t])
        return sample

    def _boxes(self, g, h: int, w: int) -> Dict[str, np.ndarray]:
        M = self.max_boxes
        det = {"det_bboxes2d": np.zeros((M, 4), np.float32),
               "det_labels": np.zeros((M,), np.int32),
               "det_boxes3d": np.zeros((M, 9), np.float32),
               "det_centers2d": np.zeros((M, 2), np.float32),
               "det_depths": np.zeros((M,), np.float32),
               "det_valid": np.zeros((M,), np.float32)}
        for i in range(int(g.integers(1, 6))):
            cx2, cy2 = g.uniform(0.2 * w, 0.8 * w), g.uniform(0.3 * h, 0.9 * h)
            bw, bh = g.uniform(20, 80), g.uniform(15, 60)
            depth = g.uniform(5, 60)
            det["det_bboxes2d"][i] = [cx2 - bw / 2, cy2 - bh / 2,
                                      cx2 + bw / 2, cy2 + bh / 2]
            det["det_labels"][i] = g.integers(0, 6)
            det["det_boxes3d"][i] = [
                (cx2 - w / 2) * depth / 1000.0, (cy2 - h / 2) * depth / 1000.0,
                depth, g.uniform(2, 6), g.uniform(1.5, 2.5), g.uniform(1.2, 3),
                g.uniform(-0.1, 0.1), g.uniform(-0.1, 0.1),
                g.uniform(-np.pi, np.pi)]
            det["det_centers2d"][i] = [cx2, cy2]
            det["det_depths"][i] = depth
            det["det_valid"][i] = 1.0
        return det

    def batch(self, start: int, size: int) -> Dict[str, np.ndarray]:
        """The arrays of samples start .. start + size - 1 stacked along a
        batch axis."""
        items = [self._arrays(start + i) for i in range(size)]
        return {k: np.stack([s[k] for s in items]) for k in items[0]}
