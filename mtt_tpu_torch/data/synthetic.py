"""Deterministic synthetic multi-task samples (the port's own copy of the 2D
tasks of mtt_tpu/data/synthetic.py:SyntheticMT).

Procedural images and per-task labels with the shapes, dtypes and ignore
conventions of PASCAL-Context / NYUD-v2, made with numpy from
``seed * 100003 + idx`` exactly as the JAX package makes them, so both
packages see the same samples. Stands in for the datasets, which are not in
the repository.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


class SyntheticMT:
    def __init__(self, tasks: Sequence[str], num_outputs: Dict[str, int],
                 size: Tuple[int, int] = (512, 512), seed: int = 0):
        unknown = set(tasks) - {"semseg", "human_parts", "sal", "edge",
                                "normals", "depth"}
        if unknown:
            raise NotImplementedError(f"no synthetic labels for {unknown}")
        self.tasks = list(tasks)
        self.num_outputs = num_outputs
        self.size = tuple(size)
        self.seed = seed

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """{"image": (H, W, 3) float32 RGB in [0, 255], task: (H, W, c)}."""
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
            else:                                   # depth
                sample[t] = (1.0 + 5.0 * (np.sin(xx / 41) * np.cos(yy / 43)
                                          + 1)).astype(np.float32)[..., None]
        return sample

    def batch(self, start: int, size: int) -> Dict[str, np.ndarray]:
        """Samples start .. start + size - 1 stacked along a batch axis."""
        items = [self[start + i] for i in range(size)]
        return {k: np.stack([s[k] for s in items]) for k in items[0]}
