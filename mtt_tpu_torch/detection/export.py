"""Prediction export to the official Cityscapes-3D JSON format, on the host
in numpy (the port's own copy of mtt_tpu/detection/export.py).

Decoded S-frame boxes (centre, dimensions L W H, ZXY Euler rotation) become
V-frame centres and quaternions through the camera's extrinsics, written per
image as {"objects": [{"2d": {"modal", "amodal"}, "3d": {"center",
"dimensions", "rotation"}, "score", "label"}]}.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from mtt_tpu_torch.detection.cs_geometry import (EVAL_LABELS, box_s_to_v,
                                           euler_zxy_to_quat_s,
                                           k_multiplier, projection_matrix,
                                           quat_to_matrix)

_CORNER_SIGNS = np.array([[sx, sy, sz] for sx in (-0.5, 0.5)
                          for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)])
# 12 box edges = corner pairs whose sign index differs in exactly one bit
_BOX_EDGES = [(i, j) for i in range(8) for j in range(i + 1, 8)
              if bin(i ^ j).count("1") == 1]
_NEAR_PLANE = 0.25  # metres in front of the camera


def _amodal_box_2d(center_s, dims_lwh, quat_s, camera) -> List[float]:
    """Projection of the full 3D box onto the image (reference
    get_amodal_box_2d via Box3dImageTransform, det_tools.py:275-279):
    rotate the 8 local corners (x=L forward, y=W left, z=H up) into the
    S frame, permute S->camera axes, project with the intrinsics, and
    take the corner envelope. Corners behind the camera are handled by
    clipping each box edge against a near plane (geometrically exact for
    the in-front portion) rather than clamping corner depths, which
    previously inflated the envelope by ~1/z_clamp for partially-behind
    boxes; a box fully behind the plane yields a zero-area box."""
    local = _CORNER_SIGNS * np.asarray(dims_lwh, np.float64)
    pts_s = local @ quat_to_matrix(quat_s).T + np.asarray(center_s)
    cam = pts_s @ k_multiplier().T                      # camera axes
    z = cam[:, 2]
    pts = [cam[i] for i in range(8) if z[i] >= _NEAR_PLANE]
    for i, j in _BOX_EDGES:
        if (z[i] >= _NEAR_PLANE) != (z[j] >= _NEAR_PLANE):
            t = (_NEAR_PLANE - z[i]) / (z[j] - z[i])
            pts.append(cam[i] + t * (cam[j] - cam[i]))
    if not pts:
        return [0.0, 0.0, 0.0, 0.0]
    cam = np.asarray(pts)
    K = projection_matrix(camera["fx"], camera["fy"],
                          camera["u0"], camera["v0"])
    uvw = cam @ K.T
    uv = uvw[:, :2] / uvw[:, 2:3]
    x0, y0 = uv.min(axis=0)
    x1, y1 = uv.max(axis=0)
    return [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]


def bbox_to_json_objects(boxes3d: np.ndarray, bboxes2d: np.ndarray,
                         scores: np.ndarray, labels: np.ndarray,
                         valid: np.ndarray, camera: Dict) -> List[dict]:
    """Padded decode outputs -> list of official-format object dicts."""
    ext = np.asarray(camera["sensor_T_ISO_8855"], np.float64)
    out = []
    for i in range(len(scores)):
        if not bool(valid[i]):
            continue
        b = np.asarray(boxes3d[i], np.float64)
        q_s = euler_zxy_to_quat_s(b[6:9])
        c_v, q_v = box_s_to_v(b[:3], q_s, ext)
        x0, y0, x1, y1 = [float(x) for x in np.asarray(bboxes2d[i])]
        bb = [x0, y0, x1 - x0, y1 - y0]           # official xywh
        amodal = _amodal_box_2d(b[:3], b[3:6], q_s, camera)
        out.append({
            "2d": {"modal": bb, "amodal": amodal},
            "3d": {
                "center": [float(x) for x in c_v],
                "dimensions": [float(x) for x in b[3:6]],
                "rotation": [float(x) for x in q_v],
                "format": "CRS_ISO8855",
            },
            "score": float(scores[i]),
            "label": EVAL_LABELS[int(labels[i])],
        })
    return out


def save_image_predictions(save_dir: str, img_name: str, objects: List[dict]):
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, img_name + ".json"), "w") as f:
        json.dump({"objects": objects}, f)
