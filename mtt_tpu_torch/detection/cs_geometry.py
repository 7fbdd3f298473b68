"""Cityscapes-3D coordinate-system geometry on the host, in numpy (the
port's own copy of mtt_tpu/detection/cs_geometry.py).

The V (vehicle, ISO 8855) -> C (camera) -> S (sensor, image-oriented)
transform chain of cityscapesscripts' box3dImageTransform: quaternion
algebra, the axis permutation S = [[0, -1, 0], [0, 0, -1], [1, 0, 0]] C,
box poses in both directions, the pinhole projection matrix and the ZXY
Euler encoding of the rotation targets. The export turns S-frame detections
back into V-frame boxes for the official-format JSON with it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

EVAL_LABELS = ("car", "truck", "bus", "train", "motorcycle", "bicycle")
LABEL_TO_ID = {n: i for i, n in enumerate(EVAL_LABELS)}


def k_multiplier() -> np.ndarray:
    """Axis permutation C->S (box3dImageTransform.py:48-52)."""
    m = np.zeros((3, 3))
    m[0][1] = m[1][2] = -1.0
    m[2][0] = 1.0
    return m


def projection_matrix(fx, fy, u0, v0) -> np.ndarray:
    K = np.zeros((3, 3), np.float64)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2], K[2, 2] = fx, u0, fy, v0, 1.0
    return K


# ---- quaternion helpers (w, x, y, z) --------------------------------------

def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def quat_inv(q):
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    return np.array([w, -x, -y, -z]) / n


def quat_from_matrix(m) -> np.ndarray:
    r = Rotation.from_matrix(np.asarray(m, np.float64))
    x, y, z, w = r.as_quat()
    return np.array([w, x, y, z])


def quat_to_matrix(q) -> np.ndarray:
    w, x, y, z = q
    return Rotation.from_quat([x, y, z, w]).as_matrix()


def box_v_to_s(center_v, quat_v_wxyz, sensor_T_ISO_8855) -> Tuple[np.ndarray, np.ndarray]:
    """V-frame box pose -> S-frame (box3dImageTransform.py:178-206).

    center_S = Km @ (E @ [c;1]);  q_S = q(Km) * q(E) * q_V * q(Km)^-1
    with E the 3x4 extrinsic and Km the axis permutation.
    """
    E = np.asarray(sensor_T_ISO_8855, np.float64)
    Km = k_multiplier()
    c = E[:, :3] @ np.asarray(center_v, np.float64) + E[:, 3]
    q = quat_mul(quat_from_matrix(E[:3, :3]), np.asarray(quat_v_wxyz, np.float64))
    c = Km @ c
    qk = quat_from_matrix(Km)
    q = quat_mul(quat_mul(qk, q), quat_inv(qk))
    return c, q


def box_s_to_v(center_s, quat_s_wxyz, sensor_T_ISO_8855) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of box_v_to_s — used for exporting predictions
    (det_tools.py:249-303 bbox2json path)."""
    E = np.asarray(sensor_T_ISO_8855, np.float64)
    E4 = np.eye(4)
    E4[:3, :] = E
    E4inv = np.linalg.inv(E4)
    Km = k_multiplier()
    qk = quat_from_matrix(Km)
    c = Km.T @ np.asarray(center_s, np.float64)
    q = quat_mul(quat_mul(quat_inv(qk), np.asarray(quat_s_wxyz, np.float64)), qk)
    c = E4inv[:3, :3] @ c + E4inv[:3, 3]
    q = quat_mul(quat_from_matrix(E4inv[:3, :3]), q)
    return c, q


def rotation_s_to_euler_zxy(quat_s_wxyz) -> np.ndarray:
    """S-frame quaternion -> ZXY Euler angles (the reference's rotation
    target encoding, cityscapes3d.py:330-334)."""
    w, x, y, z = quat_s_wxyz
    return Rotation.from_quat([x, y, z, w]).as_euler("ZXY").astype(np.float32)


def euler_zxy_to_quat_s(euler_zxy) -> np.ndarray:
    r = Rotation.from_euler("ZXY", np.asarray(euler_zxy, np.float64))
    x, y, z, w = r.as_quat()
    return np.array([w, x, y, z])
