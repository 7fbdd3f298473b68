"""ctypes binding of the 2D IoU matrix of the host library
``native/iou3d.cpp`` (the port's counterpart of
mtt_tpu/detection/iou3d_native.py), with its plain version beside it. The
evaluator (``eval3d``) is its one caller; the library's rotated IoU and NMS
are not bound, as the port's decode runs its own on the device
(``detection/iou3d.py``).

At first use the library is compiled by ``g++`` from the checkout's
``native/iou3d.cpp`` into ``build/mtt_tpu_torch/<hash>/libiou3d.so`` (the
hash of the source, the flags and the compiler's version) by
``utils/native_build.py``; ``native/`` is never written. A build or load
that fails raises: no caller falls back to the plain version.
``impl="plain"`` asks for the plain version, in numpy.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from mtt_tpu_torch.utils import native_build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "iou3d.cpp"
BUILD_ROOT = native_build.BUILD_ROOT
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build() -> Path:
    """Compiles ``native/iou3d.cpp`` unless a library of the same source,
    flags and compiler exists; returns its path."""
    return native_build.build(SOURCE, "iou3d", CXX_FLAGS, BUILD_ROOT)


def _bind(handle: ctypes.CDLL) -> None:
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    n = ctypes.c_int64
    handle.iou_matrix_2d.argtypes = [dp, n, dp, n, dp]
    handle.iou_matrix_2d.restype = None


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    return native_build.load("iou3d", build, _bind)


def _rows(a, width: int) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"expected (n, {width}) boxes, got {a.shape}")
    return a


def _check_impl(impl):
    if impl not in (None, "native", "plain"):
        raise ValueError(f"impl must be 'native' or 'plain', got {impl!r}")


def iou_matrix_2d(a, b, impl=None) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy boxes -> (N, M) IoU in f64 (no +1-pixel
    convention: the caller shifts the max corners)."""
    _check_impl(impl)
    a, b = _rows(a, 4), _rows(b, 4)
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    if impl == "plain":
        area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(
            a[:, 3] - a[:, 1], 0)
        area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
            b[:, 3] - b[:, 1], 0)
        iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                        - np.maximum(a[:, None, 0], b[None, :, 0]), 0.0)
        ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                        - np.maximum(a[:, None, 1], b[None, :, 1]), 0.0)
        inter = iw * ih
        return inter / np.maximum(area_a[:, None] + area_b[None] - inter,
                                  1e-12)
    out = np.zeros((len(a), len(b)), np.float64)
    lib().iou_matrix_2d(a, len(a), b, len(b), out)
    return out

