"""ctypes binding of the 2D IoU matrix of the host library
``native/iou3d.cpp`` (the port's counterpart of
mtt_tpu/detection/iou3d_native.py), with its plain version beside it. The
evaluator (``eval3d``) is its one caller; the library's rotated IoU and NMS
are not bound, as the port's decode runs its own on the device
(``detection/iou3d.py``).

At first use the library is compiled by ``g++`` from the checkout's
``native/iou3d.cpp`` into ``build/mtt_tpu_torch/<hash>/libiou3d.so`` (the
hash of the source, the flags and the compiler's version), as the CUDA
kernels are built (``kernels/_build.py``); ``native/`` is never written. A
build or load that fails raises: no caller falls back to the plain version.
``impl="plain"`` asks for the plain version, in numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "iou3d.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mtt_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH: "
                           "native/iou3d.cpp cannot be built")
    return cxx


def build() -> Path:
    """Compiles ``native/iou3d.cpp`` unless a library of the same source,
    flags and compiler exists; returns its path."""
    cxx = _compiler()
    version = subprocess.run([cxx, "-dumpfullversion", "-dumpversion"],
                             capture_output=True, text=True,
                             check=True).stdout.strip()
    h = hashlib.sha256(" ".join((cxx, version, platform.machine(),
                                 *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libiou3d.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # a per-process name, then an atomic rename: concurrent first uses
    tmp = out_dir / f"libiou3d.so.{os.getpid()}.tmp"
    run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{run.stderr}")
    os.replace(tmp, lib)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            n = ctypes.c_int64
            handle.iou_matrix_2d.argtypes = [dp, n, dp, n, dp]
            handle.iou_matrix_2d.restype = None
            _lib = handle
    return _lib


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

