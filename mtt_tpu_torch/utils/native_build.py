"""g++ builds of the port's host libraries, loaded through ctypes.

A library is compiled at first use from its C++ source in the checkout into
``build/mtt_tpu_torch/<hash>/lib<name>.so``, the hash being that of the
source, the flags, the compiler's version and the machine, as the CUDA
kernels are built (``kernels/_build.py``). A build or load that fails
raises: no caller falls back to a plain version. Used by
``detection/iou3d_native.py`` (``native/iou3d.cpp``) and ``data/image_io.py``
(``data/csrc/image_decode.cpp``).
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
from typing import Callable, Dict, Sequence

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mtt_tpu_torch"

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _compiler(source: Path) -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or $CXX) on PATH: {source} "
                           f"cannot be built")
    return cxx


def build(source: Path, name: str, flags: Sequence[str],
          root: Path = BUILD_ROOT) -> Path:
    """Compiles ``source`` into ``root/<hash>/lib<name>.so`` unless a library
    of the same source, flags and compiler exists; returns its path."""
    cxx = _compiler(source)
    version = subprocess.run([cxx, "-dumpfullversion", "-dumpversion"],
                             capture_output=True, text=True,
                             check=True).stdout.strip()
    h = hashlib.sha256(" ".join((cxx, version, platform.machine(),
                                 *flags)).encode())
    h.update(source.read_bytes())
    out_dir = root / h.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # a per-process name, then an atomic rename: concurrent first uses
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    run = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"building {source} failed:\n{run.stderr}")
    os.replace(tmp, lib)
    return lib


def load(name: str, build_fn: Callable[[], Path],
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library ``name``, built by ``build_fn`` at first use; ``bind``
    sets its functions' argument and result types once."""
    with _lock:
        if name not in _loaded:
            handle = ctypes.CDLL(str(build_fn()))
            bind(handle)
            _loaded[name] = handle
    return _loaded[name]
