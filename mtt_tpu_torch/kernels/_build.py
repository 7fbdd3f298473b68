"""Build, load and dispatch helpers for the port's CUDA kernels.

At first use every ``mtt_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked into one
shared library with a plain C interface, which is loaded with ``ctypes``. The
library lives under ``build/mtt_tpu_torch/<hash>/`` at the checkout's root and
is rebuilt when the hash of the sources or flags changes.

Each exported C function launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.

``COUNTS`` holds one plain integer per kernel entry point, bumped by the
wrappers in this package each time they launch their CUDA kernel and nowhere
else, so a caller can show that a forward really went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mtt_tpu_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libmtt_kernels.so"

COUNTS = {"layernorm": 0, "attention_cached": 0, "attention_emit": 0,
          "attention_qkv": 0, "attention_generic": 0, "attention_bwd": 0,
          "mlp_ln_res": 0, "mlp_fc": 0, "task_decode": 0, "head_up4": 0,
          "invpt_attention": 0, "invpt_tail": 0, "invpt_tail_head": 0,
          "window_attention": 0, "window_attention_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "mtt_layernorm_bf16": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    "mtt_qkv_proj_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mtt_attn_core_bf16": (_P, _P, _I, _I, _I, _F, _F, _I, _P),
    "mtt_attn_generic_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, *[_L] * 9,
                              _F, _P),
    "mtt_mlp_ln_res_bf16": (*[_P] * 10, _I, _I, _I, _F, _I, _P),
    "mtt_task_decode_bf16": (*[_P] * 10, *[_I] * 8, _P),
    "mtt_attn_bwd_bf16": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "mtt_mlp_fc_bf16": (*[_P] * 7, _I, _I, _I, _I, _P),
    "mtt_head_up4_bf16": (*[_P] * 9, *[_I] * 8, _P),
    "mtt_invpt_attention_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _F, _P),
    "mtt_invpt_tail_bf16": (*[_P] * 16, *[_I] * 8, _P),
    "mtt_window_attention_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L,
                                  _L, _L, _F, _P),
    "mtt_window_attention_bwd_bf16": (*[_P] * 9, _I, _I, _I, _I, *[_L] * 6,
                                      _I, _F, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the build this process ran, if any
build_log = ""           # nvcc's output (ptxas register/spill report)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def resolve_impl(impl, x: torch.Tensor) -> str:
    """'cuda' for a CUDA tensor, 'plain' for a CPU tensor. An explicit
    impl='plain' runs the plain version on any device; impl='cuda' on a
    tensor that is not on a CUDA device raises."""
    if impl is None:
        if x.device.type == "cuda":
            return "cuda"
        if x.device.type == "cpu":
            return "plain"
        raise ValueError(f"no kernel or plain version for device {x.device}")
    if impl not in ("cuda", "plain"):
        raise ValueError(f"impl must be 'cuda' or 'plain', got {impl!r}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError("impl='cuda' needs tensors on a CUDA device")
    return impl


def param_flags(*params: torch.Tensor) -> int:
    """Bit i set when ``params[i]`` is f32, clear when it is bf16: the
    kernels read a parameter in its stored dtype and widen it in registers,
    so no cast is launched."""
    flags = 0
    for i, t in enumerate(params):
        if t.dtype == torch.float32:
            flags |= 1 << i
        elif t.dtype != torch.bfloat16:
            raise TypeError(f"kernel parameters must be float32 or bfloat16, "
                            f"got {t.dtype}")
    return flags


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raises unless every tensor's data starts on a 16-byte boundary (the
    kernels' 16-byte loads and TMA's rule)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned data, got a "
                             f"tensor at offset {t.data_ptr() % 16} (a view "
                             f"into a larger tensor?)")


def check_gemm_widths(name: str, **widths: int) -> None:
    """Raises unless every named width is a positive multiple of 8: the
    shared GEMM (csrc/gemm.cu) reads its operands with TMA, whose row pitch
    must be a multiple of 16 bytes. The row count is free."""
    for key, n in widths.items():
        if n <= 0 or n % 8:
            raise ValueError(f"{name}: {key} must be a positive multiple "
                             f"of 8 (TMA reads rows whose pitch is a "
                             f"multiple of 16 bytes), got {key}={n}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compiles the sources into the shared library unless a library built
    from the same sources exists; returns its path."""
    global build_seconds, build_log
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    t0 = time.perf_counter()
    procs = []
    for src in cus:
        # per-process names: concurrent first uses must not share files
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for src, _, p in procs:
        out = p.communicate()[0].decode(errors="replace")
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    (out_dir / "build.log").write_text(build_log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            handle.mtt_error_string.argtypes = [ctypes.c_int]
            handle.mtt_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().mtt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream

