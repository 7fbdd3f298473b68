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
An entry point with a float32 form (``F32_FORMS``: rows 1-6, 13 and 14 of the
TaskPrompter-ViT eval forward) counts that form under ``<name>_f32``.
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
# the entry points with an f32 form count it under a counter of its own
F32_FORMS = ("layernorm", "attention_cached", "attention_emit",
             "attention_qkv", "attention_generic", "mlp_ln_res",
             "task_decode", "head_up4")
COUNTS.update({f"{k}_f32": 0 for k in F32_FORMS})
# where the float32 forms of the rest are planned
F32_LATER = "ROADMAP.md item 1.14"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "mtt_layernorm_bf16": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    "mtt_qkv_proj_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mtt_attn_core_bf16": (_P, _P, _I, _I, _I, _I, _F, _F, _I, _P),
    "mtt_attn_generic_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, *[_L] * 9,
                              _F, _P),
    "mtt_mlp_ln_res_bf16": (*[_P] * 10, _I, _I, _I, _F, _I, _P),
    "mtt_task_decode_bf16": (*[_P] * 10, *[_I] * 8, _P),
    "mtt_attn_bwd_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "mtt_mlp_fc_bf16": (*[_P] * 7, _I, _I, _I, _I, _P),
    "mtt_head_up4_bf16": (*[_P] * 9, *[_I] * 8, _P),
    "mtt_invpt_attention_bf16": (*[_P] * 9, *[_I] * 5, *[_L] * 12, _P, _F,
                                 _P),
    "mtt_invpt_attention_plan": (*[_I] * 5, _P),
    "mtt_invpt_tail_bf16": (*[_P] * 16, *[_I] * 8, _P),
    "mtt_window_attention_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L,
                                  _L, _L, _F, _P),
    "mtt_window_attention_bwd_bf16": (*[_P] * 9, _I, _I, _I, _I, *[_L] * 6,
                                      _I, _F, _P),
    "mtt_task_decode_split_bf16": (*[_P] * 11, *[_I] * 8, _P),
    "mtt_layernorm_f32": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    "mtt_qkv_proj_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "mtt_attn_core_f32": (_P, _P, _I, _I, _I, _I, _F, _F, _I, _P),
    "mtt_attn_generic_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, *[_L] * 9,
                             _F, _P),
    "mtt_mlp_ln_res_f32": (*[_P] * 10, _I, _I, _I, _F, _I, _P),
    "mtt_task_decode_f32": (*[_P] * 10, *[_I] * 7, _P),
    "mtt_head_up4_f32": (*[_P] * 9, *[_I] * 8, _P),
    # the f32 GEMM itself (csrc/gemm_f32.cu), which the f32 forms of rows
    # 1-2, 4 and 6 launch from C; bound here for the card's tests of its
    # contract
    "mtt_gemm_f32": (_P, _L, _P, _P, _L, _P, _P, _I, _I, _I, _I, _P),
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


def form(x: torch.Tensor, what: str) -> str:
    """The kernel form for the activation dtype of ``x``: "bf16" or "f32".
    Any other dtype raises: nothing is cast to reach a kernel."""
    if x.dtype == torch.bfloat16:
        return "bf16"
    if x.dtype == torch.float32:
        return "f32"
    raise TypeError(f"{what} takes bfloat16 or float32, got {x.dtype}")


def no_f32_form(what: str) -> TypeError:
    """The error of a kernel (or a shape of one) that has a bf16 form and no
    float32 form yet."""
    return TypeError(f"{what} takes bfloat16 only: its float32 form is "
                     f"{F32_LATER}")


def count(name: str, dtype: torch.dtype) -> None:
    """One launch of entry point ``name`` in its form for ``dtype``: the
    f32 forms count under ``<name>_f32``."""
    COUNTS[f"{name}_f32" if dtype == torch.float32 else name] += 1


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


def round8(n: int) -> int:
    """n rounded up to a multiple of 8: a row of 16-byte chunks of bf16, the
    pitch TMA and the kernels' 16-byte loads need."""
    return -(-n // 8) * 8


def pad_to(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``t`` zero-padded at the end of its last ``len(sizes)`` axes to
    ``sizes`` (``t`` itself where nothing is padded). A zero column of a
    product's K adds an exact 0 to every f32 sum, and the output columns a
    padded N adds are sliced off, so a kernel at the padded widths computes
    the function at the true widths (mtt_tpu/kernels/mlp.py:246-252 pads
    its MLP so)."""
    pads = []
    for have, want in zip(reversed(t.shape[-len(sizes):]), reversed(sizes)):
        pads += [0, want - have]
    return torch.nn.functional.pad(t, pads) if any(pads) else t


def run_padded_head(run, D: int, args: tuple, pad, unpad):
    """``run(*args)`` at the head dim ``D`` rounded up to ``DP``, a multiple
    of 8: ``unpad(run(*pad(DP)), DP)``, or ``run(*args)`` itself where D is
    one. ``pad`` gives the arguments with q, k and v (and the incoming
    gradient) zero-padded to DP, ``unpad`` drops the output's padded
    columns. A zero column adds an exact 0 to every score and product, so
    the outputs keep the bits of the function at D; the scale stays the
    caller's, for the true D. ``run`` is the kernel launch; the tests pass
    the plain versions."""
    DP = round8(D)
    if DP == D:
        return run(*args)
    return unpad(run(*pad(DP)), DP)


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

