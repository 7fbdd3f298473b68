"""Which runs take float32 on the card, and TF32 off for them.

The JAX package computes in float32 by default (its ``main.py`` defaults
``--dtype`` to float32; its inference CLI builds every model at float32).
The port's kernels have float32 forms for the TaskPrompter-ViT eval forward
(rows 1-6, and rows 13-14 through their wrappers), so the card runs that
forward at float32; training at float32, InvPT and TaskPrompter-Swin at
float32 are the later slices of ROADMAP.md item 1.14 and are refused before
anything is built. The CPU runs every model at float32 on the plain
versions; the gate is the card's.

A float32 run must not round its products to TF32: PyTorch's cuDNN
convolutions do by default (``torch.backends.cudnn.allow_tf32`` is True),
which touches the patch embedding, the decode's grouped convolutions and the
dense heads. ``exact_f32`` turns TF32 off for matmuls and convolutions for
the length of a call and puts the flags back after it. The port's own f32
GEMM and f32 attention core (csrc/gemm_f32.cu, csrc/attention_f32.cu) run on
the TF32 tensor cores as three products of split operands (3xTF32: x = hi +
lo, both TF32, and lo.hi + hi.lo + hi.hi in f32), which holds f32 accuracy
(relative RMS 1e-5 against the exact f32 plain versions); no kernel takes a
single TF32 pass, and library calls stay in full f32.
"""

from __future__ import annotations

import contextlib

import torch

from mtt_tpu_torch.kernels._build import F32_LATER


def check_card_dtype(p, run_mode: str, dtype: torch.dtype) -> None:
    """Raises ValueError unless the card runs config ``p`` (a
    ``create_config`` of a YAML experiment, or a config dict with its
    ``model`` and ``backbone`` keys) in ``run_mode`` ("train" or "infer")
    at ``dtype``: bfloat16 always; float32 for the TaskPrompter-ViT eval
    forward (``infer``) only, where its task decode has a float32 form: the
    windowed decode, or the one-launch kernel's tar and F (the split form
    past them is bfloat16 only). The refusals name ROADMAP.md item 1.14."""
    from mtt_tpu_torch.kernels.task_decode import task_decode_one_launch
    from mtt_tpu_torch.models.taskprompter import channel_windows
    from mtt_tpu_torch.models.wrappers import vit_taskprompter
    if dtype == torch.bfloat16:
        return
    if dtype != torch.float32:
        raise ValueError(f"the card runs bfloat16 or float32, got {dtype}")
    if run_mode != "infer":
        raise ValueError(f"training at float32 on the card: its backward "
                         f"kernels (rows 7 and 8) take bfloat16 only, their "
                         f"float32 forms are {F32_LATER}; train with "
                         f"--dtype bfloat16 (f32 master weights)")
    if not vit_taskprompter(p):
        raise ValueError(f"{p['model']} {p['backbone']} at float32 on the "
                         f"card: only the TaskPrompter-ViT eval forward has "
                         f"float32 kernels yet (InvPT and Swin: "
                         f"{F32_LATER}); run it with --dtype bfloat16")
    tar, fin = p["embed_dim"], p["final_embed_dim"]
    if channel_windows(p["chan_nheads"]) == (1, 1) and \
            not task_decode_one_launch(tar, fin):
        raise ValueError(f"tar {tar}, F {fin} at float32 on the card: the "
                         f"task decode takes them in its split form, whose "
                         f"float32 form is {F32_LATER}; run it with --dtype "
                         f"bfloat16")


@contextlib.contextmanager
def exact_f32(enabled: bool = True):
    """TF32 off for matmuls and cuDNN convolutions inside the block (when
    ``enabled``), the flags as they were after it."""
    if not enabled:
        yield
        return
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
