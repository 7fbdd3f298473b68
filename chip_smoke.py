"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and nvcc; it exits non-zero, printing no result, when either is missing
or any phase fails.

Phases, in order (the seconds each took are printed):
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from mtt_tpu_torch/csrc (seconds printed);
  3. each of the 15 kernel entry points (the 14 TPU kernels; the multi-scale
     tail with and without its fused head), and the qkv projection of rows
     1-2 alone (one launch of the shared GEMM, against ``F.linear``), each
     against its plain PyTorch version at the ViT-L PASCAL shapes the main
     paths give it (row 13, attention over
     the packed qkv, fast and safe; row 14, attention over separate q, k, v,
     also at InvPT's cross shape with head dim 72; the task decode and the
     up4 head also at ViT-B's C = 768, the head also at NYUD's C = 768 for
     n = 1, 3, 40; both equal across two runs, their bit-equal share to
     the plain version printed, as for the multi-scale tail and the window
     attention), the earlier kernels again
     at the shapes the InvPT path adds (N = 1025, LayerNorm rows of 2880, MLP
     widths 576, 288, 144; the tail on NYUD's non-square grid), and the Swin
     path's at its shapes (window attention and its backward at the four
     Swin-B stages with and without the shift mask, both equal across two
     runs, the backward's dbias too, as are rows 7, 8, 10, 13 and 14 and
     the projection;
     LayerNorm rows of 128 to 2048 at eps 1e-5; MLP widths 128 to 1024, down
     to the 3 prompt rows),
     and the safe softmax of rows 1, 2 and 13 (at least 99% of the outputs
     bit-equal to the plain version: the max over all keys):
     error, tolerance in bf16 ulps, CUDA-event times of the kernel, the
     plain version, the library call or composition, and the bound of the
     card;
  4. ``attention_api``: a ViT-L ``Attention`` without LN, forward and
     backward, on LayerNormed bf16 tokens (8, 1029, 1024), and
     ``dot_product_attention`` over the q, k, v of its projection, held to f32
     (the backward at its forward point); the composed front half (the JAX
     package's fallback composition) and the fused one on the same weights,
     each against f32;
  5. the ViT-L PASCAL eval forward (5 tasks, CTR on, bf16, seeded random
     weights, batch 8 at 512x512) through ``predict``, with the factored up4
     head (the default) and with the dense head: launch counts, shapes,
     finiteness, relative RMS error against an f32 run of the same weights,
     imgs/s and peak memory;
  6. the InvPT-ViT-L PASCAL eval forward (ViT-L backbone with a cls token,
     InvPT decoder, 1x1 heads; batch 8 at 512x512, bf16, seeded random
     weights, full width and depth) through ``predict``, with the fused tail
     (the default) and with the head-fused tail: the same checks;
  7. the TaskPrompter-Swin-B Cityscapes-3D eval forward (semseg, depth and
     3D detection; one 1024x2048 image, bf16, seeded random weights, full
     width and depth) through ``predict`` with a fixed camera matrix: launch
     counts, shapes, finiteness, every 2D map and every detection level
     against an f32 run of the same weights, the decode of fixed size, ms per
     forward, imgs/s, decode ms and peak memory; the decode of a seeded head
     output that keeps many boxes, on the card against the CPU;
  8. ``nyud``: NYUD-v2 TaskPrompter-ViT-L (16 channel windows, no CTR,
     768-wide heads) and InvPT-ViT-L at batch 8 and 448x576, and PASCAL
     TaskPrompter-ViT-B at batch 8 and 512x512, through ``predict`` with
     seeded weights at full width and depth: the checks of phase 5, every
     map (InvPT: and every intermediate prediction) against an f32 run;
  9. ViT-L PASCAL training at the config's batch of 2 on seeded synthetic
     batches in bf16 with f32 master weights: the launch counts of one step,
     its gradients against an f32 plain run of the same weights, batch and
     drop-path masks held to the step's forward point (in all and per
     tensor, see GRAD_RMS_TOL), finite losses, moving parameters and BN
     statistics, ms per step, imgs/s and peak memory;
  10. TaskPrompter-Swin-B Cityscapes-3D training (semseg, depth and the
     FCOS3D detection loss; one 1024x2048 image a step, labels at 512x1024,
     drop-path 0.1, bf16 with f32 master weights, seeded synthetic batches):
     the same checks as phase 9, every detection loss component finite,
     and each window attention backward launch of the step against the
     plain backward on its own inputs.
The line before the last is the kernels JSON; the last line is the device JSON.

``python3 chip_smoke.py --profile`` runs none of these phases: after the
build it traces one eval forward of each model and one training step with
``torch.profiler`` and prints their wall time and device time by kernel group
(with ``--phases``, only those models').
``python3 chip_smoke.py --grad-diag`` runs none of them either: it prints how
far the Swin-B training step's bf16 gradients move between two runs on equal
inputs, and how far they sit from the f32 step's when both run free, by loss
part, at the two bf16 paths' forward points, and at the outputs of the
decodes and the detection head (``grad_diag``).
``--phases kernels,invpt`` (any subset of kernels, attention_api, eval,
invpt, swin, nyud, train, swin_train) runs only those phases and prints no
result lines: a quick look, not the check.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# ViT-L PASCAL shapes: eval forward (batch 8) and training (batch 2)
B, N, C, HEADS, HIDDEN, D = 8, 1029, 1024, 16, 4096, 64
T, TAR, FIN, G, S = 5, 300, 350, 16, 1024
GRID, NLOG = 32, 21          # up4 head: 32x32 patch grid, semseg's 21 logits
BT = 2                       # trBatch of configs/pascal/taskprompter_vitLp16.yml
IMG = 512
TRAIN_STEPS = 4
# InvPT-ViT-L PASCAL: cls token + 1024 patches; decoder width D = 512 + 64,
# 2 heads, kv length 5 tasks x 8 x 8 at every stage; per stage (query grid per
# task, stage width)
NV = 1025
INV_D, INV_H, INV_LK = 576, 2, 320
INV_STAGES = ((8, 576), (16, 288), (32, 144))
INV_TH = 128                 # the tail's output grid (8 h0)
NYUD_TH, NYUD_TW, NYUD_NLOG = 112, 144, 40   # 448x576 inputs, 40 classes
# NYUD-v2 TaskPrompter-ViT-L: a 28x36 patch grid, 768-wide heads for semseg
# (40 logits), normals (3), depth and edge (1)
NYUD_IMG, NYUD_GH, NYUD_GW, NYUD_C = (448, 576), 28, 36, 768
NYUD_T = 4
# InvPT's message-passing attention: q rows of 5 tasks x 32 x 32 at its last
# stage, k/v rows 5 x 8 x 8, head dim 72
GEN_Q, GEN_K, GEN_H, GEN_D = 5120, 320, 2, 72

# TaskPrompter-Swin-B Cityscapes-3D: one 1024x2048 image resized to 768x1536,
# patch 4; per stage (token grid, width, heads); 12x12 windows with 3 prompts
SW_IMG = (1024, 2048)
SW_STAGES = (((192, 384), 128, 4), ((96, 192), 256, 8), ((48, 96), 512, 16),
             ((24, 48), 1024, 32))
SW_WIN, SW_P, SW_D = 12, 3, 32
SW_M = SW_WIN * SW_WIN + SW_P
SW_OUT = (512, 1024)         # dd_label_map_size
SW_TRAIN_STEPS = 3           # trBatch 1: one checked step, two timed
SW_LEVELS = ((96, 192), (48, 96), (24, 48), (24, 48), (12, 24))
# Stuttgart camera calibration of the Cityscapes demo (public constants)
SW_CAM_K = ((2262.52, 0.0, 1096.98), (0.0, 2265.3017905988554, 513.137),
            (0.0, 0.0, 1.0))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# outside them, HBM bandwidth
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12

KERNEL_ROWS = {
    # name: (source, TPU kernel it replaces, counter, path it runs on)
    "layernorm": ("mtt_tpu_torch/csrc/layernorm.cu",
                  "mtt_tpu/kernels/layernorm.py:29", "layernorm", "eval"),
    "attention_cached": ("mtt_tpu_torch/csrc/attention.cu",
                         "mtt_tpu/kernels/attention.py:423",
                         "attention_cached", "eval"),
    "attention_emit": ("mtt_tpu_torch/csrc/attention.cu",
                       "mtt_tpu/kernels/attention.py:393", "attention_emit",
                       "eval"),
    "mlp_ln_res": ("mtt_tpu_torch/csrc/mlp.cu",
                   "mtt_tpu/kernels/mlp.py:355", "mlp_ln_res", "eval"),
    "task_decode": ("mtt_tpu_torch/csrc/task_decode.cu",
                    "mtt_tpu/kernels/task_decode.py:49", "task_decode",
                    "eval"),
    "head_up4": ("mtt_tpu_torch/csrc/head_up4.cu",
                 "mtt_tpu/kernels/head_up4.py:168", "head_up4", "eval"),
    "attention_qkv": ("mtt_tpu_torch/csrc/attention_generic.cu",
                      "mtt_tpu/kernels/attention.py:230", "attention_qkv",
                      "attention_api"),
    "attention_generic": ("mtt_tpu_torch/csrc/attention_generic.cu",
                          "mtt_tpu/kernels/attention.py:118",
                          "attention_generic", "attention_api"),
    "attention_bwd": ("mtt_tpu_torch/csrc/attention_bwd.cu",
                      "mtt_tpu/kernels/attention.py:603", "attention_bwd",
                      "train"),
    "mlp_fc": ("mtt_tpu_torch/csrc/mlp.cu", "mtt_tpu/kernels/mlp.py:69",
               "mlp_fc", "train"),
    "invpt_attention": ("mtt_tpu_torch/csrc/invpt_attention.cu",
                        "mtt_tpu/kernels/invpt_attention.py:35",
                        "invpt_attention", "invpt"),
    "invpt_tail": ("mtt_tpu_torch/csrc/invpt_tail.cu",
                   "mtt_tpu/kernels/invpt_tail.py:297", "invpt_tail",
                   "invpt"),
    "invpt_tail_head": ("mtt_tpu_torch/csrc/invpt_tail.cu",
                        "mtt_tpu/kernels/invpt_tail.py:297",
                        "invpt_tail_head", "invpt_head"),
    "window_attention": ("mtt_tpu_torch/csrc/window_attention.cu",
                         "mtt_tpu/kernels/attention.py:778",
                         "window_attention", "swin"),
    "window_attention_bwd": ("mtt_tpu_torch/csrc/window_attention_bwd.cu",
                             "mtt_tpu/kernels/attention.py:838",
                             "window_attention_bwd", "swin_train"),
}


def _time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median over ``reps`` runs of one call, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _ulp_tol(want, ulps: float) -> float:
    """``ulps`` bf16 units in the last place of the largest reference value
    (bf16 keeps 8 significant bits)."""
    return ulps * want.float().abs().max().item() * 2.0 ** -7


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes: float, tc_flops: float, f32_flops: float = 0.0):
    """Least time of the card for the work, ms: bytes at the HBM rate
    against tensor-core bf16 plus f32 operations at their peaks."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (tc_flops / PEAK_BF16 + f32_flops / PEAK_F32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _invpt_cases(rnd):
    """The kernel cases the InvPT path adds, in ``kernel_phase``'s format:
    rows 9 and 10 at the PASCAL ViT-L shapes (and row 10 on NYUD's non-square
    grid), and rows 1, 3, 4 and 8 at the shapes this path gives them."""
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention
    from mtt_tpu_torch.kernels.invpt_tail import (fused_ms_tail,
                                                  fused_ms_tail_head)
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp, fused_mlp_ln_res

    bf = torch.bfloat16
    f32 = torch.float32
    cases = {}

    # row 9 at the three stages; the first has no message
    for i, (g, dim) in enumerate(INV_STAGES):
        Lq, Dh = T * g * g, dim // INV_H
        q = rnd(B, INV_H, Lq, Dh)
        k, v = rnd(B, INV_H, INV_LK, Dh), rnd(B, INV_H, INV_LK, Dh)
        msg = rnd(B, INV_H, Lq, INV_LK, dtype=f32) if i else None
        w = rnd(INV_H, 2 * INV_H, std=0.5, dtype=f32) if i else None
        b = rnd(INV_H, std=0.1, dtype=f32) if i else None

        def call(impl, a=(q, k, v, msg, w, b), sc=dim ** -0.5):
            return invpt_fused_attention(*a, sc, impl=impl)

        def comp(a=(q, k, v, msg, w, b), sc=dim ** -0.5):
            q_, k_, v_, m_, w_, b_ = a
            fused = torch.matmul(q_, k_.transpose(-1, -2)).float() * sc
            if m_ is not None:
                fused = torch.einsum("hc,bcqk->bhqk", w_,
                                     torch.cat([fused, m_], 1)) \
                    + b_[None, :, None, None]
            return torch.matmul(torch.softmax(fused, -1).to(bf), v_), fused

        nel = B * INV_H * Lq * INV_LK
        name = "invpt_attention" if i == 2 else f"invpt_attention@stage{i}"
        cases[name] = (
            call, (4, 0.01),
            "out: scores, mix and softmax in f32 and p rounded to bf16 at the "
            "same point, f32 sums in another order can flip that rounding; "
            "fused (f32 on both sides): exact bf16 products summed in f32 in "
            "another order, 0.01 bf16 ulps = 8e-5 of max |fused|",
            None, comp,
            _nbytes(q, k, v, q) + nel * 4 + (_nbytes(msg, w, b) if i else 0),
            4.0 * nel * Dh, (8.0 if i else 1.0) * nel + 5.0 * nel)

    # row 10, both forms, at the PASCAL grid and on NYUD's 14x18 grid
    def tail_case(batch, th, tw, n, label):
        xs = tuple(rnd(batch, th // f, tw // f, INV_D, std=0.5)
                   for f in (8, 4, 2))
        kc = rnd(3, 3, INV_D, INV_D, std=(9 * INV_D) ** -0.5)
        inv = rnd(INV_D, std=0.1, mean=1.0, dtype=f32)
        addv = rnd(INV_D, std=0.1, dtype=f32)
        wh = rnd(INV_D, n, std=INV_D ** -0.5)
        bh = rnd(n, std=0.1, dtype=f32)
        kc_oihw = kc.permute(3, 2, 0, 1).contiguous()
        wh_oihw = wh.t()[:, :, None, None].contiguous()

        def dense(head):
            acc = sum(F.interpolate(x.permute(0, 3, 1, 2), size=(th, tw),
                                    mode="bilinear", align_corners=False)
                      for x in xs)
            y = F.relu(F.conv2d(acc, kc_oihw, padding=1)
                       * inv.to(bf)[:, None, None]
                       + addv.to(bf)[:, None, None])
            return F.conv2d(y, wh_oihw, bh.to(bf)) if head else y

        px = batch * sum((th // f) * (tw // f) for f in (8, 4, 2))
        out_px = batch * th * tw
        # bf16 x bf16 on the tensor cores: Gm (9 taps) and the width mix (6
        # nonzero taps of the shifted bilinear bands per output, per scale;
        # the kernel also multiplies the 3 zeros); in f32: the height mix (6
        # nonzero taps per scale), the sum over scales and the affine + ReLU
        tcf = 2.0 * px * INV_D * 9 * INV_D + 12.0 * 3 * tw * INV_D * batch \
            * sum(th // f for f in (8, 4, 2))
        f32f = (3 * 12.0 + 2.0 + 4.0) * out_px * INV_D
        common = _nbytes(*xs, kc, inv, addv)
        cases[f"invpt_tail{label}"] = (
            lambda impl: fused_ms_tail(xs, kc, inv, addv, th, tw, impl=impl),
            4, "Gm and the width mix are rounded to bf16 at the same points; "
               "f32 sums in another order can flip a rounding",
            None, lambda: dense(False), common + out_px * INV_D * 2, tcf,
            f32f)
        cases[f"invpt_tail_head{label}"] = (
            lambda impl: fused_ms_tail_head(xs, kc, inv, addv, wh, bh, th, tw,
                                            impl=impl),
            4, "as invpt_tail, and the activation is rounded to bf16 at the "
               "same point before the 1x1; the logits are f32 until the "
               "wrapper's last rounding",
            None, lambda: dense(True),
            common + _nbytes(wh, bh) + out_px * n * 2,
            tcf + 2.0 * out_px * INV_D * n, f32f)

    tail_case(B, INV_TH, INV_TH, NLOG, "")
    tail_case(2, NYUD_TH, NYUD_TW, NYUD_NLOG, "@nyud")

    # rows 1 and 4 at the cls-token sequence length
    x = rnd(B, NV, C)
    gamma = rnd(C, std=0.1, mean=1.0, dtype=f32)
    beta = rnd(C, std=0.1, dtype=f32)
    wqkv, bqkv = rnd(3 * C, C, std=C ** -0.5), rnd(3 * C, std=0.1)
    w1, b1 = rnd(HIDDEN, C, std=C ** -0.5), rnd(HIDDEN, std=0.1)
    w2, b2 = rnd(C, HIDDEN, std=HIDDEN ** -0.5), rnd(C, std=0.1)
    M = B * NV

    def attn_lib():
        xn = F.layer_norm(x, (C,), gamma.to(bf), beta.to(bf), 1e-6)
        q, k, v = F.linear(xn, wqkv, bqkv).view(B, NV, HEADS, 3, D).unbind(3)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return o.transpose(1, 2).reshape(B, NV, C)

    cases["attention_cached@N1025"] = (
        lambda impl: fused_attention_ln_qkv(x, gamma, beta, wqkv, bqkv, HEADS,
                                            impl=impl),
        4, "as attention_cached, at the first odd sequence length",
        None, attn_lib, _nbytes(x, gamma, beta, wqkv, bqkv, x),
        2.0 * M * C * 3 * C + 4.0 * B * HEADS * NV * NV * D, 0.0)
    cases["mlp_ln_res@N1025"] = (
        lambda impl: fused_mlp_ln_res(x, gamma, beta, w1, b1, w2, b2,
                                      impl=impl),
        4, "as mlp_ln_res", None,
        lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(
            x, (C,), gamma.to(bf), beta.to(bf), 1e-6), w1, b1)), w2, b2),
        _nbytes(x, gamma, beta, w1, b1, w2, b2, x), 4.0 * M * C * HIDDEN, 0.0)

    # row 3 on the task-merged stage norms, row 8 at the decoder widths, both
    # at the stages' block resolution (twice the query grid)
    for g, dim in INV_STAGES:
        g, Cm = 2 * g, T * dim
        xm = rnd(B, g, g, Cm)
        gm_ = rnd(Cm, std=0.1, mean=1.0, dtype=f32)
        bm_ = rnd(Cm, std=0.1, dtype=f32)
        cases[f"layernorm@C{Cm}"] = (
            lambda impl, a=(xm, gm_, bm_): fused_layernorm(*a, impl=impl),
            1, "as layernorm, on rows of the task-merged width",
            lambda a=(xm, gm_, bm_): F.layer_norm(
                a[0], a[0].shape[-1:], a[1].to(bf), a[2].to(bf), 1e-6),
            None, _nbytes(xm, gm_, bm_, xm), 0.0, 8.0 * xm.numel())
        hid = 4 * dim
        xd = rnd(B, T, g, g, dim)
        wa, ba = rnd(hid, dim, std=dim ** -0.5), rnd(hid, std=0.1)
        wb, bb = rnd(dim, hid, std=hid ** -0.5), rnd(dim, std=0.1)
        cases[f"mlp_fc@C{dim}"] = (
            lambda impl, a=(xd, wa, ba, wb, bb): fused_mlp(*a, impl=impl),
            4, "as mlp_fc, at an InvPT stage's width", None,
            lambda a=(xd, wa, ba, wb, bb): F.linear(
                F.gelu(F.linear(a[0], a[1], a[2])), a[3], a[4]),
            _nbytes(xd, wa, ba, wb, bb, xd), 4.0 * xd.numel() * hid, 0.0)
        # row 4 on the same rows and weights: its GEMMs at the decoder
        # widths, where N ends inside a tile and K inside a 64-deep stage
        gd = rnd(dim, std=0.1, mean=1.0, dtype=f32)
        bd = rnd(dim, std=0.1, dtype=f32)
        cases[f"mlp_ln_res@C{dim}"] = (
            lambda impl, a=(xd, gd, bd, wa, ba, wb, bb): fused_mlp_ln_res(
                *a, impl=impl),
            4, "as mlp_ln_res, at an InvPT stage's width", None,
            lambda a=(xd, gd, bd, wa, ba, wb, bb): a[0] + F.linear(F.gelu(
                F.linear(F.layer_norm(a[0], a[0].shape[-1:], a[1].to(bf),
                                      a[2].to(bf), 1e-6), a[3], a[4])),
                a[5], a[6]),
            _nbytes(xd, gd, bd, wa, ba, wb, bb, xd), 4.0 * xd.numel() * hid,
            0.0)
    return cases


def _swin_cases(rnd):
    """The kernel cases the Swin path adds, in ``kernel_phase``'s format: rows
    11 and 12 at the four Swin-B stages with and without the shift mask, rows
    3 and 8 at the shapes this path gives them."""
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    from mtt_tpu_torch.kernels.window_attention import \
        fused_window_attention_qkv

    bf = torch.bfloat16
    f32 = torch.float32
    dev = torch.device("cuda")
    cases = {}
    M, D = SW_M, SW_D
    for i, ((gh, gw), dim, H) in enumerate(SW_STAGES):
        BW = gh * gw // (SW_WIN * SW_WIN)
        # q, k, v as the block hands them over: the packed qkv
        qkv = rnd(BW, M, 3, H, D)
        q, k, v = qkv.unbind(2)
        bias = torch.zeros(H, M, M, device=dev)
        bias[:, SW_P:, SW_P:] = rnd(H, M - SW_P, M - SW_P, std=0.5, dtype=f32)
        mask = torch.zeros(BW, M, M, device=dev)
        mask[:, SW_P:, SW_P:] = torch.where(
            rnd(BW, M - SW_P, M - SW_P, dtype=f32) < -0.5, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
        for m in (mask, None):
            def call(impl, a=(qkv, bias, m), nW=BW):
                return fused_window_attention_qkv(*a, D ** -0.5, nW,
                                                  impl=impl)

            both = (bias[None] + (0.0 if m is None else m[:, None])).to(bf)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa(a=(qt, kt, vt, both)):
                return F.scaled_dot_product_attention(
                    a[0], a[1], a[2], attn_mask=a[3]).transpose(1, 2)

            def comp(a=(qt, kt, vt, bias, m)):
                s_ = torch.matmul(a[0], a[1].transpose(-1, -2)).float() \
                    * D ** -0.5 + a[3][None]
                if a[4] is not None:
                    s_ = s_ + a[4][:, None]
                return torch.matmul(torch.softmax(s_, -1).to(bf),
                                    a[2]).transpose(1, 2)

            nel = BW * H * M * M
            # stage 2 is the only one whose shifted blocks reach the kernel
            # (the others' second block is a tap block)
            name = "window_attention" if (i == 2 and m is not None) else \
                f"window_attention@stage{i}" + ("+mask" if m is not None
                                                else "")
            cases[name] = (
                call, 2, "logits and softmax in f32, p rounded to bf16 at "
                         "the same point and divided by the f32 row sum "
                         "after p.v; f32 sums in another order can flip a "
                         "rounding",
                sdpa, comp,
                4 * BW * M * H * D * 2 + _nbytes(bias)
                + (_nbytes(m) if m is not None else 0),
                4.0 * nel * D, 6.0 * nel)
            cases[name.replace("window_attention", "window_attention_bwd")] = \
                _wattn_bwd_case(q, k, v, bias, m, rnd(BW, M, H, D), BW)

    # row 3 at eps 1e-5: the stages' token rows, PatchMerging's 4C rows and
    # the 3 prompt rows; row 8 at the stage widths, patches and prompts
    ln_shapes = [(gh * gw, dim) for (gh, gw), dim, _ in SW_STAGES] \
        + [(gh * gw // 4, 4 * dim) for (gh, gw), dim, _ in SW_STAGES[:3]] \
        + [(SW_P, SW_STAGES[0][1])]
    for rows, Cn in ln_shapes:
        xm = rnd(1, rows, Cn)
        gm_ = rnd(Cn, std=0.1, mean=1.0, dtype=f32)
        bm_ = rnd(Cn, std=0.1, dtype=f32)
        cases[f"layernorm@swin{rows}x{Cn}"] = (
            lambda impl, a=(xm, gm_, bm_): fused_layernorm(*a, 1e-5,
                                                           impl=impl),
            1, "as layernorm, eps 1e-5",
            lambda a=(xm, gm_, bm_): F.layer_norm(
                a[0], a[0].shape[-1:], a[1].to(bf), a[2].to(bf), 1e-5),
            None, _nbytes(xm, gm_, bm_, xm), 0.0, 8.0 * xm.numel())
    mlp_shapes = [(gh * gw, dim) for (gh, gw), dim, _ in SW_STAGES] \
        + [(SW_P, SW_STAGES[0][1]), (SW_P, SW_STAGES[3][1])]
    for rows, dim in mlp_shapes:
        hid = 4 * dim
        xd = rnd(1, rows, dim)
        wa, ba = rnd(hid, dim, std=dim ** -0.5), rnd(hid, std=0.1)
        wb, bb = rnd(dim, hid, std=hid ** -0.5), rnd(dim, std=0.1)
        cases[f"mlp_fc@swin{rows}x{dim}"] = (
            lambda impl, a=(xd, wa, ba, wb, bb): fused_mlp(*a, impl=impl),
            4, "as mlp_fc, at a Swin-B stage's width", None,
            lambda a=(xd, wa, ba, wb, bb): F.linear(
                F.gelu(F.linear(a[0], a[1], a[2])), a[3], a[4]),
            _nbytes(xd, wa, ba, wb, bb, xd), 4.0 * xd.numel() * hid, 0.0)
    return cases


def _wattn_bwd_case(q, k, v, bias, m, g, nW):
    """Row 12 on one stage's inputs, in ``kernel_phase``'s format: the
    kernel's (dq, dk, dv, dbias) against the plain backward's. The library
    call is SDPA's backward with the bias and mask merged into one (BW, H, M,
    M) bf16 mask that requires grad, plus the sum of that mask's gradient
    over the windows for dbias; the composition (c) the autograd backward of
    the plain torch attention."""
    from mtt_tpu_torch.kernels.window_attention import (
        window_attention_bwd_cuda, window_attention_bwd_plain)

    bf = torch.bfloat16
    scale = SW_D ** -0.5
    BW, M, H, D = q.shape

    def call(impl):
        if impl == "cuda":
            dqkv, db = window_attention_bwd_cuda(q, k, v, bias, m, g, scale,
                                                 nW)
            return (*dqkv.unbind(2), db)
        return window_attention_bwd_plain(q, k, v, bias, m, g, scale, nW)

    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g))
    merged = (bias[None] + (0.0 if m is None else m[:, None])).to(bf)
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt, merged)]

    def sdpa_bwd():
        d = torch.autograd.grad(sd_out, leaves, gt, retain_graph=True)
        return d[:3], d[3].float().sum(0)

    try:
        sd_out = F.scaled_dot_product_attention(*leaves[:3],
                                                attn_mask=leaves[3])
        sdpa_bwd()
    except RuntimeError as e:     # no backend differentiates the mask
        print(f"[kernel] SDPA's backward gives no gradient of a float mask "
              f"({str(e)[:120]}): library_ms is null, the composition (c) "
              f"stands in", flush=True)
        sdpa_bwd = None
    cl = [t.detach().requires_grad_() for t in (qt, kt, vt, bias)]
    logits = torch.matmul(cl[0], cl[1].transpose(-1, -2)).float() * scale \
        + cl[3][None]
    if m is not None:
        logits = logits + m[:, None]
    cout = torch.matmul(torch.softmax(logits, -1).to(bf), cl[2])

    def comp_bwd():
        return torch.autograd.grad(cout, cl, gt, retain_graph=True)

    nel = BW * H * M * M
    return (call, (4, 4, 4, 0.0128),
            "dq, dk, dv: dl and pn are rounded to bf16 at the same points, "
            "f32 sums in another order can flip a rounding; dbias (f32 on "
            "both sides, summed over the windows in another order): 1e-4 of "
            "max |dbias|",
            sdpa_bwd, comp_bwd,
            7 * BW * M * H * D * 2 + 2 * _nbytes(bias)
            + (_nbytes(m) if m is not None else 0),
            # q k^T, dp = g v^T, dq, dk, dv: five M x M x D products
            10.0 * nel * D, 12.0 * nel)


def _api_cases(rnd):
    """The kernel cases of rows 13 and 14 and of row 6 at NYUD's width, in
    ``kernel_phase``'s format: row 13 on the ViT-L packed qkv (8, 1029,
    3072), fast and safe softmax; row 14 at a ViT-L self-attention shape
    (8, 1029, 16, 64) and at InvPT's cross shape (q (8, 5120, 2, 72), k/v
    (8, 320, 2, 72)); row 6 on NYUD's 28x36 grid at C = 768 for the n of its
    task heads (depth and edge 1, normals 3, semseg 40). The library call of
    rows 13-14 is SDPA on the same tensors (strided views of the packed
    qkv), of row 6 the dense cuDNN head."""
    from mtt_tpu_torch.kernels.attention import (fused_attention,
                                                 fused_attention_qkv)
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head

    bf = torch.bfloat16
    cases = {}
    qkv = rnd(B, N, 3 * C)

    def sdpa_packed():
        q, k, v = (t.transpose(1, 2)
                   for t in qkv.view(B, N, HEADS, 3, D).unbind(3))
        o = F.scaled_dot_product_attention(q, k, v)
        return o.transpose(1, 2).reshape(B, N, C)

    for safe in (False, True):
        cases["attention_qkv" + ("_safe" if safe else "")] = (
            lambda impl, s=safe: fused_attention_qkv(qkv, HEADS, impl=impl,
                                                     safe=s),
            4, "P is rounded to bf16 at the same point; f32 sums in another "
               "order can flip that rounding" + (
                   "; the max over all keys first, so at least 99% of the "
                   "outputs are bit-equal" if safe else ""),
            sdpa_packed, None, _nbytes(qkv) + B * N * C * 2,
            4.0 * B * HEADS * N * N * D, 0.0)

    def generic_case(nq, nk, h, d):
        q, k, v = rnd(B, nq, h, d), rnd(B, nk, h, d), rnd(B, nk, h, d)

        def lib():
            o = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            return o.transpose(1, 2)

        return (lambda impl: fused_attention(q, k, v, impl=impl), 4,
                "the max over all keys, then P rounded to bf16 at the same "
                "point; f32 sums in another order can flip that rounding",
                lib, None, _nbytes(q, k, v, q), 4.0 * B * h * nq * nk * d,
                0.0)

    cases["attention_generic"] = generic_case(N, N, HEADS, D)
    cases["attention_generic@cross"] = generic_case(GEN_Q, GEN_K, GEN_H,
                                                    GEN_D)

    gh, gw, cn = NYUD_GH, NYUD_GW, NYUD_C
    xh = rnd(B, gh, gw, cn, std=0.5)
    kc = rnd(3, 3, cn, cn, std=(9 * cn) ** -0.5)
    inv = rnd(cn, std=0.1, mean=1.0, dtype=torch.float32)
    addv = rnd(cn, std=0.1, dtype=torch.float32)
    kc_oihw = kc.permute(3, 2, 0, 1).contiguous()
    for n in (1, 3, NYUD_NLOG):
        kp = rnd(cn, n, std=cn ** -0.5)

        def head_lib(kp=kp):
            up = F.interpolate(xh.permute(0, 3, 1, 2), scale_factor=4,
                               mode="bilinear", align_corners=False)
            y = F.conv2d(up, kc_oihw, padding=1)
            y = F.gelu(y * inv.to(bf)[:, None, None]
                       + addv.to(bf)[:, None, None])
            return F.conv2d(y, kp.t()[:, :, None, None].contiguous())

        cases[f"head_up4@nyud_n{n}"] = (
            lambda impl, kp=kp: fused_up4_head(xh, kc, inv, addv, kp,
                                               impl=impl),
            4, "as head_up4, at NYUD's width: the mix kernel walks slabs of "
               "192 channels and adds each slab's logits to the first's in "
               "f32",
            None, head_lib,
            _nbytes(xh, kc, inv, addv, kp) + B * 16 * gh * gw * n * 4,
            2.0 * B * gh * gw * cn * 9 * cn + 12.0 * B * gh * 3 * cn * 4 * gw
            + 2.0 * B * 16 * gh * gw * cn * n,
            (12.0 + 25.0) * B * 16 * gh * gw * cn)
    return cases


def kernel_phase():
    """Each kernel against its plain version on the same seeded inputs."""
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_cuda,
                                                 attn_core_bwd_plain,
                                                 fused_attention_ln_qkv,
                                                 qkv_proj_cuda,
                                                 qkv_proj_plain)
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp, fused_mlp_ln_res
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                + mean).to(dtype)

    M = B * N
    x = rnd(B, N, C)
    gamma = rnd(C, std=0.1, mean=1.0, dtype=torch.float32)
    beta = rnd(C, std=0.1, dtype=torch.float32)
    wqkv = rnd(3 * C, C, std=C ** -0.5)
    bqkv = rnd(3 * C, std=0.1)
    w1 = rnd(HIDDEN, C, std=C ** -0.5)
    b1 = rnd(HIDDEN, std=0.1)
    w2 = rnd(C, HIDDEN, std=HIDDEN ** -0.5)
    b2 = rnd(C, std=0.1)
    xs = rnd(B, S, C)
    a = rnd(B, T, S, G)
    cw = rnd(B, T, C, dtype=torch.float32)
    ws = rnd(T, TAR, C, std=C ** -0.5)
    wc = rnd(T, TAR, C, std=C ** -0.5)
    bs = rnd(T, TAR, std=0.1)
    bc = rnd(T, TAR, std=0.1)
    wf = rnd(T, FIN, 2 * TAR, std=(2 * TAR) ** -0.5)
    bfin = rnd(T, FIN, std=0.1)
    # up4 head: x (8, 32, 32, 350), conv3x3 (HWIO), folded BN, 1x1
    xh = rnd(B, GRID, GRID, FIN, std=0.5)
    kc = rnd(3, 3, FIN, FIN, std=(9 * FIN) ** -0.5)
    inv = rnd(FIN, std=0.1, mean=1.0, dtype=torch.float32)
    addv = rnd(FIN, std=0.1, dtype=torch.float32)
    kp = rnd(FIN, NLOG, std=FIN ** -0.5)
    # training shapes: batch 2 of the joint stream
    xt = rnd(BT, N, C)
    qkv_t = rnd(BT, N, 3 * C)
    g_t = rnd(BT, N, C)

    def attn_lib():
        xn = F.layer_norm(x, (C,), gamma.to(bf), beta.to(bf), 1e-6)
        q, k, v = F.linear(xn, wqkv, bqkv).view(B, N, HEADS, 3, D).unbind(3)
        o = F.scaled_dot_product_attention(q.transpose(1, 2),
                                           k.transpose(1, 2),
                                           v.transpose(1, 2))
        return o.transpose(1, 2).reshape(B, N, C)

    # the dense cuDNN head of the same function: upsample, conv3x3 (bias 0),
    # BN affine, GELU, 1x1
    def head_lib_of(xh, kc, inv, addv, kp):
        kc_oihw = kc.permute(3, 2, 0, 1).contiguous()
        kp_oihw = kp.t()[:, :, None, None].contiguous()

        def lib():
            up = F.interpolate(xh.permute(0, 3, 1, 2), scale_factor=4,
                               mode="bilinear", align_corners=False)
            y = F.conv2d(up, kc_oihw, padding=1)
            y = F.gelu(y * inv.to(bf)[:, None, None]
                       + addv.to(bf)[:, None, None])
            return F.conv2d(y, kp_oihw)
        return lib

    def head_bound(xh, kc, inv, addv, kp):
        # bf16 x bf16 products on the tensor cores: Gm (9 taps), the width
        # mix (6 nonzero taps of the shifted bilinear bands per output, as
        # the TPU stencil counts them) and the 1x1; in f32: the height mix
        # (6 nonzero taps) and the affine + GELU (~25 flops)
        b_, gh, gw, cin = xh.shape
        d, n = kp.shape
        out_px = b_ * 16 * gh * gw
        return (_nbytes(xh, kc, inv, addv, kp) + out_px * n * 4,
                2.0 * b_ * gh * gw * cin * 9 * d + 12.0 * b_ * gh * 3 * d * 4 * gw
                + 2.0 * out_px * d * n, (12.0 + 25.0) * out_px * d)

    def decode_case(xs, a, cw, ws, bs, wc, bc, wf, bfin, reason):
        b_, s_, c_ = xs.shape
        t_, tar, _ = ws.shape
        fin = wf.shape[1]
        g_ = a.shape[-1]

        def lib():
            xt_ = xs[:, None]
            f = torch.einsum("btsc,trc->btsr",
                             xt_ * a.repeat_interleave(c_ // g_, -1) + xt_,
                             ws) + bs[None, :, None]
            fc = torch.einsum("btsc,trc->btsr",
                              xt_ * cw.to(bf)[:, :, None] + xt_, wc) \
                + bc[None, :, None]
            return torch.einsum("btsr,tfr->btsf", torch.cat([f, fc], -1),
                                wf) + bfin[None, :, None]

        return (lambda impl: fused_task_decode(xs, a, cw, ws, bs, wc, bc, wf,
                                               bfin, impl=impl),
                4, reason, None, lib,
                _nbytes(xs, a, cw, ws, bs, wc, bc, wf, bfin)
                + b_ * s_ * t_ * fin * 2,
                2.0 * b_ * t_ * s_ * (2 * c_ * tar + 2 * tar * fin), 0.0)

    # SDPA's backward on the same q, k, v and dOut
    q5 = qkv_t.view(BT, N, HEADS, 3, D)
    qkv_sd = [q5[:, :, :, i].transpose(1, 2).detach().requires_grad_()
              for i in range(3)]
    sd_out = F.scaled_dot_product_attention(*qkv_sd)
    sd_g = g_t.view(BT, N, HEADS, D).transpose(1, 2)

    def attn_bwd_lib():
        return torch.autograd.grad(sd_out, qkv_sd, sd_g, retain_graph=True)

    def split3(t):
        v = t.view(*t.shape[:-1], HEADS, 3, D)
        return tuple(v[..., i, :] for i in range(3))

    mmf = 2.0 * M  # rows x 2 flops per multiply-add
    # the qkv projection of rows 1-2 alone, on LayerNormed rows
    xn = F.layer_norm(x, (C,), gamma.to(bf), beta.to(bf), 1e-6)
    cases = {
        # name: (call, ulps, reason, library call or None, library
        #        composition or None, bytes, tensor-core flops, f32 flops)
        "layernorm": (
            lambda impl: fused_layernorm(x, gamma, beta, impl=impl),
            1, "same f32 statistics; only the summation order differs, "
               "which can move a value across one bf16 rounding boundary",
            lambda: F.layer_norm(x, (C,), gamma.to(bf), beta.to(bf), 1e-6),
            None, _nbytes(x, gamma, beta, x), 0.0, 8.0 * M * C),
        "attention_cached": (
            lambda impl: fused_attention_ln_qkv(x, gamma, beta, wqkv, bqkv,
                                                HEADS, impl=impl),
            4, "qkv and P are rounded to bf16 at the same points, but f32 "
               "sums in another order can flip one rounding, which moves "
               "the output by a few ulps",
            None, attn_lib, _nbytes(x, gamma, beta, wqkv, bqkv, x),
            mmf * C * 3 * C + 4.0 * B * HEADS * N * N * D, 0.0),
        "attention_emit": (
            lambda impl: fused_attention_ln_qkv(x, gamma, beta, wqkv, bqkv,
                                                HEADS, need_qkv=True,
                                                impl=impl),
            4, "as attention_cached, for out, qkv and xn",
            None, attn_lib,
            _nbytes(x, gamma, beta, wqkv, bqkv, x, x) + M * 3 * C * 2,
            mmf * C * 3 * C + 4.0 * B * HEADS * N * N * D, 0.0),
        "qkv_proj": (
            lambda impl: (qkv_proj_cuda if impl == "cuda" else
                          qkv_proj_plain)(xn, wqkv, bqkv),
            1, "one product summed in f32 and rounded once on both sides; "
               "a sum in another order can flip that rounding",
            lambda: F.linear(xn, wqkv, bqkv), None,
            _nbytes(xn, wqkv, bqkv) + M * 3 * C * 2, mmf * C * 3 * C, 0.0),
        "mlp_ln_res": (
            lambda impl: fused_mlp_ln_res(x, gamma, beta, w1, b1, w2, b2,
                                          impl=impl),
            4, "xn and the GELU output are rounded to bf16 at the same "
               "points; f32 sums in another order can flip a rounding",
            None,
            lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(
                x, (C,), gamma.to(bf), beta.to(bf), 1e-6), w1, b1)), w2, b2),
            _nbytes(x, gamma, beta, w1, b1, w2, b2, x),
            2 * mmf * C * HIDDEN, 0.0),
        "task_decode": decode_case(
            xs, a, cw, ws, bs, wc, bc, wf, bfin,
            "x*a+x, f and fc are rounded to bf16 at the same points; f32 "
            "sums in another order can flip a rounding"),
        "head_up4": (
            lambda impl: fused_up4_head(xh, kc, inv, addv, kp, impl=impl),
            4, "Gm, the width mix and the GELU output are rounded to bf16 "
               "at the same points; f32 sums in another order can flip a "
               "rounding; the logits are f32 on both sides",
            None, head_lib_of(xh, kc, inv, addv, kp),
            *head_bound(xh, kc, inv, addv, kp)),
        "attention_bwd": (
            lambda impl: (attn_core_bwd_cuda if impl == "cuda"
                          else attn_core_bwd_plain)(qkv_t, g_t, HEADS,
                                                    D ** -0.5),
            4, "per q, k and v slot: dl and p are rounded to bf16 at the "
               "same points, f32 sums in another order can flip a rounding",
            attn_bwd_lib, None, _nbytes(qkv_t, g_t, qkv_t),
            # S, dP, dV, dQ, dK: five N x N x D products per (item, head)
            10.0 * BT * HEADS * N * N * D, 0.0),
        "mlp_fc": (
            lambda impl: fused_mlp(xt, w1, b1, w2, b2, impl=impl),
            4, "the GELU output is rounded to bf16 at the same point; f32 "
               "sums in another order can flip a rounding",
            None, lambda: F.linear(F.gelu(F.linear(xt, w1, b1)), w2, b2),
            _nbytes(xt, w1, b1, w2, b2, xt), 4.0 * BT * N * C * HIDDEN, 0.0),
    }
    # row 3 with bf16 parameters, as a bf16 model stores them (read as
    # stored, no cast); row 4 at ViT-B's width
    gb, bb_ = gamma.to(bf), beta.to(bf)
    cases["layernorm@bf16_params"] = (
        lambda impl: fused_layernorm(x, gb, bb_, impl=impl),
        1, "as layernorm", lambda: F.layer_norm(x, (C,), gb, bb_, 1e-6),
        None, _nbytes(x, gb, bb_, x), 0.0, 8.0 * M * C)
    xb = rnd(B, N, 768)
    pb = [rnd(768, std=0.1, mean=1.0), rnd(768, std=0.1),
          rnd(3072, std=0.1), rnd(768, std=0.1)]
    w1b, w2b = rnd(3072, 768, std=768 ** -0.5), rnd(768, 3072,
                                                      std=3072 ** -0.5)
    cases["mlp_ln_res@C768"] = (
        lambda impl: fused_mlp_ln_res(xb, pb[0], pb[1], w1b, pb[2], w2b,
                                      pb[3], impl=impl),
        4, "as mlp_ln_res, at ViT-B's width, bf16 parameters", None,
        lambda: xb + F.linear(F.gelu(F.linear(F.layer_norm(
            xb, (768,), pb[0], pb[1], 1e-6), w1b, pb[2])), w2b, pb[3]),
        _nbytes(xb, *pb, w1b, w2b, xb), 4.0 * M * 768 * 3072, 0.0)
    # rows 5 and 6 at ViT-B's width (the decode's x (8, 1024, 768); the
    # head's (8, 32, 32, 768), semseg's 21 logits)
    xs_b = rnd(B, S, 768)
    wsb, wcb = (rnd(T, TAR, 768, std=768 ** -0.5) for _ in range(2))
    cases["task_decode@C768"] = decode_case(
        xs_b, a, rnd(B, T, 768, dtype=torch.float32), wsb, bs, wcb, bc, wf,
        bfin, "as task_decode, at ViT-B's width")
    hb = (rnd(B, GRID, GRID, 768, std=0.5),
          rnd(3, 3, 768, 768, std=(9 * 768) ** -0.5),
          rnd(768, std=0.1, mean=1.0, dtype=torch.float32),
          rnd(768, std=0.1, dtype=torch.float32),
          rnd(768, NLOG, std=768 ** -0.5))
    cases["head_up4@C768"] = (
        lambda impl: fused_up4_head(*hb, impl=impl),
        4, "as head_up4, at ViT-B's width (slabs of 192 channels)", None,
        head_lib_of(*hb), *head_bound(*hb))
    cases.update(_invpt_cases(rnd))
    cases.update(_swin_cases(rnd))
    cases.update(_api_cases(rnd))
    results = {}
    for name, (call, ulps, reason, lib, comp, nbytes, tcf, f32f) in \
            cases.items():
        got = call("cuda")
        want = call("plain")
        torch.cuda.synchronize()
        if name == "attention_bwd":
            got, want = split3(got), split3(want)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, tol = 0.0, 0.0
        per_out = ulps if isinstance(ulps, tuple) else (ulps,) * len(got)
        for g_, w_, u_ in zip(got, want, per_out):
            if g_.shape != w_.shape or g_.dtype != w_.dtype \
                    or not torch.isfinite(g_).all():
                raise RuntimeError(f"{name}: bad kernel output "
                                   f"{tuple(g_.shape)} {g_.dtype} vs "
                                   f"{tuple(w_.shape)} {w_.dtype}")
            e, t = _max_err(g_, w_), _ulp_tol(w_, u_)
            if e > t:
                raise RuntimeError(f"{name}: max |kernel - plain| = {e:.4g} "
                                   f"exceeds {t:.4g} ({u_} bf16 ulps)")
            err, tol = max(err, e), max(tol, t)
        del got, want
        kms = _time_ms(lambda: call("cuda"))
        pms = _time_ms(lambda: call("plain"), reps=3, warmup=1)
        lms = _time_ms(lib) if lib else None
        cms = _time_ms(comp) if comp else None
        bms, bby = _bound(nbytes, tcf, f32f)
        results[name] = dict(max_abs_err=err, tol=tol, kernel_ms=kms,
                             plain_ms=pms, library_ms=lms,
                             library_composition_ms=cms, bound_ms=bms,
                             bound_by=bby)
        print(f"[kernel] {name}: max_abs_err={err:.6g} tol={tol:.6g} "
              f"({ulps} bf16 ulps of max |plain|: {reason}) "
              f"kernel_ms={kms:.4f} plain_ms={pms:.4f} library_ms={lms} "
              f"library_composition_ms={cms} bound_ms={bms:.4f} ({bby})",
              flush=True)

    # the window attention backward sums dbias over the windows in a fixed
    # order, and rows 5, 7, 11, 13 and 14, the up4 head and the InvPT tail
    # (which add their slabs' logits in a fixed order) and the shared GEMM
    # (row 8, the qkv projection) sum without atomics: two runs give the
    # same bits
    for name, case in cases.items():
        if name.startswith(("window_attention", "attention_bwd",
                            "attention_generic", "attention_qkv", "mlp_fc",
                            "qkv_proj", "task_decode", "head_up4",
                            "invpt_tail")):
            a, b = case[0]("cuda"), case[0]("cuda")
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise RuntimeError(f"{name}: two runs differ")
    print("[kernel] window_attention_bwd: dq, dk, dv and dbias equal across "
          "two runs at every stage, with and without the mask; "
          "attention_bwd (dqkv), attention_generic (self and cross shapes), "
          "attention_qkv (fast and safe), mlp_fc (every shape), qkv_proj, "
          "task_decode, head_up4, invpt_tail (both forms, PASCAL and NYUD) "
          "and window_attention (every stage, with and without the mask) "
          "equal across two runs",
          flush=True)

    # the safe softmax (every training forward) takes the max over ALL keys
    # before it rounds P to bf16, as the TPU kernels do: at least 99% of the
    # outputs bit-equal to the plain version, which an online (running) max
    # misses (tests/test_torch_cuda.py holds the same share). Row 13 against
    # its plain version; the front halves (rows 1-2) within 4 ulps of theirs,
    # and their core against the plain core on the qkv their own LN and
    # projection kernels made (those roundings move more bits than the
    # softmax)
    from mtt_tpu_torch.kernels.attention import attention_qkv_plain
    from mtt_tpu_torch.kernels.layernorm import layernorm_cuda

    def share(got, want):
        return (got == want).float().mean().item()

    # the shared GEMM's one rounding against the plain stage's; rows 5, 6
    # and 10 (the heads' logits are f32 sums, whose order differs) and 11
    for name in ("qkv_proj", "mlp_fc", "task_decode", "task_decode@C768",
                 "head_up4", "head_up4@C768", "head_up4@nyud_n40",
                 "invpt_tail", "invpt_tail_head", "invpt_tail@nyud",
                 "invpt_tail_head@nyud", "window_attention",
                 "window_attention@stage0", "window_attention@stage0+mask"):
        sh = share(cases[name][0]("cuda"), cases[name][0]("plain"))
        results[name]["bit_equal_share"] = sh
        print(f"[kernel] {name}: bit-equal share {sh:.6f} of the outputs",
              flush=True)
    qkv_k = qkv_proj_cuda(layernorm_cuda(x, gamma, beta, 1e-6), wqkv, bqkv)
    core_want = attention_qkv_plain(qkv_k, HEADS, D ** -0.5, True)
    qkv_case = cases["attention_qkv_safe"][0]
    checks = {"attention_qkv_safe": (qkv_case("cuda"), qkv_case("plain"),
                                     None)}
    for tag, need in (("attention_cached_safe", False),
                      ("attention_emit_safe", True)):
        got, want = (fused_attention_ln_qkv(x, gamma, beta, wqkv, bqkv, HEADS,
                                            need_qkv=need, impl=impl,
                                            safe=True)
                     for impl in ("cuda", "plain"))
        checks[tag] = (got, want, core_want)
    for tag, (got, want, core) in checks.items():
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        e, t = 0.0, 0.0
        for g_, w_ in zip(got, want):
            e_, t_ = _max_err(g_, w_), _ulp_tol(w_, 4)
            if e_ > t_:
                raise RuntimeError(f"{tag}: {e_:.4g} > {t_:.4g}")
            e, t = max(e, e_), max(t, t_)
        sh = share(got[0], want[0] if core is None else core)
        if sh < 0.99:
            raise RuntimeError(f"{tag}: {sh:.4%} of the outputs bit-equal "
                               f"to the plain version, under 99%")
        print(f"[kernel] {tag}: max_abs_err={e:.6g} tol={t:.6g} (4 bf16 "
              f"ulps); bit-equal share {sh:.6f} (at least 0.99: the max over "
              f"all keys)", flush=True)
    return results


def _expected(**launches) -> dict:
    """Launch counts of one run: the named counters, every other one 0."""
    from mtt_tpu_torch.kernels import _build
    return {**dict.fromkeys(_build.COUNTS, 0), **launches}


def expected_eval(mode: str) -> dict:
    return _expected(layernorm=5, attention_cached=20, attention_emit=4,
                     mlp_ln_res=24, task_decode=4,
                     head_up4=5 if mode == "factored" else 0)


def expected_train() -> dict:
    """One training step: blocks 1..23 run under drop-path (LN + plain MLP),
    block 0 the fused half-block; 24 attention backwards; no up4 head
    kernel."""
    return _expected(layernorm=23 + 4 + 1, attention_cached=20,
                     attention_emit=4, attention_bwd=24, mlp_ln_res=1,
                     mlp_fc=23, task_decode=4)


def expected_invpt(tail_head: bool, tasks: int = T) -> dict:
    """One InvPT eval forward: 24 ViT blocks (attention + MLP half-block);
    LayerNorm = the ViT's final norm + norm1 and norm2 of the 3 decoder
    stages + their 3 task-merged stage norms; one plain MLP and one
    message-passing attention per stage; one tail launch per task."""
    return _expected(layernorm=1 + 6 + 3, attention_cached=24, mlp_ln_res=24,
                     mlp_fc=3, invpt_attention=3,
                     **{"invpt_tail_head" if tail_head else "invpt_tail":
                        tasks})


def expected_attention_api() -> dict:
    """``attention_api_phase``: the module without LN and the composed front
    half launch row 13 once each, ``dot_product_attention`` row 14 once, the
    fused front half its cached kernel once; the backwards are torch."""
    return _expected(attention_qkv=2, attention_generic=1,
                     attention_cached=1)


def expected_nyud_taskprompter() -> dict:
    """NYUD TaskPrompter-ViT-L: the PASCAL forward's blocks, no task decode
    launch (16 channel windows take the windowed torch composition) and one
    up4 head per task."""
    return _expected(layernorm=5, attention_cached=20, attention_emit=4,
                     mlp_ln_res=24, head_up4=NYUD_T)


def expected_vitb() -> dict:
    """TaskPrompter-ViT-B PASCAL: 12 blocks with taps after blocks 3, 6 and
    9 and the last one."""
    return _expected(layernorm=5, attention_cached=8, attention_emit=4,
                     mlp_ln_res=12, task_decode=4, head_up4=T)


def expected_swin() -> dict:
    """One Swin-B eval forward, depths (2, 2, 18, 2): the last block of each
    stage is a tap block and takes the composition, the other 20 the window
    attention kernel (12 unshifted, 8 shifted, all of those in stage 2); 4
    LayerNorms (norm1 and norm2, on the tokens and on the prompts) and 2 MLPs
    a block, one of each less in the last block, which drops the prompt
    update; the patch norm, 3 PatchMerging norms and the final norm."""
    blocks = sum(d for d in (2, 2, 18, 2))
    return _expected(window_attention=blocks - 4, mlp_fc=2 * blocks - 1,
                     layernorm=4 * blocks - 1 + 1 + 3 + 1)


def expected_swin_train() -> dict:
    """One Swin-B training step: the forward's launches (drop-path changes
    no route) and one window attention backward for each of the 20 blocks
    on the kernel; the MLP and LayerNorm backwards are torch."""
    return {**expected_swin(), "window_attention_bwd": 20}


# The eval forward is held against an f32 run of the same (bf16-valued)
# weights on the plain versions, by the relative RMS error per task,
# ||logits - f32|| / ||f32||. Both bf16 paths (kernels, and the plain versions
# in bf16) round at the same points, yet each sat 0.016-0.039 from the f32 run
# with the dense head on an H100: 24 blocks of random weights amplify bf16
# rounding, and which roundings flip differs between the two paths, so
# neither is the other's exact reference. The bound is 2.5x the largest of
# those; wiring faults (a wrong head order, a dropped bias or task) give
# errors of order 1. The kernels themselves are held to ulps in phase 3.
FORWARD_RMS_TOL = 0.1
# The training step's gradients against an f32 run on the plain versions of
# the same weights, batch and drop-path masks, linearised where the run under
# test ran its forward: every module of the f32 run outputs the value that
# the same module call output in the run under test (``_ForwardPoint``), and
# the gradient of its own f32 computation. So it is the f32 backward at the
# run's forward point, and the comparison (relative RMS over all gradients,
# sqrt(sum ||g - g32||^2 / sum ||g32||^2)) sees the backward's rounding and
# wiring, kernels included, not how far bf16 moved the forward. Run free,
# Swin-B's step is no check of the backward: on an H100 its train-mode
# forward reached the detection head 0.05-0.24 from f32 (batch-statistics
# BN over the 3ddet decode's large-mean activations magnifies the error
# upstream of it about tenfold at stage 3), the head's ReLUs then pass or
# stop a cotangent on the side bf16 chose, and the kernel and plain bf16
# steps sat 0.40 and 1.0-1.6 from the free f32 step, while the f32 step
# itself moved 6% of its detection gradients under a 2^-9 scaling of the
# image (``--grad-diag``). The free distance is printed, not bounded. On
# ViT-L the kernels measured 0.062 free-running and the plain versions in
# bf16 0.060: bf16 rounding carried through 24 blocks of random weights. The
# bound is 2.5x that, as for the forward; a wiring fault (a missing
# cotangent, a transposed weight gradient) gives order 1.
GRAD_RMS_TOL = 0.15
# Per tensor, the same bound holds, divided by the cancellation rho of the
# sum that forms the tensor's gradient at the run's forward point
# (``_cancellation``): batch-statistics BN makes the loss nearly blind to a
# common scale or shift of its input, so the gradients of the parameters
# that set one (the CTR and decode biases ahead of BN) are small sums of
# large terms, and the bf16 error of the terms comes out magnified by
# 1 / rho. rho covers the bias of every F.linear and F.conv2d call and the
# weight of every F.linear call, summed over the calls; any other tensor is
# held to GRAD_RMS_TOL itself. Gradients under 1e-6 of all are left out:
# the biases ahead of batch-statistics BN, whose exact gradient is zero, and
# a few that these random weights leave near zero. The checked step and its
# references run on deterministic library algorithms (``_deterministic``):
# on an H100 the default ones moved Swin-B's bf16 gradients by 0.0147
# relative RMS from one run to the next on equal inputs, and a prompt channel
# projection's bias by a third of itself (``--grad-diag``).


def _rel_rms(got: dict, ref: dict) -> float:
    num = sum(((got[k].float() - ref[k].float()) ** 2).sum() for k in ref)
    den = sum((ref[k].float() ** 2).sum() for k in ref)
    return (num / den).sqrt().item()


def _eval_model():
    """The ViT-L PASCAL eval model (factored head) and its batch of 8
    512x512 images (``_serve_model``)."""
    from mtt_tpu_torch.train import PASCAL_VITL
    return _serve_model(PASCAL_VITL, 1, (IMG, IMG))


def _vitl_trainer():
    """The ViT-L PASCAL trainer (seeded) and its synthetic dataset."""
    from mtt_tpu_torch.train import PASCAL_VITL, make_trainer
    return make_trainer(PASCAL_VITL, seed=2, device=torch.device("cuda"))


def eval_phase():
    """The ViT-L PASCAL eval forward through the kernels, factored head then
    dense head (``_serve_check``); returns the launch counts of each."""
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet

    factored, x = _eval_model()
    dense = TaskPrompterNet(
        factored.tasks, {t: factored.get_submodule(f"head_{t}").linear_pred
                         .out_channels for t in factored.tasks}, (IMG, IMG),
        "TaskPrompter_vitL", head_up4="dense", device=torch.device("cuda"),
        dtype=torch.bfloat16).eval()
    dense.load_state_dict(factored.state_dict())
    return {mode: _serve_check(f"eval {mode}", "TaskPrompter-ViT-L PASCAL",
                               model, x, expected_eval(mode))
            for mode, model in (("factored", factored), ("dense", dense))}


def _invpt_model(tail_head: bool = False):
    """The InvPT-ViT-L PASCAL eval model and its batch of 8 512x512 images
    (``_serve_model``)."""
    from mtt_tpu_torch.models.wrappers import INVPT_PASCAL_VITL
    return _serve_model(INVPT_PASCAL_VITL, 3, (IMG, IMG), tail_head=tail_head)


def invpt_phase():
    """The InvPT-ViT-L PASCAL eval forward through the kernels, with the fused
    tail then with the head-fused tail (``_serve_check``, which also holds
    the intermediate predictions); returns the launch counts of each."""
    tail, x = _invpt_model()
    head, _ = _invpt_model(tail_head=True)
    head.load_state_dict(tail.state_dict())
    return {mode: _serve_check(f"invpt {mode}", "InvPT-ViT-L PASCAL", model,
                               x, expected_invpt(mode == "tail_head"))
            for mode, model in (("tail", tail), ("tail_head", head))}


def attention_api_phase():
    """The module API of rows 13 and 14 at ViT-L width: ``Attention`` without
    LN, forward and backward, on LayerNormed bf16 tokens (8, 1029, 1024) with
    seeded weights, and ``dot_product_attention`` over the q, k and v of the
    same projection (strided views of its output); then the composed front
    half (``attention_ln_qkv_composed``, the JAX package's fallback) and the
    fused one on the same weights. Returns the launch counts."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.attention import (attention_ln_qkv_composed,
                                                 attention_qkv_bwd_plain,
                                                 fused_attention_ln_qkv)
    from mtt_tpu_torch.kernels.layernorm import layernorm_plain
    from mtt_tpu_torch.models.layers import (Attention,
                                             dot_product_attention,
                                             init_weights)

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    attn = Attention(C, HEADS, device=dev, dtype=bf)
    init_weights(attn, gen)
    with torch.no_grad():
        attn.qkv.bias.copy_(0.1 * torch.randn(3 * C, generator=gen,
                                              device=dev))
    gamma = 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev)
    beta = 0.1 * torch.randn(C, generator=gen, device=dev)
    xr = torch.randn(B, N, C, generator=gen, device=dev).to(bf)
    x = layernorm_plain(xr, gamma, beta).requires_grad_()
    g = torch.randn(B, N, C, generator=gen, device=dev).to(bf)
    w, b = attn.qkv.weight.detach(), attn.qkv.bias.detach()
    # the packed qkv and the attention output, kept with their gradients to
    # hold the backward at its forward point
    seen = {}

    def keep(name, t):
        t.retain_grad()
        seen[name] = t

    hooks = [attn.qkv.register_forward_hook(
                 lambda m, i, o: keep("qkv", o)),
             attn.proj.register_forward_pre_hook(
                 lambda m, i: keep("att", i[0]))]
    torch.cuda.synchronize()
    _build.reset_counts()
    out = attn(x)
    out.backward(g)
    q, k, v = seen["qkv"].detach().view(B, N, HEADS, 3, D).unbind(3)
    with torch.no_grad():
        o_dpa = dot_product_attention(q, k, v)
        o_comp = attention_ln_qkv_composed(xr, gamma, beta, w, b, HEADS)
        o_fused = fused_attention_ln_qkv(xr, gamma, beta, w, b, HEADS)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    for h in hooks:
        h.remove()
    print(f"[attention_api] ViT-L Attention without LN, batch {B} x {N} "
          f"tokens x {C}, bf16; launches {counts}", flush=True)
    if counts != expected_attention_api():
        raise RuntimeError(f"attention_api launch counts {counts} != "
                           f"{expected_attention_api()}")

    def rel(got, ref):
        return ((got.float() - ref).norm() / ref.norm()).item()

    # f32 references on the plain versions: full-precision products
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        ref_out = copy.deepcopy(attn).float()(x.detach().float(),
                                              impl="plain")
        ref_dpa = dot_product_attention(q.float(), k.float(), v.float(),
                                        impl="plain")
        ref_ln = fused_attention_ln_qkv(xr.float(), gamma, beta, w.float(),
                                        b.float(), HEADS, impl="plain")
        # the backward at the run's forward point: the f32 VJP of the run's
        # own bf16 qkv and attention-output cotangent, closed through the
        # qkv weight in f32
        ref_dqkv = attention_qkv_bwd_plain(
            seen["qkv"].detach().float(), seen["att"].grad.float(), HEADS,
            D ** -0.5)
        ref_dx = torch.matmul(ref_dqkv, w.float())
    errs = {"forward": (rel(out, ref_out), FORWARD_RMS_TOL),
            "dot_product_attention": (rel(o_dpa, ref_dpa), FORWARD_RMS_TOL),
            "composed front half": (rel(o_comp, ref_ln), FORWARD_RMS_TOL),
            "fused front half": (rel(o_fused, ref_ln), FORWARD_RMS_TOL),
            "dqkv at the forward point": (rel(seen["qkv"].grad, ref_dqkv),
                                          GRAD_RMS_TOL),
            "dx at the forward point": (rel(x.grad, ref_dx), GRAD_RMS_TOL)}
    for what, (e, tol) in errs.items():
        print(f"[attention_api] {what}: relative RMS error against f32 "
              f"{e:.5g} (tol {tol})", flush=True)
        if not e <= tol:
            raise RuntimeError(f"attention_api {what}: {e:.4g} > {tol}")
    print(f"[attention_api] composed against fused front half: relative RMS "
          f"{rel(o_comp, o_fused.float()):.5g}", flush=True)
    x.grad = None
    fwd = _time_ms(lambda: attn(x))
    fwd_plain = _time_ms(lambda: attn(x, impl="plain"), reps=3, warmup=1)
    step = _time_ms(lambda: attn(x).backward(g))
    print(f"[attention_api] module forward {fwd:.4f} ms through the kernel, "
          f"{fwd_plain:.4f} ms plain; forward + backward {step:.4f} ms",
          flush=True)
    return counts


def _serve_model(p: dict, seed: int, size, **kw):
    """A model built by ``build_model`` from config dict ``p`` (bf16, seeded
    random weights, full width and depth; ``kw`` to ``build_model``) and a
    seeded batch of 8 preprocessed images of ``size``."""
    from mtt_tpu_torch.inference import preprocess
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(p, img_size=size, device=dev, dtype=torch.bfloat16,
                        **kw).eval()
    init_weights(model, gen)
    rgb = torch.randint(0, 256, (B, *size, 3), generator=gen, device=dev)
    return model, preprocess(rgb)


def _serve_check(tag: str, title: str, model, x, want: dict) -> dict:
    """One eval forward through ``predict``: launch counts, shapes,
    finiteness, every map (and InvPT's intermediate predictions) against an
    f32 run of the same weights, imgs/s and peak memory. Returns the
    launch counts."""
    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.kernels import _build

    size = tuple(x.shape[1:3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    logits, preds = predict(model, x)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] {title}, {n_params / 1e6:.1f} M params, batch {B} at "
          f"{size[0]}x{size[1]} bf16; launches {counts}", flush=True)
    if counts != want:
        raise RuntimeError(f"{tag} launch counts {counts} != {want}")
    plain, plain_preds = predict(model, x, impl="plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_model = copy.deepcopy(model).float()
    ref, ref_preds = predict(ref_model, x, impl="plain")
    del ref_model
    for t in model.tasks:
        n = model.get_submodule(f"head_{t}").linear_pred.out_channels
        maps = [(t, logits[t], ref[t], plain[t])]
        if "inter_preds" in logits:
            maps.append((f"inter_preds.{t}", logits["inter_preds"][t],
                         ref["inter_preds"][t], plain["inter_preds"][t]))
        for what, k, r, p in maps:
            if k.shape != (B, *size, n) or not torch.isfinite(k).all():
                raise RuntimeError(f"{tag} {what}: logits {tuple(k.shape)} "
                                   f"or non-finite")
            r = r.float()
            rms_k = ((k.float() - r).norm() / r.norm()).item()
            rms_p = ((p.float() - r).norm() / r.norm()).item()
            line = (f"[{tag}] {what}: vs the f32 run: relative RMS error "
                    f"kernels {rms_k:.5g} (tol {FORWARD_RMS_TOL}), plain "
                    f"bf16 {rms_p:.5g}")
            if what in ("semseg", "human_parts"):
                agree = [(q[t] == ref_preds[t]).float().mean().item()
                         for q in (preds, plain_preds)]
                line += (f"; argmax agreement with f32: kernels "
                         f"{agree[0]:.5f}, plain bf16 {agree[1]:.5f}")
            print(line, flush=True)
            if not rms_k <= FORWARD_RMS_TOL:
                raise RuntimeError(f"{tag} {what}: kernel forward is "
                                   f"{rms_k:.4g} (relative RMS) from the f32 "
                                   f"run, over {FORWARD_RMS_TOL}")
        if preds[t].shape[:3] != (B, *size) or \
                not torch.isfinite(preds[t].float()).all():
            raise RuntimeError(f"{tag} {t}: bad prediction "
                               f"{tuple(preds[t].shape)}")
    del logits, preds, plain, plain_preds, ref, ref_preds
    ms = _time_ms(lambda: predict(model, x), reps=5, warmup=1)
    plain_ms = _time_ms(lambda: predict(model, x, impl="plain"), reps=3,
                        warmup=1)
    print(f"[{tag}] forward+postprocess {ms:.2f} ms = {B / ms * 1e3:.2f} "
          f"imgs/s through the kernels; plain versions {plain_ms:.2f} ms = "
          f"{B / plain_ms * 1e3:.2f} imgs/s; peak memory of the first "
          f"forward {peak_gib:.2f} GiB", flush=True)
    return counts


def _serve_paths():
    """(tag, title, config, seed, input size, expected launches) of the
    serving paths of ``nyud_phase``."""
    from mtt_tpu_torch.models.wrappers import (NYUD_INVPT_VITL,
                                               NYUD_TASKPROMPTER_VITL,
                                               PASCAL_TASKPROMPTER_VITB)
    return (("nyud_taskprompter", "TaskPrompter-ViT-L NYUD-v2 (16 channel "
             "windows, no CTR, 768-wide heads)", NYUD_TASKPROMPTER_VITL, 5,
             NYUD_IMG, expected_nyud_taskprompter()),
            ("nyud_invpt", "InvPT-ViT-L NYUD-v2", NYUD_INVPT_VITL, 6,
             NYUD_IMG, expected_invpt(False, NYUD_T)),
            ("pascal_vitb", "TaskPrompter-ViT-B PASCAL",
             PASCAL_TASKPROMPTER_VITB, 7, (IMG, IMG), expected_vitb()))


def nyud_phase():
    """NYUD-v2 TaskPrompter-ViT-L and InvPT-ViT-L at batch 8 and 448x576,
    and PASCAL TaskPrompter-ViT-B at batch 8 and 512x512, each through
    ``predict`` (``_serve_check``). Returns the launch counts by path."""
    counts = {}
    for tag, title, p, seed, size, want in _serve_paths():
        model, x = _serve_model(p, seed, size)
        counts[tag] = _serve_check(tag, title, model, x, want)
        del model, x
        torch.cuda.empty_cache()
    return counts


def _swin_model():
    """The TaskPrompter-Swin-B Cityscapes-3D eval model (bf16, seeded random
    weights, full width and depth), one seeded preprocessed 1024x2048 image
    and the camera matrix. The deformable convs' offset convs, which the
    initialiser leaves at zero, get small random weights, so that the
    sampling positions are fractional."""
    from mtt_tpu_torch.inference import preprocess
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import CS3D_SWINB, build_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    model = build_model(CS3D_SWINB, device=dev, dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    with torch.no_grad():
        for name, w in model.named_parameters():
            if name.endswith("offset_mask.weight"):
                w.copy_(torch.randn(w.shape, generator=gen, device=dev)
                        * 0.3 * (w[0].numel()) ** -0.5)
    rgb = torch.randint(0, 256, (1, *SW_IMG, 3), generator=gen, device=dev)
    return model, preprocess(rgb), torch.tensor(SW_CAM_K, device=dev)


def _det_levels(out):
    """{name: tensor} of the detection head's per-level outputs."""
    return {f"3ddet.{name}{i}": t
            for name, lvls in zip(("cls", "bbox", "dir", "ctr"), out)
            for i, t in enumerate(lvls)}


def _decode_check(det_cfg, K):
    """The box decode on the card against the same decode on the CPU, on a
    seeded head output at the Swin-B levels that keeps many boxes: class
    logits under score_thr everywhere but at 400 random points, where one
    class's logit and the centerness are raised. The valid counts must be
    equal and every valid box must have a CPU box of the same label within
    1e-5 of its score and 1e-4 (relative to the largest value) of its 3D
    box, 2D box and centre: the same f32 function, whose exp, sigmoid and
    trigonometry differ between the two devices' libraries in the last
    bits; the order of slots whose scores tie to those bits may differ."""
    from mtt_tpu_torch.inference import decode_3ddet
    gen = torch.Generator().manual_seed(7)
    nc = det_cfg["num_classes"]
    head = ([], [], [], [])
    for h, w in SW_LEVELS:
        cls = torch.randn(1, h, w, nc, generator=gen) - 6.0
        ctr = torch.randn(1, h, w, 1, generator=gen) - 3.0
        b = torch.randn(1, h, w, 13, generator=gen)
        b[..., 2] = torch.exp(0.3 * b[..., 2]) * 20          # depth (m)
        b[..., 3:6] = torch.exp(0.2 * b[..., 3:6]) * 2       # size
        b[..., 9:] = b[..., 9:].abs()
        for t, v in zip(head, (cls, b, torch.randn(1, h, w, 6,
                                                   generator=gen), ctr)):
            t.append(v)
    n_pts = sum(h * w for h, w in SW_LEVELS)
    raised = torch.randperm(n_pts, generator=gen)[:400]
    start = 0
    for lvl, (h, w) in enumerate(SW_LEVELS):
        local = raised[(raised >= start) & (raised < start + h * w)] - start
        ys, xs = local // w, local % w
        cl = torch.randint(0, nc, (len(local),), generator=gen)
        head[0][lvl][0, ys, xs, cl] = 1.0 + 3.0 * torch.rand(
            len(local), generator=gen)
        head[3][lvl][0, ys, xs, 0] = 2.0
        start += h * w
    Kc = torch.tensor(SW_CAM_K)
    want = decode_3ddet(head, Kc, det_cfg)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    got = decode_3ddet(tuple([t.to(dev) for t in part] for part in head),
                       Kc.to(dev), det_cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = {k: v[0].cpu() for k, v in got.items()}
    want = {k: v[0] for k, v in want.items()}
    nv, nw = int(got["valid"].sum()), int(want["valid"].sum())
    if nv != nw or nw < 100:
        raise RuntimeError(f"decode: {nv} valid boxes on the card, {nw} on "
                           f"the CPU (at least 100 expected)")
    gv = {k: v[got["valid"]] for k, v in got.items()}
    wv = {k: v[want["valid"]] for k, v in want.items()}
    geo = ("boxes3d", "bboxes2d", "centers2d")
    scale = {k: wv[k].abs().max().item() for k in geo}
    worst = {"scores": 0.0, **dict.fromkeys(geo, 0.0)}
    for i in range(nv):
        same = (wv["labels"] == gv["labels"][i]).nonzero()[:, 0]
        if not len(same):
            raise RuntimeError(f"decode: card box {i} has no CPU box of its "
                               f"label")
        d = (wv["boxes3d"][same] - gv["boxes3d"][i]).abs().amax(1)
        j = same[d.argmin()]
        worst["scores"] = max(worst["scores"], abs(
            wv["scores"][j] - gv["scores"][i]).item())
        for k in geo:
            worst[k] = max(worst[k], (wv[k][j] - gv[k][i]).abs().max().item()
                           / scale[k])
    print(f"[swin] decode on the card vs the CPU: {nv} valid boxes on both "
          f"(400 raised points); worst score error {worst['scores']:.3g} "
          f"(tol 1e-5), worst relative box error "
          f"{max(worst[k] for k in geo):.3g} (tol 1e-4); card decode "
          f"{ms:.1f} ms wall", flush=True)
    if worst["scores"] > 1e-5 or any(worst[k] > 1e-4 for k in geo):
        raise RuntimeError(f"decode on the card differs from the CPU: "
                           f"{worst}")


def swin_phase():
    """The TaskPrompter-Swin-B Cityscapes-3D eval forward through the
    kernels and the decode of its detections; returns the launch counts."""
    from mtt_tpu_torch.inference import decode_3ddet, predict
    from mtt_tpu_torch.kernels import _build

    model, x, K = _swin_model()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    logits, preds = predict(model, x, cam_K=K)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[swin] TaskPrompter-Swin-B Cityscapes-3D, {n_params / 1e6:.1f} M "
          f"params, 1 image at {SW_IMG[0]}x{SW_IMG[1]} bf16; launches "
          f"{counts}", flush=True)
    if counts != expected_swin():
        raise RuntimeError(f"Swin launch counts {counts} != {expected_swin()}")
    nout = {"semseg": 19, "depth": 1}
    for t, n in nout.items():
        if logits[t].shape != (1, *SW_OUT, n) or \
                not torch.isfinite(logits[t]).all():
            raise RuntimeError(f"Swin {t}: logits {tuple(logits[t].shape)} "
                               f"or non-finite")
        if preds[t].shape != (1, *SW_OUT) or \
                not torch.isfinite(preds[t].float()).all():
            raise RuntimeError(f"Swin {t}: bad prediction "
                               f"{tuple(preds[t].shape)}")
    widths = {"cls": 6, "bbox": 13, "dir": 6, "ctr": 1}
    got_levels = _det_levels(logits["3ddet"])
    for name, v in got_levels.items():
        lvl, kind = int(name[-1]), name.split(".")[1][:-1]
        if v.shape != (1, *SW_LEVELS[lvl], widths[kind]) or \
                not torch.isfinite(v).all():
            raise RuntimeError(f"Swin {name}: {tuple(v.shape)} or non-finite")
    det = preds["3ddet"]
    n_det = model.det_cfg["test_cfg"]["max_per_img"]
    shapes = {"boxes3d": (1, n_det, 9), "bboxes2d": (1, n_det, 4),
              "scores": (1, n_det), "labels": (1, n_det),
              "centers2d": (1, n_det, 3), "valid": (1, n_det)}
    for k, shp in shapes.items():
        if det[k].shape != shp or not torch.isfinite(det[k].float()).all():
            raise RuntimeError(f"Swin decode {k}: {tuple(det[k].shape)} or "
                               f"non-finite")
    print(f"[swin] decode: {n_det} slots, {int(det['valid'].sum())} valid "
          f"(random weights at the class prior of 0.01 leave the scores "
          f"under score_thr), top score {det['scores'].max().item():.4g}",
          flush=True)
    _decode_check(model.det_cfg, K)

    plain, _ = predict(model, x, impl="plain", cam_K=K)
    # f32 reference: full-precision matmuls and convolutions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_model = copy.deepcopy(model).float()
    ref, _ = predict(ref_model, x, impl="plain", cam_K=K)
    del ref_model
    torch.cuda.empty_cache()
    maps = {t: (logits[t], plain[t], ref[t]) for t in nout}
    plain_levels, ref_levels = (_det_levels(o["3ddet"]) for o in (plain, ref))
    maps.update({k: (v, plain_levels[k], ref_levels[k])
                 for k, v in got_levels.items()})
    worst = 0.0
    for name, (k, p, r) in maps.items():
        k, p, r = k.float(), p.float(), r.float()
        rms_k = ((k - r).norm() / r.norm()).item()
        rms_p = ((p - r).norm() / r.norm()).item()
        worst = max(worst, rms_k)
        print(f"[swin] {name}: vs the f32 run: relative RMS error kernels "
              f"{rms_k:.5g} (tol {FORWARD_RMS_TOL}), plain bf16 {rms_p:.5g}",
              flush=True)
        if not rms_k <= FORWARD_RMS_TOL:
            raise RuntimeError(f"Swin {name}: kernel forward is {rms_k:.4g} "
                               f"(relative RMS) from the f32 run, over "
                               f"{FORWARD_RMS_TOL}")
    agree = (preds["semseg"] == ref["semseg"].argmax(-1)).float().mean()
    print(f"[swin] semseg argmax agreement with f32: {agree.item():.5f}; "
          f"worst relative RMS {worst:.5g}", flush=True)
    del plain, ref, maps, plain_levels, ref_levels

    head_out = logits["3ddet"]
    forward = torch.no_grad()(lambda impl=None: model(x, impl=impl))
    fwd_ms = _time_ms(forward, reps=5, warmup=1)
    plain_ms = _time_ms(lambda: forward("plain"), reps=3, warmup=1)
    dec_ms = _time_ms(lambda: decode_3ddet(head_out, K, model.det_cfg),
                      reps=3, warmup=1)
    all_ms = _wall_ms(lambda: predict(model, x, cam_K=K), reps=3)
    print(f"[swin] forward {fwd_ms:.2f} ms = {1e3 / fwd_ms:.2f} imgs/s "
          f"through the kernels; plain versions {plain_ms:.2f} ms = "
          f"{1e3 / plain_ms:.2f} imgs/s; decode (top-1000 candidates, "
          f"1000x1000 rotated IoU, 6-class greedy NMS sweep, 200 slots) "
          f"{dec_ms:.2f} ms; predict (forward + post-processing + decode) "
          f"{all_ms:.2f} ms wall = {1e3 / all_ms:.2f} imgs/s; peak memory of "
          f"the first predict {peak_gib:.2f} GiB", flush=True)
    return counts


def _map_tensors(fn, out, rec=None):
    """``out`` with each floating tensor t replaced by fn(t) (or fn(t, r),
    r the tensor at the same place in ``rec``), dicts, lists and tuples
    rebuilt."""
    if torch.is_tensor(out):
        if not out.is_floating_point():
            return out
        return fn(out) if rec is None else fn(out, rec)
    if isinstance(out, dict):
        return {k: _map_tensors(fn, v, None if rec is None else rec[k])
                for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_map_tensors(fn, v, None if rec is None else r)
                         for v, r in zip(out, rec if rec is not None
                                         else [None] * len(out)))
    return out


class _ForwardPoint:
    """The output of every module call of one run (``record``), and a run
    of another copy held to them (``pin``): there each module call outputs
    the recorded value, with the gradient of its own computation."""

    def __init__(self):
        self.outs = {}

    @contextlib.contextmanager
    def _hooked(self, model, hook):
        calls, handles = {}, []

        def make(name):
            def h(mod, args, out):
                calls[name] = i = calls.get(name, -1) + 1
                return hook((name, i), out)
            return h
        for name, mod in model.named_modules():
            handles.append(mod.register_forward_hook(make(name)))
        try:
            yield
        finally:
            for h in handles:
                h.remove()

    def record(self, model):
        self.outs = {}

        def keep(key, out):
            # copies: a caller may update an output in place afterwards
            self.outs[key] = _map_tensors(
                lambda t: t.detach().clone(), out)
        return self._hooked(model, keep)

    def pin(self, model):
        def held(key, out):
            if key not in self.outs:
                raise RuntimeError(f"the pinned run calls {key}, which the "
                                   f"recorded run did not")
            return _map_tensors(
                lambda o, r: o + (r.to(o.dtype) - o).detach(), out,
                self.outs[key])
        return self._hooked(model, held)


class _Terms(torch.overrides.TorchFunctionMode):
    """Within it, for each of ``params`` (by name) that an ``F.linear`` or
    ``F.conv2d`` call takes as its bias, or an ``F.linear`` call as its
    weight (a view of one counts), the terms t_i of its gradient summed over
    every such call and position i: sum_i t_i and sum_i |t_i|, where t_i is
    the output cotangent for a bias, the product of cotangent and input for
    a weight."""

    def __init__(self, params: dict):
        super().__init__()
        self.names = {id(t): n for n, t in params.items()}
        self.sums = {}

    def _add(self, name, s, a):
        if name in self.sums:
            self.sums[name][0].add_(s)
            self.sums[name][1].add_(a)
        else:
            self.sums[name] = [s, a]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func not in (F.linear, F.conv2d) or not out.requires_grad:
            return out
        x = args[0].detach()
        w, b = (list(args[1:3]) + [kwargs.get("weight"),
                                   kwargs.get("bias")][len(args) - 1:])[:2]
        wn = None
        if func is F.linear and w is not None:
            wn = self.names.get(id(w), self.names.get(id(w._base)))
        bn = None if b is None else self.names.get(id(b))
        if wn is None and bn is None:
            return out

        def keep(g):
            g = g.detach().float()
            if func is F.conv2d:                     # channels first
                g = g.movedim(1, -1)
            g = g.reshape(-1, g.shape[-1])
            if bn is not None:
                self._add(bn, g.sum(0), g.abs().sum(0))
            if wn is not None:
                xf = x.float().reshape(-1, x.shape[-1])
                self._add(wn, g.t() @ xf, g.abs().t() @ xf.abs())
        out.register_hook(keep)
        return out


def _cancellation(model, names, run) -> dict:
    """How far the terms that sum to each named gradient cancel in ``run``
    (a forward and backward of ``model``): rho = ||sum_i t_i|| /
    ||sum_i |t_i| ||, over every call, sample and position i that adds to
    it (``_Terms``). A relative error e in every term moves the sum by at
    most e / rho of itself. The gradients of other tensors (norms, the
    weights of convolutions, tables) are left out."""
    terms = _Terms({n: model.get_parameter(n) for n in names})
    with terms:
        run()
    return {n: (s.norm() / a.norm()).item()
            for n, (s, a) in terms.sums.items()}


@contextlib.contextmanager
def _deterministic():
    """Library ops with deterministic algorithms only (cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG, set in ``main``): a checked step then gives the
    same gradients at every run."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _grads(model, batch, criterion, gen_state, impl, *contexts):
    """One train-mode forward (within ``contexts``: a ``_ForwardPoint``'s
    record or pin, ``_deterministic``) and backward, with the drop-path
    generator set to ``gen_state``; the gradients by parameter name."""
    gen = torch.Generator(device=batch["image"].device)
    gen.set_state(gen_state)
    model.zero_grad(set_to_none=True)
    dt = next(model.parameters()).dtype
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        out = model(batch["image"].to(dt), train=True, generator=gen,
                    impl=impl)
    criterion(out, batch)["total"].backward()
    return {n: w.grad.detach().clone() for n, w in model.named_parameters()
            if w.grad is not None}


def train_phase():
    """ViT-L PASCAL training steps through the kernels; returns the launch
    counts of one step."""
    from mtt_tpu_torch.utils.train_utils import to_device

    dev = torch.device("cuda")
    trainer, data = _vitl_trainer()
    batches = [to_device(data.batch(i * BT, BT), dev)
               for i in range(TRAIN_STEPS)]
    return _train_run("train", f"TaskPrompter-ViT-L PASCAL, batch {BT} at "
                      f"{IMG}x{IMG}", trainer, batches, expected_train(), BT)


def _swin_trainer():
    """The Swin-B Cityscapes-3D trainer (seeded) and its synthetic dataset
    (labels at dd_label_map_size, 64 box slots)."""
    from mtt_tpu_torch.train import CS3D_SWINB_TRAIN, make_trainer
    return make_trainer(CS3D_SWINB_TRAIN, seed=6, device=torch.device("cuda"))


def swin_train_phase():
    """TaskPrompter-Swin-B Cityscapes-3D training steps through the kernels;
    returns the launch counts of one step."""
    from mtt_tpu_torch.utils.train_utils import to_device

    import mtt_tpu_torch.kernels.window_attention as wa

    dev = torch.device("cuda")
    trainer, data = _swin_trainer()
    batches = [to_device(data.batch(i, 1), dev) for i in range(SW_TRAIN_STEPS)]
    # every window attention backward of the checked step, with its inputs
    launches, real = [], wa.window_attention_bwd_cuda

    def capture(*args):
        out = real(*args)
        launches.append((args, out))
        return out

    def check_launches():
        wa.window_attention_bwd_cuda = real
        worst, rel = 0.0, [0.0, 0.0]
        for i, (args, (dqkv, dbias)) in enumerate(launches):
            want = wa.window_attention_bwd_plain(*args)
            # both against an f32 evaluation of the same inputs
            q, k, v, bias, mask, g, scale, nW = args
            f32 = wa.window_attention_bwd_plain(
                q.float(), k.float(), v.float(), bias, mask, g.float(),
                scale, nW)
            for j, got in enumerate((dqkv.unbind(2), want[:3])):
                rel[j] = max(rel[j], max(_rel_rms({0: a}, {0: b})
                                         for a, b in zip(got, f32[:3])))
            for name, g_, w_, u_ in zip(("dq", "dk", "dv", "dbias"),
                                        (*dqkv.unbind(2), dbias), want,
                                        (4, 4, 4, 0.0128)):
                e, t = _max_err(g_, w_), _ulp_tol(w_, u_)
                worst = max(worst, e / t)
                if not e <= t:
                    raise RuntimeError(f"swin_train: window attention "
                                       f"backward launch {i} {name}: "
                                       f"{e:.4g} > {t:.4g}")
        print(f"[swin_train] each of the step's {len(launches)} window "
              f"attention backward launches against the plain backward on "
              f"its own inputs: worst error {worst:.3g} of its tolerance "
              f"(dq, dk, dv 4 bf16 ulps, dbias 1e-4 of its largest value, "
              f"as in phase 3); dq, dk and dv against an f32 evaluation of "
              f"the same inputs, worst relative RMS: kernel {rel[0]:.4g}, "
              f"plain bf16 {rel[1]:.4g}", flush=True)
        launches.clear()

    wa.window_attention_bwd_cuda = capture
    try:
        return _train_run(
            "swin_train", f"TaskPrompter-Swin-B Cityscapes-3D, 1 image at "
            f"{SW_IMG[0]}x{SW_IMG[1]} (labels at {SW_OUT[0]}x{SW_OUT[1]})",
            trainer, batches, expected_swin_train(), 1, check_launches)
    finally:
        wa.window_attention_bwd_cuda = real


def _train_run(tag, title, trainer, batches, expected, batch_size,
               after_backward=None):
    """One checked training step on batches[0] (launch counts, gradients
    against the f32 reference of the same weights, batch and drop-path masks,
    in all and per tensor; see GRAD_RMS_TOL), then the other batches timed;
    finite losses, moving parameters and BN statistics. ``after_backward``
    runs right after the checked step's backward. Returns the step's launch
    counts."""
    from mtt_tpu_torch.kernels import _build

    model = trainer.model
    state = trainer.generator.get_state()
    criterion = trainer.criterion
    # copies of the weights before the step: the plain versions in bf16 and
    # the f32 reference
    plain_model = copy.deepcopy(model)
    ref_model = copy.deepcopy(model).float()
    buffers0 = {n: b.clone() for n, b in model.named_buffers()
                if "running" in n}
    master0 = [m.detach().to("cpu", copy=True) for m in trainer.master]

    # the kernels, through the trainer, and their f32 reference; f32 products
    # and convolutions in f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    point = _ForwardPoint()
    torch.cuda.synchronize()
    _build.reset_counts()
    with point.record(model), _deterministic():
        losses = trainer.backward(batches[0])
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    if after_backward is not None:
        after_backward()
    g_kernel = {n: w.grad.detach().clone() for n, w in
                model.named_parameters()}
    print(f"[{tag}] {title}, bf16 with f32 master weights; launches of "
          f"one step {counts}", flush=True)
    if counts != expected:
        raise RuntimeError(f"{tag} launch counts {counts} != {expected}")
    g_ref = _grads(ref_model, batches[0], criterion, state, "plain",
                   point.pin(ref_model), _deterministic())
    rms_k = _rel_rms(g_kernel, g_ref)
    if not all(torch.isfinite(g).all() for g in g_kernel.values()):
        raise RuntimeError(f"{tag}: non-finite gradients")
    # per tensor: the relative error against the reference, leaving out the
    # gradients that are zero but for rounding noise; over GRAD_RMS_TOL, the
    # bound of the cancellation rule (see GRAD_RMS_TOL)
    total = sum((g ** 2).sum() for g in g_ref.values()).sqrt().item()
    per, tiny = {}, []
    for k, r in g_ref.items():
        rn = r.norm().item()
        if rn <= 1e-6 * total:
            tiny.append(k)
            continue
        per[k] = ((g_kernel[k].float() - r).norm().item() / rn, rn / total,
                  r.numel())
    over = [k for k, (ek, *_) in per.items() if ek > GRAD_RMS_TOL]
    rho = _cancellation(ref_model, over, lambda: _grads(
        ref_model, batches[0], criterion, state, "plain",
        point.pin(ref_model), _deterministic())) if over else {}
    # the plain versions in bf16 at the same forward point, for comparison:
    # the kernels' backward against the plain one's
    g_pin = _grads(plain_model, batches[0], criterion, state, "plain",
                   point.pin(plain_model), _deterministic())
    del point
    rms_pin = _rel_rms(g_pin, g_ref)
    e_pin = {k: (g_pin[k].float() - g_ref[k]).norm().item()
             / g_ref[k].norm().item() for k in over}
    del g_pin
    # the tensors that carry most of the error of all, with their norms
    err2 = {k: ((g_kernel[k].float() - r) ** 2).sum().item()
            for k, r in g_ref.items()}
    num = sum(err2.values())
    shares = [f"{k} {err2[k] / num:.3g} (||g32|| {g_ref[k].norm():.4g})"
              for k in sorted(err2, key=lambda k: -err2[k])[:6]]

    # the plain versions in bf16 against their own reference, and both
    # against the free-running f32 step, for comparison
    point = _ForwardPoint()
    g_plain = _grads(plain_model, batches[0], criterion, state, "plain",
                     point.record(plain_model), _deterministic())
    del plain_model
    g_ref_p = _grads(ref_model, batches[0], criterion, state, "plain",
                     point.pin(ref_model), _deterministic())
    del point
    rms_p = _rel_rms(g_plain, g_ref_p)
    g_free = _grads(ref_model, batches[0], criterion, state, "plain",
                    _deterministic())
    free_k, free_p = _rel_rms(g_kernel, g_free), _rel_rms(g_plain, g_free)
    del ref_model, g_free, g_plain, g_ref_p
    trainer.update()
    torch.cuda.synchronize()
    print(f"[{tag}] step-1 gradients vs the f32 reference (plain versions at "
          f"the run's forward point): relative RMS over all gradients "
          f"kernels {rms_k:.5g} (tol {GRAD_RMS_TOL}), plain bf16 at the same "
          f"point {rms_pin:.5g}, plain bf16 at its own {rms_p:.5g}; vs the "
          f"free-running f32 step (not bounded): kernels {free_k:.5g}, plain "
          f"bf16 {free_p:.5g}", flush=True)
    print(f"[{tag}] error share of the kernels' largest: {shares}",
          flush=True)
    print(f"[{tag}] {len(tiny)} gradients under 1e-6 of all in the f32 run, "
          f"left out per tensor: {tiny}", flush=True)
    bad = []
    for k in sorted(over, key=lambda k: -per[k][0]):
        ek, share, n = per[k]
        tol = GRAD_RMS_TOL / rho[k] if k in rho else GRAD_RMS_TOL
        if not ek <= tol:
            bad.append(k)
        print(f"[{tag}] tensor {k} ({n} values, ||g32|| = {share:.3g} of "
              f"all): relative error kernels {ek:.5g} (plain bf16 at the same "
              f"point {e_pin[k]:.5g}); cancellation rho "
              f"{rho.get(k, 'not measured')}, tol {tol:.5g}: "
              f"{'OVER' if k in bad else 'ok'}", flush=True)
    print(f"[{tag}] per tensor: {len(per) - len(over)} of {len(per)} within "
          f"{GRAD_RMS_TOL} on the kernels; {len(bad)} over their tolerance",
          flush=True)
    if not rms_k <= GRAD_RMS_TOL:
        raise RuntimeError(f"{tag}: gradients {rms_k:.4g} (relative RMS) "
                           f"from the f32 reference, over {GRAD_RMS_TOL}")
    if bad:
        raise RuntimeError(f"{tag}: per-tensor gradient check failed for "
                           f"{bad}")
    has_grad = [n in g_ref and g_ref[n].abs().sum().item() > 0
                for n, _ in model.named_parameters()]
    del g_kernel, g_ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    all_losses = [losses]
    step_ms = []
    for batch in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_losses.append(trainer.step(batch))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    totals = [float(ls["total"]) for ls in all_losses]
    print(f"[{tag}] losses per step {[round(v, 5) for v in totals]}; "
          f"step 1 {({k: round(float(v), 5) for k, v in losses.items()})}",
          flush=True)
    if not all(torch.isfinite(v).all() for ls in all_losses
               for v in ls.values()):
        raise RuntimeError(f"{tag}: non-finite training loss")
    names = [n for n, _ in model.named_parameters()]
    still = [n for n, a, b in zip(names, master0, trainer.master)
             if torch.equal(a, b.detach().cpu())]
    stuck = [n for n, g in zip(names, has_grad) if g and n in still]
    bn_moved = sum(not torch.equal(buffers0[n], b) for n, b in
                   model.named_buffers() if n in buffers0)
    print(f"[{tag}] parameters moved {len(names) - len(still)}/{len(names)} "
          f"(unmoved, each with a zero f32 gradient: {still}); BN running "
          f"statistics moved {bn_moved}/{len(buffers0)}", flush=True)
    if stuck or bn_moved != len(buffers0):
        raise RuntimeError(f"parameters with a gradient that did not move "
                           f"{stuck}, or BN statistics that did not move")
    ms = statistics.median(step_ms)
    print(f"[{tag}] {ms:.2f} ms per step (median of {len(step_ms)}; "
          f"{[round(v, 2) for v in step_ms]}) = {batch_size / ms * 1e3:.2f} "
          f"imgs/s; peak memory of steps 2-{len(batches)} {peak_gib:.2f} GiB",
          flush=True)
    return counts


# profile: kernel-name fragment -> group; anything else is library work
PROFILE_GROUPS = (# the shared GEMM (gemm.cu) by its epilogue: fc1 of rows 4
                  # and 8; fc2 of row 4; fc2 of row 8 and rows 1-2's qkv
                  # projection; row 6's Gm (row 4's LayerNorm launch is
                  # ln_kernel)
                  ("gemm_kernel<0,", "GEMM + GELU (fc1, rows 4 and 8)"),
                  ("gemm_kernel<1,", "GEMM + bias + residual (fc2, row 4)"),
                  ("gemm_kernel<2,", "GEMM + bias (qkv of rows 1-2, fc2 of "
                                     "row 8)"),
                  # the up4 head's Gm launch, then its mix kernel below;
                  # the InvPT tail's three Gm launches, then its mix kernel
                  ("gemm_kernel<3,", "up4 head"),
                  ("gemm_kernel<4,", "InvPT tail"),
                  ("gemm_kernel", "GEMM (gemm.cu)"),
                  ("wattn_bwd", "window attention backward"),
                  ("wattn_dbias", "window attention backward"),
                  ("attn_bwd", "attention backward"),
                  # rows 1, 2 and 13: attn_generic_kernel under its fast
                  # (1) and safe (2) softmax policies; row 11 past 160
                  # tokens a window under its window policy (3)
                  ("attn_generic_kernel<64, 1>", "attention core"),
                  ("attn_generic_kernel<64, 2>", "attention core"),
                  ("attn_generic_kernel<32, 3>", "window attention"),
                  ("attn_generic", "generic attention"),
                  ("ln_kernel", "layernorm"), ("task_decode", "task decode"),
                  ("head_up4", "up4 head"),
                  ("invpt_attention", "InvPT attention"),
                  ("invpt_tail", "InvPT tail"),
                  ("wattn_kernel", "window attention"))


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``reps`` synchronised calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(title: str, fn, top: int = 12) -> None:
    """Wall time of ``fn`` after warm-up, then one ``torch.profiler`` trace
    of it: device time in all, per kernel group, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    wall = _wall_ms(fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # device rows, without the annotations that the profiler also puts on
    # the device's timeline (named like "Optimizer.step#Adam.step"); the
    # self device time attribute was renamed across torch versions
    dev = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and "#" not in e.key:
            t = getattr(e, "self_device_time_total", None)
            dev[e.key] = (e.count, e.self_cuda_time_total if t is None else t)
    total = sum(t for _, t in dev.values()) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    print(f"[profile] {title}: wall {wall:.2f} ms (median of 5); device "
          f"time of all kernels {total:.2f} ms = "
          f"{100 * total / wall:.1f}% of the wall time; {launches} "
          f"cudaLaunchKernel calls; peak memory {peak:.3f} GiB", flush=True)
    if not dev:
        raise RuntimeError("the profiler trace holds no device time")
    groups = {}
    for name, (count, t) in dev.items():
        g = next((g for frag, g in PROFILE_GROUPS if frag in name),
                 "library (cuBLAS, cuDNN, elementwise, copies)")
        c0, t0 = groups.get(g, (0, 0.0))
        groups[g] = (c0 + count, t0 + t / 1e3)
    for g, (count, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"[profile] {title} | {g}: {ms:.2f} ms in {count} launches "
              f"({100 * ms / wall:.1f}%)", flush=True)
    for name, (count, t) in sorted(dev.items(),
                                   key=lambda kv: -kv[1][1])[:top]:
        print(f"[profile] {title} | kernel {name[:90]}: {t / 1e3:.3f} ms in "
              f"{count}", flush=True)
    # the host's side of the same call: where the time goes when the card
    # waits for launches
    host = sorted((e for e in prof.key_averages()
                   if not str(e.device_type).endswith("CUDA")),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        print(f"[profile] {title} | host {e.key[:60]}: self "
              f"{e.self_cpu_time_total / 1e3:.2f} ms in {e.count} calls",
              flush=True)


def profile_phase(wanted):
    """``--profile``: the device-time breakdown of one eval forward of each
    model (the eval phases' models and batches) and of one training step (the
    training phase's trainer and first batch), for the phases in ``wanted``."""
    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.utils.train_utils import to_device
    if "eval" in wanted:
        model, x = _eval_model()
        _profile(f"eval forward, batch {B}", lambda: predict(model, x))
        del model, x
    for tail_head in (False, True) if "invpt" in wanted else ():
        model, x = _invpt_model(tail_head)
        _profile(f"InvPT eval forward, batch {B}, tail_head={tail_head}",
                 lambda: predict(model, x))
        del model, x
    if "nyud" in wanted:
        for tag, title, p, seed, size, _ in _serve_paths():
            model, x = _serve_model(p, seed, size)
            _profile(f"{title} eval forward, batch {B}",
                     lambda: predict(model, x))
            del model, x
    if "swin" in wanted:
        model, x, K = _swin_model()
        _profile("Swin-B Cityscapes-3D eval forward, 1 image",
                 torch.no_grad()(lambda: model(x)), top=24)
        _profile("Swin-B Cityscapes-3D predict (forward + decode), 1 image",
                 lambda: predict(model, x, cam_K=K), top=8)
        del model, x
    if "train" in wanted:
        trainer, data = _vitl_trainer()
        batch = to_device(data.batch(0, BT), torch.device("cuda"))
        _profile(f"training step, batch {BT}", lambda: trainer.step(batch))
        del trainer, data, batch
    if "swin_train" in wanted:
        trainer, data = _swin_trainer()
        batch = to_device(data.batch(0, 1), torch.device("cuda"))
        _profile("Swin-B Cityscapes-3D training step, 1 image",
                 lambda: trainer.step(batch), top=24)


def grad_diag() -> None:
    """``--grad-diag``: the Swin-B training step run free, against the f32
    step of the same weights, batch and drop-path masks. For the whole loss
    and for its 2D and detection parts: how far the kernels' and the plain
    versions' bf16 gradients sit from the f32 ones, and how far the plain
    bf16 and the f32 gradients move when the image is scaled by 1 + 2^-9.
    Then, for the whole loss, the relative error of the forward value and
    of the gradient at the outputs of the decodes, the detection head (its
    towers at the first level) and the model. First, how far the kernels'
    bf16 gradients move between two runs on equal inputs, on the library's
    default algorithms and on deterministic ones."""
    from mtt_tpu_torch.utils.train_utils import to_device

    trainer, data = _swin_trainer()
    dev = next(trainer.model.parameters()).device
    batch = to_device(data.batch(0, 1), dev)
    nudged = dict(batch, image=batch["image"] * (1 + 2.0 ** -9))
    state = trainer.generator.get_state()
    m16, m32 = trainer.model, copy.deepcopy(trainer.model).float()
    w = trainer.p["loss_kwargs"]["loss_weights"]

    for mode, ctx in (("default", contextlib.nullcontext),
                      ("deterministic", _deterministic)):
        g1, g2 = (_grads(m16, batch, trainer.criterion, state, None, ctx())
                  for _ in range(2))
        moved = {k: ((g2[k].float() - g1[k].float()).norm()
                     / g1[k].float().norm()).item() for k in g1}
        worst = max((k for k in moved if "chan_q" in k), key=moved.get)
        print(f"[grad_diag] kernels, two runs on equal inputs, {mode} "
              f"algorithms: relative RMS between them {_rel_rms(g2, g1):.5g};"
              f" {sum(v > 0 for v in moved.values())} of {len(moved)} "
              f"tensors differ; the most of a chan_q tensor {worst} "
              f"{moved[worst]:.4g}", flush=True)
        del g1, g2

    def part(tasks):
        def crit(out, b):
            ls = trainer.criterion(out, b)
            return {"total": sum(w[t] * ls[t] for t in tasks)}
        return crit

    for label, tasks in (("whole loss", tuple(w)),
                         ("semseg + depth", ("semseg", "depth")),
                         ("3ddet", ("3ddet",))):
        crit = part(tasks)
        g32 = _grads(m32, batch, crit, state, "plain")
        d = {"kernels": _rel_rms(_grads(m16, batch, crit, state, None), g32)}
        gp = _grads(m16, batch, crit, state, "plain")
        d["plain bf16"] = _rel_rms(gp, g32)
        d["plain bf16 moved by the image x (1 + 2^-9)"] = _rel_rms(
            _grads(m16, nudged, crit, state, "plain"), gp)
        d["f32 moved by it"] = _rel_rms(
            _grads(m32, nudged, crit, state, "plain"), g32)
        print(f"[grad_diag] {label}: gradients, relative RMS over all: "
              + "; ".join(f"{k} {v:.5g}" for k, v in d.items()), flush=True)
        del g32, gp

    watched = re.compile(r"^$|^backbone\.(decode_\d|norm)$|^det_head\.fpn$"
                         r"|^det_head\.fcos3d(\.(cls|reg)_tower_\d)?$")

    def first_levels(out, label=""):
        """(label, tensor) of each tensor of an output; of a list of levels,
        the first."""
        if torch.is_tensor(out):
            return [(label, out)]
        if isinstance(out, list):
            return first_levels(out[0], label)
        items = out.items() if isinstance(out, dict) else enumerate(out) \
            if isinstance(out, tuple) else ()
        return [t for k, o in items
                for t in first_levels(o, f"{label}.{k}".lstrip("."))]

    def capture(model, impl):
        vals, grads, calls, hooks = {}, {}, {}, []

        def make(name):
            def h(mod, args, out):
                calls[name] = i = calls.get(name, -1) + 1
                if i:                       # a later level's call
                    return
                for j, t in first_levels(out):
                    key = (name, j)
                    vals[key] = t.detach().float()
                    if t.requires_grad:
                        t.register_hook(lambda g, key=key: grads.__setitem__(
                            key, g.detach().float()))
            return h
        for name, mod in model.named_modules():
            if watched.match(name):
                hooks.append(mod.register_forward_hook(make(name)))
        try:
            _grads(model, batch, trainer.criterion, state, impl)
        finally:
            for h in hooks:
                h.remove()
        return vals, grads

    def rel(a, b):
        n = b.norm().item()
        return (a - b).norm().item() / n if n else float("nan")

    # the f32 gradients at the kernels' and at the plain versions' forward
    # points (``_ForwardPoint``), and each bf16 run against its own
    crit, pts, gs, refs = trainer.criterion, {}, {}, {}
    for impl in (None, "plain"):
        pts[impl] = _ForwardPoint()
        gs[impl] = _grads(m16, batch, crit, state, impl,
                          pts[impl].record(m16))
        refs[impl] = _grads(m32, batch, crit, state, "plain",
                            pts[impl].pin(m32))
    pts_rel = _rel_rms(refs[None], refs["plain"])
    own = [_rel_rms(gs[i], refs[i]) for i in (None, "plain")]
    print(f"[grad_diag] f32 gradients at the kernels' forward point against "
          f"those at the plain versions': {pts_rel:.5g}; kernels against "
          f"their point's {own[0]:.5g}, plain bf16 against theirs "
          f"{own[1]:.5g}", flush=True)
    total = sum((g ** 2).sum() for g in refs[None].values()).sqrt()
    err = {k: (gs[None][k].float() - r).norm().item() / r.norm().item()
           for k, r in refs[None].items() if r.norm() > 1e-6 * total}
    for k in sorted(err, key=lambda k: -err[k])[:4]:
        print(f"[grad_diag]   {k}: ||g32|| at the kernels' point "
              f"{refs[None][k].norm():.4g}, at the plain versions' "
              f"{refs['plain'][k].norm():.4g}; ||error|| kernels "
              f"{(gs[None][k].float() - refs[None][k]).norm():.4g}, plain "
              f"{(gs['plain'][k].float() - refs['plain'][k]).norm():.4g}",
              flush=True)
    del pts, gs, refs

    ref, runs = capture(m32, "plain"), (capture(m16, "plain"),
                                        capture(m16, None))
    print("[grad_diag] module output (first level of a list): relative "
          "error of the forward value and of its gradient, plain bf16 / "
          "kernels, against the f32 step", flush=True)
    for key, v in ref[0].items():
        fw = [rel(r[0][key], v) for r in runs]
        g = ref[1].get(key)
        gr = [rel(r[1][key], g) if g is not None and key in r[1]
              else float("nan") for r in runs]
        print(f"[grad_diag]   {key[0] or 'model'}[{key[1]}] "
              f"{tuple(v.shape)}: forward {fw[0]:.4g} / {fw[1]:.4g}, "
              f"gradient {gr[0]:.4g} / {gr[1]:.4g}", flush=True)


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier of a mangled name (<length><identifier>)
    and its template arguments."""
    for m in re.finditer(r"(?=(\d+)([a-z_][a-z_0-9]*))", mangled):
        name = m.group(2)[:int(m.group(1))]
        if len(name) == int(m.group(1)) and name.endswith("_kernel"):
            tmpl = re.match(r"I\w*?EE", mangled[m.start(2) + len(name):])
            return name + (tmpl.group(0) if tmpl else "")
    return mangled


PHASES = {"kernels": kernel_phase, "attention_api": attention_api_phase,
          "eval": eval_phase, "invpt": invpt_phase, "swin": swin_phase,
          "nyud": nyud_phase, "train": train_phase,
          "swin_train": swin_train_phase}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="only print the device-time breakdown of one eval "
                         "forward and one training step (torch.profiler)")
    ap.add_argument("--grad-diag", action="store_true",
                    help="only print how far the Swin-B training step's "
                         "bf16 gradients sit from the f32 step's, run free "
                         "(see grad_diag)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES)
                         + "; a subset prints no result lines")
    args = ap.parse_args(argv)
    profile_only = args.profile
    wanted = args.phases.split(",")
    if not set(wanted) <= set(PHASES):
        ap.error(f"unknown phase in {args.phases!r}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # before cuBLAS starts: its deterministic mode for the checked steps
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from mtt_tpu_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)      # the card's name and power limit, as printed

    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds and round(_build.build_seconds, 1)} "
          f"s)", flush=True)
    kernel = None
    for line in _build.build_log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
        elif kernel and ("spill" in line or "registers" in line):
            print(f"[ptxas] {kernel}: {line.split(':', 1)[-1].strip()}")
    if profile_only:
        profile_phase(wanted)
        return 0
    if args.grad_diag:
        grad_diag()
        return 0

    phases, outcome = {}, {}
    for name, run in PHASES.items():
        if name in wanted:
            t = time.perf_counter()
            outcome[name] = run()
            phases[name] = time.perf_counter() - t
            torch.cuda.empty_cache()
    print(f"[phases] seconds {({k: round(v, 1) for k, v in phases.items()})}",
          flush=True)
    if len(outcome) < len(PHASES):
        print(f"[partial] ran only {sorted(outcome)}: no result", flush=True)
        return 0
    results, eval_counts = outcome["kernels"], outcome["eval"]
    invpt_counts, train_counts = outcome["invpt"], outcome["train"]
    swin_counts, swin_train_counts = outcome["swin"], outcome["swin_train"]
    api_counts, serve_counts = outcome["attention_api"], outcome["nyud"]

    rows = []
    for name, (src, replaces, counter, path) in KERNEL_ROWS.items():
        r = results[name]
        by_path = {"eval_factored": eval_counts["factored"][counter],
                   "eval_dense": eval_counts["dense"][counter],
                   "train_step": train_counts[counter],
                   "invpt_tail": invpt_counts["tail"][counter],
                   "invpt_tail_head": invpt_counts["tail_head"][counter],
                   "swin": swin_counts[counter],
                   "swin_train": swin_train_counts[counter],
                   "attention_api": api_counts[counter],
                   **{tag: c[counter] for tag, c in serve_counts.items()}}
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=by_path[{"eval": "eval_factored", "train": "train_step",
                              "invpt": "invpt_tail",
                              "invpt_head": "invpt_tail_head",
                              "swin": "swin", "swin_train": "swin_train",
                              "attention_api": "attention_api"}[path]],
            launches_by_path=by_path, max_abs_err=r["max_abs_err"],
            tol=r["tol"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library_composition_ms=r["library_composition_ms"]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
