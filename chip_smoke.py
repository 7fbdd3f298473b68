"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and nvcc; it exits non-zero, printing no result, when either is missing
or any phase fails.

Phases, in order (the seconds each took are printed):
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from mtt_tpu_torch/csrc (seconds printed);
  3. each of the 12 kernel entry points (11 TPU kernels; the multi-scale tail
     with and without its fused head) against its plain PyTorch version at the
     ViT-L PASCAL shapes the main paths give it, the earlier kernels again
     at the shapes the InvPT path adds (N = 1025, LayerNorm rows of 2880, MLP
     widths 576, 288, 144; the tail on NYUD's non-square grid), and the Swin
     path's at its shapes (window attention at the four Swin-B stages with
     and without the shift mask; LayerNorm rows of 128 to 2048 at eps 1e-5;
     MLP widths 128 to 1024, down to the 3 prompt rows): error, tolerance in
     bf16 ulps, CUDA-event times of the kernel, the plain version, the
     library call or composition, and the bound of the card;
  4. the ViT-L PASCAL eval forward (5 tasks, CTR on, bf16, seeded random
     weights, batch 8 at 512x512) through ``predict``, with the factored up4
     head (the default) and with the dense head: launch counts, shapes,
     finiteness, relative RMS error against an f32 run of the same weights,
     imgs/s and peak memory;
  5. the InvPT-ViT-L PASCAL eval forward (ViT-L backbone with a cls token,
     InvPT decoder, 1x1 heads; batch 8 at 512x512, bf16, seeded random
     weights, full width and depth) through ``predict``, with the fused tail
     (the default) and with the head-fused tail: the same checks;
  6. the TaskPrompter-Swin-B Cityscapes-3D eval forward (semseg, depth and
     3D detection; one 1024x2048 image, bf16, seeded random weights, full
     width and depth) through ``predict`` with a fixed camera matrix: launch
     counts, shapes, finiteness, every 2D map and every detection level
     against an f32 run of the same weights, the decode of fixed size, ms per
     forward, imgs/s, decode ms and peak memory;
  7. ViT-L PASCAL training at the config's batch of 2 on seeded synthetic
     batches in bf16 with f32 master weights: the launch counts of one step,
     its gradients against an f32 plain run of the same weights, batch and
     drop-path masks (in all and per tensor), finite losses, moving
     parameters and BN statistics, ms per step, imgs/s and peak memory.
The line before the last is the kernels JSON; the last line is the device JSON.

``python3 chip_smoke.py --profile`` runs none of these phases: after the
build it traces one eval forward of each model and one training step with
``torch.profiler`` and prints their wall time and device time by kernel group
(with ``--phases``, only those models').
``--phases kernels,invpt`` (any subset of kernels, eval, invpt, swin, train)
runs only those phases and prints no result lines: a quick look, not the check.
"""

from __future__ import annotations

import argparse
import copy
import json
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

# TaskPrompter-Swin-B Cityscapes-3D: one 1024x2048 image resized to 768x1536,
# patch 4; per stage (token grid, width, heads); 12x12 windows with 3 prompts
SW_IMG = (1024, 2048)
SW_STAGES = (((192, 384), 128, 4), ((96, 192), 256, 8), ((48, 96), 512, 16),
             ((24, 48), 1024, 32))
SW_WIN, SW_P, SW_D = 12, 3, 32
SW_M = SW_WIN * SW_WIN + SW_P
SW_OUT = (512, 1024)         # dd_label_map_size
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
    return cases


def _swin_cases(rnd):
    """The kernel cases the Swin path adds, in ``kernel_phase``'s format: row
    11 at the four Swin-B stages with and without the shift mask, rows 3 and
    8 at the shapes this path gives them."""
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    from mtt_tpu_torch.kernels.window_attention import fused_window_attention

    bf = torch.bfloat16
    f32 = torch.float32
    dev = torch.device("cuda")
    cases = {}
    M, D = SW_M, SW_D
    for i, ((gh, gw), dim, H) in enumerate(SW_STAGES):
        BW = gh * gw // (SW_WIN * SW_WIN)
        # q, k, v as the block hands them over: views of the packed qkv
        q, k, v = rnd(BW, M, 3, H, D).unbind(2)
        bias = torch.zeros(H, M, M, device=dev)
        bias[:, SW_P:, SW_P:] = rnd(H, M - SW_P, M - SW_P, std=0.5, dtype=f32)
        mask = torch.zeros(BW, M, M, device=dev)
        mask[:, SW_P:, SW_P:] = torch.where(
            rnd(BW, M - SW_P, M - SW_P, dtype=f32) < -0.5, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
        for m in (mask, None):
            def call(impl, a=(q, k, v, bias, m), nW=BW):
                return fused_window_attention(*a, D ** -0.5, nW, impl=impl)

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


def kernel_phase():
    """Each kernel against its plain version on the same seeded inputs."""
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_cuda,
                                                 attn_core_bwd_plain,
                                                 fused_attention_ln_qkv)
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

    def decode_lib():
        xt_ = xs[:, None]
        f = torch.einsum("btsc,trc->btsr",
                         xt_ * a.repeat_interleave(C // G, -1) + xt_, ws) \
            + bs[None, :, None]
        fc = torch.einsum("btsc,trc->btsr", xt_ * cw.to(bf)[:, :, None] + xt_,
                          wc) + bc[None, :, None]
        return torch.einsum("btsr,tfr->btsf", torch.cat([f, fc], -1), wf) \
            + bfin[None, :, None]

    # the dense cuDNN head of the same function: upsample, conv3x3 (bias 0),
    # BN affine, GELU, 1x1
    kc_oihw = kc.permute(3, 2, 0, 1).contiguous()
    kp_oihw = kp.t()[:, :, None, None].contiguous()

    def head_lib():
        up = F.interpolate(xh.permute(0, 3, 1, 2), scale_factor=4,
                           mode="bilinear", align_corners=False)
        y = F.conv2d(up, kc_oihw, padding=1)
        y = F.gelu(y * inv.to(bf)[:, None, None] + addv.to(bf)[:, None, None])
        return F.conv2d(y, kp_oihw)

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
        "task_decode": (
            lambda impl: fused_task_decode(xs, a, cw, ws, bs, wc, bc, wf,
                                           bfin, impl=impl),
            4, "x*a+x, f and fc are rounded to bf16 at the same points; "
               "f32 sums in another order can flip a rounding",
            None, decode_lib,
            _nbytes(xs, a, cw, ws, bs, wc, bc, wf, bfin) + B * S * T * FIN * 2,
            2.0 * B * T * S * (2 * C * TAR + 2 * TAR * FIN), 0.0),
        "head_up4": (
            lambda impl: fused_up4_head(xh, kc, inv, addv, kp, impl=impl),
            4, "Gm, the width mix and the GELU output are rounded to bf16 "
               "at the same points; f32 sums in another order can flip a "
               "rounding; the logits are f32 on both sides",
            None, head_lib,
            _nbytes(xh, kc, inv, addv, kp) + B * 16 * GRID * GRID * NLOG * 4,
            # bf16 x bf16 products on the tensor cores: Gm (9 taps), the
            # width mix (6 nonzero taps of the shifted bilinear bands per
            # output, as the TPU stencil counts them; this kernel also
            # multiplies the 3 zeros) and the 1x1; in f32: the height mix
            # (6 nonzero taps) and the affine + GELU (~25 flops)
            2.0 * B * GRID * GRID * FIN * 9 * FIN
            + 12.0 * B * GRID * 3 * FIN * 4 * GRID
            + 2.0 * B * 16 * GRID * GRID * FIN * NLOG,
            (12.0 + 25.0) * B * 16 * GRID * GRID * FIN),
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
    cases.update(_invpt_cases(rnd))
    cases.update(_swin_cases(rnd))
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

    # the safe (max-subtracted) softmax of the training forward
    got = fused_attention_ln_qkv(x, gamma, beta, wqkv, bqkv, HEADS,
                                 impl="cuda", safe=True)
    want = fused_attention_ln_qkv(x, gamma, beta, wqkv, bqkv, HEADS,
                                  impl="plain", safe=True)
    e, t = _max_err(got, want), _ulp_tol(want, 4)
    if e > t:
        raise RuntimeError(f"attention safe softmax: {e:.4g} > {t:.4g}")
    print(f"[kernel] attention safe softmax: max_abs_err={e:.6g} tol={t:.6g}"
          " (4 bf16 ulps: the online max rescales P after its bf16 rounding)",
          flush=True)
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


def expected_invpt(tail_head: bool) -> dict:
    """One InvPT eval forward: 24 ViT blocks (attention + MLP half-block);
    LayerNorm = the ViT's final norm + norm1 and norm2 of the 3 decoder
    stages + their 3 task-merged stage norms; one plain MLP and one
    message-passing attention per stage; one tail launch per task."""
    return _expected(layernorm=1 + 6 + 3, attention_cached=24, mlp_ln_res=24,
                     mlp_fc=3, invpt_attention=3,
                     **{"invpt_tail_head" if tail_head else "invpt_tail": T})


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
# the same weights, batch and drop-path masks: relative RMS over all
# gradients, sqrt(sum ||g - g32||^2 / sum ||g32||^2). On an H100 the kernels
# measured 0.062 and the plain versions in bf16 0.060 at this seed: bf16
# rounding carried back through 24 blocks of random weights, alike on both
# paths. The bound is 2.5x that, as for the forward; a wiring fault (a
# missing cotangent, a transposed weight gradient) gives order 1.
GRAD_RMS_TOL = 0.15
# Per tensor, the same bound holds, divided by the cancellation rho of the
# sum that forms the tensor's gradient (``_cancellation``): batch-statistics
# BN in the heads makes the loss nearly blind to a common scale or shift of a
# head's input, so the gradients of the parameters that set one (the CTR
# weights and biases, the decode's last biases) are small sums of large terms
# (rho 1e-6 to 0.25 on an H100), and the bf16 error of the terms comes out
# magnified by 1 / rho on both bf16 paths alike. A tensor outside the sums
# that rho covers is held to GRAD_RMS_TOL itself. Gradients under 1e-6 of
# all are left out: the biases ahead of batch-statistics BN, whose exact
# gradient is zero, and a few that these random weights leave near zero.


def _rel_rms(got: dict, ref: dict) -> float:
    num = sum(((got[k].float() - ref[k].float()) ** 2).sum() for k in ref)
    den = sum((ref[k].float() ** 2).sum() for k in ref)
    return (num / den).sqrt().item()


def _eval_model():
    """The ViT-L PASCAL eval model (factored head, bf16, seeded random
    weights) and a seeded batch of 8 preprocessed 512x512 images."""
    from mtt_tpu_torch.inference import preprocess
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model
    from mtt_tpu_torch.train import PASCAL_VITL

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    model = build_model(PASCAL_VITL, device=dev, dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    rgb = torch.randint(0, 256, (B, IMG, IMG, 3), generator=gen, device=dev)
    return model, preprocess(rgb)


def _vitl_trainer():
    """The ViT-L PASCAL trainer (seeded) and its synthetic dataset."""
    from mtt_tpu_torch.train import PASCAL_VITL, make_trainer
    return make_trainer(PASCAL_VITL, seed=2, device=torch.device("cuda"))


def eval_phase():
    """The ViT-L PASCAL eval forward through the kernels, factored head then
    dense head; returns the launch counts of each forward."""
    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet

    dev = torch.device("cuda")
    factored, x = _eval_model()
    dense = TaskPrompterNet(
        factored.tasks, {t: factored.get_submodule(f"head_{t}").linear_pred
                         .out_channels for t in factored.tasks}, (IMG, IMG),
        "TaskPrompter_vitL", head_up4="dense", device=dev,
        dtype=torch.bfloat16).eval()
    dense.load_state_dict(factored.state_dict())
    n_params = sum(p.numel() for p in factored.parameters())
    counts = {}
    for mode, model in (("factored", factored), ("dense", dense)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        logits, preds = predict(model, x)
        torch.cuda.synchronize()
        counts[mode] = dict(_build.COUNTS)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[eval {mode}] TaskPrompter-ViT-L PASCAL, "
              f"{n_params / 1e6:.1f} M params, batch {B} at {IMG}x{IMG} "
              f"bf16; launches {counts[mode]}", flush=True)
        if counts[mode] != expected_eval(mode):
            raise RuntimeError(f"{mode} launch counts {counts[mode]} != "
                               f"{expected_eval(mode)}")
        for t in model.tasks:
            n = model.get_submodule(f"head_{t}").linear_pred.out_channels
            if logits[t].shape != (B, IMG, IMG, n) or \
                    not torch.isfinite(logits[t]).all():
                raise RuntimeError(f"{mode} {t}: logits "
                                   f"{tuple(logits[t].shape)} or non-finite")
            if preds[t].shape[:3] != (B, IMG, IMG) or \
                    not torch.isfinite(preds[t].float()).all():
                raise RuntimeError(f"{mode} {t}: bad prediction "
                                   f"{tuple(preds[t].shape)}")
        ms = _time_ms(lambda: predict(model, x), reps=5, warmup=1)
        plain_ms = _time_ms(lambda: predict(model, x, impl="plain"), reps=3,
                            warmup=1)
        plain, plain_preds = predict(model, x, impl="plain")
        # f32 reference: full-precision matmuls and convolutions (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref_model = copy.deepcopy(model).float()
        ref, ref_preds = predict(ref_model, x, impl="plain")
        del ref_model
        for t in model.tasks:
            r = ref[t].float()
            k, p = logits[t].float(), plain[t].float()
            rms_k = ((k - r).norm() / r.norm()).item()
            rms_p = ((p - r).norm() / r.norm()).item()
            line = (f"[eval {mode}] {t}: vs the f32 run: relative RMS error "
                    f"kernels {rms_k:.5g} (tol {FORWARD_RMS_TOL}), plain bf16 "
                    f"{rms_p:.5g}; max error / max|f32| kernels "
                    f"{((k - r).abs().max() / r.abs().max()).item():.5g}")
            if t in ("semseg", "human_parts"):
                line += (f"; argmax agreement with f32: kernels "
                         f"{(preds[t] == ref_preds[t]).float().mean().item():.5f}"
                         f", plain bf16 "
                         f"{(plain_preds[t] == ref_preds[t]).float().mean().item():.5f}")
            print(line, flush=True)
            if not rms_k <= FORWARD_RMS_TOL:
                raise RuntimeError(f"{mode} {t}: kernel forward is {rms_k:.4g}"
                                   f" (relative RMS) from the f32 run, over "
                                   f"{FORWARD_RMS_TOL}")
        print(f"[eval {mode}] forward+postprocess {ms:.2f} ms = "
              f"{B / ms * 1e3:.2f} imgs/s through the kernels; plain versions "
              f"{plain_ms:.2f} ms = {B / plain_ms * 1e3:.2f} imgs/s; peak "
              f"memory of the first forward {peak_gib:.2f} GiB", flush=True)
        del logits, preds, plain, plain_preds, ref, ref_preds
    return counts


def _invpt_model(tail_head: bool = False):
    """The InvPT-ViT-L PASCAL eval model (bf16, seeded random weights, full
    width and depth) and a seeded batch of 8 preprocessed 512x512 images."""
    from mtt_tpu_torch.inference import preprocess
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import INVPT_PASCAL_VITL, build_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    model = build_model(INVPT_PASCAL_VITL, tail_head=tail_head, device=dev,
                        dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    rgb = torch.randint(0, 256, (B, IMG, IMG, 3), generator=gen, device=dev)
    return model, preprocess(rgb)


def invpt_phase():
    """The InvPT-ViT-L PASCAL eval forward through the kernels, with the fused
    tail then with the head-fused tail; returns the launch counts of each."""
    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.kernels import _build

    tail, x = _invpt_model()
    head, _ = _invpt_model(tail_head=True)
    head.load_state_dict(tail.state_dict())
    n_params = sum(p.numel() for p in tail.parameters())
    # f32 reference, once: full-precision matmuls and convolutions (no TF32);
    # both tail forms compute one function
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_model = copy.deepcopy(tail).float()
    ref, ref_preds = predict(ref_model, x, impl="plain")
    del ref_model
    torch.cuda.empty_cache()
    counts = {}
    for mode, model in (("tail", tail), ("tail_head", head)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        logits, preds = predict(model, x)
        torch.cuda.synchronize()
        counts[mode] = dict(_build.COUNTS)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[invpt {mode}] InvPT-ViT-L PASCAL, {n_params / 1e6:.1f} M "
              f"params, batch {B} at {IMG}x{IMG} bf16; launches "
              f"{counts[mode]}", flush=True)
        want = expected_invpt(mode == "tail_head")
        if counts[mode] != want:
            raise RuntimeError(f"InvPT {mode} launch counts {counts[mode]} "
                               f"!= {want}")
        plain, plain_preds = predict(model, x, impl="plain")
        for t in model.tasks:
            n = model.get_submodule(f"head_{t}").linear_pred.out_channels
            for what, v in ((t, logits[t]),
                            (f"inter_preds.{t}", logits["inter_preds"][t])):
                if v.shape != (B, IMG, IMG, n) or not torch.isfinite(v).all():
                    raise RuntimeError(f"InvPT {mode} {what}: logits "
                                       f"{tuple(v.shape)} or non-finite")
            if preds[t].shape[:3] != (B, IMG, IMG) or \
                    not torch.isfinite(preds[t].float()).all():
                raise RuntimeError(f"InvPT {mode} {t}: bad prediction "
                                   f"{tuple(preds[t].shape)}")
            r = ref[t].float()
            k, p = logits[t].float(), plain[t].float()
            rms_k = ((k - r).norm() / r.norm()).item()
            rms_p = ((p - r).norm() / r.norm()).item()
            ri = ref["inter_preds"][t].float()
            rms_i = ((logits["inter_preds"][t].float() - ri).norm()
                     / ri.norm()).item()
            line = (f"[invpt {mode}] {t}: vs the f32 run: relative RMS error "
                    f"kernels {rms_k:.5g} (tol {FORWARD_RMS_TOL}), plain bf16 "
                    f"{rms_p:.5g}, intermediate prediction {rms_i:.5g}")
            if t in ("semseg", "human_parts"):
                line += (f"; argmax agreement with f32: kernels "
                         f"{(preds[t] == ref_preds[t]).float().mean().item():.5f}"
                         f", plain bf16 "
                         f"{(plain_preds[t] == ref_preds[t]).float().mean().item():.5f}")
            print(line, flush=True)
            if not max(rms_k, rms_i) <= FORWARD_RMS_TOL:
                raise RuntimeError(
                    f"InvPT {mode} {t}: kernel forward is {rms_k:.4g} "
                    f"(intermediate {rms_i:.4g}, relative RMS) from the f32 "
                    f"run, over {FORWARD_RMS_TOL}")
        del logits, preds, plain, plain_preds
        ms = _time_ms(lambda: predict(model, x), reps=5, warmup=1)
        plain_ms = _time_ms(lambda: predict(model, x, impl="plain"), reps=3,
                            warmup=1)
        print(f"[invpt {mode}] forward+postprocess {ms:.2f} ms = "
              f"{B / ms * 1e3:.2f} imgs/s through the kernels; plain versions "
              f"{plain_ms:.2f} ms = {B / plain_ms * 1e3:.2f} imgs/s; peak "
              f"memory of the first forward {peak_gib:.2f} GiB", flush=True)
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


def _grads_of(model, batch, criterion, gen_state, impl=None):
    """One train-mode forward and backward with the drop-path generator set
    to ``gen_state``; the gradients by parameter name."""
    gen = torch.Generator(device="cuda")
    gen.set_state(gen_state)
    model.zero_grad(set_to_none=True)
    dt = next(model.parameters()).dtype
    out = model(batch["image"].to(dt), train=True, generator=gen, impl=impl)
    criterion(out, batch)["total"].backward()
    return {n: w.grad.detach().clone() for n, w in model.named_parameters()}


def _cancellation(model, batch, criterion, gen_state, names) -> dict:
    """How far the terms that sum to each named gradient cancel, in one f32
    plain run: rho = ||sum_i t_i|| / ||sum_i |t_i|||, over samples and
    positions i, where t_i is the output cotangent for a bias and the product
    of cotangent and input for a Linear weight. A relative error e in every
    term moves the sum by at most e / rho of itself. Other tensors (and
    modules called more than once) are left out."""
    seen, hooks = {}, []

    def grabber(mod_name):
        def grab(_, inp, out):
            def keep(g):
                seen.setdefault(mod_name, []).append(
                    (inp[0].detach().float(), g.detach().float()))
            out.register_hook(keep)
        return grab

    for mod_name in {n.rsplit(".", 1)[0] for n in names}:
        hooks.append(model.get_submodule(mod_name).register_forward_hook(
            grabber(mod_name)))
    try:
        _grads_of(model, batch, criterion, gen_state, "plain")
    finally:
        for h in hooks:
            h.remove()
    rho = {}
    for name in names:
        mod_name, kind = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        if len(seen.get(mod_name, ())) != 1:
            continue
        x, g = seen[mod_name][0]
        if isinstance(mod, torch.nn.Conv2d):    # channels first
            g, x = g.movedim(1, -1), x.movedim(1, -1)
        g = g.reshape(-1, g.shape[-1])
        if kind == "bias":
            rho[name] = (g.sum(0).norm() / g.abs().sum(0).norm()).item()
        elif kind == "weight" and isinstance(mod, torch.nn.Linear):
            x = x.reshape(-1, x.shape[-1])
            rho[name] = ((g.t() @ x).norm()
                         / (g.abs().t() @ x.abs()).norm()).item()
    return rho


def train_phase():
    """ViT-L PASCAL training steps through the kernels; returns the launch
    counts of one step."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.utils.train_utils import to_device

    dev = torch.device("cuda")
    trainer, data = _vitl_trainer()
    model = trainer.model
    batches = [to_device(data.batch(i * BT, BT), dev)
               for i in range(TRAIN_STEPS)]

    # gradients of the first step: the kernels in bf16, the plain versions in
    # bf16, and an f32 plain run of the same weights, batch and masks
    state = trainer.generator.get_state()
    g_plain = _grads_of(copy.deepcopy(model), batches[0], trainer.criterion,
                        state, "plain")
    ref_model = copy.deepcopy(model).float()
    g_ref = _grads_of(ref_model, batches[0], trainer.criterion, state,
                      "plain")
    ref_model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    buffers0 = {n: b.clone() for n, b in model.named_buffers()
                if "running" in n}
    master0 = [m.detach().cpu() for m in trainer.master]  # off the card

    torch.cuda.synchronize()
    _build.reset_counts()
    losses = trainer.backward(batches[0])
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    g_kernel = {n: w.grad.detach().clone() for n, w in
                model.named_parameters()}
    trainer.update()
    torch.cuda.synchronize()
    print(f"[train] TaskPrompter-ViT-L PASCAL, batch {BT} at {IMG}x{IMG}, "
          f"bf16 with f32 master weights; launches of one step {counts}",
          flush=True)
    if counts != expected_train():
        raise RuntimeError(f"training launch counts {counts} != "
                           f"{expected_train()}")
    rms_k, rms_p = _rel_rms(g_kernel, g_ref), _rel_rms(g_plain, g_ref)
    print(f"[train] step-1 gradients vs the f32 plain run: relative RMS over "
          f"all gradients kernels {rms_k:.5g} (tol {GRAD_RMS_TOL}), plain "
          f"bf16 {rms_p:.5g}", flush=True)
    if not all(torch.isfinite(g).all() for g in g_kernel.values()):
        raise RuntimeError("non-finite gradients")
    if not rms_k <= GRAD_RMS_TOL:
        raise RuntimeError(f"gradients {rms_k:.4g} (relative RMS) from the "
                           f"f32 run, over {GRAD_RMS_TOL}")
    # per tensor: each path's relative error against the f32 run, leaving
    # out the gradients that are zero but for rounding noise
    total = sum((g ** 2).sum() for g in g_ref.values()).sqrt().item()
    per, tiny = {}, []
    for k, r in g_ref.items():
        rn = r.norm().item()
        if rn <= 1e-6 * total:
            tiny.append(k)
            continue
        per[k] = ((g_kernel[k].float() - r).norm().item() / rn,
                  (g_plain[k].float() - r).norm().item() / rn,
                  rn / total, r.numel())
    print(f"[train] {len(tiny)} gradients under 1e-6 of all in the f32 run, "
          f"left out per tensor: {tiny}", flush=True)
    over = [k for k, (ek, ep, _, _) in per.items()
            if max(ek, ep) > GRAD_RMS_TOL]
    rho = _cancellation(ref_model, batches[0], trainer.criterion, state,
                        over)
    del ref_model
    bad = []
    for k in sorted(over, key=lambda k: -max(per[k][:2])):
        ek, ep, share, n = per[k]
        tol = GRAD_RMS_TOL / rho[k] if k in rho else GRAD_RMS_TOL
        print(f"[train] tensor {k} ({n} values, ||g32|| = {share:.3g} of "
              f"all): relative error kernels {ek:.5g}, plain bf16 {ep:.5g}; "
              f"cancellation rho {rho.get(k, 'not measured')}, tol "
              f"{tol:.5g}", flush=True)
        if not ek <= tol:
            bad.append(k)
    print(f"[train] per tensor: {len(per) - len(over)} of {len(per)} within "
          f"{GRAD_RMS_TOL} on both bf16 paths; {len(bad)} over their "
          f"tolerance", flush=True)
    if bad:
        raise RuntimeError(f"per-tensor gradient check failed for {bad}")
    has_grad = [g_ref[n].abs().sum().item() > 0
                for n, _ in model.named_parameters()]
    del g_kernel, g_plain, g_ref
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
    print(f"[train] losses per step {[round(v, 5) for v in totals]}; "
          f"step 1 {({k: round(float(v), 5) for k, v in losses.items()})}",
          flush=True)
    if not all(torch.isfinite(v).all() for ls in all_losses
               for v in ls.values()):
        raise RuntimeError("non-finite training loss")
    names = [n for n, _ in model.named_parameters()]
    still = [n for n, a, b in zip(names, master0, trainer.master)
             if torch.equal(a, b.detach().cpu())]
    stuck = [n for n, g in zip(names, has_grad) if g and n in still]
    bn_moved = sum(not torch.equal(buffers0[n], b) for n, b in
                   model.named_buffers() if n in buffers0)
    print(f"[train] parameters moved {len(names) - len(still)}/{len(names)} "
          f"(unmoved, each with a zero f32 gradient: {still}); BN running "
          f"statistics moved {bn_moved}/{len(buffers0)}", flush=True)
    if stuck or bn_moved != len(buffers0):
        raise RuntimeError(f"parameters with a gradient that did not move "
                           f"{stuck}, or BN statistics that did not move")
    ms = statistics.median(step_ms)
    print(f"[train] {ms:.2f} ms per step (median of {len(step_ms)}; "
          f"{[round(v, 2) for v in step_ms]}) = {BT / ms * 1e3:.2f} imgs/s; "
          f"peak memory of steps 2-{TRAIN_STEPS} {peak_gib:.2f} GiB",
          flush=True)
    return counts


# profile: kernel-name fragment -> group; anything else is library work
PROFILE_GROUPS = (("mlp_kernel", "mlp (mlp.cu)"),
                  ("attn_bwd", "attention backward"),
                  ("attn_core", "attention core"),
                  ("gemm_nt_bias", "qkv projection"),
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device rows, without the annotations that the profiler also puts on
    # the device's timeline (named like "Optimizer.step#Adam.step"); the
    # self device time attribute was renamed across torch versions
    dev = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and "#" not in e.key:
            t = getattr(e, "self_device_time_total", None)
            dev[e.key] = (e.count, e.self_cuda_time_total if t is None else t)
    total = sum(t for _, t in dev.values()) / 1e3
    print(f"[profile] {title}: wall {wall:.2f} ms (median of 5); device "
          f"time of all kernels {total:.2f} ms = "
          f"{100 * total / wall:.1f}% of the wall time", flush=True)
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


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier of a mangled name (<length><identifier>)
    and its template arguments."""
    for m in re.finditer(r"(?=(\d+)([a-z_][a-z_0-9]*))", mangled):
        name = m.group(2)[:int(m.group(1))]
        if len(name) == int(m.group(1)) and name.endswith("_kernel"):
            tmpl = re.match(r"I\w*?EE", mangled[m.start(2) + len(name):])
            return name + (tmpl.group(0) if tmpl else "")
    return mangled


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="only print the device-time breakdown of one eval "
                         "forward and one training step (torch.profiler)")
    ap.add_argument("--phases", default="kernels,eval,invpt,swin,train",
                    help="comma-separated subset of kernels, eval, invpt, "
                         "swin, train; a subset prints no result lines")
    args = ap.parse_args(argv)
    profile_only = args.profile
    wanted = args.phases.split(",")
    if not set(wanted) <= {"kernels", "eval", "invpt", "swin", "train"}:
        ap.error(f"unknown phase in {args.phases!r}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    phases, outcome = {}, {}
    for name, run in (("kernels", kernel_phase), ("eval", eval_phase),
                      ("invpt", invpt_phase), ("swin", swin_phase),
                      ("train", train_phase)):
        if name in wanted:
            t = time.perf_counter()
            outcome[name] = run()
            phases[name] = time.perf_counter() - t
            torch.cuda.empty_cache()
    print(f"[phases] seconds {({k: round(v, 1) for k, v in phases.items()})}",
          flush=True)
    if len(outcome) < 5:
        print(f"[partial] ran only {sorted(outcome)}: no result", flush=True)
        return 0
    results, eval_counts = outcome["kernels"], outcome["eval"]
    invpt_counts, train_counts = outcome["invpt"], outcome["train"]
    swin_counts = outcome["swin"]

    rows = []
    for name, (src, replaces, counter, path) in KERNEL_ROWS.items():
        r = results[name]
        by_path = {"eval_factored": eval_counts["factored"][counter],
                   "eval_dense": eval_counts["dense"][counter],
                   "train_step": train_counts[counter],
                   "invpt_tail": invpt_counts["tail"][counter],
                   "invpt_tail_head": invpt_counts["tail_head"][counter],
                   "swin": swin_counts[counter]}
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=by_path[{"eval": "eval_factored", "train": "train_step",
                              "invpt": "invpt_tail",
                              "invpt_head": "invpt_tail_head",
                              "swin": "swin"}[path]],
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
