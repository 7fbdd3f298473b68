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
     widths 576, 288, 144; the tail on NYUD's non-square grid; row 9 at the
     three PASCAL stages and NYUD's last, on the model's strided head
     views, equal across two runs, the bit-equal share of its out printed),
     and the Swin
     path's at its shapes (window attention and its backward at the four
     Swin-B stages with and without the shift mask, both equal across two
     runs, the backward's dbias too, as are rows 7, 8, 10, 13 and 14 and
     the projection;
     LayerNorm rows of 128 to 2048 at eps 1e-5; MLP widths 128 to 1024, down
     to the 3 prompt rows),
     and the safe softmax of rows 1, 2 and 13 (at least 99% of the outputs
     bit-equal to the plain version: the max over all keys), and the
     ``limits`` phase's shapes (row 9 at Cityscapes-3D's three stages and at
     head dim 544, row 3 at 5440 columns, the attention core at head dims
     16, 32, 80 and 128, fast and safe, row 7 at 16 and 32) and the
     ``widths`` phase's (row 3 at 1660 and 830 columns, row 8 at 332 and
     166, row 9 at head dim 83, row 5's split form at tar = F = 768; each
     one's bit-equal share printed):
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
     plain backward on its own inputs;
  11. ``invpt_train``: InvPT-ViT-L training with intermediate supervision
     (every ``inter_<task>`` loss checked finite), drop-path on, on PASCAL
     (5 tasks, 512x512) and NYUD-v2 (4 tasks, 448x576), batch 2: the
     checks of phase 9;
  12. ``nyud_train``: NYUD-v2 TaskPrompter-ViT-L training (16 channel
     windows, no CTR, 768-wide heads) at batch 2 and 448x576: the checks
     of phase 9;
  13. ``evaluate``: ``test_phase`` over 2 seeded synthetic batches of 8
     through the InvPT-ViT-L PASCAL eval model: launch counts, finite
     scores, the meter states on the card against the port's meters on
     the CPU, imgs/s;
  14. ``loop``: the training loop as ``python -m mtt_tpu_torch.main`` runs
     it, in a temporary working directory, at full width and depth
     (TaskPrompter-ViT-L PASCAL from configs/pascal/taskprompter_vitLp16.yml,
     512x512, batch 2, drop-path 0.15, bf16, synthetic samples through the
     training transforms, the 64-image val set in 11 batches of 6): what
     ``main`` builds, then ``train_phase`` for 4 iterations with an eval
     and a checkpoint every 2 (launch counts, finite losses and scores, 64
     edge PNGs and none for the pad samples, the checkpoints, the
     TensorBoard rows, the log file; a trainer restored from step 4 and the
     loop's own take one step on one batch to equal bits); then ``main``
     itself with ``--max_iter 6``, which resumes from step 4. Prints imgs/s
     from the log lines, the loader's ms per batch beside the bare step's
     (phase 9), the checkpoint's size and its save and restore seconds, and
     peak memory.
  15. ``detect``: the Cityscapes-3D evaluation and the inference CLI as a
     user runs them, at full width and depth (TaskPrompter-Swin-B from
     configs/cityscapes3d/taskprompter_swinB.yml, bf16, seeded weights with
     the class bias at prior 0.5 so that 200 boxes an image pass the
     decode; the synthetic val set cut to 8 images, 2 batches of 4 at
     1024x2048, through the Cityscapes-3D transforms), in a temporary
     working directory: ``test_phase`` (launch counts, finite 2D scores,
     mDS and mAP in [0, 1], 8 JSON files, the card's records against the
     CPU's decode and export of the same head outputs, imgs/s, the decode's
     ms and the scoring's seconds); ``main --run_mode infer --vis`` (its
     scores with 3ddet, the vis_semseg, vis_depth and 3ddet files, drawn
     from the scoring forwards);
     ``train_phase`` for 2 iterations with an eval at 2 (the b0_ JSON and
     wireframe PNG under train/3ddet, results_iter2.json with the 3ddet
     mDS, launch counts); the inference CLI on TaskPrompter-ViT-L PASCAL
     from a seeded trainer's checkpoint and a 375x500 PNG (five PNGs equal
     to ``visualize`` of ``predict`` on the CLI's resized input) and on
     Swin-B with a 1024x2048 PNG and the Stuttgart camera, each input's
     scanlines in all five PNG filters (the host's ``read_png`` time of the
     1024x2048 file beside a filter-0 one's).
  16. ``convert``: weight ingestion at full width and depth, in a temporary
     directory: TaskPrompter-ViT-L PASCAL, InvPT-ViT-L PASCAL and
     TaskPrompter-Swin-B Cityscapes-3D, each a seeded f32 model (every bias,
     norm and BN statistic seeded too) written in the reference
     repository's checkpoint layout by an inverse map of this script's own
     (DDP ``module.`` keys in a ``{"model": ...}`` wrapper, (3, H, D) qkv
     rows, per-task convs, the unused reference tensors) and converted by
     ``python -m mtt_tpu_torch.convert_checkpoint --torch`` on the card:
     the written checkpoint equal to the model bit for bit; then each
     converted model through its eval entry point (``inference.main
     --ckpt_dir`` on a 375x500 PNG for ViT-L and Swin-B, ``predict`` on 2
     images for InvPT from a restored bf16 trainer): launch counts, every
     map (and detection level, and intermediate prediction) within 0.1 of
     the f32 forward of the same weights, the error's RMS over that of the
     f32 map less its per-channel mean (so that the class prior's bias does
     not hide an error in the detection logits), with the plain bf16
     forward's distance printed beside it; and a Google
     ViT-L/16 npz at the 384 pretraining grid through ``--npz`` into
     TaskPrompter-ViT-L at 512: every backbone tensor equal to the npz's
     (transposed as the layouts say), the position embedding within 1e-6
     of ``resize_pos_embed``. Prints each conversion's seconds, the host's
     peak RSS (sampled) and the checkpoint's GiB.
  17. ``parallel``: data-parallel training and evaluation in 2 ranks, one
     process each, started by this script with torchrun's environment
     (``--dp-rank``): gloo on this card when it is the only one (the two
     ranks share it; NCCL needs a card a rank, and runs where there are
     two), NCCL on a card a rank otherwise. The TaskPrompter-ViT-L PASCAL
     step at batch 2 a rank (drop-path 0.15, the up4 head's batch BN, bf16,
     the kernels, deterministic library algorithms) against the 1-rank step
     of batch 4 on the same global batch and seed: gradients, losses and BN
     batch moments within DP_BOUND times the 1-rank step's own distance to
     f32, the drop-path draws equal, the ranks' parameters, master weights
     and buffers equal to the bit after the update; the step's wall ms at 1
     and 2 ranks, ``all_reduce_grads``'s ms (CUDA events) and each rank's
     peak memory. Then Swin-B Cityscapes-3D ``test_phase`` over phase 15's
     cut val set of 8 images, one batch of 4 a rank: the merged 2D scores
     and ``mDetection_Score`` / ``mAP`` against the 1-rank run's
     (DP_SCORE_TOL). The launches of both ranks' checked step and eval are
     the kernels line's ``dp`` path.
  18. ``datasets``: the dataset readers from data roots on disk, in a
     temporary directory: the committed JPEG fixtures (tests/data/jpeg)
     decoded by this host's g++ build of the decoder to the SHA-256 of
     PIL's and cv2's pixels (``pixels.json``); trees in each dataset's own
     layout (PASCAL-Context: 16 train and 8 val ids, the fixtures as their
     images at VOC sizes, .mat label maps and human-parts structs, palette
     semseg PNGs, RGB normals, grey saliency, the db_info JSONs;
     Cityscapes-3D: 4 val frames at 1024x2048, RGB, labelIds and 16-bit
     disparity PNGs with mixed scanline filters, gtBbox3d JSONs; NYUD-v2:
     4 val ids at 448x576); ``main --max_iter 4 --val_interval 2`` with
     ``MTT_DATA_ROOT`` at the PASCAL tree on the ViT-L YAML at full width
     and depth (launch counts of 4 steps and 2 evals of 2 batches, finite
     losses and scores, one edge PNG per val image at its own size);
     Swin-B ``test_phase`` over the Cityscapes frames through
     ``get_dataset`` and the CS3D val transforms (launch counts, finite 2D
     scores, mDS and mAP in [0, 1]); one NYUD TaskPrompter-ViT-L eval
     batch from disk. Prints, on the host: ms to decode a 500x375 JPEG, ms
     per 1024x2048 PNG with the library's unfilter and numpy's, ms per
     PASCAL sample and the share of the edge thinning, the loader's ms per
     batch from disk, imgs/s from ``main``'s log lines. Its launches are
     the kernels line's ``data`` path.
  19. ``options``: the model options: the InvPT-ViT-L PASCAL step at
     batch 2 and the Swin-B Cityscapes-3D step at batch 1, each with
     ``remat`` off and on from one state and one generator, on
     deterministic library algorithms: the rematted step's losses,
     gradients, BN running statistics and generator state equal to the
     plain step's bits, the launch counts of each (the rematted blocks'
     forward launches twice), each step's own peak memory and ms per step;
     then eval forwards at batch 8 of TaskPrompter-ViT-L PASCAL with the
     phase up4 head, the mlp and the deconv head, InvPT-ViT-L PASCAL with
     the conv and the deconv head (through ``predict``: the checks of phase
     5) and Swin-B Cityscapes-3D with the conv head (launch counts, every
     2D map and detection level against an f32 run). Its launches are the
     kernels line's ``options_*`` paths.
  20. ``limits``: models that JAX's ``build_model`` builds from a YAML past
     the shipped configs, each YAML a shipped one with its keys changed and
     read by ``create_config`` (``_limit_configs``), seeded bf16 weights:
     InvPT-ViT-L on Cityscapes-3D's 2D tasks (semseg with 19 classes, depth)
     at 1024x2048, eval at batch 1 and one training step at batch 1 with
     intermediate supervision (row 9 at 1024 keys, rows 1-2 and row 7 over
     8,193 tokens); InvPT-ViT-L PASCAL at embed_dim 1024 (row 9 at head dim
     544, row 3 at 5440 columns), eval at batch 8; InvPT-ViT-T and
     TaskPrompter-ViT-T PASCAL (the attention core and row 7 at head dim 16),
     eval at batch 8 with the card's f32 plain forward held to the CPU's
     (LIMIT_CPU_TOL), and one step at batch 2. The checks of phases 5 and 9:
     launch counts, every map within 0.1 of f32, the gradients against the
     f32 backward at the step's forward point, finite losses, ms and peak
     memory. Each step's seed is the first that keeps every InvPT decoder
     branch for some sample (``_limit_trainer``). Its launches are the
     kernels line's ``limits_*`` paths; phase 3 holds each of these kernels
     at the new shapes to its plain version (``_limits_cases``).
  21. ``widths``: every width a YAML gives JAX's models (``_width_configs``):
     InvPT-ViT-L PASCAL at embed_dim 600 (rows 3, 8 and 9 at widths and
     head dims that are not multiples of 8) and TaskPrompter-ViT-L PASCAL
     at tar = F = 768 (row 5's split form), each eval at batch 8 and one
     step at batch 2; the MTT_DEBUG_TINY TaskPrompter-Swin on
     Cityscapes-3D (``build_model``'s ``debug_tiny``; every block of depth
     1 is a tap block, so no window attention kernel runs, as in JAX), one
     1024x2048 frame with its decode (every 2D map and detection level
     within 0.1 of f32) and one step at batch 1;
     InvPT-ViT-L PASCAL eval at batch 8 with ``factored_tail`` (no tail
     kernel), held to f32 and to the kernel tail of the same weights. The
     checks of phases 5 and 9; its launches are the kernels line's paths of
     those names; phase 3 holds the kernels at the new shapes to their
     plain versions (``_widths_cases``).
  22. ``formats``: the image files beyond baseline JPEG and plain PNG
     (``tests/data/images``: JPEG at sampling factors up to 4 and with 4
     components, Adam7 PNG, a PNG's eXIf orientation, BMP, PNM, TIFF):
     every fixture in every ``read_image`` mode against ``pixels.json``
     (written by ``tools/make_image_fixtures.py`` from PIL and cv2), each
     one's decode ms on the host beside phase 18's baseline JPEG, and the
     inference CLI once over a JPEG, a PNG, a TIFF, a BMP and a PPM with
     one TaskPrompter-ViT-L model; its launches are the kernels line's
     ``formats`` path, one eval forward's a image.
  23. ``f32``: float32 on the card, JAX's default dtype (TF32 off). Each f32
     form (rows 1-6; rows 13 and 14 through the module API) against its
     plain version at f32 at the main path's shapes and one ragged shape
     each, relative RMS at most F32_KERNEL_TOL, with its ms, the plain
     version's, the library call's or composition's and its bound (bytes,
     or the f32 GEMM's and attention core's products as three TF32 passes
     at 495 TFLOP/s and the rest at 67; every f32 flop at 67 beside it, the
     FFMA forms' bound); the TaskPrompter-ViT-L PASCAL eval
     forward at batch 8 and 512x512 in f32 through the kernels, each map
     within F32_FORWARD_TOL of the plain f32 forward of the same weights,
     the bf16 kernel forward's distance beside it, each f32 counter equal
     to the bf16 forward's row by row and no bf16 counter moving, the two
     forwards' device ms; ViT-B PASCAL and NYUD ViT-L at batch 2 the same
     way; ``Attention`` without LN and ``dot_product_attention`` at f32; the
     inference CLI at its f32 default over a JPEG and a PNG; ``main
     --run_mode infer --dtype float32`` over one val batch. Its launches
     are the kernels line's ``f32`` path (the ViT-L forward), ``f32_api``
     (rows 13 and 14), ``f32_vitb``, ``f32_nyud``, ``f32_cli`` and
     ``f32_main``.
The line before the last is the kernels JSON; the last line is the device JSON.

``python3 chip_smoke.py --profile`` runs none of these phases: after the
build it traces one eval forward of each model and one training step of
each training path (for ``options``: the InvPT-ViT-L and Swin-B steps with
remat off and on; for ``f32``: the ViT-L eval forward at f32) with
``torch.profiler`` and prints their wall time and device time by kernel
group (with ``--phases``, only those paths').
``python3 chip_smoke.py --grad-diag`` runs none of them either: it prints how
far the Swin-B training step's bf16 gradients move between two runs on equal
inputs, and how far they sit from the f32 step's when both run free, by loss
part, at the two bf16 paths' forward points, and at the outputs of the
decodes and the detection head (``grad_diag``).
``--convert-vary 0.1`` seeds the convert phase's biases, norms and BN
statistics at 10% in place of 1% (``_vary``), to see how the forwards'
bf16 error grows with them.
``--phases kernels,invpt`` (any subset of kernels, attention_api, eval,
invpt, swin, nyud, train, swin_train, invpt_train, nyud_train, evaluate,
loop, detect, convert, parallel, datasets, options, limits, widths,
formats, f32)
runs only those phases and prints no result lines: a quick look, not the
check.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import math
import os
import re
import statistics
import shutil
import struct
import subprocess
import sys
import tempfile
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

# The limits phase: models JAX's build_model builds from a YAML past the
# shipped configs. InvPT-ViT-L on Cityscapes-3D's 2D tasks at 1024x2048: 2
# tasks x 16 x 32 = 1024 keys at every stage, stage (query rows, head dim,
# message) below; InvPT-ViT-L PASCAL at embed_dim 1024 (decoder width 1088);
# the ViT-T models (4 heads of 16).
CS3D_LK = 1024
CS3D_INVPT_STAGES = ((1024, 288, False), (4096, 144, True),
                     (16384, 72, True))
WIDE_D = 1024 + 64
LIMIT_CORE = ((4, 16), (16, 32), (12, 80), (8, 128))   # (heads, head dim)
LIMIT_BWD = ((4, 16), (16, 32))
LIMIT_CPU_TOL = 1e-4     # the card's f32 plain forward against the CPU's

# The widths phase: every width a YAML gives JAX's models. InvPT-ViT-L PASCAL
# at embed_dim 600: decoder width 664, stage widths 664, 332 and 166 (head
# dims 332, 166 and 83, task-merged norms 3320, 1660 and 830);
# TaskPrompter-ViT-L PASCAL at embed_dim and final_embed_dim 768 (the task
# decode's tar = F = 768, past the one launch); the MTT_DEBUG_TINY
# TaskPrompter-Swin (embed 16, depths 1, 2 heads a stage) on Cityscapes-3D.
W600_D = 600 + 64
W600_STAGES = ((8, W600_D), (16, W600_D // 2), (32, W600_D // 4))
W768 = 768
# InvPT's factored eval tail against its kernel tail on the same weights
# (relative RMS): both round Gm and the width mix at the same points, so
# they differ by f32 sums in another order (about 1e-6 on the card)
FACTORED_TAIL_TOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# outside them, HBM bandwidth
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# TF32 tensor cores: the f32 GEMM and the f32 attention core run three TF32
# products a product (3xTF32), so their f32 flops count three times at it
PEAK_TF32 = 495e12

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
    # the f32 forms (phase 23): the f32 eval forward's path, rows 13 and 14
    # the module API's at f32
    "layernorm_f32": ("mtt_tpu_torch/csrc/layernorm.cu",
                      "mtt_tpu/kernels/layernorm.py:29", "layernorm_f32",
                      "f32"),
    "attention_cached_f32": ("mtt_tpu_torch/csrc/attention_f32.cu",
                             "mtt_tpu/kernels/attention.py:423",
                             "attention_cached_f32", "f32"),
    "attention_emit_f32": ("mtt_tpu_torch/csrc/attention_f32.cu",
                           "mtt_tpu/kernels/attention.py:393",
                           "attention_emit_f32", "f32"),
    "mlp_ln_res_f32": ("mtt_tpu_torch/csrc/gemm_f32.cu",
                       "mtt_tpu/kernels/mlp.py:355", "mlp_ln_res_f32", "f32"),
    "task_decode_f32": ("mtt_tpu_torch/csrc/task_decode_f32.cu",
                        "mtt_tpu/kernels/task_decode.py:49",
                        "task_decode_f32", "f32"),
    "head_up4_f32": ("mtt_tpu_torch/csrc/head_up4.cu",
                     "mtt_tpu/kernels/head_up4.py:168", "head_up4_f32",
                     "f32"),
    "attention_qkv_f32": ("mtt_tpu_torch/csrc/attention_f32.cu",
                          "mtt_tpu/kernels/attention.py:230",
                          "attention_qkv_f32", "f32_api"),
    "attention_generic_f32": ("mtt_tpu_torch/csrc/attention_f32.cu",
                              "mtt_tpu/kernels/attention.py:118",
                              "attention_generic_f32", "f32_api"),
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


def _bound(nbytes: float, tc_flops: float, f32_flops: float = 0.0,
           tf32x3_flops: float = 0.0):
    """Least time of the card for the work, ms: bytes at the HBM rate
    against tensor-core bf16, f32 and 3xTF32 operations at their peaks
    (the last three TF32 products each)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (tc_flops / PEAK_BF16 + f32_flops / PEAK_F32
             + 3.0 * tf32x3_flops / PEAK_TF32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _invpt_case(rnd, batch, Lq, Lk, Dh, with_msg):
    """Row 9 on the model's (B, L, H, D) head views in ``kernel_phase``'s
    format: q (batch, 2, Lq, Dh), k and v (batch, 2, Lk, Dh), a message
    (f32) with its head mix where ``with_msg``; its composition (matmul,
    the mix, softmax, matmul) as the library yardstick."""
    from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention

    bf, f32 = torch.bfloat16, torch.float32
    q = rnd(batch, Lq, INV_H, Dh).transpose(1, 2)
    k = rnd(batch, Lk, INV_H, Dh).transpose(1, 2)
    v = rnd(batch, Lk, INV_H, Dh).transpose(1, 2)
    msg = rnd(batch, INV_H, Lq, Lk, dtype=f32) if with_msg else None
    w = rnd(INV_H, 2 * INV_H, std=0.5, dtype=f32) if with_msg else None
    b = rnd(INV_H, std=0.1, dtype=f32) if with_msg else None
    sc = (INV_H * Dh) ** -0.5

    def call(impl):
        return invpt_fused_attention(q, k, v, msg, w, b, sc, impl=impl)

    def comp():
        fused = torch.matmul(q, k.transpose(-1, -2)).float() * sc
        if msg is not None:
            fused = torch.einsum("hc,bcqk->bhqk", w,
                                 torch.cat([fused, msg], 1)) \
                + b[None, :, None, None]
        return torch.matmul(torch.softmax(fused, -1).to(bf), v), fused

    nel = batch * INV_H * Lq * Lk
    return (call, (4, 0.01),
            "out: scores, mix and softmax in f32 and p rounded to bf16 at "
            "the same point, f32 sums in another order can flip that "
            "rounding; fused (f32 on both sides): exact bf16 products summed "
            "in f32 in another order, 0.01 bf16 ulps = 8e-5 of max |fused|",
            None, comp,
            _nbytes(q, k, v, q) + nel * 4
            + (_nbytes(msg, w, b) if with_msg else 0),
            4.0 * nel * Dh, (8.0 if with_msg else 1.0) * nel + 5.0 * nel)


def _invpt_cases(rnd):
    """The kernel cases the InvPT path adds, in ``kernel_phase``'s format:
    rows 9 and 10 at the PASCAL ViT-L shapes (and row 10 on NYUD's non-square
    grid), and rows 1, 3, 4 and 8 at the shapes this path gives them."""
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    from mtt_tpu_torch.kernels.invpt_tail import (fused_ms_tail,
                                                  fused_ms_tail_head)
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp, fused_mlp_ln_res

    bf = torch.bfloat16
    f32 = torch.float32
    cases = {}

    # row 9 at the three PASCAL stages (the first has no message) and at
    # NYUD's last (4 tasks x 28 x 36 query rows, 4 x 7 x 9 = 252 keys), on
    # the model's (B, L, H, D) head views
    stages = [(T * g * g, dim, INV_LK, f"@stage{i}" if i < 2 else "")
              for i, (g, dim) in enumerate(INV_STAGES)]
    stages.append((NYUD_T * NYUD_GH * NYUD_GW, INV_STAGES[2][1],
                   NYUD_T * (NYUD_GH // 4) * (NYUD_GW // 4), "@nyud2"))
    for i, (Lq, dim, Lk, label) in enumerate(stages):
        cases[f"invpt_attention{label}"] = _invpt_case(rnd, B, Lq, Lk,
                                                       dim // INV_H, i > 0)

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


def _limits_cases(rnd):
    """The kernel cases of the ``limits`` phase's shapes, in
    ``kernel_phase``'s format: row 9 at the three InvPT stages of a
    Cityscapes-3D frame (batch 1, 1024 keys) and at PASCAL's stage 0 at
    embed_dim 1024 (q (8, 2, 320, 544)), both past the resident kernel's
    reach (the streamed form); row 3 on that model's stage-0 norm (8, 16,
    16, 5440); the attention core (row 13's entry) at head dims 16 (ViT-T,
    4 heads), 32, 80 and 128 over 1025 tokens at batch 8, fast and safe;
    row 7 at head dims 16 and 32 at the training batch of 2. Library
    calls: F.layer_norm, SDPA on the packed qkv's strided views and SDPA's
    backward; row 9's composition."""
    from mtt_tpu_torch.kernels.attention import (attn_core_bwd_cuda,
                                                 attn_core_bwd_plain,
                                                 fused_attention_qkv)
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm

    bf, f32 = torch.bfloat16, torch.float32
    cases = {}
    for i, (Lq, dh, msg) in enumerate(CS3D_INVPT_STAGES):
        cases[f"invpt_attention@cs3d_stage{i}"] = _invpt_case(
            rnd, 1, Lq, CS3D_LK, dh, msg)
    g0 = INV_STAGES[0][0]
    cases[f"invpt_attention@D{WIDE_D // 2}"] = _invpt_case(
        rnd, B, T * g0 * g0, INV_LK, WIDE_D // 2, False)
    Cm = T * WIDE_D
    xm = rnd(B, 2 * g0, 2 * g0, Cm)
    gm_ = rnd(Cm, std=0.1, mean=1.0, dtype=f32)
    bm_ = rnd(Cm, std=0.1, dtype=f32)
    cases[f"layernorm@C{Cm}"] = (
        lambda impl: fused_layernorm(xm, gm_, bm_, impl=impl),
        1, "as layernorm, a row over the four warps of a block",
        lambda: F.layer_norm(xm, (Cm,), gm_.to(bf), bm_.to(bf), 1e-6),
        None, _nbytes(xm, gm_, bm_, xm), 0.0, 8.0 * xm.numel())

    for h, d in LIMIT_CORE:
        qkv = rnd(B, NV, h * 3 * d)

        def sdpa(qkv=qkv, h=h, d=d):
            q, k, v = (t.transpose(1, 2)
                       for t in qkv.view(B, NV, h, 3, d).unbind(3))
            o = F.scaled_dot_product_attention(q, k, v)
            return o.transpose(1, 2).reshape(B, NV, h * d)

        for safe in (False, True):
            cases[f"attention_qkv@D{d}" + ("_safe" if safe else "")] = (
                lambda impl, qkv=qkv, h=h, s=safe: fused_attention_qkv(
                    qkv, h, impl=impl, safe=s),
                4, f"as attention_qkv{'_safe' if safe else ''}, head dim "
                   f"{d} (its tile padded with zeros past it)",
                sdpa, None, _nbytes(qkv) + B * NV * h * d * 2,
                4.0 * B * h * NV * NV * d, 0.0)

    for h, d in LIMIT_BWD:
        qkv, g = rnd(BT, NV, h * 3 * d), rnd(BT, NV, h * d)
        q5 = qkv.view(BT, NV, h, 3, d)
        sd_in = [q5[:, :, :, j].transpose(1, 2).detach().requires_grad_()
                 for j in range(3)]
        sd_out = F.scaled_dot_product_attention(*sd_in)
        sd_g = g.view(BT, NV, h, d).transpose(1, 2)

        def bwd_lib(o=sd_out, i=sd_in, gg=sd_g):
            return torch.autograd.grad(o, i, gg, retain_graph=True)

        def bwd(impl, qkv=qkv, g=g, h=h, d=d):
            fn = attn_core_bwd_cuda if impl == "cuda" else attn_core_bwd_plain
            v5 = fn(qkv, g, h, d ** -0.5).view(BT, NV, h, 3, d)
            return tuple(v5[..., j, :] for j in range(3))

        cases[f"attention_bwd@D{d}"] = (
            bwd, 4, f"as attention_bwd, per q, k and v slot, head dim {d}",
            bwd_lib, None, _nbytes(qkv, g, qkv),
            10.0 * BT * h * NV * NV * d, 0.0)
    return cases


def _widths_cases(rnd):
    """The kernel cases of the ``widths`` phase's shapes, in
    ``kernel_phase``'s format: InvPT at embed_dim 600, row 3 on the
    task-merged stage norms of 1660 and 830 columns (rows not whole 16-byte
    chunks), row 8 at the stage widths 332 and 166 (zero-padded to 336 and
    168), row 9 at stage 2's head dim 83 (padded to 88); row 5's split form
    at TaskPrompter-ViT-L's tar = F = 768."""
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode

    bf, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")
    cases = {}
    for g, dim in W600_STAGES[1:]:
        g, Cm = 2 * g, T * dim
        xm = rnd(B, g, g, Cm)
        gm_ = rnd(Cm, std=0.1, mean=1.0, dtype=f32)
        bm_ = rnd(Cm, std=0.1, dtype=f32)
        cases[f"layernorm@C{Cm}"] = (
            lambda impl, a=(xm, gm_, bm_): fused_layernorm(*a, impl=impl),
            1, "as layernorm, on rows that are not whole 16-byte chunks "
               "(2-byte loads)",
            lambda a=(xm, gm_, bm_): F.layer_norm(
                a[0], a[0].shape[-1:], a[1].to(bf), a[2].to(bf), 1e-6),
            None, _nbytes(xm, gm_, bm_, xm), 0.0, 8.0 * xm.numel())
        hid = 4 * dim
        xd = rnd(B, T, g, g, dim)
        wa, ba = rnd(hid, dim, std=dim ** -0.5), rnd(hid, std=0.1)
        wb, bb = rnd(dim, hid, std=hid ** -0.5), rnd(dim, std=0.1)
        cases[f"mlp_fc@C{dim}"] = (
            lambda impl, a=(xd, wa, ba, wb, bb): fused_mlp(*a, impl=impl),
            4, "as mlp_fc, C and hidden zero-padded to multiples of 8", None,
            lambda a=(xd, wa, ba, wb, bb): F.linear(
                F.gelu(F.linear(a[0], a[1], a[2])), a[3], a[4]),
            _nbytes(xd, wa, ba, wb, bb, xd), 4.0 * xd.numel() * hid, 0.0)
    g2, dim2 = W600_STAGES[2]
    cases[f"invpt_attention@D{dim2 // INV_H}"] = _invpt_case(
        rnd, B, T * g2 * g2, INV_LK, dim2 // INV_H, True)

    xs = rnd(B, S, C)
    a = rnd(B, T, S, G)
    cw = rnd(B, T, C, dtype=f32)
    ws, wc = (rnd(T, W768, C, std=C ** -0.5) for _ in range(2))
    bs, bc = (rnd(T, W768, std=0.1) for _ in range(2))
    wf = rnd(T, W768, 2 * W768, std=(2 * W768) ** -0.5)
    bfin = rnd(T, W768, std=0.1)

    def decode_lib():
        xt_ = xs[:, None]
        f = torch.einsum("btsc,trc->btsr",
                         xt_ * a.repeat_interleave(C // G, -1) + xt_, ws) \
            + bs[None, :, None]
        fc = torch.einsum("btsc,trc->btsr",
                          xt_ * cw.to(bf)[:, :, None] + xt_, wc) \
            + bc[None, :, None]
        return torch.einsum("btsr,tfr->btsf", torch.cat([f, fc], -1),
                            wf) + bfin[None, :, None]

    cases[f"task_decode@tar{W768}"] = (
        lambda impl: fused_task_decode(xs, a, cw, ws, bs, wc, bc, wf, bfin,
                                       impl=impl),
        4, "the split form: [f; fc] rounded to bf16 at the one launch's "
           "point, through a scratch; f32 sums in another order can flip a "
           "rounding",
        None, decode_lib,
        _nbytes(xs, a, cw, ws, bs, wc, bc, wf, bfin) + B * S * T * W768 * 2,
        2.0 * B * T * S * (2 * C * W768 + 2 * W768 * W768), 0.0)

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
    limit_cases = {**_limits_cases(rnd), **_widths_cases(rnd)}
    cases.update(limit_cases)
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
                            "invpt_tail", "invpt_attention")):
            a, b = case[0]("cuda"), case[0]("cuda")
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise RuntimeError(f"{name}: two runs differ")
    print("[kernel] window_attention_bwd: dq, dk, dv and dbias equal across "
          "two runs at every stage, with and without the mask; "
          "attention_bwd (dqkv), attention_generic (self and cross shapes), "
          "attention_qkv (fast and safe), mlp_fc (every shape), qkv_proj, "
          "task_decode, head_up4, invpt_tail (both forms, PASCAL and NYUD), "
          "invpt_attention (out and fused, every stage) and "
          "window_attention (every stage, with and without the mask) "
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
    # row 9's out (p rounded against the max over all keys)
    for name in ("invpt_attention@stage0", "invpt_attention@stage1",
                 "invpt_attention", "invpt_attention@nyud2"):
        sh = share(cases[name][0]("cuda")[0], cases[name][0]("plain")[0])
        results[name]["bit_equal_share"] = sh
        print(f"[kernel] {name}: bit-equal share {sh:.6f} of out",
              flush=True)
    # the shapes past the shipped configs: out's share for row 9, every
    # output's for the others
    for name in limit_cases:
        got, want = (t if isinstance(t, tuple) else (t,) for t in
                     (cases[name][0]("cuda"), cases[name][0]("plain")))
        if name.startswith("invpt_attention"):
            got, want = got[:1], want[:1]
        sh = sum((a == b).sum().item() for a, b in zip(got, want)) \
            / sum(a.numel() for a in got)
        results[name]["bit_equal_share"] = sh
        print(f"[kernel] {name}: bit-equal share {sh:.6f} of "
              f"{'out' if name.startswith('invpt') else 'the outputs'}",
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


def expected_nyud_train() -> dict:
    """One NYUD TaskPrompter-ViT-L training step: the PASCAL step's blocks
    and LayerNorms (the 4 tap blocks' emit path included); no task decode
    launch (16 channel windows take the windowed torch composition)."""
    return {**expected_train(), "task_decode": 0}


def expected_invpt_train() -> dict:
    """One InvPT-ViT-L training step (PASCAL or NYUD): the 24 ViT blocks'
    attention (the cached kernel: no block emits its qkv) and its 24
    backwards; block 0 (drop-path rate 0) the fused MLP half-block, blocks
    1..23 LayerNorm + the plain MLP under drop-path; LayerNorm = those 23 +
    the ViT's final norm + norm1 and norm2 of the 3 decoder stages + their 3
    task-merged stage norms; the 3 decoder MLPs; one message-passing
    attention a stage (its backward is torch); the tail trains on the dense
    composition (no tail kernel) and the 1x1 heads are torch."""
    return _expected(layernorm=23 + 1 + 6 + 3, attention_cached=24,
                     attention_bwd=24, mlp_ln_res=1, mlp_fc=23 + 3,
                     invpt_attention=3)


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


def _serve_model(p: dict, seed: int, size, batch: int = B, **kw):
    """A model built by ``build_model`` from config dict ``p`` (bf16, seeded
    random weights, full width and depth; ``kw`` to ``build_model``) and a
    seeded batch of ``batch`` (8) preprocessed images of ``size``."""
    from mtt_tpu_torch.inference import preprocess
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(p, img_size=size, device=dev, dtype=torch.bfloat16,
                        **kw).eval()
    init_weights(model, gen)
    rgb = torch.randint(0, 256, (batch, *size, 3), generator=gen,
                        device=dev)
    return model, preprocess(rgb)


def _serve_check(tag: str, title: str, model, x, want: dict) -> dict:
    """One eval forward through ``predict``: launch counts, shapes,
    finiteness, every map (and InvPT's intermediate predictions) against an
    f32 run of the same weights, imgs/s and peak memory. Returns the
    launch counts."""
    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.kernels import _build

    nb, size = x.shape[0], tuple(x.shape[1:3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    logits, preds = predict(model, x)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] {title}, {n_params / 1e6:.1f} M params, batch {nb} at "
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
            if k.shape != (nb, *size, n) or not torch.isfinite(k).all():
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
        if preds[t].shape[:3] != (nb, *size) or \
                not torch.isfinite(preds[t].float()).all():
            raise RuntimeError(f"{tag} {t}: bad prediction "
                               f"{tuple(preds[t].shape)}")
    del logits, preds, plain, plain_preds, ref, ref_preds
    ms = _time_ms(lambda: predict(model, x), reps=5, warmup=1)
    plain_ms = _time_ms(lambda: predict(model, x, impl="plain"), reps=3,
                        warmup=1)
    print(f"[{tag}] forward+postprocess {ms:.2f} ms = {nb / ms * 1e3:.2f} "
          f"imgs/s through the kernels; plain versions {plain_ms:.2f} ms = "
          f"{nb / plain_ms * 1e3:.2f} imgs/s; peak memory of the first "
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


class _DropPathMasks(torch.overrides.TorchFunctionMode):
    """Within it, the drop-path keep masks that each InvPT decoder block of
    ``model`` draws (``layers.drop_path``: one ``torch.rand`` over the batch
    from the generator a branch): ``masks[block]`` lists the attention
    branch's mask and the MLP branch's, a bool a sample."""

    def __init__(self, model):
        from mtt_tpu_torch.models.invpt import InvPTBlock
        super().__init__()
        self.masks, self._block, self._handles = {}, None, []
        for name, mod in model.named_modules():
            if isinstance(mod, InvPTBlock):
                self._handles += [
                    mod.register_forward_pre_hook(
                        lambda mod, args, name=name: self._enter(name, mod)),
                    mod.register_forward_hook(
                        lambda *_: setattr(self, "_block", None))]

    def _enter(self, name, mod):
        self._block = (name, mod.drop_path)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func is torch.rand and self._block is not None
                and kwargs.get("generator") is not None):
            name, rate = self._block
            self.masks.setdefault(name, []).append(
                (out < 1.0 - rate).tolist())
        return out

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        return super().__exit__(*exc)

    def dead(self):
        """The branches that every sample drops."""
        return [f"{name} {branch}" for name, ms in self.masks.items()
                for branch, m in zip(("attention", "MLP"), ms) if not any(m)]


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


def _train_paths():
    """(tag, title, training config, seed, expected launches, loss names) of
    the InvPT and NYUD TaskPrompter training steps (``invpt_train_phase``,
    ``nyud_train_phase``)."""
    from mtt_tpu_torch.models.wrappers import task_table
    from mtt_tpu_torch.train import (NYUD_INVPT_VITL_TRAIN, NYUD_VITL,
                                     INVPT_PASCAL_VITL_TRAIN)

    def keys(p):
        tasks, _ = task_table(p["train_db_name"], p["task_dictionary"])
        inter = p.get("intermediate_supervision", False)
        return {*tasks, "total", *(f"inter_{t}" for t in tasks if inter)}

    return (("invpt_train_pascal", f"InvPT-ViT-L PASCAL (5 tasks, "
             f"intermediate supervision), batch {BT} at {IMG}x{IMG}",
             INVPT_PASCAL_VITL_TRAIN, 16, expected_invpt_train(),
             keys(INVPT_PASCAL_VITL_TRAIN)),
            ("invpt_train_nyud", f"InvPT-ViT-L NYUD-v2 (4 tasks, "
             f"intermediate supervision), batch {BT} at {NYUD_IMG[0]}x"
             f"{NYUD_IMG[1]}", NYUD_INVPT_VITL_TRAIN, 9,
             expected_invpt_train(), keys(NYUD_INVPT_VITL_TRAIN)),
            ("nyud_train", f"TaskPrompter-ViT-L NYUD-v2 (16 channel windows, "
             f"no CTR, 768-wide heads), batch {BT} at {NYUD_IMG[0]}x"
             f"{NYUD_IMG[1]}", NYUD_VITL, 10, expected_nyud_train(),
             keys(NYUD_VITL)))


def _run_train_paths(tags) -> dict:
    """The ``_train_paths`` steps named in ``tags`` through ``_train_run``,
    each at the config's batch of 2 on seeded synthetic batches; returns
    their launch counts by tag."""
    from mtt_tpu_torch.train import make_trainer
    from mtt_tpu_torch.utils.train_utils import to_device

    dev = torch.device("cuda")
    counts = {}
    for tag, title, p, seed, want, keys in _train_paths():
        if tag not in tags:
            continue
        trainer, data = make_trainer(p, seed=seed, device=dev)
        batches = [to_device(data.batch(i * BT, BT), dev)
                   for i in range(TRAIN_STEPS)]
        counts[tag] = _train_run(tag, title, trainer, batches, want, BT,
                                 loss_keys=keys)
        del trainer, data, batches
        torch.cuda.empty_cache()
    return counts


def invpt_train_phase():
    """InvPT-ViT-L training steps with intermediate supervision on PASCAL
    and NYUD through the kernels; returns the launch counts of each."""
    return _run_train_paths(("invpt_train_pascal", "invpt_train_nyud"))


def nyud_train_phase():
    """NYUD TaskPrompter-ViT-L training steps through the kernels; returns
    the launch counts of one step."""
    return _run_train_paths(("nyud_train",))["nyud_train"]


EVAL_BATCHES = 2


def evaluate_phase():
    """``test_phase`` over 2 seeded synthetic batches of 8 at 512x512
    through the InvPT-ViT-L PASCAL eval model (bf16, the fused tail): the
    launch counts of the two forwards, finite scores for every task, the
    meter states on the card against the port's meters run on the CPU on
    the same predictions and labels (counts equal, float sums within 1e-6
    of themselves), and imgs/s of the whole loop (forward, post-processing,
    meter update; the scores read once). Returns the launch counts."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.evaluation.meters import PerformanceMeter
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.wrappers import task_table
    from mtt_tpu_torch.train import INVPT_PASCAL_VITL_TRAIN as p
    from mtt_tpu_torch.utils.train_utils import (eval_step, test_phase,
                                                 to_device)

    dev = torch.device("cuda")
    model, _ = _invpt_model()
    tasks, num_out = task_table(p["train_db_name"], p["task_dictionary"])
    data = SyntheticMT(tasks, num_out, (IMG, IMG), seed=11)
    batches = [to_device(data.batch(i * B, B), dev)
               for i in range(EVAL_BATCHES)]
    meter = PerformanceMeter(p, tasks, dev)

    torch.cuda.synchronize()
    _build.reset_counts()
    scores = test_phase(p, model, batches, meter=meter)
    counts = dict(_build.COUNTS)
    want = {k: EVAL_BATCHES * v for k, v in expected_invpt(False).items()}
    print(f"[evaluate] test_phase, InvPT-ViT-L PASCAL, {EVAL_BATCHES} "
          f"batches of {B} at {IMG}x{IMG} bf16; launches {counts}",
          flush=True)
    if counts != want:
        raise RuntimeError(f"evaluate launch counts {counts} != {want}")
    print(f"[evaluate] scores {json.dumps(scores)}", flush=True)
    if set(scores) != set(tasks) or not all(
            math.isfinite(v) for s in scores.values() for v in s.values()):
        raise RuntimeError(f"evaluate: scores of {sorted(scores)} not all "
                           f"finite, or not every task")
    # the eval steps that test_phase takes, with their predictions kept,
    # and the CPU meters fed the same predictions and labels
    meter.reset()
    states, cpu = meter.states, PerformanceMeter(p, tasks, "cpu")
    for batch in batches:
        processed, states, _ = eval_step(model, meter, batch, states)
        cpu.update({t: v.cpu() for t, v in processed.items()},
                   {t: batch[t].cpu() for t in tasks})
    meter.states = states
    worst = 0.0
    for t in tasks:
        for k, v in meter.states[t].items():
            w = cpu.states[t][k]
            if v.device.type != "cuda" or v.dtype != w.dtype:
                raise RuntimeError(f"evaluate: {t}.{k} is {v.dtype} on "
                                   f"{v.device}")
            if w.dtype == torch.int64:
                if not torch.equal(v.cpu(), w):
                    raise RuntimeError(f"evaluate: {t}.{k} counts differ "
                                       f"from the CPU's")
                continue
            rel = ((v.cpu().double() - w.double()).abs()
                   / w.double().abs().clamp_min(1e-30)).max().item()
            worst = max(worst, rel)
            if not rel <= 1e-6:
                raise RuntimeError(f"evaluate: {t}.{k} {rel:.3g} from the "
                                   f"CPU's, over 1e-6")
    print(f"[evaluate] meter states on the card against the CPU meters on "
          f"the same predictions: counts equal, float sums within {worst:.3g}"
          f" of themselves (tol 1e-6)", flush=True)
    del cpu
    ms = _wall_ms(lambda: test_phase(p, model, batches, meter=meter),
                  reps=3)
    print(f"[evaluate] test_phase {ms:.2f} ms for {EVAL_BATCHES * B} images "
          f"= {EVAL_BATCHES * B / ms * 1e3:.2f} imgs/s (median of 3, host "
          f"clock; batches already on the card)", flush=True)
    return counts


LOOP_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "pascal", "taskprompter_vitLp16.yml")
LOOP_ITERS, LOOP_VAL, LOOP_MAIN_ITERS = 4, 2, 6
LOOP_VAL_BATCHES = 11            # 64 val images in batches of 6
STEP_MS = {}                     # median ms per step of the training phases


def _tf_records(path: str) -> int:
    """The number of TFRecord frames of a TensorBoard event file."""
    with open(path, "rb") as f:
        data = f.read()
    pos = n = 0
    while pos < len(data):
        length, = struct.unpack("<Q", data[pos:pos + 8])
        pos += 8 + 4 + length + 4
        n += 1
    if pos != len(data):
        raise RuntimeError(f"loop: {path} ends inside a record")
    return n


def _finite_scores(path: str, tasks) -> dict:
    with open(path) as f:
        scores = json.load(f)
    if set(scores) != set(tasks) or not all(
            math.isfinite(v) for s in scores.values() for v in s.values()):
        raise RuntimeError(f"loop: {path} holds {scores}, not finite scores "
                           f"of {sorted(tasks)}")
    return scores


def loop_phase():
    """The training loop of ``python -m mtt_tpu_torch.main`` on the
    TaskPrompter-ViT-L PASCAL experiment, at full width and depth, in a
    temporary working directory (removed after): what ``main`` builds, then
    ``train_phase`` for 4 iterations with an eval and a checkpoint every 2,
    then ``main`` with ``--max_iter 6``, resumed from step 4 (see the module
    docstring). Returns the launch counts of the loop."""
    from mtt_tpu_torch import main as port_main
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.data.loader import prefetch_to_device
    from mtt_tpu_torch.evaluation import save_preds
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils.logger import install
    from mtt_tpu_torch.utils.tb_writer import flatten_scores
    from mtt_tpu_torch.utils import train_utils
    from mtt_tpu_torch.utils.train_utils import Trainer, train_phase

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cwd, stdout = os.getcwd(), sys.stdout
    real_png, real_eval = save_preds.write_png, train_utils.test_phase
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    written = []

    def counted_png(path, img):
        written.append(os.path.basename(path))
        real_png(path, img)

    def build(seed):
        """The model and trainer of ``main``: seeded weights, bf16 with an
        f32 master."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = build_model(p, img_size=tuple(p.TRAIN.SCALE), device=dev,
                            dtype=torch.float32)
        init_weights(model, gen)
        return Trainer(model, p, p.TASKS.NAMES, torch.bfloat16, gen,
                       log_fn=lambda line: (lines.append(line), print(line)))

    def restore_stdout():
        if sys.stdout is not stdout:
            sys.stdout.close()
            sys.stdout = stdout

    os.chdir(work)
    save_preds.write_png = counted_png
    torch.cuda.reset_peak_memory_stats()
    try:
        # 1. what main builds, and the loop
        p = create_config(LOOP_CONFIG, {"run_mode": "train"})
        install(os.path.join(p["output_dir"], "log_file.txt"))
        lines = []
        trainer = build(5)
        train_tf, val_tf = cc.get_transformations(p)
        train_ds = cc.get_dataset(p, "train", train_tf)
        train_loader = cc.get_train_dataloader(p, train_ds)
        val_loader = cc.get_test_dataloader(p, cc.get_dataset(p, "val",
                                                              val_tf))
        tasks = p.TASKS.NAMES
        # the loader alone: ms per batch of trBatch samples through the
        # transforms, from the pool's start
        t = time.perf_counter()
        for i, _ in enumerate(train_loader):
            if i == 3:
                break
        loader_ms = (time.perf_counter() - t) * 1e3 / 4
        bare = STEP_MS.get("train")
        print(f"[loop] loader {loader_ms:.1f} ms per batch of "
              f"{p['trBatch']} (4 batches, {p.get('nworkers', 2)} threads, "
              f"from the pool's start, the card idle) beside the bare step "
              f"{'%.2f ms (phase 9)' % bare if bare else 'not run'}",
              flush=True)
        save_s, eval_s = [], []
        real_save = trainer.save_checkpoint

        def timed_save(ckpt_dir):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = real_save(ckpt_dir)
            save_s.append(time.perf_counter() - t)
            return path

        def timed_eval(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_eval(*args, **kw)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t)
            return out

        trainer.save_checkpoint = timed_save
        train_utils.test_phase = timed_eval
        torch.cuda.synchronize()
        _build.reset_counts()
        t = time.perf_counter()
        history = train_phase(p, trainer, train_loader, val_loader,
                              max_iter=LOOP_ITERS, val_interval=LOOP_VAL,
                              log_every=1)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
        counts = dict(_build.COUNTS)
        train_utils.test_phase = real_eval
        restore_stdout()
        evals = LOOP_ITERS // LOOP_VAL
        want = {k: LOOP_ITERS * v + evals * LOOP_VAL_BATCHES
                * expected_eval("factored")[k]
                for k, v in expected_train().items()}
        print(f"[loop] train_phase, TaskPrompter-ViT-L PASCAL from "
              f"{os.path.relpath(LOOP_CONFIG, cwd)}, {LOOP_ITERS} iterations "
              f"of batch {p['trBatch']} at {p.TRAIN.SCALE}, eval and "
              f"checkpoint every {LOOP_VAL} over {LOOP_VAL_BATCHES} batches "
              f"of {p['valBatch']}: {loop_s:.2f} s; launches {counts}",
              flush=True)
        if counts != want:
            raise RuntimeError(f"loop launch counts {counts} != {want}")
        if [h["iter"] for h in history] != list(range(1, LOOP_ITERS + 1)) \
                or not all(math.isfinite(v) for h in history
                           for k, v in h.items() if k != "iter"):
            raise RuntimeError(f"loop: history {history} is not "
                               f"{LOOP_ITERS} iterations of finite losses")
        rates = [float(m.group(1)) for m in (
            re.search(r"\(([0-9.]+) imgs/s\)", ln) for ln in lines) if m]
        print(f"[loop] losses per iteration "
              f"{[round(h['total'], 5) for h in history]}; imgs/s from the "
              f"log lines {rates} (the first with the loader's start)",
              flush=True)
        scores = [_finite_scores(os.path.join(
            p["save_dir"], f"results_iter{it}.json"), tasks)
            for it in range(LOOP_VAL, LOOP_ITERS + 1, LOOP_VAL)]
        print(f"[loop] scores at iteration {LOOP_ITERS} "
              f"{json.dumps(scores[-1])}", flush=True)
        names = {f"synth_{i:06d}.png" for i in range(64)}
        on_disk = set(os.listdir(os.path.join(p["save_dir"], "edge")))
        if on_disk != names or sorted(written) != sorted(list(names) * evals):
            raise RuntimeError(f"loop: {len(written)} edge PNG writes of "
                               f"{len(set(written))} names, {len(on_disk)} "
                               f"files; want {evals} x 64, none for the pad "
                               f"samples")
        ck = p["checkpoint"]
        with open(os.path.join(ck, "latest.txt")) as f:
            latest = f.read()
        step_files = sorted(f for f in os.listdir(ck) if f.endswith(".pt"))
        if latest != str(LOOP_ITERS) or step_files != [
                f"step_{it}.pt" for it in range(LOOP_VAL, LOOP_ITERS + 1,
                                                 LOOP_VAL)]:
            raise RuntimeError(f"loop: checkpoints {step_files}, latest "
                               f"{latest!r}")
        tb_dir = os.path.join(p["save_dir"], "tb")
        events = [f for f in os.listdir(tb_dir)
                  if f.startswith("events.out.tfevents.")]
        rows = sum(len(h) - 1 + 2 for h in history) + sum(
            len(flatten_scores(sc)) for sc in scores)
        with open(os.path.join(tb_dir, "scalars.csv")) as f:
            csv_rows = len(f.read().splitlines()) - 1
        if len(events) != 1 or csv_rows != rows or \
                _tf_records(os.path.join(tb_dir, events[0])) != rows + 1:
            raise RuntimeError(f"loop: TensorBoard files {events} with "
                               f"{csv_rows} CSV rows, want {rows}")
        if not os.path.isfile(os.path.join(p["output_dir"], "log_file.txt")):
            raise RuntimeError("loop: no log_file.txt")
        ck_bytes = os.path.getsize(os.path.join(ck, f"step_{LOOP_ITERS}.pt"))

        # a trainer restored from step 4 and the loop's own, one step each
        restored = build(6)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = restored.restore_checkpoint(ck)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        if step != LOOP_ITERS:
            raise RuntimeError(f"loop: restored step {step}")
        fixed = next(iter(prefetch_to_device(train_loader, dev)))
        with _deterministic():
            la, lb = trainer.step(fixed), restored.step(fixed)
            torch.cuda.synchronize()
        diff = []
        for (n, _), a, b in zip(trainer.model.named_parameters(),
                                trainer.master, restored.master):
            sa, sb = trainer.optimizer.state[a], restored.optimizer.state[b]
            if not torch.equal(a, b) or any(not torch.equal(sa[k], sb[k])
                                            for k in sa):
                diff.append(n)
        diff += [n for (n, a), (_, b) in zip(trainer.model.named_buffers(),
                                             restored.model.named_buffers())
                 if not torch.equal(a, b)]
        if diff or any(not torch.equal(la[k], lb[k]) for k in la):
            raise RuntimeError(f"loop: the restored trainer's step differs "
                               f"from the loop's in {diff[:8]} ({len(diff)})")
        print(f"[loop] a trainer restored from step {LOOP_ITERS} and the "
              f"loop's own took one step on one batch under deterministic "
              f"algorithms: {len(trainer.master)} master weights, their Adam "
              f"moments, {sum(1 for _ in trainer.model.buffers())} buffers "
              f"and the losses equal to the bit", flush=True)
        print(f"[loop] checkpoint step_{LOOP_ITERS}.pt "
              f"{ck_bytes / 2 ** 30:.3f} GiB; save {[round(v, 2) for v in save_s]} s, restore "
              f"{restore_s:.2f} s (file cache warm)", flush=True)
        print(f"[loop] test_phase {[round(v, 2) for v in eval_s]} s for 64 "
              f"images each (forwards, meters, 64 edge PNGs)", flush=True)
        del trainer, restored, fixed, la, lb
        os.remove(os.path.join(ck, f"step_{LOOP_VAL}.pt"))   # disk room
        torch.cuda.empty_cache()

        # 2. the CLI itself, in the same directory: resumes from step 4
        _build.reset_counts()
        rc = port_main.main(["--config_exp", LOOP_CONFIG, "--max_iter",
                             str(LOOP_MAIN_ITERS)])
        torch.cuda.synchronize()
        main_counts = dict(_build.COUNTS)
        restore_stdout()
        steps = LOOP_MAIN_ITERS - LOOP_ITERS
        want = {k: steps * v + LOOP_VAL_BATCHES * expected_eval(
            "factored")[k] for k, v in expected_train().items()}
        with open(os.path.join(p["output_dir"], "log_file.txt")) as f:
            log = f.read()
        _finite_scores(os.path.join(
            p["save_dir"], f"results_iter{LOOP_MAIN_ITERS}.json"), tasks)
        if rc != 0 or f"resumed from step {LOOP_ITERS}" not in log or \
                not os.path.isfile(os.path.join(
                    ck, f"step_{LOOP_MAIN_ITERS}.pt")) or \
                main_counts != want:
            raise RuntimeError(f"loop: main returned {rc}, launches "
                               f"{main_counts} (want {want}), or did not "
                               f"resume from step {LOOP_ITERS} and write "
                               f"step_{LOOP_MAIN_ITERS}")
        print(f"[loop] main --max_iter {LOOP_MAIN_ITERS}: resumed from step "
              f"{LOOP_ITERS}, {steps} steps, results_iter{LOOP_MAIN_ITERS}"
              f".json and step_{LOOP_MAIN_ITERS}.pt written; launches as "
              f"expected", flush=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[loop] peak memory {peak:.2f} GiB; phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        return counts
    finally:
        restore_stdout()
        save_preds.write_png = real_png
        train_utils.test_phase = real_eval
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


CS3D_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "cityscapes3d", "taskprompter_swinB.yml")
DET_IMAGES = 8                   # the val set cut to 2 batches of valBatch 4
# the card's decode against the CPU's: scores and thresholds (f32 sigmoids
# and exps of two libraries differ in the last bits), the records' fields
# relative to their largest value in the image
DET_SCORE_TOL, DET_IOU_TOL, DET_FIELD_TOL = 1e-5, 1e-5, 1e-4


def _cs3d_trainer(run_mode: str, seed: int):
    """``create_config`` of the Cityscapes-3D YAML and a seeded trainer of
    Swin-B as ``main`` builds it (bf16, f32 master), the class bias at prior
    0.5 so that the random weights' detections pass ``score_thr`` and the
    decode, the export and the evaluator do their work on 200 boxes an
    image."""
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model
    from mtt_tpu_torch.utils.train_utils import Trainer
    dev = torch.device("cuda")
    p = create_config(CS3D_CONFIG, {"run_mode": run_mode})
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(p, img_size=tuple(p.TRAIN.SCALE), device=dev,
                        dtype=torch.float32)
    init_weights(model, gen)
    with torch.no_grad():
        model.det_head.fcos3d.conv_cls.bias.zero_()
    return p, Trainer(model, p, p.TASKS.NAMES, torch.bfloat16, gen)


@contextlib.contextmanager
def _cut_val_set(cc):
    """``common_config.get_dataset`` with the val split cut to
    ``DET_IMAGES`` samples."""
    real = cc.get_dataset

    def cut(p, split, transforms=None, overfit=False):
        ds = real(p, split, transforms, overfit)
        if split != "train":
            ds.length = DET_IMAGES
        return ds
    cc.get_dataset = cut
    try:
        yield
    finally:
        cc.get_dataset = real


def _det_events(c, det_cfg) -> list:
    """The decisions of one image's CPU decode (``decode_candidates``) that
    lie within the tolerances of a threshold, where the card's last bits
    may decide the other way: a candidate's score at ``score_thr``; a
    candidate at ``nms_thr`` IoU with a box of its class that is kept and
    scores higher, and no such box over the threshold by more than the
    tolerance (which would suppress it on both devices); the kept scores at
    the ``max_per_img`` cut."""
    from mtt_tpu_torch.detection.iou3d import _greedy_nms_from_iou
    t = det_cfg["test_cfg"]
    s, iou = c["nms_scores"], c["iou"]
    thr_s, thr_n = float(t["score_thr"]), float(t["nms_thr"])
    valid = s > thr_s
    keep = _greedy_nms_from_iou(iou, s, thr_n, valid)
    events = []
    if ((s - thr_s).abs() <= DET_SCORE_TOL).any():
        events.append("score_thr")
    order = torch.argsort(s, dim=1, descending=True, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(s.shape[1]).expand_as(order))
    # before[c, i, j]: i kept and ahead of j in class c's sweep
    before = keep[:, :, None] & (rank[:, :, None] < rank[:, None, :])
    near = ((iou - thr_n).abs() <= DET_IOU_TOL)[None] & before
    sure = (iou > thr_n + DET_IOU_TOL)[None] & before
    if (valid & near.any(1) & ~sure.any(1)).any():
        events.append("nms_thr")
    kept = torch.sort(s[keep], descending=True).values
    n = int(t["max_per_img"])
    if len(kept) > n and kept[n - 1] - kept[n] <= DET_SCORE_TOL:
        events.append("max_per_img")
    return events


def _flat_objects(objs):
    """{field: (n, k) array} of official-format objects."""
    import numpy as np
    return {"score": np.array([[o["score"]] for o in objs]),
            **{f"2d.{k}": np.array([o["2d"][k] for o in objs])
               for k in ("modal", "amodal")},
            **{f"3d.{k}": np.array([o["3d"][k] for o in objs])
               for k in ("center", "dimensions", "rotation")}}


def _records_check(records, captured, det_cfg) -> dict:
    """The records ``test_phase`` made on the card against the port's CPU
    decode and export of the same head outputs (copied to the host): per
    image, when no decision of the CPU decode lies within the tolerances of
    a threshold (``_det_events``), the same number of boxes, each card box
    matched to the CPU box of its label nearest in 3D centre, its score
    within DET_SCORE_TOL and every other field within DET_FIELD_TOL of the
    field's largest value in the image; an image with such a decision has
    only the boxes both keep compared, and is counted. Returns the worst
    errors and counts."""
    import numpy as np
    from mtt_tpu_torch.detection.det_eval import DetRecordAccumulator
    from mtt_tpu_torch.detection.det_model import decode_candidates
    cpu = DetRecordAccumulator(det_cfg)
    events = {}
    for head, batch in captured:
        host = tuple([t.cpu() for t in lvls] for lvls in head)
        cpu.add_batch(host, batch)
        for i, meta in enumerate(batch["meta"]):
            if meta.get("pad"):
                continue
            c = decode_candidates(
                tuple([t[i] for t in lvls] for lvls in host),
                torch.from_numpy(np.asarray(meta["K_matrix"], np.float32)),
                det_cfg, tuple(det_cfg["strides"]))
            events[meta["img_name"]] = _det_events(c, det_cfg)
    if [r[0] for r in records] != [r[0] for r in cpu.records]:
        raise RuntimeError("detect: the card's and the CPU's records name "
                           "other images")
    worst = {"score": 0.0, "field": 0.0}
    boxes = exempt = 0
    for (name, gt, got), (_, cgt, want) in zip(records, cpu.records):
        near = bool(events[name])
        exempt += near
        if gt != cgt:
            raise RuntimeError(f"detect: {name}: ground truth differs")
        if len(got) != len(want) and not near:
            raise RuntimeError(f"detect: {name}: {len(got)} boxes on the "
                               f"card, {len(want)} on the CPU")
        if not got or not want:
            continue
        g, w = _flat_objects(got), _flat_objects(want)
        scale = {k: max(np.abs(v).max(), 1e-30) for k, v in w.items()}
        labels = np.array([o["label"] for o in want])
        for j, o in enumerate(got):
            same = np.nonzero(labels == o["label"])[0]
            d = np.abs(w["3d.center"][same] - g["3d.center"][j]).max(1) \
                / scale["3d.center"] if len(same) else np.array([np.inf])
            if d.min() > DET_FIELD_TOL and near:
                continue            # a box the other decode did not keep
            if not len(same):
                raise RuntimeError(f"detect: {name}: card box {j} "
                                   f"({o['label']}) has no CPU box")
            m = same[d.argmin()]
            boxes += 1
            worst["score"] = max(worst["score"], float(abs(
                g["score"][j, 0] - w["score"][m, 0])))
            for k in g:
                if k != "score":
                    worst["field"] = max(worst["field"], float(
                        np.abs(g[k][j] - w[k][m]).max() / scale[k]))
    if worst["score"] > DET_SCORE_TOL or worst["field"] > DET_FIELD_TOL:
        raise RuntimeError(f"detect: the card's records differ from the "
                           f"CPU's decode: {worst}")
    return {"images": len(records), "boxes": boxes, "exempt": exempt,
            "events": {k: v for k, v in events.items() if v}, **worst}


def detect_phase():
    """Phase 15: the Cityscapes-3D evaluation and the inference CLI as a
    user runs them, on TaskPrompter-Swin-B (and ViT-L PASCAL for the CLI),
    full width and depth, bf16, seeded weights, seeded synthetic data, in a
    temporary working directory (see the module docstring). Returns the
    launch counts of each part."""
    import io

    import numpy as np
    from mtt_tpu_torch import inference
    from mtt_tpu_torch import main as port_main
    from mtt_tpu_torch.detection import det_eval
    from mtt_tpu_torch.evaluation.save_preds import read_png, write_png
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils.train_utils import test_phase, train_phase

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_detect_")
    real_add = det_eval.DetRecordAccumulator.add_batch
    counts = {}
    os.chdir(work)
    try:
        # a. test_phase over 2 batches of 4 through the val transforms
        p, trainer = _cs3d_trainer("infer", 12)
        p["save_dir"] = os.path.join(work, "a")
        model = trainer.model
        with _cut_val_set(cc):
            _, val_tf = cc.get_transformations(p)
            val = cc.get_test_dataloader(p, cc.get_dataset(p, "val", val_tf))
        captured, accs = [], []

        def capture(acc, head_out, batch):
            captured.append((tuple([t.clone() for t in lvls]
                                   for lvls in head_out), batch))
            if acc not in accs:
                accs.append(acc)
            real_add(acc, head_out, batch)

        det_eval.DetRecordAccumulator.add_batch = capture
        torch.cuda.synchronize()
        _build.reset_counts()
        t = time.perf_counter()
        scores = test_phase(p, model, val)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        counts["detect_eval"] = dict(_build.COUNTS)
        det_eval.DetRecordAccumulator.add_batch = real_add
        want = {k: 2 * v for k, v in expected_swin().items()}
        print(f"[detect] test_phase, TaskPrompter-Swin-B Cityscapes-3D from "
              f"{os.path.relpath(CS3D_CONFIG, cwd)}, {DET_IMAGES} images "
              f"in {len(captured)} batches of {p['valBatch']} at "
              f"{p.TRAIN.SCALE} bf16: {eval_s:.2f} s = "
              f"{DET_IMAGES / eval_s:.2f} imgs/s (forwards, meters, decode, "
              f"export, scoring; the loader's samples made on the host); "
              f"launches {counts['detect_eval']}", flush=True)
        if counts["detect_eval"] != want:
            raise RuntimeError(f"detect launch counts "
                               f"{counts['detect_eval']} != {want}")
        print(f"[detect] scores {json.dumps(scores)}", flush=True)
        det = scores.get("3ddet", {})
        if set(scores) != {"semseg", "depth", "3ddet"} or not all(
                math.isfinite(v) for s in scores.values()
                for v in s.values()) or set(det) != {"mDetection_Score",
                                                     "mAP"} or not all(
                0.0 <= v <= 1.0 for v in det.values()):
            raise RuntimeError(f"detect: scores {scores}")
        files = sorted(os.listdir(os.path.join(p["save_dir"], "3ddet")))
        if len(files) != DET_IMAGES or len(accs) != 1:
            raise RuntimeError(f"detect: {len(files)} JSON files, "
                               f"{len(accs)} accumulators")
        acc = accs[0]
        check = _records_check(acc.records, captured, model.det_cfg)
        print(f"[detect] the card's records against the CPU's decode and "
              f"export of the same head outputs: {check['images']} images, "
              f"{check['boxes']} boxes matched; worst score error "
              f"{check['score']:.3g} (tol {DET_SCORE_TOL}), worst field "
              f"error {check['field']:.3g} of its largest value (tol "
              f"{DET_FIELD_TOL}); images with a decision within the "
              f"tolerances of a threshold (common boxes compared only): "
              f"{check['exempt']} {check['events']}", flush=True)
        head, batch = captured[0]
        K = torch.from_numpy(np.stack([m["K_matrix"] for m in
                                       batch["meta"]])).to(dev)
        dec_ms = _wall_ms(lambda: inference.decode_3ddet(
            head, K, model.det_cfg), reps=3)
        x = torch.from_numpy(batch["image"]).to(dev, torch.bfloat16)
        fwd_ms = _wall_ms(torch.no_grad()(lambda: model(x, train=False)),
                          reps=3)
        t = time.perf_counter()
        acc.evaluate()
        score_s = time.perf_counter() - t
        t = time.perf_counter()
        n_loaded = sum(len(b["meta"]) for b in val)
        loader_s = time.perf_counter() - t
        n_boxes = sum(len(r[2]) for r in acc.records)
        print(f"[detect] where test_phase's time goes: the loader alone "
              f"{loader_s:.2f} s for {n_loaded} samples (the card idle); a "
              f"forward of {len(batch['meta'])} {fwd_ms:.1f} ms, its decode "
              f"{dec_ms:.2f} ms (wall, median of 3); scoring "
              f"{len(acc.records)} images, {n_boxes} boxes {score_s:.2f} s "
              f"(the evaluator on the host)", flush=True)
        del trainer, model, captured, accs, acc, head, val, x
        torch.cuda.empty_cache()

        # b. main --run_mode infer --vis on the YAML
        out = io.StringIO()
        _build.reset_counts()
        t = time.perf_counter()
        with _cut_val_set(cc), contextlib.redirect_stdout(out):
            rc = port_main.main(["--config_exp", CS3D_CONFIG, "--run_mode",
                                 "infer", "--vis"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        counts["detect_main"] = dict(_build.COUNTS)
        text = out.getvalue()
        scores = json.loads(text[text.index("\n{") + 1:])
        res = os.path.join(work, "work_dirs", "TaskPrompter_CS_swinB",
                           "results")
        made = {d: len(os.listdir(os.path.join(res, d)))
                for d in ("vis_semseg", "vis_depth", "3ddet")}
        # the scoring forwards also render --vis's maps: no second pass
        want = {k: 2 * v for k, v in expected_swin().items()}
        print(f"[detect] main --run_mode infer --vis: rc {rc}, {main_s:.1f} "
              f"s; scores {json.dumps(scores)}; files {made}; launches "
              f"{counts['detect_main']}", flush=True)
        if rc != 0 or "3ddet" not in scores or counts["detect_main"] != want \
                or made != dict.fromkeys(made, DET_IMAGES):
            raise RuntimeError(f"detect: main --vis returned {rc}, scores "
                               f"{sorted(scores)}, files {made}, launches "
                               f"(want {want})")
        shape = read_png(os.path.join(res, "vis_semseg",
                                      "synth_000000.png")).shape
        if shape != (*SW_OUT, 3):
            raise RuntimeError(f"detect: vis_semseg PNG of shape {shape}")

        # c. train_phase for 2 iterations with a save_dir and an eval at 2
        p, trainer = _cs3d_trainer("train", 13)
        with _cut_val_set(cc):
            train_tf, val_tf = cc.get_transformations(p)
            train = cc.get_train_dataloader(p, cc.get_dataset(p, "train",
                                                              train_tf))
            val = cc.get_test_dataloader(p, cc.get_dataset(p, "val", val_tf))
        torch.cuda.synchronize()
        _build.reset_counts()
        t = time.perf_counter()
        history = train_phase(p, trainer, train, val, max_iter=2,
                              val_interval=2, log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        counts["detect_train"] = dict(_build.COUNTS)
        forwards = 1 + DET_IMAGES // int(p["valBatch"])
        want = {k: 2 * v + forwards * expected_swin()[k]
                for k, v in expected_swin_train().items()}
        vis_dir = os.path.join(p["save_dir"], "train", "3ddet")
        vis = sorted(os.listdir(vis_dir))
        with open(os.path.join(p["save_dir"], "results_iter2.json")) as f:
            res2 = json.load(f)
        print(f"[detect] train_phase, 2 iterations of batch {p['trBatch']}, "
              f"eval at 2: {train_s:.1f} s; losses "
              f"{[round(h['total'], 4) for h in history]}; train/3ddet "
              f"{vis}; results_iter2 {json.dumps(res2)}; launches "
              f"{counts['detect_train']}", flush=True)
        if counts["detect_train"] != want:
            raise RuntimeError(f"detect train launch counts "
                               f"{counts['detect_train']} != {want}")
        pngs = [v for v in vis if v.endswith(".png")]
        if len(vis) != 2 or len(pngs) != 1 or \
                not all(v.startswith("b0_synth_") for v in vis) or \
                not 0.0 <= res2.get("3ddet", {}).get(
                    "mDetection_Score", -1.0) <= 1.0:
            raise RuntimeError(f"detect: train/3ddet {vis}, results "
                               f"{res2}")
        if read_png(os.path.join(vis_dir, pngs[0])).shape != (*SW_IMG, 3):
            raise RuntimeError("detect: the wireframe PNG's shape")
        del trainer, train, val
        torch.cuda.empty_cache()

        # d. the inference CLI: ViT-L PASCAL from a checkpoint, Swin-B
        from mtt_tpu_torch.config import create_config
        from mtt_tpu_torch.models.layers import init_weights
        from mtt_tpu_torch.models.wrappers import build_model
        from mtt_tpu_torch.utils.train_utils import Trainer
        vp = create_config(LOOP_CONFIG, {"run_mode": "infer"})
        gen = torch.Generator(device=dev).manual_seed(14)
        vmodel = build_model(vp, img_size=tuple(vp.TEST.SCALE), device=dev,
                             dtype=torch.float32)
        init_weights(vmodel, gen)
        vtrainer = Trainer(vmodel, vp, vp.TASKS.NAMES, torch.bfloat16, gen)
        vtrainer.save_checkpoint(os.path.join(work, "ck_vitl"))
        rng = np.random.default_rng(15)
        yy, xx = np.mgrid[0:375, 0:500]
        photo = np.stack([127 + 100 * np.sin(xx / (9.0 + 3 * c))
                          * np.cos(yy / (7.0 + 2 * c)) for c in range(3)], -1)
        photo = np.clip(photo + rng.normal(0, 8, photo.shape), 0,
                        255).astype(np.uint8)
        with open(os.path.join(work, "pascal.png"), "wb") as f:
            f.write(_png_encode(photo))
        _build.reset_counts()
        t = time.perf_counter()
        rc = inference.main(["--config_exp", LOOP_CONFIG, "--image_path",
                             os.path.join(work, "pascal.png"), "--ckpt_dir",
                             os.path.join(work, "ck_vitl"), "--output_dir",
                             os.path.join(work, "out_vitl"), "--dtype",
                             "bfloat16"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        counts["detect_cli_vitl"] = dict(_build.COUNTS)
        _, img = inference.load_image(os.path.join(work, "pascal.png"),
                                      tuple(vp.TEST.SCALE))
        x = inference.preprocess(torch.from_numpy(img[None]).to(dev))
        _, preds = inference.predict(vmodel, x.to(torch.bfloat16))
        outs = sorted(os.listdir(os.path.join(work, "out_vitl")))
        same = [t for t in vp.TASKS.NAMES if np.array_equal(
            read_png(os.path.join(work, "out_vitl", f"{t}.png")),
            inference.visualize(t, preds[t][0].float().cpu().numpy()))]
        print(f"[detect] inference CLI, TaskPrompter-ViT-L PASCAL from a "
              f"checkpoint, a 375x500 PNG: rc {rc}, {cli_s:.1f} s (model "
              f"build and restore included); wrote {outs}; equal to "
              f"visualize(predict) of the resized input: {same}; launches "
              f"{counts['detect_cli_vitl']}", flush=True)
        if rc != 0 or counts["detect_cli_vitl"] != expected_eval("factored") \
                or len(same) != len(vp.TASKS.NAMES) or len(outs) != 5:
            raise RuntimeError(f"detect: the ViT-L CLI (launches want "
                               f"{expected_eval('factored')})")
        del vmodel, vtrainer, preds, x
        torch.cuda.empty_cache()
        cs_photo = photo[np.arange(SW_IMG[0]) % 375][
            :, np.arange(SW_IMG[1]) % 500]
        with open(os.path.join(work, "cs.png"), "wb") as f:
            f.write(_png_encode(cs_photo))
        write_png(os.path.join(work, "cs_plain.png"), cs_photo)
        read_ms = {}
        for name in ("cs.png", "cs_plain.png"):
            t = time.perf_counter()
            got = read_png(os.path.join(work, name))
            read_ms[name] = (time.perf_counter() - t) * 1e3
            if not np.array_equal(got, cs_photo):
                raise RuntimeError(f"detect: read_png of {name}")
        print(f"[detect] read_png of the {SW_IMG[0]}x{SW_IMG[1]} RGB input "
              f"on the host: scanline filters 0-4 in turn "
              f"{read_ms['cs.png']:.1f} ms, filter 0 only (write_png) "
              f"{read_ms['cs_plain.png']:.1f} ms; both equal to the image",
              flush=True)
        _build.reset_counts()
        t = time.perf_counter()
        rc = inference.main(["--config_exp", CS3D_CONFIG, "--image_path",
                             os.path.join(work, "cs.png"), "--output_dir",
                             os.path.join(work, "out_cs"), "--dtype",
                             "bfloat16"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        counts["detect_cli_swin"] = dict(_build.COUNTS)
        shapes = {f: read_png(os.path.join(work, "out_cs", f)).shape
                  for f in sorted(os.listdir(os.path.join(work, "out_cs")))}
        print(f"[detect] inference CLI, TaskPrompter-Swin-B Cityscapes-3D "
              f"(random weights), a {SW_IMG[0]}x{SW_IMG[1]} PNG, the "
              f"Stuttgart camera: rc {rc}, {cli_s:.1f} s; wrote {shapes}; "
              f"launches {counts['detect_cli_swin']}", flush=True)
        if rc != 0 or counts["detect_cli_swin"] != expected_swin() or \
                shapes != {"3ddet.png": (*SW_IMG, 3),
                           "depth.png": (*SW_OUT, 3),
                           "semseg.png": (*SW_OUT, 3)}:
            raise RuntimeError("detect: the Swin-B CLI")
        print(f"[detect] peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        return counts
    finally:
        det_eval.DetRecordAccumulator.add_batch = real_add
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


INVPT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "pascal", "invpt_vitLp16.yml")
# (tag, title, config, seed) of the convert phase's three checkpoints
CONVERT_PATHS = (
    ("convert_vitl", "TaskPrompter-ViT-L PASCAL", LOOP_CONFIG, 21),
    ("convert_invpt", "InvPT-ViT-L PASCAL", INVPT_CONFIG, 22),
    ("convert_swin", "TaskPrompter-Swin-B Cityscapes-3D", CS3D_CONFIG, 23))
NPZ_GRID = 24                    # ViT-L/16 pretrained at 384x384
CONVERT_VARY = 0.01              # ``_vary``'s scale in the convert phase


def _reference_rules(kind: str, tasks, heads: int, fpn_inputs: int):
    """(port key pattern, fn(match, tensor) -> {reference key: tensor}) of
    the inverse map of one model kind (the port model's class name): the
    reference repository's module
    tree (taskprompter.py, transformer_net.py, transformer_decoder.py,
    invpt.py, taskprompter_swin.py, det_head.py, fpn.py), written here apart
    from mtt_tpu_torch/models/convert_torch.py. The first pattern that
    matches a key maps it; ``fpn_inputs`` counts the FPN's lateral convs
    (the extra levels' convs follow them in the reference's list)."""
    T = len(tasks)

    def qkv(v):          # head-major (H, 3, D) rows -> (3, H, D)
        rows = v.shape[0]
        return v.reshape(heads, 3, rows // (3 * heads), *v.shape[1:]) \
            .transpose(0, 1).reshape(v.shape).contiguous()

    def per_task(fmt):   # a grouped tensor split over the tasks, task-major
        return lambda m, v: {
            fmt(m, ti, t): c for ti, (t, c) in enumerate(zip(
                tasks, [v] * T if v.dim() == 0 else v.chunk(T, 0)))}

    def one(fmt, fn=lambda v: v):
        return lambda m, v: {fmt(m): fn(v)}

    fuse = {"0": 0, "1": 1, "2": 4}
    own = [(r"backbone\.(pos_embed|cls_token|task_prompts|norm\.\w+|"
            r"patch_embed\.proj\.\w+)$", one(lambda m: m[0]))]
    if kind == "TaskPrompterNet":
        b = "backbone."
        return [
            (r"backbone\.blocks_(\d+)\.qkv\.(\w+)$",
             one(lambda m: f"{b}blocks.{m[1]}.attn.qkv.{m[2]}", qkv)),
            (r"backbone\.blocks_(\d+)\.(proj|token_trans1?)\.(\w+)$",
             one(lambda m: f"{b}blocks.{m[1]}.attn.{m[2]}.{m[3]}")),
            (r"backbone\.blocks_(\d+)\.(.+)$",
             one(lambda m: f"{b}blocks.{m[1]}.{m[2]}")),
            (r"backbone\.decode_(\d)\.(spa|chan)_\d\.(\w+)$", per_task(
                lambda m, ti, t: f"{b}fea_decode_{m[2]}.{m[1]}.{t}.0.{m[3]}")),
            (r"backbone\.decode_(\d)\.fuse(\d)_\d\.(\w+)$", per_task(
                lambda m, ti, t:
                f"{b}fea_fuse.{m[1]}.{t}.{fuse[m[2]]}.{m[3]}")),
            (r"backbone\.decode_(\d)\.fuse_bn_\d\.(\w+)$", per_task(
                lambda m, ti, t: f"{b}fea_fuse.{m[1]}.{t}.2.{m[2]}")),
            (r"backbone\.decode_(\d)\.ctr_\d_(\w+)_(\d)\.(\w+)$", one(
                lambda m: f"{b}ctr_attn_conv.{m[1]}.{m[2]}."
                          f"{2 * int(m[3])}.{m[4]}",
                lambda v: v[:, :, None, None] if v.dim() == 2 else v)),
            (r"head_(\w+)\.mt_proj\.conv\.(\w+)$",
             one(lambda m: f"heads.{m[1]}.mt_proj.0.{m[2]}")),
            (r"head_(\w+)\.mt_proj\.bn\.(\w+)$",
             one(lambda m: f"heads.{m[1]}.mt_proj.1.{m[2]}")),
            (r"head_(\w+)\.linear_pred\.(\w+)$",
             one(lambda m: f"heads.{m[1]}.linear_pred.{m[2]}"))] + own
    if kind == "TransformerNet":
        d, s = "multi_task_decoder.", "multi_task_decoder.invpt."
        st = s + "invpt_stages."

        def mt_proj(m, v):
            return {f"{s}mt_proj.{m[1]}.0.weight": v,
                    f"{s}mt_proj.{m[1]}.0.bias": torch.zeros(v.shape[0])}
        return [
            (r"backbone\.blocks_(\d+)\.attn\.qkv\.(\w+)$",
             one(lambda m: f"backbone.blocks.{m[1]}.attn.qkv.{m[2]}", qkv)),
            (r"backbone\.blocks_(\d+)\.(.+)$",
             one(lambda m: f"backbone.blocks.{m[1]}.{m[2]}")),
            (r"decoder\.scale_embed_(\d)\.(\w+)$",
             one(lambda m: f"{d}scale_embed.{m[1]}.{m[2]}")),
            (r"decoder\.prelim_(\w+)_(\d)\.conv\.(\w+)$",
             one(lambda m: f"{d}preliminary_decoder.{m[1]}.{m[2]}.conv."
                           f"{m[3]}")),
            (r"decoder\.prelim_(\w+)_(\d)\.bn\.(\w+)$",
             one(lambda m: f"{d}preliminary_decoder.{m[1]}.{m[2]}.bn1."
                           f"{m[3]}")),
            (r"decoder\.inter_head_(\w+)\.(\w+)$",
             one(lambda m: f"{d}intermediate_head.{m[1]}.{m[2]}")),
            (r"decoder\.mix_proj_(\w+)\.(\w+)$",
             one(lambda m: f"{s}mix_proj.{m[1]}.0.{m[2]}")),
            (r"decoder\.mt_proj_(\w+)\.conv\.weight$", mt_proj),
            (r"decoder\.mt_proj_(\w+)\.bn\.(\w+)$",
             one(lambda m: f"{s}mt_proj.{m[1]}.1.{m[2]}")),
            (r"decoder\.up_embed_(\d)\.proj(\d)\.(conv|bn)\.(\w+)$", per_task(
                lambda m, ti, t: f"{st}{m[1]}.patch_embed.{ti}.proj."
                f"{(1 if m[2] == '1' else 4) + (m[3] == 'bn')}.{m[4]}")),
            (r"decoder\.stage_(\d)\.attn\.conv_proj_q\.(conv|bn)\.(\w+)$",
             per_task(lambda m, ti, t: f"{st}{m[1]}.blocks.0.attn."
                      f"conv_proj_q.{ti}.{m[2]}.{m[3]}")),
            (r"decoder\.stage_(\d)\.attn\.fuse_attn_kernel$",
             one(lambda m: f"{st}{m[1]}.blocks.0.attn.fuse_attn.weight",
                 lambda v: v[:, :, None, None])),
            (r"decoder\.stage_(\d)\.attn\.fuse_attn_bias$",
             one(lambda m: f"{st}{m[1]}.blocks.0.attn.fuse_attn.bias")),
            (r"decoder\.stage_(\d)\.(.+)$",
             one(lambda m: f"{st}{m[1]}.blocks.0.{m[2]}")),
            (r"decoder\.norm_mt_(\d)\.(\w+)$",
             one(lambda m: f"{s}norm_mts.{m[1]}.{m[2]}")),
            (r"decoder\.redu_chan_(\d)_(\w+)\.(\w+)$",
             one(lambda m: f"{s}redu_chan.{m[1]}.{tasks.index(m[2])}."
                           f"{m[3]}")),
            (r"head_(\w+)\.linear_pred\.(\w+)$",
             one(lambda m: f"heads.{m[1]}.linear_pred.{m[2]}"))] + own
    b, h = "backbone.", "heads.3ddet."
    f = r"det_head\.fcos3d\."

    def dcn(v):          # (O, kh*kw*C) tap-major -> (O, C, 3, 3)
        return v.reshape(v.shape[0], 3, 3, -1).permute(0, 3, 1, 2) \
            .contiguous()

    def scales(m, v):
        return {f"{h}scales.{lvl}.{j}.scale": v[lvl, j].clone()
                for lvl in range(v.shape[0]) for j in range(v.shape[1])}
    deconv = {"deconv": 0, "bn1": 1, "conv": 3, "bn2": 4}
    return [
        (r"backbone\.patch_embed\.(\w+)$",
         one(lambda m: f"{b}patch_embed.proj.{m[1]}")),
        (r"backbone\.patch_norm\.(\w+)$",
         one(lambda m: f"{b}patch_embed.norm.{m[1]}")),
        (r"backbone\.layer(\d)_block(\d+)\.(qkv|proj|"
         r"relative_position_bias_table)(.*)$",
         one(lambda m: f"{b}layers.{m[1]}.blocks.{m[2]}.attn.{m[3]}{m[4]}")),
        (r"backbone\.layer(\d)_block(\d+)\.(.+)$",
         one(lambda m: f"{b}layers.{m[1]}.blocks.{m[2]}.{m[3]}")),
        (r"backbone\.merge_(\d)\.(.+)$",
         one(lambda m: f"{b}layers.{m[1]}.downsample.{m[2]}")),
        (r"backbone\.decode_(\d)\.fea_decode_(spa|chan)_\d_(\w+)\.(\w+)$",
         one(lambda m: f"{b}fea_decode_{m[2]}.{m[1]}.{m[3]}.0.{m[4]}")),
        (r"backbone\.decode_(\d)\.fea_fuse_\d_(\w+)_bn\.(\w+)$",
         one(lambda m: f"{b}fea_fuse.{m[1]}.{m[2]}.2.{m[3]}")),
        (r"backbone\.decode_(\d)\.fea_fuse_\d_(\w+)_(\d)\.(\w+)$",
         one(lambda m: f"{b}fea_fuse.{m[1]}.{m[2]}.{fuse[m[3]]}.{m[4]}")),
        (r"backbone\.multi_scale_fuse_(\w+)\.(\w+)$",
         one(lambda m: f"{b}multi_scale_fuse.{m[1]}.{m[2]}")),
        (r"head_(\w+)\.(deconv|bn1|conv|bn2)\.(\w+)$",
         one(lambda m: f"heads.{m[1]}.mt_proj.{deconv[m[2]]}.{m[3]}")),
        (r"head_(\w+)\.linear_pred\.(\w+)$",
         one(lambda m: f"heads.{m[1]}.linear_pred.{m[2]}")),
        (r"det_head\.fpn\.lateral_(\d)\.(\w+)$",
         one(lambda m: f"{h}neck.lateral_convs.{m[1]}.conv.{m[2]}")),
        (r"det_head\.fpn\.fpn_conv_(\d)\.(\w+)$",
         one(lambda m: f"{h}neck.fpn_convs.{m[1]}.conv.{m[2]}")),
        (r"det_head\.fpn\.extra_conv_(\d)\.(\w+)$",
         one(lambda m: f"{h}neck.fpn_convs.{fpn_inputs + int(m[1])}.conv."
                       f"{m[2]}")),
        (f + r"(cls|reg)_tower_(\d)\.dcn\.weight$",
         one(lambda m: f"{h}{m[1]}_convs.{m[2]}.conv.weight", dcn)),
        (f + r"(cls|reg)_tower_(\d)\.dcn\.bias$",
         one(lambda m: f"{h}{m[1]}_convs.{m[2]}.conv.bias")),
        (f + r"(cls|reg)_tower_(\d)\.dcn\.offset_mask\.(\w+)$",
         one(lambda m: f"{h}{m[1]}_convs.{m[2]}.conv.conv_offset.{m[3]}")),
        (f + r"(cls|reg)_tower_(\d)\.(.+)$",
         one(lambda m: f"{h}{m[1]}_convs.{m[2]}.{m[3]}")),
        (f + r"cls_branch\.conv_(\d)\.(.+)$",
         one(lambda m: f"{h}conv_cls_prev.{m[1]}.{m[2]}")),
        (f + r"reg_branch_(\d)\.conv_(\d)\.(.+)$",
         one(lambda m: f"{h}conv_reg_prevs.{m[1]}.{m[2]}.{m[3]}")),
        (f + r"dir_branch\.conv_(\d)\.(.+)$",
         one(lambda m: f"{h}conv_dir_cls_prev.{m[1]}.{m[2]}")),
        (f + r"ctr_branch\.conv_(\d)\.(.+)$",
         one(lambda m: f"{h}conv_centerness_prev.{m[1]}.{m[2]}")),
        (f + r"conv_reg_(\d)\.(\w+)$",
         one(lambda m: f"{h}conv_regs.{m[1]}.{m[2]}")),
        (f + r"(conv_cls|conv_dir_cls|conv_centerness)\.(\w+)$",
         one(lambda m: f"{h}{m[1]}.{m[2]}")),
        (f + r"scales$", scales)] + own


def _reference_layout(kind: str, state: dict, tasks, heads: int) -> dict:
    """A port state dict (CPU tensors) in the reference checkpoint's layout
    (``_reference_rules``), with the tensors the reference creates and the
    port drops (InvPT's ``scale_embed.2``, stage 0's ``fuse_attn`` and
    ``redu_chan``, ``norm_mt``) as seeded noise."""
    laterals = sum(k.startswith("det_head.fpn.lateral_") and
                   k.endswith(".weight") for k in state)
    rules = [(re.compile(p), fn) for p, fn in
             _reference_rules(kind, tuple(tasks), heads, laterals)]
    ref = {}
    for key, v in state.items():
        for pat, fn in rules:
            m = pat.match(key)
            if m:
                ref.update(fn(m, v))
                break
        else:
            raise RuntimeError(f"convert: no reference key for {key}")
    if kind == "TransformerNet":
        gen = torch.Generator().manual_seed(0)
        s = "multi_task_decoder.invpt."
        d0 = state["decoder.stage_0.norm1.weight"].shape[0]
        fuse = state["decoder.stage_1.attn.fuse_attn_kernel"].shape
        for key, shape in (
                ("multi_task_decoder.scale_embed.2.weight",
                 (d0, state["backbone.norm.weight"].shape[0], 3, 3)),
                ("multi_task_decoder.scale_embed.2.bias", (d0,)),
                (s + "invpt_stages.0.blocks.0.attn.fuse_attn.weight",
                 (*fuse, 1, 1)),
                (s + "invpt_stages.0.blocks.0.attn.fuse_attn.bias",
                 fuse[:1]),
                (s + "norm_mt.weight", state["decoder.norm_mt_2.weight"].shape),
                (s + "norm_mt.bias", state["decoder.norm_mt_2.bias"].shape),
                *[(s + f"redu_chan.0.{ti}.{leaf}", shape)
                  for ti in range(len(tasks))
                  for leaf, shape in (("weight", (d0, d0, 1, 1)),
                                      ("bias", (d0,)))]):
            ref[key] = torch.randn(shape, generator=gen)
    return ref


def _vary(model, gen, scale: float = CONVERT_VARY) -> None:
    """Seeded values in the tensors ``init_weights`` leaves constant (biases,
    LN, BN and GN scales, BN statistics, the FCOS3D scales, the deformable
    convs' offset convs), so that a round trip that drops or swaps one of
    them shows: ``scale`` times a normal sample added to each bias and BN
    mean, each variance, scale and 1-D weight times 1 + ``scale`` times its
    magnitude (the offsets as ``swin_phase`` sets them)."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            leaf = name.rsplit(".", 1)[-1]
            n = torch.randn(t.shape, generator=gen, device=t.device)
            if name.endswith("offset_mask.weight"):
                t.copy_(n * 0.3 * t[0].numel() ** -0.5)
            elif leaf.endswith("bias") or leaf == "running_mean":
                t.add_(scale * n)
            elif leaf in ("running_var", "scales") or (
                    leaf == "weight" and t.dim() == 1):
                t.mul_(1.0 + scale * n.abs())


class _PeakRSS:
    """The process's resident set sampled every 5 ms from /proc/self/statm
    while the block runs: ``before`` and ``peak``, in GiB. The C heap's free
    memory goes back to the system first (``malloc_trim``), so that what the
    block allocates shows as a rise over ``before``."""

    def __enter__(self):
        import ctypes
        import threading
        ctypes.CDLL("libc.so.6").malloc_trim(0)
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page / 2 ** 30

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _convert_cli(tag, argv) -> dict:
    """``convert_checkpoint.main(argv)``, timed, with the host's peak RSS
    and the written checkpoint's size; returns them and the file's state
    (master weights and buffers) as read back."""
    from mtt_tpu_torch import convert_checkpoint
    out = argv[argv.index("--out") + 1]
    with _PeakRSS() as rss:
        t = time.perf_counter()
        rc = convert_checkpoint.main(argv)
        secs = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"{tag}: convert_checkpoint returned {rc}")
    path = os.path.join(out, "step_0.pt")
    gib = os.path.getsize(path) / 2 ** 30
    state = torch.load(path, map_location="cpu", weights_only=True)
    print(f"[{tag}] convert_checkpoint {' '.join(argv[:4])}: {secs:.2f} s; "
          f"host RSS {rss.before:.2f} GiB before, peak {rss.peak:.2f} GiB "
          f"(+{rss.peak - rss.before:.2f}); checkpoint {gib:.3f} GiB",
          flush=True)
    return {"seconds": secs, "rss_rise_gib": rss.peak - rss.before,
            "gib": gib, "state": {**state["master"], **state["buffers"]}}


def _centred_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| over ||ref - its per-channel mean|| (channels last): the
    error against the map's spread, so that a constant in the map (such as
    the class prior's bias in the detection logits) does not hide it."""
    ref = ref.float()
    spread = ref - ref.mean(dim=tuple(range(ref.dim() - 1)), keepdim=True)
    return ((got.float() - ref).norm() / spread.norm()).item()


def _forward_rms(tag, what, got: dict, plain: dict, ref: dict) -> None:
    """Each map of the kernels' bf16 forward against the f32 forward of the
    same weights, as ``_centred_rms``, at most FORWARD_RMS_TOL; beside it
    the plain bf16 forward's distance, the witness of what bf16 alone
    costs, and the kernels' relative RMS over the map's norm. Every map is
    printed before a failure is raised."""
    over = []
    for k, r in ref.items():
        g = got[k]
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"{tag} {k}: {tuple(g.shape)} or non-finite")
        rms = _centred_rms(g, r)
        by_norm = ((g.float() - r.float()).norm() / r.float().norm()).item()
        print(f"[{tag}] {what} {k}: bf16 vs f32, error over the centred "
              f"map: kernels {rms:.5g} (tol {FORWARD_RMS_TOL}), plain bf16 "
              f"{_centred_rms(plain[k], r):.5g}; kernels over the map's "
              f"norm {by_norm:.5g}", flush=True)
        if not rms <= FORWARD_RMS_TOL:
            over.append(f"{k} {rms:.4g}")
    if over:
        raise RuntimeError(f"{tag}: from the f32 forward over "
                           f"{FORWARD_RMS_TOL}: {over}")


def _maps(out) -> dict:
    """{name: tensor} of a forward's task maps and detection levels."""
    maps = {t: v for t, v in out.items() if t not in ("3ddet", "inter_preds")}
    maps.update({f"inter_preds.{t}": v
                 for t, v in out.get("inter_preds", {}).items()})
    if "3ddet" in out:
        maps.update(_det_levels(out["3ddet"]))
    return maps


def convert_phase(vary: float = CONVERT_VARY):
    """Phase 16: weight ingestion at full width (see the module docstring),
    the models seeded by ``_vary`` at ``vary``. Returns the launch counts of
    each converted model's eval forward."""
    import numpy as np
    from mtt_tpu_torch import inference
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.taskprompter import TASKPROMPTER_VIT_SPECS
    from mtt_tpu_torch.models.vit import VIT_SPECS, resize_pos_embed
    from mtt_tpu_torch.models.wrappers import build_model
    from mtt_tpu_torch.utils.train_utils import Trainer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_convert_")
    specs = {**VIT_SPECS, **TASKPROMPTER_VIT_SPECS}
    counts, real_predict = {}, inference.predict
    try:
        rng = np.random.default_rng(24)
        photo = rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
        with open(os.path.join(work, "in.png"), "wb") as f:
            f.write(_png_encode(photo))
        for tag, title, config, seed in CONVERT_PATHS:
            p = create_config(config, {"run_mode": "infer"})
            gen = torch.Generator(device=dev).manual_seed(seed)
            model = build_model(p, img_size=tuple(p.TEST.SCALE), device=dev,
                                dtype=torch.float32)
            kind = type(model).__name__
            init_weights(model, gen)
            _vary(model, gen, vary)
            src = {k: v.cpu() for k, v in model.state_dict().items()}
            del model
            ref = _reference_layout(kind, src, p.TASKS.NAMES,
                                    specs.get(p["backbone"], {}).get(
                                        "num_heads", 0))
            path = os.path.join(work, f"{tag}.pth.tar")
            torch.save({"model": {"module." + k: v for k, v in ref.items()},
                        "epoch": 0}, path)
            del ref
            ck = os.path.join(work, f"ck_{tag}")
            got = _convert_cli(tag, ["--config_exp", config, "--torch", path,
                                     "--out", ck])
            os.remove(path)
            # the checkpoint's buffers also hold the Swin blocks'
            # non-persistent index and mask, which no state dict carries
            diff = sorted(k for k in src if k not in got["state"] or not
                          torch.equal(got["state"][k], src[k]))
            extra = {k.rsplit(".", 1)[-1] for k in got["state"]} - {
                k.rsplit(".", 1)[-1] for k in src}
            if diff or not extra <= {"rel_index", "attn_mask"}:
                raise RuntimeError(f"{tag}: the round trip changed "
                                   f"{len(diff)} tensors: {diff[:10]}, "
                                   f"extra {extra}")
            print(f"[{tag}] {title}: {len(src)} tensors, "
                  f"{sum(v.numel() for v in src.values()) / 1e6:.1f} M "
                  f"values, equal bit for bit after the reference layout "
                  f"and the CLI", flush=True)
            del got, src

            # the converted model through its eval entry point
            seen = {}

            def spy(model, images, **kw):
                logits, preds = real_predict(model, images, **kw)
                seen.update(model=model, x=images, logits=logits)
                return logits, preds
            _build.reset_counts()
            if kind == "TransformerNet":
                gen = torch.Generator(device=dev).manual_seed(0)
                model = build_model(p, img_size=tuple(p.TEST.SCALE),
                                    device=dev, dtype=torch.float32)
                trainer = Trainer(model, p, p.TASKS.NAMES, torch.bfloat16,
                                  gen, log_fn=lambda s: None)
                if trainer.restore_checkpoint(ck) != 0:
                    raise RuntimeError(f"{tag}: restore")
                _build.reset_counts()
                rgb = torch.randint(0, 256, (2, *p.TEST.SCALE, 3),
                                    generator=gen, device=dev)
                x = inference.preprocess(rgb).to(torch.bfloat16)
                logits, _ = inference.predict(model, x)
                seen.update(model=model, x=x, logits=logits)
                entry = "predict on 2 images"
                del trainer
            else:
                inference.predict = spy
                try:
                    rc = inference.main(["--config_exp", config,
                                         "--image_path",
                                         os.path.join(work, "in.png"),
                                         "--ckpt_dir", ck, "--output_dir",
                                         os.path.join(work, f"out_{tag}"),
                                         "--dtype", "bfloat16"])
                finally:
                    inference.predict = real_predict
                if rc != 0:
                    raise RuntimeError(f"{tag}: inference.main rc {rc}")
                entry = "inference.main --ckpt_dir on a 375x500 PNG"
            torch.cuda.synchronize()
            counts[tag] = dict(_build.COUNTS)
            want = {"TaskPrompterNet": expected_eval("factored"),
                    "TransformerNet": expected_invpt(False),
                    "TaskPrompterSwinNet": expected_swin()}[kind]
            print(f"[{tag}] {entry}: launches {counts[tag]}", flush=True)
            if counts[tag] != want:
                raise RuntimeError(f"{tag}: launches {counts[tag]} != {want}")
            ref_model = copy.deepcopy(seen["model"]).float()
            with torch.no_grad():
                plain = seen["model"](seen["x"], impl="plain")
                ref = ref_model(seen["x"].float(), impl="plain")
            _forward_rms(tag, title, _maps(seen["logits"]), _maps(plain),
                         _maps(ref))
            del ref_model, ref, plain, seen
            shutil.rmtree(ck)
            torch.cuda.empty_cache()

        # a Google ViT-L/16 npz at the 384 pretraining grid into
        # TaskPrompter-ViT-L at 512 (32x32)
        p = create_config(LOOP_CONFIG, {"run_mode": "infer"})
        spec = specs[p["backbone"]]
        C, H, depth = spec["embed_dim"], spec["num_heads"], spec["depth"]
        gen = torch.Generator(device=dev).manual_seed(25)

        def rnd(*shape):
            return (0.02 * torch.randn(shape, generator=gen, device=dev)) \
                .cpu().numpy()
        npz = {"embedding/kernel": rnd(16, 16, 3, C), "embedding/bias": rnd(C),
               "cls": rnd(1, 1, C),
               "Transformer/posembed_input/pos_embedding":
                   rnd(1, 1 + NPZ_GRID ** 2, C),
               "Transformer/encoder_norm/scale": 1 + rnd(C),
               "Transformer/encoder_norm/bias": rnd(C)}
        for i in range(depth):
            bp = f"Transformer/encoderblock_{i}/"
            mh = bp + "MultiHeadDotProductAttention_1/"
            for ln in ("LayerNorm_0", "LayerNorm_2"):
                npz[bp + ln + "/scale"] = 1 + rnd(C)
                npz[bp + ln + "/bias"] = rnd(C)
            for n in ("query", "key", "value"):
                npz[mh + n + "/kernel"] = rnd(C, H, C // H)
                npz[mh + n + "/bias"] = rnd(H, C // H)
            npz[mh + "out/kernel"] = rnd(H, C // H, C)
            npz[mh + "out/bias"] = rnd(C)
            for j, shape in ((0, (C, 4 * C)), (1, (4 * C, C))):
                npz[bp + f"MlpBlock_3/Dense_{j}/kernel"] = rnd(*shape)
                npz[bp + f"MlpBlock_3/Dense_{j}/bias"] = rnd(shape[1])
        npz_path = os.path.join(work, "ViT-L_16.npz")
        np.savez(npz_path, **npz)
        got = _convert_cli("convert_npz", [
            "--config_exp", LOOP_CONFIG, "--npz", npz_path, "--out",
            os.path.join(work, "ck_npz")])["state"]
        want = {"backbone.patch_embed.proj.weight":
                npz["embedding/kernel"].transpose(3, 2, 0, 1),
                "backbone.patch_embed.proj.bias": npz["embedding/bias"],
                "backbone.norm.weight": npz["Transformer/encoder_norm/scale"],
                "backbone.norm.bias": npz["Transformer/encoder_norm/bias"]}
        for i in range(depth):
            bp = f"Transformer/encoderblock_{i}/"
            mh = bp + "MultiHeadDotProductAttention_1/"
            pb = f"backbone.blocks_{i}."
            for dst, ln in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_2")):
                want[pb + dst + ".weight"] = npz[bp + ln + "/scale"]
                want[pb + dst + ".bias"] = npz[bp + ln + "/bias"]
            # row (h, j, d) of the head-major qkv = column (h, d) of q/k/v
            want[pb + "qkv.weight"] = np.stack(
                [npz[mh + n + "/kernel"] for n in ("query", "key", "value")],
                1).transpose(2, 1, 3, 0).reshape(3 * C, C)
            want[pb + "qkv.bias"] = np.stack(
                [npz[mh + n + "/bias"] for n in ("query", "key", "value")],
                1).reshape(3 * C)
            want[pb + "proj.weight"] = npz[mh + "out/kernel"].reshape(C, C).T
            want[pb + "proj.bias"] = npz[mh + "out/bias"]
            for j in (0, 1):
                want[pb + f"mlp.fc{j + 1}.weight"] = \
                    npz[bp + f"MlpBlock_3/Dense_{j}/kernel"].T
                want[pb + f"mlp.fc{j + 1}.bias"] = \
                    npz[bp + f"MlpBlock_3/Dense_{j}/bias"]
        bad = [k for k, w in want.items()
               if not np.array_equal(got[k].numpy(), w)]
        grid = (p.TEST.SCALE[0] // 16, p.TEST.SCALE[1] // 16)
        pos = resize_pos_embed(torch.from_numpy(
            npz["Transformer/posembed_input/pos_embedding"]).to(dev), grid)
        pos_err = (got["backbone.pos_embed"].to(dev) - pos).abs().max() \
            .item() / pos.abs().max().item()
        backbone = [k for k in got if k.startswith("backbone.") and
                    "decode_" not in k and "task_prompts" not in k and
                    "token_trans" not in k]
        print(f"[convert_npz] ViT-L/16 npz ({NPZ_GRID}x{NPZ_GRID} + cls) into "
              f"TaskPrompter-ViT-L at {grid[0]}x{grid[1]}: {len(want)} "
              f"backbone tensors equal to the npz's, {len(bad)} not; the "
              f"position embedding {tuple(got['backbone.pos_embed'].shape)} "
              f"within {pos_err:.3g} (relative) of the cubic resample",
              flush=True)
        if bad or pos_err > 1e-6 or set(backbone) != set(want) | {
                "backbone.pos_embed"}:
            raise RuntimeError(f"convert_npz: {bad[:10]}, pos {pos_err}, "
                               f"{sorted(set(backbone) ^ set(want))[:10]}")
        print(f"[convert] phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        return counts
    finally:
        inference.predict = real_predict
        shutil.rmtree(work, ignore_errors=True)


def _train_run(tag, title, trainer, batches, expected, batch_size,
               after_backward=None, loss_keys=None):
    """One checked training step on batches[0] (launch counts, gradients
    against the f32 reference of the same weights, batch and drop-path masks,
    in all and per tensor; see GRAD_RMS_TOL), then the other batches timed;
    finite losses (with ``loss_keys``, exactly those), moving parameters and
    BN statistics. ``after_backward`` runs right after the checked step's
    backward. Returns the step's launch counts."""
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
    point, masks = _ForwardPoint(), _DropPathMasks(model)
    torch.cuda.synchronize()
    _build.reset_counts()
    with point.record(model), _deterministic(), masks:
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
    # a decoder branch that every sample drops has no gradient to check
    if masks.masks:
        print(f"[{tag}] drop-path keep masks of the decoder blocks in the "
              f"checked step (attention branch, MLP branch; a bool a "
              f"sample): {masks.masks}", flush=True)
    if masks.dead():
        raise RuntimeError(f"{tag}: the checked step drops {masks.dead()} "
                           f"for every sample, so their gradients go "
                           f"unchecked; choose another seed")
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
    if loss_keys is not None and any(set(ls) != set(loss_keys)
                                     for ls in all_losses):
        raise RuntimeError(f"{tag}: losses {sorted(losses)} != "
                           f"{sorted(loss_keys)}")
    names = [n for n, _ in model.named_parameters()]
    still = [n for n, a, b in zip(names, master0, trainer.master)
             if torch.equal(a, b.detach().cpu())]
    # a tensor whose f32 gradient is under 1e-6 of all (``tiny``: a bias
    # ahead of batch-statistics BN, whose exact gradient is zero) may stay
    # put: the per-tensor check leaves it out for the same reason
    stuck = [n for n, g in zip(names, has_grad)
             if g and n in still and n not in tiny]
    bn_moved = sum(not torch.equal(buffers0[n], b) for n, b in
                   model.named_buffers() if n in buffers0)
    print(f"[{tag}] parameters moved {len(names) - len(still)}/{len(names)} "
          f"(unmoved, each with a zero f32 gradient or one under 1e-6 of "
          f"all: {still}); BN running statistics moved "
          f"{bn_moved}/{len(buffers0)}", flush=True)
    if stuck or bn_moved != len(buffers0):
        raise RuntimeError(f"parameters with a gradient that did not move "
                           f"{stuck}, or BN statistics that did not move")
    ms = statistics.median(step_ms)
    STEP_MS[tag] = ms
    print(f"[{tag}] {ms:.2f} ms per step (median of {len(step_ms)}; "
          f"{[round(v, 2) for v in step_ms]}) = {batch_size / ms * 1e3:.2f} "
          f"imgs/s; peak memory of steps 2-{len(batches)} {peak_gib:.2f} GiB",
          flush=True)
    return counts


DP_WORLD = 2                     # ranks of the parallel phase
DP_BATCH = 2                     # trBatch a rank: a global batch of 4
DP_STEPS = 3                     # one checked step, two timed
DP_JOIN_S = 900                  # the ranks' time in all, then they are killed
# The 2-rank step against the 1-rank step on the same global batch and seed,
# both in bf16 through the kernels: each is a bf16 evaluation of the same
# function, so if the 2-rank step rounds no worse than the 1-rank one, each
# lies within about d of the f32 backward at the 1-rank step's forward point
# (d: the 1-rank step's own relative RMS distance to it, as phase 9 measures
# it), and the two within 2 d of each other. The same rule holds the losses
# (relative RMS over the loss terms) and the BN running statistics (the
# batch moments' relative RMS), against the free-running f32 forward's
# distance. A per-rank mean, a missing all-reduce or a doubled sum moves
# them by tenths to wholes.
DP_BOUND = 2.0
# The merged scores against the 1-rank run's, relative. The 1-rank run takes
# the ranks' batches in turn (the same images in the same batches of 4), so
# that both score the same predictions: the meters then sum them in f32 in
# another grouping, and the evaluator averages over the images in another
# order. In the loader's own batches ([0..3], [4..7] against the ranks'
# [0, 2, 4, 6] and [1, 3, 5, 7]) the bf16 forward of a sample differs in its
# last bits with its batch, and with seeded random weights enough semseg
# argmaxes sit on a tie that mIoU moved by 2.7e-4 of itself on an H100;
# that distance is printed, not bounded.
DP_SCORE_TOL = 1e-5


class _Draws(torch.overrides.TorchFunctionMode):
    """Within it, every ``torch.rand`` drawn from a generator (the drop-path
    masks' draws, one a branch and block, over the global batch)."""

    def __init__(self):
        super().__init__()
        self.draws = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.rand and kwargs.get("generator") is not None:
            self.draws.append(out.detach().cpu())
        return out


def _running(model) -> dict:
    return {n: b.detach().float().clone() for n, b in model.named_buffers()
            if "running" in n}


def _moments(after: dict, before: dict) -> dict:
    """The batch moments that moved the running statistics: (after - 0.9
    before) / 0.1 (flax's momentum)."""
    return {k: (after[k] - 0.9 * before[k]) / 0.1 for k in after}


def _loss_vec(losses: dict) -> torch.Tensor:
    return torch.stack([losses[k].float().reshape(()) for k in
                        sorted(losses)])


def _dp_reference(work: str) -> dict:
    """The 1-rank ViT-L step on the global batch (kernels, bf16, f32
    master) with its distances to f32 (see DP_BOUND), two timed steps, and
    the 1-rank Swin-B ``test_phase`` over the cut val set; saved to
    ``work/ref.pt`` for the ranks. Returns the launch counts and times."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils.train_utils import test_phase, to_device
    dev = torch.device("cuda")
    gb = DP_WORLD * DP_BATCH
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer, data = _vitl_trainer()
    model, criterion = trainer.model, trainer.criterion
    batches = [to_device(data.batch(i * gb, gb), dev)
               for i in range(DP_STEPS)]
    state = trainer.generator.get_state()
    ref_model = copy.deepcopy(model).float()
    free_model = copy.deepcopy(model).float()
    before = _running(model)
    point, draws = _ForwardPoint(), _Draws()
    torch.cuda.synchronize()
    _build.reset_counts()
    with point.record(model), _deterministic(), draws:
        losses = trainer.backward(batches[0])
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    if counts != expected_train():
        raise RuntimeError(f"parallel: 1-rank launch counts {counts} != "
                           f"{expected_train()}")
    grads = {n: w.grad.detach().clone() for n, w in model.named_parameters()}
    moments = _moments(_running(model), before)
    g_ref = _grads(ref_model, batches[0], criterion, state, "plain",
                   point.pin(ref_model), _deterministic())
    d_grad = _rel_rms(grads, g_ref)
    del point, g_ref, ref_model
    gen = torch.Generator(device=dev)
    gen.set_state(state)
    with torch.no_grad(), _deterministic():
        out = free_model(batches[0]["image"].float(), train=True,
                         generator=gen, impl="plain")
        free_losses = criterion(out, batches[0])
    del out
    d_loss = ((_loss_vec(losses) - _loss_vec(free_losses)).norm()
              / _loss_vec(free_losses).norm()).item()
    d_bn = _rel_rms(moments, _moments(_running(free_model), before))
    del free_model
    trainer.update()
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for batch in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[parallel] 1 rank, TaskPrompter-ViT-L PASCAL at batch {gb}: "
          f"launches {counts}; distance to f32 (relative RMS): gradients "
          f"{d_grad:.5g} (at the step's forward point), losses {d_loss:.5g}, "
          f"BN batch moments {d_bn:.5g} (free-running); step wall ms "
          f"{[round(v, 2) for v in step_ms]}; peak {peak:.2f} GiB",
          flush=True)
    ref = {"grads": {n: g.cpu() for n, g in grads.items()},
           "losses": {k: v.cpu() for k, v in losses.items()},
           "moments": {k: v.cpu() for k, v in moments.items()},
           "draws": draws.draws, "d_grad": d_grad, "d_loss": d_loss,
           "d_bn": d_bn}
    del trainer, model, grads, batches
    torch.cuda.empty_cache()

    p, trainer = _cs3d_trainer("infer", 12)
    with _cut_val_set(cc):
        _, val_tf = cc.get_transformations(p)
        ds = cc.get_dataset(p, "val", val_tf)
        val = cc.get_test_dataloader(p, ds)
        # the ranks' batches, in turn (see DP_SCORE_TOL)
        turns = [b for r in range(DP_WORLD) for b in
                 cc.get_test_dataloader(p, ds, DP_WORLD, r)]
    with _deterministic():
        ref["scores"] = test_phase(p, trainer.model, turns)
        own = test_phase(p, trainer.model, val)
    print(f"[parallel] 1 rank, Swin-B Cityscapes-3D test_phase over "
          f"{DET_IMAGES} images in the ranks' batches: "
          f"{json.dumps(ref['scores'])}; in the loader's own batches of "
          f"{p['valBatch']} the largest relative difference to that "
          f"{_scores_close(own, ref['scores']):.3g} (bf16 forwards of a "
          f"sample in other batches; not bounded)", flush=True)
    del trainer
    torch.cuda.empty_cache()
    torch.save(ref, os.path.join(work, "ref.pt"))
    return {"step_ms": statistics.median(step_ms), "peak_gib": peak}


def _equal_on_ranks(tensors) -> bool:
    """Whether rank 1's ``tensors`` equal rank 0's to the bit (on rank 0;
    True elsewhere): each one's bytes broadcast from rank 1 and
    compared."""
    import torch.distributed as dist
    same = True
    for t in tensors:
        x = t.detach().contiguous().reshape(-1).view(torch.uint8)
        y = x.clone()
        dist.broadcast(y, src=1)
        same = same and torch.equal(x, y)
    return same


def dp_rank(work: str) -> None:
    """One rank of the parallel phase (``--dp-rank``), torchrun's
    environment set by ``parallel_phase``: the ViT-L step on the rank's
    half of each global batch against the 1-rank reference, the ranks'
    parameters after the update, two timed steps with the all-reduce timed
    by CUDA events, then the Swin-B ``test_phase`` on the rank's shard;
    the results to ``work/rank<r>.json``."""
    import torch.distributed as dist
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.parallel.mesh import init_distributed
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils import train_utils
    from mtt_tpu_torch.utils.train_utils import test_phase, to_device

    world = int(os.environ["WORLD_SIZE"])
    nccl = torch.cuda.device_count() >= world
    dev = init_distributed() if nccl else init_distributed(
        device="cuda:0", backend="gloo")
    rank = dist.get_rank()
    _build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"rank": rank, "backend": dist.get_backend(), "device": str(dev)}
    ar_ms, timing = [], [False]
    real = train_utils.all_reduce_grads

    def timed(params):
        if not timing[0]:
            return real(params)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        real(params)
        e1.record()
        e1.synchronize()
        ar_ms.append(e0.elapsed_time(e1))
    train_utils.all_reduce_grads = timed

    trainer, data = _vitl_trainer()
    model = trainer.model
    gb = world * DP_BATCH
    batches = [to_device(data.batch(i * gb + rank * DP_BATCH, DP_BATCH), dev)
               for i in range(DP_STEPS)]
    before = _running(model)
    draws = _Draws()
    torch.cuda.synchronize()
    _build.reset_counts()
    with _deterministic(), draws:
        losses = trainer.backward(batches[0])
    torch.cuda.synchronize()
    res["train_counts"] = dict(_build.COUNTS)
    if rank == 0:
        ref = torch.load(os.path.join(work, "ref.pt"), weights_only=False)
        g1 = {n: g.to(dev) for n, g in ref["grads"].items()}
        g2 = {n: w.grad.detach() for n, w in model.named_parameters()}
        res["grad_rms"] = _rel_rms(g2, g1)
        err2 = {k: ((g2[k].float() - g1[k].float()) ** 2).sum().item()
                for k in g1}
        res["grad_worst"] = sorted(err2, key=lambda k: -err2[k])[:3]
        del g1
        l1 = _loss_vec(ref["losses"])
        res["loss_rms"] = ((_loss_vec({k: v.cpu() for k, v in
                                       losses.items()}) - l1).norm()
                           / l1.norm()).item()
        res["bn_rms"] = _rel_rms(
            {k: v.cpu() for k, v in _moments(_running(model),
                                             before).items()},
            ref["moments"])
        res["draws_equal"] = len(draws.draws) == len(ref["draws"]) and all(
            torch.equal(a, b) for a, b in zip(draws.draws, ref["draws"]))
        res["n_draws"] = len(draws.draws)
        res["bounds"] = {k: DP_BOUND * ref[k] for k in
                         ("d_grad", "d_loss", "d_bn")}
        res["ref_scores"] = ref["scores"]
        del ref
    trainer.update()
    torch.cuda.synchronize()
    res["params_equal"] = _equal_on_ranks(
        list(trainer.master) + list(model.parameters())
        + list(model.buffers()))
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    timing[0] = True
    for batch in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    res["step_ms"] = step_ms
    res["allreduce_ms"] = ar_ms
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del trainer, model, batches
    torch.cuda.empty_cache()

    p, trainer = _cs3d_trainer("infer", 12)
    with _cut_val_set(cc):
        _, val_tf = cc.get_transformations(p)
        val = cc.get_test_dataloader(p, cc.get_dataset(p, "val", val_tf),
                                     world, rank)
    _build.reset_counts()
    t0 = time.perf_counter()
    with _deterministic():
        res["scores"] = test_phase(p, trainer.model, val)
    res["eval_s"] = time.perf_counter() - t0
    res["eval_counts"] = dict(_build.COUNTS)
    res["eval_batches"] = len(val)
    dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _scores_close(got: dict, want: dict) -> float:
    """The largest relative difference of two score dicts (the same keys
    required)."""
    if got.keys() != want.keys():
        return math.inf
    worst = 0.0
    for t, s in want.items():
        if got[t].keys() != s.keys():
            return math.inf
        for k, v in s.items():
            worst = max(worst, abs(got[t][k] - v) / max(abs(v), 1e-12))
    return worst


def parallel_phase():
    """Data-parallel training and evaluation in ``DP_WORLD`` ranks, one
    process each (gloo on this one card when it is the only one, NCCL on a
    card a rank otherwise): the TaskPrompter-ViT-L PASCAL step (batch 2 a
    rank, drop-path 0.15, bf16, the kernels) against the 1-rank step of
    batch 4 on the same global batch and seed (gradients, losses, BN
    statistics within DP_BOUND times the 1-rank step's own distance to f32,
    drop-path draws equal), the ranks' parameters equal to the bit after
    the update, the step's wall ms at 1 and 2 ranks and the all-reduce's ms;
    then Swin-B Cityscapes-3D ``test_phase`` over the cut val set of 8
    images, 4 a rank, whose merged scores equal the 1-rank run's. Returns
    the launches of both ranks' checked step and eval."""
    import subprocess
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        one = _dp_reference(work)
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs, logs = [], []
        for r in range(DP_WORLD):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DP_WORLD),
                       LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            logs.append(open(os.path.join(work, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank",
                 work], env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        end = time.monotonic() + DP_JOIN_S
        failed = []
        for r, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(end - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                failed.append(r)
            if proc.returncode != 0:
                failed.append(r)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
        if failed:
            for r in sorted(set(failed)):
                with open(os.path.join(work, f"rank{r}.log")) as f:
                    print(f"[parallel] rank {r} failed:\n{f.read()[-6000:]}",
                          flush=True)
            raise RuntimeError(f"parallel: ranks {sorted(set(failed))} "
                               f"failed or timed out")
        res = []
        for r in range(DP_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r0 = res[0]
    print(f"[parallel] {DP_WORLD} ranks over {r0['backend']} on "
          f"{[r['device'] for r in res]}"
          + (" (one card shared: gloo through the host; NCCL needs a card a "
             "rank)" if r0["backend"] == "gloo" else ""), flush=True)
    for r in res:
        print(f"[parallel] rank {r['rank']}: step launches "
              f"{r['train_counts']}; step wall ms "
              f"{[round(v, 2) for v in r['step_ms']]}, of it all_reduce_grads "
              f"{[round(v, 2) for v in r['allreduce_ms']]} ms (CUDA events); "
              f"peak {r['peak_gib']:.2f} GiB; eval {r['eval_batches']} "
              f"batch(es) in {r['eval_s']:.2f} s, launches "
              f"{r['eval_counts']}", flush=True)
    b = r0["bounds"]
    print(f"[parallel] 2 ranks against 1 (relative RMS): gradients "
          f"{r0['grad_rms']:.5g} (bound {b['d_grad']:.5g}; largest "
          f"{r0['grad_worst']}), losses {r0['loss_rms']:.5g} (bound "
          f"{b['d_loss']:.5g}), BN batch moments {r0['bn_rms']:.5g} (bound "
          f"{b['d_bn']:.5g}); {r0['n_draws']} drop-path draws equal "
          f"{r0['draws_equal']}; parameters equal to the bit after the "
          f"update {r0['params_equal']}", flush=True)
    step2 = statistics.median([v for r in res for v in r["step_ms"]])
    print(f"[parallel] step wall ms, global batch {DP_WORLD * DP_BATCH}: 1 "
          f"rank {one['step_ms']:.2f}, {DP_WORLD} ranks {step2:.2f}; peak "
          f"GiB 1 rank {one['peak_gib']:.2f}, per rank "
          f"{[round(r['peak_gib'], 2) for r in res]}", flush=True)
    worst = max(_scores_close(r["scores"], r0["ref_scores"]) for r in res)
    print(f"[parallel] Swin-B test_phase merged over {DP_WORLD} ranks: "
          f"{json.dumps(r0['scores'])}; largest relative difference to 1 "
          f"rank {worst:.3g} (tol {DP_SCORE_TOL})", flush=True)
    want_eval = {k: v * r0["eval_batches"] for k, v in expected_swin().items()}
    bad = [f"rank {r['rank']}" for r in res
           if r["train_counts"] != expected_train()
           or r["eval_counts"] != want_eval]
    if bad:
        raise RuntimeError(f"parallel: launch counts of {bad} != "
                           f"{expected_train()} / {want_eval}")
    if not (r0["grad_rms"] <= b["d_grad"] and r0["loss_rms"] <= b["d_loss"]
            and r0["bn_rms"] <= b["d_bn"]):
        raise RuntimeError("parallel: the 2-rank step is over its bound")
    if not (r0["draws_equal"] and r0["n_draws"] > 0 and r0["params_equal"]):
        raise RuntimeError("parallel: drop-path draws or the ranks' "
                           "parameters differ")
    if not worst <= DP_SCORE_TOL:
        raise RuntimeError("parallel: merged scores differ from 1 rank's")
    counts = {k: sum(r["train_counts"][k] + r["eval_counts"][k] for r in res)
              for k in r0["train_counts"]}
    return {"dp": counts}


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "jpeg")
DATA_TRAIN, DATA_VAL = 16, 8     # PASCAL ids of phase 18's tree
DATA_ITERS, DATA_VAL_EVERY = 4, 2
DATA_VAL_BATCHES = 2             # 8 val images in batches of 6
DATA_CS_FRAMES, DATA_NYUD = 4, 4
NYUD_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "nyud", "taskprompter_vitLp16.yml")
# PASCAL-Context classes of the tree's label maps: NYU-compatible ones, a
# tvmonitor, a person (the human-parts category), others
DATA_NYU = ["wall", "floor", "bed", "chair", "unknown"]
DATA_CONTEXT = {"unknown": 0, "wall": 3, "floor": 4, "bed": 5, "chair": 9,
                "sky": 6, "tvmonitor": 7, "person": 15, "dog": 12}
DATA_PARTS = ("head", "torso", "luarm", "rlleg", "hair", "lhand", "ruleg")


def _png_encode(img, palette=None) -> bytes:
    """A PNG file of a uint8 or uint16 (H, W) grey image (palette indices
    with ``palette``, (n, 3) uint8) or (H, W, 3) RGB one, whose scanlines
    take the five filters in turn (0 none, 1 sub, 2 up, 3 average, 4 Paeth;
    PNG spec, section 9), as an encoder such as libpng mixes them in a
    photo."""
    import zlib

    import numpy as np
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    colour = 3 if palette is not None else {1: 0, 3: 2}[ch]
    bpp = ch * depth // 8
    data = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    x = np.zeros((h + 1, (w + 1) * bpp), np.int16)
    x[1:, bpp:] = data.view(np.uint8).reshape(h, w * bpp)
    a, b, c = x[1:, :-bpp], x[:-1, bpp:], x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    f = (np.arange(h, dtype=np.int16) % 5)[:, None]
    pred = np.select([f == 1, f == 2, f == 3, f == 4],
                     [a, b, (a + b) >> 1, paeth], 0)
    raw = np.concatenate([f.astype(np.uint8), ((x[1:, bpp:] - pred) & 0xFF)
                          .astype(np.uint8)], 1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    head = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                      0))
    if palette is not None:
        head += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + head
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _write(path, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _data_photo(rng, h, w):
    """A seeded smooth RGB image with noise."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 90 * np.sin(xx / (37.0 + 9 * c))
                    * np.cos(yy / (23.0 + 5 * c)) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(
        np.uint8)


def _data_blocks(rng, h, w, values, dtype):
    """A label map of rectangles of ``values`` over the first."""
    import numpy as np
    out = np.full((h, w), values[0], dtype)
    for v in values[1:]:
        y, x = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
        out[y:y + int(rng.integers(8, h // 2)),
            x:x + int(rng.integers(8, w // 2))] = v
    return out


def _pascal_tree(root, rng):
    """PASCAL-Context in its own layout: 16 train and 8 val ids whose
    images are the JPEG fixtures in turn (VOC's 500x375, 375x500, 500x333
    and 400x300, baseline 4:2:0, 4:4:4 with restarts, grey, progressive
    4:2:2, EXIF-rotated), the .mat label maps and human-parts ``anno``
    structs (``scipy.io.savemat``), palette semseg PNGs, RGB normals, grey
    saliency and the ``db_info`` JSONs. Returns {split: [(id, (h, w))]}."""
    import numpy as np
    import scipy.io as sio

    from mtt_tpu_torch.data.image_io import read_image
    jpegs = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
    os.makedirs(os.path.join(root, "db_info"))
    with open(os.path.join(root, "db_info", "nyu_classes.json"), "w") as f:
        json.dump(DATA_NYU, f)
    with open(os.path.join(root, "db_info", "context_classes.json"),
              "w") as f:
        json.dump(DATA_CONTEXT, f)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    ids, k = {}, 0
    part_dt = [("part_name", "O"), ("mask", "O")]
    obj_dt = [("class", "O"), ("class_ind", "O"), ("mask", "O"),
              ("parts", "O")]
    for split, n in (("train", DATA_TRAIN), ("val", DATA_VAL)):
        ids[split] = []
        for i in range(n):
            name = f"200{8 + (split == 'val')}_{i:06d}"
            src = os.path.join(FIXTURES, jpegs[k % len(jpegs)])
            k += 1
            with open(src, "rb") as f:
                _write(os.path.join(root, "JPEGImages", name + ".jpg"),
                       f.read())
            h, w = read_image(src, "pil_rgb").shape[:2]
            ids[split].append((name, (h, w)))
            lbl = _data_blocks(rng, h, w, list(DATA_CONTEXT.values()),
                               np.uint16)
            os.makedirs(os.path.join(root, "pascal-context", "trainval"),
                        exist_ok=True)
            sio.savemat(os.path.join(root, "pascal-context", "trainval",
                                     name + ".mat"), {"LabelMap": lbl})
            objs = [("chair", np.array([[9]], np.uint8), lbl == 9,
                     np.zeros((0, 0)))]
            if i % 2 == 0:
                parts = np.zeros((1, 4), part_dt)
                for j in range(4):
                    m = np.zeros((h, w), np.uint8)
                    y, x = int(rng.integers(0, h - 40)), \
                        int(rng.integers(0, w - 40))
                    m[y:y + 40, x:x + 40] = 1
                    parts[0, j] = (DATA_PARTS[(i + j) % len(DATA_PARTS)], m)
                objs.append(("person", np.array([[15]], np.uint8),
                             (lbl == 15).astype(np.uint8), parts))
            arr = np.zeros((1, len(objs)), obj_dt)
            for j, o in enumerate(objs):
                arr[0, j] = o
            anno = np.zeros((1, 1), [("imname", "O"), ("objects", "O")])
            anno[0, 0] = (name, arr)
            os.makedirs(os.path.join(root, "human_parts"), exist_ok=True)
            sio.savemat(os.path.join(root, "human_parts", name + ".mat"),
                        {"anno": anno})
            sem = _data_blocks(rng, h, w, [0, 15, 7, 9, 12, 255], np.uint8)
            _write(os.path.join(root, "semseg", "VOC12", name + ".png"),
                   _png_encode(sem, palette))
            _write(os.path.join(root, "normals_distill", name + ".png"),
                   _png_encode(_data_photo(rng, h, w)))
            _write(os.path.join(root, "sal_distill", name + ".png"),
                   _png_encode(_data_photo(rng, h, w)[..., 1]))
        os.makedirs(os.path.join(root, "ImageSets", "Context"), exist_ok=True)
        with open(os.path.join(root, "ImageSets", "Context",
                               split + ".txt"), "w") as f:
            f.write("\n".join(n for n, _ in ids[split]) + "\n")
    return ids


def _cityscapes_tree(root, rng):
    """Cityscapes-3D's val split in its own layout: 4 frames at 1024x2048,
    each an RGB PNG with mixed filters, a labelIds PNG, a 16-bit disparity
    PNG (zeros where invalid) and a gtBbox3d JSON with boxes of the
    evaluated classes and one that is not."""
    import numpy as np

    from mtt_tpu_torch.detection.cs_geometry import EVAL_LABELS
    h, w = SW_IMG
    frames = []
    for i in range(DATA_CS_FRAMES):
        city = ("frankfurt", "lindau", "munster")[i % 3]
        base = f"{city}_000000_{i:06d}_"

        def at(kind, suffix):
            return os.path.join(root, kind, "val", city, base + suffix)
        img_path = at("leftImg8bit", "leftImg8bit.png")
        frames.append(img_path)
        _write(img_path, _png_encode(_data_photo(rng, h, w)))
        lbl = _data_blocks(rng, h, w, [7, 8, 10, 11, 13, 21, 23, 24, 26, 0],
                           np.uint8)
        _write(at("gtFine", "gtFine_labelIds.png"), _png_encode(lbl))
        disp = rng.integers(1, 30000, (h, w)).astype(np.uint16)
        disp[rng.random((h, w)) < 0.2] = 0
        _write(at("disparity", "disparity.png"), _png_encode(disp))
        objs = []
        for j, label in enumerate(list(EVAL_LABELS) + ["person"]):
            q = rng.normal(size=4)
            x0, y0 = rng.uniform(0, w - 300), rng.uniform(300, h - 300)
            objs.append({
                "label": label,
                "2d": {"modal": [x0, y0, 200.0, 150.0],
                       "amodal": [x0 - 5, y0 - 5, 210.0, 160.0]},
                "3d": {"center": [float(rng.uniform(8, 60)),
                                  float(rng.uniform(-10, 10)),
                                  float(rng.uniform(0, 1.5))],
                       "dimensions": [float(v) for v in
                                      rng.uniform(1, 5, 3)],
                       "rotation": [float(v) for v in
                                    q / np.linalg.norm(q)]}})
        sensor = {"fx": SW_CAM_K[0][0], "fy": SW_CAM_K[1][1],
                  "u0": SW_CAM_K[0][2], "v0": SW_CAM_K[1][2],
                  "sensor_T_ISO_8855": [[0.999, -0.0195, -0.038, -1.65],
                                        [0.0195, 0.9998, 0.0, -0.133],
                                        [0.038, -0.0007, 0.9993, -1.284]]}
        os.makedirs(os.path.dirname(at("gtBbox3d", "")), exist_ok=True)
        with open(at("gtBbox3d", "gtBbox3d.json"), "w") as f:
            json.dump({"sensor": sensor, "objects": objs}, f)
    return frames


def _nyud_tree(root, rng):
    """NYUD-v2's val split in its own layout: 4 ids at 448x576, RGB image,
    edge, 40-class segmentation and normals PNGs, depth .npy."""
    import numpy as np
    h, w = NYUD_IMG
    names = [f"{i:04d}" for i in range(DATA_NYUD)]
    os.makedirs(os.path.join(root, "gt_sets"))
    for split in ("train", "val"):
        with open(os.path.join(root, "gt_sets", split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    os.makedirs(os.path.join(root, "depth"))
    for name in names:
        _write(os.path.join(root, "images", name + ".png"),
               _png_encode(_data_photo(rng, h, w)))
        _write(os.path.join(root, "edge", name + ".png"), _png_encode(
            (rng.random((h, w)) < 0.05).astype(np.uint8) * 255))
        _write(os.path.join(root, "segmentation", name + ".png"),
               _png_encode(_data_blocks(rng, h, w, list(range(0, 41, 4)),
                                        np.uint8)))
        _write(os.path.join(root, "normals", name + ".png"),
               _png_encode(_data_photo(rng, h, w)))
        np.save(os.path.join(root, "depth", name + ".npy"),
                rng.uniform(0.5, 10, (h, w)).astype(np.float32))


def datasets_phase():
    """Phase 18: the dataset readers from data roots on disk, in a
    temporary directory on the card's host (see the module docstring).
    Returns the launch counts of the ``data`` path: ``main``'s steps and
    evals, the Swin-B ``test_phase`` and the NYUD eval batch."""
    import hashlib

    import numpy as np
    from mtt_tpu_torch import main as port_main
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.data import image_io
    from mtt_tpu_torch.data.datasets import laplacian, zhang_suen_thin
    from mtt_tpu_torch.evaluation import save_preds
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils import train_utils
    from mtt_tpu_torch.utils.train_utils import test_phase

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cwd, stdout = os.getcwd(), sys.stdout
    env_root = os.environ.get("MTT_DATA_ROOT")
    real_train = train_utils.train_phase
    work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    rng = np.random.default_rng(18)
    counts = {}

    def restore_stdout():
        if sys.stdout is not stdout:
            sys.stdout.close()
            sys.stdout = stdout

    os.chdir(work)
    try:
        # a. the committed JPEG fixtures against PIL's and cv2's digests
        with open(os.path.join(FIXTURES, "pixels.json")) as f:
            table = json.load(f)
        for name, entry in sorted(table.items()):
            for key, mode in (("pil", "pil"), ("cv2", "cv2_color")):
                a = np.ascontiguousarray(image_io.read_image(
                    os.path.join(FIXTURES, name), mode))
                if list(a.shape) != entry[key]["shape"] or hashlib.sha256(
                        a.tobytes()).hexdigest() != entry[key]["sha256"]:
                    raise RuntimeError(f"datasets: {name} in mode {mode} "
                                       f"decodes to other pixels than "
                                       f"{key}'s")
        print(f"[datasets] {len(table)} JPEG fixtures decoded by this "
              f"host's g++ build to PIL's and cv2's pixels (SHA-256 equal, "
              f"EXIF orientation as cv2 applies it)", flush=True)

        # b. the trees
        t = time.perf_counter()
        pascal_root = os.path.join(work, "PASCALContext")
        ids = _pascal_tree(pascal_root, rng)
        cs_root = os.path.join(work, "Cityscapes3D")
        frames = _cityscapes_tree(cs_root, rng)
        nyud_root = os.path.join(work, "NYUD_MT")
        _nyud_tree(nyud_root, rng)
        print(f"[datasets] trees written in {time.perf_counter() - t:.1f} s:"
              f" PASCAL-Context {DATA_TRAIN} train + {DATA_VAL} val ids at "
              f"{sorted({s for v in ids.values() for _, s in v})}, "
              f"Cityscapes-3D {DATA_CS_FRAMES} val frames at {SW_IMG}, "
              f"NYUD-v2 {DATA_NYUD} val ids at {NYUD_IMG}", flush=True)

        # c. main on the PASCAL tree: ViT-L, 4 iterations, an eval every 2,
        # a log line every iteration (main's train_phase logs every 50)
        os.environ["MTT_DATA_ROOT"] = pascal_root
        train_utils.train_phase = functools.partial(real_train, log_every=1)
        _build.reset_counts()
        t = time.perf_counter()
        rc = port_main.main(["--config_exp", LOOP_CONFIG, "--max_iter",
                             str(DATA_ITERS), "--val_interval",
                             str(DATA_VAL_EVERY)])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        train_utils.train_phase = real_train
        counts["main"] = dict(_build.COUNTS)
        restore_stdout()
        p = create_config(LOOP_CONFIG, {"run_mode": "infer"})
        evals = DATA_ITERS // DATA_VAL_EVERY
        want = {k: DATA_ITERS * v + evals * DATA_VAL_BATCHES
                * expected_eval("factored")[k]
                for k, v in expected_train().items()}
        with open(os.path.join(p["output_dir"], "log_file.txt")) as f:
            log = f.read()
        steps = re.findall(r"iter (\d+) total (\S+) \(([0-9.]+) imgs/s\)",
                           log)
        print(f"[datasets] main --max_iter {DATA_ITERS} --val_interval "
              f"{DATA_VAL_EVERY} on {os.path.relpath(LOOP_CONFIG, cwd)} with "
              f"MTT_DATA_ROOT at the PASCAL tree: rc {rc}, {main_s:.1f} s; "
              f"losses {[float(s[1]) for s in steps]}; imgs/s from the log "
              f"lines {[float(s[2]) for s in steps]} (the first with the "
              f"loader's start); launches {counts['main']}", flush=True)
        if rc != 0 or counts["main"] != want:
            raise RuntimeError(f"datasets: main returned {rc}, launches "
                               f"{counts['main']} != {want}")
        if [int(s[0]) for s in steps] != list(range(1, DATA_ITERS + 1)) or \
                not all(math.isfinite(float(s[1])) for s in steps):
            raise RuntimeError(f"datasets: log lines {steps}")
        tasks = p.TASKS.NAMES
        scores = [_finite_scores(os.path.join(
            p["save_dir"], f"results_iter{it}.json"), tasks)
            for it in range(DATA_VAL_EVERY, DATA_ITERS + 1, DATA_VAL_EVERY)]
        print(f"[datasets] scores at iteration {DATA_ITERS} "
              f"{json.dumps(scores[-1])}", flush=True)
        edge_dir = os.path.join(p["save_dir"], "edge")
        shapes = {n[:-4]: save_preds.read_png(os.path.join(edge_dir, n))
                  .shape for n in os.listdir(edge_dir)}
        if shapes != {n: s for n, s in ids["val"]}:
            raise RuntimeError(f"datasets: edge PNGs {shapes}, want one a "
                               f"val image at its size {ids['val']}")
        print(f"[datasets] {len(shapes)} edge PNGs, each at its val "
              f"image's own size (crop_padding of the 512x512 pad)",
              flush=True)

        # d. Swin-B test_phase over the Cityscapes tree
        os.environ["MTT_DATA_ROOT"] = cs_root
        p, trainer = _cs3d_trainer("infer", 18)
        p["save_dir"] = os.path.join(work, "cs")
        _, val_tf = cc.get_transformations(p)
        ds = cc.get_dataset(p, "val", val_tf)
        if type(ds).__name__ != "Cityscapes3D" or len(ds) != DATA_CS_FRAMES:
            raise RuntimeError(f"datasets: {type(ds).__name__} of {len(ds)}")
        torch.cuda.synchronize()
        _build.reset_counts()
        t = time.perf_counter()
        cs_scores = test_phase(p, trainer.model, cc.get_test_dataloader(p,
                                                                        ds))
        torch.cuda.synchronize()
        cs_s = time.perf_counter() - t
        counts["cs3d"] = dict(_build.COUNTS)
        print(f"[datasets] Swin-B test_phase over the {DATA_CS_FRAMES} "
              f"Cityscapes-3D frames from disk (get_dataset, CS3D val "
              f"transforms): {cs_s:.2f} s; scores {json.dumps(cs_scores)}; "
              f"launches {counts['cs3d']}", flush=True)
        det = cs_scores.get("3ddet", {})
        if counts["cs3d"] != expected_swin() or set(cs_scores) != {
                "semseg", "depth", "3ddet"} or not all(
                math.isfinite(v) for s in cs_scores.values()
                for v in s.values()) or set(det) != {
                "mDetection_Score", "mAP"} or not all(
                0.0 <= v <= 1.0 for v in det.values()):
            raise RuntimeError(f"datasets: Cityscapes-3D launches "
                               f"{counts['cs3d']} (want {expected_swin()}) "
                               f"or scores {cs_scores}")
        del trainer
        torch.cuda.empty_cache()

        # e. one NYUD TaskPrompter-ViT-L eval batch from disk
        os.environ["MTT_DATA_ROOT"] = nyud_root
        p = create_config(NYUD_CONFIG, {"run_mode": "infer"})
        gen = torch.Generator(device=dev).manual_seed(19)
        model = build_model(p, img_size=tuple(p.TEST.SCALE), device=dev,
                            dtype=torch.bfloat16).eval()
        init_weights(model, gen)
        _, val_tf = cc.get_transformations(p)
        ds = cc.get_dataset(p, "val", val_tf)
        loader = cc.get_test_dataloader(p, ds)
        torch.cuda.synchronize()
        _build.reset_counts()
        ny_scores = test_phase(p, model, loader)
        torch.cuda.synchronize()
        counts["nyud"] = dict(_build.COUNTS)
        print(f"[datasets] NYUD TaskPrompter-ViT-L test_phase over "
              f"{len(ds)} images from disk ({len(loader)} batch of "
              f"{p['valBatch']}): scores {json.dumps(ny_scores)}; launches "
              f"{counts['nyud']}", flush=True)
        if type(ds).__name__ != "NYUD_MT" or len(loader) != 1 or \
                counts["nyud"] != expected_nyud_taskprompter() or \
                set(ny_scores) != set(p.TASKS.NAMES) or not all(
                math.isfinite(v) for s in ny_scores.values()
                for v in s.values()):
            raise RuntimeError(f"datasets: NYUD launches {counts['nyud']} "
                               f"(want {expected_nyud_taskprompter()}) or "
                               f"scores {ny_scores}")
        del model
        torch.cuda.empty_cache()

        # f. the host's share: decoders, a PASCAL sample, the loader
        with open(os.path.join(FIXTURES, "baseline_420.jpg"), "rb") as f:
            jpg = f.read()
        jpeg_ms = _wall_ms(lambda: image_io.read_jpeg(jpg), 20)
        png_ms = _wall_ms(lambda: image_io.read_png(frames[0]), 5)
        png_plain_ms = _wall_ms(lambda: image_io.read_png(frames[0],
                                                          impl="plain"), 3)
        if not np.array_equal(image_io.read_png(frames[0]),
                              image_io.read_png(frames[0], impl="plain")):
            raise RuntimeError("datasets: the PNG unfilters disagree")
        print(f"[datasets] host decode: a 500x375 4:2:0 JPEG "
              f"{jpeg_ms:.2f} ms (median of 20); a 1024x2048 RGB PNG with "
              f"mixed filters {png_ms:.1f} ms native, {png_plain_ms:.1f} ms "
              f"with the numpy unfilter (medians of 5 and 3, zlib included)",
              flush=True)
        os.environ["MTT_DATA_ROOT"] = pascal_root
        p = create_config(LOOP_CONFIG, {"run_mode": "infer"})
        train_tf, _ = cc.get_transformations(p)
        raw = cc.get_dataset(p, "train")
        sample_ms = _wall_ms(lambda: [raw[i] for i in range(len(raw))], 3) \
            / len(raw)
        import scipy.io as sio
        maps = [sio.loadmat(raw.edges[i])["LabelMap"]
                for i in range(len(raw))]
        thin_ms = _wall_ms(lambda: [zhang_suen_thin(np.abs(laplacian(m)) > 0)
                                    for m in maps], 3) / len(raw)
        loader = cc.get_train_dataloader(p, cc.get_dataset(p, "train",
                                                           train_tf))
        t = time.perf_counter()
        for i, _ in enumerate(loader):
            if i == 3:
                break
        loader_ms = (time.perf_counter() - t) * 1e3 / 4
        print(f"[datasets] a PASCAL sample from disk (5 tasks, no "
              f"transforms) {sample_ms:.1f} ms, of it the edge's Laplacian "
              f"and zhang_suen_thin {thin_ms:.1f} ms "
              f"({100 * thin_ms / sample_ms:.0f}%); the loader "
              f"{loader_ms:.1f} ms per batch of {p['trBatch']} through the "
              f"training transforms ({p.get('nworkers', 2)} threads, 4 "
              f"batches from the pool's start; phase 14 times the synthetic "
              f"batches)", flush=True)
        print(f"[datasets] phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        return {"data": {k: sum(c[k] for c in counts.values())
                         for k in _build.COUNTS}}
    finally:
        restore_stdout()
        train_utils.train_phase = real_train
        if env_root is None:
            os.environ.pop("MTT_DATA_ROOT", None)
        else:
            os.environ["MTT_DATA_ROOT"] = env_root
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


OPT_TIMED_STEPS = 3              # timed steps a trainer, plain and remat in turns


def expected_invpt_train_remat() -> dict:
    """The InvPT-ViT-L step with ``remat``: every ViT block runs again in
    the backward, so its forward launches count twice: the attention
    (cached kernel) of all 24, LayerNorm + the plain MLP of blocks 1..23,
    the fused half-block of block 0. The decoder is not rematted."""
    base = expected_invpt_train()
    return {**base, "attention_cached": 24 + 24,
            "layernorm": base["layernorm"] + 23,
            "mlp_ln_res": base["mlp_ln_res"] + 1,
            "mlp_fc": base["mlp_fc"] + 23}


def expected_swin_train_remat() -> dict:
    """The Swin-B step with ``remat``: every Swin block runs again in the
    backward (20 window attentions, the 47 MLPs and 95 LayerNorms of the
    blocks); the 2D heads and the detection head, rematted too, are torch.
    The patch norm, the merges' and the final norm are not rematted."""
    base = expected_swin_train()
    blocks = sum((2, 2, 18, 2))
    return {**base, "window_attention": 2 * (blocks - 4),
            "mlp_fc": 2 * (2 * blocks - 1),
            "layernorm": base["layernorm"] + 4 * blocks - 1}


def _remat_pair(tag, title, p, seed, batch_size, want, want_remat):
    """The step of config ``p`` with ``remat`` off and on, from one state
    and one generator (``make_trainer`` twice on ``seed``), under
    deterministic library algorithms: the rematted step's losses, every
    gradient, every BN running statistic and the drop-path generator's
    state after the step equal the plain step's bits; the launch counts of
    each; the step's own peak memory (over what was allocated when it
    began); after one untimed step each, ms per step (host clock),
    OPT_TIMED_STEPS steps each, in turns. Returns the counts of each."""
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.train import make_trainer
    from mtt_tpu_torch.utils.train_utils import to_device

    dev = torch.device("cuda")
    runs = {}
    for remat in (False, True):
        trainer, data = make_trainer(dict(p, remat=remat), seed=seed,
                                     device=dev)
        runs[remat] = {"trainer": trainer}
    batches = [to_device(data.batch(i * batch_size, batch_size), dev)
               for i in range(1 + OPT_TIMED_STEPS)]
    for remat, run in runs.items():
        trainer = run["trainer"]
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        with _deterministic():
            losses = trainer.backward(batches[0])
        torch.cuda.synchronize()
        run.update(counts=dict(_build.COUNTS), losses=losses,
                   peak=(torch.cuda.max_memory_allocated() - start) / 2 ** 30,
                   grads={n: w.grad for n, w in
                          trainer.model.named_parameters()},
                   buffers=dict(trainer.model.named_buffers()),
                   gen=trainer.generator.get_state())
        print(f"[options] {tag} remat {'on' if remat else 'off'}: {title}; "
              f"launches of one step {run['counts']}", flush=True)
    plain, rem = runs[False], runs[True]
    for counts, expected in ((plain["counts"], want),
                             (rem["counts"], want_remat)):
        if counts != expected:
            raise RuntimeError(f"options {tag} launch counts {counts} != "
                               f"{expected}")
    differ = [k for k in plain["losses"]
              if not torch.equal(plain["losses"][k], rem["losses"][k])]
    differ += [n for n, g in plain["grads"].items()
               if (g is None) != (rem["grads"][n] is None)
               or (g is not None and not torch.equal(g, rem["grads"][n]))]
    differ += [n for n, b in plain["buffers"].items()
               if not torch.equal(b, rem["buffers"][n])]
    if not torch.equal(plain["gen"], rem["gen"]):
        differ.append("the drop-path generator's state")
    n_grads = sum(g is not None for g in plain["grads"].values())
    if differ or not all(torch.isfinite(v) for v in plain["losses"].values()):
        raise RuntimeError(f"options {tag}: the rematted step differs from "
                           f"the plain one in {differ[:8]} ({len(differ)} "
                           f"in all), or a loss is not finite")
    print(f"[options] {tag}: the rematted step equals the plain one to the "
          f"bit: {len(plain['losses'])} losses, {n_grads} gradients, "
          f"{len(plain['buffers'])} buffers, the generator state", flush=True)
    for run in runs.values():
        for k in ("losses", "grads", "buffers"):
            del run[k]
    for run in runs.values():     # untimed: Adam's state is made here
        run["trainer"].step(batches[1])
    ms = {False: [], True: []}
    for batch in batches[1:]:
        for remat, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run["trainer"].step(batch)
            torch.cuda.synchronize()
            ms[remat].append((time.perf_counter() - t0) * 1e3)
    med = {r: statistics.median(v) for r, v in ms.items()}
    print(f"[options] {tag}: peak memory of the checked step over its start "
          f"remat off {plain['peak']:.3f} GiB, on {rem['peak']:.3f} GiB "
          f"({rem['peak'] / plain['peak']:.3f}x); ms per step (median of "
          f"{OPT_TIMED_STEPS}, in turns) off {med[False]:.2f} "
          f"{[round(v, 2) for v in ms[False]]}, on {med[True]:.2f} "
          f"{[round(v, 2) for v in ms[True]]} ({med[True] / med[False]:.3f}"
          f"x)", flush=True)
    if not rem["peak"] < plain["peak"]:
        raise RuntimeError(f"options {tag}: remat did not lower the step's "
                           f"peak memory")
    return {f"{tag}_step": plain["counts"],
            f"{tag}_step_remat": rem["counts"]}


def _swin_conv_check(batch: int = B) -> dict:
    """TaskPrompter-Swin-B Cityscapes-3D with the ``conv`` head (JAX's dense
    ConvHead on the fused map) at ``batch`` images of 1024x2048 through
    ``predict``: launch counts, shapes, finiteness, every 2D map and
    detection level within FORWARD_RMS_TOL of an f32 run of the same
    weights. Returns the launch counts."""
    from mtt_tpu_torch.inference import preprocess, predict
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import CS3D_SWINB, build_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    model = build_model(dict(CS3D_SWINB, head="conv"), device=dev,
                        dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    x = preprocess(torch.randint(0, 256, (batch, *SW_IMG, 3), generator=gen,
                                 device=dev))
    K = torch.tensor(SW_CAM_K, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    logits, preds = predict(model, x, cam_K=K)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[options] swin_conv: TaskPrompter-Swin-B Cityscapes-3D with the "
          f"conv head, batch {batch} at {SW_IMG[0]}x{SW_IMG[1]} bf16; "
          f"launches {counts}", flush=True)
    if counts != expected_swin():
        raise RuntimeError(f"options swin_conv launch counts {counts} != "
                           f"{expected_swin()}")
    for t, n in {"semseg": 19, "depth": 1}.items():
        if logits[t].shape != (batch, *SW_OUT, n) or \
                not torch.isfinite(logits[t]).all() or \
                preds[t].shape != (batch, *SW_OUT):
            raise RuntimeError(f"options swin_conv {t}: logits "
                               f"{tuple(logits[t].shape)} or non-finite")
    if preds["3ddet"]["scores"].shape[0] != batch:
        raise RuntimeError("options swin_conv: no decode for every image")
    forward = torch.no_grad()(lambda m, impl=None: m(x, impl=impl))
    plain = forward(model, "plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_model = copy.deepcopy(model).float()
    ref = forward(ref_model, "plain")
    del ref_model
    maps = {t: (logits[t], plain[t], ref[t]) for t in ("semseg", "depth")}
    levels = [_det_levels(o["3ddet"]) for o in (logits, plain, ref)]
    maps.update({k: (v, levels[1][k], levels[2][k])
                 for k, v in levels[0].items()})
    for name, (k, p, r) in maps.items():
        if not torch.isfinite(k).all():
            raise RuntimeError(f"options swin_conv {name}: non-finite")
        k, p, r = k.float(), p.float(), r.float()
        rms_k = ((k - r).norm() / r.norm()).item()
        rms_p = ((p - r).norm() / r.norm()).item()
        print(f"[options] swin_conv {name}: vs the f32 run: relative RMS "
              f"error kernels {rms_k:.5g} (tol {FORWARD_RMS_TOL}), plain "
              f"bf16 {rms_p:.5g}", flush=True)
        if not rms_k <= FORWARD_RMS_TOL:
            raise RuntimeError(f"options swin_conv {name}: kernel forward "
                               f"is {rms_k:.4g} from the f32 run, over "
                               f"{FORWARD_RMS_TOL}")
    del maps, levels, logits, preds, plain, ref
    ms = _time_ms(lambda: forward(model), reps=3, warmup=1)
    print(f"[options] swin_conv: forward {ms:.2f} ms = {batch / ms * 1e3:.2f}"
          f" imgs/s through the kernels; peak memory of the first predict "
          f"{peak_gib:.2f} GiB", flush=True)
    return counts


def options_phase():
    """The model options: the InvPT-ViT-L PASCAL step at batch 2
    and the Swin-B Cityscapes-3D step at batch 1, each with ``remat`` off
    and on (``_remat_pair``); then eval forwards at batch 8 of the head
    pairs that no shipped config uses, each held to its launch counts (the
    up4 head kernel at 0) and to an f32 run: TaskPrompter-ViT-L PASCAL with
    the phase, mlp and deconv heads, InvPT-ViT-L PASCAL with the conv and
    deconv heads (``_serve_check``), Swin-B with the conv head
    (``_swin_conv_check``). Returns the launch counts by path."""
    from mtt_tpu_torch.models.wrappers import INVPT_PASCAL_VITL
    from mtt_tpu_torch.train import (CS3D_SWINB_TRAIN,
                                     INVPT_PASCAL_VITL_TRAIN, PASCAL_VITL)

    counts = {}
    counts.update(_remat_pair(
        "invpt", f"InvPT-ViT-L PASCAL, batch {BT} at {IMG}x{IMG}",
        INVPT_PASCAL_VITL_TRAIN, 16, BT, expected_invpt_train(),
        expected_invpt_train_remat()))
    torch.cuda.empty_cache()
    counts.update(_remat_pair(
        "swin", f"TaskPrompter-Swin-B Cityscapes-3D, 1 image at "
        f"{SW_IMG[0]}x{SW_IMG[1]}", CS3D_SWINB_TRAIN, 6, 1,
        expected_swin_train(), expected_swin_train_remat()))
    torch.cuda.empty_cache()
    heads = (("tp_phase", "TaskPrompter-ViT-L PASCAL, phase up4 head",
              PASCAL_VITL, {"head_up4": "phase"}, expected_eval("dense")),
             ("tp_mlp", "TaskPrompter-ViT-L PASCAL, mlp head",
              dict(PASCAL_VITL, head="mlp"), {}, expected_eval("dense")),
             ("tp_deconv", "TaskPrompter-ViT-L PASCAL, deconv head",
              dict(PASCAL_VITL, head="deconv"), {}, expected_eval("dense")),
             ("invpt_conv", "InvPT-ViT-L PASCAL, conv head",
              dict(INVPT_PASCAL_VITL, head="conv"), {},
              expected_invpt(False)),
             ("invpt_deconv", "InvPT-ViT-L PASCAL, deconv head",
              dict(INVPT_PASCAL_VITL, head="deconv"), {},
              expected_invpt(False)))
    for i, (tag, title, p, kw, want) in enumerate(heads):
        model, x = _serve_model(p, 20 + i, (IMG, IMG), **kw)
        counts[tag] = _serve_check(f"options {tag}", title, model, x, want)
        del model, x
        torch.cuda.empty_cache()
    counts["swin_conv"] = _swin_conv_check()
    return counts


_PASCAL_TASKS = """  include_semseg: True
  include_human_parts: True
  include_sal: True
  include_edge: True
  include_normals: True
  edge_w: 0.95"""
_PASCAL_LOSSES = """    semseg: 1.0
    human_parts: 2.0
    sal: 5.0
    edge: 50.0
    normals: 10.0"""


def _limit_configs(work: str) -> dict:
    """The ``limits`` phase's experiments, each a shipped YAML with the
    keys that JAX's ``build_model`` reads changed, written into ``work``
    and read by ``create_config`` as ``main`` reads an experiment:
    ``cs3d_invpt``, configs/pascal/invpt_vitLp16.yml on Cityscapes-3D's 2D
    tasks (semseg and depth, the Cityscapes-3D YAML's loss weights, its
    trBatch of 1; 1024x2048 frames); ``pascal_invpt_wide``, the same at
    embed_dim 1024 (ViT-L's width; decoder width 1088); ``invpt_vitt``,
    backbone vitT at embed_dim 64 (decoder width 128, a multiple of 64, so
    row 9's head dims are 64, 32 and 16); ``tp_vitt``,
    configs/pascal/taskprompter_vitLp16.yml with backbone
    TaskPrompter_vitT and embed_dim and final_embed_dim 64 (every GEMM
    width a multiple of 8, the task decode's C / G = 16). The ViT-T widths
    are cut from the YAMLs' 512, 300 and 350 so that the CPU f32 forward
    that the card's is held to takes seconds."""
    from mtt_tpu_torch.config import create_config

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "pascal")
    invpt, tp = "invpt_vitLp16.yml", "taskprompter_vitLp16.yml"
    specs = {
        "cs3d_invpt": (invpt, (
            ("version_name: InvPT_pascal_vitLp16",
             "version_name: InvPT_cs3d_vitLp16"),
            ("train_db_name: PASCALContext", "train_db_name: Cityscapes3D"),
            ("val_db_name: PASCALContext", "val_db_name: Cityscapes3D"),
            ("trBatch: 2", "trBatch: 1"),
            ("ignore_index: 255",
             "ignore_index: 255\nignore_invalid_area_depth: True"),
            (_PASCAL_TASKS, "  include_semseg: True\n  include_depth: True"),
            (_PASCAL_LOSSES, "    semseg: 100.0\n    depth: 1.0"))),
        "pascal_invpt_wide": (invpt, (("embed_dim: 512", "embed_dim: 1024"),)),
        "invpt_vitt": (invpt, (("backbone: vitL", "backbone: vitT"),
                               ("embed_dim: 512", "embed_dim: 64"))),
        "tp_vitt": (tp, (("backbone: TaskPrompter_vitL",
                          "backbone: TaskPrompter_vitT"),
                         ("final_embed_dim: 350", "final_embed_dim: 64"),
                         ("embed_dim: 300", "embed_dim: 64"))),
    }
    out = {}
    for name, (src, subs) in specs.items():
        with open(os.path.join(root, src)) as f:
            text = f.read()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"limits: {src} has {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        path = os.path.join(work, f"{name}.yml")
        with open(path, "w") as f:
            f.write(text)
        out[name] = create_config(path, {"run_mode": "infer"})
    return out


def expected_limits_invpt(depth: int, tasks: int, train: bool) -> dict:
    """InvPT on a ViT of ``depth`` blocks: the forward's launches as
    ``expected_invpt`` (one tail launch a task), the step's as
    ``expected_invpt_train`` (blocks 1.. under drop-path)."""
    if train:
        return _expected(layernorm=depth - 1 + 1 + 6 + 3,
                         attention_cached=depth, attention_bwd=depth,
                         mlp_ln_res=1, mlp_fc=depth - 1 + 3,
                         invpt_attention=3)
    return _expected(layernorm=1 + 6 + 3, attention_cached=depth,
                     mlp_ln_res=depth, mlp_fc=3, invpt_attention=3,
                     invpt_tail=tasks)


def expected_limits_tp(depth: int, taps: int, train: bool) -> dict:
    """TaskPrompter on a ViT of ``depth`` blocks with ``taps`` tap blocks
    (the emit front half; ViT-T's four blocks all tap): the forward's
    launches as ``expected_eval("factored")``, the step's as
    ``expected_train``."""
    if train:
        return _expected(layernorm=depth - 1 + taps + 1,
                         attention_cached=depth - taps,
                         attention_emit=taps, attention_bwd=depth,
                         mlp_ln_res=1, mlp_fc=depth - 1, task_decode=taps)
    return _expected(layernorm=taps + 1, attention_cached=depth - taps,
                     attention_emit=taps, mlp_ln_res=depth,
                     task_decode=taps, head_up4=T)


def _limit_trainer(tag, p, seeds, batch_size):
    """A trainer of config ``p`` (``make_trainer``) and its first two
    synthetic batches, from the first of ``seeds`` whose checked step keeps
    every InvPT decoder branch for at least one sample: ``_train_run``
    refuses a step that drops a branch for every sample (that branch's
    gradient would go unchecked), and at batch 1 each of the six branches
    is dropped at rate 0.15. One step a seed tried, printed."""
    from mtt_tpu_torch.train import make_trainer
    from mtt_tpu_torch.utils.train_utils import to_device

    dev = torch.device("cuda")
    for seed in seeds:
        trainer, data = make_trainer(p, seed=seed, device=dev)
        batches = [to_device(data.batch(i * batch_size, batch_size), dev)
                   for i in range(2)]
        masks = _DropPathMasks(trainer.model)
        with masks:
            trainer.backward(batches[0])
        dead = masks.dead()
        print(f"[{tag}] seed {seed}: decoder branches dropped for every "
              f"sample {dead}", flush=True)
        del trainer, data, masks
        torch.cuda.empty_cache()
        if not dead:
            trainer, _ = make_trainer(p, seed=seed, device=dev)
            return trainer, batches
    raise RuntimeError(f"{tag}: every seed of {seeds} drops a decoder "
                       f"branch for every sample")


def _cpu_f32_check(tag, model, x) -> None:
    """The card's f32 plain forward of ``model``'s weights against the
    port's CPU f32 forward of the same weights on the first image (the CPU
    tests hold the CPU path to JAX; ``_serve_check`` holds the kernels to
    the card's f32 path): every map within LIMIT_CPU_TOL of the CPU map's
    largest value, f32 products and convolutions in f32 (no TF32) on the
    card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = copy.deepcopy(model).float()
    host = copy.deepcopy(ref).to("cpu")
    with torch.no_grad():
        card = ref(x[:1], impl="plain")
        cpu = host(x[:1].cpu(), impl="plain")
    del ref, host
    maps = {t: (card[t], cpu[t]) for t in model.tasks}
    if "inter_preds" in cpu:
        maps.update({f"inter_preds.{t}": (card["inter_preds"][t], v)
                     for t, v in cpu["inter_preds"].items()})
    worst = 0.0
    for name, (c, h) in maps.items():
        e = (c.float().cpu() - h.float()).abs().max().item() \
            / h.float().abs().max().item()
        worst = max(worst, e)
        if not e <= LIMIT_CPU_TOL:
            raise RuntimeError(f"{tag} {name}: the card's f32 forward is "
                               f"{e:.3g} of its scale from the CPU's, over "
                               f"{LIMIT_CPU_TOL}")
    print(f"[{tag}] the card's f32 plain forward against the CPU's on the "
          f"first image: every map within {worst:.3g} of its scale (tol "
          f"{LIMIT_CPU_TOL}), {len(maps)} maps", flush=True)


def limits_phase():
    """Models JAX's ``build_model`` builds from a YAML past the shipped
    configs (``_limit_configs``), through the kernels at the shapes that
    lifted their limits: InvPT-ViT-L on Cityscapes-3D's 2D tasks at
    1024x2048 (row 9 at 1024 keys, rows 1-2 over 8,193 tokens), eval at
    batch 1 (``_serve_check``) and one training step at batch 1 with
    intermediate supervision (``_train_run``); InvPT-ViT-L PASCAL at
    embed_dim 1024 (row 9 at head dim 544, row 3 at 5440 columns), eval at
    batch 8; InvPT-ViT-T and TaskPrompter-ViT-T PASCAL (the attention core
    and row 7 at head dim 16), eval at batch 8, the card's f32 plain
    forward held to the CPU's (``_cpu_f32_check``), and one step at the
    YAMLs' batch of 2. Returns the launch counts by path."""
    counts = {}
    work = tempfile.mkdtemp(prefix="mtt_limits_")
    try:
        cfg = _limit_configs(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def loss_keys(p):
        inter = p.get("intermediate_supervision", False)
        return {*p.TASKS.NAMES, "total",
                *(f"inter_{t}" for t in p.TASKS.NAMES if inter)}

    p = cfg["cs3d_invpt"]
    size = tuple(p.TEST.SCALE)
    title = (f"InvPT-ViT-L Cityscapes-3D 2D tasks (semseg, depth; "
             f"{CS3D_LK} keys)")
    model, x = _serve_model(p, 30, size, batch=1)
    counts["limits_cs3d_invpt"] = _serve_check(
        "limits cs3d_invpt", title, model, x,
        expected_limits_invpt(24, 2, False))
    del model, x
    torch.cuda.empty_cache()
    trainer, batches = _limit_trainer("limits cs3d_invpt_step", p,
                                      range(31, 39), 1)
    counts["limits_cs3d_invpt_step"] = _train_run(
        "limits cs3d_invpt_step", f"{title}, 1 image at {size[0]}x{size[1]}",
        trainer, batches, expected_limits_invpt(24, 2, True), 1,
        loss_keys=loss_keys(p))
    del trainer, batches
    torch.cuda.empty_cache()

    model, x = _serve_model(cfg["pascal_invpt_wide"], 40, (IMG, IMG))
    counts["limits_invpt_wide"] = _serve_check(
        "limits invpt_wide", f"InvPT-ViT-L PASCAL at embed_dim 1024 "
        f"(decoder width {WIDE_D})", model, x, expected_invpt(False))
    del model, x
    torch.cuda.empty_cache()

    for tag, title, want, seed in (
            ("invpt_vitt", "InvPT-ViT-T PASCAL (4 heads of 16, decoder "
             "width 128)", expected_limits_invpt, 50),
            ("tp_vitt", "TaskPrompter-ViT-T PASCAL (4 heads of 16, widths "
             "64)", expected_limits_tp, 60)):
        p = cfg[tag]
        kw = {"tasks": T} if want is expected_limits_invpt else {"taps": 4}
        model, x = _serve_model(p, seed, (IMG, IMG))
        counts[f"limits_{tag}"] = _serve_check(
            f"limits {tag}", title, model, x, want(4, train=False, **kw))
        _cpu_f32_check(f"limits {tag}", model, x)
        del model, x
        torch.cuda.empty_cache()
        trainer, batches = _limit_trainer(f"limits {tag}_step", p,
                                          range(seed + 1, seed + 9), BT)
        counts[f"limits_{tag}_step"] = _train_run(
            f"limits {tag}_step", f"{title}, batch {BT} at {IMG}x{IMG}",
            trainer, batches, want(4, train=True, **kw), BT,
            loss_keys=loss_keys(p))
        del trainer, batches
        torch.cuda.empty_cache()
    return counts


def _width_configs(work: str) -> dict:
    """The ``widths`` phase's experiments, read by ``create_config`` as
    ``main`` reads an experiment: ``invpt_w600``,
    configs/pascal/invpt_vitLp16.yml at embed_dim 600 (decoder width 664;
    stage widths 332 and 166 and head dims 332, 166 and 83 are not
    multiples of 8, nor are the stage norms of 1660 and 830 columns);
    ``tp_w768``, configs/pascal/taskprompter_vitLp16.yml at embed_dim and
    final_embed_dim 768 with its chan_nheads of 1 (the task decode at tar =
    F = 768, past the one launch); ``swin_tiny``,
    configs/cityscapes3d/taskprompter_swinB.yml as shipped, which
    ``build_model`` builds tiny under MTT_DEBUG_TINY (``debug_tiny``)."""
    from mtt_tpu_torch.config import create_config

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs")
    specs = {
        "invpt_w600": ("pascal/invpt_vitLp16.yml",
                       (("embed_dim: 512", "embed_dim: 600"),)),
        "tp_w768": ("pascal/taskprompter_vitLp16.yml",
                    (("final_embed_dim: 350", f"final_embed_dim: {W768}"),
                     ("embed_dim: 300", f"embed_dim: {W768}"))),
        "swin_tiny": ("cityscapes3d/taskprompter_swinB.yml", ()),
    }
    out = {}
    for name, (src, subs) in specs.items():
        with open(os.path.join(root, src)) as f:
            text = f.read()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"widths: {src} has {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        path = os.path.join(work, f"{name}.yml")
        with open(path, "w") as f:
            f.write(text)
        out[name] = create_config(path, {"run_mode": "infer"})
    return out


def expected_swin_tiny(train: bool) -> dict:
    """The ``MTT_DEBUG_TINY`` Swin (the launches of ``expected_swin``): its
    one block a stage is a tap block and takes the composition, as JAX's
    does, so no block reaches the window attention kernels."""
    fwd = _expected(window_attention=0, mlp_fc=7, layernorm=20)
    return {**fwd, "window_attention_bwd": 0} if train else fwd


@contextlib.contextmanager
def _tiny_swin():
    """``MTT_DEBUG_TINY=1`` as a user sets it for ``main``."""
    env = os.environ.get("MTT_DEBUG_TINY")
    os.environ["MTT_DEBUG_TINY"] = "1"
    try:
        yield
    finally:
        if env is None:
            os.environ.pop("MTT_DEBUG_TINY")
        else:
            os.environ["MTT_DEBUG_TINY"] = env


def _swin_tiny_check(tag: str, title: str, p, seed: int) -> dict:
    """The tiny Swin of ``p`` (``build_model`` under ``_tiny_swin``; bf16,
    seeded random weights) on one seeded 1024x2048 frame through
    ``predict`` with the fixed camera: launch counts, the 2D maps and every
    detection level finite, of their shapes, and within FORWARD_RMS_TOL
    (relative RMS) of an f32 run of the same weights, the decode's slots;
    then one training step at batch 1 (``_train_run``). Returns the
    forward's and the step's launch counts."""
    from mtt_tpu_torch.inference import predict, preprocess
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model
    from mtt_tpu_torch.train import make_trainer
    from mtt_tpu_torch.utils.train_utils import to_device

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    with _tiny_swin():
        model = build_model(p, device=dev, dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    x = preprocess(torch.randint(0, 256, (1, *SW_IMG, 3), generator=gen,
                                 device=dev))
    K = torch.tensor(SW_CAM_K, device=dev)
    n_params = sum(q.numel() for q in model.parameters())
    _build.reset_counts()
    logits, preds = predict(model, x, cam_K=K)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    print(f"[{tag}] {title}, {n_params / 1e6:.2f} M params, 1 image at "
          f"{SW_IMG[0]}x{SW_IMG[1]} bf16; launches {counts}", flush=True)
    want = expected_swin_tiny(False)
    if counts != want:
        raise RuntimeError(f"{tag} launch counts {counts} != {want}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_model = copy.deepcopy(model).float()
    ref, _ = predict(ref_model, x, impl="plain", cam_K=K)
    del ref_model
    maps = {t: (logits[t], ref[t]) for t in ("semseg", "depth")}
    ref_levels = _det_levels(ref["3ddet"])
    maps.update({k: (v, ref_levels[k])
                 for k, v in _det_levels(logits["3ddet"]).items()})
    widths = {"cls": 6, "bbox": 13, "dir": 6, "ctr": 1}
    worst = 0.0
    for name, (k, r) in maps.items():
        if name.startswith("3ddet."):
            lvl, kind = int(name[-1]), name.split(".")[1][:-1]
            shape = (1, *SW_LEVELS[lvl], widths[kind])
        else:
            shape = (1, *SW_OUT, 19 if name == "semseg" else 1)
        if k.shape != shape or not torch.isfinite(k).all():
            raise RuntimeError(f"{tag} {name}: {tuple(k.shape)} (want "
                               f"{shape}) or non-finite")
        k, r = k.float(), r.float()
        rms = ((k - r).norm() / r.norm()).item()
        worst = max(worst, rms)
        if not rms <= FORWARD_RMS_TOL:
            raise RuntimeError(f"{tag} {name}: kernel forward is {rms:.4g} "
                               f"(relative RMS) from the f32 run, over "
                               f"{FORWARD_RMS_TOL}")
    n_det = model.det_cfg["test_cfg"]["max_per_img"]
    if preds["3ddet"]["boxes3d"].shape != (1, n_det, 9):
        raise RuntimeError(f"{tag} decode: "
                           f"{tuple(preds['3ddet']['boxes3d'].shape)}")
    print(f"[{tag}] {len(maps)} maps (semseg, depth, 20 detection levels) "
          f"finite and of their shapes, worst relative RMS against the f32 "
          f"run {worst:.5g} (tol {FORWARD_RMS_TOL}); decode {n_det} slots",
          flush=True)
    del logits, preds, ref, maps
    ms = _time_ms(lambda: predict(model, x, cam_K=K), reps=5, warmup=1)
    print(f"[{tag}] predict {ms:.2f} ms", flush=True)
    del model, x
    torch.cuda.empty_cache()

    with _tiny_swin():
        trainer, data = make_trainer(p, seed=seed + 1, device=dev)
    batches = [to_device(data.batch(i, 1), dev) for i in range(2)]
    step = _train_run(f"{tag}_step", f"{title}, 1 image at "
                      f"{SW_IMG[0]}x{SW_IMG[1]}", trainer, batches,
                      expected_swin_tiny(True), 1)
    del trainer, data, batches
    torch.cuda.empty_cache()
    return {tag: counts, f"{tag}_step": step}


def widths_phase():
    """Every width a YAML gives JAX's models, through the kernels
    (``_width_configs``): InvPT-ViT-L PASCAL at embed_dim 600 (rows 3, 8
    and 9 zero-padded or ragged), eval at batch 8 and one step at batch 2;
    TaskPrompter-ViT-L PASCAL at tar = F = 768 (row 5's split form), eval
    at batch 8 and one step at batch 2; the MTT_DEBUG_TINY TaskPrompter-Swin
    on Cityscapes-3D (``debug_tiny``), one 1024x2048 frame with its 3D
    decode and one step at batch 1; InvPT-ViT-L PASCAL eval at
    batch 8 with ``factored_tail`` (the eval tail as torch products), held
    to f32 and to the kernel tail of the same weights. Returns the launch
    counts by path."""
    counts = {}
    work = tempfile.mkdtemp(prefix="mtt_widths_")
    try:
        cfg = _width_configs(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def loss_keys(p):
        inter = p.get("intermediate_supervision", False)
        return {*p.TASKS.NAMES, "total",
                *(f"inter_{t}" for t in p.TASKS.NAMES if inter)}

    for tag, title, want, want_step, seed in (
            ("invpt_w600", f"InvPT-ViT-L PASCAL at embed_dim 600 (decoder "
             f"width {W600_D}, head dims 332, 166, 83)",
             expected_invpt(False), expected_invpt_train(), 70),
            ("tp_w768", f"TaskPrompter-ViT-L PASCAL at tar = F = {W768} "
             f"(the task decode's split form)", expected_eval("factored"),
             expected_train(), 80)):
        p = cfg[tag]
        model, x = _serve_model(p, seed, (IMG, IMG))
        counts[tag] = _serve_check(tag, title, model, x, want)
        del model, x
        torch.cuda.empty_cache()
        trainer, batches = _limit_trainer(f"{tag}_step", p,
                                          range(seed + 1, seed + 9), BT)
        counts[f"{tag}_step"] = _train_run(
            f"{tag}_step", f"{title}, batch {BT} at {IMG}x{IMG}", trainer,
            batches, want_step, BT, loss_keys=loss_keys(p))
        del trainer, batches
        torch.cuda.empty_cache()

    counts.update(_swin_tiny_check(
        "swin_tiny", "the MTT_DEBUG_TINY TaskPrompter-Swin Cityscapes-3D "
        "(embed 16, 2 heads a stage, 4x4 windows)", cfg["swin_tiny"], 90))

    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.models.wrappers import INVPT_PASCAL_VITL
    model, x = _serve_model(INVPT_PASCAL_VITL, 100, (IMG, IMG),
                            factored_tail=True)
    counts["invpt_factored"] = _serve_check(
        "invpt_factored", "InvPT-ViT-L PASCAL with factored_tail", model, x,
        {**expected_invpt(False), "invpt_tail": 0})
    model.decoder.factored_tail = False
    with torch.no_grad():
        kern = predict(model, x)[0]
    model.decoder.factored_tail = True
    with torch.no_grad():
        fact = predict(model, x)[0]
    worst = max(((fact[t].float() - kern[t].float()).norm()
                 / kern[t].float().norm()).item() for t in model.tasks)
    print(f"[invpt_factored] the factored tail against the kernel tail on "
          f"the same weights: worst relative RMS over the tasks {worst:.5g} "
          f"(tol {FACTORED_TAIL_TOL})", flush=True)
    if not worst <= FACTORED_TAIL_TOL:
        raise RuntimeError(f"invpt_factored: {worst:.4g} from the kernel "
                           f"tail, over {FACTORED_TAIL_TOL}")
    del model, x, kern, fact
    torch.cuda.empty_cache()
    return counts


FORMAT_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "data", "images")
# the inference CLI's images in the formats phase: a JPEG, a PNG and one
# each of the other formats
FORMAT_CLI = ("jpeg_411_500x375.jpg", "adam7_rgb.png", "orient3_lzw.tif",
              "palette8.bmp", "rgb16.ppm")


def formats_phase():
    """Phase 22: the image files beyond baseline JPEG and plain PNG. Every
    fixture of ``tests/data/images`` in every ``read_image`` mode against
    ``pixels.json`` (PIL's and cv2's arrays, digested on a host that has
    them; a mode they refuse must raise ValueError); each fixture's decode
    ms on this host (``cv2_color``, the CLI's mode, the file read
    included, warm), beside phase 18's baseline 4:2:0 JPEG in the same
    loop; then the inference CLI (``inference.main``) once over
    ``FORMAT_CLI``: one TaskPrompter-ViT-L PASCAL model of seeded random
    weights, one eval forward an image. Returns the launch counts of the
    ``formats`` path, which must be one eval forward's a image."""
    import hashlib

    import numpy as np
    from mtt_tpu_torch import inference
    from mtt_tpu_torch.data import image_io
    from mtt_tpu_torch.evaluation.save_preds import read_png
    from mtt_tpu_torch.kernels import _build

    t_phase = time.perf_counter()
    with open(os.path.join(FORMAT_FIXTURES, "pixels.json")) as f:
        table = json.load(f)
    checked = refused = 0
    for name, entry in sorted(table.items()):
        path = os.path.join(FORMAT_FIXTURES, name)
        for mode in image_io.MODES:
            rec = entry["modes"][mode]
            if rec is None:
                try:
                    image_io.read_image(path, mode)
                except ValueError:
                    refused += 1
                    continue
                raise RuntimeError(f"formats: {name} in mode {mode} decodes,"
                                   f" where its reader refuses it")
            a = np.ascontiguousarray(image_io.read_image(path, mode))
            got = [list(a.shape), str(a.dtype),
                   hashlib.sha256(a.tobytes()).hexdigest()]
            if got != [rec["shape"], rec["dtype"], rec["sha256"]]:
                raise RuntimeError(f"formats: {name} in mode {mode}: "
                                   f"{got[:2]}, other pixels than "
                                   f"pixels.json's {rec['shape']} "
                                   f"{rec['dtype']}")
            checked += 1
    print(f"[formats] {len(table)} fixtures x {len(image_io.MODES)} modes: "
          f"{checked} arrays equal to pixels.json's (shape, dtype, SHA-256 "
          f"of PIL's or cv2's), {refused} refusals where the reader refuses",
          flush=True)

    base = os.path.join(FIXTURES, "baseline_420.jpg")
    decode_ms = {}
    for name in ["baseline_420.jpg (phase 18)", *sorted(table)]:
        path = base if name.startswith("baseline") else os.path.join(
            FORMAT_FIXTURES, name)
        image_io.read_image(path, "cv2_color")          # the build, warm
        decode_ms[name] = _wall_ms(
            lambda: image_io.read_image(path, "cv2_color"), 21)
    print(f"[formats] host decode ms (read_image cv2_color, file read "
          f"included, warm; median of 21): "
          f"{json.dumps({k: round(v, 4) for k, v in decode_ms.items()})}",
          flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    try:
        paths = [os.path.join(FORMAT_FIXTURES, n) for n in FORMAT_CLI]
        out = os.path.join(work, "out")
        torch.cuda.synchronize()
        _build.reset_counts()
        t = time.perf_counter()
        rc = inference.main(["--config_exp", LOOP_CONFIG, "--image_path",
                             *paths, "--output_dir", out, "--dtype",
                             "bfloat16"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        counts = dict(_build.COUNTS)
        want = {k: len(paths) * v
                for k, v in expected_eval("factored").items()}
        tasks = ("semseg", "human_parts", "sal", "normals", "edge")
        maps = {}
        for n in FORMAT_CLI:
            stem = os.path.splitext(n)[0]
            for task in tasks:
                a = read_png(os.path.join(out, stem, f"{task}.png"))
                if a.shape != (IMG, IMG, 3) or a.dtype != np.uint8:
                    raise RuntimeError(f"formats: {stem}/{task}.png is "
                                       f"{a.shape} {a.dtype}")
                maps[stem, task] = a
        # neighbouring images whose pixels differ must give maps that do
        stems = [os.path.splitext(n)[0] for n in FORMAT_CLI]
        pixels = [image_io.read_image(x, "cv2_color") for x in paths]
        pairs = [(a, b) for (a, pa), (b, pb) in zip(
            zip(stems, pixels), zip(stems[1:], pixels[1:]))
            if pa.shape != pb.shape or not np.array_equal(pa, pb)]
        differ = sum(any(not np.array_equal(maps[a, t], maps[b, t])
                         for t in tasks) for a, b in pairs)
        print(f"[formats] inference CLI, TaskPrompter-ViT-L PASCAL (seeded "
              f"random weights, one model) over {len(paths)} images "
              f"{list(FORMAT_CLI)}: rc {rc}, {cli_s:.1f} s (model build "
              f"included); {len(maps)} maps of {IMG}x{IMG}x3; neighbouring "
              f"images of other pixels give other maps in {differ} of "
              f"{len(pairs)} pairs; "
              f"launches {counts} (want {len(paths)} x one eval forward's)",
              flush=True)
        if rc != 0 or counts != want or differ != len(pairs) or \
                len(pairs) != len(paths) - 1:
            raise RuntimeError(f"formats: the CLI returned {rc}, launches "
                               f"{counts} (want {want}), {differ} differing "
                               f"neighbours")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[formats] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"formats": counts}


# Phase 23: float32, JAX's default dtype. Each f32 form against its plain
# version at f32 (relative RMS): both compute in f32 throughout and differ
# only in the order of their f32 sums, about 1e-6 (a bf16 shortcut would read
# about 1e-2). The f32 kernel forward against the plain f32 forward of the
# same weights, per map: 24 blocks of random weights carry the sums' order a
# little further.
F32_KERNEL_TOL = 1e-5
F32_FORWARD_TOL = 1e-4
F32_CLI = ("jpeg_411_500x375.jpg", "adam7_rgb.png")
# the kernels line's f32 rows: name -> the bf16 entry point whose count the
# f32 eval forward must match, row by row
F32_ROWS = {"layernorm_f32": "layernorm",
            "attention_cached_f32": "attention_cached",
            "attention_emit_f32": "attention_emit",
            "mlp_ln_res_f32": "mlp_ln_res", "task_decode_f32": "task_decode",
            "head_up4_f32": "head_up4", "attention_qkv_f32": "attention_qkv",
            "attention_generic_f32": "attention_generic"}


def expected_f32(bf16_counts: dict) -> dict:
    """The launch counts of a forward at f32: each f32 form's counter takes
    the bf16 forward's count of its entry point; every other counter 0."""
    rows = {v: k for k, v in F32_ROWS.items()}
    return _expected(**{rows[k]: v for k, v in bf16_counts.items()
                        if v and k in rows})


def _rel_err(got, want) -> float:
    return ((got.double() - want.double()).norm()
            / want.double().norm()).item()


def _f32_cases(rnd):
    """(name: (call(impl), ragged call(impl), library call or None, library
    composition or None, bytes, 3xTF32 flops, f32 flops)) of the f32 forms
    at the main path's shapes, each with one ragged shape: the products of
    the f32 GEMM and the f32 attention core run as three TF32 products on
    the tensor cores, the LayerNorm, the task decode and the up4 mix in f32
    on the CUDA cores."""
    from mtt_tpu_torch.kernels.attention import (fused_attention,
                                                 fused_attention_ln_qkv,
                                                 fused_attention_qkv)
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode

    f32 = torch.float32
    M = B * N

    def r(*shape, std=1.0, mean=0.0):
        return rnd(*shape, std=std, mean=mean, dtype=f32)

    def ln_args(rows, c):
        return r(*rows, c), r(c, std=0.1, mean=1.0), r(c, std=0.1)

    def front(rows, c):
        x, g, b = ln_args(rows, c)
        return x, g, b, r(3 * c, c, std=c ** -0.5), r(3 * c, std=0.1)

    def mlp(rows, c, hd):
        x, g, b = ln_args(rows, c)
        return (x, g, b, r(hd, c, std=c ** -0.5), r(hd, std=0.1),
                r(c, hd, std=hd ** -0.5), r(c, std=0.1))

    def decode(b_, s_, c_, t_, g_, tar, fin):
        return (r(b_, s_, c_), r(b_, t_, s_, g_), r(b_, t_, c_),
                r(t_, tar, c_, std=c_ ** -0.5), r(t_, tar, std=0.1),
                r(t_, tar, c_, std=c_ ** -0.5), r(t_, tar, std=0.1),
                r(t_, fin, 2 * tar, std=(2 * tar) ** -0.5),
                r(t_, fin, std=0.1))

    def head(b_, gh, gw, c_, n):
        return (r(b_, gh, gw, c_, std=0.5), r(3, 3, c_, c_,
                                              std=(9 * c_) ** -0.5),
                r(c_, std=0.1, mean=1.0), r(c_, std=0.1),
                r(c_, n, std=c_ ** -0.5))

    ln, ln_r = ln_args((B, N), C), ln_args((5, 77), 830)
    fa, fa_r = front((B, N), C), front((2, 77), 256)
    ml, ml_r = mlp((B, N), C, HIDDEN), mlp((129,), 166, 664)
    dc = decode(B, S, C, T, G, TAR, FIN)
    dc_r = decode(2, 77, 768, T, 12, TAR, FIN)
    hd, hd_r = head(B, GRID, GRID, FIN, NLOG), head(2, NYUD_GH, NYUD_GW,
                                                   NYUD_C, NYUD_NLOG)
    qkv, qkv_r = r(B, N, 3 * C, std=1.5), r(2, 65, 4 * 3 * 72, std=1.5)
    qg = [r(B, N, HEADS, D, std=2.0 if i == 0 else 1.0) for i in range(3)]
    qg_r = [r(2, 300, 2, 72, std=2.0), r(2, 33, 2, 72), r(2, 33, 2, 72)]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ).transpose(1, 2)

    def front_lib(x, g, b, w, bq):
        def lib():
            q, k, v = F.linear(F.layer_norm(x, (C,), g, b, 1e-6), w, bq) \
                .view(B, N, HEADS, 3, D).unbind(3)
            return sdpa(q, k, v).reshape(B, N, C)
        return lib

    def decode_lib(x, a, cw, ws, bs, wc, bc, wf, bfin):
        def lib():
            xt = x[:, None]
            f = torch.einsum("btsc,trc->btsr", xt * a.repeat_interleave(
                C // G, -1) + xt, ws) + bs[None, :, None]
            fc = torch.einsum("btsc,trc->btsr", xt * cw[:, :, None] + xt,
                              wc) + bc[None, :, None]
            return torch.einsum("btsr,tfr->btsf", torch.cat([f, fc], -1),
                                wf) + bfin[None, :, None]
        return lib

    def head_lib(x, kc, inv, addv, kp):
        kc_oihw = kc.permute(3, 2, 0, 1).contiguous()
        kp_oihw = kp.t()[:, :, None, None].contiguous()

        def lib():
            up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=4,
                               mode="bilinear", align_corners=False)
            y = F.gelu(F.conv2d(up, kc_oihw, padding=1)
                       * inv[:, None, None] + addv[:, None, None])
            return F.conv2d(y, kp_oihw)
        return lib

    attn_flops = 4.0 * B * HEADS * N * N * D
    px = B * 16 * GRID * GRID
    b_ = _nbytes
    return {
        "layernorm_f32": (
            lambda impl, a=ln: fused_layernorm(*a, impl=impl),
            lambda impl, a=ln_r: fused_layernorm(*a, impl=impl),
            lambda: F.layer_norm(ln[0], (C,), ln[1], ln[2], 1e-6), None,
            b_(*ln, ln[0]), 0.0, 8.0 * M * C),
        "attention_cached_f32": (
            lambda impl, a=fa: fused_attention_ln_qkv(*a, HEADS, impl=impl),
            lambda impl, a=fa_r: fused_attention_ln_qkv(*a, 4, impl=impl),
            None, front_lib(*fa), b_(*fa, fa[0]),
            2.0 * M * C * 3 * C + attn_flops, 8.0 * M * C),
        "attention_cached_f32@safe": (
            lambda impl, a=fa: fused_attention_ln_qkv(*a, HEADS, impl=impl,
                                                      safe=True),
            lambda impl, a=fa_r: fused_attention_ln_qkv(*a, 4, impl=impl,
                                                        safe=True),
            None, front_lib(*fa), b_(*fa, fa[0]),
            2.0 * M * C * 3 * C + attn_flops, 8.0 * M * C),
        "attention_emit_f32": (
            lambda impl, a=fa: fused_attention_ln_qkv(*a, HEADS,
                                                      need_qkv=True,
                                                      impl=impl),
            lambda impl, a=fa_r: fused_attention_ln_qkv(*a, 4, need_qkv=True,
                                                        impl=impl),
            None, front_lib(*fa), b_(*fa, fa[0], fa[0]) + M * 3 * C * 4,
            2.0 * M * C * 3 * C + attn_flops, 8.0 * M * C),
        "mlp_ln_res_f32": (
            lambda impl, a=ml: fused_mlp_ln_res(*a, impl=impl),
            lambda impl, a=ml_r: fused_mlp_ln_res(*a, impl=impl),
            None, lambda a=ml: a[0] + F.linear(F.gelu(F.linear(F.layer_norm(
                a[0], (C,), a[1], a[2], 1e-6), a[3], a[4])), a[5], a[6]),
            b_(*ml, ml[0]), 4.0 * M * C * HIDDEN, 8.0 * M * C),
        "task_decode_f32": (
            lambda impl, a=dc: fused_task_decode(*a, impl=impl),
            lambda impl, a=dc_r: fused_task_decode(*a, impl=impl),
            None, decode_lib(*dc), b_(*dc) + B * S * T * FIN * 4, 0.0,
            2.0 * B * T * S * (2 * C * TAR + 2 * TAR * FIN)),
        "head_up4_f32": (
            lambda impl, a=hd: fused_up4_head(*a, impl=impl),
            lambda impl, a=hd_r: fused_up4_head(*a, impl=impl),
            None, head_lib(*hd), b_(*hd) + px * NLOG * 4,
            # Gm (9 taps) on the f32 GEMM; the width and height mixes (6
            # nonzero taps each), the affine and GELU (~25 flops), the 1x1
            2.0 * B * GRID * GRID * FIN * 9 * FIN,
            12.0 * B * GRID * 3 * FIN * 4 * GRID
            + (12.0 + 25.0) * px * FIN + 2.0 * px * FIN * NLOG),
        "attention_qkv_f32": (
            lambda impl, a=qkv: fused_attention_qkv(a, HEADS, impl=impl),
            lambda impl, a=qkv_r: fused_attention_qkv(a, 4, impl=impl),
            lambda: sdpa(*qkv.view(B, N, HEADS, 3, D).unbind(3)), None,
            b_(qkv) + M * C * 4, attn_flops, 0.0),
        "attention_qkv_f32@safe": (
            lambda impl, a=qkv: fused_attention_qkv(a, HEADS, impl=impl,
                                                    safe=True),
            lambda impl, a=qkv_r: fused_attention_qkv(a, 4, impl=impl,
                                                      safe=True),
            lambda: sdpa(*qkv.view(B, N, HEADS, 3, D).unbind(3)), None,
            b_(qkv) + M * C * 4, attn_flops, 0.0),
        "attention_generic_f32": (
            lambda impl, a=qg: fused_attention(*a, impl=impl),
            lambda impl, a=qg_r: fused_attention(*a, impl=impl),
            lambda: sdpa(*qg), None, b_(*qg, qg[0]), attn_flops, 0.0),
    }


def _f32_forward(tag: str, title: str, p: dict, seed: int, size,
                 batch: int, want_bf16: dict, timed: bool = False):
    """One TaskPrompter-ViT eval forward at f32 through the kernels against
    the plain f32 forward of the same weights, map by map; the bf16 kernel
    forward of the same weights beside it (its launches ``want_bf16``, its
    distance from the plain f32 forward printed). Returns the f32 forward's
    launch counts and, when ``timed``, the device ms of the f32 and bf16
    forwards."""
    from mtt_tpu_torch.inference import predict, preprocess
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(p, img_size=size, device=dev,
                        dtype=torch.float32).eval()
    init_weights(model, gen)
    x = preprocess(torch.randint(0, 256, (batch, *size, 3), generator=gen,
                                 device=dev))
    torch.cuda.synchronize()
    _build.reset_counts()
    logits, preds = predict(model, x)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    want = expected_f32(want_bf16)
    if counts != want:
        raise RuntimeError(f"{tag}: f32 launch counts {counts} != {want}")
    ref, _ = predict(model, x, impl="plain")
    bmodel = copy.deepcopy(model).to(torch.bfloat16)
    _build.reset_counts()
    blogits, _ = predict(bmodel, x.to(torch.bfloat16))
    torch.cuda.synchronize()
    bcounts = dict(_build.COUNTS)
    if bcounts != want_bf16:
        raise RuntimeError(f"{tag}: bf16 launch counts {bcounts} != "
                           f"{want_bf16}")
    rows = {k: (counts[k], bcounts[v]) for k, v in F32_ROWS.items()}
    if any(a != b for a, b in rows.values()):
        raise RuntimeError(f"{tag}: f32 counters {rows} differ from the "
                           f"bf16 forward's, row by row")
    errs = {}
    for t in model.tasks:
        k, r = logits[t], ref[t]
        if k.dtype != torch.float32 or not torch.isfinite(k).all() or \
                k.shape != r.shape or preds[t].shape[:3] != (batch, *size):
            raise RuntimeError(f"{tag} {t}: logits {k.dtype} "
                               f"{tuple(k.shape)} or non-finite")
        errs[t] = (_rel_err(k, r), _rel_err(blogits[t].float(), r))
    shown = {t: [float(f"{e:.4g}") for e in pair]
             for t, pair in errs.items()}
    print(f"[f32] {tag}: {title}, batch {batch} at {size[0]}x{size[1]}, f32 "
          f"through the kernels; launches {counts} (each f32 counter equal "
          f"to the bf16 forward's: {rows}); per map, relative RMS error "
          f"against the plain f32 forward of the same weights, [f32 kernels "
          f"(tol {F32_FORWARD_TOL}), the bf16 kernel forward]: {shown}",
          flush=True)
    bad = [t for t, (e, _) in errs.items() if not e <= F32_FORWARD_TOL]
    if bad:
        raise RuntimeError(f"{tag}: maps {bad} of the f32 kernel forward "
                           f"over {F32_FORWARD_TOL} from the plain f32 one")
    ms = None
    if timed:
        with torch.no_grad():
            ms = (_time_ms(lambda: model(x), reps=5, warmup=1),
                  _time_ms(lambda: bmodel(x.to(torch.bfloat16)), reps=5,
                           warmup=1))
        print(f"[f32] {tag}: forward device ms (CUDA events, median of 5): "
              f"f32 {ms[0]:.3f}, bf16 {ms[1]:.3f} ({ms[0] / ms[1]:.2f}x)",
              flush=True)
    del model, bmodel, logits, ref, blogits
    torch.cuda.empty_cache()
    return counts, ms


def f32_phase():
    """Phase 23: float32 on the card, JAX's default dtype. Each f32 form
    (rows 1-6, 13 and 14) against its plain version at f32 at the main
    path's shapes and one ragged shape (relative RMS, F32_KERNEL_TOL),
    with its time, the plain version's, the library call's or
    composition's at f32 and its bound (bytes at 3.35 TB/s or operations:
    the 3xTF32 products three times at 495 TFLOP/s, the rest at 67; every
    f32 flop at 67 beside it); the TaskPrompter-ViT-L PASCAL eval forward at
    batch 8 and 512x512 in f32 through the kernels against the plain f32
    forward, map by
    map (F32_FORWARD_TOL), its launches row by row those of the bf16
    forward, the two forwards' device ms; ViT-B PASCAL and NYUD ViT-L at
    batch 2 the same way; the module API of rows 13 and 14 at f32; the
    inference CLI at its f32 default over a JPEG and a PNG; ``main
    --run_mode infer --dtype float32`` over one val batch. TF32 is off for
    the phase (the CLI and main turn it off themselves and put it back).
    Returns the results of the f32 rows and the launch counts by path."""
    import numpy as np
    from mtt_tpu_torch import inference
    from mtt_tpu_torch import main as port_main
    from mtt_tpu_torch.evaluation.save_preds import read_png
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import (Attention,
                                             dot_product_attention,
                                             init_weights)
    from mtt_tpu_torch.models.wrappers import (NYUD_TASKPROMPTER_VITL,
                                               PASCAL_TASKPROMPTER_VITB)
    from mtt_tpu_torch.train import PASCAL_VITL
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils.precision import exact_f32

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)

    def rnd(*shape, std=1.0, mean=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                + mean).to(dtype)

    results, paths = {}, {}
    with exact_f32():
        for name, (call, ragged, lib, comp, nbytes, tf32x3, flops) in \
                _f32_cases(rnd).items():
            errs = []
            for c in (call, ragged):
                got, want = c("cuda"), c("plain")
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                torch.cuda.synchronize()
                for g_, w_ in zip(got, want):
                    if g_.shape != w_.shape or g_.dtype != torch.float32 or \
                            w_.dtype != torch.float32 or \
                            not torch.isfinite(g_).all():
                        raise RuntimeError(f"{name}: bad f32 output "
                                           f"{tuple(g_.shape)} {g_.dtype}")
                    errs.append((_rel_err(g_, w_), _max_err(g_, w_)))
                del got, want
            rel = max(e for e, _ in errs)
            if not rel <= F32_KERNEL_TOL:
                raise RuntimeError(f"{name}: relative RMS {rel:.3g} from its "
                                   f"plain version, over {F32_KERNEL_TOL}")
            kms = _time_ms(lambda: call("cuda"))
            pms = _time_ms(lambda: call("plain"), reps=3, warmup=1)
            lms = _time_ms(lib) if lib else None
            cms = _time_ms(comp) if comp else None
            # the 3xTF32 bound; beside it every f32 flop on the CUDA cores
            # (the FFMA forms' bound before this slice), never below it
            bms, bby = _bound(nbytes, 0.0, flops, tf32x3)
            fms, _ = _bound(nbytes, 0.0, flops + tf32x3)
            results[name] = dict(
                max_abs_err=errs[0][1], rel_rms=errs[0][0],
                ragged_rel_rms=max(e for e, _ in errs[1:]),
                tol=F32_KERNEL_TOL, kernel_ms=kms, plain_ms=pms,
                library_ms=lms, library_composition_ms=cms, bound_ms=bms,
                bound_by=bby, ffma_bound_ms=fms)
            print(f"[f32] {name}: relative RMS against the plain f32 version "
                  f"{errs[0][0]:.3g} (ragged {results[name]['ragged_rel_rms']:.3g}; "
                  f"tol {F32_KERNEL_TOL}), max_abs_err {errs[0][1]:.3g}; "
                  f"kernel_ms={kms:.4f} plain_ms={pms:.4f} library_ms={lms} "
                  f"library_composition_ms={cms} bound_ms={bms:.4f} ({bby}, "
                  f"3xTF32 flops at {PEAK_TF32 / 1e12:.0f} TFLOP/s, the rest "
                  f"at {PEAK_F32 / 1e12:.0f}) ffma_bound_ms={fms:.4f} (every "
                  f"f32 flop at {PEAK_F32 / 1e12:.0f})", flush=True)
        print(f"[f32] kernels {time.perf_counter() - t_phase:.1f} s",
              flush=True)

        paths["f32"], ms = _f32_forward(
            "vitl", "TaskPrompter-ViT-L PASCAL (5 tasks, CTR, factored up4 "
            "head)", PASCAL_VITL, 1, (IMG, IMG), B, expected_eval("factored"),
            timed=True)
        results["forward_ms"] = ms
        paths["f32_vitb"], _ = _f32_forward(
            "vitb", "TaskPrompter-ViT-B PASCAL", PASCAL_TASKPROMPTER_VITB, 7,
            (IMG, IMG), 2, expected_vitb())
        paths["f32_nyud"], _ = _f32_forward(
            "nyud", "TaskPrompter-ViT-L NYUD-v2 (16 channel windows, no task "
            "decode launch)", NYUD_TASKPROMPTER_VITL, 5, NYUD_IMG, 2,
            expected_nyud_taskprompter())

        # the module API of rows 13 and 14 at f32
        attn = Attention(C, HEADS, device=dev, dtype=torch.float32)
        init_weights(attn, gen)
        xa = rnd(2, N, C)
        _build.reset_counts()
        with torch.no_grad():
            out = attn(xa)
            q, k, v = attn.qkv(xa).view(2, N, HEADS, 3, D).unbind(3)
            o_dpa = dot_product_attention(q, k, v)
        torch.cuda.synchronize()
        paths["f32_api"] = dict(_build.COUNTS)
        want = _expected(attention_qkv_f32=1, attention_generic_f32=1)
        with torch.no_grad():
            e_api = (_rel_err(out, attn(xa, impl="plain")),
                     _rel_err(o_dpa, dot_product_attention(q, k, v,
                                                           impl="plain")))
        print(f"[f32] api: ViT-L Attention without LN and "
              f"dot_product_attention at f32, batch 2: launches "
              f"{paths['f32_api']}; relative RMS against the plain versions "
              f"{e_api[0]:.3g} / {e_api[1]:.3g}", flush=True)
        if paths["f32_api"] != want or max(e_api) > F32_FORWARD_TOL:
            raise RuntimeError(f"f32 api: launches {paths['f32_api']} (want "
                               f"{want}) or errors {e_api}")
        del attn, xa, out, q, k, v, o_dpa

    # the CLI at its default (f32) and main in infer mode at f32, each of
    # which sets TF32 itself and puts the flags back
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    work = tempfile.mkdtemp(prefix="chip_smoke_f32_")
    real_get_dataset = cc.get_dataset
    try:
        if inference.parse_args(["--config_exp", "x", "--image_path",
                                 "y"]).dtype != "float32":
            raise RuntimeError("f32: the inference CLI's default is not "
                               "float32")
        paths_in = [os.path.join(FORMAT_FIXTURES, n) for n in F32_CLI]
        out = os.path.join(work, "out")
        _build.reset_counts()
        t = time.perf_counter()
        rc = inference.main(["--config_exp", LOOP_CONFIG, "--image_path",
                             *paths_in, "--output_dir", out])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        paths["f32_cli"] = dict(_build.COUNTS)
        want = {k: len(paths_in) * v for k, v in
                expected_f32(expected_eval("factored")).items()}
        maps = {(n, task): read_png(os.path.join(
                    out, os.path.splitext(n)[0], f"{task}.png"))
                for n in F32_CLI for task in ("semseg", "human_parts", "sal",
                                              "normals", "edge")}
        ok_maps = all(a.shape == (IMG, IMG, 3) and a.dtype == np.uint8
                      for a in maps.values())
        print(f"[f32] inference CLI (no --dtype: float32), TaskPrompter-ViT-L "
              f"PASCAL over {list(F32_CLI)}: rc {rc}, {cli_s:.1f} s (model "
              f"build included), {len(maps)} maps of {IMG}x{IMG}x3; launches "
              f"{paths['f32_cli']}", flush=True)
        if rc != 0 or paths["f32_cli"] != want or not ok_maps:
            raise RuntimeError(f"f32: the CLI returned {rc}, launches "
                               f"{paths['f32_cli']} (want {want})")

        def one_batch(p, split, transforms=None, overfit=False):
            ds = real_get_dataset(p, split, transforms, overfit)
            if split != "train":
                ds.length = int(p["valBatch"])
            return ds
        cc.get_dataset = one_batch
        cwd = os.getcwd()
        os.chdir(work)
        try:
            _build.reset_counts()
            t = time.perf_counter()
            rc = port_main.main(["--config_exp", LOOP_CONFIG, "--run_mode",
                                 "infer", "--dtype", "float32"])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t
        finally:
            os.chdir(cwd)
        paths["f32_main"] = dict(_build.COUNTS)
        want = expected_f32(expected_eval("factored"))
        print(f"[f32] main --run_mode infer --dtype float32, one val batch "
              f"of 6 (synthetic): rc {rc}, {main_s:.1f} s; launches "
              f"{paths['f32_main']}", flush=True)
        if rc != 0 or paths["f32_main"] != want:
            raise RuntimeError(f"f32: main infer returned {rc}, launches "
                               f"{paths['f32_main']} (want {want})")
    finally:
        cc.get_dataset = real_get_dataset
        shutil.rmtree(work, ignore_errors=True)
    if (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) != flags:
        raise RuntimeError("f32: the CLI or main left the TF32 flags changed")
    print(f"[f32] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"results": results, "paths": paths}


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
                  # the f32 forms (phase 23): the f32 GEMM by its epilogue,
                  # the f32 core, decode and up4 mix
                  ("gemm_f32_kernel<0>", "f32 GEMM + GELU (fc1, row 4)"),
                  ("gemm_f32_kernel<1>", "f32 GEMM + bias + residual (fc2, "
                                         "row 4)"),
                  ("gemm_f32_kernel<2>", "f32 GEMM + bias (qkv of rows 1-2)"),
                  ("gemm_f32_kernel<3>", "f32 up4 head"),
                  ("attn_f32_kernel", "f32 attention core"),
                  ("task_decode_f32", "f32 task decode"),
                  ("head_up4_mix_kernel<float", "f32 up4 head"),
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
    model (the eval phases' models and batches) and of one training step of
    each training path (the training phases' trainers and first batches), for
    the phases in ``wanted``."""
    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.train import make_trainer
    from mtt_tpu_torch.utils.train_utils import to_device
    if "eval" in wanted:
        model, x = _eval_model()
        _profile(f"eval forward, batch {B}", lambda: predict(model, x))
        del model, x
    if "f32" in wanted:
        from mtt_tpu_torch.utils.precision import exact_f32
        model, x = _eval_model()
        model.float()
        with exact_f32():
            _profile(f"eval forward at f32, batch {B}",
                     lambda: predict(model, x))
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
        del trainer, data, batch
    if "options" in wanted:
        from mtt_tpu_torch.train import (CS3D_SWINB_TRAIN,
                                         INVPT_PASCAL_VITL_TRAIN)
        for title, p, seed, bs in (
                ("InvPT-ViT-L PASCAL", INVPT_PASCAL_VITL_TRAIN, 16, BT),
                ("Swin-B Cityscapes-3D", CS3D_SWINB_TRAIN, 6, 1)):
            for remat in (False, True):
                trainer, data = make_trainer(dict(p, remat=remat), seed=seed,
                                             device=torch.device("cuda"))
                batch = to_device(data.batch(0, bs), torch.device("cuda"))
                _profile(f"{title} training step, batch {bs}, remat "
                         f"{'on' if remat else 'off'}",
                         lambda: trainer.step(batch), top=8)
                del trainer, data, batch
                torch.cuda.empty_cache()
    for tag, title, p, seed, *_ in _train_paths():
        phase = "invpt_train" if tag.startswith("invpt_train") else tag
        if phase not in wanted:
            continue
        trainer, data = make_trainer(p, seed=seed,
                                     device=torch.device("cuda"))
        batch = to_device(data.batch(0, BT), torch.device("cuda"))
        _profile(f"{title} training step", lambda: trainer.step(batch),
                 top=16)
        del trainer, data, batch
        torch.cuda.empty_cache()


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
          "swin_train": swin_train_phase, "invpt_train": invpt_train_phase,
          "nyud_train": nyud_train_phase, "evaluate": evaluate_phase,
          "loop": loop_phase, "detect": detect_phase,
          "convert": convert_phase, "parallel": parallel_phase,
          "datasets": datasets_phase, "options": options_phase,
          "limits": limits_phase, "widths": widths_phase,
          "formats": formats_phase, "f32": f32_phase}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="only print the device-time breakdown of one eval "
                         "forward and one training step (torch.profiler)")
    ap.add_argument("--grad-diag", action="store_true",
                    help="only print how far the Swin-B training step's "
                         "bf16 gradients sit from the f32 step's, run free "
                         "(see grad_diag)")
    ap.add_argument("--convert-vary", type=float, default=CONVERT_VARY,
                    help="the convert phase's seeded variation of biases, "
                         "norms and BN statistics (see _vary)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES)
                         + "; a subset prints no result lines")
    ap.add_argument("--dp-rank", metavar="DIR", help=argparse.SUPPRESS)
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
    if args.dp_rank:
        dp_rank(args.dp_rank)        # one rank of the parallel phase
        return 0
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
    runs = {**PHASES, "convert": functools.partial(convert_phase,
                                                   args.convert_vary)}
    for name, run in runs.items():
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
    results = {**outcome["kernels"], **outcome["f32"]["results"]}
    eval_counts = outcome["eval"]
    invpt_counts, train_counts = outcome["invpt"], outcome["train"]
    swin_counts, swin_train_counts = outcome["swin"], outcome["swin_train"]
    api_counts, serve_counts = outcome["attention_api"], outcome["nyud"]
    path_counts = {**outcome["invpt_train"],
                   "nyud_train": outcome["nyud_train"],
                   "evaluate": outcome["evaluate"], "loop": outcome["loop"],
                   **outcome["detect"], **outcome["convert"],
                   **outcome["parallel"], **outcome["datasets"],
                   **{f"options_{k}": c
                      for k, c in outcome["options"].items()},
                   **outcome["limits"], **outcome["widths"],
                   **outcome["formats"], **outcome["f32"]["paths"]}

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
                   **{tag: c[counter] for tag, c in serve_counts.items()},
                   **{tag: c[counter] for tag, c in path_counts.items()}}
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=by_path[{"eval": "eval_factored", "train": "train_step",
                              "invpt": "invpt_tail",
                              "invpt_head": "invpt_tail_head",
                              "swin": "swin", "swin_train": "swin_train",
                              "attention_api": "attention_api",
                              "f32": "f32", "f32_api": "f32_api"}[path]],
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
