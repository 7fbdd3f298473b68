"""Time the port's attention kernels of two checkouts in turns on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    git archive <parent> mtt_tpu_torch | tar -x -C build/parent
    python3 tools/torch_attention_ab.py --parent build/parent
    python3 tools/torch_attention_ab.py --parent build/parent --rows invpt
    python3 tools/torch_attention_ab.py --parent build/parent --rows f32

Both checkouts' ``mtt_tpu_torch/csrc`` are built (each into its own
``build/`` directory). Each run loads one of the two libraries, in a process
of its own, and calls its exported functions on the same seeded inputs at
the shapes ``chip_smoke.py`` times: row 14 (``mtt_attn_generic_bf16``) at
(8, 1029, 16, 64) and at InvPT's cross shape (q (8, 5120, 2, 72), k/v (8,
320, 2, 72)), row 7 (``mtt_attn_bwd_bf16``) at qkv (2, 1029, 3072), row 13
and rows 1-2's core (``mtt_attn_core_bf16``, fast and safe softmax) at qkv
(8, 1029, 3072), and rows 11 and 12 (``mtt_window_attention_bf16``,
``mtt_window_attention_bwd_bf16``) at Swin-B's stage 2 (32 windows of 147
tokens, 16 heads, with the shift mask) and stage 0 (512 windows, 4 heads)
with and without the mask, and row 9 (``mtt_invpt_attention_bf16``) at the
six launches of the InvPT-ViT-L forwards at batch 8 (PASCAL and NYUD stages
0-2, on the model's strided head views; the parent's host pads are made once
outside its timing; ``--rows invpt`` runs row 9 alone). Each time is the
median of CUDA-event times of ``--reps`` calls (row 9: of 20 back-to-back
calls, over 20, beside the library composition of ``chip_smoke.py``
timed the same way); the runs go parent, change, change, parent, and SDPA
(forward and backward; for rows 11 and 12 with the bias and mask merged into
one float mask, row 12's backward with that mask requiring grad, plus its
gradient summed over the windows) is timed in each run beside the kernels.
Outputs are held to the plain versions at 4 bf16 ulps of the largest value
(row 11 at 2, row 12's dbias to 1e-4 of its largest value, row 9's fused to
0.01 ulps, its bit-equal share of out to at least the parent's), the safe
softmax of row 13 to at least 99% of its outputs bit-equal to the plain
version (rows 11's shares printed), and each kernel runs twice to show
equal bits. It prints the card's
name and power limit, each kernel's ptxas registers and spills, and one JSON
line of the times; it fails when the change's kernels miss a tolerance or
differ between two runs. The f32 rows (``f32_cases``; ``--rows f32`` alone):
rows 14, 13 and 1-2's core at f32 (``mtt_attn_generic_f32``,
``mtt_attn_core_f32``) beside SDPA at f32 with TF32 off, held to the exact f32
plain versions at 1e-5 relative RMS.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def load_module(checkout: Path, name: str, tag: str):
    """A module of a checkout's ``mtt_tpu_torch/kernels``, loaded under its
    own name so two copies live side by side."""
    path = checkout / "mtt_tpu_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_build(checkout: Path, tag: str):
    """The ``_build`` module of a checkout; its library is built at first
    use."""
    mod = load_module(checkout, "_build", tag)
    mod.lib()
    return mod


def window_chunks(checkout: Path, tag: str, BW: int, H: int) -> int:
    """The checkout's own windows per row-12 block (``bwd_window_chunks``,
    which takes the card's SM count since this slice)."""
    fn = load_module(checkout, "window_attention", tag).bwd_window_chunks
    if len(inspect.signature(fn).parameters) == 3:
        return fn(BW, H, torch.cuda.get_device_properties(0)
                  .multi_processor_count)
    return fn(BW, H)


def ptxas_lines(build, names):
    log = build.build_log or (build.BUILD_ROOT / build.source_hash()
                              / "build.log").read_text()
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and any(n in kernel for n in names) and (
                "registers" in line or "spill" in line):
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return out


def time_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_b2b(fn, reps: int, n: int = 20) -> float:
    """Median over ``reps`` of CUDA-event time of ``n`` back-to-back calls,
    divided by ``n``."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


# row 9 at the six launches of the InvPT-ViT-L forwards at batch 8: PASCAL
# and NYUD stages 0-2, (Lq, Lk, head dim, with a message)
INVPT_SHAPES = {
    "invpt_attention@pascal0": (320, 320, 288, False),
    "invpt_attention@pascal1": (1280, 320, 144, True),
    "invpt_attention@pascal2": (5120, 320, 72, True),
    "invpt_attention@nyud0": (252, 252, 288, False),
    "invpt_attention@nyud1": (1008, 252, 144, True),
    "invpt_attention@nyud2": (4032, 252, 72, True)}


def invpt_cases(checkout: Path, bld, gen, stream) -> dict:
    """Row 9's cases on the model's strided (B, L, H, D) head views: the
    checkout's raw launch (the parent's on its host-padded q, k and a
    transposed v, made once outside the timing), the plain version, the
    library composition of ``chip_smoke.py: _invpt_cases`` and this tree's
    wrapper."""
    from mtt_tpu_torch.kernels.invpt_attention import (invpt_attention_cuda,
                                                       invpt_attention_plain)
    bf, dev = torch.bfloat16, torch.device("cuda")
    lib = bld.lib()
    strided = len(bld._SIGNATURES["mtt_invpt_attention_bf16"]) > 15
    # the entry that takes the streamed form's p scratch (null: resident)
    scratch = (None,) * (len(bld._SIGNATURES["mtt_invpt_attention_bf16"])
                         > 28)
    cases = {}
    for name, (lq, lk, d, with_msg) in INVPT_SHAPES.items():
        # the inputs of tests/test_torch_cuda.py::test_invpt_attention_kernel
        # at the same shape (a fresh seed 0, the same draws)
        gen.manual_seed(0)
        B, H = 8, 2
        q, k, v = (torch.randn(B, L, H, d, generator=gen, device=dev).to(bf)
                   .transpose(1, 2) for L in (lq, lk, lk))
        msg = w = b = None
        if with_msg:
            msg = torch.randn(B, H, lq, lk, generator=gen, device=dev)
            w = torch.randn(H, 2 * H, generator=gen, device=dev) * 0.5
            b = torch.randn(H, generator=gen, device=dev) * 0.1
        scale = (H * d) ** -0.5
        ptrs = [t.data_ptr() if t is not None else None for t in (msg, w, b)]
        fused = torch.empty(B, H, lq, lk, device=dev)
        if strided:
            out = torch.empty(B, lq, H, d, dtype=bf, device=dev).transpose(
                1, 2)
            sargs = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3])

            def call(a=(q, k, v, out, fused, ptrs, sargs, lq, lk, d),
                     plan=None):
                q_, k_, v_, o_, f_, p_, s_, lq_, lk_, d_ = a
                bld.check(lib.mtt_invpt_attention_bf16(
                    q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), *p_,
                    o_.data_ptr(), f_.data_ptr(), *scratch, B, lq_, lk_,
                    lk_, d_, *s_,
                    plan, (H * d_) ** -0.5, stream()),
                    "mtt_invpt_attention_bf16")
                return o_, f_
        else:
            dp, lkp = -(-d // 16) * 16, -(-lk // 16) * 16
            qp = F.pad(q, (0, dp - d)).contiguous()
            kp = F.pad(k, (0, dp - d, 0, lkp - lk)).contiguous()
            vp = F.pad(v, (0, dp - d, 0, lkp - lk)).transpose(-1, -2) \
                .contiguous()
            out = torch.empty(B, H, lq, dp, dtype=bf, device=dev)

            def call(a=(qp, kp, vp, out, fused, ptrs, lq, lk, lkp, d, dp)):
                q_, k_, v_, o_, f_, p_, lq_, lk_, lkp_, d_, dp_ = a
                bld.check(lib.mtt_invpt_attention_bf16(
                    q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), *p_,
                    o_.data_ptr(), f_.data_ptr(), B, lq_, lk_, lkp_, dp_,
                    (H * d_) ** -0.5, stream()), "mtt_invpt_attention_bf16")
                return o_[..., :d_], f_

        def comp(a=(q, k, v, msg, w, b, scale)):
            q_, k_, v_, m_, w_, b_, sc = a
            fu = torch.matmul(q_, k_.transpose(-1, -2)).float() * sc
            if m_ is not None:
                fu = torch.einsum("hc,bcqk->bhqk", w_, torch.cat([fu, m_], 1)
                                  ) + b_[None, :, None, None]
            return torch.matmul(torch.softmax(fu, -1).to(bf), v_), fu

        cases[name] = (
            call, invpt_attention_plain(q, k, v, msg, w, b, scale), comp,
            lambda a=(q, k, v, msg, w, b, scale): invpt_attention_cuda(*a)
            if checkout == ROOT else None)
    return cases


def invpt_plan_times(cases: dict, reps: int) -> dict:
    """Row 9 at PASCAL's stage 2 under each block height the kernel takes
    (1-4 row tiles of 16 query rows; the ring depth and grid then chosen as
    the kernel's plan chooses them): plan -> back-to-back ms. One row tile
    is the only block small enough for two blocks an SM."""
    from mtt_tpu_torch.kernels.invpt_attention import invpt_attention_plan
    call = cases["invpt_attention@pascal2"][0]
    lq, lk, d, with_msg = INVPT_SHAPES["invpt_attention@pascal2"]
    times = {}
    for rt in (1, 2, 3, 4):
        plan = invpt_attention_plan(8, lq, lk, d, with_msg, (rt, 0, 0))
        arg = (ctypes.c_int * 3)(*plan[:3])
        times[str(plan)] = time_b2b(lambda arg=arg: call(plan=arg), reps)
    return times


def f32_cases(bld, gen, stream) -> dict:
    """The f32 rows: row 14's f32 form (``mtt_attn_generic_f32``) at (8,
    1029, 16, 64) and at the cross shape, row 13's and rows 1-2's f32 core
    (``mtt_attn_core_f32``, fast and safe) at the packed ViT-L qkv (8, 1029,
    3072), beside SDPA at f32 (TF32 off), each held to its exact f32 plain
    version at 1e-5 relative RMS."""
    from mtt_tpu_torch.kernels.attention import (attention_generic_plain,
                                                 attention_qkv_plain,
                                                 exp2_clamp_hi,
                                                 fused_attention,
                                                 fused_attention_qkv,
                                                 scaled_log2e)
    dev, f32 = torch.device("cuda"), torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    cases = {}
    for name, (nq, nk, h, d) in {
            "attention_generic_f32": (1029, 1029, 16, 64),
            "attention_generic_f32@cross": (5120, 320, 2, 72)}.items():
        q, k, v = rnd(8, nq, h, d, std=2.0), rnd(8, nk, h, d), rnd(8, nk, h, d)

        def call(q=q, k=k, v=v, d=d):
            out = torch.empty_like(q)
            strides = [s for t in (q, k, v) for s in t.stride()[:3]]
            bld.check(bld.lib().mtt_attn_generic_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
                *strides, d ** -0.5, stream()), "mtt_attn_generic_f32")
            return (out,)

        cases[name] = (call, (attention_generic_plain(q, k, v, d ** -0.5),),
                       lambda q=q, k=k, v=v: sdpa(q, k, v),
                       lambda q=q, k=k, v=v: fused_attention(q, k, v))
    B, N, H, D = 8, 1029, 16, 64
    qkv = rnd(B, N, 3 * H * D, std=1.5)
    s2 = float(scaled_log2e(D ** -0.5, f32))
    for safe in (False, True):
        def core_call(safe=safe):
            out = torch.empty(B, N, H * D, device=dev)
            bld.check(bld.lib().mtt_attn_core_f32(
                qkv.data_ptr(), out.data_ptr(), B, N, H, D, s2,
                exp2_clamp_hi(N), int(safe), stream()), "mtt_attn_core_f32")
            return (out,)

        cases["attention_qkv_f32" + ("_safe" if safe else "")] = (
            core_call, (attention_qkv_plain(qkv, H, D ** -0.5, safe),),
            lambda: sdpa(*qkv.view(B, N, H, 3, D).unbind(3)),
            lambda safe=safe: fused_attention_qkv(qkv, H, safe=safe))
    return cases


def run_one(checkout: Path, tag: str, reps: int, rows: str) -> dict:
    """Errors, equal bits and times of one checkout's kernels."""
    from mtt_tpu_torch.kernels.attention import (attention_generic_plain,
                                                 attention_qkv_plain,
                                                 attn_core_bwd_cuda,
                                                 attn_core_bwd_plain,
                                                 exp2_clamp_hi,
                                                 fused_attention,
                                                 fused_attention_qkv,
                                                 scaled_log2e)
    from mtt_tpu_torch.kernels.window_attention import (
        fused_window_attention_qkv, window_attention_bwd_cuda,
        window_attention_bwd_plain, window_attention_plain)
    bld = load_build(checkout, tag)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if rows == "f32":
        return measure(checkout, bld, reps, f32_cases(bld, gen, stream))
    if rows == "invpt":
        cases = invpt_cases(checkout, bld, gen, stream)
        result = measure(checkout, bld, reps, cases)
        if checkout == ROOT:
            result["plans"] = invpt_plan_times(cases, reps)
        return result
    cases = {}
    for name, (nq, nk, h, d) in {
            "attention_generic": (1029, 1029, 16, 64),
            "attention_generic@cross": (5120, 320, 2, 72)}.items():
        q, k, v = rnd(8, nq, h, d), rnd(8, nk, h, d), rnd(8, nk, h, d)
        scale = float(torch.tensor(d ** -0.5, dtype=bf))

        def call(q=q, k=k, v=v, scale=scale):
            out = torch.empty_like(q)
            strides = [s for t in (q, k, v) for s in t.stride()[:3]]
            bld.check(bld.lib().mtt_attn_generic_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
                *strides, scale, stream()), "mtt_attn_generic_bf16")
            return (out,)

        def sdpa(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

        cases[name] = (call, (attention_generic_plain(q, k, v, d ** -0.5),),
                       sdpa, lambda q=q, k=k, v=v: fused_attention(q, k, v))

    BT, N, H, D = 2, 1029, 16, 64
    qkv, g = rnd(BT, N, 3 * H * D), rnd(BT, N, H * D)
    np_ = -(-N // 64) * 64

    # entries that take the head dim (the parent's may fix it at 64)
    hd = (D,) * (len(bld._SIGNATURES["mtt_attn_bwd_bf16"]) > 9)

    def bwd_call():
        dqkv = torch.empty_like(qkv)
        # the parent reads 3 planes of N rows, the change 2 of np_
        stats = torch.empty(3, BT, H, np_, dtype=torch.float32, device=dev)
        bld.check(bld.lib().mtt_attn_bwd_bf16(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            BT, N, H, *hd, D ** -0.5, stream()), "mtt_attn_bwd_bf16")
        return tuple(dqkv.view(BT, N, H, 3, D).unbind(3))

    want = attn_core_bwd_plain(qkv, g, H, D ** -0.5).view(BT, N, H, 3, D)
    leaves = [qkv.view(BT, N, H, 3, D)[:, :, :, i].transpose(1, 2).detach()
              .requires_grad_() for i in range(3)]
    sd_out = F.scaled_dot_product_attention(*leaves)
    sd_g = g.view(BT, N, H, D).transpose(1, 2)
    cases["attention_bwd"] = (
        bwd_call, tuple(want.unbind(3)),
        lambda: torch.autograd.grad(sd_out, leaves, sd_g, retain_graph=True),
        lambda: attn_core_bwd_cuda(qkv, g, H, D ** -0.5))

    # rows 13 and 1-2's core: the packed ViT-L qkv, fast and safe softmax
    B, N, H, D = 8, 1029, 16, 64
    qkv8 = rnd(B, N, 3 * H * D)
    s2 = float(scaled_log2e(D ** -0.5, bf))

    def sdpa_packed():
        q, k, v = (t.transpose(1, 2)
                   for t in qkv8.view(B, N, H, 3, D).unbind(3))
        return F.scaled_dot_product_attention(q, k, v)

    hd = (D,) * (len(bld._SIGNATURES["mtt_attn_core_bf16"]) > 9)
    for safe in (False, True):
        def core_call(safe=safe):
            out = torch.empty(B, N, H * D, dtype=bf, device=dev)
            bld.check(bld.lib().mtt_attn_core_bf16(
                qkv8.data_ptr(), out.data_ptr(), B, N, H, *hd, s2,
                exp2_clamp_hi(N), int(safe), stream()), "mtt_attn_core_bf16")
            return (out,)

        cases["attention_qkv" + ("_safe" if safe else "")] = (
            core_call, (attention_qkv_plain(qkv8, H, D ** -0.5, safe),),
            sdpa_packed,
            lambda safe=safe: fused_attention_qkv(qkv8, H, safe=safe))

    # row 12 at Swin-B's stage 2 with the mask and stage 0 with and without
    wm = 147
    for name, (bw, hw, masked) in {
            "window_attention_bwd": (32, 16, True),
            "window_attention_bwd@stage0+mask": (512, 4, True),
            "window_attention_bwd@stage0": (512, 4, False)}.items():
        qkvw = rnd(bw, wm, 3, hw, 32)
        q, k, v = qkvw.unbind(2)
        gw = rnd(bw, wm, hw, 32)
        bias = torch.zeros(hw, wm, wm, device=dev)
        bias[:, 3:, 3:] = torch.randn(hw, wm - 3, wm - 3, generator=gen,
                                      device=dev) * 0.5
        mask = None
        if masked:
            mask = torch.zeros(bw, wm, wm, device=dev)
            mask[:, 3:, 3:] = torch.where(torch.randn(
                bw, wm - 3, wm - 3, generator=gen, device=dev) < -0.5,
                -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        wpc = window_chunks(checkout, tag, bw, hw)
        nchunk = -(-bw // wpc)

        # row 11 on the same windows: the forward of the same attention
        def wf_call(qkvw=qkvw, bias=bias, mask=mask, bw=bw, hw=hw,
                    entry="mtt_window_attention_bf16"):
            q_, k_, v_ = qkvw.unbind(2)
            out = torch.empty(bw, wm, hw * 32, dtype=bf, device=dev)
            fn = getattr(bld.lib(), entry)
            fn.argtypes = bld._SIGNATURES["mtt_window_attention_bf16"]
            bld.check(fn(
                q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), bias.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                out.data_ptr(), bw, wm, hw, bw if mask is not None else 1,
                *q_.stride()[:3], 32 ** -0.5, stream()), entry)
            return (out.view(bw, wm, hw, 32),)

        fmerged = (bias[None] + (0.0 if mask is None else mask[:, None])
                   ).to(bf)
        fq, fk, fv = (t.transpose(1, 2) for t in (q, k, v))
        cases[name.replace("_bwd", "")] = (
            wf_call, (window_attention_plain(q, k, v, bias, mask, 32 ** -0.5,
                                             bw),),
            lambda a=(fq, fk, fv, fmerged): F.scaled_dot_product_attention(
                a[0], a[1], a[2], attn_mask=a[3]),
            lambda qkvw=qkvw, bias=bias, mask=mask, bw=bw:
                fused_window_attention_qkv(qkvw, bias, mask, 32 ** -0.5, bw))

        def wb_call(q=q, k=k, v=v, gw=gw, bias=bias, mask=mask, bw=bw, hw=hw,
                    wpc=wpc, nchunk=nchunk):
            dqkv = torch.empty(bw, wm, 3, hw, 32, dtype=bf, device=dev)
            work = torch.empty(nchunk, hw, wm, wm, device=dev)
            dbias = torch.empty(hw, wm, wm, device=dev)
            bld.check(bld.lib().mtt_window_attention_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), gw.data_ptr(),
                bias.data_ptr(), mask.data_ptr() if mask is not None else None,
                dqkv.data_ptr(), work.data_ptr(), dbias.data_ptr(), bw, wm, hw,
                bw if mask is not None else 1, *q.stride()[:3],
                *gw.stride()[:3], wpc, 32 ** -0.5, stream()),
                "mtt_window_attention_bwd_bf16")
            return (*dqkv.unbind(2), dbias)

        merged = (bias[None] + (0.0 if mask is None else mask[:, None])
                  ).to(bf)
        wleaves = [t.transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v)] + [merged.requires_grad_()]

        try:
            wsd_out = F.scaled_dot_product_attention(*wleaves[:3],
                                                     attn_mask=wleaves[3])

            def sdpa_wbwd(out=wsd_out, leaves=wleaves,
                          gt=gw.transpose(1, 2)):
                d = torch.autograd.grad(out, leaves, gt, retain_graph=True)
                return d[:3], d[3].float().sum(0)

            sdpa_wbwd()
        except RuntimeError:          # no backend differentiates the mask
            sdpa_wbwd = None
        cases[name] = (
            wb_call, window_attention_bwd_plain(q, k, v, bias, mask, gw,
                                                32 ** -0.5, bw),
            sdpa_wbwd,
            lambda q=q, k=k, v=v, bias=bias, mask=mask, gw=gw, bw=bw:
                window_attention_bwd_cuda(q, k, v, bias, mask, gw,
                                          32 ** -0.5, bw))
    cases.update(invpt_cases(checkout, bld, gen, stream))
    cases.update(f32_cases(bld, gen, stream))
    return measure(checkout, bld, reps, cases)


def measure(checkout: Path, bld, reps: int, cases: dict) -> dict:
    """Errors, equal bits and times of ``cases``: name -> (raw call, the
    plain version's outputs, the library call or None, the wrapper call)."""
    result = {"ptxas": ptxas_lines(bld, ("attn_generic", "attn_bwd",
                                         "attn_core", "attn_f32", "wattn_bwd",
                                         "wattn_kernel",
                                         "invpt_attention"))}
    for name, (call, want, lib, wrapper) in cases.items():
        row9 = name.startswith("invpt_attention")
        if "_f32" in name:
            # the f32 forms: relative RMS 1e-5 against the exact f32 version
            got, again = tuple(x.clone() for x in call()), call()
            torch.cuda.synchronize()
            rel = max(((a.double() - w.double()).norm() / w.double().norm())
                      .item() for a, w in zip(got, want))
            result[name] = dict(
                ms=time_ms(call, reps), library_ms=time_ms(lib, reps),
                max_abs_err=max((a - w).abs().max().item()
                                for a, w in zip(got, want)),
                rel_rms=rel, within_tol=rel <= 1e-5 and all(
                    bool(torch.isfinite(a).all()) for a in got),
                equal_bits=all(torch.equal(a, b)
                               for a, b in zip(got, again)))
            if checkout == ROOT:
                result[name]["wrapper_ms"] = time_ms(wrapper, reps)
            continue
        # row 9's raw calls write into the same buffers each time
        got, again = tuple(x.clone() for x in call()), call()
        torch.cuda.synchronize()
        errs, tols = [], []
        for a, w in zip(got, want):
            errs.append((a.float() - w.float()).abs().max().item())
            # row 12's dbias (f32 on both sides): 1e-4 of its largest value;
            # row 11: 2 ulps, as tests/test_torch_cuda.py holds it; row 9's
            # fused 0.01 ulps and out 4, as the test holds them
            rel = (0.01 * 2.0 ** -7 if row9 else 1e-4) \
                if a.dtype == torch.float32 else (
                    2 if name.startswith("window_attention@") or
                    name == "window_attention" else 4) * 2.0 ** -7
            tols.append(rel * w.float().abs().max().item())
        # row 9: raw back-to-back launches, the form of its targets in PERF.md
        timer = time_b2b if row9 else time_ms
        result[name] = dict(
            ms=timer(call, reps), library_ms=timer(lib, reps)
            if lib else None, max_abs_err=max(errs),
            within_tol=all(e <= t for e, t in zip(errs, tols)) and all(
                bool(torch.isfinite(a).all()) for a in got),
            equal_bits=all(torch.equal(a, b) for a, b in zip(got, again)))
        if row9 or name == "attention_qkv_safe" or name.startswith(
                ("window_attention@", "window_attention")) and "bwd" not in \
                name:
            # the share of bit-equal outputs; the safe softmax takes the
            # exact max over all keys, so at least 99% of them
            share = (got[0].view(torch.int16) == want[0].view(torch.int16)
                     ).float().mean().item()
            result[name]["bit_equal_share"] = share
            if name == "attention_qkv_safe":
                result[name]["within_tol"] &= share >= 0.99
        if checkout == ROOT:
            # the same launch through the port's Python entry point, whose
            # argument checks run on the host while the card waits
            result[name]["wrapper_ms"] = timer(wrapper, reps)
            if name.startswith("window_attention") and "bwd" not in name:
                # row 11's streamed two-pass form (the Window policy of the
                # attention template), which takes windows past 160 tokens,
                # on the same windows
                result[name]["streamed_ms"] = time_ms(
                    lambda: call(entry="mtt_window_attention_streamed_bf16"),
                    reps)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout holding the parent's mtt_tpu_torch/")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", choices=("all", "invpt", "f32"),
                    default="all",
                    help="every row, row 9 alone, or the f32 rows alone")
    ap.add_argument("--one", choices=("parent", "change"),
                    help="internal: one run of one checkout, as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        checkout = args.parent.resolve() if args.one == "parent" else ROOT
        print(json.dumps(run_one(checkout, args.one, args.reps, args.rows)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        run = subprocess.run(
            [sys.executable, __file__, "--parent", str(args.parent),
             "--reps", str(args.reps), "--rows", args.rows, "--one", tag],
            capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"{tag} run failed:\n{run.stderr[-4000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        if not runs[tag]:
            for line in res["ptxas"]:
                print(f"[ptxas] {tag} {line}", flush=True)
        runs[tag].append(res)
    summary, ok = {}, True
    for name in runs["change"][0]:
        if name == "plans":
            # row 9 at stage 2 under each block height: (rt, stages, grid,
            # shared memory) -> ms in each change run
            print("[ab] invpt_attention@pascal2 plans: " + json.dumps(
                {p: [r["plans"][p] for r in runs["change"]]
                 for p in runs["change"][0]["plans"]}), flush=True)
        if name in ("ptxas", "plans"):
            continue
        row = {}
        for tag, rs in runs.items():
            row[f"{tag}_ms"] = [r[name]["ms"] for r in rs]
            row[f"{tag}_library_ms"] = [r[name]["library_ms"] for r in rs]
            if tag == "change":
                row["change_wrapper_ms"] = [r[name]["wrapper_ms"] for r in rs]
                if "streamed_ms" in rs[0][name]:
                    row["change_streamed_ms"] = [r[name]["streamed_ms"]
                                                 for r in rs]
            row[f"{tag}_max_abs_err"] = rs[0][name]["max_abs_err"]
            if "rel_rms" in rs[0][name]:
                row[f"{tag}_rel_rms"] = rs[0][name]["rel_rms"]
            row[f"{tag}_within_tol"] = all(r[name]["within_tol"] for r in rs)
            row[f"{tag}_equal_bits"] = all(r[name]["equal_bits"] for r in rs)
            if "bit_equal_share" in rs[0][name]:
                row[f"{tag}_bit_equal_share"] = [r[name]["bit_equal_share"]
                                                 for r in rs]
        ok = ok and row["change_within_tol"] and row["change_equal_bits"]
        if name.startswith("invpt_attention"):
            # row 9's share of bit-equal outputs may not fall below the
            # parent kernel's
            ok = ok and min(row["change_bit_equal_share"]) >= min(
                row["parent_bit_equal_share"])
        summary[name] = row
        print(f"[ab] {name}: {json.dumps(row)}", flush=True)
    print(json.dumps({"ab": summary, "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
