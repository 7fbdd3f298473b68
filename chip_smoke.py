"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and nvcc; it exits non-zero, printing no result, when either is missing
or any phase fails.

Phases, in order:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from mtt_tpu_torch/csrc (seconds printed);
  3. each kernel against its plain PyTorch version at the ViT-L PASCAL shapes
     the main path gives it: error, tolerance, CUDA-event times;
  4. TaskPrompter-ViT-L PASCAL (5 tasks, dense head, CTR on) with seeded
     random weights in bf16: ``predict`` on 8 images at 512x512, launch counts,
     shapes, finiteness, error against an f32 run of the same weights held to
     the plain bf16 path's own, imgs/s and peak memory.
The line before the last is the kernels JSON; the last line is the device JSON.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time

import torch

# ViT-L PASCAL main-path shapes
B, N, C, HEADS, HIDDEN = 8, 1029, 1024, 16, 4096
T, TAR, FIN, G, S = 5, 300, 350, 16, 1024
IMG = 512

KERNEL_ROWS = {
    # name: (source, TPU kernel it replaces, counter)
    "layernorm": ("mtt_tpu_torch/csrc/layernorm.cu",
                  "mtt_tpu/kernels/layernorm.py:29", "layernorm"),
    "attention_cached": ("mtt_tpu_torch/csrc/attention.cu",
                         "mtt_tpu/kernels/attention.py:423",
                         "attention_cached"),
    "attention_emit": ("mtt_tpu_torch/csrc/attention.cu",
                       "mtt_tpu/kernels/attention.py:393", "attention_emit"),
    "mlp_ln_res": ("mtt_tpu_torch/csrc/mlp.cu",
                   "mtt_tpu/kernels/mlp.py:355", "mlp"),
    "task_decode": ("mtt_tpu_torch/csrc/task_decode.cu",
                    "mtt_tpu/kernels/task_decode.py:49", "task_decode"),
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


def _ulp_tol(want, ulps: int) -> float:
    """``ulps`` bf16 units in the last place of the largest reference value
    (bf16 keeps 8 significant bits)."""
    return ulps * want.float().abs().max().item() * 2.0 ** -7


def kernel_phase():
    """Each kernel against its plain version on the same seeded inputs."""
    from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp_ln_res
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                + mean).to(dtype)

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

    # name -> (call, outputs to compare, tolerance in bf16 ulps, reason)
    cases = {
        "layernorm": (lambda impl: fused_layernorm(x, gamma, beta, impl=impl),
                      1, "same f32 statistics; only the summation order "
                         "differs, which can move a value across one bf16 "
                         "rounding boundary"),
        "attention_cached": (
            lambda impl: fused_attention_ln_qkv(x, gamma, beta, wqkv, bqkv,
                                                HEADS, impl=impl),
            4, "qkv and P are rounded to bf16 at the same points, but f32 "
               "sums in another order can flip one rounding, which moves "
               "the output by a few ulps"),
        "attention_emit": (
            lambda impl: fused_attention_ln_qkv(x, gamma, beta, wqkv, bqkv,
                                                HEADS, need_qkv=True,
                                                impl=impl),
            4, "as attention_cached, for out, qkv and xn"),
        "mlp_ln_res": (
            lambda impl: fused_mlp_ln_res(x, gamma, beta, w1, b1, w2, b2,
                                          impl=impl),
            4, "xn and the GELU output are rounded to bf16 at the same "
               "points; f32 sums in another order can flip a rounding"),
        "task_decode": (
            lambda impl: fused_task_decode(xs, a, cw, ws, bs, wc, bc, wf,
                                           bfin, impl=impl),
            4, "x*a+x, f and fc are rounded to bf16 at the same points; "
               "f32 sums in another order can flip a rounding"),
    }
    results = {}
    for name, (call, ulps, reason) in cases.items():
        got = call("cuda")
        want = call("plain")
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, tol = 0.0, 0.0
        for g_, w_ in zip(got, want):
            if g_.shape != w_.shape or not torch.isfinite(g_).all():
                raise RuntimeError(f"{name}: bad kernel output "
                                   f"{tuple(g_.shape)} vs {tuple(w_.shape)}")
            e, t = _max_err(g_, w_), _ulp_tol(w_, ulps)
            if e > t:
                raise RuntimeError(f"{name}: max |kernel - plain| = {e:.4g} "
                                   f"exceeds {t:.4g} ({ulps} bf16 ulps)")
            err, tol = max(err, e), max(tol, t)
        kms = _time_ms(lambda: call("cuda"))
        pms = _time_ms(lambda: call("plain"))
        results[name] = dict(max_abs_err=err, tol=tol, kernel_ms=kms,
                             plain_ms=pms)
        print(f"[kernel] {name}: max_abs_err={err:.6g} tol={tol:.6g} "
              f"({ulps} bf16 ulps of max |plain|: {reason}) "
              f"kernel_ms={kms:.4f} plain_ms={pms:.4f}", flush=True)

    # the safe (max-subtracted) softmax is not on the eval path; check it too
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


# configs/pascal/taskprompter_vitLp16.yml, the keys build_model reads
VITL_PASCAL = {
    "model": "TaskPrompter", "backbone": "TaskPrompter_vitL", "head": "conv",
    "embed_dim": TAR, "final_embed_dim": FIN, "prompt_len": 1,
    "chan_nheads": 1, "use_ctr": True, "train_db_name": "PASCALContext",
    "val_db_name": "PASCALContext",
    "task_dictionary": {"include_semseg": True, "include_human_parts": True,
                        "include_sal": True, "include_edge": True,
                        "include_normals": True, "edge_w": 0.95},
}
EXPECTED_LAUNCHES = {"attention_cached": 20, "attention_emit": 4,
                     "layernorm": 5, "mlp": 24, "task_decode": 4}
# The whole forward is held against an f32 run of the same (bf16-valued)
# weights on the plain versions, by the relative RMS error per task,
# ||logits - f32|| / ||f32||. Both bf16 paths (kernels, and the plain versions
# in bf16) round at the same points, yet each sits 0.016-0.039 from the f32
# run at this seed on an H100: 24 blocks of random weights amplify bf16
# rounding, and which roundings flip differs between the two paths, so
# neither is the other's exact reference. The bound is 2.5x the largest of
# those; wiring faults (a wrong head order, a dropped bias or task) give
# errors of order 1. The kernels themselves are held to ulps in phase 3.
FORWARD_RMS_TOL = 0.1


def model_phase():
    """ViT-L PASCAL eval forward through the kernels; returns the launch
    counts of that one forward."""
    from mtt_tpu_torch.inference import predict, preprocess
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    model = build_model(VITL_PASCAL, device=dev, dtype=torch.bfloat16).eval()
    init_weights(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    rgb = torch.randint(0, 256, (B, IMG, IMG, 3), generator=gen, device=dev)
    x = preprocess(rgb)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    logits, preds = predict(model, x)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[model] TaskPrompter-ViT-L PASCAL, {n_params / 1e6:.1f} M params,"
          f" batch {B} at {IMG}x{IMG} bf16; launches {counts}", flush=True)
    if counts != EXPECTED_LAUNCHES:
        raise RuntimeError(f"launch counts {counts} != {EXPECTED_LAUNCHES}")

    for t in model.tasks:
        n = model.get_submodule(f"head_{t}").linear_pred.out_channels
        if logits[t].shape != (B, IMG, IMG, n):
            raise RuntimeError(f"{t}: logits {tuple(logits[t].shape)}")
        if not torch.isfinite(logits[t]).all():
            raise RuntimeError(f"{t}: non-finite logits")
        if preds[t].shape[:3] != (B, IMG, IMG) or \
                not torch.isfinite(preds[t].float()).all():
            raise RuntimeError(f"{t}: bad prediction {tuple(preds[t].shape)}")

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
        max_k = ((k - r).abs().max() / r.abs().max()).item()
        max_p = ((p - r).abs().max() / r.abs().max()).item()
        line = (f"[model] {t}: logits {tuple(logits[t].shape)}; vs the f32 "
                f"run: relative RMS error kernels {rms_k:.5g} (tol "
                f"{FORWARD_RMS_TOL}), plain bf16 {rms_p:.5g}; max error / "
                f"max|f32| kernels {max_k:.5g}, plain bf16 {max_p:.5g}")
        if t in ("semseg", "human_parts"):
            line += (f"; argmax agreement with f32: kernels "
                     f"{(preds[t] == ref_preds[t]).float().mean().item():.5f},"
                     f" plain bf16 "
                     f"{(plain_preds[t] == ref_preds[t]).float().mean().item():.5f}")
        print(line, flush=True)
        if not rms_k <= FORWARD_RMS_TOL:
            raise RuntimeError(f"{t}: kernel forward is {rms_k:.4g} (relative"
                               f" RMS) from the f32 run, over "
                               f"{FORWARD_RMS_TOL}")
    print(f"[model] forward+postprocess {ms:.2f} ms = {B / ms * 1e3:.2f} "
          f"imgs/s through the kernels; plain versions {plain_ms:.2f} ms = "
          f"{B / plain_ms * 1e3:.2f} imgs/s; peak memory of the first "
          f"forward {peak_gib:.2f} GiB", flush=True)
    return counts


def main():
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
        m = re.search(r"entry function '\w*?(\d+)([a-z_]+_kernel)(IL\w+?E)?",
                      line)
        if m:
            kernel = m.group(2) + (m.group(3) or "")
        elif kernel and ("spill" in line or "registers" in line):
            print(f"[ptxas] {kernel}: {line.split(':', 1)[-1].strip()}")

    results = kernel_phase()
    counts = model_phase()

    rows = []
    for name, (src, replaces, counter) in KERNEL_ROWS.items():
        r = results[name]
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=counts[counter],
                         max_abs_err=r["max_abs_err"], tol=r["tol"],
                         ms=r["kernel_ms"], kernel_ms=r["kernel_ms"],
                         plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
