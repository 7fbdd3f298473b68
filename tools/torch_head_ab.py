"""Time the port's task decode (row 5) and up4 head (row 6) kernels of two
checkouts in turns on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    mkdir -p build/parent && git archive <parent> mtt_tpu_torch | tar -x -C build/parent
    python3 tools/torch_head_ab.py --parent build/parent

Each run imports one checkout's ``mtt_tpu_torch`` (built into that
checkout's own ``build/`` directory) in a process of its own (two kernel
libraries in one process give wrong results: two static CUDA runtimes) and
calls its kernel entry points, ``task_decode_cuda`` and ``head_up4_cuda``,
on the same seeded inputs: row 5 at the main path's x (8, 1024, 1024) and
ViT-B's (8, 1024, 768), 5 tasks, tar 300, F 350; row 6 at the main path's x
(8, 32, 32, 350) with 21 logits, ViT-B's (8, 32, 32, 768) and NYUD's (8,
28, 36, 768) with 1, 3 and 40 logits. Each time is one of raw launches: CUDA
events around ``--launches`` back-to-back calls (the wrapper's per-call
re-layout included, as a model pays it), divided by their number, the
median of ``--reps`` such runs. The library composition (row 5: the einsum
composition of the plain version's function; row 6: the dense cuDNN head,
upsample, conv3x3, affine, GELU, 1x1) is timed the same way in every run.
The runs go parent, change, change, parent. Each case also counts the
kernel launches of one call (``torch.profiler``: the wrapper's re-layout
launches and the kernels'), and for the change the Gm launch of row 6 alone
(``mtt_gemm_bf16`` with the bias-free epilogue) is timed the same way.
Outputs are held to each checkout's plain version at 4 bf16 ulps of the
largest value, and each kernel runs twice to show equal bits. It prints the
card's name and power limit, each kernel's ptxas registers and spills, the
bound of each case (bytes at 3.35 TB/s against bf16 tensor-core operations
at 989 TFLOP/s plus f32 operations at 67 TFLOP/s), and one JSON line of the
times; it fails when the change's kernels miss a tolerance or differ between
two runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]

PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
B, S, T, G, TAR, FIN = 8, 1024, 5, 16, 300, 350


def raw_ms(fn, launches: int, reps: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``launches``
    back-to-back calls, divided by ``launches``."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def bound_ms(nbytes: float, tc_flops: float, f32_flops: float = 0.0):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (tc_flops / PEAK_BF16 + f32_flops / PEAK_F32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def launches_of(fn) -> int:
    """Kernel launches (runtime and driver API) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cudaLaunchKernelExC", "cuLaunchKernelEx"))


def ptxas_lines(build) -> list:
    log = build.build_log or (build.BUILD_ROOT / build.source_hash()
                              / "build.log").read_text()
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and re.search(r"task_decode|head_up4|gemm_kernelILi3E",
                                  kernel) and ("registers" in line
                                               or "spill" in line):
            name = re.search(r"(task_decode\w*|head_up4\w*|gemm_kernel\w*)",
                             kernel).group(1)
            out.append(f"{name[:40]}: {line.split(':', 1)[-1].strip()}")
    return out


def run_one(checkout: Path, launches: int, reps: int) -> dict:
    """Errors, equal bits and times of one checkout's rows 5 and 6."""
    sys.path.insert(0, str(checkout))
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.head_up4 import head_up4_cuda, head_up4_plain
    from mtt_tpu_torch.kernels.task_decode import (task_decode_cuda,
                                                   task_decode_plain)
    assert Path(_build.__file__).resolve().is_relative_to(checkout.resolve())
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                + mean).to(dtype)

    cases = {}
    for name, C in (("task_decode", 1024), ("task_decode@C768", 768)):
        args = (rnd(B, S, C), rnd(B, T, S, G),
                rnd(B, T, C, dtype=torch.float32),
                rnd(T, TAR, C, std=C ** -0.5), rnd(T, TAR, std=0.1),
                rnd(T, TAR, C, std=C ** -0.5), rnd(T, TAR, std=0.1),
                rnd(T, FIN, 2 * TAR, std=(2 * TAR) ** -0.5),
                rnd(T, FIN, std=0.1))

        def comp(args=args, C=C):
            x, a, cw, ws, bs, wc, bc, wf, bfin = args
            xt = x[:, None]
            f = torch.einsum("btsc,trc->btsr",
                             xt * a.repeat_interleave(C // G, -1) + xt, ws) \
                + bs[None, :, None]
            fc = torch.einsum("btsc,trc->btsr",
                              xt * cw.to(bf)[:, :, None] + xt, wc) \
                + bc[None, :, None]
            return torch.einsum("btsr,tfr->btsf", torch.cat([f, fc], -1),
                                wf) + bfin[None, :, None]

        cases[name] = dict(
            call=lambda args=args: task_decode_cuda(*args),
            want=task_decode_plain(*args), library=comp,
            bound=bound_ms(nbytes(*args) + B * S * T * FIN * 2,
                           2.0 * B * T * S * (2 * C * TAR + 2 * TAR * FIN)))

    for name, (gh, gw, C, n) in {
            "head_up4": (32, 32, 350, 21), "head_up4@C768": (32, 32, 768, 21),
            "head_up4@nyud_n1": (28, 36, 768, 1),
            "head_up4@nyud_n3": (28, 36, 768, 3),
            "head_up4@nyud_n40": (28, 36, 768, 40)}.items():
        args = (rnd(B, gh, gw, C, std=0.5),
                rnd(3, 3, C, C, std=(9 * C) ** -0.5),
                rnd(C, std=0.1, mean=1.0, dtype=torch.float32),
                rnd(C, std=0.1, dtype=torch.float32),
                rnd(C, n, std=C ** -0.5))
        kc_oihw = args[1].permute(3, 2, 0, 1).contiguous()
        kp_oihw = args[4].t()[:, :, None, None].contiguous()

        def dense(args=args, kc_oihw=kc_oihw, kp_oihw=kp_oihw):
            x, _, inv, addv, _ = args
            up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=4,
                               mode="bilinear", align_corners=False)
            y = F.conv2d(up, kc_oihw, padding=1)
            y = F.gelu(y * inv.to(bf)[:, None, None]
                       + addv.to(bf)[:, None, None])
            return F.conv2d(y, kp_oihw)

        px = B * 16 * gh * gw
        gm_call = None
        if checkout.resolve() == ROOT.resolve():
            # the Gm launch alone: x (B gh gw, CP) . wg^T (9 DP, CP)
            fn = _build.lib().mtt_gemm_bf16
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            CP = -(-C // 8) * 8
            # from a generator of their own: both checkouts' cases keep the
            # same inputs
            g2 = torch.Generator(device=dev).manual_seed(1)
            xa, wg = (torch.randn(r, CP, generator=g2, device=dev).to(bf)
                      for r in (B * gh * gw, 9 * CP))
            gm = xa.new_empty(B * gh * gw, 9 * CP)

            def gm_call(xa=xa, wg=wg, gm=gm, CP=CP):
                _build.check(fn(xa.data_ptr(), wg.data_ptr(), gm.data_ptr(),
                                None, 0, None, xa.shape[0], 9 * CP, CP, 3,
                                _build.stream()), "mtt_gemm_bf16")
        cases[name] = dict(
            call=lambda args=args: head_up4_cuda(*args), gm_call=gm_call,
            want=head_up4_plain(*args), library=dense,
            # Gm (9 taps), the width mix (6 nonzero taps) and the 1x1 on the
            # tensor cores; the height mix (6 taps), affine and GELU in f32
            bound=bound_ms(nbytes(*args) + px * n * 4,
                           2.0 * B * gh * gw * C * 9 * C
                           + 12.0 * B * gh * 3 * C * 4 * gw
                           + 2.0 * px * C * n, 37.0 * px * C))

    result = {"ptxas": ptxas_lines(_build)}
    for name, c in cases.items():
        got = c["call"]()
        again = c["call"]()
        torch.cuda.synchronize()
        want = c["want"]
        err = (got.float() - want.float()).abs().max().item()
        tol = 4 * 2.0 ** -7 * want.float().abs().max().item()
        result[name] = dict(
            ms=raw_ms(c["call"], launches, reps),
            library_ms=raw_ms(c["library"], launches, reps),
            bound_ms=c["bound"][0], bound_by=c["bound"][1],
            max_abs_err=err,
            within_tol=err <= tol and bool(torch.isfinite(got).all()),
            equal_bits=torch.equal(got, again),
            bit_equal_share=(got == want).float().mean().item(),
            launches_per_call=launches_of(c["call"]))
        if c.get("gm_call"):
            result[name]["gm_ms"] = raw_ms(c["gm_call"], launches, reps)
        del got, again
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout holding the parent's mtt_tpu_torch/")
    ap.add_argument("--launches", type=int, default=10)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--one", choices=("parent", "change"),
                    help="internal: one run of one checkout, as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_head_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        checkout = args.parent.resolve() if args.one == "parent" else ROOT
        print(json.dumps(run_one(checkout, args.launches, args.reps)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        run = subprocess.run(
            [sys.executable, __file__, "--parent", str(args.parent),
             "--launches", str(args.launches), "--reps", str(args.reps),
             "--one", tag], capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"{tag} run failed:\n{run.stderr[-4000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        if not runs[tag]:
            for line in res["ptxas"]:
                print(f"[ptxas] {tag} {line}", flush=True)
        runs[tag].append(res)
    summary, ok = {}, True
    for name in runs["change"][0]:
        if name == "ptxas":
            continue
        row = {"bound_ms": runs["change"][0][name]["bound_ms"],
               "bound_by": runs["change"][0][name]["bound_by"]}
        for tag, rs in runs.items():
            if name not in rs[0]:
                continue
            row[f"{tag}_ms"] = [r[name]["ms"] for r in rs]
            row[f"{tag}_library_ms"] = [r[name]["library_ms"] for r in rs]
            row[f"{tag}_launches_per_call"] = rs[0][name][
                "launches_per_call"]
            if "gm_ms" in rs[0][name]:
                row[f"{tag}_gm_ms"] = [r[name]["gm_ms"] for r in rs]
            row[f"{tag}_max_abs_err"] = rs[0][name]["max_abs_err"]
            row[f"{tag}_bit_equal_share"] = rs[0][name]["bit_equal_share"]
            row[f"{tag}_within_tol"] = all(r[name]["within_tol"] for r in rs)
            row[f"{tag}_equal_bits"] = all(r[name]["equal_bits"] for r in rs)
        ok = ok and row["change_within_tol"] and row["change_equal_bits"]
        summary[name] = row
        print(f"[ab] {name}: {json.dumps(row)}", flush=True)
    print(json.dumps({"ab": summary, "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
