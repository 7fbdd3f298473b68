"""Time the port's InvPT multi-scale tail (row 10) of two checkouts in turns
on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    mkdir -p build/parent && git archive <parent> mtt_tpu_torch | tar -x -C build/parent
    python3 tools/torch_tail_ab.py --parent build/parent

Each run imports one checkout's ``mtt_tpu_torch`` (built into that
checkout's own ``build/`` directory) in a process of its own (two kernel
libraries in one process give wrong results: two static CUDA runtimes) and
calls its kernel entry point ``ms_tail_cuda`` on the same seeded inputs:
InvPT-ViT-L PASCAL's maps x0, x1, x2 (8, 16/32/64 squared, 576) with D =
576, without the head and with semseg's 21 logits, and NYUD's (8, 14x18 /
28x36 / 56x72, 576) without the head and with its 40 logits. Each time is
one of raw launches: CUDA events around ``--launches`` back-to-back calls
(the wrapper's per-call re-layout included, as a model pays it), divided by
their number, the median of ``--reps`` such runs. The library composition
(the dense cuDNN tail: upsample each scale, sum, conv3x3, affine, ReLU, and
the 1x1 for the head) is timed the same way in every run. The runs go
parent, change, change, parent. Each case also counts the launches of one
call (``torch.profiler``), and for the change the three Gm launches alone
(``mtt_gemm_bf16`` with the tail's bias-free epilogue) are timed the same
way. Outputs are held to each checkout's plain version at 4 bf16 ulps of the
largest value, and each kernel runs twice to show equal bits. It prints the
card's name and power limit, the new kernels' ptxas registers and spills,
the bound of each case (bytes at 3.35 TB/s against bf16 tensor-core
operations at 989 TFLOP/s plus f32 operations at 67 TFLOP/s), the peak
memory of one call, and one JSON line of the times; it fails when the
change's kernels miss a tolerance or differ between two runs. The timing
helpers are ``tools/torch_head_ab.py``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from torch_head_ab import bound_ms, launches_of, nbytes, raw_ms

ROOT = Path(__file__).resolve().parents[1]

B, C = 8, 576
FACTORS = (8, 4, 2)
EPI_TAIL = 4     # csrc/gemm.cuh


def peak_gib(fn) -> float:
    """Peak device memory of one call of ``fn`` above what was allocated
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def ptxas_lines(build) -> list:
    log = build.build_log or (build.BUILD_ROOT / build.source_hash()
                              / "build.log").read_text()
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and re.search(r"invpt_tail|gemm_kernelILi4E", kernel) \
                and ("registers" in line or "spill" in line):
            name = re.search(r"(invpt_tail\w*|gemm_kernel\w*)",
                             kernel).group(1)
            out.append(f"{name[:44]}: {line.split(':', 1)[-1].strip()}")
    return out


def run_one(checkout: Path, launches: int, reps: int) -> dict:
    """Errors, equal bits and times of one checkout's row 10."""
    sys.path.insert(0, str(checkout))
    from mtt_tpu_torch.kernels import _build
    from mtt_tpu_torch.kernels.invpt_tail import (ms_tail_cuda,
                                                  ms_tail_head_plain,
                                                  ms_tail_plain)
    assert Path(_build.__file__).resolve().is_relative_to(checkout.resolve())
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                + mean).to(dtype)

    cases = {}
    for tag, (th, tw, n) in {"": (128, 128, 21),
                             "@nyud": (112, 144, 40)}.items():
        xs = tuple(rnd(B, th // f, tw // f, C, std=0.5) for f in FACTORS)
        kc = rnd(3, 3, C, C, std=(9 * C) ** -0.5)
        inv = rnd(C, std=0.1, mean=1.0, dtype=torch.float32)
        addv = rnd(C, std=0.1, dtype=torch.float32)
        wh = rnd(C, n, std=C ** -0.5)
        bh = rnd(n, std=0.1, dtype=torch.float32)
        kc_oihw = kc.permute(3, 2, 0, 1).contiguous()
        wh_oihw = wh.t()[:, :, None, None].contiguous()

        def dense(head, xs=xs, th=th, tw=tw, kc_oihw=kc_oihw, inv=inv,
                  addv=addv, wh_oihw=wh_oihw, bh=bh):
            acc = sum(F.interpolate(x.permute(0, 3, 1, 2), size=(th, tw),
                                    mode="bilinear", align_corners=False)
                      for x in xs)
            y = F.relu(F.conv2d(acc, kc_oihw, padding=1)
                       * inv.to(bf)[:, None, None]
                       + addv.to(bf)[:, None, None])
            return F.conv2d(y, wh_oihw, bh.to(bf)) if head else y

        px = B * sum((th // f) * (tw // f) for f in FACTORS)
        out_px = B * th * tw
        # Gm (9 taps) and the width mix (6 nonzero taps) on the tensor
        # cores; the height mix (6 taps a scale), the sum over scales, the
        # affine and the ReLU in f32 (as chip_smoke.py counts them)
        tcf = 2.0 * px * C * 9 * C + 12.0 * 3 * tw * C * B * sum(
            th // f for f in FACTORS)
        f32f = (3 * 12.0 + 2.0 + 4.0) * out_px * C
        common = nbytes(*xs, kc, inv, addv)
        gm_call = None
        if checkout.resolve() == ROOT.resolve():
            # the three Gm launches alone: x_s (B gh gw, C) . wg^T (9 C, C)
            fn = _build.lib().mtt_gemm_bf16
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            wg = kc.permute(0, 1, 3, 2).contiguous()
            gm = xs[0].new_empty(px, 9 * C)

            def gm_call(xs=xs, wg=wg, gm=gm, th=th, tw=tw):
                row0 = 0
                for x, f in zip(xs, FACTORS):
                    rows = B * (th // f) * (tw // f)
                    _build.check(fn(x.data_ptr(), wg.data_ptr(),
                                    gm[row0:].data_ptr(), None, 0, None,
                                    rows, 9 * C, C, EPI_TAIL,
                                    _build.stream()), "mtt_gemm_bf16")
                    row0 += rows
        cases[f"invpt_tail{tag}"] = dict(
            call=lambda a=(xs, kc, inv, addv, th, tw): ms_tail_cuda(*a),
            gm_call=gm_call,
            want=ms_tail_plain(xs, kc, inv, addv, th, tw),
            library=lambda dense=dense: dense(False),
            bound=bound_ms(common + out_px * C * 2, tcf, f32f))
        cases[f"invpt_tail_head{tag}"] = dict(
            call=lambda a=(xs, kc, inv, addv, th, tw, wh, bh): ms_tail_cuda(
                *a),
            want=ms_tail_head_plain(xs, kc, inv, addv, wh, bh, th, tw),
            library=lambda dense=dense: dense(True),
            bound=bound_ms(common + nbytes(wh, bh) + out_px * n * 4,
                           tcf + 2.0 * out_px * C * n, f32f))

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
            launches_per_call=launches_of(c["call"]),
            peak_gib=peak_gib(c["call"]))
        if c.get("gm_call"):
            result[name]["gm_ms"] = raw_ms(c["gm_call"], launches, reps)
        del got, again
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout holding the parent's mtt_tpu_torch/")
    ap.add_argument("--launches", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one", choices=("parent", "change"),
                    help="internal: one run of one checkout, as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tail_ab: no CUDA device", file=sys.stderr)
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
            row[f"{tag}_ms"] = [r[name]["ms"] for r in rs]
            row[f"{tag}_library_ms"] = [r[name]["library_ms"] for r in rs]
            row[f"{tag}_launches_per_call"] = rs[0][name][
                "launches_per_call"]
            row[f"{tag}_peak_gib"] = rs[0][name]["peak_gib"]
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
