"""Time the port's attention kernels of two checkouts in turns on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    git archive <parent> mtt_tpu_torch | tar -x -C build/parent
    python3 tools/torch_attention_ab.py --parent build/parent

Both checkouts' ``mtt_tpu_torch/csrc`` are built (each into its own
``build/`` directory). Each run loads one of the two libraries, in a process
of its own, and calls its exported functions on the same seeded inputs at
the shapes ``chip_smoke.py`` times: row 14 (``mtt_attn_generic_bf16``) at
(8, 1029, 16, 64) and at InvPT's cross shape (q (8, 5120, 2, 72), k/v (8,
320, 2, 72)), and row 7 (``mtt_attn_bwd_bf16``) at qkv (2, 1029, 3072).
Each time is the median of CUDA-event times of ``--reps`` calls; the runs
go parent, change, change, parent, and SDPA (forward and backward) is timed
in each run beside the kernels. Outputs are held to the plain versions at 4
bf16 ulps of the largest value, and each kernel runs twice to show equal
bits. It prints the card's name and power limit, each kernel's ptxas
registers and spills, and one JSON line of the times; it fails when the
change's kernels miss the tolerance or differ between two runs.
"""

from __future__ import annotations

import argparse
import importlib.util
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


def load_build(checkout: Path, tag: str):
    """The ``_build`` module of a checkout, loaded under its own name so two
    copies live side by side; its library is built at first use."""
    path = checkout / "mtt_tpu_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.lib()
    return mod


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


def run_one(checkout: Path, tag: str, reps: int) -> dict:
    """Errors, equal bits and times of one checkout's kernels."""
    from mtt_tpu_torch.kernels.attention import (attention_generic_plain,
                                                 attn_core_bwd_cuda,
                                                 attn_core_bwd_plain,
                                                 fused_attention)
    bld = load_build(checkout, tag)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def stream():
        return torch.cuda.current_stream().cuda_stream

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

    def bwd_call():
        dqkv = torch.empty_like(qkv)
        # the parent reads 3 planes of N rows, the change 2 of np_
        stats = torch.empty(3, BT, H, np_, dtype=torch.float32, device=dev)
        bld.check(bld.lib().mtt_attn_bwd_bf16(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            BT, N, H, D ** -0.5, stream()), "mtt_attn_bwd_bf16")
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

    result = {"ptxas": ptxas_lines(bld, ("attn_generic", "attn_bwd"))}
    for name, (call, want, lib, wrapper) in cases.items():
        got, again = call(), call()
        torch.cuda.synchronize()
        errs, tols = [], []
        for a, w in zip(got, want):
            errs.append((a.float() - w.float()).abs().max().item())
            tols.append(4 * w.float().abs().max().item() * 2.0 ** -7)
        result[name] = dict(
            ms=time_ms(call, reps), library_ms=time_ms(lib, reps),
            max_abs_err=max(errs), within_4_ulps=all(
                e <= t for e, t in zip(errs, tols)) and all(
                bool(torch.isfinite(a).all()) for a in got),
            equal_bits=all(torch.equal(a, b) for a, b in zip(got, again)))
        if checkout == ROOT:
            # the same launch through the port's Python entry point, whose
            # argument checks run on the host while the card waits
            result[name]["wrapper_ms"] = time_ms(wrapper, reps)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout holding the parent's mtt_tpu_torch/")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--one", choices=("parent", "change"),
                    help="internal: one run of one checkout, as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        checkout = args.parent.resolve() if args.one == "parent" else ROOT
        print(json.dumps(run_one(checkout, args.one, args.reps)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        run = subprocess.run(
            [sys.executable, __file__, "--parent", str(args.parent),
             "--reps", str(args.reps), "--one", tag],
            capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"{tag} run failed:\n{run.stderr[-4000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        if not runs[tag]:
            for line in res["ptxas"]:
                print(f"[ptxas] {tag} {line}", flush=True)
        runs[tag].append(res)
    summary, ok = {}, True
    for name in ("attention_generic", "attention_generic@cross",
                 "attention_bwd"):
        row = {}
        for tag, rs in runs.items():
            row[f"{tag}_ms"] = [r[name]["ms"] for r in rs]
            row[f"{tag}_library_ms"] = [r[name]["library_ms"] for r in rs]
            if tag == "change":
                row["change_wrapper_ms"] = [r[name]["wrapper_ms"] for r in rs]
            row[f"{tag}_max_abs_err"] = rs[0][name]["max_abs_err"]
            row[f"{tag}_within_4_ulps"] = all(r[name]["within_4_ulps"]
                                              for r in rs)
            row[f"{tag}_equal_bits"] = all(r[name]["equal_bits"] for r in rs)
        ok = ok and row["change_within_4_ulps"] and row["change_equal_bits"]
        summary[name] = row
        print(f"[ab] {name}: {json.dumps(row)}", flush=True)
    print(json.dumps({"ab": summary, "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
