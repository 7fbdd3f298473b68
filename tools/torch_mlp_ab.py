"""Time the port's LayerNorm (row 3), MLP-LN-residual (row 4) and plain MLP
(row 8) kernels and the qkv projection of rows 1-2 of two checkouts in turns
on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    mkdir -p build/parent && git archive <parent> mtt_tpu_torch | tar -x -C build/parent
    python3 tools/torch_mlp_ab.py --parent build/parent
    python3 tools/torch_mlp_ab.py --parent build/parent --rows f32

Both checkouts' ``mtt_tpu_torch/csrc`` are built (each into its own
``build/`` directory); each run loads one of the two libraries, in a process
of its own (two kernel libraries in one process give wrong results: two
static CUDA runtimes), and calls its exported functions on the same seeded
inputs: row 3 (``mtt_layernorm_bf16``) at the ViT-L tap shape (8, 1029,
1024) and at Swin-B's stage 0 (73,728 rows of 128, eps 1e-5), row 4
(``mtt_mlp_ln_res_bf16``) at (8, 1029, 1024) with hidden 4096 and at ViT-B's
(8, 1029, 768) with hidden 3072, row 8 (``mtt_mlp_fc_bf16``) at the ViT-L
step's (2, 1029, 1024) with hidden 4096 and at Swin-B's stage 2 (4,608 rows
of 512, hidden 2048), and the projection (``mtt_qkv_proj_bf16``) at (8232,
1024) -> 3072. The parameters are f32 for both checkouts (the parent's row 8
and projection read nothing else); the change also runs them with bf16
parameters, as a bf16 model stores them. Each time is one of raw
launches: CUDA events around ``--launches`` back-to-back launches, divided by
their number, the median of ``--reps`` such runs; the library call or
composition (``F.layer_norm``; ``x + fc2(gelu(fc1(F.layer_norm(x))))``;
``fc2(gelu(fc1(x)))``; ``F.linear``) is timed the same way in every run, and
the change's Python entry points (``fused_layernorm``, ``fused_mlp_ln_res``,
``fused_mlp``, ``qkv_proj_cuda``: argument checks and allocation on the
host) beside them, timed after all the raw launches so that the two
checkouts' raw times follow the same work. The runs go parent, change, change, parent. Outputs
are held to the plain versions (rows 3 and the projection at 1 bf16 ulp,
rows 4 and 8 at 4 of the largest value) and each kernel runs twice to show
equal bits. It prints the
card's name and power limit, each kernel's ptxas registers and spills, the
bound of each case (bytes at 3.35 TB/s or bf16 tensor-core operations at 989
TFLOP/s), and one JSON line of the times; it fails when the change's kernels
miss a tolerance or differ between two runs.

The f32 rows (``--rows f32`` alone; ``f32_cases``): the f32 GEMM
(``mtt_gemm_f32``) at fc1, fc2 and the qkv projection of a ViT-L block,
each under its epilogue and under ``EPI_NONE`` (``/none``: the products
alone), row 4's and row 3's f32 forms, raw, beside ``F.linear``, the composition and
``F.layer_norm`` at f32 with TF32 off, held to the exact f32 plain versions
at 1e-5 relative RMS; their bound is three TF32 passes at 495 TFLOP/s (the
3xTF32 kernels' work), printed beside the f32 products at 67 TFLOP/s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from torch_attention_ab import load_build, ptxas_lines  # noqa: E402

PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
PEAK_TF32, PEAK_F32 = 495e12, 67e12   # TF32 tensor cores; f32 outside them


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


def f32_cases(bld, lib, rnd, stream) -> dict:
    """The f32 rows: ``mtt_gemm_f32`` at fc1 (GELU), fc2 (+ residual) and
    the qkv projection (+ bias) of a ViT-L block at (8232, 1024), and at the
    same shapes without an epilogue, row 4's
    f32 form (``mtt_mlp_ln_res_f32``) and row 3's (``mtt_layernorm_f32``),
    raw, beside ``F.linear``, the composition and ``F.layer_norm`` at f32
    with TF32 off. Outputs are held to the exact f32 plain versions at 1e-5
    relative RMS. Bounds: three TF32 passes at 495 TFLOP/s against the
    bytes (the change's kernels run on the tensor cores), beside the f32
    products at 67 TFLOP/s outside them."""
    from mtt_tpu_torch.kernels.layernorm import layernorm_plain
    from mtt_tpu_torch.kernels.mlp import gelu_erf_poly, mlp_ln_res_plain
    f32 = torch.float32
    fn = lib.mtt_gemm_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows, C, Hd = 8 * 1029, 1024, 4096

    def bounds(flops, nbytes):
        return dict(bound_ms=max(3 * flops / PEAK_TF32, nbytes / PEAK_BYTES)
                    * 1e3, bound_by="operations",
                    ffma_bound_ms=flops / PEAK_F32 * 1e3)

    cases = {}
    # each shape under its epilogue, then under EPI_NONE (3): the products
    # alone, so that the epilogue's share of the time shows
    for name, (N, K, epi) in {"gemm_f32@fc1": (Hd, C, 0),
                              "gemm_f32@fc2": (C, Hd, 1),
                              "gemm_f32@qkv": (3 * C, C, 2),
                              "gemm_f32@fc1/none": (Hd, C, 3),
                              "gemm_f32@fc2/none": (C, Hd, 3),
                              "gemm_f32@qkv/none": (3 * C, C, 3)}.items():
        a = rnd(rows, K, dtype=f32)
        w = rnd(N, K, std=K ** -0.5, dtype=f32)
        bias = rnd(N, std=0.1, dtype=f32)
        res = rnd(rows, N, dtype=f32) if epi == 1 else None
        out = a.new_empty(rows, N)

        def call(a=a, w=w, bias=bias, res=res, out=out, N=N, K=K, epi=epi):
            bld.check(fn(a.data_ptr(), 0, w.data_ptr(), out.data_ptr(), 0,
                         bias.data_ptr(), res.data_ptr() if res is not None
                         else None, rows, N, K, epi, stream()),
                      "mtt_gemm_f32")
            return (out,)

        acc = a @ w.t() + bias if epi != 3 else a @ w.t()
        want = gelu_erf_poly(acc) if epi == 0 else acc + res if epi == 1 \
            else acc
        cases[name] = dict(
            call=call, want=(want,), rel_tol=1e-5,
            library=lambda a=a, w=w, bias=bias if epi != 3 else None:
            F.linear(a, w, bias),
            **bounds(2.0 * rows * N * K, 4 * (a.numel() + w.numel()
                                              + 2 * out.numel())))
    x = rnd(rows, C, dtype=f32)
    g, be = rnd(C, std=0.1, mean=1.0, dtype=f32), rnd(C, std=0.1, dtype=f32)
    w1, b1 = rnd(Hd, C, std=C ** -0.5, dtype=f32), rnd(Hd, std=0.1, dtype=f32)
    w2, b2 = rnd(C, Hd, std=Hd ** -0.5, dtype=f32), rnd(C, std=0.1, dtype=f32)
    out, xn, h = torch.empty_like(x), torch.empty_like(x), x.new_empty(rows, Hd)

    def mlp_call():
        bld.check(lib.mtt_mlp_ln_res_f32(
            x.data_ptr(), g.data_ptr(), be.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), xn.data_ptr(),
            h.data_ptr(), out.data_ptr(), rows, C, Hd, 1e-6, 3, stream()),
            "mtt_mlp_ln_res_f32")
        return (out,)

    cases["mlp_ln_res_f32"] = dict(
        call=mlp_call, want=(mlp_ln_res_plain(x, g, be, w1, b1, w2, b2),),
        rel_tol=1e-5,
        library=lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(
            x, (C,), g, be, 1e-6), w1, b1)), w2, b2),
        **bounds(4.0 * rows * C * Hd, 4 * (3 * x.numel() + w1.numel()
                                           + w2.numel())))
    y = torch.empty_like(x)

    def ln_call():
        bld.check(lib.mtt_layernorm_f32(
            x.data_ptr(), g.data_ptr(), be.data_ptr(), y.data_ptr(), rows, C,
            1e-6, 3, stream()), "mtt_layernorm_f32")
        return (y,)

    cases["layernorm_f32"] = dict(
        call=ln_call, want=(layernorm_plain(x, g, be, 1e-6),), rel_tol=1e-5,
        library=lambda: F.layer_norm(x, (C,), g, be, 1e-6),
        bound_ms=2 * x.numel() * 4 / PEAK_BYTES * 1e3, bound_by="bytes")
    return cases


def run_one(checkout: Path, tag: str, launches: int, reps: int,
            rows_: str = "all") -> dict:
    """Errors, equal bits and times of one checkout's kernels."""
    from mtt_tpu_torch.kernels.layernorm import (fused_layernorm,
                                                 layernorm_plain)
    from mtt_tpu_torch.kernels.attention import qkv_proj_cuda, qkv_proj_plain
    from mtt_tpu_torch.kernels.mlp import (fused_mlp, fused_mlp_ln_res,
                                           mlp_fc_plain, mlp_ln_res_plain)
    bld = load_build(checkout, tag)
    lib = bld.lib()
    # the parent's entry points take f32 parameters and no scratch
    new_abi = len(bld._SIGNATURES["mtt_layernorm_bf16"]) == 9
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, std=1.0, mean=0.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                + mean).to(dtype)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    # the library's f32 calls in full f32, as the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = {}
    if rows_ == "f32":
        return measure(checkout, bld, f32_cases(bld, lib, rnd, stream),
                       launches, reps)
    for name, (rows, C, eps) in {"layernorm": (8 * 1029, 1024, 1e-6),
                                 "layernorm@swin0": (192 * 384, 128, 1e-5)
                                 }.items():
        x = rnd(rows, C)
        g32 = rnd(C, std=0.1, mean=1.0, dtype=f32)
        b32 = rnd(C, std=0.1, dtype=f32)
        for pdt in (f32, bf) if new_abi else (f32,):
            g, b = g32.to(pdt), b32.to(pdt)
            y = torch.empty_like(x)

            def call(x=x, g=g, b=b, y=y, rows=rows, C=C, eps=eps):
                extra = ((1 if g.dtype == f32 else 0)
                         | (2 if b.dtype == f32 else 0),) if new_abi else ()
                bld.check(lib.mtt_layernorm_bf16(
                    x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                    rows, C, eps, *extra, stream()), "mtt_layernorm_bf16")
                return (y,)

            gl, bl = g32.to(bf), b32.to(bf)
            cases[name + ("" if pdt == f32 else "@bf16_params")] = dict(
                call=call, want=(layernorm_plain(x, g, b, eps),), ulps=1,
                library=lambda x=x, gl=gl, bl=bl, eps=eps: F.layer_norm(
                    x, x.shape[-1:], gl, bl, eps),
                wrapper=lambda x=x, g=g, b=b, eps=eps: fused_layernorm(
                    x, g, b, eps),
                bound_ms=2 * x.numel() * 2 / PEAK_BYTES * 1e3,
                bound_by="bytes")

    for name, (rows, C, Hd) in {"mlp_ln_res": (8 * 1029, 1024, 4096),
                                "mlp_ln_res@vitb": (8 * 1029, 768, 3072)
                                }.items():
        x = rnd(rows, C)
        g32 = rnd(C, std=0.1, mean=1.0, dtype=f32)
        be32 = rnd(C, std=0.1, dtype=f32)
        w1, b132 = rnd(Hd, C, std=C ** -0.5), rnd(Hd, std=0.1, dtype=f32)
        w2, b232 = rnd(C, Hd, std=Hd ** -0.5), rnd(C, std=0.1, dtype=f32)
        out = torch.empty_like(x)
        xn, h = torch.empty_like(x), x.new_empty(rows, Hd)
        for pdt in (f32, bf) if new_abi else (f32,):
            p = [t.to(pdt) for t in (g32, be32, b132, b232)]

            def call(x=x, p=p, w1=w1, w2=w2, out=out, xn=xn, h=h, C=C, Hd=Hd):
                ptr = [t.data_ptr() for t in p]
                if new_abi:
                    flags = sum(1 << i for i, t in enumerate(p)
                                if t.dtype == f32)
                    args = (x.data_ptr(), ptr[0], ptr[1], w1.data_ptr(),
                            ptr[2], w2.data_ptr(), ptr[3], xn.data_ptr(),
                            h.data_ptr(), out.data_ptr(), x.shape[0], C, Hd,
                            1e-6, flags, stream())
                else:
                    args = (x.data_ptr(), ptr[0], ptr[1], w1.data_ptr(),
                            ptr[2], w2.data_ptr(), ptr[3], out.data_ptr(),
                            x.shape[0], C, Hd, 1e-6, stream())
                bld.check(lib.mtt_mlp_ln_res_bf16(*args),
                          "mtt_mlp_ln_res_bf16")
                return (out,)

            pl = [t.to(bf) for t in (g32, be32, b132, b232)]

            def comp(x=x, pl=pl, w1=w1, w2=w2, C=C):
                xn_ = F.layer_norm(x, (C,), pl[0], pl[1], 1e-6)
                return x + F.linear(F.gelu(F.linear(xn_, w1, pl[2])), w2,
                                    pl[3])

            cases[name + ("" if pdt == f32 else "@bf16_params")] = dict(
                call=call, want=(mlp_ln_res_plain(x, *p[:2], w1, p[2], w2,
                                                  p[3]),), ulps=4,
                library=comp,
                wrapper=lambda x=x, p=p, w1=w1, w2=w2: fused_mlp_ln_res(
                    x, p[0], p[1], w1, p[2], w2, p[3]),
                bound_ms=4.0 * rows * C * Hd / PEAK_BF16 * 1e3,
                bound_by="operations")

    # row 8: the parent's entry takes f32 biases and no hidden scratch
    fc_abi = len(bld._SIGNATURES["mtt_mlp_fc_bf16"]) == 12
    for name, (rows, C, Hd) in {"mlp_fc": (2 * 1029, 1024, 4096),
                                "mlp_fc@swin2": (48 * 96, 512, 2048)
                                }.items():
        x = rnd(rows, C)
        w1, b132 = rnd(Hd, C, std=C ** -0.5), rnd(Hd, std=0.1, dtype=f32)
        w2, b232 = rnd(C, Hd, std=Hd ** -0.5), rnd(C, std=0.1, dtype=f32)
        out, h = torch.empty_like(x), x.new_empty(rows, Hd)
        for pdt in (f32, bf) if fc_abi else (f32,):
            p = [t.to(pdt) for t in (b132, b232)]

            def call(x=x, p=p, w1=w1, w2=w2, out=out, h=h, C=C, Hd=Hd):
                if fc_abi:
                    flags = sum(1 << i for i, t in enumerate(p)
                                if t.dtype == f32)
                    args = (x.data_ptr(), w1.data_ptr(), p[0].data_ptr(),
                            w2.data_ptr(), p[1].data_ptr(), h.data_ptr(),
                            out.data_ptr(), x.shape[0], C, Hd, flags,
                            stream())
                else:
                    args = (x.data_ptr(), w1.data_ptr(), p[0].data_ptr(),
                            w2.data_ptr(), p[1].data_ptr(), out.data_ptr(),
                            x.shape[0], C, Hd, stream())
                bld.check(lib.mtt_mlp_fc_bf16(*args), "mtt_mlp_fc_bf16")
                return (out,)

            pl = [t.to(bf) for t in (b132, b232)]
            cases[name + ("" if pdt == f32 else "@bf16_params")] = dict(
                call=call, want=(mlp_fc_plain(x, w1, p[0], w2, p[1]),),
                ulps=4,
                library=lambda x=x, pl=pl, w1=w1, w2=w2: F.linear(
                    F.gelu(F.linear(x, w1, pl[0])), w2, pl[1]),
                wrapper=lambda x=x, p=p, w1=w1, w2=w2: fused_mlp(
                    x, w1, p[0], w2, p[1]),
                bound_ms=4.0 * rows * C * Hd / PEAK_BF16 * 1e3,
                bound_by="operations")

    # the qkv projection of rows 1-2: the parent's entry takes an f32 bias
    qkv_abi = len(bld._SIGNATURES["mtt_qkv_proj_bf16"]) == 9
    rows, C = 8 * 1029, 1024
    xn, w = rnd(rows, C), rnd(3 * C, C, std=C ** -0.5)
    b32 = rnd(3 * C, std=0.1, dtype=f32)
    qkv = xn.new_empty(rows, 3 * C)
    for pdt in (f32, bf) if qkv_abi else (f32,):
        b = b32.to(pdt)

        def call(b=b, xn=xn, w=w, qkv=qkv, rows=rows, C=C):
            extra = (int(b.dtype == f32),) if qkv_abi else ()
            bld.check(lib.mtt_qkv_proj_bf16(
                xn.data_ptr(), w.data_ptr(), b.data_ptr(), qkv.data_ptr(),
                rows, 3 * C, C, *extra, stream()), "mtt_qkv_proj_bf16")
            return (qkv,)

        cases["qkv_proj" + ("" if pdt == f32 else "@bf16_params")] = dict(
            call=call, want=(qkv_proj_plain(xn, w, b),), ulps=1,
            library=lambda xn=xn, w=w, bl=b32.to(bf): F.linear(xn, w, bl),
            wrapper=lambda b=b, xn=xn, w=w: qkv_proj_cuda(xn, w, b),
            bound_ms=2.0 * rows * C * 3 * C / PEAK_BF16 * 1e3,
            bound_by="operations")

    cases.update(f32_cases(bld, lib, rnd, stream))
    return measure(checkout, bld, cases, launches, reps)


def measure(checkout: Path, bld, cases: dict, launches: int,
            reps: int) -> dict:
    """Errors, equal bits and raw times of ``cases``; the change's wrapper
    times after them."""
    result = {"ptxas": ptxas_lines(bld, ("ln_kernel", "gemm", "mlp_kernel"))}
    for name, c in cases.items():
        # the calls write into one output buffer: copy it between them
        got = tuple(t.clone() for t in c["call"]())
        again = c["call"]()
        torch.cuda.synchronize()
        errs, tols, rels = [], [], []
        for a, w in zip(got, c["want"]):
            errs.append((a.float() - w.float()).abs().max().item())
            if "rel_tol" in c:
                # f32 forms: relative RMS against the exact f32 version
                rels.append(((a.double() - w.double()).norm()
                             / w.double().norm()).item())
                tols.append(float("inf") if rels[-1] <= c["rel_tol"]
                            else -1.0)
            else:
                tols.append(c["ulps"] * 2.0 ** -7
                            * w.float().abs().max().item())
        result[name] = dict(
            ms=raw_ms(c["call"], launches, reps),
            library_ms=raw_ms(c["library"], launches, reps),
            bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            max_abs_err=max(errs),
            within_tol=all(e <= t for e, t in zip(errs, tols)) and all(
                bool(torch.isfinite(a).all()) for a in got),
            equal_bits=all(torch.equal(a, b) for a, b in zip(got, again)))
        if rels:
            result[name]["rel_rms"] = max(rels)
        if "ffma_bound_ms" in c:
            result[name]["ffma_bound_ms"] = c["ffma_bound_ms"]
    # the change's Python entry points after every raw launch is timed, so
    # that both checkouts time their raw launches after the same work
    if checkout == ROOT:
        for name, c in cases.items():
            if "wrapper" in c:
                result[name]["wrapper_ms"] = raw_ms(c["wrapper"], launches,
                                                    reps)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout holding the parent's mtt_tpu_torch/")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rows", choices=("all", "f32"), default="all",
                    help="every row, or the f32 rows alone")
    ap.add_argument("--one", choices=("parent", "change"),
                    help="internal: one run of one checkout, as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mlp_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        checkout = args.parent.resolve() if args.one == "parent" else ROOT
        print(json.dumps(run_one(checkout, args.one, args.launches,
                                 args.reps, args.rows)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        run = subprocess.run(
            [sys.executable, __file__, "--parent", str(args.parent),
             "--launches", str(args.launches), "--reps", str(args.reps),
             "--rows", args.rows, "--one", tag], capture_output=True,
            text=True)
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
        first = runs["change"][0][name]
        row = {k: first[k] for k in ("bound_ms", "bound_by", "ffma_bound_ms")
               if k in first}
        for tag, rs in runs.items():
            if name not in rs[0]:
                continue
            row[f"{tag}_ms"] = [r[name]["ms"] for r in rs]
            row[f"{tag}_library_ms"] = [r[name]["library_ms"] for r in rs]
            if tag == "change" and "wrapper_ms" in rs[0][name]:
                row["change_wrapper_ms"] = [r[name]["wrapper_ms"] for r in rs]
            row[f"{tag}_max_abs_err"] = rs[0][name]["max_abs_err"]
            if "rel_rms" in rs[0][name]:
                row[f"{tag}_rel_rms"] = rs[0][name]["rel_rms"]
            row[f"{tag}_within_tol"] = all(r[name]["within_tol"] for r in rs)
            row[f"{tag}_equal_bits"] = all(r[name]["equal_bits"] for r in rs)
        ok = ok and row["change_within_tol"] and row["change_equal_bits"]
        summary[name] = row
        print(f"[ab] {name}: {json.dumps(row)}", flush=True)
    print(json.dumps({"ab": summary, "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
