"""Hold this checkout's bf16 kernels to a parent checkout's bits on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    mkdir -p build/parent && git archive <parent> mtt_tpu_torch | tar -x -C build/parent
    python3 tools/torch_bf16_bits.py --parent build/parent

Each checkout runs in a process of its own (two kernel libraries in one
process give wrong results: two static CUDA runtimes), imports its own
``mtt_tpu_torch`` and calls its public bf16 kernel entry points on the same
seeded inputs at the main paths' shapes and at ragged ones: row 3
(``fused_layernorm``) at widths from 6 to 16384, packed and not, with f32
and bf16 parameters; row 4 at ViT-L's and a zero-padded width; rows 1-2
(cached and emit) and 13 (fast and safe); row 14; row 5's one launch and
split form; row 6 at PASCAL's and NYUD's widths; row 8 and the projection.
It prints the card's name and power limit and, per case, whether the
outputs of the two checkouts are equal to the bit, and fails unless all
are.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cases(torch):
    """(name, thunk) of every case; each thunk returns a tuple of tensors."""
    from mtt_tpu_torch.kernels.attention import (fused_attention,
                                                 fused_attention_ln_qkv,
                                                 fused_attention_qkv,
                                                 qkv_proj_cuda)
    from mtt_tpu_torch.kernels.head_up4 import fused_up4_head
    from mtt_tpu_torch.kernels.layernorm import fused_layernorm
    from mtt_tpu_torch.kernels.mlp import fused_mlp, fused_mlp_ln_res
    from mtt_tpu_torch.kernels.task_decode import fused_task_decode

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, std=1.0, mean=0.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device="cuda") * std
                + mean).to(dtype)

    cases = []
    for shape in ((7, 6), (5, 64), (3001, 128), (8, 1029, 1024), (2, 5, 830),
                  (2, 9, 1660), (2, 5, 7, 2880), (3, 11, 4096),
                  (3, 7, 5440), (2, 16384)):
        for pd in (f32, bf):
            C = shape[-1]
            x = rnd(*shape)
            g, b = rnd(C, std=0.1, mean=1.0, dtype=pd), rnd(C, std=0.1,
                                                             dtype=pd)
            cases.append((f"layernorm {shape} {pd}",
                          lambda x=x, g=g, b=b: (fused_layernorm(x, g, b),)))
    for C, Hd, rows in ((1024, 4096, 8232), (166, 664, 129)):
        x = rnd(rows, C)
        args = (x, rnd(C, std=0.1, mean=1.0, dtype=f32),
                rnd(C, std=0.1, dtype=f32), rnd(Hd, C, std=C ** -0.5),
                rnd(Hd, std=0.1, dtype=f32), rnd(C, Hd, std=Hd ** -0.5),
                rnd(C, std=0.1, dtype=f32))
        cases.append((f"mlp_ln_res {rows}x{C} hidden {Hd}",
                      lambda a=args: (fused_mlp_ln_res(*a),)))
        cases.append((f"mlp_fc {rows}x{C} hidden {Hd}",
                      lambda a=args: (fused_mlp(a[0], *a[3:]),)))
    C, H = 1024, 16
    x = rnd(8, 1029, C)
    fa = (x, rnd(C, std=0.1, mean=1.0, dtype=f32), rnd(C, std=0.1, dtype=f32),
          rnd(3 * C, C, std=C ** -0.5), rnd(3 * C, std=0.1, dtype=f32))
    for emit in (False, True):
        for safe in (False, True):
            cases.append((f"attention front half emit={emit} safe={safe}",
                          lambda e=emit, s=safe: tuple(
                              fused_attention_ln_qkv(*fa, H, need_qkv=e,
                                                     safe=s) if e else
                              (fused_attention_ln_qkv(*fa, H, safe=s),))))
    cases.append(("qkv projection", lambda: (qkv_proj_cuda(
        fa[0].reshape(-1, C), fa[3], fa[4]),)))
    qkv = rnd(2, 77, 4 * 3 * 80, std=1.5)
    for safe in (False, True):
        cases.append((f"attention qkv D=80 safe={safe}",
                      lambda s=safe: (fused_attention_qkv(qkv, 4, safe=s),)))
    q, k = rnd(8, 1029, 16, 64, std=2.0), rnd(8, 300, 16, 64)
    cases.append(("attention generic", lambda: (fused_attention(q, k, k),)))
    for tar, fin, C, G in ((300, 350, 1024, 16), (768, 768, 256, 4)):
        B, S, T = 2, 1024, 5
        dargs = (rnd(B, S, C), rnd(B, T, S, G, dtype=f32),
                 rnd(B, T, C, dtype=f32), rnd(T, tar, C, std=C ** -0.5),
                 rnd(T, tar, std=0.1, dtype=f32),
                 rnd(T, tar, C, std=C ** -0.5),
                 rnd(T, tar, std=0.1, dtype=f32),
                 rnd(T, fin, 2 * tar, std=(2 * tar) ** -0.5),
                 rnd(T, fin, std=0.1, dtype=f32))
        cases.append((f"task decode tar {tar} F {fin}",
                      lambda a=dargs: (fused_task_decode(*a),)))
    for B, gh, gw, C, n in ((8, 32, 32, 350, 21), (2, 28, 36, 768, 40)):
        hargs = (rnd(B, gh, gw, C, std=0.5),
                 rnd(3, 3, C, C, std=(9 * C) ** -0.5, dtype=f32),
                 rnd(C, std=0.1, mean=1.0, dtype=f32),
                 rnd(C, std=0.1, dtype=f32), rnd(C, n, std=C ** -0.5,
                                                 dtype=f32))
        cases.append((f"up4 head {(B, gh, gw, C)} n {n}",
                      lambda a=hargs: (fused_up4_head(*a),)))
    return cases


def run(checkout: str, out: str) -> None:
    """One checkout's outputs of every case, saved to ``out``."""
    sys.path.insert(0, str(Path(checkout).resolve()))
    import torch
    outs = {}
    for name, thunk in _cases(torch):
        outs[name] = [t.cpu() for t in thunk()]
    torch.cuda.synchronize()
    torch.save(outs, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the parent (its mtt_tpu_torch)")
    ap.add_argument("--run", nargs=2, metavar=("CHECKOUT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run:
        run(*args.run)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "bf16_bits"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for tag, checkout in (("parent", args.parent), ("change", str(ROOT))):
        paths[tag] = out_dir / f"{tag}.pt"
        subprocess.run([sys.executable, __file__, "--parent", args.parent,
                        "--run", checkout, str(paths[tag])], check=True)
    import torch
    got = {tag: torch.load(p) for tag, p in paths.items()}
    ok = True
    for name, want in got["parent"].items():
        have = got["change"][name]
        equal = len(have) == len(want) and all(
            torch.equal(a, b) for a, b in zip(have, want))
        ok = ok and equal
        print(f"[bf16 bits] {name}: {'equal' if equal else 'DIFFER'}",
              flush=True)
    print(f"[bf16 bits] {len(got['parent'])} cases, "
          f"{'all equal to the parent' if ok else 'some differ'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
