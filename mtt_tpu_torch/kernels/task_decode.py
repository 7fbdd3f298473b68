"""TaskPrompter per-task spatial + channel decode with the first fuse
projection: the CUDA kernel (csrc/task_decode.cu) and its plain version.

Port of mtt_tpu/kernels/task_decode.py ``fused_task_decode``
(``_decode_kernel``), chan_nheads == 1. The TPU wrapper padded S to 128 for
its tiling; the CUDA kernel reads x, ws, wc and wf with TMA, whose zero fill
covers the ragged rows, tar, F and K, so nothing is padded per call, and it
masks the store of y. a, cw and the biases are read as stored (f32 or bf16).

Layouts follow the grouped 1x1 convs' torch weights viewed per task:
x (B, S, C); a (B, T, S, G) head-major groups; cw (B, T, C);
ws/wc (T, tar, C); bs/bc (T, tar); wf (T, F, 2 tar) with [f; fc] input
order; bf (T, F). Returns (B, S, T*F), task-major, where
  y_t = [f_t; fc_t] @ wf_t^T + bf_t,
  f_t  = (x * expand(a_t) + x) @ ws_t^T + bs_t,
  fc_t = (x * cw_t + x) @ wc_t^T + bc_t.

The gradient is the VJP of the XLA composition ``_decode_xla``, as the JAX
package's custom VJP takes it (task_decode.py:176-181): torch autograd through
``task_decode_plain``, which rounds where ``_decode_xla`` rounds. That is the
backward's composition in plain torch, as it is XLA in JAX; the forward on a
CUDA tensor always runs the kernel.
"""

from __future__ import annotations

import torch

from mtt_tpu_torch.kernels import _build


def task_decode_plain(x, a, cw, ws, bs, wc, bc, wf, bf):
    """Rounding points of the TPU kernel: x * a + x and x * cw + x in the
    activation dtype; f and fc cast to it before the fuse; y in f32, cast
    once."""
    B, S, C = x.shape
    T, tar, _ = ws.shape
    G = a.shape[-1]
    xt = x[:, None]                                         # (B, 1, S, C)
    at_c = a.to(x.dtype).repeat_interleave(C // G, dim=-1)  # (B, T, S, C)
    f_in = xt * at_c + xt
    fc_in = xt * cw.to(x.dtype)[:, :, None] + xt
    f = (torch.einsum("btsc,trc->btsr", f_in.float(), ws.float())
         + bs.float()[None, :, None]).to(x.dtype)
    fc = (torch.einsum("btsc,trc->btsr", fc_in.float(), wc.float())
          + bc.float()[None, :, None]).to(x.dtype)
    y = (torch.einsum("btsr,tfr->btsf", f.float(), wf[:, :, :tar].float())
         + torch.einsum("btsr,tfr->btsf", fc.float(), wf[:, :, tar:].float())
         + bf.float()[None, :, None])
    return y.to(x.dtype).permute(0, 2, 1, 3).reshape(B, S, -1)


def _check(x, a, cw, ws, bs, wc, bc, wf, bf):
    if x.dim() != 3 or not x.is_floating_point():
        raise ValueError(f"x must be a floating (B, S, C) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, S, C = x.shape
    if ws.dim() != 3:
        raise ValueError(f"ws must be (T, tar, C), got {tuple(ws.shape)}")
    T, tar, _ = ws.shape
    if a.dim() != 4 or a.shape[:3] != (B, T, S) or C % a.shape[-1]:
        raise ValueError(f"a must be (B, T, S, G) with G dividing C, got "
                         f"{tuple(a.shape)}")
    if wf.dim() != 3:
        raise ValueError(f"wf must be (T, F, 2*tar), got {tuple(wf.shape)}")
    fin = wf.shape[1]
    want = {"cw": (cw, (B, T, C)), "ws": (ws, (T, tar, C)),
            "wc": (wc, (T, tar, C)), "bs": (bs, (T, tar)),
            "bc": (bc, (T, tar)), "wf": (wf, (T, fin, 2 * tar)),
            "bf": (bf, (T, fin))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for t in (x, a, cw, ws, bs, wc, bc, wf, bf):
        if not t.is_contiguous():
            raise ValueError("task-decode inputs must be contiguous")
        if t.device != x.device:
            raise ValueError("task-decode inputs must be on one device")


MAX_TAR, MAX_FIN = 304, 352   # two consumer warpgroups' wgmma widths


def check_task_decode_widths(C: int, G: int, tar: int, fin: int) -> None:
    """Raises unless the kernel takes the widths: C and C / G multiples of 8
    (TMA rows of 16-byte pitch, whole 16-byte units of one head group), tar
    a multiple of 4 up to MAX_TAR (wf's rows of 2 tar elements at a 16-byte
    pitch) and F even up to MAX_FIN (the 4-byte stores of y)."""
    if C % 8 or C % G or (C // G) % 8 or tar % 4 or tar > MAX_TAR \
            or fin % 2 or fin > MAX_FIN:
        raise ValueError(
            f"the task-decode kernel needs C % 8 == 0, (C / G) % 8 == 0, "
            f"tar % 4 == 0 and tar <= {MAX_TAR}, F % 2 == 0 and F <= "
            f"{MAX_FIN}; got C={C}, G={G}, tar={tar}, F={fin}")


def task_decode_cuda(x, a, cw, ws, bs, wc, bc, wf, bf):
    """One launch; nothing is padded or cast per call: the weights are read
    as the grouped convs store them, a, cw and the biases in their stored
    dtype (the three biases share one)."""
    B, S, C = x.shape
    T, tar, _ = ws.shape
    fin = wf.shape[1]
    G = a.shape[-1]
    dt = torch.bfloat16
    if x.dtype != dt or ws.dtype != dt or wc.dtype != dt or wf.dtype != dt:
        raise TypeError("the task-decode kernel takes bfloat16 x and weights")
    check_task_decode_widths(C, G, tar, fin)
    if not bs.dtype == bc.dtype == bf.dtype:
        raise TypeError(f"the task-decode biases must share a dtype, got "
                        f"{bs.dtype}, {bc.dtype}, {bf.dtype}")
    flags = _build.param_flags(a, cw, bs)
    # TMA's operands; the biases are read in pairs
    _build.check_aligned("the task-decode kernel", x, ws, wc, wf, bs, bc, bf)
    out = torch.empty(B, S, T * fin, dtype=dt, device=x.device)
    _build.check(_build.lib().mtt_task_decode_bf16(
        x.data_ptr(), a.data_ptr(), cw.data_ptr(), ws.data_ptr(),
        bs.data_ptr(), wc.data_ptr(), bc.data_ptr(), wf.data_ptr(),
        bf.data_ptr(), out.data_ptr(), B, S, C, T, G, tar, fin, flags,
        _build.stream()), "mtt_task_decode_bf16")
    return out


class _TaskDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, *args):
        ctx.save_for_backward(*args)
        if impl == "plain":
            return task_decode_plain(*args)
        out = task_decode_cuda(*args)
        _build.COUNTS["task_decode"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        args = [t.detach().requires_grad_(t.is_floating_point())
                for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = task_decode_plain(*args)
        need = [t for t in args if t.requires_grad]
        grads = iter(torch.autograd.grad(y, need, g))
        return (None, *[next(grads) if t.requires_grad else None
                        for t in args])


def fused_task_decode(x, a, cw, ws, bs, wc, bc, wf, bf,
                      impl: str | None = None) -> torch.Tensor:
    """Per-task spatial + channel decode and first fuse projection; see the
    module docstring for shapes."""
    _check(x, a, cw, ws, bs, wc, bc, wf, bf)
    return _TaskDecode.apply(_build.resolve_impl(impl, x), x, a, cw, ws, bs,
                             wc, bc, wf, bf)
