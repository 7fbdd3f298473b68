"""TaskPrompter per-task spatial + channel decode with the first fuse
projection: the CUDA kernel (csrc/task_decode.cu) and its plain version.

Port of mtt_tpu/kernels/task_decode.py ``fused_task_decode``
(``_decode_kernel``), chan_nheads == 1. The TPU wrapper padded S to 128 for
its tiling; the CUDA kernel masks its ragged row block instead. tar and F need
not be multiples of 16: the wrapper pads the weight rows with zeros, so the
padded f/fc columns are exactly 0, and the kernel masks the store of y.

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
import torch.nn.functional as F

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


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def task_decode_cuda(x, a, cw, ws, bs, wc, bc, wf, bf):
    B, S, C = x.shape
    T, tar, _ = ws.shape
    fin = wf.shape[1]
    G = a.shape[-1]
    dt = torch.bfloat16
    if x.dtype != dt or ws.dtype != dt or wc.dtype != dt or wf.dtype != dt:
        raise TypeError("the task-decode kernel takes bfloat16 x and weights")
    TP, FP = _pad16(tar), _pad16(fin)
    if C % 16 or (C // G) % 8 or TP > 384 or FP > 384 or C > 1024:
        raise ValueError(f"the task-decode kernel needs C % 16 == 0, "
                         f"C <= 1024, (C / G) % 8 == 0, tar and F <= 384; "
                         f"got C={C}, G={G}, tar={tar}, F={fin}")
    # zero rows pad tar and F to 16; the [f; fc] halves of wf each to TP
    wsp = F.pad(ws, (0, 0, 0, TP - tar))
    wcp = F.pad(wc, (0, 0, 0, TP - tar))
    wfp = torch.zeros(T, FP, 2 * TP, dtype=dt, device=x.device)
    wfp[:, :fin, :tar] = wf[:, :, :tar]
    wfp[:, :fin, TP:TP + tar] = wf[:, :, tar:]
    bsp = F.pad(bs.float(), (0, TP - tar))
    bcp = F.pad(bc.float(), (0, TP - tar))
    bfp = F.pad(bf.float(), (0, FP - fin))
    ab = a.to(dt).contiguous()
    cwb = cw.to(dt).contiguous()
    out = torch.empty(B, S, T * fin, dtype=dt, device=x.device)
    _build.check(_build.lib().mtt_task_decode_bf16(
        x.data_ptr(), ab.data_ptr(), cwb.data_ptr(), wsp.data_ptr(),
        bsp.data_ptr(), wcp.data_ptr(), bcp.data_ptr(), wfp.data_ptr(),
        bfp.data_ptr(), out.data_ptr(), B, S, C, T, G, TP, fin, FP,
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
