"""TaskPrompter per-task spatial + channel decode with the first fuse
projection: the CUDA kernel (csrc/task_decode.cu) and its plain version.

Port of mtt_tpu/kernels/task_decode.py ``fused_task_decode``
(``_decode_kernel``), chan_nheads == 1. The TPU wrapper padded S to 128 for
its tiling; the CUDA kernel reads x, ws, wc and wf with TMA, whose zero fill
covers the ragged rows, tar, F and K, so nothing is padded per call, and it
masks the store of y. a, cw and the biases are read as stored (f32 or bf16).
Past the one launch's tar 304 and F 352 (TaskPrompter-ViT-L at embed_dim
768) the split form runs: the kernel's phases F and FC into a bf16 [f; fc]
scratch, then one launch of the shared GEMM a task (the JAX wrapper sends
that shape to its XLA composition ``_decode_xla``).

At f32 the one launch's widths run its f32 form (csrc/task_decode_f32.cu,
``task_decode_f32``: the three products in f32 on the CUDA cores, nothing
rounded, counted under ``task_decode_f32``); the split form has no f32
form yet (ROADMAP.md item 1.14).

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


def task_decode_ff_plain(x, a, cw, ws, bs, wc, bc):
    """[f; fc] (B, S, T, 2 tar) in the activation dtype, at the TPU kernel's
    rounding points: x * a + x and x * cw + x in the activation dtype; f
    and fc summed in f32 with their biases, rounded once. The first stage
    of the split form, and of the one launch."""
    B, S, C = x.shape
    G = a.shape[-1]
    xt = x[:, None]                                         # (B, 1, S, C)
    at_c = a.to(x.dtype).repeat_interleave(C // G, dim=-1)  # (B, T, S, C)
    f_in = xt * at_c + xt
    fc_in = xt * cw.to(x.dtype)[:, :, None] + xt
    f = (torch.einsum("btsc,trc->bstr", f_in.float(), ws.float())
         + bs.float()).to(x.dtype)
    fc = (torch.einsum("btsc,trc->bstr", fc_in.float(), wc.float())
          + bc.float()).to(x.dtype)
    return torch.cat([f, fc], -1)


def task_decode_fuse_plain(ff, wf, bf):
    """y = [f; fc] . wf^T + bf per task, summed in f32 over the 2 tar
    columns at once, rounded once: (B, S, T, 2 tar) -> (B, S, T * F)."""
    B, S, T, _ = ff.shape
    y = torch.einsum("bstr,tfr->bstf", ff.float(), wf.float()) \
        + bf.float()
    return y.to(ff.dtype).reshape(B, S, -1)


def task_decode_plain(x, a, cw, ws, bs, wc, bc, wf, bf):
    """Rounding points of the TPU kernel: x * a + x and x * cw + x in the
    activation dtype; f and fc cast to it before the fuse; y in f32, cast
    once. Written as the split form's two stages, whose cut is the one
    launch's bf16 rounding of [f; fc]."""
    return task_decode_fuse_plain(
        task_decode_ff_plain(x, a, cw, ws, bs, wc, bc), wf, bf)


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
    """Raises unless the kernels take the widths: C and C / G multiples of
    8 (TMA rows of 16-byte pitch, whole 16-byte units of one head group),
    tar and F positive. Any tar and F run: the one launch up to MAX_TAR and
    MAX_FIN (``task_decode_one_launch``), the split form past them."""
    if C % 8 or C % G or (C // G) % 8 or tar < 1 or fin < 1:
        raise ValueError(
            f"the task-decode kernel needs C % 8 == 0, (C / G) % 8 == 0, "
            f"tar >= 1 and F >= 1; got C={C}, G={G}, tar={tar}, F={fin}")


def task_decode_one_launch(tar: int, fin: int) -> bool:
    """True where the one-launch kernel takes tar and F: tar a multiple of
    4 up to MAX_TAR (wf's rows of 2 tar elements at a 16-byte pitch), F even
    up to MAX_FIN (the 4-byte stores of y). Elsewhere the split form runs
    (TaskPrompter-ViT-L at tar = F = 768)."""
    return tar % 4 == 0 and tar <= MAX_TAR and fin % 2 == 0 \
        and fin <= MAX_FIN


def task_decode_split_padded(x, a, cw, ws, bs, wc, bc, wf, bf, run):
    """``run`` (the split form's launches, or in the tests its plain
    stages) at tar and F rounded up to multiples of 8: ws, wc, bs and bc
    gain zero rows, so f and fc gain exact-zero columns, wf gains zero
    columns at those places of [f; fc] (exact zeros in every sum) and zero
    rows, bf zeros; the output's padded columns of each task are
    dropped."""
    B, S, _ = x.shape
    T, tar, C = ws.shape
    fin = wf.shape[1]
    TP, FP = _build.round8(tar), _build.round8(fin)
    wfp = _build.pad_to(wf.reshape(T, fin, 2, tar), FP, 2, TP)
    y = run(x, a, cw, _build.pad_to(ws, TP, C), _build.pad_to(bs, TP),
            _build.pad_to(wc, TP, C), _build.pad_to(bc, TP),
            wfp.reshape(T, FP, 2 * TP), _build.pad_to(bf, FP))
    if FP == fin:
        return y
    return y.reshape(B, S, T, FP)[..., :fin].reshape(B, S, T * fin)


def _task_decode_split_launch(x, a, cw, ws, bs, wc, bc, wf, bf):
    """tar % 8 == 0, F % 8 == 0: the split form's T + 1 launches, [f; fc]
    through a (B, S, T, 2 tar) bf16 scratch from torch.empty."""
    B, S, C = x.shape
    T, tar, _ = ws.shape
    fin = wf.shape[1]
    flags = _build.param_flags(a, cw, bs)
    _build.check_aligned("the task-decode kernel", x, ws, wc, wf, bs, bc, bf)
    ff = torch.empty(B, S, T, 2 * tar, dtype=x.dtype, device=x.device)
    out = torch.empty(B, S, T * fin, dtype=x.dtype, device=x.device)
    _build.check(_build.lib().mtt_task_decode_split_bf16(
        x.data_ptr(), a.data_ptr(), cw.data_ptr(), ws.data_ptr(),
        bs.data_ptr(), wc.data_ptr(), bc.data_ptr(), wf.data_ptr(),
        bf.data_ptr(), ff.data_ptr(), out.data_ptr(), B, S, C, T, a.shape[-1],
        tar, fin, flags, _build.stream()), "mtt_task_decode_split_bf16")
    return out


def task_decode_cuda(x, a, cw, ws, bs, wc, bc, wf, bf):
    """One launch where it takes tar and F (``task_decode_one_launch``);
    nothing is padded or cast per call there: the weights are read as the
    grouped convs store them, a, cw and the biases in their stored dtype
    (the three biases share one). Past it the split form
    (``task_decode_split_padded``)."""
    B, S, C = x.shape
    T, tar, _ = ws.shape
    fin = wf.shape[1]
    G = a.shape[-1]
    if x.dtype == torch.float32:
        return task_decode_f32(x, a, cw, ws, bs, wc, bc, wf, bf)
    dt = torch.bfloat16
    if x.dtype != dt or ws.dtype != dt or wc.dtype != dt or wf.dtype != dt:
        raise TypeError("the task-decode kernel takes bfloat16 x and weights")
    check_task_decode_widths(C, G, tar, fin)
    if not bs.dtype == bc.dtype == bf.dtype:
        raise TypeError(f"the task-decode biases must share a dtype, got "
                        f"{bs.dtype}, {bc.dtype}, {bf.dtype}")
    if not task_decode_one_launch(tar, fin):
        return task_decode_split_padded(x, a, cw, ws, bs, wc, bc, wf, bf,
                                        _task_decode_split_launch)
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


def task_decode_f32(x, a, cw, ws, bs, wc, bc, wf, bf):
    """The f32 form of the one launch (csrc/task_decode_f32.cu): every
    tensor f32, the three products in f32, nothing rounded; the one
    launch's widths (``task_decode_one_launch``). The split form past them
    has no f32 form yet."""
    B, S, C = x.shape
    T, tar, _ = ws.shape
    fin = wf.shape[1]
    G = a.shape[-1]
    args = (x, a, cw, ws, bs, wc, bc, wf, bf)
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError(f"the task-decode kernel's f32 form takes every "
                        f"tensor in f32, got {[t.dtype for t in args]}")
    check_task_decode_widths(C, G, tar, fin)
    if not task_decode_one_launch(tar, fin):
        raise _build.no_f32_form(f"the task-decode kernel's split form (tar "
                                 f"{tar}, F {fin})")
    _build.check_aligned("the task-decode kernel", *args)
    out = torch.empty(B, S, T * fin, dtype=x.dtype, device=x.device)
    _build.check(_build.lib().mtt_task_decode_f32(
        *(t.data_ptr() for t in args), out.data_ptr(), B, S, C, T, G, tar,
        fin, _build.stream()), "mtt_task_decode_f32")
    return out


class _TaskDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, impl, *args):
        ctx.save_for_backward(*args)
        if impl == "plain":
            return task_decode_plain(*args)
        out = task_decode_cuda(*args)
        _build.count("task_decode", args[0].dtype)
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
