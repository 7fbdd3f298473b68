"""Swin window attention with a per-head bias and a per-window mask: the CUDA
kernel (csrc/window_attention.cu; past 160 tokens a window the Window policy
of csrc/attention_generic.cu) and its plain version.

Port of mtt_tpu/kernels/attention.py ``fused_window_attention``
(``_wattn_kernel``): per (window, head)
    logits = scale * q k^T + bias[head] + mask[window % nW]
    p      = exp(logits - rowmax)
    out    = (p v) / rowsum(p)
The prompt rows and columns are zero entries of the bias and the mask, put
there by the caller.

Rounding points, kept by the kernel and the plain version alike: logits and
the softmax in f32; the unnormalised p cast to v's dtype before p.v; that
product accumulated in f32, divided by the f32 row sum of the unrounded p and
rounded once. Masked entries are -100, so the max-subtracted ``exp`` leaves
them no probability.

On the H100 the op is bound by device memory (q, k, v and the output, 19 MB
each at stage 0 of Swin-B on a 768x1536 input and half as much at each later
stage, against 6 GFLOP). The kernel reads q, k and v as strided views of the
packed qkv projection and writes (BW, M, H * D), ready for the output
projection: none of the four transposes of the TPU wrapper is launched. Its
scores, probabilities and output stay in registers (mma.sync) and the row
max is taken over all keys before any exponential: in one pass for windows
of up to 160 tokens (Swin-B's 147), in two over streamed keys for longer
ones, so it takes any token count.

The gradient ports the JAX custom VJP (``_wattn_bwd``) and its backward
kernel ``_wattn_bwd_kernel`` (csrc/window_attention_bwd.cu, plain twin
``window_attention_bwd_plain``): per (window, head) it recomputes the logits
and the NORMALISED f32 probabilities pn (the backward normalises before it
rounds, the forward after p.v), then dp = g v^T, r = rowsum(dp * pn), dl = pn
(dp - r); dq = bf16(dl) k * scale, dk = bf16(dl)^T q * scale, dv = bf16(pn)^T
g, each accumulated in f32 and rounded once; dbias (H, M, M) f32 is the sum
of the unrounded dl over the windows. The mask gets no gradient (it is a
buffer made from the window geometry). The Swin block hands over its packed
(BW, M, 3, H, D) projection (``fused_window_attention_qkv``): the Function
saves that tensor, not copies, and the backward writes dq, dk and dv into
one packed gradient of the same layout.
"""

from __future__ import annotations

import torch

from mtt_tpu_torch.kernels import _build

HEAD_DIM = 32          # every Swin-B stage: C / heads = 32
BWD_MAX_TOKENS = 160   # the backward's window, padded to 16s


def window_attention_plain(q, k, v, bias, mask, scale: float, nW: int):
    """q, k, v (BW, M, H, D); bias (H, M, M); mask (nW, M, M) or None ->
    (BW, M, H, D) in q's dtype, with the kernel's rounding points."""
    BW = q.shape[0]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits + bias.float()[None]
    if mask is not None:
        logits = logits + mask.float().repeat(BW // nW, 1, 1)[:, None]
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = p.sum(-1, keepdim=True)                          # (BW, H, M, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (o / s.permute(0, 2, 1, 3)).to(q.dtype)


def _check(q, k, v, bias, mask, nW):
    if q.dim() != 4 or not q.is_floating_point():
        raise ValueError(f"q must be a floating (BW, M, H, D) tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    BW, M, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k and v must have q's shape {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if bias.shape != (H, M, M):
        raise ValueError(f"bias must be ({H}, {M}, {M}), got "
                         f"{tuple(bias.shape)}")
    if mask is not None and (mask.shape != (nW, M, M) or nW < 1 or BW % nW):
        raise ValueError(f"mask must be (nW, {M}, {M}) with nW = {nW} "
                         f"dividing the {BW} windows, got {tuple(mask.shape)}")
    for t in (k, v, bias, mask):
        if t is not None and t.device != q.device:
            raise ValueError("window attention inputs must be on one device")


def check_window_attention_shape(M: int, D: int, backward: bool = False
                                 ) -> None:
    """Raises unless the kernels take the windows: head dim 32 (every
    Swin-B stage); any token count forward (the keys stream through the
    kernel), at most BWD_MAX_TOKENS backward (a window's tiles sit in shared
    memory)."""
    what = "backward kernel" if backward else "kernel"
    if D != HEAD_DIM:
        raise ValueError(f"the window attention {what} takes head dim "
                         f"{HEAD_DIM} (every Swin-B stage), got {D}")
    if M < 1:
        raise ValueError(f"the window attention {what} needs tokens, got "
                         f"M={M}")
    if backward and -(-M // 16) * 16 > BWD_MAX_TOKENS:
        raise ValueError(f"the window attention backward kernel keeps a "
                         f"window's q, k, v, g, probabilities and gradients "
                         f"in shared memory; M={M} tokens do not fit (at "
                         f"most {BWD_MAX_TOKENS}; Swin-B's window is 147)")


def _strided(t):
    """True if the kernel can read ``t`` (BW, M, H, D) where it lies: unit
    stride along D, every row 16-byte aligned."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3]))


def window_attention_cuda(q, k, v, bias, mask, scale: float, nW: int):
    """Launches the kernel; counts nothing (the wrapper counts). q, k and v
    may be views of one packed (BW, M, 3, H, D) projection; other layouts are
    copied once. Returns a (BW, M, H, D) view of a contiguous (BW, M, H * D)
    tensor."""
    BW, M, H, D = q.shape
    if q.dtype == torch.float32:
        raise _build.no_f32_form("the window attention kernel (row 11)")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the window attention kernel takes bfloat16, got "
                        f"{q.dtype}")
    check_window_attention_shape(M, D)
    if not (all(_strided(t) for t in (q, k, v))
            and q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = bias.float().contiguous()
    if mask is not None:
        mask = mask.float().contiguous()
    out = torch.empty(BW, M, H * D, dtype=q.dtype, device=q.device)
    sb, sm, sh, _ = q.stride()
    _build.check(_build.lib().mtt_window_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(), BW, M,
        H, nW if mask is not None else 1, sb, sm, sh, float(scale),
        _build.stream()), "mtt_window_attention_bf16")
    return out.view(BW, M, H, D)


def window_attention_bwd_plain(q, k, v, bias, mask, g, scale: float,
                               nW: int):
    """The backward at the TPU kernel's rounding points: (dq, dk, dv) in q's
    dtype, each (BW, M, H, D), and dbias (H, M, M) f32."""
    BW = q.shape[0]
    qf, kf = q.float(), k.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    logits = logits + bias.float()[None]
    if mask is not None:
        logits = logits + mask.float().repeat(BW // nW, 1, 1)[:, None]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    pn = e / e.sum(-1, keepdim=True)                     # (BW, H, M, M) f32
    gf = g.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    dl = pn * (dp - (dp * pn).sum(-1, keepdim=True))
    dlb = dl.to(q.dtype).float()
    dq = (torch.einsum("bhqk,bkhd->bqhd", dlb, kf) * scale).to(q.dtype)
    dk = (torch.einsum("bhqk,bqhd->bkhd", dlb, qf) * scale).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", pn.to(q.dtype).float(), gf
                      ).to(v.dtype)
    return dq, dk, dv, dl.sum(0)


def bwd_window_chunks(BW: int, H: int, sms: int = 132) -> int:
    """Windows a backward block walks in order; each block keeps its
    windows' dl sum, one f32 partial of dbias, in registers. The chunk gives
    at most one block per (window chunk, head) on each of the card's ``sms``
    SMs (the kernel keeps 205 KB of tiles and matrices in shared memory: one
    block an SM), in one wave."""
    return max(1, -(-BW * H // sms))


def window_attention_bwd_cuda(q, k, v, bias, mask, g, scale: float, nW: int):
    """Launches the backward kernel and the fixed-order sum of its dbias
    partials; counts nothing (the Function counts). q, k, v as the forward
    takes them. Returns (dqkv (BW, M, 3, H, D) in q's dtype, dbias (H, M, M)
    f32)."""
    BW, M, H, D = q.shape
    if q.dtype == torch.float32:
        raise _build.no_f32_form("the window attention backward kernel "
                                 "(row 12)")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the window attention backward kernel takes "
                        f"bfloat16, got {q.dtype}")
    check_window_attention_shape(M, D, backward=True)
    if not (all(_strided(t) for t in (q, k, v))
            and q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    g = g.to(q.dtype)
    if not _strided(g):
        g = g.contiguous()
    bias = bias.float().contiguous()
    if mask is not None:
        mask = mask.float().contiguous()
    wpc = bwd_window_chunks(BW, H, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    nchunk = -(-BW // wpc)
    dqkv = torch.empty(BW, M, 3, H, D, dtype=q.dtype, device=q.device)
    work = torch.empty(nchunk, H, M, M, dtype=torch.float32, device=q.device)
    dbias = torch.empty(H, M, M, dtype=torch.float32, device=q.device)
    sb, sm, sh, _ = q.stride()
    gb, gm, gh, _ = g.stride()
    _build.check(_build.lib().mtt_window_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        bias.data_ptr(), mask.data_ptr() if mask is not None else None,
        dqkv.data_ptr(), work.data_ptr(), dbias.data_ptr(), BW, M, H,
        nW if mask is not None else 1, sb, sm, sh, gb, gm, gh, wpc,
        float(scale), _build.stream()), "mtt_window_attention_bwd_bf16")
    return dqkv, dbias


def _forward(q, k, v, bias, mask, scale, nW, impl):
    if impl == "plain":
        return window_attention_plain(q, k, v, bias, mask, scale, nW)
    out = window_attention_cuda(q, k, v, bias, mask, scale, nW)
    _build.COUNTS["window_attention"] += 1
    return out


class _WindowAttention(torch.autograd.Function):
    """Window attention over a packed (BW, M, 3, H, D) projection; the
    gradient is the packed dqkv and dbias."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, nW, impl):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.cfg = (scale, nW, impl)
        return _forward(*qkv.unbind(2), bias, mask, scale, nW, impl)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, mask = ctx.saved_tensors
        scale, nW, impl = ctx.cfg
        q, k, v = qkv.unbind(2)
        if impl == "plain":
            dq, dk, dv, dbias = window_attention_bwd_plain(
                q, k, v, bias, mask, g, scale, nW)
            dqkv = torch.stack((dq, dk, dv), 2)
        else:
            dqkv, dbias = window_attention_bwd_cuda(q, k, v, bias, mask, g,
                                                    scale, nW)
            _build.COUNTS["window_attention_bwd"] += 1
        dbias = dbias.to(bias.dtype) if ctx.needs_input_grad[1] else None
        return dqkv, dbias, None, None, None, None


def fused_window_attention_qkv(qkv, bias, mask, scale: float, nW: int,
                               impl: str | None = None):
    """``fused_window_attention`` on the packed projection qkv (BW, M, 3, H,
    D), as the Swin block makes it; differentiable in qkv and bias."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be a packed (BW, M, 3, H, D) tensor, got "
                         f"{tuple(qkv.shape)}")
    q, k, v = qkv.unbind(2)
    _check(q, k, v, bias, mask, nW)
    return _WindowAttention.apply(qkv, bias, mask, scale, nW,
                                  _build.resolve_impl(impl, qkv))


def fused_window_attention(q, k, v, bias, mask, scale: float, nW: int,
                           impl: str | None = None):
    """Swin window attention over (B*nW, M, H, D) with a per-head additive
    bias (H, M, M) and an optional per-window mask (nW, M, M), window ``w``
    taking ``mask[w % nW]``. Returns (B*nW, M, H, D). The JAX package's
    signature: ``fused_window_attention_qkv`` on a packed copy of q, k, v."""
    _check(q, k, v, bias, mask, nW)
    return fused_window_attention_qkv(torch.stack((q, k, v), 2), bias, mask,
                                      scale, nW, impl)
