"""InvPT cross-task attention with message passing: the CUDA kernel
(csrc/invpt_attention.cu) and its plain version.

Port of mtt_tpu/kernels/invpt_attention.py ``invpt_fused_attention``
(``_kernel``): per head
    scores_h = scale * q_h k_h^T
    fused_h  = sum_c W[h, c] concat_c([scores, msg]) + b[h]    (a 1x1 over heads)
    out_h    = softmax(fused_h) v_h
and ``fused`` is an output in f32: the next stage's message. Without a message
``fused`` is the scores themselves (no mix; ``w`` and ``b`` are None).

Rounding points, kept by the kernel and the plain version alike: scores
accumulated in f32 and scaled after the product; the mix and the softmax (max
subtracted, divided by the row sum) in f32; the probabilities cast to v's
dtype before p.v; that product accumulated in f32 and rounded once.

On the H100 the op is bound by device memory: the f32 message in and the f32
``fused`` out are the largest operands (105 MB each at stage 2 of the PASCAL
ViT-L forward). The kernel reads the message and writes ``fused`` once each;
raw scores and probabilities stay in shared memory. The kv length is constant
across stages (an 8x8 grid per task), so a whole score row fits on chip and no
online softmax is needed.

The gradient is the JAX custom VJP (invpt_attention.py:124-164) in plain
torch, as JAX computes it in XLA: an f32 recompute, with the cotangent that
arrives through the ``fused`` output and dmsg, dw, db.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mtt_tpu_torch.kernels import _build

_QT = 32             # query rows per kernel block (csrc/invpt_attention.cu)
_SMEM_MAX = 232448


def invpt_attention_plain(q, k, v, msg, w, b, scale: float):
    """q (B, H, Lq, D), k/v (B, H, Lk, D); msg (B, H, Lq, Lk) or None; w
    (H, 2H), b (H,) -> (out (B, H, Lq, D) in q's dtype, fused (B, H, Lq, Lk)
    f32). ``_forward_xla`` with the kernel's rounding points."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if msg is not None:
        both = torch.cat([scores, msg.float()], 1)
        fused = torch.einsum("hc,bcqk->bhqk", w.float(), both) \
            + b.float()[None, :, None, None]
    else:
        fused = scores
    p = torch.softmax(fused, -1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)
    return out, fused


def invpt_attention_vjp(q, k, v, msg, w, b, scale: float, dout, dfused_out):
    """invpt_attention.py:_bwd: (dq, dk, dv, dmsg, dw, db); the last three
    are None without a message. Either cotangent may be None."""
    H = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if msg is not None:
        both = torch.cat([scores, msg.float()], 1)
        wf = w.float()
        fused = torch.einsum("hc,bcqk->bhqk", wf, both) \
            + b.float()[None, :, None, None]
    else:
        fused = scores
    p = torch.softmax(fused, -1)
    if dout is not None:
        do = dout.float()
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
        dfused = p * (dp - (dp * p).sum(-1, keepdim=True))
    else:
        dv = torch.zeros_like(vf)
        dfused = torch.zeros_like(p)
    if dfused_out is not None:
        dfused = dfused + dfused_out.float()
    if msg is not None:
        dboth = torch.einsum("hc,bhqk->bcqk", wf, dfused)
        dscores = dboth[:, :H]
        dmsg = dboth[:, H:].to(msg.dtype)
        dw = torch.einsum("bhqk,bcqk->hc", dfused, both).to(w.dtype)
        db = dfused.sum((0, 2, 3)).to(b.dtype)
    else:
        dscores, dmsg, dw, db = dfused, None, None, None
    dq = torch.einsum("bhqk,bhkd->bhqd", dscores, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dscores, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dmsg, dw, db


def _check(q, k, v, msg, w, b):
    if q.dim() != 4 or not q.is_floating_point():
        raise ValueError(f"q must be a floating (B, H, Lq, D) tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, H, Lk, D) = ({B}, {H}, Lk, "
                         f"{D}), got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if (msg is None) != (w is None) or (msg is None) != (b is None):
        raise ValueError("msg, w and b come together or not at all: without "
                         "a message there is no head mix")
    if msg is not None and (msg.shape != (B, H, Lq, Lk)
                            or w.shape != (H, 2 * H) or b.shape != (H,)):
        raise ValueError(f"msg must be ({B}, {H}, {Lq}, {Lk}), w ({H}, "
                         f"{2 * H}) and b ({H},); got {tuple(msg.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    for t in (k, v, msg, w, b):
        if t is not None and t.device != q.device:
            raise ValueError("InvPT attention inputs must be on one device")


def invpt_attention_cuda(q, k, v, msg, w, b, scale: float):
    """The kernel takes bfloat16 q/k/v with 2 heads (both heads of a query
    tile sit in one block, because each fused head reads every head's scores
    and message) and a kv length whose score rows fit in shared memory. The
    head dim and the K/V rows are zero-padded to multiples of 16 for the
    tensor-core tiles (InvPT's stage 2 has head dim 72, NYUD a kv length of
    252): zeros add nothing to q.k^T, the kernel gives the padded keys no
    probability, and the padded output columns are cut."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the InvPT attention kernel takes bfloat16, got "
                        f"{q.dtype}")
    if H != 2:
        raise ValueError(f"the InvPT attention kernel takes 2 heads (every "
                         f"InvPT config), got {H}")
    DP = -(-D // 16) * 16
    LkP = -(-Lk // 16) * 16
    smem = H * _QT * ((DP + 8) * 2 + max(LkP + 8, 32) * 4 + (LkP + 8) * 2)
    if smem > _SMEM_MAX:
        raise ValueError(f"the InvPT attention kernel keeps whole score rows "
                         f"in shared memory (the kv length is 320 on PASCAL "
                         f"and 252 on NYUD at every stage); Lk={Lk} with "
                         f"D={D} does not fit; streaming the keys is "
                         f"ROADMAP.md item 1.11")
    qp = F.pad(q, (0, DP - D)).contiguous()
    kp = F.pad(k, (0, DP - D, 0, LkP - Lk)).contiguous()
    # v transposed to (B, H, DP, LkP): the kernel's p.v fragments then read
    # pairs of keys as single 32-bit words
    vp = F.pad(v, (0, DP - D, 0, LkP - Lk)).transpose(-1, -2).contiguous()
    out = torch.empty(B, H, Lq, DP, dtype=q.dtype, device=q.device)
    fused = torch.empty(B, H, Lq, Lk, dtype=torch.float32, device=q.device)
    if msg is not None:
        msg = msg.float().contiguous()
        w = w.float().contiguous()
        b = b.float().contiguous()
    _build.check(_build.lib().mtt_invpt_attention_bf16(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        msg.data_ptr() if msg is not None else None,
        w.data_ptr() if msg is not None else None,
        b.data_ptr() if msg is not None else None,
        out.data_ptr(), fused.data_ptr(), B, Lq, Lk, LkP, DP, float(scale),
        _build.stream()), "mtt_invpt_attention_bf16")
    return out[..., :D], fused


class _InvPTAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, msg, w, b, scale, impl):
        ctx.save_for_backward(q, k, v, msg, w, b)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        if impl == "plain":
            return invpt_attention_plain(q, k, v, msg, w, b, scale)
        out = invpt_attention_cuda(q, k, v, msg, w, b, scale)
        _build.COUNTS["invpt_attention"] += 1
        return out

    @staticmethod
    def backward(ctx, dout, dfused):
        return (*invpt_attention_vjp(*ctx.saved_tensors, ctx.scale, dout,
                                     dfused), None, None)


def invpt_fused_attention(q, k, v, msg, w, b, scale: float,
                          impl: str | None = None):
    """q, k, v: (B, H, L, D); msg: (B, H, Lq, Lk) or None; w: (H, 2H), b: (H,)
    (None without a message). Returns (attention output (B, H, Lq, D), fused
    scores (B, H, Lq, Lk) f32 = the next stage's message)."""
    _check(q, k, v, msg, w, b)
    return _InvPTAttention.apply(q, k, v, msg, w, b, float(scale),
                                 _build.resolve_impl(impl, q))
