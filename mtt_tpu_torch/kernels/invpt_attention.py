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
ViT-L forward; bytes per launch in ``invpt_attention_cuda``). The kernel
reads the message and writes ``fused`` once each and keeps a block's fused
rows in shared memory from the score product to p.v. The kv length is
constant across stages (an 8x8 grid per task on PASCAL), so a whole fused row
fits on chip and no online softmax is needed; past 320 keys or head dim 480
(Cityscapes-3D at 1024x2048, embed_dim 1024) the streamed form writes fused
to device memory and reads it back for the softmax, still with the exact max
over all keys before p is rounded.

The gradient is the JAX custom VJP (invpt_attention.py:124-164) in plain
torch, as JAX computes it in XLA: an f32 recompute, with the cotangent that
arrives through the ``fused`` output and dmsg, dw, db.
"""

from __future__ import annotations

import ctypes

import torch

from mtt_tpu_torch.kernels import _build


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


# The kernel's reach (csrc/invpt_attention.cu): the resident kernel up to
# 320 keys and head dim 480 (a block keeps its rows' fused scores for every
# key in shared memory, one TMA box a half-row, q and K rows in at most two
# boxes), the streamed form past either, up to these.
MAXK = 65536
MAXD = 1024


def check_invpt_attention_shape(H: int, Lk: int, D: int) -> None:
    """Raises where the kernel does not reach: 2 heads, a kv length from 1
    to 65536 and a head dim up to 1024 (the kernel reads 16-byte rows: a
    head dim that is not a multiple of 8 is zero-padded to one by the
    wrapper, ``invpt_attention_padded``). InvPT's kv length is 320 on
    PASCAL, 252 on NYUD and 1024 on Cityscapes-3D's 1024x2048 frames; its
    stage-0 head dim is (embed_dim + 64) / 2, 288 at embed_dim 512, 332 at
    600 (stage 2: 83) and 544 at 1024. The resident kernel takes up to 320
    keys and head dim 480; longer or wider rows take the streamed form
    (``invpt_attention_plan``)."""
    if H != 2:
        raise ValueError(f"the InvPT attention kernel takes 2 heads (every "
                         f"InvPT config), got {H}")
    if not 1 <= Lk <= MAXK:
        raise ValueError(f"the InvPT attention kernel takes kv lengths from "
                         f"1 to {MAXK} (InvPT's is 320 on PASCAL, 252 on "
                         f"NYUD, 1024 on Cityscapes-3D); got Lk={Lk}")
    if D < 1 or _build.round8(D) > MAXD:
        raise ValueError(f"the InvPT attention kernel takes a head dim from "
                         f"1 up to {MAXD} (zero-padded to a multiple of 8), "
                         f"got {D}")


def invpt_attention_plan(B: int, Lq: int, Lk: int, D: int, has_msg: bool,
                         plan=None) -> tuple[int, int, int, int]:
    """(row tiles of 16 query rows a block, ring slots, grid, shared-memory
    bytes) of one launch of the resident kernel on the current card, as the
    kernel's own module chooses them (csrc/invpt_attention.cu: plan_launch);
    the entries of ``plan`` (rt, stages, grid) that are > 0 are kept. Where
    the resident kernel does not take the shape (past 320 keys or head dim
    480) and no plan is given: (0, 0, blocks of the streamed form's first
    launch, 0). Raises ValueError where the plan does not fit."""
    p = (ctypes.c_int * 4)(*(plan or (0, 0, 0)), 0)
    if _build.lib().mtt_invpt_attention_plan(B, Lq, Lk, D, int(has_msg), p):
        raise ValueError(f"no InvPT attention plan {plan} fits B={B}, "
                         f"Lq={Lq}, Lk={Lk}, D={D}")
    return tuple(p)


def _invpt_attention_launch(q, k, v, msg, w, b, scale: float, plan=None):
    """Rows of 16 bytes: D % 8 == 0."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]

    def rows(t):   # unit stride along D, 16-byte rows
        return t if t.stride(-1) == 1 and all(
            s % 8 == 0 for s in t.stride()[:3]) else t.contiguous()

    q, k, v = rows(q), rows(k), rows(v)
    ldk = -(-Lk // 4) * 4   # the message's and fused's row pitch
    fused = torch.empty(B, H, Lq, ldk, dtype=torch.float32, device=q.device)
    if msg is not None:
        msg = msg.float().contiguous()
        if ldk != Lk:
            msg = torch.nn.functional.pad(msg, (0, ldk - Lk))
        w = w.float().contiguous()
        b = b.float().contiguous()
    _build.check_aligned("the InvPT attention kernel", q, k, v,
                         *([msg] if msg is not None else []))
    out = torch.empty(B, Lq, H, D, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    streamed = invpt_attention_plan(B, Lq, Lk, D, msg is not None,
                                    plan)[0] == 0
    p = torch.empty(B, H, Lq, -(-Lk // 32) * 32, dtype=q.dtype,
                    device=q.device) if streamed else None
    _build.check(_build.lib().mtt_invpt_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        msg.data_ptr() if msg is not None else None,
        w.data_ptr() if msg is not None else None,
        b.data_ptr() if msg is not None else None,
        out.data_ptr(), fused.data_ptr(),
        p.data_ptr() if streamed else None, B, Lq, Lk, ldk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        None if plan is None else (ctypes.c_int * 3)(*plan), float(scale),
        _build.stream()),
        "mtt_invpt_attention_bf16")
    return out, fused if ldk == Lk else fused[..., :Lk]


def invpt_attention_padded(q, k, v, msg, w, b, scale: float, run):
    """``run(q, k, v, msg, w, b, scale)`` at the head dim rounded up to a
    multiple of 8: q, k and v zero-padded (exact zeros in every score and
    product, so ``fused`` keeps its bits), the output's padded columns
    dropped (a view); the scale is the caller's, for the true head dim
    (InvPT's is D ** -0.5)."""
    D = q.shape[-1]
    return _build.run_padded_head(
        run, D, (q, k, v, msg, w, b, scale),
        lambda DP: (*(_build.pad_to(t, DP) for t in (q, k, v)), msg, w, b,
                    scale),
        lambda res, DP: (res[0][..., :D], res[1]))


def invpt_attention_cuda(q, k, v, msg, w, b, scale: float, plan=None):
    """The kernel takes bfloat16 q/k/v with 2 heads (both heads of a query
    tile sit in one block, because each fused head reads every head's scores
    and message), kv lengths up to 65536 and a head dim up to 1024 (one that
    is not a multiple of 8 runs zero-padded: ``invpt_attention_padded``).
    It reads q, k and v where they lie: (B, H, L, D) views with unit stride
    along D and strides that are multiples of 8 (the
    model's head splits of its projections are such views), so nothing is
    copied or padded on the host: the kernel's loads read zeros past the
    head dim (InvPT's stage 2 has head dim 72) and it gives the keys past Lk
    (NYUD's 252) no probability. out is written as (B, Lq, H, D) and
    returned as its (B, H, Lq, D) view, so the caller's merge of the heads
    is a view too. Only a kv length that is not a multiple of 4 (no InvPT
    shape) pads the message's rows to 16 bytes, and gets ``fused`` as a
    view of rows so padded. ``plan``: (rt, stages, grid) in place of the
    kernel's own choice (``invpt_attention_plan``), which computes the same
    bits.

    Up to 320 keys and head dim 480 (PASCAL and NYUD at any embed_dim up to
    896) the call is one launch of the resident kernel; past either
    (Cityscapes-3D's 1024 keys, head dim 544 at embed_dim 1024) it is the
    streamed form's three launches, with a (B, H, Lq, Lk rounded up to 32)
    bf16 scratch for p from torch.empty.

    What bounds it on the H100 is bytes: the f32 message in and ``fused``
    out, 105 MB each at the PASCAL forward's stage 2 (235 MB in all, 70 us
    at 3.35 TB/s; stage 1 67 MB, 20 us; stage 0 18 MB, 5.5 us; NYUD's
    stages 13, 44 and 150 MB). The resident kernel brings the message by
    TMA into a block's fused tile half a tile ahead, q, K and V through a
    TMA ring, and sends fused out of the tile by bulk copies (the note at
    the head of csrc/invpt_attention.cu)."""
    H, D = q.shape[1], q.shape[3]
    if q.dtype == torch.float32:
        raise _build.no_f32_form("the InvPT attention kernel (row 9)")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the InvPT attention kernel takes bfloat16, got "
                        f"{q.dtype}")
    check_invpt_attention_shape(H, k.shape[2], D)
    return invpt_attention_padded(
        q, k, v, msg, w, b, scale,
        lambda *a: _invpt_attention_launch(*a, plan=plan))


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
