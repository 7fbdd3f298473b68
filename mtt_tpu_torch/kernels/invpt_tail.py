"""InvPT multi-scale tail, with and without the fused 1x1 head: the CUDA
kernels (csrc/invpt_tail.cu) and their plain versions.

Port of mtt_tpu/kernels/invpt_tail.py ``fused_ms_tail`` and
``fused_ms_tail_head`` (``_tail_kernel_st``, the default, and ``_tail_kernel``,
the same function with the height mix as dots):
    relu(inv * conv3x3(U8(x0) + U4(x1) + U2(x2)) + addv)      [ @ wh + bh ]
The conv and the bilinear upsamples are linear, so each scale contracts its
channels at its own resolution (Gm), then the shifted-upsample width and height
mixes expand it, and the scales are summed before the folded-BN affine. The
three upsampled (B, th, tw, C) maps never exist; with the head, neither does
the (B, th, tw, D) feature map: only the logits reach device memory.

Rounding points, kept by the kernels and the plain versions alike: Gm and the
width mix rounded to the activation dtype; the height mix, the sum over
scales, the affine and the ReLU in f32; the activation rounded to the dtype
(before the head product too); the 1x1 accumulated in f32 with the bias added
in f32. The kernel hands the logits over in f32 and ``fused_ms_tail_head``
rounds them to the activation dtype, as the TPU kernel's output is.

On the card the tail is cut at the first rounding: Gm_s (B gh gw, 9 D) of
each scale on the port's shared wgmma GEMM, into one scratch from
``torch.empty``, then the mix kernel from the three Gm to the output. Their
plain versions are ``ms_tail_gm_plain`` and ``ms_tail_mix_plain``, whose
composition is ``ms_tail_plain`` (and, with the head, ``ms_tail_head_plain``).

The gradient of ``fused_ms_tail`` is torch autograd through the dense
composition ``ms_tail_dense`` (upsample, sum, conv3x3, affine, ReLU), as the
JAX custom VJP differentiates ``_tail_xla`` (invpt_tail.py:734-739). The head
form has no VJP in JAX (eval only); its backward raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mtt_tpu_torch.kernels import _build
from mtt_tpu_torch.models.layers import (_upf_shift_stack_np, interpolate,
                                         on_device, to_nchw, to_nhwc)

FACTORS = (8, 4, 2)  # the kernels' scales: InvPT's stages against the output
MAX_LOGITS = 128     # the mix kernel keeps every logit of a pixel in registers


def _shift_stack(key) -> np.ndarray:
    """(g, 3, f*g) shifted-upsample mix matrix of ``key = (g, f)``."""
    return _upf_shift_stack_np(*key)


@functools.lru_cache(maxsize=64)
def _bands(key) -> np.ndarray:
    """(f*g, 3, 3) band of the shifted upsample stack of ``key = (g, f)``:
    [W, l, dw] is the weight of low-res column W // f + dw - 1 through tap l
    (0 off the map). Every nonzero of the stack lies in the band."""
    g, f = key
    S = _upf_shift_stack_np(g, f)                    # (g, 3, f*g)
    out = np.zeros((f * g, 3, 3), np.float32)
    back = np.zeros_like(S)
    for W in range(f * g):
        for dw in range(3):
            w = W // f + dw - 1
            if 0 <= w < g:
                out[W, :, dw] = S[w, :, W]
                back[w, :, W] = S[w, :, W]
    if not np.array_equal(back, S):
        raise ValueError(f"the {f}x shifted upsample of {g} columns reaches "
                         f"past its neighbouring columns")
    return out


def _factors(xs, th: int, tw: int):
    fs = []
    for x in xs:
        h, w = x.shape[1:3]
        if th % h or tw % w or th // h != tw // w:
            raise ValueError(
                f"the multi-scale tail needs each scale to divide the output "
                f"({th}, {tw}) by one integer factor on both axes, got a "
                f"{h}x{w} map")
        fs.append(th // h)
    return tuple(fs)


def _check(xs, kc, inv, addv, th, tw, wh=None, bh=None):
    if len(xs) != 3 or any(x.dim() != 4 for x in xs) \
            or not xs[0].is_floating_point():
        raise ValueError("xs must be three floating NHWC maps")
    C = xs[0].shape[-1]
    if kc.dim() != 4 or kc.shape[:3] != (3, 3, C) \
            or any(x.shape[-1] != C or x.shape[0] != xs[0].shape[0]
                   or x.dtype != xs[0].dtype for x in xs):
        raise ValueError(f"the three scales and the conv kernel must share "
                         f"their input channels: got "
                         f"{[tuple(x.shape) for x in xs]} and kc "
                         f"{tuple(kc.shape)}")
    D = kc.shape[-1]
    if inv.shape != (D,) or addv.shape != (D,):
        raise ValueError(f"inv and addv must be ({D},), got "
                         f"{tuple(inv.shape)} and {tuple(addv.shape)}")
    if wh is not None:
        n = wh.shape[-1]
        if wh.shape != (D, n) or bh.shape != (n,):
            raise ValueError(f"wh must be ({D}, n) and bh (n,), got "
                             f"{tuple(wh.shape)} and {tuple(bh.shape)}")
        if n > MAX_LOGITS:
            raise ValueError(f"the head-fused tail takes at most {MAX_LOGITS}"
                             f" logits, got {n}")
    for t in (*xs, kc, inv, addv, wh, bh):
        if t is not None and t.device != xs[0].device:
            raise ValueError("multi-scale tail inputs must be on one device")
    return _factors(xs, th, tw)


def ms_tail_gm_plain(xs, kc):
    """The first stage's function (one GEMM a scale on the card): Gm_s = x_s
    . kc over the 9 taps, rounded to the maps' dtype once; a (B, gh, gw, 3,
    3, D) tensor per scale."""
    dt = xs[0].dtype
    C, D = kc.shape[2], kc.shape[3]
    Wf = kc.to(dt).permute(2, 0, 1, 3).reshape(C, 9 * D)
    return tuple(torch.matmul(x.reshape(-1, C), Wf).reshape(*x.shape[:3], 3,
                                                            3, D)
                 for x in xs)


def ms_tail_mix_plain(gms, inv, addv, th: int, tw: int, wh=None, bh=None):
    """The second stage's function, from the three Gm to the output: each
    scale's width mix rounded to the dtype, the height mixes summed over the
    scales in f32, affine and ReLU, rounded to the dtype -> (B, th, tw, D);
    with ``wh`` (D, n) and ``bh`` (n,) the (B, th, tw, n) f32 logits."""
    dt, dev = gms[0].dtype, gms[0].device
    Y = None
    for G6, f in zip(gms, _factors(gms, th, tw)):
        gh, gw = G6.shape[1:3]
        Sw = on_device(_shift_stack, (gw, f), dev).to(dt)
        Sh = on_device(_shift_stack, (gh, f), dev)
        M = torch.einsum("bhwkld,wlW->bhkWd", G6, Sw)
        y = torch.einsum("bhkWd,hkH->bHWd", M.float(), Sh)
        Y = y if Y is None else Y + y
    act = torch.relu(Y * inv.float() + addv.float()).to(dt)
    if wh is None:
        return act
    return torch.matmul(act.float(), wh.to(dt).float()) + bh.float()


def ms_tail_plain(xs, kc, inv, addv, th: int, tw: int):
    """xs: NHWC maps at (th / f, tw / f); kc (3, 3, C, D) HWIO; inv, addv (D,)
    f32 -> (B, th, tw, D) in the input dtype."""
    return ms_tail_mix_plain(ms_tail_gm_plain(xs, kc), inv, addv, th, tw)


def ms_tail_head_plain(xs, kc, inv, addv, wh, bh, th: int, tw: int):
    """The same with the 1x1 head: wh (D, n), bh (n,) -> (B, th, tw, n) f32
    logits."""
    return ms_tail_mix_plain(ms_tail_gm_plain(xs, kc), inv, addv, th, tw, wh,
                             bh)


def ms_tail_dense(xs, kc, inv, addv, th: int, tw: int):
    """The dense composition ``_tail_xla`` (the model's train-mode tail
    math): upsample each scale, sum, conv3x3 SAME, affine and ReLU in f32."""
    dt = xs[0].dtype
    acc = 0.0
    for x in xs:
        acc = acc + interpolate(x, (th, tw))
    y = F.conv2d(to_nchw(acc.to(dt)), kc.to(dt).permute(3, 2, 0, 1),
                 padding=1)
    y = to_nhwc(y).float() * inv.float() + addv.float()
    return torch.relu(y).to(dt)


def check_ms_tail_shape(fs, n: int = 0) -> None:
    """Raises unless the kernels take the tail: the factors (8, 4, 2) of
    InvPT's stages (so both output sides are multiples of 8) and at most
    MAX_LOGITS logits. Any channel counts: the wrapper pads them to 8 (TMA
    reads rows whose pitch is a multiple of 16 bytes)."""
    if tuple(fs) != FACTORS:
        raise ValueError(
            f"the multi-scale tail kernel takes the factors {FACTORS} (the "
            f"InvPT stages), got {tuple(fs)}; other factors are ROADMAP.md "
            f"item 1.11")
    if n > MAX_LOGITS:
        raise ValueError(f"the head-fused tail kernel takes at most "
                         f"{MAX_LOGITS} logits, got {n}")


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def ms_tail_cuda(xs, kc, inv, addv, th: int, tw: int, wh=None, bh=None):
    """Four launches: Gm of each scale on the shared GEMM into one (B (th tw
    / 64 + th tw / 16 + th tw / 4), 9 DP) bf16 scratch, then the mix kernel
    -> (B, th, tw, D) in bf16, or with ``wh`` and ``bh`` the (B, th, tw, n)
    f32 logits. It takes bfloat16 maps at the factors (8, 4, 2); anything
    else raises. Per call the wrapper lays out what the kernels read: kc as
    (9 DP, CP), K-major for the GEMM, and with the head wh padded to (DP,
    NP); the maps are padded only where C % 8 != 0."""
    fs = _factors(xs, th, tw)
    x0 = xs[0]
    B, _, _, C = x0.shape
    D = kc.shape[-1]
    dt = x0.dtype
    if dt == torch.float32:
        raise _build.no_f32_form("the multi-scale tail kernel (row 10)")
    if dt != torch.bfloat16:
        raise TypeError(f"the multi-scale tail kernel takes bfloat16, got "
                        f"{dt}")
    n = 0 if wh is None else wh.shape[-1]
    check_ms_tail_shape(fs, n)
    CP, DP = _pad8(C), _pad8(D)
    xa = [(x if CP == C else F.pad(x, (0, CP - C))).contiguous() for x in xs]
    wg = kc.to(dt).permute(0, 1, 3, 2)                # (3, 3, D, C)
    if CP != C or DP != D:
        wg = F.pad(wg, (0, CP - C, 0, DP - D))
    wg = wg.contiguous()
    bands = []
    for x, f in zip(xs, fs):
        bands.append(on_device(_bands, (x.shape[2], f), x0.device))   # width
        bands.append(on_device(_bands, (x.shape[1], f), x0.device))   # height
    invf, addvf = inv.float().contiguous(), addv.float().contiguous()
    if n:
        NP = -(-n // 16) * 16
        kpp = F.pad(wh.to(dt), (0, NP - n, 0, DP - D)).contiguous()
        bhf = bh.float().contiguous()
        out = torch.empty(B, th, tw, n, dtype=torch.float32,
                          device=x0.device)
        extra = (kpp, bhf)
    else:
        NP, kpp, bhf, extra = 0, None, None, ()
        out = torch.empty(B, th, tw, D, dtype=dt, device=x0.device)
    _build.check_aligned("the multi-scale tail kernels", *xa, wg, invf,
                         addvf, *extra)
    gm = x0.new_empty(B * sum((th // f) * (tw // f) for f in fs), 9 * DP)
    _build.check(_build.lib().mtt_invpt_tail_bf16(
        *[x.data_ptr() for x in xa], wg.data_ptr(),
        kpp.data_ptr() if n else None, bhf.data_ptr() if n else None,
        *[t.data_ptr() for t in bands], invf.data_ptr(), addvf.data_ptr(),
        gm.data_ptr(), out.data_ptr(), B, th, tw, CP, D, DP, n, NP,
        _build.stream()), "mtt_invpt_tail_bf16")
    return out


class _MsTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x1, x2, kc, inv, addv, th, tw, impl):
        ctx.save_for_backward(x0, x1, x2, kc, inv, addv)
        ctx.size = (th, tw)
        if impl == "plain":
            return ms_tail_plain((x0, x1, x2), kc, inv, addv, th, tw)
        out = ms_tail_cuda((x0, x1, x2), kc, inv, addv, th, tw)
        _build.COUNTS["invpt_tail"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ms_tail_dense(args[:3], *args[3:], *ctx.size)
        return (*torch.autograd.grad(y, args, g), None, None, None)


class _MsTailHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x1, x2, kc, inv, addv, wh, bh, th, tw, impl):
        if impl == "plain":
            return ms_tail_head_plain((x0, x1, x2), kc, inv, addv, wh, bh,
                                      th, tw)
        out = ms_tail_cuda((x0, x1, x2), kc, inv, addv, th, tw, wh, bh)
        _build.COUNTS["invpt_tail_head"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the head-fused tail is eval-only, as in the JAX package "
            "(invpt_tail.py:768); training runs the dense tail and the head "
            "module")


def fused_ms_tail(xs, kc, inv, addv, th: int, tw: int,
                  impl: str | None = None):
    """relu(affine(conv3x3(sum_s upsample_{f_s}(xs[s])))) at (th, tw), fused;
    see the module docstring. Returns (B, th, tw, D) in the input dtype."""
    _check(xs, kc, inv, addv, th, tw)
    return _MsTail.apply(*xs, kc, inv, addv, th, tw,
                         _build.resolve_impl(impl, xs[0]))


def fused_ms_tail_head(xs, kc, inv, addv, wh, bh, th: int, tw: int,
                       impl: str | None = None):
    """The fused tail with the per-task 1x1 head: logits (B, th, tw, n) =
    relu(affine(conv3x3(sum_s upsample(xs[s])))) @ wh + bh, in the input
    dtype. Eval only."""
    _check(xs, kc, inv, addv, th, tw, wh, bh)
    return _MsTailHead.apply(*xs, kc, inv, addv, wh, bh, th, tw,
                             _build.resolve_impl(impl, xs[0])
                             ).to(xs[0].dtype)
