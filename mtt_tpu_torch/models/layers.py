"""Building blocks of the port, NHWC at the public functions.

Port of the parts of mtt_tpu/models/layers.py that the TaskPrompter-ViT and
InvPT forwards run in eval and in training: ``FusedLN``, ``Mlp`` (its ``ln=``
path and the plain MLP of the drop-path blocks), ``PatchEmbed``,
``dot_product_attention``, ``Attention`` (with and without its fused
pre-norm) and ``ViTBlock`` with per-sample ``drop_path``, ``ConvBNAct``,
``interpolate`` and ``upsample2x``, the flax BatchNorm in both modes, the
factored conv3x3(upsample4) of the up4 head with its shift matrices, and the
phase form of the same conv (``up4_conv3x3_main``, ``up4_conv3x3_borders``,
``scatter_up4_borders``, ``depth_to_space4``). ``remat_call`` is the port's
``nn.remat``: activation checkpointing that recomputes a block in the
backward to the same bits. Parameter names
follow the JAX package's module tree; leaves use torch's names and layouts
(nn.Linear (out, in), nn.Conv2d OIHW), so ``models/convert_jax.py`` maps one
to the other.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from mtt_tpu_torch.kernels.attention import (fused_attention,
                                             fused_attention_ln_qkv,
                                             fused_attention_qkv)
from mtt_tpu_torch.kernels.layernorm import fused_layernorm
from mtt_tpu_torch.kernels.mlp import fused_mlp, fused_mlp_ln_res
from mtt_tpu_torch.parallel.mesh import all_reduce_sum, data_shard_info

BN_MOMENTUM = 0.9     # flax's: running = 0.9 running + 0.1 batch (torch 0.1)
# per thread, > 0 while a rematted call runs again in the backward (in the
# thread that runs the backward, which the recompute's forward runs in too)
_RECOMPUTING = threading.local()


@contextlib.contextmanager
def _recompute(generator: Optional[torch.Generator], start):
    """The context of a rematted call's second run: the drop-path generator
    back at ``start``, its state when the call first ran, so that the second
    run draws the same masks, and after it at the state it had before, so
    that the run leaves no trace; ``update_running_stats`` idle. Both are
    restored if the run raises."""
    now = None if generator is None else generator.get_state()
    if generator is not None:
        generator.set_state(start)
    _RECOMPUTING.depth = getattr(_RECOMPUTING, "depth", 0) + 1
    try:
        yield
    finally:
        _RECOMPUTING.depth -= 1
        if generator is not None:
            generator.set_state(now)


def remat_call(fn, generator: Optional[torch.Generator], /, *args,
               **kwargs):
    """``fn(*args, **kwargs)`` under activation checkpointing, the JAX
    package's ``nn.remat``: the call keeps only its inputs for the backward,
    which runs it again to rebuild what its own backward reads. Non-reentrant
    ``torch.utils.checkpoint``, so the backward walks the graph of the first
    run and the recomputed tensors are equal to the first ones bit for bit:
    the step's gradients are the plain step's. The second run runs whole (no
    early stop), so every kernel of ``fn`` launches twice a step; it redraws
    the drop-path masks from ``generator`` as the first run drew them, and
    updates no BatchNorm running statistics (``_recompute``). The port draws
    every random number from an explicit generator, so torch's own RNG state
    is not saved. Without gradients (eval, ``torch.no_grad``) this is the
    plain call. A BatchNorm under data parallelism all-reduces its moments
    again in the second run, inside the backward, in the same order on every
    rank, before ``all_reduce_grads``."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)

    def contexts():
        start = None if generator is None else generator.get_state()
        return contextlib.nullcontext(), _recompute(generator, start)

    with checkpoint.set_checkpoint_early_stop(False):
        return checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                     preserve_rng_state=False,
                                     context_fn=contexts, **kwargs)


class FusedLN(nn.Module):
    """LayerNorm over the last axis through the LayerNorm kernel."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x, impl: Optional[str] = None):
        return fused_layernorm(x, self.weight, self.bias, self.eps, impl=impl)


class Mlp(nn.Module):
    """Transformer MLP fc1 -> GELU -> fc2. With ``ln`` the pre-norm residual
    half-block x + MLP(LN(x)) runs as one kernel (the JAX ``Mlp(...,
    ln=...)`` path); without it the MLP alone runs as one kernel (the JAX
    ``fused_mlp`` path of the drop-path blocks)."""

    def __init__(self, dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)

    def forward(self, x, ln: Optional[FusedLN] = None,
                impl: Optional[str] = None):
        if ln is None:
            return fused_mlp(x, self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias, impl=impl)
        return fused_mlp_ln_res(x, ln.weight, ln.bias, self.fc1.weight,
                                self.fc1.bias, self.fc2.weight, self.fc2.bias,
                                ln.eps, impl=impl)


class PatchEmbed(nn.Module):
    """Image (B, H, W, 3) -> tokens (B, H/p * W/p, C) by a strided conv."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3, *,
                 device=None, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size,
                              device=device, dtype=dtype)

    def forward(self, x) -> Tuple[torch.Tensor, Tuple[int, int]]:
        p = self.patch_size
        B, H, W, _ = x.shape
        if H % p or W % p:
            raise ValueError(
                f"PatchEmbed: input {H}x{W} must be divisible by "
                f"patch_size={p} (the reference's strided conv silently "
                f"truncated the remainder; pad or resize the input)")
        x = x.to(self.proj.weight.dtype).permute(0, 3, 1, 2)
        y = self.proj(x)                              # (B, C, gh, gw)
        gh, gw = H // p, W // p
        return y.flatten(2).transpose(1, 2), (gh, gw)


def sample_uniform(B: int, generator: torch.Generator, *shape):
    """U(0, 1) draws (B, *shape) for this rank's B samples: ``generator``
    draws them for the global batch (every rank's batch the same size,
    every rank's generator in the same state) and the rank keeps its own
    rows, so that a step over ranks draws the masks of one process on the
    whole batch, as JAX draws them over its sharded batch."""
    world, rank = data_shard_info()
    u = torch.rand(world * B, *shape, generator=generator,
                   device=generator.device)
    return u[rank * B:(rank + 1) * B]


def drop_path(x, rate: float, generator: Optional[torch.Generator]):
    """Stochastic depth per sample (``DropPath``): a kept sample is scaled by
    1 / keep, a dropped one is zero. The draws come from ``generator``
    (``sample_uniform``)."""
    if generator is None:
        raise ValueError("training with drop-path needs a torch.Generator "
                         "for its masks: pass generator=... (or build the "
                         "model with drop_path_rate=0)")
    keep = 1.0 - rate
    mask = (sample_uniform(x.shape[0], generator) < keep).to(x.device)
    return torch.where(mask.view(-1, *[1] * (x.dim() - 1)), x / keep,
                       torch.zeros_like(x))


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          impl: Optional[str] = None):
    """Softmax attention over (B, N, H, D) tensors with an f32 max-subtracted
    softmax, through the generic attention kernel (layers.py:195-202)."""
    return fused_attention(q, k, v, scale=scale, impl=impl)


class Attention(nn.Module):
    """ViT multi-head self-attention. With ``ln`` (the pre-norm blocks) LN,
    the qkv projection (rows head-major (H, 3, D)) and the attention run
    through the front-half kernels; without it the qkv projection is a plain
    product and the attention runs over the packed qkv (layers.py:234-240).
    Then the output projection. Training forwards take the max-subtracted
    softmax."""

    def __init__(self, dim: int, num_heads: int, *, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device, dtype=dtype)
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x, ln: Optional[FusedLN] = None, train: bool = False,
                impl: Optional[str] = None):
        D = x.shape[-1] // self.num_heads
        if ln is None:
            out = fused_attention_qkv(self.qkv(x), self.num_heads, D ** -0.5,
                                      impl=impl, safe=train)
        else:
            out = fused_attention_ln_qkv(
                x, ln.weight, ln.bias, self.qkv.weight, self.qkv.bias,
                self.num_heads, D ** -0.5, ln.eps, impl=impl, safe=train)
        return self.proj(out)


class ViTBlock(nn.Module):
    """Pre-norm transformer block: x + Attn(LN(x)); x + MLP(LN(x)). In eval
    (and without drop-path) the second half is the fused MLP half-block; a
    training block with drop-path runs LayerNorm, the plain MLP and the
    per-sample mask."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.drop_path = drop_path
        self.norm1 = FusedLN(dim, **kw)
        self.attn = Attention(dim, num_heads, **kw)
        self.norm2 = FusedLN(dim, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x, train: bool = False, impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        h = self.attn(x, self.norm1, train, impl)
        if not train or self.drop_path == 0.0:
            return self.mlp(x + h, self.norm2, impl=impl)
        x = x + drop_path(h, self.drop_path, generator)
        h = self.mlp(self.norm2(x, impl=impl), impl=impl)
        return x + drop_path(h, self.drop_path, generator)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def bn_eval(x, bn: nn.BatchNorm2d):
    """Eval BatchNorm in f32 on an NCHW tensor, cast back to its dtype."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    add = bn.bias.float() - bn.running_mean.float() * inv
    return (x.float() * inv[:, None, None] + add[:, None, None]).to(x.dtype)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean, var) -> None:
    """flax running averages (momentum 0.9) of the batch mean and the BIASED
    batch variance; torch's own update would use the unbiased one. Nothing
    while a rematted call runs again (``remat_call``): the first run made
    the step's update."""
    if getattr(_RECOMPUTING, "depth", 0):
        return
    bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
    bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    bn.num_batches_tracked += 1


def batch_moments(xf, dims: Tuple[int, ...], centred: bool):
    """(mean, biased variance) of f32 ``xf`` over ``dims`` (the batch axis
    among them) and over every rank's batch, the sums all-reduced
    (``all_reduce_sum``): the fast variance E[x^2] - E[x]^2 clipped at 0 in
    one reduction (flax's BatchNorm), or with ``centred`` the mean first and
    then E[(x - mean)^2] (the up4 head's and the InvPT tail's training BN).
    Differentiable through the reductions, so every rank's inputs get the
    cotangent of the global statistics."""
    ch = next(a for a in range(xf.dim()) if a not in dims)
    C = xf.shape[ch]
    n = xf.new_full((1,), xf.numel() // C)
    if not centred:
        s = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), n]))
        mean = s[:C] / s[-1]
        return mean, (s[C:2 * C] / s[-1] - mean * mean).clamp_min(0.0)
    s = all_reduce_sum(torch.cat([xf.sum(dims), n]))
    mean = s[:C] / s[-1]
    shape = [1] * xf.dim()
    shape[ch] = C
    xc = xf - mean.view(shape)
    return mean, all_reduce_sum((xc * xc).sum(dims)) / s[-1]


def bn_train(x, bn: nn.BatchNorm2d):
    """Training BatchNorm as flax computes it, on an NCHW tensor: batch
    statistics in f32 with the fast variance E[x^2] - E[x]^2 clipped at 0
    (flax ``_compute_stats``), over every rank's batch
    (``batch_moments``), normalised in f32, cast back to x's dtype; the
    running statistics are updated as a side effect."""
    xf = x.float()
    mean, var = batch_moments(xf, (0, 2, 3), centred=False)
    update_running_stats(bn, mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias.float()[:, None, None]
    return y.to(x.dtype)


def batch_norm(x, bn: nn.BatchNorm2d, train: bool):
    return bn_train(x, bn) if train else bn_eval(x, bn)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm (running statistics, or batch statistics in
    training) -> activation, NHWC in and out."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 use_bias: bool = False,
                 act: Optional[Callable] = F.relu, *, device=None,
                 dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size,
                              padding=kernel_size // 2, bias=use_bias,
                              device=device, dtype=dtype)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1, device=device,
                                 dtype=dtype)
        self.act = act

    def forward(self, x, train: bool = False):
        y = batch_norm(self.conv(to_nchw(x)), self.bn, train)
        if self.act is not None:
            y = self.act(y)
        return to_nhwc(y)


def interpolate(x, size: Tuple[int, int]):
    """Half-pixel bilinear resize of an NHWC map, no antialias (JAX
    ``interpolate`` == torch align_corners=False)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(to_nchw(x), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return to_nhwc(y)


def upsample2x(x):
    """2x bilinear upsample, NHWC."""
    return interpolate(x, (2 * x.shape[1], 2 * x.shape[2]))


def conv1x1(conv: nn.Conv2d, x):
    """A 1x1 ``nn.Conv2d`` applied to an NHWC map as a product over the last
    axis: the same function without the two layout changes."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


@functools.lru_cache(maxsize=128)
def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel bilinear weights, the sampling of
    ``interpolate`` for upsampling (mtt_tpu/models/layers.py:310-323)."""
    o = np.arange(n_out)
    c = (o + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(c).astype(int)
    frac = (c - lo).astype(np.float32)
    hi = np.clip(lo + 1, 0, n_in - 1)
    lo = np.clip(lo, 0, n_in - 1)
    M = np.zeros((n_out, n_in), np.float32)
    np.add.at(M, (o, lo), 1.0 - frac)
    np.add.at(M, (o, hi), frac)
    return M


@functools.lru_cache(maxsize=64)
def _upf_shift_stack_np(g: int, f: int) -> np.ndarray:
    """(g, 3, f*g) stacked shifted-upsample mix matrices: entry [w, l, W] is
    the weight with which low-res column w reaches high-res column W through
    conv tap l (offset l - 1). Out-of-range rows are zero, which is the
    conv's SAME zero padding (mtt_tpu/models/layers.py:530-543)."""
    U = _linear_resize_matrix(g, f * g)              # (fg, g)
    S = np.zeros((3, f * g, g), np.float32)
    for k in range(3):
        d = k - 1
        lo, hi = max(0, -d), min(f * g, f * g - d)
        S[k, lo:hi] = U[lo + d:hi + d]
    return S.transpose(2, 0, 1).copy()               # (g, 3, fg)


def _up4_shift_stack_np(g: int) -> np.ndarray:
    return _upf_shift_stack_np(g, 4)


def _upf_shift_stack_key(key) -> np.ndarray:
    """``_upf_shift_stack_np(g, f)`` of ``key = (g, f)``: ``on_device``
    passes one argument."""
    return _upf_shift_stack_np(*key)


@functools.lru_cache(maxsize=64)
def on_device(make, g, device: torch.device) -> torch.Tensor:
    """``make(g)`` (a cached numpy table; ``g`` an int or a tuple) as a tensor
    on ``device``, copied once: a copy from pageable host memory waits for
    the device's queue."""
    return torch.from_numpy(make(g)).to(device)


def up4_conv3x3_gm(x, kernel):
    """The channel contraction of the factored conv3x3(upsample4): Gm = x .
    W[k, l] for the 9 taps, in x's dtype. x (B, gh, gw, C), kernel HWIO (3,
    3, C, D) -> (B, gh, gw, 3, 3, D)."""
    B, gh, gw, C = x.shape
    D = kernel.shape[-1]
    Wf = kernel.to(x.dtype).permute(2, 0, 1, 3).reshape(C, 9 * D)
    return torch.matmul(x.reshape(-1, C), Wf).reshape(B, gh, gw, 3, 3, D)


def upf_conv3x3_mix(G6, f: int = 4):
    """The width mix of Gm (B, gh, gw, 3, 3, D), rounded to its dtype, then
    the height mix in f32, through the shifted f-x upsample matrices;
    returns channel-major (B, D, f gw, f gh) f32."""
    gh, gw = G6.shape[1:3]
    Sw = on_device(_upf_shift_stack_key, (gw, f), G6.device).to(G6.dtype)
    Sh = on_device(_upf_shift_stack_key, (gh, f), G6.device)
    M = torch.einsum("bhwkld,wlW->bhkdW", G6, Sw)
    return torch.einsum("bhkdW,hkH->bdWH", M.float(), Sh)


def up4_conv3x3_mix(G6):
    return upf_conv3x3_mix(G6, 4)


def upf_conv3x3_factored(x, kernel, f: int = 4):
    """Exact conv3x3-SAME(bilinear_upsample_f(x)) with the channel
    contraction at low resolution (mtt_tpu/models/layers.py:550-580): Gm =
    x . W[k, l] for the 9 taps, then the width and height mixes through the
    shifted f-x upsample matrices (f = 1 is a plain conv3x3). Rounds where
    the JAX composition rounds: Gm and the width mix to x's dtype, the
    height mix in f32. x (B, gh, gw, C), kernel HWIO (3, 3, C, D); returns
    channel-major (B, D, f gw, f gh) f32. A torch composition, as it is XLA
    in JAX: the up4 training head and InvPT's ``factored_tail`` run it."""
    return upf_conv3x3_mix(up4_conv3x3_gm(x, kernel), f)


def up4_conv3x3_factored(x, kernel):
    return upf_conv3x3_factored(x, kernel, 4)


# The phase form of conv3x3-SAME(bilinear_upsample4(x)) at low resolution
# (mtt_tpu/models/layers.py:397-530): high-res row 4q + p reads upsampled
# rows 4q + p - 1 .. 4q + p + 1, each a 2-tap mix of low-res rows q - 1 ..
# q + 1, so each of the 16 output phases is a 3x3 conv over the low-res grid.
# The channels are flat phase-major ((py * 4 + px) * Cout + d); the 1-pixel
# high-res border, which reads the conv's zero padding, is computed apart
# and scattered in.


@functools.lru_cache(maxsize=1)
def _up4_phase_matrix(_: int = 0) -> np.ndarray:
    """M[p, k, d]: the weight of low-res row q + d - 1 in high-res conv tap k
    of output row 4q + p, under the half-pixel 4x bilinear upsample (the
    argument is ``on_device``'s key)."""
    first = [-1, -1, 0, 0]
    a0 = [0.375, 0.125, 0.875, 0.625]
    M = np.zeros((4, 3, 3), np.float32)
    for p in range(4):
        for k in range(3):
            m = p - 1 + k                       # high-res row offset 4q + m
            qs, pp = m // 4, m % 4
            d0 = qs + first[pp]
            M[p, k, d0 + 1] += a0[pp]
            M[p, k, d0 + 2] += 1.0 - a0[pp]
    return M


def up4_conv3x3_main(x, kernel):
    """The 16 phase convs over the edge-padded low-res map, exact except on
    the 1-pixel high-res border; no bias. x (B, gh, gw, C), kernel HWIO (3,
    3, C, Cout), the phase kernels formed in f32 and rounded to x's dtype ->
    (B, gh, gw, 16 Cout)."""
    C, Cout = kernel.shape[2:]
    M = on_device(_up4_phase_matrix, 0, x.device)
    w_eff = torch.einsum("klcd,pki,qlj->pqdcij", kernel.float(), M, M)
    w_eff = w_eff.reshape(16 * Cout, C, 3, 3).to(x.dtype)
    xp = F.pad(to_nchw(x), (1, 1, 1, 1), mode="replicate")
    return to_nhwc(F.conv2d(xp, w_eff))


def up4_conv3x3_borders(x, kernel):
    """The exact high-res border rows and columns of
    conv3x3-SAME(upsample4(x)), no bias: strip convs over the clamped
    upsample, whose neighbours across the border all equal the edge row or
    column. Returns (row0, rowl, col0, coll): rows (B, 4gw, Cout), columns
    (B, 4gh, Cout)."""
    B, gh, gw, C = x.shape
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)          # OIHW

    def strip(three, padding):
        y = F.conv2d(to_nchw(three), w, padding=padding)
        return y.flatten(2).transpose(1, 2)

    u_top = interpolate(x[:, :1], (1, 4 * gw))           # U rows 0 and 1
    u_bot = interpolate(x[:, -1:], (1, 4 * gw))          # U rows -2 and -1
    zr = torch.zeros_like(u_top)
    u_left = interpolate(x[:, :, :1], (4 * gh, 1))       # U cols 0 and 1
    u_right = interpolate(x[:, :, -1:], (4 * gh, 1))
    zc = torch.zeros_like(u_left)
    return (strip(torch.cat([zr, u_top, u_top], 1), (0, 1)),
            strip(torch.cat([u_bot, u_bot, zr], 1), (0, 1)),
            strip(torch.cat([zc, u_left, u_left], 2), (1, 0)),
            strip(torch.cat([u_right, u_right, zc], 2), (1, 0)))


def scatter_up4_borders(main, row0, rowl, col0, coll, cout: int):
    """``main`` (B, gh, gw, 16 Cout) with its flat phase-major border
    entries replaced by the exact strips: row phase 0 of q = 0 is channels
    [0, 4 Cout), row phase 3 of q = gh - 1 [12 Cout, 16 Cout); column phases
    0 and 3 are Cout-wide blocks at a stride of 4 Cout."""
    B, gh, gw, _ = main.shape
    main = main.clone()
    main[:, 0, :, :4 * cout] = row0.reshape(B, gw, 4 * cout).to(main.dtype)
    main[:, -1, :, 12 * cout:] = rowl.reshape(B, gw, 4 * cout).to(main.dtype)
    col0 = col0.reshape(B, gh, 4, cout).to(main.dtype)
    coll = coll.reshape(B, gh, 4, cout).to(main.dtype)
    for py in range(4):
        main[:, :, 0, 4 * py * cout:(4 * py + 1) * cout] = col0[:, :, py]
        main[:, :, -1, (4 * py + 3) * cout:(4 * py + 4) * cout] = \
            coll[:, :, py]
    return main


def depth_to_space4(y, channels: int):
    """(B, gh, gw, 16 C) flat phase-major -> (B, 4 gh, 4 gw, C)."""
    B, gh, gw, _ = y.shape
    y = y.reshape(B, gh, gw, 4, 4, channels).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 4 * gh, 4 * gw, channels)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights with the JAX package's initialisers: LeCun
    truncated normal for Linear/Conv weights, zero biases, unit LN/BN/GN
    scales and BN variances; ``pos_embed``, InvPT's ``fuse_attn_kernel`` and
    Swin's ``relative_position_bias_table`` N(0, 0.02) and ``task_prompts``
    N(1, 1), all truncated at two sigma. The detection head's own: the
    deformable conv's ``offset_mask`` zero (no deformation at first), its
    kernel He normal, the class bias at prior probability 0.01 and unit
    per-level ``scales``."""

    def trunc_(t, std, mean=0.0):
        with torch.no_grad():
            tmp = torch.empty(t.shape, device=t.device, dtype=torch.float32)
            nn.init.trunc_normal_(tmp, mean, std, mean - 2 * std,
                                  mean + 2 * std, generator=generator)
            t.copy_(tmp)

    for name, p in module.named_parameters():
        *owner, leaf = name.split(".")
        owner = owner[-1] if owner else ""
        if leaf in ("pos_embed", "fuse_attn_kernel",
                    "relative_position_bias_table"):
            trunc_(p, 0.02)
        elif leaf == "task_prompts":
            trunc_(p, 1.0, 1.0)
        elif leaf == "scales":
            nn.init.ones_(p)
        elif owner == "offset_mask":
            nn.init.zeros_(p)
        elif owner == "dcn" and leaf == "weight":
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device)
                        * (2.0 / p.shape[1]) ** 0.5)
        elif owner == "conv_cls" and leaf == "bias":
            nn.init.constant_(p, -4.595)
        elif leaf == "weight" and p.dim() >= 2:
            fan_in = math.prod(p.shape[1:])
            if isinstance(module.get_submodule(name.rsplit(".", 1)[0]),
                          nn.ConvTranspose2d):      # weight (in, out, kh, kw)
                fan_in = p.shape[0] * math.prod(p.shape[2:])
            # flax lecun_normal: truncated normal, variance 1 / fan_in
            trunc_(p, (1.0 / fan_in) ** 0.5 / 0.87962566103423978)
        elif leaf == "weight":
            nn.init.ones_(p)
        else:
            nn.init.zeros_(p)
    for name, buf in module.named_buffers():
        if name.endswith("running_var"):
            buf.fill_(1.0)
        elif name.endswith("running_mean"):
            buf.zero_()
