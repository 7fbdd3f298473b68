"""InvPT inverted-pyramid UP-Transformer multi-task decoder (port of
mtt_tpu/models/invpt.py: ``TaskStackConvBN``, ``UpEmbed``,
``CrossTaskAttention``, ``InvPTBlock``, ``InvPTDecoder``).

Three stages at rising resolution run shared self-attention over the
concatenation of all task token maps; each stage's fused attention scores are
upsampled and mixed into the next stage's scores (attention message passing)
inside the InvPT attention kernel, and the stages' task features are summed at
the output resolution inside the multi-scale tail kernel.

Tasks ride a stacked axis (B, T, H, W, C) at the public functions, as in JAX;
the per-task convolutions are one grouped ``nn.Conv2d`` over the merged T*C
channel axis. The kv length is constant across stages (strides 2, 4, 8 against
resolutions x1, x2, x4). Module names mirror the JAX tree.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention
from mtt_tpu_torch.kernels.invpt_tail import (fused_ms_tail,
                                              fused_ms_tail_head)
from mtt_tpu_torch.models.layers import (ConvBNAct, FusedLN, Mlp,
                                         batch_moments, batch_norm, conv1x1,
                                         drop_path, interpolate, to_nchw,
                                         to_nhwc, update_running_stats,
                                         upf_conv3x3_factored, upsample2x)


def merge_tasks(x):
    """(B, T, H, W, C) -> (B, T*C, H, W), channel index t * C + c."""
    B, T, H, W, C = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(B, T * C, H, W)


def split_tasks(xm, T: int):
    """(B, T*C, H, W) -> (B, T, H, W, C)."""
    B, TC, H, W = xm.shape
    return xm.reshape(B, T, TC // T, H, W).permute(0, 1, 3, 4, 2)


class TaskStackConvBN(nn.Module):
    """Independent conv per task + BN over a stacked (B, T, H, W, C) tensor:
    one grouped convolution (groups = T, or T*C when ``depthwise``) over the
    merged channel axis, with torch-style symmetric padding d (k - 1) / 2, and
    BN over the merged T*C axis, which is per-task BN."""

    def __init__(self, tasks: int, in_features: int, features: int,
                 kernel_size: int = 3, dilation: int = 1, stride: int = 1,
                 depthwise: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.tasks = tasks
        groups = tasks * in_features if depthwise else tasks
        self.conv = nn.Conv2d(
            tasks * in_features, tasks * features, kernel_size, stride,
            padding=dilation * (kernel_size - 1) // 2, dilation=dilation,
            groups=groups, bias=False, device=device, dtype=dtype)
        self.bn = nn.BatchNorm2d(tasks * features, eps=1e-5, momentum=0.1,
                                 device=device, dtype=dtype)

    def forward_merged(self, xm, train: bool = False):
        """(B, T*C, H, W) in and out: back-to-back stacks skip the layout
        changes that would cancel."""
        return batch_norm(self.conv(xm), self.bn, train)

    def forward(self, x, train: bool = False):
        return split_tasks(self.forward_merged(merge_tasks(x), train),
                           self.tasks)


class UpEmbed(nn.Module):
    """Per-task 2x upsample + two dilated 3x3 conv-BN-ReLU stacks."""

    def __init__(self, tasks: int, in_features: int, features: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.proj1 = TaskStackConvBN(tasks, in_features, features, 3,
                                     dilation=2, **kw)
        self.proj2 = TaskStackConvBN(tasks, features, features, 3,
                                     dilation=2, **kw)

    def forward(self, x, train: bool = False):
        B, T, H, W, C = x.shape
        x = upsample2x(x.reshape(B * T, H, W, C))
        xm = merge_tasks(x.reshape(B, T, 2 * H, 2 * W, C))
        xm = F.relu(self.proj1.forward_merged(xm, train))
        xm = F.relu(self.proj2.forward_merged(xm, train))
        return split_tasks(xm, T)


class CrossTaskAttention(nn.Module):
    """Shared self-attention over all tasks' tokens with message passing: q
    via a per-task depthwise conv of stride 2 + BN, k and v via a per-task
    average pool of stride ``kv_stride``; the scale is dim ** -0.5 on the full
    (not per-head) dim; the previous stage's fused scores, upsampled 2x on
    each task's query grid in f32, are mixed with the current scores by a 1x1
    over the stacked head axis inside the attention kernel. ``with_message``
    declares the mix's parameters (stages past the first)."""

    def __init__(self, tasks: int, dim: int, num_heads: int = 2,
                 kv_stride: int = 2, q_stride: int = 2,
                 with_message: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.num_heads = dim, num_heads
        self.kv_stride, self.q_stride = kv_stride, q_stride
        self.conv_proj_q = TaskStackConvBN(tasks, dim, dim, 3,
                                           stride=q_stride, depthwise=True,
                                           **kw)
        self.proj_q = nn.Linear(dim, dim, **kw)
        self.proj_k = nn.Linear(dim, dim, **kw)
        self.proj_v = nn.Linear(dim, dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        if with_message:
            self.fuse_attn_kernel = nn.Parameter(
                torch.zeros(num_heads, 2 * num_heads, **kw))
            self.fuse_attn_bias = nn.Parameter(torch.zeros(num_heads, **kw))

    def forward(self, x, message: Optional[torch.Tensor],
                train: bool = False, impl: Optional[str] = None):
        B, T, H, W, C = x.shape
        qh, qw = H // self.q_stride, W // self.q_stride
        kh, kw = H // self.kv_stride, W // self.kv_stride
        q = self.conv_proj_q(x, train).reshape(B, T * qh * qw, C)
        kv = F.avg_pool2d(to_nchw(x.reshape(B * T, H, W, C)), self.kv_stride)
        kv = to_nhwc(kv).reshape(B, T * kh * kw, C)
        Hn, D = self.num_heads, self.dim // self.num_heads
        Lq, Lk = q.shape[1], kv.shape[1]

        def heads(t, L):
            return t.reshape(B, L, Hn, D).transpose(1, 2)

        q = heads(self.proj_q(q), Lq)
        k = heads(self.proj_k(kv), Lk)
        v = heads(self.proj_v(kv), Lk)
        w = b = prev = None
        if message is not None:
            ph, pw = qh // 2, qw // 2      # previous stage's query grid
            prev = interpolate(message.reshape(B * Hn * T, ph, pw, Lk),
                               (qh, qw))   # stays f32
            prev = prev.reshape(B, Hn, T * qh * qw, Lk)
            w, b = self.fuse_attn_kernel, self.fuse_attn_bias
        out, new_message = invpt_fused_attention(q, k, v, prev, w, b,
                                                 self.dim ** -0.5, impl=impl)
        out = self.proj(out.transpose(1, 2).reshape(B, Lq, self.dim))
        out = interpolate(out.reshape(B * T, qh, qw, self.dim), (H, W))
        return out.reshape(B, T, H, W, self.dim), new_message


class InvPTBlock(nn.Module):
    """norm -> cross-task attention -> residual -> shared MLP."""

    def __init__(self, tasks: int, dim: int, num_heads: int = 2,
                 kv_stride: int = 2, mlp_ratio: float = 4.0,
                 drop_path: float = 0.15, with_message: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.drop_path = drop_path
        self.norm1 = FusedLN(dim, **kw)
        self.attn = CrossTaskAttention(tasks, dim, num_heads, kv_stride,
                                       with_message=with_message, **kw)
        self.norm2 = FusedLN(dim, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def _drop(self, h, train, generator):
        if not train or self.drop_path == 0.0:
            return h
        return drop_path(h, self.drop_path, generator)

    def forward(self, x, message, train: bool = False,
                impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        x = x.contiguous()
        h, new_message = self.attn(self.norm1(x, impl=impl), message, train,
                                   impl)
        x = x + self._drop(h, train, generator)
        h = self.mlp(self.norm2(x, impl=impl), impl=impl)
        return x + self._drop(h, train, generator), new_message


class InvPTDecoder(nn.Module):
    """Preamble (preliminary decoders + intermediate heads) + 3 UP-Transformer
    stages + multi-scale aggregation. ``forward`` returns (task_features,
    intermediate_preds): task_features[t] is (B, 8 h0, 8 w0, D) with h0 =
    grid / mtt_downsample, or that task's logits when ``head_params`` fuses
    the heads into the tail; intermediate_preds[t] is (B, h0, w0, n_t)."""

    def __init__(self, tasks: Sequence[str], num_outputs: Dict[str, int],
                 embed_dim: int = 512, pred_out: int = 64,
                 backbone_dim: int = 1024, mtt_downsample: int = 2,
                 num_heads: int = 2, drop_path: float = 0.15,
                 factored_tail: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.tasks = tuple(tasks)
        self.mtt_downsample = mtt_downsample
        self.factored_tail = factored_tail
        T = len(self.tasks)
        D = embed_dim + pred_out
        self.dims = dims = (D, D // 2, D // 4)
        # flax padding ((1, 2), (1, 2)) on the transposed conv is torch's
        # padding=1, output_padding=1; the kernel is flipped in convert_jax
        self.scale_embed_0 = nn.ConvTranspose2d(
            backbone_dim, dims[2], 3, stride=2, padding=1, output_padding=1,
            **kw)
        self.scale_embed_1 = nn.Conv2d(backbone_dim, dims[1], 3, padding=1,
                                       **kw)
        for t in self.tasks:
            self.add_module(f"prelim_{t}_0",
                            ConvBNAct(backbone_dim, backbone_dim, 3, **kw))
            self.add_module(f"prelim_{t}_1",
                            ConvBNAct(backbone_dim, embed_dim, 3, **kw))
            self.add_module(f"inter_head_{t}",
                            nn.Conv2d(embed_dim, num_outputs[t], 1, **kw))
            self.add_module(f"mix_proj_{t}", nn.Conv2d(
                embed_dim + num_outputs[t], D, 1, **kw))
            self.add_module(f"mt_proj_{t}", ConvBNAct(D, D, 3, **kw))
        for i, kv_stride in enumerate((2, 4, 8)):
            if i > 0:
                self.add_module(f"up_embed_{i}",
                                UpEmbed(T, dims[i - 1], dims[i], **kw))
                for t in self.tasks:
                    self.add_module(f"redu_chan_{i}_{t}",
                                    nn.Conv2d(dims[i], D, 1, **kw))
            self.add_module(f"stage_{i}", InvPTBlock(
                T, dims[i], num_heads, kv_stride, drop_path=drop_path,
                with_message=i > 0, **kw))
            self.add_module(f"norm_mt_{i}", FusedLN(T * dims[i], **kw))

    def _tail(self, t, stage_tx, th, tw, train, head_params, impl):
        """The mt_proj tail of task ``t``: conv3x3 + BN + ReLU on the
        multi-scale sum. Eval runs the fused tail kernel (with the 1x1 head
        when ``head_params`` is given), or with ``factored_tail`` and no
        head the factored composition; training the dense composition with
        batch statistics."""
        mt = getattr(self, f"mt_proj_{t}")
        conv, bn = mt.conv, mt.bn
        kc = conv.weight.permute(2, 3, 1, 0)                 # HWIO
        if not train:
            inv = torch.rsqrt(bn.running_var.float() + bn.eps) \
                * bn.weight.float()
            addv = bn.bias.float() - bn.running_mean.float() * inv
            if head_params is not None:
                wh, bh = head_params[t]
                return fused_ms_tail_head(stage_tx, kc, inv, addv, wh, bh,
                                          th, tw, impl=impl)
            if self.factored_tail and all(
                    th % x.shape[1] == 0 and tw % x.shape[2] == 0
                    and th // x.shape[1] == tw // x.shape[2]
                    for x in stage_tx):
                return self._factored_tail(stage_tx, kc, inv, addv, th)
            return fused_ms_tail(stage_tx, kc, inv, addv, th, tw, impl=impl)
        dt = stage_tx[0].dtype
        acc = 0.0
        for tx in stage_tx:
            acc = acc + interpolate(tx, (th, tw))
        xf = to_nhwc(conv(to_nchw(acc.to(dt)))).float()
        m, v = batch_moments(xf, (0, 1, 2), centred=True)
        update_running_stats(bn, m, v)
        inv = torch.rsqrt(v + bn.eps) * bn.weight.float()
        return F.relu(xf * inv + (bn.bias.float() - m * inv)).to(dt)

    @staticmethod
    def _factored_tail(stage_tx, kc, inv, addv, th):
        """The eval tail as JAX's ``MTT_INVPT_FACTORED`` branch computes it
        (mtt_tpu/models/invpt.py:378-388): the conv distributes over the
        multi-scale sum, so each stage's map is contracted at its own
        resolution (``upf_conv3x3_factored``, channel-major f32), the terms
        summed in f32, then the folded-BN affine and ReLU, transposed back
        and rounded once. No TPU kernel: torch products."""
        Y = 0.0
        for x in stage_tx:
            Y = Y + upf_conv3x3_factored(x, kc, th // x.shape[1])
        y = torch.relu(Y * inv[None, :, None, None]
                       + addv[None, :, None, None])
        return y.permute(0, 3, 2, 1).to(stage_tx[0].dtype)

    def forward(self, taps: List[torch.Tensor], grid: Tuple[int, int],
                train: bool = False, head_params=None,
                impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        gh, gw = grid
        B = taps[0].shape[0]
        maps = [t.reshape(B, gh, gw, t.shape[-1]) for t in taps]
        back0 = to_nhwc(self.scale_embed_0(to_nchw(maps[0])))
        back1 = to_nhwc(self.scale_embed_1(to_nchw(maps[1])))

        h0, w0 = gh // self.mtt_downsample, gw // self.mtt_downsample
        x_in = interpolate(maps[3], (h0, w0))
        feats, inter_preds = [], {}
        for t in self.tasks:
            f = getattr(self, f"prelim_{t}_0")(x_in, train)
            f = getattr(self, f"prelim_{t}_1")(f, train)
            ip = conv1x1(getattr(self, f"inter_head_{t}"), f)
            inter_preds[t] = ip
            feats.append(conv1x1(getattr(self, f"mix_proj_{t}"),
                                 torch.cat([f, ip], -1)))
        x = torch.stack(feats, 1)                            # (B, T, h0, w0, D)

        th, tw = 8 * h0, 8 * w0
        message = None
        stage_tx: Dict[str, List] = {t: [] for t in self.tasks}
        for i in range(3):
            if i > 0:
                x = getattr(self, f"up_embed_{i}")(x, train)
                x = x + (back1 if i == 1 else back0)[:, None]
            x, message = getattr(self, f"stage_{i}")(x, message, train, impl,
                                                     generator)
            # stage norm over the task-concatenated channel dim; the per-task
            # maps are slices of the merged layout
            Bx, Tx, Hx, Wx, Cx = x.shape
            xs = x.permute(0, 2, 3, 1, 4).reshape(Bx, Hx, Wx, Tx * Cx)
            xs = getattr(self, f"norm_mt_{i}")(xs, impl=impl)
            for ti, t in enumerate(self.tasks):
                tx = xs[..., ti * Cx:(ti + 1) * Cx]
                if i > 0:
                    tx = conv1x1(getattr(self, f"redu_chan_{i}_{t}"), tx)
                stage_tx[t].append(tx)

        out = {t: self._tail(t, stage_tx[t], th, tw, train, head_params, impl)
               for t in self.tasks}
        return out, inter_preds
