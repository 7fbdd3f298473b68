"""TaskPrompter-ViT backbone, eval and training forward (port of
mtt_tpu/models/taskprompter.py: ``PromptedBlock``, ``TaskFeatureDecode``,
``TaskPrompterViT``, ``TASKPROMPTER_VIT_SPECS``).

Each block runs the joint token stream [prompts; patches] through the
attention kernel (cached variant, or the emit variant at tap layers, which
also returns qkv and LN(x) for the raw prompt scores) and the MLP kernel. At
the tap layers the task decode kernel (or, with several channel windows, its
plain torch composition) turns the raw spatial and channel prompt scores into
per-task features. Module names mirror the JAX tree.

In training (``train=True``) the attention takes the max-subtracted softmax,
the decode BatchNorm uses batch statistics, and blocks with a drop-path rate
above 0 run LayerNorm, the plain MLP kernel and per-row-group stochastic depth
drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.kernels.attention import fused_attention_ln_qkv
from mtt_tpu_torch.kernels.layernorm import layernorm_plain
from mtt_tpu_torch.kernels.task_decode import fused_task_decode
from mtt_tpu_torch.models.layers import (FusedLN, Mlp, PatchEmbed, batch_norm,
                                         interpolate, sample_uniform,
                                         to_nchw, to_nhwc)

TASKPROMPTER_VIT_SPECS = {
    "TaskPrompter_vitL": dict(patch_size=16, embed_dim=1024, depth=24,
                              num_heads=16, select_list=(6, 12, 18)),
    "TaskPrompter_vitB": dict(patch_size=16, embed_dim=768, depth=12,
                              num_heads=12, select_list=(3, 6, 9)),
    "TaskPrompter_vitT": dict(patch_size=16, embed_dim=64, depth=4,
                              num_heads=4, select_list=(1, 2, 3)),
}


class PromptBlockOut:
    """Per-block tap payload: raw spatial and channel attention scores."""
    __slots__ = ("raw_spa", "raw_chan")

    def __init__(self, raw_spa, raw_chan):
        self.raw_spa = raw_spa      # (B, H, P, P+N) f32, pre-scale
        self.raw_chan = raw_chan    # (B, nwins, P, C) f32


def row_drop(branch, num_prompts: int, rate: float,
             generator: torch.Generator):
    """Stochastic depth with independent per-sample masks for the prompt rows
    and the patch rows (taskprompter.py:65-80): each kept group is scaled by
    1 / keep, each dropped group is zero. The draws come from ``generator``
    (``layers.sample_uniform``)."""
    if generator is None:
        raise ValueError("training with drop-path needs a torch.Generator "
                         "for its masks: pass generator=... (or build the "
                         "model with drop_path_rate=0)")
    keep = 1.0 - rate
    B = branch.shape[0]
    mask = (sample_uniform(B, generator, 2)
            < keep).to(branch.device, torch.float32) / keep
    rows = torch.ones(branch.shape[1], dtype=torch.long, device=branch.device)
    rows[:num_prompts] = 0
    return branch * mask[:, rows, None].to(branch.dtype)


def channel_windows(chan_nheads: int) -> Tuple[int, int]:
    """The (rows, columns) of channel-attention windows a config's
    ``chan_nheads`` gives: (1, 1) runs the task decode kernel, more windows
    the windowed decode in torch (NYUD's 16)."""
    nh = int(round(chan_nheads ** 0.5))
    return (nh, max(chan_nheads // max(nh, 1), 1))


class PromptedBlock(nn.Module):
    """One TaskPrompter block over the joint stream (B, P+N, C)."""

    def __init__(self, dim: int, num_heads: int, num_prompts: int,
                 chan_windows: Tuple[int, int], grid: Tuple[int, int],
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.drop_path = drop_path
        self.num_heads = num_heads
        self.num_prompts = num_prompts
        self.chan_windows = chan_windows
        self.grid = grid
        pixel_no = grid[0] * grid[1]
        self.norm1 = FusedLN(dim, **kw)
        self.qkv = nn.Linear(dim, 3 * dim, **kw)      # rows head-major (H,3,D)
        self.proj = nn.Linear(dim, dim, **kw)
        self.token_trans = nn.Linear(dim, pixel_no, **kw)
        self.token_trans1 = nn.Linear(pixel_no, dim, **kw)
        self.norm2 = FusedLN(dim, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, joint, need_taps: bool = False,
                impl: Optional[str] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        B, M, C = joint.shape
        P = self.num_prompts
        H, D = self.num_heads, C // self.num_heads
        ln1 = self.norm1
        # the max-subtracted softmax on training forwards (taskprompter.py:96)
        if need_taps:
            out, qkv, jn = fused_attention_ln_qkv(
                joint, ln1.weight, ln1.bias, self.qkv.weight, self.qkv.bias,
                H, D ** -0.5, ln1.eps, need_qkv=True, impl=impl, safe=train)
            pn = jn[:, :P]
        else:
            out = fused_attention_ln_qkv(
                joint, ln1.weight, ln1.bias, self.qkv.weight, self.qkv.bias,
                H, D ** -0.5, ln1.eps, impl=impl, safe=train)
            # the P prompt rows' LN stays plain torch, as it is XLA in JAX
            pn = layernorm_plain(joint[:, :P], ln1.weight, ln1.bias, ln1.eps)
        out = self.proj(out)

        # channel pathway: prompts -> pixel-space queries; the prompt-only
        # update joins the attention residual branch
        chan_prompts = self.token_trans(pn)                 # (B, P, pixel_no)
        out[:, :P] += self.token_trans1(chan_prompts)

        raw = None
        if need_taps:
            # raw (pre-scale, pre-softmax) prompt-row spatial scores from the
            # head-major qkv, accumulated in f32
            qkv5 = qkv.view(B, M, H, 3, D)
            q, k = qkv5[:, :P, :, 0], qkv5[:, :, :, 1]
            raw_spa = torch.einsum("bphd,bkhd->bhpk", q.float(), k.float())
            # raw windowed channel scores, contracted over pixels
            gh, gw = self.grid
            nh, nw = self.chan_windows
            wh, ww = gh // nh, gw // nw
            qc = chan_prompts.reshape(B, P, nh, wh, nw, ww).float()
            kc = jn[:, P:].reshape(B, nh, wh, nw, ww, C).float()
            raw_chan = torch.einsum("bphvnw,bhvnwc->bhnpc", qc, kc)
            raw = PromptBlockOut(raw_spa, raw_chan.reshape(B, nh * nw, P, C))

        if not train or self.drop_path == 0.0:
            joint = joint + out
            return self.mlp(joint, self.norm2, impl=impl), raw
        # drop-path blocks: LN, the MLP alone, a second row-group mask
        joint = joint + row_drop(out, P, self.drop_path, generator)
        h = self.mlp(self.norm2(joint, impl=impl), impl=impl)
        return joint + row_drop(h, P, self.drop_path, generator), raw


class TaskFeatureDecode(nn.Module):
    """Per-task features from the raw scores of one tap layer. With one
    channel window (chan_nheads == 1) the spatial and channel inputs, their
    projections and the first fuse projection run as the task decode
    kernel; with several windows as plain torch, as the JAX package composes
    them in XLA (taskprompter.py:244-270). The parameter tree is the same."""

    def __init__(self, tasks: Sequence[str], num_heads: int, prompt_len: int,
                 chan_windows: Tuple[int, int], dim: int, tar_dim: int,
                 final_dim: int, use_ctr: bool, layer_idx: int, *,
                 device=None, dtype=None):
        super().__init__()
        if prompt_len != 1:
            # the channel decode takes prompt row t*pl per task while the
            # reference cal_task_feature indexes flat row t (equal only for
            # prompt_len == 1, the value of every published config)
            raise NotImplementedError(
                "TaskFeatureDecode requires prompt_len == 1; the channel-"
                "pathway prompt-row convention diverges from the reference "
                f"for prompt_len={prompt_len}")
        kw = dict(device=device, dtype=dtype)
        T = len(tasks)
        self.tasks = tuple(tasks)
        self.num_heads = num_heads
        self.use_ctr = use_ctr
        self.chan_windows = tuple(chan_windows)
        self.tar_dim, self.final_dim = tar_dim, final_dim
        il = self.il = layer_idx
        # stacked per-task convs as grouped convs, task-major channels
        self.add_module(f"spa_{il}", nn.Conv2d(T * dim, T * tar_dim, 1,
                                               groups=T, **kw))
        self.add_module(f"chan_{il}", nn.Conv2d(T * dim, T * tar_dim, 1,
                                                groups=T, **kw))
        self.add_module(f"fuse0_{il}", nn.Conv2d(T * 2 * tar_dim,
                                                 T * final_dim, 1, groups=T,
                                                 **kw))
        self.add_module(f"fuse1_{il}", nn.Conv2d(T * final_dim, T * final_dim,
                                                 3, padding=1, groups=T, **kw))
        self.add_module(f"fuse_bn_{il}", nn.BatchNorm2d(T * final_dim,
                                                        eps=1e-5, **kw))
        self.add_module(f"fuse2_{il}", nn.Conv2d(T * final_dim, T * final_dim,
                                                 1, groups=T, **kw))
        if use_ctr:
            G = num_heads * prompt_len
            for t in tasks:
                self.add_module(f"ctr_{il}_{t}_0", nn.Linear(num_heads, G, **kw))
                self.add_module(f"ctr_{il}_{t}_1", nn.Linear(G, 1, **kw))

    def _sub(self, name):
        return getattr(self, f"{name}_{self.il}")

    def _windowed(self, x_map, raw: PromptBlockOut):
        """The decode inputs of several channel windows, their grouped 1x1
        projections and the first fuse projection (taskprompter.py:
        244-270), in the dtype of x_map: the spatial inputs x * a + x per
        head group, the channel inputs x * c + x with c the window's prompt
        scores broadcast over its cells, [f_t, fc_t] interleaved task-major.
        Returns (B, gh, gw, T * final)."""
        B, gh, gw, C = x_map.shape
        T, G = len(self.tasks), self.num_heads
        nh, nw = self.chan_windows
        wh, ww = gh // nh, gw // nw
        dt = x_map.dtype
        # (B, H, P, N) -> (B, gh, gw, T, G), head-major groups
        a = raw.raw_spa[:, :, :, T:].reshape(B, G, T, gh, gw) \
            .permute(0, 3, 4, 2, 1).to(dt)
        xg = x_map.reshape(B, gh, gw, 1, G, C // G)
        f_in = (xg * a[..., None]).reshape(B, gh, gw, T, C) \
            + x_map[:, :, :, None]
        # (B, nh*nw, P, C) -> per window (B, nh, 1, nw, 1, T, C)
        cw = raw.raw_chan.reshape(B, nh, 1, nw, 1, T, C).to(dt)
        xw = x_map.reshape(B, nh, wh, nw, ww, 1, C)
        fw_in = (xw * cw).reshape(B, gh, gw, T, C) + x_map[:, :, :, None]

        def grouped1x1(conv, inp):
            w = conv.weight.view(T, -1, inp.shape[-1])
            return torch.einsum("bhwtc,toc->bhwto", inp, w) \
                + conv.bias.view(T, -1)

        f = grouped1x1(self._sub("spa"), f_in)
        fc = grouped1x1(self._sub("chan"), fw_in)
        cat = grouped1x1(self._sub("fuse0"), torch.cat([f, fc], -1))
        return cat.reshape(B, gh, gw, -1)

    def forward(self, x_map, raw: PromptBlockOut, impl: Optional[str] = None,
                train: bool = False):
        B, gh, gw, C = x_map.shape
        T = len(self.tasks)
        P = T
        S = gh * gw
        tar, fin = self.tar_dim, self.final_dim
        spa, chan, fuse0 = self._sub("spa"), self._sub("chan"), \
            self._sub("fuse0")
        if self.chan_windows == (1, 1):
            # (B, H, P, N) -> (B, T, S, G), head-major groups
            a = raw.raw_spa[:, :, :, P:].permute(0, 2, 3, 1).contiguous()
            cat = fused_task_decode(
                x_map.reshape(B, S, C), a.to(x_map.dtype),
                raw.raw_chan.reshape(B, T, C).contiguous(),
                spa.weight.view(T, tar, C), spa.bias.view(T, tar),
                chan.weight.view(T, tar, C), chan.bias.view(T, tar),
                fuse0.weight.view(T, fin, 2 * tar), fuse0.bias.view(T, fin),
                impl=impl)
        else:
            cat = self._windowed(x_map, raw)
        y = self._sub("fuse1")(to_nchw(cat.view(B, gh, gw, T * fin)))
        y = F.gelu(batch_norm(y, self._sub("fuse_bn"), train))
        y = to_nhwc(self._sub("fuse2")(y))
        stack = y.reshape(B, gh, gw, T, fin)
        task_fea = {t: stack[:, :, :, ti] for ti, t in enumerate(self.tasks)}

        if self.use_ctr:
            # Cross-Task Reweighting from the prompt->prompt raw scores
            pp = raw.raw_spa[:, :, :, :P]                  # (B, H, P, P)
            new_fea = {}
            for ti, t in enumerate(self.tasks):
                wgt = pp[:, :, ti, :].to(x_map.dtype).transpose(1, 2)  # (B,T,H)
                wgt = F.gelu(getattr(self, f"ctr_{self.il}_{t}_0")(wgt))
                wgt = getattr(self, f"ctr_{self.il}_{t}_1")(wgt)[:, :, 0]
                new_fea[t] = sum(wgt[:, k, None, None, None] * task_fea[tk]
                                 for k, tk in enumerate(self.tasks))
            task_fea = new_fea
        return task_fea


class TaskPrompterViT(nn.Module):
    """Prompted ViT backbone; per-task features at 4x the patch grid, or at
    the patch grid with ``upsample_out=False`` (the factored up4 heads own
    the upsample then)."""

    def __init__(self, tasks: Sequence[str], img_size: Tuple[int, int],
                 select_list: Sequence[int], patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 chan_nheads: int = 1, prompt_len: int = 1,
                 tar_dim: int = 300, final_dim: int = 350,
                 use_ctr: bool = False, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, upsample_out: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        T = len(tasks)
        self.tasks = tuple(tasks)
        self.upsample_out = upsample_out
        self.embed_dim = embed_dim
        self.num_prompts = T * prompt_len
        self.tap_set = set(select_list)
        self.depth = depth
        gh, gw = img_size[0] // patch_size, img_size[1] // patch_size
        chan_windows = channel_windows(chan_nheads)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, gh * gw + 1, embed_dim,
                                                  **kw))
        self.task_prompts = nn.Parameter(torch.zeros(T * prompt_len,
                                                     embed_dim, **kw))
        for i in range(depth):
            # the stochastic-depth schedule of taskprompter.py:347
            self.add_module(f"blocks_{i}", PromptedBlock(
                embed_dim, num_heads, self.num_prompts, chan_windows,
                (gh, gw), mlp_ratio, drop_path_rate * i / max(depth - 1, 1),
                **kw))
        for il in range(len(select_list) + 1):
            self.add_module(f"decode_{il}", TaskFeatureDecode(
                tasks, num_heads, prompt_len, chan_windows, embed_dim,
                tar_dim, final_dim, use_ctr, il, **kw))
        self.norm = FusedLN(embed_dim, **kw)

    def forward(self, x, impl: Optional[str] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        B = x.shape[0]
        P, E = self.num_prompts, self.embed_dim
        tokens, (gh, gw) = self.patch_embed(x)
        tokens = tokens + self.pos_embed[:, 1:]
        prompts = self.task_prompts[None].expand(B, P, E)
        joint = torch.cat([prompts, tokens], dim=1)
        task_fea: Dict[str, torch.Tensor] = {}
        il = 0
        for i in range(self.depth):
            # the final tap (after the closing norm) reuses the last block's
            # raw scores, so the last block always computes them
            is_tap = (i + 1) in self.tap_set
            need = is_tap or i == self.depth - 1
            joint, raw = getattr(self, f"blocks_{i}")(
                joint, need, impl=impl, train=train, generator=generator)
            if is_tap:
                x_map = joint[:, P:].reshape(B, gh, gw, E).contiguous()
                fea = getattr(self, f"decode_{il}")(x_map, raw, impl=impl,
                                                    train=train)
                task_fea = {t: task_fea.get(t, 0) + fea[t] for t in self.tasks}
                il += 1
        tokens = self.norm(joint[:, P:].contiguous(), impl=impl)
        fea = getattr(self, f"decode_{il}")(tokens.view(B, gh, gw, E), raw,
                                            impl=impl, train=train)
        out = {t: task_fea.get(t, 0) + fea[t] for t in self.tasks}
        if self.upsample_out:
            out = {t: interpolate(f, (4 * gh, 4 * gw)) for t, f in out.items()}
        return out
