"""TaskPrompter-Swin backbone, eval and training forward (port of
mtt_tpu/models/taskprompter_swin.py: ``SwinPromptBlock``, ``PatchMerging``,
``SwinTaskDecode``, ``TaskPrompterSwin`` and the window helpers).

Swin-B with W-MSA / SW-MSA window attention where the task prompts are
repeated into every window and mean-reduced back; the relative-position bias
and the shifted-window mask apply to the patch-patch block only (zero prompt
rows and columns); a channel pathway projects prompts and per-channel pixel
vectors into ``chan_embed_dim``; ``PatchMerging`` downsamples x and the prompt
attention maps and re-projects channel attention and prompts to twice the
width; per stage, ``SwinTaskDecode`` turns x and the raw prompt scores into
task features (2D tasks at twice the grid, ``3ddet`` at the grid itself).

Blocks that are not tap blocks run the window attention kernel
(kernels/window_attention.py); the last block of each stage keeps the raw
pre-scale scores for the decode and runs the same attention as a torch
composition, as it is an XLA composition in the JAX package. LayerNorm and
the MLP run through their kernels. Module names mirror the JAX tree.

In training, drop-path (stochastic depth per sample, rate 0.1 * i / (depth -
1) for block i; the ViT's is 0.15) applies at the JAX block's four places,
each a draw of its own from the caller's generator, and the decode's BNs take
batch statistics (``layers.bn_train``). Gradients reach the window attention
through its backward kernel, the tap blocks' composition through autograd.

Unlike the JAX modules, which read the grid off their input, these are built
for one input size: ``chan_kv`` contracts over a stage's token count, so the
weights depend on it anyway. With ``remat`` each block is checkpointed
(``layers.remat_call``, the JAX ``nn.remat(SwinPromptBlock)``): the same
results and gradients in less memory.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtt_tpu_torch.kernels.window_attention import fused_window_attention_qkv
from mtt_tpu_torch.models.layers import (FusedLN, Mlp, batch_norm, conv1x1,
                                         drop_path, interpolate, remat_call,
                                         to_nchw, to_nhwc)

LN_EPS = 1e-5          # every Swin norm (1e-6 on the ViT side)


def window_partition(x, ws: int):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins, ws: int, H: int, W: int):
    Bn = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(Bn, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(Bn, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws*ws, ws*ws)


def shifted_window_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)  # (nW, N, N)


def resize_linear_antialias(x, size: Tuple[int, int]):
    """``jax.image.resize(..., "linear")`` of an NHWC map: half-pixel
    centres, and a triangle filter widened by the scale where it shrinks."""
    y = F.interpolate(to_nchw(x), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return to_nhwc(y)


class SwinPromptBlock(nn.Module):
    """One Swin block with prompted window attention and the channel
    pathway, for a (H, W) token grid."""

    def __init__(self, dim: int, resolution: Tuple[int, int], num_heads: int,
                 window_size: int, shift_size: int, prompts_len: int,
                 chan_embed_dim: int, last_block: bool = False,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        H, W = resolution
        self.drop_path = drop_path
        # a grid under the window shrinks the window and drops the shift
        ws = min(window_size, H, W)
        self.ws = ws
        self.shift = shift_size if ws == window_size else 0
        self.resolution = (H, W)
        self.num_heads = num_heads
        self.prompts_len = prompts_len
        self.chan_embed_dim = chan_embed_dim
        self.last_block = last_block
        self.pad = ((ws - H % ws) % ws, (ws - W % ws) % ws)

        self.norm1 = FusedLN(dim, LN_EPS, **kw)
        self.token_trans = nn.Linear(dim, chan_embed_dim, **kw)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, **kw)  # (3, H, D)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * ws - 1) * (2 * ws - 1), num_heads, **kw))
        self.proj = nn.Linear(dim, dim, **kw)
        self.chan_q = nn.Linear(chan_embed_dim, chan_embed_dim,
                                bias=qkv_bias, **kw)
        self.chan_kv = nn.Linear(H * W, 2 * chan_embed_dim, bias=qkv_bias,
                                 **kw)
        self.norm2 = FusedLN(dim, LN_EPS, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)
        if not last_block:
            self.chan_proj = nn.Linear(chan_embed_dim, chan_embed_dim, **kw)
            self.token_trans1 = nn.Linear(chan_embed_dim, dim, **kw)

        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(ws).reshape(-1)).to(device),
            persistent=False)
        mask = None
        if self.shift > 0:
            P = prompts_len
            m = shifted_window_mask(H + self.pad[0], W + self.pad[1], ws,
                                    self.shift)
            mask = torch.from_numpy(np.pad(m, ((0, 0), (P, 0), (P, 0)))
                                    ).to(device)
        self.register_buffer("attn_mask", mask, persistent=False)

    def attention_bias(self) -> torch.Tensor:
        """(heads, P+N, P+N) f32: the relative-position bias on the
        patch-patch block, zero prompt rows and columns."""
        N, P = self.ws * self.ws, self.prompts_len
        bias = self.relative_position_bias_table.float()[self.rel_index]
        bias = bias.reshape(N, N, self.num_heads).permute(2, 0, 1)
        return F.pad(bias, (P, 0, P, 0))

    def forward(self, x, prompts, need_taps: bool = False,
                impl: Optional[str] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        H, W = self.resolution
        ws, shift = self.ws, self.shift
        B, L, C = x.shape
        P, Hd = self.prompts_len, self.num_heads
        Dh = C // Hd
        N = ws * ws

        spa_prompts = self.norm1(prompts, impl=impl)
        chan_prompts = self.token_trans(prompts)

        shortcut = x
        xn = self.norm1(x, impl=impl).reshape(B, H, W, C)
        pad_b, pad_r = self.pad
        Hp, Wp = H + pad_b, W + pad_r
        if pad_b or pad_r:            # zeros after the norm, bottom and right
            xn = F.pad(xn, (0, 0, 0, pad_r, 0, pad_b))
        if shift > 0:
            xn = torch.roll(xn, (-shift, -shift), dims=(1, 2))

        wins = window_partition(xn, ws)                  # (B*nW, N, C)
        nW = wins.shape[0] // B
        # the prompts join every window; as a broadcast, whose gradient sums
        # the windows' cotangents with f32 accumulation (repeat_interleave's
        # index_add sums them in bf16, which loses the prompts' gradient
        # over 512 windows)
        pw = spa_prompts[:, None].expand(B, nW, P, C).reshape(B * nW, P, C)
        joint = torch.cat([pw, wins], dim=1)             # (B*nW, P+N, C)
        qkv = self.qkv(joint).view(-1, P + N, 3, Hd, Dh)

        bias_f = self.attention_bias()
        m_f = self.attn_mask
        scale = Dh ** -0.5

        raw = None
        if need_taps:
            # tap blocks keep the raw (pre-scale, pre-bias) scores for the
            # prompt attention maps: a torch composition, f32 scores
            q, k, v = qkv.unbind(2)
            raw = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            attn = raw * scale + bias_f[None]
            if m_f is not None:
                attn = attn + m_f.repeat(B, 1, 1)[:, None]
            probs = torch.softmax(attn, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        else:
            out = fused_window_attention_qkv(qkv, bias_f, m_f, scale, nW,
                                             impl=impl)
        out = self.proj(out.reshape(-1, P + N, C))

        p_out = out[:, :P].reshape(B, nW, P, C).mean(dim=1)
        xw = window_reverse(out[:, P:], ws, Hp, Wp)
        spa_map = None
        if need_taps:
            # raw prompt -> patch scores stitched back to the full map
            rp = raw[:, :, :P, P:]                        # (B*nW, Hd, P, N)
            rp = rp.reshape(B, Hp // ws, Wp // ws, Hd, P, ws, ws)
            spa_map = rp.permute(0, 3, 4, 1, 5, 2, 6).reshape(B, Hd, P, Hp,
                                                              Wp)
        if shift > 0:
            xw = torch.roll(xw, (shift, shift), dims=(1, 2))
            if spa_map is not None:
                spa_map = torch.roll(spa_map, (shift, shift), dims=(3, 4))
        if pad_b or pad_r:
            xw = xw[:, :H, :W]
            if spa_map is not None:
                spa_map = spa_map[:, :, :, :H, :W]
        x_attn = xw.reshape(B, L, C)

        # channel pathway, on the window-attention output before the residual
        cq = self.chan_q(chan_prompts)                    # (B, P, D)
        kv = self.chan_kv(x_attn.transpose(1, 2))         # (B, C, 2D)
        ck, cv = kv.chunk(2, dim=-1)
        raw_chan = torch.einsum("bpd,bcd->bpc", cq.float(), ck.float())
        cprobs = torch.softmax(raw_chan * self.chan_embed_dim ** -0.5, dim=-1)
        # the probabilities enter the product rounded to cv's dtype, as in
        # the JAX module, but their cotangent stays f32: the softmax's
        # backward subtracts nearly equal terms, and rounded to bf16 there
        # it moves the prompts' channel gradients by a large share
        cprobs = cprobs + (cprobs.to(cv.dtype).float() - cprobs).detach()
        chan_x = torch.einsum("bpc,bcd->bpd", cprobs, cv.float()
                              ).to(cv.dtype)                 # (B, P, D)

        def dp(branch):           # a draw of its own at each of the 4 places
            if not train or self.drop_path == 0.0:
                return branch
            return drop_path(branch, self.drop_path, generator)

        x = shortcut + dp(x_attn)
        x = x + dp(self.mlp(self.norm2(x, impl=impl), impl=impl))

        if not self.last_block:
            p_out = p_out + self.token_trans1(self.chan_proj(chan_x))
            prompts = prompts + dp(p_out)
            prompts = prompts + dp(self.mlp(self.norm2(prompts, impl=impl),
                                            impl=impl))
        return x, prompts, ((spa_map, raw_chan) if need_taps else None)


class PatchMerging(nn.Module):
    """2x downsample of the tokens and of the prompt attention maps; channel
    attention and prompts re-projected to twice the width."""

    def __init__(self, dim: int, resolution: Tuple[int, int], num_heads: int,
                 prompts_len: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if resolution[0] % 2 or resolution[1] % 2:
            raise ValueError(f"PatchMerging needs an even token grid, got "
                             f"{resolution}")
        self.resolution = tuple(resolution)
        G = num_heads * prompts_len
        self.norm = FusedLN(4 * dim, LN_EPS, **kw)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, **kw)
        # symmetric padding 1, as the reference's Conv2d(k3, s2, padding=1)
        self.spa_attn_ds = nn.Conv2d(G, G, 3, stride=2, padding=1, **kw)
        self.process_chan_attn = nn.Linear(dim, 2 * dim, bias=False, **kw)
        self.task_prompts_up = nn.Linear(dim, 2 * dim, bias=False, **kw)

    def forward(self, x, prompts, raw, impl: Optional[str] = None):
        H, W = self.resolution
        B, L, C = x.shape
        xm = x.reshape(B, H, W, C)
        xm = torch.cat([xm[:, 0::2, 0::2], xm[:, 1::2, 0::2],
                        xm[:, 0::2, 1::2], xm[:, 1::2, 1::2]], dim=-1)
        xm = xm.reshape(B, (H // 2) * (W // 2), 4 * C)
        xm = self.reduction(self.norm(xm, impl=impl))

        spa_map, raw_chan = raw
        _, Hd, P, _, _ = spa_map.shape
        dt = self.reduction.weight.dtype
        sm = self.spa_attn_ds(spa_map.reshape(B, Hd * P, H, W).to(dt))
        sm = sm.reshape(B, Hd, P, H // 2, W // 2)
        rc = self.process_chan_attn(raw_chan.to(dt))      # (B, P, 2C)
        return xm, self.task_prompts_up(prompts), (sm, rc)


class SwinTaskDecode(nn.Module):
    """Per-stage task-feature decode: the spatial and the channel prompt
    scores each modulate x, a 1x1 conv each, then the fuse stack."""

    def __init__(self, tasks: Sequence[str], in_dim: int, num_heads: int,
                 prompt_len: int, tar_dim: int, final_dim: int,
                 layer_idx: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.tasks = tuple(tasks)
        self.num_heads = num_heads
        self.prompt_len = prompt_len
        self.layer_idx = il = layer_idx
        for t in self.tasks:
            self.add_module(f"fea_decode_spa_{il}_{t}",
                            nn.Conv2d(in_dim, tar_dim, 1, **kw))
            self.add_module(f"fea_decode_chan_{il}_{t}",
                            nn.Conv2d(in_dim, tar_dim, 1, **kw))
            self.add_module(f"fea_fuse_{il}_{t}_0",
                            nn.Conv2d(2 * tar_dim, final_dim, 1, **kw))
            self.add_module(f"fea_fuse_{il}_{t}_1",
                            nn.Conv2d(final_dim, final_dim, 3, padding=1,
                                      **kw))
            self.add_module(f"fea_fuse_{il}_{t}_bn",
                            nn.BatchNorm2d(final_dim, eps=1e-5, momentum=0.1,
                                           **kw))
            self.add_module(f"fea_fuse_{il}_{t}_2",
                            nn.Conv2d(final_dim, final_dim, 3, padding=1,
                                      **kw))

    def forward(self, x_map, raw, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        B, gh, gw, C = x_map.shape
        spa_map, raw_chan = raw         # (B, Hd, P, gh, gw), (B, P, C)
        G = self.num_heads * self.prompt_len
        il = self.layer_idx
        sub = lambda name: getattr(self, name)

        out = {}
        for ti, t in enumerate(self.tasks):
            a = spa_map[:, :, ti * self.prompt_len:(ti + 1) * self.prompt_len]
            a = a.reshape(B, G, gh, gw).permute(0, 2, 3, 1)    # (B, gh, gw, G)
            xg = x_map.reshape(B, gh, gw, G, C // G)
            f = (xg * a[..., None].to(xg.dtype)).reshape(B, gh, gw, C) + x_map
            cw = raw_chan[:, ti]                                # (B, C)
            fc = x_map * cw[:, None, None, :].to(x_map.dtype) + x_map
            if t != "3ddet":
                f = interpolate(f, (2 * gh, 2 * gw))
                fc = interpolate(fc, (2 * gh, 2 * gw))
            f = conv1x1(sub(f"fea_decode_spa_{il}_{t}"), f)
            fc = conv1x1(sub(f"fea_decode_chan_{il}_{t}"), fc)

            cat = conv1x1(sub(f"fea_fuse_{il}_{t}_0"),
                          torch.cat([f, fc], dim=-1))
            cat = sub(f"fea_fuse_{il}_{t}_1")(to_nchw(cat))
            cat = F.gelu(batch_norm(cat, sub(f"fea_fuse_{il}_{t}_bn"), train))
            out[t] = to_nhwc(sub(f"fea_fuse_{il}_{t}_2")(cat))
        return out


class TaskPrompterSwin(nn.Module):
    """Swin-B TaskPrompter; returns {task: feature}: a 2D task gets one map
    fused over the stages at twice the first merged grid, ``3ddet`` the list
    of per-stage maps for the FPN."""

    def __init__(self, tasks: Sequence[str], img_size: Tuple[int, int],
                 patch_size: int = 4, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12, prompt_len: int = 1,
                 chan_embed_dim: int = 256, tar_dim: int = 256,
                 final_dim: int = 450, img_ds_ratio: float = 1.0,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1,
                 remat: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.tasks = tuple(tasks)
        self.img_size = tuple(img_size)
        self.remat = remat
        self.depths = tuple(depths)
        self.img_ds_ratio = img_ds_ratio
        self.in_size = self.img_size if img_ds_ratio == 1.0 else (
            int(img_size[0] * img_ds_ratio), int(img_size[1] * img_ds_ratio))
        P = len(self.tasks) * prompt_len
        ps = patch_size
        self.patch_embed = nn.Conv2d(3, embed_dim, ps, ps, **kw)
        self.patch_norm = FusedLN(embed_dim, LN_EPS, **kw)
        self.task_prompts = nn.Parameter(torch.zeros(P, embed_dim, **kw))

        n_layers = len(self.depths)
        dims = [embed_dim * 2 ** i for i in range(n_layers)]
        res = (self.in_size[0] // ps, self.in_size[1] // ps)
        self.grid = res
        total = sum(self.depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        for il in range(n_layers):
            last_layer = il == n_layers - 1
            for d in range(self.depths[il]):
                last_of_stage = d == self.depths[il] - 1
                self.add_module(f"layer{il}_block{d}", SwinPromptBlock(
                    dims[il], res, num_heads[il], window_size,
                    0 if d % 2 == 0 else window_size // 2, P, chan_embed_dim,
                    last_block=last_layer and last_of_stage,
                    mlp_ratio=mlp_ratio,
                    drop_path=dpr[sum(self.depths[:il]) + d], **kw))
            if not last_layer:
                # the merge first, then the stage's decode on the merged x
                # and maps (strides 8, 16, 32, 32)
                self.add_module(f"merge_{il}", PatchMerging(
                    dims[il], res, num_heads[il], P, **kw))
                res = (res[0] // 2, res[1] // 2)
                self.add_module(f"decode_{il}", SwinTaskDecode(
                    self.tasks, 2 * dims[il], num_heads[il], prompt_len,
                    tar_dim, final_dim, il, **kw))
        self.norm = FusedLN(dims[-1], LN_EPS, **kw)
        self.add_module(f"decode_{n_layers - 1}", SwinTaskDecode(
            self.tasks, dims[-1], num_heads[-1], prompt_len, tar_dim,
            final_dim, n_layers - 1, **kw))
        for t in self.tasks:
            if t != "3ddet":
                self.add_module(f"multi_scale_fuse_{t}", nn.Conv2d(
                    final_dim, final_dim, 3, padding=1, **kw))

    def forward(self, x, impl: Optional[str] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) normalised image batch. ``train`` takes batch
        statistics (and updates the running ones) and drop-path masks from
        ``generator``."""
        if tuple(x.shape[1:3]) != self.img_size:
            raise ValueError(f"this backbone was built for {self.img_size} "
                             f"inputs (the channel pathway contracts over "
                             f"the token count), got {tuple(x.shape[1:3])}")
        B = x.shape[0]
        if self.img_ds_ratio != 1.0:
            x = resize_linear_antialias(x, self.in_size)
        dt = self.patch_embed.weight.dtype
        x = to_nhwc(self.patch_embed(to_nchw(x.to(dt))))
        _, gh, gw, C = x.shape
        x = self.patch_norm(x.contiguous(), impl=impl).reshape(B, gh * gw, C)
        prompts = self.task_prompts.to(dt)[None].expand(B, -1, -1).contiguous()

        n_layers = len(self.depths)
        task_fea: Dict[str, List[torch.Tensor]] = {t: [] for t in self.tasks}
        res = (gh, gw)
        raw = None
        for il in range(n_layers):
            for d in range(self.depths[il]):
                block = getattr(self, f"layer{il}_block{d}")
                args = (x, prompts, d == self.depths[il] - 1)
                kw = dict(impl=impl, train=train, generator=generator)
                x, prompts, r = remat_call(block, generator, *args, **kw) \
                    if self.remat else block(*args, **kw)
                if r is not None:
                    raw = r
            if il < n_layers - 1:
                x, prompts, raw = getattr(self, f"merge_{il}")(
                    x, prompts, raw, impl=impl)
                res = (res[0] // 2, res[1] // 2)
                fea = getattr(self, f"decode_{il}")(
                    x.reshape(B, res[0], res[1], -1), raw, train)
                for t in self.tasks:
                    task_fea[t].append(fea[t])

        x = self.norm(x, impl=impl)
        fea = getattr(self, f"decode_{n_layers - 1}")(
            x.reshape(B, res[0], res[1], -1), raw, train)
        for t in self.tasks:
            task_fea[t].append(fea[t])

        # 2D tasks: the stages' maps summed at the first one's size, the
        # largest; 3ddet: the raw list
        out = {}
        for t in self.tasks:
            if t == "3ddet":
                out[t] = task_fea[t]
                continue
            tgt = tuple(task_fea[t][0].shape[1:3])
            summed = sum(interpolate(f, tgt) for f in task_fea[t])
            out[t] = to_nhwc(getattr(self, f"multi_scale_fuse_{t}")(
                to_nchw(summed)))
        return out
