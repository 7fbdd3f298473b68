"""ViT backbone with multi-depth feature taps, the InvPT encoder (port of
mtt_tpu/models/vit.py: ``VisionTransformer``, ``resize_pos_embed``,
``VIT_SPECS``, ``build_vit``).

ViT-B/L with a cls token and a learned position embedding; tokens are tapped
after the blocks in ``select_list`` and after the final norm, with the cls row
stripped. With ``remat`` each block is checkpointed (``layers.remat_call``,
the JAX ``nn.remat(ViTBlock)``). Module names mirror the JAX tree.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mtt_tpu_torch.models.layers import (FusedLN, PatchEmbed, ViTBlock,
                                         remat_call)


def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(method="cubic")`` along one
    axis, in f32 as ``jax._src.image.scale.compute_weight_mat`` forms them:
    the Keys kernel with a = -0.5 at half-pixel centres, widened by the scale
    when shrinking (antialias), each row normalised to sum 1, zero for a
    sample outside [-0.5, n_in - 0.5]."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kscale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :]) / kscale
    w = np.where(x < 1.0, ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0),
                 np.where(x < 2.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0))
                          * x + f32(2.0), f32(0.0)))
    total = w.sum(1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


def resize_pos_embed(pos_embed: torch.Tensor, new_grid: Tuple[int, int],
                     num_prefix_tokens: int = 1) -> torch.Tensor:
    """Bicubic resample of the grid part of a (1, 1 + N, C) position
    embedding, used when the resolution differs from the pretrained grid. The
    cubic is JAX's (Keys a = -0.5, normalised), not torch's a = -0.75."""
    tok = pos_embed[:, :num_prefix_tokens]
    grid = pos_embed[0, num_prefix_tokens:]
    n, c = grid.shape
    gs_old = int(round(n ** 0.5))
    grid = grid.reshape(gs_old, gs_old, c)
    Rh = torch.from_numpy(_cubic_resize_matrix(gs_old, new_grid[0])).to(grid)
    Rw = torch.from_numpy(_cubic_resize_matrix(gs_old, new_grid[1])).to(grid)
    grid = torch.einsum("Hh,hwc,Ww->HWc", Rh, grid, Rw)
    return torch.cat([tok, grid.reshape(1, new_grid[0] * new_grid[1], c)], 1)


class VisionTransformer(nn.Module):
    """ViT encoder returning multi-scale token taps: ``forward`` gives
    (final_tokens, [tap_0, ..., tap_k]), each tap (B, gh * gw, C) with the cls
    token stripped; the last tap is the final norm's output."""

    def __init__(self, img_size: Tuple[int, int], select_list: Sequence[int],
                 patch_size: int = 16, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, remat: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.select_list = tuple(select_list)
        self.depth = depth
        self.remat = remat
        gh, gw = img_size[0] // patch_size, img_size[1] // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, **kw))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, gh * gw + 1, embed_dim, **kw))
        for i in range(depth):
            self.add_module(f"blocks_{i}", ViTBlock(
                embed_dim, num_heads, mlp_ratio,
                drop_path=drop_path_rate * i / max(depth - 1, 1), **kw))
        self.norm = FusedLN(embed_dim, **kw)

    def forward(self, x, train: bool = False, impl: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        tokens, _ = self.patch_embed(x)
        B = tokens.shape[0]
        tokens = torch.cat([self.cls_token.to(tokens.dtype).expand(B, -1, -1),
                            tokens], 1) + self.pos_embed.to(tokens.dtype)
        taps: List[torch.Tensor] = []
        for i in range(self.depth):
            block = getattr(self, f"blocks_{i}")
            if self.remat:
                tokens = remat_call(block, generator, tokens, train, impl,
                                    generator)
            else:
                tokens = block(tokens, train, impl, generator)
            if (i + 1) in self.select_list:
                taps.append(tokens[:, 1:])
        final = self.norm(tokens, impl=impl)[:, 1:]
        taps.append(final)
        return final, taps


VIT_SPECS = {
    "vitL": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16,
                 select_list=(6, 12, 18)),
    "vitB": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12,
                 select_list=(3, 6, 9)),
    # tiny spec for unit tests
    "vitT": dict(patch_size=16, embed_dim=64, depth=4, num_heads=4,
                 select_list=(1, 2, 3)),
}


def build_vit(name: str, img_size: Tuple[int, int],
              drop_path_rate: float = 0.15, *, device=None,
              dtype=None) -> VisionTransformer:
    return VisionTransformer(img_size=tuple(img_size),
                             drop_path_rate=drop_path_rate, device=device,
                             dtype=dtype, **VIT_SPECS[name])
