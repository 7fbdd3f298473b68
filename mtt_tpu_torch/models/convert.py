"""Pretrained backbones into the port: a Google ViT ``.npz`` or the
``backbone.*`` subtree of a released reference checkpoint (port of
mtt_tpu/models/convert.py: ``load_vit_npz``, ``load_vit_npz_taskprompter``,
``load_torch_backbone``; the position embedding is resampled by
``vit.resize_pos_embed``, JAX's cubic).

Each function takes the port model's ``state_dict()`` and returns a new one
with the backbone's keys filled; every other key keeps its value. The port
keeps torch's layouts (nn.Linear (out, in), nn.Conv2d OIHW), so a reference
tensor is only renamed, while an npz tensor (flax layouts: Dense (in, out),
Conv HWIO, the attention's q, k, v kernels (C, H, D) and its out kernel
(H, D, C)) is transposed. The port's qkv rows are head-major (H, 3, D), so
the npz's three projections are stacked that way and the reference's
(3, H, D) rows are reordered. Numpy and torch only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mtt_tpu_torch.models.vit import resize_pos_embed

BACKBONE = "backbone."      # the backbone's key prefix in every port model


def as_tensor(v) -> torch.Tensor:
    """A torch tensor or a numpy array (or scalar) as a tensor, sharing
    memory where it can."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def fit_pos_embed(pos, want_shape, grid: Tuple[int, int]) -> torch.Tensor:
    """A (1, 1 + N, C) position embedding fitted to the model's
    ``want_shape``, in f32: as it is when the shapes agree, else resampled
    to ``grid`` by ``vit.resize_pos_embed`` (one prefix token), with the cls
    slot dropped where the model has none."""
    pos = as_tensor(pos).float()
    if tuple(pos.shape) == tuple(want_shape):
        return pos
    pos = resize_pos_embed(pos, grid, 1)
    return pos[:, -want_shape[1]:] if pos.shape[1] != want_shape[1] else pos


def qkv_rows_head_major(v: torch.Tensor, heads: int) -> torch.Tensor:
    """The rows (or the bias) of a fused qkv projection from the reference's
    (3, H, D) order to the port's head-major (H, 3, D)."""
    v = as_tensor(v)
    rows = v.shape[0]
    d = rows // (3 * heads)
    return v.reshape(3, heads, d, *v.shape[1:]).transpose(0, 1) \
        .reshape(rows, *v.shape[1:]).contiguous()


class Filler:
    """Writes tensors into a copy of a state dict (``out``) under
    ``module``, each checked against the shape of the key it replaces and
    cast to its dtype; ``filled`` names the keys written."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], module: str = ""):
        self.out = dict(state_dict)
        self.module = module
        self.filled: set = set()

    def has(self, key: str) -> bool:
        return self.module + key in self.out

    def __setitem__(self, key: str, value) -> None:
        key = self.module + key
        if key not in self.out:
            raise KeyError(f"the port model has no key {key}")
        want, value = self.out[key], as_tensor(value)
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {key}: the source gives "
                             f"{tuple(value.shape)}, the model wants "
                             f"{tuple(want.shape)}")
        self.out[key] = value.to(want.dtype).contiguous()
        self.filled.add(key)


def load_vit_npz(npz_path: str, state_dict: Dict[str, torch.Tensor],
                 depth: int, grid: Tuple[int, int], prefix: str = "",
                 with_cls_token: bool = True,
                 num_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Fill the ViT backbone (``backbone.*``) of a port state dict from a
    Google ViT npz (``prefix``: the npz's key prefix, ``opt/target/`` found
    by itself). Both block layouts load: ``VisionTransformer``'s nested
    ``attn`` and the block-level qkv of ``PromptedBlock``. The position
    embedding is resampled to ``grid`` when its shape differs; ``num_heads``
    (default C // 64) orders the qkv rows."""
    w = np.load(npz_path)
    if not prefix and "opt/target/embedding/kernel" in w:
        prefix = "opt/target/"

    def g(name):
        return np.asarray(w[prefix + name])

    f = Filler(state_dict, BACKBONE)
    f["patch_embed.proj.weight"] = g("embedding/kernel").transpose(3, 2, 0, 1)
    f["patch_embed.proj.bias"] = g("embedding/bias")
    want = tuple(state_dict[BACKBONE + "pos_embed"].shape)
    f["pos_embed"] = fit_pos_embed(
        g("Transformer/posembed_input/pos_embedding"), want, grid)
    if with_cls_token and f.has("cls_token") and prefix + "cls" in w.files:
        f["cls_token"] = g("cls")

    C = f.out[BACKBONE + "patch_embed.proj.bias"].shape[0]
    H = num_heads or C // 64
    for i in range(depth):
        bp = f"Transformer/encoderblock_{i}/"
        mh = bp + "MultiHeadDotProductAttention_1/"
        blk = f"blocks_{i}."
        for dst, src in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_2")):
            f[blk + dst + ".weight"] = g(bp + src + "/scale")
            f[blk + dst + ".bias"] = g(bp + src + "/bias")
        # q, k, v (C, H, D) -> rows (H, 3, D) of the fused (3C, C) weight
        qkv_w = np.stack([g(mh + n + "/kernel").reshape(C, H, C // H)
                          for n in ("query", "key", "value")], axis=2)
        qkv_b = np.stack([g(mh + n + "/bias").reshape(H, C // H)
                          for n in ("query", "key", "value")], axis=1)
        att = blk + "attn." if f.has(blk + "attn.qkv.weight") else blk
        f[att + "qkv.weight"] = qkv_w.reshape(C, 3 * C).T
        f[att + "qkv.bias"] = qkv_b.reshape(3 * C)
        f[att + "proj.weight"] = g(mh + "out/kernel").reshape(C, C).T
        f[att + "proj.bias"] = g(mh + "out/bias")
        for j in (0, 1):
            f[blk + f"mlp.fc{j + 1}.weight"] = \
                g(bp + f"MlpBlock_3/Dense_{j}/kernel").T
            f[blk + f"mlp.fc{j + 1}.bias"] = g(bp + f"MlpBlock_3/Dense_{j}/bias")
    f["norm.weight"] = g("Transformer/encoder_norm/scale")
    f["norm.bias"] = g("Transformer/encoder_norm/bias")
    return f.out


def load_vit_npz_taskprompter(npz_path: str,
                              state_dict: Dict[str, torch.Tensor], depth: int,
                              grid: Tuple[int, int],
                              num_heads: Optional[int] = None
                              ) -> Dict[str, torch.Tensor]:
    """TaskPrompter-ViT: the shared ViT keys from the npz, the prompt
    pathway (task_prompts, token_trans*, the decodes) as it was, as the
    reference's partial load of a pretrained ViT does."""
    return load_vit_npz(npz_path, state_dict, depth, grid,
                        with_cls_token=False, num_heads=num_heads)


def load_torch_backbone(state_dict: Dict, model_state: Dict[str, torch.Tensor],
                        depth: int, grid: Tuple[int, int],
                        prefix: str = "backbone.",
                        num_heads: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """The ``prefix`` subtree of a released checkpoint's state dict (torch
    tensors or numpy arrays) into the backbone (``backbone.*``) of the port
    state dict ``model_state``, as far as it goes: keys the checkpoint lacks
    keep their values. The map is the full converter's
    (``convert_torch._map_vit_backbone``, the block layout read off
    ``model_state``), so the qkv rows are reordered to head-major with
    ``num_heads`` (default C // 64), which the JAX function leaves out; the
    position embedding is resampled to ``grid`` when its shape differs."""
    from mtt_tpu_torch.models.convert_torch import Mapper, _map_vit_backbone
    sd = {BACKBONE + k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}
    m = Mapper(sd, partial=True)
    C = model_state[BACKBONE + "norm.weight"].shape[0]
    _map_vit_backbone(
        m, depth, num_heads or C // 64,
        nested_attn=BACKBONE + "blocks_0.attn.qkv.weight" in model_state,
        prompted=BACKBONE + "blocks_0.token_trans.weight" in model_state)
    for k in ("cls_token", "task_prompts"):
        if BACKBONE + k in model_state:
            m.put(BACKBONE + k, m.take(BACKBONE + k))
    f = Filler(model_state)
    for key, value in m.entries.items():
        f[key] = value
    if BACKBONE + "pos_embed" in sd:
        f[BACKBONE + "pos_embed"] = fit_pos_embed(
            sd[BACKBONE + "pos_embed"],
            model_state[BACKBONE + "pos_embed"].shape, grid)
    return f.out
