"""JAX package variables -> the port's state dict.

The port's module tree mirrors the JAX package's, so the conversion is a walk
over the flax tree that renames leaves and changes layouts:

  Dense kernel (in, out)              -> nn.Linear weight (out, in)
  Conv kernel HWIO (grouped: I = in/groups, the outputs group-major on
  both sides)                          -> nn.Conv2d weight OIHW (same groups)
  ConvTranspose kernel (kh, kw, in, out) -> nn.ConvTranspose2d weight
                                          (in, out, kh, kw), spatially flipped
  LayerNorm / BatchNorm scale          -> weight
  BatchNorm batch_stats mean / var     -> running_mean / running_var
                                          (+ num_batches_tracked = 0)
  pos_embed, cls_token, task_prompts,
  fuse_attn_kernel, fuse_attn_bias,
  relative_position_bias_table, scales -> as they are
  GroupNorm scale                      -> weight (flax eps 1e-6, set by the
                                          modules)
  DeformConv2d kernel (K*C, out)       -> weight (out, K*C), tap-major columns

The qkv weight stays head-major (H, 3, D): only its transpose changes. Flax
BatchNorm momentum 0.9 is torch's 0.1 and eps 1e-5 on both sides (set by the
modules). A checkpoint of the reference PyTorch repo loads by composition:
``mtt_tpu.models.convert_torch.convert_full_checkpoint`` then this function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# modules that are nn.ConvTranspose in the JAX tree, by their own name
TRANSPOSED_CONVS = ("scale_embed_0", "deconv")


def state_dict_from_flax(variables, transposed=TRANSPOSED_CONVS
                         ) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (arrays convertible with
    numpy) -> a state dict that loads into the port's model strictly.
    ``transposed`` names the modules whose kernel is a transposed conv's:
    flax correlates with the kernel as stored where torch's gradient form
    flips it (mtt_tpu/models/convert_torch.py:37-44)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(variables["params"]):
        a = np.asarray(v, dtype=np.float32)
        *mod, leaf = path
        key = ".".join(mod)
        if not mod:          # a module converted on its own: bare leaf names
            leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            sd[leaf] = torch.tensor(a.T if a.ndim == 2 and leaf == "weight"
                                    else a)
        elif leaf == "kernel" and a.ndim == 2:
            sd[f"{key}.weight"] = torch.tensor(a.T)
        elif leaf == "kernel" and a.ndim == 4 and mod[-1] in transposed:
            sd[f"{key}.weight"] = torch.tensor(
                a[::-1, ::-1].transpose(2, 3, 0, 1).copy())
        elif leaf == "kernel" and a.ndim == 4:
            sd[f"{key}.weight"] = torch.tensor(a.transpose(3, 2, 0, 1))
        elif leaf == "scale":
            sd[f"{key}.weight"] = torch.tensor(a)
        elif leaf == "bias":
            sd[f"{key}.bias"] = torch.tensor(a)
        else:
            sd[".".join(path)] = torch.tensor(a)
    for path, v in _flatten(variables.get("batch_stats", {})):
        a = np.asarray(v, dtype=np.float32)
        *mod, leaf = path
        key = ".".join(mod)
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{key}.{name}"] = torch.tensor(a)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
    return sd
