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
modules). A checkpoint of the reference PyTorch repo loads through the
port's own ``models/convert_torch.py: convert_full_checkpoint``, which the
tests hold bit for bit to the JAX package's converter followed by this
function. ``trainer_state_from_jax`` carries a whole JAX ``TrainState`` (weights, BN
statistics, Adam's moments and the step) into the port's ``Trainer``.
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


def _states(tree):
    """The optimizer states of an optax chain's state (tuples of named
    tuples), depth first."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        for s in tree:
            yield from _states(s)
    else:
        yield tree


@torch.no_grad()
def trainer_state_from_jax(trainer, state, transposed=TRANSPOSED_CONVS
                           ) -> None:
    """A JAX ``TrainState`` brought to numpy (``step``, ``params``,
    ``batch_stats``, ``opt_state``) into the port's ``Trainer``: the f32
    master weights (and the model's weights rounded from them), the BN
    running statistics, optax's ``ScaleByAdamState`` (``count``, ``mu``,
    ``nu``) as Adam's ``step``, ``exp_avg`` and ``exp_avg_sq`` (or its
    ``TraceState`` as SGD's ``momentum_buffer``), the scheduler's step and
    the trainer's ``step_count``."""
    sd = state_dict_from_flax({"params": state.params,
                               "batch_stats": state.batch_stats}, transposed)
    names = [n for n, _ in trainer.model.named_parameters()]
    for n, m in zip(names, trainer.master):
        m.copy_(sd[n])
    if trainer.master[0] is not next(trainer.model.parameters()):
        for m, w in zip(trainer.master, trainer.model.parameters()):
            w.copy_(m)
    for n, b in trainer.model.named_buffers():
        if b.is_floating_point() and n in sd:
            b.copy_(sd[n])
    opt = trainer.optimizer
    for s in _states(state.opt_state):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            mu = state_dict_from_flax({"params": s.mu}, transposed)
            nu = state_dict_from_flax({"params": s.nu}, transposed)
            for n, m in zip(names, trainer.master):
                opt.state[m] = {
                    "step": torch.tensor(float(np.asarray(s.count)),
                                         dtype=torch.float32),
                    "exp_avg": mu[n].to(m), "exp_avg_sq": nu[n].to(m)}
        elif hasattr(s, "trace"):
            tr = state_dict_from_flax({"params": s.trace}, transposed)
            for n, m in zip(names, trainer.master):
                opt.state[m] = {"momentum_buffer": tr[n].to(m)}
    step = int(np.asarray(state.step))
    sched = trainer.scheduler
    sched.last_epoch = step
    for g, base, lam in zip(opt.param_groups, sched.base_lrs,
                            sched.lr_lambdas):
        g["lr"] = base * lam(step)
    sched._last_lr = [g["lr"] for g in opt.param_groups]
    trainer.step_count = step
