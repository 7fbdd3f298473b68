"""Top-level models and their factory (port of mtt_tpu/models/wrappers.py
``TaskPrompterNet``, ``TransformerNet``, ``TaskPrompterSwinNet`` and
``build_model``).

Every wrapper takes every head of ``HEADS`` (``mlp``, ``conv``, ``deconv``),
as the JAX wrappers do. ``remat`` (activation checkpointing, the JAX
``nn.remat``) recomputes the ViT blocks of ``TransformerNet``, and the Swin
blocks, the 2D heads and the detection head of ``TaskPrompterSwinNet``, in
the backward; JAX's ``TaskPrompterNet`` has none, and ``build_model`` raises
when a TaskPrompter-ViT config asks for it.

The entry points build on the CUDA card unless the caller names another
device; without a card they raise rather than build on the CPU unasked."""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mtt_tpu_torch.config.config import DB_SCALES, task_table
from mtt_tpu_torch.detection.det_params import default_det_params
from mtt_tpu_torch.detection.fcos3d_head import DetectionHead
from mtt_tpu_torch.models.heads import HEADS, ConvHead
from mtt_tpu_torch.models.invpt import InvPTDecoder
from mtt_tpu_torch.models.layers import interpolate, remat_call
from mtt_tpu_torch.models.taskprompter import (TASKPROMPTER_VIT_SPECS,
                                               TaskPrompterViT)
from mtt_tpu_torch.models.taskprompter_swin import TaskPrompterSwin
from mtt_tpu_torch.models.vit import VIT_SPECS, VisionTransformer

# configs/pascal/invpt_vitLp16.yml, the keys the port reads
INVPT_PASCAL_VITL = {
    "model": "TransformerNet", "backbone": "vitL", "head": "mlp",
    "embed_dim": 512, "mtt_resolution_downsample_rate": 2,
    "PRED_OUT_NUM_CONSTANT": 64, "train_db_name": "PASCALContext",
    "val_db_name": "PASCALContext",
    "task_dictionary": {"include_semseg": True, "include_human_parts": True,
                        "include_sal": True, "include_edge": True,
                        "include_normals": True, "edge_w": 0.95},
}
# configs/cityscapes3d/taskprompter_swinB.yml, the keys the port reads
CS3D_SWINB = {
    "model": "TaskPrompter", "backbone": "TaskPrompter_swinB",
    "head": "deconv", "level_embed_dim": 256, "final_embed_dim": 450,
    "prompt_len": 1, "chan_embed_dim": 256, "chan_nheads": 1,
    "img_ds_ratio": 0.75, "dd_label_map_size": (512, 1024),
    "train_db_name": "Cityscapes3D", "val_db_name": "Cityscapes3D",
    "task_dictionary": {"include_semseg": True, "include_depth": True,
                        "include_3ddet": True},
}
_NYUD_TASKS = {"include_semseg": True, "include_depth": True,
               "include_edge": True, "include_normals": True, "edge_w": 0.95}
# configs/nyud/taskprompter_vitLp16.yml, the keys the port reads: 16 channel
# windows (the windowed task decode), no CTR, 768-wide decode and heads
NYUD_TASKPROMPTER_VITL = {
    "model": "TaskPrompter", "backbone": "TaskPrompter_vitL", "head": "conv",
    "embed_dim": 768, "final_embed_dim": 768, "prompt_len": 1,
    "chan_nheads": 16, "use_ctr": False, "train_db_name": "NYUD",
    "val_db_name": "NYUD", "task_dictionary": _NYUD_TASKS,
}
# configs/nyud/invpt_vitLp16.yml, the keys the port reads
NYUD_INVPT_VITL = {
    "model": "TransformerNet", "backbone": "vitL", "head": "mlp",
    "embed_dim": 512, "mtt_resolution_downsample_rate": 2,
    "PRED_OUT_NUM_CONSTANT": 64, "train_db_name": "NYUD",
    "val_db_name": "NYUD", "task_dictionary": _NYUD_TASKS,
}
# configs/pascal/taskprompter_vitBp16.yml, the keys the port reads
PASCAL_TASKPROMPTER_VITB = {
    "model": "TaskPrompter", "backbone": "TaskPrompter_vitB", "head": "conv",
    "embed_dim": 300, "final_embed_dim": 350, "prompt_len": 1,
    "chan_nheads": 1, "use_ctr": True, "train_db_name": "PASCALContext",
    "val_db_name": "PASCALContext",
    "task_dictionary": INVPT_PASCAL_VITL["task_dictionary"],
}
# Swin topologies by backbone name (taskprompter_swin_base_patch4_window12)
TASKPROMPTER_SWIN_SPECS = {
    "TaskPrompter_swinB": dict(embed_dim=128, depths=(2, 2, 18, 2),
                               num_heads=(4, 8, 16, 32), window_size=12),
}
# JAX's build_model under MTT_DEBUG_TINY (mtt_tpu/models/wrappers.py:218-227):
# the backbone, whatever the config names, and the detection head's widths
TINY_SWIN_SPEC = dict(embed_dim=16, depths=(1, 1, 1, 1),
                      num_heads=(2, 2, 2, 2), window_size=4)
TINY_DET = dict(feat_channels=16, norm_groups=4, cls_branch=(16, 8),
                dir_branch=(16,), reg_branch=((16,),) * 5,
                centerness_branch=(16,))


def tiny_det_cfg(det_cfg):
    """A copy of ``det_cfg`` shrunk as JAX's ``build_model`` shrinks the
    config's under MTT_DEBUG_TINY (the caller's dict is left as it is)."""
    d = copy.deepcopy(det_cfg)
    d.update(TINY_DET)
    d["neck"]["out_channels"] = 16
    return d


def default_device(device=None) -> torch.device:
    """The device an entry point builds on: the caller's, else the CUDA
    card. Without a card that is an error, never a silent CPU build."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless "
            "the caller asks for another device (pass device='cpu')")
    return device


def _head(name: str, in_dim: int, num_classes: int,
          up4: str = "dense", **kw) -> nn.Module:
    """``HEADS[name]``; a ConvHead in the mode ``up4`` (the JAX ConvHead's
    default, dense, unless the caller fuses the upsample into it)."""
    if name not in HEADS:
        raise ValueError(f"head {name!r}: one of {tuple(HEADS)}")
    if name == "conv":
        return ConvHead(in_dim, num_classes, up4=up4, **kw)
    return HEADS[name](in_dim, num_classes, **kw)


class TransformerNet(nn.Module):
    """InvPT: ViT backbone + InvPT decoder + per-task heads (``head_name``:
    the 1x1 ``mlp`` of the InvPT configs, the dense ``conv`` head or
    ``deconv``, on the decoder's (B, th, tw, embed_dim + pred_out)
    features). ``forward`` returns the per-task logits resized to the input
    plus ``inter_preds``, the preamble's intermediate predictions resized the
    same way.

    With ``tail_head`` (``mlp`` heads only) an eval forward fuses each task's
    1x1 head into the decoder's tail kernel, so the per-task feature maps
    never reach device memory; the parameter tree is the ``MLPHead`` one
    either way. (The JAX wrapper reads MTT_TAIL_HEAD=1 from the environment
    for this.) ``remat`` checkpoints each ViT block (``remat_call``).
    ``factored_tail`` (JAX: MTT_INVPT_FACTORED=1) runs an eval forward's
    decoder tail as the factored composition in place of the tail kernel;
    ``tail_head`` wins over it, and training takes the dense tail."""

    def __init__(self, tasks: Sequence[str], num_outputs: Dict[str, int],
                 img_size: Tuple[int, int], backbone_name: str = "vitL",
                 head_name: str = "mlp", embed_dim: int = 512,
                 pred_out: int = 64, mtt_downsample: int = 2,
                 drop_path_rate: float = 0.15, tail_head: bool = False,
                 remat: bool = False, factored_tail: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        if tail_head and head_name != "mlp":
            raise ValueError(f"tail_head fuses the 1x1 'mlp' head into the "
                             f"tail kernel; this model's head is "
                             f"{head_name!r}")
        device = default_device(device)
        spec = VIT_SPECS[backbone_name]
        self.tasks = tuple(tasks)
        self.img_size = tuple(img_size)
        self.patch_size = spec["patch_size"]
        self.tail_head = tail_head
        self.backbone = VisionTransformer(
            img_size=img_size, drop_path_rate=drop_path_rate, remat=remat,
            device=device, dtype=dtype, **spec)
        self.decoder = InvPTDecoder(
            self.tasks, dict(num_outputs), embed_dim=embed_dim,
            pred_out=pred_out, backbone_dim=spec["embed_dim"],
            mtt_downsample=mtt_downsample, factored_tail=factored_tail,
            device=device, dtype=dtype)
        for t in self.tasks:
            self.add_module(f"head_{t}", _head(
                head_name, embed_dim + pred_out, num_outputs[t],
                device=device, dtype=dtype))

    def forward(self, x, impl: Optional[str] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) normalised image batch -> {task: (B, H, W, n),
        "inter_preds": {task: (B, H, W, n)}}."""
        size = tuple(x.shape[1:3])
        if size != self.img_size:
            raise ValueError(f"this model's position embedding was built for "
                             f"{self.img_size} inputs, got {size}")
        _, taps = self.backbone(x, train=train, impl=impl,
                                generator=generator)
        grid = (size[0] // self.patch_size, size[1] // self.patch_size)
        head_params = None
        if self.tail_head and not train:
            head_params = {t: getattr(self, f"head_{t}").params()
                           for t in self.tasks}
        feats, inter_preds = self.decoder(taps, grid, train=train,
                                          head_params=head_params, impl=impl,
                                          generator=generator)
        out = {}
        for t in self.tasks:
            logits = feats[t] if head_params is not None else \
                getattr(self, f"head_{t}")(feats[t], train, impl=impl)
            out[t] = interpolate(logits, size)
        out["inter_preds"] = {t: interpolate(v, size)
                              for t, v in inter_preds.items()}
        return out


class TaskPrompterNet(nn.Module):
    """TaskPrompter: prompted ViT backbone + per-task heads, NHWC logits at
    ``target_size`` (default: the input size). With the ``conv`` head and
    ``head_up4="factored"`` (the default, as in the JAX wrapper) or
    ``"phase"`` the backbone returns patch-grid features and each ConvHead
    fuses the 4x upsample into its conv; with ``"dense"``, and for the
    ``mlp`` and ``deconv`` heads, the backbone upsamples and the heads run on
    the 4x maps, as the JAX package does under MTT_HEAD_IMPL=dense|phase
    (its environment switch is this keyword here). ``drop_path_rate`` is
    the stochastic depth of the last block in training (0.15 in JAX)."""

    def __init__(self, tasks: Sequence[str], num_outputs: Dict[str, int],
                 img_size: Tuple[int, int],
                 backbone_name: str = "TaskPrompter_vitB",
                 head_name: str = "conv", tar_dim: int = 300,
                 final_dim: int = 350, prompt_len: int = 1,
                 chan_nheads: int = 1, use_ctr: bool = True,
                 target_size: Optional[Tuple[int, int]] = None,
                 drop_path_rate: float = 0.15,
                 head_up4: Optional[str] = None, *, device=None, dtype=None):
        super().__init__()
        if head_up4 is not None and head_name != "conv":
            raise ValueError(f"head_up4 is the conv head's; this model's "
                             f"head is {head_name!r}")
        head_up4 = head_up4 or "factored"
        fused_up4 = head_name == "conv" and head_up4 != "dense"
        device = default_device(device)
        self.tasks = tuple(tasks)
        self.target_size = target_size
        self.backbone = TaskPrompterViT(
            tasks=self.tasks, img_size=img_size, chan_nheads=chan_nheads,
            prompt_len=prompt_len, tar_dim=tar_dim, final_dim=final_dim,
            use_ctr=use_ctr, drop_path_rate=drop_path_rate,
            upsample_out=not fused_up4, device=device, dtype=dtype,
            **TASKPROMPTER_VIT_SPECS[backbone_name])
        for t in self.tasks:
            self.add_module(f"head_{t}", _head(
                head_name, final_dim, num_outputs[t], up4=head_up4,
                device=device, dtype=dtype))

    def forward(self, x, impl: Optional[str] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalised image batch -> {task: (B, h, w, n)}.
        ``train`` takes batch statistics (and updates the running ones) and
        drop-path masks from ``generator``."""
        target = self.target_size or tuple(x.shape[1:3])
        feats = self.backbone(x, impl=impl, train=train, generator=generator)
        return {t: interpolate(getattr(self, f"head_{t}")(feats[t], train,
                                                          impl=impl), target)
                for t in self.tasks}


class TaskPrompterSwinNet(nn.Module):
    """TaskPrompter-Swin + heads, and the FCOS3D detection head for
    ``3ddet``: the 2D heads' logits are resized to ``target_size`` (default:
    the input size); the detection head takes the backbone's 4-scale list and
    returns per-level lists (cls_scores, bbox_preds, dir_preds,
    centernesses). ``drop_path_rate`` is the backbone's stochastic depth in
    training (0.1 in JAX, which the wrapper leaves at the backbone's
    default). The ``conv`` head is the dense ConvHead on the fused feature
    map, as in JAX. ``remat`` checkpoints each Swin block, each 2D head and
    the detection head (``remat_call``; mtt_tpu/models/wrappers.py:191-203):
    the same results and gradients in less memory."""

    def __init__(self, tasks: Sequence[str], num_outputs: Dict[str, int],
                 img_size: Tuple[int, int], head_name: str = "deconv",
                 tar_dim: int = 256, final_dim: int = 450,
                 prompt_len: int = 1, chan_embed_dim: int = 256,
                 img_ds_ratio: float = 1.0,
                 target_size: Optional[Tuple[int, int]] = None,
                 det_cfg: Optional[dict] = None, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12, drop_path_rate: float = 0.1,
                 remat: bool = False, *, device=None, dtype=None):
        super().__init__()
        device = default_device(device)
        self.tasks = tuple(tasks)
        self.target_size = target_size
        self.det_cfg = det_cfg
        self.remat = remat
        self.backbone = TaskPrompterSwin(
            self.tasks, img_size, embed_dim=embed_dim, depths=depths,
            num_heads=num_heads, window_size=window_size,
            prompt_len=prompt_len, chan_embed_dim=chan_embed_dim,
            tar_dim=tar_dim, final_dim=final_dim, img_ds_ratio=img_ds_ratio,
            drop_path_rate=drop_path_rate, remat=remat, device=device,
            dtype=dtype)
        for t in self.tasks:
            if t == "3ddet":
                if det_cfg is None:
                    raise ValueError("the 3ddet task needs det_cfg "
                                     "(detection.det_params)")
                self.det_head = DetectionHead(
                    det_cfg, (final_dim,) * len(depths), device=device,
                    dtype=dtype)
            else:
                self.add_module(f"head_{t}", _head(
                    head_name, final_dim, num_outputs[t], up4="dense",
                    device=device, dtype=dtype))

    def forward(self, x, impl: Optional[str] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) normalised image batch -> {task: (B, h, w, n)},
        and under ``3ddet`` the detection head's four per-level lists.
        ``train`` takes batch statistics (and updates the running ones) and
        drop-path masks from ``generator``; the detection head has GroupNorm
        only and computes the same either way."""
        target = self.target_size or tuple(x.shape[1:3])
        feats = self.backbone(x, impl=impl, train=train, generator=generator)

        def call(head, *args, **kw):
            if not self.remat:
                return head(*args, **kw)
            return remat_call(head, None, *args, **kw)

        out = {}
        for t in self.tasks:
            if t == "3ddet":
                out[t] = call(self.det_head, feats[t])
            else:
                out[t] = interpolate(call(getattr(self, f"head_{t}"),
                                          feats[t], train, impl=impl), target)
        return out


def vit_taskprompter(p) -> bool:
    """True for a TaskPrompter config on a ViT backbone (not Swin)."""
    return p["model"] == "TaskPrompter" and \
        "swin" not in p["backbone"].lower()


def build_model(p: dict, img_size: Optional[Tuple[int, int]] = None, *,
                tail_head: bool = False, head_up4: Optional[str] = None,
                factored_tail: bool = False,
                debug_tiny: Optional[bool] = None, device=None, dtype=None):
    """Config dict (the keys of configs/pascal/taskprompter_vitLp16.yml or
    taskprompter_vitBp16.yml, configs/pascal/invpt_vitLp16.yml,
    configs/nyud/taskprompter_vitLp16.yml or invpt_vitLp16.yml, or
    configs/cityscapes3d/taskprompter_swinB.yml, or a ``create_config``
    of one) -> model. ``img_size`` defaults to the database's test scale
    (``config.DB_SCALES``); ``tail_head`` is ``TransformerNet``'s and
    ``head_up4`` (``factored``, ``phase`` or ``dense``) TaskPrompter-ViT's
    conv heads'. The config's ``remat`` reaches ``TransformerNet`` and
    TaskPrompter-Swin; JAX's TaskPrompter-ViT has no remat, so a
    TaskPrompter-ViT config that sets it raises. ``factored_tail`` is
    ``TransformerNet``'s (JAX reads MTT_INVPT_FACTORED). ``debug_tiny``
    builds a TaskPrompter-Swin config as JAX's ``build_model`` does under
    MTT_DEBUG_TINY, which is its default here too: ``TINY_SWIN_SPEC`` and,
    where the config has a ``det_cfg``, that config shrunk
    (``tiny_det_cfg``); other models ignore it, as JAX's does."""
    if debug_tiny is None:
        debug_tiny = bool(os.environ.get("MTT_DEBUG_TINY"))
    tasks, num_outputs = task_table(p["train_db_name"], p["task_dictionary"])
    remat = bool(p.get("remat", False))
    if head_up4 is not None and not vit_taskprompter(p):
        raise ValueError(f"head_up4 is TaskPrompter-ViT's; this config "
                         f"builds {p['model']} {p['backbone']}")
    if p["model"] == "TransformerNet":
        return TransformerNet(
            tasks=tasks, num_outputs=num_outputs,
            img_size=img_size or DB_SCALES[p["val_db_name"]][1],
            backbone_name=p["backbone"], head_name=p["head"],
            embed_dim=p["embed_dim"], pred_out=p["PRED_OUT_NUM_CONSTANT"],
            mtt_downsample=p["mtt_resolution_downsample_rate"],
            tail_head=tail_head, remat=remat, factored_tail=factored_tail,
            device=device, dtype=dtype)
    if p["model"] != "TaskPrompter":
        raise NotImplementedError(
            f"only TaskPrompter and InvPT (TransformerNet) are ported, got "
            f"{p['model']}")
    if "swin" in p["backbone"].lower():
        det_cfg = p.get("det_cfg")
        if debug_tiny and det_cfg is not None:
            det_cfg = tiny_det_cfg(det_cfg)
        spec = TINY_SWIN_SPEC if debug_tiny else \
            TASKPROMPTER_SWIN_SPECS[p["backbone"]]
        return TaskPrompterSwinNet(
            tasks=tasks, num_outputs=num_outputs,
            img_size=img_size or DB_SCALES[p["val_db_name"]][1],
            head_name=p["head"], tar_dim=p.get("level_embed_dim", 256),
            final_dim=p["final_embed_dim"], prompt_len=p["prompt_len"],
            chan_embed_dim=p.get("chan_embed_dim", 256),
            img_ds_ratio=float(p.get("img_ds_ratio", 1.0)),
            target_size=tuple(p["dd_label_map_size"])
            if "dd_label_map_size" in p else None,
            det_cfg=(det_cfg or default_det_params())
            if "3ddet" in tasks else None,
            remat=remat, **spec, device=device, dtype=dtype)
    if remat:
        raise ValueError(
            "remat: the JAX package's TaskPrompter-ViT has no remat "
            "(mtt_tpu/models/wrappers.py: build_model ignores the key "
            "there); remove it from this TaskPrompter-ViT config")
    return TaskPrompterNet(
        tasks=tasks, num_outputs=num_outputs,
        img_size=img_size or DB_SCALES[p["val_db_name"]][1],
        backbone_name=p["backbone"], head_name=p["head"],
        tar_dim=p["embed_dim"], final_dim=p["final_embed_dim"],
        prompt_len=p["prompt_len"], chan_nheads=p["chan_nheads"],
        use_ctr=p.get("use_ctr", False),
        target_size=tuple(p["dd_label_map_size"])
        if "dd_label_map_size" in p else None, head_up4=head_up4,
        device=device, dtype=dtype)
