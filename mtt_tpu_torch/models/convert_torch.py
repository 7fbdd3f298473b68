"""A released reference checkpoint (``.pth.tar``) into the port's state dict
(port of mtt_tpu/models/convert_torch.py).

Maps every parameter and BatchNorm statistic of the reference's published
TaskPrompter-ViT, InvPT (``TransformerNet``) and TaskPrompter-Swin (with
FPN and the FCOS3D head) checkpoints onto the port's module tree, and fails
loudly: a reference key the map expects and the file lacks, a port key left
unfilled, a reference key left unconsumed and a shape that differs each
raise and name the keys (the first 20).

The port keeps torch's layouts, so most tensors only change their names.
What changes besides (the JAX converter's transposes and flips exist only
for flax and are not copied):

  ViT qkv rows (3, H, D)               -> head-major (H, 3, D) (Swin's stay)
  T per-task convs (O, I, kh, kw)      -> one grouped conv (T*O, I, kh, kw),
                                          task-major; their BNs concatenated
  1x1 convs the port holds as Linear   -> weight[:, :, 0, 0]
  DCNv2 weight (O, C, kh, kw)          -> (O, kh*kw*C), tap-major columns
  FCOS3D per-level Scale scalars       -> the (levels, dims) ``scales``
  InvPT mt_proj conv bias              -> folded into its BN running mean
                                          (the port's conv has none)
  ConvTranspose2d (I, O, kh, kw)       -> as it is, not flipped
  num_batches_tracked                  -> consumed; the port's is 0

The modules and the keys the reference creates but never uses (InvPT's
``scale_embed.2``, stage 0's ``fuse_attn`` and ``redu_chan``,
``norm_mt``; Swin's ``relative_position_index`` and ``attn_mask``
buffers) are consumed and dropped. Numpy and torch only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from mtt_tpu_torch.models.convert import (Filler, as_tensor, fit_pos_embed,
                                          qkv_rows_head_major)


def _cat(vs: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat(vs, 0)


def _dcn_weight(v: torch.Tensor) -> torch.Tensor:
    """DCNv2 weight (O, C, kh, kw) -> the port's gather-matmul weight
    (O, kh*kw*C), tap-major columns (ops/deform_conv.py)."""
    return v.permute(0, 2, 3, 1).reshape(v.shape[0], -1)


def reference_state_dict(obj) -> Dict[str, torch.Tensor]:
    """The model state dict inside a loaded reference checkpoint: a
    ``{"model": ...}`` wrapper is unwrapped and a DDP ``module.`` prefix
    stripped."""
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


class Mapper:
    """Collects {port key: tensor} from a reference state dict (torch tensors
    or numpy arrays), tracking which reference keys were consumed. A
    ``partial`` mapper takes what the state dict has and skips the rest
    (``take`` gives None, which ``put`` ignores)."""

    def __init__(self, sd: Dict, partial: bool = False):
        self.sd = sd
        self.partial = partial
        self.used: set = set()
        self.entries: Dict[str, torch.Tensor] = {}

    def take(self, key: str, tf: Optional[Callable] = None
             ) -> Optional[torch.Tensor]:
        if key not in self.sd:
            if self.partial:
                return None
            raise KeyError(f"the reference checkpoint is missing expected "
                           f"key {key}")
        self.used.add(key)
        v = as_tensor(self.sd[key])
        return tf(v) if tf is not None else v

    def take_many(self, keys: Sequence[str], tf: Callable = _cat
                  ) -> torch.Tensor:
        return tf([self.take(k) for k in keys])

    def consume(self, *keys: str) -> None:
        self.used.update(keys)

    def put(self, key: str, value: Optional[torch.Tensor]) -> None:
        if value is not None:
            self.entries[key] = value

    # --- composite helpers -------------------------------------------------
    def copy(self, dst: str, src: str, bias: bool = True) -> None:
        """A Linear, Conv2d or ConvTranspose2d: weight and (if the reference
        has one) bias as they are."""
        self.put(dst + ".weight", self.take(src + ".weight"))
        if bias and src + ".bias" in self.sd:
            self.put(dst + ".bias", self.take(src + ".bias"))

    def ln(self, dst: str, src: str) -> None:
        self.put(dst + ".weight", self.take(src + ".weight"))
        self.put(dst + ".bias", self.take(src + ".bias"))

    def bn(self, dst: str, srcs, mean_shift: Optional[torch.Tensor] = None
           ) -> None:
        """One BatchNorm, or the per-task BNs ``srcs`` concatenated."""
        srcs = [srcs] if isinstance(srcs, str) else list(srcs)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self.put(f"{dst}.{leaf}",
                     self.take_many([f"{s}.{leaf}" for s in srcs]))
        if mean_shift is not None:
            self.put(f"{dst}.running_mean",
                     self.entries[f"{dst}.running_mean"] - mean_shift)
        self.consume(*[s + ".num_batches_tracked" for s in srcs])
        self.put(dst + ".num_batches_tracked", torch.tensor(0))

    def stack(self, dst: str, srcs: Sequence[str]) -> None:
        """Per-task convs into one grouped conv, task-major."""
        self.put(dst + ".weight", self.take_many([s + ".weight" for s in srcs]))
        if srcs[0] + ".bias" in self.sd:
            self.put(dst + ".bias", self.take_many([s + ".bias" for s in srcs]))


# ---------------------------------------------------------------------------
# TaskPrompter ViT and the ViT backbone
# ---------------------------------------------------------------------------

def _map_vit_backbone(m: Mapper, depth: int, heads: int,
                      nested_attn: bool = True, prompted: bool = False):
    m.copy("backbone.patch_embed.proj", "backbone.patch_embed.proj")
    for i in range(depth):
        pb, rb = f"backbone.blocks_{i}", f"backbone.blocks.{i}"
        m.ln(pb + ".norm1", rb + ".norm1")
        m.ln(pb + ".norm2", rb + ".norm2")
        pa = pb + ".attn" if nested_attn else pb
        for leaf in ("weight", "bias"):
            m.put(f"{pa}.qkv.{leaf}", m.take(
                f"{rb}.attn.qkv.{leaf}",
                lambda v: qkv_rows_head_major(v, heads)))
        m.copy(pa + ".proj", rb + ".attn.proj")
        if prompted:
            m.copy(pb + ".token_trans", rb + ".attn.token_trans")
            m.copy(pb + ".token_trans1", rb + ".attn.token_trans1")
        m.copy(pb + ".mlp.fc1", rb + ".mlp.fc1")
        m.copy(pb + ".mlp.fc2", rb + ".mlp.fc2")
    m.ln("backbone.norm", "backbone.norm")
    m.consume("backbone.pos_embed")    # fitted by convert_full_checkpoint


def map_taskprompter_net(sd: Dict, tasks: List[str], depth: int, heads: int,
                         use_ctr: bool = True) -> Mapper:
    """TaskPrompterNet (ViT-B/L): backbone.* and heads.* (reference
    taskprompter.py:168-193 blocks, 330-367 decode convs, 688-698
    ConvHead)."""
    m = Mapper(sd)
    _map_vit_backbone(m, depth, heads, nested_attn=False, prompted=True)
    m.put("backbone.task_prompts", m.take("backbone.task_prompts"))
    b = "backbone."
    for il in range(4):
        pd = f"backbone.decode_{il}"
        m.stack(f"{pd}.spa_{il}",
                [f"{b}fea_decode_spa.{il}.{t}.0" for t in tasks])
        m.stack(f"{pd}.chan_{il}",
                [f"{b}fea_decode_chan.{il}.{t}.0" for t in tasks])
        for j, ref in ((0, 0), (1, 1), (2, 4)):
            m.stack(f"{pd}.fuse{j}_{il}",
                    [f"{b}fea_fuse.{il}.{t}.{ref}" for t in tasks])
        m.bn(f"{pd}.fuse_bn_{il}", [f"{b}fea_fuse.{il}.{t}.2" for t in tasks])
        if use_ctr:
            # 1x1 convs over the head axis; the port holds them as Linear
            for t in tasks:
                for j, ref in ((0, 0), (1, 2)):
                    src = f"{b}ctr_attn_conv.{il}.{t}.{ref}"
                    m.put(f"{pd}.ctr_{il}_{t}_{j}.weight",
                          m.take(src + ".weight", lambda v: v[:, :, 0, 0]))
                    m.put(f"{pd}.ctr_{il}_{t}_{j}.bias",
                          m.take(src + ".bias"))
    for t in tasks:
        m.copy(f"head_{t}.mt_proj.conv", f"heads.{t}.mt_proj.0")
        m.bn(f"head_{t}.mt_proj.bn", f"heads.{t}.mt_proj.1")
        m.copy(f"head_{t}.linear_pred", f"heads.{t}.linear_pred")
    return m


# ---------------------------------------------------------------------------
# TaskPrompter Swin (Cityscapes-3D) + FPN + FCOS3D detection head
# ---------------------------------------------------------------------------

def swin_arch(model_state: Dict[str, torch.Tensor]) -> dict:
    """The keyword arguments of ``map_taskprompter_swin`` read off a port
    TaskPrompterSwinNet's state dict: the stage depths and, with a
    detection head, its FPN inputs and levels, its towers' depth and the
    convs of each branch."""
    def count(fmt):
        n = 0
        while any(k.startswith(fmt.format(n)) for k in model_state):
            n += 1
        return n

    layers = count("backbone.layer{}_block0.")
    arch = {"depths": tuple(count(f"backbone.layer{il}_block{{}}.")
                            for il in range(layers))}
    if "det_head.fcos3d.scales" in model_state:
        h = "det_head.fcos3d."
        n_in = count("det_head.fpn.lateral_{}.")
        arch["det"] = dict(
            n_fpn_in=n_in,
            num_outs=n_in + count("det_head.fpn.extra_conv_{}."),
            stacked_convs=count(h + "cls_tower_{}."),
            cls_convs=count(h + "cls_branch.conv_{}."),
            reg_convs=tuple(count(h + f"reg_branch_{g}.conv_{{}}.")
                            for g in range(count(h + "conv_reg_{}."))),
            dir_convs=count(h + "dir_branch.conv_{}."),
            ctr_convs=count(h + "ctr_branch.conv_{}."),
            scale_dim=model_state[h + "scales"].shape[1])
    return arch


def map_taskprompter_swin(sd: Dict, tasks: List[str], depths: Sequence[int],
                          det: Optional[dict] = None) -> Mapper:
    """TaskPrompterSwinNet: backbone.* (taskprompter_swin.py:236-655),
    heads.{t} DEConvHead and heads.3ddet FCOS3D (det_head.py:128-317,
    fpn.py:105-130). ``det`` (with ``3ddet``): the detection head's FPN
    inputs ``n_fpn_in`` and levels ``num_outs``, ``stacked_convs`` (the
    last one deformable), the convs of each branch (``cls_convs``,
    ``reg_convs`` one count a regression group, ``dir_convs``,
    ``ctr_convs``) and ``scale_dim``, as ``swin_arch`` reads them."""
    m = Mapper(sd)
    b = "backbone."
    m.copy("backbone.patch_embed", b + "patch_embed.proj")
    m.ln("backbone.patch_norm", b + "patch_embed.norm")
    m.put("backbone.task_prompts", m.take(b + "task_prompts"))
    n_layers = len(depths)
    for il in range(n_layers):
        for d in range(depths[il]):
            rb, pb = f"{b}layers.{il}.blocks.{d}", f"backbone.layer{il}_block{d}"
            m.ln(pb + ".norm1", rb + ".norm1")
            m.ln(pb + ".norm2", rb + ".norm2")
            m.put(pb + ".relative_position_bias_table",
                  m.take(rb + ".attn.relative_position_bias_table"))
            m.consume(rb + ".attn.relative_position_index", rb + ".attn_mask")
            m.copy(pb + ".qkv", rb + ".attn.qkv")        # (3, H, D) rows
            m.copy(pb + ".proj", rb + ".attn.proj")
            names = ["token_trans", "chan_q", "chan_kv"]
            if not (il == n_layers - 1 and d == depths[il] - 1):
                names += ["chan_proj", "token_trans1"]
            for name in names + ["mlp.fc1", "mlp.fc2"]:
                m.copy(f"{pb}.{name}", f"{rb}.{name}")
        if il < n_layers - 1:
            rd, pd = f"{b}layers.{il}.downsample", f"backbone.merge_{il}"
            m.ln(pd + ".norm", rd + ".norm")
            for name in ("reduction", "process_chan_attn", "task_prompts_up"):
                m.copy(f"{pd}.{name}", f"{rd}.{name}", bias=False)
            m.copy(pd + ".spa_attn_ds", rd + ".spa_attn_ds")
    m.ln("backbone.norm", b + "norm")

    for il in range(n_layers):
        pd = f"backbone.decode_{il}"
        for t in tasks:
            m.copy(f"{pd}.fea_decode_spa_{il}_{t}",
                   f"{b}fea_decode_spa.{il}.{t}.0")
            m.copy(f"{pd}.fea_decode_chan_{il}_{t}",
                   f"{b}fea_decode_chan.{il}.{t}.0")
            for j, ref in ((0, 0), (1, 1), (2, 4)):
                m.copy(f"{pd}.fea_fuse_{il}_{t}_{j}",
                       f"{b}fea_fuse.{il}.{t}.{ref}")
            m.bn(f"{pd}.fea_fuse_{il}_{t}_bn", f"{b}fea_fuse.{il}.{t}.2")
    for t in tasks:
        if t != "3ddet":
            m.copy(f"backbone.multi_scale_fuse_{t}",
                   f"{b}multi_scale_fuse.{t}")

    # 2D heads (DEConvHead, taskprompter.py:700-715)
    for t in tasks:
        if t == "3ddet":
            continue
        h = f"heads.{t}."
        m.copy(f"head_{t}.deconv", h + "mt_proj.0")     # not flipped
        m.bn(f"head_{t}.bn1", h + "mt_proj.1")
        m.copy(f"head_{t}.conv", h + "mt_proj.3")
        m.bn(f"head_{t}.bn2", h + "mt_proj.4")
        m.copy(f"head_{t}.linear_pred", h + "linear_pred")
    if "3ddet" not in tasks:
        return m

    dh, ph = "heads.3ddet.", "det_head.fcos3d"
    n_fpn_in, num_outs = det["n_fpn_in"], det["num_outs"]

    def conv_gn(dst, src, dcn: bool):
        if dcn:
            m.put(dst + ".dcn.weight", m.take(src + ".conv.weight",
                                              _dcn_weight))
            if src + ".conv.bias" in m.sd:
                m.put(dst + ".dcn.bias", m.take(src + ".conv.bias"))
            # the offset/mask conv: (y, x) interleaved per tap, then 9 masks
            m.copy(dst + ".dcn.offset_mask", src + ".conv.conv_offset")
        else:
            m.copy(dst + ".conv", src + ".conv")
        m.ln(dst + ".gn", src + ".gn")

    # FPN neck: the first n_fpn_in fpn_convs are output convs, the rest extra
    for i in range(n_fpn_in):
        m.copy(f"det_head.fpn.lateral_{i}", dh + f"neck.lateral_convs.{i}.conv")
        m.copy(f"det_head.fpn.fpn_conv_{i}", dh + f"neck.fpn_convs.{i}.conv")
    for j in range(num_outs - n_fpn_in):
        m.copy(f"det_head.fpn.extra_conv_{j}",
               dh + f"neck.fpn_convs.{n_fpn_in + j}.conv")
    for i in range(det["stacked_convs"]):
        dcn = i == det["stacked_convs"] - 1
        conv_gn(f"{ph}.cls_tower_{i}", dh + f"cls_convs.{i}", dcn)
        conv_gn(f"{ph}.reg_tower_{i}", dh + f"reg_convs.{i}", dcn)
    for i in range(det["cls_convs"]):
        conv_gn(f"{ph}.cls_branch.conv_{i}", dh + f"conv_cls_prev.{i}", False)
    m.copy(f"{ph}.conv_cls", dh + "conv_cls")
    for gi, convs in enumerate(det["reg_convs"]):
        for i in range(convs):
            conv_gn(f"{ph}.reg_branch_{gi}.conv_{i}",
                    dh + f"conv_reg_prevs.{gi}.{i}", False)
        m.copy(f"{ph}.conv_reg_{gi}", dh + f"conv_regs.{gi}")
    for i in range(det["dir_convs"]):
        conv_gn(f"{ph}.dir_branch.conv_{i}", dh + f"conv_dir_cls_prev.{i}",
                False)
    m.copy(f"{ph}.conv_dir_cls", dh + "conv_dir_cls")
    for i in range(det["ctr_convs"]):
        conv_gn(f"{ph}.ctr_branch.conv_{i}",
                dh + f"conv_centerness_prev.{i}", False)
    m.copy(f"{ph}.conv_centerness", dh + "conv_centerness")
    # per-level Scale scalars -> the (levels, dims) parameter
    dims = det["scale_dim"]
    m.put(f"{ph}.scales", m.take_many(
        [dh + f"scales.{lvl}.{j}.scale"
         for lvl in range(num_outs) for j in range(dims)],
        lambda vs: torch.stack([v.float().reshape(()) for v in vs])
        .reshape(num_outs, dims)))
    return m


# ---------------------------------------------------------------------------
# InvPT TransformerNet
# ---------------------------------------------------------------------------

def map_transformer_net(sd: Dict, tasks: List[str], depth: int,
                        heads: int) -> Mapper:
    """TransformerNet (InvPT ViT-L): backbone.*, multi_task_decoder.* and
    heads.* (reference vit.py, transformer_decoder.py:18-98,
    invpt.py:419-545)."""
    m = Mapper(sd)
    _map_vit_backbone(m, depth, heads, nested_attn=True, prompted=False)
    m.put("backbone.cls_token", m.take("backbone.cls_token"))

    d, pd = "multi_task_decoder.", "decoder."
    # scale_embed: 0 ConvTranspose (not flipped), 1 Conv; [2] is never
    # consumed downstream (stage 0 has no patch embed: transformer_decoder.py
    # :82-84, invpt.py:405); [3] is None
    m.copy(pd + "scale_embed_0", d + "scale_embed.0")
    m.copy(pd + "scale_embed_1", d + "scale_embed.1")
    m.consume(d + "scale_embed.2.weight", d + "scale_embed.2.bias")
    T = len(tasks)
    for t in tasks:
        for j in (0, 1):
            src = d + f"preliminary_decoder.{t}.{j}"
            m.copy(f"{pd}prelim_{t}_{j}.conv", src + ".conv")
            m.bn(f"{pd}prelim_{t}_{j}.bn", src + ".bn1")
        m.copy(f"{pd}inter_head_{t}", d + f"intermediate_head.{t}")
        m.copy(f"{pd}mix_proj_{t}", d + f"invpt.mix_proj.{t}.0")
        # the reference's mt_proj conv bias ahead of its BN: BN(conv(x) + b)
        # == BN'(conv(x)) with mean' = mean - b
        m.put(f"{pd}mt_proj_{t}.conv.weight",
              m.take(d + f"invpt.mt_proj.{t}.0.weight"))
        m.bn(f"{pd}mt_proj_{t}.bn", d + f"invpt.mt_proj.{t}.1",
             mean_shift=m.take(d + f"invpt.mt_proj.{t}.0.bias"))

    for i in range(3):
        st, ps = d + f"invpt.invpt_stages.{i}.", f"{pd}stage_{i}."
        if i > 0:
            # per-task UpEmbed convs -> grouped convs
            for j, (ci, bi) in enumerate(((1, 2), (4, 5))):
                pe = [st + f"patch_embed.{ti}.proj" for ti in range(T)]
                up = f"{pd}up_embed_{i}.proj{j + 1}"
                m.stack(up + ".conv", [f"{p}.{ci}" for p in pe])
                m.bn(up + ".bn", [f"{p}.{bi}" for p in pe])
        blk, at = st + "blocks.0.", st + "blocks.0.attn."
        m.ln(ps + "norm1", blk + "norm1")
        m.ln(ps + "norm2", blk + "norm2")
        m.copy(ps + "mlp.fc1", blk + "mlp.fc1")
        m.copy(ps + "mlp.fc2", blk + "mlp.fc2")
        # per-task depthwise q convs -> one depthwise grouped conv
        m.stack(ps + "attn.conv_proj_q.conv",
                [at + f"conv_proj_q.{ti}.conv" for ti in range(T)])
        m.bn(ps + "attn.conv_proj_q.bn",
             [at + f"conv_proj_q.{ti}.bn" for ti in range(T)])
        for name in ("proj_q", "proj_k", "proj_v", "proj"):
            m.copy(ps + "attn." + name, at + name)
        if i > 0:
            # 1x1 conv over heads (2H -> H): (H, 2H) kernel and (H,) bias
            m.put(ps + "attn.fuse_attn_kernel",
                  m.take(at + "fuse_attn.weight", lambda v: v[:, :, 0, 0]))
            m.put(ps + "attn.fuse_attn_bias", m.take(at + "fuse_attn.bias"))
        else:
            # stage 0 gets no message; the reference's fuse_attn is unused
            m.consume(at + "fuse_attn.weight", at + "fuse_attn.bias")
        m.ln(f"{pd}norm_mt_{i}", d + f"invpt.norm_mts.{i}")
        for ti, t in enumerate(tasks):
            src = d + f"invpt.redu_chan.{i}.{ti}"
            if i > 0:
                m.copy(f"{pd}redu_chan_{i}_{t}", src)
            else:
                m.consume(src + ".weight", src + ".bias")
    # invpt.norm_mt is created but never applied (invpt.py:492)
    m.consume(d + "invpt.norm_mt.weight", d + "invpt.norm_mt.bias")
    for t in tasks:
        m.copy(f"head_{t}.linear_pred", f"heads.{t}.linear_pred")
    return m


# ---------------------------------------------------------------------------
# apply + verify
# ---------------------------------------------------------------------------

def apply_entries(model_state: Dict[str, torch.Tensor], mapper: Mapper
                  ) -> Dict[str, torch.Tensor]:
    """The mapper's entries over a copy of the port state dict
    ``model_state``, each cast to its key's dtype, then the check: every key
    filled (``pos_embed`` aside, which the caller fits) and every reference
    key consumed."""
    f = Filler(model_state)
    for key, value in mapper.entries.items():
        f[key] = value
    unfilled = [k for k in f.out if k not in f.filled
                and not k.endswith("pos_embed")]
    if unfilled:
        raise ValueError(f"{len(unfilled)} model keys not filled by the "
                         f"checkpoint (first 20): {unfilled[:20]}")
    unused = [k for k in mapper.sd if k not in mapper.used]
    if unused:
        raise ValueError(f"{len(unused)} reference keys not consumed (first "
                         f"20): {unused[:20]}")
    return f.out


def square_grid(tokens: int) -> tuple:
    """The square token grid of a position embedding of ``tokens`` rows,
    with a cls slot or without; anything else raises, as the JAX converter
    does (it infers the grid from the count alone)."""
    for pre in (1, 0):
        g = int(round((tokens - pre) ** 0.5))
        if g * g == tokens - pre:
            return g, g
    raise ValueError(f"cannot resample the position embedding to {tokens} "
                     f"tokens: only a square grid is inferred")


def convert_full_checkpoint(sd: Dict, model: torch.nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """A reference state dict (``reference_state_dict`` of the loaded file)
    -> a state dict that the port ``model`` (a ``TaskPrompterNet``,
    ``TransformerNet`` or ``TaskPrompterSwinNet``) loads strictly. The
    tasks, the ViT's depth and heads (which order its qkv rows), the CTR
    switch and the Swin topology are read off the model. The position
    embedding is resampled only when its shape differs from the model's, to
    the square grid its token count gives."""
    from mtt_tpu_torch.models.wrappers import (TaskPrompterNet,
                                               TaskPrompterSwinNet,
                                               TransformerNet)
    state, tasks, bb = model.state_dict(), list(model.tasks), model.backbone
    if isinstance(model, TaskPrompterSwinNet):
        m = map_taskprompter_swin(sd, tasks, **swin_arch(state))
    elif isinstance(model, TransformerNet):
        m = map_transformer_net(sd, tasks, bb.depth,
                                bb.blocks_0.attn.num_heads)
    elif isinstance(model, TaskPrompterNet):
        m = map_taskprompter_net(sd, tasks, bb.depth, bb.blocks_0.num_heads,
                                 use_ctr=bb.decode_0.use_ctr)
    else:
        raise ValueError(f"no reference layout for {type(model).__name__}")
    out = apply_entries(state, m)
    if "backbone.pos_embed" in out:
        want = tuple(out["backbone.pos_embed"].shape)
        pos = as_tensor(sd["backbone.pos_embed"])
        grid = square_grid(want[1]) if tuple(pos.shape) != want else None
        out["backbone.pos_embed"] = fit_pos_embed(pos, want, grid).to(
            state["backbone.pos_embed"].dtype)
    return out
