"""The port's TaskPrompter-Swin modules and its whole ``TaskPrompterSwinNet``
eval forward (2D heads and the FCOS3D detection head) against the JAX
package, on the CPU.

Small sizes: embed_dim 16, depths (2, 2, 4, 2) (so that an unshifted and a
shifted block of stage 2 are not tap blocks and run the window attention
function), 2 heads, window 4, tasks semseg / depth / 3ddet. The JAX weights
are made with numpy from a seed over the shapes of the JAX module's tree,
carried into the port by ``state_dict_from_flax`` (strict load), and both
sides run the same numpy inputs in f32. On the CPU the JAX window attention
takes its XLA composition, the port its plain version.

Tolerance, unless a test says otherwise: max |port - jax| <= 1e-5 * max |jax|
per output (the same function in f32 with sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_detection import _close, _load, _rand, _t, tiny_det_cfg
from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401

TASKS = ("semseg", "depth", "3ddet")
NUM_OUT = {"semseg": 5, "depth": 1, "3ddet": 18}
TINY = dict(tar_dim=12, final_dim=20, chan_embed_dim=16, embed_dim=16,
            depths=(2, 2, 4, 2), num_heads=(2, 2, 2, 2), window_size=4)


def test_window_helpers_match_jax():
    from mtt_tpu.models import taskprompter_swin as js
    from mtt_tpu_torch.models import taskprompter_swin as ts
    x = _rand(0, 2, 8, 12, 3)
    wins = ts.window_partition(_t(x), 4)
    assert np.array_equal(wins.numpy(), np.asarray(
        js.window_partition(jnp.asarray(x), 4)))
    assert torch.equal(ts.window_reverse(wins, 4, 8, 12), _t(x))
    for ws in (3, 4, 12):
        assert np.array_equal(ts.relative_position_index(ws),
                              js.relative_position_index(ws))
    for H, W, ws, shift in [(8, 12, 4, 2), (24, 48, 12, 6)]:
        assert np.array_equal(ts.shifted_window_mask(H, W, ws, shift),
                              js.shifted_window_mask(H, W, ws, shift))


@pytest.mark.parametrize("size,out", [((8, 12), (6, 9)), ((6, 8), (12, 16)),
                                      ((16, 32), (12, 24))])
def test_antialiased_resize_matches_jax(size, out):
    """``jax.image.resize(..., "linear")`` antialiases when it shrinks (the
    ``img_ds_ratio`` resize, 0.75): torch's bilinear with ``antialias``."""
    from mtt_tpu_torch.models.taskprompter_swin import resize_linear_antialias
    x = _rand(0, 2, *size, 3)
    want = jax.image.resize(jnp.asarray(x), (2, *out, 3), method="linear")
    _close(resize_linear_antialias(_t(x), out), want)


BLOCKS = [  # resolution, shift, need_taps, last_block
    ((8, 12), 0, False, False),     # unshifted, the window attention function
    ((8, 12), 2, False, False),     # shifted: the mask, rolled there and back
    ((8, 12), 2, True, False),      # a tap block: raw scores and maps
    ((6, 10), 2, False, False),     # a padded grid (8 x 12), shifted
    ((6, 10), 0, True, True),       # padded, tap, the last block of all
    ((3, 5), 2, True, False),       # grid under the window: ws 3, no shift
]


@pytest.mark.parametrize("res,shift,taps,last", BLOCKS)
def test_swin_prompt_block_matches_jax(res, shift, taps, last):
    from mtt_tpu.models.taskprompter_swin import SwinPromptBlock as JBlock
    from mtt_tpu_torch.models.taskprompter_swin import SwinPromptBlock
    B, C, P = 2, 32, 3
    x = _rand(0, B, res[0] * res[1], C)
    prompts = 1 + _rand(1, B, P, C)
    jm = JBlock(dim=C, resolution=res, num_heads=2, window_size=4,
                shift_size=shift, prompts_len=P, chan_embed_dim=16,
                last_block=last)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(prompts), taps))
    v = _fill(shapes, 2)
    wx, wp, wraw = jm.apply(v, jnp.asarray(x), jnp.asarray(prompts), taps)
    port = _load(SwinPromptBlock(C, res, 2, 4, shift, P, 16,
                                 last_block=last), v)
    if res == (3, 5):
        assert port.ws == 3 and port.shift == 0 and port.attn_mask is None
    with torch.no_grad():
        gx, gp, graw = port(_t(x), _t(prompts), taps)
    _close(gx, wx, what="x")
    _close(gp, wp, what="prompts")
    assert (graw is None) == (wraw is None) == (not taps)
    if taps:
        _close(graw[0], wraw[0], what="spa_map")
        _close(graw[1], wraw[1], what="raw_chan")
        assert graw[0].shape == (B, 2, P, *res)


def _fill(shapes, seed):
    """``random_variables`` over an already evaluated shape tree, with the
    relative-position bias table at its own scale."""
    import math
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        n = rng.normal(size=s.shape)
        if name == "kernel":
            val = n * math.prod(s.shape[:-1]) ** -0.5
        elif name in ("scale", "var"):
            val = 1.0 + 0.1 * np.abs(n)
        elif name == "task_prompts":
            val = 1.0 + n
        elif name == "relative_position_bias_table":
            val = 0.5 * n
        else:
            val = 0.1 * n
        return np.asarray(val, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_patch_merging_matches_jax():
    """The 2x2 gather order, and the stride-2 conv over the attention maps
    with symmetric padding."""
    from mtt_tpu.models.taskprompter_swin import PatchMerging as JMerge
    from mtt_tpu_torch.models.taskprompter_swin import PatchMerging
    B, C, P, Hd, res = 2, 16, 3, 2, (6, 8)
    x = _rand(0, B, res[0] * res[1], C)
    prompts = _rand(1, B, P, C)
    raw = (_rand(2, B, Hd, P, *res), _rand(3, B, P, C))
    jm = JMerge(C, res, Hd, P)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(prompts),
        tuple(jnp.asarray(r) for r in raw)))
    v = _fill(shapes, 4)
    wx, wp, (wsm, wrc) = jm.apply(v, jnp.asarray(x), jnp.asarray(prompts),
                                  tuple(jnp.asarray(r) for r in raw))
    port = _load(PatchMerging(C, res, Hd, P), v)
    with torch.no_grad():
        gx, gp, (gsm, grc) = port(_t(x), _t(prompts),
                                  tuple(_t(r) for r in raw))
    for g, w, what in ((gx, wx, "x"), (gp, wp, "prompts"),
                       (gsm, wsm, "spa maps"), (grc, wrc, "chan attn")):
        _close(g, w, what=what)
    with pytest.raises(ValueError, match="even"):
        PatchMerging(C, (5, 8), Hd, P)


@pytest.mark.parametrize("tasks", [TASKS, ("semseg", "depth")])
def test_swin_task_decode_matches_jax(tasks):
    """2D tasks upsample 2x before the 1x1 decode convs; ``3ddet`` stays at
    the grid."""
    from mtt_tpu.models.taskprompter_swin import SwinTaskDecode as JDecode
    from mtt_tpu_torch.models.taskprompter_swin import SwinTaskDecode
    B, C, Hd, gh, gw = 2, 16, 2, 3, 5
    P = len(tasks)
    x = _rand(0, B, gh, gw, C)
    raw = (_rand(1, B, Hd, P, gh, gw), _rand(2, B, P, C))
    jm = JDecode(tasks, Hd, 1, 12, 20, 1)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x),
        tuple(jnp.asarray(r) for r in raw)))
    v = _fill(shapes, 3)
    want = jm.apply(v, jnp.asarray(x), tuple(jnp.asarray(r) for r in raw))
    port = _load(SwinTaskDecode(tasks, C, Hd, 1, 12, 20, 1), v)
    with torch.no_grad():
        got = port(_t(x), tuple(_t(r) for r in raw))
    for t in tasks:
        _close(got[t], want[t], what=t)
        assert got[t].shape[1:3] == ((gh, gw) if t == "3ddet"
                                     else (2 * gh, 2 * gw))


def test_deconv_head_matches_jax():
    """The 2x2 stride-2 transposed conv (kernel flipped by the converter)
    gives exactly 2x."""
    from mtt_tpu.models.heads import DEConvHead as JHead
    from mtt_tpu_torch.models.heads import HEADS, DEConvHead
    assert HEADS["deconv"] is DEConvHead
    x = _rand(0, 2, 5, 7, 12)
    jm = JHead(4)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want = jm.apply(v, jnp.asarray(x))
    port = _load(DEConvHead(12, 4), v)
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == (2, 10, 14, 4)
    _close(got, want)
    # training: both BNs on batch statistics, and their running averages
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    _close(port(_t(x), train=True), want, what="train")
    for bn in ("bn1", "bn2"):
        st = upd["batch_stats"][bn]
        _close(getattr(port, bn).running_mean, st["mean"], what=bn)
        _close(getattr(port, bn).running_var, st["var"], what=bn)


def test_swin_backbone_matches_jax():
    """The whole ``TaskPrompterSwin`` at 96x160, which pads stage 2 (6x10 to
    8x12) and shrinks stage 3's window (3x5): the fused 2D maps and the
    4-scale ``3ddet`` list."""
    from mtt_tpu.models.taskprompter_swin import TaskPrompterSwin as JSwin
    from mtt_tpu_torch.models.taskprompter_swin import TaskPrompterSwin
    size = (96, 160)
    kw = dict(TINY)
    x = _rand(0, 1, *size, 3)
    jm = JSwin(tasks=TASKS, img_size=size, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    v = _fill(shapes, 1)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = _load(TaskPrompterSwin(TASKS, size, **kw), v)
    with torch.no_grad():
        got = port(_t(x))
    for t in ("semseg", "depth"):
        assert got[t].shape == (1, 24, 40, 20)
        _close(got[t], want[t], what=t)
    assert [tuple(f.shape[1:3]) for f in got["3ddet"]] == [
        (12, 20), (6, 10), (3, 5), (3, 5)]
    assert port.layer2_block1.pad == (2, 2) and port.layer3_block0.ws == 3
    for i, (g, w) in enumerate(zip(got["3ddet"], want["3ddet"])):
        _close(g, w, what=f"3ddet scale {i}")
    with pytest.raises(ValueError, match="built for"):
        port(torch.zeros(1, 32, 64, 3))


def _nets(size, ratio):
    from mtt_tpu.detection.det_params import default_det_params as jmake
    from mtt_tpu.models.wrappers import TaskPrompterSwinNet as JNet
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.models.wrappers import TaskPrompterSwinNet
    kw = dict(TINY, target_size=(32, 64), img_ds_ratio=ratio)
    jm = JNet(tasks=TASKS, num_outputs=NUM_OUT, det_cfg=tiny_det_cfg(jmake),
              **kw)
    port = TaskPrompterSwinNet(TASKS, NUM_OUT, size,
                               det_cfg=tiny_det_cfg(default_det_params),
                               device="cpu", **kw)
    return jm, port


@pytest.mark.parametrize("size,ratio", [((64, 128), 1.0),
                                        ((128, 256), 0.75)])
def test_swin_net_matches_jax(size, ratio):
    """``TaskPrompterSwinNet`` with the detection head: every 2D map and
    every detection level. 128x256 at ``img_ds_ratio`` 0.75 resizes the image
    with antialiasing and pads stage 2 (6x12 to 8x12)."""
    jm, port = _nets(size, ratio)
    x = _rand(0, 1, *size, 3)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    v = _fill(shapes, 1)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    _load(port, v)
    with torch.no_grad():
        got = port(_t(x))
    for t in ("semseg", "depth"):
        assert got[t].shape == (1, 32, 64, NUM_OUT[t])
        _close(got[t], want[t], what=t)
    for name, gl, wl in zip(("cls", "bbox", "dir", "ctr"), got["3ddet"],
                            want["3ddet"]):
        assert len(gl) == len(wl) == 5
        for i, (g, w) in enumerate(zip(gl, wl)):
            _close(g, w, what=f"{name} level {i}")
    if ratio != 1.0:
        assert port.backbone.in_size == (96, 192)
    # a training forward runs (drop-path masks from the generator) and
    # gives every output at its eval shape; its values against JAX are
    # tests/test_torch_swin_train.py's
    tr = port(_t(x), train=True, generator=torch.Generator().manual_seed(0))
    for t in ("semseg", "depth"):
        assert tr[t].shape == got[t].shape and torch.isfinite(tr[t]).all()
    assert [g.shape for g in tr["3ddet"][0]] == [g.shape for g in
                                                  got["3ddet"][0]]


def test_predict_decodes_detections():
    """``predict`` on the tiny net: post-processed 2D maps and the decoded
    dict of fixed size for ``3ddet``, which needs the camera matrix; the
    decode equals the decode function on the head's output."""
    from mtt_tpu_torch.detection.det_model import decode_bboxes_single
    from mtt_tpu_torch.inference import predict
    from mtt_tpu_torch.models.layers import init_weights
    _, port = _nets((64, 128), 1.0)
    init_weights(port.eval(), torch.Generator().manual_seed(0))
    with torch.no_grad():       # raise the class prior so that boxes survive
        port.det_head.fcos3d.conv_cls.bias.fill_(0.0)
    x = _t(_rand(0, 2, 64, 128, 3))
    K = torch.tensor([[2262.52, 0, 1096.98], [0, 2265.30, 513.137],
                      [0, 0, 1.0]])
    with pytest.raises(ValueError, match="cam_K"):
        predict(port, x)
    logits, preds = predict(port, x, cam_K=K)
    assert preds["semseg"].shape == (2, 32, 64)
    assert preds["depth"].shape == (2, 32, 64) and preds["depth"].min() >= 0
    det = preds["3ddet"]
    n = port.det_cfg["test_cfg"]["max_per_img"]
    assert det["boxes3d"].shape == (2, n, 9)
    assert det["bboxes2d"].shape == (2, n, 4)
    assert det["centers2d"].shape == (2, n, 3)
    assert det["scores"].shape == det["labels"].shape == det["valid"].shape \
        == (2, n)
    assert det["valid"].any() and det["valid"].dtype == torch.bool
    one = decode_bboxes_single(
        tuple([lvl[1] for lvl in part] for part in logits["3ddet"]), K,
        port.det_cfg, port.det_cfg["strides"])
    for k, val in one.items():
        assert torch.equal(det[k][1], val), k
    # one camera per image and a scale factor reach the decode of each image
    Ks = torch.stack([K, K * torch.tensor([[0.5], [0.5], [1.0]])])
    _, preds2 = predict(port, x, cam_K=Ks, scale_factor=(0.5, 0.75))
    one = decode_bboxes_single(
        tuple([lvl[1] for lvl in part] for part in logits["3ddet"]), Ks[1],
        port.det_cfg, port.det_cfg["strides"], (0.5, 0.75))
    for k, val in one.items():
        assert torch.equal(preds2["3ddet"][k][1], val), k


def test_build_model_cs3d_swinb():
    """The Cityscapes-3D config at full width on the meta device: Swin-B's
    topology, the window of 147 tokens at every stage, 19 classes, 18
    detection channels in the task table, the deconv heads and the default
    detection parameters."""
    from mtt_tpu_torch.models.wrappers import (CS3D_SWINB, build_model,
                                               task_table)
    tasks, num_out = task_table(CS3D_SWINB["train_db_name"],
                                CS3D_SWINB["task_dictionary"])
    assert tasks == TASKS and num_out == {"semseg": 19, "depth": 1,
                                          "3ddet": 18}
    model = build_model(CS3D_SWINB, device="meta")
    bb = model.backbone
    assert bb.img_size == (1024, 2048) and bb.in_size == (768, 1536)
    assert bb.grid == (192, 384) and bb.depths == (2, 2, 18, 2)
    assert model.target_size == (512, 1024)
    for il, (heads, dim, res) in enumerate([(4, 128, (192, 384)),
                                            (8, 256, (96, 192)),
                                            (16, 512, (48, 96)),
                                            (32, 1024, (24, 48))]):
        blk = getattr(bb, f"layer{il}_block1")
        assert blk.num_heads == heads and blk.qkv.in_features == dim
        assert dim // heads == 32 and blk.ws == 12 and blk.pad == (0, 0)
        assert blk.resolution == res and blk.shift == 6
        assert blk.attn_mask.shape == (res[0] * res[1] // 144, 147, 147)
        assert blk.chan_kv.in_features == res[0] * res[1]
    assert not hasattr(bb.layer3_block1, "chan_proj")      # the last block
    assert model.head_semseg.linear_pred.out_channels == 19
    assert model.head_semseg.deconv.in_channels == 450
    assert model.det_head.fcos3d.conv_cls.out_channels == 6
    assert model.det_cfg["strides"] == (8, 16, 32, 32, 64)
