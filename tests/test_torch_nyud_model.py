"""The port's NYUD-v2 serving models and the PASCAL ViT-B config against the
JAX package, on the CPU.

The windowed task decode (``chan_nheads > 1``) alone, then whole NYUD models
at ViT-T size: TaskPrompter (4 tasks, 40 classes, CTR off, 16 and 4 channel
windows, the factored up4 head) and InvPT, on a non-square 8x12 patch grid
(windows of 2x3 and 4x6 cells), so that a wrong window transpose shows. The
JAX weights are made with numpy from a seed over the shapes of the JAX
module's tree and carried into the port by ``state_dict_from_flax`` (strict
load); both sides run the same numpy inputs in f32.

Tolerance: max |port - jax| <= 1e-5 * max |jax| per output (the same function
in f32 with sums in another order; the factored head's f32 GELU is the A&S
erf on both sides). The config dicts are held to their YAML
files, which this box can read (the card's machine has no PyYAML, so the port
keeps them as dicts).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TASKS = ("semseg", "depth", "normals", "edge")
NUM_OUT = {"semseg": 40, "depth": 1, "normals": 3, "edge": 1}
TAR, FIN = 24, 28
IMG = (128, 192)            # an 8x12 patch grid at patch 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _load(port, variables):
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return port.eval()


def _close(got, want, slack=0.0, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    tol = 1e-5 * np.abs(want).max() + slack
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("windows", [(4, 4), (2, 2)])
def test_windowed_task_decode_matches_jax(windows):
    """``TaskFeatureDecode`` with several channel windows on an 8x12 grid:
    the spatial inputs per head group, the channel inputs per window, the
    grouped projections, the task-major interleave and the fuse stack."""
    from mtt_tpu.models.taskprompter import PromptBlockOut as JOut
    from mtt_tpu.models.taskprompter import TaskFeatureDecode as JDecode
    from mtt_tpu_torch.models.taskprompter import (PromptBlockOut,
                                                   TaskFeatureDecode)

    B, gh, gw, C, H, T = 2, 8, 12, 32, 4, len(TASKS)
    x = _rand(0, B, gh, gw, C)
    spa = _rand(1, B, H, T, T + gh * gw)
    chan = _rand(2, B, windows[0] * windows[1], T, C)
    jm = JDecode(tasks=TASKS, num_heads=H, prompt_len=1,
                 chan_windows=windows, tar_dim=TAR, final_dim=FIN,
                 use_ctr=False, layer_idx=1)
    raw = JOut(jnp.asarray(spa), jnp.asarray(chan))
    v = random_variables(jm, (jnp.asarray(x), raw), seed=3)
    want = jm.apply(v, jnp.asarray(x), raw)
    port = _load(TaskFeatureDecode(TASKS, H, 1, windows, C, TAR, FIN, False,
                                   1, device="cpu"), v)
    with torch.no_grad():
        got = port(_t(x), PromptBlockOut(_t(spa), _t(chan)))
    for t in TASKS:
        _close(got[t], want[t], what=t)


def _jax_taskprompter(chan_nheads):
    from mtt_tpu.models.wrappers import TaskPrompterNet
    return TaskPrompterNet(tasks=TASKS, num_outputs=NUM_OUT,
                           backbone_name="TaskPrompter_vitT", tar_dim=TAR,
                           final_dim=FIN, use_ctr=False,
                           chan_nheads=chan_nheads, drop_path_rate=0.0)


@pytest.mark.parametrize("chan_nheads", [16, 4])
def test_nyud_taskprompter_matches_jax(chan_nheads, monkeypatch):
    """The whole NYUD TaskPrompter eval forward (the windowed decode at every
    tap, the raw windowed channel scores of ``PromptedBlock``, the factored
    up4 head) against JAX's factored head."""
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet

    monkeypatch.setenv("MTT_HEAD_IMPL", "factored")
    x = _rand(4, 2, *IMG, 3)
    jm = _jax_taskprompter(chan_nheads)
    v = random_variables(jm, jnp.asarray(x), seed=5)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    port = _load(TaskPrompterNet(TASKS, NUM_OUT, IMG, "TaskPrompter_vitT",
                                 tar_dim=TAR, final_dim=FIN, use_ctr=False,
                                 chan_nheads=chan_nheads, device="cpu"), v)
    nh = int(round(chan_nheads ** 0.5))
    assert port.backbone.decode_0.chan_windows == (nh, chan_nheads // nh)
    with torch.no_grad():
        got = port(_t(x))
    for t, n in NUM_OUT.items():
        assert got[t].shape == (2, *IMG, n)
        _close(got[t], want[t], what=t)


def test_nyud_invpt_matches_jax():
    """The whole NYUD InvPT eval forward (40-class semseg, depth, normals,
    edge), every task map and every intermediate prediction."""
    from mtt_tpu.models.wrappers import TransformerNet as JNet
    from mtt_tpu_torch.models.wrappers import TransformerNet

    size = (64, 128)
    x = _rand(6, 2, *size, 3)
    jm = JNet(tasks=TASKS, num_outputs=NUM_OUT, backbone_name="vitT",
              embed_dim=32, pred_out=8)
    v = random_variables(jm, jnp.asarray(x), seed=7)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = _load(TransformerNet(TASKS, NUM_OUT, size, "vitT", embed_dim=32,
                                pred_out=8, device="cpu"), v)
    with torch.no_grad():
        got = port(_t(x))
    for t, n in NUM_OUT.items():
        assert got[t].shape == (2, *size, n)
        _close(got[t], want[t], what=t)
        _close(got["inter_preds"][t], want["inter_preds"][t],
               what=f"inter_preds.{t}")


@pytest.mark.parametrize("n", [40, 3])
def test_up4_head_plain_at_768_matches_head_xla(n):
    """The up4 head's plain version at NYUD's width C = D = 768 on a 4x6 grid
    against JAX's XLA twin ``_head_xla`` (which the TPU takes for the 40-class
    semseg), f32, both on the A&S erf GELU: 1e-5 of the logit scale."""
    from mtt_tpu.kernels.head_up4 import _head_xla
    from mtt_tpu_torch.kernels.head_up4 import head_up4_plain

    rng = np.random.default_rng(8)
    C = 768
    x = rng.normal(size=(1, 4, 6, C)).astype(np.float32) * 0.3
    kc = rng.normal(size=(3, 3, C, C)).astype(np.float32) * 0.01
    inv = 1.0 + 0.1 * rng.normal(size=(C,)).astype(np.float32)
    addv = 0.1 * rng.normal(size=(C,)).astype(np.float32)
    kp = rng.normal(size=(C, n)).astype(np.float32) * 0.02
    args = (x, kc, inv, addv, kp)
    want = np.asarray(_head_xla(*map(jnp.asarray, args)))
    got = head_up4_plain(*map(_t, args))
    _close(got, want)


def _config_dicts():
    from mtt_tpu_torch import train
    from mtt_tpu_torch.models import wrappers
    return {
        "pascal/taskprompter_vitLp16.yml": train.PASCAL_VITL,
        "pascal/invpt_vitLp16.yml": wrappers.INVPT_PASCAL_VITL,
        "cityscapes3d/taskprompter_swinB.yml": wrappers.CS3D_SWINB,
        "nyud/taskprompter_vitLp16.yml": wrappers.NYUD_TASKPROMPTER_VITL,
        "nyud/invpt_vitLp16.yml": wrappers.NYUD_INVPT_VITL,
        "pascal/taskprompter_vitBp16.yml": wrappers.PASCAL_TASKPROMPTER_VITB,
    }


@pytest.mark.parametrize("path", [
    "pascal/taskprompter_vitLp16.yml", "pascal/invpt_vitLp16.yml",
    "cityscapes3d/taskprompter_swinB.yml", "nyud/taskprompter_vitLp16.yml",
    "nyud/invpt_vitLp16.yml", "pascal/taskprompter_vitBp16.yml"])
def test_config_dict_matches_its_yaml(path):
    """Every key of the port's hand-copied dict equals the YAML file's (the
    task dictionary and the loss weights key by key; tuples as lists)."""
    import yaml

    want = yaml.safe_load((REPO / "configs" / path).read_text())
    got = _config_dicts()[path]

    def norm(v):
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        return list(v) if isinstance(v, tuple) else v

    for key, value in got.items():
        assert key in want, (path, key)
        assert norm(value) == norm(want[key]), (path, key, value, want[key])


def test_build_model_builds_the_new_configs():
    """``build_model`` builds NYUD TaskPrompter-ViT-L (16 windows, 768-wide
    heads), NYUD InvPT-ViT-L and PASCAL TaskPrompter-ViT-B at their test
    scales (meta tensors: no memory)."""
    from mtt_tpu_torch.models.wrappers import (NYUD_INVPT_VITL,
                                               NYUD_TASKPROMPTER_VITL,
                                               PASCAL_TASKPROMPTER_VITB,
                                               build_model)

    tp = build_model(NYUD_TASKPROMPTER_VITL, device="meta")
    assert tp.tasks == TASKS
    assert tp.backbone.pos_embed.shape == (1, 28 * 36 + 1, 1024)
    assert tp.backbone.decode_3.chan_windows == (4, 4)
    assert not tp.backbone.decode_0.use_ctr
    assert tp.head_semseg.linear_pred.out_channels == 40
    assert tp.head_normals.mt_proj.conv.weight.shape == (768, 768, 3, 3)
    inv = build_model(NYUD_INVPT_VITL, device="meta")
    assert inv.tasks == TASKS and inv.img_size == (448, 576)
    assert inv.head_semseg.linear_pred.out_channels == 40
    vb = build_model(PASCAL_TASKPROMPTER_VITB, device="meta")
    assert vb.backbone.depth == 12 and vb.backbone.embed_dim == 768
    assert vb.backbone.decode_0.use_ctr
    assert vb.head_semseg.linear_pred.out_channels == 21
