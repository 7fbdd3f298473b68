"""The port's TaskPrompter-Swin Cityscapes-3D training path against the JAX
package, on the CPU in f32.

One training step of a tiny TaskPrompter-Swin (embed 16, depths (2, 2, 3, 2)
so that stage 2 trains an unshifted and a shifted block through the window
attention, window 4, 64x128 images, batch 2) with semseg, depth and the
FCOS3D detection loss (the detection settings of tests/test_cs3d_e2e.py,
without the deformable conv),
through JAX's ``make_train_step`` and the port's ``Trainer``, on the same
weights (numpy, seeded; carried over by ``state_dict_from_flax``) and the
same synthetic batch (2D labels at 32x64). Drop-path is off on both sides
(the port builds with rate 0; the JAX module's ``DropPath`` is patched to a
pass-through for the step), so that both are deterministic; its schedule and
masks are tested on the port alone. The JAX step runs once, with an optax
transformation that hands the gradients back as its state.

Tolerances: each loss rtol 1e-5 (the same f32 functions with sums in another
order); gradients within 1e-4 of the largest gradient of all plus rtol 1e-4
(the tap blocks' scores and the detection targets pass through long f32
chains on both sides); running statistics rtol 1e-4 with a floor of 1e-5 of
each tensor's largest value. The Adam update against the optax chain fed the
port's own gradients: 1e-6 of the parameter plus 1% of the learning rate (as
tests/test_torch_train.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn

from test_torch_swin_model import TINY, _fill
from torch_threads import torch_threads  # noqa: F401

TINY = dict(TINY, depths=(2, 2, 3, 2))
TASKS = ("semseg", "depth", "3ddet")
NUM_OUT = {"semseg": 19, "depth": 1, "3ddet": 18}
IMG, LABELS = (64, 128), (32, 64)


def _det_cfg(make):
    """tests/test_cs3d_e2e.py's detection settings on either package's
    ``default_det_params``, with plain convs where the last tower conv is a
    deformable one: XLA's CPU compile of the JAX deformable conv's per-tap
    gathers and their gradients over five levels took 40 of the step's 80 s.
    Its gradient has a test of its own (tests/test_torch_detection.py)."""
    d = make(6)
    d["dcn_on_last_conv"] = False
    d["feat_channels"] = 16
    d["cls_branch"] = (16, 8)
    d["reg_branch"] = ((16,),) * 5
    d["dir_branch"] = (16,)
    d["centerness_branch"] = (16,)
    d["norm_groups"] = 4
    d["neck"]["out_channels"] = 16
    d["max_boxes"] = 8
    return d


def _p(det_cfg):
    # a short poly schedule, a clip that binds and an L2 decay, so that the
    # whole optimizer chain shows in one step
    return {
        "train_db_name": "Cityscapes3D", "ignore_index": 255,
        "intermediate_supervision": False,
        "loss_kwargs": {"loss_weights": {"semseg": 100.0, "depth": 1.0,
                                         "3ddet": 1.0}},
        "optimizer": "adam",
        "optimizer_kwargs": {"lr": 1e-3, "weight_decay": 0.01},
        "scheduler": "poly", "max_iter": 10,
        "grad_clip_param": {"max_norm": 1.0, "norm_type": 2},
        "ignore_invalid_area_depth": True, "det_cfg": det_cfg,
        "dd_label_map_size": list(LABELS),
    }


def _jax_config():
    from mtt_tpu.config.config import Config
    from mtt_tpu.detection.det_params import default_det_params
    return Config.wrap(dict(_p(_det_cfg(default_det_params)),
                            TASKS={"NAMES": list(TASKS),
                                   "NUM_OUTPUT": dict(NUM_OUT)}))


def _jax_net(p):
    from mtt_tpu.models.wrappers import TaskPrompterSwinNet
    return TaskPrompterSwinNet(tasks=TASKS, num_outputs=NUM_OUT,
                               det_cfg=p.det_cfg, target_size=LABELS, **TINY)


class _NoDropPath(nn.Module):
    rate: float = 0.0

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        return x


@pytest.fixture(scope="module")
def batch():
    """The seeded synthetic batch, raw (numpy) and on the port's side
    (``to_device``: ImageNet-normalised image, every ``det_*`` array)."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.utils.train_utils import to_device
    raw = SyntheticMT(TASKS, NUM_OUT, IMG, seed=5, max_boxes=8,
                      label_size=LABELS).batch(0, 2)
    tb = to_device(raw, "cpu")
    assert {k for k in tb if k.startswith("det_")} == {
        "det_bboxes2d", "det_labels", "det_boxes3d", "det_centers2d",
        "det_depths", "det_valid"}
    assert tb["semseg"].shape == (2, *LABELS, 1)
    return {k: v.numpy() for k, v in tb.items()}


@pytest.fixture(scope="module")
def variables(batch):
    p = _jax_config()
    x = jnp.asarray(batch["image"])
    shapes = jax.eval_shape(lambda: _jax_net(p).init(jax.random.PRNGKey(0),
                                                     x))
    return _fill(shapes, 7)


@pytest.fixture(scope="module")
def jax_step(variables, batch):
    """(losses, grads, new batch_stats) of one JAX make_train_step, the
    backbone's DropPath patched to a pass-through."""
    import mtt_tpu.models.taskprompter_swin as jswin
    from mtt_tpu.losses.loss_schemes import build_criterion
    from mtt_tpu.utils.train_utils import TrainState, make_train_step

    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))
    p = _jax_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jswin, "DropPath", _NoDropPath)
        step = jax.jit(make_train_step(_jax_net(p), build_criterion(p),
                                       keep_grads, TASKS))
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=keep_grads.init(variables["params"]))
        new, losses = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                           jax.random.PRNGKey(0))
    return (jax.device_get(losses), jax.device_get(new.opt_state),
            jax.device_get(new.batch_stats))


@pytest.fixture(scope="module")
def port_step(variables, batch):
    """(losses, grads by name, running statistics after the forward, the
    parameters before and after the update, the clipped grads, the config)."""
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.wrappers import TaskPrompterSwinNet
    from mtt_tpu_torch.utils.train_utils import Trainer

    p = _p(_det_cfg(default_det_params))
    model = TaskPrompterSwinNet(TASKS, NUM_OUT, IMG, target_size=LABELS,
                                det_cfg=p["det_cfg"], drop_path_rate=0.0,
                                device="cpu", **TINY)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer = Trainer(model, p, TASKS, torch.float32, torch.Generator())
    before = {n: w.detach().clone() for n, w in model.named_parameters()}
    losses = trainer.backward({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = {n: w.grad.clone() for n, w in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    trainer.update()
    after = {n: w.detach().clone() for n, w in model.named_parameters()}
    clipped = {n: w.grad.clone() for n, w in model.named_parameters()}
    return losses, grads, stats, before, after, clipped, p


@pytest.mark.parametrize("task", TASKS + ("total",))
def test_swin_train_step_loss_matches_jax(task, jax_step, port_step):
    np.testing.assert_allclose(float(port_step[0][task]),
                               float(jax_step[0][task]), rtol=1e-5)


def test_swin_train_step_detection_components(port_step):
    """The detection loss's components ride along, finite, and sum to it."""
    losses = port_step[0]
    parts = {k: v for k, v in losses.items() if k.startswith("3ddet.")}
    assert set(parts) == {f"3ddet.loss_{n}" for n in (
        "cls", "offset", "depth", "size", "rotsin", "bbox2d", "dir",
        "centerness")}
    assert all(torch.isfinite(v) for v in parts.values())
    np.testing.assert_allclose(float(sum(parts.values())),
                               float(losses["3ddet"]), rtol=1e-6)


def test_swin_train_step_grads_match_jax(jax_step, port_step):
    """Every parameter's gradient, the window attention's (the Function's
    plain backward) and the relative-position tables' (through the pad and
    gather of ``attention_bias``) included."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    want = state_dict_from_flax({"params": jax_step[1]})
    got = port_step[1]
    assert got.keys() == want.keys()
    scale = max(np.abs(np.asarray(w)).max() for w in want.values())
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    # the blocks that train through the window attention have gradients
    for name in ("backbone.layer2_block0.relative_position_bias_table",
                 "backbone.layer2_block1.relative_position_bias_table",
                 "backbone.layer2_block1.qkv.weight"):
        assert got[name].abs().max() > 1e-3 * scale, name


def test_swin_train_step_bn_stats_match_jax(jax_step, port_step):
    """The decode BNs' and the deconv heads' running statistics (flax
    momentum 0.9 on the biased batch variance)."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    want = state_dict_from_flax({"params": {}, "batch_stats": jax_step[2]})
    got = port_step[2]
    assert got.keys() == {k for k in want if "running" in k}
    assert any("head_semseg.bn1" in k for k in got)
    for name in got:
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                   atol=max(1e-5 * np.abs(w).max(), 1e-7),
                                   err_msg=name)


def test_swin_train_step_adam_update_matches_optax(port_step):
    """The update against build_optimizer's optax chain, all tensors
    flattened into one vector (every op of the chain is elementwise or a
    global norm, so the layout does not matter): the port's clipped
    gradients against optax's clip at rtol 1e-6 (optax sums the squares in
    f32, the port in f64), then L2 decay, Adam and poly fed those clipped
    gradients (as tests/test_torch_train.py)."""
    from mtt_tpu.utils.optim import build_optimizer
    _, grads, _, before, after, clipped, p = port_step
    noclip = _jax_config()
    del noclip["grad_clip_param"]
    tx, _ = build_optimizer(noclip)
    flat = lambda d: jnp.asarray(np.concatenate([d[k].numpy().ravel()
                                                 for k in before]))
    params, g = flat(before), flat(grads)
    max_norm = p["grad_clip_param"]["max_norm"]
    assert float(optax.global_norm(g)) > max_norm
    clip = optax.clip_by_global_norm(max_norm)
    np.testing.assert_allclose(flat(clipped), np.asarray(
        clip.update(g, clip.init(g))[0]), rtol=1e-6, atol=0.0)
    updates, _ = tx.update(flat(clipped), tx.init(params), params)
    lr = p["optimizer_kwargs"]["lr"]
    np.testing.assert_allclose(flat(after), np.asarray(params + updates),
                               rtol=1e-6, atol=0.01 * lr)


@pytest.mark.parametrize("idx", [0, 3])
def test_synthetic_3ddet_sample_matches_jax(idx):
    """The ``3ddet`` sample (boxes drawn from the same generator in the same
    order) equals the JAX package's bit for bit, and the 2D labels at
    ``label_size`` equal cv2's nearest resize of the full-size labels."""
    import cv2
    from mtt_tpu.data.synthetic import SyntheticMT as JSynth
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    want = JSynth(list(TASKS), NUM_OUT, IMG, seed=5, max_boxes=8)[idx]
    full = SyntheticMT(TASKS, NUM_OUT, IMG, seed=5, max_boxes=8)[idx]
    assert set(full) == set(want)
    meta, want_meta = full.pop("meta"), want["meta"]
    assert meta.keys() == want_meta.keys()
    assert np.array_equal(meta.pop("K_matrix"), want_meta["K_matrix"])
    assert all(meta[k] == want_meta[k] for k in meta)
    for k, v in full.items():
        assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k
    assert 1 <= want["det_valid"].sum() <= 5
    small = SyntheticMT(TASKS, NUM_OUT, IMG, seed=5, max_boxes=8,
                        label_size=LABELS)[idx]
    for t in ("semseg", "depth"):
        ref = cv2.resize(want[t][..., 0], LABELS[::-1],
                         interpolation=cv2.INTER_NEAREST)[..., None]
        assert np.array_equal(small[t], ref), t
        assert np.array_equal(small[t], want[t][::2, ::2]), t
    assert np.array_equal(small["det_boxes3d"], want["det_boxes3d"])


def test_swin_drop_path_schedule():
    """Swin-B's 24 blocks take 0.1 * i / 23 (the backbone's default rate,
    which the JAX wrapper does not override; the ViT's is 0.15)."""
    from mtt_tpu_torch.models.wrappers import CS3D_SWINB, build_model
    bb = build_model(CS3D_SWINB, device="meta").backbone
    rates = [getattr(bb, f"layer{il}_block{d}").drop_path
             for il, n in enumerate(bb.depths) for d in range(n)]
    np.testing.assert_allclose(rates, [0.1 * i / 23 for i in range(24)])


def test_swin_drop_path_masks(monkeypatch):
    """In training a block draws a mask at each of the JAX block's four
    places (two in the last block, which keeps its prompts), each at the
    block's rate and from the caller's generator: per sample, the branch is
    kept and scaled by 1 / keep or zero, and the four draws differ. Eval and
    rate 0 draw nothing; training without a generator raises."""
    import mtt_tpu_torch.models.taskprompter_swin as ts
    calls = []
    real = ts.drop_path

    def record(x, rate, generator):
        out = real(x, rate, generator)
        calls.append((x.detach(), rate, out.detach()))
        return out

    monkeypatch.setattr(ts, "drop_path", record)
    B, C, P, rate = 32, 32, 3, 0.4
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, 8 * 12, C)).astype(np.float32))
    prompts = 1 + torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, P, C)).astype(np.float32))
    for last, n_calls in ((False, 4), (True, 2)):
        blk = ts.SwinPromptBlock(C, (8, 12), 2, 4, 2, P, 16, last_block=last,
                                 drop_path=rate)
        calls.clear()
        with torch.no_grad():
            out = blk(x, prompts, train=True,
                      generator=torch.Generator().manual_seed(0))
            again = blk(x, prompts, train=True,
                        generator=torch.Generator().manual_seed(0))
        assert torch.equal(out[0], again[0])                   # seeded
        assert len(calls) == 2 * n_calls
        keeps = []
        for xin, r, got in calls[:n_calls]:
            assert r == rate
            kept = got.flatten(1).abs().amax(1) > 0
            torch.testing.assert_close(got[kept], xin[kept] / (1 - rate))
            keeps.append(kept)
        assert len({tuple(k.tolist()) for k in keeps}) == n_calls
        assert 0.3 < torch.stack(keeps).float().mean() < 0.9
        calls.clear()
        with torch.no_grad():
            blk(x, prompts)
        assert not calls
        with pytest.raises(ValueError, match="torch.Generator"):
            blk(x, prompts, train=True)
