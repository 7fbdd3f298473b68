"""The port's InvPT training path against the JAX package, on the CPU in f32.

One training step of InvPT-ViT-T (``vitT``, embed_dim 32, PRED_OUT 16, NYUD's
4 tasks, which cover depth, 128x128, batch 2) with intermediate supervision,
through the JAX ``make_train_step`` and the port's ``Trainer``, on the same
weights (numpy, seeded; carried into the port by ``state_dict_from_flax``)
and the same synthetic batch. Drop-path is off on both sides, so that both
are deterministic: the backbone is built with rate 0, and the decoder, whose
blocks keep their own rate of 0.15 in both packages whatever
``drop_path_rate`` says, runs with the JAX ``DropPath`` patched to a
pass-through and the port's decoder blocks set to rate 0, for the test only.
The JAX step is compiled once, with an optax transformation that hands the
gradients back as its state, so that losses, gradients and batch statistics
come from the one step. 128x128 and not 64x64: at 64x64 the first stage's
query grid is 1x1, so its batch-statistics BN normalises 2 values a channel
(mean up to 714 standard deviations), and its f32 gradients are rounding
noise in both packages; at 128x128 every BN sees at least 8 values a
channel.

Tolerances (those of tests/test_torch_train.py): losses, every ``inter_*``
included, rtol 1e-5; gradients and running statistics rtol 1e-4 with a floor
of 1e-5 times each tensor's largest value and never below 1e-7 (the same f32
functions with sums in another order). The labels at the kinks of the L1
terms are ignored (``batch``: the gradient is not defined there). Every
gradient is held to JAX's step in f64 as well as to its f32 step; where the
two f32 gradients part by more than the tolerance, the f64 step decides
which is the nearer, for at most 2% of the tensors
(``test_invpt_train_step_grads_match_jax``: sums that cancel, which XLA's f32
sums carry farther from exact than the port's). Parameters after two Adam
steps against the optax chain of the JAX config fed the port's gradients:
1e-6 of the parameter plus 1% of the learning rate.

Also here: the 5-task PASCAL criterion with intermediate terms against the
JAX ``build_criterion`` on seeded logits; the three training config dicts
against their YAML files; ``train_and_score`` on the CPU for
``pascal_invpt_vitl`` at a tiny size.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn

from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TASKS = ("semseg", "depth", "normals", "edge")
NUM_OUT = {"semseg": 40, "depth": 1, "normals": 3, "edge": 1}
EMBED, PRED = 32, 16
IMG = (128, 128)
P = {
    "model": "TransformerNet", "backbone": "vitT", "head": "mlp",
    "embed_dim": EMBED, "mtt_resolution_downsample_rate": 2,
    "PRED_OUT_NUM_CONSTANT": PRED, "train_db_name": "NYUD",
    "val_db_name": "NYUD", "ignore_index": 255,
    "intermediate_supervision": True,
    # a short poly schedule and an L2 decay, so that both show in 2 steps;
    # no gradient clip, as in the InvPT configs
    "max_iter": 10, "optimizer": "adam",
    "optimizer_kwargs": {"lr": 0.001, "weight_decay": 0.01},
    "scheduler": "poly",
    "task_dictionary": {"include_semseg": True, "include_depth": True,
                        "include_edge": True, "include_normals": True,
                        "edge_w": 0.95},
    "loss_kwargs": {"loss_weights": {"semseg": 1.0, "depth": 1.0,
                                     "normals": 10.0, "edge": 50.0}},
}


def _jax_config(p=P, tasks=TASKS, num_out=NUM_OUT):
    """The JAX package's view of a port config, as create_config builds it."""
    from mtt_tpu.config.config import Config
    return Config.wrap(dict(p, edge_w=p["task_dictionary"]["edge_w"],
                            TASKS={"NAMES": list(tasks),
                                   "NUM_OUTPUT": dict(num_out)}))


def _jax_net(dtype=np.float32):
    from mtt_tpu.models.wrappers import TransformerNet
    return TransformerNet(tasks=TASKS, num_outputs=NUM_OUT,
                          backbone_name="vitT", embed_dim=EMBED,
                          pred_out=PRED, drop_path_rate=0.0, dtype=dtype)


class _NoDropPath(nn.Module):
    rate: float = 0.0

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        return x


def _raw_batch():
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.utils.train_utils import to_device
    raw = SyntheticMT(TASKS, NUM_OUT, IMG, seed=3).batch(0, 2)
    return {k: v.numpy() for k, v in to_device(raw, "cpu").items()}


@pytest.fixture(scope="module")
def variables():
    return random_variables(_jax_net(), jnp.asarray(_raw_batch()["image"]),
                            seed=11)


KINK = 1e-4


@pytest.fixture(scope="module")
def batch(variables):
    """The seeded synthetic batch, with the labels of the pixels where an L1
    term sits within KINK of its kink set to the ignore value (255 on every
    channel): the normals L1 on the normalised prediction and the depth L1
    are not differentiable there, and a pixel 5e-7 from a normals kink moved
    the gradients of whole tensors by up to 1.6e-3 of themselves between two
    f32 evaluations (a flipped sign at a prediction of norm 0.023). Found on
    the port's f32 forward at these weights; both packages then see the same
    batch."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    b = _raw_batch()
    model = _port_net()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(b["image"]), train=True)
    kinks = {}
    for key, preds in (("", out), ("inter ", out["inter_preds"])):
        n = preds["normals"].numpy()
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        near_n = (np.abs(n - b["normals"]) < KINK).any(-1)
        near_d = np.abs(preds["depth"].numpy() - b["depth"])[..., 0] < KINK
        for t, near in (("normals", near_n), ("depth", near_d)):
            b[t][near] = 255.0
            kinks[key + t] = int(near.sum())
    b["kinks"] = kinks
    return b


def _jax_train_step(variables, batch, dtype):
    """(losses, grads, new batch_stats) of one JAX make_train_step in
    ``dtype`` on ``variables`` and ``batch`` cast to it, the decoder's
    DropPath patched to a pass-through. In f64 (x64 on), every
    ``jnp.float32`` of the JAX package reads as f64 while the step is
    traced, so that its f32 casts keep the sums in f64."""
    import mtt_tpu.models.invpt as jinvpt
    from mtt_tpu.losses.loss_schemes import build_criterion
    from mtt_tpu.utils.train_utils import TrainState, make_train_step

    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))

    def cast(tree):
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)),
                            tree)

    f64 = dtype == np.float64
    with jax.enable_x64(f64), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinvpt, "DropPath", _NoDropPath)
        if f64:
            mp.setattr(jnp, "float32", jnp.float64)
        step = jax.jit(make_train_step(_jax_net(dtype),
                                       build_criterion(_jax_config()),
                                       keep_grads, TASKS))
        params = cast(variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=cast(variables["batch_stats"]),
                           opt_state=keep_grads.init(params))
        new, losses = step(state, cast({k: v for k, v in batch.items()
                                        if k != "kinks"}),
                           jax.random.PRNGKey(0))
        return (jax.device_get(losses), jax.device_get(new.opt_state),
                jax.device_get(new.batch_stats))


@pytest.fixture(scope="module")
def jax_step(variables, batch):
    """The JAX step in f32, as the port's is run."""
    return _jax_train_step(variables, batch, np.float32)


@pytest.fixture(scope="module")
def jax_exact_grads(variables, batch):
    """The gradients of the JAX step in f64 throughout: the exact values to
    f32's accuracy (rounded to f32 by ``state_dict_from_flax``)."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    return state_dict_from_flax(
        {"params": _jax_train_step(variables, batch, np.float64)[1]})


def _port_net():
    """The port's InvPT-ViT-T with drop-path off: the backbone built at rate
    0, the decoder blocks' fixed 0.15 set to 0 here."""
    from mtt_tpu_torch.models.wrappers import TransformerNet
    model = TransformerNet(TASKS, NUM_OUT, IMG, "vitT", embed_dim=EMBED,
                           pred_out=PRED, drop_path_rate=0.0, device="cpu")
    for i in range(3):
        getattr(model.decoder, f"stage_{i}").drop_path = 0.0
    return model


@pytest.fixture(scope="module")
def port_step(variables, batch):
    """(losses, grads of 2 steps by name, running statistics after step 1,
    parameters before and after each step)."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.utils.train_utils import Trainer

    model = _port_net()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer = Trainer(model, P, TASKS, torch.float32, torch.Generator())
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if k != "kinks"}
    names = [n for n, _ in model.named_parameters()]
    history = [{n: w.detach().clone() for n, w in model.named_parameters()}]
    losses, grads, stats = None, [], None
    for i in range(2):
        out = trainer.backward(tb)
        grads.append({n: w.grad.clone() for n, w in zip(
            names, model.parameters())})
        if i == 0:
            losses = out
            stats = {k: v.clone() for k, v in model.state_dict().items()
                     if "running" in k}
        trainer.update()
        history.append({n: w.detach().clone()
                        for n, w in model.named_parameters()})
    return losses, grads, stats, history


def _close(got, want, rtol=1e-4, atol=None, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    if atol is None:
        atol = max(1e-5 * np.abs(want).max(), 1e-7)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("name", TASKS + tuple(f"inter_{t}" for t in TASKS)
                         + ("total",))
def test_invpt_train_step_loss_matches_jax(name, jax_step, port_step):
    """Every task loss, every intermediate term and the total."""
    assert set(port_step[0]) == set(jax_step[0])
    np.testing.assert_allclose(float(port_step[0][name]),
                               float(jax_step[0][name]), rtol=1e-5)


def _within(got, want, rtol=1e-4):
    want = np.asarray(want, np.float64)
    atol = max(1e-5 * np.abs(want).max(), 1e-7)
    return bool(np.all(np.abs(np.asarray(got, np.float64) - want)
                       <= atol + rtol * np.abs(want)))


def test_invpt_train_step_grads_match_jax(jax_step, port_step,
                                          jax_exact_grads):
    """Every parameter's gradient: the backbone, the preamble convs and BNs
    (batch statistics), the grouped and depthwise convs of the stages, the
    message-passing attention's ported VJP, the dense training tail. Each is
    held to JAX's f64 step, and to JAX's f32 step. Where the two f32 results
    part by more than the tolerance, the JAX one must be the farther from
    the f64 one: the depth tail's conv weights and the biases ahead of its
    batch-statistics BN, whose gradients are sums that cancel to 1e-4 of the
    largest (the depth L1's cotangent has one sign at these random weights),
    which XLA's f32 sums on the CPU carry 2e-4 from exact and the port 2e-5.
    At most 2% of the tensors may be such."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    want = state_dict_from_flax({"params": jax_step[1]})
    got = port_step[1][0]
    assert got.keys() == want.keys() == jax_exact_grads.keys()
    parted = []
    for name in got:
        g, w = got[name].numpy(), want[name].numpy()
        x = jax_exact_grads[name].numpy()
        assert g.shape == w.shape == x.shape, name
        assert _within(g, x), name
        if _within(g, w):
            continue
        assert np.abs(w - x).max() > np.abs(g - x).max(), name
        parted.append(name)
    assert len(parted) <= 0.02 * len(got), parted


def test_invpt_train_step_bn_stats_match_jax(jax_step, port_step):
    """Every running statistic after the step: the fast variance of flax
    ``nn.BatchNorm`` in the preamble and the stages, the centred variance of
    the dense tail, momentum 0.9."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    want = state_dict_from_flax({"params": {}, "batch_stats": jax_step[2]})
    got = port_step[2]
    assert got.keys() == {k for k in want if "running" in k}
    assert any("mt_proj" in k for k in got)
    for name in got:
        _close(got[name], want[name], msg=name)


def test_invpt_optimizer_steps_match_optax(port_step):
    """Two updates of the port against the JAX config's optax chain (no
    clip: the InvPT configs have none; L2 decay, Adam, poly) fed the port's
    own gradients, on trees in the port's layout."""
    from mtt_tpu.utils.optim import build_optimizer
    _, grads, _, history = port_step
    tx, _ = build_optimizer(_jax_config())
    params = {k: jnp.asarray(v.numpy()) for k, v in history[0].items()}
    state = tx.init(params)

    @jax.jit
    def update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    for i in range(2):
        g = {k: jnp.asarray(v.numpy()) for k, v in grads[i].items()}
        params, state = update(g, state, params)
        for name, w in history[i + 1].items():
            _close(w, params[name], rtol=1e-6,
                   atol=0.01 * P["optimizer_kwargs"]["lr"], msg=name)
        assert any(not torch.equal(history[i][n], history[i + 1][n])
                   for n in history[i])


PASCAL_TASKS = ("semseg", "human_parts", "sal", "normals", "edge")
PASCAL_OUT = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3,
              "edge": 1}


def _pascal_case(rng):
    """Seeded logits for each task and its intermediate prediction, labels
    with ignore regions."""
    shape = (2, 9, 11)
    pred, inter, gt = {}, {}, {}
    for t, k in PASCAL_OUT.items():
        pred[t] = rng.normal(size=(*shape, k)).astype(np.float32) * 2
        inter[t] = rng.normal(size=(*shape, k)).astype(np.float32) * 2
        if t == "normals":
            lab = rng.normal(size=(*shape, 3)).astype(np.float32)
        elif t == "edge":
            lab = (rng.random((*shape, 1)) < 0.3).astype(np.float32)
        else:
            lab = rng.integers(0, k, size=(*shape, 1)).astype(np.float32)
        lab[rng.random(shape) < 0.2] = 255
        gt[t] = lab
    return pred, inter, gt


@pytest.mark.parametrize("inter_sup", [True, False])
def test_pascal_criterion_with_intermediate_terms_matches_jax(inter_sup):
    """The 5-task PASCAL criterion of configs/pascal/invpt_vitLp16.yml on
    seeded logits and intermediate predictions: every term and the total,
    and the gradient of the total w.r.t. each input, against the JAX
    ``build_criterion`` (rtol 1e-5; gradients to 1e-6 of their largest
    value). Without intermediate supervision neither side adds a term."""
    from mtt_tpu.losses.loss_schemes import build_criterion as jbuild
    from mtt_tpu_torch.losses.loss_schemes import build_criterion
    from mtt_tpu_torch.train import INVPT_PASCAL_VITL_TRAIN

    p = dict(INVPT_PASCAL_VITL_TRAIN, intermediate_supervision=inter_sup)
    pred, inter, gt = _pascal_case(np.random.default_rng(5))
    jcrit = jbuild(_jax_config(p, PASCAL_TASKS, PASCAL_OUT))

    def jtotal(pred, inter):
        return jcrit({**pred, "inter_preds": inter}, gt)["total"]

    @jax.jit
    def jax_side(pred, inter):
        return (jcrit({**pred, "inter_preds": inter}, gt),
                jax.grad(jtotal, argnums=(0, 1))(pred, inter))

    want, (gp_want, gi_want) = jax_side(pred, inter)
    tp = {t: torch.from_numpy(v).requires_grad_() for t, v in pred.items()}
    ti = {t: torch.from_numpy(v).requires_grad_() for t, v in inter.items()}
    got = build_criterion(p, PASCAL_TASKS)(
        {**tp, "inter_preds": ti},
        {t: torch.from_numpy(v) for t, v in gt.items()})
    assert set(got) == set(want)
    assert ("inter_edge" in got) == inter_sup
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    got["total"].backward()
    for mine, theirs in ((tp, gp_want), (ti, gi_want)):
        for t in PASCAL_TASKS:
            g = np.asarray(theirs[t])
            if mine[t].grad is None:
                assert not inter_sup and not np.abs(g).max(), t
                continue
            np.testing.assert_allclose(mine[t].grad.numpy(), g, rtol=1e-5,
                                       atol=1e-6 * np.abs(g).max(),
                                       err_msg=t)


@pytest.mark.parametrize("name,path", [
    ("pascal_invpt_vitl", "pascal/invpt_vitLp16.yml"),
    ("nyud_invpt_vitl", "nyud/invpt_vitLp16.yml"),
    ("nyud_vitl", "nyud/taskprompter_vitLp16.yml")])
def test_train_config_dict_matches_its_yaml(name, path):
    """Every key of the port's training config dict equals the YAML
    file's (the task dictionary and the loss weights key by key; the clip's
    dict against the YAML's literal)."""
    import ast

    import yaml

    from mtt_tpu_torch.train import CONFIGS

    want = yaml.safe_load((REPO / "configs" / path).read_text())
    got = CONFIGS[name]

    def norm(v):
        if isinstance(v, str) and v.startswith("{"):
            v = ast.literal_eval(v)
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        return list(v) if isinstance(v, tuple) else v

    for key, value in got.items():
        assert key in want, (path, key)
        assert norm(value) == norm(want[key]), (path, key, value, want[key])
    for key in ("intermediate_supervision", "optimizer_kwargs", "trBatch",
                "valBatch", "loss_kwargs"):
        assert key in got, (name, key)
    assert ("grad_clip_param" in got) == ("grad_clip_param" in want)
    assert ("ignore_invalid_area_depth" in got) == \
        ("ignore_invalid_area_depth" in want)


def test_train_steps_invpt_entry_point_on_the_cpu(monkeypatch):
    """train.train_and_score for ``pascal_invpt_vitl`` at a tiny width
    (ViT-T, embed_dim 32, PRED_OUT 16) and size (128x128 for the
    database's 512x512), bf16 model with f32 master, drop-path on, then one
    eval batch: finite losses for every task, every ``inter_*`` term and
    the total, and finite scores of every task."""
    from mtt_tpu_torch.models.wrappers import DB_SCALES
    from mtt_tpu_torch.train import INVPT_PASCAL_VITL_TRAIN, train_and_score
    monkeypatch.setitem(DB_SCALES, "PASCALContext",
                        ((128, 128), (128, 128)))
    p = dict(INVPT_PASCAL_VITL_TRAIN, backbone="vitT", embed_dim=32,
             PRED_OUT_NUM_CONSTANT=16, valBatch=1)
    (losses,), scores = train_and_score(p, 1, 1, 1, seed=0, device="cpu")
    assert losses.keys() == set(PASCAL_TASKS) | {
        f"inter_{t}" for t in PASCAL_TASKS} | {"total"}
    assert all(np.isfinite(v) for v in losses.values())
    assert set(scores) == set(PASCAL_TASKS)
    assert all(np.isfinite(v) for s in scores.values() for v in s.values())


def test_train_cli_lists_the_new_configs():
    """``--config`` takes the three new names; ``--eval`` needs a
    ``valBatch``."""
    from mtt_tpu_torch import train
    assert {"pascal_invpt_vitl", "nyud_invpt_vitl", "nyud_vitl"} <= \
        set(train.CONFIGS)
    assert all("valBatch" in train.CONFIGS[n] for n in (
        "pascal_vitl", "pascal_invpt_vitl", "nyud_invpt_vitl", "nyud_vitl"))
    with pytest.raises(SystemExit):
        train.main(["--config", "cs3d_swinb", "--eval", "1"])
