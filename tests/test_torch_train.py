"""The port's training path against the JAX package, on the CPU in f32.

One training step of TaskPrompter-ViT-T (5 PASCAL tasks, CTR on, factored
head, 64x64, batch 2) through the JAX ``make_train_step`` and through the
port's ``Trainer``, on the same weights (numpy, seeded; carried into the port
by ``state_dict_from_flax``) and the same synthetic batch. Drop-path is 0 on
both sides so that both are deterministic; its semantics are tested on the
port alone. The JAX step is compiled once, with an optax transformation that
hands the gradients back as its state, so that loss, gradients and batch
statistics come from the one step.

Tolerances: losses rtol 1e-5; gradients and running statistics rtol 1e-4
with a floor of 1e-5 times each tensor's largest value, and never below 1e-7
(the same f32 functions with sums in another order; the attention backward is
the hand-written one on the port's side and a differentiated composition on
the CPU JAX side; the conv biases ahead of batch-statistics BN have a
gradient that is zero but for rounding noise of order 1e-8). Parameters after
the optimizer: 1e-6 of the parameter plus 1% of the learning rate. An Adam
step moves a parameter by about lr; where a gradient sits near Adam's eps,
f32 rounding decides that move, while a wrong order, step count or schedule
moves whole tensors by tenths of lr.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401

TASKS = ("semseg", "human_parts", "sal", "normals", "edge")
NUM_OUT = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3, "edge": 1}
TAR, FIN = 24, 28
IMG = (64, 64)
P = {
    "model": "TaskPrompter", "backbone": "TaskPrompter_vitT", "head": "conv",
    "embed_dim": TAR, "final_embed_dim": FIN, "prompt_len": 1,
    "chan_nheads": 1, "use_ctr": True, "train_db_name": "PASCALContext",
    "val_db_name": "PASCALContext", "ignore_index": 255,
    # a short poly schedule and a clip that binds, so both show in 2 steps
    "max_iter": 10, "optimizer": "adam",
    "optimizer_kwargs": {"lr": 0.001, "weight_decay": 0.01},
    "scheduler": "poly", "grad_clip_param": "{'max_norm': 1, 'norm_type': 2}",
    "task_dictionary": {"include_semseg": True, "include_human_parts": True,
                        "include_sal": True, "include_edge": True,
                        "include_normals": True, "edge_w": 0.95},
    "loss_kwargs": {"loss_weights": {"semseg": 1.0, "human_parts": 2.0,
                                     "sal": 5.0, "edge": 50.0,
                                     "normals": 10.0}},
}


def _jax_config():
    """The JAX package's view of P, as create_config would build it."""
    from mtt_tpu.config.config import Config
    return Config.wrap(dict(P, edge_w=P["task_dictionary"]["edge_w"],
                            TASKS={"NAMES": list(TASKS),
                                   "NUM_OUTPUT": dict(NUM_OUT)}))


def _jax_net():
    from mtt_tpu.models.wrappers import TaskPrompterNet
    return TaskPrompterNet(tasks=TASKS, num_outputs=NUM_OUT,
                           backbone_name="TaskPrompter_vitT", tar_dim=TAR,
                           final_dim=FIN, use_ctr=True, drop_path_rate=0.0)


@pytest.fixture(scope="module")
def batch():
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    b = SyntheticMT(TASKS, NUM_OUT, IMG, seed=3).batch(0, 2)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    b["image"] = (b["image"] / 255.0 - mean) / std
    return b


@pytest.fixture(scope="module")
def variables(batch):
    return random_variables(_jax_net(), jnp.asarray(batch["image"]), seed=11)


@pytest.fixture(scope="module")
def jax_step(variables, batch):
    """(losses, grads, new batch_stats) of one JAX make_train_step."""
    from mtt_tpu.losses.loss_schemes import build_criterion
    from mtt_tpu.utils.train_utils import TrainState, make_train_step

    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))
    p = _jax_config()
    step = jax.jit(make_train_step(_jax_net(), build_criterion(p),
                                   keep_grads, TASKS))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=keep_grads.init(variables["params"]))
    new, losses = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    return (jax.device_get(losses), jax.device_get(new.opt_state),
            jax.device_get(new.batch_stats))


@pytest.fixture(scope="module")
def port_step(variables, batch):
    """(losses, grads by name, running statistics, parameters of 2 steps,
    clipped grads of 2 steps)."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    from mtt_tpu_torch.utils.train_utils import Trainer

    model = TaskPrompterNet(TASKS, NUM_OUT, IMG, "TaskPrompter_vitT",
                            tar_dim=TAR, final_dim=FIN, use_ctr=True,
                            drop_path_rate=0.0, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer = Trainer(model, P, TASKS, torch.float32, torch.Generator())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    names = [n for n, _ in model.named_parameters()]
    history = [{n: w.detach().clone() for n, w in model.named_parameters()}]
    losses, grads, stats, clipped = None, [], None, []
    for i in range(2):
        out = trainer.backward(tb)
        grads.append({n: w.grad.clone() for n, w in zip(
            names, model.parameters())})
        if i == 0:
            losses = out
            stats = {k: v.clone() for k, v in model.state_dict().items()
                     if "running" in k}
        trainer.update()
        # the master's gradients after the update are the clipped ones
        clipped.append({n: w.grad.clone() for n, w in zip(
            names, model.parameters())})
        history.append({n: w.detach().clone()
                        for n, w in model.named_parameters()})
    return losses, grads, stats, history, clipped


def _close(got, want, rtol=1e-4, atol=None, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    if atol is None:
        atol = max(1e-5 * np.abs(want).max(), 1e-7)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("task", TASKS + ("total",))
def test_train_step_loss_matches_jax(task, jax_step, port_step):
    np.testing.assert_allclose(float(port_step[0][task]),
                               float(jax_step[0][task]), rtol=1e-5)


def test_train_step_grads_match_jax(jax_step, port_step):
    """Every parameter's gradient, JAX's tree carried into the port's names
    and layouts by state_dict_from_flax."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    want = state_dict_from_flax({"params": jax_step[1]})
    got = port_step[1][0]
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name], msg=name)


def test_train_step_bn_stats_match_jax(jax_step, port_step):
    """The decode BNs' and the heads' running statistics after the step
    (flax momentum 0.9 on the biased batch variance)."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    want = state_dict_from_flax({"params": {}, "batch_stats": jax_step[2]})
    got = port_step[2]
    assert got.keys() == {k for k in want if "running" in k}
    for name in got:
        _close(got[name], want[name], msg=name)


def test_optimizer_steps_match_optax(port_step):
    """Two updates of the port against build_optimizer's optax chain, on
    trees in the port's layout (every op of the chain is elementwise or a
    global norm, so the layout does not matter). The clip: the port's
    clipped gradients against optax.clip_by_global_norm on the port's own
    gradients at rtol 1e-6 (optax sums the squares in f32, the port in f64:
    the norms differ by up to 6e-7 of themselves at this size; the clip's
    arithmetic is tested exactly against numpy below). The rest of the chain
    (L2 decay, Adam, poly) fed the port's clipped gradients: 1e-6 of the
    parameter plus 1% of the learning rate (where decay and gradient cancel
    to below Adam's eps, the last bits of the norm decide the move)."""
    from mtt_tpu.utils.optim import build_optimizer
    from mtt_tpu_torch.utils.optim import grad_clip_norm
    _, grads, _, history, clipped = port_step
    noclip = _jax_config()
    del noclip["grad_clip_param"]
    tx, _ = build_optimizer(noclip)
    clip = optax.clip_by_global_norm(grad_clip_norm(P))
    params = {k: jnp.asarray(v.numpy()) for k, v in history[0].items()}
    state = tx.init(params)

    @jax.jit
    def update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    @jax.jit
    def clip_and_norm(g):
        return clip.update(g, clip.init(g))[0], optax.global_norm(g)

    norms = []
    for i in range(2):
        g = {k: jnp.asarray(v.numpy()) for k, v in grads[i].items()}
        want, norm = clip_and_norm(g)
        norms.append(float(norm))
        for name, w in clipped[i].items():
            _close(w, want[name], rtol=1e-6, atol=0.0, msg=name)
        g = {k: jnp.asarray(v.numpy()) for k, v in clipped[i].items()}
        params, state = update(g, state, params)
        for name, w in history[i + 1].items():
            _close(w, params[name], rtol=1e-6,
                   atol=0.01 * P["optimizer_kwargs"]["lr"], msg=name)
    assert min(norms) > 1.0          # the clip bound on both steps


def test_drop_path_masks_rows_per_sample_and_group():
    """row_drop: one keep/drop draw per sample for the prompt rows and one
    for the patch rows, each kept group scaled by 1 / keep."""
    from mtt_tpu_torch.models.taskprompter import row_drop
    B, Pr, M, C, rate = 64, 3, 11, 4, 0.4
    branch = torch.ones(B, M, C)
    out = row_drop(branch, Pr, rate, torch.Generator().manual_seed(0))
    keep = 1.0 - rate
    for rows in (out[:, :Pr], out[:, Pr:]):
        first = rows[:, :1]
        assert torch.equal(rows, first.expand_as(rows))    # one draw a group
        vals = first.unique()
        assert len(vals) <= 2 and vals.min() >= 0
        assert torch.allclose(vals[vals > 0], torch.tensor(1.0 / keep))
    kept_p = (out[:, 0, 0] > 0)
    kept_n = (out[:, Pr, 0] > 0)
    assert not torch.equal(kept_p, kept_n)                 # independent
    assert 0.3 < kept_n.float().mean().item() < 0.9
    again = row_drop(branch, Pr, rate, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)                         # seeded


def test_drop_path_schedule_and_block_paths():
    """0.15 * i / (depth - 1) per block; in training block 0 keeps the fused
    MLP half-block and the others run LN + the plain MLP under drop-path,
    while eval ignores the rate."""
    from mtt_tpu_torch.models.wrappers import build_model
    model = build_model(P, img_size=IMG, device="meta")
    rates = [getattr(model.backbone, f"blocks_{i}").drop_path
             for i in range(4)]
    np.testing.assert_allclose(rates, [0.0, 0.05, 0.1, 0.15])


def test_drop_path_training_without_generator_raises():
    """A train-mode forward with drop-path > 0 and no generator names the
    missing argument; eval and drop-path 0 need none."""
    from mtt_tpu_torch.models.wrappers import build_model
    model = build_model(P, img_size=IMG, device="cpu")
    x = torch.zeros(1, *IMG, 3)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x, train=True)
    with torch.no_grad():
        assert set(model(x)) == set(TASKS)


def _loss_case(name, rng):
    """(jax loss fn, port loss fn, logits, label) with ignore regions."""
    from mtt_tpu.losses import loss_functions as jl
    from mtt_tpu_torch.losses import loss_functions as pl
    ign = rng.random((2, 9, 11, 1)) < 0.2
    if name in ("semseg", "sal"):
        K = 21 if name == "semseg" else 2
        logits = rng.normal(size=(2, 9, 11, K)).astype(np.float32) * 2
        label = rng.integers(0, K, size=(2, 9, 11, 1)).astype(np.float32)
        label[ign] = 255
        bal = name == "sal"
        return (lambda a, b: jl.cross_entropy_loss(a, b, 255, bal),
                lambda a, b: pl.cross_entropy_loss(a, b, 255, bal),
                logits, label)
    if name.startswith("edge"):
        pw = 0.95 if name == "edge_w" else None
        logits = rng.normal(size=(2, 9, 11, 1)).astype(np.float32) * 2
        label = (rng.random((2, 9, 11, 1)) < 0.3).astype(np.float32)
        label[ign] = 255
        return (lambda a, b: jl.balanced_bce_loss(a, b, 255, pw),
                lambda a, b: pl.balanced_bce_loss(a, b, 255, pw),
                logits, label)
    if name == "normals":
        pred = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
        label = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
        label[np.repeat(ign, 3, -1)] = 255
        return (lambda a, b: jl.l1_loss(a, b, 255, True),
                lambda a, b: pl.l1_loss(a, b, 255, True), pred, label)
    inv = name == "depth_invalid"
    pred = rng.normal(size=(2, 9, 11, 1)).astype(np.float32)
    label = np.abs(rng.normal(size=(2, 9, 11, 1))).astype(np.float32)
    label[ign] = -1.0
    label[rng.random(label.shape) < 0.1] = 255
    return (lambda a, b: jl.depth_l1_loss(a, b, inv),
            lambda a, b: pl.depth_l1_loss(a, b, inv), pred, label)


@pytest.mark.parametrize("name", ["semseg", "sal", "edge_w", "edge_auto",
                                  "normals", "depth", "depth_invalid"])
def test_loss_function_matches_jax(name):
    """Each loss and its gradient w.r.t. the predictions against the JAX
    loss on the same numpy inputs with ignore regions: rtol 1e-5, gradient
    floor 1e-6 of its largest value."""
    fj, fp, pred, label = _loss_case(name, np.random.default_rng(12))
    want, gwant = jax.value_and_grad(fj)(jnp.asarray(pred),
                                         jnp.asarray(label))
    pt = torch.from_numpy(pred).requires_grad_()
    got = fp(pt, torch.from_numpy(label))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gwant), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(gwant)).max())


def test_train_steps_entry_point_on_the_cpu():
    """train.train_steps end to end (seeded synthetic batch at the
    database's 512x512, ImageNet normalisation, bf16 model with f32 master,
    drop-path on) when the caller asks for the CPU: finite losses for every
    task and the total."""
    from mtt_tpu_torch.train import train_steps
    (losses,) = train_steps(P, 1, 1, seed=0, device="cpu")
    assert losses.keys() == set(TASKS) | {"total"}
    assert all(np.isfinite(v) for v in losses.values())


def test_trainer_update_copies_nothing_on_f32(monkeypatch):
    """With an f32 model the master is the model's own parameters: an
    update writes them in place and copies no tensor (no self-copy of each
    parameter), while a bf16 model's update rounds the f32 master into it."""
    from mtt_tpu_torch.utils.train_utils import Trainer
    copies = []
    real = torch.Tensor.copy_

    def counted(self, *a, **kw):
        copies.append(self.shape)
        return real(self, *a, **kw)

    for dtype, n_copies in ((torch.float32, 0), (torch.bfloat16, 2)):
        model = torch.nn.Linear(4, 3)
        trainer = Trainer(model, P, TASKS, dtype, torch.Generator())
        ptrs = [w.data_ptr() for w in model.parameters()]
        for w in model.parameters():
            w.grad = torch.ones_like(w)
        copies.clear()
        monkeypatch.setattr(torch.Tensor, "copy_", counted)
        trainer.update()
        monkeypatch.undo()
        assert len(copies) == n_copies, (dtype, copies)
        assert [w.data_ptr() for w in model.parameters()] == ptrs
        if dtype == torch.float32:
            assert all(m is w for m, w in zip(trainer.master,
                                              model.parameters()))
            assert all((w != 0).any() for w in model.parameters())


@pytest.mark.parametrize("factor", [10.0, 0.5])
def test_clip_gradients_is_optax_exactly(factor):
    """A global norm of ``factor`` times max_norm: at 10 every gradient
    becomes (t / g) * max_norm, as optax.clip_by_global_norm computes it
    (held against numpy at 1e-7 relative; torch's clip_grad_norm_ divides by
    g + 1e-6); at 0.5 the gradients stay as they are, bit for bit."""
    from mtt_tpu_torch.utils.optim import clip_gradients
    rng = np.random.default_rng(4)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    gs = [(1e-3 * rng.normal(size=s)).astype(np.float32) for s in shapes]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs))
    max_norm = float(norm / factor)
    params = [torch.zeros(s, requires_grad=True) for s in shapes]
    for w, g in zip(params, gs):
        w.grad = torch.from_numpy(g.copy())
    clip_gradients(params, {"grad_clip_param": {"max_norm": max_norm,
                                                "norm_type": 2}})
    for w, g in zip(params, gs):
        if factor < 1:
            assert np.array_equal(w.grad.numpy(), g)
        else:
            want = (g / np.float32(norm)) * np.float32(max_norm)
            np.testing.assert_allclose(w.grad.numpy(), want, rtol=1e-7)
