"""The port's training loop against the JAX package, on the CPU.

The whole slice: a TaskPrompter-ViT-T PASCAL experiment (5 tasks, CTR on,
drop-path off, 32x32, Adam at lr 1e-3 with the YAML's clip and poly
schedule) read from one YAML file by each package's ``create_config``, its
synthetic datasets through each package's transforms and loaders
(``common_config``), and each package's ``train_phase`` for 2 iterations
with ``val_interval`` 2, started from the same state (the JAX
``TrainState`` carried into the port's trainer by
``trainer_state_from_jax``). The JAX side compiles one train and one eval
step, once for the module.

Tolerances, each stated at its test: losses and scores of the same f32
functions with sums in another order (rtol 1e-4 on the first step's losses,
which see equal weights and equal batches; 1e-3 on the second's, after an
Adam step in which a gradient near Adam's eps moves a weight by a whole
lr; the scores over 64 images within 1e-3); the edge maps written as uint8
at most 1 level apart. The optimizer (SGD against optax) and the
checkpoint round trip (bit-equal) are checked on their own.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_threads import torch_threads  # noqa: F401

TASKS = ("semseg", "human_parts", "sal", "normals", "edge")
NUM_OUT = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3, "edge": 1}
TAR, FIN = 24, 28
IMG = (32, 32)
LR = 0.001


def _yaml(path):
    """configs/pascal/taskprompter_vitLp16.yml at ViT-T width, lr 1e-3."""
    with open(os.path.join(os.path.dirname(__file__), "..", "configs",
                           "pascal", "taskprompter_vitLp16.yml")) as f:
        text = f.read()
    for old, new in (("backbone: TaskPrompter_vitL",
                      "backbone: TaskPrompter_vitT"),
                     ("embed_dim: 300", f"embed_dim: {TAR}"),
                     ("final_embed_dim: 350", f"final_embed_dim: {FIN}"),
                     ("lr: 0.00002", f"lr: {LR}")):
        assert old in text
        text = text.replace(old, new)
    path.write_text(text)
    return str(path)


def _port_net():
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    return TaskPrompterNet(TASKS, NUM_OUT, IMG, "TaskPrompter_vitT",
                           tar_dim=TAR, final_dim=FIN, use_ctr=True,
                           drop_path_rate=0.0, device="cpu")


def _port_trainer(p, dtype=torch.float32, model=None, seed=0):
    from mtt_tpu_torch.utils.train_utils import Trainer
    return Trainer(model or _port_net(), p, TASKS, dtype,
                   torch.Generator().manual_seed(seed), log_fn=lambda s: None)


def _jax_state(jtrainer, sample):
    """``Trainer.init_state`` with seeded numpy weights in place of the
    jitted flax init (whose compile alone takes about 20 s): the same
    TrainState, optimizer and jitted steps."""
    from mtt_tpu.utils.optim import build_optimizer
    from mtt_tpu.utils.train_utils import (TrainState, make_eval_step,
                                           make_train_step)
    from test_torch_model import random_variables
    v = random_variables(jtrainer.model, jnp.asarray(sample["image"]),
                         seed=3)
    jtrainer.tx, jtrainer.sched = build_optimizer(jtrainer.p)
    jtrainer._train_step = jax.jit(make_train_step(
        jtrainer.model, jtrainer.criterion, jtrainer.tx, jtrainer.tasks),
        donate_argnums=(0,))
    jtrainer._eval_step = jax.jit(make_eval_step(
        jtrainer.model, jtrainer.meter, jtrainer.tasks))
    return TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                      batch_stats=v["batch_stats"],
                      opt_state=jtrainer.tx.init(v["params"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both loops from one state: (JAX dir, port dir, JAX history, port
    history, JAX start state, JAX end state, port trainer)."""
    from mtt_tpu.config.config import DB_SCALES as JAX_SCALES
    from mtt_tpu.config.config import create_config as jax_config
    from mtt_tpu.models.wrappers import TaskPrompterNet as JNet
    from mtt_tpu.parallel.mesh import make_mesh
    from mtt_tpu.utils import common_config as jcc
    from mtt_tpu.utils.train_utils import Trainer as JTrainer
    from mtt_tpu.utils.train_utils import train_phase as jax_train_phase
    from mtt_tpu_torch.config.config import DB_SCALES
    from mtt_tpu_torch.config.config import create_config
    from mtt_tpu_torch.models.convert_jax import trainer_state_from_jax
    from mtt_tpu_torch.utils import common_config as cc
    from mtt_tpu_torch.utils.train_utils import train_phase

    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("loop")
    yml = _yaml(root / "exp.yml")
    mp.setitem(JAX_SCALES, "PASCALContext", (IMG, IMG))
    mp.setitem(DB_SCALES, "PASCALContext", (IMG, IMG))
    try:
        out = {}
        for side in ("jax", "port"):
            (root / side).mkdir()
            mp.chdir(root / side)
            make = jax_config if side == "jax" else create_config
            out[side] = p = make(yml)
            for k in ("root_dir", "output_dir", "save_dir", "checkpoint"):
                p[k] = os.path.abspath(p[k])
            c = jcc if side == "jax" else cc
            train_tf, val_tf = c.get_transformations(p)
            loaders = (c.get_train_dataloader(p, c.get_dataset(
                p, "train", train_tf)), c.get_test_dataloader(
                p, c.get_dataset(p, "val", val_tf)))
            if side == "jax":
                jtrainer = JTrainer(p, JNet(
                    tasks=TASKS, num_outputs=NUM_OUT,
                    backbone_name="TaskPrompter_vitT", tar_dim=TAR,
                    final_dim=FIN, use_ctr=True, drop_path_rate=0.0),
                    mesh=make_mesh(1), log_fn=lambda s: None)
                state0 = _jax_state(jtrainer, next(iter(loaders[1])))
                start = jax.device_get(state0)
                # the orbax checkpoint is the JAX package's own and is not
                # compared: the port's is checked below
                jtrainer.save_checkpoint = lambda state, path: None
                end, jax_hist = jax_train_phase(
                    p, jtrainer, state0, *loaders, max_iter=2,
                    val_interval=2, log_every=1)
                end = jax.device_get(end)
            else:
                trainer = _port_trainer(p)
                trainer_state_from_jax(trainer, start)
                port_hist = train_phase(p, trainer, *loaders, max_iter=2,
                                        val_interval=2, log_every=1)
        return (out["jax"], out["port"], jax_hist, port_hist, start, end,
                trainer, root)
    finally:
        mp.undo()


@pytest.mark.parametrize("it", [1, 2])
def test_train_phase_losses_match_jax(runs, it):
    """Each iteration's history entry: every task's loss and the total,
    rtol 1e-4 at iteration 1 (equal weights, equal batches), 1e-3 at 2."""
    _, _, jh, ph, *_ = runs
    assert [h["iter"] for h in ph] == [h["iter"] for h in jh] == [1, 2]
    got, want = ph[it - 1], jh[it - 1]
    assert set(got) == set(want) == {"iter", "total", *TASKS}
    for k in TASKS + ("total",):
        np.testing.assert_allclose(got[k], want[k],
                                   rtol=1e-4 if it == 1 else 1e-3, err_msg=k)


def test_train_phase_results_and_checkpoint_match_jax(runs):
    """``results_iter2.json``: every task's score within 1e-3 (absolute on
    mIoU, maxF and the edge loss; relative on the normals' mean angle);
    the port's checkpoint and ``latest.txt`` exist, the TB event file and
    ``scalars.csv`` hold every scalar JAX's hold."""
    pj, pp, *_ = runs
    want = json.load(open(os.path.join(pj["save_dir"], "results_iter2.json")))
    got = json.load(open(os.path.join(pp["save_dir"], "results_iter2.json")))
    assert got.keys() == want.keys() == set(TASKS)
    for t in TASKS:
        assert got[t].keys() == want[t].keys()
        for k, v in want[t].items():
            tol = 1e-3 * abs(v) if t == "normals" else 1e-3
            assert abs(got[t][k] - v) <= tol, (t, k, got[t][k], v)
    ck = pp["checkpoint"]
    assert open(os.path.join(ck, "latest.txt")).read() == "2"
    assert os.path.isfile(os.path.join(ck, "step_2.pt"))

    def tags(p):
        rows = open(os.path.join(p["save_dir"], "tb", "scalars.csv")
                    ).read().splitlines()[1:]
        return sorted((r.split(",")[0], r.split(",")[1]) for r in rows)
    assert tags(pp) == tags(pj)
    assert [f for f in os.listdir(os.path.join(pp["save_dir"], "tb"))
            if f.startswith("events.out.tfevents.")]


def test_train_phase_edge_maps_match_jax(runs):
    """The 64 val images' edge PNGs (and none for the pad samples), read
    with cv2: equal shapes and at most 1 grey level apart (the same f32
    sigmoid * 255 truncated to uint8 on both sides)."""
    import cv2
    pj, pp, *_ = runs
    names = sorted(os.listdir(os.path.join(pj["save_dir"], "edge")))
    assert len(names) == 64
    assert sorted(os.listdir(os.path.join(pp["save_dir"], "edge"))) == names
    worst = 0
    for n in names:
        a = cv2.imread(os.path.join(pj["save_dir"], "edge", n),
                       cv2.IMREAD_UNCHANGED).astype(int)
        b = cv2.imread(os.path.join(pp["save_dir"], "edge", n),
                       cv2.IMREAD_UNCHANGED).astype(int)
        assert a.shape == b.shape == IMG
        worst = max(worst, np.abs(a - b).max())
    assert worst <= 1


def test_trainer_state_from_jax(runs):
    """The JAX state after the 2 iterations carried into a fresh port
    trainer: the step, the scheduler's learning rate, the master weights,
    the BN statistics and Adam's step and moments equal JAX's, bit for bit,
    in the port's layout. Against the port's own 2 iterations: every master
    within 2 lr (an Adam update moves a weight by up to about lr, and the
    biases ahead of batch-statistics BN have gradients of pure rounding
    noise, which Adam turns into whole-lr moves of either sign), Adam's
    moments within rtol 1e-3 with a floor of 1e-4 of the largest moment
    of all tensors (the noise biases' moments are 1e-8 of it)."""
    from mtt_tpu_torch.models.convert_jax import (state_dict_from_flax,
                                                  trainer_state_from_jax)
    _, pp, _, _, _, end, trainer, _ = runs
    fresh = _port_trainer(pp)
    trainer_state_from_jax(fresh, end)
    assert fresh.step_count == trainer.step_count == int(end.step) == 2
    sched = 1 - 2 / pp["max_iter"]
    assert fresh.optimizer.param_groups[0]["lr"] == LR * sched ** 0.9 == \
        trainer.optimizer.param_groups[0]["lr"]
    adam = [s for s in end.opt_state if hasattr(s, "mu")][0]
    want = state_dict_from_flax({"params": end.params,
                                 "batch_stats": end.batch_stats})
    mu = state_dict_from_flax({"params": adam.mu})
    nu = state_dict_from_flax({"params": adam.nu})
    names = [n for n, _ in trainer.model.named_parameters()]
    top = {k: max(trainer.optimizer.state[b][k].abs().max().item()
                  for b in trainer.master) for k in ("exp_avg", "exp_avg_sq")}
    for n, a, b in zip(names, fresh.master, trainer.master):
        assert torch.equal(a, want[n]), n
        sa, sb = fresh.optimizer.state[a], trainer.optimizer.state[b]
        assert float(sa["step"]) == float(sb["step"]) == int(adam.count)
        assert torch.equal(sa["exp_avg"], mu[n]), n
        assert torch.equal(sa["exp_avg_sq"], nu[n]), n
        assert (a - b).abs().max().item() <= 2 * LR, n
        for k in ("exp_avg", "exp_avg_sq"):
            ref = sb[k].numpy()
            np.testing.assert_allclose(sa[k].numpy(), ref, rtol=1e-3,
                                       atol=1e-4 * top[k], err_msg=(n, k))
    for n, buf in fresh.model.named_buffers():
        if buf.is_floating_point():
            assert torch.equal(buf, want[n]), n


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_sgd_matches_optax(nesterov, wd):
    """``optimizer: sgd`` over 3 steps against build_optimizer's optax
    chain (add_decayed_weights, trace, poly learning rate) on the same
    gradients: rtol 1e-6 (the same elementwise f32 arithmetic)."""
    from mtt_tpu.config.config import Config
    from mtt_tpu.utils.optim import build_optimizer as jax_optimizer
    from mtt_tpu_torch.utils.optim import build_optimizer
    p = {"optimizer": "sgd", "scheduler": "poly", "max_iter": 10,
         "optimizer_kwargs": {"lr": 0.1, "momentum": 0.8,
                              "nesterov": nesterov, "weight_decay": wd}}
    tx, _ = jax_optimizer(Config.wrap(p))
    rng = np.random.default_rng(5)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    params = [torch.tensor(w0, requires_grad=True)]
    opt, sched = build_optimizer(params, p)
    jp = jnp.asarray(w0)
    state = tx.init(jp)
    for _ in range(3):
        g = rng.normal(size=(4, 3)).astype(np.float32)
        params[0].grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(params[0].detach().numpy(),
                                   np.asarray(jp), rtol=1e-6, atol=1e-7)


def _batch(seed=0, n=2):
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.utils.train_utils import to_device
    return to_device(SyntheticMT(TASKS, NUM_OUT, IMG, seed=seed).batch(0, n),
                     "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_resume_is_bit_equal(tmp_path, dtype):
    """Two steps, a checkpoint, a third step; a new trainer restored from
    the checkpoint takes the same third step: every master weight, Adam
    moment, BN statistic and the model's weights equal to the bit, with
    drop-path on (its generator restored), in f32 and with a bf16 model on
    an f32 master."""
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    p = {"optimizer": "adam", "scheduler": "poly", "max_iter": 10,
         "optimizer_kwargs": {"lr": LR, "weight_decay": 1e-4},
         "grad_clip_param": {"max_norm": 1.0, "norm_type": 2},
         "train_db_name": "PASCALContext", "ignore_index": 255,
         "task_dictionary": {"edge_w": 0.95},
         "loss_kwargs": {"loss_weights": dict.fromkeys(
             TASKS, 1.0)}}

    def net():
        torch.manual_seed(0)
        return TaskPrompterNet(TASKS, NUM_OUT, IMG, "TaskPrompter_vitT",
                               tar_dim=TAR, final_dim=FIN, use_ctr=True,
                               drop_path_rate=0.3, device="cpu")

    a = _port_trainer(p, dtype, net(), seed=7)
    for s in range(2):
        a.step(_batch(s))
    path = a.save_checkpoint(str(tmp_path))
    assert path.endswith("step_2.pt")
    assert open(tmp_path / "latest.txt").read() == "2"
    b = _port_trainer(p, dtype, net(), seed=99)
    assert _port_trainer(p, dtype, net()).restore_checkpoint(
        str(tmp_path / "none")) is None
    assert b.restore_checkpoint(str(tmp_path)) == 2
    la, lb = a.step(_batch(2)), b.step(_batch(2))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert a.step_count == b.step_count == 3
    for ma, mb in zip(a.master, b.master):
        assert torch.equal(ma, mb)
        sa, sb = a.optimizer.state[ma], b.optimizer.state[mb]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for (n, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert x.dtype == y.dtype and torch.equal(x, y), n


def test_tb_writer_bytes_match_jax(tmp_path, monkeypatch):
    """The same scalar calls under a fixed ``time.time``: the event file
    and ``scalars.csv`` equal the JAX writer's byte for byte, and
    ``flatten_scores`` equals JAX's."""
    import time
    from mtt_tpu.utils import tb_writer as jtb
    from mtt_tpu_torch.utils import tb_writer as ptb
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    scores = {"semseg": {"mIoU": 0.25}, "normals": {"mean": 31.5},
              "edge": {"loss": 0.125}}
    for mod, d in ((jtb, tmp_path / "j"), (ptb, tmp_path / "p")):
        w = mod.SummaryWriter(str(d))
        w.add_scalars({"total": 1.5, "semseg": 0.75}, 3, prefix="loss/")
        w.add_scalar("lr", 0.001, 3)
        w.add_scalars(mod.flatten_scores(scores), 4, prefix="perf/")
        w.close()
    assert ptb.flatten_scores(scores) == jtb.flatten_scores(scores)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names and len(names) == 2
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()


def test_step_profiler_writes_a_trace(tmp_path, monkeypatch):
    """MTT_PROFILE_DIR set: steps 10 .. 15 traced, a Chrome trace written
    there; unset: nothing traced."""
    from mtt_tpu_torch.utils.train_utils import StepProfiler
    monkeypatch.setenv("MTT_PROFILE_DIR", str(tmp_path))
    prof = StepProfiler()
    for step in range(17):
        prof.maybe_start(step)
        torch.ones(8, 8).matmul(torch.ones(8, 8))
        prof.maybe_stop(step)
    files = os.listdir(tmp_path)
    assert files == ["trace_steps10-15.json"]
    assert "traceEvents" in json.load(open(tmp_path / files[0]))
    monkeypatch.delenv("MTT_PROFILE_DIR")
    quiet = StepProfiler()
    quiet.maybe_start(10)
    assert quiet._prof is None


def test_main_trains_then_resumes_in_infer(tmp_path, monkeypatch, capsys):
    """``main`` on the CPU at 32x32 (ViT-T): 2 iterations with an eval and a
    checkpoint at 2, the log file; then ``--run_mode infer`` resumes from
    step 2 and prints finite scores of every task; with ``--vis`` it also
    writes each task's map of the 64 val images under ``vis_<task>``, as
    ``render_task`` draws them, from the forwards that give the same
    scores. Without a card the default device raises."""
    from mtt_tpu_torch.config.config import DB_SCALES
    from mtt_tpu_torch.main import main
    monkeypatch.setitem(DB_SCALES, "PASCALContext", (IMG, IMG))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    yml = _yaml(tmp_path / "exp.yml")
    assert main(["--config_exp", yml, "--max_iter", "2", "--val_interval",
                 "2", "--dtype", "float32"], device="cpu") == 0
    logger = sys.stdout                  # main's tee to log_file.txt
    sys.stdout = logger.console
    logger.close()
    out = tmp_path / "work_dirs" / "TaskPrompter_pascal_vitLp16"
    assert (out / "checkpoint" / "step_2.pt").is_file()
    assert "eval@2" in (out / "log_file.txt").read_text()
    capsys.readouterr()
    assert main(["--config_exp", yml, "--run_mode", "infer", "--dtype",
                 "float32"], device="cpu") == 0
    text = capsys.readouterr().out
    assert "resumed from step 2" in text
    scores = json.loads(text[text.index("{"):])
    assert set(scores) == set(TASKS)
    assert all(np.isfinite(v) for s in scores.values() for v in s.values())
    assert main(["--config_exp", yml, "--run_mode", "infer", "--vis",
                 "--dtype", "float32"], device="cpu") == 0
    text = capsys.readouterr().out
    assert json.loads(text[text.index("{"):]) == scores
    vis = out / "results"
    for t in TASKS:
        names = sorted(os.listdir(vis / f"vis_{t}"))
        assert names == [f"synth_{i:06d}.png" for i in range(64)], t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config_exp", yml])
