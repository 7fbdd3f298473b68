"""The port's data-parallel training and evaluation over two processes.

Two ranks on the CPU (gloo, a free port, two torch threads each;
``tests/torch_dist_worker.py``) run every job once, while this process
computes the one-rank references on the same inputs:

- One f32 ``Trainer`` step of ViT-T TaskPrompter (5 PASCAL tasks, CTR, the
  up4 head's batch BN), ViT-T InvPT with intermediate supervision (BN
  everywhere in the decoder) and the tiny Swin with semseg, depth and the
  FCOS3D loss, each with drop-path on (0.3; InvPT's decoder 0.15), on a
  global batch of 4, two samples a rank, against the one-rank step on the
  whole batch; the Swin again with ``remat`` on (``swin_remat``), so that
  the recompute's BN moment all-reduce runs inside the backward on both
  ranks. Rank 1's images are three times rank 0's, 80% of its labels
  are ignored, it has fewer edge positives and boxes (an image without
  any): a per-rank BN moment, loss mean or average factor moves the
  gradients by whole percents. Tolerances are those of the one-process
  parity tests (tests/test_torch_train.py): losses rtol 1e-5; gradients
  and running statistics rtol 1e-4, with a floor of 1e-5 of each tensor's
  largest value (1e-4 of the largest gradient of all for the Swin with
  detection, as tests/test_torch_swin_train.py) and never below 1e-7: the
  same f32 functions with the sums in another order. After the update the
  two ranks' parameters are equal to the bit.
- The TaskPrompter step, drop-path off, against JAX's ``make_train_step``
  on a 2-device mesh (the conftest's virtual CPU devices) from the same
  weights (``state_dict_from_flax``) and batch, at the same tolerances.
- ``test_phase`` of the tiny Swin over 5 val images through each rank's
  loader shard (valBatch 3: rank 1's shard ends in a pad sample): the
  merged 2D scores (rtol 1e-6: f32 sums in another order) and the merged
  detection records' ``mDetection_Score`` and ``mAP`` (1e-12) equal the
  one-rank run's, on every rank.
- ``all_reduce_sum``'s gradient and ``all_reduce_grads`` with a gradient
  that one rank lacks.
- ``mtt_tpu_torch.main --multihost`` for 2 iterations (ViT-T at 32x32):
  rank 0 alone writes the checkpoint. Without torchrun's environment
  ``--multihost`` raises.

Every collective has the group's 60 s timeout, and the ranks are joined
within ``JOIN_S``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_dist_worker as W
from torch_threads import torch_threads  # noqa: F401

JOIN_S = 300
TRAIN_KINDS = ("taskprompter", "invpt", "swin", "swin_remat")


def _jax_step(variables, batch):
    """(losses, grads, new batch_stats) of JAX's ``make_train_step`` for
    the ViT-T TaskPrompter of tests/test_torch_train.py on a 2-device
    mesh: the parameters replicated, the batch sharded."""
    from mtt_tpu.losses.loss_schemes import build_criterion
    from mtt_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from mtt_tpu.utils.train_utils import TrainState, make_train_step
    from test_torch_train import TASKS, _jax_config, _jax_net

    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))
    mesh = make_mesh(2)
    step = jax.jit(make_train_step(_jax_net(), build_criterion(_jax_config()),
                                   keep_grads, TASKS))
    state = jax.device_put(
        TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                   batch_stats=variables["batch_stats"],
                   opt_state=keep_grads.init(variables["params"])),
        replicated(mesh))
    arrays = {k: jax.device_put(v.numpy(), batch_sharding(mesh))
              for k, v in batch.items()}
    new, losses = step(state, arrays, jax.random.PRNGKey(0))
    return (jax.device_get(losses), jax.device_get(new.opt_state),
            jax.device_get(new.batch_stats))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results of every job, the one-rank references and
    JAX's 2-device step."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from test_torch_model import random_variables
    from test_torch_train import _jax_net

    tmp = tmp_path_factory.mktemp("dp")
    batches = {k: W.mask_kinks(W.build(k), W.global_batch(k))
               for k in TRAIN_KINDS}
    jbatch = W.global_batch("taskprompter")
    variables = random_variables(_jax_net(), jnp.asarray(
        jbatch["image"].numpy()), seed=11)
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in
             state_dict_from_flax(variables).items()}
    model = W.build("taskprompter", drop=0.0)
    model.load_state_dict(state)
    jbatch = W.mask_kinks(model, jbatch)
    for d in ("eval1", "eval2", "main"):
        os.makedirs(tmp / d)
    jobs = [dict(name="train_step", kind=k, batch=batches[k])
            for k in TRAIN_KINDS]
    jobs += [dict(name="train_step", kind="taskprompter", batch=jbatch,
                  state=state),
             dict(name="eval", save_dir=str(tmp / "eval2")),
             dict(name="collectives"), dict(name="main", tmp=str(tmp / "main"))]
    procs = W.launch(jobs, str(tmp))
    try:
        one = {k: W.train_step(k, batches[k]) for k in TRAIN_KINDS}
        one["eval"] = W.eval_scores(str(tmp / "eval1"))
        jax_out = _jax_step(variables, jbatch)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    ranks = W.join(procs, str(tmp), JOIN_S)
    names = [*TRAIN_KINDS, "jax", "eval", "collectives", "main"]
    two = [dict(zip(names, r)) for r in ranks]
    return one, two, jax_out


def _close(got, want, rtol=1e-4, atol=None, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.detach().numpy() if torch.is_tensor(want) \
        else np.asarray(want)
    assert got.shape == want.shape, msg
    if atol is None:
        atol = max(1e-5 * np.abs(want).max(), 1e-7)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_two_rank_losses_equal_one_rank(runs, kind):
    """Every rank logs the global losses (each its share, summed), equal to
    the one-rank step's on the whole batch."""
    one, two, _ = runs
    want = one[kind]["losses"]
    for r in two:
        got = r[kind]["losses"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_two_rank_grads_equal_one_rank(runs, kind):
    """The summed gradients (each rank's after ``all_reduce_grads``) equal
    the one-rank step's, on both ranks."""
    one, two, _ = runs
    want = one[kind]["grads"]
    atol = None
    if kind.startswith("swin"):
        atol = 1e-4 * max(g.abs().max().item() for g in want.values())
    for r in two:
        got = r[kind]["grads"]
        assert got.keys() == want.keys()
        for name in want:
            _close(got[name], want[name], atol=atol, msg=name)


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_two_rank_bn_stats_equal_one_rank(runs, kind):
    """The running statistics of every batch-statistics BN (the fast
    variance of ``bn_train`` and the centred one of the up4 head and the
    InvPT tail) come from the global moments."""
    one, two, _ = runs
    want = one[kind]["stats"]
    assert want
    for r in two:
        assert r[kind]["stats"].keys() == want.keys()
        for name in want:
            _close(r[kind]["stats"][name], want[name], msg=name)


@pytest.mark.parametrize("kind", TRAIN_KINDS + ("jax",))
def test_ranks_parameters_bit_equal_after_update(runs, kind):
    """The same summed gradients into the same optimizer: after the update
    both ranks hold the same parameters to the bit, with no broadcast."""
    _, (r0, r1), _ = runs
    assert r0[kind]["params"].keys() == r1[kind]["params"].keys()
    for name, w in r0[kind]["params"].items():
        assert torch.equal(w, r1[kind]["params"][name]), name


def test_drop_path_masks_are_the_global_batch_rows():
    """``sample_uniform`` draws for the whole batch and keeps the rank's
    rows: rank r of 2 sees rows [rB, (r + 1)B) of one process's draws."""
    from unittest import mock

    from mtt_tpu_torch.models import layers
    want = torch.rand(6, 2, generator=torch.Generator().manual_seed(4))
    for rank in range(2):
        with mock.patch.object(layers, "data_shard_info",
                               return_value=(2, rank)):
            got = layers.sample_uniform(
                3, torch.Generator().manual_seed(4), 2)
        assert torch.equal(got, want[3 * rank:3 * rank + 3])


@pytest.mark.parametrize("part", ["losses", "grads", "stats"])
def test_two_rank_step_equals_jax_mesh_step(runs, part):
    """The port's 2-rank TaskPrompter step (drop-path off) against JAX's
    step on a 2-device mesh, from the same weights and global batch."""
    from mtt_tpu_torch.models.convert_jax import state_dict_from_flax
    from test_torch_train import TASKS
    _, two, (jl, jg, js) = runs
    for r in two:
        got = r["jax"][part]
        if part == "losses":
            for t in TASKS + ("total",):
                np.testing.assert_allclose(float(got[t]), float(jl[t]),
                                           rtol=1e-5, err_msg=t)
            continue
        want = state_dict_from_flax({"params": jg} if part == "grads" else
                                    {"params": {}, "batch_stats": js})
        if part == "stats":
            want = {k: v for k, v in want.items() if "running" in k}
        assert got.keys() == want.keys() and want
        for name in got:
            _close(got[name], want[name], msg=name)


def test_two_rank_eval_merges_meters_and_detections(runs):
    """``test_phase`` over 2 ranks: the meter states summed (the pad sample
    uncounted) and the detection records merged on rank 0, so every rank
    returns the one-rank scores; each rank wrote its own images' JSONs."""
    one, two, _ = runs
    want = one["eval"]["scores"]
    assert set(want) == {"semseg", "depth", "3ddet"}
    for r in two:
        got = r["eval"]["scores"]
        assert got.keys() == want.keys()
        for t in ("semseg", "depth"):
            assert got[t].keys() == want[t].keys()
            for k, v in want[t].items():
                np.testing.assert_allclose(got[t][k], v, rtol=1e-6,
                                           err_msg=f"{t} {k}")
        for k in ("mDetection_Score", "mAP"):
            assert got["3ddet"][k] == pytest.approx(want["3ddet"][k],
                                                    abs=1e-12), k
    # the records' own scores (predictions: the ground truth less a box),
    # the whole dict on every rank
    rec = one["eval"]["records"]
    assert 0.5 < rec["mDetection_Score"] < 1.0
    for r in two:
        assert r["eval"]["records"].keys() == rec.keys()
        assert r["eval"]["records"]["GT_stats"] == rec["GT_stats"]
        for k in ("mDetection_Score", "mAP"):
            assert r["eval"]["records"][k] == pytest.approx(rec[k],
                                                            abs=1e-12), k
    assert [r["eval"]["pads"] for r in two] == [0, 1]
    assert two[0]["eval"]["files"] == two[1]["eval"]["files"] == \
        [f"synth_{i:06d}.json" for i in range(5)]


def test_all_reduce_sum_grad_and_missing_gradients(runs):
    """``all_reduce_sum``: the sum forward, the summed cotangents backward
    (each rank's loss weights the sum by rank + 1, so every input's
    gradient is 1 + 2). ``all_reduce_grads`` over buckets of 4 values: a
    gradient only rank 0 has is summed as if rank 1's were zeros (bf16 kept),
    one that no rank has stays None."""
    _, two, _ = runs
    for r in two:
        c = r["collectives"]
        assert torch.equal(c["y"], 2 * torch.arange(4.0) + 3)
        assert torch.equal(c["x_grad"], torch.full((4,), 3.0))
        assert torch.equal(c["a"], torch.full((3,), 3.0))
        assert c["b_dtype"] == torch.bfloat16
        assert torch.equal(c["b"], torch.ones(2, dtype=torch.bfloat16))
        assert c["c"] is None


def test_main_multihost_rank0_writes_the_checkpoint(runs):
    """``main --multihost`` under 2 gloo ranks: both ran 2 iterations with
    an eval at 2; rank 0 alone wrote the checkpoint, the log file and the
    results."""
    _, (r0, r1), _ = runs
    assert r0["main"]["rc"] == r1["main"]["rc"] == 0
    assert [os.path.basename(w) for w in r0["main"]["writes"]] == \
        ["step_2.pt"]
    assert r1["main"]["writes"] == []
    files = r0["main"]["files"]
    assert "checkpoint/step_2.pt" in files and "log_file.txt" in files
    assert "results/results_iter2.json" in files


def test_multihost_without_torchrun_environment_raises(tmp_path,
                                                       monkeypatch):
    from mtt_tpu_torch.main import main
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        main(["--config_exp", "unused.yml", "--multihost"], device="cpu")


def test_data_shard_info_without_a_group():
    from mtt_tpu_torch.parallel.mesh import all_reduce_sum, data_shard_info
    assert data_shard_info() == (1, 0)
    x = torch.ones(3, requires_grad=True)
    assert all_reduce_sum(x) is x
