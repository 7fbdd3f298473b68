"""The port's task meters, ``PerformanceMeter``, eval step and ``test_phase``
against the JAX package's meters, on the CPU.

Each meter is fed the same seeded predictions and labels (ignore pixels
included, and labels outside the class range for the confusion counts) in
two updates on both sides. Counts: equal (the port counts in int64, JAX in
f32, exact below 2^24); sums of per-pixel values: rtol 1e-5 (f32 sums in
another order); scores: rtol 1e-5. ``test_phase`` runs a ViT-T InvPT (5
PASCAL tasks, 64x64) over 2 batches and is held to the JAX
``PerformanceMeter`` fed the port's own predictions (no JAX model).
"""

import os

import numpy as np
import pytest
import torch

from torch_threads import torch_threads  # noqa: F401

B, H, W = 2, 13, 17


def _labels(rng, shape, values, ignore=0.15):
    lab = rng.choice(values, size=shape).astype(np.float32)
    lab[rng.random(shape[:3]) < ignore] = 255.0
    return lab


def _case(name, rng):
    """(jax meter args, port meter args, [(pred, gt), (pred, gt)])."""
    out = []
    for _ in range(2):
        if name == "semseg":
            pred = rng.integers(0, 21, size=(B, H, W))
            # a label past the class range counts for no class, as JAX's
            # zero one-hot row
            gt = _labels(rng, (B, H, W, 1), list(range(21)) + [30])
        elif name == "normals":
            pred = rng.uniform(0, 255, size=(B, H, W, 3)).astype(np.float32)
            pred[0, 0, 0] = 127.5            # a zero vector after rescaling
            gt = rng.normal(size=(B, H, W, 3)).astype(np.float32)
            gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
            gt[rng.random((B, H, W)) < 0.15] = 255.0
            gt[0, 0, 1] = 0.0                # a zero label
        elif name in ("sal", "edge"):
            pred = rng.uniform(0, 255, size=(B, H, W)).astype(np.float32)
            gt = _labels(rng, (B, H, W, 1), [0.0, 1.0])
        else:                                   # depth, depth_cs3d
            pred = rng.uniform(-1, 90, size=(B, H, W)).astype(np.float32)
            gt = rng.uniform(0, 100, size=(B, H, W, 1)).astype(np.float32)
            gt[rng.random((B, H, W)) < 0.15] = 255.0
            gt[0, :3, 0, 0] = (0.0, 80.0, 1e-3)   # on and next to the bounds
        out.append((pred, gt))
    return out


def _meters(name):
    from mtt_tpu.evaluation import meters as jm
    from mtt_tpu_torch.evaluation import meters as pm
    make = {"semseg": ("ConfusionMeter", (21, 255)),
            "normals": ("NormalsMeter", (255,)),
            "sal": ("SaliencyMeter", (255, 0.05, 0.3)),
            "depth": ("DepthMeter", (255,)),
            "depth_cs3d": ("DepthMeter", (255, 80.0, 0.0)),
            "edge": ("EdgeMeter", (0.95, 255))}[name]
    return getattr(jm, make[0])(*make[1]), getattr(pm, make[0])(*make[1])


def _same_states(got, want, what=""):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, (what, k)
        if g.dtype == np.int64:
            np.testing.assert_array_equal(g, w.astype(np.int64),
                                          err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} {k}")


def _same_scores(got, want, what=""):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ["semseg", "normals", "sal", "depth",
                                  "depth_cs3d", "edge"])
def test_meter_matches_jax(name):
    """Two updates of each meter and its score against the JAX meter on
    the same numpy inputs; the port's update leaves its input state as it
    was (a pure function, as the jitted JAX update)."""
    jmeter, pmeter = _meters(name)
    js, ps = jmeter.init(), pmeter.init()
    for pred, gt in _case(name, np.random.default_rng(7)):
        js = jmeter.update(js, pred, gt)
        before = {k: v.clone() for k, v in ps.items()}
        new = pmeter.update(ps, torch.from_numpy(pred), torch.from_numpy(gt))
        for k in ps:
            assert torch.equal(ps[k], before[k])
        ps = new
    _same_states(ps, js, name)
    _same_scores(pmeter.score(ps), jmeter.score(js), name)


def test_confusion_meter_counts_are_int64_and_exact():
    """Counts past f32's exact range stay exact: 2^24 + 1 pixels of one
    class (the JAX state would round the sum)."""
    from mtt_tpu_torch.evaluation.meters import ConfusionMeter
    m = ConfusionMeter(3)
    n = 2 ** 24 + 1
    s = m.update(m.init(), torch.ones(n, dtype=torch.long),
                 torch.ones(n, 1))
    assert s["tp"].dtype == torch.int64
    assert s["tp"].tolist() == [0, n, 0] and not s["fp"].any()
    assert m.score(s)["mIoU"] == pytest.approx(1 / 3)


def _jax_p(db, task_dictionary, **extra):
    """The JAX package's config for a database, as create_config builds the
    task table (``parse_task_dictionary``)."""
    from mtt_tpu.config.config import Config, parse_task_dictionary
    tasks, other = parse_task_dictionary(db, task_dictionary)
    return Config.wrap({"train_db_name": db, "ignore_index": 255,
                        "TASKS": tasks, **other, **extra})


def _db_configs():
    from mtt_tpu_torch.models.wrappers import (CS3D_SWINB, INVPT_PASCAL_VITL,
                                               NYUD_INVPT_VITL)
    return {"PASCALContext": INVPT_PASCAL_VITL, "NYUD": NYUD_INVPT_VITL,
            "Cityscapes3D": CS3D_SWINB}


@pytest.mark.parametrize("db", ["PASCALContext", "NYUD", "Cityscapes3D"])
def test_get_single_task_meter_matches_jax(db):
    """For each task of the database's config (but ``3ddet``), the port's
    factory gives the JAX factory's meter class with the same settings."""
    from mtt_tpu.evaluation.meters import get_single_task_meter as jget
    from mtt_tpu_torch.evaluation.meters import get_single_task_meter
    from mtt_tpu_torch.models.wrappers import task_table

    p = dict(_db_configs()[db], ignore_index=255)
    tasks, _ = task_table(db, p["task_dictionary"])
    jp = _jax_p(db, p["task_dictionary"])
    assert list(tasks) == list(jp.TASKS.NAMES)
    for t in tasks:
        if t == "3ddet":
            with pytest.raises(NotImplementedError):
                get_single_task_meter(p, db, t)
            continue
        got, want = get_single_task_meter(p, db, t), jget(jp, db, t)
        assert type(got).__name__ == type(want).__name__, t
        keys = set(vars(want)) - {"thresholds"}
        assert {k: vars(got)[k] for k in keys} == \
            {k: vars(want)[k] for k in keys}, t
        if hasattr(want, "thresholds"):
            np.testing.assert_array_equal(got.thresholds, want.thresholds)


def _task_case(tasks, num_out, rng, shape=(B, H, W)):
    """Post-processed predictions and labels of every task."""
    pred, gt = {}, {}
    for t in tasks:
        if t in ("semseg", "human_parts"):
            pred[t] = rng.integers(0, num_out[t], size=shape)
            gt[t] = _labels(rng, (*shape, 1), list(range(num_out[t])))
        elif t == "normals":
            pred[t] = rng.uniform(0, 255, size=(*shape, 3)).astype(
                np.float32)
            gt[t] = rng.normal(size=(*shape, 3)).astype(np.float32)
        elif t == "depth":
            pred[t] = rng.uniform(0, 10, size=shape).astype(np.float32)
            gt[t] = _labels(rng, (*shape, 1), [0.5, 2.0, 7.5])
        else:
            pred[t] = rng.uniform(0, 255, size=shape).astype(np.float32)
            gt[t] = _labels(rng, (*shape, 1), [0.0, 1.0])
    return pred, gt


@pytest.mark.parametrize("db", ["PASCALContext", "NYUD"])
def test_performance_meter_matches_jax(db):
    """Two multi-task updates, the scores, then reset: the port's
    ``PerformanceMeter`` against JAX's on the same inputs."""
    from mtt_tpu.evaluation.meters import PerformanceMeter as JPM
    from mtt_tpu_torch.evaluation.meters import PerformanceMeter
    from mtt_tpu_torch.models.wrappers import task_table

    p = dict(_db_configs()[db], ignore_index=255)
    tasks, num_out = task_table(db, p["task_dictionary"])
    jpm = JPM(_jax_p(db, p["task_dictionary"]), tasks)
    pm = PerformanceMeter(p, tasks + ("3ddet",), device="cpu")
    assert pm.tasks == list(tasks)
    rng = np.random.default_rng(3)
    for _ in range(2):
        pred, gt = _task_case(tasks, num_out, rng)
        jpm.update(pred, gt)
        pm.update({t: torch.from_numpy(v) for t, v in pred.items()},
                  {t: torch.from_numpy(v) for t, v in gt.items()})
    for t in tasks:
        _same_states(pm.states[t], jpm.states[t], t)
    got, want = pm.get_score(), jpm.get_score()
    assert got.keys() == want.keys()
    for t in want:
        _same_scores(got[t], want[t], t)
    pm.reset()
    assert all(not v.any() for s in pm.states.values() for v in s.values())


TASKS = ("semseg", "human_parts", "sal", "normals", "edge")
NUM_OUT = {"semseg": 21, "human_parts": 7, "sal": 2, "normals": 3, "edge": 1}
P = {"train_db_name": "PASCALContext", "ignore_index": 255,
     "task_dictionary": {"include_semseg": True, "include_human_parts": True,
                         "include_sal": True, "include_edge": True,
                         "include_normals": True, "edge_w": 0.95}}


def _invpt_vit_t():
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import TransformerNet
    model = TransformerNet(TASKS, NUM_OUT, (64, 64), "vitT", embed_dim=32,
                           pred_out=8, device="cpu")
    init_weights(model, torch.Generator().manual_seed(1))
    return model


def test_test_phase_matches_jax_meters_on_the_port_predictions():
    """``test_phase`` of a ViT-T InvPT over 2 synthetic batches against the
    JAX ``PerformanceMeter`` fed the port's own post-processed predictions
    (an eval forward and ``get_output`` per batch): every task's score; the
    intermediate predictions are not scored."""
    from mtt_tpu.evaluation.meters import PerformanceMeter as JPM
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.evaluation.meters import PerformanceMeter
    from mtt_tpu_torch.utils.postprocess import get_output
    from mtt_tpu_torch.utils.train_utils import test_phase, to_device

    model = _invpt_vit_t()
    data = SyntheticMT(TASKS, NUM_OUT, (64, 64), seed=4)
    batches = [data.batch(2 * i, 2) for i in range(2)]
    meter = PerformanceMeter(P, TASKS, device="cpu")
    meter.update({t: torch.zeros(1, 2, 2, dtype=torch.long) for t in TASKS
                  if t in ("semseg", "human_parts")} | {
        t: torch.zeros(1, 2, 2) for t in ("sal", "edge")} | {
        "normals": torch.zeros(1, 2, 2, 3)}, {
        t: torch.zeros(1, 2, 2, 3 if t == "normals" else 1) for t in TASKS})
    dev = [to_device(b, "cpu") for b in batches]
    scores = test_phase(P, model, dev, meter=meter)
    assert set(scores) == set(TASKS)

    jpm = JPM(_jax_p("PASCALContext", P["task_dictionary"]), TASKS)
    with torch.no_grad():
        for raw in batches:
            b = to_device(raw, "cpu")
            out = model(b["image"])
            jpm.update({t: get_output(out[t], t).numpy() for t in TASKS},
                       {t: raw[t] for t in TASKS})
    for t in TASKS:
        _same_states(meter.states[t], jpm.states[t], t)
    want = jpm.get_score()
    for t in TASKS:
        _same_scores(scores[t], want[t], t)
    # the same scores from the default meter, and from numpy batches as the
    # loader gives them (normalised by the transforms)
    assert test_phase(P, model, iter(dev)) == scores
    assert test_phase(P, model, [{k: v.numpy() for k, v in b.items()}
                                 for b in dev]) == scores


def test_eval_step_is_pure_and_skips_inter_preds():
    """``eval_step`` returns the post-processed maps of the meter's tasks
    only (not ``inter_preds``), new states, leaving the old ones, and no
    detection head output (the model has no ``3ddet``)."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.evaluation.meters import PerformanceMeter
    from mtt_tpu_torch.utils.train_utils import eval_step, to_device

    model = _invpt_vit_t()
    meter = PerformanceMeter(P, TASKS, device="cpu")
    b = to_device(SyntheticMT(TASKS, NUM_OUT, (64, 64), seed=4).batch(0, 1),
                  "cpu")
    old = meter.states
    processed, new, det = eval_step(model, meter, b, old)
    assert set(processed) == set(TASKS) and det is None
    assert processed["semseg"].shape == (1, 64, 64)
    assert all(not v.any() for s in old.values() for v in s.values())
    assert int(new["semseg"]["tp"].sum() + new["semseg"]["fn"].sum()) == \
        int((b["semseg"] != 255).sum())


def test_test_phase_refuses_saving_and_3ddet(tmp_path):
    """``test_phase`` refuses a ``3ddet`` model without the decode's
    ``det_cfg`` (tests/test_torch_det_eval.py scores one that has it).
    Saving predictions is not refused: the edge maps of the samples in
    ``meta`` are written, a pad sample's not."""
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.utils.train_utils import test_phase, to_device

    model = _invpt_vit_t()
    det = torch.nn.Linear(1, 1)
    det.tasks = ("semseg", "3ddet")
    with pytest.raises(ValueError, match="det_cfg"):
        test_phase({"train_db_name": "Cityscapes3D"}, det, [])
    b = to_device(SyntheticMT(TASKS, NUM_OUT, (64, 64), seed=4).batch(0, 2),
                  "cpu")
    b["meta"] = [{"img_name": "a", "img_size": (64, 64)},
                 {"img_name": "b", "img_size": (64, 64), "pad": True}]
    test_phase(dict(P, save_dir=str(tmp_path)), model, [b],
               save_tasks=("edge",))
    assert sorted(os.listdir(tmp_path / "edge")) == ["a.png"]
