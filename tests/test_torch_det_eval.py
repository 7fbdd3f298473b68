"""The port's Cityscapes-3D evaluation against the JAX package, on the CPU:
the geometry (``cs_geometry``, the new ``box3d`` functions, both NMS), the
export, the native IoU library against its plain version, the evaluator,
the record accumulator and ``test_phase`` / ``train_phase`` on a tiny
TaskPrompter-Swin.

The JAX evaluator's 2D IoU would build ``native/`` with make; its
``iou3d_native.available`` is patched to False here, so it takes its numpy
IoU, and the port's (the native library, built into ``build/``) is held to
it.

Tolerances, stated at each test: host numpy copies equal; the tensor
geometry at 1e-6 of the largest value in f32 and 1e-12 in f64; NMS keep
masks equal; the native IoU within 1e-12 of its plain version; evaluator
score dicts equal; decoded records (the same f32 decode with sums in
another order) at 1e-4 of each field's largest value.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_detection import _seeded_head_outputs, tiny_det_cfg
from test_torch_swin_model import TINY
from torch_threads import torch_threads  # noqa: F401

TASKS = ("semseg", "depth", "3ddet")
NUM_OUT = {"semseg": 19, "depth": 1, "3ddet": 18}
IMG, LABELS = (64, 128), (32, 64)
CAMERA = {"fx": 2262.52, "fy": 2265.3017905988554, "u0": 1096.98,
          "v0": 513.137,
          "sensor_T_ISO_8855": [
              [0.9990881051503779, -0.01948468779721943,
               -0.03799085532693703, -1.6501524664770573],
              [0.019498764210995674, 0.9998098810245096, 0.0,
               -0.1331288872611436],
              [0.03798363254444427, -0.0007407747301939942,
               0.9992780868764849, -1.2836173638418473]]}


@pytest.fixture
def jax_numpy_iou(monkeypatch):
    """JAX's evaluator on its numpy IoU, never its make-built library."""
    from mtt_tpu.detection import iou3d_native
    monkeypatch.setattr(iou3d_native, "available", lambda: False)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _boxes(rng, n, spread=30.0):
    """Seeded S-frame boxes (n, 9): centres in front of the camera."""
    b = np.zeros((n, 9))
    b[:, 0] = rng.uniform(-spread, spread, n)
    b[:, 1] = rng.uniform(-2, 3, n)
    b[:, 2] = rng.uniform(-1, 60, n)          # some behind the near plane
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6:9] = rng.uniform(-np.pi, np.pi, (n, 3))
    return b


def test_cs_geometry_matches_jax():
    """Every function of ``cs_geometry`` on seeded poses: equal in f64 (the
    same numpy), the f32 Euler encoding equal."""
    from mtt_tpu.detection import cs_geometry as J
    from mtt_tpu_torch.detection import cs_geometry as P
    assert P.EVAL_LABELS == J.EVAL_LABELS and P.LABEL_TO_ID == J.LABEL_TO_ID
    assert np.array_equal(P.k_multiplier(), J.k_multiplier())
    assert np.array_equal(P.projection_matrix(1.5, 2, 3, 4),
                          J.projection_matrix(1.5, 2, 3, 4))
    rng = np.random.default_rng(0)
    ext = np.asarray(CAMERA["sensor_T_ISO_8855"])
    for _ in range(20):
        c = rng.normal(size=3) * 20
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = rng.normal(size=4)
        for name in ("quat_inv", "quat_to_matrix"):
            _close(getattr(P, name)(q), getattr(J, name)(q), 1e-12, name)
        _close(P.quat_mul(q, r), J.quat_mul(q, r), 1e-12, "quat_mul")
        m = J.quat_to_matrix(q)
        _close(P.quat_from_matrix(m), J.quat_from_matrix(m), 1e-12, "q(m)")
        for name in ("box_v_to_s", "box_s_to_v"):
            for g, w in zip(getattr(P, name)(c, q, ext),
                            getattr(J, name)(c, q, ext)):
                _close(g, w, 1e-12, name)
        e = P.rotation_s_to_euler_zxy(q)
        assert e.dtype == np.float32
        assert np.array_equal(e, J.rotation_s_to_euler_zxy(q))
        _close(P.euler_zxy_to_quat_s(e), J.euler_zxy_to_quat_s(e), 1e-12,
               "euler")


def test_export_matches_jax(tmp_path):
    """``bbox_to_json_objects`` on seeded decoded boxes (some behind the
    near plane, some slots invalid) gives JAX's objects, and
    ``save_image_predictions`` writes what JAX's writes; so does
    ``save_det_predictions`` for a decoded batch of two (tensors), but for
    its pad sample, which the port leaves out."""
    from mtt_tpu.detection import export as J
    from mtt_tpu.evaluation.save_preds import save_det_predictions as jsave
    from mtt_tpu_torch.detection import export as P
    from mtt_tpu_torch.evaluation.save_preds import save_det_predictions
    rng = np.random.default_rng(1)
    n = 24
    boxes = _boxes(rng, n).astype(np.float32)
    b2d = rng.uniform(0, 1000, (n, 4)).astype(np.float32)
    scores = rng.uniform(size=n).astype(np.float32)
    labels = rng.integers(0, 6, n)
    valid = rng.uniform(size=n) > 0.25
    got = P.bbox_to_json_objects(boxes, b2d, scores, labels, valid, CAMERA)
    want = J.bbox_to_json_objects(boxes, b2d, scores, labels, valid, CAMERA)
    assert got == want and len(got) == valid.sum()
    assert any(o["2d"]["amodal"] == [0.0] * 4 for o in got)   # behind
    P.save_image_predictions(str(tmp_path / "p"), "img", got)
    J.save_image_predictions(str(tmp_path / "j"), "img", want)
    assert (tmp_path / "p" / "img.json").read_bytes() == \
        (tmp_path / "j" / "img.json").read_bytes()
    dec = {"boxes3d": boxes.reshape(2, 12, 9), "bboxes2d": b2d.reshape(2, 12, 4),
           "scores": scores.reshape(2, 12), "labels": labels.reshape(2, 12),
           "valid": valid.reshape(2, 12)}
    metas = [{"img_name": "a", "camera": CAMERA},
             {"img_name": "b", "camera": CAMERA}]
    jsave(str(tmp_path / "j"), dec, metas)
    save_det_predictions(str(tmp_path / "p"),
                         {k: torch.from_numpy(v) for k, v in dec.items()},
                         [metas[0], dict(metas[1], pad=True)])
    assert sorted(os.listdir(tmp_path / "p" / "3ddet")) == ["a.json"]
    assert (tmp_path / "p" / "3ddet" / "a.json").read_bytes() == \
        (tmp_path / "j" / "3ddet" / "a.json").read_bytes()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_box3d_functions_match_jax(dtype):
    """``points_cam2img``, ``euler_to_quaternion`` and ``corners_3d`` on
    seeded inputs: 1e-6 of the largest value in f32, 1e-12 in f64 (JAX with
    x64 on)."""
    from mtt_tpu.detection import box3d as J
    from mtt_tpu_torch.detection import box3d as P
    tol = 1e-6 if dtype == "float32" else 1e-12
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(40, 3)).astype(dtype) * 10
    pts[:, 2] = np.abs(pts[:, 2])
    pts[0, 2] = 0.0                                   # the depth floor
    K = np.array([[2262.52, 0, 1096.98], [0, 2265.3, 513.137], [0, 0, 1]],
                 dtype)
    ang = rng.uniform(-np.pi, np.pi, (3, 40)).astype(dtype)
    boxes = _boxes(rng, 40).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = (J.points_cam2img(jnp.asarray(pts), jnp.asarray(K)),
                J.euler_to_quaternion(*map(jnp.asarray, ang)),
                J.corners_3d(jnp.asarray(boxes)))
        want = [np.asarray(w) for w in want]
    got = (P.points_cam2img(torch.from_numpy(pts), torch.from_numpy(K)),
           P.euler_to_quaternion(*map(torch.from_numpy, ang)),
           P.corners_3d(torch.from_numpy(boxes)))
    for name, g, w in zip(("cam2img", "quaternion", "corners"), got, want):
        assert g.dtype == getattr(torch, dtype), name
        _close(g.numpy(), w, tol, name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nms_matches_jax(dtype):
    """``nms_bev`` and ``nms_normal_bev`` on seeded overlapping BEV boxes,
    with and without a valid mask: the keep masks equal JAX's."""
    from mtt_tpu.detection import iou3d as J
    from mtt_tpu_torch.detection import iou3d as P
    rng = np.random.default_rng(3)
    n = 40
    bev = np.concatenate([rng.uniform(-6, 6, (n, 2)),
                          rng.uniform(1, 4, (n, 2)),
                          rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(dtype)
    scores = rng.permutation(n).astype(dtype) / n
    valid = rng.uniform(size=n) > 0.2
    with jax.enable_x64(dtype == "float64"):
        for name in ("nms_bev", "nms_normal_bev"):
            # jitted: JAX's op-by-op sweep takes seconds
            jnms = jax.jit(getattr(J, name), static_argnums=2)
            for v in (None, valid):
                want = np.asarray(jnms(
                    jnp.asarray(bev), jnp.asarray(scores), 0.2,
                    jnp.ones(n, bool) if v is None else jnp.asarray(v)))
                got = getattr(P, name)(
                    torch.from_numpy(bev), torch.from_numpy(scores), 0.2,
                    None if v is None else torch.from_numpy(v)).numpy()
                assert np.array_equal(got, want), (name, v is None)
                assert 3 < want.sum() < (n if v is None else valid.sum())


def test_native_iou_matches_its_plain_version(tmp_path, monkeypatch):
    """The library built from ``native/iou3d.cpp`` into ``build/``: its 2D
    IoU within 1e-12 of the plain version, on overlapping, disjoint and
    inverted boxes; a build that fails raises (no fallback)."""
    from mtt_tpu_torch.detection import iou3d_native as nat
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 100, (30, 4))
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 100, (20, 4))
    b[:, 2:] += b[:, :2] * rng.uniform(0.5, 1.5, (20, 2))  # some inverted
    got = nat.iou_matrix_2d(a, b)
    assert (got > 0).sum() > 20
    _close(got, nat.iou_matrix_2d(a, b, impl="plain"), 1e-12, "2d")
    assert nat.iou_matrix_2d(a[:0], b).shape == (0, 20)
    assert (got == 0).sum() > 20
    _close(nat.iou_matrix_2d(a, a), nat.iou_matrix_2d(a, a, impl="plain"),
           1e-12, "2d self")
    assert os.path.dirname(os.path.dirname(nat.lib()._name)) == \
        str(nat.BUILD_ROOT)
    with pytest.raises(ValueError, match="impl"):
        nat.iou_matrix_2d(a, b, impl="numpy")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nat, "SOURCE", bad)
    monkeypatch.setattr(nat, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        nat.build()


def _record_objects(rng, n_img=6, n_gt=5):
    """Seeded official-format GT and prediction objects per image:
    predictions near each GT (scores spread over the sweep), false
    positives, and ignore regions."""
    out = []
    labels = ("car", "truck", "bus", "bicycle")
    for i in range(n_img):
        gts, preds, ign = [], [], []
        for _ in range(n_gt):
            lbl = labels[rng.integers(0, len(labels))]
            x, y = rng.uniform(0, 1800), rng.uniform(200, 800)
            w, h = rng.uniform(30, 200), rng.uniform(30, 150)
            c = [rng.uniform(5, 110), rng.uniform(-20, 20),
                 rng.uniform(0, 2)]
            dims = list(rng.uniform(1, 5, 3))
            q = rng.normal(size=4)
            q = list(q / np.linalg.norm(q))
            gts.append({"label": lbl, "2d": {"modal": [x, y, w, h]},
                        "3d": {"center": c, "dimensions": dims,
                               "rotation": q}})
            if rng.uniform() < 0.8:
                j = rng.normal(size=4) * 0.05
                dq = np.asarray(q) + rng.normal(size=4) * 0.1
                preds.append({
                    "label": lbl, "score": float(rng.uniform()),
                    "2d": {"modal": [x + j[0] * w, y + j[1] * h,
                                     w * (1 + j[2]), h * (1 + j[3])]},
                    "3d": {"center": list(np.asarray(c)
                                          + rng.normal(size=3)),
                           "dimensions": list(np.asarray(dims)
                                              * rng.uniform(0.8, 1.2, 3)),
                           "rotation": list(dq / np.linalg.norm(dq))}})
        for _ in range(3):
            preds.append({
                "label": labels[rng.integers(0, len(labels))],
                "score": float(rng.uniform()),
                "2d": {"modal": list(rng.uniform(0, 900, 4))},
                "3d": {"center": list(rng.uniform(1, 80, 3)),
                       "dimensions": list(rng.uniform(1, 4, 3)),
                       "rotation": [1.0, 0.0, 0.0, 0.0]}})
        if i % 2:
            ign.append({"2d": list(preds[-1]["2d"]["modal"])})
        out.append((f"img{i}", gts, preds, ign))
    return out


def test_box3d_evaluator_matches_jax(tmp_path, jax_numpy_iou):
    """``Box3dEvaluator`` on the same seeded records gives JAX's score dict,
    and so does a ``load_folders`` round trip of them through JSON files
    (``evaluate_3d_detection``); the plain IoU gives the same dict."""
    from mtt_tpu.detection import eval3d as J
    from mtt_tpu_torch.detection import eval3d as P
    recs = _record_objects(np.random.default_rng(5))
    evs = [J.Box3dEvaluator(), P.Box3dEvaluator(),
           P.Box3dEvaluator(impl="plain")]
    for name, gts, preds, ign in recs:
        for ev in evs:
            ev.add_image(name, gts, preds, ign)
    want = evs[0].evaluate()
    assert 0.1 < want["mAP"] < 1 and 0 < want["mDetection_Score"] < 1
    assert evs[1].evaluate() == want and evs[2].evaluate() == want
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    for d in (gt_dir / "city", pred_dir):
        d.mkdir(parents=True)
    for name, gts, preds, ign in recs:
        (gt_dir / "city" / f"{name}_gtBbox3d.json").write_text(json.dumps(
            {"objects": gts, "ignore": ign}))
        (pred_dir / f"{name}.json").write_text(json.dumps(
            {"objects": preds}))
    got = P.evaluate_3d_detection(str(gt_dir), str(pred_dir))
    assert got == J.evaluate_3d_detection(str(gt_dir), str(pred_dir))
    assert got["mAP"] == pytest.approx(want["mAP"], rel=1e-12)


def _det_batch(B, seed):
    """A synthetic Cityscapes-3D batch at 64x128 through the port's val
    transforms (labels at 32x64), as the loader collates it."""
    from mtt_tpu_torch.config.config import Config
    from mtt_tpu_torch.data.cityscapes3d import CS3DValTransforms
    from mtt_tpu_torch.data.loader import collate
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    tf = CS3DValTransforms(Config.wrap({"dd_label_map_size": LABELS,
                                        "TRAIN": {"SCALE": IMG}}))
    ds = SyntheticMT(TASKS, NUM_OUT, IMG, seed=seed, max_boxes=8,
                     transform=tf)
    return collate([ds[i] for i in range(B)])


def test_det_record_accumulator_matches_jax(jax_numpy_iou):
    """The port's ``DetRecordAccumulator`` against JAX's on the same seeded
    head outputs (3 images, the last a pad sample) and synthetic batch: the
    same image names and GT objects, and the same predicted objects (the
    decode of the same f32 function: every field within 1e-4 of its largest
    value, labels equal); both score the records alike."""
    from mtt_tpu.detection.det_eval import DetRecordAccumulator as JAcc
    from mtt_tpu.detection.det_params import default_det_params as jmake
    from mtt_tpu_torch.detection.det_eval import DetRecordAccumulator
    from mtt_tpu_torch.detection.det_params import default_det_params
    sizes = [(8, 16), (4, 8), (2, 4), (2, 4), (1, 2)]
    heads = [_seeded_head_outputs(s, sizes, 6, cls_bias=-4.0)
             for s in range(3)]
    head = tuple([np.stack([heads[i][g][lvl] for i in range(3)])
                  for lvl in range(len(sizes))] for g in range(4))
    batch = _det_batch(3, seed=6)
    batch["meta"][2] = dict(batch["meta"][0], pad=True)
    cfgs = []
    for make in (jmake, default_det_params):
        cfg = make(6)
        cfg["test_cfg"]["nms_pre"] = 100
        cfg["test_cfg"]["max_per_img"] = 150
        cfgs.append(cfg)
    jacc = JAcc(types.SimpleNamespace(det_cfg=cfgs[0]))
    jacc.add_batch(head, batch)
    acc = DetRecordAccumulator(cfgs[1])
    acc.add_batch(tuple([torch.from_numpy(a) for a in lvl] for lvl in head),
                  batch)
    assert [r[0] for r in acc.records] == [r[0] for r in jacc.records] == \
        ["synth_000000", "synth_000001"]
    for (_, gt, pred), (_, jgt, jpred) in zip(acc.records, jacc.records):
        assert gt == jgt and len(gt) > 0
        assert 3 < len(pred) == len(jpred) < 150
        assert [o["label"] for o in pred] == [o["label"] for o in jpred]
        for key in (("2d", "modal"), ("2d", "amodal"), ("3d", "center"),
                    ("3d", "dimensions"), ("3d", "rotation"), ("score",)):
            def leaf(o):
                for k in key:
                    o = o[k]
                return o
            _close([leaf(o) for o in pred], [leaf(o) for o in jpred], 1e-4,
                   key)
    got, want = acc.evaluate(), jacc.evaluate()
    assert got["GT_stats"] == want["GT_stats"]
    assert got["mDetection_Score"] == pytest.approx(want["mDetection_Score"],
                                                    abs=1e-6)


def _tiny_swin():
    from mtt_tpu_torch.detection.det_params import default_det_params
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import TaskPrompterSwinNet
    model = TaskPrompterSwinNet(
        TASKS, NUM_OUT, IMG, det_cfg=tiny_det_cfg(default_det_params, 6),
        target_size=LABELS, drop_path_rate=0.0, device="cpu", **TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():       # the class prior at 0.5: boxes survive
        model.det_head.fcos3d.conv_cls.bias.fill_(0.0)
    return model


def _p(tmp_path):
    return {"train_db_name": "Cityscapes3D", "ignore_index": 255,
            "intermediate_supervision": False,
            "loss_kwargs": {"loss_weights": {"semseg": 100.0, "depth": 1.0,
                                             "3ddet": 1.0}},
            "optimizer": "adam", "optimizer_kwargs": {"lr": 1e-4},
            "scheduler": "poly", "max_iter": 10,
            "grad_clip_param": {"max_norm": 10.0, "norm_type": 2},
            "ignore_invalid_area_depth": True,
            "save_dir": str(tmp_path / "results"),
            "checkpoint": str(tmp_path / "checkpoint")}


def test_test_phase_scores_3ddet_as_jax(tmp_path, jax_numpy_iou):
    """``test_phase`` of the tiny Swin over 2 batches (the second with a pad
    sample): the 2D scores and ``scores["3ddet"]``, which equals JAX's
    ``Box3dEvaluator`` over the port's records (the predictions read back
    from the JSONs it wrote, the ground truth rebuilt by JAX's
    ``_gt_objects_from_batch``); ``evaluate_detection`` scores the same."""
    from mtt_tpu.detection.det_eval import _gt_objects_from_batch
    from mtt_tpu.detection.eval3d import Box3dEvaluator
    from mtt_tpu_torch.detection.det_eval import evaluate_detection
    from mtt_tpu_torch.utils.train_utils import test_phase
    model = _tiny_swin()
    p = _p(tmp_path)
    batches = [_det_batch(2, seed=7), _det_batch(2, seed=8)]
    batches[1]["meta"][1] = dict(batches[1]["meta"][1], pad=True)
    scores = test_phase(p, model, batches)
    assert set(scores) == set(TASKS)
    assert set(scores["3ddet"]) == {"mDetection_Score", "mAP"}
    files = sorted(os.listdir(os.path.join(p["save_dir"], "3ddet")))
    assert files == ["synth_000000.json", "synth_000001.json"]
    ev = Box3dEvaluator()
    n_pred = 0
    for batch in batches:
        for i, meta in enumerate(batch["meta"]):
            if meta.get("pad"):
                continue
            with open(os.path.join(p["save_dir"], "3ddet",
                                   meta["img_name"] + ".json")) as f:
                pred = json.load(f)["objects"]
            n_pred += len(pred)
            ev.add_image(meta["img_name"], _gt_objects_from_batch(batch, i),
                         pred)
    want = ev.evaluate()
    assert n_pred > 20
    assert scores["3ddet"] == {"mDetection_Score": want["mDetection_Score"],
                               "mAP": want["mAP"]}
    tensors = [{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in b.items()} for b in batches]
    got = evaluate_detection(model, tensors)
    assert got["mDetection_Score"] == want["mDetection_Score"]


def test_train_phase_writes_the_epoch_detections(tmp_path):
    """``train_phase`` of the tiny Swin with a ``save_dir``: one step, the
    first batch's detections as ``b0_`` JSONs and wireframe PNGs under
    ``train/3ddet`` (each PNG a decodable image of the batch's size), and
    the eval's ``results_iter1.json`` with the 3ddet scores."""
    from mtt_tpu_torch.config.config import Config
    from mtt_tpu_torch.data.cityscapes3d import CS3DTrainTransforms
    from mtt_tpu_torch.data.loader import MultiTaskLoader
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.evaluation.save_preds import read_png
    from mtt_tpu_torch.utils.train_utils import Trainer, train_phase
    model = _tiny_swin()
    p = _p(tmp_path)
    tf = CS3DTrainTransforms(Config.wrap({"dd_label_map_size": LABELS,
                                          "TRAIN": {"SCALE": IMG}}))
    ds = SyntheticMT(TASKS, NUM_OUT, IMG, seed=9, max_boxes=8, length=2,
                     transform=tf)
    train = MultiTaskLoader(ds, 2, shuffle=False, num_workers=1)
    val = MultiTaskLoader(ds, 2, shuffle=False, num_workers=1,
                          drop_last=False)
    trainer = Trainer(model, p, TASKS, torch.float32,
                      torch.Generator().manual_seed(0), log_fn=lambda s: None)
    train_phase(p, trainer, train, val, max_iter=1, val_interval=1,
                log_every=1)
    out = os.path.join(p["save_dir"], "train", "3ddet")
    names = sorted(os.listdir(out))
    jsons = [n for n in names if n.endswith(".json")]
    pngs = [n for n in names if n.endswith(".png")]
    assert jsons == ["b0_synth_000000.json", "b0_synth_000001.json"]
    assert len(pngs) == 2 and all(n.startswith("b0_synth_") for n in pngs)
    for n in pngs:
        with open(os.path.join(out, n[:15] + ".json")) as f:
            assert int(n[16:-4]) == len(json.load(f)["objects"]) > 0
        assert read_png(os.path.join(out, n)).shape == (*IMG, 3)
    with open(os.path.join(p["save_dir"], "results_iter1.json")) as f:
        res = json.load(f)
    assert set(res) == set(TASKS) and \
        0 <= res["3ddet"]["mDetection_Score"] <= 1
