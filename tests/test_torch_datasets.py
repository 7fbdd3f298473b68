"""The port's dataset readers (``mtt_tpu_torch/data/datasets.py``:
``PASCALContext``, ``NYUD_MT``; ``data/cityscapes3d.py: Cityscapes3D``) and
``common_config.get_dataset`` with a data root on disk, against the JAX
package's on the same files, on the CPU.

Each test builds a tiny tree in the dataset's own layout in ``tmp_path``:
JPEGs (baseline, progressive, grey) and palette PNGs written by PIL, 16-bit
disparity PNGs by cv2, ``.mat`` label maps and the nested human-parts
``anno`` struct by ``scipy.io.savemat``, the ``db_info`` JSONs, gtBbox3d
JSONs (one training frame without boxes of the evaluated classes).

Tolerances: ``len``, order, ``meta`` and every array of every sample
without transforms equal to the bit; with the val transforms equal to the
bit as well (they normalise and pad, and the Cityscapes-3D linear resize is
cv2's float path bit for bit, ``tests/test_torch_vis.py``); loader batches through the training
transforms as ``tests/test_torch_data.py`` states them (labels bit-equal,
the normalised image apart by at most one uint8 level on at most 0.1% of
the pixels).
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import scipy.io as sio
from PIL import Image

from torch_threads import torch_threads  # noqa: F401

# (h, w): VOC's 375x500, 500x375 and 333x500 shapes, cut by 10
PASCAL_SIZES = ((37, 50), (50, 37), (33, 50), (40, 40))
NYU = ["wall", "floor", "bed", "unknown", "chair"]
CONTEXT = {"unknown": 0, "wall": 3, "floor": 4, "bed": 5, "sky": 6,
           "tvmonitor": 7, "person": 15, "chair": 9}
PARTS = ("head", "torso", "luarm", "rlleg", "hair", "lhand")


def _photo(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 90 * np.sin(xx / (5.0 + c)) * np.cos(yy / 4.0)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def _labels(rng, h, w, values):
    """A label map of a few rectangles of ``values``."""
    out = np.full((h, w), values[0], np.uint16)
    for v in values[1:]:
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        dy, dx = rng.integers(4, h // 2 + 5), rng.integers(4, w // 2 + 5)
        out[y:y + dy, x:x + dx] = v
    return out


def _parts_mat(path, rng, h, w, human: bool):
    """The ``anno`` struct of a PASCAL-Part .mat: an object of class 15
    (person) with parts when ``human``, and a chair without parts."""
    part_dt = [("part_name", "O"), ("mask", "O")]
    obj_dt = [("class", "O"), ("class_ind", "O"), ("mask", "O"),
              ("parts", "O")]
    objs = []
    if human:
        parts = np.zeros((1, 3), part_dt)
        for i in range(3):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
            m[y:y + 6, x:x + 6] = 1
            parts[0, i] = (PARTS[rng.integers(0, len(PARTS))], m)
        objs.append(("person", np.array([[15]], np.uint8),
                     np.ones((h, w), np.uint8), parts))
    objs.append(("chair", np.array([[9]], np.uint8),
                 np.ones((h, w), np.uint8), np.zeros((0, 0))))
    arr = np.zeros((1, len(objs)), obj_dt)
    for i, o in enumerate(objs):
        arr[0, i] = o
    anno = np.zeros((1, 1), [("imname", "O"), ("objects", "O")])
    anno[0, 0] = ("img", arr)
    sio.savemat(path, {"anno": anno})


def pascal_tree(root, n_train=6, n_val=4, listed_train=0, seed=0):
    """A PASCAL-Context tree; ``listed_train`` more train ids are listed
    without files (for ``overfit``)."""
    rng = np.random.default_rng(seed)
    for d in ("JPEGImages", "ImageSets/Context", "pascal-context/trainval",
              "human_parts", "semseg/VOC12", "semseg/pascal-context",
              "normals_distill", "sal_distill", "db_info"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "db_info", "nyu_classes.json"), "w") as f:
        json.dump(NYU, f)
    with open(os.path.join(root, "db_info", "context_classes.json"),
              "w") as f:
        json.dump(CONTEXT, f)
    ids = {"train": [f"2008_{i:06d}" for i in range(n_train)],
           "val": [f"2009_{i:06d}" for i in range(n_val)]}
    for split, names in ids.items():
        listed = names + [f"2010_{i:06d}" for i in range(
            listed_train if split == "train" else 0)]
        with open(os.path.join(root, "ImageSets", "Context",
                               split + ".txt"), "w") as f:
            f.write("\n".join(listed) + "\n")
        for k, name in enumerate(names):
            h, w = PASCAL_SIZES[k % len(PASCAL_SIZES)]
            img = _photo(rng, h, w)
            kw = {0: dict(quality=90), 1: dict(quality=75, progressive=True),
                  2: dict(quality=85, subsampling=0)}.get(k % 4)
            if kw is None:             # a grey JPEG: repeated to RGB
                Image.fromarray(img[..., 0]).save(
                    os.path.join(root, "JPEGImages", name + ".jpg"),
                    quality=80)
            else:
                Image.fromarray(img).save(
                    os.path.join(root, "JPEGImages", name + ".jpg"), **kw)
            lbl = _labels(rng, h, w, [0, 3, 4, 6, 7, 9, 15])
            sio.savemat(os.path.join(root, "pascal-context", "trainval",
                                     name + ".mat"), {"LabelMap": lbl})
            if k % 3 != 2:             # one id in three has no parts file
                _parts_mat(os.path.join(root, "human_parts", name + ".mat"),
                           rng, h, w, human=k % 3 == 0)
            sem = rng.integers(0, 21, (h, w)).astype(np.uint8)
            if k % 2 == 0:             # VOC12: a palette PNG
                im = Image.fromarray(sem, "P")
                im.putpalette(rng.integers(0, 256, 768).astype(np.uint8)
                              .tobytes())
                if k == 2:             # a label map of another size
                    im = im.resize((w + 3, h - 2), Image.NEAREST)
                im.save(os.path.join(root, "semseg", "VOC12", name + ".png"))
            else:
                Image.fromarray(sem).save(os.path.join(
                    root, "semseg", "pascal-context", name + ".png"))
            Image.fromarray(_photo(rng, h, w)).save(
                os.path.join(root, "normals_distill", name + ".png"))
            Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8)) \
                .save(os.path.join(root, "sal_distill", name + ".png"))
    return ids


def nyud_tree(root, n_val=3, listed=0, seed=1, size=(24, 30)):
    rng = np.random.default_rng(seed)
    for d in ("gt_sets", "images", "edge", "segmentation", "normals",
              "depth"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = [f"{i:04d}" for i in range(n_val)]
    for split in ("train", "val"):
        with open(os.path.join(root, "gt_sets", split + ".txt"), "w") as f:
            f.write("\n".join(names + [f"x{i:04d}" for i in range(listed)])
                    + "\n")
    h, w = size
    for k, name in enumerate(names):
        path = os.path.join(root, "images", name + ".png")
        if k == 1:                     # a JPEG under a .png name: sniffed
            Image.fromarray(_photo(rng, h, w)).save(path, "JPEG",
                                                    quality=85)
        else:
            Image.fromarray(_photo(rng, h, w)).save(path)
        Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8)).save(
            os.path.join(root, "edge", name + ".png"))
        Image.fromarray(rng.integers(0, 41, (h, w)).astype(np.uint8)).save(
            os.path.join(root, "segmentation", name + ".png"))
        Image.fromarray(_photo(rng, h, w)).save(
            os.path.join(root, "normals", name + ".png"))
        np.save(os.path.join(root, "depth", name + ".npy"),
                rng.uniform(0, 10, (h, w)).astype(np.float32))
    return names


SENSOR = {"fx": 2262.52, "fy": 2265.3017905988554, "u0": 1096.98,
          "v0": 513.137,
          "sensor_T_ISO_8855": [[0.999, -0.0195, -0.038, -1.65],
                                [0.0195, 0.9998, 0.0, -0.133],
                                [0.038, -0.0007, 0.9993, -1.284]]}


def _boxes(rng, labels):
    out = []
    for lbl in labels:
        q = rng.normal(size=4)
        out.append({"label": lbl,
                    "2d": {"modal": list(rng.uniform(0, 40, 4)),
                           "amodal": list(rng.uniform(0, 40, 4))},
                    "3d": {"center": [rng.uniform(5, 60),
                                      rng.uniform(-10, 10),
                                      rng.uniform(-1, 2)],
                           "dimensions": list(rng.uniform(1, 5, 3)),
                           "rotation": list(q / np.linalg.norm(q))}})
    return out


def cityscapes_tree(root, frames, size=(24, 48), seed=2, empty=False):
    """Frames {split: [(city, labels of its boxes), ...]}; with ``empty``
    the image files hold nothing (for the file lists only)."""
    rng = np.random.default_rng(seed)
    h, w = size
    for split, items in frames.items():
        for i, (city, labels) in enumerate(items):
            base = f"{city}_000000_{i:06d}_"
            dirs = {k: os.path.join(root, k, split, city) for k in
                    ("leftImg8bit", "gtFine", "disparity", "gtBbox3d")}
            for d in dirs.values():
                os.makedirs(d, exist_ok=True)
            img_path = os.path.join(dirs["leftImg8bit"],
                                    base + "leftImg8bit.png")
            with open(os.path.join(dirs["gtBbox3d"], base + "gtBbox3d.json"),
                      "w") as f:
                json.dump({"sensor": SENSOR,
                           "objects": _boxes(rng, labels)}, f)
            if empty:
                open(img_path, "wb").close()
                continue
            cv2.imwrite(img_path, _photo(rng, h, w))
            lbl = rng.choice([7, 8, 10, 11, 26, 0, 33], (h, w)).astype(
                np.uint8)
            cv2.imwrite(os.path.join(dirs["gtFine"],
                                     base + "gtFine_labelIds.png"), lbl)
            disp = rng.integers(0, 20000, (h, w)).astype(np.uint16)
            disp[rng.random((h, w)) < 0.2] = 0
            cv2.imwrite(os.path.join(dirs["disparity"], base +
                                     "disparity.png"), disp)


CS_FRAMES = {"train": [("aachen", ["car", "person"]), ("aachen", ["person"]),
                       ("bochum", ["truck", "bicycle", "car"])],
             "val": [("frankfurt", ["car"]), ("lindau", ["bus", "person"])]}


def _equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = got[k], want[k]
        if k == "meta":
            assert g.keys() == w.keys(), what
            for mk in w:
                if isinstance(w[mk], np.ndarray):
                    assert np.array_equal(g[mk], w[mk]), (what, mk)
                else:
                    assert g[mk] == w[mk], (what, mk)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
            assert np.array_equal(g, w), (what, k)


def _both(kind, *args, **kw):
    if kind == "pascal":
        from mtt_tpu.data.datasets import PASCALContext as J
        from mtt_tpu_torch.data.datasets import PASCALContext as P
    elif kind == "nyud":
        from mtt_tpu.data.datasets import NYUD_MT as J
        from mtt_tpu_torch.data.datasets import NYUD_MT as P
    else:
        from mtt_tpu.data.cityscapes3d import Cityscapes3D as J
        from mtt_tpu_torch.data.cityscapes3d import Cityscapes3D as P
    return J(*args, **kw), P(*args, **kw)


ALL_PASCAL = dict(do_edge=True, do_semseg=True, do_human_parts=True,
                  do_normals=True, do_sal=True)


@pytest.mark.parametrize("split", ["train", "val"])
def test_pascal_matches_jax(tmp_path, split):
    """PASCAL-Context, every task: ``len``, ids, the parts cache each
    writes, and every sample equal to JAX's to the bit (images from
    baseline, progressive, 4:4:4 and grey JPEGs; palette and grey semseg
    PNGs, one of another size; thinned edges; merged human parts;
    NYU-masked normals; thresholded saliency)."""
    root = tmp_path / "PASCALContext"
    pascal_tree(str(root))
    jds, pds = _both("pascal", str(root), split=split, **ALL_PASCAL)
    assert len(pds) == len(jds) == (6 if split == "train" else 4)
    assert pds.im_ids == jds.im_ids and pds.images == jds.images
    assert pds.has_human_parts == jds.has_human_parts
    assert 0 < sum(pds.has_human_parts) < len(pds)
    for i in range(len(jds)):
        got = pds[i]
        _equal(got, jds[i], (split, i))
        assert got["edge"].sum() > 0
        if pds.has_human_parts[i]:
            assert got["human_parts"].max() > 0
    # the cache written by the first is read by the next: same samples
    again = _both("pascal", str(root), split=split, **ALL_PASCAL)[1]
    _equal(again[0], pds[0], "cached")


def test_pascal_overfit_and_defaults_match_jax(tmp_path):
    """``overfit`` keeps the first 64 of 70 listed ids in both; with the
    default flags (edge only) the samples equal JAX's."""
    root = tmp_path / "PASCALContext"
    pascal_tree(str(root), n_train=2, listed_train=68)
    jds, pds = _both("pascal", str(root), split=["train"], overfit=True,
                     do_human_parts=True)
    assert len(pds) == len(jds) == 64 and pds.im_ids == jds.im_ids
    assert pds.has_human_parts == jds.has_human_parts
    jds, pds = _both("pascal", str(root), split="val")
    for i in range(len(jds)):
        _equal(pds[i], jds[i], i)


def test_laplacian_and_thinning_match_jax():
    """``laplacian`` equals ``cv2.Laplacian`` (ksize 1, f64) on label maps,
    one row or column wide too; ``zhang_suen_thin`` equals JAX's."""
    from mtt_tpu.data.datasets import zhang_suen_thin as jthin
    from mtt_tpu_torch.data.datasets import laplacian, zhang_suen_thin
    rng = np.random.default_rng(3)
    for shape in ((37, 50), (1, 9), (9, 1), (2, 2)):
        lbl = rng.integers(0, 5, shape).astype(np.uint16)
        want = cv2.Laplacian(lbl.astype(np.float64), cv2.CV_64F)
        assert np.array_equal(laplacian(lbl), want), shape
    lbl = _labels(rng, 60, 80, [0, 1, 2, 3, 4])
    mask = np.abs(laplacian(lbl)) > 0
    got = zhang_suen_thin(mask)
    assert got.dtype == np.float32 and 0 < got.sum() < mask.sum()
    assert np.array_equal(got, jthin(mask))
    assert np.array_equal(zhang_suen_thin(mask[:0]), jthin(mask[:0]))


def test_nyud_matches_jax(tmp_path):
    """NYUD-v2, the four tasks: ``len``, ids and samples equal to JAX's
    (one image a JPEG under a .png name); ``overfit`` keeps 64."""
    root = tmp_path / "NYUD_MT"
    nyud_tree(str(root))
    flags = dict(do_edge=True, do_semseg=True, do_normals=True,
                 do_depth=True)
    jds, pds = _both("nyud", str(root), split="val", **flags)
    assert len(pds) == len(jds) == 3 and pds.im_ids == jds.im_ids
    for i in range(len(jds)):
        _equal(pds[i], jds[i], i)
    root2 = tmp_path / "NYUD_long"
    nyud_tree(str(root2), n_val=1, listed=69)
    jds, pds = _both("nyud", str(root2), split="val", overfit=True)
    assert len(pds) == len(jds) == 64 and pds.im_ids == jds.im_ids


def test_cityscapes_matches_jax(tmp_path):
    """Cityscapes-3D: the ``os.walk`` file lists (the training frame
    without boxes of the evaluated classes dropped), every sample (RGB
    PNG, label ids encoded, 16-bit disparity to (d - 1) / 256 with -1 and
    sky 0, the padded boxes, ``meta`` with ``K_matrix``, ``camera``,
    ``scale_factor``) equal to JAX's; ``overfit`` keeps 16 of 17."""
    root = tmp_path / "Cityscapes3D"
    cityscapes_tree(str(root), CS_FRAMES)
    for split in ("train", "val"):
        jds, pds = _both("cs", str(root), split=split)
        assert pds.files == jds.files
        assert len(pds) == (2 if split == "train" else 2)
        for i in range(len(jds)):
            got = pds[i]
            _equal(got, jds[i], (split, i))
            assert (got["depth"] == -1).any() and (got["depth"] == 0).any()
    root2 = tmp_path / "CS_many"
    cityscapes_tree(str(root2), {"train": [("ulm", ["car"])] * 17},
                    empty=True)
    jds, pds = _both("cs", str(root2), split="train", overfit=True)
    assert len(pds) == 16 and pds.files == jds.files


def _configs(tmp_path, monkeypatch, src, scale, edits=()):
    """Both packages' config of ``configs/<src>`` with the database's scales
    set to ``scale``, made in ``tmp_path``."""
    from mtt_tpu.config import config as jconfig
    from mtt_tpu_torch.config import config as pconfig
    with open(os.path.join(os.path.dirname(__file__), "..", "configs",
                           *src)) as f:
        text = f.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    yml = tmp_path / "exp.yml"
    yml.write_text(text)
    monkeypatch.chdir(tmp_path)
    db = {"pascal": "PASCALContext", "nyud": "NYUD",
          "cityscapes3d": "Cityscapes3D"}[src[0]]
    monkeypatch.setitem(jconfig.DB_SCALES, db, (scale, scale))
    monkeypatch.setitem(pconfig.DB_SCALES, db, (scale, scale))
    return (jconfig.create_config(str(yml), run_mode="infer"),
            pconfig.create_config(str(yml), run_mode="infer"), str(yml))


@pytest.mark.parametrize("db", ["pascal", "nyud", "cityscapes3d"])
def test_get_dataset_with_a_root_matches_jax(tmp_path, monkeypatch, db):
    """``get_dataset`` of both factories under ``MTT_DATA_ROOT`` builds the
    database's reader (not the synthetic stand-in) for both splits; the
    val samples through each package's val transforms equal to the bit;
    the first two training batches of both loaders (training transforms,
    seeded) equal at the loader tolerance."""
    from mtt_tpu.utils import common_config as jcc
    from mtt_tpu_torch.utils import common_config as pcc
    data = tmp_path / "data"
    if db == "pascal":
        pascal_tree(str(data), n_train=4, n_val=3)
        src, scale = ("pascal", "taskprompter_vitLp16.yml"), (56, 56)
        kind = "PASCALContext"
    elif db == "nyud":
        nyud_tree(str(data), n_val=4)
        src, scale = ("nyud", "taskprompter_vitLp16.yml"), (32, 40)
        kind = "NYUD_MT"
    else:
        cityscapes_tree(str(data), CS_FRAMES)
        src, scale = ("cityscapes3d", "taskprompter_swinB.yml"), (32, 64)
        kind = "Cityscapes3D"
    jp, pp, _ = _configs(tmp_path, monkeypatch, src, scale)
    if db == "cityscapes3d":
        jp["dd_label_map_size"] = pp["dd_label_map_size"] = [16, 32]
    monkeypatch.setenv("MTT_DATA_ROOT", str(data))
    jtr, jva = jcc.get_transformations(jp)
    ptr, pva = pcc.get_transformations(pp)
    jval, pval = jcc.get_dataset(jp, "val", jva), pcc.get_dataset(pp, "val",
                                                                  pva)
    assert type(pval).__name__ == type(jval).__name__ == kind
    assert len(pval) == len(jval) > 0
    for i in range(len(jval)):
        _equal(pval[i], jval[i], ("val", i))
    jtrain = jcc.get_dataset(jp, "train", jtr)
    ptrain = pcc.get_dataset(pp, "train", ptr)
    assert len(ptrain) == len(jtrain) >= 2
    jl, pl = jcc.get_train_dataloader(jp, jtrain), \
        pcc.get_train_dataloader(pp, ptrain)
    flips = total = 0
    for n, (g, w) in enumerate(zip(pl, jl)):
        assert g.keys() == w.keys()
        for k in w:
            if k == "meta":
                assert [m["img_name"] for m in g[k]] == \
                    [m["img_name"] for m in w[k]]
            elif k != "image":
                assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
        d = np.abs(np.asarray(g["image"]) - np.asarray(w["image"]))
        assert d.max() <= 1.0 / 255.0 / 0.224 + 1e-5
        flips += int((d > 0).sum())
        total += d.size
        if n == 1:
            break
    assert n == 1 and flips <= 1e-3 * total


def test_main_on_a_pascal_tree(tmp_path, monkeypatch):
    """``main`` on the CPU with ``MTT_DATA_ROOT`` at a tiny PASCAL tree
    (TaskPrompter-ViT-T, 64x64): one iteration and an eval, the training
    images scaled, cropped and padded, the val images padded; every val
    image's edge prediction written at that image's own size (``pad_image``
    undone by ``crop_padding``), finite scores of every task."""
    from mtt_tpu_torch.main import main
    data = tmp_path / "data"
    ids = pascal_tree(str(data), n_train=4, n_val=4)
    _, _, yml = _configs(
        tmp_path, monkeypatch, ("pascal", "taskprompter_vitLp16.yml"),
        (64, 64), (("backbone: TaskPrompter_vitL",
                    "backbone: TaskPrompter_vitT"),
                   ("embed_dim: 300", "embed_dim: 24"),
                   ("final_embed_dim: 350", "final_embed_dim: 28")))
    monkeypatch.setenv("MTT_DATA_ROOT", str(data))
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    assert main(["--config_exp", yml, "--max_iter", "1", "--val_interval",
                 "1", "--dtype", "float32"], device="cpu") == 0
    logger = sys.stdout                  # main's tee to log_file.txt
    sys.stdout = logger.console
    logger.close()
    out = tmp_path / "work_dirs" / "TaskPrompter_pascal_vitLp16"
    results = json.loads((out / "results" / "results_iter1.json")
                         .read_text())
    assert set(results) == {"semseg", "human_parts", "sal", "normals",
                            "edge"}
    assert all(np.isfinite(v) for s in results.values()
               for v in (s.values() if isinstance(s, dict) else [s]))
    from mtt_tpu_torch.data.image_io import read_png
    edge_dir = out / "results" / "edge"
    assert sorted(os.listdir(edge_dir)) == sorted(i + ".png"
                                                  for i in ids["val"])
    for k, name in enumerate(ids["val"]):
        assert read_png(edge_dir / (name + ".png")).shape == \
            PASCAL_SIZES[k % len(PASCAL_SIZES)], name
