"""The port's single-image inference CLI (``python -m
mtt_tpu_torch.inference``) on the CPU, against the repository's
inference.py: a ViT-T TaskPrompter PASCAL experiment at 128x128 and a tiny
TaskPrompter-Swin Cityscapes-3D one, each from a checkpoint of a seeded
trainer, on a PNG of another size.

Each task's PNG equals, pixel for pixel, the root ``inference.visualize``
of the port's ``predict`` on the CLI's resized input; ``3ddet.png`` equals
the wireframes of the same decode (Stuttgart camera, the resize's
``scale_xy``). The uint8 cubic resize sits within one level of cv2's.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from torch_threads import torch_threads  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _yaml(tmp_path, src, edits):
    with open(os.path.join(REPO, "configs", *src)) as f:
        text = f.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / "exp.yml"
    path.write_text(text)
    return str(path)


def _photo(h, w, seed):
    """A smooth seeded RGB image with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(xx / (9.0 + 3 * c)) *
                    np.cos(yy / (7.0 + 2 * c)) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
        np.uint8)


def _checkpoint(p, size, ck_dir, seed, det_prior=False):
    """A seeded f32 trainer of the config's model, saved to ``ck_dir``."""
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model
    from mtt_tpu_torch.utils.train_utils import Trainer
    gen = torch.Generator().manual_seed(seed)
    model = build_model(p, img_size=size, device="cpu", dtype=torch.float32)
    init_weights(model, gen)
    if det_prior:               # the class prior at 0.5: boxes survive
        with torch.no_grad():
            model.det_head.fcos3d.conv_cls.bias.fill_(0.0)
    trainer = Trainer(model, p, p.TASKS.NAMES, torch.float32, gen,
                      log_fn=lambda s: None)
    trainer.save_checkpoint(str(ck_dir))
    return model


def _run_cli(tmp_path, yml, size, ori, seed, det_prior=False,
             dtype_args=("--dtype", "float32")):
    """Writes ``ori`` as a PNG, saves a checkpoint, runs the CLI (with
    ``dtype_args``); returns (the output directory, the checkpoint's model,
    the CLI's resized input)."""
    from mtt_tpu_torch import inference
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.data.transforms import resize_cubic_u8
    from mtt_tpu_torch.evaluation.save_preds import write_png
    p = create_config(yml, {"run_mode": "infer"})
    model = _checkpoint(p, size, tmp_path / "ck", seed, det_prior)
    png, out = tmp_path / "in.png", tmp_path / "out"
    write_png(str(png), ori)
    assert inference.main(["--config_exp", yml, "--image_path", str(png),
                           "--ckpt_dir", str(tmp_path / "ck"),
                           "--output_dir", str(out), *dtype_args],
                          device="cpu") == 0
    return out, model, resize_cubic_u8(ori, (size[1], size[0]))


def test_cli_vit_t_pascal_matches_root_visualize(tmp_path, monkeypatch,
                                                 capsys):
    """ViT-T TaskPrompter PASCAL at 128x128 from a 96x112 PNG: five PNGs,
    each the root ``visualize`` of ``predict`` on the resized input."""
    import inference as root
    from mtt_tpu_torch.config.config import DB_SCALES
    from mtt_tpu_torch.evaluation.save_preds import read_png
    from mtt_tpu_torch.inference import predict, preprocess
    monkeypatch.setitem(DB_SCALES, "PASCALContext", ((128, 128), (128, 128)))
    yml = _yaml(tmp_path, ("pascal", "taskprompter_vitLp16.yml"),
                (("backbone: TaskPrompter_vitL", "backbone: TaskPrompter_vitT"),
                 ("embed_dim: 300", "embed_dim: 24"),
                 ("final_embed_dim: 350", "final_embed_dim: 28")))
    ori = _photo(96, 112, 0)
    out, model, img = _run_cli(tmp_path, yml, (128, 128), ori, seed=5)
    assert "loaded checkpoint step 0" in capsys.readouterr().out
    _, preds = predict(model, preprocess(torch.from_numpy(img[None])))
    tasks = ("semseg", "human_parts", "sal", "normals", "edge")
    assert sorted(os.listdir(out)) == sorted(f"{t}.png" for t in tasks)
    for t in tasks:
        want = root.visualize(t, preds[t][0].numpy())
        assert np.array_equal(read_png(str(out / f"{t}.png")), want), t


def test_cli_default_dtype_is_float32_as_root_inference(tmp_path,
                                                       monkeypatch):
    """Without ``--dtype`` the CLI runs at float32, the dtype of every
    forward of the root inference.py (JAX's ``build_model`` default): the
    ViT-T TaskPrompter PASCAL experiment's forward gets an f32 input from an
    f32 model, and its five PNGs are the root ``visualize`` of the f32
    ``predict`` on the resized input. ``--dtype bfloat16`` stays."""
    import inference as root
    from mtt_tpu_torch import inference
    from mtt_tpu_torch.config.config import DB_SCALES
    from mtt_tpu_torch.evaluation.save_preds import read_png
    assert inference.parse_args(["--config_exp", "x.yml", "--image_path",
                                 "a.png"]).dtype == "float32"
    assert inference.parse_args(["--config_exp", "x.yml", "--image_path",
                                 "a.png", "--dtype",
                                 "bfloat16"]).dtype == "bfloat16"
    monkeypatch.setitem(DB_SCALES, "PASCALContext", ((64, 64), (64, 64)))
    yml = _yaml(tmp_path, ("pascal", "taskprompter_vitLp16.yml"),
                (("backbone: TaskPrompter_vitL", "backbone: TaskPrompter_vitT"),
                 ("embed_dim: 300", "embed_dim: 24"),
                 ("final_embed_dim: 350", "final_embed_dim: 28")))
    seen = {}
    real = inference.predict

    def spy(model, images, **kw):
        seen.update(x=images.dtype, w=next(model.parameters()).dtype)
        return real(model, images, **kw)
    monkeypatch.setattr(inference, "predict", spy)
    out, model, img = _run_cli(tmp_path, yml, (64, 64), _photo(50, 60, 7),
                               seed=8, dtype_args=())
    assert seen == {"x": torch.float32, "w": torch.float32}
    _, preds = real(model, inference.preprocess(torch.from_numpy(img[None])))
    for t in ("semseg", "human_parts", "sal", "normals", "edge"):
        want = root.visualize(t, preds[t][0].numpy())
        assert np.array_equal(read_png(str(out / f"{t}.png")), want), t


def test_cli_tiny_swin_cs3d_matches_root_visualize(tmp_path, monkeypatch):
    """A tiny TaskPrompter-Swin Cityscapes-3D experiment at 128x256 from a
    100x200 PNG: semseg and depth as the root ``visualize`` of ``predict``,
    and ``3ddet.png`` the wireframes of the decode with the Stuttgart camera
    and ``scale_xy`` (boxes drawn: the checkpoint's class prior is 0.5)."""
    import inference as root
    from mtt_tpu_torch.config.config import DB_SCALES
    from mtt_tpu_torch.evaluation.save_preds import read_png
    from mtt_tpu_torch.inference import STUTTGART_CAMERA, predict, \
        preprocess, stuttgart_K
    from mtt_tpu_torch.models import wrappers
    from mtt_tpu_torch.utils.visualization import draw_boxes3d
    assert STUTTGART_CAMERA == root.STUTTGART_CAMERA
    monkeypatch.setitem(DB_SCALES, "Cityscapes3D", ((128, 256), (128, 256)))
    monkeypatch.setitem(wrappers.TASKPROMPTER_SWIN_SPECS, "TaskPrompter_swinT",
                        dict(embed_dim=16, depths=(2, 2, 4, 2),
                             num_heads=(2, 2, 2, 2), window_size=4))
    yml = _yaml(tmp_path, ("cityscapes3d", "taskprompter_swinB.yml"),
                (("backbone: TaskPrompter_swinB",
                  "backbone: TaskPrompter_swinT"),
                 ("level_embed_dim: 256", "level_embed_dim: 12"),
                 ("final_embed_dim: 450", "final_embed_dim: 20"),
                 ("chan_embed_dim: 256", "chan_embed_dim: 16"),
                 ("dd_label_map_size: [512, 1024]",
                  "dd_label_map_size: [64, 128]")))
    ori = _photo(100, 200, 1)
    out, model, img = _run_cli(tmp_path, yml, (128, 256), ori, seed=6,
                               det_prior=True)
    assert sorted(os.listdir(out)) == ["3ddet.png", "depth.png",
                                       "semseg.png"]
    scale = np.array([256 / 200, 128 / 100], np.float32)
    _, preds = predict(model, preprocess(torch.from_numpy(img[None])),
                       cam_K=stuttgart_K(), scale_factor=scale)
    for t in ("semseg", "depth"):
        want = root.visualize(t, preds[t][0].numpy())
        assert np.array_equal(read_png(str(out / f"{t}.png")), want), t
    dec = {k: v[0].numpy() for k, v in preds["3ddet"].items()}
    keep = dec["valid"] & (dec["scores"] > 0.3)
    want = draw_boxes3d(ori, dec["boxes3d"], stuttgart_K(), valid=keep)
    got = read_png(str(out / "3ddet.png"))
    assert keep.sum() > 0 and np.array_equal(got, want)
    assert not np.array_equal(got, ori)


def test_resize_cubic_u8_within_a_level_of_cv2():
    """``resize_cubic_u8`` against cv2's INTER_CUBIC on uint8 (the CLI's
    resize of PASCAL's 375x500 to 512x512, and down): at most one level
    apart, and equal on all but a few pixels in a million."""
    from mtt_tpu_torch.data.transforms import resize_cubic_u8
    for (h, w), size in (((375, 500), (512, 512)), ((120, 90), (64, 48))):
        for img in (_photo(h, w, 2), np.random.default_rng(3).integers(
                0, 256, (h, w, 3)).astype(np.uint8)):
            got = resize_cubic_u8(img, size).astype(np.int64)
            want = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
            assert got.shape == want.shape
            diff = np.abs(got - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 2e-5
    same = _photo(10, 12, 4)
    assert np.array_equal(resize_cubic_u8(same, (12, 10)), same)


def test_cli_refuses_what_is_not_a_png(tmp_path):
    """A format the port does not decode (WebP) raises and names ROADMAP
    item 1.13; a BMP and a JPEG load as ``cv2.imread`` reads them (RGB
    order), a grey PNG repeated to three channels."""
    from mtt_tpu_torch.inference import load_image
    webp = tmp_path / "x.webp"
    cv2.imwrite(str(webp), _photo(20, 30, 5))
    with pytest.raises(NotImplementedError, match="item 1.13"):
        load_image(str(webp), (32, 32))
    bmp = tmp_path / "x.bmp"
    cv2.imwrite(str(bmp), _photo(20, 30, 5))
    ori, _ = load_image(str(bmp), (32, 32))
    assert np.array_equal(ori, cv2.cvtColor(cv2.imread(str(bmp)),
                                            cv2.COLOR_BGR2RGB))
    path = tmp_path / "x.jpg"
    cv2.imwrite(str(path), _photo(20, 30, 5))
    ori, img = load_image(str(path), (32, 32))
    assert np.array_equal(ori, cv2.cvtColor(cv2.imread(str(path)),
                                            cv2.COLOR_BGR2RGB))
    assert img.shape == (32, 32, 3)
    grey = tmp_path / "g.png"
    cv2.imwrite(str(grey), _photo(20, 30, 5)[..., 0])
    ori, img = load_image(str(grey), (40, 60))
    assert ori.shape == (20, 30, 3) and img.shape == (40, 60, 3)
    assert np.array_equal(ori[..., 1], ori[..., 0])


def test_cli_several_images_one_model(tmp_path, monkeypatch):
    """``--image_path`` with a JPEG, a BMP and a TIFF: one model, each
    image's five maps in a folder of its name, each the root ``visualize``
    of ``predict`` on that image read as ``cv2.imread`` reads it."""
    import inference as root
    from mtt_tpu_torch import inference
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.config.config import DB_SCALES
    from mtt_tpu_torch.evaluation.save_preds import read_png
    monkeypatch.setitem(DB_SCALES, "PASCALContext", ((64, 64), (64, 64)))
    yml = _yaml(tmp_path, ("pascal", "taskprompter_vitLp16.yml"),
                (("backbone: TaskPrompter_vitL", "backbone: TaskPrompter_vitT"),
                 ("embed_dim: 300", "embed_dim: 24"),
                 ("final_embed_dim: 350", "final_embed_dim: 28")))
    p = create_config(yml, {"run_mode": "infer"})
    model = _checkpoint(p, (64, 64), tmp_path / "ck", 6, False)
    paths = []
    for i, ext in enumerate((".jpg", ".bmp", ".tif")):
        paths.append(str(tmp_path / f"in{i}{ext}"))
        cv2.imwrite(paths[-1], _photo(40 + 8 * i, 56, i))
    out = tmp_path / "out"
    assert inference.main(["--config_exp", yml, "--image_path", *paths,
                           "--ckpt_dir", str(tmp_path / "ck"),
                           "--output_dir", str(out), "--dtype", "float32"],
                          device="cpu") == 0
    assert sorted(os.listdir(out)) == ["in0", "in1", "in2"]
    tasks = ("semseg", "human_parts", "sal", "normals", "edge")
    for i, path in enumerate(paths):
        ori, img = inference.load_image(path, (64, 64))
        assert np.array_equal(ori, cv2.cvtColor(cv2.imread(path),
                                                cv2.COLOR_BGR2RGB))
        _, preds = inference.predict(model, inference.preprocess(
            torch.from_numpy(img[None])))
        for t in tasks:
            want = root.visualize(t, preds[t][0].numpy())
            assert np.array_equal(read_png(str(out / f"in{i}" / f"{t}.png")),
                                  want), (path, t)
