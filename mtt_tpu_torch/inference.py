"""Inference: normalisation, forward and per-task post-processing of a
batch (``predict``, with the decode of the 3D detections), and the
single-image CLI of the repository's inference.py:

    python -m mtt_tpu_torch.inference --config_exp CONFIG.yml \
        --image_path img.jpg [more.png ...] [--ckpt_dir DIR] --output_dir out/

Each image is read as ``cv2.imread`` reads it (``data/image_io.py``'s
``cv2_color`` mode: RGB, the EXIF orientation of a JPEG's Exif block or a
PNG's eXIf chunk applied, a TIFF's Orientation tag 1-4 applied): JPEG
(baseline or progressive, 1, 3 or 4 components, sampling factors 1-4),
PNG (any depth and colour type, Adam7 too), BMP (1-, 4-, 8-, 24- and
32-bit), PNM (P1-P6) and TIFF (strips or tiles, uncompressed, LZW, Deflate
or PackBits; grey, RGB(A) or palette at 1-16 bits). WebP, GIF, JPEG 2000,
AVIF, HDR, PFM, Sun raster, RLE BMP, JPEG-in-TIFF and the other forms
``data/image_io.py`` names raise ``NotImplementedError`` (ROADMAP.md item
1.13). The image is resized to the config's ``TEST.SCALE`` (cv2's uint8
cubic, ``data/transforms.py: resize_cubic_u8``) and normalised; the model
(seeded random weights, or the checkpoint ``latest.txt`` names in
``--ckpt_dir``, read by ``Trainer.restore_checkpoint``), built once, runs
on the card unless the caller of ``main`` passes another device, at
float32 by default as JAX's CLI runs (``--dtype bfloat16``; on the card
InvPT and Swin take bfloat16 until ROADMAP.md item 1.14, and a float32 run
turns TF32 off for the call); each
task's map is written as ``<task>.png`` (``visualize``), and for
Cityscapes-3D the boxes above score 0.3 as wireframes on the original
image (``3ddet.png``), decoded with the Stuttgart camera and the resize's
``scale_xy``. With several images, each one's maps go to
``<output_dir>/<its file name without the extension>/``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mtt_tpu_torch.utils.postprocess import get_output

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """RGB batch (B, H, W, 3) with values in [0, 255] -> ImageNet-normalised
    float32 batch."""
    x = images.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def decode_3ddet(head_out, cam_K, det_cfg: dict, scale_factor=1.0
                 ) -> Dict[str, torch.Tensor]:
    """The detection head's per-level output lists (batched, NHWC) -> the
    decoded detections of every image, stacked: boxes3d (B, n, 9), bboxes2d
    (B, n, 4), scores, labels, valid (B, n), centers2d (B, n, 3), n =
    ``max_per_img``. ``cam_K`` is one camera matrix for every image, (3, 3)
    or (3, 4), or one per image, (B, 3, 3|4): image i decodes with its own,
    as the JAX evaluation decodes each image with its ``K_matrix``.
    ``scale_factor`` maps the input's pixels back to the camera's (a resized
    image), one number or (x, y)."""
    from mtt_tpu_torch.detection.det_model import decode_bboxes_single
    cls, bbox, dirp, ctr = head_out
    B = cls[0].shape[0]
    cam_K = torch.as_tensor(cam_K, dtype=torch.float32)
    if cam_K.dim() == 2:
        cam_K = cam_K.expand(B, *cam_K.shape)
    if cam_K.dim() != 3 or cam_K.shape[0] != B or cam_K.shape[1] != 3 \
            or cam_K.shape[2] not in (3, 4):
        raise ValueError(f"cam_K must be (3, 3|4) or ({B}, 3, 3|4), got "
                         f"{tuple(cam_K.shape)}")
    per_image = [decode_bboxes_single(
        ([c[i] for c in cls], [b[i] for b in bbox], [d[i] for d in dirp],
         [c[i] for c in ctr]), cam_K[i], det_cfg, tuple(det_cfg["strides"]),
        scale_factor) for i in range(B)]
    return {k: torch.stack([d[k] for d in per_image]) for k in per_image[0]}


@torch.no_grad()
def predict(model, images: torch.Tensor, impl: Optional[str] = None,
            cam_K=None, scale_factor=1.0
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Normalised images (B, H, W, 3) -> (logits, predictions). ``logits``
    is the model's output: a dict keyed by task, with InvPT's intermediate
    predictions under ``inter_preds`` and, for ``3ddet``, the detection
    head's per-level lists; ``predictions`` holds the post-processed map of
    each task and, for ``3ddet``, the decoded detections, which need the
    camera matrix ``cam_K`` (one, or one per image) and take the
    ``scale_factor`` of ``decode_3ddet``."""
    logits = model(images, impl=impl)
    preds = {}
    for t, v in logits.items():
        if t == "inter_preds":
            continue
        if t == "3ddet":
            if cam_K is None:
                raise ValueError("decoding the 3D detections needs the "
                                 "camera matrix: pass cam_K")
            preds[t] = decode_3ddet(v, cam_K, model.det_cfg, scale_factor)
        else:
            preds[t] = get_output(v, t)
    return logits, preds


def visualize(task: str, pred: np.ndarray) -> np.ndarray:
    """A post-processed map -> RGB uint8, as the repository's inference.py
    draws it (depth in grey from its min to its max)."""
    from mtt_tpu_torch.utils.visualization import voc_colormap
    if task in ("semseg", "human_parts"):
        return voc_colormap()[pred.astype(np.int32) % 256]
    if task in ("edge", "sal"):
        return np.repeat(pred.astype(np.uint8)[..., None], 3, -1)
    if task == "normals":
        return pred.astype(np.uint8)
    if task == "depth":
        d = pred.astype(np.float32)
        d = (255 * (d - d.min()) / max(d.max() - d.min(), 1e-6)).astype(
            np.uint8)
        return np.repeat(d[..., None], 3, -1)
    raise ValueError(task)


# Stuttgart camera calibration of the reference's single-image 3D detection
# demo (public calibration constants), used when no camera accompanies the
# image
STUTTGART_CAMERA = {
    "fx": 2262.52, "fy": 2265.3017905988554,
    "u0": 1096.98, "v0": 513.137,
    "sensor_T_ISO_8855": [
        [0.9990881051503779, -0.01948468779721943,
         -0.03799085532693703, -1.6501524664770573],
        [0.019498764210995674, 0.9998098810245096, 0.0,
         -0.1331288872611436],
        [0.03798363254444427, -0.0007407747301939942,
         0.9992780868764849, -1.2836173638418473]],
}


def stuttgart_K() -> np.ndarray:
    cam = STUTTGART_CAMERA
    return np.array([[cam["fx"], 0, cam["u0"]], [0, cam["fy"], cam["v0"]],
                     [0, 0, 1]], np.float32)


def infer_3ddet(dec: Dict[str, torch.Tensor], ori_img: np.ndarray,
                output_dir: str) -> int:
    """Wireframes of the decoded boxes (one image's ``decode_3ddet`` dict)
    that are valid and score above 0.3 on the original image, written as
    ``3ddet.png``; returns how many."""
    from mtt_tpu_torch.evaluation.save_preds import write_png
    from mtt_tpu_torch.utils.visualization import draw_boxes3d
    dec = {k: v[0].cpu().numpy() for k, v in dec.items()}
    keep = dec["valid"] & (dec["scores"] > 0.3)
    path = os.path.join(output_dir, "3ddet.png")
    write_png(path, draw_boxes3d(ori_img, dec["boxes3d"], stuttgart_K(),
                                 valid=keep))
    n = int(keep.sum())
    print(f"[inference] wrote {path} ({n} boxes above score 0.3)")
    return n


def load_image(path: str, size: Tuple[int, int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(the image as RGB uint8, it resized to ``size`` = (H, W)), as the
    repository's inference.py reads it with ``cv2.imread``: grey repeated to
    three channels, alpha dropped, the orientation of a JPEG's or PNG's
    EXIF block or a TIFF's tag applied."""
    from mtt_tpu_torch.data.image_io import read_image
    from mtt_tpu_torch.data.transforms import resize_cubic_u8
    img = read_image(path, "cv2_color")
    return img, resize_cubic_u8(img, (size[1], size[0]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="single-image inference")
    ap.add_argument("--config_exp", required=True)
    ap.add_argument("--image_path", required=True, nargs="+",
                    help="one image, or several: each one's maps go to a "
                         "folder of its name under --output_dir")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--output_dir", default="inference_out")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="compute dtype: float32, as JAX's inference.py "
                         "runs every model (on the card: the TaskPrompter-"
                         "ViT configs; InvPT and Swin take bfloat16 until "
                         "ROADMAP.md item 1.14)")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> int:
    args = parse_args(argv)
    from mtt_tpu_torch.utils.precision import exact_f32
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    with exact_f32(dtype == torch.float32):
        return _main(args, dtype, device)


def _main(args, dtype, device) -> int:
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.evaluation.save_preds import write_png
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import build_model, default_device
    from mtt_tpu_torch.utils.precision import check_card_dtype
    from mtt_tpu_torch.utils.train_utils import Trainer

    device = default_device(device)
    p = create_config(args.config_exp, {"run_mode": "infer"})
    if device.type == "cuda":
        check_card_dtype(p, "infer", dtype)
    size = tuple(p.TEST.SCALE)
    paths = args.image_path
    stems = [os.path.splitext(os.path.basename(x))[0] for x in paths]
    if len(paths) > 1 and len(set(stems)) < len(stems):
        raise ValueError(f"--image_path: two images of one name {stems}: "
                         f"their maps would share a folder")
    images = [load_image(x, size) for x in paths]   # before the model

    gen = torch.Generator(device=device).manual_seed(0)
    model = build_model(p, img_size=size, device=device, dtype=torch.float32)
    init_weights(model, gen)
    trainer = Trainer(model, p, p.TASKS.NAMES, dtype, gen)
    if args.ckpt_dir:
        step = trainer.restore_checkpoint(args.ckpt_dir)
        if step is not None:
            print(f"[inference] loaded checkpoint step {step}")
        else:
            print(f"[inference] WARNING: no checkpoint found under "
                  f"{args.ckpt_dir} — running with RANDOM weights")
    else:
        print("[inference] WARNING: --ckpt_dir not given — RANDOM weights")

    cam_K = stuttgart_K() if "3ddet" in model.tasks else None
    for (ori_img, img), stem in zip(images, stems):
        out_dir = args.output_dir if len(paths) == 1 else os.path.join(
            args.output_dir, stem)
        x = preprocess(torch.from_numpy(img[None]).to(device)).to(dtype)
        scale_xy = np.array([img.shape[1] / ori_img.shape[1],
                             img.shape[0] / ori_img.shape[0]], np.float32)
        _, preds = predict(model, x, cam_K=cam_K, scale_factor=scale_xy)
        os.makedirs(out_dir, exist_ok=True)
        for t in p.TASKS.NAMES:
            if t == "3ddet":
                infer_3ddet(preds[t], ori_img, out_dir)
                continue
            out = os.path.join(out_dir, f"{t}.png")
            write_png(out, visualize(t, preds[t][0].float().cpu().numpy()))
            print(f"[inference] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
