"""Batch inference: normalisation, forward and per-task post-processing
(the forward half of the JAX package's inference.py, with the decode of the
3D detections)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
