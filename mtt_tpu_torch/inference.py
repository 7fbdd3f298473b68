"""Batch inference: normalisation, forward and per-task post-processing
(the forward half of the JAX package's inference.py)."""

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


@torch.no_grad()
def predict(model, images: torch.Tensor, impl: Optional[str] = None
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Normalised images (B, H, W, 3) -> (logits, predictions). ``logits``
    is the model's output: a dict keyed by task, with InvPT's intermediate
    predictions under ``inter_preds``; ``predictions`` holds the
    post-processed map of each task."""
    logits = model(images, impl=impl)
    return logits, {t: get_output(v, t) for t, v in logits.items()
                    if t != "inter_preds"}
