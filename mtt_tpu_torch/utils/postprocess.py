"""Task logits -> predictions (port of mtt_tpu/utils/postprocess.py
``get_output``). All inputs NHWC."""

from __future__ import annotations

import torch


def get_output(output: torch.Tensor, task: str) -> torch.Tensor:
    """logits (B, H, W, K) -> prediction, reference semantics:
    normals: L2-normalise -> [0, 255]; semseg/human_parts: argmax;
    edge: sigmoid * 255; sal: softmax[..., 1] * 255; depth: clamp >= 0."""
    if task == "normals":
        norm = torch.linalg.vector_norm(output, dim=-1, keepdim=True)
        out = output / norm.clamp_min(1e-12)
        return (out + 1.0) * 255.0 / 2.0
    if task in ("semseg", "human_parts"):
        return output.argmax(-1)
    if task == "edge":
        return 255.0 * torch.sigmoid(output[..., 0])
    if task == "sal":
        return torch.softmax(output, dim=-1)[..., 1] * 255.0
    if task == "depth":
        out = output.clamp_min(0.0)
        return out[..., 0] if output.shape[-1] == 1 else out
    raise ValueError(f"Unknown task {task}")
