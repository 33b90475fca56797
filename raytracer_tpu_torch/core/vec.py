"""The vec3 helpers the camera needs, over ``(..., 3)`` float32 tensors
(counterpart of ``raytracer_tpu/core/vec.py``)."""

from __future__ import annotations

import math

import torch


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| with |v|² summed as (x·x + y·y) + z·z."""
    sq = v * v
    return v / torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def degrees_to_radians(deg):
    return deg * (math.pi / 180.0)
