"""The vec3 helpers the camera, picking and the AOVs need, over
``(..., 3)`` float32 tensors (counterpart of ``raytracer_tpu/core/vec.py``).
Sums over the last axis run (x + y) + z."""

from __future__ import annotations

import math

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v|."""
    return v / length(v)[..., None]


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
