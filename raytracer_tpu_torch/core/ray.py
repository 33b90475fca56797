"""Rays over ``(..., 3)`` tensors (counterpart of
``raytracer_tpu/core/ray.py``): one :class:`Ray` holds a whole wavefront,
for example every pixel's camera ray."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Ray(NamedTuple):
    origin: torch.Tensor  # (..., 3)
    direction: torch.Tensor  # (..., 3), not normalised

    def at(self, t) -> torch.Tensor:
        """The point ``origin + t·direction``; ``t`` has the rays' leading
        shape and is taken in the direction's dtype and device."""
        t = torch.as_tensor(t, dtype=self.direction.dtype,
                            device=self.direction.device)
        return self.origin + t[..., None] * self.direction
