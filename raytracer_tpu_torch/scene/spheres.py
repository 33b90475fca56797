"""Struct-of-arrays sphere scene (counterpart of
``raytracer_tpu/scene/spheres.py``).

A negative radius flips the outward normal (hollow glass shells);
``active`` is 1.0 for live slots and 0.0 for padding, which is never hit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from raytracer_tpu_torch.scene.materials import Material

#: the selection id of "nothing selected" (the reference's
#: NO_SELECTED_OBJECT_ID)
NO_SELECTED_OBJECT_ID = 1000


@dataclasses.dataclass(frozen=True)
class Scene:
    center: torch.Tensor  # (N, 3) float32
    radius: torch.Tensor  # (N,) float32
    material_type: torch.Tensor  # (N,) int32
    albedo: torch.Tensor  # (N, 3) float32
    fuzz: torch.Tensor  # (N,) float32
    refraction_index: torch.Tensor  # (N,) float32
    active: torch.Tensor  # (N,) float32

    @property
    def count(self) -> int:
        """Slot count, padding included."""
        return self.center.shape[0]

    def to(self, device) -> "Scene":
        """The scene with every field on ``device``."""
        return Scene(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})

    def numpy(self) -> dict:
        """The fields as host numpy arrays."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}


def scene_from_numpy(center, radius, material_type, albedo, fuzz,
                     refraction_index, active, device="cpu") -> Scene:
    """Build a :class:`Scene` from the JAX ``Scene`` fields as arrays."""

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return Scene(
        center=t(center, torch.float32).reshape(-1, 3),
        radius=t(radius, torch.float32),
        material_type=t(material_type, torch.int32),
        albedo=t(albedo, torch.float32).reshape(-1, 3),
        fuzz=t(fuzz, torch.float32),
        refraction_index=t(refraction_index, torch.float32),
        active=t(active, torch.float32),
    )


def make_scene(
    spheres: Sequence[Tuple[Tuple[float, float, float], float, Material]],
) -> Scene:
    """Build a :class:`Scene` from (center, radius, material) triples."""
    if not spheres:
        raise ValueError("scene must contain at least one sphere")
    mats = [s[2] for s in spheres]
    return scene_from_numpy(
        center=np.array([s[0] for s in spheres], np.float32),
        radius=np.array([s[1] for s in spheres], np.float32),
        material_type=np.array([m.material_type for m in mats], np.int32),
        albedo=np.array([m.albedo for m in mats], np.float32),
        fuzz=np.array([m.fuzz for m in mats], np.float32),
        refraction_index=np.array([m.refraction_index for m in mats],
                                  np.float32),
        active=np.ones(len(spheres), np.float32),
    )
