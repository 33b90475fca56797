"""Material codes and the host-side material record (counterpart of
``raytracer_tpu/scene/materials.py``): DIFFUSE=0, METAL=1, GLASS=2; any
other code absorbs."""

from __future__ import annotations

import dataclasses
from typing import Tuple

DIFFUSE = 0
METAL = 1
GLASS = 2

MATERIAL_NAMES = {DIFFUSE: "diffuse", METAL: "metal", GLASS: "glass"}


@dataclasses.dataclass(frozen=True)
class Material:
    """Used only while building scenes; a :class:`Scene` stores SoA
    tensors."""

    material_type: int
    albedo: Tuple[float, float, float]
    fuzz: float = 0.0
    refraction_index: float = 0.0

    @staticmethod
    def diffuse(albedo) -> "Material":
        return Material(DIFFUSE, albedo)

    @staticmethod
    def metal(albedo, fuzz: float = 0.0) -> "Material":
        return Material(METAL, albedo, fuzz=fuzz)

    @staticmethod
    def glass(refraction_index: float = 1.5,
              albedo=(1.0, 1.0, 1.0)) -> "Material":
        return Material(GLASS, albedo, refraction_index=refraction_index)
