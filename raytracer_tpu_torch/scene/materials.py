"""Material codes and the host-side material record (counterpart of
``raytracer_tpu/scene/materials.py``): DIFFUSE=0, METAL=1, GLASS=2, and
the port's CHECKER=3, a Lambertian surface under *The Next Week*'s
checker texture: its albedo is the even colour, or the odd one where
sin(10x)·sin(10y)·sin(10z) < 0 at the hit point. Only the motion walk
reads the checker (``render/cluster_walk.py``); in any other kernel, as
any further code, it absorbs."""

from __future__ import annotations

import dataclasses
from typing import Tuple

DIFFUSE = 0
METAL = 1
GLASS = 2
CHECKER = 3

MATERIAL_NAMES = {DIFFUSE: "diffuse", METAL: "metal", GLASS: "glass"}


@dataclasses.dataclass(frozen=True)
class Material:
    """Used only while building scenes; a :class:`Scene` stores SoA
    tensors."""

    material_type: int
    albedo: Tuple[float, float, float]
    fuzz: float = 0.0
    refraction_index: float = 0.0
    #: a checker's odd colour (None: no checker); the port's own, so
    #: keyword-only
    albedo_odd: Tuple[float, float, float] | None = dataclasses.field(
        default=None, kw_only=True)

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

    @staticmethod
    def checker(even, odd) -> "Material":
        """Lambertian under the checker texture of colours ``even`` and
        ``odd``."""
        return Material(CHECKER, even, albedo_odd=odd)
