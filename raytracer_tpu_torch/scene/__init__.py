"""Scene layer (counterpart of ``raytracer_tpu/scene/``): struct-of-arrays
sphere scenes, materials and the preset builders."""

from raytracer_tpu_torch.scene.materials import DIFFUSE, GLASS, METAL, Material
from raytracer_tpu_torch.scene.spheres import Scene, make_scene

__all__ = ["DIFFUSE", "METAL", "GLASS", "Material", "Scene", "make_scene"]
