"""raytracer_tpu_torch: the PyTorch + CUDA port of ``raytracer_tpu``.

The cover render (kd cluster partition, gathered cluster walk, pixels
sorted by profiled cost, exact segment totals), at fixed spp or with
adaptive per-pixel stopping, with the random or the stratified sampler,
runs on an NVIDIA Hopper card through a hand-written CUDA kernel
(``csrc/cluster_walk.cu``, four instantiations). The package imports
torch and numpy only.

Public entry: :func:`raytracer_tpu_torch.render.api.render_image`.
"""

from raytracer_tpu_torch.camera.camera import (
    CameraConfig,
    DerivedCamera,
    camera_from_numpy,
    derive_camera,
)
from raytracer_tpu_torch.render.api import render_image
from raytracer_tpu_torch.render.megakernel import adaptive_state_from_numpy
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene.spheres import Scene, make_scene, scene_from_numpy

__all__ = [
    "CameraConfig",
    "DerivedCamera",
    "Scene",
    "TraceOptions",
    "adaptive_state_from_numpy",
    "camera_from_numpy",
    "derive_camera",
    "make_scene",
    "render_image",
    "scene_from_numpy",
]
