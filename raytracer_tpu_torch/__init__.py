"""raytracer_tpu_torch: the PyTorch + CUDA port of ``raytracer_tpu``.

The cover render's main path (kd cluster partition, gathered cluster walk,
profile-guided pixel sorting, exact segment totals) runs on an NVIDIA
Hopper card through a hand-written CUDA kernel
(``csrc/cluster_walk.cu``). The package imports torch and numpy only.

Public entry: :func:`raytracer_tpu_torch.render.api.render_image`.
"""

from raytracer_tpu_torch.camera.camera import (
    CameraConfig,
    DerivedCamera,
    camera_from_numpy,
    derive_camera,
)
from raytracer_tpu_torch.render.api import render_image
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene.spheres import Scene, make_scene, scene_from_numpy

__all__ = [
    "CameraConfig",
    "DerivedCamera",
    "Scene",
    "TraceOptions",
    "camera_from_numpy",
    "derive_camera",
    "make_scene",
    "render_image",
    "scene_from_numpy",
]
