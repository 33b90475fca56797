"""Camera layer (counterpart of ``raytracer_tpu/camera/``): the camera's
config, its derived basis, ray generation and the fly-cam controller."""

from raytracer_tpu_torch.camera import controller
from raytracer_tpu_torch.camera.camera import (
    CameraConfig,
    DerivedCamera,
    center_ray,
    derive_camera,
    generate_rays,
)

__all__ = [
    "CameraConfig",
    "DerivedCamera",
    "derive_camera",
    "generate_rays",
    "center_ray",
    "controller",
]
