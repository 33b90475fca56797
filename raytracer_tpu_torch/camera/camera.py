"""Camera primitives and the derived viewport basis (counterpart of
``raytracer_tpu/camera/camera.py``), in float32.

``CameraConfig`` holds what the user controls (origin, yaw and pitch in
degrees, fov in radians, aperture, focus distance, aspect ratio);
:func:`derive_camera` turns it into the basis the kernel reads.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracer_tpu_torch.core import vec


def _f32(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32))


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    origin: torch.Tensor  # (3,)
    yaw: torch.Tensor  # degrees; -90 looks down -z
    pitch: torch.Tensor  # degrees
    fov: torch.Tensor  # radians
    aperture: torch.Tensor
    focus_distance: torch.Tensor
    aspect_ratio: torch.Tensor  # width / height
    vup: torch.Tensor = dataclasses.field(
        default_factory=lambda: _f32((0.0, 1.0, 0.0))
    )

    @classmethod
    def create(cls, origin=(0.0, 0.0, 0.0), yaw=-90.0, pitch=0.0,
               fov=math.pi / 3.0, aperture=0.0, focus_distance=1.0,
               aspect_ratio=16.0 / 9.0, vup=(0.0, 1.0, 0.0)):
        """Build from Python scalars and tuples, rounded to float32."""
        return cls(origin=_f32(origin), yaw=_f32(yaw), pitch=_f32(pitch),
                   fov=_f32(fov), aperture=_f32(aperture),
                   focus_distance=_f32(focus_distance),
                   aspect_ratio=_f32(aspect_ratio), vup=_f32(vup))


@dataclasses.dataclass(frozen=True)
class DerivedCamera:
    """The viewport basis the kernel consumes."""

    origin: torch.Tensor  # (3,)
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor  # (3,)
    vertical: torch.Tensor  # (3,)
    u: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    w: torch.Tensor  # (3,)
    lens_radius: torch.Tensor  # ()
    front: torch.Tensor  # (3,)


def camera_front(yaw, pitch) -> torch.Tensor:
    """front = (cos(yaw)cos(pitch), sin(pitch), sin(yaw)cos(pitch))."""
    yaw_r = vec.degrees_to_radians(yaw)
    pitch_r = vec.degrees_to_radians(pitch)
    cp = torch.cos(pitch_r)
    return torch.stack(
        [torch.cos(yaw_r) * cp, torch.sin(pitch_r), torch.sin(yaw_r) * cp]
    )


def derive_camera(cfg: CameraConfig) -> DerivedCamera:
    """The viewport basis of a :class:`CameraConfig`, op for op as the JAX
    package derives it."""
    camera_h = torch.tan(cfg.fov / 2.0)
    front = camera_front(cfg.yaw, cfg.pitch)
    w = vec.normalize(-front)
    u = vec.normalize(vec.cross(cfg.vup, w))
    v = vec.cross(w, u)
    viewport_height = 2.0 * camera_h
    viewport_width = viewport_height * cfg.aspect_ratio
    horizontal = cfg.focus_distance * viewport_width * u
    vertical = cfg.focus_distance * viewport_height * v
    lower_left = (cfg.origin - horizontal / 2.0 - vertical / 2.0
                  - cfg.focus_distance * w)
    return DerivedCamera(
        origin=cfg.origin, lower_left_corner=lower_left,
        horizontal=horizontal, vertical=vertical, u=u, v=v, w=w,
        lens_radius=cfg.aperture / 2.0, front=front,
    )


def camera_from_numpy(fields: dict):
    """A :class:`CameraConfig` or :class:`DerivedCamera` from a mapping of
    field name to array (the JAX dataclass's fields). The field names
    decide which one: a mapping with ``lower_left_corner`` is a derived
    basis, carried across as it is."""
    cls = DerivedCamera if "lower_left_corner" in fields else CameraConfig
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**{k: _f32(v) for k, v in fields.items()})
