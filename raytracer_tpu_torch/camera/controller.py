"""Interactive camera controls: fly-cam, mouse-look and zoom, with the
reference's clamps and speed scaling (counterpart of
``raytracer_tpu/camera/controller.py``), as functions ``CameraConfig ->
CameraConfig`` on the camera's float32 tensors. A Python number meets a
float32 tensor as JAX's weakly typed scalars do: rounded to float32
first."""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.camera.camera import (
    FOV_MAX,
    FOV_MIN,
    PITCH_LIMIT_DEG,
    CameraConfig,
    camera_front,
)
from raytracer_tpu_torch.core import vec

MOVEMENT_SPEED = 0.001
LOOK_SENSITIVITY = 0.1
WHEEL_ZOOM_STEP = 0.03


@dataclasses.dataclass
class KeydownMap:
    """Which movement keys are held (host state)."""

    w: bool = False
    a: bool = False
    s: bool = False
    d: bool = False
    space: bool = False
    shift: bool = False

    def all_false(self) -> bool:
        return not (self.w or self.a or self.s or self.d or self.space
                    or self.shift)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def set_fov(cfg: CameraConfig, new_fov_radians) -> CameraConfig:
    """fov clamped to [0.0001, 0.75π]."""
    return dataclasses.replace(
        cfg, fov=torch.clamp(_f32(new_fov_radians), FOV_MIN, FOV_MAX))


def zoom(cfg: CameraConfig, wheel_delta_sign: float) -> CameraConfig:
    """Scroll-wheel zoom: fov × (1 ± 0.03)."""
    return set_fov(cfg, cfg.fov * (1.0 + WHEEL_ZOOM_STEP * wheel_delta_sign))


def set_camera_angles(cfg: CameraConfig, yaw, pitch) -> CameraConfig:
    """Yaw as given, pitch clamped to ±89°."""
    return dataclasses.replace(
        cfg, yaw=_f32(yaw),
        pitch=torch.clamp(_f32(pitch), -PITCH_LIMIT_DEG, PITCH_LIMIT_DEG))


def mouse_look(cfg: CameraConfig, dx: float, dy: float,
               look_sensitivity: float = LOOK_SENSITIVITY) -> CameraConfig:
    """Mouse-look: Δangle = movement × sensitivity × fov; screen y grows
    downward, so dy turns the pitch down."""
    scale = look_sensitivity * cfg.fov
    return set_camera_angles(cfg, cfg.yaw + dx * scale,
                             cfg.pitch - dy * scale)


def update_position(cfg: CameraConfig, keys: KeydownMap,
                    dt_ms: float) -> CameraConfig:
    """Fly-cam integration over ``dt_ms``: speed scales with dt and fov;
    lateral motion uses cross(front, vup) unnormalised, as the reference
    does (strafing slows as the camera pitches)."""
    if keys.all_false():
        return cfg
    front = camera_front(cfg.yaw, cfg.pitch)
    right = vec.cross(front, cfg.vup)
    step = MOVEMENT_SPEED * dt_ms * cfg.fov
    origin = cfg.origin
    if keys.w:
        origin = origin + front * step
    if keys.a:
        origin = origin - right * step
    if keys.s:
        origin = origin - front * step
    if keys.d:
        origin = origin + right * step
    if keys.space:
        origin = origin + cfg.vup * step
    if keys.shift:
        origin = origin - cfg.vup * step
    return dataclasses.replace(cfg, origin=origin)
