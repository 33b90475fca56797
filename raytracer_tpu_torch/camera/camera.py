"""Camera primitives and the derived viewport basis (counterpart of
``raytracer_tpu/camera/camera.py``), in float32.

``CameraConfig`` holds what the user controls (origin, yaw and pitch in
degrees, fov in radians, aperture, focus distance, aspect ratio);
:func:`derive_camera` turns it into the basis the kernel reads. The
kernels generate their own jittered thin-lens rays; :func:`generate_rays`
gives the jnp tracer's (and, pinhole and unjittered, the AOV views'),
and :func:`center_ray` the ray that picking casts.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracer_tpu_torch.core import sampling, vec
from raytracer_tpu_torch.core.ray import Ray
from raytracer_tpu_torch.render import rng

# the controller's clamps (the reference's src/state.rs:349-358)
FOV_MIN = 0.0001
FOV_MAX = math.pi * 0.75
PITCH_LIMIT_DEG = 89.0


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


def pixel_st_grid(width: int, height: int, dtype=torch.float32, *,
                  device="cpu") -> torch.Tensor:
    """Pixel-centre viewport coordinates st in (0, 1)², (H, W, 2) of
    ``dtype``; row 0 is the bottom of the image (GL order)."""
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"dtype must be a torch.dtype, got {dtype!r}")
    # 0-d divisors filled on the device: exact divisions, and nothing is
    # copied to a card
    xs = ((torch.arange(width, dtype=dtype, device=device) + 0.5)
          / torch.full((), float(width), dtype=dtype, device=device))
    ys = ((torch.arange(height, dtype=dtype, device=device) + 0.5)
          / torch.full((), float(height), dtype=dtype, device=device))
    t, s = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([s, t], dim=-1)


def generate_rays(dcam: DerivedCamera, st: torch.Tensor, key=None,
                  width: int = 0, height: int = 0, jitter: bool = True,
                  uv: torch.Tensor | None = None) -> Ray:
    """Thin-lens rays through the viewport points ``st`` (..., 2), as the
    JAX package generates them. ``key`` (key data) gives two keys,
    ``split(key)``: the sub-pixel jitter, uniform [0, 1)² / (width,
    height) added to ``st`` (forward of the pixel centre, as the reference
    does), and the lens disc, scaled by the lens radius and laid along
    (u, v). ``uv`` (..., 4) replaces both draws with [jitter u, jitter v,
    lens u, lens v] (the stratified sampler). Directions are not
    normalised.

    Without ``key`` and ``uv`` the rays are pinhole and unjittered: the
    JAX function's ``jitter=False`` with the lens radius zeroed, as its
    AOV views call it. The camera's tensors go to ``st``'s device."""
    dev = st.device
    llc, hor, ver, org = (t.to(dev) for t in (
        dcam.lower_left_corner, dcam.horizontal, dcam.vertical,
        dcam.origin))
    if key is None and uv is None:
        direction = llc + st[..., 0:1] * hor + st[..., 1:2] * ver - org
        return Ray(origin=org.expand(direction.shape), direction=direction)
    shape = st.shape[:-1]
    if uv is None:
        kj, kl = rng.split(key)
        n = int(math.prod(shape))
        uj, ul = rng.uniforms([(kj, 2 * n), (kl, 2 * n)], dev)
        uv = torch.cat([uj.reshape(shape + (2,)), ul.reshape(shape + (2,))],
                       dim=-1)
    if jitter:
        # exact divisions: a host scalar divisor may become a product
        # with its reciprocal
        st = st + torch.stack([
            uv[..., 0] / torch.full((), float(width), device=dev),
            uv[..., 1] / torch.full((), float(height), device=dev)],
            dim=-1)
    rd = dcam.lens_radius.to(dev) * sampling.disk_from_uv(uv[..., 2],
                                                          uv[..., 3])
    offset = rd[..., 0:1] * dcam.u.to(dev) + rd[..., 1:2] * dcam.v.to(dev)
    direction = (llc + st[..., 0:1] * hor + st[..., 1:2] * ver - org
                 - offset)
    return Ray(origin=(org + offset).expand(shape + (3,)),
               direction=direction)


def center_ray(dcam: DerivedCamera) -> Ray:
    """The ray through the viewport centre, without lens offset: what
    picking and autofocus cast."""
    direction = (dcam.lower_left_corner + dcam.horizontal / 2.0
                 + dcam.vertical / 2.0 - dcam.origin)
    return Ray(origin=dcam.origin, direction=direction)
