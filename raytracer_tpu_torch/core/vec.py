"""Vec3 math over ``(..., 3)`` float32 tensors (counterpart of
``raytracer_tpu/core/vec.py``): what the camera, picking, the AOVs and
the jnp tracer read, and GLSL's reflect, refract and mix. Sums over the
last axis run (x + y) + z."""

from __future__ import annotations

import math

import torch


def vec3(x, y, z, dtype=torch.float32) -> torch.Tensor:
    """A (3,) vector, or (..., 3) stacked from parts that broadcast
    together, in ``dtype``. Parts go on the device of the first part that
    is a tensor; parts that are all Python numbers (or numpy values) go on
    the CPU, where ``CameraConfig.create`` and ``make_scene`` build theirs
    too."""
    device = next((v.device for v in (x, y, z)
                   if isinstance(v, torch.Tensor)), None)
    parts = [torch.as_tensor(v, dtype=dtype, device=device)
             for v in (x, y, z)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(v))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """v / |v|; with ``eps``, v / max(|v|, eps), which guards a vector of
    length 0."""
    n = length(v)
    return v / (torch.clamp_min(n, eps) if eps else n)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLSL ``reflect``: v - 2·dot(v, n)·n."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(unit_v: torch.Tensor, n: torch.Tensor,
            eta_ratio: torch.Tensor) -> torch.Tensor:
    """Snell refraction of a unit incident vector, as RTiOW splits it
    into a perpendicular and a parallel part. ``eta_ratio`` (...) is n1/n2.
    The square root's argument is clamped at 0, which changes only a
    direction that total internal reflection replaces."""
    eta = eta_ratio[..., None]
    cos_theta = torch.clamp_max(dot(-unit_v, n), 1.0)[..., None]
    r_out_perp = eta * (unit_v + cos_theta * n)
    k = torch.clamp_min(1.0 - length_squared(r_out_perp), 0.0)
    return r_out_perp + -torch.sqrt(k)[..., None] * n


def mix(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """GLSL ``mix``: a·(1 - t) + b·t; a ``t`` of one dimension less than
    ``a`` gains a last axis of 1."""
    if isinstance(t, torch.Tensor) and t.dim() and t.dim() < a.dim() \
            and t.shape[-1] != 1:
        t = t[..., None]
    return a * (1.0 - t) + b * t


def near_zero(v: torch.Tensor, threshold: float = 1e-8) -> torch.Tensor:
    """True where every component's magnitude is below ``threshold`` (the
    book's form)."""
    return (v.abs() < threshold).all(dim=-1)


def near_zero_signed(v: torch.Tensor, threshold: float = 1e-5) -> torch.Tensor:
    """The reference shader's signed form, without the abs."""
    return (v < threshold).all(dim=-1)


def degrees_to_radians(deg):
    return deg * (math.pi / 180.0)
