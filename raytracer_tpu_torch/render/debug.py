"""The debug AOV views (counterpart of ``raytracer_tpu/render/debug.py``):
single-bounce images of the first hit, read from the same closest-hit
scan as picking (``render/tracer.py``).

- ``'normal'``: the front-corrected normal mapped to [0, 1]³;
- ``'depth'``: the world distance t·|d| of the first hit as 1/(1 + t);
- ``'uuid'``: the hit sphere's index hashed to a colour;
- ``'front'``: front faces green, back faces (a surface seen from inside)
  red.

The rays are pinhole and unjittered (the lens radius is zeroed), so each
pixel's view is fixed, whatever the key. A miss is black. Rows run
bottom-up (GL order).
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.camera.camera import generate_rays, pixel_st_grid
from raytracer_tpu_torch.core import vec
from raytracer_tpu_torch.render import rng
from raytracer_tpu_torch.render.api import resolve_device, to_derived
from raytracer_tpu_torch.render.tracer import hit_world
from raytracer_tpu_torch.scene.spheres import Scene

AOV_MODES = ("normal", "depth", "uuid", "front")
#: the uuid hash: one multiplier per channel, then a shared mix
UUID_MULTIPLIERS = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35)
UUID_MIX = 0x2C1B3C6D
FRONT_COLOUR = (0.1, 0.9, 0.1)
BACK_COLOUR = (0.9, 0.1, 0.1)


def uuid_colour(uuid: torch.Tensor) -> torch.Tensor:
    """(..., 3) colour of each sphere index: uint32 arithmetic (in int64
    held below 2^32, products through ``rng.mul32``), low byte · (1/255)."""
    u = (uuid.to(torch.int64) + 1) & rng.M32

    def channel(mult):
        x = rng.mul32(u, mult)
        x = rng.mul32(x ^ (x >> 15), UUID_MIX)
        x = x ^ (x >> 12)
        # the JAX function divides by 255 under jit, which XLA compiles as
        # a product with float32(1/255)
        return (x & 0xFF).to(torch.float32) * (1.0 / 255.0)

    return torch.stack([channel(m) for m in UUID_MULTIPLIERS], dim=-1)


def render_aov(scene: Scene, camera, width: int, height: int,
               mode: str = "normal", key=None, *,
               device=None) -> torch.Tensor:
    """One AOV view, (H, W, 3) float32 in [0, 1] on ``device`` (CUDA
    unless the CPU is named; keyword-only, the port's own). ``camera`` is
    a :class:`CameraConfig` or an already derived :class:`DerivedCamera`.

    ``key`` (an int seed or key data; None is ``PRNGKey(0)``'s) draws the
    camera rays, as the JAX function does, with the jitter off and the
    lens radius zeroed: the lens draw is scaled by zero, so no key changes
    a pixel, for a defocused camera too (in both packages)."""
    if mode not in AOV_MODES:
        raise ValueError(f"unknown AOV mode {mode!r}; choose from "
                         f"{AOV_MODES}")
    kd = rng.key_data(0 if key is None else key)
    device = resolve_device(device)
    scene = scene.to(device)
    st = pixel_st_grid(width, height, device=device).reshape(-1, 2)
    dcam = to_derived(camera)
    pinhole = dataclasses.replace(
        dcam, lens_radius=torch.zeros_like(dcam.lens_radius))
    ray = generate_rays(pinhole, st, kd, width, height, jitter=False)
    rec = hit_world(ray.origin, ray.direction, scene)
    hit3 = rec.hit[:, None]
    if mode == "normal":
        img = torch.where(hit3, rec.normal * 0.5 + 0.5, 0.0)
    elif mode == "depth":
        shade = 1.0 / (1.0 + rec.t * vec.length(ray.direction))
        img = torch.where(hit3, shade[:, None].expand(-1, 3), 0.0)
    elif mode == "uuid":
        img = torch.where(hit3, uuid_colour(rec.uuid), 0.0)
    else:
        front = torch.tensor(FRONT_COLOUR, device=device)
        back = torch.tensor(BACK_COLOUR, device=device)
        img = torch.where(hit3, torch.where(rec.front_face[:, None], front,
                                            back), 0.0)
    return img.reshape(height, width, 3)
