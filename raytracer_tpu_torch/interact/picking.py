"""Picking and autofocus: the ray through the centre of the view against
the scene (counterpart of ``raytracer_tpu/interact/picking.py``).

The rules are the JAX package's, which keeps the reference's:

- the centre ray has no lens offset;
- ``t_min`` is 0, not the render's MIN_T;
- autofocus changes ``focus_distance`` only when the aperture is open,
  and sets it to 10 on a miss;
- nothing selected is ``NO_SELECTED_OBJECT_ID`` = 1000;
- of spheres that tie for the closest hit, the later one is picked
  (``render/tracer.py``).

:func:`center_hit` runs on the scene's device and returns device tensors;
:func:`update_cursor_state` reads them to the host once, the one wait for
the device that a camera change costs an interactive session.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import CameraConfig, center_ray
from raytracer_tpu_torch.core import vec
from raytracer_tpu_torch.render.api import to_derived
from raytracer_tpu_torch.render.options import MAX_T
from raytracer_tpu_torch.render.tracer import hit_world
from raytracer_tpu_torch.scene.spheres import NO_SELECTED_OBJECT_ID, Scene

#: autofocus distance after a miss
MISS_FOCUS_DISTANCE = 10.0


class CenterHit(NamedTuple):
    """The centre-of-view pick, as 0-d or (3,) tensors on the scene's
    device."""

    hit: torch.Tensor  # () bool
    t: torch.Tensor  # ()
    point: torch.Tensor  # (3,), zeros on a miss
    uuid: torch.Tensor  # () int32, NO_SELECTED_OBJECT_ID on a miss
    distance: torch.Tensor  # () |point - camera origin|


def center_hit(scene: Scene, camera) -> CenterHit:
    """Cast the ray through the centre of the view and return its closest
    hit. ``camera`` is a :class:`CameraConfig` (derived where it lives) or
    a :class:`DerivedCamera`; the ray goes to the scene's device."""
    dcam = to_derived(camera)
    ray = center_ray(dcam)
    dev = scene.center.device
    origin = ray.origin.to(dev)
    rec = hit_world(origin[None, :], ray.direction.to(dev)[None, :], scene,
                    t_min=0.0, t_max=MAX_T)
    hit = rec.hit[0]
    point = torch.where(hit, rec.point[0], 0.0)
    uuid = torch.where(hit, rec.uuid[0], NO_SELECTED_OBJECT_ID).to(
        torch.int32)
    distance = vec.length(point - origin)
    return CenterHit(hit=hit, t=rec.t[0], point=point, uuid=uuid,
                     distance=distance)


def update_cursor_state(scene: Scene, camera: CameraConfig):
    """The reference's update_cursor_position_in_world as a function:
    ``(camera', cursor_point, selected_object)``, the last two as host
    values (a tuple of three float32 values and an int). Autofocus sets
    ``focus_distance`` only where the aperture is open. The pick is read
    to the host in one copy: the call waits for the scene's device once."""
    ch = center_hit(scene, camera)
    host = torch.cat([
        ch.point, ch.distance[None], ch.hit.to(torch.float32)[None],
        ch.uuid.to(torch.float32)[None],
    ]).cpu().numpy()
    point = tuple(float(v) for v in host[:3])
    distance, hit, uuid = host[3], bool(host[4]), int(host[5])
    if float(camera.aperture) > 0.0:
        focus = distance if hit else np.float32(MISS_FOCUS_DISTANCE)
        camera = dataclasses.replace(
            camera, focus_distance=torch.tensor(np.float32(focus)))
    return camera, point, uuid
