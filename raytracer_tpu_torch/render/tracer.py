"""The closest-hit scan that picking and the AOV views read (counterpart
of ``raytracer_tpu/render/tracer.py`` ``HitRecord`` and ``hit_world``),
in plain PyTorch. It is not a kernel of the renderer: a pick casts one
ray and an AOV view one per pixel.

The JAX function scans the spheres in a loop that carries the best t and
index. A sphere's candidate is its near root where that is at least
``t_min``, else its far root, and it wins where it is at least ``t_min``
and no farther than the best so far: ties go to the later sphere (its
``<=`` test). Each sphere's candidate depends only on the ray, so the
port forms all candidates of a block of rays at once and takes the last
index of the smallest; the result is the loop's. The arithmetic is plain
float32, as in the render's plain twins; XLA fuses some of the JAX
function's products into multiply-adds, so t and the point may differ by
a few ulps. Note that the render kernels keep the LOWEST slot of a tie,
so on exactly coincident spheres the overlay's outline may disagree with
the pick, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.core import vec
from raytracer_tpu_torch.render.options import MAX_T, MIN_T
from raytracer_tpu_torch.scene.spheres import Scene

#: candidates formed at once: rays of a block times spheres
BLOCK_ELEMENTS = 1 << 20


class HitRecord(NamedTuple):
    """The closest hit of each ray, gathered from the winning sphere."""

    hit: torch.Tensor  # (P,) bool
    t: torch.Tensor  # (P,) in units of |d|; t_max on a miss
    point: torch.Tensor  # (P, 3)
    normal: torch.Tensor  # (P, 3), front-face corrected
    front_face: torch.Tensor  # (P,) bool
    uuid: torch.Tensor  # (P,) int32 sphere index; -1 on a miss


def _closest(origin, direction, a, inv_a, scene: Scene, t_min, t_max):
    """(best t, best index) of a block of rays."""
    oc = origin[:, None, :] - scene.center[None, :, :]  # (P, S, 3)
    d = direction[:, None, :]
    half_b = vec.dot(oc, d)
    c_coef = vec.dot(oc, oc) - scene.radius * scene.radius
    disc = half_b * half_b - a[:, None] * c_coef
    sqrtd = torch.sqrt(torch.clamp_min(disc, 0.0))
    root_near = (-half_b - sqrtd) * inv_a[:, None]
    root_far = (-half_b + sqrtd) * inv_a[:, None]
    root = torch.where(root_near >= t_min, root_near, root_far)
    valid = ((disc >= 0.0) & (scene.active > 0.0) & (root >= t_min)
             & (root <= t_max))
    cand = torch.where(valid, root, torch.inf)
    best = cand.min(dim=1).values
    won = valid & (cand == best[:, None])
    # the last index of the minimum, -1 where no sphere is valid
    idx = torch.arange(scene.count, device=origin.device)
    best_idx = torch.where(won, idx, -1).max(dim=1).values
    return torch.where(best_idx >= 0, best, t_max), best_idx


def hit_world(origin: torch.Tensor, direction: torch.Tensor, scene: Scene,
              t_min: float = MIN_T, t_max: float = MAX_T) -> HitRecord:
    """Closest hit over all spheres for rays (P, 3) on the scene's
    device."""
    a = vec.length_squared(direction)  # directions are not normalised
    inv_a = 1.0 / a
    block = max(1, BLOCK_ELEMENTS // max(1, scene.count))
    ts, idxs = [], []
    for lo in range(0, origin.shape[0], block):
        sl = slice(lo, lo + block)
        t, i = _closest(origin[sl], direction[sl], a[sl], inv_a[sl], scene,
                        t_min, t_max)
        ts.append(t)
        idxs.append(i)
    best_t, best_idx = torch.cat(ts), torch.cat(idxs)
    hit = best_idx >= 0
    safe = torch.clamp_min(best_idx, 0)
    center = scene.center[safe]
    radius = scene.radius[safe]
    point = origin + best_t[:, None] * direction
    outward = (point - center) / radius[:, None]
    front_face = vec.dot(direction, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return HitRecord(hit=hit, t=best_t, point=point, normal=normal,
                     front_face=front_face, uuid=best_idx.to(torch.int32))
