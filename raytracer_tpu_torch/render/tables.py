"""Scene and camera tables of the cluster walk (counterpart of
``raytracer_tpu/render/pallas_kernel.py`` ``_slot_encoding``,
``_cluster_partition``, ``_cluster_tables`` and ``_camera_uniforms``).

The TPU layouts (sublane pre-broadcast, 128-lane winner banks, padding
to 128 lanes and to 8 bound rows) are gone: the tables are plain
row-major float32 arrays that the kernel loads into shared memory once
per block and indexes directly.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.camera.camera import DerivedCamera
from raytracer_tpu_torch.render.options import (
    CLUSTER_AUTO_MIN_SPHERES,
    MAX_T,
    TraceOptions,
)
from raytracer_tpu_torch.scene.accel import ClusteredScene, build_grid_clustered
from raytracer_tpu_torch.scene.spheres import Scene

#: the packed visit key carries the cluster index in 7 mantissa bits
MAX_CLUSTERS = 128


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """(x + y) + z over the last axis, the JAX package's reduction order."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def slot_encoding(scene: Scene):
    """(act, zeroed centers, k1 = |c|² − r²). Inactive slots, and slots
    wholly beyond MAX_T of the origin, are encoded unhittable: center 0
    and k1 = +1 make the discriminant negative for every ray."""
    act = (scene.active > 0.0) & (
        torch.sqrt(_sum3(scene.center * scene.center))
        - torch.abs(scene.radius) <= MAX_T
    )
    c_act = torch.where(act[:, None], scene.center, 0.0)
    k1 = torch.where(
        act, _sum3(c_act * c_act) - scene.radius * scene.radius, 1.0
    )
    return act, c_act, k1


def cluster_partition(scene: Scene, opts: TraceOptions) -> ClusteredScene:
    """The kd partition of ``scene``, or NotImplementedError where the JAX
    package would render the scene with the flat scan instead (fewer than
    64 slots, no small-sphere clusters, or more clusters than the packed
    visit key can index)."""
    flat = NotImplementedError(
        "this scene takes the flat scan in the JAX package, which is not "
        "ported yet (ROADMAP: kernel variant K2)"
    )
    if scene.count < CLUSTER_AUTO_MIN_SPHERES:
        raise flat
    part = build_grid_clustered(scene, group=opts.cluster_group,
                                partition=opts.cluster_partition)
    k = part.boxes.shape[0]
    if k == 0 or k > MAX_CLUSTERS:
        raise flat
    return part


@dataclasses.dataclass(frozen=True)
class WalkTables:
    """Everything the cluster walk reads besides the lane→pixel map."""

    camera: torch.Tensor  # (19,) origin, llc, horizontal, vertical, u, v, lens
    globals: torch.Tensor  # (n_global, 4) [cx, cy, cz, k1]
    bounds: torch.Tensor  # (K, 6) member AABBs [lo xyz, hi xyz]
    members: torch.Tensor  # (K, group, 4) [cx, cy, cz, k1]
    winner: torch.Tensor  # (slots, 11) [c xyz, 1/r, mat, albedo, fuzz, ior, uuid]

    def to(self, device) -> "WalkTables":
        return WalkTables(**{
            f.name: getattr(self, f.name).to(device).contiguous()
            for f in dataclasses.fields(self)
        })


def camera_uniforms(dcam: DerivedCamera) -> torch.Tensor:
    return torch.cat([
        dcam.origin, dcam.lower_left_corner, dcam.horizontal, dcam.vertical,
        dcam.u, dcam.v, dcam.lens_radius.reshape(1),
    ]).to(torch.float32)


def cluster_tables(scene: Scene, boxes, uuid, n_global: int,
                   group: int) -> tuple:
    """(globals, bounds, members, winner) of a partition's reordered
    scene, bit for bit the entries of the JAX package's tables."""
    k = boxes.shape[0]
    _, c, k1 = slot_encoding(scene)
    mem = torch.cat([c, k1[:, None]], dim=1)
    r = scene.radius
    inv_r = torch.where(
        r == 0.0, 1.0, 1.0 / torch.where(r == 0.0, 1.0, r)
    )
    winner = torch.stack(
        [
            c[:, 0], c[:, 1], c[:, 2], inv_r,
            scene.material_type.to(torch.float32),
            scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
            scene.fuzz, scene.refraction_index,
            torch.as_tensor(uuid, device=r.device).to(torch.float32),
        ],
        dim=1,
    )
    return (
        mem[:n_global].contiguous(),
        torch.as_tensor(boxes, dtype=torch.float32).reshape(k, 6),
        mem[n_global:].reshape(k, group, 4).contiguous(),
        winner.contiguous(),
    )


def walk_tables(part: ClusteredScene, dcam: DerivedCamera,
                device) -> WalkTables:
    """The partition's and the camera's tables, on ``device``."""
    globals_, bounds, members, winner = cluster_tables(
        part.scene, part.boxes, part.uuid, part.n_global, part.group
    )
    return WalkTables(
        camera=camera_uniforms(dcam), globals=globals_, bounds=bounds,
        members=members, winner=winner,
    ).to(device)
