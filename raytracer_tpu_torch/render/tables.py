"""Scene and camera tables of the cluster walk and the flat scan
(counterpart of ``raytracer_tpu/render/pallas_kernel.py``
``_slot_encoding``, ``_sphere_table``, ``_pad_spheres``,
``_cluster_partition``, ``_cluster_reorder``, ``_cluster_tables`` and
``_camera_uniforms``, whose debug slots 19-22 are :func:`debug_uniforms`).

The TPU layouts (sublane pre-broadcast, 128-lane winner banks, the
bf16-split parameter table, padding to 128 lanes and to 8 rows) are
gone: the tables are plain row-major float32 arrays that the kernels load
into shared memory once per block and index directly. Tables are built
where the scene lives and then uploaded (:func:`upload`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import DerivedCamera
from raytracer_tpu_torch.render.options import (
    MAX_T,
    DebugParams,
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


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` contiguous on ``device``. A host tensor goes to a card
    through pinned memory, without waiting for the card: a copy from
    pageable memory would wait until the card's queue has drained."""
    device = torch.device(device)
    t = t.contiguous()
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_spheres(n: int) -> int:
    """The JAX package's sphere-row padding (a multiple of 8, at least 8):
    the split scan's ``g_full`` is counted in it."""
    return max(8, -(-n // 8) * 8)


def _winner_params(scene: Scene) -> list:
    """The columns the bounce tail reads of a hit sphere: [1/r, mat,
    albedo rgb, fuzz, ior]. 1/r is signed (a negative radius flips the
    normal) and 1 where r == 0, so no inf reaches a table."""
    r = scene.radius
    inv_r = torch.where(r == 0.0, 1.0, 1.0 / torch.where(r == 0.0, 1.0, r))
    return [inv_r, scene.material_type.to(torch.float32),
            scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
            scene.fuzz, scene.refraction_index]


def sphere_table(scene: Scene) -> torch.Tensor:
    """(S, 12) float32 rows [cx, cy, cz, k1, 1/r, mat, albedo rgb, fuzz,
    ior, active], the JAX package's ``_sphere_table`` without its padding
    rows. Centers and k1 come from :func:`slot_encoding` (inactive slots
    unhittable)."""
    _, c, k1 = slot_encoding(scene)
    return torch.stack(
        [c[:, 0], c[:, 1], c[:, 2], k1, *_winner_params(scene),
         scene.active],
        dim=1,
    ).to(torch.float32).contiguous()


def cluster_partition(scene: Scene, opts: TraceOptions):
    """The kd partition of ``scene``, or None where the JAX package
    renders the scene with the flat scan instead: no small-sphere
    clusters, or more clusters than the packed visit key can index. The
    caller decides first whether the cluster walk is wanted at all
    (:func:`~raytracer_tpu_torch.render.options.cluster_scan_enabled`)."""
    part = build_grid_clustered(scene, group=opts.cluster_group,
                                partition=opts.cluster_partition)
    k = part.boxes.shape[0]
    if k == 0 or k > MAX_CLUSTERS:
        return None
    return part


def cluster_reorder(scene: Scene, uuid: torch.Tensor) -> Scene:
    """``scene`` gathered into a prebuilt partition's slot layout (``uuid``
    maps slot → original index, -1 for padding; on the scene's device):
    the progressive step's static-cluster hint, built once from a
    concrete scene and applied to every frame's scene. Padding slots are
    filled as :func:`~raytracer_tpu_torch.scene.accel.build_grid_clustered`
    fills them: inactive, radius and refraction index 1."""
    uuid = uuid.to(torch.int64)
    live = uuid >= 0
    safe = torch.clamp_min(uuid, 0)

    def take(a, fill):
        g = a[safe]
        mask = live[:, None] if g.ndim == 2 else live
        return torch.where(mask, g, torch.full_like(g, fill))

    return Scene(
        center=take(scene.center, 0.0),
        radius=take(scene.radius, 1.0),
        material_type=take(scene.material_type, 0),
        albedo=take(scene.albedo, 0.0),
        fuzz=take(scene.fuzz, 0.0),
        refraction_index=take(scene.refraction_index, 1.0),
        active=live.to(torch.float32),
    )


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
            f.name: upload(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class FlatTables:
    """Everything the flat scan reads besides the lane→pixel map."""

    camera: torch.Tensor  # (19,) origin, llc, horizontal, vertical, u, v, lens
    spheres: torch.Tensor  # (S, 12), see :func:`sphere_table`

    def to(self, device) -> "FlatTables":
        return FlatTables(camera=upload(self.camera, device),
                          spheres=upload(self.spheres, device))


def camera_uniforms(dcam: DerivedCamera) -> torch.Tensor:
    return torch.cat([
        dcam.origin, dcam.lower_left_corner, dcam.horizontal, dcam.vertical,
        dcam.u, dcam.v, dcam.lens_radius.reshape(1),
    ]).to(torch.float32)


def debug_uniforms(debug: DebugParams) -> tuple:
    """The overlay's four uniforms (the TPU kernel's camera slots 19-22):
    cursor xyz and float32(selected_object), as Python floats that the
    kernels take by value. The selection compares as float32 with the
    winner's uuid, exact below 2^24."""
    return (*debug.cursor_point, float(np.float32(debug.selected_object)))


def flat_tables(scene: Scene, dcam: DerivedCamera, device) -> FlatTables:
    """The scene's and the camera's flat-scan tables, on ``device``."""
    return FlatTables(camera=camera_uniforms(dcam),
                      spheres=sphere_table(scene)).to(device)


def cluster_tables(scene: Scene, boxes, uuid, n_global: int,
                   group: int) -> tuple:
    """(globals, bounds, members, winner) of a partition's reordered
    scene, bit for bit the entries of the JAX package's tables."""
    k = boxes.shape[0]
    _, c, k1 = slot_encoding(scene)
    mem = torch.cat([c, k1[:, None]], dim=1)
    winner = torch.stack(
        [c[:, 0], c[:, 1], c[:, 2], *_winner_params(scene),
         torch.as_tensor(uuid).to(c.device, torch.float32)],
        dim=1,
    )
    return (
        mem[:n_global].contiguous(),
        torch.as_tensor(np.asarray(boxes, np.float32)).reshape(k, 6),
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
