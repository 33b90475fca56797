"""The kd cluster partition of the gathered cluster walk (counterpart of
``raytracer_tpu/scene/accel.py``: ``_kd_chunks`` and
``build_grid_clustered(..., partition='kd')``), built on the host in
numpy.

Big spheres (|radius| > ``big_radius``) become "globals", tested exactly
at the start of every bounce; the rest are split by balanced recursive
median bisection into ceil(n/group) leaves of at most ``group`` members,
each with a conservative member AABB. The scene is reordered to globals
first, then each leaf padded to ``group`` slots.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raytracer_tpu_torch.scene.spheres import Scene, scene_from_numpy


@dataclasses.dataclass(frozen=True)
class ClusteredScene:
    scene: Scene  # globals first, then leaf clusters padded to ``group``
    boxes: np.ndarray  # (K, 6) float32 member AABBs [lo xyz, hi xyz]
    n_global: int
    group: int
    uuid: np.ndarray  # (slots,) int32: slot → original index, -1 padding


def _kd_chunks(idx, centers, radii, group):
    """Balanced recursive median bisection of sphere indices into
    ceil(n/group) leaves of <= group members each, split along the
    longest axis of the member AABB."""
    idx = np.asarray(idx, np.int64)
    n = len(idx)
    if n <= group:
        return [list(idx)]
    lo = (centers[idx] - np.abs(radii[idx])[:, None]).min(axis=0)
    hi = (centers[idx] + np.abs(radii[idx])[:, None]).max(axis=0)
    axis = int(np.argmax(hi - lo))
    leaves = -(-n // group)
    l_left = leaves // 2
    n_left = int(round(n * l_left / leaves))
    n_left = max(n - (leaves - l_left) * group,
                 min(l_left * group, n_left))
    order = idx[np.argsort(centers[idx, axis], kind="stable")]
    return (_kd_chunks(order[:n_left], centers, radii, group)
            + _kd_chunks(order[n_left:], centers, radii, group))


def build_grid_clustered(scene: Scene, cell_size: float = 2.0,
                         big_radius: float = 0.5, group: int = 8,
                         partition: str = "grid") -> ClusteredScene:
    """Host-side build of the global/cluster partition, with the JAX
    package's arguments and defaults. Only the 'kd' partition is ported:
    the default, 'grid', raises ``NotImplementedError`` (ROADMAP "Not to
    port"), so callers pass ``partition='kd'``; ``cell_size`` sizes the
    grid's cells and is unused by 'kd'.
    """
    if partition != "kd":
        raise NotImplementedError(
            f"partition {partition!r}: only 'kd' is ported"
        )
    host = scene.numpy()
    centers = np.asarray(host["center"], np.float64)
    radii = np.asarray(host["radius"], np.float64)
    active = host["active"] > 0.0
    big = (np.abs(radii) > big_radius) & active
    small = active & ~big

    order = list(np.where(big)[0])
    n_global = len(order)
    chunks = ([] if not small.any()
              else _kd_chunks(np.where(small)[0], centers, radii, group))

    boxes = []
    slots = []  # original index or -1 per padded slot
    for chunk in chunks:
        pts = centers[chunk]
        rs = np.abs(radii[chunk])
        lo = (pts - rs[:, None]).min(axis=0)
        hi = (pts + rs[:, None]).max(axis=0)
        # widen by an absolute+relative margin so float32 rounding cannot
        # shave a member surface
        lo = lo - (1e-4 + 1e-4 * np.abs(lo))
        hi = hi + (1e-4 + 1e-4 * np.abs(hi))
        boxes.append((*lo.astype(np.float32), *hi.astype(np.float32)))
        slots.extend(list(chunk) + [-1] * (group - len(chunk)))

    uuid = np.array(order + slots, dtype=np.int32)
    live = uuid >= 0

    def take(name, fill=0.0):
        a = np.asarray(host[name])
        out = np.full((len(uuid),) + a.shape[1:], fill, a.dtype)
        out[live] = a[uuid[live]]
        return out

    new_scene = scene_from_numpy(
        center=take("center"),
        radius=take("radius", 1.0),
        material_type=take("material_type"),
        albedo=take("albedo"),
        fuzz=take("fuzz"),
        refraction_index=take("refraction_index", 1.0),
        active=live.astype(np.float32),
    )
    return ClusteredScene(
        scene=new_scene,
        boxes=np.array(boxes, np.float32).reshape(-1, 6),
        n_global=n_global,
        group=group,
        uuid=uuid,
    )
