"""The kd cluster partition of the gathered cluster walk (counterpart of
``raytracer_tpu/scene/accel.py``: ``_kd_chunks`` and
``build_grid_clustered(..., partition='kd')``), built on the host in
numpy.

Big spheres (|radius| > ``big_radius``) become "globals", tested exactly
at the start of every bounce; the rest are split by balanced recursive
median bisection into ceil(n/group) leaves of at most ``group`` members,
each with a conservative member AABB. The scene is reordered to globals
first, then each leaf padded to ``group`` slots.

In a :class:`~raytracer_tpu_torch.scene.spheres.MotionScene` a sphere
stands for its swept volume: the bisection splits at the midpoints of
its two centres, and its box is the union of its boxes at times 0 and 1,
which bounds it at every time between, as it moves linearly (the span
``swept``). A static sphere's is its box, so a static scene's partition
is the same either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raytracer_tpu_torch.scene.spheres import Scene, scene_from_numpy
from raytracer_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ClusteredScene:
    scene: Scene  # globals first, then leaf clusters padded to ``group``
    boxes: np.ndarray  # (K, 6) float32 member AABBs [lo xyz, hi xyz]
    n_global: int
    group: int
    uuid: np.ndarray  # (slots,) int32: slot → original index, -1 padding


def _kd_leaves(idx, centers, lo_pt, hi_pt, group):
    """Balanced recursive median bisection of sphere indices into
    ceil(n/group) leaves of <= group members each, split along the
    longest axis of the member AABB (of the spheres' boxes ``lo_pt``,
    ``hi_pt``): a node of n > group members, in the
    order its parent left them, sorts them stably by centre along that
    axis and gives its first half of its leaves' worth to the left child.
    Worked out a level of the tree at a time, every node of the level at
    once (one sort keyed by node, then centre). Returns ``(order,
    sizes)``: the leaves' members one leaf after another, the leaves in
    the recursion's depth-first order, and each leaf's size."""
    order = np.asarray(idx, np.int64).copy()
    start = np.zeros(1, np.int64)
    end = np.array([len(order)], np.int64)
    leaf_start, leaf_end = [], []
    while start.size:
        n = end - start
        leaf = n <= group
        leaf_start.append(start[leaf])
        leaf_end.append(end[leaf])
        start, end, n = start[~leaf], end[~leaf], n[~leaf]
        if not start.size:
            break
        node = np.repeat(np.arange(start.size), n)
        first = np.cumsum(n) - n
        pos = start[node] + np.arange(node.size) - first[node]
        members = order[pos]
        lo = np.minimum.reduceat(lo_pt[members], first, axis=0)
        hi = np.maximum.reduceat(hi_pt[members], first, axis=0)
        axis = np.argmax(hi - lo, axis=1)
        leaves = -(-n // group)
        l_left = leaves // 2
        n_left = np.round(n * l_left / leaves).astype(np.int64)
        n_left = np.maximum(n - (leaves - l_left) * group,
                            np.minimum(l_left * group, n_left))
        # lexsort is stable: ties keep the order the parent left them in
        order[pos] = members[np.lexsort((centers[members, axis[node]],
                                         node))]
        split = start + n_left
        start, end = np.concatenate([start, split]), np.concatenate(
            [split, end])
    leaf_start = np.concatenate(leaf_start)
    sizes = (np.concatenate(leaf_end) - leaf_start)[np.argsort(leaf_start)]
    return order, sizes


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
    r = np.abs(radii)[:, None]
    if "center1" in host:
        with span("swept"):
            # the union of the boxes at both ends; the split at the middle
            ends = np.asarray(host["center1"], np.float64)
            lo_pt = np.minimum(centers, ends) - r
            hi_pt = np.maximum(centers, ends) + r
            centers = (centers + ends) * 0.5
    else:
        lo_pt, hi_pt = centers - r, centers + r
    active = host["active"] > 0.0
    big = (np.abs(radii) > big_radius) & active
    small = active & ~big

    order = np.where(big)[0]
    n_global = len(order)
    members, sizes = (_kd_leaves(np.where(small)[0], centers, lo_pt, hi_pt,
                                 group)
                      if small.any() else (np.zeros(0, np.int64),
                                           np.zeros(0, np.int64)))

    # each leaf's member AABB, widened by an absolute+relative margin so
    # float32 rounding cannot shave a member surface
    first = np.cumsum(sizes) - sizes
    lo = np.minimum.reduceat(lo_pt[members], first, axis=0)
    hi = np.maximum.reduceat(hi_pt[members], first, axis=0)
    lo = lo - (1e-4 + 1e-4 * np.abs(lo))
    hi = hi + (1e-4 + 1e-4 * np.abs(hi))
    boxes = np.concatenate([lo, hi], axis=1).astype(np.float32)
    # the leaves padded to group slots: original index, -1 for padding
    slots = np.full(len(sizes) * group, -1, np.int64)
    leaf = np.repeat(np.arange(len(sizes)), sizes)
    slots[leaf * group + np.arange(len(members)) - first[leaf]] = members

    uuid = np.concatenate([order, slots]).astype(np.int32)
    live = uuid >= 0

    def take(name, fill=0.0):
        a = np.asarray(host[name])
        out = np.full((len(uuid),) + a.shape[1:], fill, a.dtype)
        out[live] = a[uuid[live]]
        return out

    shutter = {name: take(name) for name in ("center1", "albedo_odd")
               if name in host}
    new_scene = scene_from_numpy(
        center=take("center"),
        radius=take("radius", 1.0),
        material_type=take("material_type"),
        albedo=take("albedo"),
        fuzz=take("fuzz"),
        refraction_index=take("refraction_index", 1.0),
        active=live.astype(np.float32),
        **shutter,
    )
    return ClusteredScene(
        scene=new_scene,
        boxes=boxes.reshape(-1, 6),
        n_global=n_global,
        group=group,
        uuid=uuid,
    )
