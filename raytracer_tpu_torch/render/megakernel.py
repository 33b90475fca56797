"""Chunked cluster-walk render (counterpart of the host orchestration in
``raytracer_tpu/render/pallas_kernel.py``: ``render_image_pallas``,
``_render_pallas``, ``_plan_from_cost``, ``_accumulate_sorted``,
``_finalize_flat`` and ``_finalize``).

The spp run is cut by the shared schedule. With ``sort_pixels`` and more
than one chunk, the first chunk renders in the identity lane order and
doubles as a per-pixel cost profile; every later chunk renders its
pixels in descending cumulative cost (a stable argsort) and folds its
lane-order sums back into pixel order. Per-pixel results depend only on
the pixel and the chunk, and every pixel sums its chunks in schedule
order, so sorted and unsorted renders are bitwise equal.

Segment totals are exact int64 sums of the kernel's per-lane counts;
``return_stats`` reports them rounded once to float32 under
``"segments"`` (as the JAX package does) and exactly under
``"segments_exact"``.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import DerivedCamera
from raytracer_tpu_torch.render import schedule
from raytracer_tpu_torch.render.cluster_walk import cluster_walk, identity_map
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.render.rng import kernel_seed
from raytracer_tpu_torch.render.tables import cluster_partition, walk_tables
from raytracer_tpu_torch.scene.spheres import Scene


def plan_from_cost(cost: torch.Tensor, width: int):
    """Per-pixel cumulative cost → (inv, pixel_map): pixels in descending
    cost (stable, as ``jnp.argsort``), and the inverse permutation that
    takes lane-order sums back to pixel order."""
    order = torch.argsort(-cost, stable=True)
    inv = torch.argsort(order, stable=True)
    pixel_map = torch.stack([order % width, order // width], 1)
    return inv, pixel_map.to(torch.int32).contiguous()


def accumulate_sorted(out: torch.Tensor, segs: torch.Tensor,
                      acc: torch.Tensor, segments: torch.Tensor,
                      inv: torch.Tensor):
    """Fold one chunk's lane-order (4, n) sums into the pixel-order
    accumulator [rgb, cumulative cost], and its per-lane segment counts
    into the exact int64 total."""
    acc = acc + out[:, inv]
    return acc, segments + segs.sum(dtype=torch.int64)


def finalize_flat(acc: torch.Tensor, width: int, height: int, spp: int,
                  gamma: bool) -> torch.Tensor:
    """(3, H·W) pixel sums → (H, W, 3) image, row 0 at the bottom."""
    image = acc.reshape(3, height, width).permute(1, 2, 0) * (1.0 / spp)
    if gamma:
        image = torch.sqrt(torch.clamp_min(image, 0.0))
    return image


def render_image_cluster(scene: Scene, dcam: DerivedCamera, width: int,
                         height: int, spp: int, seed: int,
                         opts: TraceOptions, device,
                         return_stats: bool = False):
    """Render ``spp`` samples per pixel of ``scene`` through the cluster
    walk on ``device``."""
    device = torch.device(device)
    part = cluster_partition(scene, opts)
    tables = walk_tables(part, dcam, device)
    kseed = kernel_seed(seed)
    # the ORIGINAL slot count: the schedule must not see the padding
    chunk = schedule.pick_chunk_spp(
        spp, width * height, scene.count, opts.max_depth,
        opts.russian_roulette_depth,
    )
    sizes, _ = schedule.chunk_schedule(spp, chunk)
    n = width * height
    identity = identity_map(width, height, device)
    acc = torch.zeros((4, n), dtype=torch.float32, device=device)
    segments = torch.zeros((), dtype=torch.int64, device=device)
    sort = opts.sort_pixels and len(sizes) > 1
    pixel_map, inv = identity, None
    offset = 0
    for cs in sizes:
        out, segs = cluster_walk(tables, pixel_map, kseed, offset, cs,
                                 width, height, opts)
        if inv is None:
            acc = acc + out
            segments = segments + segs.sum(dtype=torch.int64)
        else:
            acc, segments = accumulate_sorted(out, segs, acc, segments, inv)
        offset += cs
        if sort and offset < spp:
            inv, pixel_map = plan_from_cost(acc[3], width)
    image = finalize_flat(acc[:3], width, height, spp, opts.gamma)
    if not return_stats:
        return image
    total = int(segments)
    return image, {"segments": float(np.float32(total)),
                   "segments_exact": total}
