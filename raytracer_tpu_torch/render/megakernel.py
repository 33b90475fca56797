"""Chunked render through the port's kernels (counterpart of the host
orchestration in ``raytracer_tpu/render/pallas_kernel.py``:
``render_image_pallas``, ``_render_pallas``, ``_plan_from_cost``,
``_accumulate_sorted``, ``_render_adaptive_profiled``,
``_render_adaptive_scan``, ``_finalize_flat``, ``_finalize_adaptive``
and ``_finalize``; ``_plan_adaptive``'s is ``render/adaptive_plan.py``).

:func:`choose_kernel` picks the kernel as the JAX package does: the
cluster walk (K1) on a progressive session's static-cluster hint, or
where ``cluster_scan`` is enabled and a partition can be built; else the
flat scan, split (K2s) on a static-split hint or on this scene's own
containable split, unsplit (K2) otherwise. A caller that stands for a
scene the JAX package would see traced (the progressive step) turns the
scene analysis off, and only its hints choose. A debug render (K3) never
splits: the flat scan's outline reads the winner's slot as the scene
index, so the slots keep the scene's order; it also renders fixed spp
(the overlay has no adaptive instantiation). A scene with a shutter
(moving spheres, a checker) always takes the motion walk, on a kd
partition of its own (``tables.motion_partition``); it has no adaptive,
debug, wide or flat form, and no hint stands for it.

The spp run is cut by the shared schedule. With ``sort_pixels`` and more
than one chunk, the first chunk renders in the identity lane order and
doubles as a per-pixel cost profile; every later chunk renders its
pixels in descending cumulative cost (a stable argsort) and folds its
lane-order sums back into pixel order. Per-pixel results depend only on
the pixel and the chunk, and every pixel sums its chunks in schedule
order, so sorted and unsorted renders are bitwise equal.

An adaptive render (``adaptive_tolerance`` > 0) runs finer chunks and
carries two more accumulator rows, each pixel's completed-sample count
and its sum of squared sample luminances. After every chunk it decides
per pixel whether the confidence interval of the mean luminance meets
the tolerance; converged pixels get budget 0 and sort last, so their
lanes do nothing, and the image divides each pixel's sums by its own
count. Each re-plan reads only the lanes that still sample
(``render/adaptive_plan.py``; on the card a chain of kernels whose live
count stays on the device): budgets, maps and statistics are built on
the device, and the loop never waits for it.

A band of image rows (the sharded renders of ``parallel/``) renders
through the same loop: its lanes map to absolute pixels just before each
launch, so the kernels key every stream on the absolute pixel and sample
as a whole-image render does.

Segment totals are exact int64 sums of the kernel's per-lane counts;
``return_stats`` reports them rounded once to float32 under
``"segments"`` (as the JAX package does) and exactly under
``"segments_exact"``.

The host phases are spans of the registry in ``utils/profiling.py``:
``prep`` (every host step before the first launch: the kernel choice,
its tables, the schedule and the first lane map),
``launch`` (one chunk's enqueue), ``plan`` (the accumulation and re-plan
after a chunk), ``finish``, and the waits ``segments`` of
:func:`segment_stats`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import DerivedCamera
from raytracer_tpu_torch.render import adaptive_plan, schedule
from raytracer_tpu_torch.render.cluster_walk import (
    cluster_walk,
    identity_map,
    is_wide,
    padded_width,
)
from raytracer_tpu_torch.render.cluster_walk import library as walk_library
from raytracer_tpu_torch.render.flat_scan import LIBRARY as FLAT_LIBRARY
from raytracer_tpu_torch.render.flat_scan import flat_scan
from raytracer_tpu_torch.render.options import (
    DebugParams,
    TraceOptions,
    cluster_scan_enabled,
)
from raytracer_tpu_torch.render.rng import kernel_seed_from_key
from raytracer_tpu_torch.render.split import containable_split
from raytracer_tpu_torch.render.tables import (
    cluster_partition,
    cluster_reorder,
    flat_tables,
    motion_partition,
    upload,
    walk_tables,
)
from raytracer_tpu_torch.scene.accel import ClusteredScene
from raytracer_tpu_torch.scene.spheres import Scene, is_motion
from raytracer_tpu_torch.utils import cuda_build
from raytracer_tpu_torch.utils.profiling import span, wait


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
    """Fold one chunk's lane-order sums into the pixel-order accumulator
    ([rgb, cumulative cost], and [n, Σ lum²] when adaptive), and its
    per-lane segment counts into the exact int64 total."""
    acc = acc + out[:, inv]
    return acc, segments + segs.sum(dtype=torch.int64)


def finalize_flat(acc: torch.Tensor, width: int, height: int, spp: int,
                  gamma: bool) -> torch.Tensor:
    """(3, H·W) pixel sums → (H, W, 3) image, row 0 at the bottom."""
    image = acc.reshape(3, height, width).permute(1, 2, 0) * (1.0 / spp)
    if gamma:
        image = torch.sqrt(torch.clamp_min(image, 0.0))
    return image


def finalize_adaptive(acc: torch.Tensor, width: int, height: int,
                      gamma: bool):
    """(6, H·W) sums → ``(image, spp_map)``: every pixel divides its rgb
    sums by its OWN sample count; ``spp_map`` is that (H, W) count."""
    n = torch.clamp_min(acc[4], 1.0)
    image = (acc[:3] / n).reshape(3, height, width).permute(1, 2, 0)
    if gamma:
        image = torch.sqrt(torch.clamp_min(image, 0.0))
    return image, acc[4].reshape(height, width)


def adaptive_state_from_numpy(acc, width: int, height: int,
                              chunk_stats=None, device="cpu"):
    """Carry the JAX package's adaptive state across: its (6, Hp·Wp)
    accumulator and (3, Hp·Wp) chunk statistics live in padded pixel space
    (rows of ``padded_width(width)``); crop them to the port's row-major
    (·, H·W) tensors. Returns ``(acc, chunk_stats)``, the second ``None``
    when none was given."""
    wp = padded_width(width)

    def crop(a):
        a = np.asarray(a, dtype=np.float32)
        a = a.reshape(a.shape[0], -1, wp)[:, :height, :width]
        return torch.from_numpy(
            np.ascontiguousarray(a.reshape(a.shape[0], -1))
        ).to(device)

    return crop(acc), None if chunk_stats is None else crop(chunk_stats)


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """The kernel that renders a scene and the tables it reads:
    ``kernel`` is ``'cluster_walk'`` (K1) or ``'flat_scan'`` (K2, or K2s
    when ``g_full`` is set)."""

    kernel: str
    tables: object
    g_full: int | None = None

    def launcher(self, kseed: int, width: int, height: int,
                 opts: TraceOptions, debug: DebugParams | None = None):
        """``launch(pixel_map, sample_offset, spp, budget=None,
        extent=None) -> (out, segs)``: one chunk through the chosen kernel
        (with the overlay of ``debug`` under ``opts.enable_debug``); the
        walk takes the live extent of ``budget`` where it is given (the
        flat scan deals every lane)."""
        if self.kernel == "cluster_walk":
            def launch(pixel_map, offset, cs, budget=None, extent=None):
                with span("launch"):
                    return cluster_walk(self.tables, pixel_map, kseed,
                                        offset, cs, width, height, opts,
                                        budget, debug, extent=extent)
        else:
            def launch(pixel_map, offset, cs, budget=None, extent=None):
                with span("launch"):
                    return flat_scan(self.tables, pixel_map, kseed, offset,
                                     cs, width, height, opts, self.g_full,
                                     budget, debug)
        return launch

    def library(self) -> tuple:
        """``(name, defines)`` of the chosen kernel's library, as
        ``cuda_build.load`` takes them."""
        if self.kernel == "cluster_walk":
            return walk_library(is_wide(self.tables.members.shape[0]),
                                self.tables.motion)
        return FLAT_LIBRARY


def permute_scene(scene: Scene, perm) -> Scene:
    """The scene's slots in the order of ``perm`` (numpy indices)."""
    with span("tables"):
        idx = upload(torch.as_tensor(np.asarray(perm, np.int64)),
                     scene.center.device)
        return type(scene)(**{f.name: getattr(scene, f.name)[idx]
                              for f in dataclasses.fields(scene)})


def choose_kernel(scene: Scene, dcam: DerivedCamera, opts: TraceOptions,
                  device, static_split=None, static_cluster=None,
                  analyse: bool = True) -> KernelChoice:
    """The kernel and tables for ``scene``, as ``render_image_pallas``
    and ``_render_pallas`` choose. ``static_cluster`` = (boxes, uuid,
    n_global) of a partition built once from a concrete hint: the scene
    is gathered into its slot layout (K1). ``static_split`` = (perm,
    g_full) from a hint (K2s). With ``analyse`` off the scene is not read
    on the host: no partition and no split of its own. With
    ``enable_debug`` no split at all. A scene with a shutter takes the
    motion walk on a partition of its own, and raises ``ValueError``
    where that cannot render it."""
    if is_motion(scene):
        if static_cluster is not None or static_split is not None or (
                not analyse):
            raise ValueError(
                "a scene with a shutter renders through the motion walk on "
                "a partition of its own: no static hint stands for it")
        if opts.adaptive_tolerance > 0.0 or opts.enable_debug:
            raise ValueError(
                "a scene with a shutter renders fixed spp without the debug "
                "overlay: the motion walk has no adaptive or debug "
                "instantiation")
        return KernelChoice("cluster_walk", walk_tables(
            motion_partition(scene, opts), dcam, device))
    if static_cluster is not None:
        boxes, uuid, n_global = static_cluster
        uuid = upload(torch.as_tensor(uuid), scene.center.device)
        part = ClusteredScene(scene=cluster_reorder(scene, uuid), boxes=boxes,
                              n_global=n_global, group=opts.cluster_group,
                              uuid=uuid)
        return KernelChoice("cluster_walk", walk_tables(part, dcam, device))
    if analyse and cluster_scan_enabled(opts, scene.count):
        part = cluster_partition(scene, opts)
        if part is not None:
            return KernelChoice("cluster_walk",
                                walk_tables(part, dcam, device))
    split = None
    if not opts.enable_debug:
        split = static_split
        if split is None and analyse:
            split = containable_split(scene, dcam, opts)
    g_full = None
    if split is not None:
        perm, g_full = split
        if perm is not None:
            scene = permute_scene(scene, perm)
    return KernelChoice("flat_scan", flat_tables(scene, dcam, device),
                        g_full)


def _render_adaptive(launch, sizes, width, height, opts, device):
    """The adaptive host loop: an identity-order profile chunk at full
    budget, then equal sorted chunks, each followed by the re-plan of
    ``adaptive_plan`` (accumulation and a new convergence decision over
    the lanes that had budget). Returns the (6, H·W) accumulator and the
    int64 segment total, both on the device."""
    acc, segs = launch(identity_map(width, height, device), 0, sizes[0])
    with span("plan"):
        plans = adaptive_plan.start(acc, width, opts.adaptive_tolerance,
                                    opts.sampler == "stratified", len(sizes))
        plans.step(None, segs, sizes[1])
    offset = sizes[0]
    for i, cs in enumerate(sizes[1:], 2):
        out, segs = launch(plans.pixel_map, offset, cs, plans.budget,
                           plans.extent)
        with span("plan"):
            offset += cs
            plans.step(out, segs, sizes[i] if i < len(sizes) else None)
    return plans.acc, plans.segments


def band_pixels(pixel_map: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A band's lane map in absolute pixels: ``pixel_map``'s [px, i] pairs
    (i a row of the band) with i replaced by the image row ``rows[i]``."""
    py = rows[pixel_map[:, 1].to(torch.int64)]
    return torch.stack([pixel_map[:, 0], py.to(torch.int32)], 1)


def render_sums(scene: Scene, dcam: DerivedCamera, width: int, height: int,
                spp: int, key, opts: TraceOptions, device,
                sample_offset: int = 0, static_split=None,
                static_cluster=None, analyse: bool = True,
                debug: DebugParams | None = None, rows=None):
    """The pixel-order sums of :func:`render`, before the image is formed:
    ``(acc, segments)``, ``acc`` (4, n) [rgb, cumulative cost] of a fixed
    render or (6, n) [rgb, cost, n, Σ lum²] of an adaptive one, and the
    exact int64 segment total as a 0-d device tensor.

    ``rows`` (an int64 tensor of absolute image rows, in order) renders a
    band: its pixel i·W + x is the image pixel (x, ``rows[i]``), so every
    lane keys its streams on the absolute pixel and the band's sums are
    the image's sums at those pixels. The plans sort and place the band's
    own pixels, and the schedule sees the band's pixel count. ``None`` is
    every row."""
    device = torch.device(device)
    n_rows = height
    if rows is not None:
        rows = torch.as_tensor(rows, dtype=torch.int64).to(device)
        if rows.dim() != 1 or rows.shape[0] < 1:
            raise ValueError(f"rows must be a non-empty 1-D tensor, got "
                             f"shape {tuple(rows.shape)}")
        n_rows = rows.shape[0]

    def launcher(opts):
        launch = choice.launcher(kseed, width, height, opts, debug)
        if rows is None:
            return launch
        return lambda pixel_map, offset, cs, budget=None, extent=None: (
            launch(band_pixels(pixel_map, rows), offset, cs, budget, extent))

    # every host step before the first launch
    with span("prep"):
        choice = choose_kernel(scene, dcam, opts, device, static_split,
                               static_cluster, analyse)
        kseed = kernel_seed_from_key(key)
        launch = launcher(opts)
        # the ORIGINAL slot count: the schedule must not see the padding
        plan = schedule.render_schedule(spp, width * n_rows, scene.count,
                                        opts)
        if opts.adaptive_tolerance > 0.0:
            if sample_offset != 0:
                # pixels stop at different sample counts, so no uniform
                # base offset describes where a later render would resume
                raise ValueError(
                    "adaptive_tolerance requires sample_offset == 0 (per-"
                    "pixel stop counts cannot resume from a uniform base)"
                )
            if plan.adaptive is None:
                # nothing could gate a later chunk, or the overlay is on.
                # Render fixed spp through the four-row kernels
                launch = launcher(dataclasses.replace(
                    opts, adaptive_tolerance=0.0))
            elif device.type == "cuda":
                # the re-plan's library compiles beside the kernel's
                cuda_build.load_all([choice.library(), adaptive_plan.LIBRARY])
        if plan.adaptive is None:
            sizes, _ = schedule.chunk_schedule(spp, plan.chunk)
            acc = torch.zeros((4, width * n_rows), dtype=torch.float32,
                              device=device)
            segments = torch.zeros((), dtype=torch.int64, device=device)
            pixel_map, inv = identity_map(width, n_rows, device), None
    if plan.adaptive is not None:
        return _render_adaptive(launch, plan.adaptive, width, n_rows, opts,
                                device)
    sort = plan.sort
    offset = sample_offset
    for cs in sizes:
        out, segs = launch(pixel_map, offset, cs)
        with span("plan"):
            if inv is None:
                acc = acc + out
                segments = segments + segs.sum(dtype=torch.int64)
            else:
                acc, segments = accumulate_sorted(out, segs, acc, segments,
                                                  inv)
            offset += cs
            if sort and offset < sample_offset + spp:
                inv, pixel_map = plan_from_cost(acc[3], width)
    return acc, segments


def finish(acc: torch.Tensor, width: int, height: int, spp: int,
           gamma: bool):
    """:func:`render_sums`' sums of ``height`` rows → ``(image, extra)``:
    the (height, W, 3) image and, for an adaptive render's six rows,
    ``{'spp_map': (height, W) sample counts}``, else ``{}``. The span
    ``finish``."""
    with span("finish"):
        if acc.shape[0] == 6:
            image, spp_map = finalize_adaptive(acc, width, height, gamma)
            return image, {"spp_map": spp_map}
        return finalize_flat(acc[:3], width, height, spp, gamma), {}


def render(scene: Scene, dcam: DerivedCamera, width: int, height: int,
           spp: int, key, opts: TraceOptions, device, sample_offset: int = 0,
           static_split=None, static_cluster=None, analyse: bool = True,
           debug: DebugParams | None = None, rows=None):
    """Render ``spp`` samples per pixel of ``scene`` on ``device``, with
    key data ``key`` (see ``rng.key_data``), starting at absolute sample
    ``sample_offset``; with ``opts.enable_debug``, the overlay of
    ``debug`` (``DebugParams.none()`` when omitted); only the image rows
    ``rows`` where given (see :func:`render_sums`). Returns ``(image,
    segments, extra)``: the (len(rows) or H, W, 3) image, the exact int64
    segment total as a 0-d device tensor (read it when you need it: that
    waits for the device), and for an adaptive render ``{'spp_map':
    sample counts of the same rows}``, else ``{}``."""
    acc, segments = render_sums(scene, dcam, width, height, spp, key, opts,
                                device, sample_offset, static_split,
                                static_cluster, analyse, debug, rows)
    image, extra = finish(acc, width, acc.shape[1] // width, spp,
                          opts.gamma)
    return image, segments, extra


def segment_stats(segments: torch.Tensor, extra: dict) -> dict:
    """The render's stats: segments rounded once to float32 (as the JAX
    package reports them) and exactly; an adaptive render's mean spp and
    sample map. Each read waits for the device: the wait ``segments``."""
    with wait("segments"):
        total = int(segments)
    stats = {"segments": float(np.float32(total)), "segments_exact": total}
    if "spp_map" in extra:
        spp_map = extra["spp_map"]
        with wait("segments"):
            stats["mean_spp"] = float(spp_map.mean(dtype=torch.float64))
        stats["spp_map"] = spp_map
    return stats
