"""Chunked render through the port's kernels (counterpart of the host
orchestration in ``raytracer_tpu/render/pallas_kernel.py``:
``render_image_pallas``, ``_render_pallas``, ``_plan_from_cost``,
``_plan_adaptive``, ``_accumulate_sorted``, ``_render_adaptive_profiled``,
``_render_adaptive_scan``, ``_finalize_flat``, ``_finalize_adaptive``
and ``_finalize``).

:func:`choose_kernel` picks the kernel as the JAX package does: the
cluster walk (K1) on a progressive session's static-cluster hint, or
where ``cluster_scan`` is enabled and a partition can be built; else the
flat scan, split (K2s) on a static-split hint or on this scene's own
containable split, unsplit (K2) otherwise. A caller that stands for a
scene the JAX package would see traced (the progressive step) turns the
scene analysis off, and only its hints choose. A debug render (K3) never
splits: the flat scan's outline reads the winner's slot as the scene
index, so the slots keep the scene's order; it also renders fixed spp
(the overlay has no adaptive instantiation).

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
count. Budgets, maps and statistics are built on the device: the loop
never waits for it.

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
from raytracer_tpu_torch.render import schedule
from raytracer_tpu_torch.render.cluster_walk import (
    cluster_walk,
    identity_map,
    padded_width,
)
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
    upload,
    walk_tables,
)
from raytracer_tpu_torch.scene.accel import ClusteredScene
from raytracer_tpu_torch.scene.spheres import Scene
from raytracer_tpu_torch.utils.profiling import span, wait


def plan_from_cost(cost: torch.Tensor, width: int):
    """Per-pixel cumulative cost → (inv, pixel_map): pixels in descending
    cost (stable, as ``jnp.argsort``), and the inverse permutation that
    takes lane-order sums back to pixel order."""
    order = torch.argsort(-cost, stable=True)
    inv = torch.argsort(order, stable=True)
    pixel_map = torch.stack([order % width, order // width], 1)
    return inv, pixel_map.to(torch.int32).contiguous()


def plan_adaptive(acc: torch.Tensor, width: int, cs: int, tol: float,
                  chunk_stats: torch.Tensor | None = None,
                  t975: torch.Tensor | None = None):
    """Adaptive variant of :func:`plan_from_cost`: ``(inv, pixel_map,
    budget)`` with unconverged pixels first in descending cost, converged
    ones last, and a lane-order sample budget (``cs``, or 0 for a
    converged pixel).

    ``acc`` rows: [r, g, b, cost, n, Σ lum²], cumulative. A pixel has
    converged when n >= ``schedule.ADAPTIVE_MIN_N`` and the 95 % half-width
    of its mean luminance is within tol · (mean + ``ADAPTIVE_ABS_FLOOR``).
    The half-width is 1.96 · sqrt(var / n) from the per-sample variance.
    With ``chunk_stats`` ([n_c, Σ m, Σ m²] per pixel, m a full chunk's mean
    luminance; the stratified sampler only) and n_c >= 3 it is the smaller
    of that and the Student-t interval on the between-chunk-mean variance,
    which sees the stratification that the per-sample variance cannot.
    ``t975`` is ``schedule.T975_BY_CHUNKS`` on ``acc``'s device."""
    n = acc[4]
    n_safe = torch.clamp_min(n, 1.0)
    mean = (acc[0] + acc[1] + acc[2]) * (1.0 / 3.0) / n_safe
    var = torch.clamp_min(acc[5] / n_safe - mean * mean, 0.0)
    ci = 1.96 * torch.sqrt(var / n_safe)
    if chunk_stats is not None:
        if t975 is None:
            t975 = t975_table(acc.device)
        n_c = chunk_stats[0]
        nc_safe = torch.clamp_min(n_c, 1.0)
        m_mean = chunk_stats[1] / nc_safe
        s2 = (torch.clamp_min(chunk_stats[2] / nc_safe - m_mean * m_mean, 0.0)
              * nc_safe / torch.clamp_min(n_c - 1.0, 1.0))
        t = t975[torch.clamp(n_c.to(torch.int64), 0, t975.shape[0] - 1)]
        ci_c = t * torch.sqrt(s2 / nc_safe)
        ci = torch.where(n_c >= 3.0, torch.minimum(ci, ci_c), ci)
    converged = (n >= schedule.ADAPTIVE_MIN_N) & (
        ci <= tol * (mean + schedule.ADAPTIVE_ABS_FLOOR)
    )
    key = torch.where(converged, 3e38, -acc[3])
    order = torch.argsort(key, stable=True)
    inv = torch.argsort(order, stable=True)
    pixel_map = torch.stack([order % width, order // width], 1)
    budget = torch.where(converged, 0, cs)[order].to(torch.int32)
    return inv, pixel_map.to(torch.int32).contiguous(), budget.contiguous()


def t975_table(device) -> torch.Tensor:
    return torch.tensor(schedule.T975_BY_CHUNKS, dtype=torch.float32,
                        device=device)


def chunk_mean_stats(chunk_stats: torch.Tensor, acc: torch.Tensor,
                     lsum_prev: torch.Tensor, n_prev: torch.Tensor):
    """Add one chunk to the per-pixel between-chunk statistics [n_c, Σ m,
    Σ m²]: m is the chunk's mean luminance, from the accumulator after the
    chunk and its rgb sum and count before it; a pixel that took no
    sample adds nothing."""
    dn = acc[4] - n_prev
    sampled = (dn > 0.0).to(torch.float32)
    m_c = ((acc[0] + acc[1] + acc[2] - lsum_prev) * (1.0 / 3.0)
           / torch.clamp_min(dn, 1.0))
    return chunk_stats + torch.stack(
        [sampled, m_c * sampled, m_c * m_c * sampled]
    )


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
        """``launch(pixel_map, sample_offset, spp, budget=None) -> (out,
        segs)``: one chunk through the chosen kernel (with the overlay of
        ``debug`` under ``opts.enable_debug``)."""
        if self.kernel == "cluster_walk":
            def launch(pixel_map, offset, cs, budget=None):
                with span("launch"):
                    return cluster_walk(self.tables, pixel_map, kseed,
                                        offset, cs, width, height, opts,
                                        budget, debug)
        else:
            def launch(pixel_map, offset, cs, budget=None):
                with span("launch"):
                    return flat_scan(self.tables, pixel_map, kseed, offset,
                                     cs, width, height, opts, self.g_full,
                                     budget, debug)
        return launch


def permute_scene(scene: Scene, perm) -> Scene:
    """The scene's slots in the order of ``perm`` (numpy indices)."""
    with span("tables"):
        idx = upload(torch.as_tensor(np.asarray(perm, np.int64)),
                     scene.center.device)
        return Scene(**{f.name: getattr(scene, f.name)[idx]
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
    ``enable_debug`` no split at all."""
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
    budget, then equal sorted chunks, each followed by accumulation and a
    new convergence decision. Returns the (6, H·W) accumulator and the
    int64 segment total, both on the device."""
    tol = opts.adaptive_tolerance
    track_chunks = opts.sampler == "stratified"
    acc, segs = launch(identity_map(width, height, device), 0, sizes[0])
    with span("plan"):
        segments = segs.sum(dtype=torch.int64)
        inv, pixel_map, budget = plan_adaptive(acc, width, sizes[1], tol)
        # between-chunk statistics start after the profile chunk, whose
        # size differs; only the stratified sampler keeps them
        cstats = torch.zeros((3, acc.shape[1]), dtype=torch.float32,
                             device=device) if track_chunks else None
        t975 = t975_table(device) if track_chunks else None
    offset, spp = sizes[0], sum(sizes)
    for cs in sizes[1:]:
        if track_chunks:
            lsum_prev, n_prev = acc[0] + acc[1] + acc[2], acc[4]
        out, segs = launch(pixel_map, offset, cs, budget)
        with span("plan"):
            acc, segments = accumulate_sorted(out, segs, acc, segments,
                                              inv)
            if track_chunks:
                cstats = chunk_mean_stats(cstats, acc, lsum_prev, n_prev)
            offset += cs
            if offset < spp:
                inv, pixel_map, budget = plan_adaptive(acc, width, cs, tol,
                                                       cstats, t975)
    return acc, segments


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
        return lambda pixel_map, offset, cs, budget=None: launch(
            band_pixels(pixel_map, rows), offset, cs, budget)

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
