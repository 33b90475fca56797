"""Pixel-row and spp sharding of the renders over a (rows, spp) mesh
(counterpart of ``raytracer_tpu/parallel/sharding.py``): the kernel
paths (``render_image_sharded_pallas``, ``make_sharded_step_fn`` with
``_make_sharded_step_fn_pallas``, ``shard_render_state`` and the band
helpers) and the jnp tracer's (``render_image_sharded``,
``_render_shard``, the step's jnp path).

Each rows shard renders a band of image rows and each spp shard a
disjoint range of absolute sample indices. The kernels key every stream
on the absolute pixel and sample, so a band is just a lane map and an spp
shard just a sample offset: the mesh renders what one device renders.
Row shards never communicate while they trace; spp shards sum their
linear sums once, before the image is formed (``all_reduce``), the mesh
sums its exact segment counts, and a render ends in one all-gather over
rows, so every rank holds the whole image and the stats. A progressive session keeps
its accumulation buffer on each rank as that rank's band, frame to frame.

A rows-only mesh whose band schedule equals the single render's gives
the single render's image bit for bit; otherwise the sums regroup (each
spp shard, and each band, runs its own chunk schedule) and the image
differs in float32 summation order only. Segment totals are exact int64
over the whole mesh.

The JAX package's jnp tracer paths (``render_image_sharded``,
``_render_shard`` and the step with ``opts.backend == 'jnp'`` or
``enable_debug``) key each shard's streams apart instead: the key is
folded with the rows coordinate and, where the mesh has an spp axis, the
spp coordinate, and each shard draws by its own batch positions. The mesh
then renders another Monte Carlo estimate than one device, the same at
every mesh of that shape, as in the JAX package. These paths need height
% rows == 0 only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import CameraConfig, pixel_st_grid
from raytracer_tpu_torch.parallel.mesh import Mesh, make_mesh
from raytracer_tpu_torch.progressive.state import RenderState
from raytracer_tpu_torch.progressive.step import (
    DEFAULT_LAST_FRAME_WEIGHT,
    DEFAULT_MAX_RENDER_COUNT,
    accumulate,
)
from raytracer_tpu_torch.render import schedule
from raytracer_tpu_torch.render.api import to_derived
from raytracer_tpu_torch.render.megakernel import (
    finalize_flat,
    finish,
    render_sums,
    segment_stats,
)
from raytracer_tpu_torch.render.options import (
    DebugParams,
    TraceOptions,
    resolve_backend,
)
from raytracer_tpu_torch.render.rng import fold_in, key_data
from raytracer_tpu_torch.render.split import containable_split
from raytracer_tpu_torch.render.tracer import (
    camera_on,
    sample_sums,
    scene_on,
)
from raytracer_tpu_torch.scene.spheres import Scene

#: the rows-shard height unit of the JAX package's kernel paths (its
#: tile's sublane rows), kept so the port takes exactly its arguments
ROW_UNIT = 8


def interleave_block(local_h: int) -> int:
    """Row-block height of the round-robin interleave: the JAX package's
    ``_shard_tile_params`` (k_slots·r_sub, r_sub 8, k_slots from 4 halved
    until the block divides the band)."""
    k_slots = 4
    while k_slots > 1 and (
        local_h < k_slots * ROW_UNIT or local_h % (k_slots * ROW_UNIT)
    ):
        k_slots //= 2
    return ROW_UNIT * k_slots


def band_rows(shard: int, n_shards: int, local_h: int,
              block: int | None = None) -> torch.Tensor:
    """The absolute image rows of rows shard ``shard``, in band order
    (int64): the contiguous band ``[shard·local_h, (shard+1)·local_h)``,
    or with ``block`` (the interleave) its local block j, row r, at image
    row (shard + j·n_shards)·block + r."""
    u = torch.arange(local_h, dtype=torch.int64)
    if block is None:
        return shard * local_h + u
    return (shard + (u // block) * n_shards) * block + u % block


def interleave_inverse(height: int, n_shards: int, block: int) -> np.ndarray:
    """The un-interleave: image row i is row ``inv[i]`` of the bands
    stacked in shard order (``sharding.py:452-459`` of the JAX package)."""
    local_h = height // n_shards
    phys = np.concatenate([band_rows(s, n_shards, local_h, block).numpy()
                           for s in range(n_shards)])
    inv = np.empty(height, np.int64)
    inv[phys] = np.arange(height)
    return inv


def _check_rows(height: int, n_rows: int, why: str = ""):
    if height % (n_rows * ROW_UNIT):
        raise ValueError(
            f"height {height} must be divisible by rows*8 = "
            f"{n_rows * ROW_UNIT}{why}"
        )


def _check_spp(spp: int, spp_size: int):
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if spp % spp_size:
        raise ValueError(f"spp {spp} not divisible by spp axis {spp_size}")


def gather_rows(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows shards' bands stacked in shard order on every rank: the
    whole accumulation buffer of a sharded progressive session."""
    return torch.cat(mesh.all_gather("rows", tensor))


def render_image_sharded_pallas(scene: Scene, camera, width: int,
                                height: int, spp: int, key, mesh: Mesh,
                                opts: TraceOptions | None = None,
                                return_stats: bool = False):
    """Render over ``mesh`` through the kernels; every rank of the mesh
    calls it with the same arguments and gets the whole (H, W, 3) image
    on its device (and with ``return_stats`` the stats of
    ``render_image``: exact segments over the mesh, an adaptive render's
    ``mean_spp``, the mean of the bands' means, and its whole
    ``spp_map``). ``key`` is a seed or key data, as ``render_image``
    takes.

    Needs height % (rows·8) == 0 and spp % spp_axis == 0. The kernel and
    its tables are chosen on every rank as ``render_image`` chooses them.
    The debug overlay is dropped. An adaptive tolerance holds only without
    an spp axis (an spp shard that stopped a pixel would shift the other
    shards' sample ranges) and with ``sort_pixels``; otherwise the render
    is fixed spp. ``opts.interleave_rows`` gives each rows shard every
    rows-th block of rows instead of one band, on the sorted and adaptive
    paths where a band holds more than one block: the image is the same
    bit for bit."""
    opts = opts or TraceOptions()
    if opts.enable_debug:
        # the overlay is an interactive single-device feature
        opts = dataclasses.replace(opts, enable_debug=False)
    n_rows, spp_size = mesh.size("rows"), mesh.size("spp")
    _check_rows(height, n_rows)
    _check_spp(spp, spp_size)
    local_h, spp_local = height // n_rows, spp // spp_size
    dcam, kd = to_derived(camera), key_data(key)
    # the schedule of a band, as render_sums derives it
    plan = schedule.render_schedule(spp_local, width * local_h, scene.count,
                                    opts)
    use_adaptive = spp_size == 1 and plan.adaptive is not None
    if opts.adaptive_tolerance > 0.0 and not use_adaptive:
        opts = dataclasses.replace(opts, adaptive_tolerance=0.0)
    block = interleave_block(local_h)
    interleave = (opts.interleave_rows and n_rows > 1
                  and (plan.sort or use_adaptive) and local_h > block)
    rows = band_rows(mesh.index("rows"), n_rows, local_h,
                     block if interleave else None)
    acc, segments = render_sums(
        scene, dcam, width, height, spp_local, kd, opts, mesh.device,
        sample_offset=mesh.index("spp") * spp_local, rows=rows,
    )
    # linear sums over spp, before the image is formed; the exact counts
    # over the whole mesh
    mesh.all_reduce("spp", acc)
    mesh.all_reduce(None, segments)
    image, extra = finish(acc, width, local_h, spp, opts.gamma)
    # one all-gather over rows: the band's image and its sample map
    parts = [image] + list(extra.values())
    sizes = [p.numel() for p in parts]
    bands = [t.split(sizes) for t in mesh.all_gather(
        "rows", torch.cat([p.reshape(-1) for p in parts]))]
    image = torch.cat([b[0].reshape(image.shape) for b in bands])
    take = None
    if interleave:
        take = torch.as_tensor(interleave_inverse(height, n_rows, block),
                               device=image.device)
        image = image[take]
    if not return_stats:
        return image
    stats = segment_stats(segments, {})
    if use_adaptive:
        maps = [b[1].reshape(local_h, width) for b in bands]
        # equal band sizes: the mean of the bands' means
        stats["mean_spp"] = float(torch.stack(
            [m.mean(dtype=torch.float64) for m in maps]).mean())
        spp_map = torch.cat(maps)
        stats["spp_map"] = spp_map if take is None else spp_map[take]
    return image, stats


def shard_key(key, mesh: Mesh) -> tuple:
    """A shard's key of the jnp paths: ``key`` folded with the rows
    coordinate and, where the mesh has an spp axis, the spp coordinate."""
    key = fold_in(key, mesh.index("rows"))
    if "spp" in mesh.axis_names:
        key = fold_in(key, mesh.index("spp"))
    return key


def _render_shard(scene: Scene, dcam, st_block: torch.Tensor, key,
                  width: int, height: int, spp_local: int,
                  opts: TraceOptions, debug: DebugParams | None, mesh: Mesh,
                  sample_offset: int = 0):
    """A rank's share of the jnp tracer's sharded render: its pixel rows
    ``st_block`` (rows_local, W, 2) at ``spp_local`` samples under its
    :func:`shard_key`; the linear sums added over the spp axis, then the
    mean and the gamma. Returns ``(image (rows_local, W, 3), segments)``:
    the exact int64 segments of the rows shard (summed over spp), a 0-d
    tensor. ``sample_offset`` shifts the shard's sample indices (the
    stratified step passes frame·spp_local)."""
    rows_local = st_block.shape[0]
    acc, segments = sample_sums(scene, dcam, st_block.reshape(-1, 2),
                                shard_key(key, mesh), width, height,
                                spp_local, opts, debug, sample_offset)
    # nothing moves without an spp axis
    mesh.all_reduce("spp", acc)
    mesh.all_reduce("spp", segments)
    color = acc * (1.0 / (spp_local * mesh.size("spp")))
    if opts.gamma:
        color = torch.sqrt(torch.clamp_min(color, 0.0))
    return color.reshape(rows_local, -1, 3), segments


def _check_height(height: int, n_rows: int):
    if height % n_rows:
        raise ValueError(
            f"height {height} not divisible by rows axis {n_rows}")


def render_image_sharded(scene: Scene, camera, width: int, height: int,
                         spp: int, key, mesh: Mesh,
                         opts: TraceOptions | None = None,
                         debug: DebugParams | None = None,
                         return_stats: bool = False):
    """The JAX package's sharded render through its jnp tracer, over
    ``mesh`` (axes 'rows' and optionally 'spp'): each rank renders its
    band of H/rows rows at spp/spp_axis samples (:func:`_render_shard`),
    and every rank gets the whole (H, W, 3) image on its device after one
    all-gather over rows (and with ``return_stats`` ``{'segments',
    'segments_exact'}``, exact over the mesh). Needs height % rows == 0
    and spp % spp_axis == 0; ``key`` is a seed or key data."""
    opts = opts or TraceOptions()
    n_rows, spp_size = mesh.size("rows"), mesh.size("spp")
    _check_height(height, n_rows)
    _check_spp(spp, spp_size)
    local_h = height // n_rows
    device = mesh.device
    row0 = mesh.index("rows") * local_h
    st = pixel_st_grid(width, height, device=device)[row0:row0 + local_h]
    band, segments = _render_shard(
        scene_on(scene, device), camera_on(to_derived(camera), device), st,
        key_data(key), width, height, spp // spp_size, opts, debug, mesh)
    image = torch.cat(mesh.all_gather("rows", band))
    if not return_stats:
        return image
    return image, segment_stats(mesh.all_reduce("rows", segments), {})


def make_sharded_step_fn(width: int, height: int, mesh: Mesh, spp: int = 1,
                         opts: TraceOptions | None = None,
                         should_average: bool = True,
                         last_frame_weight: float = DEFAULT_LAST_FRAME_WEIGHT,
                         max_render_count: int = DEFAULT_MAX_RENDER_COUNT,
                         static_scene: Scene | None = None,
                         static_camera: CameraConfig | None = None):
    """The progressive step over ``mesh``: ``step(state, scene, camera,
    debug=None) -> (state', aux)``, called by every rank of the mesh with
    a state from :func:`shard_render_state`. The accumulation buffer
    stays on each rank as its band of rows; ``aux['segments']`` is the
    frame's exact segment total over the mesh (a 0-d tensor).
    :func:`gather_rows` reads the whole buffer.

    ``static_scene`` / ``static_camera``: concrete copies of what every
    call receives, for a fixed-scene session: the split scan's analysis
    runs once here. Like the JAX package's sharded step, the frames go
    through the flat scan only (K2, or K2s with the hints). An adaptive
    tolerance is stripped.

    With ``opts.backend == 'jnp'`` or ``opts.enable_debug`` the frames are
    the JAX package's jnp tracer's instead, as it decides: each rank
    renders its band through :func:`_render_shard` (the overlay of the
    step's ``debug`` where enabled), which needs height % rows == 0
    only."""
    opts = opts or TraceOptions()
    opts = dataclasses.replace(opts, backend=resolve_backend(opts.backend))
    n_rows, spp_size = mesh.size("rows"), mesh.size("spp")
    _check_height(height, n_rows)
    _check_spp(spp, spp_size)
    if opts.backend == "jnp" or opts.enable_debug:
        return _make_sharded_step_fn_jnp(
            width, height, mesh, spp, opts, should_average,
            last_frame_weight, max_render_count)
    return _make_sharded_step_fn_kernels(
        width, height, mesh, spp, opts, should_average, last_frame_weight,
        max_render_count, static_scene, static_camera)


def _blend(state: RenderState, color: torch.Tensor, should_average: bool,
           last_frame_weight: float, max_render_count: int) -> RenderState:
    """Fold a frame's band into the rank's running average, in place."""
    render_count = min(state.render_count + 1, max_render_count)
    if should_average:
        accumulate(state.accum, color, render_count, last_frame_weight,
                   out=state.accum)
    else:
        state.accum.copy_(color)
    return dataclasses.replace(state, render_count=render_count,
                               frame=state.frame + 1)


def _check_band(state: RenderState, local_h: int, width: int, device):
    if (state.accum.device != device
            or tuple(state.accum.shape) != (local_h, width, 3)):
        raise ValueError(
            f"state.accum is {tuple(state.accum.shape)} on "
            f"{state.accum.device}; this rank's band is "
            f"({local_h}, {width}, 3) on {device} (shard_render_state)"
        )


def _make_sharded_step_fn_jnp(width, height, mesh, spp, opts,
                              should_average, last_frame_weight,
                              max_render_count):
    """The JAX package's jnp sharded step: with the random sampler frame
    i folds i into the session key, with the stratified one the key stays
    and each shard's samples start at frame·spp_local; the rank's band of
    the frame comes from :func:`_render_shard`, the segments are summed
    over the mesh."""
    n_rows, spp_size = mesh.size("rows"), mesh.size("spp")
    local_h, spp_local = height // n_rows, spp // spp_size
    device = mesh.device
    row0 = mesh.index("rows") * local_h
    st = pixel_st_grid(width, height, device=device)[row0:row0 + local_h]
    stratified = opts.sampler == "stratified"

    def step(state: RenderState, scene: Scene, camera, debug=None):
        _check_band(state, local_h, width, device)
        if stratified:
            key, offset = state.key, state.frame * spp_local
        else:
            key, offset = fold_in(state.key, state.frame), 0
        color, segments = _render_shard(
            scene_on(scene, device), camera_on(to_derived(camera), device),
            st, key, width, height, spp_local, opts, debug, mesh,
            sample_offset=offset)
        state = _blend(state, color, should_average, last_frame_weight,
                       max_render_count)
        return state, {"segments": mesh.all_reduce("rows", segments)}

    return step


def _make_sharded_step_fn_kernels(width, height, mesh, spp, opts,
                                  should_average, last_frame_weight,
                                  max_render_count, static_scene,
                                  static_camera):
    """``_make_sharded_step_fn_pallas``: each rows shard renders its band,
    each spp shard its range of the frame's samples; with the random
    sampler frame i folds i into the key, with the stratified one the key
    stays and frame i is the session's samples [i·spp, (i+1)·spp). A
    rows-only mesh gives the single-device step's frames bit for bit."""
    opts = dataclasses.replace(opts, adaptive_tolerance=0.0)
    n_rows, spp_size = mesh.size("rows"), mesh.size("spp")
    _check_rows(height, n_rows, " for the kernels' row bands")
    local_h, spp_local = height // n_rows, spp // spp_size
    static_split = None
    if static_scene is not None and static_camera is not None:
        static_split = containable_split(
            static_scene, to_derived(static_camera), opts)
    rows = band_rows(mesh.index("rows"), n_rows, local_h).to(mesh.device)
    shard_offset = mesh.index("spp") * spp_local
    stratified = opts.sampler == "stratified"
    device = mesh.device

    def step(state: RenderState, scene: Scene, camera, debug=None):
        _check_band(state, local_h, width, device)
        if stratified:
            key, base = state.key, state.frame * spp
        else:
            key, base = fold_in(state.key, state.frame), 0
        acc, segments = render_sums(
            scene, to_derived(camera), width, height, spp_local, key, opts,
            device, sample_offset=base + shard_offset,
            static_split=static_split, analyse=False, rows=rows,
        )
        mesh.all_reduce("spp", acc)
        color = finalize_flat(acc[:3], width, local_h, spp, opts.gamma)
        state = _blend(state, color, should_average, last_frame_weight,
                       max_render_count)
        return state, {"segments": mesh.all_reduce(None, segments)}

    step.static_split = static_split
    return step


def shard_render_state(state: RenderState, mesh: Mesh) -> RenderState:
    """This rank's share of ``state``: its band of the accumulation
    buffer, on the mesh's device, and the counters and key as they are."""
    n_rows = mesh.size("rows")
    if state.height % n_rows:
        raise ValueError(f"height {state.height} not divisible by rows "
                         f"axis {n_rows}")
    local_h = state.height // n_rows
    start = mesh.index("rows") * local_h
    band = state.accum[start:start + local_h].to(mesh.device, copy=True)
    return dataclasses.replace(state, accum=band.contiguous())
