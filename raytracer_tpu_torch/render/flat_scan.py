"""The flat closest-hit scan: one spp chunk for every lane of a
lane→pixel map, every bounce testing every sphere (counterpart of the
flat-scan variants of ``raytracer_tpu/render/pallas_kernel.py``
``_make_kernel(...).kernel``, ``cdims=None``, launched by
``_render_chunk_impl``).

:func:`flat_scan` launches the CUDA kernel ``csrc/flat_scan.cu`` on CUDA
tensors and counts its launches in ``flat_scan.launches`` (and by kernel
variant in ``flat_scan.launches_by_variant``); on CPU tensors it runs
:func:`flat_scan_plain`, the same function written as masked tensor code.
Both return what the cluster walk returns (``render/cluster_walk.py``):
``out`` (4, n) float32 in lane order [rgb sums, bounces], with two more
rows when adaptive, and ``segs`` (n,) int32 completed bounces.

K2 (``g_full`` None, or not below the slot count) takes the near root,
else the far root, of every slot. K2s (``0 <= g_full`` < slots) does so
for slots [0, g_full) and takes the near root alone for the rest, whose
spheres cannot contain a ray origin (``render/split.py``); an exact
far-root self-test of the sphere the lane last bounced off covers a path
re-entering it. Of equal candidates the lowest slot wins (strict <),
where the TPU kernel's one-hot gather summed the tied slots' parameters.
The bounce tail and its adaptive, stratified and debug switches are the
cluster walk's (``bounce_tail``); under debug (K3) the winner's uuid is
its slot, which is the scene's own index because a debug render keeps the
scene's order: the wrapper refuses debug with a split or with adaptive.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytracer_tpu_torch.render import rng
from raytracer_tpu_torch.render.cluster_walk import (
    FILLQ,
    _first_min,
    _lane_counter,
    bounce_tail,
    check_chunk_args,
    check_tables,
    lane_setup,
    overlay,
    padded_width,
    roots,
    variant_suffix,
)
from raytracer_tpu_torch.render.options import (
    MIN_T,
    DebugParams,
    TraceOptions,
)
from raytracer_tpu_torch.render.tables import MAX_WIDE_CLUSTERS, FlatTables
from raytracer_tpu_torch.utils import cuda_build, profiling

#: floats per sphere row (see ``tables.sphere_table``)
ROW = 12
#: shared memory a block may take without opting in to more; the scan's
#: whole table (20 + 12 floats a slot) must fit: at most 1022 slots
MAX_SMEM_BYTES = 48 * 1024
#: the version of ``flat_scan_launch``'s arguments that :func:`call`
#: passes (``flat_scan_abi`` in ``csrc/flat_scan.cu``)
ABI = 2


#: the most slots whose table fits ``MAX_SMEM_BYTES``
MAX_SLOTS = (MAX_SMEM_BYTES // 4 - 20) // ROW


def smem_bytes(slots: int) -> int:
    """Shared memory of one block of the kernel, in bytes."""
    return 4 * (20 + ROW * slots)


def variant_name(opts: TraceOptions, split: bool) -> str:
    """The kernel instantiation that serves ``opts`` (K2s when
    ``split``)."""
    return "flat_scan" + ("_split" if split else "") + variant_suffix(opts)


def is_split(tables: FlatTables, g_full) -> bool:
    return g_full is not None and g_full < tables.spheres.shape[0]


def _check(tables: FlatTables, pixel_map: torch.Tensor, width: int,
           height: int, spp: int, opts: TraceOptions, g_full, budget):
    check_tables(tables, ("camera", "spheres"), pixel_map.device)
    slots = tables.spheres.shape[0]
    if (tables.camera.shape != (19,) or tables.spheres.ndim != 2
            or tables.spheres.shape[1] != ROW or slots < 1):
        raise ValueError("inconsistent flat-scan table shapes")
    if smem_bytes(slots) > MAX_SMEM_BYTES:
        raise ValueError(
            f"the flat scan's table of {slots} slots needs "
            f"{smem_bytes(slots)} bytes of shared memory per block, over "
            f"the {MAX_SMEM_BYTES} a block has by default: it takes at most "
            f"{MAX_SLOTS} slots. A larger scene renders only through the "
            "cluster walk (cluster_scan 'auto' or True), where its kd "
            f"partition has 1 to {MAX_WIDE_CLUSTERS} clusters whose tables "
            "fit a block's 227 KiB of shared memory"
        )
    if g_full is not None and not 0 <= g_full:
        raise ValueError(f"g_full must be >= 0, got {g_full}")
    if opts.enable_debug and is_split(tables, g_full):
        raise ValueError(
            "the debug overlay has no split instantiation: its outline "
            "reads the winner's slot as the scene index"
        )
    check_chunk_args(pixel_map, width, height, spp, opts, budget)


def flat_scan(tables: FlatTables, pixel_map: torch.Tensor, seed: int,
              sample_offset: int, spp: int, width: int, height: int,
              opts: TraceOptions, g_full: int | None = None,
              budget: torch.Tensor | None = None,
              debug: DebugParams | None = None):
    """One chunk of ``spp`` samples for every lane of ``pixel_map``
    through K2, or K2s with ``g_full`` full-logic slots; with ``budget``
    (adaptive only), lane j takes ``budget[j]`` samples instead; with
    ``opts.enable_debug``, the overlay of ``debug``."""
    _check(tables, pixel_map, width, height, spp, opts, g_full, budget)
    dev = pixel_map.device
    if dev.type == "cpu":
        return flat_scan_plain(tables, pixel_map, seed, sample_offset, spp,
                               width, height, opts, g_full, budget, debug)
    if dev.type != "cuda":
        raise ValueError(f"no flat scan for device {dev}")
    return _launch(tables, pixel_map, seed, sample_offset, spp, width,
                   height, opts, g_full, budget, overlay(opts, debug))


flat_scan.launches = 0
flat_scan.launches_by_variant = {}


def reset_launch_counts():
    """Zero this module's launch counters and empty the span registry
    (``utils.profiling.reset_counters``): one window of counting for all
    of the program's counters starts. ``cluster_walk``'s counters stay."""
    flat_scan.launches = 0
    flat_scan.launches_by_variant = {}
    profiling.reset_counters()


#: ``(name, defines)`` of the flat scan's library, as ``cuda_build.load``
#: takes them
LIBRARY = ("flat_scan", ())


def _lib():
    return bind(cuda_build.load(*LIBRARY))


def bind(lib: ctypes.CDLL):
    """``flat_scan_launch`` of a loaded library, with its argument types
    set; raises where the library's interface version is not ``ABI``."""
    fn = lib.flat_scan_launch
    if fn.argtypes is None:
        got = cuda_build.abi(lib, "flat_scan_abi")
        if got != ABI:
            raise RuntimeError(f"flat_scan library has launch interface "
                               f"{got}, this wrapper passes {ABI}")
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(tables, pixel_map, seed, sample_offset, spp, width, height,
            opts, g_full, budget, uniforms):
    out, segs = call(_lib(), tables, pixel_map, seed, sample_offset, spp,
                     width, height, opts, g_full, budget, uniforms)
    flat_scan.launches += 1
    name = variant_name(opts, is_split(tables, g_full))
    by_variant = flat_scan.launches_by_variant
    by_variant[name] = by_variant.get(name, 0) + 1
    return out, segs


def call(fn, tables, pixel_map, seed, sample_offset, spp, width, height,
         opts, g_full, budget, uniforms):
    """``(out, segs)`` of one launch of ``fn`` (a bound
    ``flat_scan_launch``) on the current stream, uncounted; raises on the
    launch's CUDA error."""
    n = pixel_map.shape[0]
    dev = pixel_map.device
    adaptive = opts.adaptive_tolerance > 0.0
    split = is_split(tables, g_full)
    slots = tables.spheres.shape[0]
    # the kernel writes every element, zeros for a lane without budget
    out = torch.empty((6 if adaptive else 4, n), dtype=torch.float32,
                      device=dev)
    segs = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out, segs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        next_lane = _lane_counter(dev, stream)
        err = fn(
            tables.camera.data_ptr(), tables.spheres.data_ptr(),
            pixel_map.data_ptr(),
            None if budget is None else budget.data_ptr(),
            out.data_ptr(), segs.data_ptr(), next_lane.data_ptr(),
            int(adaptive), int(opts.sampler == "stratified"), int(split),
            int(uniforms is not None),
            n, slots, g_full if split else slots, padded_width(width),
            int(seed), int(sample_offset), int(spp),
            opts.max_depth, opts.russian_roulette_depth,
            int(opts.exhaust_black), int(opts.near_zero_guard),
            float(np.float32(1.0 / width)), float(np.float32(1.0 / height)),
            *(uniforms or (0.0,) * 4), stream,
        )
    cuda_build.check_launch("flat_scan", err)
    return out, segs


def flat_scan_plain(tables: FlatTables, pixel_map: torch.Tensor, seed: int,
                    sample_offset: int, spp: int, width: int, height: int,
                    opts: TraceOptions, g_full: int | None = None,
                    budget: torch.Tensor | None = None,
                    debug: DebugParams | None = None):
    """The flat scan as masked tensor code: every lane runs the same
    regeneration loop, one bounce per pass, ``while`` any lane is alive.
    The arithmetic and its order are the kernel's."""
    f32 = torch.float32
    sph = tables.spheres
    slots = sph.shape[0]
    split = is_split(tables, g_full)
    lanes, st = lane_setup(tables.camera, pixel_map, seed, sample_offset,
                           spp, width, height, opts, budget, debug)
    cols = [sph[:, j][None, :] for j in range(4)]
    full_slot = (torch.arange(slots, device=sph.device)
                 < (g_full if split else slots))[None, :]
    last = torch.zeros_like(st.s)  # K2s: the slot last bounced off

    while bool(st.alive.any()):
        alive = st.alive
        st.out[3] += alive.to(f32)
        st.segs += alive.to(torch.int32)
        ox, oy, oz, dx, dy, dz = st.ox, st.oy, st.oz, st.dx, st.dy, st.dz
        a = rng.dot3(dx, dy, dz, dx, dy, dz)
        inv_a = 1.0 / a
        o_dot_d = rng.dot3(ox, oy, oz, dx, dy, dz)
        o_dot_o = rng.dot3(ox, oy, oz, ox, oy, oz)
        min_t_a = MIN_T * a

        # (n, slots) candidates: near root, else far root on full-logic
        # slots; near root alone on the rest
        col = [t[:, None] for t in (ox, oy, oz, dx, dy, dz, a, o_dot_d,
                                    o_dot_o)]
        nb, sq = roots(*cols, *col)
        qn = nb - sq
        q = torch.where(qn >= min_t_a[:, None], qn, nb + sq)
        full = torch.where(q >= min_t_a[:, None], q, FILLQ)
        near = torch.where(qn >= min_t_a[:, None], qn, FILLQ)
        cand = torch.where(full_slot, full, near)
        bq, bs = _first_min(cand)
        if split:
            # the far root of the sphere the origin sits on, mid-path
            # only; strict <: a tie keeps the scan's winner
            own = sph[last]
            s_nb, s_sq = roots(*own[:, :4].unbind(1), ox, oy, oz, dx, dy,
                               dz, a, o_dot_d, o_dot_o)
            s_qf = s_nb + s_sq
            ok = (st.i >= 1) & (s_qf >= min_t_a) & (s_qf < bq)
            bq = torch.where(ok, s_qf, bq)
            bs = torch.where(ok, last, bs)

        w = sph[bs]
        win = [w[:, j] for j in (0, 1, 2, 4, 5, 6, 7, 8, 9, 10)]
        goes_on = bounce_tail(st, lanes, win, bq, inv_a, alive,
                              bs.to(torch.float32))
        if split:
            last = torch.where(goes_on, bs, last)
    return st.out, st.segs
