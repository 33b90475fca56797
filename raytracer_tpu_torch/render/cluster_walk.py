"""The gathered cluster walk: one spp chunk for every lane of a
lane→pixel map (counterpart of the cluster-walk variants of
``raytracer_tpu/render/pallas_kernel.py`` ``_make_kernel(...).kernel``,
launched by ``_render_chunk_impl``).

:func:`cluster_walk` launches the CUDA kernel ``csrc/cluster_walk.cu`` on
CUDA tensors and counts its launches in ``cluster_walk.launches`` (and by
kernel variant in ``cluster_walk.launches_by_variant``); on CPU tensors it
runs :func:`cluster_walk_plain`, the same function written as masked
tensor code. Both return

- ``out`` (4, n) float32, lane order: rgb sums of the lane's pixel over
  the chunk's samples, and the walk-iteration count (the path cost that
  drives pixel sorting); with ``opts.adaptive_tolerance`` > 0 two more
  rows, the lane's completed-sample count and its sum of squared sample
  luminances;
- ``segs`` (n,) int32: bounce-completed segments per lane.

Per lane: ray generation from the counter-hash RNG, exact tests of the
global spheres when a bounce starts, a slab test of every cluster box,
extraction of the two nearest unvisited packed (entry, cluster) keys,
an exact test of the first one's members, the fused bounce-done test on
the second, and on bounce completion the shared tail: winner lookup,
front-face normal, diffuse / metal / glass scatter, Russian roulette,
depth exhaustion, accumulation and path regeneration. The kernel makes
the same selection from fewer slab tests: once a bounce, through parent
boxes (``tables.parent_boxes``) and a mask of the boxes hit; the plain
version tests every box on every walk iteration (:func:`box_keys`,
:func:`select_two`).

Three compile-time switches of the kernel follow ``opts``. Adaptive
(``adaptive_tolerance`` > 0): a lane samples up to its own ``budget``
(the chunk's ``spp`` where no budget is given) and a lane whose budget is
0 does nothing. On the card a narrow adaptive launch (every live lane's
samples within ``ITEM_CAP``, as after a re-plan) deals one-sample items
spread over the whole grid, a wide one whole lanes; the sums stay bit for
bit those of whole lanes (:func:`live_extent` bounds the live lanes on
the device, and the kernel counts the samples it runs each way under
``SAMPLE_COUNTS`` in the span registry). Stratified
(``sampler='stratified'``): the four camera draws, and on a sample's
first bounce the diffuse direction and the glass roll, are the
(sample_offset + s)-th point of the pixel's rotated Kronecker sequence;
every other draw stays counter-hashed. Debug
(``enable_debug``, K3): the overlay of the shared tail with the cursor
and selection of ``debug`` (a :class:`DebugParams`, ``none()`` when
omitted); the winner's uuid is column 10 of its winner row. It has no
adaptive instantiation: the wrappers refuse debug with adaptive.

A partition of more than ``MAX_CLUSTERS`` clusters (up to
``MAX_WIDE_CLUSTERS``) takes the wide walk: the same kernel source built
with ``RT_WALK_WIDE`` into a library of its own, so the narrow walk's
instantiations and build stay as they are. Its visit key holds the
cluster index in 9 bits (``tables.key_bits``), and the plain version
packs its keys the same way; it finds a bounce's clusters nearest
first, from a short ordered list of pending boxes of the whole box tree
in each thread's shared memory (a bounce whose list overflows sweeps the
boxes instead), and reads the winner rows from global memory. It counts
its lanes' walk iterations, completed bounces and sweeps
(``WIDE_COUNTS`` in the span registry).

A scene with a shutter (moving spheres, a checker: a
:class:`~raytracer_tpu_torch.scene.spheres.MotionScene`) takes the
motion walk: the same source built with ``RT_WALK_MOTION`` into a third
library, the narrow walk's fixed-spp instantiations of both samplers
alone, on the motion walk's tables
(``tables.motion_tables``). Each camera ray draws its time t uniformly in
[0, 1) (:func:`shutter_time`); every global and member test, and the
winner's normal, take the sphere's centre at t, c0 + t·(c1 − c0), and its
k1 = |c|² − r²; a checker winner scatters as diffuse with the albedo of
its colour at the hit point (:func:`motion_winner`). It counts its member
tests and completed bounces (``MOTION_COUNTS``). A static scene's tables
and kernels are as they were.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.core.sampling import A4_FIX, AB0_FIX
from raytracer_tpu_torch.render import rng
from raytracer_tpu_torch.render.options import (
    MAX_T,
    MIN_T,
    DebugParams,
    TraceOptions,
)
from raytracer_tpu_torch.render.tables import (
    MAX_CLUSTERS,
    MAX_WIDE_CLUSTERS,
    MOTION_SPHERE_FLOATS,
    MOTION_WINNER_FLOATS,
    SPHERE_FLOATS,
    WINNER_FLOATS,
    WalkTables,
    debug_uniforms,
    is_wide,
    key_bits,
    walk_fits,
    walk_layout,
)
from raytracer_tpu_torch.scene.materials import CHECKER
from raytracer_tpu_torch.utils import cuda_build, profiling

LANES_TPU = 128  # the RNG's pixel id keeps the TPU's padded row width
DRAWS_PER_BOUNCE = 8
FILLQ = 3e38
#: the version of ``cluster_walk_launch``'s arguments that :func:`call`
#: passes (``cluster_walk_abi`` in ``csrc/cluster_walk.cu``)
ABI = 3
#: items (lane, sample) an adaptive launch's scratch holds, which the
#: launch passes to the kernel: a launch whose live lanes' samples fit
#: runs one sample a thread, a wider one whole lanes. 2^22 holds every
#: re-plan of the cover's adaptive render (1.5 M items at most) and its
#: 4-spp profile launch (3.84 M) in 96 MiB
ITEM_CAP = 1 << 22
#: the scratch's rows, an item's record: r, g, b, sum of lum², walk
#: iterations, bounces (the kernel refuses a launch with other rows)
ITEM_ROWS = 6
#: the kernel's counts of the samples it ran as items and of all samples,
#: as the span registry reports them (``utils.profiling.counters``)
SAMPLE_COUNTS = ("walk_item_samples", "walk_samples")
#: the wide walk's counts: those, then its lanes' walk iterations and
#: completed bounces (every launch of it, adaptive or not), and the
#: bounces whose pending list overflowed and that swept the boxes instead
WIDE_COUNTS = SAMPLE_COUNTS + ("walk_iterations", "walk_segments",
                               "walk_sweeps")
#: the define that builds ``csrc/cluster_walk.cu`` as the wide walk
WIDE_DEFINE = "RT_WALK_WIDE"
#: the define that builds it as the motion walk
MOTION_DEFINE = "RT_WALK_MOTION"
#: the motion walk's counts: sphere tests of cluster members (a visit
#: tests its cluster's ``group`` slots) and completed bounces
MOTION_COUNTS = ("motion_member_tests", "motion_segments")
#: a sample's time is draw 0 of counter SHUTTER_CTR + its absolute index:
#: a counter past every sample's block [s·dps, (s + 1)·dps) while the
#: samples' counters stay below 2^31, and apart from the stratified
#: rotations' 0xFFFFFFF8 and up
SHUTTER_CTR = 0x80000000
NEG_BIG = -3e38
#: the overlay's marker: a hit whose squared distance to the cursor is
#: below this; the outline: the selected sphere where d·n > GRAZING
CURSOR_R2 = 0.01
GRAZING = -0.05


def fill_floor(bits: int = 7) -> float:
    """float32 3e38 with the ``bits`` low key bits cleared: a selection at
    or above it is a miss or an exhausted list."""
    return float(np.int32(np.float32(FILLQ).view(np.int32)
                          & ~np.int32((1 << bits) - 1)).view(np.float32))


#: the narrow walk's (7 key bits)
FILL_FLOOR = fill_floor(7)


def padded_width(width: int) -> int:
    return -(-width // LANES_TPU) * LANES_TPU


def identity_map(width: int, height: int, device) -> torch.Tensor:
    """(W·H, 2) int32 [px, py] with lane = py·W + px."""
    lane = torch.arange(width * height, device=device, dtype=torch.int64)
    return torch.stack([lane % width, lane // width], 1).to(torch.int32)


def variant_suffix(opts: TraceOptions) -> str:
    """The adaptive, stratified and debug parts of an instantiation's
    name."""
    return (("_adaptive" if opts.adaptive_tolerance > 0.0 else "")
            + ("_stratified" if opts.sampler == "stratified" else "")
            + ("_debug" if opts.enable_debug else ""))


def variant_name(opts: TraceOptions, wide: bool = False,
                 motion: bool = False) -> str:
    """The kernel instantiation that serves ``opts`` (in the wide walk
    when ``wide``, the motion walk when ``motion``)."""
    return ("cluster_walk" + ("_wide" if wide else "")
            + ("_motion" if motion else "") + variant_suffix(opts))


def _check(tables: WalkTables, pixel_map: torch.Tensor, width: int,
           height: int, spp: int, opts: TraceOptions, budget):
    check_tables(tables, ("camera", "globals", "bounds", "members", "winner",
                          "parents", "packed"), pixel_map.device)
    k, group = tables.members.shape[:2]
    n_global = tables.globals.shape[0]
    motion = tables.motion
    lay = walk_layout(n_global, k, group, motion)
    row = MOTION_SPHERE_FLOATS if motion else SPHERE_FLOATS
    win = MOTION_WINNER_FLOATS if motion else WINNER_FLOATS
    if (tables.camera.shape != (19,) or tables.globals.shape[1:] != (row,)
            or tables.bounds.shape != (k, 6)
            or tables.members.shape[2:] != (row,)
            or tables.winner.shape != (n_global + k * group, win)
            or tables.parents.shape != (
                lay.n_parents + lay.n_grand + lay.n_top, 6)
            or tables.packed.shape != (lay.n_floats,)):
        raise ValueError("inconsistent walk table shapes")
    if motion:
        if k > MAX_CLUSTERS:
            raise ValueError(f"the motion walk takes 0 to {MAX_CLUSTERS} "
                             f"clusters, got {k}")
        if opts.adaptive_tolerance > 0.0 or opts.enable_debug:
            raise ValueError("the motion walk renders fixed spp without "
                             "the debug overlay: it has no adaptive or "
                             "debug instantiation")
    elif not walk_fits(n_global, k, group):
        raise ValueError(
            f"a partition of {k} clusters of {group} slots beside "
            f"{n_global} globals: the walk takes 1 to {MAX_WIDE_CLUSTERS} "
            "clusters, and past 128 only while the wide walk's shared "
            "memory fits a block")
    check_chunk_args(pixel_map, width, height, spp, opts, budget)


def check_tables(tables, names, device):
    """Each named table of ``tables`` is contiguous float32 on
    ``device``."""
    for name in names:
        t = getattr(tables, name)
        if t.device != device:
            raise ValueError(f"tables.{name} is on {t.device}, map on {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"tables.{name} must be contiguous float32")


def check_chunk_args(pixel_map: torch.Tensor, width: int, height: int,
                     spp: int, opts: TraceOptions, budget):
    """The checks both kernels' wrappers make of a chunk's lane map, image
    size, spp and budget."""
    if (pixel_map.dtype != torch.int32 or pixel_map.ndim != 2
            or pixel_map.shape[1] != 2 or not pixel_map.is_contiguous()):
        raise ValueError("pixel_map must be a contiguous (n, 2) int32 tensor")
    if width < 1 or height < 1 or spp < 1:
        raise ValueError("width, height and spp must be >= 1")
    if opts.enable_debug and opts.adaptive_tolerance > 0.0:
        raise ValueError(
            "the debug overlay has no adaptive instantiation: strip "
            "adaptive_tolerance (render_image does)"
        )
    if budget is not None:
        if not opts.adaptive_tolerance > 0.0:
            raise ValueError("a budget needs opts.adaptive_tolerance > 0")
        if (budget.dtype != torch.int32 or budget.device != pixel_map.device
                or budget.shape != pixel_map.shape[:1]
                or not budget.is_contiguous()):
            raise ValueError(
                "budget must be a contiguous (n,) int32 tensor on the "
                "map's device"
            )


def overlay(opts: TraceOptions, debug: DebugParams | None):
    """The four overlay uniforms that ``opts`` asks for (``debug``, or
    ``DebugParams.none()``), or None without ``enable_debug``."""
    if not opts.enable_debug:
        return None
    return debug_uniforms(debug or DebugParams.none())


def cluster_walk(tables: WalkTables, pixel_map: torch.Tensor, seed: int,
                 sample_offset: int, spp: int, width: int, height: int,
                 opts: TraceOptions, budget: torch.Tensor | None = None,
                 debug: DebugParams | None = None, *,
                 extent: torch.Tensor | None = None):
    """One chunk of ``spp`` samples for every lane of ``pixel_map``;
    with ``budget`` (adaptive only), lane j takes ``budget[j]`` samples
    instead; with ``opts.enable_debug``, the overlay of ``debug``. On the
    card a budget comes with its live extent ``extent`` (as
    :func:`live_extent` gives it; an adaptive re-plan writes it into a
    buffer it holds), on the device and held by the caller until the
    launch is enqueued; the plain walk reads none."""
    _check(tables, pixel_map, width, height, spp, opts, budget)
    dev = pixel_map.device
    if dev.type == "cpu":
        return cluster_walk_plain(tables, pixel_map, seed, sample_offset,
                                  spp, width, height, opts, budget, debug)
    if dev.type != "cuda":
        raise ValueError(f"no cluster walk for device {dev}")
    return _launch(tables, pixel_map, seed, sample_offset, spp, width,
                   height, opts, budget, overlay(opts, debug), extent)


cluster_walk.launches = 0
cluster_walk.launches_by_variant = {}


def reset_launch_counts():
    """Zero this module's launch counters and empty the span registry
    (``utils.profiling.reset_counters``): one window of counting for all
    of the program's counters starts. ``flat_scan``'s counters stay."""
    cluster_walk.launches = 0
    cluster_walk.launches_by_variant = {}
    profiling.reset_counters()


def library(wide: bool = False, motion: bool = False) -> tuple:
    """``(name, defines)`` of the narrow walk's library, or with ``wide``
    the wide walk's, with ``motion`` the motion walk's, as
    ``cuda_build.load`` takes them."""
    return ("cluster_walk", (WIDE_DEFINE,) if wide
            else (MOTION_DEFINE,) if motion else ())


def _lib(wide: bool = False, motion: bool = False):
    """The narrow walk's library, or with ``wide`` the wide walk's, with
    ``motion`` the motion walk's; each is built at its first use."""
    return bind(cuda_build.load(*library(wide, motion)))


def bind(lib: ctypes.CDLL):
    """``cluster_walk_launch`` of a loaded library, with its argument
    types set; raises where the library's interface version is not
    ``ABI``."""
    fn = lib.cluster_walk_launch
    if fn.argtypes is None:
        got = cuda_build.abi(lib, "cluster_walk_abi")
        if got != ABI:
            raise RuntimeError(f"cluster_walk library has launch interface "
                               f"{got}, this wrapper passes {ABI}")
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 25
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(tables, pixel_map, seed, sample_offset, spp, width, height,
            opts, budget, uniforms, extent):
    wide, motion = is_wide(tables.members.shape[0]), tables.motion
    out, segs = call(_lib(wide, motion), tables, pixel_map, seed,
                     sample_offset, spp, width, height, opts, budget,
                     uniforms, extent)
    cluster_walk.launches += 1
    name = variant_name(opts, wide, motion)
    by_variant = cluster_walk.launches_by_variant
    by_variant[name] = by_variant.get(name, 0) + 1
    return out, segs


def call(fn, tables, pixel_map, seed, sample_offset, spp, width, height,
         opts, budget, uniforms, extent=None):
    """``(out, segs)`` of one launch of ``fn`` (``cluster_walk_launch``
    bound by :func:`bind`, of the narrow, the wide or the motion walk's
    library as the tables ask) on the current stream, uncounted;
    raises on the launch's CUDA error. ``extent``: the budget's live
    extent (:func:`live_extent`), held by the caller until the launch is
    enqueued; given exactly where ``budget`` is."""
    if (budget is None) != (extent is None):
        raise ValueError("a launch takes the live extent of its budget "
                         "(live_extent(budget)), and only with a budget")
    n = pixel_map.shape[0]
    k, group = tables.members.shape[:2]
    n_global = tables.globals.shape[0]
    lay = walk_layout(n_global, k, group, tables.motion)
    dev = pixel_map.device
    adaptive = opts.adaptive_tolerance > 0.0
    # the kernel writes every element, zeros for a lane without budget
    out = torch.empty((6 if adaptive else 4, n), dtype=torch.float32,
                      device=dev)
    segs = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out, segs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        next_lane = _lane_counter(dev, stream)
        # the live extent, the item scratch and the sample counts (an
        # adaptive launch's), and the scratch's shape. The caller holds
        # the extent until the launch is enqueued: freed before, its block
        # could go to the next allocation on the stream (the counts'
        # zeros) and be overwritten before the kernel reads it. The wide
        # and the motion walk count on every launch, into WIDE_COUNTS and
        # MOTION_COUNTS.
        ptrs, shape = (None,) * 4, (ITEM_ROWS, ITEM_CAP)
        wide = is_wide(k)
        if adaptive or wide:
            counts = profiling.device_counts(
                dev, WIDE_COUNTS if wide else SAMPLE_COUNTS).data_ptr()
            ptrs = (None, None, None, counts)
        elif tables.motion:
            counts = profiling.device_counts(dev, MOTION_COUNTS).data_ptr()
            ptrs = (None, None, None, counts)
        if adaptive:
            ptrs = (None if extent is None else extent.data_ptr(),
                    *(t.data_ptr() for t in _item_scratch(dev, stream)),
                    counts)
        err = fn(
            tables.packed.data_ptr(), pixel_map.data_ptr(),
            None if budget is None else budget.data_ptr(),
            out.data_ptr(), segs.data_ptr(), next_lane.data_ptr(), *ptrs,
            int(adaptive), int(opts.sampler == "stratified"),
            int(uniforms is not None), *shape,
            n, n_global, k, group, lay.n_parents, lay.mstride, lay.off_glob,
            lay.off_par, lay.off_box, lay.off_mem, lay.off_win, lay.n_floats,
            padded_width(width), int(seed), int(sample_offset), int(spp),
            opts.max_depth, opts.russian_roulette_depth,
            int(opts.exhaust_black), int(opts.near_zero_guard),
            float(np.float32(1.0 / width)), float(np.float32(1.0 / height)),
            *(uniforms or (0.0,) * 4), stream,
        )
    cuda_build.check_launch("cluster_walk", err)
    return out, segs


def live_extent(budget: torch.Tensor) -> torch.Tensor:
    """(2,) int32 on ``budget``'s device: one past the last lane whose
    budget is positive (0 where none is), and the largest budget (0 for
    an empty map). Worked out on the device, without a read back."""
    n = budget.shape[0]
    if n == 0:
        return torch.zeros((2,), dtype=torch.int32, device=budget.device)
    ramp = torch.arange(1, n + 1, dtype=torch.int32, device=budget.device)
    end = torch.where(budget > 0, ramp, 0).amax()
    return torch.stack([end, budget.amax()])


_ITEM_SCRATCH = {}


def _item_scratch(dev: torch.device, stream: int):
    """The adaptive launches' item scratch for ``stream`` on ``dev``:
    (ITEM_ROWS, ITEM_CAP) float32, and the lanes' counts of their items
    done, ITEM_CAP int32 that every launch leaves zero (launches on one
    stream run one after another)."""
    key = (dev.index, stream)
    if key not in _ITEM_SCRATCH:
        _ITEM_SCRATCH[key] = (
            torch.empty((ITEM_ROWS, ITEM_CAP), dtype=torch.float32,
                        device=dev),
            torch.zeros((ITEM_CAP,), dtype=torch.int32, device=dev),
        )
    return _ITEM_SCRATCH[key]


_LANE_COUNTERS = {}


def _lane_counter(dev: torch.device, stream: int) -> torch.Tensor:
    """The lane counter for ``stream`` on ``dev``: one int32 that every
    launch of either kernel on that stream reuses (each launch zeroes it
    there first, and launches on one stream run one after another)."""
    key = (dev.index, stream)
    if key not in _LANE_COUNTERS:
        _LANE_COUNTERS[key] = torch.zeros((1,), dtype=torch.int32,
                                          device=dev)
    return _LANE_COUNTERS[key]


def _gen_ray(cam, s_abs, px, py, pix, inv_w, inv_h, dps, stratified):
    """Camera ray of absolute sample index ``s_abs``: four draws jitter
    the pixel and sample the lens disc. They are draws 0-3 of the
    sample's counter block, or with the stratified sampler the
    ``s_abs``-th point of the pixel's four camera dimensions."""
    if stratified:
        s_u = s_abs & rng.M32
        u0, u1, u2, u3 = (
            rng.r2_fixed(pix, rng.ROT_CAMERA, d, s_u, A4_FIX[d])
            for d in range(4)
        )
    else:
        ctr0 = (s_abs * dps) & rng.M32
        u0 = rng.u01(pix, ctr0, 0)
        u1 = rng.u01(pix, ctr0, 1)
        u2 = rng.u01(pix, ctr0, 2)
        u3 = rng.u01(pix, ctr0, 3)
    (ox0, oy0, oz0, llx, lly, llz, hx, hy, hz, vx, vy, vz,
     ux, uy, uz, vvx, vvy, vvz, lens) = cam
    st_s = (px + 0.5 + u0) * inv_w
    st_t = (py + 0.5 + u1) * inv_h
    ang = u2 * rng.TWO_PI
    rad = lens * torch.sqrt(u3)
    rdx = rad * torch.cos(ang)
    rdy = rad * torch.sin(ang)
    ox = ox0 + (ux * rdx + vvx * rdy)
    oy = oy0 + (uy * rdx + vvy * rdy)
    oz = oz0 + (uz * rdx + vvz * rdy)
    dx = llx + st_s * hx + st_t * vx - ox
    dy = lly + st_s * hy + st_t * vy - oy
    dz = llz + st_s * hz + st_t * vz - oz
    return ox, oy, oz, dx, dy, dz


def discriminant(cx, cy, cz, k1, ox, oy, oz, dx, dy, dz, a, o_dot_d,
                 o_dot_o):
    """(nb, ds): half the b of the sphere quadratic in q-space (q =
    t·|d|²) and its discriminant, as the kernels form them
    (``csrc/common.cuh`` ``discriminant``)."""
    cdd = cx * dx + cy * dy + cz * dz
    cdo = cx * ox + cy * oy + cz * oz
    nb = cdd - o_dot_d
    cc = o_dot_o - 2.0 * cdo + k1
    return nb, nb * nb - a * cc


def shutter_time(pix, s_abs) -> torch.Tensor:
    """The time in [0, 1) of absolute sample ``s_abs`` of the pixel with
    hash ``pix``: draw 0 of counter ``SHUTTER_CTR + s_abs``."""
    return rng.u01(pix, (SHUTTER_CTR + s_abs) & rng.M32, 0)


def moving_q(rows, tm, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o,
             min_t_a):
    """:func:`_exact_q` of the motion walk's sphere rows ``rows`` ([c0
    xyz, r², c1 - c0 xyz, 0] on the last axis) at the time ``tm``: the
    centre c0 + tm·(c1 - c0) and k1 = |c|² - r², in the kernel's order
    (``csrc/cluster_walk.cu`` ``moving_q``)."""
    cx = rows[..., 0] + tm * rows[..., 4]
    cy = rows[..., 1] + tm * rows[..., 5]
    cz = rows[..., 2] + tm * rows[..., 6]
    k1 = rng.dot3(cx, cy, cz, cx, cy, cz) - rows[..., 3]
    return _exact_q(cx, cy, cz, k1, ox, oy, oz, dx, dy, dz, a, o_dot_d,
                    o_dot_o, min_t_a)


def motion_winner(w, tm, bq, inv_a, st) -> list:
    """The tail's winner columns (as :func:`bounce_tail` takes them) from
    the motion walk's winner rows ``w`` (n, 17) at the lanes' times: the
    centre c0 + tm·(c1 - c0), and a checker as diffuse, its albedo the
    odd colour where sin(10x)·sin(10y)·sin(10z) < 0 at the hit point
    (the tail's), else the even one (``csrc/cluster_walk.cu``
    ``motion_winner``)."""
    best_t = bq * inv_a
    hpx = st.ox + best_t * st.dx
    hpy = st.oy + best_t * st.dy
    hpz = st.oz + best_t * st.dz
    odd = (torch.sin(10.0 * hpx) * torch.sin(10.0 * hpy)
           * torch.sin(10.0 * hpz)) < 0.0
    mat = w[:, 4]
    checker = (mat > CHECKER - 0.5) & (mat < CHECKER + 0.5)
    pick = checker & odd
    return [w[:, 0] + tm * w[:, 11], w[:, 1] + tm * w[:, 12],
            w[:, 2] + tm * w[:, 13], w[:, 3],
            torch.where(checker, 0.0, mat),
            torch.where(pick, w[:, 14], w[:, 5]),
            torch.where(pick, w[:, 15], w[:, 6]),
            torch.where(pick, w[:, 16], w[:, 7]), w[:, 8], w[:, 9]]


def root_of(ds):
    """The roots' half-distance sq of a discriminant, poisoned to -3e38
    where it is negative (or NaN), never NaN."""
    return torch.where(ds >= 0.0, torch.sqrt(torch.abs(ds)), NEG_BIG)


def roots(cx, cy, cz, k1, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o):
    """(nb, sq) of the sphere quadratic in q-space (q = t·|d|², roots
    nb ∓ sq), as the kernels form them: sq is poisoned to -3e38 where the
    discriminant is negative, never NaN."""
    nb, ds = discriminant(cx, cy, cz, k1, ox, oy, oz, dx, dy, dz, a,
                          o_dot_d, o_dot_o)
    return nb, root_of(ds)


def _exact_q(cx, cy, cz, k1, ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o,
             min_t_a):
    """Nearest root q = t·|d|² of the sphere quadratic with t >= MIN_T
    (near root, else far root), FILLQ when there is none."""
    nb, sq = roots(cx, cy, cz, k1, ox, oy, oz, dx, dy, dz, a, o_dot_d,
                   o_dot_o)
    qn = nb - sq
    q = torch.where(qn >= min_t_a, qn, nb + sq)
    return torch.where(q >= min_t_a, q, FILLQ)


def _first_min(q: torch.Tensor):
    """(min, first index of the min) over the last axis: a sequential
    strict-< running minimum keeps the first of equal values."""
    m = q.min(dim=-1).values
    first = (q == m[..., None]).to(torch.uint8).argmax(dim=-1)
    return m, first


def _col(t: torch.Tensor) -> torch.Tensor:
    return t[:, None]


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Direction reciprocal clamped away from zero: no slab product
    reaches inf."""
    return 1.0 / torch.where(d >= 0.0, torch.clamp_min(d, 1e-12),
                             torch.clamp_max(d, -1e-12))


def _key_floor(key: torch.Tensor, bits: int = 7) -> torch.Tensor:
    return (key.view(torch.int32) & -(1 << bits)).view(torch.float32)


@dataclasses.dataclass
class Lanes:
    """What the plain versions' lanes keep for the whole chunk: camera
    uniforms, pixel coordinates and hash, sample limits and options."""

    cam: list  # the 19 camera uniforms, 0-d tensors
    px: torch.Tensor
    py: torch.Tensor
    pix: torch.Tensor  # the pixel's hash, int64 in [0, 2^32)
    limit: object  # the chunk's spp, or the (n,) int64 budgets
    sample_offset: int
    dps: int  # draws per sample
    inv_w: float
    inv_h: float
    opts: TraceOptions
    #: the overlay's (cursor x, y, z, selection) with ``enable_debug``
    debug: tuple | None = None

    @property
    def stratified(self) -> bool:
        return self.opts.sampler == "stratified"

    @property
    def adaptive(self) -> bool:
        return self.opts.adaptive_tolerance > 0.0


@dataclasses.dataclass
class PathState:
    """Per-lane path state of the plain versions' regeneration loop."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    cr: torch.Tensor
    cg: torch.Tensor
    cb: torch.Tensor
    s: torch.Tensor  # int64 sample counter
    i: torch.Tensor  # int64 bounce counter
    alive: torch.Tensor
    out: torch.Tensor  # (4, n), or (6, n) adaptive
    segs: torch.Tensor  # (n,) int32

    def ctr(self, lanes: Lanes) -> torch.Tensor:
        """The draw counter of each lane's current bounce."""
        ctr0 = ((lanes.sample_offset + self.s) * lanes.dps) & rng.M32
        return (ctr0 + 4 + self.i * DRAWS_PER_BOUNCE) & rng.M32


def lane_setup(camera: torch.Tensor, pixel_map: torch.Tensor, seed: int,
               sample_offset: int, spp: int, width: int, height: int,
               opts: TraceOptions, budget, debug=None):
    """``(lanes, state)`` at the start of a chunk: each lane's first
    camera ray; a lane without budget is dead at launch."""
    dev = pixel_map.device
    f32 = torch.float32
    n = pixel_map.shape[0]
    pxi = pixel_map[:, 0].to(torch.int64)
    pyi = pixel_map[:, 1].to(torch.int64)
    gid = (pyi * padded_width(width) + pxi) & rng.M32
    lanes = Lanes(
        cam=list(camera.unbind(0)), px=pxi.to(f32), py=pyi.to(f32),
        pix=rng.lowbias32(gid ^ (int(seed) & rng.M32)),
        limit=spp if budget is None else budget.to(torch.int64),
        sample_offset=sample_offset,
        dps=4 + opts.max_depth * DRAWS_PER_BOUNCE,
        inv_w=1.0 / width, inv_h=1.0 / height, opts=opts,
        debug=overlay(opts, debug),
    )
    s = torch.zeros(n, dtype=torch.int64, device=dev)
    ray = _gen_ray(lanes.cam, s + sample_offset, lanes.px, lanes.py,
                   lanes.pix, lanes.inv_w, lanes.inv_h, lanes.dps,
                   lanes.stratified)
    one = torch.ones(n, dtype=f32, device=dev)
    state = PathState(
        *ray, one, one, one, s=s, i=torch.zeros_like(s),
        alive=s < lanes.limit,
        out=torch.zeros((6 if lanes.adaptive else 4, n), dtype=f32,
                        device=dev),
        segs=torch.zeros(n, dtype=torch.int32, device=dev),
    )
    return lanes, state


def bounce_tail(st: PathState, lanes: Lanes, win, bq: torch.Tensor,
                inv_a: torch.Tensor, ab: torch.Tensor,
                uuid: torch.Tensor | None = None) -> torch.Tensor:
    """The bounce tail for the lanes ``ab`` whose closest hit is known:
    best q ``bq`` (FILLQ on a miss) and the winner's parameters ``win`` =
    (center xyz, 1/r, mat, albedo rgb, fuzz, ior). Front-face normal;
    diffuse, metal or glass scatter; sky on a miss; Russian roulette;
    depth exhaustion; the contribution into ``st.out``; then the path goes
    on from the hit point, or the lane starts its next sample, or it has
    taken its samples and is done. With ``lanes.debug``, the overlay
    (cursor marker, then the outline of the sphere whose float32 ``uuid``
    is the selection) ends a marked lane's path with its fixed colour.
    Updates ``st`` and returns the lanes whose path goes on. The
    arithmetic and its order are the CUDA tail's (``csrc/common.cuh``
    ``bounce_tail``)."""
    opts = lanes.opts
    pix = lanes.pix
    ctr = st.ctr(lanes)
    ox, oy, oz, dx, dy, dz = st.ox, st.oy, st.oz, st.dx, st.dy, st.dz
    cr, cg, cb = st.cr, st.cg, st.cb
    zero = torch.zeros_like(ox)
    scx, scy, scz, inv_r, mat, al_r, al_g, al_b, fuzz, refr = win
    best_t = bq * inv_a
    hit = best_t < 1e20
    best_t = torch.where(hit, best_t, MAX_T)
    hpx = ox + best_t * dx
    hpy = oy + best_t * dy
    hpz = oz + best_t * dz
    nx = (hpx - scx) * inv_r
    ny = (hpy - scy) * inv_r
    nz = (hpz - scz) * inv_r
    front = rng.dot3(dx, dy, dz, nx, ny, nz) < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

    uvx, uvy, uvz = rng.unit_vec(pix, ctr, 0)
    usx, usy, usz = rng.unit_sphere(pix, ctr, 3)
    glass_u = rng.u01(pix, ctr, 6)
    if lanes.stratified:
        # a sample's first bounce: direction from (hx, phi) on the
        # unit sphere, not normalised again, and the glass roll
        s_u = (lanes.sample_offset + st.s) & rng.M32
        b0, b1, b2 = (
            rng.r2_fixed(pix, rng.ROT_BOUNCE0, d, s_u, AB0_FIX[d])
            for d in range(3)
        )
        b_hx = b0 * 2.0 - 1.0
        b_phi = b1 * rng.TWO_PI
        b_s = torch.sqrt(torch.clamp_min(1.0 - b_hx * b_hx, 0.0))
        first = st.i == 0
        uvx = torch.where(first, b_s * torch.sin(b_phi), uvx)
        uvy = torch.where(first, b_s * torch.cos(b_phi), uvy)
        uvz = torch.where(first, b_hx, uvz)
        glass_u = torch.where(first, b2, glass_u)

    ddx, ddy, ddz = nx + uvx, ny + uvy, nz + uvz
    if opts.near_zero_guard:
        nzm = ((torch.abs(ddx) < 1e-8) & (torch.abs(ddy) < 1e-8)
               & (torch.abs(ddz) < 1e-8))
        ddx = torch.where(nzm, nx, ddx)
        ddy = torch.where(nzm, ny, ddy)
        ddz = torch.where(nzm, nz, ddz)

    d_dot_n = rng.dot3(dx, dy, dz, nx, ny, nz)
    mdx = dx - 2.0 * d_dot_n * nx + fuzz * usx
    mdy = dy - 2.0 * d_dot_n * ny + fuzz * usy
    mdz = dz - 2.0 * d_dot_n * nz + fuzz * usz
    metal_ok = rng.dot3(nx, ny, nz, mdx, mdy, mdz) > 0.0

    ratio = torch.where(front, 1.0 / refr, refr)
    udx, udy, udz = rng.normalize3(dx, dy, dz)
    cos_t = torch.clamp_max(-rng.dot3(udx, udy, udz, nx, ny, nz), 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_m = 1.0 - cos_t
    one_m2 = one_m * one_m
    schlick = r0 + (1.0 - r0) * one_m2 * one_m2 * one_m
    reflects = cannot | (schlick > glass_u)
    rpx = ratio * (udx + cos_t * nx)
    rpy = ratio * (udy + cos_t * ny)
    rpz = ratio * (udz + cos_t * nz)
    kk = torch.clamp_min(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz), 0.0)
    sk = torch.sqrt(kk)
    ud_dot_n = rng.dot3(udx, udy, udz, nx, ny, nz)
    gdx = torch.where(reflects, udx - 2.0 * ud_dot_n * nx, rpx - sk * nx)
    gdy = torch.where(reflects, udy - 2.0 * ud_dot_n * ny, rpy - sk * ny)
    gdz = torch.where(reflects, udz - 2.0 * ud_dot_n * nz, rpz - sk * nz)

    is_diffuse = mat < 0.5
    is_metal = (mat >= 0.5) & (mat < 1.5)
    is_glass = (mat >= 1.5) & (mat < 2.5)
    ndx = torch.where(is_diffuse, ddx, torch.where(is_metal, mdx, gdx))
    ndy = torch.where(is_diffuse, ddy, torch.where(is_metal, mdy, gdy))
    ndz = torch.where(is_diffuse, ddz, torch.where(is_metal, mdz, gdz))
    did_scatter = is_diffuse | (is_metal & metal_ok) | is_glass

    miss = ab & ~hit
    scat = ab & hit & did_scatter
    sky_t = 0.5 * (udy + 1.0)
    con_r = torch.where(miss, cr * (1.0 - 0.5 * sky_t), zero)
    con_g = torch.where(miss, cg * (1.0 - 0.3 * sky_t), zero)
    con_b = torch.where(miss, cb, zero)
    if lanes.debug is not None:
        # the overlay: blue (0, 0, 1) within 0.1 of the cursor, else red
        # (1, 0, 0) on the selected sphere at grazing incidence; a marked
        # lane does not scatter
        cx, cy, cz, sel = lanes.debug
        dcx, dcy, dcz = hpx - cx, hpy - cy, hpz - cz
        cursor = ab & hit & (dcx * dcx + dcy * dcy + dcz * dcz < CURSOR_R2)
        outline = (ab & hit & ~cursor & (uuid == sel)
                   & (rng.dot3(dx, dy, dz, nx, ny, nz) > GRAZING))
        scat = scat & ~cursor & ~outline
        con_r = torch.where(outline, 1.0, con_r)
        con_b = torch.where(cursor, 1.0, con_b)

    cr = torch.where(scat, cr * al_r, cr)
    cg = torch.where(scat, cg * al_g, cg)
    cb = torch.where(scat, cb * al_b, cb)
    rr = opts.russian_roulette_depth
    if rr > 0:
        p_surv = torch.clamp(
            torch.maximum(cr, torch.maximum(cg, cb)), 0.05, 1.0
        )
        survive = (st.i < rr) | (rng.u01(pix, ctr, 7) < p_surv)
        boost = torch.where((st.i >= rr) & survive & scat, 1.0 / p_surv,
                            1.0)
        cr, cg, cb = cr * boost, cg * boost, cb * boost
        scat = scat & survive

    exhausted = scat & (st.i >= opts.max_depth - 1)
    if not opts.exhaust_black:
        con_r = torch.where(exhausted, cr, con_r)
        con_g = torch.where(exhausted, cg, con_g)
        con_b = torch.where(exhausted, cb, con_b)
    scat_cont = scat & ~exhausted
    out = st.out
    out[0] += con_r
    out[1] += con_g
    out[2] += con_b

    # regeneration: an ended path starts the lane's next sample
    done = ab & ~scat_cont
    if lanes.adaptive:
        # the sample's luminance is its contribution's mean, zero for
        # an absorbed or roulette-killed path
        lum = (con_r + con_g + con_b) * (1.0 / 3.0)
        out[4] += done.to(torch.float32)
        out[5] += lum * lum
    s = st.s + done.to(torch.int64)
    regen = done & (s < lanes.limit)
    nox, noy, noz, ndx2, ndy2, ndz2 = _gen_ray(
        lanes.cam, s + lanes.sample_offset, lanes.px, lanes.py, pix,
        lanes.inv_w, lanes.inv_h, lanes.dps, lanes.stratified
    )
    one = torch.ones_like(ox)
    st.ox = torch.where(regen, nox, torch.where(scat_cont, hpx, ox))
    st.oy = torch.where(regen, noy, torch.where(scat_cont, hpy, oy))
    st.oz = torch.where(regen, noz, torch.where(scat_cont, hpz, oz))
    st.dx = torch.where(regen, ndx2, torch.where(scat_cont, ndx, dx))
    st.dy = torch.where(regen, ndy2, torch.where(scat_cont, ndy, dy))
    st.dz = torch.where(regen, ndz2, torch.where(scat_cont, ndz, dz))
    st.cr = torch.where(regen, one, cr)
    st.cg = torch.where(regen, one, cg)
    st.cb = torch.where(regen, one, cb)
    st.i = torch.where(regen, 0, torch.where(scat_cont, st.i + 1, st.i))
    st.s = s
    # a lane whose bounce did not complete (mid-walk) stays alive
    st.alive = scat_cont | regen | (st.alive & ~ab)
    return scat_cont


def box_keys(ray, boxes: torch.Tensor, bits: int = 7) -> torch.Tensor:
    """(n, K) packed visit keys of each lane's ray (``ray`` = (ox, oy, oz,
    dx, dy, dz, a, o_dot_d, o_dot_o, min_t_a), each (n,)) against the
    (K, 6) ``boxes``: the slab test's entry q = t·|d|² with its ``bits``
    low bits floored, OR the box's index; a missed box's key is at least
    ``fill_floor(bits)``."""
    ox, oy, oz, dx, dy, dz, a, _, _, min_t_a = ray
    tn = tf = None
    for j, (o_, d_) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        iv = _col(_inv_dir(d_))
        t1 = (boxes[None, :, j] - _col(o_)) * iv
        t2 = (boxes[None, :, j + 3] - _col(o_)) * iv
        if tn is None:
            tn, tf = torch.minimum(t1, t2), torch.maximum(t1, t2)
        else:
            tn = torch.maximum(tn, torch.minimum(t1, t2))
            tf = torch.minimum(tf, torch.maximum(t1, t2))
    qn_q = torch.maximum(tn * _col(a), _col(min_t_a))
    hitb = (tf >= tn) & (tf * _col(a) >= _col(min_t_a)) & (qn_q < 1e20)
    qe = torch.where(hitb, qn_q, FILLQ)
    idx = torch.arange(boxes.shape[0], device=boxes.device,
                       dtype=torch.int32)
    return ((qe.view(torch.int32) & -(1 << bits)) | idx).view(torch.float32)


def select_two(keys: torch.Tensor, kl: torch.Tensor):
    """(m0, m1): each lane's two smallest keys beyond its cursor ``kl``,
    INFINITY where there are none."""
    inf = float("inf")
    if keys.shape[1] == 0:
        none = torch.full_like(kl, inf)
        return none, none.clone()
    m0 = torch.where(keys > _col(kl), keys, inf).min(dim=1).values
    m1 = torch.where(keys > _col(m0), keys, inf).min(dim=1).values
    return m0, m1


def cluster_walk_plain(tables: WalkTables, pixel_map: torch.Tensor,
                       seed: int, sample_offset: int, spp: int, width: int,
                       height: int, opts: TraceOptions,
                       budget: torch.Tensor | None = None,
                       debug: DebugParams | None = None):
    """The cluster walk as masked tensor code: every lane runs the same
    regeneration loop, one walk iteration per pass, ``while`` any lane is
    alive. The arithmetic and its order are the kernel's, the visit keys
    packed as the narrow or the wide walk packs them; on the motion
    walk's tables, the motion walk's (each lane's time from its sample,
    :func:`shutter_time`)."""
    dev = pixel_map.device
    f32 = torch.float32
    n = pixel_map.shape[0]
    n_global = tables.globals.shape[0]
    k, group = tables.members.shape[:2]
    bits = key_bits(k)
    floor = fill_floor(bits)
    motion = tables.motion
    glob = (list(tables.globals) if motion
            else [list(g.unbind(0)) for g in tables.globals])
    lanes, st = lane_setup(tables.camera, pixel_map, seed, sample_offset,
                           spp, width, height, opts, budget, debug)
    bq = torch.full((n,), FILLQ, dtype=f32, device=dev)
    bs = torch.zeros(n, dtype=torch.int64, device=dev)
    kl = torch.full((n,), NEG_BIG, dtype=f32, device=dev)

    while bool(st.alive.any()):
        alive = st.alive
        st.out[3] += alive.to(f32)
        ox, oy, oz, dx, dy, dz = st.ox, st.oy, st.oz, st.dx, st.dy, st.dz
        a = rng.dot3(dx, dy, dz, dx, dy, dz)
        inv_a = 1.0 / a
        o_dot_d = rng.dot3(ox, oy, oz, dx, dy, dz)
        o_dot_o = rng.dot3(ox, oy, oz, ox, oy, oz)
        min_t_a = MIN_T * a
        ray = (ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o, min_t_a)
        if motion:
            tm = shutter_time(lanes.pix, lanes.sample_offset + st.s)

        # a fresh bounce first tests the global spheres exactly
        fresh = kl < -1e38
        g_best = torch.full((n,), FILLQ, dtype=f32, device=dev)
        g_slot = torch.zeros(n, dtype=torch.int64, device=dev)
        for g in range(n_global):
            qg = (moving_q(glob[g], tm, *ray) if motion
                  else _exact_q(*glob[g], *ray))
            upd = qg < g_best
            g_best = torch.where(upd, qg, g_best)
            g_slot = torch.where(upd, g, g_slot)
        bq = torch.where(fresh, g_best, bq)
        bs = torch.where(fresh, g_slot, bs)

        # slab test of every cluster box, in q-space
        m0, m1 = select_two(box_keys(ray, tables.bounds, bits), kl)

        imm_done = (_key_floor(m0, bits) >= bq) | (m0 >= floor)
        u_live = alive & ~imm_done
        if k:  # a motion partition may hold only globals
            cidx = (m0.view(torch.int32) & ((1 << bits) - 1)).to(torch.int64)
            mem = tables.members[cidx]
            if motion:
                qm = moving_q(mem, _col(tm), *(_col(t) for t in ray))
            else:
                qm = _exact_q(mem[..., 0], mem[..., 1], mem[..., 2],
                              mem[..., 3], *(_col(t) for t in ray))
            qmin, mfirst = _first_min(qm)
            upd = u_live & (qmin < bq)
            bq = torch.where(upd, qmin, bq)
            bs = torch.where(upd, n_global + cidx * group + mfirst, bs)
        kl = torch.where(u_live, m0, kl)
        new_done = u_live & ((_key_floor(m1, bits) >= bq) | (m1 >= floor))
        bdone = imm_done | new_done
        ab = alive & bdone
        st.segs += ab.to(torch.int32)

        # the shared tail, for lanes whose bounce completed
        w = tables.winner[bs]
        win = (motion_winner(w, tm, bq, inv_a, st) if motion
               else [w[:, j] for j in range(10)])
        bounce_tail(st, lanes, win, bq, inv_a, ab, w[:, 10])
        bq = torch.where(ab, FILLQ, bq)
        bs = torch.where(ab, 0, bs)
        kl = torch.where(ab, NEG_BIG, kl)
    return st.out, st.segs
