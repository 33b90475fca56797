"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the port from ``raytracer_tpu_torch/csrc`` (one
``nvcc`` per source, started together): the cluster walk with its
adaptive, stratified and adaptive + stratified instantiations and its two
debug-overlay ones (random, stratified), and the flat scan with its eight
(unsplit K2 and split K2s, each fixed or adaptive, random or stratified)
and its two debug ones: sixteen; and the three probes' nine. Each
instantiation is held against its plain PyTorch version on the card, on
a crop and at the shapes, tables and depth of every path below that runs
it (the debug ones bitwise, and
bitwise equal to their non-debug twins where the overlay cannot fire).
Then it drives the port's paths through ``render_image``, the progressive
step and the interactive engine:

- the RTiOW cover (1200x800, 500 spp, depth 50) through the cluster walk:
  fixed spp with Russian roulette from bounce 5, then without; the same
  with the stratified sampler; the adaptive render (tolerance 0.2) with
  the stratified sampler, and with the random one;
- the demo at 1920x1080, 8 spp, through K2, K2s and the cluster walk,
  which must agree bit for bit;
- the cover through the flat scan (``cluster_scan=False``), split and
  unsplit;
- BASELINE configs 1-3 (two_sphere, three_sphere, dof) at ``bench.py``'s
  sizes, rr5;
- the realtime progressive step (demo, 1920x1080, 1 spp a frame, depth
  8, 256 frames in batches of 32 with one sync per batch) without hints
  (K2), with static hints (K2s), and with the stratified sampler, whose
  frames must equal the offline renders at their sample offsets;
- adaptive renders of the demo (tolerance 0.2) through the four adaptive
  flat instantiations;
- the interactive engine at the reference app's canvas cap (1280x720, 1
  spp a frame, depth 8) with the debug overlay on: the cover through the
  cluster walk and the demo through the flat scan, each with the random
  and the stratified sampler. Unpause, overlay on, a mouse move that picks
  the sphere at the centre, 128 frames in batches of 32 (the centre pixel
  exactly marker blue after each, an outline on the selected sphere's
  silhouette, no NaN), a paused 25-spp still saved to a PNG and decoded;
  the overlay off restarts the average and its next frame is the plain
  step's; fps with and without the overlay, ms per pick;
- the four AOV views at 1280x720 on the card against the port on the CPU;
- the card probes (``raytracer_tpu_torch/scripts/``, built from
  ``csrc/probe_chain.cu``, ``probe_gather.cu`` and ``probe_scan.cu``: two
  chains, three gather modes, four scan blocks), each instantiation first
  held bitwise against its plain version at the TPU's shape and at a
  card-filling one, then the probe A/B (``scripts/probe_ab.py``: the
  scan's four blocks and the one-hot product, redesigned for Hopper,
  against their base revision's builds, bitwise and timed in turns, with
  registers, spill bytes and SASS counts), then each probe's entry point
  at its script's trips, and the roofline: its float32 chain against the
  issue line (SMs x 128 x the highest SM clock, which fails the run
  unless the chain comes within 10 % of it) and the cover through the
  flat scan against both.

The wide walk (``RT_WALK_WIDE``: partitions of 129 to 512 clusters,
tables past shared memory): its six instantiations on the SPD
sphereflake (7,382 slots, 462 clusters, 512x512, depth 50) on a grid of
its pixels, and its adaptive ones on a sparse live set of the whole frame
(whole lanes), bitwise their plain versions (``walk_ab.flake_check``);
its counts of walk iterations and bounces those of its cost row and
segments; two whole sphereflake renders at 500 spp through
``render_image``, bitwise each other.

Then the entry points a user starts the renderer from, each through the
kernels:

- the CLI (``python -m raytracer_tpu_torch.app.cli``), each run in its
  own process: the cover rr5 (K1), the adaptive stratified cover with
  its spp map (K1a+K1s), the demo's 64 progressive frames (K2s), config
  1 (K2) and the normal AOV; every PNG byte for byte the PNG of the same
  call made in this process;
- the bench line (``python -m raytracer_tpu_torch.bench``) with
  ``BENCH_CONVERGENCE=golden`` and with ``BENCH_CONFIG=progressive``:
  ``bench.py``'s keys, the segments exactly a repeat's, the golden and
  adaptive bounds;
- the terminal viewer headless (320x180, 64 frames, the demo and the
  cover, ANSI and kitty frames);
- a real out-of-memory error in the engine's step and in
  ``render_image``: the engine's next frames bitwise a fresh engine's,
  the retried render bitwise the render without the fault;
- edited covers (a sphere removed and re-added, padding, a 63-slot cover
  grown to 64) bitwise their plain versions; an inactive slot never hit;
- the sharded paths (``raytracer_tpu_torch.parallel``), each mesh in its
  own spawned ranks: a (1, 1) NCCL mesh (the cover, the adaptive
  stratified cover, 64 progressive frames of the demo at 1920x1080)
  bitwise the same calls made in its process; four gloo ranks sharing the
  card, the cover on a (2, 2) mesh (golden, exact segments, the single
  render within the spp axis's regrouping, sorted bitwise unsorted) and
  the adaptive stratified cover on a (4,) mesh (golden, interleaved
  bitwise contiguous); three gloo ranks, a (3,) mesh's 64 progressive
  frames bitwise the single step's; and K1, K1a+K1s, K2 and K2s on a band
  of rows that starts mid-image, bitwise their plain versions.

Then the JAX package's names: ``render_image_pallas``
(``render/pallas_kernel.py``) on the full cover through K1, its image and
exact segments bitwise ``render_image``'s, both walls in turns;
``python -m raytracer_tpu_torch.entry`` in its own process, and
``entry()``'s step (the demo at 256x144, 1 spp, depth 8): bitwise a
directly built ``make_step_fn`` frame, K2 and no other kernel of the
renderer under the profiler, K2 bitwise its plain version on the step's
inputs, ms a frame.

Then the JAX package's jnp tracer, ``backend='jnp'`` (plain PyTorch on
the card: no kernel may launch on it): Threefry on the card bitwise the
CPU's; two_sphere, three_sphere, demo and dof at 64x36, 32 spp, against
the JAX package's goldens and the port on the CPU; the full-width cover
(1200x800, 487 spheres, depth 50, rr0) through its five bands against
the golden and the kernels' render, 8x8-box averaged; BENCH_CONVERGENCE=1
in its own process; the 1080p demo step with each sampler (no sync
inside a frame; the stratified average bitwise the offline renders'); the
CLI, the bench line and the viewer with ``--backend jnp`` in their own
processes and ``Engine(backend='jnp')`` with the overlay; and, in the
sharding phase's ranks, ``render_image_sharded`` (each band bitwise
``_render_shard``'s formed in this process) and the debug step.

The walk A/B (``raytracer_tpu_torch/scripts/walk_ab.py``): the cluster
walk's six instantiations and the flat scan's ten, each built from the
base revision's sources (the commit the tree is held against, unpacked
with ``git archive`` where the checkout has its history) and from this
one, held bitwise old against new at their paths' shapes and timed in
turns; each kernel's ``-Xptxas -v``, SASS loops and counter build (the
walk's SIMT efficiency and slab tests a bounce; the scan's SIMT of the
trip, the slot loop and the tail, live lanes a warp trip, roots a slot).

Every image is checked (the cover against the committed golden
``tests/goldens/cover_jnp_rr0_500spp_f16.npz``); each kernel is timed on
its path beside its operation bound (at the data sheet's float32 rate,
``bound_ms``, and at the issue line, ``issue_bound_ms``); one JSON line
carries the kernels' numbers. Launch counts are set to 0 just before each path and read just
after it. Any failed phase ends the run with a nonzero exit. The last
line of output is ``{"ok": true, "device": {...}}``.

Needs CUDA and one card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from raytracer_tpu_torch.utils.profiling import (
    bound_by,
    bound_pair,
    card_label,
    card_lines,
    flat_bound,
    issue_bound_ms,
    walk_bound,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "cover_jnp_rr0_500spp_f16.npz")
WALK_SOURCE = "raytracer_tpu_torch/csrc/cluster_walk.cu"
FLAT_SOURCE = "raytracer_tpu_torch/csrc/flat_scan.cu"

# kernel vs plain version on the card, same inputs (cover crop, 4 spp,
# depth 12): both round every operation alike (-fmad=false, the same
# libdevice), so only a transcendental that PyTorch evaluates another way
# can fork a path. Bounds: share of pixels off by more than 1e-3, mean
# |delta| of the rgb sums, relative difference of the segment totals.
CROP_W, CROP_H, CROP_SPP, CROP_DEPTH = 256, 128, 4, 12
CROP_OFFSET = 37  # the variants run at a nonzero sample offset
MAX_FORKED_SHARE = 0.005
MAX_MEAN_ABS = 1e-4
MAX_SEG_REL = 1e-3
# the same check at the main path's shapes: the full frame at its depth,
# with few samples so the plain version stays quick
FULL_W, FULL_H, FULL_SPP, FULL_DEPTH = 1200, 800, 1, 50

# the JAX package's 500-spp render measured mean|delta| 4.3e-3 against
# the same golden
GOLDEN_MAX_MAD = 6e-3
# the adaptive render at tolerance 0.2 against the same golden: the fixed
# render's distance (4.3e-3) plus the early stop's own error, which the JAX
# package's benchmark names as 4e-3 to 7e-3 against the fixed render of
# the same (stratified) sampler, so 8.3e-3 to 1.13e-2 in all; the random
# sampler's early-stop error is 1.3 to 1.6 times the stratified one's, so
# up to 1.55e-2. Each limit sits a third above its sum. (If every pixel
# stopped right at its threshold, a standard error of 0.1·mean, the gamma
# image would be off by about 2.9e-2: most pixels are far inside it when
# they reach the 64-sample minimum.)
ADAPTIVE_TOL = 0.2
ADAPTIVE_GOLDEN_MAX_MAD = {"stratified": 1.5e-2, "random": 2.0e-2}
ADAPTIVE_LAUNCHES = 17  # the cover's adaptive schedule: [4] + [31] * 16

PALLAS = "raytracer_tpu/render/pallas_kernel.py"
#: kernel name → (adaptive, stratified, file:line of the TPU kernel's branch)
KERNELS = {
    "cluster_walk": (False, False, f"{PALLAS}:216"),
    "cluster_walk_adaptive": (True, False, f"{PALLAS}:1300"),
    "cluster_walk_stratified": (False, True, f"{PALLAS}:366"),
    "cluster_walk_adaptive_stratified": (True, True, f"{PALLAS}:1316"),
}
#: flat-scan instantiation → (adaptive, stratified, split, file:line of the
#: TPU kernel's flat scan (K2) or split scan (K2s))
FLAT_KERNELS = {
    "flat_scan" + ("_split" if sp else "") + ("_adaptive" if a else "")
    + ("_stratified" if st else ""): (a, st, sp,
                                      f"{PALLAS}:{950 if sp else 890}")
    for sp in (False, True) for a in (False, True) for st in (False, True)
}

# the progressive step as bench.py drives it (BASELINE config 4)
PROG_W, PROG_H, PROG_DEPTH = 1920, 1080, 8
PROG_WARM, PROG_FRAMES, PROG_BATCH = 5, 256, 32
#: the debug overlay's instantiations → (flat, stratified); they replace
#: the overlay branch of the TPU kernel
DEBUG_KERNELS = {
    "cluster_walk_debug": (False, False),
    "cluster_walk_stratified_debug": (False, True),
    "flat_scan_debug": (True, False),
    "flat_scan_stratified_debug": (True, True),
}
DEBUG_REPLACES = f"{PALLAS}:1094"
# the interactive engine at the reference app's canvas cap
ENGINE_W, ENGINE_H, ENGINE_DEPTH = 1280, 720, 8
ENGINE_FRAMES = 128
#: the scene and kernel of each engine session
ENGINE_SCENES = {"cover": "cluster_walk", "demo": "flat_scan"}
# AOV views on the card against the port on the CPU (the CPU test's
# bounds against the JAX package; the same code on both devices)
AOV_MIN_EQUAL = 0.999  # uuid and front maps
AOV_MAX_DEPTH = 1e-5
AOV_NORMAL_SHARE, AOV_NORMAL_MAX = 0.70, 1e-2
# frames of the stratified session held against offline renders
STRAT_CHECK_FRAMES = 8
# K2, K2s and K1 on the demo (1920x1080, 8 spp, depth 8, rr0): the JAX
# package asserts them equal; share of pixels allowed to differ
CROSS_SPP = 8
MAX_CROSS_SHARE = 1e-4
# the accumulated random-sampler session (256 frames of 1 spp, each frame
# gamma-encoded before the running average) against the offline 256-spp
# render: the average of square roots sits below the square root of the
# average, and the two use different streams. Measured with the plain
# versions on the CPU (demo, 96x54): mean|delta| 8.26e-3 (signed
# -7.4e-3), where two offline seeds differ by 3.85e-3. Limit: 1.45x.
SESSION_MAX_MAD = 1.2e-2
# adaptive demo renders (128 spp, depth 8, rr5, tolerance 0.2) against the
# fixed render of the same options and seed: measured with the plain
# versions on the CPU (96x54) 3.76e-3 (random), 2.75e-3 (stratified),
# mean spp 68.6. Limit: 1.6x the random sampler's.
FLAT_ADAPTIVE_SPP = 128
FLAT_ADAPTIVE_MAX_MAD = 6e-3


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of ``fn`` over ``repeats`` runs after one warm-up,
    by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def phase_device():
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    smi = card_label(torch.device("cuda", 0))
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    """Every kernel source, the walk A/B's builds (the base revision's
    walk and flat scan, where the checkout has them, both counter builds
    and the flat scan's two form builds) and the probe A/B's (the base
    revision's two probes and their design builds), one nvcc each, all at
    once."""
    from raytracer_tpu_torch.scripts import probe_ab, walk_ab
    from raytracer_tpu_torch.utils import cuda_build

    from raytracer_tpu_torch.render import cluster_walk as cw

    names = ("cluster_walk", "flat_scan", *PROBE_SOURCES)
    old = walk_ab.parent_csrc()
    specs = ([(name, None, ()) for name in names]
             + [("cluster_walk", None, (cw.WIDE_DEFINE,))]
             + walk_ab.extra_builds(old) + probe_ab.extra_builds(old))
    t0 = time.perf_counter()
    cuda_build.build_all(specs)
    extra = [f"{name} {' '.join(d) or 'base revision'}"
             for name, _, d in specs[len(names):]]
    for line in cuda_build.build_log(
            "cluster_walk", (cw.WIDE_DEFINE,)).splitlines():
        if "registers" in line or "spill" in line or "nvcc took" in line:
            print("[ptxas cluster_walk wide]", line.strip())
    print(f"[build] {', '.join(names)} and the A/B's {', '.join(extra)} "
          f"at once: {time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "nvcc took" in line:
                print(f"[ptxas {name}]", line.strip())
            elif "Compiling" in line:
                # the mangled name carries the template arguments as Lb0E
                # / Lb1E / Li4E: adaptive, stratified, (split,) debug,
                # and the walk's box-mask words or the scan's form
                bits = re.findall(r"L[bi](\d+)E", line)
                keys = (("adaptive", "stratified", "debug", "mask words")
                        if name == "cluster_walk" else
                        ("adaptive", "stratified", "split", "debug",
                         "batched"))
                inst = (" <" + ", ".join(f"{k}={b}" for k, b in
                                        zip(keys, bits)) + ">"
                        if len(bits) == len(keys) else "")
                print(f"[ptxas {name}]", line.strip() + inst)


def trace_options(rr: int, depth: int, adaptive=False, stratified=False):
    from raytracer_tpu_torch.render.options import TraceOptions

    return TraceOptions(
        max_depth=depth, russian_roulette_depth=rr,
        adaptive_tolerance=ADAPTIVE_TOL if adaptive else 0.0,
        sampler="stratified" if stratified else "random",
    )


def walk_inputs(rr: int, width: int | None, height: int | None, depth,
                adaptive=False, stratified=False, group: int = 16):
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import tables
    from raytracer_tpu_torch.scene import presets

    scene, cam, *_ = presets.get_config("cover", width, height)
    opts = dataclasses.replace(trace_options(rr, depth, adaptive, stratified),
                               cluster_group=group)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), "cuda")
    return tabs, opts


def kernel_and_plain(flat: bool):
    """The wrapper (which launches the kernel on CUDA tensors) and the
    plain version of the cluster walk, or of the flat scan."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import flat_scan as fs

    if flat:
        return fs.flat_scan, fs.flat_scan_plain
    return cw.cluster_walk, cw.cluster_walk_plain


def reset_launch_counts():
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import flat_scan as fs

    cw.reset_launch_counts()
    fs.reset_launch_counts()


def launch_counts() -> dict:
    """Launches by kernel instantiation since the last reset."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import flat_scan as fs

    return {**cw.cluster_walk.launches_by_variant,
            **fs.flat_scan.launches_by_variant}


def compare(label: str, args, flat: bool = False) -> dict:
    """The kernel and its plain version on the same inputs; fails above
    the bounds."""
    kernel, plain = kernel_and_plain(flat)
    out_k, seg_k = kernel(*args)
    out_p, seg_p = plain(*args)
    torch.cuda.synchronize()
    d = (out_k[:3] - out_p[:3]).abs().amax(0)
    forked = float((d > 1e-3).float().mean())
    mad = float(d.mean())
    sk = int(seg_k.sum(dtype=torch.int64))
    sp = int(seg_p.sum(dtype=torch.int64))
    cost_eq = float((out_k[3] == out_p[3]).float().mean())
    bitwise = torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)
    print(f"[kernel vs plain {label}] max|d| {float(d.max()):.3e} "
          f"mean|d| {mad:.3e} forked {forked:.5f} bitwise "
          f"{float((d == 0).float().mean()):.5f} cost_equal {cost_eq:.5f} "
          f"segments kernel {sk} plain {sp} all rows bitwise {bitwise}")
    if not torch.isfinite(out_k).all():
        fail(f"kernel output is not finite ({label})")
    if (forked > MAX_FORKED_SHARE or mad > MAX_MEAN_ABS
            or abs(sk - sp) > MAX_SEG_REL * sp):
        fail(f"kernel disagrees with the plain version ({label})")
    return {"max_abs_err": float(d.max()), "out": out_k, "out_plain": out_p,
            "seg_lanes": seg_k, "segs": sk, "bitwise": bitwise}


def budgeted_map(launch, ident, spp: int, seed: int):
    """A sorted map and budget as the adaptive re-plans give them: lanes in
    descending cost of a profile chunk launched through ``launch(map,
    spp)``, 40 % of the pixels converged (budget 0, sorted last), the rest
    at the chunk's spp."""
    n = ident.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    converged = (torch.rand(n, generator=g) < 0.4).to(ident.device)
    prof, _ = launch(ident, spp)
    key = torch.where(converged, 3e38, -prof[3])
    order = torch.argsort(key, stable=True)
    budget = torch.where(converged, 0, spp)[order].to(torch.int32)
    return ident[order].contiguous(), budget.contiguous()


def check_budget(label: str, got: dict, budget) -> float:
    """An adaptive comparison's budget handling: sample counts equal to
    the budget in kernel and plain version, lanes without budget all
    zeros. Returns the largest difference of the sum of lum^2."""
    out, plain = got["out"], got["out_plain"]
    dead = budget == 0
    n_equal = (torch.equal(out[4], budget.float())
               and torch.equal(out[4], plain[4]))
    dead_zero = (not out[:, dead].any()
                 and not got["seg_lanes"][dead].any())
    l2 = float((out[5] - plain[5]).abs().max())
    print(f"[{label}] n equal {n_equal}, lanes without budget "
          f"{int(dead.sum())} all zero {dead_zero}, max|d| of sum lum^2 "
          f"{l2:.3e}")
    if not n_equal or not dead_zero or l2 > 1e-3:
        fail(f"{label}: budget handling disagrees")
    return l2


def phase_kernel_vs_plain() -> dict:
    """The kernel against its plain version: on the crop (rr5, rr0, a
    shuffled lane map against the identity, and the cover in clusters of
    8 and 4, past the one-word box mask), then at the main path's
    shapes (the full frame, depth 50, the cover's tables) with few
    samples, under the identity map of the profile chunk and the sorted
    map of the later chunks; and on the demo's partition at 1920x1080,
    depth 8, rr0, as the cross-kernel render runs it."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render.megakernel import (
        choose_kernel,
        plan_from_cost,
    )
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed

    seed = kernel_seed(7)
    n = CROP_W * CROP_H
    ident = cw.identity_map(CROP_W, CROP_H, "cuda")
    result = {"max_abs_err": 0.0}
    for rr in (5, 0):
        tabs, opts = walk_inputs(rr, CROP_W, CROP_H, CROP_DEPTH)
        args = (tabs, ident, seed, 0, CROP_SPP, CROP_W, CROP_H, opts)
        got = compare(f"crop rr{rr}", args)
        result["max_abs_err"] = max(result["max_abs_err"], got["max_abs_err"])
        if rr == 5:
            g = torch.Generator(device="cpu").manual_seed(1)
            perm = torch.randperm(n, generator=g).to("cuda")
            out_s, seg_s = cw.cluster_walk(tabs, ident[perm].contiguous(),
                                           seed, 0, CROP_SPP, CROP_W, CROP_H,
                                           opts)
            inv = torch.argsort(perm)
            same = torch.equal(out_s[:, inv], got["out"]) and int(
                seg_s.sum(dtype=torch.int64)) == got["segs"]
            print(f"[shuffled map vs identity] bitwise {same}")
            if not same:
                fail("shuffled lane map changed the kernel's result")
            result.update(crop_times(args, cw.variant_name(opts)))
    # past 32 clusters the walk takes its four-word box mask: the cover
    # in clusters of 8 and of 4
    for group in (8, 4):
        tabs, opts = walk_inputs(5, CROP_W, CROP_H, CROP_DEPTH, group=group)
        got = compare(f"crop rr5, {tabs.bounds.shape[0]} clusters",
                      (tabs, ident, seed, 0, CROP_SPP, CROP_W, CROP_H, opts))
        result["max_abs_err"] = max(result["max_abs_err"], got["max_abs_err"])
    for rr in (5, 0):
        tabs, opts = walk_inputs(rr, FULL_W, FULL_H, FULL_DEPTH)
        ident = cw.identity_map(FULL_W, FULL_H, "cuda")
        args = (tabs, ident, seed, 0, FULL_SPP, FULL_W, FULL_H, opts)
        got = compare(f"full frame rr{rr} identity map", args)
        result["max_abs_err"] = max(result["max_abs_err"], got["max_abs_err"])
        _, pmap = plan_from_cost(got["out"][3], FULL_W)
        args = (tabs, pmap, seed, FULL_SPP, FULL_SPP, FULL_W, FULL_H, opts)
        got = compare(f"full frame rr{rr} sorted map", args)
        result["max_abs_err"] = max(result["max_abs_err"], got["max_abs_err"])
    # the demo's own partition (cluster_scan=True), as the cross-kernel
    # render runs it
    scene, _, dcam = demo_inputs(PROG_W, PROG_H)
    opts = TraceOptions(max_depth=PROG_DEPTH, cluster_scan=True)
    choice = choose_kernel(scene, dcam, opts, "cuda")
    if choice.kernel != "cluster_walk":
        fail(f"cluster_scan=True on the demo took {choice}")
    args = (choice.tables, cw.identity_map(PROG_W, PROG_H, "cuda"), seed, 5,
            1, PROG_W, PROG_H, opts)
    got = compare(f"demo {PROG_W}x{PROG_H} d{PROG_DEPTH} rr0", args)
    result["max_abs_err"] = max(result["max_abs_err"], got["max_abs_err"])
    return result


def crop_times(args, name: str, flat: bool = False) -> dict:
    """Kernel and plain version timed on the crop's inputs."""
    kernel, plain = kernel_and_plain(flat)
    crop_ms = cuda_ms(lambda: kernel(*args), 3)
    t0 = time.perf_counter()
    plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"[crop {CROP_W}x{CROP_H} x{CROP_SPP} spp d{CROP_DEPTH} {name}] "
          f"kernel {crop_ms:.3f} ms, plain {plain_ms:.1f} ms")
    return {"crop_ms": crop_ms, "plain_ms": plain_ms}


def check_items(stratified: bool) -> None:
    """The adaptive walk's one-sample items (``walk_ab.item_cases``):
    on the cover's own re-planned launches (rr0, depth 50), with the
    live lanes' samples just under the item scratch (items) and just over
    it (whole lanes), with no live lane and one, and on a shuffled map
    whose budgets run from 0 to the chunk's, every output row and the
    segments bitwise the plain walk's
    (of the map's lanes with budget, zeros elsewhere), and the kernel's sample
    counts those of the items and of every lane."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.scripts import walk_ab
    from raytracer_tpu_torch.utils import profiling

    name = "cluster_walk_adaptive" + ("_stratified" if stratified else "")
    for case, args in walk_ab.item_cases(stratified).items():
        profiling.reset_counters()
        out_k, seg_k = cw.cluster_walk(*args)
        got = profiling.counters()
        out_p, seg_p = walk_ab.live_lanes_plain(args)
        bitwise = torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)
        items, every = walk_ab.expected_samples(args[8])
        counted = (got.get("walk_item_samples", (0, 0.0))[0],
                   got.get("walk_samples", (0, 0.0))[0])
        print(f"[items {name} {case}] live end "
              f"{int(cw.live_extent(args[8])[0])}, samples as items / all "
              f"{counted[0]} / {counted[1]} (expected {items} / {every}), "
              f"segments {int(seg_k.sum(dtype=torch.int64))}, all rows "
              f"bitwise {bitwise}")
        if not bitwise or counted != (items, every):
            fail(f"{name} {case}: the items disagree with the plain walk "
                 f"or with their counts")


def phase_variants_vs_plain() -> dict:
    """The stratified, adaptive and adaptive + stratified instantiations
    against the plain version at a nonzero sample offset: on the crop
    (rr5 and rr0), then at their paths' shapes (the full frame, depth 50,
    the cover's tables, rr5) with few samples. The adaptive ones run
    under a sorted map (descending cost of a profile chunk, converged
    pixels last) whose budget plane mixes 0 and the chunk's spp, as the
    re-plans give it. Sample counts must be equal and a lane without
    budget all zeros. Then the adaptive ones' items (:func:`check_items`)."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render.rng import kernel_seed

    seed = kernel_seed(7)
    shapes = (("crop", CROP_W, CROP_H, CROP_SPP, CROP_DEPTH, (5, 0)),
              ("full frame", FULL_W, FULL_H, FULL_SPP, FULL_DEPTH, (5,)))
    results = {}
    for name, (adaptive, stratified, _) in KERNELS.items():
        if name == "cluster_walk":
            continue
        result = {"max_abs_err": 0.0}
        for shape, w, h, spp, depth, rrs in shapes:
            ident = cw.identity_map(w, h, "cuda")
            for rr in rrs:
                tabs, opts = walk_inputs(rr, w, h, depth, adaptive,
                                         stratified)
                pmap, budget = ident, None
                if adaptive:
                    pmap, budget = budgeted_map(
                        lambda m, s: cw.cluster_walk(tabs, m, seed, 0, s, w,
                                                     h, opts),
                        ident, spp, 3)
                args = (tabs, pmap, seed, CROP_OFFSET, spp, w, h, opts,
                        budget)
                label = f"{name} {shape} rr{rr}"
                got = compare(label, args)
                result["max_abs_err"] = max(result["max_abs_err"],
                                            got["max_abs_err"])
                if adaptive:
                    result["max_abs_err"] = max(
                        result["max_abs_err"], check_budget(label, got, budget))
                if shape == "crop" and rr == 5:
                    result.update(crop_times(args, name))
        if adaptive:
            check_items(stratified)
        results[name] = result
    return results


def render_once(scene, cam, w, h, spp, seed, opts):
    from raytracer_tpu_torch.render.api import render_image

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, stats = render_image(scene, cam, w, h, spp, seed, opts,
                              return_stats=True)
    torch.cuda.synchronize()
    return img, stats, time.perf_counter() - t0


def drive_path(label: str, kernel: str, opts, smi: str, golden, timed_seeds,
               max_mad: float) -> dict:
    """One of the port's paths through ``render_image`` on the full
    cover: launch counts set to 0 just before the first render and read
    just after it, then timed repeats; the last image is held against the
    golden."""
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, _ = presets.get_config("cover")
    reset_launch_counts()
    first, first_stats, wall = render_once(scene, cam, w, h, spp, 0, opts)
    launches = launch_counts()
    print(f"[{label}] launches {launches} (first render, {wall:.3f} s)")
    if launches.get(kernel, 0) < 1 or set(launches) != {kernel}:
        fail(f"{label} did not run through {kernel} alone: {launches}")
    walls, img, stats = [], first, first_stats
    for seed in timed_seeds:
        img, stats, wall = render_once(scene, cam, w, h, spp, seed, opts)
        walls.append(wall)
    best = min(walls) if walls else wall
    segs = stats["segments_exact"]
    im = img.cpu().numpy().astype(np.float64)
    nan = int(np.isnan(im).any(-1).sum())
    mad = float(np.abs(im - golden).mean())
    print(f"[{label}] {w}x{h} {spp} spp d{opts.max_depth} wall "
          f"{' '.join(f'{x:.4f}' for x in walls or [wall])} s (best "
          f"{best:.4f}) segments {segs} Mrays/s {segs / best / 1e6:.2f} "
          f"golden mean|d| {mad:.3e} nan_pixels {nan} [{smi}]")
    if im.shape != golden.shape or nan or mad > max_mad:
        fail(f"{label} disagrees with the golden (mean|d| {mad}, limit "
             f"{max_mad}, nan pixels {nan})")
    return {"wall_s": best, "segments": segs, "mad": mad,
            "launches": launches[kernel], "depth": opts.max_depth,
            "first_image": first,
            "first_stats": first_stats, "image": img, "stats": stats}


def phase_main_paths(smi: str, golden) -> dict:
    """Every path of the port on the full cover, each through its own
    instantiation of the kernel."""
    from raytracer_tpu_torch.scene import presets

    w, h, spp, depth = presets.get_config("cover")[2:]
    paths = {}
    paths["cluster_walk"] = drive_path(
        "main path rr5", "cluster_walk", trace_options(5, depth), smi,
        golden, (1, 2), GOLDEN_MAX_MAD)
    paths["rr0"] = drive_path(
        "main path rr0", "cluster_walk", trace_options(0, depth), smi,
        golden, (), GOLDEN_MAX_MAD)
    strat = paths["cluster_walk_stratified"] = drive_path(
        "stratified fixed render rr5", "cluster_walk_stratified",
        trace_options(5, depth, stratified=True), smi, golden, (1,),
        GOLDEN_MAX_MAD)
    for kernel, stratified in (("cluster_walk_adaptive_stratified", True),
                               ("cluster_walk_adaptive", False)):
        label = ("adaptive companion (stratified)" if stratified
                 else "adaptive render (random sampler)")
        got = paths[kernel] = drive_path(
            label, kernel, trace_options(5, depth, True, stratified), smi,
            golden, (1, 2),
            ADAPTIVE_GOLDEN_MAX_MAD["stratified" if stratified else "random"])
        stats = got["first_stats"]
        spp_map = stats["spp_map"]
        lo, hi = float(spp_map.min()), float(spp_map.max())
        line = (f"[{label}] seed 0: mean_spp {stats['mean_spp']:.4f} = "
                f"{stats['mean_spp'] / spp:.4f} of {spp}, spp_map min "
                f"{lo:.0f} max {hi:.0f}, pixels at {spp} spp "
                f"{float((spp_map == spp).float().mean()):.4f}, launches "
                f"{got['launches']}, segments {stats['segments_exact']}")
        if stratified:
            d = (got["first_image"] - strat["first_image"]).abs().mean()
            line += (f", mean|d| vs the stratified fixed render of seed 0 "
                     f"{float(d):.3e}")
        print(line)
        if got["launches"] != ADAPTIVE_LAUNCHES:
            fail(f"{label}: {got['launches']} launches, expected "
                 f"{ADAPTIVE_LAUNCHES}")
        if not (64 <= stats["mean_spp"] < spp) or lo < 64 or hi > spp:
            fail(f"{label}: sample counts out of range (mean "
                 f"{stats['mean_spp']}, min {lo}, max {hi})")
        if spp_map.shape != (h, w) or not torch.equal(spp_map,
                                                      spp_map.round()):
            fail(f"{label}: spp_map is not an (H, W) map of whole counts")
    return paths


def event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class LaunchTimer:
    """CUDA events around every launch that ``render/megakernel.py`` makes
    through ``attr`` ('cluster_walk' or 'flat_scan'), with each launch's
    work (loop trips, segments, samples) summed on the device after its
    span; read with :meth:`results` after the render."""

    def __init__(self, attr: str):
        from raytracer_tpu_torch.render import megakernel

        self.module, self.attr = megakernel, attr
        self.real = getattr(megakernel, attr)
        self.records = []

    def __enter__(self):
        flat = self.attr == "flat_scan"

        def timed(tabs, pixel_map, seed, offset, spp, width, height, opts,
                  *rest):
            start = event()
            out, segs = self.real(tabs, pixel_map, seed, offset, spp, width,
                                  height, opts, *rest)
            end = event()
            n = pixel_map.shape[0]
            samples = (out[4].sum(dtype=torch.float64) if out.shape[0] == 6
                       else n * spp)
            self.records.append((start, end, tabs, rest[0] if flat else None,
                                 opts, n, out[3].sum(dtype=torch.float64),
                                 segs.sum(dtype=torch.int64), samples))
            return out, segs

        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)

    def results(self) -> list:
        """Per launch: ms, its (operations ms, bytes ms) bound, samples."""
        torch.cuda.synchronize()
        got = []
        for start, end, tabs, g_full, opts, n, iters, nsegs, samples in (
                self.records):
            adaptive = opts.adaptive_tolerance > 0.0
            stratified = opts.sampler == "stratified"
            samples, nsegs = float(samples), int(nsegs)
            if self.attr == "flat_scan":
                pair = flat_bound(tabs, g_full, adaptive, stratified, n,
                                  nsegs, samples, opts.enable_debug)
            else:
                pair = walk_bound(tabs, adaptive, stratified, n,
                                  float(iters), nsegs, samples,
                                  opts.enable_debug)
            got.append({"ms": start.elapsed_time(end), "bound": pair,
                        "samples": samples, "segments": nsegs, "lanes": n,
                        "kernel": f"{self.attr}_kernel<"})
        return got


def summarize_launches(recs: list, rows=()) -> dict:
    """Mean kernel ms and mean bound per launch, what binds it, and the
    share of the bound over all launches. The kernel's time is its device
    time under the profiler where ``rows`` (of :func:`device_profile`)
    have it: CUDA events around a launch also span the wrapper's host work
    whenever the device is waiting for the host. Else it is the events'."""
    n = len(recs)
    events = sum(r["ms"] for r in recs)
    profiled = sum(r[0] for r in rows if recs[0]["kernel"] in r[2])
    total = profiled or events
    bounds = [max(r["bound"]) for r in recs]
    issue = [issue_bound_ms(r["bound"], card_lines()["fp32"]) for r in recs]
    by = bound_by(sum(r["bound"][0] for r in recs),
                  sum(r["bound"][1] for r in recs))
    return {"ms": total / n, "events_ms": events / n,
            "timed_by": "profiler" if profiled else "CUDA events",
            "bound_ms": sum(bounds) / n, "bound_by": by,
            "share": sum(bounds) / total, "sum_ms": total, "n": n,
            "issue_bound_ms": sum(issue) / n,
            "issue_share": sum(issue) / total}


def phase_fixed_kernel_alone(smi: str, stratified: bool) -> dict:
    """One 153-spp sorted chunk at 1200x800, the fixed render's shape."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import schedule, tables
    from raytracer_tpu_torch.render.megakernel import plan_from_cost
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts = trace_options(5, depth, stratified=stratified)
    part = tables.cluster_partition(scene, opts)
    tabs = tables.walk_tables(part, derive_camera(cam), "cuda")
    chunk = schedule.pick_chunk_spp(spp, w * h, scene.count, depth, 5)
    sizes, _ = schedule.chunk_schedule(spp, chunk)
    seed = kernel_seed(0)
    out0, _ = cw.cluster_walk(tabs, cw.identity_map(w, h, "cuda"), seed, 0,
                              sizes[0], w, h, opts)
    # the profile chunk ran in identity order: lane order is pixel order
    _, pmap = plan_from_cost(out0[3], w)
    args = (tabs, pmap, seed, sizes[0], sizes[1], w, h, opts)
    out, segs = cw.cluster_walk(*args)
    ms = cuda_ms(lambda: cw.cluster_walk(*args), 3)
    iters = float(out[3].sum(dtype=torch.float64))
    nsegs = int(segs.sum(dtype=torch.int64))
    ops_ms, bytes_ms = walk_bound(tabs, False, stratified, w * h, iters,
                                  nsegs, w * h * sizes[1])
    bound_ms = max(ops_ms, bytes_ms)
    issue_ms = issue_bound_ms((ops_ms, bytes_ms), card_lines()["fp32"])
    print(f"[kernel alone {cw.variant_name(opts)}] {w}x{h} x{sizes[1]} spp "
          f"sorted chunk (schedule {sizes}): {ms:.3f} ms; walk iterations "
          f"{iters:.0f}, segments {nsegs}; bound {bound_ms:.4f} ms by "
          f"{bound_by(ops_ms, bytes_ms)} (bytes {bytes_ms:.4f} ms); share "
          f"of bound {bound_ms / ms:.4f}; at the issue line {issue_ms:.4f} "
          f"ms, share {issue_ms / ms:.4f} [{smi}]")
    return {"ms": ms, "bound_ms": bound_ms, "issue_bound_ms": issue_ms,
            "bound_by": bound_by(ops_ms, bytes_ms)}


def phase_walk_ab(smi: str) -> dict:
    """The walk against its base revision (``scripts/walk_ab.py``): the
    six instantiations at their paths' shapes (the adaptive ones on a
    launch of the cover's adaptive render where every lane has budget and
    on one of its tail), every output row and the segments bitwise equal,
    timed in turns; ``-Xptxas -v``, the SASS's loops, and the counter
    build's SIMT efficiency and slab tests. Then the flat scan's ten
    instantiations the same way, with their SASS loops and the flat
    counter build (SIMT of the trip, the slot loop and the tail, live
    lanes a warp trip, roots a slot), and its form sweep (each scan form
    on tables of 9-63 slots, bitwise, timed in turns). Without
    the base revision's sources (a checkout without history, and nothing
    unpacked under ``build/walk_parent``) the old builds are left out."""
    from raytracer_tpu_torch.scripts import walk_ab

    old = walk_ab.parent_csrc()
    if old is None:
        print("[walk A/B] the base revision's sources are not in this "
              "checkout: the new kernel alone, and its counters")
    else:
        print(f"[walk A/B] base revision {old.parent.parent.name}")
    got = walk_ab.run(old, WALK_AB_REPEATS, smi)
    got["flat"] = walk_ab.flat_ab(old, WALK_AB_REPEATS, smi)
    bad = [k for k, ok in {**got["bitwise"], **got["flat"]["bitwise"]}.items()
           if not ok]
    if bad:
        fail(f"a kernel disagrees with its base revision: {bad}")
    for name, c in {**got["counters"], **got["flat"]["counters"]}.items():
        if not (c["cost_row_equal"] and c["segs_equal"]):
            fail(f"{name}: the counter build's trips or tails disagree "
                 f"with its cost row or segments")
    for name, t in {**got["times"], **got["flat"]["times"]}.items():
        if "old" in t:
            print(f"[walk A/B {name}] old {min(t['old']):.3f} ms, new "
                  f"{min(t['new']):.3f} ms (best of {len(t['new'])} in "
                  f"turns), x{min(t['old']) / min(t['new']):.3f} [{smi}]")
    return got


def phase_wide_walk(smi: str) -> None:
    """The wide walk on the SPD sphereflake: every instantiation bitwise
    its plain version (``walk_ab.flake_check``), the base revision's build
    and its overflow build (``walk_ab.wide_ab``, with its counters), its
    iteration and bounce counts its cost row's and segments' sums, and
    two whole renders (512x512, 500 spp, depth 50) through
    ``render_image``, each launch the wide walk's, bitwise each other."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scripts import walk_ab
    from raytracer_tpu_torch.utils import profiling

    bad = [case for case, ok in walk_ab.flake_check().items() if not ok]
    if bad:
        fail(f"the wide walk disagrees with its plain version: {bad}")
    # the list against the base revision's sweep, the overflow build, and
    # the counters (slab tests, the list's high-water mark, sweeps)
    ab = walk_ab.wide_ab(walk_ab.parent_csrc(), WALK_AB_REPEATS, smi)
    bad = [case for case, ok in ab["bitwise"].items() if not ok]
    if bad:
        fail(f"the wide walk's builds disagree: {bad}")
    for name, c in ab["counters"].items():
        print(f"[wide counters {name}] slab tests a bounce "
              f"{c['slab_tests_per_bounce']:.2f}, list high-water mark "
              f"{c['list_peak_mean']:.2f} (most {c['list_peak_max']}), "
              f"swept {100 * c['sweep_share']:.4f} %, SIMT trip "
              f"{c['simt_trip']:.3f} visit {c['simt_visit']:.3f}")
        if not (c["cost_row_equal"] and c["segs_equal"]):
            fail(f"{name}: the wide counter build disagrees with its cost "
                 "row or segments")
        if name.startswith("list8") and not c["sweeps"]:
            fail(f"{name}: the overflow build swept no bounce")
    args = walk_ab.flake_cases()["cluster_walk"]
    profiling.reset_counters()
    out, segs = cw.cluster_walk(*args)
    got = profiling.counters()
    want = (int(out[3].sum(dtype=torch.float64)),
            int(segs.sum(dtype=torch.int64)))
    counted = (got.get("walk_iterations", (0, 0.0))[0],
               got.get("walk_segments", (0, 0.0))[0])
    print(f"[wide counts] iterations / bounces {counted} (cost row and "
          f"segments {want})")
    if counted != want:
        fail("the wide walk's counts disagree with its cost row or "
             "segments")
    scene = presets.sphereflake_scene().to("cuda")
    cam = presets.sphereflake_camera(512, 512)
    images = []
    for _ in range(2):
        reset_launch_counts()
        t0 = time.perf_counter()
        img, st = render_image(scene, cam, 512, 512, 500, 3,
                               TraceOptions(max_depth=50), None, True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(cw.cluster_walk.launches_by_variant)
        print(f"[wide render] 512x512 500 spp d50: {dt:.3f} s, segments "
              f"{st['segments_exact']}, launches {launches} [{smi}]")
        if set(launches) != {"cluster_walk_wide"}:
            fail(f"the sphereflake rendered through {launches}")
        images.append(img)
    if not torch.equal(images[0], images[1]):
        fail("two sphereflake renders of one key differ")


def phase_adaptive_alone(smi: str, stratified: bool) -> dict:
    """The adaptive render of seed 0 once more, with CUDA events around
    every kernel launch and every re-plan of its host loop: per-launch
    kernel times beside their bounds, and the re-plans' device time (two
    argsorts of 960,000 keys, the statistics and the gathers)."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import megakernel
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts = trace_options(5, depth, True, stratified)
    name = cw.variant_name(opts)
    plans = []
    real_plan = megakernel.plan_adaptive

    def timed_plan(*args, **kw):
        start = event()
        got = real_plan(*args, **kw)
        plans.append((start, event()))
        return got

    megakernel.plan_adaptive = timed_plan
    try:
        with LaunchTimer("cluster_walk") as timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_image(scene, cam, w, h, spp, 0, opts)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        megakernel.plan_adaptive = real_plan
    recs = timer.results()
    ms = [r["ms"] for r in recs]
    bounds = [max(r["bound"]) for r in recs]
    summary = summarize_launches(recs)
    plan_ms = [s.elapsed_time(e) for s, e in plans]
    samples = [r["samples"] / (w * h) for r in recs]
    print(f"[kernel alone {name}] {len(ms)} launches of one adaptive "
          f"render, wall {wall_ms:.3f} ms with the events: kernel ms per "
          f"launch {' '.join(f'{x:.3f}' for x in ms)} (sum {sum(ms):.3f}, "
          f"mean {summary['ms']:.3f}; the three launches that every "
          f"pixel takes {sum(ms[:3]):.3f} at "
          f"{sum(bounds[:3]) / sum(ms[:3]):.4f} of their bound, the rest "
          f"{sum(ms[3:]):.3f}); mean samples per pixel per launch "
          f"{' '.join(f'{x:.3f}' for x in samples)}; bound ms per "
          f"launch {' '.join(f'{b:.3f}' for b in bounds)} (mean "
          f"{summary['bound_ms']:.4f}, by {summary['bound_by']}); share of "
          f"bound {summary['share']:.4f} [{smi}]")
    print(f"[re-plan {name}] {len(plan_ms)} plans, device ms each "
          f"{' '.join(f'{x:.3f}' for x in plan_ms)} (sum "
          f"{sum(plan_ms):.3f} = {sum(plan_ms) / wall_ms:.4f} of the wall) "
          f"[{smi}]")
    if len(ms) != ADAPTIVE_LAUNCHES:
        fail(f"{name}: {len(ms)} launches in the timed render")
    return summary


def device_profile(fn):
    """``fn()`` under torch.profiler: (its result, wall ms, device-busy ms,
    rows of (device ms, count, name) in descending time, PyTorch operator
    calls on the host). Rows are empty where the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host_ops = [], 0
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            # an operator's device time is its kernels', which have rows
            # of their own
            host_ops += e.count
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return got, wall_ms, sum(r[0] for r in rows), rows, host_ops


def phase_where_time_goes(smi: str, label: str, opts):
    """One render under torch.profiler: device time by kernel, the
    device's busy share of the wall, and the host's partition + table
    build."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import tables
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, _ = presets.get_config("cover")
    t0 = time.perf_counter()
    tables.walk_tables(tables.cluster_partition(scene, opts),
                       derive_camera(cam), "cuda")
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    _, wall_ms, busy, rows, _ = device_profile(
        lambda: render_image(scene, cam, w, h, spp, 0, opts))
    walk = sum(r[0] for r in rows if "cluster_walk" in r[2])
    print(f"[where the time goes {label}] wall {wall_ms:.3f} ms under the "
          f"profiler; host partition + tables {setup_ms:.3f} ms; device "
          + (f"busy {busy:.3f} ms = {busy / wall_ms:.4f} of the wall, idle "
             f"{1 - busy / wall_ms:.4f}; cluster walk kernels {walk:.3f} "
             f"ms, everything else on the device {busy - walk:.3f} ms"
             if rows else "time not measured by the profiler")
          + f" [{smi}]")
    for ms, count, key in rows[:8]:
        print(f"  {ms:10.3f} ms  x{count:<4d} {key[:90]}")


def demo_inputs(width: int, height: int):
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.scene import presets

    scene, cam, *_ = presets.get_config("demo", width, height)
    return scene, cam, derive_camera(cam)


def flat_choice(name: str, scene, cam, opts, split: bool):
    """The kernel choice of ``render_image`` for ``scene``: fails unless it
    is the flat scan, split or not as ``split`` says."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import flat_scan as fs
    from raytracer_tpu_torch.render import megakernel

    choice = megakernel.choose_kernel(scene, derive_camera(cam), opts, "cuda")
    if (choice.kernel != "flat_scan"
            or fs.is_split(choice.tables, choice.g_full) != split):
        fail(f"{name}: the scene took {choice}")
    return choice


def compare_flat(result: dict, label: str, choice, pmap, budget, seed,
                 offset, spp, w, h, opts):
    """One flat-scan instantiation against its plain version, folded into
    ``result`` (largest error, all bitwise); returns the arguments and
    what :func:`compare` gives."""
    args = (choice.tables, pmap, seed, offset, spp, w, h, opts,
            choice.g_full, budget)
    got = compare(label, args, flat=True)
    result["max_abs_err"] = max(result["max_abs_err"], got["max_abs_err"])
    result["bitwise"] = result.get("bitwise", True) and got["bitwise"]
    if budget is not None:
        result["max_abs_err"] = max(result["max_abs_err"],
                                    check_budget(label, got, budget))
    return args, got


def phase_flat_vs_plain() -> dict:
    """Each flat-scan instantiation against its plain version, at a
    nonzero sample offset:

    - on the demo crop (depth 12, rr5 and rr0; K2s on the demo's own
      split, K2 with the split off; the adaptive ones under a sorted map
      whose budget mixes 0 and the chunk's spp);
    - all eight at the demo's 1920x1080, depth 8, 1 spp: rr0 for the fixed
      ones (the progressive sessions and the cross-kernel renders), rr5
      under a budgeted sorted map for the adaptive ones (the adaptive demo
      renders);
    - K2 and K2s on the cover's own tables (``cluster_scan=False``; K2s on
      its split of 487 slots) at 1200x800, depth 50, rr5, 1 spp, under the
      identity map of a profile chunk and the sorted map of the later ones;
    - K2 on BASELINE configs 1-3 at their sizes and depths, rr5, 1 spp,
      under the same two maps."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import flat_scan as fs
    from raytracer_tpu_torch.render.megakernel import plan_from_cost
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    seed = kernel_seed(7)
    shapes = (("crop", CROP_W, CROP_H, CROP_SPP, CROP_DEPTH, CROP_OFFSET),
              ("demo 1080p", PROG_W, PROG_H, 1, PROG_DEPTH, 5))
    results = {}
    for name, (adaptive, stratified, split, _) in FLAT_KERNELS.items():
        result = results[name] = {"max_abs_err": 0.0}
        for shape, w, h, spp, depth, offset in shapes:
            rrs = (5, 0) if shape == "crop" else (5,) if adaptive else (0,)
            scene, cam, _ = demo_inputs(w, h)
            ident = cw.identity_map(w, h, "cuda")
            for rr in rrs:
                opts = TraceOptions(
                    max_depth=depth, russian_roulette_depth=rr,
                    adaptive_tolerance=ADAPTIVE_TOL if adaptive else 0.0,
                    sampler="stratified" if stratified else "random",
                    split_scan=split)
                choice = flat_choice(name, scene, cam, opts, split)
                pmap, budget = ident, None
                if adaptive:
                    pmap, budget = budgeted_map(
                        lambda m, s: fs.flat_scan(choice.tables, m, seed, 0,
                                                  s, w, h, opts,
                                                  choice.g_full),
                        ident, spp, 3)
                args, _ = compare_flat(result, f"{name} {shape} rr{rr}",
                                       choice, pmap, budget, seed, offset,
                                       spp, w, h, opts)
                if shape == "crop" and rr == 5:
                    result.update(crop_times(args, name, flat=True))

    paths = (("cover", "flat_scan_split", dict(cluster_scan=False)),
             ("cover", "flat_scan", dict(cluster_scan=False,
                                         split_scan=False)),
             ("two_sphere", "flat_scan", {}),
             ("three_sphere", "flat_scan", {}),
             ("dof", "flat_scan", {}))
    for config, name, kw in paths:
        scene, cam, w, h, _, depth = presets.get_config(config)
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5, **kw)
        choice = flat_choice(name, scene, cam, opts, FLAT_KERNELS[name][2])
        label = (f"{name} {config} {w}x{h} d{opts.max_depth} rr5 "
                 f"({choice.tables.spheres.shape[0]} slots, g_full "
                 f"{choice.g_full})")
        _, got = compare_flat(results[name], f"{label} identity map", choice,
                              cw.identity_map(w, h, "cuda"), None, seed, 0,
                              1, w, h, opts)
        _, pmap = plan_from_cost(got["out"][3], w)
        compare_flat(results[name], f"{label} sorted map", choice, pmap,
                     None, seed, 1, 1, w, h, opts)
        del got, pmap
        torch.cuda.empty_cache()
    return results


def render_path(label: str, kernel: str, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; fails unless ``kernel`` alone ran."""
    reset_launch_counts()
    got = fn()
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches.get(kernel, 0) < 1 or set(launches) != {kernel}:
        fail(f"{label} did not run through {kernel} alone: {launches}")
    return got, launches[kernel]


def phase_cross_kernel(smi: str) -> dict:
    """The demo at 1920x1080, 8 spp, depth 8, rr0 through K2 (split off),
    K2s (its own split) and K1 (cluster_scan on): the same image and the
    same exact segments, as the JAX package asserts of its kernels."""
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions

    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    base = TraceOptions(max_depth=PROG_DEPTH)
    variants = (("flat_scan", TraceOptions(max_depth=PROG_DEPTH,
                                           split_scan=False)),
                ("flat_scan_split", base),
                ("cluster_walk", TraceOptions(max_depth=PROG_DEPTH,
                                              cluster_scan=True)))
    renders, launches = {}, {}
    for kernel, opts in variants:
        renders[kernel], launches[kernel] = render_path(
            f"cross-kernel {kernel}", kernel,
            lambda: render_image(scene, cam, PROG_W, PROG_H, CROSS_SPP, 0,
                                 opts, return_stats=True))
    ref, ref_stats = renders["flat_scan"]
    for kernel in ("flat_scan_split", "cluster_walk"):
        img, stats = renders[kernel]
        differ = float((img != ref).any(-1).float().mean())
        segs, ref_segs = stats["segments_exact"], ref_stats["segments_exact"]
        print(f"[cross-kernel demo {PROG_W}x{PROG_H} x{CROSS_SPP} spp "
              f"d{PROG_DEPTH} rr0] {kernel} vs flat_scan: pixels that "
              f"differ {differ:.7f}, max|d| {float((img - ref).abs().max()):.3e}"
              f", segments {segs} vs {ref_segs} ({segs == ref_segs}), "
              f"launches {launches[kernel]} [{smi}]")
        if (differ > MAX_CROSS_SHARE or not torch.isfinite(img).all()
                or abs(segs - ref_segs) > MAX_CROSS_SHARE * ref_segs):
            fail(f"cross-kernel: {kernel} disagrees with flat_scan")
    return launches


def phase_cover_flat(smi: str, golden) -> dict:
    """The cover through the flat scan (``cluster_scan=False``): its own
    split (K2s, 184 full-logic slots of 487), and with the split off (K2).
    Held against the golden; kernel time beside its operation bound."""
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    depth = presets.get_config("cover")[5]
    results = {}
    for kernel, split in (("flat_scan_split", True), ("flat_scan", False)):
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5,
                            cluster_scan=False, split_scan=split)
        label = f"cover through {kernel} rr5"
        with LaunchTimer("flat_scan") as timer:
            got = drive_path(label, kernel, opts, smi, golden, (),
                             GOLDEN_MAX_MAD)
        summary = summarize_launches(timer.results())
        print(f"[{label}] kernel {summary['sum_ms']:.3f} ms over "
              f"{summary['n']} launches = {summary['sum_ms'] / 1e3 / got['wall_s']:.4f}"
              f" of the wall; bound {summary['bound_ms'] * summary['n']:.3f}"
              f" ms by {summary['bound_by']}; share of bound "
              f"{summary['share']:.4f}; at the issue line "
              f"{summary['issue_bound_ms'] * summary['n']:.3f} ms, share "
              f"{summary['issue_share']:.4f} [{smi}]")
        results[kernel] = {**got, **summary}
    return results


def phase_baseline_configs(smi: str) -> dict:
    """BASELINE configs 1-3 at bench.py's sizes, spp and depth, rr5,
    through ``render_image``: a first render with the launch counts, then
    two timed repeats (seeds 1 and 2, best wall)."""
    from raytracer_tpu_torch.render import schedule
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    results = {}
    for config in ("two_sphere", "three_sphere", "dof"):
        scene, cam, w, h, spp, depth = presets.get_config(config)
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5)
        (img, stats, wall), launches = render_path(
            config, "flat_scan",
            lambda: render_once(scene, cam, w, h, spp, 0, opts))
        chunks = len(schedule.chunk_schedule(spp, schedule.pick_chunk_spp(
            spp, w * h, scene.count, depth, 5))[0])
        walls = []
        for seed in (1, 2):
            img, stats, wall = render_once(scene, cam, w, h, spp, seed, opts)
            walls.append(wall)
        best = min(walls)
        segs = stats["segments_exact"]
        nan = int(torch.isnan(img).any(-1).sum())
        print(f"[config {config}] {w}x{h} {spp} spp d{depth} rr5 through "
              f"flat_scan: launches {launches} (chunks {chunks}), wall "
              f"{' '.join(f'{x:.4f}' for x in walls)} s (best {best:.4f}), "
              f"segments {segs}, Mrays/s {segs / best / 1e6:.2f}, "
              f"nan_pixels {nan} [{smi}]")
        if (img.shape != (h, w, 3) or nan or not torch.isfinite(img).all()
                or launches != chunks or segs < w * h * spp):
            fail(f"config {config}: bad render")
        results[config] = {"wall_s": best, "segments": segs,
                           "launches": launches}
    return results


def run_batches(step, state, scene, cam, frames: int):
    """``frames`` steps in batches of PROG_BATCH, one sync per batch
    (reading the batch's last segment count, as bench.py does). Returns
    the state, the per-frame ms of each batch and the segments of each
    batch's last frame."""
    ms, segs = [], []
    done = 0
    while done < frames:
        n = min(PROG_BATCH, frames - done)
        t0 = time.perf_counter()
        for _ in range(n):
            state, aux = step(state, scene, cam)
        segs.append(int(aux["segments"]))
        ms.append((time.perf_counter() - t0) * 1e3 / n)
        done += n
    return state, ms, segs


def drive_session(label: str, kernel: str, opts, smi: str, hints: bool):
    """One progressive session as bench.py drives it: PROG_WARM warm-up
    frames on a throwaway state, then PROG_FRAMES frames of a fresh one
    (session key 0) in batches, with the launch counts set to 0 just before
    them and read just after. Then one more batch with CUDA events around
    every launch, and one under the profiler, on the throwaway state."""
    from raytracer_tpu_torch import init_render_state, make_step_fn

    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    kw = dict(static_scene=scene, static_camera=cam) if hints else {}
    step = make_step_fn(PROG_W, PROG_H, 1, opts, **kw)
    spare, _, _ = run_batches(step, init_render_state(PROG_W, PROG_H, 1),
                              scene, cam, PROG_WARM)
    (state, ms, segs), launches = render_path(
        label, kernel, lambda: run_batches(
            step, init_render_state(PROG_W, PROG_H, 0), scene, cam,
            PROG_FRAMES))
    if launches != PROG_FRAMES or state.frame != PROG_FRAMES:
        fail(f"{label}: {launches} launches for {PROG_FRAMES} frames")
    # host time to issue one step: the device may still be busy after
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spare, _ = step(spare, scene, cam)
    issue_ms = (time.perf_counter() - t0) * 1e3
    with LaunchTimer("flat_scan") as timer:
        _, wall_ms, busy, rows, host_ops = device_profile(
            lambda: run_batches(step, spare, scene, cam, PROG_BATCH))
    kern = summarize_launches(timer.results(), rows)
    best = min(ms)
    print(f"[{label}] {PROG_W}x{PROG_H} 1 spp/frame d{opts.max_depth}, "
          f"{PROG_FRAMES} frames in batches of {PROG_BATCH}: fps "
          f"{1e3 / best:.2f} (best batch {best:.4f} ms/frame; batches "
          f"{' '.join(f'{x:.3f}' for x in ms)}), segments per frame "
          f"{segs[-1]}, launches {launches}; kernel {kern['ms']:.4f} "
          f"ms/frame by {kern['timed_by']} (CUDA events "
          f"{kern['events_ms']:.4f}; bound {kern['bound_ms']:.4f} ms by "
          f"{kern['bound_by']}, share {kern['share']:.4f}); host issue of "
          f"one step {issue_ms:.3f} ms [{smi}]")
    print(f"[{label} where the time goes] one batch of {PROG_BATCH} under "
          f"the profiler: wall {wall_ms / PROG_BATCH:.4f} ms/frame, "
          f"{host_ops / PROG_BATCH:.1f} PyTorch operator calls a frame on "
          f"the host (nested ones too); device "
          + (f"busy {busy / PROG_BATCH:.4f} ms/frame = {busy / wall_ms:.4f} "
             f"of the wall, idle {1 - busy / wall_ms:.4f}; flat scan "
             f"{kern['sum_ms'] / PROG_BATCH:.4f} ms/frame, everything else "
             f"on the device (lane map, accumulation, finalize, running "
             f"average, table upload, segment sum) "
             f"{(busy - kern['sum_ms']) / PROG_BATCH:.4f} ms/frame"
             if rows else "time not measured by the profiler")
          + f" [{smi}]")
    for dev_ms, count, key in rows[:6]:
        print(f"  {dev_ms:10.3f} ms  x{count:<4d} {key[:90]}")
    if not torch.isfinite(state.accum).all():
        fail(f"{label}: the running average is not finite")
    return {"state": state, "fps": 1e3 / best, "ms_per_frame": best,
            "segments_per_frame": segs[-1], "launches": launches, **kern}


def phase_progressive(smi: str) -> dict:
    """This slice's main path, the realtime progressive step (demo,
    1920x1080, 1 spp a frame, depth 8): without hints (K2), with static
    hints (K2s), with the stratified sampler (K2); the hinted and hint-less
    sessions bitwise alike, the random session's average against the
    offline 256-spp render; then a hinted stratified session without
    averaging whose frames must equal the offline renders at their sample
    offsets (K2s)."""
    from raytracer_tpu_torch import (
        init_render_state,
        make_step_fn,
        render_image,
    )
    from raytracer_tpu_torch.render.options import TraceOptions

    random_opts = TraceOptions(max_depth=PROG_DEPTH)
    strat_opts = TraceOptions(max_depth=PROG_DEPTH, sampler="stratified")
    sessions = {
        "flat_scan": drive_session("progressive K2 (no hints)", "flat_scan",
                                   random_opts, smi, False),
        "flat_scan_split": drive_session(
            "progressive K2s (static hints)", "flat_scan_split", random_opts,
            smi, True),
        "flat_scan_stratified": drive_session(
            "progressive stratified K2 (no hints)", "flat_scan_stratified",
            strat_opts, smi, False),
    }
    plain_acc = sessions["flat_scan"]["state"].accum
    hinted_acc = sessions["flat_scan_split"]["state"].accum
    differ = float((plain_acc != hinted_acc).any(-1).float().mean())
    print(f"[progressive hinted vs hint-less] pixels that differ after "
          f"{PROG_FRAMES} frames {differ:.7f}")
    if differ > MAX_CROSS_SHARE:
        fail("progressive: the hinted session differs from the hint-less one")

    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    (offline, _), _ = render_path(
        "offline demo", "flat_scan_split",
        lambda: render_image(scene, cam, PROG_W, PROG_H, PROG_FRAMES, 0,
                             random_opts, return_stats=True))
    mad = float((plain_acc - offline).abs().mean())
    signed = float((plain_acc - offline).mean())
    print(f"[progressive random session vs offline {PROG_FRAMES} spp] "
          f"mean|d| {mad:.4e} (signed {signed:.4e}), limit "
          f"{SESSION_MAX_MAD} [{smi}]")
    if mad > SESSION_MAX_MAD or not torch.isfinite(offline).all():
        fail("progressive: the session's average is off the offline render")

    step = make_step_fn(PROG_W, PROG_H, 1, strat_opts, should_average=False,
                        static_scene=scene, static_camera=cam)
    kernel = "flat_scan_split_stratified"

    def frames_and_offline():
        state, equal = init_render_state(PROG_W, PROG_H, 0), []
        for i in range(STRAT_CHECK_FRAMES):
            state, _ = step(state, scene, cam)
            ref = render_image(scene, cam, PROG_W, PROG_H, 1, 0, strat_opts,
                               sample_offset=i)
            equal.append(torch.equal(state.accum, ref))
        return equal

    with LaunchTimer("flat_scan") as timer:
        (equal, launches), _, _, rows, _ = device_profile(
            lambda: render_path("stratified frames", kernel,
                                frames_and_offline))
    kern = summarize_launches(timer.results(), rows)
    print(f"[progressive stratified frames vs offline renders at "
          f"sample_offset i] {STRAT_CHECK_FRAMES} frames with static hints, "
          f"bitwise {equal}; launches {launches}; kernel "
          f"{kern['ms']:.4f} ms per launch by {kern['timed_by']} (events "
          f"{kern['events_ms']:.4f}; bound {kern['bound_ms']:.4f} ms, share "
          f"{kern['share']:.4f}) [{smi}]")
    if not all(equal):
        fail("progressive: a stratified frame differs from its offline "
             "render")
    sessions[kernel] = {"launches": launches, **kern}
    return sessions


def phase_flat_adaptive(smi: str) -> dict:
    """Adaptive renders of the demo (1920x1080, 128 spp, depth 8, rr5,
    tolerance 0.2) through the four adaptive flat instantiations, each
    held against the fixed render of the same options and seed."""
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions

    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    results = {}
    for name, (adaptive, stratified, split, _) in FLAT_KERNELS.items():
        if not adaptive:
            continue
        fixed = TraceOptions(max_depth=PROG_DEPTH, russian_roulette_depth=5,
                             sampler="stratified" if stratified else "random",
                             split_scan=split)
        opts = dataclasses.replace(fixed, adaptive_tolerance=ADAPTIVE_TOL)
        (img, stats, wall), launches = render_path(
            name, name, lambda: render_once(
                scene, cam, PROG_W, PROG_H, FLAT_ADAPTIVE_SPP, 0, opts))
        # the same render again, timed launch by launch
        with LaunchTimer("flat_scan") as timer:
            _, _, _, rows, _ = device_profile(lambda: render_image(
                scene, cam, PROG_W, PROG_H, FLAT_ADAPTIVE_SPP, 0, opts))
        kern = summarize_launches(timer.results(), rows)
        ref = render_image(scene, cam, PROG_W, PROG_H, FLAT_ADAPTIVE_SPP, 0,
                           fixed)
        mad = float((img - ref).abs().mean())
        spp_map = stats["spp_map"]
        print(f"[adaptive demo {name}] {PROG_W}x{PROG_H} up to "
              f"{FLAT_ADAPTIVE_SPP} spp d{PROG_DEPTH} rr5 tol {ADAPTIVE_TOL}:"
              f" wall {wall:.4f} s, launches {launches}, mean_spp "
              f"{stats['mean_spp']:.4f}, spp_map min "
              f"{float(spp_map.min()):.0f} max {float(spp_map.max()):.0f}, "
              f"segments {stats['segments_exact']}, mean|d| vs the fixed "
              f"render {mad:.4e} (limit {FLAT_ADAPTIVE_MAX_MAD}); kernel ms "
              f"per launch {kern['ms']:.4f} by {kern['timed_by']} (events "
              f"{kern['events_ms']:.4f}; sum {kern['sum_ms']:.3f}; bound "
              f"{kern['bound_ms']:.4f} by {kern['bound_by']}, share "
              f"{kern['share']:.4f}) [{smi}]")
        if (mad > FLAT_ADAPTIVE_MAX_MAD or not torch.isfinite(img).all()
                or not 64 <= stats["mean_spp"] < FLAT_ADAPTIVE_SPP
                or float(spp_map.min()) < 64):
            fail(f"adaptive demo {name}: bad render")
        results[name] = {"launches": launches, **kern}
    return results


def centre_pick(scene, cam):
    """The engine's pick at the centre of the view, on the card: the
    overlay's cursor on that surface and that sphere selected."""
    from raytracer_tpu_torch.interact.picking import update_cursor_state
    from raytracer_tpu_torch.render.options import DebugParams

    _, point, sel = update_cursor_state(scene.to("cuda"), cam)
    if sel == 1000:
        fail("the centre of the view hits nothing")
    return DebugParams(point, sel)


def marked_pixels(out, spp: int):
    """(marker pixels, outline-dominated pixels) of a chunk's lane sums:
    blue (0, 0, 1) in every sample, or red above green and blue by 0.2."""
    r, g, b = out[0] / spp, out[1] / spp, out[2] / spp
    blue = int(((b == 1.0) & (r == 0.0) & (g == 0.0)).sum())
    red = int(((r - torch.maximum(g, b)) > 0.2).sum())
    return blue, red


def phase_debug_vs_plain() -> dict:
    """The four debug instantiations against their plain versions,
    BITWISE, with the cursor on the sphere at the centre of the view and
    that sphere selected (the outline fires): on the crop (256x128, 4 spp,
    depth 12, rr5 and rr0; the cover's tables for the walk, the demo's for
    the flat scan) and at the engine's shapes (1280x720, 1 spp, depth 8,
    rr0). On the crop, with the cursor away and nothing selected, each is
    bitwise its non-debug twin."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import flat_scan as fs
    from raytracer_tpu_torch.render import megakernel
    from raytracer_tpu_torch.render.options import DebugParams, TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    seed = kernel_seed(7)
    shapes = (("crop", CROP_W, CROP_H, CROP_SPP, CROP_DEPTH, CROP_OFFSET,
               (5, 0)),
              ("engine", ENGINE_W, ENGINE_H, 1, ENGINE_DEPTH, 5, (0,)))
    away = DebugParams((1e4, 1e4, 1e4), 1000)
    results = {}
    for name, (flat, stratified) in DEBUG_KERNELS.items():
        result = results[name] = {"max_abs_err": 0.0}
        kernel = fs.flat_scan if flat else cw.cluster_walk
        for shape, w, h, spp, depth, offset, rrs in shapes:
            scene, cam, *_ = presets.get_config("demo" if flat else "cover",
                                                w, h)
            debug = centre_pick(scene, cam)
            for rr in rrs:
                opts = TraceOptions(
                    max_depth=depth, russian_roulette_depth=rr,
                    sampler="stratified" if stratified else "random",
                    enable_debug=True)
                choice = megakernel.choose_kernel(scene, derive_camera(cam),
                                                  opts, "cuda")
                got_name = (fs.variant_name(opts, choice.g_full is not None)
                            if flat else cw.variant_name(opts))
                if got_name != name or choice.kernel != (
                        "flat_scan" if flat else "cluster_walk"):
                    fail(f"{name}: the {shape} took {got_name}")
                head = (choice.tables, cw.identity_map(w, h, "cuda"), seed,
                        offset, spp, w, h)
                tail = (choice.g_full, None) if flat else (None,)
                label = f"{name} {shape} rr{rr}"
                got = compare(label, (*head, opts, *tail, debug), flat)
                blue, red = marked_pixels(got["out"], spp)
                print(f"[{label}] cursor {debug.cursor_point} selected "
                      f"{debug.selected_object}: marker pixels {blue}, "
                      f"outline-dominated pixels {red}")
                if not got["bitwise"]:
                    fail(f"{label}: not bitwise equal to the plain version")
                result["marked"] = [result.get("marked", [0, 0])[0] + blue,
                                    result.get("marked", [0, 0])[1] + red]
                result["max_abs_err"] = max(result["max_abs_err"],
                                            got["max_abs_err"])
                if shape != "crop" or rr != 5:
                    continue
                result.update(crop_times((*head, opts, *tail, debug), name,
                                         flat))
                plain = dataclasses.replace(opts, enable_debug=False)
                a = kernel(*head, opts, *tail, away)
                b = kernel(*head, plain, *tail)
                same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                print(f"[{label}] cursor away, nothing selected: bitwise "
                      f"the non-debug instantiation {same}")
                if not same:
                    fail(f"{label}: the overlay changed a frame it cannot "
                         "mark")
            del scene
        torch.cuda.empty_cache()
        if min(result["marked"]) == 0:
            fail(f"{name}: the overlay drew no marker or no outline "
                 f"(pixels {result['marked']})")
    return results


def uuid_map(scene, cam, w: int, h: int):
    """(H, W) sphere index at each pixel centre (-1 on a miss), on the
    card."""
    from raytracer_tpu_torch.camera.camera import (
        derive_camera,
        generate_rays,
        pixel_st_grid,
    )
    from raytracer_tpu_torch.render.tracer import hit_world

    ray = generate_rays(derive_camera(cam),
                        pixel_st_grid(w, h, device="cuda").reshape(-1, 2))
    return hit_world(ray.origin, ray.direction,
                     scene.to("cuda")).uuid.reshape(h, w)


def silhouette_red(fb, sel_mask) -> tuple:
    """(red-dominant pixels, those within 2 pixels of the selected
    sphere's silhouette)."""
    f = torch.nn.functional
    m = sel_mask.float()[None, None]
    grown = f.max_pool2d(m, 5, stride=1, padding=2)[0, 0] > 0
    shrunk = -f.max_pool2d(-m, 5, stride=1, padding=2)[0, 0] > 0
    red = (fb[..., 0] - torch.maximum(fb[..., 1], fb[..., 2])) > 0.2
    return int(red.sum()), int((red & grown & ~shrunk).sum())


def engine_batches(eng, now, frames: int, check=None):
    """``frames`` ticks in batches of PROG_BATCH, each timed to a sync;
    ``check(batch)`` after each. Returns the ms per frame of each batch.
    The ticks run with the sync debug mode raising on any call that waits
    for the device."""
    ms = []
    done = 0
    while done < frames:
        n = min(PROG_BATCH, frames - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(n):
                now[0] += 16.0
                if not eng.tick(now[0]):
                    fail("the engine skipped a frame")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / n)
        done += n
        if check is not None:
            check(len(ms))
    return ms


def profiled_batch(eng, now, attr: str):
    """One more batch of PROG_BATCH ticks under the profiler, with CUDA
    events around every launch: the kernel's time per frame."""
    with LaunchTimer(attr) as timer:
        _, wall_ms, busy, rows, host_ops = device_profile(
            lambda: engine_batches(eng, now, PROG_BATCH))
    return (summarize_launches(timer.results(), rows), wall_ms, busy, rows,
            host_ops)


def engine_session(smi: str, scene_name: str, kernel: str,
                   stratified: bool) -> dict:
    """One interactive session at 1280x720 with the overlay: see
    :func:`phase_engine`."""
    from raytracer_tpu_torch import Engine, init_render_state, make_step_fn
    from raytracer_tpu_torch.app import io
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    w, h = ENGINE_W, ENGINE_H
    name = kernel + ("_stratified" if stratified else "") + "_debug"
    plain_name = kernel + ("_stratified" if stratified else "")
    label = f"engine {scene_name} {w}x{h} d{ENGINE_DEPTH} " + (
        "stratified" if stratified else "random")
    scene, cam, *_ = presets.get_config(scene_name, w, h)
    sampler = "stratified" if stratified else "random"
    eng = Engine(scene, cam, w, h, max_depth=ENGINE_DEPTH, sampler=sampler)
    now = [0.0]
    eng.set_paused(False)
    eng.set_debugging(True)
    # a mouse move, and back: the pick lands on the sphere at the centre
    eng.handle_mouse_move(4.0, -3.0)
    eng.handle_mouse_move(-4.0, 3.0)
    sel = eng.app.selected_object
    if sel == 1000:
        fail(f"{label}: the pick hit nothing")
    now[0] += 16.0
    eng.tick(now[0])  # builds the step
    eng.set_debugging(False)
    eng.set_debugging(True)  # a fresh average for the counted frames
    # the pixel whose samples (jittered forward of its centre) cover the
    # centre of the view: every one hits within 0.1 of the cursor
    centre = (h // 2 - 1, w // 2 - 1)
    blue = torch.tensor([0.0, 0.0, 1.0], device="cuda")

    def centre_is_blue(batch):
        c = eng.render_state.accum[centre]
        if not bool((c == blue).all()):
            fail(f"{label}: centre pixel {c.tolist()} after batch {batch}, "
                 "not the marker's (0, 0, 1)")

    reset_launch_counts()
    ms = engine_batches(eng, now, ENGINE_FRAMES, centre_is_blue)
    launches = launch_counts()
    if launches != {name: ENGINE_FRAMES}:
        fail(f"{label}: launches {launches}, not {ENGINE_FRAMES} of {name}")
    fb = eng.render_state.accum
    total, on_edge = silhouette_red(fb, uuid_map(eng.scene, eng.camera, w, h)
                                    == sel)
    finite = bool(torch.isfinite(fb).all())
    print(f"[{label}] overlay on, cursor {eng.app.cursor_point} selected "
          f"{sel}: {ENGINE_FRAMES} frames, fps {1e3 / min(ms):.2f} (best "
          f"batch {min(ms):.4f} ms/frame; batches "
          f"{' '.join(f'{x:.3f}' for x in ms)}), launches {launches}; "
          f"centre pixel (0, 0, 1) after every batch; red-dominant pixels "
          f"{total}, on the selection's silhouette {on_edge}; finite "
          f"{finite}; no device sync inside a frame [{smi}]")
    if not finite or on_edge == 0:
        fail(f"{label}: bad overlay frame (finite {finite}, outline pixels "
             f"{on_edge})")
    kern_dbg, wall_ms, busy, rows, host_ops = profiled_batch(eng, now,
                                                             kernel)

    # picks: a one-pixel mouse move each, its read of the pick included
    pick_ms = []
    for i in range(16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.handle_mouse_move(1.0 if i % 2 == 0 else -1.0, 0.0)
        pick_ms.append((time.perf_counter() - t0) * 1e3)
    if eng.app.selected_object != sel:
        fail(f"{label}: the pick moved off sphere {sel}")

    # the paused 25-spp still, saved and decoded
    path = os.path.join(ROOT, "build", f"engine_{scene_name}_{sampler}.png")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    eng.set_paused(True)
    eng.request_save(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    now[0] += 16.0
    if not eng.tick(now[0]):
        fail(f"{label}: the paused still did not render")
    torch.cuda.synchronize()
    still_s = time.perf_counter() - t0
    # the save's own share of that tick: the same save once more, alone
    t0 = time.perf_counter()
    eng.save_image(path)
    save_s = time.perf_counter() - t0
    with open(path, "rb") as f:
        png = io.decode_png(f.read())
    want = io.tonemap_u8(eng.framebuffer())
    if png.shape != (h, w, 3) or not (png == want).all():
        fail(f"{label}: the saved still does not decode to the framebuffer")
    c = eng.render_state.accum[centre]
    if not bool((c == blue).all()):
        fail(f"{label}: the still's centre pixel {c.tolist()} is not the "
             f"marker's (cursor {eng.app.cursor_point})")

    # overlay off: the average restarts; the next frame is the plain step's
    eng.set_debugging(False)
    eng.set_paused(False)
    if eng.render_state.render_count != 0 or eng.app.render_count != 0:
        fail(f"{label}: turning the overlay off kept the average")
    frame = eng.render_state.frame
    now[0] += 16.0
    eng.tick(now[0])
    opts = TraceOptions(max_depth=ENGINE_DEPTH, sampler=sampler)
    step = make_step_fn(w, h, 1, opts, static_scene=eng.scene)
    state = dataclasses.replace(init_render_state(w, h, 0), frame=frame)
    state, _ = step(state, eng.scene, eng.camera)
    same = torch.equal(state.accum, eng.render_state.accum)
    reset_launch_counts()
    ms_off = engine_batches(eng, now, ENGINE_FRAMES)
    launches_off = launch_counts()
    kern_off = profiled_batch(eng, now, kernel)[0]
    print(f"[{label}] overlay off: next frame bitwise the plain step's "
          f"{same}; {ENGINE_FRAMES} frames, fps {1e3 / min(ms_off):.2f} "
          f"(best batch {min(ms_off):.4f} ms/frame), launches "
          f"{launches_off} [{smi}]")
    if not same or launches_off != {plain_name: ENGINE_FRAMES}:
        fail(f"{label}: the frame after the overlay is off is not the plain "
             "step's")
    print(f"[{label} kernels] {name} {kern_dbg['ms']:.4f} ms/frame by "
          f"{kern_dbg['timed_by']} (events {kern_dbg['events_ms']:.4f}; "
          f"bound {kern_dbg['bound_ms']:.4f} ms by {kern_dbg['bound_by']}, "
          f"share {kern_dbg['share']:.4f}); {plain_name} "
          f"{kern_off['ms']:.4f} ms/frame (bound {kern_off['bound_ms']:.4f})"
          f"; overlay cost {kern_dbg['ms'] / kern_off['ms']:.4f}x the "
          f"kernel; ms per pick with its sync {np.mean(pick_ms):.3f} (min "
          f"{min(pick_ms):.3f}); paused 25-spp still {still_s:.4f} s with its "
          f"PNG save, the save alone {save_s:.4f} s; one "
          f"profiled batch {wall_ms / PROG_BATCH:.4f} ms/frame of wall, "
          + (f"device busy {busy / PROG_BATCH:.4f} ms/frame = "
             f"{busy / wall_ms:.4f} of the wall, the kernel "
             f"{kern_dbg['sum_ms'] / PROG_BATCH:.4f}, everything else on "
             f"the device {(busy - kern_dbg['sum_ms']) / PROG_BATCH:.4f}"
             if rows else "device time not measured by the profiler")
          + f"; {host_ops / PROG_BATCH:.1f} PyTorch operator calls a frame "
          f"on the host [{smi}]")
    for dev_ms, count, key in rows[:6]:
        print(f"  {dev_ms:10.3f} ms  x{count:<4d} {key[:90]}")
    return {"launches": ENGINE_FRAMES, **kern_dbg,
            "fps": 1e3 / min(ms), "fps_off": 1e3 / min(ms_off),
            "pick_ms": float(np.mean(pick_ms)), "still_s": still_s,
            "save_s": save_s}


def phase_engine(smi: str) -> dict:
    """The interactive engine at 1280x720, 1 spp a frame, depth 8, with
    the overlay on: the cover (its static scene gets a cluster partition:
    K1 + debug) and the demo (9 spheres: K2 + debug, unsplit), each with
    the random and the stratified sampler. Unpause, overlay on, a mouse
    move that picks the sphere at the centre; 128 frames in batches of 32,
    no sync inside a frame, the centre pixel exactly (0, 0, 1) after each
    batch; red-dominant pixels on the selected sphere's silhouette; 16
    picks timed with their sync; a paused 25-spp still saved to a PNG and
    decoded; the overlay off restarts the average, the next frame is the
    plain step's bitwise, and 128 more frames give the fps without it."""
    results = {}
    for scene_name, kernel in ENGINE_SCENES.items():
        for stratified in (False, True):
            got = engine_session(smi, scene_name, kernel, stratified)
            name = kernel + ("_stratified" if stratified else "") + "_debug"
            results[name] = got
    return results


def phase_aov(smi: str):
    """The four AOV views at 1280x720 on the card against the port on the
    CPU: the demo in every mode, the cover's uuid map (the CPU takes about
    25 s a view of the cover). The bounds of the CPU tests against the JAX
    package."""
    from raytracer_tpu_torch.render.debug import AOV_MODES, render_aov
    from raytracer_tpu_torch.scene import presets

    w, h = ENGINE_W, ENGINE_H
    for scene_name, modes in (("demo", AOV_MODES), ("cover", ("uuid",))):
        scene, cam, *_ = presets.get_config(scene_name, w, h)
        for mode in modes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = render_aov(scene, cam, w, h, mode)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            cpu = render_aov(scene, cam, w, h, mode, device="cpu")
            d = (card.cpu() - cpu).abs().amax(-1)
            equal = float((d == 0).float().mean())
            close = float((d <= 1e-5).float().mean())
            print(f"[aov {scene_name} {mode} {w}x{h}] card {card_ms:.2f} ms; "
                  f"against the CPU: max|d| {float(d.max()):.3e}, equal "
                  f"{equal:.6f}, within 1e-5 {close:.6f} [{smi}]")
            ok = (equal >= AOV_MIN_EQUAL if mode in ("uuid", "front") else
                  float(d.max()) <= AOV_MAX_DEPTH if mode == "depth" else
                  close >= AOV_NORMAL_SHARE
                  and float(d.max()) <= AOV_NORMAL_MAX)
            if not ok or card.shape != (h, w, 3):
                fail(f"aov {scene_name} {mode}: the card and the CPU "
                     "disagree")


#: probe source → its file in the repo
PROBE_SOURCES = {name: f"raytracer_tpu_torch/csrc/{name}.cu"
                 for name in ("probe_chain", "probe_gather", "probe_scan")}
#: probe instantiation → (source, file:line of the TPU kernel's
#: pallas_call). The float chain serves two: the issue-rate probe (P3) and
#: the roofline's ceiling (P2), each counted on its own path; the axis-0
#: gather also serves P1b's axis-0 forms.
PROBE_KERNELS = {
    "probe_chain_f32": ("probe_chain", "scripts/bench_bf16_vpu.py:61"),
    "probe_chain_bf16": ("probe_chain", "scripts/bench_bf16_vpu.py:61"),
    "probe_chain_f32_roofline": ("probe_chain", "scripts/roofline.py:81"),
    "probe_gather_axis0": ("probe_gather",
                           "scripts/probe_mosaic_gather.py:89"),
    "probe_gather_onehot": ("probe_gather",
                            "scripts/probe_mosaic_gather.py:89"),
    "probe_gather_axis1": ("probe_gather",
                           "scripts/probe_mosaic_gather.py:133"),
    **{f"probe_scan_{b}": ("probe_scan", "scripts/bench_scan_layout.py:119")
       for b in (512, 64, 32, 8)},
}
#: the case of probe_gather.CASES each gather row reports
GATHER_ROW_CASE = {"axis0": "take_along_axis", "onehot": "onehot_matmul",
                   "axis1": "dynamic_gather(8, 128) axis=1"}
# kernel vs plain version on the card: the chains at few trips (a plain
# trip is 32 operator calls), the gathers at the script's 5000, the scans
# at few trips (a plain trip of the card-filling rays is 25 calls on
# 69M-element tensors). All bitwise: the same operations, each rounded on
# its own; sqrtf and torch.sqrt are both correctly rounded on the card.
PROBE_CHAIN_CHECK_ITERS = 40
PROBE_SCAN_CHECK_ITERS = {"tpu": 50, "fill": 5}
# the issue line the bounds are restated at (utils/profiling.py
# card_lines: SMs x 128 x the highest clock) holds when the card-filling
# float32 chain comes within this share of it; else the run fails
INSTR_LINE_TOLERANCE = 0.10
#: launches of each walk build per instantiation in the walk A/B, taken
#: in turns (old, new, new, old, ...)
WALK_AB_REPEATS = 6
#: launches of each probe build per case in the probe A/B, in turns
PROBE_AB_REPEATS = 4


def held(label: str, got: torch.Tensor, want: torch.Tensor):
    """Fails unless the kernel's output equals the plain version's bit for
    bit."""
    if got.shape != want.shape or not torch.equal(got, want):
        err = (float((got.float() - want.float()).abs().max())
               if got.shape == want.shape else float("inf"))
        fail(f"{label}: the kernel differs from its plain version (max "
             f"|delta| {err})")


def phase_probes_vs_plain() -> dict:
    """Every probe instantiation against its plain version on the card, at
    the TPU's shape and at the card-filling one: the chains (float32 and
    bf16), the gathers (every case of probe_mosaic_gather.py, one replica
    and the card-filling count) and the scans (every block), bitwise. The
    plain version's ms at the TPU's shape."""
    from raytracer_tpu_torch.scripts import bench_bf16_chain as bc
    from raytracer_tpu_torch.scripts import bench_scan_layout as bs
    from raytracer_tpu_torch.scripts import probe_gather as pg

    results = {}
    it = PROBE_CHAIN_CHECK_ITERS
    for dtype, name in bc.VARIANTS.items():
        for rows in (bc.TPU_ROWS, bc.FILL_ROWS):
            x = bc.chain_input(rows, dtype, "cuda")
            held(f"{name} ({rows},128) x{it}", bc.chain(x, it),
                 bc.chain_plain(x, it))
        x = bc.chain_input(bc.TPU_ROWS, dtype, "cuda")
        results[name] = {
            "max_abs_err": 0.0,
            "plain_ms": cuda_ms(lambda: bc.chain_plain(x, it), 3),
            "plain_shape": f"({bc.TPU_ROWS},128) x{it}"}
        print(f"[probe vs plain] {name}: bitwise at ({bc.TPU_ROWS},128) and "
              f"({bc.FILL_ROWS},128), {it} trips; plain "
              f"{results[name]['plain_ms']:.3f} ms")
    results["probe_chain_f32_roofline"] = results["probe_chain_f32"]
    for label, mode, shape, rows in pg.CASES:
        tbl = pg.gather_table(shape).cuda()
        reps = pg.fill_reps(mode, rows, shape[1])
        for r in (1, reps):
            held(f"{label} x{r}", pg.gather_probe(tbl, mode, rows, pg.ITERS,
                                                  r),
                 pg.gather_probe_plain(tbl, mode, rows, pg.ITERS, r))
        print(f"[probe vs plain] {label} ({pg.variant_name(mode)}): bitwise "
              f"at x1 and x{reps}, {pg.ITERS} trips")
        if GATHER_ROW_CASE[mode] == label:
            results[pg.variant_name(mode)] = {
                "max_abs_err": 0.0,
                "plain_ms": cuda_ms(lambda: pg.gather_probe_plain(
                    tbl, mode, rows, pg.ITERS), 1),
                "plain_shape": f"{shape} -> ({rows},{shape[1]}) x{pg.ITERS}"}
    sph = bs.scan_table().cuda()
    for block in bs.BLOCKS:
        name = bs.variant_name(block)
        for shape, rows in (("tpu", bs.R_SUB), ("fill", bs.FILL_ROWS)):
            n = PROBE_SCAN_CHECK_ITERS[shape]
            held(f"{name} ({rows},128) x{n}", bs.scan_probe(sph, block, rows,
                                                            n),
                 bs.scan_probe_plain(sph, block, rows, n))
        n = PROBE_SCAN_CHECK_ITERS["tpu"]
        results[name] = {
            "max_abs_err": 0.0,
            "plain_ms": cuda_ms(lambda: bs.scan_probe_plain(sph, block,
                                                            bs.R_SUB, n), 3),
            "plain_shape": f"({bs.R_SUB},128) x{n}"}
        print(f"[probe vs plain] {name}: bitwise at ({bs.R_SUB},128) x"
              f"{PROBE_SCAN_CHECK_ITERS['tpu']} and ({bs.FILL_ROWS},128) x"
              f"{PROBE_SCAN_CHECK_ITERS['fill']}; plain "
              f"{results[name]['plain_ms']:.3f} ms")
    return results


def phase_probe_ab(smi: str) -> dict:
    """The scan probe's four blocks and the one-hot product against their
    base revision (``scripts/probe_ab.py``): each build's registers,
    spill bytes and SASS counts (per slot and ray of the scan; the
    product's HMMAs), every build bitwise the current one (and the
    one-hot's odd trip count bitwise its plain version), times in turns.
    Fails on a disagreement, a spill in a current scan instantiation or a
    one-hot product without HMMA. Without the base revision's sources
    the old builds are left out."""
    from raytracer_tpu_torch.scripts import probe_ab, walk_ab

    old = walk_ab.parent_csrc()
    print("[probe A/B] " + ("the base revision's sources are not in this "
                            "checkout: the current builds alone"
                            if old is None else
                            f"base revision {old.parent.parent.name}"))
    got = probe_ab.run(old, PROBE_AB_REPEATS, smi)
    bad = probe_ab.failures(got)
    if bad:
        fail(f"probe A/B: {bad}")
    for name in probe_ab.SOURCES:
        for case, t in got[name]["times"].items():
            line = ", ".join(f"{b} {min(ts):.3f} ms" for b, ts in t.items())
            ratio = (f", old/new x{min(t['old']) / min(t['new']):.3f}"
                     if "old" in t else "")
            print(f"[probe A/B {case}] best of {len(t['new'])} in turns: "
                  f"{line}{ratio} [{smi}]")
    return got


def probe_bound(ops: float, nbytes: float, flop_peak: float, line: float,
                smem_words: float = 0.0) -> dict:
    """The bound of a probe launch: at the data sheet's rate
    (``bound_ms``, operations or device-memory bytes) and at the card's
    lines (``issue_bound_ms``, the largest of the operations at the
    instruction ``line``, the bytes and the shared-memory words at 32 an
    SM a clock; ``issue_bound_by`` names it, and the first and the last
    stand in ``issue_ops_ms`` and ``smem_bound_ms``)."""
    ops_ms, bytes_ms = bound_pair(ops, nbytes, flop_peak)
    terms = {"operations": ops / line * 1e3, "bytes": bytes_ms,
             "smem": smem_words / card_lines()["smem_words"] * 1e3}
    by = max(terms, key=terms.get)
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": bound_by(ops_ms, bytes_ms),
            "issue_bound_ms": terms[by], "issue_bound_by": by,
            "issue_ops_ms": terms["operations"],
            "smem_bound_ms": terms["smem"]}


def phase_probe_paths(smi: str) -> dict:
    """The probes' entry points as a user runs them, each with the launch
    counts set to 0 just before it and read just after: the chain
    (float32 and bf16 at 16 and 2112 rows), the gathers (the script's six
    cases, then card-filling replicas), the scans (every block at 8 rows
    and at 1056) and the roofline (its ceiling chain and the cover through
    the flat scan). The outputs are checked; per instantiation its
    launches, card-filling and TPU-shape times and its bounds."""
    from raytracer_tpu_torch.scripts import bench_bf16_chain as bc
    from raytracer_tpu_torch.scripts import bench_scan_layout as bs
    from raytracer_tpu_torch.scripts import probe_gather as pg
    from raytracer_tpu_torch.scripts import roofline
    from raytracer_tpu_torch.utils import profiling as pf

    rows = {}
    launches = {}
    bc.reset_launch_counts()
    chain = bc.main()
    launches.update(bc.chain.launches_by_variant)
    outs = [chain["rows"][r][t]["out"] for r in (bc.TPU_ROWS, bc.FILL_ROWS)
            for t in ("float32", "bfloat16")]
    if not all(torch.isfinite(o.float()).all() for o in outs):
        fail("chain: a non-finite output")
    f32, bf16 = outs[0], outs[1]
    if not (bool((f32 == f32[0, 0]).all())
            and bool((outs[2] == f32[0, 0]).all())):
        fail("chain: float32 elements differ, though every input is equal")
    if not (bool((bf16.float() == 2048.0).all())
            and bool((outs[3].float() == 2048.0).all())):
        fail("chain: a bf16 chain did not stop at 256 (sum 2048)")
    for dtype, name in bc.VARIANTS.items():
        key = str(dtype).removeprefix("torch.")
        fill, tpu = (chain["rows"][r][key] for r in (bc.FILL_ROWS,
                                                      bc.TPU_ROWS))
        n = bc.FILL_ROWS * bc.LANES
        elt = 4 if dtype == torch.float32 else 2
        peak, line = ((pf.FP32_FLOP_PEAK, card_lines()["fp32"])
                      if dtype == torch.float32 else
                      (pf.BF16_FLOP_PEAK, card_lines()["bf16"]))
        rows[name] = {
            "ms": fill["seconds"] * 1e3, "tpu_shape_ms": tpu["seconds"] * 1e3,
            "rate_telops": fill["rate"] / 1e12,
            "tpu_shape_rate_telops": tpu["rate"] / 1e12,
            "shape": f"({bc.FILL_ROWS},128) x{bc.ITERS}",
            **probe_bound(bc.chain_ops(bc.FILL_ROWS, bc.ITERS),
                          (bc.CHAINS + 1) * n * elt, peak, line)}
    print(f"[probe chain] bf16/float32 at ({bc.FILL_ROWS},128): "
          f"{chain['rows'][bc.FILL_ROWS]['ratio']:.4f} [{smi}]")

    pg.reset_launch_counts()
    gather = pg.main()
    launches.update(pg.gather_probe.launches_by_variant)
    for label, mode, shape, r in pg.CASES:
        case = gather["cases"][label]
        tbl = pg.gather_table(shape)
        want = pg.gather_probe_plain(tbl, mode, r, pg.ITERS)[0]
        for kind in ("tpu", "fill", "library"):
            if not torch.equal(case[kind]["out"], want):
                fail(f"gather {label} ({kind}): the main path's output "
                     "differs from the plain version")
        fill, reps, lib = case["fill"], case["fill"]["reps"], case["library"]
        print(f"[probe gather] {label}: kernel "
              f"{case['tpu']['ns_per_gather']:.1f} ns per gather alone, "
              f"{fill['ns_per_gather']:.3f} ns with {reps} replicas "
              f"({fill['seconds'] * 1e3:.3f} ms); torch.gather doing the "
              f"same work (one call a trip over the replicas, summed trip "
              f"by trip) {lib['ns_per_gather']:.3f} ns per gather "
              f"({lib['seconds'] * 1e3:.3f} ms) [{smi}]")
        if GATHER_ROW_CASE[mode] != label:
            continue
        elements = reps * r * shape[1]
        nbytes = 4 * (shape[0] * shape[1] + elements)
        # every mode reads one shared-memory word a lane and trip, or one
        # broadcast a warp; the one-hot row is bounded by the gather of
        # column 0 it reproduces, its own scan's bound (a broadcast per
        # table row) beside it
        func = "axis0" if mode == "onehot" else mode
        bound = probe_bound(
            pg.probe_ops(func, shape[0], r, shape[1], pg.ITERS, reps),
            nbytes, pf.FP32_FLOP_PEAK, card_lines()["fp32"],
            elements * pg.ITERS)
        if mode == "onehot":
            # beside it, what the product issues: its MMAs at the data
            # sheet's dense bf16 rate, and its CUDA-core side (the
            # one-hot's words and the pieces' sums) at the issue line
            mma = pg.mma_account(shape[0], r, shape[1], pg.ITERS, reps)
            bound["tensor_bound_ms"] = mma["flop"] / pf.BF16_TC_PEAK * 1e3
            bound["cuda_core_bound_ms"] = (mma["cuda_core_ops"]
                                           / card_lines()["fp32"] * 1e3)
        print(f"[probe gather] {pg.variant_name(mode)} x{reps}: "
              f"{fill['seconds'] * 1e3:.3f} ms, bound "
              f"{bound['issue_bound_ms']:.3f} ms by "
              f"{bound['issue_bound_by']} (operations "
              f"{bound['issue_ops_ms']:.3f} ms, smem "
              f"{bound['smem_bound_ms']:.3f} ms), share "
              f"{bound['issue_bound_ms'] / (fill['seconds'] * 1e3):.4f}"
              + (f"; its MMAs at the tensor cores' bf16 rate "
                 f"{bound['tensor_bound_ms']:.3f} ms, its CUDA-core side "
                 f"at the issue line {bound['cuda_core_bound_ms']:.3f} ms"
                 if mode == "onehot" else "") + f" [{smi}]")
        rows[pg.variant_name(mode)] = {
            "ms": fill["seconds"] * 1e3,
            "tpu_shape_ms": case["tpu"]["seconds"] * 1e3,
            "ns_per_gather": case["tpu"]["ns_per_gather"],
            "fill_ns_per_gather": fill["ns_per_gather"],
            # torch.gather doing the same work as "ms": every trip's
            # gathers of every replica, summed trip by trip
            "library_ns_per_gather": lib["ns_per_gather"],
            "library_ms": lib["seconds"] * 1e3,
            "shape": f"{shape} -> {reps}x({r},{shape[1]}) x{pg.ITERS}",
            **bound}

    bs.reset_launch_counts()
    scan = bs.main()
    launches.update(bs.scan_probe.launches_by_variant)
    for kind in ("tpu", "fill"):
        got = [b[kind]["out"] for b in scan["blocks"].values()]
        if not all(torch.isfinite(o).all() for o in got):
            fail(f"scan ({kind}): a non-finite output")
        if not all(torch.equal(got[0], o) for o in got[1:]):
            fail(f"scan ({kind}): the blocks disagree")
    for label, b in scan["blocks"].items():
        fill_rows, fill_iters = bs.FILL_ROWS, bs.FILL_ITERS
        rows[bs.variant_name(b["block"])] = {
            "ms": b["fill"]["seconds"] * 1e3,
            "tpu_shape_ms": b["tpu"]["seconds"] * 1e3,
            "ns_per_strip_iter": b["tpu"]["ns_per_strip_iter"],
            "slot_tests_per_s": b["fill"]["slot_tests"],
            "shape": f"({fill_rows},128) x{fill_iters}, {bs.S} slots",
            # a slot is one broadcast a warp: a lane's word of the SM's 32
            **probe_bound(bs.probe_ops(bs.S, fill_rows, fill_iters),
                          bs.S * 16 + fill_rows * bs.LANES * 4,
                          pf.FP32_FLOP_PEAK, card_lines()["fp32"],
                          bs.S * fill_rows * bs.LANES * fill_iters)}

    bc.reset_launch_counts()
    roof = roofline.main()
    launches["probe_chain_f32_roofline"] = bc.chain.launches_by_variant.get(
        "probe_chain_f32", 0)
    chain_ms = (bc.elem_ops(bc.FILL_ROWS, bc.ITERS)
                / (roof["chain_telops"] * 1e12) * 1e3)
    rows["probe_chain_f32_roofline"] = {
        **rows["probe_chain_f32"], "ms": chain_ms,
        "rate_telops": roof["chain_telops"], "tpu_shape_ms": None,
        "tpu_shape_rate_telops": None}
    near = abs(roof["chain_telops"] / roof["issue_line_telops"] - 1.0)
    print(f"[roofline] the float32 chain at {roof['chain_telops']:.4f} "
          f"Telem-ops/s is {roof['chain_telops'] / roof['issue_line_telops']:.4f}"
          f" of the issue line ({roof['issue_line_telops']:.4f} T) and "
          f"{roof['chain_telops'] / roof['fp32_flop_peak_telops']:.4f} of "
          f"67e12; the cover-flat render at "
          f"{roof['share_of_issue_line']:.4f} of the issue line, "
          f"{roof['share_of_chain']:.4f} of the chain [{smi}]")
    if near > INSTR_LINE_TOLERANCE:
        fail(f"roofline: the float32 chain is {near:.1%} off the issue line "
             f"the bounds are restated at (at most "
             f"{INSTR_LINE_TOLERANCE:.0%})")
    if not (np.isfinite(roof["cover_mrays"]) and roof["segments"] > 0):
        fail("roofline: no cover render")
    for name in PROBE_KERNELS:
        rows[name]["launches"] = launches.get(name, 0)
        if rows[name]["launches"] < 1:
            fail(f"{name}: no launch on the probes' paths")
    return rows


# --- the entry points users start the renderer from ----------------------

#: each CLI run (its flags, the in-process call it must equal byte for
#: byte, and the kernel the in-process call launches)
CLI_RUNS = {
    "cover rr5": (["--config", "cover", "--russian-roulette", "5"],
                  "cluster_walk"),
    "cover adaptive": (["--config", "cover", "--russian-roulette", "5",
                        "--sampler", "stratified", "--adaptive", "0.2"],
                       "cluster_walk_adaptive_stratified"),
    "demo progressive": (["--config", "demo", "--progressive-frames", "64"],
                         "flat_scan_split"),
    "two_sphere": (["--config", "two_sphere"], "flat_scan"),
    "aov normal": (["--aov", "normal"], None),
}
#: the keys bench.py's cover line builds with BENCH_CONVERGENCE=golden
#: and the default knobs (bench.py:316-328, :331-360, :405-419, :448-488)
BENCH_COVER_KEYS = {
    "metric", "value", "unit", "vs_baseline", "wall_s", "segments",
    "backend", "device", "rr0_mrays", "rr0_wall_s", "adaptive_tol",
    "adaptive_sampler", "adaptive_wall_s", "adaptive_mean_spp",
    "adaptive_mad_vs_fixed", "convergence_mad_vs_golden",
    "convergence_nan_px", "adaptive_golden_mad",
}
#: bench.py's progressive line (bench.py:137-148)
BENCH_PROGRESSIVE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "ms_per_frame", "frames",
    "segments_per_frame", "backend",
}
# the bench line's adaptive companion (tolerance 0.2, stratified, at key
# fold_in(0, i)) against the fixed stratified render at key 0: measured
# 5.56e-3 on an H100 80GB HBM3 at 700 W (two independent streams and the
# early stop); the limit is about 1.5 times that.
BENCH_ADAPTIVE_MAX_MAD = 8.5e-3
VIEWER_W, VIEWER_H, VIEWER_FRAMES = 320, 180, 64
OOM_WARM_FRAMES, OOM_AFTER_FRAMES = 8, 32
#: slots added to the cover by ``pad_to``, and the thinned cover's size
EDIT_PAD, THIN_SLOTS = 37, 63


def start_module(args, env=None):
    """``python -m`` ``args`` started from the checkout's root; returns
    the process and its start time."""
    return (subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                             env={**os.environ, **(env or {})},
                             stdin=subprocess.DEVNULL,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True), time.perf_counter())


def finish_module(started, label: str):
    """Waits for a :func:`start_module` process; fails on a non-zero
    exit. Returns its stdout, stderr and wall in s."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}\n{out[-2000:]}\n"
             f"{err[-4000:]}")
    return out, err, wall


def cli_in_process(flags):
    """The image (and spp map) the CLI's call with ``flags`` renders, by
    the same functions in this process, as PNG bytes."""
    from raytracer_tpu_torch.app import cli, io
    from raytracer_tpu_torch.progressive.state import init_render_state
    from raytracer_tpu_torch.progressive.step import make_step_fn, run_frames
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.debug import render_aov
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    a = cli.build_parser().parse_args(flags)
    scene, cam, w, h, spp, depth = presets.get_config(a.config, a.width,
                                                      a.height)
    spp = a.spp if a.spp is not None else spp
    depth = a.max_depth if a.max_depth is not None else depth
    if a.aov:
        return io.encode_png(render_aov(scene, cam, w, h, a.aov,
                                        device=a.device).cpu().numpy()), None
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=(
        a.russian_roulette), adaptive_tolerance=a.adaptive,
        sampler=a.sampler, backend=a.backend)
    if a.progressive_frames:
        step = make_step_fn(w, h, spp=spp, opts=opts, static_scene=scene,
                            static_camera=cam, device=a.device)
        state, _ = run_frames(step, init_render_state(w, h, a.seed,
                                                      device=a.device),
                              scene, cam, a.progressive_frames)
        return io.encode_png(state.accum.cpu().numpy()), None
    img, stats = render_image(scene, cam, w, h, spp, a.seed, opts,
                              return_stats=True, device=a.device)
    heat = None
    if "spp_map" in stats:
        m = stats["spp_map"].cpu().numpy().astype(np.float32)
        heat = io.encode_png(np.repeat((m / max(float(m.max()), 1.0))[
            ..., None], 3, axis=-1))
    return io.encode_png(img.cpu().numpy()), heat


def phase_cli(smi: str) -> dict:
    """``python -m raytracer_tpu_torch.app.cli`` on the card, each run in
    its own process: every PNG (and the adaptive run's spp map) byte for
    byte the PNG of the same call in this process. Prints each run's wall
    as the CLI reports it (the render and the PNG's copy to the host) and
    as this process sees it (process start and library load too)."""
    out_dir = os.path.join(ROOT, "build", "chip_smoke_cli")
    os.makedirs(out_dir, exist_ok=True)
    runs = {}
    for label, (flags, kernel) in CLI_RUNS.items():
        out = os.path.join(out_dir, label.replace(" ", "_") + ".png")
        extra = ["--out", out]
        spp_map = None
        if "--adaptive" in flags:
            spp_map = out.replace(".png", "_spp.png")
            extra += ["--spp-map", spp_map]
        runs[label] = (["raytracer_tpu_torch.app.cli", *flags, *extra], out,
                       spp_map)
    # the cover's run alone, for its wall; the others side by side
    first = next(iter(runs))
    done = {first: finish_module(start_module(runs[first][0]),
                                 f"cli {first}")}
    started = {label: start_module(runs[label][0]) for label in runs
               if label != first}
    done.update({label: finish_module(p, f"cli {label}")
                 for label, p in started.items()})
    launches = {}
    for label, (flags, kernel) in CLI_RUNS.items():
        stdout, _, wall = done[label]
        _, out, spp_map = runs[label]
        said = re.search(r"wall=([0-9.]+)s rays=([0-9.]+)M \(([0-9.]+) "
                         r"Mrays/s\)", stdout) or re.search(
            r"\(([0-9.]+)s\)", stdout)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_map = cli_in_process(flags)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        launches[label] = launch_counts()
        if kernel is not None and (launches[label].get(kernel, 0) < 1 or set(
                launches[label]) != {kernel}):
            fail(f"cli {label}: the in-process call ran {launches[label]}, "
                 f"not {kernel} alone")
        with open(out, "rb") as f:
            same = f.read() == want
        if spp_map is not None:
            with open(spp_map, "rb") as f:
                same = same and f.read() == want_map
        print(f"[cli {label}] {' '.join(flags)}: exit 0, wall "
              f"{said.group(1)} s by the CLI"
              + (f", {said.group(3)} Mrays/s" if said.lastindex == 3 else "")
              + f"; {wall:.3f} s with process start and library load"
              + ("" if label == first else " (run beside the other three)")
              + f"; the same call in this process, warm, {warm:.4f} s with "
              f"its PNG encode; PNG byte-identical {same}; launches "
              f"{launches[label]} [{smi}]")
        if not same:
            fail(f"cli {label}: the PNG differs from the in-process render")
    return launches


def phase_bench_line(smi: str) -> dict:
    """``python -m raytracer_tpu_torch.bench`` with BENCH_CONVERGENCE=golden
    (the cover line) and with BENCH_CONFIG=progressive: each line parses
    with bench.py's keys; the cover's ``segments`` are exactly the segment
    total of ``render_image`` at one repeat's key, ``fold_in(0, i)``; the
    golden bound and the adaptive companion's bound hold."""
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.rng import fold_in, key_data
    from raytracer_tpu_torch.scene import presets

    lines = {}
    for label, env, keys in (
            ("cover golden", {"BENCH_CONVERGENCE": "golden"},
             BENCH_COVER_KEYS),
            ("progressive", {"BENCH_CONFIG": "progressive"},
             BENCH_PROGRESSIVE_KEYS)):
        stdout, stderr, wall = finish_module(
            start_module(["raytracer_tpu_torch.bench"], env),
            f"bench {label}")
        out = stdout.strip().splitlines()
        if len(out) != 1:
            fail(f"bench {label}: {len(out)} lines on stdout")
        line = lines[label] = json.loads(out[0])
        print(f"[bench {label}] {wall:.3f} s with process start; stderr: "
              + " | ".join(stderr.strip().splitlines()))
        print(json.dumps(line))
        if set(line) != keys or not line["value"] > 0:
            fail(f"bench {label}: keys {sorted(set(line) ^ keys)} differ "
                 f"from bench.py's, or no value")
    cover = lines["cover golden"]
    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts = trace_options(5, depth)
    reset_launch_counts()
    segs = [render_image(scene, cam, w, h, spp, fold_in(key_data(0), i),
                         opts, return_stats=True)[1]["segments_exact"]
            for i in range(3)]
    launches = launch_counts()
    print(f"[bench cover golden] segments {cover['segments']}; "
          f"render_image at fold_in(0, i), i = 0, 1, 2: {segs} (launches "
          f"{launches}); golden "
          f"mean|d| {cover['convergence_mad_vs_golden']} (limit "
          f"{GOLDEN_MAX_MAD}), nan {cover['convergence_nan_px']}; adaptive "
          f"mean|d| vs fixed {cover['adaptive_mad_vs_fixed']} (limit "
          f"{BENCH_ADAPTIVE_MAX_MAD}) [{smi}]")
    if cover["segments"] not in segs:
        fail("bench: the line's segments are no repeat's segment total")
    if (cover["convergence_mad_vs_golden"] > GOLDEN_MAX_MAD
            or cover["convergence_nan_px"]):
        fail("bench: the golden check failed")
    if not cover["adaptive_mad_vs_fixed"] <= BENCH_ADAPTIVE_MAX_MAD:
        fail("bench: the adaptive companion is too far from the fixed render")
    if cover["device"] != smi:
        fail(f"bench: device {cover['device']!r}, nvidia-smi says {smi!r}")
    return lines


def run_viewer_captured(config: str, display: str):
    """``run_viewer`` off a tty (stdin from /dev/null, stdout captured):
    the frames drawn, the output, the engine and the wall in s."""
    import contextlib
    import io as stdio

    from raytracer_tpu_torch.app import viewer

    made, real = [], viewer.Engine

    def engine(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    out = stdio.StringIO()
    viewer.Engine = engine
    try:
        with open(os.devnull) as null, contextlib.redirect_stdout(out):
            stdin, sys.stdin = sys.stdin, null
            try:
                t0 = time.perf_counter()
                n = viewer.run_viewer(config, VIEWER_W, VIEWER_H,
                                      max_frames=VIEWER_FRAMES,
                                      target_fps=1e6, display=display)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                sys.stdin = stdin
    finally:
        viewer.Engine = real
    return n, out.getvalue(), made[0], wall


def phase_viewer(smi: str) -> dict:
    """The terminal viewer headless at 320x180 on the demo and the cover,
    64 frames with each display: frames drawn, the framebuffer finite,
    ``kitty_frame`` of it round-trips to ``tonemap_u8``; ms a frame."""
    import base64

    from raytracer_tpu_torch.app.display import (
        kitty_frame,
        parse_kitty_commands,
    )
    from raytracer_tpu_torch.app.io import decode_png, tonemap_u8

    launches = {}
    for config in ("demo", "cover"):
        for display in ("ansi", "kitty"):
            reset_launch_counts()
            n, out, eng, wall = run_viewer_captured(config, display)
            launches[f"{config} {display}"] = launch_counts()
            fb = eng.framebuffer()
            payload = "".join(c for _, c in parse_kitty_commands(
                kitty_frame(fb))[1:])
            round_trip = np.array_equal(
                decode_png(base64.standard_b64decode(payload)),
                tonemap_u8(fb))
            drawn = ("\x1b[38;2;" in out if display == "ansi"
                     else "\x1b_Ga=T,f=100" in out)
            print(f"[viewer {config} {display}] {VIEWER_W}x{VIEWER_H}, {n} "
                  f"frames: {wall * 1e3 / n:.3f} ms a frame (tick, copy to "
                  f"the host, encode); frames drawn {drawn}; finite "
                  f"{bool(np.isfinite(fb).all())}; kitty round trip "
                  f"{round_trip}; render_count "
                  f"{eng.render_state.render_count}; launches "
                  f"{launches[f'{config} {display}']} [{smi}]")
            if (n != VIEWER_FRAMES or not drawn or not round_trip
                    or not np.isfinite(fb).all()
                    or eng.render_state.render_count != VIEWER_FRAMES):
                fail(f"viewer {config} {display}")
    return launches


def oom_once(step):
    """``step`` whose first call tries to allocate twice the card's
    memory: a real ``torch.OutOfMemoryError`` from the allocator."""
    calls = []

    def faulty(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            total = torch.cuda.get_device_properties(0).total_memory
            torch.empty(2 * total, dtype=torch.uint8, device="cuda")
        return step(*args, **kwargs)

    faulty.calls = calls
    return faulty


def phase_fault_recovery(smi: str):
    """A real out-of-memory error in the engine's step and in
    ``render_image``, on the card: the engine (the cover at 1280x720 with
    the overlay on) returns False from the faulted tick with the count at
    0, and its next 32 frames are bitwise a fresh engine's; the render
    retried once is bitwise the render without the fault."""
    import logging

    from raytracer_tpu_torch.app.engine import Engine
    from raytracer_tpu_torch.render import pallas_kernel
    from raytracer_tpu_torch.scene import presets

    scene, cam, *_ = presets.get_config("cover", ENGINE_W, ENGINE_H)

    def engine():
        eng = Engine(scene, cam, ENGINE_W, ENGINE_H, seed=11)
        eng.set_paused(False)
        eng.set_debugging(True)
        eng.handle_mouse_move(0, 0)
        return eng

    eng, fresh = engine(), engine()
    eng.run(OOM_WARM_FRAMES)
    real = eng._step_fn
    eng._step_fn = lambda spp: oom_once(real(spp))
    now = 1000.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticked = eng.tick(now)
    torch.cuda.synchronize()
    engine_ms = (time.perf_counter() - t0) * 1e3
    del eng._step_fn
    count = eng.render_state.render_count
    if ticked or count != 0:
        fail("engine: the faulted tick rendered, or the count is not 0")
    reset_launch_counts()
    same = True
    for i in range(OOM_AFTER_FRAMES):
        now += 16.0
        if not (eng.tick(now) and fresh.tick(now)):
            fail("engine: a frame after the recovery was skipped")
        same = same and torch.equal(eng.render_state.accum,
                                    fresh.render_state.accum)
    launches = launch_counts()

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    img0, stats0, wall0 = render_once(scene, cam, w, h, spp, 0,
                                      trace_options(5, depth))
    logged = []

    class Catch(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())

    handler = Catch(logging.WARNING)
    logging.getLogger("raytracer_tpu_torch.utils.resilience").addHandler(
        handler)
    real_render = pallas_kernel.render
    pallas_kernel.render = oom_once(real_render)
    try:
        img1, stats1, wall1 = render_once(scene, cam, w, h, spp, 0,
                                          trace_options(5, depth))
    finally:
        pallas_kernel.render = real_render
        logging.getLogger("raytracer_tpu_torch.utils.resilience") \
            .removeHandler(handler)
    render_same = (torch.equal(img0, img1) and stats0["segments_exact"]
                   == stats1["segments_exact"])
    # where a recovery's time goes: the failed allocation (the allocator
    # frees its cached blocks and tries once more), emptying the cache,
    # and a render whose memory is allocated afresh
    reserved = torch.cuda.memory_reserved() / 2**30
    t0 = time.perf_counter()
    try:
        torch.empty(2 * torch.cuda.get_device_properties(0).total_memory,
                    dtype=torch.uint8, device="cuda")
    except torch.OutOfMemoryError:
        pass
    fail_ms = (time.perf_counter() - t0) * 1e3
    left = torch.cuda.memory_reserved() / 2**30
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    empty_ms = (time.perf_counter() - t0) * 1e3
    _, _, wall_cold = render_once(scene, cam, w, h, spp, 0,
                                  trace_options(5, depth))
    print(f"[fault recovery] where a render's recovery goes: the failed "
          f"allocation {fail_ms:.1f} ms ({reserved:.2f} GiB reserved "
          f"before it, {left:.2f} after), empty_cache {empty_ms:.1f} ms, a "
          f"render right after it {wall_cold:.4f} s against {wall0:.4f} s "
          f"warm [{smi}]")
    print(f"[fault recovery] engine (cover {ENGINE_W}x{ENGINE_H}, overlay "
          f"on): the faulted tick {engine_ms:.3f} ms, returned {ticked}, "
          f"render_count {count} after it; the next "
          f"{OOM_AFTER_FRAMES} frames bitwise a fresh engine's {same} "
          f"(launches {launches}); render_image (cover rr5) with one OOM "
          f"{wall1:.4f} s against {wall0:.4f} s without: "
          f"{(wall1 - wall0) * 1e3:.1f} ms for the recovery; bitwise "
          f"{render_same}; warnings {logged} [{smi}]")
    if not same or not render_same or len(logged) != 1 or \
            "retry 1/" not in logged[0]:
        fail("fault recovery")


def phase_edited_scenes(smi: str):
    """Edited covers through the kernels, each bitwise its plain version
    at the crop: a sphere removed, then a sphere added into its slot (K1);
    the cover padded by 37 slots (K1); a 63-slot thinned cover (the flat
    scan) grown to 64 slots by ``add_sphere`` (K1). The removed sphere,
    moved in front of the camera while inactive, changes no pixel."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import megakernel
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scene import spheres as sp
    from raytracer_tpu_torch.scene.materials import Material

    cover, cam, *_ = presets.get_config("cover", CROP_W, CROP_H)
    dcam = derive_camera(cam)
    opts = trace_options(5, CROP_DEPTH)
    seed = kernel_seed(5)
    ident = cw.identity_map(CROP_W, CROP_H, "cuda")
    j = 200  # a small sphere of the grid
    removed = sp.remove_sphere(cover, j)
    ghost = sp.update_sphere(removed, j, center=(6.5, 1.0, 1.5), radius=1.0,
                             material=Material.diffuse((1.0, 0.0, 1.0)))
    thin = dataclasses.replace(cover, **{
        f.name: getattr(cover, f.name)[:THIN_SLOTS]
        for f in dataclasses.fields(cover)})
    flat = dataclasses.replace(opts, cluster_scan=False)
    cases = {
        "removed": (removed, "cluster_walk", opts),
        "removed, moved in front of the camera": (ghost, "cluster_walk",
                                                  opts),
        "removed, flat scan": (removed, "flat_scan", flat),
        "removed, moved in front of the camera, flat scan": (
            ghost, "flat_scan", flat),
        "re-added": (sp.add_sphere(removed, (4.0, 0.2, 0.5), 0.2,
                                   Material.metal((0.9, 0.9, 0.9), 0.0)),
                     "cluster_walk", opts),
        f"padded by {EDIT_PAD}": (cover.pad_to(cover.count + EDIT_PAD),
                                  "cluster_walk", opts),
        f"thinned to {THIN_SLOTS}": (thin, "flat_scan", opts),
        f"thinned, grown to {THIN_SLOTS + 1}": (
            sp.add_sphere(thin, (4.0, 0.2, 0.5), 0.2,
                          Material.diffuse((0.2, 0.8, 0.3))),
            "cluster_walk", opts),
    }
    images = {}
    for label, (scene, kernel, o) in cases.items():
        choice = megakernel.choose_kernel(scene, dcam, o, "cuda")
        if choice.kernel != kernel:
            fail(f"edited cover {label}: took {choice.kernel}, not {kernel}")
        is_flat = kernel == "flat_scan"
        args = (choice.tables, ident, seed, CROP_OFFSET, CROP_SPP, CROP_W,
                CROP_H, o) + ((choice.g_full,) if is_flat else ())
        got = compare(f"edited cover {label} ({scene.count} slots, "
                      f"{int(scene.num_active())} live, {kernel}, g_full "
                      f"{choice.g_full})", args, flat=is_flat)
        images[label] = got["out"]
        if not got["bitwise"]:
            fail(f"edited cover {label}: the kernel is not bitwise its "
                 f"plain version")
    unseen = all(torch.equal(images[f"removed{k}"],
                             images[f"removed, moved in front of the "
                                    f"camera{k}"])
                 for k in ("", ", flat scan"))
    print(f"[edited scenes] the removed sphere never wins: the inactive "
          f"slot moved in front of the camera changes no pixel {unseen} "
          f"[{smi}]")
    if not unseen:
        fail("edited scenes: an inactive slot was hit")


# --- the sharded paths (parallel/) ----------------------------------------

#: the spp axis regroups the float32 sums (each shard sums its own samples,
#: the all-reduce adds the shards): at most a few ulps of a pixel
SHARD_REGROUP_MAX_ABS = 1e-5
SHARD_FRAMES = 64
#: a band that starts mid-image, each kernel against its plain version
BAND_ROWS, BAND_SPP, BAND_DEPTH = (400, 416), 2, 12
ONE_CARD = ("the ranks share one card, so these are no scaling figures; "
            "multi-GPU speed is not measured")


def synced_ms(fn):
    """``(fn(), milliseconds)`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_stats(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


def shard_frames(step, state, scene, cam, frames: int):
    segs = []
    for _ in range(frames):
        state, aux = step(state, scene, cam)
        segs.append(aux["segments"])
    return state, [int(x) for x in segs]


def shard_world_one() -> dict:
    """A (1, 1) NCCL mesh on cuda:0: the cover (K1), the adaptive
    stratified cover (K1a+K1s) and the demo's progressive frames (K2)
    through the mesh and through ``render_image`` / ``make_step_fn`` in
    this process."""
    from raytracer_tpu_torch import init_render_state, make_step_fn
    from raytracer_tpu_torch.parallel import (
        gather_rows,
        make_mesh,
        make_sharded_step_fn,
        render_image_sharded_pallas,
        shard_render_state,
    )
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    import torch.distributed as dist

    mesh = make_mesh((1, 1))
    got = {"device": str(mesh.device), "backend": mesh.backend}
    # the NCCL collectives each path issues (a (1, 1) mesh still runs them)
    issued = {}

    def counted(name):
        real = getattr(dist, name)

        def call(*args, **kwargs):
            issued[name] = issued.get(name, 0) + 1
            return real(*args, **kwargs)
        return call

    dist.all_reduce = counted("all_reduce")
    dist.all_gather = counted("all_gather")
    scene, cam, w, h, spp, depth = presets.get_config("cover")
    for label, adaptive in (("cover rr5", False),
                            ("adaptive stratified cover", True)):
        opts = trace_options(5, depth, adaptive, adaptive)
        reset_launch_counts()
        issued.clear()
        (img, stats), ms = synced_ms(lambda: render_image_sharded_pallas(
            scene, cam, w, h, spp, 0, mesh, opts, return_stats=True))
        launches = launch_counts()
        ref, ref_stats = render_image(scene, cam, w, h, spp, 0, opts,
                                      return_stats=True)
        got[label] = {"bitwise": bool(torch.equal(img, ref)
                                      and same_stats(stats, ref_stats)),
                      "segments": stats["segments_exact"],
                      "ref_segments": ref_stats["segments_exact"],
                      "ms": ms, "launches": launches,
                      "collectives": dict(issued)}
    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    opts = TraceOptions(max_depth=PROG_DEPTH)
    step = make_sharded_step_fn(PROG_W, PROG_H, mesh, 1, opts)
    state = shard_render_state(init_render_state(PROG_W, PROG_H, 0), mesh)
    reset_launch_counts()
    issued.clear()
    (state, segs), ms = synced_ms(lambda: shard_frames(
        step, state, scene, cam, SHARD_FRAMES))
    launches = launch_counts()
    accum = gather_rows(state.accum, mesh)
    collectives = dict(issued)
    ref, ref_segs = shard_frames(
        make_step_fn(PROG_W, PROG_H, 1, opts),
        init_render_state(PROG_W, PROG_H, 0), scene, cam, SHARD_FRAMES)
    got["progressive"] = {
        "bitwise": bool(torch.equal(accum, ref.accum) and segs == ref_segs),
        "segments": sum(segs), "ms": ms, "launches": launches,
        "collectives": collectives}
    got.update(jnp_mesh_cases(mesh, issued))
    return got


def jnp_mesh_cases(mesh, issued=None) -> dict:
    """The jnp tracer's sharded paths on ``mesh``: ``render_image_sharded``
    of the demo (JNP_SHARD_W x JNP_SHARD_H, JNP_SHARD_SPP spp, depth 8)
    and, on a mesh of one, the debug step with the cursor on the sphere
    at the centre of the view (4 frames)."""
    from raytracer_tpu_torch import init_render_state
    from raytracer_tpu_torch.parallel import (
        make_sharded_step_fn,
        render_image_sharded,
        shard_render_state,
    )
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    issued = {} if issued is None else issued
    w, h = JNP_SHARD_W, JNP_SHARD_H
    scene, cam, *_ = presets.get_config("demo", w, h)
    reset_launch_counts()
    issued.clear()
    (img, stats), ms = synced_ms(lambda: render_image_sharded(
        scene, cam, w, h, JNP_SHARD_SPP, 0, mesh,
        jnp_options(max_depth=PROG_DEPTH), return_stats=True))
    got = {"jnp render": {"image": img.cpu(), "segments":
                          stats["segments_exact"], "ms": ms,
                          "launches": launch_counts(),
                          "collectives": dict(issued)}}
    if mesh.shape == {"rows": 1, "spp": 1}:
        debug = centre_pick(scene, cam)
        step = make_sharded_step_fn(w, h, mesh, 1, TraceOptions(
            max_depth=PROG_DEPTH, enable_debug=True))
        state = shard_render_state(init_render_state(w, h, 0), mesh)
        reset_launch_counts()
        issued.clear()
        for _ in range(4):
            state, aux = step(state, scene, cam, debug)
        got["jnp debug step"] = {
            "centre": state.accum[h // 2 - 1, w // 2 - 1].tolist(),
            "segments": int(aux["segments"]), "launches": launch_counts(),
            "collectives": dict(issued)}
    return got


def jnp_band_reference(r: int, n_rows: int, n_spp: int) -> torch.Tensor:
    """Rows shard r's band of the sharded jnp render, formed in this
    process as ``_render_shard`` forms it: the spp shards' sums
    (``sample_sums`` under ``fold_in(fold_in(key, r), s)``) added in
    order, then the mean and the gamma."""
    from raytracer_tpu_torch.camera.camera import pixel_st_grid
    from raytracer_tpu_torch.render.api import to_derived
    from raytracer_tpu_torch.render.rng import fold_in, key_data
    from raytracer_tpu_torch.render.tracer import (
        camera_on,
        sample_sums,
        scene_on,
    )
    from raytracer_tpu_torch.scene import presets

    w, h = JNP_SHARD_W, JNP_SHARD_H
    scene, cam, *_ = presets.get_config("demo", w, h)
    lh = h // n_rows
    st = pixel_st_grid(w, h, device="cuda")[r * lh:(r + 1) * lh]
    st = st.reshape(-1, 2)
    acc = None
    for s in range(n_spp):
        a, _ = sample_sums(scene_on(scene, "cuda"),
                           camera_on(to_derived(cam), "cuda"), st,
                           fold_in(fold_in(key_data(0), r), s), w, h,
                           JNP_SHARD_SPP // n_spp,
                           jnp_options(max_depth=PROG_DEPTH))
        acc = a if acc is None else acc + a
    color = torch.sqrt(torch.clamp_min(acc * (1.0 / JNP_SHARD_SPP), 0.0))
    return color.reshape(lh, w, 3).cpu()


def shard_world_four() -> dict:
    """Four gloo ranks on the one card: the cover on a (2, 2) mesh,
    sorted and unsorted; the adaptive stratified cover on a (4,) mesh,
    contiguous and interleaved; the (4,) mesh refusing 1080 rows."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel import (
        make_mesh,
        make_sharded_step_fn,
        render_image_sharded_pallas,
    )
    from raytracer_tpu_torch.scene import presets

    rank0 = dist.get_rank() == 0
    m22, m4 = make_mesh((2, 2)), make_mesh((4,), ("rows",))
    scene, cam, w, h, spp, depth = presets.get_config("cover")
    got = {"coords": (m22.index("rows"), m22.index("spp"), m4.index("rows"))}
    for label, mesh, adaptive, variant in (
            ("cover", m22, False, dict(sort_pixels=False)),
            ("adaptive", m4, True, dict(interleave_rows=True))):
        opts = trace_options(5, depth, adaptive, adaptive)
        reset_launch_counts()
        (img, stats), ms = synced_ms(lambda: render_image_sharded_pallas(
            scene, cam, w, h, spp, 0, mesh, opts, return_stats=True))
        launches = launch_counts()
        (img2, stats2), ms2 = synced_ms(lambda: render_image_sharded_pallas(
            scene, cam, w, h, spp, 0, mesh,
            dataclasses.replace(opts, **variant), return_stats=True))
        got[label] = {
            "image": img.cpu() if rank0 else None,
            "spp_map": stats["spp_map"].cpu() if rank0 and adaptive
            else None,
            "stats": {k: v for k, v in stats.items() if k != "spp_map"},
            "ms": (ms, ms2), "launches": launches,
            # the image, the sample map and the segments; the mean spp
            # is a mean of other bands' float64 means
            "variant_bitwise": bool(
                torch.equal(img, img2)
                and stats["segments_exact"] == stats2["segments_exact"]
                and (not adaptive
                     or torch.equal(stats["spp_map"], stats2["spp_map"]))),
            "variant_mean_spp": stats2.get("mean_spp")}
    try:
        make_sharded_step_fn(PROG_W, PROG_H, m4)
        got["step_error"] = ""
    except ValueError as e:
        got["step_error"] = str(e)
    got.update(jnp_mesh_cases(m22))
    return got


def shard_world_three() -> dict:
    """Three gloo ranks on the one card, a (3,) rows mesh: the demo's
    progressive frames."""
    import torch.distributed as dist

    from raytracer_tpu_torch import init_render_state
    from raytracer_tpu_torch.parallel import (
        gather_rows,
        make_mesh,
        make_sharded_step_fn,
        shard_render_state,
    )
    from raytracer_tpu_torch.render.options import TraceOptions

    mesh = make_mesh((3,), ("rows",))
    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    step = make_sharded_step_fn(PROG_W, PROG_H, mesh, 1,
                                TraceOptions(max_depth=PROG_DEPTH))
    state = shard_render_state(init_render_state(PROG_W, PROG_H, 0), mesh)
    reset_launch_counts()
    (state, segs), ms = synced_ms(lambda: shard_frames(
        step, state, scene, cam, SHARD_FRAMES))
    launches = launch_counts()
    accum = gather_rows(state.accum, mesh)
    return {"accum": accum.cpu() if dist.get_rank() == 0 else None,
            "segments": segs, "ms": ms, "launches": launches}


def phase_band_kernels() -> None:
    """K1, K1a+K1s, K2 and K2s each render the band BAND_ROWS of the
    cover (a sharded render's lane map, starting mid-image) against
    their plain versions: bitwise."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render.megakernel import band_pixels
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, _, _ = presets.get_config("cover")
    rows = torch.arange(*BAND_ROWS, device="cuda")
    band = band_pixels(cw.identity_map(w, rows.shape[0], "cuda"), rows)
    seed = kernel_seed(7)
    label = f"band rows {BAND_ROWS} of {w}x{h}, {BAND_SPP} spp d{BAND_DEPTH}"
    for name in ("cluster_walk", "cluster_walk_adaptive_stratified"):
        adaptive = name != "cluster_walk"
        tabs, opts = walk_inputs(5, w, h, BAND_DEPTH, adaptive, adaptive)
        pmap, budget = band, None
        if adaptive:
            pmap, budget = budgeted_map(
                lambda m, s: cw.cluster_walk(tabs, m, seed, 0, s, w, h,
                                             opts), band, BAND_SPP, 3)
        got = compare(f"{name} {label}", (tabs, pmap, seed, 3, BAND_SPP, w,
                                           h, opts, budget))
        if not got["bitwise"]:
            fail(f"{name} on a band differs from its plain version")
    for name, split in (("flat_scan", False), ("flat_scan_split", True)):
        opts = TraceOptions(max_depth=BAND_DEPTH, russian_roulette_depth=5,
                            cluster_scan=False, split_scan=split)
        choice = flat_choice(name, scene, cam, opts, split)
        got = compare(f"{name} {label}", (choice.tables, band, seed, 3,
                                           BAND_SPP, w, h, opts,
                                           choice.g_full), flat=True)
        if not got["bitwise"]:
            fail(f"{name} on a band differs from its plain version")


def mesh_launches(label: str, launches: dict, kernel: str):
    if launches.get(kernel, 0) < 1 or set(launches) != {kernel}:
        fail(f"{label} did not run through {kernel} alone: {launches}")


def phase_sharding(smi: str, golden) -> None:
    """The sharded paths (``raytracer_tpu_torch.parallel``), each mesh in
    its own spawned ranks on the one card: a (1, 1) NCCL mesh bitwise
    the same calls in one process; four gloo ranks, the (2, 2) cover
    against the golden and the single render (exact segments) and sorted
    against unsorted, the (4,) adaptive cover interleaved against
    contiguous; three gloo ranks, the (3,) progressive frames bitwise the
    single step's; and each kernel on a band against its plain version."""
    from raytracer_tpu_torch import init_render_state, make_step_fn
    from raytracer_tpu_torch.parallel import run_ranks
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    phase_band_kernels()
    scene, cam, w, h, spp, depth = presets.get_config("cover")
    ref, ref_stats, _ = render_once(scene, cam, w, h, spp, 0,
                                    trace_options(5, depth))
    ref = ref.cpu()
    pscene, pcam, _ = demo_inputs(PROG_W, PROG_H)
    pref, pref_segs = shard_frames(
        make_step_fn(PROG_W, PROG_H, 1, TraceOptions(max_depth=PROG_DEPTH)),
        init_render_state(PROG_W, PROG_H, 0), pscene, pcam, SHARD_FRAMES)

    one, wall = synced_ms(lambda: run_ranks(shard_world_one, 1,
                                            backend="nccl"))
    one = one[0]
    print(f"[sharding (1, 1) nccl on {one['device']}] mesh wall (spawn "
          f"included) {wall:.1f} ms [{smi}]")
    for label, kernel in (("cover rr5", "cluster_walk"),
                          ("adaptive stratified cover",
                           "cluster_walk_adaptive_stratified"),
                          ("progressive", "flat_scan")):
        got = one[label]
        print(f"[sharding (1, 1) {label}] bitwise the single-device call "
              f"{got['bitwise']}, segments {got['segments']}, "
              f"{got['ms']:.1f} ms, launches {got['launches']}, NCCL "
              f"collectives {got['collectives']} [{smi}]")
        mesh_launches(f"(1, 1) {label}", got["launches"], kernel)
        if not (got["collectives"].get("all_reduce")
                and got["collectives"].get("all_gather")):
            fail(f"(1, 1) mesh: {label} issued no NCCL all-reduce or no "
                 f"all-gather: {got['collectives']}")
        if not got["bitwise"]:
            fail(f"(1, 1) mesh: {label} differs from the single-device call")

    four, wall = synced_ms(lambda: run_ranks(shard_world_four, 4))
    print(f"[sharding 4 gloo ranks] mesh wall (spawn included) {wall:.1f} "
          f"ms; {ONE_CARD} [{smi}]")
    for label, kernel, bound in (
            ("cover", "cluster_walk", GOLDEN_MAX_MAD),
            ("adaptive", "cluster_walk_adaptive_stratified",
             ADAPTIVE_GOLDEN_MAX_MAD["stratified"])):
        got = four[0][label]
        img = got["image"]
        im = img.numpy().astype(np.float64)
        nan = int(np.isnan(im).any(-1).sum())
        mad = float(np.abs(im - golden).mean())
        line = (f"[sharding {label} {'(2, 2)' if label == 'cover' else '(4,)'}"
                f"] ranks' times (ms, the variant's ms) "
                f"{[tuple(round(x, 1) for x in r[label]['ms']) for r in four]}"
                f", launches of rank 0 {got['launches']}, golden mean|d| "
                f"{mad:.3e} (limit {bound}), nan pixels {nan}, segments "
                f"{got['stats']['segments_exact']}, "
                + ("sorted bitwise unsorted" if label == "cover" else
                   "interleaved bitwise contiguous")
                + f" {all(r[label]['variant_bitwise'] for r in four)}")
        mesh_launches(f"sharded {label}", got["launches"], kernel)
        if nan or mad > bound or img.shape != golden.shape:
            fail(f"sharded {label} disagrees with the golden (mean|d| "
                 f"{mad}, nan pixels {nan})")
        if not all(r[label]["variant_bitwise"] for r in four):
            fail(f"sharded {label}: the variant's render differs")
        if label == "cover":
            d = float((img - ref).abs().max())
            line += (f", max|d| vs the single render {d:.3e} (limit "
                     f"{SHARD_REGROUP_MAX_ABS}), single segments "
                     f"{ref_stats['segments_exact']}")
            if (d > SHARD_REGROUP_MAX_ABS or got["stats"]["segments_exact"]
                    != ref_stats["segments_exact"]):
                fail("the (2, 2) cover differs from the single render")
        else:
            mean, mean2 = got["stats"]["mean_spp"], got["variant_mean_spp"]
            line += (f", mean_spp {mean!r} (interleaved {mean2!r}), spp_map "
                     f"min {float(got['spp_map'].min()):.0f}")
            if abs(mean - mean2) > 1e-12 * mean:
                fail("sharded adaptive: the interleaved mean spp differs")
        print(line + f" [{smi}]")
    if "divisible by rows*8 = 32" not in four[0]["step_error"]:
        fail(f"a (4,) mesh on {PROG_H} rows: {four[0]['step_error']!r}")
    print(f"[sharding (4,) step on {PROG_H} rows] ValueError: "
          f"{four[0]['step_error']}")

    jnp_sharded(smi, one, four)

    three, wall = synced_ms(lambda: run_ranks(shard_world_three, 3))
    got = three[0]
    bitwise = (torch.equal(got["accum"], pref.accum.cpu())
               and got["segments"] == pref_segs)
    print(f"[sharding (3,) progressive {PROG_W}x{PROG_H} {SHARD_FRAMES} "
          f"frames] mesh wall (spawn included) {wall:.1f} ms; ranks' "
          f"frames {[round(r['ms'], 1) for r in three]} ms; launches of "
          f"rank 0 {got['launches']}; bitwise the single step's "
          f"{bitwise}; {ONE_CARD} [{smi}]")
    mesh_launches("(3,) progressive", got["launches"], "flat_scan")
    if not bitwise:
        fail("the (3,) progressive frames differ from the single step's")


# --- the import surface: render_image_pallas and entry() ------------------

#: timed repeats of each render of the pallas-cover path (in turns)
SURFACE_REPEATS = 3
#: frames of entry()'s step timed in batches of PROG_BATCH
ENTRY_FRAMES = 4 * PROG_BATCH
#: K2 <adaptive, stratified, split, debug, form> as the profiler names it
K2_PROFILE_NAME = "flat_scan_kernel<false, false, false, false,"
ENTRY_LINE = re.compile(r"^entry OK: \((\d+), (\d+), 3\) (\d+\.\d+)$")


def phase_import_surface_entry(smi: str, golden) -> None:
    """The JAX package's names through the kernels:

    - pallas-cover: ``render_image_pallas`` (``render/pallas_kernel.py``)
      on the full cover (1200x800, 500 spp, d50, rr5), the path
      ``bench.py`` times, through K1 alone: the image and the exact
      segments bitwise ``render_image``'s, the image against the golden;
      both walls, best of SURFACE_REPEATS in turns;
    - entry-demo: ``python -m raytracer_tpu_torch.entry`` in its own
      process, its line the same step's in this one; then ``entry()``'s
      step (the demo at 256x144, 1 spp, d8): bitwise a directly built
      ``make_step_fn`` frame with one launch of K2, K2 ``<0,0,0,0,b>``
      and no other kernel of the renderer under the profiler over
      PROG_BATCH steps (the wrapper counting one launch a step), K2
      bitwise its plain version on the step's own tables and lane map,
      ms a frame (best batch of PROG_BATCH)."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.entry import HEIGHT, WIDTH, entry
    from raytracer_tpu_torch.progressive.state import init_render_state
    from raytracer_tpu_torch.progressive.step import make_step_fn
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import megakernel
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.pallas_kernel import render_image_pallas
    from raytracer_tpu_torch.render.rng import fold_in, kernel_seed_from_key
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts, dcam = trace_options(5, depth), derive_camera(cam)

    def pallas(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, stats = render_image_pallas(scene, dcam, w, h, spp, seed, opts,
                                         return_stats=True)
        torch.cuda.synchronize()
        return img, stats, time.perf_counter() - t0

    (img_p, st_p, _), launches = render_path(
        "pallas-cover", "cluster_walk", lambda: pallas(0))
    img_r, st_r, _ = render_once(scene, cam, w, h, spp, 0, opts)
    same = (torch.equal(img_p, img_r)
            and st_p["segments_exact"] == st_r["segments_exact"])
    walls = {"render_image_pallas": [], "render_image": []}
    for _ in range(SURFACE_REPEATS):
        walls["render_image_pallas"].append(pallas(0)[2])
        walls["render_image"].append(render_once(scene, cam, w, h, spp, 0,
                                                 opts)[2])
    im = img_p.cpu().numpy().astype(np.float64)
    mad = float(np.abs(im - golden).mean())
    segs = st_p["segments_exact"]
    best = {k: min(v) for k, v in walls.items()}
    print(f"[pallas-cover] render_image_pallas {w}x{h} {spp} spp "
          f"d{depth} rr5: launches {launches} of cluster_walk alone; image "
          f"and segments_exact ({segs} against {st_r['segments_exact']}) "
          f"bitwise render_image's {same}; golden mean|d| {mad:.3e}; wall "
          + "; ".join(f"{k} {' '.join(f'{x:.4f}' for x in v)} s (best "
                      f"{best[k]:.4f}, {segs / best[k] / 1e6:.2f} Mrays/s)"
                      for k, v in walls.items())
          + f" [{smi}]")
    if not same:
        fail("pallas-cover: render_image_pallas differs from render_image")
    if im.shape != golden.shape or not np.isfinite(im).all() \
            or mad > GOLDEN_MAX_MAD:
        fail(f"pallas-cover disagrees with the golden (mean|d| {mad})")

    out, _, wall = finish_module(start_module(["raytracer_tpu_torch.entry"]),
                                 "entry-demo module")
    line = out.strip().splitlines()[-1] if out.strip() else ""
    match = ENTRY_LINE.match(line)
    step, args = entry()
    state0 = dataclasses.replace(args[0], accum=args[0].accum.clone())
    (got, aux), n_launch = render_path("entry-demo", "flat_scan",
                                       lambda: step(*args))
    direct_step = make_step_fn(WIDTH, HEIGHT, spp=1,
                               opts=TraceOptions(max_depth=8), jit=False)
    want, want_aux = direct_step(init_render_state(WIDTH, HEIGHT, 0),
                                 *args[1:])
    seg = int(aux["segments"])
    direct = (torch.equal(got.accum, want.accum)
              and seg == int(want_aux["segments"]))
    print(f"[entry-demo] python -m raytracer_tpu_torch.entry: {line!r} in "
          f"{wall:.3f} s with process start; in this process the step's "
          f"segments {seg}, launches {n_launch} of flat_scan alone, the "
          f"frame bitwise a direct make_step_fn frame {direct} [{smi}]")
    if (not match or (int(match[1]), int(match[2])) != (HEIGHT, WIDTH)
            or float(match[3]) != float(seg)):
        fail(f"entry-demo: the module printed {line!r}, this process's "
             f"step {seg} segments")
    if not direct or n_launch != 1:
        fail("entry-demo: entry()'s step differs from make_step_fn's")

    # a batch of steps under the profiler, from the same fresh state: one
    # step alone is too short a window (after the sharding phase, one
    # step's window held 0.0138 ms of device time and no K2 row)
    def batch():
        st = dataclasses.replace(state0, accum=state0.accum.clone())
        for _ in range(PROG_BATCH):
            st, _ = step(st, *args[1:])
        return st

    reset_launch_counts()
    _, wall_ms, busy, rows, host_ops = device_profile(batch)
    counted = launch_counts()
    kernels = [r for r in rows if "_kernel<" in r[2]
               and ("flat_scan" in r[2] or "cluster_walk" in r[2])]
    print(f"[entry-demo] {PROG_BATCH} steps under the profiler: wall "
          f"{wall_ms / PROG_BATCH:.4f} ms a step, device busy "
          f"{busy / PROG_BATCH:.4f} ms a step (idle share "
          f"{1 - busy / wall_ms:.4f}), {host_ops / PROG_BATCH:.1f} PyTorch "
          f"operator calls a step; launches {counted}; the renderer's "
          f"kernel rows {[(k, n, round(ms, 4)) for ms, n, k in kernels]} "
          f"[{smi}]")
    if (counted != {"flat_scan": PROG_BATCH} or len(kernels) != 1
            or not 1 <= kernels[0][1] <= PROG_BATCH
            or K2_PROFILE_NAME not in kernels[0][2]):
        fail(f"entry-demo: the profiler saw {kernels} and the wrapper "
             f"counted {counted}, not K2 <0,0,0,0,b> alone")

    # K2 against its plain version on the step's own inputs
    step_opts = dataclasses.replace(TraceOptions(max_depth=8),
                                    backend="pallas")
    choice = megakernel.choose_kernel(args[1], derive_camera(args[2]),
                                      step_opts, "cuda", analyse=False)
    kseed = kernel_seed_from_key(fold_in(state0.key, state0.frame))
    k2 = compare(f"entry-demo K2 {WIDTH}x{HEIGHT} d8", (
        choice.tables, cw.identity_map(WIDTH, HEIGHT, "cuda"), kseed, 0, 1,
        WIDTH, HEIGHT, step_opts, choice.g_full, None), flat=True)
    if choice.kernel != "flat_scan" or choice.g_full is not None \
            or not k2["bitwise"]:
        fail("entry-demo: K2 is not bitwise its plain version")

    state, ms = dataclasses.replace(state0, accum=state0.accum.clone()), []
    for _ in range(ENTRY_FRAMES // PROG_BATCH):
        t0 = time.perf_counter()
        for _ in range(PROG_BATCH):
            state, aux = step(state, *args[1:])
        int(aux["segments"])
        ms.append((time.perf_counter() - t0) * 1e3 / PROG_BATCH)
    print(f"[entry-demo] {WIDTH}x{HEIGHT} 1 spp d8, "
          f"{ENTRY_FRAMES} frames in batches of {PROG_BATCH}: "
          f"{min(ms):.4f} ms a frame (best batch; batches "
          f"{' '.join(f'{x:.4f}' for x in ms)}), fps {1e3 / min(ms):.1f} "
          f"[{smi}]")
    if not torch.isfinite(state.accum).all():
        fail("entry-demo: the running average is not finite")


# --- the jnp tracer (render/tracer.py), backend='jnp', on the card ----------
#
# No kernel of the port lies on this path: it is plain PyTorch on CUDA
# tensors, as the JAX package's is XLA-compiled jnp. Every phase below
# checks that no kernel launched.

JNP_RNG_SEEDS = (0, 42, 2**31 + 5)
JNP_RNG_SIZES = (7, 1_048_577)
JNP_GOLDEN_CONFIGS = ("two_sphere", "three_sphere", "demo", "dof")
JNP_W, JNP_H, JNP_SPP, JNP_DEPTH, JNP_SEED = 64, 36, 32, 8, 42
# the CPU tests' bounds (tests/test_torch_jnp_render.py, the port's render
# bounds): share of pixels off by more than 1e-3, mean |delta|
JNP_MAX_FORKED_SHARE, JNP_MAX_MEAN_ABS = 0.05, 8e-3
# the full-width cover through five bands at JNP_COVER_SPP spp, rr0
JNP_COVER_SPP = 4
JNP_BOX = 8
#: bounces of the band profiled for the cover's calls a bounce
JNP_PROFILE_DEPTH = 10
# 8x8 box means at 4 spp (measured on one H100 80GB HBM3, 700 W):
# mean|delta| jnp against the golden 5.90e-3, against the kernels' rr0
# render 6.40e-3 (the kernels against the golden 5.82e-3); the largest
# per-channel mean gap to the golden 4.42e-3 (both renders sit below the
# golden alike: the gamma of a 4-sample mean). Limits about 1.5x.
JNP_COVER_BOX_MAX = {"golden": 9e-3, "kernel": 9.5e-3}
JNP_COVER_CHANNEL_MAX = 7e-3
# BENCH_CONVERGENCE=1 in its own process, at this spp (500, the line's
# own, takes about 2.5 min of jnp on the crop: it is run on its own;
# 200 took 66-90 s, too much of the run's 500 s). Measured at 100 spp on
# one H100 80GB HBM3, 700 W: 9.84e-3; the limit is 1.5x it.
JNP_CONV_SPP = 100
JNP_CONV_MAX_MAD = 1.5e-2
JNP_PROG_FRAMES = 16
JNP_ENGINE_FRAMES = 32
JNP_VIEWER_FRAMES = 8
#: the sharded jnp render's shapes (demo)
JNP_SHARD_W, JNP_SHARD_H, JNP_SHARD_SPP = 640, 360, 8
#: bench.py's line for a BASELINE config with the default knobs, without
#: a convergence mode
BENCH_LINE_KEYS = BENCH_COVER_KEYS - {"convergence_mad_vs_golden",
                                      "convergence_nan_px",
                                      "adaptive_golden_mad"}


def jnp_options(**kw):
    from raytracer_tpu_torch.render.options import TraceOptions

    return TraceOptions(backend="jnp", **kw)


def no_kernel_launched(label: str):
    counts = launch_counts()
    if any(counts.values()):
        fail(f"{label}: the jnp path launched kernels {counts}")


def image_bounds(got, want) -> tuple:
    """(share of pixels off by more than 1e-3, mean |delta|)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float((d.max(-1) > 1e-3).mean()), float(np.nanmean(d))


def phase_jnp_rng(smi: str):
    """Threefry ``uniform`` over (P,), (P, 2), (P, 3) and a bounce's
    concatenated draws (split(key, 3) and the roulette fold) at P = 7 and
    1,048,577 under three keys, on the card: bit for bit the CPU's. Then
    the time of one bounce's draw call."""
    from raytracer_tpu_torch.render import rng

    checked = 0
    for seed in JNP_RNG_SEEDS:
        kd = rng.key_data(seed)
        for p in JNP_RNG_SIZES:
            for shape in ((p,), (p, 2), (p, 3)):
                if not torch.equal(rng.uniform(kd, shape, "cuda").cpu(),
                                   rng.uniform(kd, shape)):
                    fail(f"jnp rng: uniform {shape} of seed {seed} differs "
                         "on the card")
                checked += int(np.prod(shape))
            k1, k2, k3 = rng.split(kd, 3)
            draws = [(k1, 3 * p), (k2, 3 * p), (k3, p),
                     (rng.fold_in(kd, 7), p)]
            for g, w in zip(rng.uniforms(draws, "cuda"),
                            rng.uniforms(draws)):
                if not torch.equal(g.cpu(), w):
                    fail(f"jnp rng: a bounce's draws of seed {seed} differ "
                         "on the card")
                checked += w.numel()
    print(f"[jnp rng] {checked} Threefry uniforms on the card bitwise the "
          f"CPU's (seeds {JNP_RNG_SEEDS}, P {JNP_RNG_SIZES})")
    for label, p in (("the cover's 1200x168 band", 1200 * 168),
                     ("a 1920x1080 frame", 1920 * 1080)):
        kd = rng.key_data(3)
        k1, k2, k3 = rng.split(kd, 3)
        draws = [(k1, 3 * p), (k2, 3 * p), (k3, p), (rng.fold_in(kd, 7), p)]
        ms = cuda_ms(lambda: rng.uniforms(draws, "cuda"), 10)
        print(f"[jnp rng] one bounce's draws for {label} ({8 * p} uniforms, "
              f"one Threefry pass): {ms:.3f} ms [{smi}]")


def phase_jnp_goldens(smi: str):
    """two_sphere, three_sphere, demo and dof at 64x36, 32 spp, depth 8,
    key 42, ``backend='jnp'`` on the card: against the JAX package's
    goldens (rendered by its jnp tracer) and against the port's CPU render
    of the same call, within the CPU test's bounds."""
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.scene import presets

    opts = jnp_options(max_depth=JNP_DEPTH)
    for name in JNP_GOLDEN_CONFIGS:
        scene, cam, *_ = presets.get_config(name, JNP_W, JNP_H)
        reset_launch_counts()
        (img, st), ms = synced_ms(lambda: render_image(
            scene, cam, JNP_W, JNP_H, JNP_SPP, JNP_SEED, opts,
            return_stats=True))
        no_kernel_launched(f"jnp golden {name}")
        cpu, cst = render_image(scene, cam, JNP_W, JNP_H, JNP_SPP, JNP_SEED,
                                opts, return_stats=True, device="cpu")
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      f"{name}_64x36_spp32_d8.npy"))
        g = image_bounds(img.cpu(), golden)
        c = image_bounds(img.cpu(), cpu)
        print(f"[jnp golden {name}] {JNP_W}x{JNP_H} {JNP_SPP} spp "
              f"d{JNP_DEPTH} on the card: {ms:.1f} ms; against the golden "
              f"{g[0]:.4f} of pixels off by more than 1e-3, mean|d| "
              f"{g[1]:.3e}; against the CPU {c[0]:.4f}, {c[1]:.3e} (limits "
              f"{JNP_MAX_FORKED_SHARE}, {JNP_MAX_MEAN_ABS}); segments "
              f"{st['segments_exact']} (CPU {cst['segments_exact']}) "
              f"[{smi}]")
        if (max(g[0], c[0]) > JNP_MAX_FORKED_SHARE
                or max(g[1], c[1]) > JNP_MAX_MEAN_ABS
                or not bool(torch.isfinite(img).all())):
            fail(f"jnp golden {name}: the card's render is off")


def box_mean(a: np.ndarray, box: int) -> np.ndarray:
    """Mean over box x box blocks, NaN values left out."""
    h, w, c = a.shape
    return np.nanmean(a.reshape(h // box, box, w // box, box, c), (1, 3))


def phase_jnp_cover(smi: str, golden):
    """The cover at 1200x800, 487 spheres, depth 50, rr0 (the golden's
    settings) through ``render_image(..., backend='jnp')``: five bands of
    168 rows (the last 128) at 1 spp an execution, JNP_COVER_SPP spp,
    exact int64 segments, NaN pixels counted. Held after 8x8 box
    averaging against the golden and against the kernels' rr0 render at
    the same spp (two unbiased estimators of one image); per-channel
    means. Then one band under the profiler: PyTorch calls a bounce and
    the device's busy share."""
    from raytracer_tpu_torch.render import api
    from raytracer_tpu_torch.render.tracer import render_image_jnp
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, _, depth = presets.get_config("cover")
    opts = jnp_options(max_depth=depth)
    band = api._jnp_band_rows(w, h, scene.count, depth)
    bands = [min(band, h - r) for r in range(0, h, band)]
    if bands != [168] * 4 + [128] or api._jnp_chunk_spp(
            JNP_COVER_SPP, w * band, scene.count, depth) != 1:
        fail(f"jnp cover: bands {bands}, not the JAX package's")
    reset_launch_counts()
    img, st, wall = render_once(scene, cam, w, h, JNP_COVER_SPP, 0, opts)
    no_kernel_launched("jnp cover")
    kern, kst, kwall = render_once(scene, cam, w, h, JNP_COVER_SPP, 0,
                                   trace_options(0, depth))
    im, km = (x.cpu().numpy().astype(np.float64) for x in (img, kern))
    nan_px = int(np.isnan(im).any(-1).sum())
    bj, bk, bg = (box_mean(a, JNP_BOX) for a in (im, km, golden))
    mad_g = float(np.nanmean(np.abs(bj - bg)))
    mad_k = float(np.nanmean(np.abs(bj - bk)))
    mad_kg = float(np.nanmean(np.abs(bk - bg)))
    means = [np.nanmean(a.reshape(-1, 3), 0) for a in (im, km, golden)]
    ch = float(np.abs(means[0] - means[2]).max())
    segs = st["segments_exact"]
    print(f"[jnp cover] {w}x{h}, {scene.count} spheres, d{depth}, rr0, "
          f"{JNP_COVER_SPP} spp through bands {bands}: wall {wall:.3f} s, "
          f"{segs} segments (exact), {segs / wall / 1e6:.2f} Mrays/s; NaN "
          f"pixels {nan_px}; the kernels' rr0 render at {JNP_COVER_SPP} spp "
          f"{kwall:.3f} s ({kst['segments_exact']} segments) [{smi}]")
    print(f"[jnp cover {JNP_BOX}x{JNP_BOX} boxes] mean|d| jnp vs golden "
          f"{mad_g:.4e} (limit {JNP_COVER_BOX_MAX['golden']}), jnp vs "
          f"kernels {mad_k:.4e} (limit {JNP_COVER_BOX_MAX['kernel']}), "
          f"kernels vs golden {mad_kg:.4e}; per-channel means jnp "
          f"{means[0].round(5).tolist()}, kernels "
          f"{means[1].round(5).tolist()}, golden "
          f"{means[2].round(5).tolist()} (largest jnp-golden gap {ch:.4e}, "
          f"limit {JNP_COVER_CHANNEL_MAX})")
    if (img.shape != (h, w, 3) or mad_g > JNP_COVER_BOX_MAX["golden"]
            or mad_k > JNP_COVER_BOX_MAX["kernel"]
            or ch > JNP_COVER_CHANNEL_MAX):
        fail("jnp cover: the render is off the golden or the kernels'")
    from raytracer_tpu_torch.render.api import to_derived
    from raytracer_tpu_torch.render.rng import key_data

    dcam = to_derived(cam)
    short = dataclasses.replace(opts, max_depth=JNP_PROFILE_DEPTH)
    _, band_ms, busy, rows, host_ops = device_profile(
        lambda: render_image_jnp(scene, dcam, w, h, 1, key_data(0), short,
                                 row_offset=0, band_height=band,
                                 device="cuda"))
    print(f"[jnp cover where the time goes] one {w}x{band} band, 1 spp, "
          f"{JNP_PROFILE_DEPTH} bounces under the profiler: wall "
          f"{band_ms:.1f} ms, {host_ops / JNP_PROFILE_DEPTH:.1f} PyTorch "
          f"operator calls a bounce on the "
          f"host (nested ones too); device "
          + (f"busy {busy:.1f} ms = {busy / band_ms:.4f} of the wall, idle "
             f"{1 - busy / band_ms:.4f}" if rows else
             "time not measured by the profiler") + f" [{smi}]")
    for dev_ms, count, key in rows[:8]:
        print(f"  {dev_ms:10.3f} ms  x{count:<5d} {key[:90]}")


def phase_jnp_convergence(smi: str):
    """``python -m raytracer_tpu_torch.bench`` with BENCH_CONVERGENCE=1 in
    its own process: the kernels at rr5 on the 304x200 crop against the
    jnp tracer at rr0 in 10-spp chunks under ``fold_in(key, 1000 +
    done)``, at JNP_CONV_SPP spp."""
    env = {"BENCH_CONVERGENCE": "1", "BENCH_SPP": str(JNP_CONV_SPP)}
    stdout, stderr, wall = finish_module(
        start_module(["raytracer_tpu_torch.bench"], env), "bench convergence")
    out = stdout.strip().splitlines()
    line = json.loads(out[-1])
    keys = BENCH_LINE_KEYS | {"convergence_mad_vs_jnp", "convergence_nan_px"}
    print(f"[jnp convergence] BENCH_CONVERGENCE=1 BENCH_SPP={JNP_CONV_SPP}: "
          f"{wall:.1f} s with process start; stderr: "
          + " | ".join(stderr.strip().splitlines()) + f" [{smi}]")
    print(json.dumps(line))
    if len(out) != 1 or set(line) != keys:
        fail(f"jnp convergence: keys {sorted(set(line) ^ keys)} differ from "
             "bench.py's")
    if not line["convergence_mad_vs_jnp"] <= JNP_CONV_MAX_MAD:
        fail(f"jnp convergence: mean|d| {line['convergence_mad_vs_jnp']} "
             f"above {JNP_CONV_MAX_MAD}")


def phase_jnp_progressive(smi: str):
    """The demo at 1920x1080, depth 8, 1 spp a frame, JNP_PROG_FRAMES
    frames with each sampler through ``make_step_fn(..., backend='jnp')``,
    with the sync debug mode raising on any call that waits for the
    device; the stratified session's running average bitwise that of the
    offline jnp renders at sample_offset = i."""
    from raytracer_tpu_torch import init_render_state, make_step_fn
    from raytracer_tpu_torch.progressive.step import accumulate
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions

    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    for sampler in ("random", "stratified"):
        opts = TraceOptions(max_depth=PROG_DEPTH, sampler=sampler)
        step = make_step_fn(PROG_W, PROG_H, 1, opts, backend="jnp")
        step(init_render_state(PROG_W, PROG_H, 1), scene, cam)  # warm
        state = init_render_state(PROG_W, PROG_H, 0)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(JNP_PROG_FRAMES):
                state, aux = step(state, scene, cam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / JNP_PROG_FRAMES
        no_kernel_launched(f"jnp progressive {sampler}")
        line = (f"[jnp progressive {sampler}] demo {PROG_W}x{PROG_H} 1 "
                f"spp/frame d{PROG_DEPTH}, {JNP_PROG_FRAMES} frames: "
                f"{ms:.2f} ms a frame = {1e3 / ms:.2f} fps, last frame "
                f"{int(aux['segments'])} segments; no device sync inside a "
                f"frame")
        if sampler == "stratified":
            avg = None
            for i in range(JNP_PROG_FRAMES):
                f = render_image(scene, cam, PROG_W, PROG_H, 1, 0,
                                 dataclasses.replace(opts, backend="jnp"),
                                 sample_offset=i)
                avg = f if avg is None else accumulate(avg, f, i + 1)
            same = bool(torch.equal(state.accum, avg))
            line += (f"; running average bitwise the offline renders' at "
                     f"sample_offset i {same}")
            if not same:
                fail("jnp progressive: the stratified session is not the "
                     "offline renders' running average")
        print(line + f" [{smi}]")
        if not bool(torch.isfinite(state.accum).all()):
            fail(f"jnp progressive {sampler}: the average is not finite")


def phase_jnp_entry_points(smi: str):
    """``backend='jnp'`` through the entry points on the card: the CLI on
    two_sphere and on a demo progressive run, each in its own process,
    their PNGs byte-identical to the same calls in this process; the
    bench line with BENCH_BACKEND=jnp BENCH_CONFIG=two_sphere; the viewer
    headless for JNP_VIEWER_FRAMES frames in its own process; and
    ``Engine(backend='jnp')`` at 1280x720 on the demo with the overlay
    on: the centre pixel marker blue after every batch (no device sync
    inside a frame), the outline on the selection's silhouette."""
    from raytracer_tpu_torch import Engine
    from raytracer_tpu_torch.scene import presets

    out_dir = os.path.join(ROOT, "build", "chip_smoke_cli")
    os.makedirs(out_dir, exist_ok=True)
    runs = {"two_sphere": ["--config", "two_sphere"],
            "demo progressive": ["--config", "demo", "--progressive-frames",
                                 "8"]}
    started = {}
    for label, flags in runs.items():
        out = os.path.join(out_dir, "jnp_" + label.replace(" ", "_") + ".png")
        runs[label] = flags + ["--backend", "jnp", "--out", out]
        started[label] = start_module(["raytracer_tpu_torch.app.cli",
                                       *runs[label]])
    started["bench"] = start_module(["raytracer_tpu_torch.bench"], {
        "BENCH_BACKEND": "jnp", "BENCH_CONFIG": "two_sphere"})
    started["viewer"] = start_module([
        "raytracer_tpu_torch.app.viewer", "--backend", "jnp", "--max-frames",
        str(JNP_VIEWER_FRAMES)])
    for label, flags in runs.items():
        stdout, _, wall = finish_module(started[label], f"jnp cli {label}")
        reset_launch_counts()
        want, _ = cli_in_process(flags)
        no_kernel_launched(f"jnp cli {label}")
        with open(flags[-1], "rb") as f:
            same = f.read() == want
        print(f"[jnp cli {label}] {' '.join(flags[:-2])}: {wall:.3f} s with "
              f"process start; {stdout.strip().splitlines()[-1]}; PNG "
              f"byte-identical to the same call in this process {same} "
              f"[{smi}]")
        if not same:
            fail(f"jnp cli {label}: the PNG differs from the in-process call")
    stdout, stderr, wall = finish_module(started["bench"], "jnp bench")
    out = stdout.strip().splitlines()
    line = json.loads(out[-1])
    print(f"[jnp bench two_sphere] {wall:.1f} s with process start; stderr: "
          + " | ".join(stderr.strip().splitlines()))
    print(json.dumps(line))
    if (len(out) != 1 or set(line) != BENCH_LINE_KEYS
            or line["backend"] != "jnp" or not line["value"] > 0):
        fail(f"jnp bench: keys {sorted(set(line) ^ BENCH_LINE_KEYS)} or "
             f"backend {line.get('backend')}")
    stdout, _, wall = finish_module(started["viewer"], "jnp viewer")
    drawn = stdout.count("\x1b[38;2;") > 0
    print(f"[jnp viewer] --backend jnp --max-frames {JNP_VIEWER_FRAMES}, "
          f"headless: exit 0 in {wall:.1f} s with process start; frames "
          f"drawn {drawn} [{smi}]")
    if not drawn:
        fail("jnp viewer: no frame drawn")

    w, h = ENGINE_W, ENGINE_H
    scene, cam, *_ = presets.get_config("demo", w, h)
    eng = Engine(scene, cam, w, h, max_depth=ENGINE_DEPTH, backend="jnp")
    now = [0.0]
    eng.set_paused(False)
    eng.set_debugging(True)
    eng.handle_mouse_move(4.0, -3.0)
    eng.handle_mouse_move(-4.0, 3.0)
    sel = eng.app.selected_object
    if sel == 1000:
        fail("jnp engine: the pick hit nothing")
    now[0] += 16.0
    eng.tick(now[0])
    eng.set_debugging(False)
    eng.set_debugging(True)
    centre = (h // 2 - 1, w // 2 - 1)
    blue = torch.tensor([0.0, 0.0, 1.0], device="cuda")

    def centre_is_blue(batch):
        c = eng.render_state.accum[centre]
        if not bool((c == blue).all()):
            fail(f"jnp engine: centre pixel {c.tolist()} after batch "
                 f"{batch}, not the marker's (0, 0, 1)")

    reset_launch_counts()
    ms = engine_batches(eng, now, JNP_ENGINE_FRAMES, centre_is_blue)
    no_kernel_launched("jnp engine")
    fb = eng.render_state.accum
    total, on_edge = silhouette_red(fb, uuid_map(eng.scene, eng.camera, w, h)
                                    == sel)
    print(f"[jnp engine demo {w}x{h} d{ENGINE_DEPTH}] overlay on, selected "
          f"{sel}: {JNP_ENGINE_FRAMES} frames, fps {1e3 / min(ms):.2f} "
          f"(batches {' '.join(f'{x:.2f}' for x in ms)} ms/frame); centre "
          f"pixel (0, 0, 1) after every batch; red-dominant pixels {total}, "
          f"on the selection's silhouette {on_edge}; no device sync inside "
          f"a frame [{smi}]")
    if on_edge == 0 or not bool(torch.isfinite(fb).all()):
        fail("jnp engine: no outline on the selection, or a NaN")




def jnp_sharded(smi: str, one: dict, four: list) -> None:
    """The jnp tracer's sharded cases of the (1, 1) NCCL rank and the
    (2, 2) gloo ranks: every band bitwise ``_render_shard``'s, formed in
    this process; no kernel launched; the (1, 1) mesh through NCCL; the
    debug step's centre pixel the marker's blue."""
    for label, got, n_rows, n_spp in (
            ("(1, 1) nccl", one["jnp render"], 1, 1),
            ("(2, 2) gloo", four[0]["jnp render"], 2, 2)):
        lh = JNP_SHARD_H // n_rows
        same = [bool(torch.equal(got["image"][r * lh:(r + 1) * lh],
                                 jnp_band_reference(r, n_rows, n_spp)))
                for r in range(n_rows)]
        print(f"[sharding {label} jnp render] demo {JNP_SHARD_W}x"
              f"{JNP_SHARD_H} {JNP_SHARD_SPP} spp: {got['ms']:.1f} ms, "
              f"segments {got['segments']}, launches {got['launches']}, "
              f"collectives {got['collectives']}; each band bitwise "
              f"_render_shard's in this process {same} [{smi}]")
        if not all(same) or any(got["launches"].values()):
            fail(f"sharded jnp render {label}: a band differs, or kernels "
                 "ran")
    if not (one["jnp render"]["collectives"].get("all_reduce")
            and one["jnp render"]["collectives"].get("all_gather")):
        fail("(1, 1) mesh: the jnp render issued no NCCL collective")
    dbg = one["jnp debug step"]
    print(f"[sharding (1, 1) nccl jnp debug step] 4 frames: centre pixel "
          f"{dbg['centre']}, segments of the last {dbg['segments']}, "
          f"launches {dbg['launches']}, collectives {dbg['collectives']} "
          f"[{smi}]")
    if dbg["centre"] != [0.0, 0.0, 1.0] or any(dbg["launches"].values()):
        fail("sharded jnp debug step: no marker at the centre, or kernels "
             "ran")


def timed(phase, *args):
    """``phase(*args)``, with a line of the seconds it took."""
    t0 = time.perf_counter()
    got = phase(*args)
    print(f"[phase time] {phase.__name__} {time.perf_counter() - t0:.1f} s")
    return got


def main():
    t_start = time.perf_counter()
    smi = timed(phase_device)
    timed(phase_build)
    crops = {"cluster_walk": timed(phase_kernel_vs_plain)}
    crops.update(timed(phase_variants_vs_plain))
    crops.update(timed(phase_flat_vs_plain))
    golden = np.load(GOLDEN)["image"].astype(np.float64)
    paths = timed(phase_main_paths, smi, golden)
    alone = {
        "cluster_walk": timed(phase_fixed_kernel_alone, smi, False),
        "cluster_walk_stratified": timed(phase_fixed_kernel_alone, smi,
                                         True),
        "cluster_walk_adaptive_stratified": timed(phase_adaptive_alone, smi,
                                                  True),
        "cluster_walk_adaptive": timed(phase_adaptive_alone, smi, False),
    }
    timed(phase_walk_ab, smi)
    timed(phase_wide_walk, smi)
    depth = paths["cluster_walk"]["depth"]
    timed(phase_where_time_goes, smi, "rr5", trace_options(5, depth))
    timed(phase_where_time_goes, smi, "adaptive companion",
          trace_options(5, depth, True, True))
    timed(phase_cross_kernel, smi)
    timed(phase_cover_flat, smi, golden)
    timed(phase_baseline_configs, smi)
    flat_paths = timed(phase_progressive, smi)
    flat_paths.update(timed(phase_flat_adaptive, smi))
    crops.update(timed(phase_debug_vs_plain))
    flat_paths.update(timed(phase_engine, smi))
    timed(phase_aov, smi)
    crops.update(timed(phase_probes_vs_plain))
    timed(phase_probe_ab, smi)
    probes = timed(phase_probe_paths, smi)
    timed(phase_cli, smi)
    timed(phase_bench_line, smi)
    timed(phase_viewer, smi)
    timed(phase_fault_recovery, smi)
    timed(phase_edited_scenes, smi)
    timed(phase_sharding, smi, golden)
    timed(phase_import_surface_entry, smi, golden)
    t_jnp = time.perf_counter()
    timed(phase_jnp_rng, smi)
    timed(phase_jnp_goldens, smi)
    timed(phase_jnp_cover, smi, golden)
    timed(phase_jnp_convergence, smi)
    timed(phase_jnp_progressive, smi)
    timed(phase_jnp_entry_points, smi)
    t_jnp = time.perf_counter() - t_jnp
    for name, got in flat_paths.items():
        paths[name] = alone[name] = got
    sources = {**{n: (WALK_SOURCE, KERNELS[n][2]) for n in KERNELS},
               **{n: (FLAT_SOURCE, FLAT_KERNELS[n][3]) for n in FLAT_KERNELS},
               **{n: (FLAT_SOURCE if DEBUG_KERNELS[n][0] else WALK_SOURCE,
                      DEBUG_REPLACES) for n in DEBUG_KERNELS}}
    renderer = [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": paths[name]["launches"],
        "max_abs_err": crops[name]["max_abs_err"],
        "ms": alone[name]["ms"],
        "plain_ms": crops[name]["plain_ms"],
        "bound_ms": alone[name]["bound_ms"],
        "bound_by": alone[name]["bound_by"],
        "library_ms": None,
        "issue_bound_ms": alone[name]["issue_bound_ms"],
        "crop_ms": crops[name]["crop_ms"],
        "plain_shape": f"{CROP_W}x{CROP_H}x{CROP_SPP}spp d{CROP_DEPTH}",
    } for name, (source, replaces) in sources.items()]
    probe_rows = [{
        "name": name,
        "route": "cuda",
        "source": PROBE_SOURCES[source],
        "replaces": replaces,
        "max_abs_err": crops[name]["max_abs_err"],
        "plain_ms": crops[name]["plain_ms"],
        "library_ms": None,
        "plain_shape": crops[name]["plain_shape"],
        **probes[name],
    } for name, (source, replaces) in PROBE_KERNELS.items()]
    # the order for kernel redesigns, the renderer's and the probes'
    # together: the time each path spends above the issue-line bound,
    # launches x (ms - bound)
    for row in sorted(renderer + probe_rows, key=lambda r: -r["launches"] * (
            r["ms"] - r["issue_bound_ms"])):
        print(f"[redesign order] {row['name']}: {row['launches']} launches x "
              f"({row['ms']:.4f} - {row['issue_bound_ms']:.4f}) ms = "
              f"{row['launches'] * (row['ms'] - row['issue_bound_ms']):.3f} "
              f"ms; share of the issue-line bound "
              f"{row['issue_bound_ms'] / row['ms']:.4f} (of the data "
              f"sheet's: {row['bound_ms'] / row['ms']:.4f}) [{smi}]")
    t_all = time.perf_counter() - t_start
    print(f"[phase time] all {t_all:.1f} s; the jnp phases "
          f"{t_jnp:.1f} s of it, a share of {t_jnp / t_all:.3f}")
    print(json.dumps({"kernels": renderer + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
