"""The card's correctness run of the PyTorch + CUDA port, on one NVIDIA
GPU.

    python3 chip_smoke.py

It takes no timings: the benchmark (``benchmark/run.py``) measures the
port end to end, and the A/B scripts (``scripts/walk_ab.py``,
``scripts/probe_ab.py``) time kernels in turns, bitwise against the base
revision. The roofline is ``benchmark/roofline.py``'s. Each phase prints
its checks and a ``[phase time]`` line, and any failed check ends the run
with a nonzero exit.

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
- the adaptive cover at the benchmark cell cover-adaptive's shape (no
  roulette, 960,000 lanes, 17 chunks), each sampler, with the plain twin
  of the re-plan chain (``csrc/adaptive_plan.cu``) stepped beside it and
  bitwise after every step, and the render bitwise its launches
  re-planned at full width;
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
  silhouette, no NaN, no device sync inside a frame), 16 picks that stay
  on the sphere, a paused 25-spp still saved to a PNG and decoded; the
  overlay off restarts the average and its next frame is the plain
  step's;
- the four AOV views at 1280x720 on the card against the port on the CPU;
- the card probes (``raytracer_tpu_torch/scripts/``, built from
  ``csrc/probe_chain.cu``, ``probe_gather.cu`` and ``probe_scan.cu``: two
  chains, three gather modes, four scan blocks), each instantiation first
  held bitwise against its plain version at the TPU's shape and at a
  card-filling one, then the probe A/B (``scripts/probe_ab.py``: the
  scan's four blocks and the one-hot product, redesigned for Hopper,
  against their base revision's builds, bitwise and timed in turns, with
  registers, spill bytes and SASS counts), then each probe's entry point
  at its script's trips, its outputs checked and its launches counted,
  and the roofline script, which fails the run unless its float32 chain
  comes within 10 % of the issue line (SMs x 128 x the highest SM clock).

The wide walk (``RT_WALK_WIDE``: partitions of 129 to 512 clusters,
tables past shared memory): its six instantiations on the SPD
sphereflake (7,382 slots, 462 clusters, 512x512, depth 50) on a grid of
its pixels, and its adaptive ones on a sparse live set of the whole frame
(whole lanes), bitwise their plain versions (``walk_ab.flake_check``);
its counts of walk iterations and bounces those of its cost row and
segments; two whole sphereflake renders at 500 spp through
``render_image``, bitwise each other.

The motion walk (``RT_WALK_MOTION``: scenes with a shutter, moving
spheres and the checker): *The Next Week*'s bouncing spheres at the
benchmark cell bouncing-offline's shape (1200x675, depth 50), a 2-spp
launch of each sampler bitwise its plain version, its counts of bounces
its segments'; the cover made a still scene with a one-colour checker
ground, through ``render_image``, bitwise the narrow walk's render; two
whole renders of the cell (500 spp), each launch the motion walk's,
bitwise each other.

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
exact segments bitwise ``render_image``'s;
``python -m raytracer_tpu_torch.entry`` in its own process, and
``entry()``'s step (the demo at 256x144, 1 spp, depth 8): bitwise a
directly built ``make_step_fn`` frame, K2 and no other kernel of the
renderer under the profiler, K2 bitwise its plain version on the step's
inputs.

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
``tests/goldens/cover_jnp_rr0_500spp_f16.npz``). Launch counts are set
to 0 just before each path and read just after it. The last line of
output is ``{"ok": true, "device": {...}}``.

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

from raytracer_tpu_torch.utils.profiling import card_label

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "cover_jnp_rr0_500spp_f16.npz")

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

#: kernel name → (adaptive, stratified)
KERNELS = {
    "cluster_walk": (False, False),
    "cluster_walk_adaptive": (True, False),
    "cluster_walk_stratified": (False, True),
    "cluster_walk_adaptive_stratified": (True, True),
}
#: flat-scan instantiation → (adaptive, stratified, split)
FLAT_KERNELS = {
    "flat_scan" + ("_split" if sp else "") + ("_adaptive" if a else "")
    + ("_stratified" if st else ""): (a, st, sp)
    for sp in (False, True) for a in (False, True) for st in (False, True)
}

# the progressive step as bench.py drives it (BASELINE config 4)
PROG_W, PROG_H, PROG_DEPTH = 1920, 1080, 8
PROG_FRAMES, PROG_BATCH = 256, 32
#: the debug overlay's instantiations → (flat, stratified)
DEBUG_KERNELS = {
    "cluster_walk_debug": (False, False),
    "cluster_walk_stratified_debug": (False, True),
    "flat_scan_debug": (True, False),
    "flat_scan_stratified_debug": (True, True),
}
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
             + [("cluster_walk", None, (cw.WIDE_DEFINE,)),
                ("cluster_walk", None, (cw.MOTION_DEFINE,))]
             + walk_ab.extra_builds(old) + probe_ab.extra_builds(old))
    t0 = time.perf_counter()
    cuda_build.build_all(specs)
    extra = [f"{name} {' '.join(d) or 'base revision'}"
             for name, _, d in specs[len(names):]]
    for label, define in (("wide", cw.WIDE_DEFINE),
                          ("motion", cw.MOTION_DEFINE)):
        for line in cuda_build.build_log(
                "cluster_walk", (define,)).splitlines():
            if ("registers" in line or "spill" in line
                    or "nvcc took" in line):
                print(f"[ptxas cluster_walk {label}]", line.strip())
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
    from raytracer_tpu_torch.scripts import walk_ab

    if flat:
        return fs.flat_scan, fs.flat_scan_plain
    return walk_ab.walk, cw.cluster_walk_plain


def reset_launch_counts():
    from raytracer_tpu_torch.render import adaptive_plan
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import flat_scan as fs

    cw.reset_launch_counts()
    fs.reset_launch_counts()
    adaptive_plan.CudaPlan.launches = 0


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
    return {"out": out_k, "out_plain": out_p, "seg_lanes": seg_k,
            "segs": sk, "bitwise": bitwise}


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


def check_budget(label: str, got: dict, budget) -> None:
    """An adaptive comparison's budget handling: sample counts equal to
    the budget in kernel and plain version, lanes without budget all
    zeros, the sum of lum^2 within 1e-3."""
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


def phase_kernel_vs_plain() -> None:
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
    for rr in (5, 0):
        tabs, opts = walk_inputs(rr, CROP_W, CROP_H, CROP_DEPTH)
        args = (tabs, ident, seed, 0, CROP_SPP, CROP_W, CROP_H, opts)
        got = compare(f"crop rr{rr}", args)
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
    # past 32 clusters the walk takes its four-word box mask: the cover
    # in clusters of 8 and of 4
    for group in (8, 4):
        tabs, opts = walk_inputs(5, CROP_W, CROP_H, CROP_DEPTH, group=group)
        compare(f"crop rr5, {tabs.bounds.shape[0]} clusters",
                (tabs, ident, seed, 0, CROP_SPP, CROP_W, CROP_H, opts))
    for rr in (5, 0):
        tabs, opts = walk_inputs(rr, FULL_W, FULL_H, FULL_DEPTH)
        ident = cw.identity_map(FULL_W, FULL_H, "cuda")
        args = (tabs, ident, seed, 0, FULL_SPP, FULL_W, FULL_H, opts)
        got = compare(f"full frame rr{rr} identity map", args)
        _, pmap = plan_from_cost(got["out"][3], FULL_W)
        args = (tabs, pmap, seed, FULL_SPP, FULL_SPP, FULL_W, FULL_H, opts)
        compare(f"full frame rr{rr} sorted map", args)
    # the demo's own partition (cluster_scan=True), as the cross-kernel
    # render runs it
    scene, _, dcam = demo_inputs(PROG_W, PROG_H)
    opts = TraceOptions(max_depth=PROG_DEPTH, cluster_scan=True)
    choice = choose_kernel(scene, dcam, opts, "cuda")
    if choice.kernel != "cluster_walk":
        fail(f"cluster_scan=True on the demo took {choice}")
    args = (choice.tables, cw.identity_map(PROG_W, PROG_H, "cuda"), seed, 5,
            1, PROG_W, PROG_H, opts)
    compare(f"demo {PROG_W}x{PROG_H} d{PROG_DEPTH} rr0", args)


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
        out_k, seg_k = walk_ab.walk(*args)
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


def phase_variants_vs_plain() -> None:
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
    for name, (adaptive, stratified) in KERNELS.items():
        if name == "cluster_walk":
            continue
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
                if adaptive:
                    check_budget(label, got, budget)
        if adaptive:
            check_items(stratified)


def render_once(scene, cam, w, h, spp, seed, opts):
    from raytracer_tpu_torch.render.api import render_image

    return render_image(scene, cam, w, h, spp, seed, opts,
                        return_stats=True)


def drive_path(label: str, kernel: str, opts, smi: str, golden, seeds,
               max_mad: float) -> dict:
    """One of the port's paths through ``render_image`` on the full
    cover: launch counts set to 0 just before the first render (seed 0)
    and read just after it (the re-plan chain's too), then renders at
    ``seeds``; the last image is held against the golden."""
    from raytracer_tpu_torch.render import adaptive_plan
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, _ = presets.get_config("cover")
    reset_launch_counts()
    first, first_stats = render_once(scene, cam, w, h, spp, 0, opts)
    launches = launch_counts()
    plan_launches = adaptive_plan.CudaPlan.launches
    print(f"[{label}] launches {launches} (first render)")
    if launches.get(kernel, 0) < 1 or set(launches) != {kernel}:
        fail(f"{label} did not run through {kernel} alone: {launches}")
    img, stats = first, first_stats
    for seed in seeds:
        img, stats = render_once(scene, cam, w, h, spp, seed, opts)
    segs = stats["segments_exact"]
    im = img.cpu().numpy().astype(np.float64)
    nan = int(np.isnan(im).any(-1).sum())
    mad = float(np.abs(im - golden).mean())
    print(f"[{label}] {w}x{h} {spp} spp d{opts.max_depth}, seeds "
          f"{(0, *seeds)}: segments of the last {segs}, its golden mean|d| "
          f"{mad:.3e}, nan_pixels {nan} [{smi}]")
    if im.shape != golden.shape or nan or mad > max_mad:
        fail(f"{label} disagrees with the golden (mean|d| {mad}, limit "
             f"{max_mad}, nan pixels {nan})")
    return {"launches": launches[kernel], "first_image": first,
            "first_stats": first_stats, "plan_launches": plan_launches}


def phase_main_paths(smi: str, golden) -> None:
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
                f"{got['launches']}, re-plan chain launches "
                f"{got['plan_launches']}, segments {stats['segments_exact']}")
        if stratified:
            d = (got["first_image"] - strat["first_image"]).abs().mean()
            line += (f", mean|d| vs the stratified fixed render of seed 0 "
                     f"{float(d):.3e}")
        print(line)
        if got["launches"] != ADAPTIVE_LAUNCHES:
            fail(f"{label}: {got['launches']} launches, expected "
                 f"{ADAPTIVE_LAUNCHES}")
        # a step of the chain after every chunk: 16 re-plans and the last
        # chunk's fold
        if got["plan_launches"] != ADAPTIVE_LAUNCHES:
            fail(f"{label}: {got['plan_launches']} launches of the re-plan "
                 f"chain, expected {ADAPTIVE_LAUNCHES}")
        if not (64 <= stats["mean_spp"] < spp) or lo < 64 or hi > spp:
            fail(f"{label}: sample counts out of range (mean "
                 f"{stats['mean_spp']}, min {lo}, max {hi})")
        if spp_map.shape != (h, w) or not torch.equal(spp_map,
                                                      spp_map.round()):
            fail(f"{label}: spp_map is not an (H, W) map of whole counts")


def phase_adaptive_replans(smi: str) -> None:
    """The re-plan chain (``csrc/adaptive_plan.cu``) at the shape of the
    benchmark cell cover-adaptive: the cover at 1200x800, 500 spp, depth
    50, no roulette, tolerance 0.2 (960,000 lanes: 235 tiles of sort keys,
    the passes' grids at their cap, merge passes up to runs of 524,288;
    the schedule [4] + [31] * 16), with the stratified and the random
    sampler, through ``render_image``. After every step of the chain,
    ``adaptive_plan.PlainPlan`` steps on the same chunk's outputs: the
    sums, chunk statistics, exact segments, lane order, lane map, budgets
    and live count must be bitwise. The render's sums and segments must be
    bitwise those of the same launches re-planned at full width, as the
    base revision re-planned them (``walk_ab.full_width_render``); the
    chain's launches, counted from just before the render, 17: 16
    re-plans and the last chunk's fold."""
    from raytracer_tpu_torch.render import adaptive_plan, megakernel
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scripts import walk_ab

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    steps, renders = [], []

    def same(a, b) -> bool:
        return (a is None and b is None) or (
            a is not None and b is not None and torch.equal(a, b))

    class Twin(adaptive_plan.CudaPlan):
        """The chain, with its plain twin stepped beside it."""

        def __init__(self, acc, width, tol, stratified, n_steps):
            self.plain = adaptive_plan.PlainPlan(acc.clone(), width, tol,
                                                 stratified)
            super().__init__(acc, width, tol, stratified, n_steps)

        def step(self, out, segs, cs):
            super().step(out, segs, cs)
            self.plain.step(out, segs, cs)
            bad = [name for name in ("acc", "stats", "segments", "order",
                                     "pixel_map", "budget")
                   if not same(getattr(self, name),
                               getattr(self.plain, name))]
            live = int(self.lives[min(self.index, len(self.lives) - 2)])
            if live != self.plain.live:
                bad.append(f"live {live} vs {self.plain.live}")
            steps.append((live, bad))

    def both(launch, sizes, width, height, opts, device):
        got = real_render(launch, sizes, width, height, opts, device)
        renders.append((sizes, got, walk_ab.full_width_render(
            launch, sizes, width, height, opts, device)))
        return got

    real_start = adaptive_plan.start
    real_render = megakernel._render_adaptive
    adaptive_plan.start = Twin
    megakernel._render_adaptive = both
    try:
        for stratified, seed in ((True, 7), (False, 2_147_483_659)):
            label = ("adaptive re-plans at the cell's shape, "
                     + ("stratified" if stratified else "random"))
            opts = dataclasses.replace(
                trace_options(0, depth, True, stratified),
                exhaust_black=False, near_zero_guard=False)
            steps.clear()
            renders.clear()
            reset_launch_counts()
            _, stats = render_once(scene, cam, w, h, spp, seed, opts)
            chain = adaptive_plan.CudaPlan.launches
            (sizes, (acc, seg), (acc_r, seg_r)), = renders
            sizes = list(sizes)
            lives = [live for live, _ in steps[:-1]]
            bad = [(k, b) for k, (_, b) in enumerate(steps) if b]
            sums_equal = torch.equal(acc, acc_r)
            print(f"[{label}] {w}x{h} {spp} spp d{depth} seed {seed}: "
                  f"schedule {sizes[0]} + {sizes[1]} x {len(sizes) - 1}, "
                  f"chain launches {chain}, live lanes after each re-plan "
                  f"{lives}, steps unlike the plain twin {bad}; against the "
                  f"full-width re-plans sums bitwise {sums_equal}, "
                  f"segments {int(seg)} vs {int(seg_r)}, mean_spp "
                  f"{stats['mean_spp']:.4f} [{smi}]")
            if sizes != [4] + [31] * 16 or w * h != 960_000:
                fail(f"{label}: not the cell's shape ({w}x{h}, {sizes})")
            if chain != ADAPTIVE_LAUNCHES or len(steps) != ADAPTIVE_LAUNCHES:
                fail(f"{label}: {chain} launches of the re-plan chain, "
                     f"expected {ADAPTIVE_LAUNCHES}")
            if bad:
                fail(f"{label}: the chain differs from its plain twin {bad}")
            if not sums_equal or int(seg) != int(seg_r):
                fail(f"{label}: the render differs from the full-width "
                     f"re-plans")
            if not lives[0] == w * h > lives[-1]:
                fail(f"{label}: the live set did not shrink: {lives}")
    finally:
        adaptive_plan.start = real_start
        megakernel._render_adaptive = real_render


def phase_walk_ab(smi: str) -> None:
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
        img, st = render_image(scene, cam, 512, 512, 500, 3,
                               TraceOptions(max_depth=50), None, True)
        launches = dict(cw.cluster_walk.launches_by_variant)
        print(f"[wide render] 512x512 500 spp d50: segments "
              f"{st['segments_exact']}, launches {launches} [{smi}]")
        if set(launches) != {"cluster_walk_wide"}:
            fail(f"the sphereflake rendered through {launches}")
        images.append(img)
    if not torch.equal(images[0], images[1]):
        fail("two sphereflake renders of one key differ")


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


def compare_flat(label: str, choice, pmap, budget, seed, offset, spp, w, h,
                 opts):
    """One flat-scan instantiation against its plain version (and its
    budget handling, where it has a budget); returns what :func:`compare`
    gives."""
    args = (choice.tables, pmap, seed, offset, spp, w, h, opts,
            choice.g_full, budget)
    got = compare(label, args, flat=True)
    if budget is not None:
        check_budget(label, got, budget)
    return got


def phase_flat_vs_plain() -> None:
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
    for name, (adaptive, stratified, split) in FLAT_KERNELS.items():
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
                compare_flat(f"{name} {shape} rr{rr}", choice, pmap, budget,
                             seed, offset, spp, w, h, opts)

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
        got = compare_flat(f"{label} identity map", choice,
                           cw.identity_map(w, h, "cuda"), None, seed, 0, 1,
                           w, h, opts)
        _, pmap = plan_from_cost(got["out"][3], w)
        compare_flat(f"{label} sorted map", choice, pmap, None, seed, 1, 1, w,
                     h, opts)
        del got, pmap
        torch.cuda.empty_cache()


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


def phase_cross_kernel(smi: str) -> None:
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


def phase_cover_flat(smi: str, golden) -> None:
    """The cover through the flat scan (``cluster_scan=False``): its own
    split (K2s, 184 full-logic slots of 487), and with the split off (K2).
    Held against the golden."""
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    depth = presets.get_config("cover")[5]
    for kernel, split in (("flat_scan_split", True), ("flat_scan", False)):
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5,
                            cluster_scan=False, split_scan=split)
        drive_path(f"cover through {kernel} rr5", kernel, opts, smi, golden,
                   (), GOLDEN_MAX_MAD)


def phase_baseline_configs(smi: str) -> None:
    """BASELINE configs 1-3 at bench.py's sizes, spp and depth, rr5,
    through ``render_image``: a first render with the launch counts, then
    seeds 1 and 2, the last render checked."""
    from raytracer_tpu_torch.render import schedule
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    for config in ("two_sphere", "three_sphere", "dof"):
        scene, cam, w, h, spp, depth = presets.get_config(config)
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5)
        _, launches = render_path(
            config, "flat_scan",
            lambda: render_once(scene, cam, w, h, spp, 0, opts))
        chunks = len(schedule.chunk_schedule(spp, schedule.pick_chunk_spp(
            spp, w * h, scene.count, depth, 5))[0])
        for seed in (1, 2):
            img, stats = render_once(scene, cam, w, h, spp, seed, opts)
        segs = stats["segments_exact"]
        nan = int(torch.isnan(img).any(-1).sum())
        print(f"[config {config}] {w}x{h} {spp} spp d{depth} rr5 through "
              f"flat_scan: launches {launches} (chunks {chunks}), segments "
              f"{segs}, nan_pixels {nan} [{smi}]")
        if (img.shape != (h, w, 3) or nan or not torch.isfinite(img).all()
                or launches != chunks or segs < w * h * spp):
            fail(f"config {config}: bad render")


def run_batches(step, state, scene, cam, frames: int):
    """``frames`` steps in batches of PROG_BATCH, one sync per batch
    (reading the batch's last segment count, as bench.py does). Returns
    the state and the segments of each batch's last frame."""
    segs = []
    done = 0
    while done < frames:
        n = min(PROG_BATCH, frames - done)
        for _ in range(n):
            state, aux = step(state, scene, cam)
        segs.append(int(aux["segments"]))
        done += n
    return state, segs


def drive_session(label: str, kernel: str, opts, smi: str, hints: bool):
    """One progressive session as bench.py drives it: PROG_FRAMES frames
    (session key 0) in batches, with the launch counts set to 0 just
    before them and read just after. Returns the state."""
    from raytracer_tpu_torch import init_render_state, make_step_fn

    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    kw = dict(static_scene=scene, static_camera=cam) if hints else {}
    step = make_step_fn(PROG_W, PROG_H, 1, opts, **kw)
    (state, segs), launches = render_path(
        label, kernel, lambda: run_batches(
            step, init_render_state(PROG_W, PROG_H, 0), scene, cam,
            PROG_FRAMES))
    if launches != PROG_FRAMES or state.frame != PROG_FRAMES:
        fail(f"{label}: {launches} launches for {PROG_FRAMES} frames")
    print(f"[{label}] {PROG_W}x{PROG_H} 1 spp/frame d{opts.max_depth}, "
          f"{PROG_FRAMES} frames in batches of {PROG_BATCH}: segments per "
          f"frame {segs[-1]}, launches {launches} [{smi}]")
    if not torch.isfinite(state.accum).all():
        fail(f"{label}: the running average is not finite")
    return state


def phase_progressive(smi: str) -> None:
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
    plain_acc = sessions["flat_scan"].accum
    hinted_acc = sessions["flat_scan_split"].accum
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

    equal, launches = render_path("stratified frames", kernel,
                                  frames_and_offline)
    print(f"[progressive stratified frames vs offline renders at "
          f"sample_offset i] {STRAT_CHECK_FRAMES} frames with static hints, "
          f"bitwise {equal}; launches {launches} [{smi}]")
    if not all(equal):
        fail("progressive: a stratified frame differs from its offline "
             "render")


def phase_flat_adaptive(smi: str) -> None:
    """Adaptive renders of the demo (1920x1080, 128 spp, depth 8, rr5,
    tolerance 0.2) through the four adaptive flat instantiations, each
    held against the fixed render of the same options and seed."""
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions

    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    for name, (adaptive, stratified, split) in FLAT_KERNELS.items():
        if not adaptive:
            continue
        fixed = TraceOptions(max_depth=PROG_DEPTH, russian_roulette_depth=5,
                             sampler="stratified" if stratified else "random",
                             split_scan=split)
        opts = dataclasses.replace(fixed, adaptive_tolerance=ADAPTIVE_TOL)
        (img, stats), launches = render_path(
            name, name, lambda: render_once(
                scene, cam, PROG_W, PROG_H, FLAT_ADAPTIVE_SPP, 0, opts))
        ref = render_image(scene, cam, PROG_W, PROG_H, FLAT_ADAPTIVE_SPP, 0,
                           fixed)
        mad = float((img - ref).abs().mean())
        spp_map = stats["spp_map"]
        print(f"[adaptive demo {name}] {PROG_W}x{PROG_H} up to "
              f"{FLAT_ADAPTIVE_SPP} spp d{PROG_DEPTH} rr5 tol {ADAPTIVE_TOL}:"
              f" launches {launches}, mean_spp {stats['mean_spp']:.4f}, "
              f"spp_map min {float(spp_map.min()):.0f} max "
              f"{float(spp_map.max()):.0f}, segments "
              f"{stats['segments_exact']}, mean|d| vs the fixed render "
              f"{mad:.4e} (limit {FLAT_ADAPTIVE_MAX_MAD}) [{smi}]")
        if (mad > FLAT_ADAPTIVE_MAX_MAD or not torch.isfinite(img).all()
                or not 64 <= stats["mean_spp"] < FLAT_ADAPTIVE_SPP
                or float(spp_map.min()) < 64):
            fail(f"adaptive demo {name}: bad render")


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


def phase_debug_vs_plain() -> None:
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
    for name, (flat, stratified) in DEBUG_KERNELS.items():
        marked = [0, 0]  # marker pixels, outline-dominated pixels
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
                marked = [marked[0] + blue, marked[1] + red]
                if shape != "crop" or rr != 5:
                    continue
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
        if min(marked) == 0:
            fail(f"{name}: the overlay drew no marker or no outline "
                 f"(pixels {marked})")


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


def engine_batches(eng, now, frames: int, check=None) -> None:
    """``frames`` ticks in batches of PROG_BATCH, each followed by a
    sync and ``check(batch)``. The ticks run with the sync debug mode
    raising on any call that waits for the device."""
    done = batch = 0
    while done < frames:
        n = min(PROG_BATCH, frames - done)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(n):
                now[0] += 16.0
                if not eng.tick(now[0]):
                    fail("the engine skipped a frame")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        done += n
        batch += 1
        if check is not None:
            check(batch)


def engine_session(smi: str, scene_name: str, kernel: str,
                   stratified: bool) -> None:
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
    engine_batches(eng, now, ENGINE_FRAMES, centre_is_blue)
    launches = launch_counts()
    if launches != {name: ENGINE_FRAMES}:
        fail(f"{label}: launches {launches}, not {ENGINE_FRAMES} of {name}")
    fb = eng.render_state.accum
    total, on_edge = silhouette_red(fb, uuid_map(eng.scene, eng.camera, w, h)
                                    == sel)
    finite = bool(torch.isfinite(fb).all())
    print(f"[{label}] overlay on, cursor {eng.app.cursor_point} selected "
          f"{sel}: {ENGINE_FRAMES} frames, launches {launches}; "
          f"centre pixel (0, 0, 1) after every batch; red-dominant pixels "
          f"{total}, on the selection's silhouette {on_edge}; finite "
          f"{finite}; no device sync inside a frame [{smi}]")
    if not finite or on_edge == 0:
        fail(f"{label}: bad overlay frame (finite {finite}, outline pixels "
             f"{on_edge})")

    # picks: a one-pixel mouse move each, back and forth
    for i in range(16):
        eng.handle_mouse_move(1.0 if i % 2 == 0 else -1.0, 0.0)
    if eng.app.selected_object != sel:
        fail(f"{label}: the pick moved off sphere {sel}")

    # the paused 25-spp still, saved and decoded
    path = os.path.join(ROOT, "build", f"engine_{scene_name}_{sampler}.png")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    eng.set_paused(True)
    eng.request_save(path)
    now[0] += 16.0
    if not eng.tick(now[0]):
        fail(f"{label}: the paused still did not render")
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
    engine_batches(eng, now, ENGINE_FRAMES)
    launches_off = launch_counts()
    print(f"[{label}] overlay off: next frame bitwise the plain step's "
          f"{same}; {ENGINE_FRAMES} frames, launches {launches_off} [{smi}]")
    if not same or launches_off != {plain_name: ENGINE_FRAMES}:
        fail(f"{label}: the frame after the overlay is off is not the plain "
             "step's")


def phase_engine(smi: str) -> None:
    """The interactive engine at 1280x720, 1 spp a frame, depth 8, with
    the overlay on: the cover (its static scene gets a cluster partition:
    K1 + debug) and the demo (9 spheres: K2 + debug, unsplit), each with
    the random and the stratified sampler. Unpause, overlay on, a mouse
    move that picks the sphere at the centre; 128 frames in batches of 32,
    no sync inside a frame, the centre pixel exactly (0, 0, 1) after each
    batch; red-dominant pixels on the selected sphere's silhouette; 16
    picks that stay on that sphere; a paused 25-spp still saved to a PNG
    and decoded; the overlay off restarts the average, the next frame is the
    plain step's bitwise, and 128 more frames run through the plain
    instantiation."""
    for scene_name, kernel in ENGINE_SCENES.items():
        for stratified in (False, True):
            engine_session(smi, scene_name, kernel, stratified)


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
            card = render_aov(scene, cam, w, h, mode)
            cpu = render_aov(scene, cam, w, h, mode, device="cpu")
            d = (card.cpu() - cpu).abs().amax(-1)
            equal = float((d == 0).float().mean())
            close = float((d <= 1e-5).float().mean())
            print(f"[aov {scene_name} {mode} {w}x{h}] the card against the "
                  f"CPU: max|d| {float(d.max()):.3e}, equal "
                  f"{equal:.6f}, within 1e-5 {close:.6f} [{smi}]")
            ok = (equal >= AOV_MIN_EQUAL if mode in ("uuid", "front") else
                  float(d.max()) <= AOV_MAX_DEPTH if mode == "depth" else
                  close >= AOV_NORMAL_SHARE
                  and float(d.max()) <= AOV_NORMAL_MAX)
            if not ok or card.shape != (h, w, 3):
                fail(f"aov {scene_name} {mode}: the card and the CPU "
                     "disagree")


#: the probes' sources in ``raytracer_tpu_torch/csrc``
PROBE_SOURCES = ("probe_chain", "probe_gather", "probe_scan")
#: the probes' instantiations. The float chain serves two: the issue-rate
#: probe (P3) and the roofline's ceiling (P2), each counted on its own
#: path
PROBE_KERNELS = ("probe_chain_f32", "probe_chain_bf16",
                 "probe_chain_f32_roofline", "probe_gather_axis0",
                 "probe_gather_onehot", "probe_gather_axis1",
                 *(f"probe_scan_{b}" for b in (512, 64, 32, 8)))
# kernel vs plain version on the card: the chains at few trips (a plain
# trip is 32 operator calls), the gathers at the script's 5000, the scans
# at few trips (a plain trip of the card-filling rays is 25 calls on
# 69M-element tensors). All bitwise: the same operations, each rounded on
# its own; sqrtf and torch.sqrt are both correctly rounded on the card.
PROBE_CHAIN_CHECK_ITERS = 40
PROBE_SCAN_CHECK_ITERS = {"tpu": 50, "fill": 5}
# the issue line (utils/profiling.py card_lines: SMs x 128 x the highest
# clock) holds when the card-filling float32 chain comes within this
# share of it; else the run fails
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


def phase_probes_vs_plain() -> None:
    """Every probe instantiation against its plain version on the card, at
    the TPU's shape and at the card-filling one: the chains (float32 and
    bf16), the gathers (every case of probe_mosaic_gather.py, one replica
    and the card-filling count) and the scans (every block), bitwise."""
    from raytracer_tpu_torch.scripts import bench_bf16_chain as bc
    from raytracer_tpu_torch.scripts import bench_scan_layout as bs
    from raytracer_tpu_torch.scripts import probe_gather as pg

    it = PROBE_CHAIN_CHECK_ITERS
    for dtype, name in bc.VARIANTS.items():
        for rows in (bc.TPU_ROWS, bc.FILL_ROWS):
            x = bc.chain_input(rows, dtype, "cuda")
            held(f"{name} ({rows},128) x{it}", bc.chain(x, it),
                 bc.chain_plain(x, it))
        print(f"[probe vs plain] {name}: bitwise at ({bc.TPU_ROWS},128) and "
              f"({bc.FILL_ROWS},128), {it} trips")
    for label, mode, shape, rows in pg.CASES:
        tbl = pg.gather_table(shape).cuda()
        reps = pg.fill_reps(mode, rows, shape[1])
        for r in (1, reps):
            held(f"{label} x{r}", pg.gather_probe(tbl, mode, rows, pg.ITERS,
                                                  r),
                 pg.gather_probe_plain(tbl, mode, rows, pg.ITERS, r))
        print(f"[probe vs plain] {label} ({pg.variant_name(mode)}): bitwise "
              f"at x1 and x{reps}, {pg.ITERS} trips")
    sph = bs.scan_table().cuda()
    for block in bs.BLOCKS:
        name = bs.variant_name(block)
        for shape, rows in (("tpu", bs.R_SUB), ("fill", bs.FILL_ROWS)):
            n = PROBE_SCAN_CHECK_ITERS[shape]
            held(f"{name} ({rows},128) x{n}", bs.scan_probe(sph, block, rows,
                                                            n),
                 bs.scan_probe_plain(sph, block, rows, n))
        print(f"[probe vs plain] {name}: bitwise at ({bs.R_SUB},128) x"
              f"{PROBE_SCAN_CHECK_ITERS['tpu']} and ({bs.FILL_ROWS},128) x"
              f"{PROBE_SCAN_CHECK_ITERS['fill']}")


def phase_probe_ab(smi: str) -> None:
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


def phase_probe_paths(smi: str) -> None:
    """The probes' entry points as a user runs them, each with the launch
    counts set to 0 just before it and read just after: the chain
    (float32 and bf16 at 16 and 2112 rows), the gathers (the script's six
    cases, then card-filling replicas), the scans (every block at 8 rows
    and at 1056) and the roofline (its ceiling chain and the cover through
    the flat scan). The outputs are checked, every instantiation must
    launch, and the float32 chain must come within INSTR_LINE_TOLERANCE
    of the issue line."""
    from raytracer_tpu_torch.scripts import bench_bf16_chain as bc
    from raytracer_tpu_torch.scripts import bench_scan_layout as bs
    from raytracer_tpu_torch.scripts import probe_gather as pg
    from raytracer_tpu_torch.scripts import roofline

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

    pg.reset_launch_counts()
    gather = pg.main()
    launches.update(pg.gather_probe.launches_by_variant)
    for label, mode, shape, r in pg.CASES:
        case = gather["cases"][label]
        want = pg.gather_probe_plain(pg.gather_table(shape), mode, r,
                                     pg.ITERS)[0]
        for kind in ("tpu", "fill", "library"):
            if not torch.equal(case[kind]["out"], want):
                fail(f"gather {label} ({kind}): the main path's output "
                     "differs from the plain version")
        print(f"[probe gather] {label}: the kernel alone, with "
              f"{case['fill']['reps']} replicas and torch.gather's same "
              f"work all equal the plain version [{smi}]")

    bs.reset_launch_counts()
    scan = bs.main()
    launches.update(bs.scan_probe.launches_by_variant)
    for kind in ("tpu", "fill"):
        got = [b[kind]["out"] for b in scan["blocks"].values()]
        if not all(torch.isfinite(o).all() for o in got):
            fail(f"scan ({kind}): a non-finite output")
        if not all(torch.equal(got[0], o) for o in got[1:]):
            fail(f"scan ({kind}): the blocks disagree")

    bc.reset_launch_counts()
    roof = roofline.main()
    launches["probe_chain_f32_roofline"] = bc.chain.launches_by_variant.get(
        "probe_chain_f32", 0)
    near = abs(roof["chain_telops"] / roof["issue_line_telops"] - 1.0)
    print(f"[roofline] the float32 chain at {roof['chain_telops']:.4f} "
          f"Telem-ops/s is {roof['chain_telops'] / roof['issue_line_telops']:.4f}"
          f" of the issue line ({roof['issue_line_telops']:.4f} T) [{smi}]")
    if near > INSTR_LINE_TOLERANCE:
        fail(f"roofline: the float32 chain is {near:.1%} off the issue line "
             f"(at most {INSTR_LINE_TOLERANCE:.0%})")
    if not (np.isfinite(roof["cover_mrays"]) and roof["segments"] > 0):
        fail("roofline: no cover render")
    print(f"[probe paths] launches {launches} [{smi}]")
    for name in PROBE_KERNELS:
        if launches.get(name, 0) < 1:
            fail(f"{name}: no launch on the probes' paths")


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
    the process."""
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                            env={**os.environ, **(env or {})},
                            stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_module(proc, label: str):
    """Waits for a :func:`start_module` process; fails on a non-zero
    exit. Returns its stdout and stderr."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}\n{out[-2000:]}\n"
             f"{err[-4000:]}")
    return out, err


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


def phase_cli(smi: str) -> None:
    """``python -m raytracer_tpu_torch.app.cli`` on the card, each run in
    its own process, side by side: every PNG (and the adaptive run's spp
    map) byte for byte the PNG of the same call in this process, whose
    launches are its kernel's alone."""
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
    started = {label: start_module(runs[label][0]) for label in runs}
    done = {label: finish_module(p, f"cli {label}")
            for label, p in started.items()}
    for label, (flags, kernel) in CLI_RUNS.items():
        stdout, _ = done[label]
        _, out, spp_map = runs[label]
        reset_launch_counts()
        want, want_map = cli_in_process(flags)
        launches = launch_counts()
        if kernel is not None and (launches.get(kernel, 0) < 1 or set(
                launches) != {kernel}):
            fail(f"cli {label}: the in-process call ran {launches}, not "
                 f"{kernel} alone")
        with open(out, "rb") as f:
            same = f.read() == want
        if spp_map is not None:
            with open(spp_map, "rb") as f:
                same = same and f.read() == want_map
        said = stdout.strip().splitlines()[-1] if stdout.strip() else ""
        print(f"[cli {label}] {' '.join(flags)}: exit 0, {said!r}; PNG "
              f"byte-identical to the same call in this process {same}; "
              f"launches {launches} [{smi}]")
        if not same:
            fail(f"cli {label}: the PNG differs from the in-process render")


def phase_bench_line(smi: str) -> None:
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
        stdout, stderr = finish_module(
            start_module(["raytracer_tpu_torch.bench"], env),
            f"bench {label}")
        out = stdout.strip().splitlines()
        if len(out) != 1:
            fail(f"bench {label}: {len(out)} lines on stdout")
        line = lines[label] = json.loads(out[0])
        print(f"[bench {label}] stderr: "
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


def run_viewer_captured(config: str, display: str):
    """``run_viewer`` off a tty (stdin from /dev/null, stdout captured):
    the frames drawn, the output and the engine."""
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
                n = viewer.run_viewer(config, VIEWER_W, VIEWER_H,
                                      max_frames=VIEWER_FRAMES,
                                      target_fps=1e6, display=display)
            finally:
                sys.stdin = stdin
    finally:
        viewer.Engine = real
    return n, out.getvalue(), made[0]


def phase_viewer(smi: str) -> None:
    """The terminal viewer headless at 320x180 on the demo and the cover,
    64 frames with each display: frames drawn, the framebuffer finite,
    ``kitty_frame`` of it round-trips to ``tonemap_u8``."""
    import base64

    from raytracer_tpu_torch.app.display import (
        kitty_frame,
        parse_kitty_commands,
    )
    from raytracer_tpu_torch.app.io import decode_png, tonemap_u8

    for config in ("demo", "cover"):
        for display in ("ansi", "kitty"):
            reset_launch_counts()
            n, out, eng = run_viewer_captured(config, display)
            launches = launch_counts()
            fb = eng.framebuffer()
            payload = "".join(c for _, c in parse_kitty_commands(
                kitty_frame(fb))[1:])
            round_trip = np.array_equal(
                decode_png(base64.standard_b64decode(payload)),
                tonemap_u8(fb))
            drawn = ("\x1b[38;2;" in out if display == "ansi"
                     else "\x1b_Ga=T,f=100" in out)
            print(f"[viewer {config} {display}] {VIEWER_W}x{VIEWER_H}, {n} "
                  f"frames: frames drawn {drawn}; finite "
                  f"{bool(np.isfinite(fb).all())}; kitty round trip "
                  f"{round_trip}; render_count "
                  f"{eng.render_state.render_count}; launches {launches} "
                  f"[{smi}]")
            if (n != VIEWER_FRAMES or not drawn or not round_trip
                    or not np.isfinite(fb).all()
                    or eng.render_state.render_count != VIEWER_FRAMES):
                fail(f"viewer {config} {display}")


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
    ticked = eng.tick(now)
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
    img0, stats0 = render_once(scene, cam, w, h, spp, 0,
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
        img1, stats1 = render_once(scene, cam, w, h, spp, 0,
                                   trace_options(5, depth))
    finally:
        pallas_kernel.render = real_render
        logging.getLogger("raytracer_tpu_torch.utils.resilience") \
            .removeHandler(handler)
    render_same = (torch.equal(img0, img1) and stats0["segments_exact"]
                   == stats1["segments_exact"])
    print(f"[fault recovery] engine (cover {ENGINE_W}x{ENGINE_H}, overlay "
          f"on): the faulted tick returned {ticked}, render_count {count} "
          f"after it; the next {OOM_AFTER_FRAMES} frames bitwise a fresh "
          f"engine's {same} (launches {launches}); render_image (cover rr5) "
          f"with one OOM bitwise the render without it {render_same}; "
          f"warnings {logged} [{smi}]")
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
        img, stats = render_image_sharded_pallas(
            scene, cam, w, h, spp, 0, mesh, opts, return_stats=True)
        launches = launch_counts()
        ref, ref_stats = render_image(scene, cam, w, h, spp, 0, opts,
                                      return_stats=True)
        got[label] = {"bitwise": bool(torch.equal(img, ref)
                                      and same_stats(stats, ref_stats)),
                      "segments": stats["segments_exact"],
                      "ref_segments": ref_stats["segments_exact"],
                      "launches": launches, "collectives": dict(issued)}
    scene, cam, _ = demo_inputs(PROG_W, PROG_H)
    opts = TraceOptions(max_depth=PROG_DEPTH)
    step = make_sharded_step_fn(PROG_W, PROG_H, mesh, 1, opts)
    state = shard_render_state(init_render_state(PROG_W, PROG_H, 0), mesh)
    reset_launch_counts()
    issued.clear()
    state, segs = shard_frames(step, state, scene, cam, SHARD_FRAMES)
    launches = launch_counts()
    accum = gather_rows(state.accum, mesh)
    collectives = dict(issued)
    ref, ref_segs = shard_frames(
        make_step_fn(PROG_W, PROG_H, 1, opts),
        init_render_state(PROG_W, PROG_H, 0), scene, cam, SHARD_FRAMES)
    got["progressive"] = {
        "bitwise": bool(torch.equal(accum, ref.accum) and segs == ref_segs),
        "segments": sum(segs), "launches": launches,
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
    img, stats = render_image_sharded(
        scene, cam, w, h, JNP_SHARD_SPP, 0, mesh,
        jnp_options(max_depth=PROG_DEPTH), return_stats=True)
    got = {"jnp render": {"image": img.cpu(), "segments":
                          stats["segments_exact"],
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
        img, stats = render_image_sharded_pallas(
            scene, cam, w, h, spp, 0, mesh, opts, return_stats=True)
        launches = launch_counts()
        img2, stats2 = render_image_sharded_pallas(
            scene, cam, w, h, spp, 0, mesh,
            dataclasses.replace(opts, **variant), return_stats=True)
        got[label] = {
            "image": img.cpu() if rank0 else None,
            "spp_map": stats["spp_map"].cpu() if rank0 and adaptive
            else None,
            "stats": {k: v for k, v in stats.items() if k != "spp_map"},
            "launches": launches,
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
    state, segs = shard_frames(step, state, scene, cam, SHARD_FRAMES)
    launches = launch_counts()
    accum = gather_rows(state.accum, mesh)
    return {"accum": accum.cpu() if dist.get_rank() == 0 else None,
            "segments": segs, "launches": launches}


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
    ref, ref_stats = render_once(scene, cam, w, h, spp, 0,
                                 trace_options(5, depth))
    ref = ref.cpu()
    pscene, pcam, _ = demo_inputs(PROG_W, PROG_H)
    pref, pref_segs = shard_frames(
        make_step_fn(PROG_W, PROG_H, 1, TraceOptions(max_depth=PROG_DEPTH)),
        init_render_state(PROG_W, PROG_H, 0), pscene, pcam, SHARD_FRAMES)

    one = run_ranks(shard_world_one, 1, backend="nccl")[0]
    print(f"[sharding (1, 1) nccl on {one['device']}] [{smi}]")
    for label, kernel in (("cover rr5", "cluster_walk"),
                          ("adaptive stratified cover",
                           "cluster_walk_adaptive_stratified"),
                          ("progressive", "flat_scan")):
        got = one[label]
        print(f"[sharding (1, 1) {label}] bitwise the single-device call "
              f"{got['bitwise']}, segments {got['segments']}, launches "
              f"{got['launches']}, NCCL collectives {got['collectives']} "
              f"[{smi}]")
        mesh_launches(f"(1, 1) {label}", got["launches"], kernel)
        if not (got["collectives"].get("all_reduce")
                and got["collectives"].get("all_gather")):
            fail(f"(1, 1) mesh: {label} issued no NCCL all-reduce or no "
                 f"all-gather: {got['collectives']}")
        if not got["bitwise"]:
            fail(f"(1, 1) mesh: {label} differs from the single-device call")

    four = run_ranks(shard_world_four, 4)
    print(f"[sharding 4 gloo ranks] the ranks share one card [{smi}]")
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
                f"] launches of rank 0 {got['launches']}, golden mean|d| "
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

    got = run_ranks(shard_world_three, 3)[0]
    bitwise = (torch.equal(got["accum"], pref.accum.cpu())
               and got["segments"] == pref_segs)
    print(f"[sharding (3,) progressive {PROG_W}x{PROG_H} {SHARD_FRAMES} "
          f"frames] launches of rank 0 {got['launches']}; bitwise the "
          f"single step's {bitwise}; the ranks share one card [{smi}]")
    mesh_launches("(3,) progressive", got["launches"], "flat_scan")
    if not bitwise:
        fail("the (3,) progressive frames differ from the single step's")


# --- the import surface: render_image_pallas and entry() ------------------

#: frames of entry()'s step after the profiled batch
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
    - entry-demo: ``python -m raytracer_tpu_torch.entry`` in its own
      process, its line the same step's in this one; then ``entry()``'s
      step (the demo at 256x144, 1 spp, d8): bitwise a directly built
      ``make_step_fn`` frame with one launch of K2, K2 ``<0,0,0,0,b>``
      and no other kernel of the renderer under the profiler over
      PROG_BATCH steps (the wrapper counting one launch a step), K2
      bitwise its plain version on the step's own tables and lane map,
      ENTRY_FRAMES more frames finite."""
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
    from torch.profiler import ProfilerActivity, profile

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts, dcam = trace_options(5, depth), derive_camera(cam)

    (img_p, st_p), launches = render_path(
        "pallas-cover", "cluster_walk", lambda: render_image_pallas(
            scene, dcam, w, h, spp, 0, opts, return_stats=True))
    img_r, st_r = render_once(scene, cam, w, h, spp, 0, opts)
    same = (torch.equal(img_p, img_r)
            and st_p["segments_exact"] == st_r["segments_exact"])
    im = img_p.cpu().numpy().astype(np.float64)
    mad = float(np.abs(im - golden).mean())
    segs = st_p["segments_exact"]
    print(f"[pallas-cover] render_image_pallas {w}x{h} {spp} spp "
          f"d{depth} rr5: launches {launches} of cluster_walk alone; image "
          f"and segments_exact ({segs} against {st_r['segments_exact']}) "
          f"bitwise render_image's {same}; golden mean|d| {mad:.3e} "
          f"[{smi}]")
    if not same:
        fail("pallas-cover: render_image_pallas differs from render_image")
    if im.shape != golden.shape or not np.isfinite(im).all() \
            or mad > GOLDEN_MAX_MAD:
        fail(f"pallas-cover disagrees with the golden (mean|d| {mad})")

    out, _ = finish_module(start_module(["raytracer_tpu_torch.entry"]),
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
    print(f"[entry-demo] python -m raytracer_tpu_torch.entry: {line!r}; in "
          f"this process the step's segments {seg}, launches {n_launch} of "
          f"flat_scan alone, the frame bitwise a direct make_step_fn frame "
          f"{direct} [{smi}]")
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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batch()
        torch.cuda.synchronize()
    counted = launch_counts()
    # (name, count) of the renderer's kernels that ran on the device
    kernels = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and "_kernel<" in e.key and (
                "flat_scan" in e.key or "cluster_walk" in e.key):
            kernels.append((e.key, e.count))
    print(f"[entry-demo] {PROG_BATCH} steps under the profiler: launches "
          f"{counted}; the renderer's kernel rows {kernels} [{smi}]")
    if (counted != {"flat_scan": PROG_BATCH} or len(kernels) != 1
            or not 1 <= kernels[0][1] <= PROG_BATCH
            or K2_PROFILE_NAME not in kernels[0][0]):
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

    state = dataclasses.replace(state0, accum=state0.accum.clone())
    for _ in range(ENTRY_FRAMES):
        state, aux = step(state, *args[1:])
    print(f"[entry-demo] {WIDTH}x{HEIGHT} 1 spp d8, {ENTRY_FRAMES} frames: "
          f"segments of the last {int(aux['segments'])} [{smi}]")
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
    1,048,577 under three keys, on the card: bit for bit the CPU's."""
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
          f"CPU's (seeds {JNP_RNG_SEEDS}, P {JNP_RNG_SIZES}) [{smi}]")


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
        img, st = render_image(scene, cam, JNP_W, JNP_H, JNP_SPP, JNP_SEED,
                               opts, return_stats=True)
        no_kernel_launched(f"jnp golden {name}")
        cpu, cst = render_image(scene, cam, JNP_W, JNP_H, JNP_SPP, JNP_SEED,
                                opts, return_stats=True, device="cpu")
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      f"{name}_64x36_spp32_d8.npy"))
        g = image_bounds(img.cpu(), golden)
        c = image_bounds(img.cpu(), cpu)
        print(f"[jnp golden {name}] {JNP_W}x{JNP_H} {JNP_SPP} spp "
              f"d{JNP_DEPTH} on the card: against the golden "
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
    means."""
    from raytracer_tpu_torch.render import api
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, _, depth = presets.get_config("cover")
    opts = jnp_options(max_depth=depth)
    band = api._jnp_band_rows(w, h, scene.count, depth)
    bands = [min(band, h - r) for r in range(0, h, band)]
    if bands != [168] * 4 + [128] or api._jnp_chunk_spp(
            JNP_COVER_SPP, w * band, scene.count, depth) != 1:
        fail(f"jnp cover: bands {bands}, not the JAX package's")
    reset_launch_counts()
    img, st = render_once(scene, cam, w, h, JNP_COVER_SPP, 0, opts)
    no_kernel_launched("jnp cover")
    kern, kst = render_once(scene, cam, w, h, JNP_COVER_SPP, 0,
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
          f"{JNP_COVER_SPP} spp through bands {bands}: {segs} segments "
          f"(exact); NaN pixels {nan_px}; the kernels' rr0 render at "
          f"{JNP_COVER_SPP} spp {kst['segments_exact']} segments [{smi}]")
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


def phase_jnp_convergence(smi: str):
    """``python -m raytracer_tpu_torch.bench`` with BENCH_CONVERGENCE=1 in
    its own process: the kernels at rr5 on the 304x200 crop against the
    jnp tracer at rr0 in 10-spp chunks under ``fold_in(key, 1000 +
    done)``, at JNP_CONV_SPP spp."""
    env = {"BENCH_CONVERGENCE": "1", "BENCH_SPP": str(JNP_CONV_SPP)}
    stdout, stderr = finish_module(
        start_module(["raytracer_tpu_torch.bench"], env), "bench convergence")
    out = stdout.strip().splitlines()
    line = json.loads(out[-1])
    keys = BENCH_LINE_KEYS | {"convergence_mad_vs_jnp", "convergence_nan_px"}
    print(f"[jnp convergence] BENCH_CONVERGENCE=1 BENCH_SPP={JNP_CONV_SPP}: "
          f"stderr: "
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
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(JNP_PROG_FRAMES):
                state, aux = step(state, scene, cam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        no_kernel_launched(f"jnp progressive {sampler}")
        line = (f"[jnp progressive {sampler}] demo {PROG_W}x{PROG_H} 1 "
                f"spp/frame d{PROG_DEPTH}, {JNP_PROG_FRAMES} frames: last "
                f"frame {int(aux['segments'])} segments; no device sync "
                f"inside a frame")
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
        stdout, _ = finish_module(started[label], f"jnp cli {label}")
        reset_launch_counts()
        want, _ = cli_in_process(flags)
        no_kernel_launched(f"jnp cli {label}")
        with open(flags[-1], "rb") as f:
            same = f.read() == want
        print(f"[jnp cli {label}] {' '.join(flags[:-2])}: "
              f"{stdout.strip().splitlines()[-1]}; PNG "
              f"byte-identical to the same call in this process {same} "
              f"[{smi}]")
        if not same:
            fail(f"jnp cli {label}: the PNG differs from the in-process call")
    stdout, stderr = finish_module(started["bench"], "jnp bench")
    out = stdout.strip().splitlines()
    line = json.loads(out[-1])
    print(f"[jnp bench two_sphere] stderr: "
          + " | ".join(stderr.strip().splitlines()))
    print(json.dumps(line))
    if (len(out) != 1 or set(line) != BENCH_LINE_KEYS
            or line["backend"] != "jnp" or not line["value"] > 0):
        fail(f"jnp bench: keys {sorted(set(line) ^ BENCH_LINE_KEYS)} or "
             f"backend {line.get('backend')}")
    stdout, _ = finish_module(started["viewer"], "jnp viewer")
    drawn = stdout.count("\x1b[38;2;") > 0
    print(f"[jnp viewer] --backend jnp --max-frames {JNP_VIEWER_FRAMES}, "
          f"headless: exit 0; frames drawn {drawn} [{smi}]")
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
    engine_batches(eng, now, JNP_ENGINE_FRAMES, centre_is_blue)
    no_kernel_launched("jnp engine")
    fb = eng.render_state.accum
    total, on_edge = silhouette_red(fb, uuid_map(eng.scene, eng.camera, w, h)
                                    == sel)
    print(f"[jnp engine demo {w}x{h} d{ENGINE_DEPTH}] overlay on, selected "
          f"{sel}: {JNP_ENGINE_FRAMES} frames; centre "
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
              f"{JNP_SHARD_H} {JNP_SHARD_SPP} spp: "
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


def phase_motion_walk(smi: str) -> None:
    """The motion walk on *The Next Week*'s bouncing spheres at the cell
    bouncing-offline's shape (1200x675, depth 50, no roulette): a 2-spp
    launch of each sampler on the identity map bitwise its plain version
    on the card, its bounce count its segments' sum and its member tests
    a multiple of the cluster size; the cover with its spheres still and
    its ground a one-colour checker, through ``render_image``, bitwise
    the narrow walk's render of the cover; two renders of the cell at 500
    spp through ``render_image``, every launch the motion walk's, bitwise
    each other, finite."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import megakernel
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scene.materials import Material
    from raytracer_tpu_torch.scene.spheres import update_sphere
    from raytracer_tpu_torch.utils import profiling

    w, h = 1200, 675
    scene = presets.bouncing_spheres_scene().to("cuda")
    cam = presets.bouncing_camera(w, h)
    for sampler in ("random", "stratified"):
        opts = TraceOptions(max_depth=50, sampler=sampler)
        choice = megakernel.choose_kernel(scene, derive_camera(cam), opts,
                                          "cuda")
        tabs = choice.tables
        args = (tabs, cw.identity_map(w, h, "cuda"), 0x2545F491, 41, 2, w,
                h, opts)
        profiling.reset_counters()
        out_k, seg_k = cw.cluster_walk(*args)
        got = profiling.counters()
        out_p, seg_p = cw.cluster_walk_plain(*args)
        same = torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)
        tests, bounces = (got.get(name, (0, 0.0))[0]
                          for name in cw.MOTION_COUNTS)
        segs = int(seg_k.sum(dtype=torch.int64))
        group = tabs.members.shape[1]
        print(f"[motion vs plain {sampler}] {w}x{h} 2 spp d50: bitwise "
              f"{same}, segments {segs}, counted bounces {bounces}, member "
              f"tests {tests} ({tests / max(bounces, 1):.2f} a bounce), "
              f"clusters {tabs.members.shape[0]}, globals "
              f"{tabs.globals.shape[0]}")
        if not same:
            fail(f"the motion walk disagrees with its plain version "
                 f"({sampler})")
        if bounces != segs or tests % group or not tests:
            fail("the motion walk's counts disagree with its segments")
    # a still scene through the motion walk is the narrow walk's render
    cover = presets.cover_scene()
    ground = Material.checker((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    still = update_sphere(cover, 0, material=ground).to("cuda")
    cam_c = presets.cover_camera(400, 225)
    opts = TraceOptions(max_depth=50)
    images = {}
    for name, sc in (("narrow", cover.to("cuda")), ("motion", still)):
        reset_launch_counts()
        img, st = render_image(sc, cam_c, 400, 225, 16, 5, opts, None, True)
        images[name] = (img, st["segments_exact"], launch_counts())
    print(f"[motion still] cover 400x225 16 spp: launches "
          f"{images['narrow'][2]} / {images['motion'][2]}")
    if set(images["motion"][2]) != {"cluster_walk_motion"}:
        fail(f"the still cover rendered through {images['motion'][2]}")
    if not (torch.equal(images["narrow"][0], images["motion"][0])
            and images["narrow"][1] == images["motion"][1]):
        fail("the motion walk's still cover is not the narrow walk's")
    renders = []
    for _ in range(2):
        reset_launch_counts()
        img, st = render_image(scene, cam, w, h, 500, 11,
                               TraceOptions(max_depth=50), None, True)
        launches = launch_counts()
        print(f"[motion render] {w}x{h} 500 spp d50: segments "
              f"{st['segments_exact']}, launches {launches} [{smi}]")
        if set(launches) != {"cluster_walk_motion"}:
            fail(f"the bouncing spheres rendered through {launches}")
        if not torch.isfinite(img).all():
            fail("the bouncing spheres' render is not finite")
        renders.append(img)
    if not torch.equal(renders[0], renders[1]):
        fail("two renders of the bouncing spheres of one key differ")


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
    timed(phase_kernel_vs_plain)
    timed(phase_variants_vs_plain)
    timed(phase_flat_vs_plain)
    golden = np.load(GOLDEN)["image"].astype(np.float64)
    timed(phase_main_paths, smi, golden)
    timed(phase_adaptive_replans, smi)
    timed(phase_walk_ab, smi)
    timed(phase_wide_walk, smi)
    timed(phase_motion_walk, smi)
    timed(phase_cross_kernel, smi)
    timed(phase_cover_flat, smi, golden)
    timed(phase_baseline_configs, smi)
    timed(phase_progressive, smi)
    timed(phase_flat_adaptive, smi)
    timed(phase_debug_vs_plain)
    timed(phase_engine, smi)
    timed(phase_aov, smi)
    timed(phase_probes_vs_plain)
    timed(phase_probe_ab, smi)
    timed(phase_probe_paths, smi)
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
    t_all = time.perf_counter() - t_start
    print(f"[phase time] all {t_all:.1f} s; the jnp phases "
          f"{t_jnp:.1f} s of it, a share of {t_jnp / t_all:.3f}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
