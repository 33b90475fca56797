"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the port from ``raytracer_tpu_torch/csrc`` (the
cluster walk and its adaptive, stratified and adaptive + stratified
instantiations), holds each against its plain PyTorch version on the
card, and drives the port's paths through ``render_image`` on the RTiOW
cover (1200x800, 500 spp, depth 50):

- the fixed-spp render with Russian roulette from bounce 5, then without;
- the same with the stratified sampler;
- the adaptive render (tolerance 0.2) with the stratified sampler, and
  with the random one.

Every image is checked against the committed golden
(``tests/goldens/cover_jnp_rr0_500spp_f16.npz``); each kernel is timed at
its path's shapes beside its operation bound; one JSON line carries the
kernels' numbers. Any failed phase ends the run with a nonzero exit. The
last line of output is ``{"ok": true, "device": {...}}``.

Needs CUDA and one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "cover_jnp_rr0_500spp_f16.npz")
SOURCE = "raytracer_tpu_torch/csrc/cluster_walk.cu"

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

# operations the kernel source does per unit of work, transcendentals
# counted as one: per walk iteration (ray dot products, direction
# reciprocals, done tests), per cluster box per iteration (slab test,
# key packing, two-key extraction), per member sphere tested (exact
# quadratic and update), per completed bounce besides the globals
# (winner lookup, normal, scatter draws and arithmetic, roulette,
# accumulation), per global sphere tested at a bounce's start, and per
# sample (camera ray)
OPS_ITER, OPS_BOX, OPS_MEMBER, OPS_BOUNCE, OPS_GLOBAL, OPS_SAMPLE = (
    40, 37, 30, 150, 30, 90)
# the adaptive instantiation adds, per completed bounce, the luminance
# (two sums, a product), its square and the sum of squares
OPS_BOUNCE_ADAPTIVE = 5
# the stratified instantiation: each of the four camera draws forms
# index·alpha + rotation hash where the hashed draw forms a counter sum
# (+1 each), and the first bounce's diffuse direction takes 2 Kronecker
# draws, a root, a sine and a cosine (36) where the hashed one takes 3
# draws, exp, log, a root and a normalisation (62); counted for every
# sample, so the bound errs low
OPS_SAMPLE_STRATIFIED = 4 - 26
FP32_PEAK = 67e12  # H100 SXM, FLOP/s outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s

#: kernel name → (adaptive, stratified, file:line of the TPU kernel's branch)
KERNELS = {
    "cluster_walk": (False, False,
                     "raytracer_tpu/render/pallas_kernel.py:216"),
    "cluster_walk_adaptive": (True, False,
                              "raytracer_tpu/render/pallas_kernel.py:1300"),
    "cluster_walk_stratified": (False, True,
                                "raytracer_tpu/render/pallas_kernel.py:366"),
    "cluster_walk_adaptive_stratified": (
        True, True, "raytracer_tpu/render/pallas_kernel.py:1316"),
}


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from raytracer_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all(["cluster_walk"])
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for line in cuda_build.build_log("cluster_walk").splitlines():
        if "registers" in line or "spill" in line:
            print("[ptxas]", line.strip())
        elif "Compiling" in line:
            # the mangled name carries the template arguments as Lb0E / Lb1E
            m = re.search(r"Lb([01])ELb([01])E", line)
            inst = (f" <adaptive={m.group(1)}, stratified={m.group(2)}>"
                    if m else "")
            print("[ptxas]", line.strip() + inst)


def trace_options(rr: int, depth: int, adaptive=False, stratified=False):
    from raytracer_tpu_torch.render.options import TraceOptions

    return TraceOptions(
        max_depth=depth, russian_roulette_depth=rr,
        adaptive_tolerance=ADAPTIVE_TOL if adaptive else 0.0,
        sampler="stratified" if stratified else "random",
    )


def walk_inputs(rr: int, width: int | None, height: int | None, depth,
                adaptive=False, stratified=False):
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import tables
    from raytracer_tpu_torch.scene import presets

    scene, cam, *_ = presets.get_config("cover", width, height)
    opts = trace_options(rr, depth, adaptive, stratified)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), "cuda")
    return tabs, opts


def compare(label: str, args) -> dict:
    """The kernel and its plain version on the same inputs; fails above
    the bounds."""
    from raytracer_tpu_torch.render import cluster_walk as cw

    out_k, seg_k = cw.cluster_walk(*args)
    out_p, seg_p = cw.cluster_walk_plain(*args)
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
            "seg_lanes": seg_k, "segs": sk}


def phase_kernel_vs_plain() -> dict:
    """The kernel against its plain version: on the crop (rr5, rr0, and a
    shuffled lane map against the identity), then at the main path's
    shapes (the full frame, depth 50, the cover's tables) with few
    samples, under the identity map of the profile chunk and the sorted
    map of the later chunks."""
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render.megakernel import plan_from_cost
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
            result.update(crop_times(args))
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
    return result


def crop_times(args) -> dict:
    """Kernel and plain version timed on the crop's inputs."""
    from raytracer_tpu_torch.render import cluster_walk as cw

    crop_ms = cuda_ms(lambda: cw.cluster_walk(*args), 3)
    t0 = time.perf_counter()
    cw.cluster_walk_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"[crop {CROP_W}x{CROP_H} x{CROP_SPP} spp d{CROP_DEPTH} "
          f"{cw.variant_name(args[7])}] kernel {crop_ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms")
    return {"crop_ms": crop_ms, "plain_ms": plain_ms}


def phase_variants_vs_plain() -> dict:
    """The stratified, adaptive and adaptive + stratified instantiations
    against the plain version at a nonzero sample offset: on the crop
    (rr5 and rr0), then at their paths' shapes (the full frame, depth 50,
    the cover's tables, rr5) with few samples. The adaptive ones run
    under a sorted map (descending cost of a profile chunk, converged
    pixels last) whose budget plane mixes 0 and the chunk's spp, as the
    re-plans give it. Sample counts must be equal and a lane without
    budget all zeros."""
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
            g = torch.Generator(device="cpu").manual_seed(3)
            converged = (torch.rand(w * h, generator=g) < 0.4).to("cuda")
            for rr in rrs:
                tabs, opts = walk_inputs(rr, w, h, depth, adaptive,
                                         stratified)
                pmap, budget = ident, None
                if adaptive:
                    prof, _ = cw.cluster_walk(tabs, ident, seed, 0, spp, w,
                                              h, opts)
                    key = torch.where(converged, 3e38, -prof[3])
                    order = torch.argsort(key, stable=True)
                    pmap = ident[order].contiguous()
                    budget = torch.where(converged, 0, spp)[order].to(
                        torch.int32).contiguous()
                args = (tabs, pmap, seed, CROP_OFFSET, spp, w, h, opts,
                        budget)
                label = f"{name} {shape} rr{rr}"
                got = compare(label, args)
                result["max_abs_err"] = max(result["max_abs_err"],
                                            got["max_abs_err"])
                if adaptive:
                    out, plain = got["out"], got["out_plain"]
                    dead = budget == 0
                    n_equal = (torch.equal(out[4], budget.float())
                               and torch.equal(out[4], plain[4]))
                    dead_zero = (not out[:, dead].any()
                                 and not got["seg_lanes"][dead].any())
                    l2 = float((out[5] - plain[5]).abs().max())
                    print(f"[{label}] n equal {n_equal}, lanes without "
                          f"budget {int(dead.sum())} all zero {dead_zero}, "
                          f"max|d| of sum lum^2 {l2:.3e}")
                    if not n_equal or not dead_zero or l2 > 1e-3:
                        fail(f"{label}: budget handling disagrees")
                    result["max_abs_err"] = max(result["max_abs_err"], l2)
                if shape == "crop" and rr == 5:
                    result.update(crop_times(args))
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
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, _ = presets.get_config("cover")
    cw.reset_launch_counts()
    first, first_stats, wall = render_once(scene, cam, w, h, spp, 0, opts)
    launches = dict(cw.cluster_walk.launches_by_variant)
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


def phase_main_paths(smi: str) -> dict:
    """Every path of the port on the full cover, each through its own
    instantiation of the kernel."""
    from raytracer_tpu_torch.scene import presets

    golden = np.load(GOLDEN)["image"].astype(np.float64)
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


def walk_bound(tabs, adaptive, stratified, n_lanes, iters, nsegs, samples):
    """Least time for the work these inputs needed, as (operations ms,
    bytes ms): the bound is the larger. Operations from the measured walk
    iterations, segments and samples; bytes from the tables, map, budget
    and outputs."""
    k, group = tabs.members.shape[:2]
    n_global = tabs.globals.shape[0]
    ops = (iters * (OPS_ITER + OPS_BOX * k)
           + (iters - nsegs) * OPS_MEMBER * group
           + nsegs * (OPS_BOUNCE + OPS_GLOBAL * n_global
                      + (OPS_BOUNCE_ADAPTIVE if adaptive else 0))
           + samples * (OPS_SAMPLE
                        + (OPS_SAMPLE_STRATIFIED if stratified else 0)))
    rows = 6 if adaptive else 4
    nbytes = (sum(t.numel() * 4 for t in (tabs.camera, tabs.globals,
                                          tabs.bounds, tabs.members,
                                          tabs.winner))
              + n_lanes * 4 * (2 + (1 if adaptive else 0) + rows + 1))
    return ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3


def bound_by(ops_ms: float, bytes_ms: float) -> str:
    return "operations" if ops_ms >= bytes_ms else "bytes"


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
    print(f"[kernel alone {cw.variant_name(opts)}] {w}x{h} x{sizes[1]} spp "
          f"sorted chunk (schedule {sizes}): {ms:.3f} ms; walk iterations "
          f"{iters:.0f}, segments {nsegs}; bound {bound_ms:.4f} ms by "
          f"{bound_by(ops_ms, bytes_ms)} (bytes {bytes_ms:.4f} ms); share "
          f"of bound {bound_ms / ms:.4f} [{smi}]")
    return {"ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by(ops_ms, bytes_ms)}


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
    launches, plans = [], []
    real_walk, real_plan = megakernel.cluster_walk, megakernel.plan_adaptive

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_walk(tabs, *args, **kw):
        start = event()
        out, segs = real_walk(tabs, *args, **kw)
        end = event()
        # the work this launch did, summed on the device after the span
        launches.append((start, end, tabs, out[3].sum(dtype=torch.float64),
                         segs.sum(dtype=torch.int64),
                         out[4].sum(dtype=torch.float64)))
        return out, segs

    def timed_plan(*args, **kw):
        start = event()
        got = real_plan(*args, **kw)
        plans.append((start, event()))
        return got

    megakernel.cluster_walk, megakernel.plan_adaptive = timed_walk, timed_plan
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(scene, cam, w, h, spp, 0, opts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        megakernel.cluster_walk = real_walk
        megakernel.plan_adaptive = real_plan
    ms = [s.elapsed_time(e) for s, e, *_ in launches]
    pairs = [walk_bound(tabs, True, stratified, w * h, float(iters),
                        int(nsegs), float(samples))
             for _, _, tabs, iters, nsegs, samples in launches]
    bounds = [max(pair) for pair in pairs]
    by = bound_by(sum(p[0] for p in pairs), sum(p[1] for p in pairs))
    plan_ms = [s.elapsed_time(e) for s, e in plans]
    samples = [float(x[5]) / (w * h) for x in launches]
    bound_ms = sum(bounds) / len(bounds)
    print(f"[kernel alone {name}] {len(ms)} launches of one adaptive "
          f"render, wall {wall_ms:.3f} ms with the events: kernel ms per "
          f"launch {' '.join(f'{x:.3f}' for x in ms)} (sum {sum(ms):.3f}, "
          f"mean {sum(ms) / len(ms):.3f}; the three launches that every "
          f"pixel takes {sum(ms[:3]):.3f} at "
          f"{sum(bounds[:3]) / sum(ms[:3]):.4f} of their bound, the rest "
          f"{sum(ms[3:]):.3f}); mean samples per pixel per launch "
          f"{' '.join(f'{x:.3f}' for x in samples)}; bound ms per "
          f"launch {' '.join(f'{b:.3f}' for b in bounds)} (mean "
          f"{bound_ms:.4f}, by {by}); share of bound "
          f"{sum(bounds) / sum(ms):.4f} [{smi}]")
    print(f"[re-plan {name}] {len(plan_ms)} plans, device ms each "
          f"{' '.join(f'{x:.3f}' for x in plan_ms)} (sum "
          f"{sum(plan_ms):.3f} = {sum(plan_ms) / wall_ms:.4f} of the wall) "
          f"[{smi}]")
    if len(ms) != ADAPTIVE_LAUNCHES:
        fail(f"{name}: {len(ms)} launches in the timed render")
    return {"ms": sum(ms) / len(ms), "bound_ms": bound_ms, "bound_by": by}


def phase_where_time_goes(smi: str, label: str, opts):
    """One render under torch.profiler: device time by kernel, the
    device's busy share of the wall, and the host's partition + table
    build."""
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_image(scene, cam, w, h, spp, 0, opts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
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


def main():
    smi = phase_device()
    phase_build()
    crops = {"cluster_walk": phase_kernel_vs_plain()}
    crops.update(phase_variants_vs_plain())
    paths = phase_main_paths(smi)
    alone = {
        "cluster_walk": phase_fixed_kernel_alone(smi, False),
        "cluster_walk_stratified": phase_fixed_kernel_alone(smi, True),
        "cluster_walk_adaptive_stratified": phase_adaptive_alone(smi, True),
        "cluster_walk_adaptive": phase_adaptive_alone(smi, False),
    }
    depth = paths["cluster_walk"]["depth"]
    phase_where_time_goes(smi, "rr5", trace_options(5, depth))
    phase_where_time_goes(smi, "adaptive companion",
                          trace_options(5, depth, True, True))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCE,
        "replaces": replaces,
        "launches": paths[name]["launches"],
        "max_abs_err": crops[name]["max_abs_err"],
        "ms": alone[name]["ms"],
        "plain_ms": crops[name]["plain_ms"],
        "bound_ms": alone[name]["bound_ms"],
        "bound_by": alone[name]["bound_by"],
        "library_ms": None,
        "crop_ms": crops[name]["crop_ms"],
        "plain_shape": f"{CROP_W}x{CROP_H}x{CROP_SPP}spp d{CROP_DEPTH}",
    } for name, (_, _, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
