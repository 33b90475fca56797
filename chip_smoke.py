"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``raytracer_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the main
path (the RTiOW cover render: 1200x800, 500 spp, depth 50, Russian
roulette from bounce 5, then the same render without roulette) through
``render_image``, checks both images against the committed golden
(``tests/goldens/cover_jnp_rr0_500spp_f16.npz``), times the kernel at the
main path's shape, and prints one JSON line of kernel numbers. Any
failed phase ends the run with a nonzero exit. The last line of output
is ``{"ok": true, "device": {...}}``.

Needs CUDA and one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "cover_jnp_rr0_500spp_f16.npz")

# kernel vs plain version on the card, same inputs (cover crop, 4 spp,
# depth 12): both round every operation alike (-fmad=false, the same
# libdevice), so only a transcendental that PyTorch evaluates another way
# can fork a path. Bounds: share of pixels off by more than 1e-3, mean
# |delta| of the rgb sums, relative difference of the segment totals.
CROP_W, CROP_H, CROP_SPP, CROP_DEPTH = 256, 128, 4, 12
MAX_FORKED_SHARE = 0.005
MAX_MEAN_ABS = 1e-4
MAX_SEG_REL = 1e-3
# the same check at the main path's shapes: the full frame at its depth,
# with few samples so the plain version stays quick
FULL_W, FULL_H, FULL_SPP, FULL_DEPTH = 1200, 800, 1, 50

# the JAX package's 500-spp render measured mean|delta| 4.3e-3 against
# the same golden
GOLDEN_MAX_MAD = 6e-3

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
FP32_PEAK = 67e12  # H100 SXM, FLOP/s outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s


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
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("[ptxas]", line.strip())


def walk_inputs(rr: int, width: int | None, height: int | None, depth):
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import tables
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    scene, cam, *_ = presets.get_config("cover", width, height)
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=rr)
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
    print(f"[kernel vs plain {label}] max|d| {float(d.max()):.3e} "
          f"mean|d| {mad:.3e} forked {forked:.5f} bitwise "
          f"{float((d == 0).float().mean()):.5f} cost_equal {cost_eq:.5f} "
          f"segments kernel {sk} plain {sp}")
    if not torch.isfinite(out_k).all():
        fail(f"kernel output is not finite ({label})")
    if (forked > MAX_FORKED_SHARE or mad > MAX_MEAN_ABS
            or abs(sk - sp) > MAX_SEG_REL * sp):
        fail(f"kernel disagrees with the plain version ({label})")
    return {"max_abs_err": float(d.max()), "out": out_k, "segs": sk}


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
            result["crop_ms"] = cuda_ms(lambda: cw.cluster_walk(*args), 3)
            t0 = time.perf_counter()
            cw.cluster_walk_plain(*args)
            torch.cuda.synchronize()
            result["plain_ms"] = (time.perf_counter() - t0) * 1e3
            print(f"[crop {CROP_W}x{CROP_H} x{CROP_SPP} spp d{CROP_DEPTH}] "
                  f"kernel {result['crop_ms']:.3f} ms, plain "
                  f"{result['plain_ms']:.1f} ms")
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


def phase_main_path(smi: str) -> dict:
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.cluster_walk import cluster_walk
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    golden = np.load(GOLDEN)["image"].astype(np.float64)
    scene, cam, w, h, spp, depth = presets.get_config("cover")
    result = {}
    for rr in (5, 0):
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=rr)

        def run(seed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, stats = render_image(scene, cam, w, h, spp, seed, opts,
                                      return_stats=True)
            torch.cuda.synchronize()
            return img, stats, time.perf_counter() - t0

        if rr == 5:
            # the main path's run: counts start at 0 just before it
            cluster_walk.launches = 0
            img, stats, wall = run(0)
            result["launches"] = cluster_walk.launches
            print(f"[main path rr5] launches {result['launches']} "
                  f"(first render, {wall:.3f} s)")
            if result["launches"] < 1:
                fail("the main path did not launch the cluster walk kernel")
            walls = []
            for seed in (1, 2):
                img, stats, wall = run(seed)
                walls.append(wall)
        else:
            img, stats, wall = run(0)
            walls = [wall]
        best = min(walls)
        segs = stats["segments_exact"]
        im = img.cpu().numpy().astype(np.float64)
        nan = int(np.isnan(im).any(-1).sum())
        mad = float(np.abs(im - golden).mean())
        print(f"[main path rr{rr}] {w}x{h} {spp} spp d{depth} wall "
              f"{' '.join(f'{x:.4f}' for x in walls)} s (best {best:.4f}) "
              f"segments {segs} Mrays/s {segs / best / 1e6:.2f} "
              f"golden mean|d| {mad:.3e} nan_pixels {nan} [{smi}]")
        if im.shape != golden.shape or nan or mad > GOLDEN_MAX_MAD:
            fail(f"rr{rr} render disagrees with the golden (mean|d| {mad})")
        result[f"rr{rr}"] = {"wall_s": best, "segments": segs,
                             "mad": mad}
    return result


def phase_kernel_alone(smi: str) -> dict:
    """One 153-spp sorted chunk at 1200x800, the main path's shape."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import cluster_walk as cw
    from raytracer_tpu_torch.render import schedule, tables
    from raytracer_tpu_torch.render.megakernel import plan_from_cost
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=5)
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
    k, group = tabs.members.shape[:2]
    n_global = tabs.globals.shape[0]
    samples = w * h * sizes[1]
    ops = (iters * (OPS_ITER + OPS_BOX * k)
           + (iters - nsegs) * OPS_MEMBER * group
           + nsegs * (OPS_BOUNCE + OPS_GLOBAL * n_global)
           + samples * OPS_SAMPLE)
    nbytes = (sum(t.numel() * 4 for t in (tabs.camera, tabs.globals,
                                          tabs.bounds, tabs.members,
                                          tabs.winner))
              + pmap.numel() * 4 + out.numel() * 4 + segs.numel() * 4)
    bound_ops_ms = ops / FP32_PEAK * 1e3
    bound_bytes_ms = nbytes / HBM_RATE * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    print(f"[kernel alone] {w}x{h} x{sizes[1]} spp sorted chunk (schedule "
          f"{sizes}): {ms:.3f} ms; walk iterations {iters:.0f}, segments "
          f"{nsegs}; ops {ops:.4e} -> bound {bound_ms:.4f} ms by "
          f"{bound_by} (bytes {bound_bytes_ms:.4f} ms); share of bound "
          f"{bound_ms / ms:.4f} [{smi}]")
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_where_time_goes(smi: str):
    """One rr5 render of the main path under torch.profiler: device time
    by kernel, the device's busy share of the wall, and the host's
    partition + table build."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import tables
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=5)
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
    print(f"[where the time goes rr5] wall {wall_ms:.3f} ms under the "
          f"profiler; host partition + tables {setup_ms:.3f} ms; device "
          + (f"busy {busy:.3f} ms = {busy / wall_ms:.4f} of the wall"
             if rows else "time not measured by the profiler")
          + f" [{smi}]")
    for ms, count, key in rows[:6]:
        print(f"  {ms:10.3f} ms  x{count:<4d} {key[:90]}")


def main():
    smi = phase_device()
    phase_build()
    crop = phase_kernel_vs_plain()
    main_path = phase_main_path(smi)
    alone = phase_kernel_alone(smi)
    phase_where_time_goes(smi)
    print(json.dumps({"kernels": [{
        "name": "cluster_walk",
        "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/cluster_walk.cu",
        "replaces": "raytracer_tpu/render/pallas_kernel.py:216",
        "launches": main_path["launches"],
        "max_abs_err": crop["max_abs_err"],
        "ms": alone["ms"],
        "plain_ms": crop["plain_ms"],
        "bound_ms": alone["bound_ms"],
        "bound_by": alone["bound_by"],
        "library_ms": None,
        "crop_ms": crop["crop_ms"],
        "plain_shape": f"{CROP_W}x{CROP_H}x{CROP_SPP}spp d{CROP_DEPTH}",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
