"""Offline renderer: a scene preset to a PNG (counterpart of
``raytracer_tpu/app/cli.py``, with its options, defaults and choices).

    python -m raytracer_tpu_torch.app.cli --config cover --spp 500 --out cover.png
    python -m raytracer_tpu_torch.app.cli --config demo --width 640 --height 360 \\
        --progressive-frames 64 --out demo.png

The render runs on the card through the CUDA kernels; ``--device cpu``
runs their plain PyTorch versions. Without a card and without
``--device cpu`` it exits with an error; it never falls back to the CPU.
``--backend`` takes the JAX package's names: ``auto`` and ``pallas`` run
the kernels, ``jnp`` the JAX package's wavefront tracer in plain PyTorch,
on the same device. ``--scan-mxu`` (a TPU offload) is served by the flat
scan in exact float32.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from raytracer_tpu_torch.app import io
from raytracer_tpu_torch.progressive.state import init_render_state
from raytracer_tpu_torch.progressive.step import make_step_fn, run_frames
from raytracer_tpu_torch.render.api import render_image, resolve_device
from raytracer_tpu_torch.render.debug import render_aov
from raytracer_tpu_torch.render.options import (
    BACKENDS,
    TraceOptions,
    resolve_backend,
)
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.utils.profiling import mrays_per_sec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_tpu_torch",
        description="RTiOW path tracer on CUDA (PyTorch port)")
    p.add_argument("--config", default="demo",
                   choices=sorted(presets.BASELINE_CONFIGS))
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="render.png")
    p.add_argument(
        "--backend", default="auto", choices=list(BACKENDS),
        help="'auto' and 'pallas' run the CUDA kernels; 'jnp' the JAX "
        "package's wavefront tracer, in plain PyTorch on the same device")
    p.add_argument(
        "--progressive-frames", type=int, default=0,
        help="accumulate N progressive frames (of --spp samples each) "
        "instead of one batch render")
    p.add_argument(
        "--aov", default=None, choices=["normal", "depth", "uuid", "front"],
        help="render a debug AOV instead of the beauty pass")
    p.add_argument(
        "--russian-roulette", type=int, default=0, metavar="DEPTH",
        help="unbiased Russian-roulette termination from this bounce on "
        "(0 = off; faster deep renders, slightly more variance)")
    p.add_argument(
        "--adaptive", type=float, default=0.0, metavar="TOL",
        help="adaptive sampling: stop sampling a pixel once its 95%% CI "
        "on mean luminance is within TOL (relative); 0 = fixed spp")
    p.add_argument(
        "--spp-map", default=None, metavar="PATH",
        help="with --adaptive: also save the per-pixel sample-density "
        "heatmap (effective spp, normalized to its max) as a grayscale PNG")
    p.add_argument(
        "--sampler", default="random", choices=("random", "stratified"),
        help="camera-sample sequencer: 'stratified' uses per-pixel "
        "low-discrepancy jitter/lens points (same distributions, lower "
        "variance). --adaptive is offline-only: progressive mode strips "
        "the tolerance and renders fixed spp")
    p.add_argument(
        "--scan-mxu", action="store_true",
        help="the JAX package's MXU offload of the flat scan; served here "
        "by the flat scan in exact float32")
    p.add_argument(
        "--cluster-scan", dest="cluster_scan", action="store_const",
        const=True, default="auto",
        help="force the cluster walk on (the flat scan serves scenes with "
        "no small-sphere clusters). Default auto: on for scenes >= 64 "
        "slots.")
    p.add_argument(
        "--no-cluster-scan", dest="cluster_scan", action="store_const",
        const=False, help="force the flat scan")
    p.add_argument(
        "--cluster-bounds", choices=("sphere", "box"), default="box",
        help="cluster bound shape: 'box' (the port's walk); 'sphere' is "
        "not ported (ROADMAP.md §2)")
    p.add_argument(
        "--book-physics", action="store_true",
        help="canonical RTiOW physics (black on depth exhaustion + "
        "near-zero guard) instead of reference quirks")
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (the kernels; the default) or 'cpu' (their plain "
        "PyTorch versions)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        parser.error(f"--device {args.device}: CUDA is not available; pass "
                     "--device cpu to run the kernels' plain PyTorch "
                     "versions")
    except ValueError as e:
        parser.error(f"--device {args.device}: {e}")
    scene, cam, w, h, spp, depth = presets.get_config(
        args.config, args.width, args.height)
    # 'is not None': an explicit --spp 0 raises in the render
    spp = args.spp if args.spp is not None else spp
    depth = args.max_depth if args.max_depth is not None else depth
    opts = TraceOptions(
        max_depth=depth,
        exhaust_black=args.book_physics,
        near_zero_guard=args.book_physics,
        russian_roulette_depth=args.russian_roulette,
        adaptive_tolerance=args.adaptive,
        sampler=args.sampler,
        scan_mxu=args.scan_mxu,
        cluster_scan=args.cluster_scan,
        cluster_bounds=args.cluster_bounds,
        backend=args.backend,
    )

    if args.adaptive > 0.0 and (resolve_backend(args.backend) != "pallas"
                                or args.progressive_frames > 0):
        # only the kernels' batch render samples adaptively: the jnp
        # tracer and the progressive step render fixed spp
        print("warning: --adaptive requires the Pallas batch backend; "
              "rendering fixed spp", file=sys.stderr)

    if args.aov:
        t0 = time.perf_counter()
        image = render_aov(scene, cam, w, h, args.aov, device=device)
        image = image.cpu().numpy()
        elapsed = time.perf_counter() - t0
        io.save_png(args.out, image)
        print(f"{args.config} AOV={args.aov}: {w}x{h} -> {args.out} "
              f"({elapsed:.3f}s)")
        return 0

    t0 = time.perf_counter()
    if args.progressive_frames > 0:
        if args.spp_map:
            print("warning: --spp-map needs an adaptive batch render; "
                  "progressive mode renders fixed spp per frame — skipped",
                  file=sys.stderr)
        # scene and camera stay fixed for the whole accumulation: concrete
        # hints let the step build its partition or split once
        step = make_step_fn(w, h, spp=spp, opts=opts, static_scene=scene,
                            static_camera=cam, device=device)
        state = init_render_state(w, h, args.seed, device=device)
        state, segments = run_frames(step, state, scene, cam,
                                     args.progressive_frames)
        image = state.accum.cpu().numpy()
    else:
        image, stats = render_image(scene, cam, w, h, spp, args.seed, opts,
                                    return_stats=True, device=device)
        image = image.cpu().numpy()
        segments = stats["segments_exact"]
        if "mean_spp" in stats:
            print(f"adaptive: mean effective spp {stats['mean_spp']:.1f} "
                  f"of {spp}")
        if args.spp_map:
            if "spp_map" in stats:
                m = stats["spp_map"].cpu().numpy().astype(np.float32)
                heat = m / max(float(m.max()), 1.0)
                io.save_png(args.spp_map,
                            np.repeat(heat[..., None], 3, axis=-1))
                print(f"spp map -> {args.spp_map} "
                      f"(min {m.min():.0f}, max {m.max():.0f} spp)")
            else:
                print("warning: --spp-map needs an adaptive render "
                      "(--adaptive TOL); skipped", file=sys.stderr)
    elapsed = time.perf_counter() - t0

    io.save_png(args.out, image)
    print(f"{args.config}: {w}x{h} spp={spp} depth={depth} "
          f"backend={args.backend} -> {args.out}\n"
          f"wall={elapsed:.3f}s rays={segments / 1e6:.1f}M "
          f"({mrays_per_sec(segments, elapsed):.1f} Mrays/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
