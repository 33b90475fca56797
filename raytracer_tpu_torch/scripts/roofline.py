"""The roofline of the cover's flat-scan render on the card: the
counterpart of ``scripts/roofline.py``.

    python -m raytracer_tpu_torch.scripts.roofline [--device cpu]

1. The ceiling (P2): the independent float32 chain of
   ``bench_bf16_chain`` at a card-filling size, unfused like the kernels.
2. The issue line (``utils/profiling.py`` ``card_lines``): SMs × 128
   float32 lanes × the SM's highest clock (``nvidia-smi
   --query-gpu=clocks.max.sm``), beside the data sheet's 67e12, which
   counts a fused multiply-add as two operations.
3. The render the script times: the cover through the flat scan
   (``cluster_scan=False``: its split, K2s), 1200x800, 500 spp, depth 50,
   roulette from bounce 5; one warm run, then the best of 2, with its
   exact segment total.
4. Operations from the port's own account (``utils/profiling.py``: per
   slot its discriminant, per trip, self-test, tail and camera ray; the
   root logic on no slot), not the TPU kernel's.
5. One JSON line: the render's wall and Mrays/s, the scan's operations
   per segment, ``g_full`` and ``s_pad`` (the slot count in the JAX
   package's padding; the port scans ``slots``), the useful operations a
   second, the chain's rate, and the share of the chain, of the issue line
   and of 67e12.

Every number names the device it ran on; on the CPU (``--device cpu``)
there is no issue line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.render import rng
from raytracer_tpu_torch.render.api import render_image, resolve_device
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.render.split import containable_split
from raytracer_tpu_torch.render.tables import pad_spheres
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scripts import bench_bf16_chain as bc
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.profiling import best_seconds, device_name

RR_DEPTH = 5
REPEATS = 2


def main(device=None, width: int | None = None,
         height: int | None = None, spp: int | None = None,
         depth: int | None = None, chain_rows: int = bc.FILL_ROWS,
         chain_iters: int = bc.ITERS) -> dict:
    """Measures and prints what the module docstring lists; returns the
    JSON line's dict."""
    device = resolve_device(device)
    x = bc.chain_input(chain_rows, torch.float32, device)
    chain_s, _ = best_seconds(lambda: bc.chain(x, chain_iters), device)
    chain = bc.elem_ops(chain_rows, chain_iters) / chain_s
    print(f"float32 independent chain ({chain_rows},{bc.LANES}) "
          f"x{chain_iters}: {chain / 1e12:.3f} Telem-ops/s")
    line = (profiling.card_lines(device.index or 0)
            if device.type == "cuda" else None)
    if line is not None:
        print(f"issue line: {line['sms']} SMs x {profiling.FP32_LANES} lanes "
              f"x {line['sm_clock_mhz']:.0f} MHz = {line['fp32'] / 1e12:.3f}"
              f" T instructions/s; data sheet "
              f"{profiling.FP32_FLOP_PEAK / 1e12:.0f} TFLOP/s (FMA as two)")

    scene, cam, w, h, spp0, depth0 = presets.get_config("cover", width,
                                                         height)
    spp, depth = spp or spp0, depth or depth0
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=RR_DEPTH,
                        cluster_scan=False)
    split = containable_split(scene, derive_camera(cam), opts)
    slots = scene.count
    g_full = split[1] if split is not None else None

    def render(seed) -> int:
        _, stats = render_image(scene, cam, w, h, spp, seed, opts,
                                return_stats=True, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return stats["segments_exact"]

    render(0)  # warm
    best, segments = None, 0
    for i in range(REPEATS):
        seed = rng.fold_in(rng.key_data(0), i)
        t0 = time.perf_counter()
        s = render(seed)
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, segments = dt, s
    # the port's operation account of the fixed-spp flat-scan render
    ops = profiling.flat_ops(slots, g_full, False, False, segments,
                             w * h * spp)
    useful = ops / best
    result = {
        "device": device_name(device),
        "chain_telops": chain / 1e12,
        "issue_line_telops": None if line is None else line["fp32"] / 1e12,
        "sms": None if line is None else line["sms"],
        "sm_clock_mhz": None if line is None else line["sm_clock_mhz"],
        "fp32_flop_peak_telops": profiling.FP32_FLOP_PEAK / 1e12,
        "cover_wall_s": best,
        "cover_mrays": segments / best / 1e6,
        "segments": segments,
        "scan_ops_per_segment": profiling.flat_scan_ops(slots),
        "ops_per_segment": ops / segments,
        "ops": ops,
        "g_full": slots if g_full is None else g_full,
        "s_pad": pad_spheres(slots),
        "slots": slots,
        "useful_telops": useful / 1e12,
        "share_of_chain": useful / chain,
        "share_of_issue_line": None if line is None else useful / line["fp32"],
        "share_of_flop_peak": useful / profiling.FP32_FLOP_PEAK,
    }
    print(json.dumps(result))
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu for the plain versions")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
