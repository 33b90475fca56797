#!/usr/bin/env python3
"""The benchmark of raytracer_tpu_torch: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic (BENCHMARK.json and the files
under benchmark/), builds the scene and camera from them, warms the
cell's own shapes, runs the cell's traffic for `--seconds`, compares what
the timed path produced with the plain reference, and prints one JSON
line last on standard output. `--trace 0` reports the cell's end-to-end
metrics, `--trace 1` its per-layer metrics from the benchmark's spans,
the port's launch counters and a profiled sub-window.

Needs a CUDA card: without one, or with fewer than the cell asks for,
it exits 3 and prints no result. It exits 4, and prints no result, when
JAX or the JAX package has been loaded into the process. Kernel builds
and compiler caches stay under build/ in the checkout."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


def seconds_since_start() -> float:
    """Seconds since this process started (Linux: its start tick against
    the boot clock), so that set-up counts the interpreter and imports."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def pin_caches(root: Path) -> None:
    """Every compiler and kernel cache at a fixed path inside the
    checkout, so that only a checkout's first run builds."""
    build = root / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(build / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    pin_caches(ROOT)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark import harness

    try:
        cell = harness.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: cannot load cell {args.workload!r}: {e}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark measures the card "
              "and runs nowhere else", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import raytracer_tpu_torch as port
    except ImportError as e:
        print(f"benchmark: the program is missing: {e}", file=sys.stderr)
        return 3
    result = run(port, cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    print_result(result)
    return 0


class Counters:
    """The port's kernel launch counters."""

    def __init__(self):
        from raytracer_tpu_torch.render import cluster_walk, flat_scan

        self.mods = {"cluster_walk": cluster_walk, "flat_scan": flat_scan}

    def reset(self) -> None:
        for mod in self.mods.values():
            mod.reset_launch_counts()

    def read(self) -> dict:
        return {name: getattr(mod, name).launches
                for name, mod in self.mods.items()}


def run(port, cell, seed: int, seconds: float, trace: bool, device,
        overrides=None, counters=None) -> dict:
    """One run of `cell` on `device`; returns the result's fields and the
    checks. `overrides` and a CPU `device` are for the tests."""
    import torch

    from benchmark import harness, roofline
    from benchmark.trace import breakdown

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    counters = counters or Counters()
    session = harness.session_class(cell.traffic["entry"])(
        port, cell, device, overrides)
    session.warm(seed)
    sync()
    rec = harness.Run(cell, seed, seconds, trace)
    rec.setup_s = seconds_since_start()
    session.window(rec, sync, counters)
    # the peak on the fullest card of those the cell uses
    mem = (max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips))
           if on_card else 0)
    # the reference runs after the program's peak is read, on what the
    # window kept
    values = session.check(rec, device)
    session.release()
    correct, rows = harness.check_against(values, cell.limits)
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        v = harness.load_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else device.type),
           "count": cell.chips, "memory_peak_bytes": int(mem)}
    out = {"correct": correct, "attempted": rec.attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and rec.sub is not None:
        dev["busy_s"] = rec.sub["busy_s"]
        dev["window_s"] = rec.sub["window_s"]
        out["breakdown"] = breakdown(rec.sub)
    if on_card:
        out["card"] = roofline.card_label(device.index or 0)
        if trace:
            # a share at 67e12 times 67e12 / this line is the share at the
            # float32 issue line, which unfused kernels cannot pass
            out["fp32_issue_line"] = roofline.card_lines(
                device.index or 0)["fp32_line"]
    out["run"] = dict(rec.extra, seed=seed, window_s=rec.window_s,
                      setup_s=rec.setup_s, launches=rec.launches,
                      checked=values)
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rows}
    return out


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
