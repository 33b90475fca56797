"""Frames of the interactive engine on the cover, the base revision's
package against this tree's, in turns, on the card.

    python -m raytracer_tpu_torch.scripts.engine_ab

The engine at 1280x720, 1 spp a frame, depth 8, the overlay on, the
cursor on the sphere at the centre: the cover through the cluster walk
with the overlay (K3), each sampler. Each turn is a process of its own
that imports one tree's package (``PYTHONPATH``): the base revision's,
as ``walk_ab.parent_tree`` unpacks it, then this tree's, then this tree's
again, then the base's; then the same in the other order. A process
builds its tree's kernels, warms the engine up, times 4 batches of 32
frames with one sync a batch, and counts the PyTorch operator calls of
one more batch under ``torch.profiler``. Prints ms a frame (the best and
the median batch) and calls a frame per tree and sampler, and writes
them to ``build/walk_ab/engine_ab.json``. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import statistics
import time

ENGINE_W, ENGINE_H, ENGINE_DEPTH = 1280, 720, 8
BATCH = 32
BATCHES = 4  # timed batches a process
ROUNDS = 2  # turns old, new, new, old (then new, old, old, new)
SAMPLERS = ("random", "stratified")


def worker() -> dict:
    """One tree's engine (the package on ``sys.path``): per sampler, ms a
    frame of each timed batch and PyTorch calls a frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch import Engine
    from raytracer_tpu_torch.scene import presets

    scene, cam, *_ = presets.get_config("cover", ENGINE_W, ENGINE_H)
    got = {}
    for sampler in SAMPLERS:
        eng = Engine(scene, cam, ENGINE_W, ENGINE_H, max_depth=ENGINE_DEPTH,
                     sampler=sampler)
        eng.set_paused(False)
        eng.set_debugging(True)
        eng.handle_mouse_move(4.0, -3.0)
        eng.handle_mouse_move(-4.0, 3.0)
        now = [0.0]

        def frames(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                now[0] += 16.0
                if not eng.tick(now[0]):
                    raise RuntimeError("the engine skipped a frame")
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        frames(BATCH)  # builds the step and the kernels, warms up
        ms = [frames(BATCH) for _ in range(BATCHES)]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            frames(BATCH)
        calls = sum(e.count for e in prof.key_averages()
                    if e.key.startswith("aten::"))
        got[sampler] = {"ms": ms, "calls_per_frame": calls / BATCH}
    return got


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    if ap.parse_args(argv).worker:
        print(json.dumps(worker()))
        return {}
    from raytracer_tpu_torch.scripts import walk_ab

    old = walk_ab.parent_tree()
    if old is None:
        raise SystemExit("engine_ab: the base revision is not in this "
                         "checkout (see walk_ab.parent_tree)")
    smi = walk_ab.smi_line()
    print(smi)
    trees = {"old": old, "new": walk_ab.ROOT}
    runs = {b: {s: [] for s in SAMPLERS} for b in trees}
    for r in range(ROUNDS):
        for b in (("old", "new", "new", "old") if r % 2 == 0 else
                  ("new", "old", "old", "new")):
            env = dict(os.environ, PYTHONPATH=str(trees[b]))
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker"],
                env=env, cwd=str(trees[b]), capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"engine_ab: the {b} tree's engine failed:\n"
                                 + proc.stderr[-4000:])
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            for s in SAMPLERS:
                runs[b][s].append(got[s])
                print(f"[engine A/B {b} {s}] ms a frame "
                      f"{' '.join(f'{x:.4f}' for x in got[s]['ms'])}; "
                      f"{got[s]['calls_per_frame']:.1f} PyTorch calls a "
                      f"frame [{smi}]")
    for s in SAMPLERS:
        ms = {b: [x for g in runs[b][s] for x in g["ms"]] for b in trees}
        best = {b: min(x) for b, x in ms.items()}
        med = {b: statistics.median(x) for b, x in ms.items()}
        print(f"[engine A/B cover {s}] ms a frame, best batch: old "
              f"{best['old']:.4f}, new {best['new']:.4f} (x"
              f"{best['old'] / best['new']:.3f}); median of "
              f"{len(ms['new'])} batches: old {med['old']:.4f}, new "
              f"{med['new']:.4f} (x{med['old'] / med['new']:.3f}); PyTorch "
              f"calls a frame old "
              f"{runs['old'][s][0]['calls_per_frame']:.1f}, new "
              f"{runs['new'][s][0]['calls_per_frame']:.1f} [{smi}]")
    out = walk_ab.OUT_DIR
    out.mkdir(parents=True, exist_ok=True)
    result = {"smi": smi, "runs": runs}
    (out / "engine_ab.json").write_text(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
