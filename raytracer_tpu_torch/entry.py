"""Single-device entry point and the multi-device dry run (counterpart of
``__graft_entry__.py``).

- :func:`entry` returns one progressive render step on the flagship scene
  (the RTiOW demo, 9 spheres, at 256x144, 1 spp, depth 8) with its
  arguments; the step traces the frame through the flat scan's CUDA
  kernel (K2, ``csrc/flat_scan.cu``) and folds it into the running
  average on the device.
- :func:`~raytracer_tpu_torch.parallel.dryrun.dryrun_multichip` spawns
  one rank per device over a (rows, spp) mesh and runs the sharded
  paths once.

Run one step and print the running average's shape and the frame's
segment count (on the card; ``--device cpu`` runs the kernels' plain
PyTorch versions):

    python -m raytracer_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse

from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
from raytracer_tpu_torch.progressive.state import init_render_state
from raytracer_tpu_torch.progressive.step import make_step_fn
from raytracer_tpu_torch.render.api import resolve_device
from raytracer_tpu_torch.render.options import DebugParams, TraceOptions
from raytracer_tpu_torch.scene import presets

__all__ = ["entry", "dryrun_multichip"]

WIDTH, HEIGHT = 256, 144


def entry(*, device=None):
    """Returns ``(step, (state, scene, cam, debug))``: one full
    progressive step (trace 1 spp over the pixel grid, fold it into the
    running average) and its example arguments, a fresh state of key 0
    on ``device`` (CUDA unless the CPU is named), the demo scene and
    camera and ``DebugParams.none()``. ``step(*args)`` returns the next
    state and ``{'segments': the frame's exact segment count}``."""
    device = resolve_device(device)
    scene, cam, *_ = presets.get_config("demo", WIDTH, HEIGHT)
    opts = TraceOptions(max_depth=8)
    step = make_step_fn(WIDTH, HEIGHT, spp=1, opts=opts, jit=False,
                        device=device)
    state = init_render_state(WIDTH, HEIGHT, 0, device=device)
    return step, (state, scene, cam, DebugParams.none())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m raytracer_tpu_torch.entry",
        description=__doc__.splitlines()[0])
    parser.add_argument(
        "--device", default=None,
        help="'cuda' (the kernels; the default) or 'cpu' (their plain "
        "PyTorch versions)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        parser.error(str(e))
    fn, fn_args = entry(device=device)
    state, aux = fn(*fn_args)
    # reading the segment count waits for the device
    print("entry OK:", tuple(state.accum.shape), float(aux["segments"]))


if __name__ == "__main__":
    main()
