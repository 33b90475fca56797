"""The progressive step: trace one frame and fold it into the running
average (counterpart of ``raytracer_tpu/progressive/step.py``).

A step renders through the same dispatcher as ``render_image``, but as
the JAX package's jitted step sees a traced scene: nothing of the scene is
read on the host per frame, so the flat scan serves it with full root
logic (K2) unless the factory was given concrete hints, from which it
builds a static cluster partition (K1) or a static split (K2s) once. The
running average is updated in place on the device, the counterpart of
JAX's buffer donation; counters and key data are host ints, and the debug
overlay's cursor and selection are host values that the kernels take by
value, so nothing in a step waits for the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import CameraConfig
from raytracer_tpu_torch.progressive.state import RenderState
from raytracer_tpu_torch.render.api import resolve_device, to_derived
from raytracer_tpu_torch.render.megakernel import render
from raytracer_tpu_torch.render.options import (
    DebugParams,
    TraceOptions,
    check_backend,
    cluster_scan_enabled,
    resolve_backend,
)
from raytracer_tpu_torch.render.rng import fold_in
from raytracer_tpu_torch.render.split import containable_split
from raytracer_tpu_torch.render.tables import cluster_partition
from raytracer_tpu_torch.render.tracer import render_image_jnp
from raytracer_tpu_torch.scene.spheres import Scene

# the reference viewer's defaults
DEFAULT_LAST_FRAME_WEIGHT = 1.0
DEFAULT_MAX_RENDER_COUNT = 100_000


def accumulate(prev: torch.Tensor, new: torch.Tensor, render_count: int,
               last_frame_weight: float = DEFAULT_LAST_FRAME_WEIGHT, *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's progressive blend, in the JAX package's order:
    ``(prev·rc + new·w) / (rc + w)`` in float32, or ``new`` where the
    post-increment count ``rc`` <= 1. Written into ``out`` when given
    (``out`` may be ``prev``: the step blends in place)."""
    rc = np.float32(render_count)
    w = np.float32(last_frame_weight)
    if out is None:
        out = torch.empty_like(prev)
    if rc <= 1.0:
        return out.copy_(new)
    # a 0-d tensor on the device divides exactly; a host scalar divisor
    # may be turned into a product with its reciprocal
    denom = torch.full((), float(rc + w), dtype=torch.float32,
                       device=prev.device)
    torch.mul(prev, float(rc), out=out)
    out.add_(new if w == 1.0 else new * float(w))
    return out.div_(denom)


def make_step_fn(width: int, height: int, spp: int = 1,
                 opts: TraceOptions | None = None,
                 should_average: bool = True,
                 last_frame_weight: float = DEFAULT_LAST_FRAME_WEIGHT,
                 max_render_count: int = DEFAULT_MAX_RENDER_COUNT,
                 backend: str | None = None, jit: bool = True,
                 static_scene: Scene | None = None,
                 static_camera: CameraConfig | None = None, *,
                 device=None):
    """Build ``step(state, scene, camera, debug=None) -> (state', aux)``.

    ``aux['segments']`` is the frame's exact segment count as a 0-d
    device tensor. ``debug`` (a :class:`DebugParams`) is the overlay's
    cursor and selection under ``opts.enable_debug``; ``none()`` when
    omitted. ``static_scene`` / ``static_camera``: concrete copies
    of what every call will receive, for fixed-scene sessions. A scene of
    at least 64 slots gets a cluster partition built once (the camera may
    still move); otherwise scene and camera together give the split
    scan's analysis, except under ``enable_debug``, whose frames keep the
    scene's slot order. Interactive sessions that edit the scene or fly the
    camera omit them. An adaptive tolerance is stripped: adaptive
    sampling is an offline mode, and the running average would weight
    per-pixel means over unequal sample counts as if equal.

    The arguments are the JAX package's, in its order; ``device`` is the
    port's own and keyword-only. ``jit`` is accepted for the JAX
    package's callers and changes nothing: the port runs eagerly, and its
    step computes the same frame either way.

    ``backend`` (when given) replaces ``opts.backend``. 'jnp' frames are
    the JAX package's ``render_image_jnp`` of the whole frame on the same
    device (``render/tracer.py``; no hints, no bands), and like the
    kernels' they wait for the device nowhere.

    The step blends into ``state.accum`` in place and returns a new state
    around the same tensor: do not reuse the old state."""
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if not isinstance(jit, bool):
        raise TypeError(f"jit must be a bool, got {jit!r}")
    device = resolve_device(device)
    opts = opts or TraceOptions()
    if backend is not None:
        check_backend(backend)
        opts = dataclasses.replace(opts, backend=backend)
    opts = dataclasses.replace(opts, backend=resolve_backend(opts.backend))
    jnp = opts.backend == "jnp"
    static_split = static_cluster = None
    if static_scene is not None and not jnp:
        if cluster_scan_enabled(opts, static_scene.count):
            part = cluster_partition(static_scene, opts)
            if part is not None:
                static_cluster = (part.boxes, torch.as_tensor(part.uuid),
                                  part.n_global)
        if (static_cluster is None and static_camera is not None
                and not opts.enable_debug):
            static_split = containable_split(
                static_scene, to_derived(static_camera), opts
            )
    opts = dataclasses.replace(opts, adaptive_tolerance=0.0)
    stratified = opts.sampler == "stratified"

    def step(state: RenderState, scene: Scene, camera,
             debug: DebugParams | None = None):
        if state.accum.device != device:
            raise ValueError(
                f"state.accum is on {state.accum.device}, the step renders "
                f"on {device}"
            )
        if stratified:
            # one stream for the session; frame i is the offline render's
            # samples [i·spp, (i+1)·spp)
            key, offset = state.key, state.frame * spp
        else:
            key, offset = fold_in(state.key, state.frame), 0
        if jnp:
            color, stats = render_image_jnp(
                scene, to_derived(camera), width, height, spp, key, opts,
                debug, return_stats=True, sample_offset=offset,
                device=device)
            segments = stats["segments"]
        else:
            color, segments, _ = render(
                scene, to_derived(camera), width, height, spp, key, opts,
                device, sample_offset=offset, static_split=static_split,
                static_cluster=static_cluster, analyse=False, debug=debug,
            )
        render_count = min(state.render_count + 1, max_render_count)
        if should_average:
            accumulate(state.accum, color, render_count, last_frame_weight,
                       out=state.accum)
        else:
            state.accum.copy_(color)
        return (dataclasses.replace(state, render_count=render_count,
                                    frame=state.frame + 1),
                {"segments": segments})

    step.static_split = static_split
    step.static_cluster = static_cluster
    return step


def run_frames(step_fn, state: RenderState, scene: Scene, camera,
               n_frames: int, debug: DebugParams | None = None):
    """Drive ``n_frames`` steps (with the overlay of ``debug`` where the
    step's options enable it); segments are summed on the device and read
    once at the end. Returns the final state and the exact segment
    total."""
    total = None
    for _ in range(n_frames):
        state, aux = step_fn(state, scene, camera, debug)
        total = aux["segments"] if total is None else total + aux["segments"]
    return state, 0 if total is None else int(total)
