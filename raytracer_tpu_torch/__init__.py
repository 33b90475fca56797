"""raytracer_tpu_torch: the PyTorch + CUDA port of ``raytracer_tpu``.

Offline renders (kd cluster partition and gathered cluster walk for
scenes of 64 slots and more, the flat or split closest-hit scan below
that; pixels sorted by profiled cost; exact segment totals), at fixed spp
or with adaptive per-pixel stopping, with the random or the stratified
sampler, with or without the debug overlay (cursor marker and selection
outline, drawn in the kernel), the progressive step's running average and
the interactive engine, run on an NVIDIA Hopper card through hand-written
CUDA kernels: ``csrc/cluster_walk.cu`` (six instantiations of
``<adaptive, stratified, debug>``: the four without debug, and
``<0,0,1>``, ``<0,1,1>``) and ``csrc/flat_scan.cu`` (ten of ``<adaptive,
stratified, split, debug>``: the eight without debug, and ``<0,0,0,1>``,
``<0,1,0,1>``), sixteen in all. Picking and the AOV views read a
closest-hit scan in plain PyTorch. The card probes and the roofline
(:mod:`raytracer_tpu_torch.scripts`) have three kernels of their own:
``csrc/probe_chain.cu``, ``probe_gather.cu`` and ``probe_scan.cu``. The
package imports torch and numpy only; every entry runs on CUDA unless the
caller names the CPU.

The JAX package's second backend, its plain wavefront tracer, is
``TraceOptions(backend='jnp')`` (:mod:`raytracer_tpu_torch.render.tracer`,
drawing from Threefry as ``jax.random`` does, :mod:`~raytracer_tpu_torch.render.rng`):
plain PyTorch on the same device, through ``render_image``, the
progressive step, the engine, the sharded paths, the CLI, the viewer and
the bench line. 'auto' and 'pallas' run the kernels.

Public entries: :func:`raytracer_tpu_torch.render.api.render_image`
(``debug=`` a :class:`DebugParams`);
:func:`~raytracer_tpu_torch.progressive.step.make_step_fn`,
:func:`~raytracer_tpu_torch.progressive.state.init_render_state` and
:func:`~raytracer_tpu_torch.progressive.step.run_frames`;
:class:`~raytracer_tpu_torch.app.engine.Engine`, the interactive session
(``set_debugging(True)`` turns the overlay on);
:func:`~raytracer_tpu_torch.interact.picking.center_hit` and
:func:`~raytracer_tpu_torch.interact.picking.update_cursor_state`
(picking and autofocus); :func:`~raytracer_tpu_torch.render.debug.render_aov`
(normal, depth, uuid and front views); :func:`~raytracer_tpu_torch.scene.spheres.update_sphere`,
:func:`~raytracer_tpu_torch.scene.spheres.add_sphere` and
:func:`~raytracer_tpu_torch.scene.spheres.remove_sphere` (pure scene
edits, with ``Scene.pad_to`` and ``Scene.num_active``);
:func:`~raytracer_tpu_torch.utils.resilience.retry_on_device_fault`
(``render_image`` and the engine run again after a recoverable device
fault, through the same kernels; a sticky one raises
:class:`DeviceContextLost`).

The JAX package's import surface holds: every public name of each of
its modules (less ``native/``, ``utils/jaxcache.py``, ``render/primary.py``
and the TPU's grid partition and tiling) resolves at the same path here,
``render_image_pallas`` in :mod:`raytracer_tpu_torch.render.pallas_kernel`
among them; :func:`raytracer_tpu_torch.entry.entry` is the counterpart of
``__graft_entry__.py``'s ``entry()``.

Multi-device sharding is the subpackage :mod:`raytracer_tpu_torch.parallel`
(imported on its own): ``make_mesh`` over ``torch.distributed``,
``render_image_sharded_pallas``, ``make_sharded_step_fn``,
``shard_render_state``, ``gather_rows`` and ``dryrun_multichip``, one
process per card, through the same kernels.

Entry points a user starts the renderer from (each on CUDA unless told
``--device cpu`` / ``BENCH_DEVICE=cpu``):

    python -m raytracer_tpu_torch.app.cli --config cover --out cover.png
    python -m raytracer_tpu_torch.bench          # bench.py's JSON line
    python -m raytracer_tpu_torch.app.viewer     # the terminal viewer
    python -m raytracer_tpu_torch.entry          # one progressive step
"""

from raytracer_tpu_torch.app.engine import Engine
from raytracer_tpu_torch.app.viewer import run_viewer
from raytracer_tpu_torch.camera import controller
from raytracer_tpu_torch.camera.camera import (
    CameraConfig,
    DerivedCamera,
    camera_from_numpy,
    derive_camera,
)
from raytracer_tpu_torch.core import sampling, vec
from raytracer_tpu_torch.core.ray import Ray
from raytracer_tpu_torch.interact.picking import (
    center_hit,
    update_cursor_state,
)
from raytracer_tpu_torch.progressive.state import (
    RenderState,
    init_render_state,
    load_render_state,
    render_state_from_numpy,
    reset_accumulation,
    save_render_state,
)
from raytracer_tpu_torch.progressive.step import (
    accumulate,
    make_step_fn,
    run_frames,
)
from raytracer_tpu_torch.render.api import render_image
from raytracer_tpu_torch.render.debug import render_aov
from raytracer_tpu_torch.render.megakernel import adaptive_state_from_numpy
from raytracer_tpu_torch.render.options import (
    DebugParams,
    TraceOptions,
    debug_from_numpy,
)
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.materials import DIFFUSE, GLASS, METAL, Material
from raytracer_tpu_torch.scene.spheres import (
    Scene,
    add_sphere,
    make_scene,
    remove_sphere,
    scene_from_numpy,
    update_sphere,
)
from raytracer_tpu_torch.utils.resilience import (
    DeviceContextLost,
    is_device_fault,
    retry_on_device_fault,
)

__all__ = [
    "CameraConfig",
    "DIFFUSE",
    "DebugParams",
    "DerivedCamera",
    "DeviceContextLost",
    "Engine",
    "GLASS",
    "METAL",
    "Material",
    "Ray",
    "RenderState",
    "Scene",
    "TraceOptions",
    "accumulate",
    "adaptive_state_from_numpy",
    "add_sphere",
    "camera_from_numpy",
    "center_hit",
    "controller",
    "debug_from_numpy",
    "derive_camera",
    "init_render_state",
    "is_device_fault",
    "load_render_state",
    "make_scene",
    "make_step_fn",
    "presets",
    "remove_sphere",
    "render_aov",
    "render_image",
    "render_state_from_numpy",
    "reset_accumulation",
    "retry_on_device_fault",
    "run_frames",
    "run_viewer",
    "sampling",
    "save_render_state",
    "scene_from_numpy",
    "update_cursor_state",
    "update_sphere",
    "vec",
]
