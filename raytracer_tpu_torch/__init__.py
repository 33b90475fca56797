"""raytracer_tpu_torch: the PyTorch + CUDA port of ``raytracer_tpu``.

Offline renders (kd cluster partition and gathered cluster walk for
scenes of 64 slots and more, the flat or split closest-hit scan below
that; pixels sorted by profiled cost; exact segment totals), at fixed spp
or with adaptive per-pixel stopping, with the random or the stratified
sampler, and the progressive step's running average, run on an NVIDIA
Hopper card through hand-written CUDA kernels (``csrc/cluster_walk.cu``,
four instantiations; ``csrc/flat_scan.cu``, eight). The package imports
torch and numpy only.

Public entries: :func:`raytracer_tpu_torch.render.api.render_image`;
:func:`~raytracer_tpu_torch.progressive.step.make_step_fn`,
:func:`~raytracer_tpu_torch.progressive.state.init_render_state` and
:func:`~raytracer_tpu_torch.progressive.step.run_frames`.
"""

from raytracer_tpu_torch.camera.camera import (
    CameraConfig,
    DerivedCamera,
    camera_from_numpy,
    derive_camera,
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
from raytracer_tpu_torch.render.megakernel import adaptive_state_from_numpy
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene.spheres import Scene, make_scene, scene_from_numpy

__all__ = [
    "CameraConfig",
    "DerivedCamera",
    "RenderState",
    "Scene",
    "TraceOptions",
    "accumulate",
    "adaptive_state_from_numpy",
    "camera_from_numpy",
    "derive_camera",
    "init_render_state",
    "load_render_state",
    "make_scene",
    "make_step_fn",
    "render_image",
    "render_state_from_numpy",
    "reset_accumulation",
    "run_frames",
    "save_render_state",
    "scene_from_numpy",
]
