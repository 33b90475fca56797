"""The port's render entry point (counterpart of
``raytracer_tpu/render/api.py`` ``render_image`` with the Pallas
backend)."""

from __future__ import annotations

import torch

from raytracer_tpu_torch.camera.camera import (
    CameraConfig,
    DerivedCamera,
    derive_camera,
)
from raytracer_tpu_torch.render.megakernel import render, segment_stats
from raytracer_tpu_torch.render.options import DebugParams, TraceOptions
from raytracer_tpu_torch.render.rng import key_data
from raytracer_tpu_torch.scene.spheres import Scene
from raytracer_tpu_torch.utils.resilience import retry_on_device_fault


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is asked for
    (explicitly or by default) and absent. The CPU runs only when the
    caller names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to render with the "
            "plain PyTorch version"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def to_derived(camera) -> DerivedCamera:
    """``camera`` as a :class:`DerivedCamera` (derived from a
    :class:`CameraConfig`)."""
    if isinstance(camera, CameraConfig):
        return derive_camera(camera)
    if not isinstance(camera, DerivedCamera):
        raise TypeError(f"camera must be a CameraConfig or DerivedCamera, "
                        f"got {type(camera).__name__}")
    return camera


def render_image(scene: Scene, camera, width: int, height: int, spp: int,
                 seed, opts: TraceOptions | None = None,
                 return_stats: bool = False, device=None,
                 sample_offset: int = 0, debug: DebugParams | None = None):
    """Render ``spp`` samples per pixel. ``camera`` is a
    :class:`CameraConfig` or an already derived :class:`DerivedCamera`.
    ``seed`` is an int, which drives the same hash streams as
    ``jax.random.PRNGKey(seed)`` in the JAX package, or a JAX key's data
    (a ``(2,)`` uint32 pair, such as ``jax.random.fold_in``'s). Samples
    are numbered from ``sample_offset`` on (a stratified progressive
    session renders its frame i at i·spp); an adaptive render needs 0.
    Scenes go through the cluster walk or the flat scan as the JAX
    package's Pallas backend chooses. With ``opts.enable_debug`` the
    kernel draws the overlay of ``debug`` (a :class:`DebugParams`;
    ``DebugParams.none()`` when omitted). Returns an (H, W, 3) float32 image
    in [0, 1] on ``device``, row 0 at the image bottom, and with
    ``return_stats`` a dict of segment totals (``segments``,
    ``segments_exact``); an adaptive render adds ``mean_spp`` (float,
    mean samples per pixel) and ``spp_map`` ((H, W) tensor of per-pixel
    sample counts).

    The whole render is the unit of recovery: after a recoverable device
    fault (an allocation that failed) it runs again from its arguments,
    on the same device through the same kernels; a sticky fault raises
    ``DeviceContextLost`` (``utils/resilience.py``). On the card the render
    ends in a synchronize, so the image is complete when it returns."""
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if width < 1 or height < 1:
        raise ValueError(f"bad image size {width}x{height}")
    device = resolve_device(device)
    opts = opts or TraceOptions()
    dcam, key = to_derived(camera), key_data(seed)

    @retry_on_device_fault
    def run():
        out = render(scene, dcam, width, height, spp, key, opts, device,
                     sample_offset=sample_offset, debug=debug)
        if device.type == "cuda":
            # inside the retry's scope, so an asynchronous fault surfaces
            # here
            torch.cuda.synchronize(device)
        return out

    image, segments, extra = run()
    if not return_stats:
        return image
    return image, segment_stats(segments, extra)
