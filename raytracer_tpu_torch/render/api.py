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
from raytracer_tpu_torch.render.megakernel import render_image_cluster
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene.spheres import Scene


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
    return device


def render_image(scene: Scene, camera, width: int, height: int, spp: int,
                 seed: int, opts: TraceOptions | None = None,
                 return_stats: bool = False, device=None):
    """Render ``spp`` samples per pixel. ``camera`` is a
    :class:`CameraConfig` or an already derived :class:`DerivedCamera`.
    ``seed`` drives the same hash streams as ``jax.random.PRNGKey(seed)``
    in the JAX package. Returns an (H, W, 3) float32 image in [0, 1] on
    ``device``, row 0 at the image bottom, and with ``return_stats`` a
    dict of segment totals (``segments``, ``segments_exact``); an adaptive
    render adds ``mean_spp`` (float, mean samples per pixel) and
    ``spp_map`` ((H, W) tensor of per-pixel sample counts)."""
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if width < 1 or height < 1:
        raise ValueError(f"bad image size {width}x{height}")
    device = resolve_device(device)
    opts = opts or TraceOptions()
    if isinstance(camera, CameraConfig):
        camera = derive_camera(camera)
    elif not isinstance(camera, DerivedCamera):
        raise TypeError(f"camera must be a CameraConfig or DerivedCamera, "
                        f"got {type(camera).__name__}")
    return render_image_cluster(scene, camera, width, height, spp, seed,
                                opts, device, return_stats=return_stats)
