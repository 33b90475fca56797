"""The megakernel render under the JAX package's name (counterpart of
``raytracer_tpu/render/pallas_kernel.py``).

This module is thin. The orchestration (kernel choice, schedule, pixel
plans, adaptive re-plans, finalize) lives in ``render/megakernel.py``, and
the kernels are hand-written CUDA in ``csrc/cluster_walk.cu`` and
``csrc/flat_scan.cu``, bound by ``render/cluster_walk.py`` and
``render/flat_scan.py``. What the JAX module tiles for the TPU (``r_sub``
rows a grid step, ``k_slots`` virtual tiles, ``DEFAULT_R_SUB``) has no
counterpart: a call that passes ``r_sub`` or ``k_slots`` raises
``TypeError``.

The constants are the port's own objects under the JAX names: ``LANES``
is the padded row width the RNG's pixel id keeps, ``INV_24`` and
``TWO_PI`` the hash's float constants, ``ADAPTIVE_*`` the adaptive
schedule's.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import DerivedCamera
from raytracer_tpu_torch.render.api import check_render_args, resolve_device
from raytracer_tpu_torch.render.cluster_walk import LANES_TPU as LANES
from raytracer_tpu_torch.render.megakernel import render, segment_stats
from raytracer_tpu_torch.render.options import DebugParams, TraceOptions
from raytracer_tpu_torch.render.rng import INV_24, TWO_PI, key_data
from raytracer_tpu_torch.render.schedule import (
    ADAPTIVE_ABS_FLOOR,
    ADAPTIVE_AUTO_CHUNK,
    ADAPTIVE_MIN_N,
)
from raytracer_tpu_torch.scene.spheres import Scene


def check_hints(static_split, static_cluster):
    """Raise ``TypeError`` unless the hints are in the port's format, the
    one ``progressive/step.py`` builds: ``static_split`` = (perm, g_full),
    perm a numpy index array or None and g_full an int;
    ``static_cluster`` = (boxes, uuid, n_global), boxes the partition's
    (K, 6) float32 numpy AABBs, uuid a tensor and n_global an int. A
    cluster hint built by the JAX package holds JAX arrays and raises; a
    split hint is a numpy array and an int in both packages, with the
    same meaning."""
    if static_split is not None:
        if not (isinstance(static_split, tuple) and len(static_split) == 2
                and (static_split[0] is None
                     or isinstance(static_split[0], np.ndarray))
                and isinstance(static_split[1], (int, np.integer))):
            raise TypeError("static_split must be (perm: numpy array or "
                            "None, g_full: int)")
    if static_cluster is not None:
        if not (isinstance(static_cluster, tuple) and len(static_cluster) == 3
                and isinstance(static_cluster[0], np.ndarray)
                and static_cluster[0].ndim == 2
                and static_cluster[0].shape[1] == 6
                and isinstance(static_cluster[1], torch.Tensor)
                and isinstance(static_cluster[2], (int, np.integer))):
            raise TypeError("static_cluster must be (boxes: (K, 6) numpy "
                            "array, uuid: tensor, n_global: int), as "
                            "make_step_fn builds it")


def render_image_pallas(scene: Scene, dcam: DerivedCamera, width: int,
                        height: int, spp: int, key, opts: TraceOptions,
                        debug: DebugParams | None = None,
                        return_stats: bool = False, *, static_split=None,
                        sample_offset: int = 0, static_cluster=None,
                        device=None):
    """Render ``spp`` samples per pixel of ``scene`` through the CUDA
    kernels (their plain versions on the CPU), as the JAX package's
    function of this name does through its Pallas kernel: the cluster
    walk (K1) for scenes of 64 slots and more, else the flat or split
    scan (K2, K2s), whatever ``opts.backend`` says.

    The positional parameters are the JAX package's up to
    ``return_stats``; the hints, ``sample_offset`` and ``device`` (CUDA
    unless the CPU is named) are keyword-only. ``dcam`` is a
    :class:`DerivedCamera`, ``key`` an int seed or key data (see
    ``rng.key_data``). ``static_split`` / ``static_cluster`` are the
    progressive step's hints (:func:`check_hints`). With
    ``opts.enable_debug`` the kernel draws the overlay of ``debug``
    (``DebugParams.none()`` when omitted).

    Like the JAX function it neither retries nor synchronises:
    :func:`~raytracer_tpu_torch.render.api.render_image` wraps it in both.
    Returns the (H, W, 3) float32 image on the device, and with
    ``return_stats`` the dict ``render_image`` returns (reading the
    segment total waits for the device)."""
    check_render_args(width, height, spp, opts, debug, return_stats)
    if not isinstance(dcam, DerivedCamera):
        raise TypeError(f"dcam must be a DerivedCamera, got "
                        f"{type(dcam).__name__}")
    check_hints(static_split, static_cluster)
    image, segments, extra = render(
        scene, dcam, width, height, spp, key_data(key), opts,
        resolve_device(device), sample_offset=sample_offset,
        static_split=static_split, static_cluster=static_cluster,
        debug=debug)
    if not return_stats:
        return image
    return image, segment_stats(segments, extra)
