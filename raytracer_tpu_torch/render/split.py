"""Static far-root analysis of the split scan (counterpart of
``raytracer_tpu/render/pallas_kernel.py`` ``_containable_split`` and
``_containable_flags``), on the host in numpy float64.

The quadratic's far root is the closest legitimate hit only when a ray
starts strictly inside the sphere. Ray origins are the camera's lens disc
and hit points on sphere surfaces, so a sphere can contain an origin only
if it is glass, if another active sphere's surface passes through its
interior, or if the lens disc reaches inside it. Every other sphere may
skip the far-root fallback in the scan (K2s); the kernel's exact
self-test of the last-hit sphere covers a path re-entering the sphere it
just left.
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch.camera.camera import DerivedCamera
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.render.tables import pad_spheres
from raytracer_tpu_torch.scene import materials
from raytracer_tpu_torch.scene.spheres import Scene
from raytracer_tpu_torch.utils.profiling import span, wait


def _host(t):
    """``t`` as a host numpy array: a read that waits for the device, the
    wait ``scene_read``."""
    with wait("scene_read"):
        return t.detach().cpu().numpy()


def containable_flags(scene: Scene, dcam: DerivedCamera,
                      opts: TraceOptions):
    """Per-sphere bool array: may this sphere contain a ray origin? None
    when ``opts.split_scan`` is off."""
    if not opts.split_scan:
        return None
    c = _host(scene.center).astype(np.float64)
    r = np.abs(_host(scene.radius).astype(np.float64))
    act = _host(scene.active).astype(np.float64) > 0.0
    mat = _host(scene.material_type)
    # the derived camera lives on the host: its read waits for nothing
    cam = dcam.origin.detach().cpu().numpy().astype(np.float64)
    lens = float(dcam.lens_radius)
    # float32 hit points on sphere i wander off its surface by about
    # eps32·(|c_i| + r_i); the pairwise test inflates by that bound with
    # 10x headroom, so exact tangencies stay containable
    delta = 1e-5 * (np.linalg.norm(c, axis=-1) + r + 1.0)
    containable = act & (mat == materials.GLASS)
    # the camera or any lens sample inside, with the same scale-relative
    # margin for the float32 lens-ray origins
    cam_delta = 1e-5 * (np.linalg.norm(cam) + 1.0)
    containable |= act & (
        np.linalg.norm(c - cam[None, :], axis=-1)
        < r + lens + cam_delta + 1e-4
    )
    # shell_i crosses ball_j iff | |ci - cj| - ri | < rj
    dist = np.linalg.norm(c[:, None, :] - c[None, :, :], axis=-1)
    crosses = np.abs(dist - r[:, None]) < (r[None, :] + delta[:, None]
                                           + 1e-4)
    np.fill_diagonal(crosses, False)
    containable |= act & (crosses & act[:, None]).any(axis=0)
    return containable


def containable_split(scene: Scene, dcam: DerivedCamera,
                      opts: TraceOptions):
    """``(perm, g_full)`` for the split scan, or None where the JAX
    package keeps full logic on every slot: 8 slots or fewer, the
    analysis off, or every slot needing full logic. ``perm`` (a numpy
    index array, or None when the scene is already laid out so) puts the
    containable spheres first, stably; ``g_full`` counts the full-logic
    slots in the JAX package's padding (a multiple of 8). The span
    ``split``; its reads of the scene, the waits ``scene_read``."""
    with span("split"):
        if scene.count <= 8:
            return None
        flags = containable_flags(scene, dcam, opts)
        if flags is None:
            return None
        n_cont = int(flags.sum())
        s_pad = pad_spheres(flags.shape[0])
        g_full = min(s_pad, pad_spheres(max(1, n_cont)) if n_cont else 0)
        if g_full >= s_pad:
            return None
        perm = np.argsort(~flags, kind="stable")
        if np.array_equal(perm, np.arange(perm.shape[0])):
            perm = None
        return perm, g_full
