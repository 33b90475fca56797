"""The port's render entry point (counterpart of
``raytracer_tpu/render/api.py``): one signature, two backends. 'auto'
and 'pallas' run the kernels (``render_image_pallas`` in
``render/pallas_kernel.py``, over ``render/megakernel.py``), 'jnp' the JAX
package's wavefront tracer (``render/tracer.py``), each on the device the
caller gets from :func:`resolve_device`."""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.camera.camera import (
    CameraConfig,
    DerivedCamera,
    derive_camera,
)
from raytracer_tpu_torch.render.megakernel import segment_stats
from raytracer_tpu_torch.render.options import (
    DebugParams,
    TraceOptions,
    check_debug,
    resolve_backend,
)
from raytracer_tpu_torch.render.rng import fold_in, key_data
from raytracer_tpu_torch.render.tracer import render_image_jnp
from raytracer_tpu_torch.scene.spheres import Scene, is_motion
from raytracer_tpu_torch.utils.profiling import span, wait
from raytracer_tpu_torch.utils.resilience import retry_on_device_fault


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is asked for
    (explicitly or by default) and absent. The CPU runs only when the
    caller names it. A value that is not a device or a device's name
    (an argument given in another position) raises ``TypeError``."""
    if not (device is None or isinstance(device, (str, torch.device))):
        raise TypeError(f"device must be a torch.device or its name, got "
                        f"{type(device).__name__} {device!r}")
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


def check_render_args(width: int, height: int, spp: int, opts, debug,
                      return_stats) -> None:
    """Raise on arguments no render takes: ``spp`` or a side below 1, an
    ``opts`` that is not a :class:`TraceOptions`, a ``debug`` that is not
    a :class:`DebugParams` or None, a ``return_stats`` that is not a
    bool (an argument given in another position)."""
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if width < 1 or height < 1:
        raise ValueError(f"bad image size {width}x{height}")
    if not isinstance(opts, TraceOptions):
        raise TypeError(f"opts must be a TraceOptions, got "
                        f"{type(opts).__name__}")
    check_debug(debug)
    if not isinstance(return_stats, bool):
        raise TypeError(f"return_stats must be a bool, got {return_stats!r}")


def to_derived(camera) -> DerivedCamera:
    """``camera`` as a :class:`DerivedCamera` (derived from a
    :class:`CameraConfig`)."""
    if isinstance(camera, CameraConfig):
        return derive_camera(camera)
    if not isinstance(camera, DerivedCamera):
        raise TypeError(f"camera must be a CameraConfig or DerivedCamera, "
                        f"got {type(camera).__name__}")
    return camera


#: the JAX package's work bound of one jnp execution, in ray-sphere tests
#: at the render's depth (its bounce loop runs max_depth bounces over
#: every lane). Here it decides only how a render is cut into bands and
#: spp chunks, and so which samples it draws: the JAX package's value,
#: so that both cut a render alike.
_JNP_EXEC_BUDGET = 5e9
#: the key fold of a band that starts at row r: 7_000_000 + r
BAND_KEY_FOLD = 7_000_000


def _jnp_chunk_spp(spp: int, p: int, s_count: int, max_depth: int) -> int:
    """spp per execution for a p-pixel grid (at least 1)."""
    per_sample = p * max_depth * max(s_count, 1)
    return max(1, min(spp, int(_JNP_EXEC_BUDGET // max(per_sample, 1))))


def _jnp_band_rows(width: int, height: int, s_count: int,
                   max_depth: int) -> int:
    """Rows per execution: the full height when a 1-spp pass of the whole
    grid fits the budget, else a multiple of 8 rows (at least 8) whose
    1-spp pass does; the last band may be shorter."""
    per_row = width * max_depth * max(s_count, 1)
    if per_row * height <= _JNP_EXEC_BUDGET:
        return height
    rows = max(8, int(_JNP_EXEC_BUDGET // per_row) // 8 * 8)
    return min(height, rows)


def render_jnp(scene: Scene, dcam: DerivedCamera, width: int, height: int,
               spp: int, key, opts: TraceOptions, device,
               sample_offset: int = 0, debug: DebugParams | None = None):
    """The JAX package's jnp dispatch: bands of :func:`_jnp_band_rows`
    rows, each keyed ``fold_in(key, 7_000_000 + first row)`` (one band
    keeps ``key``), rendered in spp chunks of :func:`_jnp_chunk_spp` whose
    means times their spp are summed, then the mean over ``spp`` and the
    gamma. Returns ``(image, segments)``: the (H, W, 3) image and the
    exact int64 segment total as a 0-d device tensor. A chunked render
    equals the unchunked one to float32 rounding, as in the JAX
    package."""
    lin = dataclasses.replace(opts, gamma=False)
    band = _jnp_band_rows(width, height, scene.count, opts.max_depth)
    chunk = _jnp_chunk_spp(spp, width * band, scene.count, opts.max_depth)
    bands, segments = [], torch.zeros((), dtype=torch.int64, device=device)
    for row0 in range(0, height, band):
        bh = min(band, height - row0)
        bkey = key if band >= height else fold_in(key, BAND_KEY_FOLD + row0)
        acc, offset = None, 0
        while offset < spp:
            cs = min(chunk, spp - offset)
            img, stats = render_image_jnp(
                scene, dcam, width, height, cs, bkey, lin, debug,
                return_stats=True, sample_offset=sample_offset + offset,
                row_offset=row0, band_height=bh, device=device)
            img = img * cs  # the chunk's linear sum
            acc = img if acc is None else acc + img
            segments = segments + stats["segments"]
            offset += cs
        bands.append(acc)
    color = (bands[0] if len(bands) == 1 else torch.cat(bands)) * (1.0 / spp)
    if opts.gamma:
        color = torch.sqrt(torch.clamp_min(color, 0.0))
    return color, segments


def render_image(scene: Scene, camera, width: int, height: int, spp: int,
                 key, opts: TraceOptions | None = None,
                 debug: DebugParams | None = None,
                 return_stats: bool = False, *, device=None,
                 sample_offset: int = 0):
    """Render ``spp`` samples per pixel. The arguments are the JAX
    package's, in its order; ``device`` and ``sample_offset`` are the
    port's own and keyword-only. ``camera`` is a
    :class:`CameraConfig` or an already derived :class:`DerivedCamera`.
    ``key`` is an int, which drives the same hash streams as
    ``jax.random.PRNGKey(key)`` in the JAX package, or a JAX key's data
    (a ``(2,)`` uint32 pair, such as ``jax.random.fold_in``'s). Samples
    are numbered from ``sample_offset`` on (a stratified progressive
    session renders its frame i at i·spp); an adaptive render needs 0.
    With ``opts.backend`` 'auto' or 'pallas', scenes go through
    :func:`~raytracer_tpu_torch.render.pallas_kernel.render_image_pallas`:
    the cluster walk or the flat scan as the JAX package's Pallas backend
    chooses; 'jnp' renders with the JAX package's wavefront tracer
    (:func:`render_jnp`), on the same device. With ``opts.enable_debug`` the
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
    ends in a synchronize, so the image is complete when it returns.

    Each attempt is the span ``render_image`` of the registry in
    ``utils/profiling.py``, its synchronize the wait ``sync``."""
    # imported here: pallas_kernel imports this module
    from raytracer_tpu_torch.render.pallas_kernel import render_image_pallas

    opts = TraceOptions() if opts is None else opts
    check_render_args(width, height, spp, opts, debug, return_stats)
    device = resolve_device(device)
    dcam, key = to_derived(camera), key_data(key)

    jnp = resolve_backend(opts.backend) == "jnp"
    if jnp and is_motion(scene):
        raise ValueError("the jnp backend renders static scenes only; a "
                         "scene with a shutter takes the motion walk")

    @retry_on_device_fault
    def run():
        with span("render_image"):
            if jnp:
                image, segments = render_jnp(scene, dcam, width, height,
                                             spp, key, opts, device,
                                             sample_offset, debug)
                out = ((image, segment_stats(segments, {})) if return_stats
                       else image)
            else:
                out = render_image_pallas(scene, dcam, width, height, spp,
                                          key, opts, debug, return_stats,
                                          sample_offset=sample_offset,
                                          device=device)
            if device.type == "cuda":
                # inside the retry's scope, so an asynchronous fault
                # surfaces here
                with wait("sync"):
                    torch.cuda.synchronize(device)
            return out

    return run()
