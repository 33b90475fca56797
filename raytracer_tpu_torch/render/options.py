"""Trace options of the port (counterpart of
``raytracer_tpu/render/options.py``): what the ported paths (cluster
walk, flat and split scan; fixed spp, adaptive, stratified; the debug
overlay; the jnp tracer) read. The production cluster-walk configuration of the
JAX package (one cluster per walk step, packed visit key, fused
bounce-done test) is the only walk the port has, so it carries no knobs
for it."""

from __future__ import annotations

import dataclasses

import numpy as np

from raytracer_tpu_torch.scene.spheres import NO_SELECTED_OBJECT_ID

# Kernel constants (the reference shader's t range).
MIN_T = 0.001
MAX_T = 1e5

#: scenes below this slot count take the flat scan under
#: ``cluster_scan='auto'``
CLUSTER_AUTO_MIN_SPHERES = 64


#: the JAX package's backend names
BACKENDS = ("auto", "jnp", "pallas")


def check_backend(backend: str) -> None:
    """Raises ``TypeError`` for a value that is not a string (an argument
    given in another position) and ``ValueError`` for a name that is not a
    backend."""
    if not isinstance(backend, str):
        raise TypeError(f"backend must be one of {BACKENDS}, got "
                        f"{type(backend).__name__} {backend!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def resolve_backend(backend: str) -> str:
    """``backend`` with 'auto' resolved: 'pallas', the kernels (the CUDA
    kernels on a card, their plain PyTorch versions on the CPU), on every
    device. This differs from the JAX package on purpose: there 'auto'
    off a TPU means 'jnp', because its CPU runs Pallas only in interpret
    mode; the port's plain versions render on the CPU, so 'jnp' runs
    only when it is named."""
    check_backend(backend)
    return "pallas" if backend == "auto" else backend


def cluster_scan_enabled(opts: "TraceOptions", scene_count: int) -> bool:
    """Resolve ``opts.cluster_scan`` ('auto' | bool) for a scene of
    ``scene_count`` slots: 'auto' is on from CLUSTER_AUTO_MIN_SPHERES
    slots unless ``scan_mxu`` was asked for. A True resolution still
    takes the flat scan where no partition can be built."""
    if opts.cluster_scan == "auto":
        return (not opts.scan_mxu
                and scene_count >= CLUSTER_AUTO_MIN_SPHERES)
    return bool(opts.cluster_scan)


@dataclasses.dataclass(frozen=True)
class TraceOptions:
    """Static tracing options.

    ``exhaust_black`` returns black instead of the accumulated throughput
    when a path runs out of bounces; ``near_zero_guard`` re-aims a
    near-zero diffuse direction at the normal. Both default to the
    reference shader's behaviour. ``russian_roulette_depth`` > 0 ends
    paths from that bounce on with probability 1 - max(throughput) and
    reweights survivors. ``sort_pixels`` renders chunks after the first in
    descending measured per-pixel cost; the image does not change.

    ``adaptive_tolerance`` > 0 stops sampling a pixel, between chunks, once
    the 95 % confidence half-width of its mean luminance is within
    tolerance · (mean + 0.02); it needs ``sort_pixels`` and a multi-chunk
    uniform schedule, and renders fixed spp otherwise.
    ``adaptive_chunk_spp`` > 0 overrides the adaptive chunk cap (never
    above the fixed render's chunk). ``sampler`` is ``'random'``
    (independent hashed draws) or ``'stratified'`` (the camera draws and
    the first bounce's diffuse direction and glass roll come from a
    per-pixel rotated Kronecker sequence; marginals are unchanged).

    ``enable_debug`` draws the overlay in the kernel: the cursor marker
    and the selection outline (see :class:`DebugParams`). A debug render
    keeps the scene's slot order (no split) and strips an adaptive
    tolerance, as the JAX package does.

    ``interleave_rows`` gives each rows shard of a sharded render
    (``parallel/sharding.py``) every rows-th block of rows instead of one
    band; the image does not change, and a single-device render ignores
    it.

    ``backend`` is 'auto', 'pallas' (both: the kernels) or 'jnp' (the JAX
    package's wavefront tracer, ``render/tracer.py``, in plain PyTorch on
    the same device); see :func:`resolve_backend`. The jnp tracer reads
    the physics options, the sampler and the overlay, and ignores the
    kernels' scan, sort and adaptive options, as the JAX package's does.

    ``cluster_scan`` ('auto', True or False) chooses the cluster walk
    over the flat scan (see :func:`cluster_scan_enabled`). ``split_scan``
    lets a concrete scene's flat scan skip the far root of spheres that
    cannot contain a ray origin (``render/split.py``). ``scan_mxu`` (the
    JAX package's MXU offload of the flat scan, a TPU workaround) is
    accepted and served by the flat scan in exact float32.

    Options the JAX package has and the port does not yet serve raise
    ``NotImplementedError`` naming their ROADMAP item.

    The fields up to ``cluster_scan`` are the JAX package's, in its order
    and with its defaults, so a positional call means what it means there.
    The rest are keyword-only: the JAX package's next field
    (``cluster_cpi``) is not ported, and a keyword only the JAX package
    has raises ``TypeError``.
    """

    max_depth: int = 8
    exhaust_black: bool = False
    near_zero_guard: bool = False
    gamma: bool = True
    enable_debug: bool = False
    backend: str = "auto"
    russian_roulette_depth: int = 0
    sort_pixels: bool = True
    adaptive_tolerance: float = 0.0
    adaptive_chunk_spp: int = 0
    sampler: str = "random"
    split_scan: bool = True
    scan_mxu: bool = False
    cluster_scan: bool | str = "auto"
    # the JAX package's next field, cluster_cpi, is not ported (ROADMAP
    # "Not to port"): from here on every field is keyword-only, so a
    # positional call past cluster_scan raises instead of filling another
    # field
    _: dataclasses.KW_ONLY
    cluster_bounds: str = "box"
    #: spheres per cluster of the partition
    cluster_group: int = 16
    cluster_partition: str = "kd"
    interleave_rows: bool = False

    def __post_init__(self):
        check_backend(self.backend)
        if self.max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {self.max_depth}")
        if self.cluster_group < 1:
            raise ValueError(
                f"cluster_group must be >= 1, got {self.cluster_group}"
            )
        if self.sampler not in ("random", "stratified"):
            raise ValueError(
                f"sampler must be 'random' or 'stratified', got "
                f"{self.sampler!r}"
            )
        if self.cluster_scan not in (True, False, "auto"):
            raise ValueError(
                f"cluster_scan must be True, False or 'auto', got "
                f"{self.cluster_scan!r}"
            )
        if self.cluster_scan is True and self.scan_mxu:
            raise ValueError(
                "cluster_scan and scan_mxu are alternative scan "
                "implementations — enable at most one"
            )
        if self.cluster_bounds != "box":
            raise NotImplementedError(
                f"cluster_bounds {self.cluster_bounds!r}: only 'box' is "
                "ported (the sphere-bound walk is among ROADMAP.md §2's "
                "variants not to be ported)"
            )
        if self.cluster_partition != "kd":
            raise NotImplementedError(
                f"cluster_partition {self.cluster_partition!r}: only 'kd' "
                "is ported"
            )


def check_debug(debug) -> None:
    """Raises ``TypeError`` unless ``debug`` is a :class:`DebugParams` or
    None (an argument given in another position)."""
    if debug is not None and not isinstance(debug, DebugParams):
        raise TypeError(f"debug must be a DebugParams or None, got "
                        f"{type(debug).__name__} {debug!r}")


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class DebugParams:
    """The debug overlay's inputs as host values (the reference's
    u_cursor_point / u_selected_object uniforms): a float32 cursor point
    and the selected sphere's id. The kernels take them by value, so a
    frame uploads nothing for them and waits for nothing."""

    cursor_point: tuple = (0.0, 0.0, 0.0)
    selected_object: int = NO_SELECTED_OBJECT_ID

    def __post_init__(self):
        point = tuple(_f32(v) for v in self.cursor_point)
        if len(point) != 3:
            raise ValueError(f"cursor_point needs 3 values, got {point}")
        object.__setattr__(self, "cursor_point", point)
        object.__setattr__(self, "selected_object",
                           int(self.selected_object))

    @classmethod
    def none(cls) -> "DebugParams":
        """Cursor at the world origin, nothing selected. Not "nothing
        drawn": a surface within 0.1 of the origin shows the marker, as in
        the JAX package."""
        return cls()


def debug_from_numpy(cursor_point, selected_object) -> DebugParams:
    """:class:`DebugParams` from the JAX ``DebugParams`` fields as
    arrays."""
    return DebugParams(
        tuple(np.asarray(cursor_point, np.float32).reshape(3).tolist()),
        int(np.asarray(selected_object)),
    )
