"""Render layer (counterpart of ``raytracer_tpu/render/``): the entry
point :func:`render_image` (``render/api.py``) over the CUDA kernels'
orchestration (``render/megakernel.py``, with ``render_image_pallas`` in
``render/pallas_kernel.py`` under the JAX package's name) and the jnp
tracer (``render/tracer.py``).

``render_image`` and ``TraceOptions`` are resolved when first read
(PEP 562): ``core/sampling.py`` and ``camera/camera.py`` import
``render.rng`` from this package, and ``render/api.py`` imports the
camera, so importing ``api`` here would close a cycle.
"""

__all__ = ["render_image", "TraceOptions"]

_HOMES = {
    "render_image": "raytracer_tpu_torch.render.api",
    "TraceOptions": "raytracer_tpu_torch.render.options",
}


def __getattr__(name):
    if name not in _HOMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(_HOMES[name]), name)
