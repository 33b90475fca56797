"""The spp launch schedule (counterpart of
``raytracer_tpu/render/pallas_kernel.py`` ``_pick_chunk_spp`` and
``_chunk_schedule``, copied verbatim, and the adaptive constants and
schedule rule of ``_render_pallas``).

On a GPU the TPU's watchdog budget is gone, but the schedule fixes the
per-pixel float32 summation order (sample order within a launch, then
launch order), so the port keeps it to stay comparable with the JAX
package. It must be fed the ORIGINAL scene's slot count, not the padded
partition's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

#: samples a pixel must have before it may be declared converged
ADAPTIVE_MIN_N = 64
#: adaptive chunk cap when ``adaptive_chunk_spp`` is 0; the schedule it
#: feeds emits sorted chunks of about twice this. A pixel cannot stop
#: inside a chunk, so the chunk is the floor of its overshoot.
ADAPTIVE_AUTO_CHUNK = 16
#: absolute luminance floor added to the relative tolerance, so
#: near-black pixels do not demand absurd precision
ADAPTIVE_ABS_FLOOR = 0.02
#: two-sided 97.5 % Student-t quantiles by CHUNK count n_c (dof n_c − 1):
#: under 3 chunks no interval forms (inf); above 16 the last entry stays
T975_BY_CHUNKS = (
    math.inf, math.inf, math.inf, 4.303, 3.182, 2.776, 2.571, 2.447,
    2.365, 2.306, 2.262, 2.228, 2.201, 2.179, 2.160, 2.145, 2.131,
)


def pick_chunk_spp(spp: int, p: int, s_count: int, max_depth: int,
                   rr_depth: int = 0) -> int:
    """spp of one launch: ~1.2e11 ray-sphere tests at a flat effective
    depth of 3 (with Russian roulette) or 4."""
    eff_depth = min(max_depth, 3 if rr_depth else 4)
    per_sample = p * eff_depth * max(s_count, 1)
    return max(1, min(spp, int(1.2e11 // max(per_sample, 1))))


def chunk_schedule(spp: int, chunk: int):
    """``(sizes, uniform)``: per-launch spp counts summing to spp. The
    first (profile) chunk is about half the base budget; the rest are
    equal where possible (``uniform``), at most twice the budget."""
    if spp <= chunk:
        return [spp], False
    c0p = max(1, chunk // 2)
    n0 = max(1, -(-(spp - c0p) // (2 * chunk)))
    for n in range(n0, n0 + 256):
        cs = -(-(spp - c0p) // n)
        c0 = spp - n * cs
        if 1 <= c0 <= chunk and max(2, chunk // 2) <= cs <= 2 * chunk:
            return [c0] + [cs] * n, True
    sizes = [c0p]
    off = c0p
    while off < spp:
        c = min(2 * chunk, spp - off)
        sizes.append(c)
        off += c
    return sizes, False


def adaptive_schedule(spp: int, chunk: int, adaptive_chunk_spp: int,
                      sort_pixels: bool):
    """Per-launch spp counts of an adaptive render, or ``None`` when the
    render cannot gate later chunks and runs fixed spp instead: a single
    chunk, unsorted pixels, or a schedule whose sorted chunks are not all
    equal. ``chunk`` is the fixed render's chunk, which caps the adaptive
    one."""
    chunk_a = min(chunk, adaptive_chunk_spp if adaptive_chunk_spp > 0
                  else ADAPTIVE_AUTO_CHUNK)
    sizes, uniform = chunk_schedule(spp, chunk_a)
    if spp <= chunk_a or not sort_pixels or not uniform:
        return None
    return sizes


class RenderSchedule(NamedTuple):
    """How a render launches: ``chunk`` the fixed render's chunk spp,
    ``sort`` whether chunks after the first run in sorted pixel order,
    ``adaptive`` the adaptive render's per-launch spp counts (``None``
    for fixed spp)."""

    chunk: int
    sort: bool
    adaptive: list | None


def render_schedule(spp: int, n_pixels: int, s_count: int,
                    opts) -> RenderSchedule:
    """The schedule of ``spp`` samples over ``n_pixels`` pixels (a band's
    own count when sharded) of a scene of ``s_count`` ORIGINAL slots,
    under ``opts`` (``TraceOptions``). An adaptive tolerance gives sizes
    only where :func:`adaptive_schedule` does and the debug overlay is
    off: it has no adaptive instantiation."""
    chunk = pick_chunk_spp(spp, n_pixels, s_count, opts.max_depth,
                           opts.russian_roulette_depth)
    adaptive = None
    if opts.adaptive_tolerance > 0.0 and not opts.enable_debug:
        adaptive = adaptive_schedule(spp, chunk, opts.adaptive_chunk_spp,
                                     opts.sort_pixels)
    return RenderSchedule(chunk, opts.sort_pixels and spp > chunk, adaptive)
