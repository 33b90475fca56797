"""The spp launch schedule (counterpart of
``raytracer_tpu/render/pallas_kernel.py`` ``_pick_chunk_spp`` and
``_chunk_schedule``, copied verbatim).

On a GPU the TPU's watchdog budget is gone, but the schedule fixes the
per-pixel float32 summation order (sample order within a launch, then
launch order), so the port keeps it to stay comparable with the JAX
package. It must be fed the ORIGINAL scene's slot count, not the padded
partition's.
"""

from __future__ import annotations


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
