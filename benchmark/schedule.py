"""The renderer's launch schedule, as the reference needs it: the spp of
each launch fixes a pixel's float32 summation order, and in an adaptive
render the points at which a pixel may stop. A frozen copy of the rule
the port states (its `render/schedule.py`), so that the reference works
it out again from the render's arguments."""

from __future__ import annotations


def pick_chunk_spp(spp: int, n_pixels: int, s_count: int, max_depth: int,
                   rr_depth: int = 0) -> int:
    """spp of one launch: about 1.2e11 ray-sphere tests at a flat depth
    of 3 (with Russian roulette) or 4."""
    eff_depth = min(max_depth, 3 if rr_depth else 4)
    per_sample = n_pixels * eff_depth * max(s_count, 1)
    return max(1, min(spp, int(1.2e11 // max(per_sample, 1))))


def chunk_schedule(spp: int, chunk: int):
    """(sizes, uniform): a first launch of about half the chunk, then
    equal launches where possible, at most twice the chunk."""
    if spp <= chunk:
        return [spp], False
    c0p = max(1, chunk // 2)
    n0 = max(1, -(-(spp - c0p) // (2 * chunk)))
    for n in range(n0, n0 + 256):
        cs = -(-(spp - c0p) // n)
        c0 = spp - n * cs
        if 1 <= c0 <= chunk and max(2, chunk // 2) <= cs <= 2 * chunk:
            return [c0] + [cs] * n, True
    sizes, off = [c0p], c0p
    while off < spp:
        c = min(2 * chunk, spp - off)
        sizes.append(c)
        off += c
    return sizes, False


def fixed_sizes(spp: int, n_pixels: int, s_count: int,
                max_depth: int) -> list:
    return chunk_schedule(spp, pick_chunk_spp(spp, n_pixels, s_count,
                                              max_depth))[0]


def adaptive_sizes(spp: int, n_pixels: int, s_count: int,
                   max_depth: int):
    """Launch sizes of an adaptive render (launch cap 16), or None where
    it renders fixed spp: one launch, or launches that are not equal."""
    chunk = pick_chunk_spp(spp, n_pixels, s_count, max_depth)
    chunk_a = min(chunk, 16)
    sizes, uniform = chunk_schedule(spp, chunk_a)
    if spp <= chunk_a or not uniform:
        return None
    return sizes
