"""The share of the wide walk's completed bounces whose pending list
overflowed and that swept the boxes instead, in percent: the program's
device counts `walk_sweeps` over `walk_segments`, read from its registry
after the window. It says how often the nearest-first list is not what
ran. A program without the sweeps' count (one older than the list), or
a window without a wide walk, gives None."""

from benchmark.program_counters import snapshot

SWEEPS, SEGMENTS = "walk_sweeps", "walk_segments"


def read(run):
    snap = snapshot()
    if snap is None or SWEEPS not in snap or SEGMENTS not in snap:
        return None
    segments = snap[SEGMENTS][0]
    return 100.0 * snap[SWEEPS][0] / segments if segments > 0 else None
