"""The cluster walk's iterations a completed bounce: its lanes' walk
iterations over their completed bounces, the program's device counts
`walk_iterations` and `walk_segments`, read from its registry after the
window. An iteration tests the boxes of the clusters not yet visited
and visits the nearest; so this is the work the traversal spends
finding one closest hit. A program without the counts (one older than
the wide walk, which keeps them), or a window without a wide walk,
gives None."""

from benchmark.program_counters import snapshot

ITERATIONS, SEGMENTS = "walk_iterations", "walk_segments"


def read(run):
    snap = snapshot()
    if snap is None or ITERATIONS not in snap or SEGMENTS not in snap:
        return None
    segments = snap[SEGMENTS][0]
    return snap[ITERATIONS][0] / segments if segments > 0 else None
