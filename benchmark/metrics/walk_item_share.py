"""The share of the cluster walk's adaptive samples that ran as
one-sample work items (the map's head, spread over the whole grid)
rather than in whole lanes, in percent: the program's device counts
`walk_item_samples` over `walk_samples`, read from its registry after
the window. A program without them (one older than its item path), or
a window with no adaptive walk, gives None."""

from benchmark.program_counters import snapshot

ITEMS, ALL = "walk_item_samples", "walk_samples"


def read(run):
    snap = snapshot()
    if snap is None or ITEMS not in snap or ALL not in snap:
        return None
    total = snap[ALL][0]
    return 100.0 * snap[ITEMS][0] / total if total > 0 else None
