"""The share of the wide walk's cluster visits whose member tests were
pooled across the warp, in percent: the program's device counts
`walk_pooled` over `walk_visits`, read from its registry after the
window. A trip's visits are pooled where few of a warp's lanes visit at
once, so the lanes without a visit share the visiting lanes' member
tests; the rest run one lane's members after another. A program without
the counts (one older than the pool), or a window without a wide walk,
gives None."""

from benchmark.program_counters import snapshot

POOLED, VISITS = "walk_pooled", "walk_visits"


def read(run):
    snap = snapshot()
    if snap is None or POOLED not in snap or VISITS not in snap:
        return None
    visits = snap[VISITS][0]
    return 100.0 * snap[POOLED][0] / visits if visits > 0 else None
