"""The share of the image's lanes that the adaptive re-plans read, in
percent: the program's device counts `plan_lanes` (the lanes each re-plan
read: those that had budget) over `plan_slots` (re-plans times the
image's lanes), read from its registry after the window. A re-plan over
every pixel reads 100. A program without them (one whose re-plans read
every pixel), or a window without an adaptive re-plan, gives None."""

from benchmark.program_counters import snapshot

LANES, SLOTS = "plan_lanes", "plan_slots"


def read(run):
    snap = snapshot()
    if snap is None or LANES not in snap or SLOTS not in snap:
        return None
    slots = snap[SLOTS][0]
    return 100.0 * snap[LANES][0] / slots if slots > 0 else None
