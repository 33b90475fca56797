"""The motion walk's member sphere tests a completed bounce: its lanes'
tests of cluster members over their completed bounces, the program's
device counts `motion_member_tests` and `motion_segments`, read from its
registry after the window. A visit tests every slot of its cluster, so
this is what the swept boxes cost a bounce: a box that bounds a sphere's
whole motion is entered by rays that miss the sphere at their own time.
A program without the counts (one older than the motion walk), or a
window without a motion walk, gives None."""

from benchmark.program_counters import snapshot

TESTS, SEGMENTS = "motion_member_tests", "motion_segments"


def read(run):
    snap = snapshot()
    if snap is None or TESTS not in snap or SEGMENTS not in snap:
        return None
    segments = snap[SEGMENTS][0]
    return snap[TESTS][0] / segments if segments > 0 else None
