"""Calls a still in which the host waits on the device (the split's
reads, the segment total, the synchronize), from the program's `wait`
count over the window."""

from benchmark.program_counters import waits_per_unit as read  # noqa: F401
