"""Calls a render in which the host waits on the device (the scene's
read back, the segment total, the adaptive mean, the synchronize), from
the program's `wait` count over the window."""

from benchmark.program_counters import waits_per_unit as read  # noqa: F401
