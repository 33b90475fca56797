"""Milliseconds a render in the program's `prep` span (the kernel
choice, the kd partition with its scene read, the walk tables and
their upload), from the program's span registry over the window."""

from benchmark.program_counters import prep_ms_per_unit as read  # noqa: F401
