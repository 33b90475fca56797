"""Milliseconds a still in the program's `prep` span (the kernel
choice, the split analysis with its scene reads, the flat tables and
their upload), from the program's span registry over the window."""

from benchmark.program_counters import prep_ms_per_unit as read  # noqa: F401
