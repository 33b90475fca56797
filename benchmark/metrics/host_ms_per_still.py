"""Host milliseconds a still inside the program's `render_image` not
spent waiting on the device: the `render_image` spans' seconds less
the `wait` spans' seconds, from the program's span registry over the
window."""

from benchmark.program_counters import host_ms_per_unit as read  # noqa: F401
