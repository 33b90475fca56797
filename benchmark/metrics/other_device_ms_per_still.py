"""Device milliseconds a still outside the renderer kernels (lane maps,
accumulation, finalize, table uploads, copies), in the profiled stills."""

from benchmark.readers import other_device_ms_per_unit as read  # noqa: F401
