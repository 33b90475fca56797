"""Device milliseconds a render outside the renderer kernels (lane maps,
plans, accumulation, finalize, table uploads, copies), in the profiled
renders."""

from benchmark.readers import other_device_ms_per_unit as read  # noqa: F401
