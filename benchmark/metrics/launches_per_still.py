"""Renderer kernel launches a still, from the port's own launch counters
(cluster walk and flat scan) over the window."""

from benchmark.readers import launches_per_unit as read  # noqa: F401
