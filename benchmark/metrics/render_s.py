"""Seconds to a finished image: the whole window over the renders
completed in it, renders back to back, each ending in `render_image`'s
synchronize."""

from benchmark.readers import seconds_per_unit as read  # noqa: F401
