"""Seconds to a finished 1080p still: the whole window over the stills
completed in it, back to back, each ending in `render_image`'s
synchronize. Apart from `render_s` because its spread is the host's
(a 25 ms render), and its bound with it."""

from benchmark.readers import seconds_per_unit as read  # noqa: F401
