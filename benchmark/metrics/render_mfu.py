"""The whole render's share of the card's float32 peak, in percent: the
operations of the profiled renders (benchmark/roofline.py, from their
exact segments and samples) over the wall time they took, host gaps
included, at 67e12 a second. It bounds any kernel's roofline gain: a
kernel taken off the path silences its own roofline, not this."""

from benchmark.readers import mfu as read  # noqa: F401
