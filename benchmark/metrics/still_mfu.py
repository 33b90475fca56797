"""The whole still's share of the card's float32 peak, in percent: the
operations of the profiled stills (benchmark/roofline.py, from their
exact segments and samples) over the wall time they took, host gaps
included, at 67e12 a second. It bounds the flat scan's roofline gain."""

from benchmark.readers import mfu as read  # noqa: F401
