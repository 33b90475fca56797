"""The whole render's share of the card's float32 peak, in percent, for
renders with a shutter: the operations of the profiled renders by the
count of `roofline_motion.py` (from their exact segments and samples)
over the wall time they took, host gaps included, at 67e12 a second."""

from benchmark.roofline_motion import mfu as read  # noqa: F401
