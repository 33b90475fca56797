"""The motion walk's share of its roofline (csrc/cluster_walk.cu built
with RT_WALK_MOTION, whose kernel is `cluster_walk_kernel` too), in
percent, over the profiled renders, by the count of
`roofline_motion.py`: `roofline.py`'s, and the centre at a ray's time
and the time draw."""

from benchmark import roofline_motion


def read(run):
    return roofline_motion.kernel_share(run, "cluster_walk_kernel")
