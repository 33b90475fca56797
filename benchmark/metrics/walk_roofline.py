"""The cluster walk's share of its roofline (csrc/cluster_walk.cu over
csrc/common.cuh), in percent, over the profiled renders."""

from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "cluster_walk_kernel")
