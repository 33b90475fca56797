"""The flat scan's share of its roofline (csrc/flat_scan.cu over
csrc/common.cuh), in percent, over the profiled renders."""

from benchmark import roofline


def read(run):
    return roofline.kernel_share(run, "flat_scan_kernel")
