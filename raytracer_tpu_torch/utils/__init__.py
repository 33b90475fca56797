"""Utilities (counterpart of ``raytracer_tpu/utils/``): throughput
metrics, profiling, the CUDA build and device-fault recovery."""

from raytracer_tpu_torch.utils.profiling import MraysMeter, mrays_per_sec

__all__ = ["MraysMeter", "mrays_per_sec"]
