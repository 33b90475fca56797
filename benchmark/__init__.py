"""The benchmark of raytracer_tpu_torch: see run.py and PERF.md."""
