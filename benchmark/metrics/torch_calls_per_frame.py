"""Top-level PyTorch (aten) calls a frame in the profiled frames: calls
not made inside another aten call, by the profiler's CPU timeline."""


def read(run):
    if run.sub is None or not run.sub_units:
        return None
    return run.sub["aten_top"] / len(run.sub_units)
