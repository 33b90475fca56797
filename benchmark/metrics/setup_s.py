"""Seconds from process start to the window's first timed call:
interpreter, imports, CUDA context, kernel libraries (built on a
checkout's first run), scene tables, and the warm-up of the cell's own
shapes."""


def read(run):
    return run.setup_s
