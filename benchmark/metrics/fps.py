"""Frames completed over the whole window; the window ends in a
synchronize after the last frame."""


def read(run):
    return len(run.units) / run.window_s if run.units else None
