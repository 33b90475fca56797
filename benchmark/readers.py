"""Readings that several per-layer metrics take, each in the cells of its
own end-to-end metric: a metric moves one end-to-end metric, so a
quantity whose cells report different ones is split by name
(`launches_per_render` in the cells of `render_s`, `launches_per_still`
in those of `still_s`), and both names read it here."""

from __future__ import annotations

from benchmark import roofline

#: the renderer kernels; every other device operation is orchestration
RENDERER = ("cluster_walk_kernel", "flat_scan_kernel")


def seconds_per_unit(run):
    """The whole window over the renders completed in it."""
    return run.window_s / len(run.units) if run.units else None


def launches_per_unit(run):
    """Renderer kernel launches a render, by the port's own counters over
    the window."""
    if not run.units:
        return None
    return sum(run.launches.values()) / len(run.units)


def other_device_ms_per_unit(run):
    """Device milliseconds a profiled render outside the renderer
    kernels."""
    if run.sub is None or not run.sub_units:
        return None
    other = sum(d for name, _, _, d in run.sub["device"]
                if not any(k in name for k in RENDERER))
    return other * 1e3 / len(run.sub_units)


def idle_share(run):
    """Percent of the profiled window with nothing on the device."""
    if run.sub is None or run.sub["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.sub["busy_s"] / run.sub["window_s"])


def mfu(run):
    """The profiled renders' operations (from their exact segments and
    samples) over the wall time they took, host gaps included, at the
    float32 peak, in percent."""
    if run.sub is None or not run.sub_units or run.sub["window_s"] <= 0:
        return None
    ops = roofline.window_ops(run.sub_units, run.cell.traffic)
    return 100.0 * ops / (run.sub["window_s"] * roofline.FP32_PEAK)
