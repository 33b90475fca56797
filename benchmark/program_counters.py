"""Readings of the program's own span registry
(`raytracer_tpu_torch.utils.profiling`: `span`, `wait`, `counters`),
which `reset_launch_counts()` clears when the measured window opens
(run.py `Counters.reset`). So its totals, read after the window, are the
window's renders' own; each reading here is a total over the renders
completed in the window.

The program is imported when a reader runs, never when this module is
imported. A program without the registry (one older than it), or a
window in which no `render_image` span closed, gives None: the metric is
left out of the result line."""

from __future__ import annotations

#: the span of one whole render, and the registry's total of every wait
RENDER, WAITS = "render_image", "waits"


def snapshot():
    """The registry's `{name: (count, seconds)}`, or None where the
    program has no registry or the window holds no render span."""
    from raytracer_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    snap = read()
    return snap if RENDER in snap else None


def _per_unit(run, value):
    """`value(snapshot)` over the window's renders, or None."""
    snap = snapshot()
    if snap is None or not run.units:
        return None
    return value(snap) / len(run.units)


def host_ms_per_unit(run):
    """Host milliseconds a render inside `render_image` not spent waiting
    on the device: the render spans' seconds less the waits' seconds. A
    host that fills the card's launch queue blocks in a launch, and that
    time counts here too; so the metric lists only cells whose host does
    not run that far ahead."""
    return _per_unit(run, lambda s: (s[RENDER][1]
                                     - s.get(WAITS, (0, 0.0))[1]) * 1e3)


def prep_ms_per_unit(run):
    """Milliseconds a render in `prep`: the kernel choice, the scene's
    analysis and the tables, before the first launch."""
    return _per_unit(run, lambda s: s.get("prep", (0, 0.0))[1] * 1e3)


def waits_per_unit(run):
    """Calls a render in which the host waits on the device (read backs
    and the synchronize), counted by the program."""
    return _per_unit(run, lambda s: s.get(WAITS, (0, 0.0))[0])
