"""Host milliseconds a frame inside the engine: the benchmark's spans
around `Engine.tick` and `handle_mouse_move`, over every frame of the
traced run's measured window (after its profiled frames)."""


def read(run):
    ticks = run.spans.durations("tick")
    if not ticks:
        return None
    return (sum(ticks) + sum(run.spans.durations("handle_mouse_move"))) \
        * 1e3 / len(ticks)
