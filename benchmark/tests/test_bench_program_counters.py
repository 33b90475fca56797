"""The readers of the program's span registry (`program_counters.py`
and the six metrics over it) on known registry totals, on an empty
registry, and on a program without a registry."""

from __future__ import annotations

import types

import pytest

from benchmark import harness, program_counters

#: registry totals of a window of 4 renders, and what each reader gives
TOTALS = {"render_image": (4, 0.8), "prep": (4, 0.02), "launch": (20, 0.1),
          "scene_read": (28, 0.05), "segments": (4, 0.15),
          "waits": (36, 0.2)}
WANT = {"host_ms": (0.8 - 0.2) * 1e3 / 4, "prep_ms": 0.02 * 1e3 / 4,
        "device_waits": 36 / 4}
READERS = [f"{base}_per_{unit}" for base in WANT
           for unit in ("render", "still")]


@pytest.fixture
def profiling():
    from raytracer_tpu_torch.utils import profiling

    profiling.reset_counters()
    yield profiling
    profiling.reset_counters()


def fake_run(units=4):
    return types.SimpleNamespace(units=[{}] * units)


@pytest.mark.parametrize("metric", READERS)
def test_reader_on_known_totals(monkeypatch, profiling, metric):
    monkeypatch.setattr(profiling, "counters", lambda: dict(TOTALS))
    got = harness.load_reader(metric)(fake_run())
    assert got == pytest.approx(WANT[metric.rsplit("_per_", 1)[0]])


@pytest.mark.parametrize("metric", READERS)
def test_reader_gives_none_without_a_render(monkeypatch, profiling,
                                            metric):
    read = harness.load_reader(metric)
    assert read(fake_run()) is None
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"prep": (1, 0.01)})
    assert read(fake_run()) is None
    monkeypatch.setattr(profiling, "counters", lambda: dict(TOTALS))
    assert read(fake_run(0)) is None
    # a program older than the registry
    monkeypatch.delattr(profiling, "counters")
    assert read(fake_run()) is None


def test_snapshot_needs_a_render_span(profiling):
    assert program_counters.snapshot() is None
    with profiling.span("render_image"):
        with profiling.wait("sync"):
            pass
    snap = program_counters.snapshot()
    assert snap["render_image"][0] == 1
    assert snap[program_counters.WAITS][0] == 1


def test_wait_names_agree_with_the_program(profiling):
    assert program_counters.WAITS == profiling.WAITS
