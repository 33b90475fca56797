"""The `plan_live_share` reader on known registry totals, without the
re-plans' counts (a program older than them), and without a render."""

from __future__ import annotations

import types

import pytest

from benchmark import harness

RENDERS = {"render_image": (4, 0.8), "waits": (40, 0.2)}


@pytest.fixture
def profiling():
    from raytracer_tpu_torch.utils import profiling

    profiling.reset_counters()
    yield profiling
    profiling.reset_counters()


def _read(monkeypatch, profiling, snap):
    monkeypatch.setattr(profiling, "counters", lambda: dict(snap))
    return harness.load_reader("plan_live_share")(
        types.SimpleNamespace(units=[{}] * 4))


@pytest.mark.parametrize("lanes, slots, want", [
    (2_960_917, 15_360_000, 100.0 * 2_960_917 / 15_360_000),
    (0, 10, 0.0), (960_000, 960_000, 100.0)])
def test_share_of_known_totals(monkeypatch, profiling, lanes, slots, want):
    snap = {**RENDERS, "plan_lanes": (lanes, 0.0),
            "plan_slots": (slots, 0.0)}
    assert _read(monkeypatch, profiling, snap) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    RENDERS,                                      # no re-plan
    {**RENDERS, "plan_lanes": (0, 0.0), "plan_slots": (0, 0.0)},
    {"plan_lanes": (5, 0.0), "plan_slots": (9, 0.0)},  # no render
], ids=["no_counts", "no_slots", "no_render"])
def test_none_without_counts(monkeypatch, profiling, snap):
    assert _read(monkeypatch, profiling, snap) is None


def test_none_for_a_program_without_a_registry(monkeypatch, profiling):
    monkeypatch.delattr(profiling, "counters")
    assert harness.load_reader("plan_live_share")(
        types.SimpleNamespace(units=[{}])) is None


def test_listed_for_the_adaptive_cell():
    entry = {m["name"]: m for m in harness.load_spec()["per_layer"]}[
        "plan_live_share"]
    assert entry == {"name": "plan_live_share", "unit": "%",
                     "better": "lower", "source": "program_counter",
                     "layer": "render orchestration", "moves": "render_s",
                     "workloads": ["cover-adaptive"]}
