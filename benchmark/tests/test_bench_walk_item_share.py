"""The `walk_item_share` reader on known registry totals, without the
walk's counts (a program older than them), and without a render."""

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
    return harness.load_reader("walk_item_share")(
        types.SimpleNamespace(units=[{}] * 4))


@pytest.mark.parametrize("items, every, want", [
    (2_500_000, 65_900_000, 100.0 * 2_500_000 / 65_900_000),
    (0, 10, 0.0), (31, 31, 100.0)])
def test_share_of_known_totals(monkeypatch, profiling, items, every, want):
    snap = {**RENDERS, "walk_item_samples": (items, 0.0),
            "walk_samples": (every, 0.0)}
    assert _read(monkeypatch, profiling, snap) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    RENDERS,                                      # no adaptive walk
    {**RENDERS, "walk_item_samples": (0, 0.0), "walk_samples": (0, 0.0)},
    {"walk_item_samples": (5, 0.0), "walk_samples": (9, 0.0)},  # no render
], ids=["no_counts", "no_samples", "no_render"])
def test_none_without_counts(monkeypatch, profiling, snap):
    assert _read(monkeypatch, profiling, snap) is None


def test_none_for_a_program_without_a_registry(monkeypatch, profiling):
    monkeypatch.delattr(profiling, "counters")
    assert harness.load_reader("walk_item_share")(
        types.SimpleNamespace(units=[{}])) is None


def test_listed_for_the_adaptive_cell():
    entry = {m["name"]: m for m in harness.load_spec()["per_layer"]}[
        "walk_item_share"]
    assert entry == {"name": "walk_item_share", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "kernels", "moves": "render_s",
                     "workloads": ["cover-adaptive"]}
