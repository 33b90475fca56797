"""The `walk_sweep_share` reader on known registry totals, without the
sweeps' count (a program older than the wide walk's list), without a
wide walk, and without a render; and its entry in the benchmark."""

from __future__ import annotations

import types

import pytest

from benchmark import harness

RENDERS = {"render_image": (4, 0.8), "waits": (36, 0.2)}


@pytest.fixture
def profiling():
    from raytracer_tpu_torch.utils import profiling

    profiling.reset_counters()
    yield profiling
    profiling.reset_counters()


def _read(monkeypatch, profiling, snap):
    monkeypatch.setattr(profiling, "counters", lambda: dict(snap))
    return harness.load_reader("walk_sweep_share")(
        types.SimpleNamespace(units=[{}] * 4))


@pytest.mark.parametrize("sweeps, segments, want", [
    (1_234, 402_000_000, 100.0 * 1_234 / 402_000_000),
    (0, 10, 0.0), (7, 7, 100.0)])
def test_share_of_known_totals(monkeypatch, profiling, sweeps, segments,
                               want):
    snap = {**RENDERS, "walk_iterations": (2 * segments, 0.0),
            "walk_segments": (segments, 0.0), "walk_sweeps": (sweeps, 0.0)}
    assert _read(monkeypatch, profiling, snap) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    RENDERS,                                      # no wide walk
    {**RENDERS, "walk_iterations": (9, 0.0),      # a program before the list
     "walk_segments": (4, 0.0)},
    {**RENDERS, "walk_segments": (0, 0.0), "walk_sweeps": (0, 0.0)},
    {"walk_segments": (5, 0.0), "walk_sweeps": (1, 0.0)},  # no render
], ids=["no_counts", "no_sweeps", "no_segments", "no_render"])
def test_none_without_counts(monkeypatch, profiling, snap):
    assert _read(monkeypatch, profiling, snap) is None


def test_none_for_a_program_without_a_registry(monkeypatch, profiling):
    monkeypatch.delattr(profiling, "counters")
    assert harness.load_reader("walk_sweep_share")(
        types.SimpleNamespace(units=[{}])) is None


def test_the_wide_walk_counts_its_sweeps():
    """The program registers the count the reader reads, after the wide
    walk's iterations and bounces."""
    from raytracer_tpu_torch.render import cluster_walk as cw

    assert cw.WIDE_COUNTS[2:] == ("walk_iterations", "walk_segments",
                                  "walk_sweeps")


def test_listed_for_the_flake_cell():
    entry = {m["name"]: m for m in harness.load_spec()["per_layer"]}[
        "walk_sweep_share"]
    assert entry == {"name": "walk_sweep_share", "unit": "%",
                     "better": "lower", "source": "program_counter",
                     "layer": "kernels", "moves": "render_s",
                     "workloads": ["flake-offline"]}
