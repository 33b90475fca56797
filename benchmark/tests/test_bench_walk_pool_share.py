"""The `walk_pool_share` reader on known registry totals, without the
pool's counts (a program older than the pool), without a wide walk, and
without a render; and its entry in the benchmark."""

from __future__ import annotations

import types

import pytest

from benchmark import harness

RENDERS = {"render_image": (4, 0.8), "waits": (36, 0.2)}
WIDE = {"walk_iterations": (900, 0.0), "walk_segments": (400, 0.0),
        "walk_sweeps": (0, 0.0)}


@pytest.fixture
def profiling():
    from raytracer_tpu_torch.utils import profiling

    profiling.reset_counters()
    yield profiling
    profiling.reset_counters()


def _read(monkeypatch, profiling, snap):
    monkeypatch.setattr(profiling, "counters", lambda: dict(snap))
    return harness.load_reader("walk_pool_share")(
        types.SimpleNamespace(units=[{}] * 4))


@pytest.mark.parametrize("pooled, visits, want", [
    (612_345, 744_000, 100.0 * 612_345 / 744_000),
    (0, 10, 0.0), (7, 7, 100.0)])
def test_share_of_known_totals(monkeypatch, profiling, pooled, visits,
                               want):
    snap = {**RENDERS, **WIDE, "walk_visits": (visits, 0.0),
            "walk_pooled": (pooled, 0.0)}
    assert _read(monkeypatch, profiling, snap) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    RENDERS,                                         # no wide walk
    {**RENDERS, **WIDE},                             # a program before it
    {**RENDERS, **WIDE, "walk_visits": (0, 0.0),     # no visit
     "walk_pooled": (0, 0.0)},
    {**WIDE, "walk_visits": (5, 0.0), "walk_pooled": (1, 0.0)},  # no render
], ids=["no_counts", "no_pool", "no_visits", "no_render"])
def test_none_without_counts(monkeypatch, profiling, snap):
    assert _read(monkeypatch, profiling, snap) is None


def test_none_for_a_program_without_a_registry(monkeypatch, profiling):
    monkeypatch.delattr(profiling, "counters")
    assert harness.load_reader("walk_pool_share")(
        types.SimpleNamespace(units=[{}])) is None


def test_the_wide_walk_counts_its_visits():
    """The program registers the counts the reader reads, after the wide
    walk's others in the same buffer."""
    from raytracer_tpu_torch.render import cluster_walk as cw

    assert cw.VISIT_COUNTS == ("walk_visits", "walk_pooled")


def test_listed_for_the_flake_cell():
    entry = {m["name"]: m for m in harness.load_spec()["per_layer"]}[
        "walk_pool_share"]
    assert entry == {"name": "walk_pool_share", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "kernels", "moves": "render_s",
                     "workloads": ["flake-offline"]}
