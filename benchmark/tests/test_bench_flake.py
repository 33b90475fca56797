"""The `flake-offline` cell: its configuration's sphere list is the port's
sphereflake preset, written out as data; the cell loads with the metrics
it lists; a whole sound run of it on the CPU at a tiny size reads
correct; and the `walk_iters_per_segment` reader on known registry
totals, and without the wide walk's counts (a program older than them)."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from benchmark import harness, scenes
from benchmark import run as bench_run

RENDERS = {"render_image": (4, 0.8), "waits": (40, 0.2)}


def test_flake_scene_copy_equals_the_port_preset():
    from raytracer_tpu_torch.scene import presets

    want = presets.sphereflake_scene(4).numpy()
    cell = harness.load_cell("flake-offline")
    got = scenes.scene_arrays(cell.config["scene"])
    assert got["center"].shape == (7382, 3)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_flake_cell_loads_its_metrics():
    cell = harness.load_cell("flake-offline")
    assert cell.chips == 1 and cell.traffic["entry"] == "render_image"
    assert cell.config["camera"]["vup"] == [0.0, 0.0, 1.0]
    assert (cell.config["image_width"], cell.config["image_height"],
            cell.config["samples_per_pixel"], cell.config["max_depth"]) == (
        512, 512, 500, 50)
    assert [m["name"] for m in cell.end_to_end] == ["render_s", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert {"walk_iters_per_segment", "walk_roofline", "render_mfu",
            "launches_per_render", "idle_share.render"} <= names
    assert "walk_item_share" not in names
    assert set(cell.limits) == {"pixel_mismatch", "pixel_gap",
                                "segment_gap"}


class Frozen:
    """No launch counters on the CPU."""

    def reset(self):
        pass

    def read(self):
        return {}


def test_sound_flake_run_is_correct():
    """The cell's traffic at 16x12, 3 spp (its depth 50) through the
    port's plain walk on the CPU, checked against the reference."""
    import raytracer_tpu_torch as port

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = bench_run.run(port, harness.load_cell("flake-offline"),
                            2**31 + 77, 0.3, False, torch.device("cpu"),
                            overrides={"width": 16, "height": 12, "spp": 3},
                            counters=Frozen())
    finally:
        torch.set_num_threads(n)
    assert out["correct"], out["checks"]
    assert out["checks"]["pixel_mismatch"]["value"] == 0.0
    assert out["attempted"] >= 1 and set(out["metrics"]) == {"render_s",
                                                            "setup_s"}


@pytest.fixture
def profiling():
    from raytracer_tpu_torch.utils import profiling

    profiling.reset_counters()
    yield profiling
    profiling.reset_counters()


def _read(monkeypatch, profiling, snap):
    monkeypatch.setattr(profiling, "counters", lambda: dict(snap))
    return harness.load_reader("walk_iters_per_segment")(
        types.SimpleNamespace(units=[{}] * 4))


@pytest.mark.parametrize("iters, segs, want", [
    (9_000_000, 3_000_000, 3.0), (5, 5, 1.0), (7, 2, 3.5)])
def test_iterations_per_segment_of_known_totals(monkeypatch, profiling,
                                                iters, segs, want):
    snap = {**RENDERS, "walk_iterations": (iters, 0.0),
            "walk_segments": (segs, 0.0)}
    assert _read(monkeypatch, profiling, snap) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    RENDERS,
    {**RENDERS, "walk_iterations": (0, 0.0), "walk_segments": (0, 0.0)},
    {"walk_iterations": (5, 0.0), "walk_segments": (9, 0.0)},
], ids=["no_counts", "no_segments", "no_render"])
def test_none_without_the_wide_walks_counts(monkeypatch, profiling, snap):
    assert _read(monkeypatch, profiling, snap) is None


def test_listed_for_the_flake_cell():
    entry = {m["name"]: m for m in harness.load_spec()["per_layer"]}[
        "walk_iters_per_segment"]
    assert entry == {"name": "walk_iters_per_segment",
                     "unit": "iters/segment", "better": "lower",
                     "source": "program_counter", "layer": "kernels",
                     "moves": "render_s", "workloads": ["flake-offline"]}
