"""The `bouncing-offline` cell: its configuration's sphere list is the
port's bouncing-spheres preset, written out as data; the cell loads with
exactly the metrics it lists; a whole sound run of it on the CPU at a
tiny size reads correct, and planted faults do not; its yardstick files
import nothing of the program; and its three readers on known registry
and trace totals, and without them."""

from __future__ import annotations

import ast
import types

import numpy as np
import pytest
import torch

from benchmark import harness, roofline, roofline_motion
from benchmark import run as bench_run

ROOT = harness.ROOT
CELL = "bouncing-offline"
SESSION = harness.BENCH_DIR / "sessions" / "moving_render.py"
TINY = {"width": 48, "height": 27, "spp": 3}
RENDERS = {"render_image": (4, 0.8), "waits": (44, 0.2)}


def _session_module():
    return harness._load_module(SESSION, "bench_session")


def test_config_copy_equals_the_port_preset():
    from raytracer_tpu_torch.scene import presets

    want = presets.bouncing_spheres_scene(0).numpy()
    got = _session_module().motion_arrays(
        harness.load_cell(CELL).config["scene"])
    assert set(got) == set(want)
    assert got["center"].shape == (487, 3)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    moving = (got["center1"] != got["center"]).any(1)
    assert int(moving.sum()) == 389 == int(
        harness.load_cell(CELL).config["counts"]["moving"])


def test_cell_loads_exactly_its_metrics():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["entry"] == "moving_render"
    assert issubclass(harness.session_class("moving_render"),
                      harness.OfflineSession)
    assert (cell.config["image_width"], cell.config["image_height"],
            cell.config["samples_per_pixel"], cell.config["max_depth"]) == (
        1200, 675, 500, 50)
    assert cell.traffic["sampler"] == "random"
    assert cell.traffic["adaptive_tolerance"] == 0.0
    assert cell.traffic["traced_renders"] == 5
    assert [m["name"] for m in cell.end_to_end] == ["render_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "launches_per_render", "other_device_ms_per_render",
        "idle_share.render", "host_ms_per_render", "prep_ms_per_render",
        "device_waits_per_render", "motion_walk_roofline",
        "motion_render_mfu", "motion_members_per_segment"}
    assert set(cell.limits) == {"pixel_mismatch", "pixel_gap",
                                "segment_gap"}
    assert cell.check == {"renders": 2, "pixels": 1024}


class Frozen:
    """No launch counters on the CPU."""

    def reset(self):
        pass

    def read(self):
        return {}


def _run(port, seconds=0.3):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return bench_run.run(port, harness.load_cell(CELL), 2**31 + 77,
                             seconds, False, torch.device("cpu"),
                             overrides=TINY, counters=Frozen())
    finally:
        torch.set_num_threads(n)


def test_sound_run_is_correct():
    """The cell's traffic at 48x27, 3 spp (its depth 50) through the
    port's plain motion walk on the CPU, against the reference."""
    import raytracer_tpu_torch as port

    out = _run(port)
    assert out["correct"], out["checks"]
    assert out["checks"]["pixel_mismatch"]["value"] == 0.0
    assert out["attempted"] >= 1 and set(out["metrics"]) == {"render_s",
                                                            "setup_s"}


def _port(**over):
    import raytracer_tpu_torch as port

    ns = types.SimpleNamespace(**{k: getattr(port, k) for k in port.__all__})
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def _faulty(kind, monkeypatch):
    """The program with a planted fault: every ray at time 0; the checker
    off (the ground diffuse in its even colour); or the layout rendered
    static, every sphere at its start."""
    import raytracer_tpu_torch as port
    from raytracer_tpu_torch.render import cluster_walk as cw

    if kind == "time_0":
        monkeypatch.setattr(cw, "shutter_time",
                            lambda pix, s: torch.zeros(pix.shape))
        return port

    def scene_from_numpy(center, radius, material_type, albedo, fuzz,
                         refraction_index, active, device="cpu", **shutter):
        mat = np.asarray(material_type).copy()
        if kind == "checker_off":
            mat[mat == 3] = 0
        else:
            shutter.pop("center1")
        return port.scene_from_numpy(center, radius, mat, albedo, fuzz,
                                     refraction_index, active, device,
                                     **shutter)

    return _port(scene_from_numpy=scene_from_numpy)


@pytest.mark.parametrize("kind", ["time_0", "checker_off", "static"])
def test_planted_fault_is_not_correct(kind, monkeypatch):
    out = _run(_faulty(kind, monkeypatch))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["reference_motion.py", "roofline_motion.py",
                                  "sessions/moving_render.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse((harness.BENCH_DIR / name).read_text())
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            got.add(node.module.split(".")[0])
    assert not got & {"raytracer_tpu_torch", "raytracer_tpu", "jax",
                      "jaxlib", "flax"}, got
    if name == "reference_motion.py":
        assert got <= {"__future__", "numpy", "torch", "benchmark"}, got


# --- the readers ------------------------------------------------------


@pytest.fixture
def profiling():
    from raytracer_tpu_torch.utils import profiling

    profiling.reset_counters()
    yield profiling
    profiling.reset_counters()


def _members(monkeypatch, profiling, snap):
    monkeypatch.setattr(profiling, "counters", lambda: dict(snap))
    return harness.load_reader("motion_members_per_segment")(
        types.SimpleNamespace(units=[{}] * 4))


@pytest.mark.parametrize("tests, segs, want", [
    (20_800_000, 1_000_000, 20.8), (16, 1, 16.0), (48, 32, 1.5)])
def test_members_per_segment_of_known_totals(monkeypatch, profiling, tests,
                                             segs, want):
    snap = {**RENDERS, "motion_member_tests": (tests, 0.0),
            "motion_segments": (segs, 0.0)}
    assert _members(monkeypatch, profiling, snap) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    RENDERS,
    {**RENDERS, "motion_member_tests": (0, 0.0),
     "motion_segments": (0, 0.0)},
    {"motion_member_tests": (5, 0.0), "motion_segments": (9, 0.0)},
], ids=["no_counts", "no_segments", "no_render"])
def test_members_per_segment_none_without_counts(monkeypatch, profiling,
                                                 snap):
    assert _members(monkeypatch, profiling, snap) is None


def _traced_run(device_rows, window_s=2.0):
    """A traced run's record: 4 profiled renders of 1e9 segments and 4e8
    samples each at 1200x675 over 487 spheres, and its trace's kernels."""
    cell = harness.load_cell(CELL)
    units = [{"segments": 10**9, "samples": 4 * 10**8}] * 4
    return types.SimpleNamespace(
        cell=cell, sub_units=units,
        sub={"device": device_rows, "window_s": window_s, "busy_s": 1.9},
        extra={"n_spheres": 487, "width": 1200, "height": 675})


def test_roofline_and_mfu_of_known_totals():
    ops = 4 * (10**9 * (150 + 30 + 6) + 4 * 10**8 * (90 + 14))
    assert roofline_motion.window_ops(_traced_run([]).sub_units,
                                      {"sampler": "random"}) == ops
    rows = [("cluster_walk_kernel<...>", 0, 0, 0.8),
            ("other_kernel", 0, 0, 0.1)]
    bound = max(ops / roofline.FP32_PEAK,
                4 * (487 * 64 + 1200 * 675 * 12) / roofline.HBM_BYTES_PER_S)
    share = harness.load_reader("motion_walk_roofline")(_traced_run(rows))
    assert share == pytest.approx(100.0 * bound / 0.8)
    mfu = harness.load_reader("motion_render_mfu")(_traced_run(rows))
    assert mfu == pytest.approx(100.0 * ops / (2.0 * roofline.FP32_PEAK))
    # more than the static count by the centre and the time draw
    assert ops > roofline.window_ops(_traced_run([]).sub_units,
                                     {"sampler": "random"})


@pytest.mark.parametrize("name", ["motion_walk_roofline",
                                  "motion_render_mfu"])
def test_trace_readers_none_without_a_trace(name):
    read = harness.load_reader(name)
    run = _traced_run([("other_kernel", 0, 0, 0.1)])
    assert read(types.SimpleNamespace(sub=None, sub_units=[])) is None
    if name == "motion_walk_roofline":
        assert read(run) is None


def test_new_metrics_listed_for_the_cell_only():
    per_layer = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    for name, layer, unit in (
            ("motion_walk_roofline", "kernels", "%"),
            ("motion_render_mfu", "render entry", "%"),
            ("motion_members_per_segment", "kernels", "tests/segment")):
        m = per_layer[name]
        assert (m["layer"], m["unit"], m["moves"], m["workloads"]) == (
            layer, unit, "render_s", [CELL])
    for name in ("walk_roofline", "render_mfu"):
        assert CELL not in per_layer[name]["workloads"]
