"""The benchmark's files, its contract and its run on the CPU.

Run: python -m pytest benchmark/tests -q -p xdist -n 4
(CPU; the tests marked `gpu` run on a card:
python -m pytest --noconftest benchmark/tests -m gpu -q)."""

from __future__ import annotations

import ast
import json
import math
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, run as bench_run, scenes

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
#: cells built and checked that BENCHMARK.json does not list yet
PENDING = [w["name"] for w in harness.load_spec(True)["workloads"]
           if w["name"] not in CELLS]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def one_thread():
    # float comparisons: intra-op threads may split a sum differently
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_contract_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = []
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        names.append(m["name"])
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in names
        names.append(m["name"])
    assert len(names) == len(set(names))
    for n in names + CELLS + [c["name"] for c in SPEC["configs"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS + PENDING)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell, pending=True)
    assert harness.session_class(c.traffic["entry"])
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())
    got = {m["name"] for m in c.end_to_end}
    assert "setup_s" in got and len(got) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_reader(m["name"]))


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    spec = harness.load_spec(True)
    listed = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    files = {p.stem for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert listed == files


@pytest.mark.parametrize("cell", ["no-such-cell"] + PENDING)
def test_unlisted_cell_is_refused(cell):
    with pytest.raises(KeyError):
        harness.load_cell(cell)


def test_cover_scene_copy_equals_the_port_preset():
    from raytracer_tpu_torch.scene import presets

    want = presets.cover_scene(0).numpy()
    got = scenes.scene_arrays(harness.load_cell("cover-offline")
                              .config["scene"])
    assert got["center"].shape == (487, 3)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_demo_scene_copy_equals_the_port_preset():
    from raytracer_tpu_torch.scene import presets

    want = presets.demo_scene().numpy()
    got = scenes.scene_arrays(harness.load_cell("demo-offline-1080p")
                              .config["scene"])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_render_keys_differ_by_render_and_seed():
    keys = {tuple(harness.render_key(s, i)) for s in (2**31 + 5, 7)
            for i in range(4)}
    assert len(keys) == 8


def test_reservoir_keeps_a_uniform_sample():
    counts = np.zeros(10)
    for t in range(2000):
        r = harness.Reservoir(2, np.random.default_rng(t))
        for i in range(10):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
    assert counts.min() > 0.8 * 400 and counts.max() < 1.2 * 400


# --- the import guard ------------------------------------------------


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracer_tpu_torch_x", types.ModuleType("x"))
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "raytracer_tpu.render",
                        types.ModuleType("x"))
    assert bench_run.forbidden_modules() == ["jax", "raytracer_tpu"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("name", ["reference.py", "scenes.py",
                                  "schedule.py", "roofline.py",
                                  "trace.py", "harness.py", "readers.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    got = _imports(ROOT / "benchmark" / name)
    assert not got & {"raytracer_tpu_torch", "raytracer_tpu", "jax",
                      "jaxlib", "flax"}, got


def test_no_file_of_the_benchmark_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "raytracer_tpu"}, path


# --- refusals --------------------------------------------------------


def test_no_card_exits_3_with_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH", "PYTORCH_KERNEL_CACHE_PATH", "USE_FLAX"):
        monkeypatch.delenv(var, raising=False)
    rc = bench_run.main(["--workload", "cover-offline", "--seed",
                         str(2**31 + 11), "--seconds", "1", "--trace", "0"])
    assert rc == 3
    assert capsys.readouterr().out == ""


def test_checkout_without_the_program_exits_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    stub = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['run.py', '--workload', 'cover-offline', "
            "'--seed', '5', '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path('benchmark/run.py', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", stub], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode not in (0, None)
    assert proc.stdout == ""
    assert "program is missing" in proc.stderr


# --- a whole run on the CPU, sound and broken ------------------------

TINY = {
    "cover-offline": {"width": 32, "height": 24, "spp": 8},
    "cover-adaptive": {"width": 12, "height": 8, "spp": 130},
    "demo-offline-1080p": {"width": 48, "height": 27, "spp": 4},
    "demo-viewer-1080p": {"width": 48, "height": 27},
}


class Frozen:
    """No launch counters on the CPU."""

    def reset(self):
        pass

    def read(self):
        return {}


def _run(cell, port, seconds=0.3, traffic=None):
    c = harness.load_cell(cell, pending=True)
    c.traffic.update(traffic or {})
    return bench_run.run(port, c, 2**31 + 77, seconds, False,
                         torch.device("cpu"), overrides=TINY[cell],
                         counters=Frozen())


def _port(**over):
    import raytracer_tpu_torch as port

    ns = types.SimpleNamespace(**{k: getattr(port, k) for k in port.__all__})
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("cell", CELLS + PENDING)
def test_sound_run_is_correct(cell):
    import raytracer_tpu_torch as port

    out = _run(cell, port)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in harness.load_cell(
        cell, pending=True).end_to_end}
    assert list(out)[-1] == "checks"


def _broken_render(kind):
    import raytracer_tpu_torch as port

    first = {}

    def render(scene, cam, w, h, spp, key, opts, debug, stats, **kw):
        if kind == "half":
            # half the samples left out, the mean taken over the rest
            return port.render_image(scene, cam, w, h, max(1, spp // 2),
                                     key, opts, debug, stats, **kw)
        img, st = port.render_image(scene, cam, w, h, spp, key, opts,
                                    debug, stats, **kw)
        if kind == "unchanged":
            # every render returns the state of the first (a warm-up)
            first.setdefault("out", (img, st))
            return first["out"]
        if kind == "altered":
            img = img.clone()
            img[..., 0] += 0.05
        return img, st

    return render


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["cover-offline", "demo-offline-1080p",
                                  "cover-adaptive"])
def test_broken_render_is_not_correct(cell, kind):
    out = _run(cell, _port(render_image=_broken_render(kind)), seconds=0.5)
    assert out["attempted"] >= 1
    assert not out["correct"], out["checks"]


def _broken_engine(kind):
    import raytracer_tpu_torch as port

    class Engine(port.Engine):
        def tick(self, now_ms=None):
            if kind == "unchanged" and self.app.render_count > 0:
                # the frame's step returns the state unchanged
                self.render_state = type(self.render_state)(
                    accum=self.render_state.accum,
                    render_count=self.render_state.render_count,
                    frame=self.render_state.frame + 1,
                    key=self.render_state.key)
                return True
            return super().tick(now_ms)

        def handle_mouse_move(self, dx, dy):
            super().handle_mouse_move(dx, dy)
            if kind == "altered":
                x, y, z = self.app.cursor_point
                self.app.cursor_point = (x + 0.01, y, z)

    return Engine


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_broken_viewer_is_not_correct(kind):
    out = _run("demo-viewer-1080p", _port(Engine=_broken_engine(kind)))
    # the window ends after a cycle's still frames: the last move's frame
    # and the 64 after it are checked
    assert out["run"]["checked"]["frames_checked"] == 65
    assert not out["correct"], out["checks"]


def test_look_at_camera_turns_into_the_viewer_camera():
    cam = harness.load_cell("cover-offline").config["camera"]
    view = harness.viewer_camera(dict(cam, aperture=0.0))
    want = harness.basis_of(dict(cam, aperture=0.0), 1.5)
    got = harness.basis_of(view, 1.5)
    for k in ("origin", "lower_left_corner", "horizontal", "vertical"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    with pytest.raises(ValueError):
        harness.viewer_camera(dict(cam, vup=[0.0, 0.0, 1.0]))


def test_a_driver_is_found_by_its_entry():
    assert harness.session_class("engine") is harness.ViewerSession
    with pytest.raises(FileNotFoundError):
        harness.session_class("no-such-entry")


def test_check_against_fails_nan_and_missing():
    ok, rows = harness.check_against({"a": 0.0, "b": math.nan},
                                     {"a": 1.0, "b": 1.0, "c": 1.0})
    assert not ok
    assert [r[0] for r in rows] == ["a", "b", "c"]
    assert harness.check_against({"a": 0.5}, {"a": 1.0})[0]
