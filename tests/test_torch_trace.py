"""The span registry of the port's render path (``utils/profiling.py``
``span``, ``wait``, ``counters``) and the benchmark's window over it.

- a render leaves ``render_image``, ``prep``, ``launch``, ``plan`` and
  ``finish``, one ``launch`` and one ``plan`` a chunk of the schedule;
  ``partition`` only on the cluster walk's path, ``split`` only on the
  flat scan's;
- the waits a render are a constant of the path, over renders and seeds,
  and the registry's totals add up over renders;
- the scene's analysis counts one wait a field it reads back, and none
  for the camera, which lives on the host;
- either kernel module's ``reset_launch_counts`` empties the registry;
- counts a kernel adds on a device (``device_counts``) join the registry's
  snapshot while any is nonzero, summed over devices, and a reset zeroes
  them;
- under ``torch.profiler`` the spans are ``rt::`` annotations nested in
  ``rt::render_image``; with no profiler recording none is made;
- the six readers (``benchmark/program_counters.py``) are listed for
  their cells, and read a CPU window of the benchmark (their cases on
  known totals are in ``benchmark/tests/test_bench_program_counters.py``).
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from benchmark import harness
from benchmark import run as bench_run
from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.render import (api, cluster_walk, flat_scan,
                                        schedule, split, tables)
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.utils import profiling

W, H = 16, 8
#: waits of one CPU render (no synchronize there): the cover's partition
#: reads its 7 scene fields, the demo's split 4 (the camera it reads
#: lives on the host); then the segment total, and an adaptive render's
#: mean
SCENE_READS = {"cover": 7, "demo": 4}
CPU_WAITS = {("cover", False): 8, ("cover", True): 9, ("demo", False): 5,
             ("demo", True): 6}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Intra-op threads only contend between test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset_counters()
    yield
    torch.set_num_threads(n)


def setup(name, adaptive):
    """(scene, camera, spp, opts) of a small render: the cover (487
    spheres, the cluster walk) or the demo (9 spheres, the flat scan);
    an adaptive render of several launches."""
    scene, cam, *_ = presets.get_config(name, W, H)
    opts = TraceOptions(max_depth=3)
    if adaptive:
        opts = dataclasses.replace(opts, adaptive_tolerance=0.5,
                                   adaptive_chunk_spp=8)
    return scene, cam, (24 if adaptive else 6), opts


def render(name, adaptive, seed=3, device="cpu"):
    scene, cam, spp, opts = setup(name, adaptive)
    return api.render_image(scene.to(device), cam, W, H, spp, seed, opts,
                            None, True, device=device)


def chunks(name, adaptive) -> int:
    """Launches the schedule gives the render."""
    scene, _, spp, opts = setup(name, adaptive)
    plan = schedule.render_schedule(spp, W * H, scene.count, opts)
    if plan.adaptive is not None:
        return len(plan.adaptive)
    return len(schedule.chunk_schedule(spp, plan.chunk)[0])


PATHS = [("cover", False), ("cover", True), ("demo", False), ("demo", True)]


@pytest.mark.parametrize("name, adaptive", PATHS)
def test_render_leaves_its_spans(monkeypatch, name, adaptive):
    if not adaptive:
        # launches of at most 2 spp, so that the fixed render sorts and
        # re-plans too
        monkeypatch.setattr(schedule, "pick_chunk_spp", lambda *a, **k: 2)
    n = chunks(name, adaptive)
    assert n > 1
    render(name, adaptive)
    got = profiling.counters()
    for span in ("render_image", "prep", "finish"):
        assert got[span][0] == 1, span
    assert got["launch"][0] == n and got["plan"][0] == n
    assert ("partition" in got) == (name == "cover")
    assert ("split" in got) == (name == "demo")
    assert got[profiling.WAITS][0] == CPU_WAITS[name, adaptive]
    # a child's seconds lie within its parent's
    assert got["partition" if name == "cover" else "split"][1] \
        <= got["prep"][1] <= got["render_image"][1]
    assert got["render_image"][1] >= (got["prep"][1] + got["launch"][1]
                                      + got["plan"][1] + got["finish"][1])


@pytest.mark.parametrize("name, adaptive", PATHS)
def test_waits_a_render_are_constant(name, adaptive):
    per_render = []
    for seed in (3, 2**31 + 9):
        for _ in range(2):
            profiling.reset_counters()
            render(name, adaptive, seed)
            per_render.append(profiling.counters()[profiling.WAITS][0])
    assert per_render == [CPU_WAITS[name, adaptive]] * 4


@pytest.mark.parametrize("name, adaptive", PATHS)
def test_totals_add_up_over_renders(name, adaptive):
    render(name, adaptive)
    once = profiling.counters()
    render(name, adaptive, seed=2**31 + 9)
    twice = profiling.counters()
    assert twice.keys() == once.keys()
    for span, (count, seconds) in once.items():
        assert twice[span][0] == 2 * count, span
        assert twice[span][1] > seconds, span


@pytest.mark.parametrize("name", ["cover", "demo"])
def test_scene_analysis_waits_a_field_read(name):
    scene, cam, _, opts = setup(name, False)
    if name == "cover":
        assert tables.cluster_partition(scene, opts) is not None
    else:
        assert split.containable_split(scene, derive_camera(cam),
                                       opts) is not None
    got = profiling.counters()
    assert got["scene_read"][0] == got[profiling.WAITS][0] \
        == SCENE_READS[name]
    assert got["partition" if name == "cover" else "split"][0] == 1


@pytest.mark.parametrize("module", [cluster_walk, flat_scan])
def test_reset_launch_counts_empties_the_registry(module):
    render("demo", False)
    assert profiling.counters()
    module.reset_launch_counts()
    assert profiling.counters() == {}
    # the launcher, named as its module, carries the launch counters
    assert getattr(module, module.__name__.rsplit(".", 1)[1]).launches == 0


def test_device_counts_join_the_registry(monkeypatch):
    """The walk's sample counts live in a buffer a kernel adds to (here
    on the CPU, one a device index); the snapshot reads them as
    ``(count, 0.0)`` while any is nonzero, and a reset zeroes them."""
    monkeypatch.setattr(profiling, "_DEVICE_COUNTS", {})
    names = cluster_walk.SAMPLE_COUNTS
    buf = profiling.device_counts(torch.device("cpu"), names)
    assert buf.dtype == torch.int64 and buf.tolist() == [0, 0]
    assert profiling.device_counts(torch.device("cpu"), names) is buf
    assert profiling.counters() == {}
    buf += torch.tensor([31, 93])
    other = profiling.device_counts(torch.device("cpu", 1), names)
    other += torch.tensor([0, 7])
    with profiling.span("render_image"):
        pass
    got = profiling.counters()
    assert got["walk_item_samples"] == (31, 0.0)
    assert got["walk_samples"] == (100, 0.0)
    assert got["render_image"][0] == 1
    profiling.reset_counters()
    assert buf.tolist() == [0, 0] and other.tolist() == [0, 0]
    assert profiling.counters() == {}


def test_spans_nest_under_render_image_in_the_profiler(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        render("cover", False)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"
             and str(e.get("name", "")).startswith(profiling.SPAN_PREFIX)]
    names = [e["name"] for e in spans]
    for want in ("rt::render_image", "rt::prep", "rt::partition",
                 "rt::scene_read", "rt::tables", "rt::launch", "rt::plan",
                 "rt::finish", "rt::segments"):
        assert want in names, want
    (outer,) = [e for e in spans if e["name"] == "rt::render_image"]
    for e in spans:
        assert outer["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                           <= outer["ts"] + outer["dur"])
    (prep,) = [e for e in spans if e["name"] == "rt::prep"]
    for e in spans:
        if e["name"] in ("rt::partition", "rt::scene_read", "rt::tables"):
            assert prep["ts"] <= e["ts"] <= prep["ts"] + prep["dur"]
    # the registry counted the same spans
    got = profiling.counters()
    assert names.count("rt::launch") == got["launch"][0]
    assert names.count("rt::scene_read") == got["scene_read"][0] \
        == SCENE_READS["cover"]


def test_no_annotation_without_a_profiler(monkeypatch):
    made = []

    class Counted:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    render("demo", True)
    assert made == []
    assert profiling.counters()["render_image"][0] == 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        render("demo", False)
    assert "rt::render_image" in made and "rt::split" in made


@pytest.mark.parametrize("kind", [profiling.span, profiling.wait])
def test_a_span_counts_a_block_that_raises(kind):
    with pytest.raises(ValueError):
        with kind("prep"):
            raise ValueError("no scene")
    with profiling.wait("sync"):
        pass
    got = profiling.counters()
    assert got["prep"][0] == 1 and got["sync"][0] == 1
    waits = [got["sync"]] + ([got["prep"]] if kind is profiling.wait
                             else [])
    assert got[profiling.WAITS] == (len(waits),
                                    pytest.approx(sum(w[1] for w in waits)))


# --- the benchmark's readers ------------------------------------------

#: the readers' metrics: each base, per render and per still
BASES = ("host_ms", "prep_ms", "device_waits")
READERS = [f"{base}_per_{unit}" for base in BASES
           for unit in ("render", "still")]


def test_readers_are_listed_for_their_cells():
    spec = harness.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for metric in READERS:
        m = entries[metric]
        assert m["layer"] == "render orchestration"
        still = metric.endswith("_still")
        assert m["moves"] == ("still_s" if still else "render_s")
        # the adaptive render's host blocks on a full launch queue:
        # there host_ms would read the device's time (PERF.md section 3)
        assert m["workloads"] == (
            ["demo-offline-1080p"] if still else
            ["cover-offline", "flake-offline", "bouncing-offline"]
            if metric == "host_ms_per_render" else
            ["cover-offline", "cover-adaptive", "flake-offline",
             "bouncing-offline"])


TINY = {"cover-offline": {"width": 16, "height": 8, "spp": 4},
        "demo-offline-1080p": {"width": 32, "height": 18, "spp": 4}}


@pytest.mark.parametrize("cell, waits", [("cover-offline", 8),
                                         ("demo-offline-1080p", 5)])
def test_window_on_the_cpu(cell, waits):
    """The benchmark's window with the real counters: the reset at its
    start leaves the window's renders alone in the registry."""
    import raytracer_tpu_torch as port

    c = harness.load_cell(cell)
    session = harness.OfflineSession(port, c, torch.device("cpu"),
                                     TINY[cell])
    session.warm(2**31 + 5)
    rec = harness.Run(c, 2**31 + 5, 0.2, False)
    session.window(rec, lambda: None, bench_run.Counters())
    assert profiling.counters()["render_image"][0] == len(rec.units)
    unit = "still" if cell.startswith("demo") else "render"
    read = {base: harness.load_reader(f"{base}_per_{unit}")(rec)
            for base in BASES}
    assert read["device_waits"] == waits
    assert read["host_ms"] > 0 and read["prep_ms"] > 0
    assert read["prep_ms"] < read["host_ms"]


@pytest.mark.gpu
@pytest.mark.parametrize("name, adaptive", PATHS)
def test_card_adds_the_sync_wait(name, adaptive):
    """On a card each render also waits in its synchronize."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    render(name, adaptive, device="cuda")
    profiling.reset_counters()
    render(name, adaptive, device="cuda")
    got = profiling.counters()
    assert got[profiling.WAITS][0] == CPU_WAITS[name, adaptive] + 1
    assert got["sync"][0] == 1
