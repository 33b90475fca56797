"""The readers on synthetic runs: a stall moves the end-to-end metrics,
the trace reduction, the rooflines' work, and one card test of the
roofline's work against the plain path."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, roofline, trace


def _run(cell="cover-offline", **kw):
    r = harness.Run(harness.load_cell(cell, pending=True), 7, 10.0, True)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _read(name, run):
    return harness.load_reader(name)(run)


def test_stall_moves_render_s():
    steady = _run(units=[{"t": 0.2 * (i + 1)} for i in range(50)],
                  window_s=10.0)
    stalled = _run(units=[{"t": 0.2 * (i + 1)} for i in range(45)],
                   window_s=10.0)   # a 1 s stall: 5 renders fewer
    assert _read("render_s", steady) == pytest.approx(0.2)
    assert _read("render_s", stalled) > 1.1 * _read("render_s", steady)


def test_stall_moves_fps_and_the_tail():
    frames = [1.5] * 6000
    steady = _run("demo-viewer-1080p", units=list(range(6000)),
                  window_s=9.0, frame_ms=frames)
    stall = list(frames)
    for i in range(0, 6000, 60):        # one frame in 60 waits 20 ms
        stall[i] = 20.0
    stalled = _run("demo-viewer-1080p", units=list(range(6000)),
                   window_s=9.0 + 100 * 0.0185, frame_ms=stall)
    assert _read("fps", stalled) < _read("fps", steady)
    assert _read("frame_ms_p99", steady) == pytest.approx(1.5)
    assert _read("frame_ms_p99", stalled) > 10.0


def _chrome(events):
    return {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, **e}
                            for e in events]}


def test_reduce_busy_gaps_and_calls():
    t = trace.reduce(_chrome([
        {"name": "ProfilerStep#2", "cat": "user_annotation", "ts": 0,
         "dur": 1000},
        {"name": "bench::tick", "cat": "user_annotation", "ts": 0,
         "dur": 550},
        {"name": "aten::add", "cat": "cpu_op", "ts": 10, "dur": 50},
        {"name": "aten::copy_", "cat": "cpu_op", "ts": 20, "dur": 10},
        {"name": "aten::mul", "cat": "cpu_op", "ts": 100, "dur": 20},
        {"name": "flat_scan_kernel<0>", "cat": "kernel", "ts": 100,
         "dur": 200, "tid": 7},
        {"name": "elementwise", "cat": "kernel", "ts": 250, "dur": 100,
         "tid": 7},
        {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 600,
         "dur": 100, "tid": 7},
    ]))
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(350e-6)
    assert t["aten_top"] == 2
    names = {n for n, _ in t["gaps"]}
    assert names == {"bench::tick", "(no benchmark span)"}
    assert sum(d for _, d in t["gaps"]) == pytest.approx(650e-6)
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] == "flat_scan_kernel<0>"
    assert b["idle_gaps"] == [["bench::tick", pytest.approx(350e-6)],
                              ["(no benchmark span)", pytest.approx(300e-6)]]


def test_readers_of_the_sub_window():
    sub = {"window_s": 1.0, "busy_s": 0.75, "aten_top": 900, "gaps": [],
           "device": [("void cluster_walk_kernel<0,0,0,1>", "kernel", 0.0,
                       0.2),
                      ("argsort", "kernel", 0.3, 0.05)]}
    units = [{"segments": 10**9, "samples": 4 * 10**8}] * 2
    r = _run(sub=sub, sub_units=units, units=units * 3, window_s=2.0,
             launches={"cluster_walk": 30, "flat_scan": 0},
             extra={"n_spheres": 487, "width": 1200, "height": 800})
    assert _read("idle_share.render", r) == pytest.approx(25.0)
    assert _read("launches_per_render", r) == pytest.approx(5.0)
    assert _read("other_device_ms_per_render", r) == pytest.approx(25.0)
    ops = 2 * (10**9 * 180 + 4 * 10**8 * 90)
    assert _read("walk_roofline", r) == pytest.approx(
        100 * ops / 67e12 / 0.2)
    assert _read("flat_roofline", r) is None    # no flat scan ran
    assert _read("render_mfu", r) == pytest.approx(100 * ops / 67e12)
    # a still's metrics read the same quantities in the cells of still_s
    for name in ("idle_share", "launches_per", "other_device_ms_per"):
        sep = "." if name == "idle_share" else "_"
        assert _read(f"{name}{sep}still", r) == _read(f"{name}{sep}render", r)
    assert _read("still_mfu", r) == _read("render_mfu", r)
    v = _run("demo-viewer-1080p", sub=sub, sub_units=list(range(300)))
    assert _read("torch_calls_per_frame", v) == pytest.approx(3.0)


def test_span_readers():
    r = _run("demo-viewer-1080p", units=list(range(10)))
    r.spans.items = ([("tick", 0.0, 0.001)] * 10
                     + [("handle_mouse_move", 0.0, 0.002)] * 2)
    assert _read("host_ms_per_frame", r) == pytest.approx(1.4)
    assert _read("pick_ms_p95", r) == pytest.approx(2.0)


def test_roofline_work_is_the_same_whatever_searches():
    """The cluster walk and the flat scan search the cover's spheres in
    different orders and structures; their exact outputs, and so the work
    the roofline counts, are the same."""
    import raytracer_tpu_torch as port

    from benchmark import reference, scenes

    torch.set_num_threads(1)
    arrays = scenes.scene_arrays({"generator": "rtiow_random_scene",
                                  "seed": 0})
    w, h, spp = 24, 16, 4
    cam = port.camera_from_numpy(reference.camera_basis(
        (13, 2, 3), (0, 0, 0), 20.0, 0.1, 10.0, w / h))
    scene = port.scene_from_numpy(**arrays, device="cpu")
    out = {}
    for scan in (True, False):
        opts = port.TraceOptions(max_depth=50, cluster_scan=scan)
        img, st = port.render_image(scene, cam, w, h, spp, 3, opts, None,
                                    True, device="cpu")
        out[scan] = roofline.render_ops(st["segments_exact"], w * h * spp,
                                        False, False)
    assert out[True] == out[False] > 0


@pytest.mark.gpu
def test_card_work_equals_the_reference():
    """On a card: the kernel's exact segments of a small cover render equal
    the plain reference's on the card, pixel by pixel summed, so the
    roofline's work is the same whichever computes it. (The CPU's plain
    path is no witness here: its transcendentals round otherwise.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import raytracer_tpu_torch as port

    from benchmark import reference, schedule, scenes

    arrays = scenes.scene_arrays({"generator": "rtiow_random_scene",
                                  "seed": 0})
    w, h, spp, depth = 64, 48, 16, 50
    basis = reference.camera_basis((13, 2, 3), (0, 0, 0), 20.0, 0.1, 10.0,
                                   w / h)
    key = np.array([11, 2**31 + 5], np.uint32)
    scene = port.scene_from_numpy(**arrays, device="cuda")
    img, st = port.render_image(scene, port.camera_from_numpy(basis), w, h,
                                spp, key, port.TraceOptions(max_depth=depth),
                                None, True, device="cuda")
    px = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2)
    sizes = schedule.fixed_sizes(spp, w * h, len(arrays["radius"]), depth)
    ref_img, segs = reference.fixed_pixels(
        arrays, reference.cam19(basis), w, h, reference.kernel_seed(key), px,
        spp, depth, sizes, device="cuda")
    assert int(segs.sum()) == st["segments_exact"]
    assert roofline.render_ops(int(segs.sum()), w * h * spp, False, False) \
        == roofline.render_ops(st["segments_exact"], w * h * spp, False,
                               False)
    got = img[torch.as_tensor(px[:, 1]).cuda(), torch.as_tensor(px[:, 0])
              .cuda()]
    assert float((got - ref_img).abs().max()) == 0.0
