"""The plain reference against the port's plain path, and the control
against the reference, at sizes a CPU test holds. The port is imported
here only as the thing judged; the reference itself imports none of it
(test_bench_harness.py checks that)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import harness, reference, schedule, scenes


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cover():
    arrays = scenes.scene_arrays({"generator": "rtiow_random_scene",
                                  "seed": 0})
    return arrays, lambda w, h: reference.camera_basis(
        (13, 2, 3), (0, 0, 0), 20.0, 0.1, 10.0, w / h)


def _demo():
    cell = harness.load_cell("demo-offline-1080p")
    return (scenes.scene_arrays(cell.config["scene"]),
            lambda w, h: harness.basis_of(cell.config["camera"], w / h))


def _all_pixels(w, h):
    return np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1
                    ).reshape(-1, 2)


def _port_render(arrays, basis, w, h, spp, key, **opts):
    import raytracer_tpu_torch as port

    scene = port.scene_from_numpy(**arrays, device="cpu")
    return port.render_image(scene, port.camera_from_numpy(basis), w, h,
                             spp, key, port.TraceOptions(**opts), None,
                             True, device="cpu")


@pytest.mark.parametrize("which,w,h,spp,depth,sampler", [
    ("demo", 40, 24, 6, 8, "random"),
    ("demo", 40, 24, 6, 8, "stratified"),
    ("cover", 32, 20, 8, 50, "random"),
    ("cover", 32, 20, 8, 50, "stratified"),
])
def test_fixed_render_matches_the_plain_path(which, w, h, spp, depth,
                                             sampler):
    arrays, basis_at = _cover() if which == "cover" else _demo()
    basis = basis_at(w, h)
    key = np.array([0x9E3779B9, 2**31 + 3], np.uint32)
    img, st = _port_render(arrays, basis, w, h, spp, key, max_depth=depth,
                           sampler=sampler)
    px = _all_pixels(w, h)
    sizes = schedule.fixed_sizes(spp, w * h, len(arrays["radius"]), depth)
    got, segs = reference.fixed_pixels(
        arrays, reference.cam19(basis), w, h, reference.kernel_seed(key),
        px, spp, depth, sizes, sampler)
    want = img[torch.as_tensor(px[:, 1]), torch.as_tensor(px[:, 0])]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(segs.sum()) == st["segments_exact"]


def test_adaptive_render_matches_the_plain_path():
    arrays, basis_at = _cover()
    w, h, spp, depth = 12, 8, 130, 50
    basis = basis_at(w, h)
    key = np.array([17, 2**31 + 9], np.uint32)
    img, st = _port_render(arrays, basis, w, h, spp, key, max_depth=depth,
                           sampler="stratified", adaptive_tolerance=0.2)
    px = _all_pixels(w, h)
    sizes = schedule.adaptive_sizes(spp, w * h, len(arrays["radius"]),
                                    depth)
    assert sizes == [6, 31, 31, 31, 31]
    got, n, segs = reference.adaptive_pixels(
        arrays, reference.cam19(basis), w, h, reference.kernel_seed(key),
        px, depth, sizes, 0.2, "stratified")
    yy, xx = torch.as_tensor(px[:, 1]), torch.as_tensor(px[:, 0])
    torch.testing.assert_close(n, st["spp_map"][yy, xx], rtol=0, atol=0)
    assert 6 < float(n.mean()) < spp      # some pixels stopped early
    torch.testing.assert_close(got, img[yy, xx], rtol=0, atol=0)
    assert int(segs.sum()) == st["segments_exact"]


@pytest.mark.parametrize("spp,npix,count,depth", [
    (500, 960000, 487, 50), (128, 1920 * 1080, 9, 8), (1, 2073600, 9, 8),
    (37, 5000, 30, 16)])
def test_schedule_copy_is_the_port_rule(spp, npix, count, depth):
    from raytracer_tpu_torch.render import schedule as port_schedule

    chunk = port_schedule.pick_chunk_spp(spp, npix, count, depth)
    assert schedule.fixed_sizes(spp, npix, count, depth) == \
        port_schedule.chunk_schedule(spp, chunk)[0]
    assert schedule.adaptive_sizes(spp, npix, count, depth) == \
        port_schedule.adaptive_schedule(spp, chunk, 0, True)


@pytest.mark.parametrize("key,data", [((0, 7), 0), ((0, 2**31 + 5), 123),
                                      ((0xDEADBEEF, 1), 2**32 - 1)])
def test_fold_in_copy_is_threefry(key, data):
    from raytracer_tpu_torch.render import rng

    assert reference.threefry_fold_in(key, data) == tuple(
        int(v) for v in rng.fold_in(key, data))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_prng_key_copy(seed):
    from raytracer_tpu_torch.render import rng

    assert reference.prng_key(seed) == rng.key_data(seed)


def test_kernel_seed_copy():
    from raytracer_tpu_torch.render import rng

    for kd in ((0, 5), (123, 2**31 + 1), (2**32 - 1, 2**32 - 1)):
        assert reference.kernel_seed(kd) == rng.kernel_seed_from_key(kd) \
            & 0xFFFFFFFF


@pytest.mark.parametrize("yaw,pitch", [(-90.0, 0.0), (-80.5, 7.25),
                                       (-101.0, -3.5)])
def test_pick_and_viewer_camera(yaw, pitch):
    import raytracer_tpu_torch as port
    from raytracer_tpu_torch.interact.picking import update_cursor_state

    arrays, _ = _demo()
    fields = {"origin": np.float32([0, 0, 1]), "yaw": np.float32(yaw),
              "pitch": np.float32(pitch), "fov": np.float32(math.pi / 3),
              "aperture": np.float32(0.0),
              "focus_distance": np.float32(0.75),
              "aspect_ratio": np.float32(16 / 9)}
    cam = port.camera_from_numpy(fields)
    d = port.derive_camera(cam)
    mine = reference.viewer_basis_f32(
        fields["origin"], yaw, pitch, fields["fov"], 0.0, 0.75,
        fields["aspect_ratio"])
    for k in ("origin", "lower_left_corner", "horizontal", "vertical"):
        np.testing.assert_array_equal(mine[k], getattr(d, k).numpy())
    scene = port.scene_from_numpy(**arrays, device="cpu")
    _, point, sel = update_cursor_state(scene, cam)
    ref_point, ref_sel = reference.pick(arrays, mine)
    assert sel == ref_sel
    np.testing.assert_allclose(point, ref_point, rtol=0, atol=1e-5)


def test_viewer_frames_match_the_engine():
    import raytracer_tpu_torch as port

    cell = harness.load_cell("demo-viewer-1080p", pending=True)
    ov = {"width": 40, "height": 24}
    s = harness.ViewerSession(port, cell, torch.device("cpu"), ov)
    rec = harness.Run(cell, 2**31 + 21, 0.2, False)
    s.warm(rec.seed)
    rec.seconds = 0.3
    s.window(rec, lambda: None, _NoCounters())
    assert rec.kept["frame_end"] > rec.kept["restart"][1]
    assert rec.kept["frame_end"] == rec.kept["engine"].render_state.frame
    got = s.check(rec, torch.device("cpu"))
    assert got["frames_checked"] == 65
    assert got["frame_mismatch"] == 0.0 and got["frame_gap"] == 0.0
    assert got["pick_gap"] < 1e-5


class _NoCounters:
    def reset(self):
        pass

    def read(self):
        return {}


@pytest.mark.parametrize("cell", ["cover-offline", "demo-offline-1080p",
                                  "demo-viewer-1080p"])
def test_control_fails_the_cell(cell):
    """The control (the reference in bfloat16 in the program's place)
    fails one of the cell's numbers at a test size; the cell's runs on the
    card, at its own size, gave the readings in PERF.md."""
    import raytracer_tpu_torch as port

    c = harness.load_cell(cell, pending=True)
    ov = {"cover-offline": {"width": 32, "height": 24, "spp": 8},
          "demo-offline-1080p": {"width": 48, "height": 27, "spp": 4},
          "demo-viewer-1080p": {"width": 48, "height": 27}}[cell]
    s = harness.session_class(c.traffic["entry"])(port, c,
                                                  torch.device("cpu"), ov)
    rec = harness.Run(c, 2**31 + 99, 0.3, False)
    s.warm(rec.seed)
    s.window(rec, lambda: None, _NoCounters())
    sound = s.check(rec, torch.device("cpu"))
    control = s.check(rec, torch.device("cpu"), control=True)
    assert harness.check_against(sound, c.limits)[0], sound
    assert not harness.check_against(control, c.limits)[0], control
