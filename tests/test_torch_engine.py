"""The port's interactive engine, camera controller, app state and PNG
export against the JAX package, and the engine's frame-loop semantics on
the port alone.

Against the JAX package:

- the controller (fov and pitch clamps, zoom, mouse-look within 1 ulp;
  the fly-cam within 2 ulps, its cos and sin being the only
  transcendentals) and the app state (``adjusted_screen_dimensions``,
  ``compute_should_render``, ``effective_spp``, the fps window): exact;
- ``encode_png``: the bytes of the JAX package's
  ``_encode_png_py(tonemap_u8(...))``, and ``decode_png`` round-trips;
- one scripted session (unpause, mouse moves, ``set_debugging(True)``, a
  move that centres a sphere, ``w`` held for two ticks, a resize past the
  debounce, ``reset``, a save) on ``Engine(backend='pallas')`` in
  interpret mode and on the port's engine on the CPU, at 48x27, depth 3:
  on two_sphere (K2 + debug) and on the cover (487 spheres, K1 + debug).
  After every tick: the tick's result, ``render_count``,
  ``selected_object``, ``should_render`` and the camera's yaw, pitch, fov
  and aspect exact; its origin within 4 ulps (the fly-cam's cos and sin);
  the focus distance and the cursor point within 1e-4 relative (picking
  from a camera the port derives itself, ``tests/test_torch_debug.py``
  ``test_update_cursor_state_matches_jax``); the framebuffer within the
  walk's chunk bounds. Measured with this file's ``__main__``: two_sphere
  0-0.08 % of pixels off by more than 1e-3, 99.9-100 % within 1e-5, mean
  |delta| 1e-8 to 2.7e-4, the cursor equal; the cover 0.2-1.2 %,
  92.4-94.6 %, 6.4e-4 to 1.7e-3, the cursor up to 298 ulps apart.

On the port alone, the JAX engine tests' semantics: pause gating, the
paused spp floor, accumulation resets, the resize debounce and cap, saves,
the fps window, reset, the debug toggle and the LRU bound of the step
cache.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.app import engine as jax_engine
from raytracer_tpu.app import io as jax_io
from raytracer_tpu.camera import controller as jax_controller
from raytracer_tpu.camera.camera import CameraConfig as JaxCamera
from raytracer_tpu.interact import appstate as jax_appstate
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu_torch.app import io
from raytracer_tpu_torch.app.engine import Engine
from raytracer_tpu_torch.camera import controller
from raytracer_tpu_torch.camera.camera import camera_from_numpy
from raytracer_tpu_torch.interact import appstate
from raytracer_tpu_torch.interact.appstate import (
    AppState,
    adjusted_screen_dimensions,
    cameras_equal,
)
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import flat_scan as fs
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

W, H = 48, 27

MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3  # mean |delta|


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Intra-op threads only contend between test workers, and with them
    PyTorch's exp and log were seen to return a thread's chunk off by
    1e-5..1e-4 (ROADMAP §C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry_across(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def ulps(a, b) -> np.ndarray:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


# --- controller and app state --------------------------------------------

def camera_pairs():
    r = np.random.default_rng(3)
    for _ in range(40):
        j = JaxCamera.create(
            origin=tuple(r.uniform(1, 5, 3) * r.choice([-1, 1], 3)),
            yaw=float(r.uniform(-400, 400)), pitch=float(r.uniform(-95, 95)),
            fov=float(r.uniform(1e-5, 2.5)), aperture=float(r.uniform(0, .2)),
            focus_distance=float(r.uniform(0.5, 9)),
            aspect_ratio=float(r.uniform(0.5, 2.5)))
        yield j, camera_from_numpy(carry_across(j))


def assert_cameras_close(got, ref, origin_ulps=0, angle_ulps=0):
    for f in dataclasses.fields(ref):
        want = np.asarray(getattr(ref, f.name))
        have = getattr(got, f.name).numpy()
        assert have.dtype == np.float32 and have.shape == want.shape
        bound = {"origin": origin_ulps, "yaw": angle_ulps,
                 "pitch": angle_ulps, "fov": angle_ulps}.get(f.name, 0)
        assert ulps(have, want).max() <= bound, (f.name, have, want)


def test_controller_matches_jax():
    """set_fov and set_camera_angles clamp exactly; zoom and mouse-look
    within 1 ulp; the fly-cam within 2 ulps, on 40 random cameras (fovs
    and pitches past the clamps among them) and every key."""
    keys = ["w", "a", "s", "d", "space", "shift"]
    for i, (j, p) in enumerate(camera_pairs()):
        fov = [1e-6, 0.5, 3.0][i % 3]
        assert_cameras_close(controller.set_fov(p, fov),
                             jax_controller.set_fov(j, fov))
        yaw, pitch = 30.0 * i - 400.0, [-120.0, 10.0, 95.0][i % 3]
        assert_cameras_close(controller.set_camera_angles(p, yaw, pitch),
                             jax_controller.set_camera_angles(j, yaw, pitch))
        sign = (-1.0, 1.0)[i % 2]
        assert_cameras_close(controller.zoom(p, sign),
                             jax_controller.zoom(j, sign), angle_ulps=1)
        dx, dy = 7.0 - i, 3.5 * (i % 5) - 4.0
        assert_cameras_close(controller.mouse_look(p, dx, dy, 0.1),
                             jax_controller.mouse_look(j, dx, dy, 0.1),
                             angle_ulps=1)
        km, jkm = controller.KeydownMap(), jax_controller.KeydownMap()
        for k in (keys[i % 6], keys[(i + 2) % 6]):
            setattr(km, k, True)
            setattr(jkm, k, True)
        dt = 16.0 + i
        assert_cameras_close(controller.update_position(p, km, dt),
                             jax_controller.update_position(j, jkm, dt),
                             origin_ulps=2)
    assert controller.update_position(p, controller.KeydownMap(), 16.0) is p


def test_app_state_matches_jax():
    """adjusted_screen_dimensions (its portrait quirk included), the
    should-render gate over every flag combination, the spp floor and
    the fps window, exactly."""
    for raw in ((2560, 1440), (800, 600), (600, 900), (1280, 1280),
                (4000, 2000), (300.5, 200.25), (1000, 3000)):
        assert adjusted_screen_dimensions(*raw) == \
            jax_appstate.adjusted_screen_dimensions(*raw)
    for bits in range(16):
        flags = dict(should_render=bool(bits & 1), is_paused=bool(bits & 2),
                     should_save=bool(bits & 4))
        count = 0 if bits & 8 else 3
        for spp in (1, 30):
            a = AppState(W, H, samples_per_pixel=spp, render_count=count,
                         **flags)
            b = jax_appstate.AppState(W, H, samples_per_pixel=spp,
                                      render_count=count, **flags)
            assert a.compute_should_render() == b.compute_should_render()
            assert a.effective_spp() == b.effective_spp()
    a, b = AppState(4, 4), jax_appstate.AppState(4, 4)
    for i in range(60):
        dt = 10.0 + (i % 7)
        a.update_moving_fps(i * 10.0, dt)
        b.update_moving_fps(i * 10.0, dt)
    np.testing.assert_array_equal(a.prev_fps, b.prev_fps)
    for now in (1000.0, 1100.0, 1300.0):
        assert a.average_fps(now) == b.average_fps(now)
    assert (appstate.MAX_CANVAS_SIZE, appstate.PAUSED_SPP_FLOOR,
            appstate.RESIZE_DEBOUNCE_MS) == (
        jax_appstate.MAX_CANVAS_SIZE, jax_appstate.PAUSED_SPP_FLOOR,
        jax_appstate.RESIZE_DEBOUNCE_MS)


def test_cameras_equal():
    cam = presets.simple_camera(W, H)
    assert cameras_equal(cam, dataclasses.replace(cam))
    moved = controller.mouse_look(cam, 1.0, 0.0)
    assert not cameras_equal(cam, moved)


# --- PNG ------------------------------------------------------------------

@pytest.mark.parametrize("shape, flip", [((27, 48, 3), True),
                                         ((5, 7, 3), False)])
def test_png_bytes_match_jax(shape, flip, tmp_path):
    """``encode_png`` gives the JAX package's bytes (out-of-range values
    clamped, GL rows flipped); ``decode_png`` reads them back."""
    r = np.random.default_rng(1)
    img = r.uniform(-0.2, 1.2, shape).astype(np.float32)
    want = jax_io._encode_png_py(jax_io.tonemap_u8(img, flip))
    got = io.encode_png(img, flip)
    assert got == want
    np.testing.assert_array_equal(io.tonemap_u8(img, flip),
                                  jax_io.tonemap_u8(img, flip))
    np.testing.assert_array_equal(io.decode_png(got),
                                  io.tonemap_u8(img, flip))
    np.testing.assert_array_equal(jax_io.decode_png(got),
                                  io.decode_png(got))
    path = tmp_path / "img.png"
    io.save_png(path, img, flip)
    assert path.read_bytes() == want
    with pytest.raises(ValueError, match="not a PNG"):
        io.decode_png(b"GIF89a" + got)


# --- the engine against the JAX engine ------------------------------------

def session_engines(config):
    j_scene, j_cam, *_ = jax_presets.get_config(config, W, H)
    kw = dict(spp=1, max_depth=3, seed=4)
    j = jax_engine.Engine(j_scene, j_cam, W, H, backend="pallas", **kw)
    p = Engine(scene_from_numpy(**carry_across(j_scene)),
               camera_from_numpy(carry_across(j_cam)), W, H, device="cpu",
               **kw)
    return j, p


def frame_stats(j, p) -> dict:
    a, b = p.framebuffer(), np.asarray(j.render_state.accum)
    assert a.shape == b.shape
    d = np.abs(a - b).max(axis=-1)
    return {"forked": float((d > 1e-3).mean()),
            "close": float((d <= 1e-5).mean()), "mean_abs": float(d.mean())}


def compare_engines(j, p, ticked, j_ticked, log):
    assert ticked == j_ticked
    assert p.app.render_count == j.app.render_count
    assert p.app.selected_object == j.app.selected_object
    assert p.app.should_render == j.app.should_render
    assert (p.app.width, p.app.height) == (j.app.width, j.app.height)
    assert p.render_state.render_count == int(j.render_state.render_count)
    assert p.render_state.frame == int(j.render_state.frame)
    for name in ("yaw", "pitch", "fov", "aspect_ratio", "aperture", "vup"):
        np.testing.assert_array_equal(getattr(p.camera, name).numpy(),
                                      np.asarray(getattr(j.camera, name)))
    assert ulps(p.camera.origin.numpy(), j.camera.origin).max() <= 4
    focus = float(j.camera.focus_distance)
    assert abs(float(p.camera.focus_distance) - focus) <= 1e-4 * focus
    cursor = np.asarray(j.app.cursor_point, np.float32)
    assert np.abs(np.asarray(p.app.cursor_point) - cursor).max() <= 1e-4 * (
        1.0 + np.abs(cursor).max())
    log.append(ulps(np.asarray(p.app.cursor_point, np.float32),
                    cursor).max())
    stats = frame_stats(j, p)
    log.append(stats)
    assert stats["forked"] <= MAX_FORKED_SHARE, stats
    assert stats["close"] >= MIN_CLOSE_SHARE, stats
    assert stats["mean_abs"] <= MAX_MEAN_ABS, stats


def scripted_session(config, tmp_path) -> list:
    """Drive both engines through the same events; compare after every
    tick. Returns the per-tick statistics."""
    j, p = session_engines(config)
    log, now = [], [0.0]

    def both(fn):
        fn(j)
        fn(p)

    def tick(dt=16.0):
        now[0] += dt
        jt = j.tick(now[0])
        pt = p.tick(now[0])
        compare_engines(j, p, pt, jt, log)

    both(lambda e: e.set_paused(False))
    tick()
    both(lambda e: e.handle_mouse_move(30.0, -12.0))
    tick()
    both(lambda e: e.set_debugging(True))
    tick()
    # back to the start: the sphere at the centre of the view again
    both(lambda e: e.handle_mouse_move(-30.0, 12.0))
    assert p.app.selected_object != 1000
    tick()
    both(lambda e: e.handle_key("w", True))
    tick()
    tick()
    both(lambda e: e.handle_key("w", False))
    both(lambda e: e.handle_resize(64.0, 36.0, now_ms=now[0]))
    tick(100.0)  # inside the debounce
    assert p.app.width == W
    tick(600.0)  # past it: 64x36
    assert p.app.width == 64 and p.render_state.accum.shape == (36, 64, 3)
    both(lambda e: e.reset())
    tick()
    paths = {}
    for e, name in ((j, "jax.png"), (p, "port.png")):
        paths[name] = str(tmp_path / name)
        e.request_save(paths[name])
    tick()
    assert os.path.exists(paths["port.png"])
    png = io.decode_png(open(paths["port.png"], "rb").read())
    assert png.shape == (36, 64, 3)
    assert (png == io.tonemap_u8(p.framebuffer())).all()
    return log


@pytest.mark.parametrize("config, kernel", [("two_sphere", "flat_scan"),
                                            ("cover", "cluster_walk")])
def test_scripted_session_matches_jax_engine(config, kernel, tmp_path,
                                             monkeypatch):
    """two_sphere through K2 + debug; the cover (487 spheres: the engine's
    static scene gets a cluster partition) through K1 + debug."""
    launched = []
    for mod, name in ((cw, "cluster_walk"), (fs, "flat_scan")):
        def spy(*a, _real=getattr(mod, name), _name=name, **k):
            launched.append((_name, a[7].enable_debug))
            return _real(*a, **k)
        monkeypatch.setattr(
            "raytracer_tpu_torch.render.megakernel." + name, spy)
    scripted_session(config, tmp_path)
    assert {k for k, _ in launched} == {kernel}
    assert (kernel, True) in launched and (kernel, False) in launched


# --- the engine on the port alone -----------------------------------------

def make_engine(**kw):
    scene = presets.two_sphere_scene()
    cam = presets.simple_camera(W, H)
    defaults = dict(width=W, height=H, spp=1, max_depth=3, device="cpu")
    defaults.update(kw)
    return Engine(scene, cam, **defaults)


def test_paused_renders_only_first_frame():
    e = make_engine()
    assert e.app.is_paused
    assert e.tick(16.0) is True
    assert e.app.render_count == 1
    assert e.tick(32.0) is False
    assert e.tick(48.0) is False
    assert e.app.render_count == 1


def test_paused_spp_floor():
    e = make_engine()
    assert e.app.effective_spp() == 25
    e.set_paused(False)
    assert e.app.effective_spp() == 1


def test_camera_change_resets_accumulation():
    e = make_engine()
    e.set_paused(False)
    e.run(3)
    assert e.app.render_count == 3
    e.handle_wheel(+1.0)
    assert e.render_state.render_count == 0
    e.tick(1000.0)
    assert e.app.render_count == 1


def test_wasd_moves_and_escape_pauses():
    e = make_engine()
    e.set_paused(False)
    e.run(2)
    e.handle_key("w", True)
    before = e.camera.origin.clone()
    e.tick(2000.0)
    assert not torch.equal(before, e.camera.origin)
    e.handle_key("w", False)
    assert e.app.keydown_map.all_false()
    e.handle_key("escape", True)
    assert e.app.is_paused


def test_saves():
    """A save runs right after the next render, even paused, and is one
    shot: bytes into ``_saved_images`` and ``on_save``, or a file."""
    e = make_engine()
    e.tick(16.0)
    assert e.tick(32.0) is False
    seen = []
    e.on_save = seen.append
    e.request_save()
    assert e.tick(48.0) is True
    assert len(e._saved_images) == 1 and len(seen) == 1
    assert e._saved_images[0][:8] == b"\x89PNG\r\n\x1a\n"
    assert not e.app.should_save
    np.testing.assert_array_equal(io.decode_png(e._saved_images[0]),
                                  io.tonemap_u8(e.framebuffer()))


def test_request_save_with_path(tmp_path):
    e = make_engine()
    out = str(tmp_path / "save.png")
    e.request_save(out)
    assert e.tick(16.0)
    assert os.path.exists(out) and e._save_path is None


def test_resize_debounce_cap_and_aspect():
    e = make_engine()
    e.set_paused(False)
    e.tick(16.0)
    e.handle_resize(4000, 2000, now_ms=100.0)
    e.tick(200.0)
    assert e.app.width == W
    e.tick(700.0)
    assert (e.app.width, e.app.height) == (1280, 640)
    assert e.render_state.accum.shape == (640, 1280, 3)
    assert float(e.camera.aspect_ratio) == 2.0
    assert e.render_state.frame == 3  # the frame count carries over


def test_framebuffer_is_a_copy():
    e = make_engine()
    e.tick(16.0)
    fb = e.framebuffer()
    assert fb.shape == (H, W, 3)
    np.testing.assert_array_equal(fb, e.render_state.accum.numpy())
    fb[:] = -1.0
    assert float(e.render_state.accum.min()) >= 0.0


def test_reset_restores_scene_and_camera():
    scene, cam, *_ = presets.get_config("two_sphere", 32, 16)
    e = Engine(scene, cam, 32, 16, max_depth=2, device="cpu")
    e.tick(0.0)
    e.handle_mouse_move(40.0, 25.0)
    e.scene = presets.get_config("three_sphere", 32, 16)[0]
    e.tick(16.0)
    e.reset()
    assert e.scene is scene
    assert cameras_equal(e.camera, cam)
    assert e.app.render_count == 0 and e.render_state.render_count == 0
    assert e.app.selected_object == 1000


def test_debug_toggle_resets_accumulation():
    e = make_engine()
    e.set_paused(False)
    e.run(3)
    e.set_debugging(True)
    assert e.app.enable_debugging and e.app.should_render
    assert e.render_state.render_count == 0 and e.app.render_count == 0
    e.run(2)
    n = e.app.render_count
    e.set_debugging(True)
    assert e.app.render_count == n
    e.set_debugging(False)
    assert e.app.render_count == 0


def test_step_cache_is_lru_bounded():
    e = make_engine()
    cap = Engine._STEP_CACHE_MAX
    for i in range(cap + 4):
        e.app.width = W + i
        e._step_fn(1)
    assert len(e._step_cache) == cap
    oldest = next(iter(e._step_cache))
    e.app.width = oldest[0]
    e._step_fn(1)
    assert next(iter(e._step_cache)) != oldest
    assert len(e._step_cache) == cap


def test_debug_frame_draws_the_overlay():
    """With the overlay on, a pick of the small sphere at the centre puts
    the cursor on it; the centre pixels show the blue marker, and toggling
    the overlay off renders the plain step's frame."""
    e = make_engine(enable_debugging=True, spp=4)
    e.set_paused(False)
    e.handle_mouse_move(0.0, 0.0)
    assert e.app.selected_object == 0
    e.tick(16.0)
    fb = e.framebuffer()
    c = fb[H // 2 - 1:H // 2 + 1, W // 2 - 1:W // 2 + 1]
    assert (c[..., 2] > 0.99).all() and (c[..., 0] < 0.01).all()
    e.set_debugging(False)
    e.tick(32.0)
    plain = make_engine(spp=4)
    plain.set_paused(False)
    plain.render_state = dataclasses.replace(plain.render_state, frame=1)
    plain.tick(32.0)
    np.testing.assert_array_equal(e.framebuffer(), plain.framebuffer())


def test_segments_drain_to_the_host():
    e = make_engine()
    e._SEG_FOLD_FRAMES = 2
    e.set_paused(False)
    e.run(5)
    assert e._segments_unfolded == 1
    assert e.total_segments >= 5 * W * H


def test_engine_cluster_scan_matches_flat():
    """cluster_scan=True gives the engine's step a partition of its fixed
    scene; the fly-cam moves the camera and the frames stay bitwise those
    of the flat scan."""
    a = make_engine()
    b = make_engine(cluster_scan=True)
    for e in (a, b):
        e.set_paused(False)
        e.tick(0.0)
        e.handle_key("w", True)
        e.tick(16.0)
    np.testing.assert_array_equal(a.framebuffer(), b.framebuffer())


def test_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(presets.two_sphere_scene(), presets.simple_camera(W, H), W, H)


if __name__ == "__main__":
    # per-tick parity statistics; run as  python tests/test_torch_engine.py
    import pathlib
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    for config in sys.argv[1:] or ["two_sphere", "cover"]:
        with tempfile.TemporaryDirectory() as d:
            print(config, scripted_session(config, pathlib.Path(d)),
                  flush=True)
