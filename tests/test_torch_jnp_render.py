"""``backend='jnp'`` through the port's entry points on the CPU, against
the JAX package's jnp tracer on the same scenes, cameras and keys:
``render_image`` (the four BASELINE configs at 64x36, 32 spp, depth 8,
key 42, also against the stored goldens, which that tracer rendered),
the stratified sampler with a sample offset, the band and chunk
decisions and a banded render, the progressive step (both samplers) and
a scripted ``Engine`` session; and 'auto' still taking the kernels.

Images cannot match bit for bit: a one-ulp difference in a
transcendental (ROADMAP ground rules; the cube root, ``tests/
test_torch_threefry.py``) sometimes flips a Schlick or roulette roll or a
grazing hit, and the path forks. Each comparison is held to the port's
render bounds (at most 5 % of pixels off by more than 1e-3, mean |Δ| ≤
8e-3), set above these measurements:

- against ``render_image_jnp`` (32 spp, d8, key 42), then against the
  golden: two_sphere 0.65 % of pixels off by more than 1e-3, mean |Δ|
  5.8e-5, the same against the golden; three_sphere 0.91 %, 3.6e-5
  (golden 0.95 %, 3.7e-5); demo 2.56 %, 7.9e-5 (2.60 %, 8.5e-5); dof
  1.78 %, 1.1e-4 (the same);
- the stratified demo at sample offset 5 (8 spp): 0.74 %, 1.1e-4; the
  banded render (3 bands, 6 spp): 0.65 %, 1.1e-4;
- the progressive step after 4 frames: random 0.31 %, 1.2e-4,
  stratified 0.62 %, 1.7e-4; the engine session after each tick: at most
  0.08 %, 2.3e-4.

Segment totals: the port's are exact int64; JAX sums float32 (exact at
these sizes), and a forked path changes the count, so they are held
within 1 % (measured at most 0.073 %).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.app import engine as jax_engine
from raytracer_tpu.camera.camera import derive_camera as jax_derive
from raytracer_tpu.progressive import step as jax_step
from raytracer_tpu.progressive.state import init_render_state as jax_state
from raytracer_tpu.render import api as jax_api
from raytracer_tpu.render.options import DebugParams as JaxDebug
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.render.tracer import render_image_jnp as jax_render_jnp
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu_torch.app.engine import Engine
from raytracer_tpu_torch.camera.camera import camera_from_numpy
from raytracer_tpu_torch.progressive.state import init_render_state
from raytracer_tpu_torch.progressive.step import make_step_fn
from raytracer_tpu_torch.render import api, megakernel, pallas_kernel
from raytracer_tpu_torch.render.options import (
    TraceOptions,
    resolve_backend,
)
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CONFIGS = ["two_sphere", "three_sphere", "demo", "dof"]
W, H, SPP, DEPTH, SEED = 64, 36, 32, 8, 42

MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MAX_MEAN_ABS = 8e-3
MAX_SEG_REL = 0.01


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def both_inputs(name, w=W, h=H):
    """The JAX config and its port counterpart (scene, derived camera)."""
    scene, cam, *_ = jax_presets.get_config(name, w, h)
    dcam = jax_derive(cam)
    return (scene, cam, dcam), (scene_from_numpy(**carry(scene)),
                                camera_from_numpy(carry(dcam)))


def within_bounds(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    forked = float((d.max(-1) > 1e-3).mean())
    assert forked <= MAX_FORKED_SHARE, forked
    assert float(d.mean()) <= MAX_MEAN_ABS, float(d.mean())
    return forked, float(d.mean())


def segments_close(got: int, want: float):
    assert isinstance(got, int)
    assert abs(got - want) <= MAX_SEG_REL * want


def port_jnp(scene, dcam, w, h, spp, seed, **kw):
    return api.render_image(scene, dcam, w, h, spp, seed,
                            TraceOptions(max_depth=DEPTH, backend="jnp",
                                         **kw),
                            return_stats=True, device="cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_render_matches_jax_and_golden(name):
    (jscene, _, jdcam), (scene, dcam) = both_inputs(name)
    want, wstats = jax.jit(lambda s, c, k: jax_render_jnp(
        s, c, W, H, SPP, k, JaxOptions(max_depth=DEPTH),
        return_stats=True))(jscene, jdcam, jax.random.PRNGKey(SEED))
    got, stats = port_jnp(scene, dcam, W, H, SPP, SEED)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    within_bounds(got, want)
    within_bounds(got, np.load(os.path.join(
        GOLDEN_DIR, f"{name}_64x36_spp32_d8.npy")))
    segments_close(stats["segments_exact"], float(wstats["segments"]))
    assert stats["segments"] == float(np.float32(stats["segments_exact"]))


def test_stratified_at_a_sample_offset():
    """The stratified sampler's rotations and Kronecker points, at a
    sample offset: ``render_image(..., sample_offset=5)`` is JAX's
    ``render_image_jnp(..., sample_offset=5)``."""
    (jscene, _, jdcam), (scene, dcam) = both_inputs("demo")
    want = jax.jit(lambda s, c, k: jax_render_jnp(
        s, c, W, H, 8, k, JaxOptions(max_depth=DEPTH, sampler="stratified"),
        sample_offset=5))(jscene, jdcam, jax.random.PRNGKey(3))
    got = api.render_image(scene, dcam, W, H, 8, 3, TraceOptions(
        max_depth=DEPTH, backend="jnp", sampler="stratified"),
        device="cpu", sample_offset=5)
    within_bounds(got, want)


SIZES = [(64, 36), (1200, 800), (1920, 1080)]


@pytest.mark.parametrize("w, h", SIZES)
@pytest.mark.parametrize("name", sorted(presets.BASELINE_CONFIGS))
def test_band_and_chunk_decisions_are_jaxs(name, w, h):
    scene, _, _, _, spp, depth = presets.get_config(name, w, h)
    band = api._jnp_band_rows(w, h, scene.count, depth)
    assert band == jax_api._jnp_band_rows(w, h, scene.count, depth)
    for s in (1, spp, 500):
        assert api._jnp_chunk_spp(s, w * band, scene.count, depth) == \
            jax_api._jnp_chunk_spp(s, w * band, scene.count, depth)
    assert api._JNP_EXEC_BUDGET == jax_api._JNP_EXEC_BUDGET


def test_cover_bands_at_full_size():
    """The cover at 1200x800, depth 50: bands of 168 rows (the last 128)
    at 1 spp an execution."""
    scene, *_ = presets.get_config("cover")
    band = api._jnp_band_rows(1200, 800, scene.count, 50)
    assert band == 168
    assert [min(band, 800 - r) for r in range(0, 800, band)] == \
        [168] * 4 + [128]
    assert api._jnp_chunk_spp(500, 1200 * band, scene.count, 50) == 1


def test_banded_render_matches_jax(monkeypatch):
    """A budget small enough for 16-row bands (demo 64x36: bands 16, 16,
    4, each at 1 spp an execution), patched in both packages: each band
    keyed ``fold_in(key, 7_000_000 + row0)``, the chunks' sums
    ``mean·cs``."""
    (jscene, jcam, _), (scene, _) = both_inputs("demo")
    budget = W * DEPTH * scene.count * 20
    monkeypatch.setattr(api, "_JNP_EXEC_BUDGET", budget)
    monkeypatch.setattr(jax_api, "_JNP_EXEC_BUDGET", budget)
    assert api._jnp_band_rows(W, H, scene.count, DEPTH) == 16
    assert api._jnp_chunk_spp(6, W * 16, scene.count, DEPTH) == 1
    want, wstats = jax_api.render_image(
        jscene, jcam, W, H, 6, jax.random.PRNGKey(9),
        JaxOptions(max_depth=DEPTH, backend="jnp"), return_stats=True)
    cam = camera_from_numpy(carry(jcam))
    got, stats = api.render_image(
        scene, cam, W, H, 6, 9, TraceOptions(max_depth=DEPTH,
                                             backend="jnp"),
        return_stats=True, device="cpu")
    within_bounds(got, want)
    segments_close(stats["segments_exact"], float(wstats["segments"]))
    # the bands are other streams than the unbanded render's
    monkeypatch.setattr(api, "_JNP_EXEC_BUDGET", 5e9)
    whole = api.render_image(scene, cam, W, H, 6, 9, TraceOptions(
        max_depth=DEPTH, backend="jnp"), device="cpu")
    assert not torch.equal(whole, got)


def test_chunked_render_equals_unchunked_to_rounding(monkeypatch):
    (_, jcam, _), (scene, _) = both_inputs("two_sphere")
    cam = camera_from_numpy(carry(jcam))
    opts = TraceOptions(max_depth=DEPTH, backend="jnp")
    whole = api.render_image(scene, cam, W, H, 6, 1, opts, device="cpu")
    monkeypatch.setattr(api, "_JNP_EXEC_BUDGET",
                        W * H * DEPTH * scene.count * 4)
    chunked = api.render_image(scene, cam, W, H, 6, 1, opts, device="cpu")
    assert float((chunked - whole).abs().max()) <= 1e-6


@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_progressive_step_matches_jax(sampler):
    """4 frames of the jnp step, both packages, from seed 5."""
    (jscene, jcam, _), (scene, _) = both_inputs("demo", 48, 27)
    cam = camera_from_numpy(carry(jcam))
    jopts = JaxOptions(max_depth=4, sampler=sampler)
    jstep = jax_step.make_step_fn(48, 27, 1, jopts, backend="jnp")
    jst = jax_state(48, 27, jax.random.PRNGKey(5))
    step = make_step_fn(48, 27, 1, TraceOptions(max_depth=4,
                                                sampler=sampler),
                        device="cpu", backend="jnp")
    st = init_render_state(48, 27, 5, device="cpu")
    for _ in range(4):
        jst, jaux = jstep(jst, jscene, jcam, JaxDebug.none())
        st, aux = step(st, scene, cam)
        segments_close(int(aux["segments"]), float(jaux["segments"]))
    assert st.frame == int(jst.frame) == 4
    assert st.render_count == int(jst.render_count)
    within_bounds(st.accum, jst.accum)


def test_stratified_step_frames_are_offline_renders():
    """Without averaging, stratified frame i is the offline jnp render at
    sample offset i, bit for bit."""
    scene, cam, *_ = presets.get_config("demo", 32, 18)
    opts = TraceOptions(max_depth=3, sampler="stratified", backend="jnp")
    step = make_step_fn(32, 18, 1, opts, should_average=False, device="cpu")
    st = init_render_state(32, 18, 2, device="cpu")
    for i in range(3):
        st, _ = step(st, scene, cam)
        ref = api.render_image(scene, cam, 32, 18, 1, 2, opts, device="cpu",
                               sample_offset=i)
        assert torch.equal(st.accum, ref)


def test_engine_session_matches_jax():
    """A scripted session on ``Engine(backend='jnp')`` in both packages
    (unpause, a mouse move, the overlay on, a move back that picks the
    centre sphere, ``w`` held two ticks, reset): after every tick the
    tick's result, the counters, the selection and the running average
    within the bounds."""
    j_scene, j_cam, *_ = jax_presets.get_config("two_sphere", 48, 27)
    kw = dict(spp=1, max_depth=3, seed=4, backend="jnp")
    j = jax_engine.Engine(j_scene, j_cam, 48, 27, **kw)
    p = Engine(scene_from_numpy(**carry(j_scene)),
               camera_from_numpy(carry(j_cam)), 48, 27, device="cpu", **kw)
    assert p.backend == "jnp"
    now = [0.0]

    def tick():
        now[0] += 16.0
        assert p.tick(now[0]) == j.tick(now[0])
        assert p.app.render_count == j.app.render_count
        assert p.app.selected_object == j.app.selected_object
        assert p.render_state.frame == int(j.render_state.frame)
        within_bounds(p.framebuffer(), np.asarray(j.render_state.accum))

    def both(fn):
        fn(j)
        fn(p)

    both(lambda e: e.set_paused(False))
    tick()
    both(lambda e: e.handle_mouse_move(30.0, -12.0))
    tick()
    both(lambda e: e.set_debugging(True))
    tick()
    both(lambda e: e.handle_mouse_move(-30.0, 12.0))
    assert p.app.selected_object != 1000
    tick()
    both(lambda e: e.handle_key("w", True))
    tick()
    tick()
    both(lambda e: e.handle_key("w", False))
    both(lambda e: e.reset())
    tick()


def test_auto_takes_the_kernels(monkeypatch):
    """'auto' keeps the port's meaning: the kernels (their plain versions
    on the CPU), never the jnp tracer; 'jnp' runs only when named."""
    calls = []
    real_render, real_jnp = pallas_kernel.render, api.render_jnp
    monkeypatch.setattr(pallas_kernel, "render", lambda *a, **k: (
        calls.append("kernels"), real_render(*a, **k))[1])
    monkeypatch.setattr(api, "render_jnp", lambda *a, **k: (
        calls.append("jnp"), real_jnp(*a, **k))[1])
    scene, cam, *_ = presets.get_config("two_sphere", 16, 8)
    auto = api.render_image(scene, cam, 16, 8, 2, 0, TraceOptions(),
                            device="cpu")
    pallas = api.render_image(scene, cam, 16, 8, 2, 0,
                              TraceOptions(backend="pallas"), device="cpu")
    jnp = api.render_image(scene, cam, 16, 8, 2, 0,
                           TraceOptions(backend="jnp"), device="cpu")
    assert calls == ["kernels", "kernels", "jnp"]
    assert torch.equal(auto, pallas) and not torch.equal(auto, jnp)
    assert resolve_backend("auto") == resolve_backend("pallas") == "pallas"
    assert resolve_backend("jnp") == "jnp"
    with pytest.raises(ValueError, match="backend must be one of"):
        TraceOptions(backend="xla")
    launched = []
    monkeypatch.setattr(megakernel, "render", lambda *a, **k: (
        launched.append(1), real_render(*a, **k))[1])
    from raytracer_tpu_torch.progressive import step as pstep
    monkeypatch.setattr(pstep, "render", megakernel.render)
    st = init_render_state(16, 8, 0, device="cpu")
    make_step_fn(16, 8, 1, device="cpu")(st, scene, cam)
    assert launched == [1]
    make_step_fn(16, 8, 1, device="cpu", backend="jnp")(
        init_render_state(16, 8, 0, device="cpu"), scene, cam)
    assert launched == [1]


def test_jnp_needs_the_card_unless_the_cpu_is_named(monkeypatch):
    """No fallback: without CUDA, a jnp render that does not name the
    CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam, *_ = presets.get_config("two_sphere", 16, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.render_image(scene, cam, 16, 8, 1, 0,
                         TraceOptions(backend="jnp"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_step_fn(16, 8, 1, backend="jnp")
