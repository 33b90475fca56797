"""The port's debug overlay (K3), picking and AOV views against the JAX
package, and their own invariants.

Against the JAX package:

- one chunk with the overlay against the TPU kernel in interpret mode
  (``pk._render_chunk_impl(..., interpret=True, debug=...)``) at 128x64,
  4 spp, depth 8: K2 + debug on two_sphere with the JAX tests' cursors
  (on the small sphere with it selected; far away with the ground
  selected), K1 + debug on the cover with the cursor on the sphere at the
  centre of the view and that sphere selected; random and stratified, rr0
  and rr5. The walk's chunk bounds (``test_torch_walk``) hold, and the
  pixels that the JAX chunk paints marker blue in every sample, or whose
  sums are red-dominated by the outline, are classed alike by the port on
  at least 95 % of them.
  Measured with this file's ``__main__`` (seed 7, offset 3): two_sphere
  0.02-0.04 % of pixels off by more than 1e-3, 99.96-99.98 % within 1e-5,
  mean |delta| 9e-5 to 2.9e-4, segments within 1.6e-4, marks all alike
  (108-114 marker pixels, 21-30 outline pixels); the cover 2.6-2.9 %,
  79.9-81.8 %, 4.2e-3 to 4.7e-3, within 1.9e-3, and of its 1 + 20 and
  1 + 21 marked pixels one classed otherwise (0.976 pooled: one outline
  sample at the -0.05 threshold, where XLA's fused dot product rounds
  otherwise; seeds 11-13 gave 0.91-1.0 per chunk);
- whole debug renders against ``pk.render_image_pallas`` on two_sphere
  and the cover at 64x32: the whole-render bounds of ``test_torch_flat``;
- ``hit_world`` on random rays and the presets: hit, uuid and facing
  equal, t and the point within the bounds ``assert_records_match``
  states; ``center_hit`` and
  ``update_cursor_state`` on random cameras and the presets: hit and uuid
  (the selection) equal, the point, t and focus within the relative
  bounds each test states (XLA fuses the jitted pick otherwise);
- ``render_aov``'s four modes on the presets: uuid and front maps equal
  on at least 99.9 % of pixels, depth within 1e-5, the normal within 1e-5
  on at least 70 % of pixels (the cover's ground sphere is
  ill-conditioned in float32).

Inside the port, bitwise: the overlay with the cursor away and nothing
selected is the render without it; K1 + debug and K2 + debug on the demo
agree (an outline on a global slot among them); debug with an adaptive
tolerance is debug at fixed spp; debug never splits.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.camera.camera import CameraConfig as JaxCamera
from raytracer_tpu.camera.camera import center_ray as jax_center_ray
from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.interact import picking as jax_picking
from raytracer_tpu.progressive import state as jax_state
from raytracer_tpu.progressive import step as jax_step
from raytracer_tpu.render import debug as jax_debug
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render import tracer as jax_tracer
from raytracer_tpu.render.options import DebugParams as JaxDebug
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu.scene.materials import Material as JaxMaterial
from raytracer_tpu.scene.spheres import make_scene as jax_make_scene
from raytracer_tpu_torch.camera.camera import camera_from_numpy
from raytracer_tpu_torch.interact import picking
from raytracer_tpu_torch.progressive import state as pstate
from raytracer_tpu_torch.progressive import step as pstep
from raytracer_tpu_torch.render import api, megakernel, tables, tracer
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render.debug import AOV_MODES, render_aov
from raytracer_tpu_torch.render.options import (
    DebugParams,
    TraceOptions,
    debug_from_numpy,
)
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

W, H, SPP, DEPTH, OFFSET = 128, 64, 4, 8, 3

MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3  # mean |delta| of the per-pixel rgb sums
MAX_SEG_REL = 6e-3  # segment totals
MIN_MARK_MATCH = 0.95  # marker and outline pixels classed alike

#: the JAX tests' cursors on two_sphere (tests/test_pallas.py:400-448)
ON_SMALL = ((0.0, 0.0, -0.5), 0)
GROUND = ((100.0, 100.0, 100.0), 1)


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


def port_scene(j_scene):
    return scene_from_numpy(**carry_across(j_scene))


def port_camera(cam):
    return camera_from_numpy(carry_across(cam))


def jax_debug_params(cursor, sel) -> JaxDebug:
    return JaxDebug(cursor_point=jnp.asarray(cursor, jnp.float32),
                    selected_object=jnp.asarray(sel, jnp.int32))


def cover_pick(w=W, h=H):
    """The JAX package's pick of the cover at the centre of the view: the
    cursor on that sphere's surface, and the sphere selected."""
    j_scene, j_cam, *_ = jax_presets.get_config("cover", w, h)
    ch = jax_picking.center_hit(j_scene, j_cam)
    assert bool(ch.hit)
    return tuple(np.asarray(ch.point).tolist()), int(ch.uuid)


def opts_of(cls, rr, stratified):
    return cls(max_depth=DEPTH, russian_roulette_depth=rr,
               sampler="stratified" if stratified else "random",
               enable_debug=True)


def jax_chunk(config, rr, stratified, cursor, sel, seed):
    """Per-pixel (4, H·W) sums and the segment total of one interpret-mode
    chunk with the overlay, pixel order py·W + px."""
    j_scene, j_cam, *_ = jax_presets.get_config(config, W, H)
    dcam = jax_derive_camera(j_cam)
    opts = opts_of(JaxOptions, rr, stratified)
    debug = jax_debug_params(cursor, sel)
    kw = {}
    if config == "cover":
        part = pk._cluster_partition(j_scene, opts)
        j_scene = part.scene
        kw = dict(caux=(part.boxes, part.uuid), n_global=part.n_global)
    out = pk._render_chunk_impl(j_scene, dcam, jnp.int32(seed), OFFSET, W, H,
                                SPP, opts, 8, True, k_slots=1, debug=debug,
                                **kw)
    flat = np.asarray(pk._tiles_to_flat(out, W, H, 8, 1))
    flat = flat.reshape(4, -1, pk.LANES)[:, :H, :W].reshape(4, -1)
    return flat, int(np.asarray(out)[:, 4, 0, 0].sum())


def port_chunk(config, rr, stratified, cursor, sel, seed):
    j_scene, j_cam, *_ = jax_presets.get_config(config, W, H)
    scene = port_scene(j_scene)
    dcam = port_camera(jax_derive_camera(j_cam))
    opts = opts_of(TraceOptions, rr, stratified)
    choice = megakernel.choose_kernel(scene, dcam, opts, "cpu")
    assert choice.kernel == ("cluster_walk" if config == "cover"
                             else "flat_scan")
    assert choice.g_full is None
    out, segs = choice.launcher(seed, W, H, opts, DebugParams(cursor, sel))(
        cw.identity_map(W, H, "cpu"), OFFSET, SPP)
    return out.numpy(), int(segs.sum(dtype=torch.int64))


def marks(sums) -> np.ndarray:
    """0 unmarked, 1 marker blue in every sample, 2 outline-dominated."""
    r, g, b = sums[0] / SPP, sums[1] / SPP, sums[2] / SPP
    blue = (b == 1.0) & (r == 0.0) & (g == 0.0)
    red = (r - np.maximum(g, b)) > 0.2
    return np.where(blue, 1, np.where(red, 2, 0))


def chunk_parity(config, rr, stratified, cursor, sel, seed=7) -> dict:
    ref, ref_segs = jax_chunk(config, rr, stratified, cursor, sel, seed)
    out, segs = port_chunk(config, rr, stratified, cursor, sel, seed)
    d = np.abs(out[:3] - ref[:3]).max(axis=0)
    mj, mp = marks(ref), marks(out)
    marked = mj > 0
    return {
        "forked": float((d > 1e-3).mean()),
        "close": float((d <= 1e-5).mean()),
        "mean_abs": float(d.mean()),
        "seg_rel": (segs - ref_segs) / ref_segs,
        "blue": int((mj == 1).sum()),
        "red": int((mj == 2).sum()),
        "mark_match": float((mp[marked] == mj[marked]).mean()),
    }


def assert_bounds(stats):
    assert stats["forked"] <= MAX_FORKED_SHARE, stats
    assert stats["close"] >= MIN_CLOSE_SHARE, stats
    assert stats["mean_abs"] <= MAX_MEAN_ABS, stats
    assert abs(stats["seg_rel"]) <= MAX_SEG_REL, stats
    assert stats["mark_match"] >= MIN_MARK_MATCH, stats


@pytest.mark.parametrize("debug, rr, stratified", [
    (ON_SMALL, 0, False), (ON_SMALL, 5, True), (GROUND, 5, False),
    (GROUND, 0, True),
], ids=["cursor-rr0", "cursor-rr5-stratified", "outline-rr5",
        "outline-rr0-stratified"])
def test_flat_debug_chunk_matches_interpret_kernel(debug, rr, stratified):
    """K2 + debug on two_sphere: the marker on the small sphere, or the
    ground's outline."""
    stats = chunk_parity("two_sphere", rr, stratified, *debug)
    assert_bounds(stats)
    assert stats["blue" if debug == ON_SMALL else "red"] > 0, stats


def test_walk_debug_chunk_matches_interpret_kernel():
    """K1 + debug on the cover, cursor on the sphere at the centre of the
    view, that sphere selected: rr5 with the random sampler, rr0 with the
    stratified one. The cover's marked pixels are few (a 0.1 marker and a
    thin outline at this size), so the classes are pooled over both
    chunks."""
    pick = cover_pick()
    pooled = []
    for rr, stratified in ((5, False), (0, True)):
        stats = chunk_parity("cover", rr, stratified, *pick)
        assert_bounds({**stats, "mark_match": 1.0})
        pooled.append(stats)
    blue = sum(s["blue"] for s in pooled)
    red = sum(s["red"] for s in pooled)
    match = sum(s["mark_match"] * (s["blue"] + s["red"])
                for s in pooled) / (blue + red)
    assert blue > 0 and red > 0, pooled
    assert match >= MIN_MARK_MATCH, pooled


@pytest.mark.parametrize("config", ["two_sphere", "cover"])
def test_debug_render_matches_render_image_pallas(config):
    """A whole debug render at 64x32, 4 spp, depth 8, rr5, gamma off,
    against ``render_image_pallas``: the whole-render bounds of
    ``test_torch_flat`` on
    the image scaled back to sums, segments within 0.6 %."""
    w, h = 64, 32
    j_scene, j_cam, *_ = jax_presets.get_config(config, w, h)
    dcam = jax_derive_camera(j_cam)
    cursor, sel = cover_pick(w, h) if config == "cover" else ON_SMALL
    kw = dict(max_depth=DEPTH, russian_roulette_depth=5, gamma=False,
              enable_debug=True)
    ref, ref_stats = pk.render_image_pallas(
        j_scene, dcam, w, h, SPP, jax.random.PRNGKey(3), JaxOptions(**kw),
        jax_debug_params(cursor, sel), return_stats=True)
    img, stats = api.render_image(
        port_scene(j_scene), port_camera(dcam), w, h, SPP, 3,
        TraceOptions(**kw), return_stats=True, device="cpu",
        debug=DebugParams(cursor, sel))
    d = np.abs(img.numpy() - np.asarray(ref)).max(axis=-1) * SPP
    assert (d > 1e-3).mean() <= MAX_FORKED_SHARE
    assert (d <= 1e-5).mean() >= MIN_CLOSE_SHARE
    assert d.mean() <= MAX_MEAN_ABS
    ref_segs = float(ref_stats["segments"])
    assert abs(stats["segments_exact"] - ref_segs) <= MAX_SEG_REL * ref_segs


@pytest.mark.parametrize("config", ["two_sphere", "cover"])
def test_overlay_away_is_the_plain_render(config):
    """``enable_debug`` with the cursor far away and nothing selected
    (1000) draws nothing: bitwise the render without the overlay. (The
    default ``DebugParams.none()`` puts the cursor at the origin, which
    two_sphere keeps clear of, as the JAX test relies on.)"""
    scene, cam, *_ = presets.get_config(config, 64, 32)
    base = TraceOptions(max_depth=DEPTH, russian_roulette_depth=5)
    debug = dataclasses.replace(base, enable_debug=True)
    plain = api.render_image(scene, cam, 64, 32, 4, 1, base,
                             return_stats=True, device="cpu")
    far = api.render_image(scene, cam, 64, 32, 4, 1, debug,
                           return_stats=True, device="cpu",
                           debug=DebugParams((1e4, 1e4, 1e4), 1000))
    assert torch.equal(plain[0], far[0]) and plain[1] == far[1]
    if config == "two_sphere":
        none = api.render_image(scene, cam, 64, 32, 4, 1, debug,
                                device="cpu")
        assert torch.equal(plain[0], none)


def test_walk_and_scan_overlays_agree_on_the_demo():
    """K1 + debug (``cluster_scan=True``: the winner's uuid from its
    winner row) and K2 + debug (the slot index) on the demo: the same
    image and segments, for a cursor on the centre sphere with it
    selected and for the ground selected (a global slot of the
    partition); the outline fires."""
    scene, cam, *_ = presets.get_config("demo", 64, 32)
    base = TraceOptions(max_depth=DEPTH, enable_debug=True)
    walk = dataclasses.replace(base, cluster_scan=True)
    dcam = api.to_derived(cam)
    assert megakernel.choose_kernel(scene, dcam, walk, "cpu").kernel == \
        "cluster_walk"
    choice = megakernel.choose_kernel(scene, dcam, base, "cpu")
    assert choice.kernel == "flat_scan" and choice.g_full is None
    for cursor, sel in (((0.0, 0.0, -0.5), 1), ((1e4, 1e4, 1e4), 0)):
        dbg = DebugParams(cursor, sel)
        a = api.render_image(scene, cam, 64, 32, 4, 5, base,
                             return_stats=True, device="cpu", debug=dbg)
        b = api.render_image(scene, cam, 64, 32, 4, 5, walk,
                             return_stats=True, device="cpu", debug=dbg)
        assert torch.equal(a[0], b[0]) and a[1] == b[1], (cursor, sel)
    red = b[0][..., 0] - torch.maximum(b[0][..., 1], b[0][..., 2])
    assert int((red > 0.2).sum()) > 0


def test_debug_strips_adaptive_and_never_splits():
    """Debug with an adaptive tolerance renders debug at fixed spp,
    bitwise; on the demo, whose analysis splits (g_full 8), a debug
    render and a debug step with static hints take K2 unsplit."""
    scene, cam, *_ = presets.get_config("demo", 32, 16)
    dcam = api.to_derived(cam)
    fixed = TraceOptions(max_depth=4, enable_debug=True)
    adaptive = dataclasses.replace(fixed, adaptive_tolerance=0.2,
                                   adaptive_chunk_spp=4)
    dbg = DebugParams((0.0, 0.0, -0.5), 1)
    a = api.render_image(scene, cam, 32, 16, 96, 2, adaptive,
                         return_stats=True, device="cpu", debug=dbg)
    b = api.render_image(scene, cam, 32, 16, 96, 2, fixed,
                         return_stats=True, device="cpu", debug=dbg)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    assert "mean_spp" not in a[1]
    plain = dataclasses.replace(fixed, enable_debug=False)
    assert megakernel.choose_kernel(scene, dcam, plain, "cpu").g_full == 8
    assert megakernel.choose_kernel(scene, dcam, fixed, "cpu").g_full is None
    hinted = pstep.make_step_fn(32, 16, 1, fixed, static_scene=scene,
                                static_camera=cam, device="cpu")
    assert hinted.static_split is None
    split = pstep.make_step_fn(32, 16, 1, plain, static_scene=scene,
                               static_camera=cam, device="cpu")
    assert split.static_split is not None
    # a hinted debug session renders the unhinted one's frames
    bare = pstep.make_step_fn(32, 16, 1, fixed, device="cpu")
    s1, t1 = pstep.run_frames(hinted, pstate.init_render_state(
        32, 16, 0, device="cpu"), scene, cam, 2, dbg)
    s2, t2 = pstep.run_frames(bare, pstate.init_render_state(
        32, 16, 0, device="cpu"), scene, cam, 2, dbg)
    assert torch.equal(s1.accum, s2.accum) and t1 == t2


def test_debug_step_matches_jax_step():
    """A debug session on two_sphere (two frames of 2 spp, depth 4) on
    both sides from one key, with the cursor on the small sphere: the
    walk's chunk bounds on the running average."""
    j_scene, j_cam, *_ = jax_presets.get_config("two_sphere", 48, 27)
    j_opts = JaxOptions(max_depth=4, backend="pallas", enable_debug=True)
    j_step = jax_step.make_step_fn(48, 27, spp=2, opts=j_opts)
    js = jax_state.init_render_state(48, 27, jax.random.PRNGKey(5))
    jd = jax_debug_params(*ON_SMALL)
    js, j_segs = jax_step.run_frames(j_step, js, j_scene, j_cam, 2, jd)
    step = pstep.make_step_fn(48, 27, 2, TraceOptions(max_depth=4,
                                                      enable_debug=True),
                              device="cpu")
    ps, p_segs = pstep.run_frames(
        step, pstate.init_render_state(48, 27, 5, device="cpu"),
        port_scene(j_scene), port_camera(j_cam), 2,
        debug_from_numpy(jd.cursor_point, jd.selected_object))
    d = np.abs(ps.accum.numpy() - np.asarray(js.accum)).max(axis=-1)
    assert (d > 1e-3).mean() <= MAX_FORKED_SHARE
    assert (d <= 1e-5).mean() >= MIN_CLOSE_SHARE
    assert abs(p_segs - j_segs) <= MAX_SEG_REL * j_segs


def test_debug_params_from_numpy():
    d = debug_from_numpy(np.asarray([0.1, 0.2, 0.3], np.float32),
                         np.int32(7))
    assert d.cursor_point == tuple(float(np.float32(v))
                                   for v in (0.1, 0.2, 0.3))
    assert d.selected_object == 7
    none = DebugParams.none()
    assert none.cursor_point == (0.0, 0.0, 0.0)
    assert none.selected_object == 1000
    assert tables.debug_uniforms(DebugParams((1, 2, 3), 5)) == (1.0, 2.0,
                                                                 3.0, 5.0)
    with pytest.raises(ValueError):
        DebugParams((1.0, 2.0), 0)


# --- hit_world, picking ---------------------------------------------------

def record_stats(got, ref) -> dict:
    """Over the rays that hit: the share of t within 1e-4 relative and its
    largest relative difference; the share of points within
    1e-5·(1 + |p|) and the largest such difference."""
    hit = np.asarray(ref.hit)
    want_t = np.asarray(ref.t)[hit]
    t_rel = np.abs(got.t.numpy()[hit] - want_t) / want_t
    want_p = np.asarray(ref.point)[hit]
    p_rel = (np.abs(got.point.numpy()[hit] - want_p).max(-1)
             / (1.0 + np.abs(want_p).max(-1)))
    return {"t_close": float((t_rel <= 1e-4).mean()),
            "t_max": float(t_rel.max()),
            "p_close": float((p_rel <= 1e-5).mean()),
            "p_max": float(p_rel.max())}


def assert_records_match(got, ref):
    """Hit, uuid and facing equal. The port's quadratic is plain float32
    and XLA fuses the JAX function's into multiply-adds, so t and the
    point differ where the quadratic is ill-conditioned (grazing rays, and
    the cover's ground sphere of radius 1000, whose c = |oc|² - r²
    cancels). Measured with this file's ``__main__ hit`` (seeds 11-15 of
    ``hit_world_case``): t within 1e-4 relative on 98.0-100 % of hits and
    4.5e-2 at most; the point within 1e-5·(1 + |p|) on 88.6-100 % and
    2.0e-4·(1 + |p|) at most."""
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.uuid.numpy(), np.asarray(ref.uuid))
    np.testing.assert_array_equal(got.front_face.numpy(),
                                  np.asarray(ref.front_face))
    stats = record_stats(got, ref)
    assert stats["t_close"] >= 0.97 and stats["t_max"] <= 0.1, stats
    assert stats["p_close"] >= 0.85 and stats["p_max"] <= 5e-4, stats


def random_scene(r, n):
    m = JaxMaterial
    spheres = [((float(x), float(y), float(z)), float(rad),
                m.diffuse((0.5, 0.5, 0.5)))
               for x, y, z, rad in zip(*(r.uniform(-3, 3, (3, n))),
                                       r.uniform(0.2, 1.0, n))]
    return jax_make_scene(spheres)


def hit_world_case(config, seed):
    """2000 random rays from random origins (some inside spheres) against
    a random scene of 40 spheres or a preset: (port's record, JAX's)."""
    r = np.random.default_rng(seed)
    if config == "random":
        j_scene = random_scene(r, 40)
    else:
        j_scene = jax_presets.get_config(config, 32, 16)[0]
    origin = r.uniform(-4, 4, (2000, 3)).astype(np.float32)
    direction = r.normal(size=(2000, 3)).astype(np.float32)
    ref = jax_tracer.hit_world(jnp.asarray(origin), jnp.asarray(direction),
                               j_scene)
    got = tracer.hit_world(torch.from_numpy(origin),
                           torch.from_numpy(direction), port_scene(j_scene))
    return got, ref


@pytest.mark.parametrize("config", ["random", "demo", "cover", "three_sphere"])
def test_hit_world_matches_jax(config):
    """``hit_world_case`` of seed 11: ``assert_records_match``."""
    got, ref = hit_world_case(config, 11)
    assert np.asarray(ref.hit).mean() > 0.2
    assert_records_match(got, ref)


def test_hit_world_tie_goes_to_the_later_sphere():
    """A duplicated sphere: every hit on it ties, and the later index wins
    (the JAX function's ``<=``), as picking reports it."""
    m = JaxMaterial
    spheres = [((0.0, 0.0, -2.0), 0.5, m.diffuse((0.5, 0.5, 0.5))),
               ((0.0, -100.5, -1.0), 100.0, m.diffuse((0.5, 0.5, 0.5)))]
    j_scene = jax_make_scene(spheres + [spheres[0]])
    origin = np.zeros((5, 3), np.float32)
    direction = np.array([[0, 0, -1], [0.05, 0, -1], [0, 0.1, -1],
                          [0, -1, -1], [0, 1, 0]], np.float32)
    got = tracer.hit_world(torch.from_numpy(origin),
                           torch.from_numpy(direction), port_scene(j_scene))
    ref = jax_tracer.hit_world(jnp.asarray(origin), jnp.asarray(direction),
                               j_scene)
    assert got.uuid.tolist()[:3] == [2, 2, 2]
    assert got.uuid.tolist()[3:] == [1, -1]
    assert_records_match(got, ref)


def random_camera(r):
    return JaxCamera.create(
        origin=tuple(r.uniform(-2, 2, 3)), yaw=float(r.uniform(-180, 180)),
        pitch=float(r.uniform(-60, 60)), fov=float(r.uniform(0.3, 1.5)),
        aperture=float(r.choice([0.0, 0.1])),
        focus_distance=float(r.uniform(0.5, 5)), aspect_ratio=16 / 9)


def pick_cases():
    r = np.random.default_rng(5)
    cases = [("demo", jax_presets.get_config("demo", 64, 36)[1]),
             ("cover", jax_presets.get_config("cover", 64, 36)[1]),
             ("dof", jax_presets.get_config("dof", 64, 36)[1])]
    cases += [("demo", random_camera(r)) for _ in range(12)]
    cases += [("cover", random_camera(r)) for _ in range(6)]
    return cases


def jax_pick_body(j_scene, dcam):
    """``center_hit``'s body, run eagerly on a derived camera: the JAX
    package's arithmetic before XLA fuses it under ``jax.jit``."""
    ray = jax_center_ray(dcam)
    rec = jax_tracer.hit_world(ray.origin[None, :], ray.direction[None, :],
                               j_scene, t_min=0.0)
    point = np.where(np.asarray(rec.hit[0]), np.asarray(rec.point[0]), 0.0)
    return rec, point.astype(np.float32)


def test_center_hit_matches_jax():
    """The pick of the presets' cameras and of random ones (hits and
    misses), on the derived camera carried across: hit and uuid equal to
    the JAX ``center_hit``'s; t, the point and the distance within 1e-5
    relative (to 1 + the largest coordinate) of the jitted function and of
    its body run eagerly. Not within 4 ulps: the port's quadratic is
    plain float32, XLA fuses the JAX one into multiply-adds, and the
    quadratic magnifies an ulp near a silhouette (measured: 6.4e-6
    relative, 131 ulps, against the jitted function; 2.7e-6 against the
    body; t within 6.9e-7)."""
    seen = set()
    for config, j_cam in pick_cases():
        j_scene = jax_presets.get_config(config, 64, 36)[0]
        dcam = jax_derive_camera(j_cam)
        ref = jax_picking.center_hit(j_scene, j_cam)
        got = picking.center_hit(port_scene(j_scene), port_camera(dcam))
        assert bool(got.hit) == bool(ref.hit)
        assert int(got.uuid) == int(ref.uuid)
        body, point = jax_pick_body(j_scene, dcam)
        for want_point, want_t in ((np.asarray(ref.point), ref.t),
                                   (point, body.t[0])):
            scale = 1.0 + np.abs(want_point).max()
            assert np.abs(got.point.numpy() - want_point).max() \
                <= 1e-5 * scale
            if bool(ref.hit):
                assert abs(float(got.t) - float(want_t)) <= 1e-5 * scale
        assert abs(float(got.distance) - float(ref.distance)) \
            <= 1e-5 * (1.0 + float(ref.distance))
        seen.add(bool(ref.hit))
    assert seen == {True, False}


def test_update_cursor_state_matches_jax():
    """The cursor, the selection and autofocus from the cameras as the
    user holds them (the port derives them itself, where torch's tan can
    differ from XLA's by an ulp): the selection equal, the cursor and the
    focus distance within 1e-4 relative, every other camera field equal;
    open and closed apertures, hits and misses."""
    seen = set()
    for config, j_cam in pick_cases():
        j_scene = jax_presets.get_config(config, 64, 36)[0]
        j_cam2, j_point, j_sel = jax_picking.update_cursor_state(j_scene,
                                                                 j_cam)
        cam2, point, sel = picking.update_cursor_state(port_scene(j_scene),
                                                       port_camera(j_cam))
        assert sel == int(j_sel)
        j_point = np.asarray(j_point)
        assert np.abs(np.asarray(point) - j_point).max() <= 1e-4 * (
            1.0 + np.abs(j_point).max())
        focus = float(j_cam2.focus_distance)
        assert abs(float(cam2.focus_distance) - focus) <= 1e-4 * focus
        for name in ("origin", "yaw", "pitch", "fov", "aperture",
                     "aspect_ratio", "vup"):
            np.testing.assert_array_equal(getattr(cam2, name).numpy(),
                                          np.asarray(getattr(j_cam2, name)))
        seen.add((int(j_sel) != 1000, float(j_cam.aperture) > 0))
    assert seen == {(True, True), (True, False), (False, True),
                    (False, False)}


def test_picking_uses_t_min_zero():
    """Cameras at the centre of a sphere, on its surface looking in, and
    just inside: the pick, with t_min = 0, is the JAX package's (the
    sphere, t and the point within 1e-5); from outside looking away it
    misses, the cursor goes to the origin, nothing is selected and the
    open aperture's focus goes to 10."""
    m = JaxMaterial
    j_scene = jax_make_scene([((0.0, 0.0, 0.0), 2.0,
                               m.diffuse((0.5, 0.5, 0.5)))])
    for origin in ((0.0, 0.0, 0.0), (0.0, 0.0, 2.0), (0.0, 0.0, 1.9995)):
        j_cam = JaxCamera.create(origin=origin, aperture=0.1)
        dcam = jax_derive_camera(j_cam)
        body, point = jax_pick_body(j_scene, dcam)
        got = picking.center_hit(port_scene(j_scene), port_camera(dcam))
        assert bool(got.hit) and bool(body.hit[0])
        assert int(got.uuid) == int(body.uuid[0]) == 0
        assert abs(float(got.t) - float(body.t[0])) <= 1e-5
        assert np.abs(got.point.numpy() - point).max() <= 1e-5 * 3.0
    away = JaxCamera.create(origin=(0.0, 0.0, 10.0), yaw=90.0, aperture=0.1)
    cam2, point, sel = picking.update_cursor_state(port_scene(j_scene),
                                                   port_camera(away))
    assert sel == 1000 and point == (0.0, 0.0, 0.0)
    assert float(cam2.focus_distance) == 10.0


# --- AOV views ------------------------------------------------------------

def aov_diffs(config, w, h) -> dict:
    """Per mode, the (H, W) largest channel difference between the port's
    view and the JAX ``render_aov``, on the derived camera carried
    across."""
    j_scene, j_cam, *_ = jax_presets.get_config(config, w, h)
    scene = port_scene(j_scene)
    cam = port_camera(jax_derive_camera(j_cam))
    diffs = {}
    for mode in AOV_MODES:
        ref = np.asarray(jax_debug.render_aov(j_scene, j_cam, w, h, mode))
        got = render_aov(scene, cam, w, h, mode, device="cpu").numpy()
        assert got.shape == ref.shape == (h, w, 3)
        diffs[mode] = np.abs(got - ref).max(-1)
    return diffs


@pytest.mark.parametrize("config", ["demo", "cover", "three_sphere", "dof"])
def test_render_aov_matches_jax(config):
    """All four modes at 64x36 with the derived camera carried across:
    uuid and front maps equal on at least 99.9 % of pixels (measured: all),
    depth within 1e-5 (measured 4.9e-6). The normal is (p - c)/r: the
    port's hit point is plain float32 and XLA contracts the jitted view's
    quadratic and hit point into fused multiply-adds, and the cover's
    ground sphere (radius 1000) is ill-conditioned in both. Within 1e-5 on
    at least 70 % of pixels and 1e-2 on all (measured at 64x36, 96x54 and
    160x90 with this file's ``__main__ aov``: 72.9-73.8 % and 3.1e-3 to
    5.4e-3 on the cover; 98.9-100 % and 1.8e-4 at most on the other
    presets)."""
    for mode, d in aov_diffs(config, 64, 36).items():
        if mode in ("uuid", "front"):
            assert (d == 0).mean() >= 0.999, (mode, (d == 0).mean())
        elif mode == "depth":
            assert d.max() <= 1e-5, d.max()
        else:
            assert (d <= 1e-5).mean() >= 0.70 and d.max() <= 1e-2, (
                (d <= 1e-5).mean(), d.max())


def test_aov_modes_and_device():
    scene, cam, *_ = presets.get_config("demo", 16, 8)
    with pytest.raises(ValueError, match="unknown AOV mode"):
        render_aov(scene, cam, 16, 8, "albedo", device="cpu")
    img = render_aov(scene, cam, 16, 8, "depth", device="cpu")
    assert img.shape == (8, 16, 3) and float(img.min()) >= 0.0
    assert float(img.max()) <= 1.0


if __name__ == "__main__":
    # parity statistics; run as
    #   python tests/test_torch_debug.py [seed...]   the overlay's chunks
    #   python tests/test_torch_debug.py hit         hit_world, seeds 11-15
    #   python tests/test_torch_debug.py aov         the AOV views
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    if sys.argv[1:] == ["hit"]:
        for config in ("random", "demo", "cover", "three_sphere"):
            for seed in range(11, 16):
                print(config, seed, record_stats(*hit_world_case(config,
                                                                 seed)),
                      flush=True)
    elif sys.argv[1:] == ["aov"]:
        for w, h in ((64, 36), (96, 54), (160, 90)):
            for config in ("demo", "cover", "three_sphere", "dof"):
                for mode, d in aov_diffs(config, w, h).items():
                    print(w, h, config, mode, "equal", (d == 0).mean(),
                          "within 1e-5", (d <= 1e-5).mean(), "max", d.max(),
                          flush=True)
    else:
        for seed in [int(s) for s in sys.argv[1:]] or [7]:
            for config, rr, strat, dbg in (
                    ("two_sphere", 0, False, ON_SMALL),
                    ("two_sphere", 5, True, ON_SMALL),
                    ("two_sphere", 5, False, GROUND),
                    ("two_sphere", 0, True, GROUND),
                    ("cover", 5, False, None), ("cover", 0, True, None)):
                dbg = dbg or cover_pick()
                print(config, rr, strat, dbg, seed,
                      chunk_parity(config, rr, strat, *dbg, seed),
                      flush=True)
