"""The port's jnp tracer (``render/tracer.py``: ``hit_world``'s material
gathers, ``schlick``, ``scatter``, ``background``, ``trace_rays``) against
the JAX package's on the same numpy inputs and keys: the cases of
``tests/test_tracer.py``'s materials, bounce-loop and debug sections, each
run on both packages and held to its own claim there as well.

Bounds, each above a measurement:

- ``schlick``: bitwise against JAX run op by op (``integer_pow`` by
  squaring). Under ``jax.jit`` XLA contracts r0 + (1 - r0)·x⁵ into a
  fused multiply-add, which differs on 18.8 % of 200k inputs: the test
  holds the eager form.
- ``scatter``: the scatter flags and the attenuation exact; the new
  directions within 16 ulps of their magnitude (measured 3.4 diffuse,
  9.0 metal, 4.0 glass, 7.0 unknown, whose glass-formed direction is
  discarded; the draws' sin, cos and cube root and XLA's fused
  multiply-adds).
- ``trace_rays`` on these small scenes: at least 99 % of rays within
  1e-5 of JAX's colour (measured 100 %: nothing forked); the segment
  totals equal (JAX sums them in float32, exact at these counts).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.render import tracer as jt
from raytracer_tpu.render.options import DebugParams as JDebug
from raytracer_tpu.render.options import TraceOptions as JOptions
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu.scene.materials import Material
from raytracer_tpu.scene.spheres import make_scene
from raytracer_tpu_torch.render import rng
from raytracer_tpu_torch.render import tracer as pt
from raytracer_tpu_torch.render.options import DebugParams, TraceOptions
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

ULP = 2.0 ** -23
DIR_MAX_ULPS = 16
MIN_CLOSE_SHARE = 0.99
CLOSE = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(scene):
    return scene_from_numpy(**{f.name: np.asarray(getattr(scene, f.name))
                               for f in dataclasses.fields(scene)})


def single_sphere(center=(0, 0, -2), radius=1.0, mat=None):
    return make_scene([(center, radius,
                        mat or Material.diffuse((0.5, 0.5, 0.5)))])


def batch(o, d, n):
    o = np.broadcast_to(np.asarray(o, np.float32), (n, 3)).copy()
    d = np.broadcast_to(np.asarray(d, np.float32), (n, 3)).copy()
    return o, d


#: rays of every traced batch: a ray's draws are keyed by its batch
#: position alone, so padding a batch (with copies of its last ray)
#: changes none of its rays, and the JAX loop compiles once per options
BATCH = 2048
_JAX_TRACE = {}


def jax_trace(opts_kw: dict):
    key = tuple(sorted(opts_kw.items()))
    if key not in _JAX_TRACE:
        jopts = JOptions(**opts_kw)
        _JAX_TRACE[key] = jax.jit(
            lambda o, d, s, k, g: jt.trace_rays(o, d, s, k, jopts, g))
    return _JAX_TRACE[key]


def both(scene, o, d, opts_kw, seed=0, debug=None):
    """``trace_rays`` of both packages on the same rays and key:
    ((JAX colour, JAX segments), (port colour, port segments)), the
    segments those of the whole padded batch."""
    n = o.shape[0]
    pad = np.repeat(np.arange(n), [1] * (n - 1) + [BATCH - n + 1])
    o, d = o[pad], d[pad]
    key = jax.random.PRNGKey(seed)
    if debug is None:
        debug = ((0.0, 0.0, 0.0), 1000)  # the JAX package's none()
    jdbg = JDebug(cursor_point=jnp.asarray(debug[0], jnp.float32),
                  selected_object=jnp.asarray(debug[1], jnp.int32))
    jc, js = jax_trace(opts_kw)(o, d, scene, key, jdbg)
    pc, ps = pt.trace_rays(torch.from_numpy(o), torch.from_numpy(d),
                           carry(scene), rng.key_data(np.asarray(key)),
                           TraceOptions(**opts_kw), DebugParams(*debug))
    return (np.asarray(jc)[:n], float(js)), (pc.numpy()[:n], int(ps))


def held(pair):
    """Both packages' colours agree; returns the port's."""
    (jc, js), (pc, ps) = pair
    close = (np.abs(jc - pc).max(-1) <= CLOSE).mean()
    assert close >= MIN_CLOSE_SHARE
    assert ps == js
    return pc


# --- hit_world's gathers ------------------------------------------------------

def test_hit_record_carries_the_material():
    scene = make_scene([
        ((0, 0, -5), 1.0, Material.diffuse((1, 0, 0))),
        ((0, 0, -2), 0.5, Material.glass(1.7)),
        ((3, 0, -2), 0.5, Material.metal((0.2, 0.3, 0.4), fuzz=0.6)),
    ], pad_to=8)
    o, d = batch((0, 0, 0), (0, 0, -1), 3)
    d[1], d[2] = (0, 1, 0), (3, 0, -2)
    want = jt.hit_world(jnp.asarray(o), jnp.asarray(d), scene)
    got = pt.hit_world(torch.from_numpy(o), torch.from_numpy(d),
                       carry(scene))
    for name in ("hit", "front_face", "uuid", "material_type", "albedo",
                 "fuzz", "refraction_index"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.point.numpy(), np.asarray(want.point),
                               atol=1e-6)
    assert got.uuid.tolist() == [1, -1, 2]


# --- materials --------------------------------------------------------------

def test_schlick_bitwise():
    r = np.random.default_rng(0)
    c = r.uniform(-1, 1, 200_000).astype(np.float32)
    eta = r.uniform(0.3, 2.5, 200_000).astype(np.float32)
    want = np.asarray(jt.schlick(jnp.asarray(c), jnp.asarray(eta)))
    got = pt.schlick(torch.from_numpy(c), torch.from_numpy(eta)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert abs(float(pt.schlick(torch.tensor(1.0), torch.tensor(1.5)))
               - 0.04) < 1e-3
    assert abs(float(pt.schlick(torch.tensor(0.0), torch.tensor(1.5)))
               - 1.0) < 1e-6


jax_scatter = jax.jit(lambda d, rec, k: jt.scatter(d, rec, k, JOptions()))

MATERIALS = {
    "diffuse": Material.diffuse((0.5, 0.6, 0.7)),
    "metal": Material.metal((0.8, 0.7, 0.6), fuzz=0.4),
    "glass": Material.glass(1.5),
    "unknown": Material(7, (1, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_scatter_matches_jax(name):
    """``scatter`` of every lane of a fan of rays into one sphere of each
    material, from one key, against the JAX function."""
    scene = single_sphere(center=(0, 0, -2), mat=MATERIALS[name])
    r = np.random.default_rng(1)
    n = 4096
    o = np.zeros((n, 3), np.float32)
    o[n // 2:] = (0, 0, -2)  # half the fan starts inside: back faces
    d = np.concatenate([r.normal(size=(n, 2)) * 0.4,
                        -np.ones((n, 1))], axis=1).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jrec = jt.hit_world(jnp.asarray(o), jnp.asarray(d), scene)
    want = jax_scatter(jnp.asarray(d), jrec, key)
    prec = pt.hit_world(torch.from_numpy(o), torch.from_numpy(d),
                        carry(scene))
    got = pt.scatter(torch.from_numpy(d), prec,
                     rng.key_data(np.asarray(key)), TraceOptions())
    hit = np.asarray(jrec.hit)
    assert hit.mean() > 0.3 and hit[n // 2:].all()
    np.testing.assert_array_equal(got[0].numpy()[hit], np.asarray(want[0])[hit])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    d_err = np.abs(got[2].numpy() - np.asarray(want[2]))[hit]
    scale = np.maximum(1.0, np.abs(np.asarray(want[2])[hit]))
    assert (d_err / scale).max() <= DIR_MAX_ULPS * ULP
    if name == "glass":
        assert got[0].numpy()[hit].all()  # glass never absorbs
    if name == "unknown":
        assert not got[0].numpy().any()  # unknown materials absorb


def test_sky_gradient_no_hit():
    scene = single_sphere(center=(100, -100, 0), radius=1.0)
    o, d = batch((0, 0, 0), (0, 1e-6, -1), 2)
    d[1] = (0, 1, 0.0001)
    pc = held(both(scene, o, d, dict(max_depth=4)))
    np.testing.assert_allclose(pc[0], [0.75, 0.85, 1.0], rtol=1e-4)
    np.testing.assert_allclose(pc[1], [0.5, 0.7, 1.0], rtol=1e-3)


def test_background_matches_jax():
    r = np.random.default_rng(2)
    d = np.concatenate([r.normal(size=(1000, 3)), [[0, -1, 0], [0, 0, 0]]])
    d = d.astype(np.float32)
    want = np.asarray(jt.background(jnp.asarray(d)))
    got = pt.background(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=2 * ULP, rtol=0)
    np.testing.assert_allclose(got[-2], [1, 1, 1], atol=1e-6)


def test_metal_mirror_deterministic():
    scene = make_scene([((0, -100, 0), 99.0,
                         Material.metal((0.8, 0.8, 0.8)))])
    o, d = batch((0, 0, 0), (1, -1, 0), 1)
    pc = held(both(scene, o, d, dict(max_depth=3)))
    t = 0.5 * (1 / math.sqrt(2) + 1)
    sky = (1 - t) * np.array([1, 1, 1.0]) + t * np.array([0.5, 0.7, 1.0])
    np.testing.assert_allclose(pc[0], 0.8 * sky, rtol=5e-2)


def test_metal_absorbs_below_surface():
    scene = make_scene([((0, -101, 0), 100.0,
                         Material.metal((1, 1, 1), fuzz=3.0))])
    o, d = batch((0, 0, 0), (0, -1, 0), 512)
    pc = held(both(scene, o, d, dict(max_depth=2)))
    assert (pc.max(axis=-1) == 0).mean() > 0.2


def test_glass_never_absorbs():
    scene = single_sphere(mat=Material.glass(1.5))
    o, d = batch((0, 0, 0), (0, 0, -1), 256)
    pc = held(both(scene, o, d, dict(max_depth=8)))
    assert pc.min() > 0.0


def test_glass_total_internal_reflection():
    """A grazing ray inside glass meets the back face with ratio 1.5 and
    a sine above 1/1.5: it must reflect, in both packages."""
    scene = make_scene([((0, 0, 0), 1.0, Material.glass(1.5))])
    o, d = batch((0, 0, 0), (1, 0.05, 0), 1)
    o[0] = (0, 0.9, 0)
    rec = pt.hit_world(torch.from_numpy(o), torch.from_numpy(d),
                       carry(scene))
    assert not bool(rec.front_face[0])
    u = (torch.zeros(1, 3), torch.zeros(1, 3), torch.ones(1))  # no Schlick
    did, _, new_dir = pt.scatter(torch.from_numpy(d), rec, None,
                                 TraceOptions(), uniforms=u)
    unit = d[0] / np.linalg.norm(d[0])
    n = rec.normal[0].numpy()
    np.testing.assert_allclose(new_dir[0].numpy(),
                               unit - 2 * np.dot(unit, n) * n, atol=1e-6)
    assert bool(did[0])


def test_unknown_material_absorbs():
    scene = single_sphere(mat=Material(7, (1, 1, 1)))
    o, d = batch((0, 0, 0), (0, 0, -1), 1)
    pc = held(both(scene, o, d, dict(max_depth=3)))
    np.testing.assert_allclose(pc[0], [0, 0, 0])


# --- bounce-loop semantics ----------------------------------------------------

@pytest.mark.parametrize("exhaust_black, want", [(False, 0.9), (True, 0.0)])
def test_exhaust_mode(exhaust_black, want):
    scene = make_scene([
        ((0, 0, -3), 1.0, Material.diffuse((0.9, 0.9, 0.9))),
        ((0, 0, 3), 1.0, Material.diffuse((0.9, 0.9, 0.9))),
    ])
    o, d = batch((0, 0, 0), (0, 0, -1), 64)
    pc = held(both(scene, o, d, dict(max_depth=1,
                                     exhaust_black=exhaust_black)))
    np.testing.assert_allclose(pc, want, atol=1e-6)


def test_throughput_attenuates_multiplicatively():
    scene = make_scene([((0, -1000.5, 0), 1000.0,
                         Material.diffuse((0.5, 0.5, 0.5)))])
    o, d = batch((0, 0, 0), (0, -1, 0), 2048)
    pc = held(both(scene, o, d, dict(max_depth=16)))
    assert 0.1 < pc.mean() < 0.55


def test_russian_roulette_matches_jax():
    """Roulette from bounce 2 inside a closed diffuse sphere (every path
    runs to the depth without it): the survivors' rolls and reweights as
    JAX draws them (the key ``fold_in(bounce key, 7)``), and fewer
    segments than without it."""
    scene = single_sphere(center=(0, 0, 0), radius=10.0,
                          mat=Material.diffuse((0.7, 0.7, 0.7)))
    o, d = batch((0, 0, 0), (0, -1, 0), 2048)
    rr = both(scene, o, d, dict(max_depth=12, russian_roulette_depth=2),
              seed=3)
    pc = held(rr)
    (_, s_all), _ = both(scene, o, d, dict(max_depth=12), seed=3)
    assert s_all > 0.99 * 12 * 2048
    assert rr[1][1] < 0.5 * s_all
    assert np.isfinite(pc).all() and (pc.max(-1) == 0).mean() > 0.5


def test_segments_exact():
    """Rays to the sky trace one segment each; rays into the scene more.
    The port's count is an exact int, JAX's float32 sum equal to it."""
    scene = jpresets.two_sphere_scene()
    o, d = batch((0, 0, 0), (0, 1, 0), 16)
    (_, js), (_, ps) = both(scene, o, d, dict(max_depth=8))
    assert ps == js == BATCH
    assert isinstance(ps, int)
    o, d = batch((0, 0, 0), (0, -1, -1), 300)
    (_, js), (_, ps) = both(scene, o, d, dict(max_depth=8))
    assert ps == js and ps > BATCH


# --- the debug overlay (the jnp forms) --------------------------------------

def test_debug_cursor_marker_blue():
    scene = single_sphere()
    o, d = batch((0, 0, 0), (0, 0, -1), 1)
    pc = held(both(scene, o, d, dict(max_depth=4, enable_debug=True),
                   debug=((0.0, 0.0, -1.0), 1000)))
    np.testing.assert_allclose(pc[0], [0, 0, 1])


def test_debug_marker_is_a_true_distance():
    """The jnp marker is length(point - cursor) < 0.1: a hit 0.0999 away
    is marked, 0.1001 away is not (the kernels compare the squared
    distance with 0.01)."""
    scene = single_sphere()
    o, d = batch((0, 0, 0), (0, 0, -1), 2)
    pc = pt.trace_rays(torch.from_numpy(o[:1]), torch.from_numpy(d[:1]),
                       carry(scene), (0, 0),
                       TraceOptions(max_depth=2, enable_debug=True),
                       DebugParams((0.0999, 0.0, -1.0), 1000))[0]
    assert pc[0].tolist() == [0.0, 0.0, 1.0]
    pc = pt.trace_rays(torch.from_numpy(o[:1]), torch.from_numpy(d[:1]),
                       carry(scene), (0, 0),
                       TraceOptions(max_depth=2, enable_debug=True),
                       DebugParams((0.1001, 0.0, -1.0), 1000))[0]
    assert pc[0].tolist() != [0.0, 0.0, 1.0]


def test_debug_outline_red_on_grazing():
    scene = single_sphere()
    o, d = batch((0, 0.9999, 0), (0, 0, -1), 2)
    o[1] = (0, 0, 0)
    pc = held(both(scene, o, d, dict(max_depth=4, enable_debug=True),
                   debug=((100.0, 100.0, 100.0), 0)))
    np.testing.assert_allclose(pc[0], [1, 0, 0])
    assert not np.allclose(pc[1], [1, 0, 0])
