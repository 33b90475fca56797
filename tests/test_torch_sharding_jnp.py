"""The port's sharded jnp-tracer paths (``parallel/sharding.py``:
``render_image_sharded``, ``_render_shard``, the sharded step with
``backend='jnp'`` and with ``enable_debug``) on 4 gloo ranks on the CPU,
against the JAX package's ``shard_map`` paths on the conftest's virtual
CPU devices, with the same key folds (the rows coordinate, then the spp
coordinate where the mesh has that axis).

- ``render_image_sharded`` on a (2, 2) mesh (two_sphere 64x32, 4 spp,
  depth 4) and, stratified, on a (4,) mesh;
- the jnp step on a (2, 2) mesh (2 spp a frame, 2 frames);
- the debug step on a (4,) mesh (the cursor on the centre sphere, that
  sphere selected, 2 frames).

Each is held to the single-device comparison's bounds
(``tests/test_torch_jnp_render.py``: at most 5 % of pixels off by more
than 1e-3, mean |Δ| ≤ 8e-3; segments within 1 %), measured here: the
(2, 2) render 0.20 % and 1.5e-4 (segments 0.06 % apart), the stratified
(4,) render 0 and 2.3e-9, the (2, 2) step 0.05 % and 1.2e-5, the debug
step 0 and 2.2e-9 (segments at most 0.015 % apart). Inside the port, bit for bit: a rows-only
mesh's band is ``render_image_jnp`` of that band under ``fold_in(key,
row)``, and every rank holds the same whole image.

The ranks import this module: JAX is imported inside the fixtures only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.camera.camera import camera_from_numpy
from raytracer_tpu_torch.parallel import (
    gather_rows,
    make_mesh,
    make_sharded_step_fn,
    render_image_sharded,
    run_ranks,
    shard_render_state,
)
from raytracer_tpu_torch.progressive.state import init_render_state
from raytracer_tpu_torch.render.api import to_derived
from raytracer_tpu_torch.render.options import DebugParams, TraceOptions
from raytracer_tpu_torch.render.rng import fold_in, key_data
from raytracer_tpu_torch.render.tracer import render_image_jnp
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

W, H, SPP, DEPTH, FRAMES = 64, 32, 4, 4, 2
CURSOR = (0.0, 0.0, -0.5)  # on two_sphere's centre sphere, facing the camera
SELECTED = 1

MAX_FORKED_SHARE = 0.05
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


def steps(step, state, scene, cam, debug=None):
    segs = []
    for _ in range(FRAMES):
        state, aux = step(state, scene, cam, debug)
        segs.append(int(aux["segments"]))
    return state, segs


def port_world(scene_np: dict, cam_np: dict) -> dict:
    """Every case, on this rank of a world of 4."""
    m22 = make_mesh((2, 2), device="cpu")
    m4 = make_mesh((4,), ("rows",), device="cpu")
    scene, cam = scene_from_numpy(**scene_np), camera_from_numpy(cam_np)
    opts = TraceOptions(max_depth=DEPTH, backend="jnp")
    got = {"render22": render_image_sharded(scene, cam, W, H, SPP, 0, m22,
                                            opts, return_stats=True)}
    strat = dataclasses.replace(opts, sampler="stratified")
    got["render4"] = render_image_sharded(scene, cam, W, H, SPP, 0, m4,
                                          strat, return_stats=True)
    step = make_sharded_step_fn(W, H, m22, spp=2, opts=opts)
    st = shard_render_state(init_render_state(W, H, 0, device="cpu"), m22)
    st, segs = steps(step, st, scene, cam)
    got["step22"] = (gather_rows(st.accum, m22), segs)
    dbg_opts = TraceOptions(max_depth=DEPTH, enable_debug=True)
    step = make_sharded_step_fn(W, H, m4, spp=1, opts=dbg_opts)
    st = shard_render_state(init_render_state(W, H, 0, device="cpu"), m4)
    st, segs = steps(step, st, scene, cam, DebugParams(CURSOR, SELECTED))
    got["debug4"] = (gather_rows(st.accum, m4), segs)
    return got


@pytest.fixture(scope="module")
def inputs():
    from raytracer_tpu.scene import presets

    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    return scene, cam, carry(scene), carry(cam)


@pytest.fixture(scope="module")
def ranks(inputs):
    return run_ranks(port_world, 4, inputs[2], inputs[3])


@pytest.fixture(scope="module")
def jax_ref(inputs):
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.parallel import sharding as js
    from raytracer_tpu.progressive.state import init_render_state as jinit
    from raytracer_tpu.render.options import DebugParams as JDebug
    from raytracer_tpu.render.options import TraceOptions as JOptions

    scene, cam, _, _ = inputs
    key = jax.random.PRNGKey(0)
    m22, m4 = js.make_mesh((2, 2)), js.make_mesh((4,), ("rows",))
    opts = JOptions(max_depth=DEPTH, backend="jnp")
    ref = {"render22": js.render_image_sharded(
        scene, cam, W, H, SPP, key, m22, opts, return_stats=True)}
    ref["render4"] = js.render_image_sharded(
        scene, cam, W, H, SPP, key, m4,
        dataclasses.replace(opts, sampler="stratified"), return_stats=True)

    def run(mesh, spp, o, debug):
        step = js.make_sharded_step_fn(W, H, mesh, spp=spp, opts=o)
        st = js.shard_render_state(jinit(W, H, key), mesh)
        segs = []
        for _ in range(FRAMES):
            st, aux = step(st, scene, cam, debug)
            segs.append(float(aux["segments"]))
        return np.asarray(st.accum), segs

    ref["step22"] = run(m22, 2, opts, JDebug.none())
    ref["debug4"] = run(m4, 1, JOptions(max_depth=DEPTH, enable_debug=True),
                        JDebug(cursor_point=jnp.asarray(CURSOR, jnp.float32),
                               selected_object=jnp.asarray(SELECTED,
                                                           jnp.int32)))
    return ref


def held(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert float((d.max(-1) > 1e-3).mean()) <= MAX_FORKED_SHARE
    assert float(d.mean()) <= MAX_MEAN_ABS


def segments_held(got: int, want: float):
    assert abs(got - want) <= MAX_SEG_REL * want


@pytest.mark.parametrize("case", ["render22", "render4"])
def test_sharded_render_matches_jax(ranks, jax_ref, case):
    img, stats = ranks[0][case]
    want, wstats = jax_ref[case]
    assert img.shape == (H, W, 3)
    held(img, want)
    segments_held(stats["segments_exact"], float(wstats["segments"]))
    for r in ranks[1:]:
        assert torch.equal(r[case][0], img) and r[case][1] == stats


@pytest.mark.parametrize("case", ["step22", "debug4"])
def test_sharded_jnp_steps_match_jax(ranks, jax_ref, case):
    accum, segs = ranks[0][case]
    want, wsegs = jax_ref[case]
    held(accum, want)
    for got, w in zip(segs, wsegs, strict=True):
        segments_held(got, w)
    for r in ranks[1:]:
        assert torch.equal(r[case][0], accum) and r[case][1] == segs


def test_debug_step_draws_the_marker(ranks, jax_ref):
    """The marker at the cursor: the pixel whose primary rays meet the
    centre sphere at CURSOR (the image centre) is exactly blue, in both
    packages."""
    accum, _ = ranks[0]["debug4"]
    assert accum[H // 2, W // 2].tolist() == [0.0, 0.0, 1.0]
    assert jax_ref["debug4"][0][H // 2, W // 2].tolist() == [0.0, 0.0, 1.0]


def test_rows_band_is_render_image_jnp_of_the_band(ranks, inputs):
    """A rows-only mesh: rank r's band is ``render_image_jnp`` of rows
    [r·H/4, (r+1)·H/4) under ``fold_in(key, r)``, bit for bit."""
    scene = scene_from_numpy(**inputs[2])
    dcam = to_derived(camera_from_numpy(inputs[3]))
    img, _ = ranks[0]["render4"]
    opts = TraceOptions(max_depth=DEPTH, backend="jnp",
                        sampler="stratified")
    lh = H // 4
    for r in range(4):
        band = render_image_jnp(scene, dcam, W, H, SPP,
                                fold_in(key_data(0), r), opts,
                                row_offset=r * lh, band_height=lh)
        assert torch.equal(img[r * lh:(r + 1) * lh], band)


def test_signature_is_the_jax_packages():
    import inspect

    from raytracer_tpu.parallel import sharding as js

    want = inspect.signature(js.render_image_sharded).parameters
    got = inspect.signature(render_image_sharded).parameters
    assert list(got) == list(want)
    for arg, p in want.items():
        assert got[arg].default == p.default, arg
