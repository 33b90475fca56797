"""The port's sharded paths against the JAX package's on the same mesh
shapes: ``render_image_sharded_pallas`` on a (4, 2) mesh (8 gloo ranks
here, 8 virtual CPU devices there, Pallas in interpret mode as
``tests/test_sharding.py`` runs it), the adaptive render on a (2,) mesh
and the progressive step on a (4,) mesh over 2 frames. The scene and the
derived camera are the JAX package's, carried across as arrays.

Frames cannot match bit for bit (a one-ulp difference in a
transcendental forks a path; ROADMAP ground rules), so each comparison
is held to the bounds of the single-device comparison it repeats, each
set above a measurement:

- the (4, 2) render (two_sphere 64x32, 4 spp, depth 4, gamma off; the
  ground rules' whole-render bounds on the per-pixel rgb sums): measured no pixel off by more
  than 1e-3, all within 1e-5, mean |Δ| 4.4e-8, segment totals equal;
- the (2,) adaptive render (17 spp as chunks [1, 4, 4, 4, 4] forced on
  both sides, tolerance 0.3, ``ADAPTIVE_MIN_N`` 4, depth 4, gamma off;
  the ground rules' adaptive-render bounds): ``spp_map`` equal on every pixel (5 to 17
  samples), mean spp 6.006 on both, no pixel off by more than 1e-3, all
  within 1e-5, mean |Δ| 1.1e-8, segments equal;
- the (4,) step (depth 3, the running average after 2 frames; the
  progressive step's bounds): no pixel off by more than 1e-3, all within
  1e-5, mean |Δ| 9.9e-9, each frame's segments equal.

Two spheres give few grazing hits, so nothing forked here; the bounds
are the single-device comparisons' (the cover forks on 2-5 % of pixels).

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
    render_image_sharded_pallas,
    run_ranks,
    shard_render_state,
)
from raytracer_tpu_torch.progressive.state import init_render_state
from raytracer_tpu_torch.render import schedule
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

W, H = 64, 32
SPP, DEPTH = 4, 4
A_SPP, A_CHUNK, A_TOL, A_MIN_N = 17, 2, 0.3, 4
STEP_DEPTH, FRAMES = 3, 2

# the ROADMAP ground rules' whole-render bounds (per-pixel rgb sums) and
# adaptive-render bounds, the progressive step's bounds
MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3
MAX_SEG_REL = 6e-3
A_MIN_MAP_EQUAL = 0.95
A_MAX_MEAN_SPP_REL = 0.02
A_MAX_FORKED_SHARE = 0.10
A_MAX_MEAN_ABS = 4e-3
A_MAX_SEG_REL = 0.01


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry_across(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


# --- the ranks' work ------------------------------------------------------

def port_render(scene_np: dict, cam_np: dict) -> tuple:
    mesh = make_mesh((4, 2), device="cpu")
    return render_image_sharded_pallas(
        scene_from_numpy(**scene_np), camera_from_numpy(cam_np), W, H, SPP,
        0, mesh, TraceOptions(max_depth=DEPTH, gamma=False),
        return_stats=True)


def port_adaptive(scene_np: dict, cam_np: dict) -> tuple:
    mesh = make_mesh((2,), ("rows",), device="cpu")
    schedule.pick_chunk_spp = lambda spp, *a, **k: min(spp, A_CHUNK)
    schedule.ADAPTIVE_MIN_N = A_MIN_N
    return render_image_sharded_pallas(
        scene_from_numpy(**scene_np), camera_from_numpy(cam_np), W, H,
        A_SPP, 0, mesh, TraceOptions(max_depth=DEPTH, gamma=False,
                                     adaptive_tolerance=A_TOL),
        return_stats=True)


def port_steps(scene_np: dict, cam_np: dict) -> tuple:
    mesh = make_mesh((4,), ("rows",), device="cpu")
    scene, cam = scene_from_numpy(**scene_np), camera_from_numpy(cam_np)
    step = make_sharded_step_fn(W, H, mesh, spp=1,
                                opts=TraceOptions(max_depth=STEP_DEPTH))
    state = shard_render_state(init_render_state(W, H, 0, device="cpu"),
                               mesh)
    segs = []
    for _ in range(FRAMES):
        state, aux = step(state, scene, cam)
        segs.append(int(aux["segments"]))
    return gather_rows(state.accum, mesh), segs


@pytest.fixture(scope="module")
def inputs():
    from raytracer_tpu.camera.camera import derive_camera
    from raytracer_tpu.scene import presets

    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    return scene, cam, carry_across(scene), carry_across(derive_camera(cam))


@pytest.fixture(scope="module")
def render_pair(inputs):
    import jax

    from raytracer_tpu.parallel.sharding import (
        make_mesh as jax_mesh,
        render_image_sharded_pallas as jax_render,
    )
    from raytracer_tpu.render.options import TraceOptions as JaxOptions

    scene, cam, scene_np, cam_np = inputs
    ref = jax_render(scene, cam, W, H, SPP, jax.random.PRNGKey(0),
                     jax_mesh((4, 2)),
                     JaxOptions(max_depth=DEPTH, gamma=False),
                     return_stats=True)
    return run_ranks(port_render, 8, scene_np, cam_np), ref


@pytest.fixture(scope="module")
def adaptive_pair(inputs):
    import jax

    from raytracer_tpu.parallel.sharding import (
        make_mesh as jax_mesh,
        render_image_sharded_pallas as jax_render,
    )
    from raytracer_tpu.render import pallas_kernel as pk
    from raytracer_tpu.render.options import TraceOptions as JaxOptions

    scene, cam, scene_np, cam_np = inputs
    real = pk._pick_chunk_spp, pk.ADAPTIVE_MIN_N
    pk._pick_chunk_spp = lambda spp, *a, **k: min(spp, A_CHUNK)
    pk.ADAPTIVE_MIN_N = A_MIN_N
    try:
        ref = jax_render(scene, cam, W, H, A_SPP, jax.random.PRNGKey(0),
                         jax_mesh((2,), ("rows",)),
                         JaxOptions(max_depth=DEPTH, gamma=False,
                                    adaptive_tolerance=A_TOL),
                         return_stats=True)
    finally:
        pk._pick_chunk_spp, pk.ADAPTIVE_MIN_N = real
    return run_ranks(port_adaptive, 2, scene_np, cam_np), ref


@pytest.fixture(scope="module")
def step_pair(inputs):
    import jax

    from raytracer_tpu.parallel.sharding import (
        make_mesh as jax_mesh,
        make_sharded_step_fn as jax_step_fn,
        shard_render_state as jax_shard_state,
    )
    from raytracer_tpu.progressive.state import (
        init_render_state as jax_init_state,
    )
    from raytracer_tpu.render.options import DebugParams
    from raytracer_tpu.render.options import TraceOptions as JaxOptions

    scene, cam, scene_np, cam_np = inputs
    mesh = jax_mesh((4,), ("rows",))
    step = jax_step_fn(W, H, mesh, spp=1,
                       opts=JaxOptions(max_depth=STEP_DEPTH,
                                       backend="pallas"))
    state = jax_shard_state(jax_init_state(W, H, jax.random.PRNGKey(0)),
                            mesh)
    segs = []
    for _ in range(FRAMES):
        state, aux = step(state, scene, cam, DebugParams.none())
        segs.append(float(aux["segments"]))
    return run_ranks(port_steps, 4, scene_np, cam_np), (
        np.asarray(state.accum), segs)


def close_shares(d: np.ndarray) -> tuple:
    return float((d > 1e-3).mean()), float((d <= 1e-5).mean()), float(
        d.mean())


def test_rows_spp_render_matches_jax(render_pair):
    ranks, (ref, ref_stats) = render_pair
    img, stats = ranks[0]
    assert img.shape == (H, W, 3)
    d = np.abs(img.numpy() - np.asarray(ref)).max(axis=-1) * SPP
    forked, close, mad = close_shares(d)
    assert forked <= MAX_FORKED_SHARE
    assert close >= MIN_CLOSE_SHARE
    assert mad <= MAX_MEAN_ABS
    ref_segs = float(ref_stats["segments"])
    assert abs(stats["segments_exact"] - ref_segs) <= MAX_SEG_REL * ref_segs


def test_rows_spp_render_same_on_every_rank(render_pair):
    ranks, _ = render_pair
    for img, stats in ranks[1:]:
        assert torch.equal(img, ranks[0][0]) and stats == ranks[0][1]


def test_adaptive_render_matches_jax(adaptive_pair):
    ranks, (ref, ref_stats) = adaptive_pair
    img, stats = ranks[0]
    spp_map = stats["spp_map"].numpy()
    ref_map = np.asarray(ref_stats["spp_map"])
    assert spp_map.shape == ref_map.shape == (H, W)
    assert (spp_map == ref_map).mean() >= A_MIN_MAP_EQUAL
    # both stopped pixels early, at the same chunk boundaries
    assert set(np.unique(spp_map)) == set(np.unique(ref_map))
    assert spp_map.min() < spp_map.max() <= A_SPP
    ref_mean = float(ref_stats["mean_spp"])
    assert abs(stats["mean_spp"] - ref_mean) <= A_MAX_MEAN_SPP_REL * ref_mean
    d = np.abs(img.numpy() - np.asarray(ref)).max(axis=-1)
    forked, close, mad = close_shares(d)
    assert forked <= A_MAX_FORKED_SHARE
    assert close >= MIN_CLOSE_SHARE
    assert mad <= A_MAX_MEAN_ABS
    ref_segs = float(ref_stats["segments"])
    assert abs(stats["segments_exact"] - ref_segs) <= A_MAX_SEG_REL * ref_segs


def test_progressive_step_matches_jax(step_pair):
    ranks, (ref, ref_segs) = step_pair
    accum, segs = ranks[0]
    assert accum.shape == (H, W, 3)
    d = np.abs(accum.numpy() - ref).max(axis=-1)
    forked, close, mad = close_shares(d)
    assert forked <= MAX_FORKED_SHARE
    assert close >= MIN_CLOSE_SHARE
    assert mad <= MAX_MEAN_ABS
    for got, want in zip(segs, ref_segs, strict=True):
        assert abs(got - want) <= MAX_SEG_REL * want
    for other in ranks[1:]:
        assert torch.equal(other[0], accum) and other[1] == segs


@pytest.mark.parametrize("name", ["make_mesh", "render_image_sharded_pallas",
                                  "make_sharded_step_fn"])
def test_arguments_are_the_jax_packages(name):
    """The port's functions take the JAX package's arguments, in its
    order and with its defaults; ``make_mesh`` adds only ``device``."""
    import inspect

    from raytracer_tpu.parallel import sharding as jax_sharding

    from raytracer_tpu_torch.parallel import mesh, sharding

    port = getattr(sharding, name, None) or getattr(mesh, name)
    want = inspect.signature(getattr(jax_sharding, name)).parameters
    got = inspect.signature(port).parameters
    extra = ["device"] if name == "make_mesh" else []
    assert list(got) == list(want) + extra
    for arg, p in want.items():
        assert got[arg].default == p.default, arg
