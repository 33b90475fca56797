"""The port's progressive step against the JAX package's, and its own
invariants.

Against the JAX package: the blend within one ulp; the random sampler's
frame keys (``fold_in``) exactly; a short session of each sampler against
``make_step_fn(backend='pallas')`` in interpret mode, continued on both
sides from one JAX state carried across. Frames cannot match bit for bit
(a one-ulp difference in a transcendental forks a path, see
``test_torch_walk``); the accumulated images are held under the walk's chunk
bounds. Measured (demo, 48x27, 2 spp a frame, depth 4, three frames
after the carried one): random sampler 0.69 % of pixels off by more than
1e-3, 99.2 % within 1e-5, mean |delta| 6.5e-5, segments 4.9e-4 apart;
stratified with hints 0.54 %, 99.4 %, 5.6e-5, 4.2e-4 apart.

Inside the port, bitwise: hinted (K2s) and hint-less (K2) sessions, a
static-cluster session (K1), stratified frames against offline renders
at ``sample_offset`` = i·spp, random frames against offline renders with
the folded key, a stripped adaptive tolerance against the fixed step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.progressive import state as jax_state
from raytracer_tpu.progressive import step as jax_step
from raytracer_tpu.render.options import DebugParams
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu_torch.progressive import state as pstate
from raytracer_tpu_torch.progressive import step as pstep
from raytracer_tpu_torch.render import api, megakernel
from raytracer_tpu_torch.render import flat_scan as fs
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.render.rng import fold_in
from raytracer_tpu_torch.scene import presets

W, H = 48, 27

MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3  # mean |delta|
MAX_SEG_REL = 6e-3  # segment totals


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Intra-op threads only contend between test workers, and with them
    PyTorch's exp and log were seen to return a thread's chunk off by
    1e-5..1e-4 (ROADMAP §C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def demo():
    scene, cam, *_ = presets.get_config("demo", W, H)
    return scene, cam


def step_fn(opts, **kw):
    return pstep.make_step_fn(W, H, kw.pop("spp", 2), opts, device="cpu",
                              **kw)


def fresh(key=5):
    return pstate.init_render_state(W, H, key, device="cpu")


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("render_count", [0, 1, 2, 7, 1000, 100_000])
@pytest.mark.parametrize("weight", [1.0, 0.7])
def test_accumulate_within_one_ulp_of_jax(render_count, weight):
    """``(prev·rc + new·w)/(rc + w)``, or ``new`` where rc <= 1; XLA may
    fuse the products into an FMA, so one ulp apart at most."""
    r = np.random.default_rng(render_count)
    prev = r.random((9, 13, 3), dtype=np.float32)
    new = r.random((9, 13, 3), dtype=np.float32)
    ref = np.asarray(jax_step.accumulate(prev, new, render_count, weight))
    got = pstep.accumulate(torch.from_numpy(prev), torch.from_numpy(new),
                           render_count, weight).numpy()
    assert ulps(got, ref).max() <= 1
    # in place, as the step runs it
    buf = torch.from_numpy(prev.copy())
    pstep.accumulate(buf, torch.from_numpy(new), render_count, weight,
                     out=buf)
    assert torch.equal(buf, torch.from_numpy(got))


def test_fold_in_matches_jax():
    """The random sampler's frame key: ``fold_in(key, frame)`` is
    Threefry-2x32 over the key data, equal to ``jax.random.fold_in`` on
    10,000 keys and frames (frame 0 and 2^31 - 1 among them)."""
    r = np.random.default_rng(3)
    kd = r.integers(0, 2**32, (10_000, 2), dtype=np.uint64).astype(np.uint32)
    frames = r.integers(0, 2**31, 10_000).astype(np.int32)
    frames[:2] = (0, 2**31 - 1)
    ref = np.asarray(jax.vmap(
        lambda k, f: jax.random.key_data(jax.random.fold_in(
            jax.random.wrap_key_data(k, impl="threefry2x32"), f))
    )(kd, frames))
    y0, y1 = fold_in((kd[:, 0], kd[:, 1]), frames)
    np.testing.assert_array_equal(np.stack([y0, y1], 1), ref)
    # a host int frame gives host ints
    assert fold_in((0, 5), 3) == tuple(
        int(v) for v in np.asarray(jax.random.fold_in(
            jax.random.PRNGKey(5), 3)))


def jax_opts(**kw):
    return JaxOptions(max_depth=4, backend="pallas", **kw)


def carried_session(sampler: str, hints: bool):
    """One frame on the JAX side, the state carried across, then three
    more frames on each side from it. Returns both states and segment
    totals."""
    j_scene, j_cam, *_ = jax_presets.get_config("demo", W, H)
    hint = dict(static_scene=j_scene, static_camera=j_cam) if hints else {}
    j_step = jax_step.make_step_fn(W, H, spp=2, opts=jax_opts(sampler=sampler),
                                   **hint)
    js = jax_state.init_render_state(W, H, jax.random.PRNGKey(5))
    js, _ = j_step(js, j_scene, j_cam, DebugParams.none())
    ps = pstate.render_state_from_numpy(
        np.asarray(js.accum), np.asarray(js.render_count),
        np.asarray(js.frame), np.asarray(js.key), device="cpu")
    scene, cam = demo()
    opts = TraceOptions(max_depth=4, sampler=sampler)
    p_hint = dict(static_scene=scene, static_camera=cam) if hints else {}
    p_step = step_fn(opts, **p_hint)
    js, j_segs = jax_step.run_frames(j_step, js, j_scene, j_cam, 3)
    ps, p_segs = pstep.run_frames(p_step, ps, scene, cam, 3)
    return js, ps, float(j_segs), p_segs, p_step


@pytest.mark.parametrize("sampler, hints", [("random", False),
                                            ("stratified", True)])
def test_session_matches_jax(sampler, hints):
    """Random sampler without hints (K2 on both sides), stratified with
    hints (K2s): counters, key and image continue alike."""
    js, ps, j_segs, p_segs, p_step = carried_session(sampler, hints)
    assert (ps.frame, ps.render_count) == (int(js.frame),
                                           int(js.render_count)) == (4, 4)
    assert ps.key == tuple(int(v) for v in np.asarray(js.key))
    assert (p_step.static_split is not None) == hints
    d = np.abs(ps.accum.numpy() - np.asarray(js.accum)).max(axis=-1)
    assert (d > 1e-3).mean() <= MAX_FORKED_SHARE
    assert (d <= 1e-5).mean() >= MIN_CLOSE_SHARE
    assert d.mean() <= MAX_MEAN_ABS
    assert abs(p_segs - j_segs) <= MAX_SEG_REL * j_segs


def test_hinted_session_bitwise_equals_hintless():
    """The static split (K2s) changes no frame of the hint-less (K2)
    session; a static cluster partition (K1, cluster_scan on) none
    either, with the segments equal."""
    scene, cam = demo()
    opts = TraceOptions(max_depth=4)
    fs.reset_launch_counts()
    plain = step_fn(opts)
    hinted = step_fn(opts, static_scene=scene, static_camera=cam)
    clustered = step_fn(dataclasses.replace(opts, cluster_scan=True),
                        static_scene=scene, static_camera=cam)
    assert plain.static_split is None and plain.static_cluster is None
    assert hinted.static_split is not None
    assert clustered.static_cluster is not None
    a, sa = pstep.run_frames(plain, fresh(), scene, cam, 2)
    b, sb = pstep.run_frames(hinted, fresh(), scene, cam, 2)
    c, sc = pstep.run_frames(clustered, fresh(), scene, cam, 2)
    assert torch.equal(a.accum, b.accum) and sa == sb
    assert torch.equal(a.accum, c.accum) and sa == sc


def test_stratified_frames_are_offline_chunks():
    """With ``should_average=False`` frame i of a stratified session is
    the offline render of samples [i·spp, (i+1)·spp) with the session
    key, bit for bit."""
    scene, cam = demo()
    opts = TraceOptions(max_depth=4, sampler="stratified")
    step = step_fn(opts, should_average=False)
    state = fresh()
    for i in range(3):
        state, _ = step(state, scene, cam)
        offline = api.render_image(scene, cam, W, H, 2, 5, opts,
                                   device="cpu", sample_offset=2 * i)
        assert torch.equal(state.accum, offline), i


def test_random_frames_are_offline_renders_with_folded_keys():
    """Frame i of a random-sampler session is the offline render with the
    key data ``fold_in(key, i)``, bit for bit, and the running average
    blends the frames as ``accumulate`` does."""
    scene, cam = demo()
    opts = TraceOptions(max_depth=4)
    state, _ = pstep.run_frames(step_fn(opts), fresh(), scene, cam, 3)
    key = fresh().key
    frames = [api.render_image(scene, cam, W, H, 2, fold_in(key, i), opts,
                               device="cpu") for i in range(3)]
    want = frames[0].clone()
    for i in (1, 2):
        pstep.accumulate(want, frames[i], i + 1, out=want)
    assert torch.equal(state.accum, want)


@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_progressive_strips_adaptive(sampler):
    """An adaptive tolerance is an offline mode: the step strips it and
    renders exactly the fixed step's frames, sampler kept."""
    scene, cam = demo()
    fixed = TraceOptions(max_depth=4, sampler=sampler)
    adaptive = dataclasses.replace(fixed, adaptive_tolerance=0.05)
    a, sa = pstep.run_frames(step_fn(adaptive), fresh(), scene, cam, 2)
    b, sb = pstep.run_frames(step_fn(fixed), fresh(), scene, cam, 2)
    assert torch.equal(a.accum, b.accum) and sa == sb


def test_reset_keeps_the_frame_count():
    scene, cam = demo()
    step = step_fn(TraceOptions(max_depth=2))
    state, _ = pstep.run_frames(step, fresh(), scene, cam, 2)
    reset = pstate.reset_accumulation(state)
    assert (reset.frame, reset.render_count) == (2, 0)
    assert not reset.accum.any() and reset.key == state.key
    after, _ = step(reset, scene, cam)
    assert (after.frame, after.render_count) == (3, 1)
    # the first frame after a reset replaces the average: it is frame 2
    # of a session that renders straight through
    whole, _ = pstep.run_frames(step_fn(TraceOptions(max_depth=2),
                                        should_average=False),
                                fresh(), scene, cam, 3)
    assert torch.equal(after.accum, whole.accum)


def test_render_count_clamps():
    scene, cam = demo()
    step = step_fn(TraceOptions(max_depth=2), max_render_count=2)
    state, _ = pstep.run_frames(step, fresh(), scene, cam, 4)
    assert (state.frame, state.render_count) == (4, 2)


def test_save_load_round_trip(tmp_path):
    """Save and load keep every field bit for bit; a state the JAX
    package saved loads into the port, and one the port saved into the
    JAX package."""
    scene, cam = demo()
    state, _ = pstep.run_frames(step_fn(TraceOptions(max_depth=2)), fresh(7),
                                scene, cam, 2)
    path = tmp_path / "port.npz"
    pstate.save_render_state(path, state)
    back = pstate.load_render_state(path, device="cpu")
    assert torch.equal(back.accum, state.accum)
    assert (back.render_count, back.frame, back.key) == (
        state.render_count, state.frame, state.key)
    j = jax_state.load_render_state(str(path))
    np.testing.assert_array_equal(np.asarray(j.accum), state.accum.numpy())
    assert (int(j.frame), int(j.render_count)) == (2, 2)
    np.testing.assert_array_equal(np.asarray(j.key), np.asarray(state.key))

    r = np.random.default_rng(0)
    js = jax_state.RenderState(
        accum=jax.numpy.asarray(r.random((H, W, 3), dtype=np.float32)),
        render_count=jax.numpy.asarray(11, jax.numpy.int32),
        frame=jax.numpy.asarray(12, jax.numpy.int32),
        key=jax.random.fold_in(jax.random.PRNGKey(3), 4),
    )
    jpath = tmp_path / "jax.npz"
    jax_state.save_render_state(str(jpath), js)
    got = pstate.load_render_state(jpath, device="cpu")
    np.testing.assert_array_equal(got.accum.numpy(), np.asarray(js.accum))
    assert (got.render_count, got.frame) == (11, 12)
    assert got.key == tuple(int(v) for v in np.asarray(js.key))


def test_run_frames_sums_the_steps():
    scene, cam = demo()
    step = step_fn(TraceOptions(max_depth=3))
    state, total = pstep.run_frames(step, fresh(), scene, cam, 2)
    s, per = fresh(), []
    for _ in range(2):
        s, aux = step(s, scene, cam)
        per.append(int(aux["segments"]))
    assert total == sum(per) >= 2 * W * H * 2
    assert pstep.run_frames(step, s, scene, cam, 0)[1] == 0


def test_step_defaults_to_cuda(monkeypatch):
    """The step and the state live on CUDA unless the CPU is named, and
    raise where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pstep.make_step_fn(W, H)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pstate.init_render_state(W, H)
    step = step_fn(TraceOptions(max_depth=2))
    scene, cam = demo()
    meta = dataclasses.replace(fresh(), accum=torch.zeros((H, W, 3),
                                                          device="meta"))
    with pytest.raises(ValueError, match="state.accum is on"):
        step(meta, scene, cam)
    with pytest.raises(ValueError, match="spp"):
        pstep.make_step_fn(W, H, 0, device="cpu")


def test_default_cuda_device_gets_its_index(monkeypatch):
    """``torch.device('cuda') != torch.device('cuda:0')``: the default CUDA
    device resolves to its index, so a step built without a device takes
    the states that ``init_render_state`` puts there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert api.resolve_device() == torch.device("cuda", 0)
    assert api.resolve_device("cuda") == torch.device("cuda", 0)
    assert api.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert api.resolve_device("cpu") == torch.device("cpu")


def test_session_uses_the_flat_scan():
    """A hint-less demo session renders through K2, a hinted one through
    K2s (counted on the kernel choice; the CPU runs the plain version)."""
    scene, cam = demo()
    opts = TraceOptions(max_depth=2)
    hinted = step_fn(opts, static_scene=scene, static_camera=cam)
    choice = megakernel.choose_kernel(scene, api.to_derived(cam), opts,
                                      "cpu", static_split=hinted.static_split,
                                      analyse=False)
    assert choice.kernel == "flat_scan" and choice.g_full == 8
    bare = megakernel.choose_kernel(scene, api.to_derived(cam), opts, "cpu",
                                    analyse=False)
    assert bare.kernel == "flat_scan" and bare.g_full is None
