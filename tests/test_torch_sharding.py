"""The port's sharded renders and progressive step (``parallel/``) on gloo
ranks on the CPU, against the single-device port: the counterparts of
``tests/test_sharding.py``'s kernel-path cases.

Each mesh is spawned once per module (``run_ranks``: 4 ranks, then 2)
and runs every case; the tests read the ranks' results. The
single-device references run in this process, at one torch thread as the
ranks do.

Bitwise, as ``render_image``: a rows-only render whose band schedule is
the single render's (one chunk at these sizes, or the same forced
chunks), its sorted and unsorted forms, the split scan, the adaptive
render, interleaved against contiguous (sorted and adaptive), the
rows-only progressive step (both samplers). With an spp axis the sums
regroup (each shard sums its own samples, then the all-reduce adds the
shards), so the image is held to max |Δ| ≤ 1e-6 (measured 6.0e-8 at 4
spp, on 7.4 % of pixels, and 1.2e-7 at 18 spp sorted; the step's two
samples, one a shard, happen to add in the single step's order); every
fixed-spp render's exact segment total equals the single render's.
"""

import contextlib
import dataclasses
import hashlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracer_tpu_torch.parallel import (
    dryrun_multichip,
    gather_rows,
    make_mesh,
    make_sharded_step_fn,
    render_image_sharded,
    render_image_sharded_pallas,
    run_ranks,
    shard_render_state,
)
from raytracer_tpu_torch.parallel import sharding
from raytracer_tpu_torch.progressive import state as pstate
from raytracer_tpu_torch.progressive import step as pstep
from raytracer_tpu_torch.render import api, megakernel, schedule
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.render.rng import fold_in, key_data
from raytracer_tpu_torch.render.tracer import render_image_jnp
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.materials import Material
from raytracer_tpu_torch.scene.spheres import make_scene

W, H = 64, 32
TALL = 128  # rows=2 -> 64-row bands of two 32-row blocks
REGROUP_MAX_ABS = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def forced_chunks(chunk: int, min_n: int | None = None):
    """A multi-chunk schedule at test size (and a lower adaptive floor)."""
    real = schedule.pick_chunk_spp, schedule.ADAPTIVE_MIN_N
    schedule.pick_chunk_spp = lambda spp, *a, **k: min(spp, chunk)
    if min_n is not None:
        schedule.ADAPTIVE_MIN_N = min_n
    try:
        yield
    finally:
        schedule.pick_chunk_spp, schedule.ADAPTIVE_MIN_N = real


def two_sphere(h: int = H):
    scene, cam, *_ = presets.get_config("two_sphere", W, h)
    return scene, cam


def split_scene():
    """A scene whose flat scan splits (tests/test_sharding.py's)."""
    return make_scene([
        ((0, -1000, 0), 1000.0, Material.diffuse((0.5, 0.5, 0.5))),
        ((0, 1, 0), 1.0, Material.glass(1.5)),
        ((0, 1, 0), -0.45, Material.glass(1.5)),
        ((4, 3, 0), 1.0, Material.metal((0.7, 0.6, 0.5), 0.0)),
        ((8, 5, 0), 1.0, Material.diffuse((0.4, 0.2, 0.1))),
        ((-8, 5, 0), 1.0, Material.metal((0.7, 0.7, 0.7), 0.1)),
        ((-8, 9, 0), 1.0, Material.diffuse((0.1, 0.4, 0.2))),
        ((12, 9, 4), 1.0, Material.diffuse((0.2, 0.1, 0.4))),
        ((12, 9, -4), 1.0, Material.metal((0.5, 0.5, 0.6), 0.0)),
        ((-12, 9, 4), 1.0, Material.diffuse((0.3, 0.3, 0.1))),
        ((0, 3, -4), 1.0, Material.diffuse((0.6, 0.2, 0.2))),
    ])


def digest(choice) -> tuple:
    """The chosen kernel and a hash of its tables' bytes."""
    h = hashlib.sha256()
    for f in dataclasses.fields(choice.tables):
        v = getattr(choice.tables, f.name)
        if isinstance(v, torch.Tensor):
            h.update(v.contiguous().numpy().tobytes())
    return choice.kernel, choice.g_full, h.hexdigest()


def choices():
    """Kernel choices of the cover (cluster walk) and the split scene."""
    opts = TraceOptions(max_depth=4)
    out = []
    for scene, cam in (presets.get_config("cover", W, H)[:2],
                       (split_scene(), presets.simple_camera(W, H))):
        out.append(digest(megakernel.choose_kernel(
            scene, api.to_derived(cam), opts, "cpu")))
    return out


def steps(step, state, scene, cam, frames: int):
    segs = []
    for _ in range(frames):
        state, aux = step(state, scene, cam)
        segs.append(int(aux["segments"]))
    return state, segs


def caught(fn, *args, **kw) -> str:
    """``'<error type>: <message>'`` of what ``fn`` raises, or ''."""
    try:
        fn(*args, **kw)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


# --- the ranks' work ------------------------------------------------------

def world4() -> dict:
    """Every case of the 4-rank world: a (2, 2) and a (4,) mesh."""
    m22 = make_mesh((2, 2), device="cpu")
    m4 = make_mesh((4,), ("rows",), device="cpu")
    scene, cam = two_sphere()
    opts = TraceOptions(max_depth=4)
    got = {"coords": (m22.index("rows"), m22.index("spp"), m4.index("rows")),
           "shape": (m22.shape, m4.shape), "choices": choices()}

    def render(mesh, spp, o=opts, sc=scene, c=cam, h=H):
        return render_image_sharded_pallas(sc, c, W, h, spp, 0, mesh, o,
                                           return_stats=True)

    got["r22"], got["r4"] = render(m22, 4), render(m4, 4)
    with forced_chunks(2):
        got["sorted22"] = render(m22, 18)
        got["unsorted22"] = render(m22, 18, dataclasses.replace(
            opts, sort_pixels=False))
        got["sorted4"] = render(m4, 9)
        got["unsorted4"] = render(m4, 9, dataclasses.replace(
            opts, sort_pixels=False))
        got["stratified4"] = render(m4, 9, dataclasses.replace(
            opts, sampler="stratified"))
    got["debug4"] = render(m4, 2, dataclasses.replace(opts,
                                                      enable_debug=True))
    got["plain4"] = render(m4, 2)
    got["noop4"] = render(m4, 2, dataclasses.replace(opts,
                                                     interleave_rows=True))
    cover, ccam, *_ = presets.get_config("cover", W, H)
    seen, real = [], schedule.pick_chunk_spp

    def spy(spp, p, s_count, *a, **k):
        seen.append(s_count)
        return real(spp, p, s_count, *a, **k)

    schedule.pick_chunk_spp = spy
    try:
        render(m22, 4, dataclasses.replace(opts, cluster_scan=True),
               sc=cover, c=ccam)
    finally:
        schedule.pick_chunk_spp = real
    got["chunk_counts"] = (cover.count, seen)
    demo, dcam, *_ = presets.get_config("demo", W, H)
    got["demo_flat22"] = render(m22, 4, sc=demo, c=dcam)
    got["demo_cluster22"] = render(m22, 4, dataclasses.replace(
        opts, cluster_scan=True), sc=demo, c=dcam)

    sopts = TraceOptions(max_depth=3)
    for name, o in (("random", sopts),
                    ("stratified", dataclasses.replace(
                        sopts, sampler="stratified"))):
        step = make_sharded_step_fn(W, H, m4, spp=1, opts=o)
        st = shard_render_state(pstate.init_render_state(W, H, 0, device="cpu"),
                                m4)
        st, segs = steps(step, st, scene, cam, 2)
        got[f"step4_{name}"] = (gather_rows(st.accum, m4), segs, st.frame,
                                st.render_count)
    step = make_sharded_step_fn(W, H, m22, spp=2, opts=sopts)
    st = shard_render_state(pstate.init_render_state(W, H, 0, device="cpu"), m22)
    st, segs = steps(step, st, scene, cam, 1)
    got["step22"] = (gather_rows(st.accum, m22), segs)
    sc, scam = split_scene(), presets.simple_camera(W, H)
    hinted = make_sharded_step_fn(W, H, m4, spp=1, opts=sopts,
                                  static_scene=sc, static_camera=scam)
    plain = make_sharded_step_fn(W, H, m4, spp=1, opts=sopts)
    got["hint"] = hinted.static_split is not None
    for name, step in (("hinted", hinted), ("plain", plain)):
        st = shard_render_state(pstate.init_render_state(W, H, 0, device="cpu"),
                                m4)
        st, segs = steps(step, st, sc, scam, 2)
        got[f"split_{name}"] = (gather_rows(st.accum, m4), segs)

    got["errors"] = {
        "world": caught(make_mesh, (2,), ("rows",), device="cpu"),
        "height": caught(render_image_sharded_pallas, scene, cam, W, 30, 2,
                         0, m4, opts),
        "rows8": caught(render_image_sharded_pallas, scene, cam, W, 36, 2,
                        0, m4, opts),
        "spp": caught(render_image_sharded_pallas, scene, cam, W, H, 3, 0,
                      m22, opts),
        "step_height": caught(make_sharded_step_fn, W, 30, m4),
        "step_rows8": caught(make_sharded_step_fn, W, 36, m4),
        "step_spp": caught(make_sharded_step_fn, W, H, m22, spp=3),
    }
    # the jnp tracer's paths: the step with backend 'jnp' or the overlay
    # (one frame each), the sharded render
    for name, o in (("step_jnp", dataclasses.replace(sopts, backend="jnp")),
                    ("step_debug", dataclasses.replace(sopts,
                                                       enable_debug=True))):
        step = make_sharded_step_fn(W, H, m4, spp=1, opts=o)
        st = shard_render_state(pstate.init_render_state(W, H, 0, device="cpu"),
                                m4)
        st, segs = steps(step, st, scene, cam, 1)
        got[name] = (gather_rows(st.accum, m4), segs)
    got["jnp22"] = render_image_sharded(
        scene, cam, W, H, 4, 0, m22, dataclasses.replace(opts, backend="jnp"),
        return_stats=True)
    return got


def world2() -> dict:
    """Every case of the 2-rank world: a (2,) rows mesh on 64-row bands
    (interleave, adaptive) and the split scan."""
    mesh = make_mesh((2,), ("rows",), device="cpu")
    scene, cam = two_sphere(TALL)
    got = {}
    opts = TraceOptions(max_depth=3)
    for name, o in (("contiguous", opts),
                    ("interleaved", dataclasses.replace(
                        opts, interleave_rows=True))):
        with forced_chunks(2):
            got[f"sorted_{name}"] = render_image_sharded_pallas(
                scene, cam, W, TALL, 9, 0, mesh, o, return_stats=True)
        with forced_chunks(3, min_n=4):
            got[f"adaptive_{name}"] = render_image_sharded_pallas(
                scene, cam, W, TALL, 27, 0, mesh, dataclasses.replace(
                    o, adaptive_tolerance=0.05), return_stats=True)
    got["split"] = render_image_sharded_pallas(
        split_scene(), presets.simple_camera(W, H), W, H, 2, 0, mesh,
        TraceOptions(max_depth=4), return_stats=True)
    got["collectives"] = collectives(make_mesh((2, 1), device="cpu"), mesh)
    return got


def collectives(m21, m2) -> dict:
    """The process group's collectives each mesh call issues, and what
    it returns: the (2, 1) mesh's size-1 spp axis and its rows axis, the
    (2,) mesh's absent spp axis."""
    issued = []
    real = dist.all_reduce, dist.all_gather
    dist.all_reduce = lambda *a, **k: (issued.append("all_reduce"),
                                       real[0](*a, **k))[1]
    dist.all_gather = lambda *a, **k: (issued.append("all_gather"),
                                       real[1](*a, **k))[1]
    rank = torch.tensor([float(dist.get_rank() + 1)])
    got = {}
    try:
        for name, mesh, axis in (("size1", m21, "spp"),
                                 ("rows", m21, "rows"),
                                 ("absent", m2, "spp")):
            issued.clear()
            summed = mesh.all_reduce(axis, rank.clone())
            gathered = mesh.all_gather(axis, rank)
            got[name] = (list(issued), summed, gathered)
    finally:
        dist.all_reduce, dist.all_gather = real
    return got


@pytest.fixture(scope="module")
def ranks4():
    return run_ranks(world4, 4)


@pytest.fixture(scope="module")
def ranks2():
    return run_ranks(world2, 2)


@pytest.fixture(scope="module")
def single():
    """The single-device port's renders and steps of the same cases."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, cam = two_sphere()
        opts = TraceOptions(max_depth=4)

        def render(spp, o=opts, sc=scene, c=cam, h=H):
            return api.render_image(sc, c, W, h, spp, 0, o,
                                    return_stats=True, device="cpu")

        got = {"r4": render(4), "plain2": render(2), "choices": choices()}
        with forced_chunks(2):
            got["sorted18"] = render(18)
            got["sorted9"] = render(9)
            got["stratified9"] = render(9, dataclasses.replace(
                opts, sampler="stratified"))
            got["tall_sorted"] = render(9, TraceOptions(max_depth=3),
                                        *two_sphere(TALL), TALL)
        with forced_chunks(3, min_n=4):
            got["tall_adaptive"] = render(27, TraceOptions(
                max_depth=3, adaptive_tolerance=0.05), *two_sphere(TALL),
                TALL)
        got["split"] = render(2, sc=split_scene(),
                              c=presets.simple_camera(W, H))
        sopts = TraceOptions(max_depth=3)
        for name, o in (("random", sopts),
                        ("stratified", dataclasses.replace(
                            sopts, sampler="stratified"))):
            st = pstate.init_render_state(W, H, 0, device="cpu")
            step = pstep.make_step_fn(W, H, 1, o, device="cpu")
            got[f"step_{name}"] = steps(step, st, scene, cam, 2)
        st = pstate.init_render_state(W, H, 0, device="cpu")
        got["step2"] = steps(pstep.make_step_fn(W, H, 2, sopts,
                                                device="cpu"),
                             st, scene, cam, 1)
        return got
    finally:
        torch.set_num_threads(n)


def same(a, b) -> bool:
    """Images, and stats with their sample maps, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


# --- the mesh ---------------------------------------------------------------

def test_rank_coordinates_are_row_major(ranks4):
    """Rank r sits at (r // spp, r % spp), as JAX reshapes its devices."""
    assert [r["coords"] for r in ranks4] == [(0, 0, 0), (0, 1, 1),
                                             (1, 0, 2), (1, 1, 3)]
    assert ranks4[0]["shape"] == ({"rows": 2, "spp": 2}, {"rows": 4})


def test_mesh_needs_the_whole_world(ranks4):
    assert ranks4[0]["errors"]["world"].startswith(
        "ValueError: mesh (2,) needs 2 devices")


@pytest.mark.parametrize("case,issued,summed,gathered", [
    # a (2, 1) mesh's spp axis: one rank a group, and still a collective
    ("size1", ["all_reduce", "all_gather"], [1.0, 2.0], [[1.0], [2.0]]),
    ("rows", ["all_reduce", "all_gather"], [3.0, 3.0],
     [[1.0, 2.0], [1.0, 2.0]]),
    # the (2,) mesh has no spp axis: nothing moves
    ("absent", [], [1.0, 2.0], [[1.0], [2.0]]),
])
def test_collectives_run_on_every_axis_the_mesh_has(ranks2, case, issued,
                                                    summed, gathered):
    for r, rank in enumerate(ranks2):
        got_issued, got_summed, got_gathered = rank["collectives"][case]
        assert got_issued == issued
        assert float(got_summed) == summed[r]
        assert [float(t) for t in got_gathered] == gathered[r]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1,), ("rows",), device="cpu")


def test_make_mesh_axes_are_checked():
    with pytest.raises(ValueError, match="axis sizes"):
        make_mesh((2, 2), ("rows",), device="cpu")
    with pytest.raises(ValueError, match="'rows'"):
        make_mesh((2,), ("x",), device="cpu")


def test_tables_equal_on_every_rank(ranks4, single):
    """Every rank builds the single device's partition and split."""
    kinds = [c[0] for c in single["choices"]]
    assert kinds == ["cluster_walk", "flat_scan"]
    assert single["choices"][1][1] is not None  # the split engaged
    for r in ranks4:
        assert r["choices"] == single["choices"]


# --- the render -------------------------------------------------------------

@pytest.mark.parametrize("case", ["r22", "r4", "sorted4", "debug4",
                                  "demo_cluster22"])
def test_every_rank_holds_the_whole_image(ranks4, case):
    img, stats = ranks4[0][case]
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    for r in ranks4[1:]:
        assert same(r[case], ranks4[0][case])


def test_rows_only_render_bitwise_single(ranks4, single):
    """One chunk per band and per image: the same sums."""
    assert same(ranks4[0]["r4"], single["r4"])


def test_rows_spp_render_matches_single(ranks4, single):
    img, stats = ranks4[0]["r22"]
    ref, ref_stats = single["r4"]
    assert float((img - ref).abs().max()) <= REGROUP_MAX_ABS
    assert stats == ref_stats  # exact segments


@pytest.mark.parametrize("case,ref", [("sorted4", "sorted9"),
                                      ("stratified4", "stratified9")])
def test_rows_only_sorted_render_bitwise_single(ranks4, single, case, ref):
    """Chunks [1, 4, 4] in every band and in the image."""
    assert same(ranks4[0][case], single[ref])


@pytest.mark.parametrize("mesh", ["22", "4"])
def test_sorted_bitwise_unsorted(ranks4, mesh):
    assert same(ranks4[0][f"sorted{mesh}"], ranks4[0][f"unsorted{mesh}"])


def test_rows_spp_sorted_segments_exact(ranks4, single):
    img, stats = ranks4[0]["sorted22"]
    ref, ref_stats = single["sorted18"]
    assert stats["segments_exact"] == ref_stats["segments_exact"]
    assert float((img - ref).abs().max()) <= REGROUP_MAX_ABS


def test_debug_dropped(ranks4):
    assert same(ranks4[0]["debug4"], ranks4[0]["plain4"])


def test_interleave_noop_one_block_per_band(ranks4):
    """8-row bands hold one block, and a single chunk never sorts."""
    assert same(ranks4[0]["noop4"], ranks4[0]["plain4"])


def test_cluster_walk_bitwise_flat_scan(ranks4):
    assert same(ranks4[0]["demo_cluster22"], ranks4[0]["demo_flat22"])


@pytest.mark.parametrize("opts,want", [
    (TraceOptions(max_depth=4), (2, True, None)),
    (TraceOptions(max_depth=4, sort_pixels=False), (2, False, None)),
    (TraceOptions(max_depth=4, adaptive_tolerance=0.1),
     (2, True, [1, 4, 4])),
    (TraceOptions(max_depth=4, adaptive_tolerance=0.1,
                  adaptive_chunk_spp=1), (2, True, [1, 2, 2, 2, 2])),
    (TraceOptions(max_depth=4, adaptive_tolerance=0.1, enable_debug=True),
     (2, True, None)),
    (TraceOptions(max_depth=4, adaptive_tolerance=0.1, sort_pixels=False),
     (2, False, None)),
])
def test_render_schedule_is_the_one_decision(opts, want):
    """The schedule render_sums and the sharded render both take: the
    fixed chunk, sorting, and adaptive sizes only with a sorted uniform
    multi-chunk schedule and without the overlay."""
    with forced_chunks(2):
        got = schedule.render_schedule(9, W * H, 2, opts)
    assert (got.chunk, got.sort, got.adaptive) == want


def test_cluster_schedule_sees_the_original_slot_count(ranks4):
    """The bands' schedule is fed the cover's own 487 slots, never the
    padded partition's (the sums' grouping would shift)."""
    count, seen = ranks4[0]["chunk_counts"]
    assert count == 487 and seen and set(seen) == {count}


def test_split_scan_bitwise_single(ranks2, single):
    assert same(ranks2[0]["split"], single["split"])


@pytest.mark.parametrize("path", ["sorted", "adaptive"])
def test_interleaved_bitwise_contiguous(ranks2, path):
    """The image, the sample map and the segments; the mean spp is the
    mean of the bands' float64 means, whose bands now hold other pixels
    (equal here: 4096-pixel bands divide exactly)."""
    (a, sa), (b, sb) = (ranks2[0][f"{path}_contiguous"],
                        ranks2[0][f"{path}_interleaved"])
    sa, sb = dict(sa), dict(sb)
    assert torch.equal(a, b)
    mean, mean_b = sa.pop("mean_spp", 0.0), sb.pop("mean_spp", 0.0)
    assert same(sa, sb) and mean == pytest.approx(mean_b, rel=1e-12)
    assert same(ranks2[1][f"{path}_interleaved"],
                ranks2[0][f"{path}_interleaved"])


@pytest.mark.parametrize("path", ["sorted", "adaptive"])
def test_tall_rows_render_bitwise_single(ranks2, single, path):
    """64-row bands at the single render's forced schedule, the adaptive
    one with its stops: the image, the sample map and the segments; the
    mean spp as the mean of the bands' means."""
    (img, stats), (ref, ref_stats) = (ranks2[0][f"{path}_interleaved"],
                                      single[f"tall_{path}"])
    assert torch.equal(img, ref)
    stats, ref_stats = dict(stats), dict(ref_stats)
    mean = stats.pop("mean_spp", None)
    ref_mean = ref_stats.pop("mean_spp", None)
    assert same(stats, ref_stats)
    if path == "adaptive":
        assert mean < 27.0 and mean == pytest.approx(ref_mean, rel=1e-12)


def test_interleave_inverse_matches_the_jax_map():
    """``sharding.py:452-459`` of the JAX package, replicated in numpy."""
    for height, rows, g in ((128, 2, 32), (800, 4, 8), (96, 3, 16)):
        local_h = height // rows
        s = np.arange(height) // local_h
        u = np.arange(height) % local_h
        phys = (s + (u // g) * rows) * g + (u % g)
        want = np.empty(height, np.int64)
        want[phys] = np.arange(height)
        np.testing.assert_array_equal(
            sharding.interleave_inverse(height, rows, g), want)


def test_interleave_block_is_the_jax_tile():
    """``_shard_tile_params``: k_slots·r_sub, halved to divide the band."""
    assert [sharding.interleave_block(h) for h in (64, 200, 8, 48, 360)] == [
        32, 8, 8, 16, 8]


def test_band_rows_cover_the_image():
    for block in (None, 8):
        rows = torch.cat([sharding.band_rows(s, 4, 32, block)
                          for s in range(4)])
        assert sorted(rows.tolist()) == list(range(128))
    assert sharding.band_rows(1, 4, 32, 8)[:10].tolist() == [
        8, 9, 10, 11, 12, 13, 14, 15, 40, 41]


# --- the progressive step ---------------------------------------------------

@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_rows_only_step_bitwise_single(ranks4, single, sampler):
    accum, segs, frame, count = ranks4[0][f"step4_{sampler}"]
    ref_state, ref_segs = single[f"step_{sampler}"]
    assert torch.equal(accum, ref_state.accum)
    assert segs == ref_segs
    assert (frame, count) == (ref_state.frame, ref_state.render_count)


def test_rows_spp_step_matches_single(ranks4, single):
    accum, segs = ranks4[0]["step22"]
    ref_state, ref_segs = single["step2"]
    assert float((accum - ref_state.accum).abs().max()) <= REGROUP_MAX_ABS
    assert segs == ref_segs


def test_static_split_step_bitwise_hint_less(ranks4):
    assert ranks4[0]["hint"]
    assert same(ranks4[0]["split_hinted"], ranks4[0]["split_plain"])


def test_step_buffer_stays_a_band():
    """shard_render_state gives each rank its band; a step refuses the
    whole buffer."""
    st = pstate.init_render_state(W, H, 0, device="cpu")
    st.accum.copy_(torch.arange(H * W * 3, dtype=torch.float32)
                   .reshape(H, W, 3))

    class Rows:  # the two calls read a mesh's size, index and device
        device = torch.device("cpu")

        def __init__(self, index):
            self.i = index

        def size(self, axis):
            return 4 if axis == "rows" else 1

        def index(self, axis):
            return self.i if axis == "rows" else 0

    bands = [shard_render_state(st, Rows(i)).accum for i in range(4)]
    assert all(b.shape == (8, W, 3) for b in bands)
    assert torch.equal(torch.cat(bands), st.accum)
    bands[0].zero_()
    assert st.accum.abs().sum() > 0  # a copy, not a view
    step = make_sharded_step_fn(W, H, Rows(1), spp=1)
    with pytest.raises(ValueError, match="band"):
        step(st, *two_sphere())


# --- the rules of the JAX package's arguments -------------------------------

@pytest.mark.parametrize("case,message", [
    ("height", "height 30 must be divisible by rows*8 = 32"),
    # 36 rows split into four 9-row bands, but the JAX package's rows*8
    # rule holds: the port takes exactly the arguments it takes
    ("rows8", "height 36 must be divisible by rows*8 = 32"),
    ("spp", "spp 3 not divisible by spp axis 2"),
    ("step_height", "height 30 not divisible by rows axis 4"),
    ("step_rows8", "height 36 must be divisible by rows*8 = 32"),
    ("step_spp", "spp 3 not divisible by spp axis 2"),
])
def test_indivisible_shapes_raise(ranks4, case, message):
    got = ranks4[0]["errors"][case]
    assert got.startswith("ValueError: ") and message in got


@pytest.mark.parametrize("case", ["step_jnp", "step_debug"])
def test_jnp_step_paths(ranks4, case):
    """The sharded step with ``backend='jnp'`` or the overlay renders
    through the jnp tracer (the overlay at the default cursor, nothing
    selected): on the (4,) mesh its first frame is, band by band,
    ``render_image_jnp`` of that band under ``fold_in(fold_in(key, 0),
    rows coordinate)``, bit for bit."""
    accum, segs = ranks4[0][case]
    scene, cam = two_sphere()
    opts = TraceOptions(max_depth=3, backend="jnp",
                        enable_debug=case == "step_debug")
    lh = H // 4
    frame_key = fold_in(key_data(0), 0)
    bands = [render_image_jnp(scene, api.to_derived(cam), W, H, 1,
                              fold_in(frame_key, r), opts,
                              row_offset=r * lh, band_height=lh)
             for r in range(4)]
    assert torch.equal(accum, torch.cat(bands))
    assert segs[0] > W * H
    for r in ranks4[1:]:
        assert torch.equal(r[case][0], accum) and r[case][1] == segs


def test_jnp_render(ranks4):
    """``render_image_sharded`` on the (2, 2) mesh: every rank holds the
    whole image; each rows band is the mean of its two spp shards'
    ``render_image_jnp`` under ``fold_in(fold_in(key, row), spp)``,
    within float32 rounding of the regrouped sums."""
    img, stats = ranks4[0]["jnp22"]
    scene, cam = two_sphere()
    opts = TraceOptions(max_depth=4, backend="jnp", gamma=False)
    lh = H // 2
    bands = []
    for r in range(2):
        lin = sum(render_image_jnp(scene, api.to_derived(cam), W, H, 2,
                                   fold_in(fold_in(key_data(0), r), s), opts,
                                   row_offset=r * lh, band_height=lh)
                  for s in range(2)) * 0.5
        bands.append(torch.sqrt(torch.clamp_min(lin, 0.0)))
    assert float((img - torch.cat(bands)).abs().max()) <= REGROUP_MAX_ABS
    assert stats["segments_exact"] > W * H * 4
    for r in ranks4[1:]:
        assert torch.equal(r["jnp22"][0], img) and r["jnp22"][1] == stats


def test_dryrun_multichip():
    got = dryrun_multichip(4, device="cpu")
    assert got["mesh"] == {"rows": 2, "spp": 2}
    assert got["segments"] > 0 and got["pallas_progressive_segments"] > 0
    assert got["pallas_sharded"] == (16, 128, 3)
    assert got["pallas_sorted"] == got["pallas_cluster"] == (64, 128, 3)
    assert got["pallas_interleaved"] == (256, 128, 3)
    assert 1.0 <= got["pallas_adaptive_mean_spp"] <= 9.0
    assert got["odd_mesh"] == {"rows": 3}
    assert got["indivisible"] == "ValueError"
