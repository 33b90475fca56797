"""Tests of the port that need a CUDA card; each skips without one.

On the card, from the repository root (the suite's conftest imports jax,
which the port's machine need not have):

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.progressive import state as pstate
from raytracer_tpu_torch.progressive import step as pstep
from raytracer_tpu_torch.render import (
    adaptive_plan,
    api,
    megakernel,
    pallas_kernel,
    schedule,
    tables,
)
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import flat_scan as fs
from raytracer_tpu_torch.render.options import DebugParams, TraceOptions
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scripts import bench_bf16_chain as bc
from raytracer_tpu_torch.scripts import bench_scan_layout as bs
from raytracer_tpu_torch.scripts import probe_gather as pg
from raytracer_tpu_torch.scripts import walk_ab
from raytracer_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

W, H, SPP = 64, 32, 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def walk_inputs(device, rr=5, adaptive=False, stratified=False):
    scene, cam, *_ = presets.get_config("cover", W, H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=rr,
                        adaptive_tolerance=0.2 if adaptive else 0.0,
                        sampler="stratified" if stratified else "random")
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), device)
    return tabs, cw.identity_map(W, H, device), opts


@pytest.mark.parametrize("rr", [5, 0])
def test_kernel_matches_plain_on_card(card, rr):
    """Both round every operation alike (-fmad=false, the same libdevice):
    forked paths stay under chip_smoke.py's bounds (measured bitwise equal
    on an H100 at 256x128)."""
    tabs, ident, opts = walk_inputs(card, rr)
    args = (tabs, ident, 9, 0, SPP, W, H, opts)
    out_k, seg_k = cw.cluster_walk(*args)
    out_p, seg_p = cw.cluster_walk_plain(*args)
    d = (out_k[:3] - out_p[:3]).abs().amax(0)
    assert torch.isfinite(out_k).all()
    assert float((d > 1e-3).float().mean()) <= 0.005
    assert float(d.mean()) <= 1e-4
    sk, sp = int(seg_k.sum()), int(seg_p.sum())
    assert abs(sk - sp) <= 1e-3 * sp


@pytest.mark.parametrize("adaptive, stratified", [
    (False, True), (True, False), (True, True),
], ids=["stratified", "adaptive", "adaptive_stratified"])
def test_variant_matches_plain_on_card(card, adaptive, stratified):
    """The adaptive and stratified instantiations against the plain
    version at a nonzero sample offset, the adaptive ones under a budget
    that mixes 0 and the chunk's spp: the same bounds, the sample counts
    equal, and a lane without budget all zeros."""
    tabs, ident, opts = walk_inputs(card, 5, adaptive, stratified)
    budget = None
    if adaptive:
        g = torch.Generator().manual_seed(2)
        budget = (torch.where(torch.rand(W * H, generator=g) < 0.4, 0, SPP)
                  .to(torch.int32).to(card))
    args = (tabs, ident, 9, 6, SPP, W, H, opts, budget)
    out_k, seg_k = walk_ab.walk(*args)
    out_p, seg_p = cw.cluster_walk_plain(*args)
    assert out_k.shape == out_p.shape == (6 if adaptive else 4, W * H)
    d = (out_k[:3] - out_p[:3]).abs().amax(0)
    assert torch.isfinite(out_k).all()
    assert float((d > 1e-3).float().mean()) <= 0.005
    assert float(d.mean()) <= 1e-4
    sk, sp = int(seg_k.sum()), int(seg_p.sum())
    assert abs(sk - sp) <= 1e-3 * sp
    if adaptive:
        assert torch.equal(out_k[4], budget.float())
        assert torch.equal(out_k[4], out_p[4])
        assert not out_k[:, budget == 0].any()
        assert not seg_k[budget == 0].any()


@pytest.mark.parametrize("adaptive, stratified, debug", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, False), (False, False, True), (False, True, True),
], ids=["K1", "K1s", "K1a", "K1a+K1s", "K3_on_K1", "K3_on_K1s"])
def test_walk_instantiation_bitwise_on_card(card, adaptive, stratified,
                                            debug):
    """Each of the walk's six instantiations, with its culled box test,
    whole-bounce walk and persistent lanes, equals its plain version (the
    flat walk) bit for bit in every output row and segment count, at a
    nonzero sample offset; the adaptive ones under a budget that mixes 0
    and the chunk's spp, the debug ones with the cursor on the centre's
    surface."""
    scene, cam, *_ = presets.get_config("cover", W, H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                        adaptive_tolerance=0.2 if adaptive else 0.0,
                        sampler="stratified" if stratified else "random",
                        enable_debug=debug)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), card)
    ident = cw.identity_map(W, H, card)
    budget = dbg = None
    if adaptive:
        g = torch.Generator().manual_seed(3)
        budget = (torch.where(torch.rand(W * H, generator=g) < 0.4, 0, SPP)
                  .to(torch.int32).to(card))
    if debug:
        from raytracer_tpu_torch.interact.picking import update_cursor_state

        _, point, sel = update_cursor_state(scene.to(card), cam)
        dbg = DebugParams(point, sel)
    args = (tabs, ident, 9, 6, SPP, W, H, opts, budget, dbg)
    out_k, seg_k = walk_ab.walk(*args)
    out_p, seg_p = cw.cluster_walk_plain(*args)
    assert torch.equal(out_k, out_p)
    assert torch.equal(seg_k, seg_p)


@pytest.fixture(scope="module")
def item_cases():
    """``walk_ab.item_cases`` for K1a and K1a+K1s, built once for the
    module (each runs the cover's adaptive render at 1200x800)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return {stratified: walk_ab.item_cases(stratified)
            for stratified in (False, True)}


ITEM_CASES = [f"launch {j}" for j in walk_ab.ITEM_LAUNCHES] + [
    "whole lanes", "under cap", "over cap", "none live", "one live",
    "shuffled"]


@pytest.mark.parametrize("case", ITEM_CASES)
@pytest.mark.parametrize("stratified", [False, True],
                         ids=["K1a", "K1a+K1s"])
def test_adaptive_walk_items_bitwise_on_card(item_cases, stratified, case):
    """A narrow adaptive launch deals one-sample items, a wide one whole
    lanes: every output row, the segments and their total bit for bit
    those of the plain walk, on the cover's own re-planned launches, on
    its whole frame at their settings with samples past the item scratch
    (whole lanes), with the live lanes' samples just under the item
    scratch (items) and just over it (whole lanes), with no live lane and
    one, and on a shuffled
    map whose budgets run from 0 to the chunk's; the kernel's sample
    counts are those of the items and of every lane."""
    args = item_cases[stratified][case]
    budget = args[8]
    profiling.reset_counters()
    out_k, seg_k = walk_ab.walk(*args)
    got = profiling.counters()
    out_p, seg_p = walk_ab.live_lanes_plain(args)
    assert torch.equal(out_k, out_p)
    assert torch.equal(seg_k, seg_p)
    assert int(seg_k.sum(dtype=torch.int64)) == int(
        seg_p.sum(dtype=torch.int64))
    items, every = walk_ab.expected_samples(budget)
    if every == 0:
        assert "walk_samples" not in got
    else:
        assert got["walk_item_samples"] == (items, 0.0)
        assert got["walk_samples"] == (every, 0.0)
    if case == "under cap":
        assert items == every > 0
    if case in ("whole lanes", "over cap"):
        assert items == 0 < every


# a process whose first adaptive launch has a budget
FIRST_LAUNCH = """
import sys
import torch
from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.render import cluster_walk as cw, tables
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import presets

dev = torch.device("cuda")
w, h, spp = 64, 32, 8
scene, cam, *_ = presets.get_config("cover", w, h)
opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                    adaptive_tolerance=0.2, sampler=sys.argv[1])
tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                          derive_camera(cam), dev)
g = torch.Generator().manual_seed(3)
budget = torch.randint(0, spp + 1, (w * h,), generator=g)
args = (tabs, cw.identity_map(w, h, dev), 9, 6, spp, w, h, opts,
        budget.to(torch.int32).to(dev), None)
out_k, seg_k = cw.cluster_walk(*args, extent=cw.live_extent(args[8]))
out_p, seg_p = cw.cluster_walk_plain(*args)
print("live", int((out_k[4] > 0).sum()), "bitwise",
      torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p))
"""


@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_budgeted_adaptive_launch_first_in_a_process_on_card(card, sampler):
    """A fresh process whose first adaptive launch has a budget (so the
    launch also makes the sample counts' buffer and the item scratch
    after its caller worked out the live extent) runs its items bit for
    bit the plain walk."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", FIRST_LAUNCH, sampler],
                          cwd=root, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    words = proc.stdout.split()
    assert words[-2:] == ["bitwise", "True"], proc.stdout
    assert int(words[1]) > 0


def test_live_extent_held_through_the_launch_on_card(card):
    """The live extent an adaptive launch reads is the one its caller
    holds until the launch is enqueued (freed before, the caching
    allocator may give its block to the next allocation on the stream,
    which overwrites it before the kernel reads it): the launch passes
    that tensor, and refuses a budget without one, or one without a
    budget, rather than work one out that it would free."""
    launch = cw._lib()
    seen = []

    def fn(*args):
        seen.append(args[6])
        return launch(*args)

    tabs, ident, opts = walk_inputs(card, adaptive=True)
    budget = torch.randint(0, SPP + 1, (W * H,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))
    args = (tabs, ident, 9, 6, SPP, W, H, opts, budget.to(card), None)
    extent = cw.live_extent(args[8])
    out_k, seg_k = cw.call(fn, *args, extent)
    assert seen == [extent.data_ptr()]
    with pytest.raises(ValueError, match="live extent"):
        cw.call(fn, *args)
    with pytest.raises(ValueError, match="live extent"):
        cw.call(fn, *args[:8], None, None, extent)
    assert len(seen) == 1
    out_p, seg_p = cw.cluster_walk_plain(*args)
    assert torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)


@pytest.mark.parametrize("group", [8, 4])
@pytest.mark.parametrize("stratified", [False, True],
                         ids=["random", "stratified"])
def test_walk_bitwise_past_32_clusters_on_card(card, group, stratified):
    """The cover in clusters of 8 and 4 (61 and 121) takes the walk's
    four-word box mask; bit for bit its plain version."""
    scene, cam, *_ = presets.get_config("cover", W, H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                        cluster_group=group,
                        sampler="stratified" if stratified else "random")
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), card)
    assert tabs.bounds.shape[0] > 32
    args = (tabs, cw.identity_map(W, H, card), 9, 6, SPP, W, H, opts)
    out_k, seg_k = cw.cluster_walk(*args)
    out_p, seg_p = cw.cluster_walk_plain(*args)
    assert torch.equal(out_k, out_p)
    assert torch.equal(seg_k, seg_p)


@pytest.fixture(scope="module")
def flake_cases():
    """``walk_ab.flake_cases``: the wide walk on the SPD sphereflake,
    built once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return walk_ab.flake_cases()


FLAKE_CASES = list(walk_ab.VARIANTS) + [
    f"{name} whole lanes" for name, (adaptive, _, _) in
    walk_ab.VARIANTS.items() if adaptive]


@pytest.mark.parametrize("case", FLAKE_CASES)
def test_wide_walk_bitwise_on_card(flake_cases, case):
    """The wide walk (462 clusters: 9 key bits, grandparent boxes, masks
    in shared memory, winner rows in global memory): each instantiation
    on a grid of the sphereflake's 512x512 at depth 50, and the adaptive
    ones on a sparse live set of the whole frame (whole lanes), every
    output row and segment count bit for bit its plain version's."""
    args = flake_cases[case]
    before = cw.cluster_walk.launches_by_variant.get("cluster_walk_wide"
                                                     + cw.variant_suffix(
                                                         args[7]), 0)
    out_k, seg_k = walk_ab.walk(*args)
    out_p, seg_p = walk_ab.live_lanes_plain(args)
    assert torch.equal(out_k, out_p)
    assert torch.equal(seg_k, seg_p)
    assert cw.cluster_walk.launches_by_variant[
        "cluster_walk_wide" + cw.variant_suffix(args[7])] == before + 1


def test_wide_walk_counts_iterations_and_bounces_on_card(flake_cases):
    """The wide walk's device counts are its cost row's and its
    segments' sums, and it counts its bounces that swept."""
    args = flake_cases["cluster_walk"]
    profiling.reset_counters()
    out, segs = cw.cluster_walk(*args)
    got = profiling.counters()
    assert got["walk_iterations"][0] == int(out[3].sum(dtype=torch.float64))
    assert got["walk_segments"][0] == int(segs.sum(dtype=torch.int64))
    assert got["walk_segments"][0] > args[1].shape[0]
    assert 0 <= got["walk_sweeps"][0] < got["walk_segments"][0]


def _wide_build(csrc, defines):
    """``call(*case)`` of the wide walk built from ``csrc`` with
    ``defines``, and the device counts it adds to: ``(out, segs,
    counts)``."""
    import ctypes

    from raytracer_tpu_torch.utils import cuda_build

    call = walk_ab.walk_caller(ctypes.CDLL(str(cuda_build.build(
        "cluster_walk", csrc, defines))))

    def run(*args):
        profiling.reset_counters()
        out, segs = call(*walk_ab.launch_args(args))
        got = profiling.counters()
        return out, segs, {name: got.get(name, (0, 0.0))[0]
                           for name in cw.WIDE_COUNTS}

    return run


@pytest.mark.parametrize("case", FLAKE_CASES)
def test_wide_walk_bitwise_the_base_revision_on_card(flake_cases, case):
    """Each of the wide walk's instantiations on the sphereflake, bit for
    bit as the base revision's wide walk (its box sweep) runs it: every
    output row (the cost row and an adaptive launch's sample counts
    among them), the segments, and the launch's sample, iteration and
    bounce counts."""
    old = walk_ab.parent_csrc()
    if old is None:
        pytest.skip("the base revision's sources are not in this checkout")
    args = flake_cases[case]
    out_b, seg_b, cnt_b = _wide_build(old, (cw.WIDE_DEFINE,))(*args)
    out_k, seg_k, cnt_k = _wide_build(None, (cw.WIDE_DEFINE,))(*args)
    assert torch.equal(out_k, out_b) and torch.equal(seg_k, seg_b)
    assert {n: cnt_k[n] for n in cw.WIDE_COUNTS[:4]} == {
        n: cnt_b[n] for n in cw.WIDE_COUNTS[:4]}
    assert cnt_k["walk_segments"] == int(seg_k.sum(dtype=torch.int64))


@pytest.mark.parametrize("case", FLAKE_CASES)
def test_wide_walk_list_overflow_sweeps_bitwise_on_card(flake_cases, case):
    """A build whose pending list holds ``walk_ab.TEST_LIST_CAP`` entries
    (``-DRT_WALK_LIST_CAP``, a test build) overflows on a share of its
    bounces, some at their start, which start over as the sweep: it
    counts them, and every output row, the segments and the counts stay
    bit for bit the main build's."""
    args = flake_cases[case]
    out_k, seg_k, cnt_k = _wide_build(None, (cw.WIDE_DEFINE,))(*args)
    out_o, seg_o, cnt_o = _wide_build(None, walk_ab.WIDE_BUILDS["list8"])(
        *args)
    assert torch.equal(out_o, out_k) and torch.equal(seg_o, seg_k)
    assert {n: cnt_o[n] for n in cw.WIDE_COUNTS[:4]} == {
        n: cnt_k[n] for n in cw.WIDE_COUNTS[:4]}
    assert cnt_o["walk_sweeps"] > cnt_k["walk_sweeps"]
    assert cnt_o["walk_sweeps"] > cnt_o["walk_segments"] // 100


def test_sphereflake_renders_through_the_wide_walk_on_card(card):
    """``render_image`` with its default options renders the sphereflake
    on the card through the wide walk alone, deterministically."""
    scene = presets.sphereflake_scene()
    cam = presets.sphereflake_camera(64, 48)
    cw.reset_launch_counts()
    a, sa = api.render_image(scene, cam, 64, 48, 12, 2, TraceOptions(),
                             return_stats=True)
    b, sb = api.render_image(scene, cam, 64, 48, 12, 2, TraceOptions(),
                             return_stats=True)
    assert set(cw.cluster_walk.launches_by_variant) == {"cluster_walk_wide"}
    assert torch.equal(a, b) and sa["segments_exact"] == sb["segments_exact"]
    assert torch.isfinite(a).all() and sa["segments_exact"] > 64 * 48 * 12


@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_motion_walk_bitwise_on_card(card, sampler):
    """The motion walk on the bouncing spheres at 96x54, 3 spp, depth 12:
    the kernel bit for bit its plain version on the card, its bounce
    count the segments' sum and its member tests a whole number of
    clusters; ``render_image`` runs it alone."""
    scene = presets.bouncing_spheres_scene()
    w, h = 96, 54
    opts = TraceOptions(max_depth=12, russian_roulette_depth=0,
                        sampler=sampler)
    choice = megakernel.choose_kernel(
        scene, derive_camera(presets.bouncing_camera(w, h)), opts, card)
    args = (choice.tables, cw.identity_map(w, h, card), 0x1234567, 7, 3, w,
            h, opts)
    profiling.reset_counters()
    out_k, seg_k = cw.cluster_walk(*args)
    got = profiling.counters()
    out_p, seg_p = cw.cluster_walk_plain(*args)
    assert torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)
    tests, bounces = (got[name][0] for name in cw.MOTION_COUNTS)
    assert bounces == int(seg_k.sum(dtype=torch.int64))
    assert tests > 0 and tests % choice.tables.members.shape[1] == 0
    cw.reset_launch_counts()
    api.render_image(scene, presets.bouncing_camera(w, h), w, h, 8, 4, opts)
    assert set(cw.cluster_walk.launches_by_variant) == {
        cw.variant_name(opts, motion=True)}


def test_narrow_walk_at_128_clusters_unchanged_on_card(card):
    """A scene of exactly 128 clusters, the most the narrow walk takes,
    renders bit for bit as the base revision's walk renders it, and as
    its plain version (7 key bits)."""
    old = walk_ab.parent_csrc()
    if old is None:
        pytest.skip("the base revision's sources are not in this checkout")
    import ctypes

    from raytracer_tpu_torch.utils import cuda_build

    scene = walk_ab.random_scene(walk_ab.FULL_NARROW_SPHERES)
    _, cam, *_ = presets.get_config("cover", W, H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), card)
    assert tabs.bounds.shape[0] == 128 == tables.MAX_CLUSTERS
    args = (tabs, cw.identity_map(W, H, card), 9, 6, SPP, W, H, opts)
    out_k, seg_k = cw.cluster_walk(*args)
    base = walk_ab.walk_caller(ctypes.CDLL(str(cuda_build.build(
        "cluster_walk", old))))
    out_b, seg_b = base(*args, None, None)
    out_p, seg_p = cw.cluster_walk_plain(*args)
    assert torch.equal(out_k, out_b) and torch.equal(seg_k, seg_b)
    assert torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)


def test_adaptive_render_runs_the_kernel(card):
    """An adaptive stratified render on the card goes through that
    instantiation, once per chunk, and reports its sample map."""
    scene, cam, *_ = presets.get_config("cover", W, H)
    opts = TraceOptions(max_depth=8, russian_roulette_depth=3,
                        adaptive_tolerance=0.5, sampler="stratified",
                        adaptive_chunk_spp=16)
    cw.reset_launch_counts()
    img, stats = api.render_image(scene, cam, W, H, 200, 0, opts,
                                  return_stats=True)
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert cw.cluster_walk.launches_by_variant == {
        "cluster_walk_adaptive_stratified": cw.cluster_walk.launches}
    assert cw.cluster_walk.launches > 2
    assert stats["spp_map"].shape == (H, W)
    assert 64 <= stats["mean_spp"] < 200


def test_render_runs_the_kernel(card):
    """``render_image`` without a device renders on the card through the
    kernel: one launch per chunk."""
    scene, cam, *_ = presets.get_config("cover", W, H)
    before = cw.cluster_walk.launches
    img, stats = api.render_image(scene, cam, W, H, 8, 0,
                                  TraceOptions(max_depth=8),
                                  return_stats=True)
    assert img.device.type == "cuda" and img.shape == (H, W, 3)
    assert torch.isfinite(img).all()
    assert cw.cluster_walk.launches > before
    assert stats["segments_exact"] > W * H * 8


def test_kernel_rejects_tables_on_another_device(card):
    tabs, ident, opts = walk_inputs(card)
    with pytest.raises(ValueError, match="is on"):
        cw.cluster_walk(tabs.to("cpu"), ident, 1, 0, 1, W, H, opts)


FLAT_VARIANTS = [(a, st, sp) for sp in (False, True) for a in (False, True)
                 for st in (False, True)]


@pytest.mark.parametrize("adaptive, stratified, split", FLAT_VARIANTS,
                         ids=[fs.variant_name(TraceOptions(
                             adaptive_tolerance=0.2 if a else 0.0,
                             sampler="stratified" if st else "random"), sp)
                             for a, st, sp in FLAT_VARIANTS])
def test_flat_kernel_matches_plain_on_card(card, adaptive, stratified, split):
    """Each of the flat scan's eight instantiations against the plain
    version on the demo (K2s on its own split), at a nonzero sample
    offset, the adaptive ones under a budget that mixes 0 and the chunk's
    spp: the walk's bounds, the sample counts equal, a lane without
    budget all zeros."""
    scene, cam, *_ = presets.get_config("demo", W, H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                        adaptive_tolerance=0.2 if adaptive else 0.0,
                        sampler="stratified" if stratified else "random",
                        split_scan=split)
    choice = megakernel.choose_kernel(scene, derive_camera(cam), opts, card)
    assert choice.kernel == "flat_scan"
    assert fs.is_split(choice.tables, choice.g_full) == split
    budget = None
    if adaptive:
        g = torch.Generator().manual_seed(2)
        budget = (torch.where(torch.rand(W * H, generator=g) < 0.4, 0, SPP)
                  .to(torch.int32).to(card))
    args = (choice.tables, cw.identity_map(W, H, card), 9, 6, SPP, W, H,
            opts, choice.g_full, budget)
    before = dict(fs.flat_scan.launches_by_variant)
    out_k, seg_k = fs.flat_scan(*args)
    out_p, seg_p = fs.flat_scan_plain(*args)
    name = fs.variant_name(opts, split)
    assert fs.flat_scan.launches_by_variant[name] == before.get(name, 0) + 1
    assert out_k.shape == out_p.shape == (6 if adaptive else 4, W * H)
    d = (out_k[:3] - out_p[:3]).abs().amax(0)
    assert torch.isfinite(out_k).all()
    assert float((d > 1e-3).float().mean()) <= 0.005
    assert float(d.mean()) <= 1e-4
    sk, sp = int(seg_k.sum()), int(seg_p.sum())
    assert abs(sk - sp) <= 1e-3 * sp
    if adaptive:
        assert torch.equal(out_k[4], budget.float())
        assert torch.equal(out_k[4], out_p[4])
        assert not out_k[:, budget == 0].any()
        assert not seg_k[budget == 0].any()


@pytest.mark.parametrize("config", ["two_sphere", "three_sphere", "dof",
                                    "demo"])
def test_flat_render_runs_the_kernel(card, config):
    """A scene under 64 slots renders on the card through the flat scan
    (the demo through its split), one launch per chunk."""
    scene, cam, *_ = presets.get_config(config, W, H)
    fs.reset_launch_counts()
    img, stats = api.render_image(scene, cam, W, H, 8, 0,
                                  TraceOptions(max_depth=8),
                                  return_stats=True)
    assert img.device.type == "cuda" and img.shape == (H, W, 3)
    assert torch.isfinite(img).all()
    want = "flat_scan_split" if config == "demo" else "flat_scan"
    assert fs.flat_scan.launches_by_variant == {want: 1}
    assert stats["segments_exact"] >= W * H * 8


@pytest.mark.parametrize("scene_name", ["demo", "cover"],
                         ids=["slot_by_slot", "batched"])
@pytest.mark.parametrize("case", ["short_map", "one_lane", "no_budget"])
def test_flat_refill_edges_on_card(card, scene_name, case):
    """The flat scan's persistent grid at its edges, bit for bit its plain
    version in both scan forms (the demo's 9 slots one at a time, the
    cover's 487 in batches): a map shorter than one block, a map of one
    lane, and an adaptive budget without a lane to run (every lane
    written as zeros)."""
    scene, cam, *_ = presets.get_config(scene_name, W, H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                        cluster_scan=False,
                        adaptive_tolerance=0.2 if case == "no_budget"
                        else 0.0)
    choice = megakernel.choose_kernel(scene, derive_camera(cam), opts, card)
    assert choice.kernel == "flat_scan"
    ident = cw.identity_map(W, H, card)
    budget = None
    if case == "short_map":
        pmap = ident[:300].contiguous()
    elif case == "one_lane":
        pmap = ident[777:778].contiguous()
    else:
        pmap = ident
        budget = torch.zeros((W * H,), dtype=torch.int32, device=card)
    args = (choice.tables, pmap, 9, 6, SPP, W, H, opts, choice.g_full,
            budget)
    out_k, seg_k = fs.flat_scan(*args)
    out_p, seg_p = fs.flat_scan_plain(*args)
    assert torch.equal(out_k, out_p)
    assert torch.equal(seg_k, seg_p)
    if case == "no_budget":
        assert not out_k.any() and not seg_k.any()
    else:
        assert int(seg_k.sum()) >= pmap.shape[0] * SPP


FLAT_ALL = [(a, st, sp, False) for a, st, sp in FLAT_VARIANTS] + [
    (False, st, False, True) for st in (False, True)]


@pytest.mark.parametrize("adaptive, stratified, split, debug", FLAT_ALL,
                         ids=[fs.variant_name(TraceOptions(
                             adaptive_tolerance=0.2 if a else 0.0,
                             sampler="stratified" if st else "random",
                             enable_debug=d), sp)
                             for a, st, sp, d in FLAT_ALL])
def test_flat_batched_form_bitwise_on_card(card, adaptive, stratified, split,
                                           debug):
    """Each of the ten instantiations in the batched form (the cover's 487
    slots, through the flat scan; K2s on the cover's own split) bit for
    bit its plain version: the adaptive ones under a budget that mixes 0
    and the chunk's spp, the debug ones with the cursor on the sphere at
    the centre of the view and that sphere selected."""
    from raytracer_tpu_torch.interact.picking import update_cursor_state

    scene, cam, *_ = presets.get_config("cover", W, H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                        adaptive_tolerance=0.2 if adaptive else 0.0,
                        sampler="stratified" if stratified else "random",
                        cluster_scan=False, split_scan=split,
                        enable_debug=debug)
    choice = megakernel.choose_kernel(scene, derive_camera(cam), opts, card)
    assert choice.kernel == "flat_scan"
    assert choice.tables.spheres.shape[0] >= 32
    assert fs.is_split(choice.tables, choice.g_full) == split
    budget = None
    if adaptive:
        g = torch.Generator().manual_seed(2)
        budget = (torch.where(torch.rand(W * H, generator=g) < 0.4, 0, SPP)
                  .to(torch.int32).to(card))
    debug_params = None
    if debug:
        _, point, sel = update_cursor_state(scene.to(card), cam)
        debug_params = DebugParams(point, sel)
    args = (choice.tables, cw.identity_map(W, H, card), 9, 6, SPP, W, H,
            opts, choice.g_full, budget, debug_params)
    out_k, seg_k = fs.flat_scan(*args)
    out_p, seg_p = fs.flat_scan_plain(*args)
    assert torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)
    assert int(seg_k.sum()) > 0
    if adaptive:
        assert torch.equal(out_k[4], budget.float())
        assert not out_k[:, budget == 0].any()


def test_progressive_step_waits_for_nothing(card):
    """Steps of the progressive demo session on the card, with the sync
    debug mode raising on any call that waits for the device: none does;
    the session equals the same session on the CPU's plain versions
    within the walk's bounds."""
    scene, cam, *_ = presets.get_config("demo", W, H)
    opts = TraceOptions(max_depth=8)
    step = pstep.make_step_fn(W, H, 1, opts)
    state = pstate.init_render_state(W, H, 0)
    state, _ = step(state, scene, cam)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, aux = step(state, scene, cam)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.frame == 4 and state.render_count == 4
    cpu_step = pstep.make_step_fn(W, H, 1, opts, device="cpu")
    ref, _ = pstep.run_frames(cpu_step,
                              pstate.init_render_state(W, H, 0, device="cpu"),
                              scene, cam, 4)
    d = (state.accum.cpu() - ref.accum).abs().amax(-1)
    assert float((d > 1e-3).float().mean()) <= 0.005
    assert float(d.mean()) <= 1e-4


def test_accumulate_on_card_equals_cpu(card):
    """The running average divides by a 0-d device tensor, so the card
    rounds it as the CPU does: bitwise equal (a host scalar divisor would
    become a product with its reciprocal)."""
    g = torch.Generator().manual_seed(4)
    prev = torch.rand((27, 48, 3), generator=g)
    new = torch.rand((27, 48, 3), generator=g)
    for rc, w in ((1, 1.0), (7, 1.0), (7, 0.7), (100_000, 1.0)):
        cpu = pstep.accumulate(prev, new, rc, w)
        got = pstep.accumulate(prev.to(card), new.to(card), rc, w)
        assert torch.equal(got.cpu(), cpu), (rc, w)


DEBUG_VARIANTS = [(flat, st) for flat in (False, True) for st in (False, True)]


@pytest.mark.parametrize("flat, stratified", DEBUG_VARIANTS,
                         ids=["cluster_walk_debug",
                              "cluster_walk_stratified_debug",
                              "flat_scan_debug", "flat_scan_stratified_debug"])
def test_debug_kernel_matches_plain_on_card(card, flat, stratified):
    """Each debug instantiation (the cover's tables for the walk, the
    demo's for the flat scan) against its plain version, with the cursor
    on the sphere at the centre of the view and that sphere selected:
    bitwise, the outline drawn (and the demo's marker); with the cursor
    away and nothing selected, bitwise its non-debug twin."""
    from raytracer_tpu_torch.interact.picking import update_cursor_state

    scene, cam, *_ = presets.get_config("demo" if flat else "cover", W, H)
    _, point, sel = update_cursor_state(scene.to(card), cam)
    opts = TraceOptions(max_depth=8, russian_roulette_depth=5,
                        sampler="stratified" if stratified else "random",
                        enable_debug=True)
    choice = megakernel.choose_kernel(scene, derive_camera(cam), opts, card)
    assert choice.g_full is None
    kernel, plain = ((fs.flat_scan, fs.flat_scan_plain) if flat
                     else (cw.cluster_walk, cw.cluster_walk_plain))
    head = (choice.tables, cw.identity_map(W, H, card), 9, 6, SPP, W, H)
    tail = (choice.g_full, None) if flat else (None,)
    debug = DebugParams(point, sel)
    out_k, seg_k = kernel(*head, opts, *tail, debug)
    out_p, seg_p = plain(*head, opts, *tail, debug)
    assert torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)
    r, g, b = (out_k[:3] / SPP).unbind(0)
    # the outline always shows; the cover's picked sphere is seen at a
    # grazing angle, so at this size its marker fills no whole pixel
    assert int(((r - torch.maximum(g, b)) > 0.2).sum()) > 0
    if flat:
        assert int(((b == 1) & (r == 0) & (g == 0)).sum()) > 0
    off = TraceOptions(max_depth=8, russian_roulette_depth=5,
                       sampler=opts.sampler)
    a = kernel(*head, opts, *tail, DebugParams((1e4, 1e4, 1e4), 1000))
    b_ = kernel(*head, off, *tail)
    assert torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1])


def test_engine_frames_wait_for_nothing(card):
    """Engine ticks with the overlay on the card, with the sync debug mode
    raising on any call that waits for the device: none does (a pick,
    which reads its result, comes before); the pixel at the centre of the
    view is the marker's blue."""
    from raytracer_tpu_torch import Engine

    scene, cam, *_ = presets.get_config("demo", W, H)
    eng = Engine(scene, cam, W, H, enable_debugging=True)
    eng.set_paused(False)
    eng.handle_mouse_move(0.0, 0.0)
    assert eng.app.selected_object == 1
    eng.tick(16.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(70):  # past a drain of the segment total
            assert eng.tick(32.0 + 16.0 * i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the pixel whose jittered samples cover the centre of the view
    c = eng.render_state.accum[H // 2 - 1, W // 2 - 1]
    assert torch.equal(c, torch.tensor([0.0, 0.0, 1.0], device=card))
    assert eng.total_segments > 70 * W * H


def test_aov_on_card_equals_cpu(card):
    from raytracer_tpu_torch.render.debug import AOV_MODES, render_aov

    scene, cam, *_ = presets.get_config("demo", W, H)
    for mode in AOV_MODES:
        got = render_aov(scene, cam, W, H, mode)
        assert got.device.type == "cuda"
        ref = render_aov(scene, cam, W, H, mode, device="cpu")
        assert float((got.cpu() - ref).abs().max()) <= 1e-5, mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chain_kernel_matches_plain_on_card(card, dtype):
    """The chain probe's two instantiations, at the TPU's rows and at
    more: bitwise (every product and sum rounded on its own)."""
    for rows in (bc.TPU_ROWS, 264):
        x = bc.chain_input(rows, dtype, card)
        before = bc.chain.launches
        got = bc.chain(x, 40)
        assert bc.chain.launches == before + 1
        assert torch.equal(got, bc.chain_plain(x, 40))


@pytest.mark.parametrize("mode", pg.MODES)
def test_gather_kernel_matches_plain_on_card(card, mode):
    """Every case of a gather mode, one replica and five: bitwise."""
    for _, m, shape, rows in pg.CASES:
        if m != mode:
            continue
        tbl = pg.gather_table(shape).to(card)
        for reps in (1, 5):
            got = pg.gather_probe(tbl, mode, rows, 300, reps)
            assert torch.equal(got, pg.gather_probe_plain(tbl, mode, rows,
                                                          300, reps))


@pytest.mark.parametrize("block", list(bs.BLOCKS))
def test_scan_kernel_matches_plain_on_card(card, block):
    """Each scan block against the plain version: bitwise (sqrtf and the
    card's torch.sqrt are both correctly rounded)."""
    sph = bs.scan_table().to(card)
    for rows in (bs.R_SUB, 64):
        got = bs.scan_probe(sph, block, rows, 20)
        assert torch.equal(got, bs.scan_probe_plain(sph, block, rows, 20))


@pytest.mark.parametrize("block", list(bs.BLOCKS))
def test_scan_block_bitwise_at_odd_rows_on_card(card, block):
    """The redesigned scan (one slot loop for every block) at odd row
    counts and an odd trip count: bitwise the plain version."""
    sph = bs.scan_table().to(card)
    for rows in (1, 7, 133):
        got = bs.scan_probe(sph, block, rows, 9)
        assert torch.equal(got, bs.scan_probe_plain(sph, block, rows, 9))


@pytest.mark.parametrize("reps, rows, iters", [(1, 8, 5000), (3, 8, 77),
                                               (5, 3, 31), (257, 1, 6)])
def test_onehot_mma_bitwise_at_odd_counts_on_card(card, reps, rows, iters):
    """The one-hot product on the tensor cores at odd replica, row and
    trip counts (a warp's 16 outputs past a replica's end, the trip
    loop's tail): bitwise the plain version."""
    tbl = pg.gather_table((pg.S, 128)).to(card)
    got = pg.gather_probe(tbl, "onehot", rows, iters, reps)
    assert torch.equal(got, pg.gather_probe_plain(tbl, "onehot", rows,
                                                  iters, reps))


@pytest.mark.parametrize("shape", [(16, 8), (64, 32), (8, 4)])
def test_onehot_mma_small_tables_on_card(card, shape):
    """Tables of fewer than 256 rows (fewer k-tiles; one, zero-padded,
    under 16 rows) and narrower than 16 lanes: bitwise."""
    tbl = pg.gather_table(shape).to(card)
    got = pg.gather_probe(tbl, "onehot", 5, 41, 2)
    assert torch.equal(got, pg.gather_probe_plain(tbl, "onehot", 5, 41, 2))


def test_probe_ab_base_equals_new_for_unchanged_sources(card, tmp_path):
    """``scripts/probe_ab.py`` with the current sources as its base: both
    builds bound, run and held bitwise on every case; nothing fails."""
    import shutil

    from raytracer_tpu_torch.scripts import probe_ab
    from raytracer_tpu_torch.utils import cuda_build

    old = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, old)
    got = probe_ab.run(old, 1, "test", tmp_path / "out")
    for name in probe_ab.SOURCES:
        assert got[name]["bitwise"] and all(got[name]["bitwise"].values())
        assert "old" in got[name]["reports"]
    assert probe_ab.failures(got) == []


def oom_once(fn):
    """``fn`` whose first call allocates twice the card's memory: a real
    ``torch.OutOfMemoryError``."""
    calls = []

    def faulty(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            total = torch.cuda.get_device_properties(0).total_memory
            torch.empty(2 * total, dtype=torch.uint8, device="cuda")
        return fn(*args, **kwargs)

    return faulty


def test_engine_recovers_from_oom_bitwise_on_card(card):
    """A real OOM in the step: the tick returns False with the count at 0,
    and the next frames are bitwise a fresh engine's (same seed)."""
    from raytracer_tpu_torch.app.engine import Engine

    scene, cam, *_ = presets.get_config("cover", W, H)

    def engine():
        eng = Engine(scene, cam, W, H, seed=4)
        eng.set_paused(False)
        eng.set_debugging(True)
        return eng

    eng, fresh = engine(), engine()
    eng.run(4)
    real = eng._step_fn
    eng._step_fn = lambda spp: oom_once(real(spp))
    assert eng.tick(500.0) is False
    del eng._step_fn
    assert eng.render_state.render_count == 0
    for i in range(8):
        assert eng.tick(516.0 + 16 * i) and fresh.tick(16.0 * (i + 1))
        assert torch.equal(eng.render_state.accum, fresh.render_state.accum)


def test_render_image_recovers_from_oom_bitwise_on_card(card, monkeypatch):
    scene, cam, *_ = presets.get_config("cover", W, H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5)
    want, want_stats = api.render_image(scene, cam, W, H, SPP, 3, opts,
                                        return_stats=True)
    monkeypatch.setattr(pallas_kernel, "render",
                        oom_once(pallas_kernel.render))
    got, got_stats = api.render_image(scene, cam, W, H, SPP, 3, opts,
                                      return_stats=True)
    assert torch.equal(got, want)
    assert got_stats["segments_exact"] == want_stats["segments_exact"]


def test_cli_cover_png_byte_identical_on_card(card, tmp_path):
    """The CLI in its own process writes the PNG of the same call made in
    this one."""
    import os
    import subprocess
    import sys

    from raytracer_tpu_torch.app import io

    out = tmp_path / "cover.png"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-m", "raytracer_tpu_torch.app.cli",
                    "--config", "cover", "--width", str(W), "--height",
                    str(H), "--spp", str(SPP), "--russian-roulette", "5",
                    "--out", str(out)], cwd=root, check=True, timeout=300)
    scene, cam, *_ = presets.get_config("cover", W, H)
    img = api.render_image(scene, cam, W, H, SPP, 0,
                           TraceOptions(max_depth=50,
                                        russian_roulette_depth=5))
    assert out.read_bytes() == io.encode_png(img.cpu().numpy())


@pytest.mark.parametrize("edit", ["removed", "padded", "grown"])
def test_edited_cover_kernel_matches_plain_on_card(card, edit):
    """Edited covers through the kernel their slot count picks, bitwise
    the plain version: a sphere removed (K1), 37 slots of padding (K1), a
    63-slot cover grown to 64 by ``add_sphere`` (K1, where 63 took the
    flat scan)."""
    import dataclasses

    from raytracer_tpu_torch.scene import spheres as sp
    from raytracer_tpu_torch.scene.materials import Material

    scene, cam, *_ = presets.get_config("cover", W, H)
    if edit == "removed":
        scene = sp.remove_sphere(scene, 200)
    elif edit == "padded":
        scene = scene.pad_to(scene.count + 37)
    else:
        thin = dataclasses.replace(scene, **{
            f.name: getattr(scene, f.name)[:63]
            for f in dataclasses.fields(scene)})
        assert megakernel.choose_kernel(
            thin, derive_camera(cam), TraceOptions(), card).kernel == \
            "flat_scan"
        scene = sp.add_sphere(thin, (4.0, 0.2, 0.5), 0.2,
                              Material.diffuse((0.2, 0.8, 0.3)))
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5)
    choice = megakernel.choose_kernel(scene, derive_camera(cam), opts, card)
    assert choice.kernel == "cluster_walk"
    args = (choice.tables, cw.identity_map(W, H, card), 9, 6, SPP, W, H,
            opts)
    out_k, seg_k = cw.cluster_walk(*args)
    out_p, seg_p = cw.cluster_walk_plain(*args)
    assert torch.equal(out_k, out_p)
    assert torch.equal(seg_k, seg_p)


def nccl_mesh_of_one() -> list:
    """In a spawned rank: the cover crop through a (1, 1) NCCL mesh and
    through ``render_image``, fixed (K1) and adaptive stratified
    (K1a+K1s, 48 spp as [8, 20, 20])."""
    from raytracer_tpu_torch.parallel import (
        make_mesh,
        render_image_sharded_pallas,
    )

    import torch.distributed as dist

    mesh = make_mesh((1, 1))
    scene, cam, *_ = presets.get_config("cover", W, H)
    issued = []
    real = dist.all_reduce, dist.all_gather
    dist.all_reduce = lambda *a, **k: (issued.append("all_reduce"),
                                       real[0](*a, **k))[1]
    dist.all_gather = lambda *a, **k: (issued.append("all_gather"),
                                       real[1](*a, **k))[1]
    got = []
    for adaptive in (False, True):
        opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                            adaptive_tolerance=0.2 if adaptive else 0.0,
                            sampler="stratified" if adaptive else "random")
        issued.clear()
        a, sa = render_image_sharded_pallas(scene, cam, W, H, 48, 0, mesh,
                                            opts, return_stats=True)
        collectives = sorted(issued)
        b, sb = api.render_image(scene, cam, W, H, 48, 0, opts,
                                 return_stats=True)
        maps = [s.pop("spp_map", None) for s in (sa, sb)]
        got.append({"image": torch.equal(a, b), "stats": sa == sb,
                    "maps": maps[0] is None and maps[1] is None
                    or torch.equal(*maps), "device": str(a.device),
                    "collectives": collectives})
    return got


@pytest.fixture(scope="module")
def nccl_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from raytracer_tpu_torch.parallel import run_ranks

    return run_ranks(nccl_mesh_of_one, 1, backend="nccl")[0]


@pytest.mark.parametrize("case", [0, 1], ids=["fixed", "adaptive"])
def test_nccl_mesh_of_one_bitwise_render_image_on_card(nccl_one, case):
    """A world of one NCCL rank renders what ``render_image`` renders in
    its process, bit for bit: image, stats, sample map."""
    got = nccl_one[case]
    assert got["device"] == "cuda:0"
    assert got["image"] and got["stats"] and got["maps"]


@pytest.mark.parametrize("case", [0, 1], ids=["fixed", "adaptive"])
def test_nccl_mesh_of_one_runs_its_collectives_on_card(nccl_one, case):
    """The (1, 1) mesh's render goes through NCCL: the sums' all-reduce
    over spp, the segments' over the mesh, the all-gather over rows."""
    assert nccl_one[case]["collectives"] == ["all_gather", "all_reduce",
                                             "all_reduce"]


@pytest.mark.parametrize("kernel", ["cluster_walk",
                                    "cluster_walk_adaptive_stratified",
                                    "flat_scan", "flat_scan_split"])
def test_band_kernel_matches_plain_on_card(card, kernel):
    """A sharded render's lane map, a band of rows that starts mid-image
    (rows 8-15 of the crop), through each kernel of the sharded paths:
    bitwise its plain version, a budget mixing 0 and the chunk's spp for
    the adaptive one."""
    adaptive = kernel == "cluster_walk_adaptive_stratified"
    rows = torch.arange(8, 16, device=card)
    band = megakernel.band_pixels(cw.identity_map(W, 8, card), rows)
    budget = None
    if adaptive:
        g = torch.Generator().manual_seed(4)
        budget = (torch.where(torch.rand(W * 8, generator=g) < 0.4, 0, 2)
                  .to(torch.int32).to(card))
    if kernel.startswith("cluster_walk"):
        tabs, _, opts = walk_inputs(card, 5, adaptive, adaptive)
        args = (tabs, band, 9, 6, 2, W, H, opts, budget)
        kernel_fn, plain_fn = walk_ab.walk, cw.cluster_walk_plain
    else:
        scene, cam, *_ = presets.get_config("cover", W, H)
        opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                            cluster_scan=False,
                            split_scan=kernel == "flat_scan_split")
        choice = megakernel.choose_kernel(scene, derive_camera(cam), opts,
                                          card)
        assert fs.is_split(choice.tables, choice.g_full) == opts.split_scan
        args = (choice.tables, band, 9, 6, 2, W, H, opts, choice.g_full)
        kernel_fn, plain_fn = fs.flat_scan, fs.flat_scan_plain
    out_k, seg_k = kernel_fn(*args)
    out_p, seg_p = plain_fn(*args)
    assert torch.equal(out_k, out_p) and torch.equal(seg_k, seg_p)
    assert int(seg_k.sum()) >= (W * 8 * 2 if budget is None
                                else int(budget.sum()))


# --- the jnp tracer (render/tracer.py) on the card -------------------------

@pytest.mark.parametrize("p", [7, 4099, 1 << 20])
def test_threefry_on_card_bitwise_cpu(card, p):
    """Every Threefry draw on the card is the CPU's, bit for bit: the
    uniforms of (P,), (P, 2), (P, 3) and a concatenated bounce's draws."""
    from raytracer_tpu_torch.render import rng

    for seed in (0, 42, 2**31 + 5):
        kd = rng.key_data(seed)
        for shape in ((p,), (p, 2), (p, 3)):
            got = rng.uniform(kd, shape, card)
            assert torch.equal(got.cpu(), rng.uniform(kd, shape))
        draws = [(k, n) for k, n in zip(rng.split(kd, 3), (3 * p, 3 * p, p))]
        for g, w in zip(rng.uniforms(draws, card), rng.uniforms(draws)):
            assert torch.equal(g.cpu(), w)


def test_jnp_render_on_card_matches_cpu(card):
    """``backend='jnp'`` on the card against the same call on the CPU:
    the CPU test's bounds (at most 5 % of pixels off by more than 1e-3,
    mean |Δ| ≤ 8e-3, segments within 1 %); the card's sin, cos, sqrt and
    pow round as they do, so a path may fork."""
    scene, cam, *_ = presets.get_config("demo", W, H)
    opts = TraceOptions(max_depth=8, backend="jnp")
    got, st = api.render_image(scene, cam, W, H, 8, 42, opts,
                               return_stats=True)
    assert got.device.type == "cuda"
    ref, rst = api.render_image(scene, cam, W, H, 8, 42, opts,
                                return_stats=True, device="cpu")
    d = (got.cpu() - ref).abs()
    assert float((d.amax(-1) > 1e-3).float().mean()) <= 0.05
    assert float(d.mean()) <= 8e-3
    assert abs(st["segments_exact"] - rst["segments_exact"]) <= \
        0.01 * rst["segments_exact"]


def test_jnp_step_waits_for_nothing(card):
    """The jnp progressive step on the card, with the sync debug mode
    raising on any call that waits for the device: none does."""
    scene, cam, *_ = presets.get_config("demo", W, H)
    step = pstep.make_step_fn(W, H, 1, TraceOptions(max_depth=4),
                              backend="jnp")
    state = pstate.init_render_state(W, H, 0, device=card)
    state, _ = step(state, scene, cam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, aux = step(state, scene, cam)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.frame == 4 and int(aux["segments"]) >= W * H
    assert bool(torch.isfinite(state.accum).all())


def test_entry_step_launches_the_flat_scan_on_card(card):
    """``entry()`` without a device steps on the card: one launch of K2
    (``flat_scan``, the unsplit fixed random instantiation) and nothing
    else, and the frame is bitwise a directly built step's."""
    from raytracer_tpu_torch.entry import entry

    step, args = entry()
    assert args[0].accum.device.type == "cuda"
    cw.reset_launch_counts()
    fs.reset_launch_counts()
    got, got_aux = step(*args)
    torch.cuda.synchronize()
    assert fs.flat_scan.launches_by_variant == {"flat_scan": 1}
    assert cw.cluster_walk.launches_by_variant == {}
    scene, cam, *_ = presets.get_config("demo", 256, 144)
    want, want_aux = pstep.make_step_fn(
        256, 144, spp=1, opts=TraceOptions(max_depth=8), jit=False)(
        pstate.init_render_state(256, 144, 0), scene, cam,
        DebugParams.none())
    assert torch.equal(got.accum, want.accum)
    assert int(got_aux["segments"]) == int(want_aux["segments"])


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed", "adaptive"])
def test_render_image_pallas_is_render_image_on_card(card, adaptive):
    """``render_image_pallas`` on the card, on a small cover through the
    cluster walk: the image and the exact segments bitwise
    ``render_image``'s."""
    scene, cam, *_ = presets.get_config("cover", W, H)
    spp = 96 if adaptive else SPP
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                        adaptive_tolerance=0.2 if adaptive else 0.0,
                        sampler="stratified" if adaptive else "random")
    cw.reset_launch_counts()
    img, stats = pallas_kernel.render_image_pallas(
        scene, derive_camera(cam), W, H, spp, 3, opts, return_stats=True)
    torch.cuda.synchronize()
    kernel = ("cluster_walk_adaptive_stratified" if adaptive
              else "cluster_walk")
    assert set(cw.cluster_walk.launches_by_variant) == {kernel}
    want, want_stats = api.render_image(scene, cam, W, H, spp, 3, opts,
                                        return_stats=True)
    assert img.device.type == "cuda" and torch.equal(img, want)
    assert stats["segments_exact"] == want_stats["segments_exact"]
    if adaptive:
        assert torch.equal(stats["spp_map"], want_stats["spp_map"])


# --- the adaptive re-plan over the live lanes (csrc/adaptive_plan.cu) -------


def _plan_state(plans):
    """A plan's state as CPU tensors, and the live count of its newest
    plan."""
    live = (plans.live if plans.extent is None
            else int(plans.lives[min(plans.index, len(plans.lives) - 2)]))
    got = {name: getattr(plans, name).cpu() for name in (
        "acc", "segments", "order", "pixel_map", "budget")}
    if plans.stats is not None:
        got["stats"] = plans.stats.cpu()
    return got, live


@pytest.mark.parametrize("w, h", [(64, 32), (200, 90)],
                         ids=["one_tile", "merged_tiles"])
@pytest.mark.parametrize("stratified", [False, True],
                         ids=["random", "stratified"])
def test_adaptive_plan_chain_bitwise_its_plain_twin_on_card(
        card, monkeypatch, stratified, w, h):
    """The chain's re-plans against ``adaptive_plan.PlainPlan`` on the same
    synthetic chunks (sums that depend on the pixel and the chunk, ties in
    cost): after every step the sums, chunk statistics, exact segments,
    order, lane map, budgets and live count bitwise; the walk's extent
    [live count, next spp or 0]; the device counts the lanes each re-plan
    read and its slots. One tile of keys, and tiles merged."""
    monkeypatch.setattr(schedule, "ADAPTIVE_MIN_N", 8)
    n, tol = w * h, 0.1
    sizes = [4] + [5] * 8
    g = torch.Generator().manual_seed(11)
    mean = torch.rand(n, generator=g) * (torch.rand(n, generator=g) < 0.8)
    # per-sample variances over three decades: pixels stop chunk by chunk
    var = torch.exp(-8.0 * torch.rand(n, generator=g))
    cost = torch.randint(1, 6, (n,), generator=g).to(torch.float32)
    bounces = torch.randint(1, 9, (n,), generator=g, dtype=torch.int32)

    def chunk(pixel_map, budget, k):
        p = pixel_map[:, 1].to(torch.int64) * w + pixel_map[:, 0]
        b = budget.to(torch.float32)
        m = mean[p] * (1.0 + 0.1 * torch.sin(1.7 * k + p.to(torch.float32)))
        out = torch.stack([b * m * 0.9, b * m * 1.1, b * m, b * cost[p], b,
                           b * (m * m + var[p] * m)])
        return out.contiguous(), (bounces[p] * budget).contiguous()

    ident = cw.identity_map(w, h, "cpu")
    acc, segs = chunk(ident, torch.full((n,), sizes[0], dtype=torch.int32),
                      0)
    plain = adaptive_plan.PlainPlan(acc.clone(), w, tol, stratified)
    profiling.reset_counters()
    chain = adaptive_plan.start(acc.to(card), w, tol, stratified, len(sizes))
    assert isinstance(chain, adaptive_plan.CudaPlan)
    launched = adaptive_plan.CudaPlan.launches
    lanes_read, lives = 0, []
    for k in range(len(sizes)):
        nxt = sizes[k + 1] if k + 1 < len(sizes) else None
        if k > 0:
            out, segs = chunk(plain.pixel_map, plain.budget, k)
        lanes_read += plain.live if nxt is not None else 0
        plain.step(None if k == 0 else out, segs, nxt)
        chain.step(None if k == 0 else out.to(card), segs.to(card), nxt)
        want, live = _plan_state(plain)
        got, live_k = _plan_state(chain)
        assert live_k == live, k
        for name, t in want.items():
            assert torch.equal(got[name], t), (k, name)
        if nxt is not None:
            assert chain.extent.tolist() == [live, nxt if live else 0], k
            lives.append(live)
    # every lane live, then fewer re-plan by re-plan
    assert lives[0] == n and lives == sorted(lives, reverse=True), lives
    assert len({v for v in lives if 0 < v < n / 2}) >= 3, lives
    assert adaptive_plan.CudaPlan.launches == launched + len(sizes)
    got = profiling.counters()
    assert got["plan_lanes"] == (lanes_read, 0.0)
    assert got["plan_slots"] == ((len(sizes) - 1) * n, 0.0)


@pytest.mark.parametrize("name, sampler, band", [
    ("cover", "random", False), ("cover", "stratified", False),
    ("cover", "stratified", True), ("demo", "stratified", False)],
    ids=["walk_random", "walk_stratified", "walk_band", "flat_stratified"])
def test_adaptive_render_bitwise_the_full_width_loop_on_card(
        card, monkeypatch, name, sampler, band):
    """Adaptive renders on the card (past one tile of sort keys) through
    the walk, a band of its rows, and the flat scan, against the same
    launches re-planned over every pixel, as the base revision re-planned
    them (``walk_ab.full_width_render``): the image, the sample map and
    the exact segments bitwise."""
    got = []
    real = megakernel._render_adaptive

    def both(launch, sizes, width, height, opts, device):
        new = real(launch, sizes, width, height, opts, device)
        got.append((new, walk_ab.full_width_render(launch, sizes, width,
                                                   height, opts, device)))
        return new

    monkeypatch.setattr(megakernel, "_render_adaptive", both)
    w, h, spp = 160, 100, 200
    scene, cam, *_ = presets.get_config(name, w, h)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=0,
                        adaptive_tolerance=0.2, sampler=sampler)
    rows = torch.arange(10, 90) if band else None
    megakernel.render_sums(scene, derive_camera(cam), w, h, spp, (0, 5),
                           opts, card, rows=rows)
    ((acc, seg), (acc_r, seg_r)), = got
    rows_n = acc.shape[1] // w
    assert rows_n == (80 if band else h)
    image, extra = megakernel.finish(acc, w, rows_n, spp, True)
    image_r, extra_r = megakernel.finish(acc_r, w, rows_n, spp, True)
    assert torch.equal(image, image_r)
    assert torch.equal(extra["spp_map"], extra_r["spp_map"])
    assert int(seg) == int(seg_r)
    spp_map = extra["spp_map"]
    assert 64 <= float(spp_map.min()) < float(spp_map.max()) <= spp


def test_adaptive_render_launches_read_the_held_extent_on_card(card,
                                                                monkeypatch):
    """Every budgeted launch of an adaptive render reads the live extent
    from the buffer held for its stream (``adaptive_plan.extent_buffer``),
    which the chain rewrites only after that launch: a buffer freed before
    the launch is enqueued may be overwritten before the kernel reads it.
    The chain's kernels are not the renderer's: the walk's launch counts
    hold the walk's launches alone."""
    ptrs = []
    real = cw._lib

    def lib(wide=False, motion=False):
        fn = real(wide, motion)

        def call(*args):
            ptrs.append(args[6])
            return fn(*args)

        return call

    monkeypatch.setattr(cw, "_lib", lib)
    scene, cam, *_ = presets.get_config("cover", W, H)
    opts = TraceOptions(max_depth=8, russian_roulette_depth=3,
                        adaptive_tolerance=0.5, sampler="stratified",
                        adaptive_chunk_spp=16)
    cw.reset_launch_counts()
    launched = adaptive_plan.CudaPlan.launches
    api.render_image(scene, cam, W, H, 200, 0, opts, device=card)
    dev = torch.device("cuda", torch.cuda.current_device())
    held = adaptive_plan.extent_buffer(
        dev, torch.cuda.current_stream(dev).cuda_stream)
    assert ptrs[0] is None and len(ptrs) > 2
    assert set(ptrs[1:]) == {held.data_ptr()}
    assert cw.cluster_walk.launches == len(ptrs)
    assert cw.cluster_walk.launches_by_variant == {
        "cluster_walk_adaptive_stratified": len(ptrs)}
    # one step of the chain a chunk: a re-plan after each but the last
    assert adaptive_plan.CudaPlan.launches == launched + len(ptrs)


def test_adaptive_render_loop_waits_for_nothing_on_card(card, monkeypatch):
    """From the first launch to the last accumulation an adaptive render
    never waits for the card: no read back and no copy that synchronizes
    (a table copied from pageable memory would wait for the first
    launch)."""
    real = megakernel._render_adaptive
    ran = []

    def guarded(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ran.append(True)
        return out

    scene, cam, *_ = presets.get_config("cover", W, H)
    for sampler in ("random", "stratified"):
        opts = TraceOptions(max_depth=8, russian_roulette_depth=3,
                            adaptive_tolerance=0.5, sampler=sampler,
                            adaptive_chunk_spp=16)
        api.render_image(scene, cam, W, H, 200, 0, opts, device=card)
        with monkeypatch.context() as mp:
            mp.setattr(megakernel, "_render_adaptive", guarded)
            api.render_image(scene, cam, W, H, 200, 1, opts, device=card)
    assert ran == [True, True]
