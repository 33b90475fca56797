"""The flat closest-hit scan of the port (K2, K2s) against the JAX
package, and its own invariants.

Against the JAX package: the sphere table and the split analysis exactly;
one chunk of the plain flat scan against the TPU kernel in interpret mode
(``pk._render_chunk_impl(..., interpret=True, g_full=...)``) at 128x64,
4 spp, depth 8 (K2 on three_sphere, K2s on the demo, rr0 and rr5; the
adaptive and stratified variants on the demo); a whole small render
against ``pk.render_image_pallas``; the kernel each scene takes; and the
schedule of the BASELINE configs 1-3.

As in ``test_torch_walk``, integer streams match bit for bit and images
cannot: a one-ulp difference in a transcendental, or XLA's CPU backend
contracting a·b + c into an FMA, flips a roll or a grazing hit and that
path forks. The bounds are the walk's chunk bounds. Measured with this file's
``__main__`` (seed 7, offset 3): K2 on three_sphere 0.02 % of pixels off
by more than 1e-3, 99.8 % within 1e-5, mean |delta| 7e-5 to 1e-4,
segments 1e-5 apart; K2s on the demo 0.5 %, 98.5-98.7 %, 9e-4 to 1.1e-3,
1e-4 to 2e-4 apart.

Inside the port, bitwise: K2, K2s and K1 (the cluster walk on the demo's
partition) give the same image and segments; a duplicated sphere changes
nothing (of equal candidates the lowest slot wins, where the TPU kernel
summed the tied slots' parameters).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.render.options import (
    cluster_scan_enabled as jax_cluster_scan_enabled,
)
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu.scene.materials import Material as JaxMaterial
from raytracer_tpu.scene.spheres import make_scene as jax_make_scene
from raytracer_tpu_torch.camera.camera import camera_from_numpy
from raytracer_tpu_torch.render import api, megakernel, schedule, split
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import flat_scan as fs
from raytracer_tpu_torch.render import tables
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.materials import Material
from raytracer_tpu_torch.scene.spheres import make_scene, scene_from_numpy

W, H, SPP, DEPTH, OFFSET = 128, 64, 4, 8, 3
R_SUB = 8

MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3  # mean |delta| of the per-pixel rgb sums
MIN_COST_EQUAL = 0.95  # pixels with equal bounce counts
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


def carry_across(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def port_scene(j_scene):
    return scene_from_numpy(**carry_across(j_scene))


def port_camera(dcam):
    return camera_from_numpy(carry_across(dcam))


# --- scenes of the JAX package's split tests (tests/test_pallas.py) ---

def analysis_scene():
    """``test_containable_split_analysis``: glass, a hollow inner shell,
    an overlapping pair and isolated spheres."""
    m = JaxMaterial
    return jax_make_scene([
        ((0, -1000, 0), 1000.0, m.diffuse((0.5, 0.5, 0.5))),
        ((0, 1, 0), 1.0, m.glass(1.5)),
        ((0, 1, 0), -0.45, m.glass(1.5)),
        ((4, 3, 0), 1.0, m.metal((0.7, 0.6, 0.5), 0.0)),
        ((8, 5, 0), 1.0, m.diffuse((0.4, 0.2, 0.1))),
        ((8, 5.5, 0), 1.0, m.diffuse((0.4, 0.2, 0.1))),
        ((-8, 5, 0), 1.0, m.metal((0.7, 0.7, 0.7), 0.1)),
        ((-8, 9, 0), 1.0, m.diffuse((0.1, 0.4, 0.2))),
        ((12, 9, 4), 1.0, m.diffuse((0.2, 0.1, 0.4))),
        ((12, 9, -4), 1.0, m.metal((0.5, 0.5, 0.6), 0.0)),
        ((-12, 9, 4), 1.0, m.diffuse((0.3, 0.3, 0.1))),
    ]), jax_derive_camera(jax_presets.simple_camera(64, 32))


def shell_scene():
    """``test_split_scan_camera_inside_sphere``: the camera inside a
    diffuse shell."""
    scene = jax_make_scene([((0, 0, 0), 50.0,
                             JaxMaterial.diffuse((0.8, 0.1, 0.1)))])
    return scene, jax_derive_camera(jax_presets.simple_camera(64, 32))


def margin_scene():
    """``test_containable_camera_margin_scales_with_distance``: a camera
    far from the origin, just outside a sphere, with an aperture."""
    spheres = [((2001.0, 0.0, 0.0), 0.997,
                JaxMaterial.diffuse((0.5, 0.5, 0.5)))]
    spheres += [((i * 50.0, 500.0, 500.0), 1.0,
                 JaxMaterial.diffuse((0.3, 0.3, 0.3))) for i in range(9)]
    cam = dataclasses.replace(
        jax_presets.simple_camera(64, 32),
        origin=jnp.asarray((2000.0, 0.0, 0.0), jnp.float32), aperture=0.1,
    )
    return jax_make_scene(spheres), jax_derive_camera(cam)


def config_scene(name):
    j_scene, j_cam, *_ = jax_presets.get_config(name, 64, 32)
    return j_scene, jax_derive_camera(j_cam)


def zero_radius_scene():
    """``test_zero_radius_sphere_does_not_poison_gather``, plus an
    inactive slot."""
    m = JaxMaterial
    scene = jax_make_scene([
        ((0, -1000, 0), 1000.0, m.diffuse((0.5, 0.5, 0.5))),
        ((0, 1, 0), 1.0, m.diffuse((0.7, 0.3, 0.3))),
        ((3, 1, 0), 0.0, m.metal((0.9, 0.9, 0.9), 0.0)),
        ((0, 1, 3), -0.5, m.glass(1.5)),
    ])
    scene = scene.replace(active=scene.active.at[3].set(0.0))
    return scene, jax_derive_camera(jax_presets.simple_camera(64, 32))


SCENES = {
    "demo": lambda: config_scene("demo"),
    "dof": lambda: config_scene("dof"),
    "two_sphere": lambda: config_scene("two_sphere"),
    "cover": lambda: config_scene("cover"),
    "analysis": analysis_scene,
    "shell": shell_scene,
    "margin": margin_scene,
    "zero_radius": zero_radius_scene,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sphere_table_matches_jax(name):
    """``sphere_table`` is ``pk._sphere_table`` without its padding rows,
    bit for bit; 1/r stays finite where r == 0."""
    j_scene, _ = SCENES[name]()
    ref = np.asarray(pk._sphere_table(j_scene))[:j_scene.count]
    got = tables.sphere_table(port_scene(j_scene)).numpy()
    assert got.shape == (j_scene.count, fs.ROW)
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_containable_split_matches_jax(name):
    """The same flags, the same ``perm`` (None where the scene is already
    in order), the same ``g_full``, and None where the JAX package gives
    None; the option turns the analysis off on both sides."""
    j_scene, dcam = SCENES[name]()
    j_opts, opts = JaxOptions(), TraceOptions()
    scene, cam = port_scene(j_scene), port_camera(dcam)
    np.testing.assert_array_equal(
        split.containable_flags(scene, cam, opts),
        np.asarray(pk._containable_flags(j_scene, dcam, j_opts)))
    ref = pk._containable_split(j_scene, dcam, j_opts)
    got = split.containable_split(scene, cam, opts)
    if ref is None:
        assert got is None
    else:
        assert got is not None and got[1] == ref[1]
        if ref[0] is None:
            assert got[0] is None
        else:
            np.testing.assert_array_equal(got[0], ref[0])
    off = dataclasses.replace(opts, split_scan=False)
    assert split.containable_split(scene, cam, off) is None


def test_split_cases_are_covered():
    """The scenes above reach every branch of the analysis: a split with
    a permutation, None for 8 slots or fewer, None when every slot needs
    full logic."""
    results = {}
    for name, make in SCENES.items():
        j_scene, dcam = make()
        results[name] = pk._containable_split(j_scene, dcam, JaxOptions())
    assert results["demo"] is not None and results["demo"][0] is not None
    assert results["analysis"] is not None
    assert results["shell"] is None and results["two_sphere"] is None
    assert results["margin"] is not None


def jax_choice(j_scene, dcam, j_opts):
    """The kernel ``render_image_pallas`` takes, and its split."""
    if jax_cluster_scan_enabled(j_opts, j_scene.count):
        if pk._cluster_partition(j_scene, j_opts) is not None:
            return "cluster_walk", None
    return "flat_scan", pk._containable_split(j_scene, dcam, j_opts)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("cluster_scan", ["auto", True, False])
def test_kernel_choice_matches_jax(name, cluster_scan):
    """The dispatcher takes the cluster walk where the JAX package takes
    it, the flat scan elsewhere, split as the JAX package splits it."""
    j_scene, dcam = SCENES[name]()
    j_opts = JaxOptions(cluster_scan=cluster_scan)
    opts = TraceOptions(cluster_scan=cluster_scan)
    kernel, ref_split = jax_choice(j_scene, dcam, j_opts)
    got = megakernel.choose_kernel(port_scene(j_scene), port_camera(dcam),
                                   opts, "cpu")
    assert got.kernel == kernel
    if kernel == "flat_scan":
        assert got.g_full == (None if ref_split is None else ref_split[1])


def test_scan_mxu_is_served_by_the_flat_scan():
    """``scan_mxu`` (the TPU's MXU offload) is K2's function: accepted,
    routed to the flat scan, and refused beside an explicit
    cluster_scan=True as in the JAX package."""
    j_scene, dcam = config_scene("cover")
    opts = TraceOptions(scan_mxu=True)
    got = megakernel.choose_kernel(port_scene(j_scene), port_camera(dcam),
                                   opts, "cpu")
    assert got.kernel == "flat_scan"
    with pytest.raises(ValueError, match="cluster_scan and scan_mxu"):
        TraceOptions(scan_mxu=True, cluster_scan=True)
    with pytest.raises(ValueError, match="cluster_scan"):
        TraceOptions(cluster_scan="yes")


@pytest.mark.parametrize("config", ["two_sphere", "three_sphere", "dof"])
@pytest.mark.parametrize("rr", [5, 0])
def test_baseline_schedule_matches_jax(config, rr):
    """The port's schedule gives BASELINE configs 1-3 at bench.py's sizes
    the JAX package's chunks (the flat path's cost scale is 1.0)."""
    scene, _, w, h, spp, depth = presets.get_config(config)
    chunk = schedule.pick_chunk_spp(spp, w * h, scene.count, depth, rr)
    assert chunk == pk._pick_chunk_spp(spp, w * h, scene.count, depth, rr,
                                       cost_scale=1.0)
    assert schedule.chunk_schedule(spp, chunk) == pk._chunk_schedule(spp,
                                                                    chunk)


def variant_opts(cls, rr, adaptive=False, stratified=False):
    return cls(max_depth=DEPTH, russian_roulette_depth=rr,
               adaptive_tolerance=0.2 if adaptive else 0.0,
               sampler="stratified" if stratified else "random")


def mixed_budget() -> np.ndarray:
    r = np.random.default_rng(99)
    return np.where(r.random(W * H) < 0.4, 0, SPP).astype(np.int32)


def jax_chunk(config, rr, seed, adaptive=False, stratified=False,
              budget=None):
    """Per-pixel rows, the segment total and the split of one
    interpret-mode flat chunk, pixel order py·W + px."""
    j_scene, j_cam, *_ = jax_presets.get_config(config, W, H)
    dcam = jax_derive_camera(j_cam)
    opts = variant_opts(JaxOptions, rr, adaptive, stratified)
    sp = pk._containable_split(j_scene, dcam, opts)
    scene, g_full = j_scene, None
    if sp is not None:
        perm, g_full = sp
        if perm is not None:
            scene = jax.tree_util.tree_map(lambda a: a[perm], j_scene)
    pixel_map = None
    if budget is not None:
        rows = np.arange(H, dtype=np.int32).reshape(H // R_SUB, R_SUB, 1)
        planes = np.stack([
            np.broadcast_to(np.arange(W, dtype=np.int32),
                            (H // R_SUB, R_SUB, W)),
            np.broadcast_to(rows, (H // R_SUB, R_SUB, W)),
            budget.reshape(H // R_SUB, R_SUB, W),
        ], axis=1)
        pixel_map = jnp.asarray(planes[:, :, None])
    out = pk._render_chunk_impl(
        scene, dcam, jnp.int32(seed), OFFSET, W, H, SPP, opts, R_SUB, True,
        k_slots=1, g_full=g_full, pixel_map=pixel_map,
    )
    nacc = 6 if adaptive else 4
    flat = np.asarray(pk._tiles_to_flat(out, W, H, R_SUB, 1, nacc))
    flat = flat.reshape(nacc, -1, pk.LANES)[:, :H, :W].reshape(nacc, -1)
    return flat, int(np.asarray(out)[:, nacc, 0, 0].sum()), g_full


def chunk_parity(config, rr, seed=7, adaptive=False, stratified=False):
    budget = mixed_budget() if adaptive else None
    ref, ref_segs, g_full = jax_chunk(config, rr, seed, adaptive,
                                      stratified, budget)
    j_scene, j_cam, *_ = jax_presets.get_config(config, W, H)
    opts = variant_opts(TraceOptions, rr, adaptive, stratified)
    choice = megakernel.choose_kernel(
        port_scene(j_scene), port_camera(jax_derive_camera(j_cam)), opts,
        "cpu")
    out, segs = fs.flat_scan(
        choice.tables, cw.identity_map(W, H, "cpu"), seed, OFFSET, SPP, W,
        H, opts, choice.g_full,
        None if budget is None else torch.from_numpy(budget),
    )
    out = out.numpy()
    d = np.abs(out[:3] - ref[:3]).max(axis=0)
    n_segs = int(segs.sum(dtype=torch.int64))
    stats = {
        "g_full": (choice.g_full, g_full),
        "forked": float((d > 1e-3).mean()),
        "close": float((d <= 1e-5).mean()),
        "mean_abs": float(d.mean()),
        "cost_equal": float((out[3] == ref[3]).mean()),
        "seg_rel": (n_segs - ref_segs) / ref_segs,
        "segments": (n_segs, ref_segs),
    }
    if adaptive:
        dead = budget == 0
        stats["n_equal"] = bool((out[4] == ref[4]).all()
                                and (out[4] == budget).all())
        stats["dead_zero"] = bool((out[:, dead] == 0).all()
                                  and (segs.numpy()[dead] == 0).all())
    return stats


def assert_chunk_bounds(stats):
    assert stats["forked"] <= MAX_FORKED_SHARE, stats
    assert stats["close"] >= MIN_CLOSE_SHARE, stats
    assert stats["mean_abs"] <= MAX_MEAN_ABS, stats
    assert stats["cost_equal"] >= MIN_COST_EQUAL, stats
    assert abs(stats["seg_rel"]) <= MAX_SEG_REL, stats


@pytest.mark.parametrize("config, rr", [
    ("three_sphere", 0), ("three_sphere", 5), ("demo", 0), ("demo", 5),
])
def test_flat_chunk_matches_interpret_kernel(config, rr):
    """K2 on three_sphere (5 slots: no split), K2s on the demo (its own
    split, g_full 8 of 9 slots)."""
    stats = chunk_parity(config, rr)
    want = 8 if config == "demo" else None
    assert stats["g_full"] == (want, want), stats
    assert_chunk_bounds(stats)


@pytest.mark.parametrize("adaptive, stratified", [
    (False, True), (True, False), (True, True),
], ids=["stratified", "adaptive", "adaptive_stratified"])
def test_flat_variant_chunk_matches_interpret_kernel(adaptive, stratified):
    """K2s's adaptive and stratified instantiations on the demo, rr5, the
    adaptive ones under a budget plane with 0 on 40 % of the pixels: the
    same bounds; the sample counts equal the budgets and a lane without
    budget is all zeros."""
    stats = chunk_parity("demo", 5, 11, adaptive, stratified)
    assert_chunk_bounds(stats)
    if adaptive:
        assert stats["n_equal"] and stats["dead_zero"], stats


def test_flat_render_matches_render_image_pallas(monkeypatch):
    """The demo (K2s) at 128x64, 4 spp as chunks [1, 3], depth 8, rr5,
    seed 3, gamma off, against ``render_image_pallas``: the chunk bounds
    on the image scaled back to sums, segments within 0.6 %."""
    monkeypatch.setattr(pk, "_pick_chunk_spp",
                        lambda spp, *a, **k: min(spp, 3))
    monkeypatch.setattr(schedule, "pick_chunk_spp",
                        lambda spp, *a, **k: min(spp, 3))
    j_scene, j_cam, *_ = jax_presets.get_config("demo", W, H)
    dcam = jax_derive_camera(j_cam)
    ref, ref_stats = pk.render_image_pallas(
        j_scene, dcam, W, H, SPP, jax.random.PRNGKey(3),
        JaxOptions(max_depth=DEPTH, russian_roulette_depth=5, gamma=False),
        return_stats=True,
    )
    img, stats = api.render_image(
        port_scene(j_scene), port_camera(dcam), W, H, SPP, 3,
        TraceOptions(max_depth=DEPTH, russian_roulette_depth=5,
                     gamma=False),
        return_stats=True, device="cpu",
    )
    d = np.abs(img.numpy() - np.asarray(ref)).max(axis=-1) * SPP
    assert (d > 1e-3).mean() <= MAX_FORKED_SHARE
    assert (d <= 1e-5).mean() >= MIN_CLOSE_SHARE
    assert d.mean() <= MAX_MEAN_ABS
    ref_segs = float(ref_stats["segments"])
    assert abs(stats["segments_exact"] - ref_segs) <= MAX_SEG_REL * ref_segs


def test_k2_k2s_k1_bitwise_on_the_demo():
    """The demo through K2 (split_scan off), K2s (its own split) and K1
    (cluster_scan on: 4 globals and one cluster of 5): the same image and
    the same exact segments, as the JAX package asserts of its kernels."""
    scene, cam, *_ = presets.get_config("demo", 64, 32)
    base = TraceOptions(max_depth=8)
    variants = {
        "flat_scan": dataclasses.replace(base, split_scan=False),
        "flat_scan_split": base,
        "cluster_walk": dataclasses.replace(base, cluster_scan=True),
    }
    results = {}
    for want, opts in variants.items():
        choice = megakernel.choose_kernel(scene, api.to_derived(cam), opts,
                                          "cpu")
        got = choice.kernel + ("_split" if choice.g_full is not None
                               else "")
        assert got == want
        results[want] = api.render_image(scene, cam, 64, 32, 4, 5, opts,
                                         return_stats=True, device="cpu")
    img, stats = results["flat_scan"]
    for other in ("flat_scan_split", "cluster_walk"):
        assert torch.equal(results[other][0], img), other
        assert results[other][1] == stats, other


def with_duplicate(spheres, j):
    return make_scene(spheres + [spheres[j]])


@pytest.mark.parametrize("config, dup", [("two_sphere", 0),
                                         ("three_sphere", 3),
                                         ("three_sphere", 2)])
def test_duplicate_sphere_changes_nothing(config, dup):
    """A scene with one sphere duplicated (exactly coincident surfaces:
    every hit on it ties) renders finite and bitwise equal to the scene
    without the duplicate: of equal candidates the lowest slot wins."""
    d, m, g = Material.diffuse, Material.metal, Material.glass
    spheres = {
        "two_sphere": [((0.0, 0.0, -1.0), 0.5, d((0.5, 0.5, 0.5))),
                       ((0.0, -100.5, -1.0), 100.0, d((0.5, 0.5, 0.5)))],
        "three_sphere": [((0.0, -100.5, -1.0), 100.0, d((0.8, 0.8, 0.0))),
                         ((0.0, 0.0, -1.0), 0.5, d((0.1, 0.2, 0.5))),
                         ((-1.0, 0.0, -1.0), 0.5, g(1.5)),
                         ((1.0, 0.0, -1.0), 0.5, m((0.8, 0.6, 0.2))),
                         ((-1.0, 0.0, -1.0), -0.45, g(1.5))],
    }[config]
    cam = presets.simple_camera(64, 32)
    opts = TraceOptions(max_depth=8, russian_roulette_depth=3)
    a, sa = api.render_image(make_scene(spheres), cam, 64, 32, 3, 2, opts,
                             return_stats=True, device="cpu")
    b, sb = api.render_image(with_duplicate(spheres, dup), cam, 64, 32, 3, 2,
                             opts, return_stats=True, device="cpu")
    assert torch.isfinite(b).all()
    assert torch.equal(a, b) and sa == sb


def test_zero_radius_sphere_renders_finite():
    """A zero-radius slot (an interactive radius edit passing through 0)
    never wins a hit and puts no inf in the table: the image is finite
    and equals the scene without it."""
    d, m = Material.diffuse, Material.metal
    spheres = [((0, -1000, 0), 1000.0, d((0.5, 0.5, 0.5))),
               ((0, 1, 0), 1.0, d((0.7, 0.3, 0.3)))]
    cam = presets.simple_camera(64, 32)
    opts = TraceOptions(max_depth=4)
    with_zero = make_scene(spheres + [((3, 1, 0), 0.0, m((0.9, 0.9, 0.9)))])
    assert torch.isfinite(tables.sphere_table(with_zero)).all()
    a = api.render_image(make_scene(spheres), cam, 64, 32, 4, 0, opts,
                         device="cpu")
    b = api.render_image(with_zero, cam, 64, 32, 4, 0, opts, device="cpu")
    assert torch.isfinite(b).all() and torch.equal(a, b)


def test_wrapper_checks_its_inputs():
    scene, cam, *_ = presets.get_config("demo", 16, 8)
    opts = TraceOptions(max_depth=2)
    ft = tables.flat_tables(scene, api.to_derived(cam), "cpu")
    ident = cw.identity_map(16, 8, "cpu")
    with pytest.raises(ValueError, match="is on"):
        fs.flat_scan(ft, ident.to("meta"), 1, 0, 1, 16, 8, opts)
    with pytest.raises(ValueError, match="g_full"):
        fs.flat_scan(ft, ident, 1, 0, 1, 16, 8, opts, g_full=-1)
    with pytest.raises(ValueError, match="budget"):
        fs.flat_scan(ft, ident, 1, 0, 1, 16, 8, opts,
                     budget=torch.ones(16 * 8, dtype=torch.int32))
    big = tables.FlatTables(camera=ft.camera,
                            spheres=torch.zeros((2048, fs.ROW)))
    with pytest.raises(ValueError, match="shared memory"):
        fs.flat_scan(big, ident, 1, 0, 1, 16, 8, opts)
    assert fs.smem_bytes(1022) <= fs.MAX_SMEM_BYTES < fs.smem_bytes(1023)


def test_variant_names():
    names = {fs.variant_name(variant_opts(TraceOptions, 0, a, s), sp)
             for a in (False, True) for s in (False, True)
             for sp in (False, True)}
    assert len(names) == 8 and "flat_scan" in names
    assert "flat_scan_split_adaptive_stratified" in names


def test_adaptive_flat_render():
    """An adaptive render of a small scene goes through the flat scan's
    adaptive instantiation: whole per-pixel counts, at least 64 of them,
    and a stripped tolerance is the fixed render bitwise."""
    scene, cam, *_ = presets.get_config("demo", 16, 8)
    opts = TraceOptions(max_depth=4, adaptive_tolerance=0.3,
                        sampler="stratified", adaptive_chunk_spp=8)
    img, stats = api.render_image(scene, cam, 16, 8, 96, 1, opts,
                                  return_stats=True, device="cpu")
    spp_map = stats["spp_map"]
    assert torch.isfinite(img).all()
    assert float(spp_map.min()) >= 64 and float(spp_map.max()) <= 96
    assert torch.equal(spp_map, spp_map.round())
    fixed = dataclasses.replace(opts, adaptive_tolerance=0.0)
    single = dataclasses.replace(opts, sort_pixels=False)
    a = api.render_image(scene, cam, 16, 8, 96, 1, fixed, device="cpu")
    b = api.render_image(scene, cam, 16, 8, 96, 1, single, device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sample_offset"):
        api.render_image(scene, cam, 16, 8, 96, 1, opts, device="cpu",
                         sample_offset=4)


if __name__ == "__main__":
    # parity statistics; run as  python tests/test_torch_flat.py [seed...]
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    for seed in [int(s) for s in sys.argv[1:]] or [7]:
        for config, rr in (("three_sphere", 0), ("three_sphere", 5),
                           ("demo", 0), ("demo", 5)):
            print(config, rr, seed, chunk_parity(config, rr, seed),
                  flush=True)
