"""The plain PyTorch cluster walk's adaptive and stratified variants
against the TPU kernel run in interpret mode
(``pk._render_chunk_impl(..., interpret=True, caux=...)``): one chunk of
the cover at 128x64, depth 12, Russian roulette from bounce 5, at a
nonzero sample offset, on the same partition, seed and JAX-derived camera
basis; and the variants' own invariants inside the port, bit for bit.

As in ``test_torch_walk``, integer streams (the Kronecker draws included)
match bit for bit and images cannot: a one-ulp difference flips a roll or
a grazing hit and that path forks, and XLA's CPU backend contracts
a·b + c into FMAs. The bounds are that file's. Measured here (seeds 7
and 11, offset 5, 4 spp; ``python tests/test_torch_variants.py 7 11``):

- stratified: 2.6-2.8 % of pixels off by more than 1e-3, 80.6-80.9 %
  within 1e-5, mean |delta| 4.0e-3 to 4.6e-3, cost equal on 97.7-97.8 %,
  segments 0.06-0.09 % apart;
- adaptive (a budget plane with 0 on 40 % of the pixels, 4 elsewhere):
  1.6 %, 88.3-88.5 %, 2.8e-3, 98.5 %, 0.01-0.15 %; Σ lum² within 1e-5 on
  94.2-94.3 % of pixels;
- adaptive + stratified: 1.6-1.7 %, 88.2-88.4 %, 2.3e-3 to 2.7e-3,
  98.5-98.6 %, 0.01-0.12 %; Σ lum² within 1e-5 on 94.0-94.4 %.

The sample count row and the budget handling are exact: n equals the
lane's budget everywhere, and a lane without budget returns zeros.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu_torch.camera.camera import camera_from_numpy
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import tables
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

W, H, SPP, DEPTH, RR, OFFSET = 128, 64, 4, 12, 5, 5
R_SUB = 8

MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3  # mean |delta| of the per-pixel rgb sums
MIN_COST_EQUAL = 0.95  # pixels with equal walk-iteration counts
MAX_SEG_REL = 6e-3  # segment totals


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain walk runs thousands of small tensor ops; with the test
    workers sharing the machine, PyTorch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry_across(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def variant_opts(cls, adaptive: bool, stratified: bool):
    return cls(max_depth=DEPTH, russian_roulette_depth=RR,
               adaptive_tolerance=0.2 if adaptive else 0.0,
               sampler="stratified" if stratified else "random")


def port_inputs(adaptive: bool, stratified: bool):
    j_scene, j_cam, *_ = jax_presets.get_config("cover", W, H)
    scene = scene_from_numpy(**carry_across(j_scene))
    dcam = camera_from_numpy(carry_across(jax_derive_camera(j_cam)))
    opts = variant_opts(TraceOptions, adaptive, stratified)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts), dcam,
                              "cpu")
    return tabs, opts


def mixed_budget() -> np.ndarray:
    """(H·W,) int32 budgets in pixel order: 0 on a seeded 40 % of the
    pixels, the chunk's spp elsewhere."""
    r = np.random.default_rng(99)
    return np.where(r.random(W * H) < 0.4, 0, SPP).astype(np.int32)


def jax_chunk(adaptive: bool, stratified: bool, seed: int, budget=None):
    """Per-pixel (nacc, H·W) rows and the segment total of one
    interpret-mode chunk, pixel order py·W + px. With ``budget`` the
    chunk runs under the identity lane map with a budget plane."""
    j_scene, j_cam, *_ = jax_presets.get_config("cover", W, H)
    opts = variant_opts(JaxOptions, adaptive, stratified)
    part = pk._cluster_partition(j_scene, opts)
    pixel_map = None
    if budget is not None:
        # (nt, 3, k_slots=1, r_sub, lanes): tile t holds rows t·8 .. t·8+7
        rows = np.arange(H, dtype=np.int32).reshape(H // R_SUB, R_SUB, 1)
        planes = np.stack([
            np.broadcast_to(np.arange(W, dtype=np.int32), (H // R_SUB, R_SUB,
                                                           W)),
            np.broadcast_to(rows, (H // R_SUB, R_SUB, W)),
            budget.reshape(H // R_SUB, R_SUB, W),
        ], axis=1)
        pixel_map = jnp.asarray(planes[:, :, None])
    out = pk._render_chunk_impl(
        part.scene, jax_derive_camera(j_cam), jnp.int32(seed), OFFSET, W, H,
        SPP, opts, R_SUB, True, caux=(part.boxes, part.uuid),
        n_global=part.n_global, k_slots=1, pixel_map=pixel_map,
    )
    nacc = 6 if adaptive else 4
    flat = np.asarray(pk._tiles_to_flat(out, W, H, R_SUB, 1, nacc))
    flat = flat.reshape(nacc, -1, pk.LANES)[:, :H, :W].reshape(nacc, -1)
    return flat, int(np.asarray(out)[:, nacc, 0, 0].sum())


def variant_parity(adaptive: bool, stratified: bool, seed: int = 7) -> dict:
    budget = mixed_budget() if adaptive else None
    ref, ref_segs = jax_chunk(adaptive, stratified, seed, budget)
    tabs, opts = port_inputs(adaptive, stratified)
    out, segs = cw.cluster_walk(
        tabs, cw.identity_map(W, H, "cpu"), seed, OFFSET, SPP, W, H, opts,
        budget=None if budget is None else torch.from_numpy(budget),
    )
    out = out.numpy()
    d = np.abs(out[:3] - ref[:3]).max(axis=0)
    n_segs = int(segs.sum(dtype=torch.int64))
    stats = {
        "forked": float((d > 1e-3).mean()),
        "close": float((d <= 1e-5).mean()),
        "mean_abs": float(d.mean()),
        "cost_equal": float((out[3] == ref[3]).mean()),
        "seg_rel": (n_segs - ref_segs) / ref_segs,
        "segments": (n_segs, ref_segs),
    }
    if adaptive:
        stats["n_equal"] = bool(
            (out[4] == ref[4]).all() and (out[4] == budget).all()
        )
        dead = budget == 0
        stats["dead_zero"] = bool(
            (out[:, dead] == 0).all() and (ref[:, dead] == 0).all()
            and (segs.numpy()[dead] == 0).all()
        )
        stats["l2_close"] = float((np.abs(out[5] - ref[5]) <= 1e-5).mean())
    return stats


@pytest.mark.parametrize("adaptive, stratified", [
    (False, True), (True, False), (True, True),
], ids=["stratified", "adaptive", "adaptive_stratified"])
def test_variant_chunk_matches_interpret_kernel(adaptive, stratified):
    stats = variant_parity(adaptive, stratified)
    assert stats["forked"] <= MAX_FORKED_SHARE, stats
    assert stats["close"] >= MIN_CLOSE_SHARE, stats
    assert stats["mean_abs"] <= MAX_MEAN_ABS, stats
    assert stats["cost_equal"] >= MIN_COST_EQUAL, stats
    assert abs(stats["seg_rel"]) <= MAX_SEG_REL, stats
    if adaptive:
        assert stats["n_equal"] and stats["dead_zero"], stats
        assert stats["l2_close"] >= MIN_CLOSE_SHARE, stats


def small_inputs(adaptive: bool, stratified: bool, w=64, h=32):
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.scene import presets

    scene, cam, *_ = presets.get_config("cover", w, h)
    opts = TraceOptions(max_depth=8, russian_roulette_depth=3,
                        adaptive_tolerance=0.2 if adaptive else 0.0,
                        sampler="stratified" if stratified else "random")
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), "cpu")
    return tabs, opts, cw.identity_map(w, h, "cpu")


def test_adaptive_rows_of_the_profile_chunk():
    """Without a budget every lane takes the chunk's spp: rows 0-3 are
    bitwise the fixed kernel's, n is spp, and Σ lum² is bounded by
    n·max(lum)² with lum <= 1 per sample."""
    w, h, spp = 64, 32, 3
    tabs, opts, ident = small_inputs(True, False)
    fixed = dataclasses.replace(opts, adaptive_tolerance=0.0)
    a, sa = cw.cluster_walk(tabs, ident, 3, 2, spp, w, h, opts)
    f, sf = cw.cluster_walk(tabs, ident, 3, 2, spp, w, h, fixed)
    assert a.shape == (6, w * h) and f.shape == (4, w * h)
    assert torch.equal(a[:4], f) and torch.equal(sa, sf)
    assert torch.equal(a[4], torch.full((w * h,), float(spp)))
    assert float(a[5].min()) >= 0.0 and float(a[5].max()) <= spp
    # a 1-spp chunk's Σ lum² is the square of its mean rgb
    one, _ = cw.cluster_walk(tabs, ident, 3, 2, 1, w, h, opts)
    lum = (one[0] + one[1] + one[2]) * (1.0 / 3.0)
    assert torch.equal(one[5], lum * lum)


@pytest.mark.parametrize("stratified", [False, True],
                         ids=["random", "stratified"])
def test_budgeted_shuffled_map_bitwise_equals_identity(stratified):
    """Per-lane results depend only on the lane's pixel and budget: a
    shuffled map with its budgets shuffled alike gives bitwise the same
    per-pixel rows; a lane with budget b equals the same lane in a b-spp
    chunk; a lane without budget is all zeros."""
    w, h = 64, 32
    tabs, opts, ident = small_inputs(True, stratified)
    g = torch.Generator().manual_seed(5)
    budget = torch.randint(0, 4, (w * h,), generator=g, dtype=torch.int32)
    perm = torch.randperm(w * h, generator=g)
    a, sa = cw.cluster_walk(tabs, ident, 11, 3, 3, w, h, opts, budget=budget)
    b, sb = cw.cluster_walk(tabs, ident[perm].contiguous(), 11, 3, 3, w, h,
                            opts, budget=budget[perm].contiguous())
    back = torch.argsort(perm)
    assert torch.equal(b[:, back], a) and torch.equal(sb[back], sa)
    assert torch.equal(a[4], budget.to(torch.float32))
    dead = budget == 0
    assert not a[:, dead].any() and not sa[dead].any()
    for spp in (1, 2, 3):
        whole, sw = cw.cluster_walk(tabs, ident, 11, 3, spp, w, h, opts)
        lanes = budget == spp
        assert torch.equal(a[:, lanes], whole[:, lanes])
        assert torch.equal(sa[lanes], sw[lanes])


def test_stratified_changes_only_the_named_draws():
    """The stratified sampler leaves costs and images near the random
    sampler's (same marginals) but not equal, continues across chunks
    like the random one, and is a different stream per sample offset."""
    w, h = 64, 32
    tabs, opts, ident = small_inputs(False, True)
    rand = dataclasses.replace(opts, sampler="random")
    whole, sw = cw.cluster_walk(tabs, ident, 5, 0, 2, w, h, opts)
    a, sa = cw.cluster_walk(tabs, ident, 5, 0, 1, w, h, opts)
    b, sb = cw.cluster_walk(tabs, ident, 5, 1, 1, w, h, opts)
    assert torch.equal(a + b, whole) and torch.equal(sa + sb, sw)
    assert not torch.equal(a, b)
    r, _ = cw.cluster_walk(tabs, ident, 5, 0, 2, w, h, rand)
    assert not torch.equal(r, whole)
    assert abs(float(whole[:3].mean()) - float(r[:3].mean())) < 0.05


def test_wrapper_rejects_a_bad_budget():
    w, h = 64, 32
    tabs, opts, ident = small_inputs(True, False)
    good = torch.ones(w * h, dtype=torch.int32)
    with pytest.raises(ValueError, match="adaptive_tolerance"):
        cw.cluster_walk(tabs, ident, 1, 0, 1, w, h,
                        dataclasses.replace(opts, adaptive_tolerance=0.0),
                        budget=good)
    for bad in (good.to(torch.int64), good[:-1], good.to("meta"),
                torch.ones(2 * w * h, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="budget"):
            cw.cluster_walk(tabs, ident, 1, 0, 1, w, h, opts, budget=bad)


def test_variant_names():
    names = {cw.variant_name(variant_opts(TraceOptions, a, s))
             for a in (False, True) for s in (False, True)}
    assert names == {"cluster_walk", "cluster_walk_adaptive",
                     "cluster_walk_stratified",
                     "cluster_walk_adaptive_stratified"}


if __name__ == "__main__":
    # parity statistics; run as  python tests/test_torch_variants.py [seed...]
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    for seed in [int(s) for s in sys.argv[1:]] or [7]:
        for adaptive, stratified in ((False, True), (True, False),
                                     (True, True)):
            print(f"adaptive {adaptive} stratified {stratified} seed {seed}",
                  variant_parity(adaptive, stratified, seed), flush=True)
