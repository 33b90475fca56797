"""The plain PyTorch cluster walk against the TPU kernel run in interpret
mode (``pk._render_chunk_impl(..., interpret=True, caux=...)``): one
chunk of the cover at 128x64, 4 spp, depth 12, with Russian roulette from
bounce 5 and without, on the same partition, seed and JAX-derived camera
basis. Also the walk's own placement invariance and its input checks.

The integer RNG streams match bit for bit, but images cannot: a one-ulp
difference in a transcendental, or in a multiply-add, sometimes flips a
Schlick roll, a roulette roll or a grazing hit, and that path then
forks. XLA's CPU backend also contracts a·b + c into fused multiply-adds
inside its fusions, which the TPU kernel and the port (and its CUDA
kernel, built with -fmad=false) do not; that is most of the forking.
Measured with this file's ``__main__`` (seeds 7, 11-14):

- as the suite runs XLA: 2.4-3.2 % of pixels off by more than 1e-3,
  78-82 % within 1e-5, mean |delta| of the rgb sums 3.6e-3 to 4.4e-3,
  cost equal on 96.5-97.8 % of pixels, segment totals 0.05-0.36 % apart;
- with ``XLA_FLAGS=--xla_disable_hlo_passes=fusion`` (no contraction):
  0.16-0.2 % of pixels off by more than 1e-3, 99.4 % within 1e-5, mean
  |delta| 1.1e-4 to 1.7e-4, segment totals within 0.03 %.

The bounds below sit above the first set with margin.
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

W, H, SPP, DEPTH = 128, 64, 4, 12

MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3  # mean |delta| of the per-pixel rgb sums
MIN_COST_EQUAL = 0.95  # pixels with equal walk-iteration counts
MAX_SEG_REL = 6e-3  # segment totals


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain walk runs thousands of small tensor ops; with the test
    workers sharing the machine, PyTorch's intra-op threads only contend
    (measured 10x slower at 8 threads than at 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry_across(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def port_inputs(rr: int, w=W, h=H, depth=DEPTH):
    j_scene, j_cam, *_ = jax_presets.get_config("cover", w, h)
    scene = scene_from_numpy(**carry_across(j_scene))
    dcam = camera_from_numpy(carry_across(jax_derive_camera(j_cam)))
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=rr)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts), dcam,
                              "cpu")
    return tabs, opts


def jax_chunk(rr: int, seed: int, w=W, h=H, spp=SPP, depth=DEPTH,
              offset=0) -> tuple:
    """Per-pixel (4, h·w) [rgb sums, cost] and the segment total of one
    interpret-mode chunk, pixel order py·w + px."""
    j_scene, j_cam, *_ = jax_presets.get_config("cover", w, h)
    opts = JaxOptions(max_depth=depth, russian_roulette_depth=rr)
    part = pk._cluster_partition(j_scene, opts)
    out = pk._render_chunk_impl(
        part.scene, jax_derive_camera(j_cam), jnp.int32(seed), offset, w, h,
        spp, opts, 8, True, caux=(part.boxes, part.uuid),
        n_global=part.n_global, k_slots=1,
    )
    flat = np.asarray(pk._tiles_to_flat(out, w, h, 8, 1))
    flat = flat.reshape(4, -1, pk.LANES)[:, :h, :w].reshape(4, -1)
    return flat, int(np.asarray(out)[:, 4, 0, 0].sum())


def chunk_parity(rr: int, seed: int, w=W, h=H, spp=SPP, depth=DEPTH,
                 offset=0) -> dict:
    ref, ref_segs = jax_chunk(rr, seed, w, h, spp, depth, offset)
    tabs, opts = port_inputs(rr, w, h, depth)
    out, segs = cw.cluster_walk(tabs, cw.identity_map(w, h, "cpu"), seed,
                                offset, spp, w, h, opts)
    out = out.numpy()
    d = np.abs(out[:3] - ref[:3]).max(axis=0)
    n_segs = int(segs.sum(dtype=torch.int64))
    return {
        "forked": float((d > 1e-3).mean()),
        "close": float((d <= 1e-5).mean()),
        "mean_abs": float(d.mean()),
        "cost_equal": float((out[3] == ref[3]).mean()),
        "seg_rel": (n_segs - ref_segs) / ref_segs,
        "segments": (n_segs, ref_segs),
    }


@pytest.mark.parametrize("rr", [5, 0])
def test_chunk_matches_interpret_kernel(rr):
    stats = chunk_parity(rr, seed=7)
    assert stats["forked"] <= MAX_FORKED_SHARE, stats
    assert stats["close"] >= MIN_CLOSE_SHARE, stats
    assert stats["mean_abs"] <= MAX_MEAN_ABS, stats
    assert stats["cost_equal"] >= MIN_COST_EQUAL, stats
    assert abs(stats["seg_rel"]) <= MAX_SEG_REL, stats


def test_unpadded_width_and_sample_offset(monkeypatch):
    """The RNG's pixel id keeps the TPU's padded row width (gid = py·wp +
    px, wp = ceil(W/128)·128) and the draw counters continue from the
    chunk's sample offset. At W = 72 (wp = 128), offset 5, 2 spp, depth 8,
    roulette from bounce 5, the walk agrees with the kernel as closely as
    the 128-wide chunk does (measured on seeds 7, 11, 12: 1.4-1.7 % of
    pixels forked, 87 % within 1e-5, mean |delta| 2.5e-3 to 3.6e-3, cost
    equal on 98.4-98.8 %, segment totals within 0.4 %). Keyed on
    gid = py·W + px instead, 6 % of pixels stay within 1e-5."""
    w, h, spp, depth, offset = 72, 16, 2, 8, 5
    ref, ref_segs = jax_chunk(5, 7, w, h, spp, depth, offset)
    tabs, opts = port_inputs(5, w, h, depth)
    ident = cw.identity_map(w, h, "cpu")

    def close_share():
        out, segs = cw.cluster_walk(tabs, ident, 7, offset, spp, w, h, opts)
        d = np.abs(out.numpy()[:3] - ref[:3]).max(axis=0)
        n_segs = int(segs.sum(dtype=torch.int64))
        assert abs(n_segs - ref_segs) <= MAX_SEG_REL * ref_segs
        assert (d > 1e-3).mean() <= MAX_FORKED_SHARE
        assert d.mean() <= MAX_MEAN_ABS
        return float((d <= 1e-5).mean())

    assert close_share() >= MIN_CLOSE_SHARE
    monkeypatch.setattr(cw, "padded_width", lambda width: width)
    with pytest.raises(AssertionError):
        close_share()


def test_exact_q_sentinels():
    """The exact sphere test never yields NaN: a negative discriminant
    poisons the root to -3e38, which absorbs into the 3e38 fill (no
    candidate); a sphere behind the ray is no candidate; an origin inside
    the sphere takes the far root; otherwise the near root, as q = t·|d|²."""
    f = lambda *v: torch.tensor(v, dtype=torch.float32)
    # spheres at x = 5 (r 1), x = -5 (r 1), the origin (r 2), y = 5 (r 1)
    cx, cy, cz = f(5, -5, 0, 0), f(0, 0, 0, 5), f(0, 0, 0, 0)
    k1 = cx * cx + cy * cy + cz * cz - f(1, 1, 4, 1)
    o = [torch.zeros(4) for _ in range(3)]
    d = [f(2, 2, 2, 2), torch.zeros(4), torch.zeros(4)]
    a = d[0] * d[0]
    q = cw._exact_q(cx, cy, cz, k1, *o, *d, a, torch.zeros(4), torch.zeros(4),
                    0.001 * a)
    fill = torch.tensor(cw.FILLQ, dtype=torch.float32)
    assert not torch.isnan(q).any()
    assert float(q[0]) == 2.0 * 4.0  # near root t = 2, |d|² = 4
    assert torch.equal(q[1], fill)  # behind the ray
    assert float(q[2]) == 1.0 * 4.0  # inside: far root t = 1
    assert torch.equal(q[3], fill)  # missed: poisoned, then filled


def test_shuffled_map_bitwise_equals_identity():
    """Per-lane results depend only on the lane's pixel: any lane order
    gives bitwise the same per-pixel sums, costs and segment total."""
    tabs, opts = port_inputs(5)
    ident = cw.identity_map(W, H, "cpu")
    perm = torch.randperm(W * H, generator=torch.Generator().manual_seed(1))
    a, sa = cw.cluster_walk(tabs, ident, 11, 3, 2, W, H, opts)
    b, sb = cw.cluster_walk(tabs, ident[perm].contiguous(), 11, 3, 2, W, H,
                            opts)
    assert torch.equal(b[:, torch.argsort(perm)], a)
    assert torch.equal(sb[torch.argsort(perm)], sa)


def test_sample_offset_continues_the_stream():
    """Two chunks of 1 spp at offsets 0 and 1 trace the same paths as one
    2-spp chunk, and a pixel's two samples add in the same order: equal
    bit for bit."""
    tabs, opts = port_inputs(5)
    ident = cw.identity_map(W, H, "cpu")
    whole, sw = cw.cluster_walk(tabs, ident, 5, 0, 2, W, H, opts)
    a, sa = cw.cluster_walk(tabs, ident, 5, 0, 1, W, H, opts)
    b, sb = cw.cluster_walk(tabs, ident, 5, 1, 1, W, H, opts)
    assert torch.equal(a + b, whole)
    assert torch.equal(sa + sb, sw)


def test_wrapper_rejects_bad_inputs():
    tabs, opts = port_inputs(5)
    ident = cw.identity_map(W, H, "cpu")
    with pytest.raises(ValueError, match="pixel_map"):
        cw.cluster_walk(tabs, ident.to(torch.int64), 1, 0, 1, W, H, opts)
    with pytest.raises(ValueError, match="pixel_map"):
        cw.cluster_walk(tabs, ident.t(), 1, 0, 1, W, H, opts)
    with pytest.raises(ValueError, match="float32"):
        bad = dataclasses.replace(tabs, winner=tabs.winner.double())
        cw.cluster_walk(bad, ident, 1, 0, 1, W, H, opts)
    with pytest.raises(ValueError, match="shapes"):
        bad = dataclasses.replace(tabs, winner=tabs.winner[:-1].contiguous())
        cw.cluster_walk(bad, ident, 1, 0, 1, W, H, opts)
    with pytest.raises(ValueError, match="spp"):
        cw.cluster_walk(tabs, ident, 1, 0, 0, W, H, opts)
    with pytest.raises(ValueError, match="is on"):
        cw.cluster_walk(tabs, ident.to("meta"), 1, 0, 1, W, H, opts)
    with pytest.raises(ValueError, match="no cluster walk for device"):
        cw.cluster_walk(tabs.to("meta"), ident.to("meta"), 1, 0, 1, W, H,
                        opts)


if __name__ == "__main__":
    # parity statistics over several seeds; run as
    #   python tests/test_torch_walk.py
    #   XLA_FLAGS=--xla_disable_hlo_passes=fusion python tests/test_torch_walk.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    seeds = [int(s) for s in sys.argv[1:]] or [7, 11, 12, 13, 14]
    for rr in (5, 0):
        for seed in seeds:
            print(f"rr{rr} seed {seed}", chunk_parity(rr, seed), flush=True)
