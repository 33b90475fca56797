"""Tests of the port that need a CUDA card; each skips without one.

On the card, from the repository root (the suite's conftest imports jax,
which the port's machine need not have):

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import pytest
import torch

from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.render import api, tables
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import presets

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
    out_k, seg_k = cw.cluster_walk(*args)
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
