"""The port's whole adaptive render against ``pk.render_image_pallas`` in
interpret mode, for the random and the stratified sampler: the cover at
128x32, 17 spp as chunks [1, 4, 4, 4, 4] (forced on both sides), depth 6,
roulette from bounce 3, tolerance 0.3, ``ADAPTIVE_MIN_N`` patched to 4 on
both sides so pixels may stop, gamma off.

A stop is a threshold on float32 statistics of paths that fork between
the two libraries (see ``test_torch_walk``), so per-pixel sample counts
agree on most pixels, never on all. Measured (seed 3): ``spp_map`` equal
on 98.6 % (random) and 98.7 % (stratified) of pixels; mean spp 9.035
against 9.045 and 9.082 against 9.073; 4.9 % and 4.8 % of pixels off by
more than 1e-3 in the image (means, not sums), 88.5 % and 87.8 % within
1e-5, mean |delta| 1.2e-3 and 1.0e-3; segment totals 0.10 % and 0.15 %
apart. The bounds sit above that with margin."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu_torch.camera.camera import camera_from_numpy
from raytracer_tpu_torch.render import api, schedule
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

W, H, SPP, DEPTH, CHUNK, TOL = 128, 32, 17, 6, 2, 0.3

MIN_MAP_EQUAL = 0.95  # pixels with the same sample count
MAX_MEAN_SPP_REL = 0.02
MAX_FORKED_SHARE = 0.10  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 4e-3
MAX_SEG_REL = 0.01


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry_across(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_adaptive_render_matches_render_image_pallas(monkeypatch, sampler):
    for mod, name in ((pk, "_pick_chunk_spp"), (schedule, "pick_chunk_spp")):
        monkeypatch.setattr(mod, name, lambda spp, *a, **k: min(spp, CHUNK))
    monkeypatch.setattr(pk, "ADAPTIVE_MIN_N", 4)
    monkeypatch.setattr(schedule, "ADAPTIVE_MIN_N", 4)
    assert schedule.adaptive_schedule(SPP, CHUNK, 0, True) == [1, 4, 4, 4, 4]
    kw = dict(max_depth=DEPTH, russian_roulette_depth=3, gamma=False,
              adaptive_tolerance=TOL, sampler=sampler)
    j_scene, j_cam, *_ = jax_presets.get_config("cover", W, H)
    dcam = jax_derive_camera(j_cam)
    ref, ref_stats = pk.render_image_pallas(
        j_scene, dcam, W, H, SPP, jax.random.PRNGKey(3), JaxOptions(**kw),
        return_stats=True,
    )
    img, stats = api.render_image(
        scene_from_numpy(**carry_across(j_scene)),
        camera_from_numpy(carry_across(dcam)), W, H, SPP, 3,
        TraceOptions(**kw), return_stats=True, device="cpu",
    )
    spp_map = stats["spp_map"].numpy()
    ref_map = np.asarray(ref_stats["spp_map"])
    assert spp_map.shape == ref_map.shape == (H, W)
    assert (spp_map == ref_map).mean() >= MIN_MAP_EQUAL
    # both stopped pixels early, at the same chunk boundaries
    assert set(np.unique(spp_map)) == set(np.unique(ref_map))
    assert 5.0 <= spp_map.min() and spp_map.min() < spp_map.max() <= SPP
    ref_mean = float(ref_stats["mean_spp"])
    assert abs(stats["mean_spp"] - ref_mean) <= MAX_MEAN_SPP_REL * ref_mean
    d = np.abs(img.numpy() - np.asarray(ref)).max(axis=-1)
    assert (d > 1e-3).mean() <= MAX_FORKED_SHARE
    assert (d <= 1e-5).mean() >= MIN_CLOSE_SHARE
    assert d.mean() <= MAX_MEAN_ABS
    ref_segs = float(ref_stats["segments"])
    assert abs(stats["segments_exact"] - ref_segs) <= MAX_SEG_REL * ref_segs
