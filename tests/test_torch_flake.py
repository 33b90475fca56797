"""Scenes past the flat scan and past a 128-cluster partition: the SPD
sphereflake (``presets.sphereflake_scene``, 7,381 spheres and a floor,
462 kd clusters) and a scene of 2,100 random spheres (132 clusters),
both through the wide walk's plain version on the CPU.

- the preset is the SPD's ``balls`` at size factor 4: its sphere count,
  radii and extents, and its nine child directions;
- ``render_image``'s default options choose the cluster walk for it (the
  wide walk: 9 key bits, the grandparent boxes), and the flat scan's
  refusal of a larger table names the limit that applies;
- the plain walk renders the sphereflake bit for bit as the benchmark's
  plain reference (``benchmark/reference.py``) does, as it does the
  cover (``benchmark/tests/test_bench_reference.py``);
- the 2,100-sphere scene against the JAX package's interpret-mode
  ``render_image_pallas``, which renders it with its flat scan, within
  the bounds ``test_torch_render.py`` sets for the cover, for the same
  reasons;
- the kd partition, built a level of the tree at a time, is the JAX
  package's recursive one: the same slots, boxes and globals, on the
  sphereflake and on seeded scenes with tied centres.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import reference, schedule
from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import accel as jax_accel
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu.scene.spheres import Scene as JaxScene
from raytracer_tpu_torch.camera.camera import camera_from_numpy, derive_camera
from raytracer_tpu_torch.render import api, megakernel, tables
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import flat_scan as fs
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.accel import build_grid_clustered
from raytracer_tpu_torch.scene.spheres import Scene
from raytracer_tpu_torch.scripts import walk_ab


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flake():
    return presets.sphereflake_scene()


def test_sphereflake_is_the_spd_balls_at_size_factor_4(flake):
    host = flake.numpy()
    c, r = host["center"][1:], host["radius"][1:]
    assert flake.count == 7382 and len(r) == 7381 == sum(
        9 ** d for d in range(5))
    # slot 0, the floor: a diffuse sphere whose top is the plane z = -0.5
    assert host["center"][0].tolist() == [0.0, 0.0, -1000.5]
    assert host["radius"][0] == 1000.0 and host["material_type"][0] == 0
    assert (host["material_type"][1:] == 1).all()
    assert (host["fuzz"][1:] == 0.0).all()
    # radii 0.5 / 3^d, 9^d spheres of each, depth first from the root
    want = [np.float32(0.5 / 3 ** d) for d in range(5)]
    got = sorted(set(r.tolist()), reverse=True)
    assert np.allclose(got, want, rtol=1e-6)
    assert r.min() == pytest.approx(0.00617, abs=1e-5)
    for d, rad in enumerate(got):
        assert int((r == rad).sum()) == 9 ** d
    assert r[0] == 0.5 and r[1] == got[1] and r[2] == got[2]
    lo, hi = (c - r[:, None]).min(0), (c + r[:, None]).max(0)
    np.testing.assert_allclose(lo, [-0.937, -0.937, -0.5], atol=5e-4)
    np.testing.assert_allclose(hi, [0.951, 0.951, 0.831], atol=5e-4)
    # each child touches its parent: the root's nine, each the head of a
    # subtree of 820, lie at 4/3 of its radius from it
    kids = c[1::820]
    assert len(kids) == 9 and (r[1::820] == got[1]).all()
    np.testing.assert_allclose(np.linalg.norm(kids, axis=1), 2.0 / 3.0,
                               rtol=1e-6)


def test_sphereflake_directions():
    """Six on the equator at azimuths 15 + 60m degrees, three at
    elevation asin(2/sqrt(6)) (54.74) at azimuths 45, 165, 285."""
    d = presets.sphereflake_directions()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-12)
    elev = np.degrees(np.arcsin(d[:, 2]))
    az = np.degrees(np.arctan2(d[:, 1], d[:, 0])) % 360.0
    up = elev > 1.0
    assert up.sum() == 3
    np.testing.assert_allclose(elev[up], math.degrees(math.asin(
        2.0 / math.sqrt(6.0))), atol=1e-9)
    np.testing.assert_allclose(elev[~up], 0.0, atol=1e-9)
    np.testing.assert_allclose(sorted(az[up]), [45.0, 165.0, 285.0],
                               atol=1e-9)
    np.testing.assert_allclose(sorted(az[~up]),
                               [15.0 + 60.0 * m for m in range(6)],
                               atol=1e-9)


def test_default_options_choose_the_wide_walk(flake):
    """``cluster_scan='auto'`` takes the walk for 7,382 slots: 462
    clusters and the floor as its one global, past the narrow walk's 128,
    so the wide walk's layout (the box levels up to the root, shared
    memory without the winner rows, a list of 85 entries a thread) and 9
    key bits; the flat scan is never asked."""
    opts = TraceOptions()
    assert opts.cluster_scan == "auto"
    choice = megakernel.choose_kernel(
        flake, derive_camera(presets.sphereflake_camera(64, 64)), opts,
        "cpu")
    assert choice.kernel == "cluster_walk"
    tabs = choice.tables
    k, group = tabs.members.shape[:2]
    assert (k, group, tabs.globals.shape[0]) == (462, 16, 1)
    assert tables.is_wide(k) and tables.key_bits(k) == 9
    lay = tables.walk_layout(1, k, group)
    assert (lay.n_parents, lay.n_grand) == (116, 29)
    # the levels past the grandparents up to the root: 8, 2, 1
    assert tables.upper_levels(k) == [8, 2, 1] and lay.n_top == 11
    assert tabs.parents.shape == (156, 6)
    assert tables.wide_smem_bytes(lay) <= tables.MAX_WALK_SMEM_BYTES
    assert tables.wide_list_capacity(lay) == 85
    assert 4 * lay.n_floats > tables.MAX_WALK_SMEM_BYTES
    assert cw.variant_name(opts, True) == "cluster_walk_wide"


def test_walk_limits_and_the_flat_scans_message():
    """The narrow walk keeps 7 key bits up to 128 clusters; past 512 the
    walk refuses the partition and the scene falls to the flat scan,
    whose refusal names its own limit and the walk's."""
    assert tables.key_bits(128) == 7 and not tables.is_wide(128)
    assert tables.walk_fits(1, 512, 16)
    assert not tables.walk_fits(1, 513, 16)
    assert not tables.walk_fits(0, 0, 16)
    assert not tables.walk_fits(1, 500, 64)  # its tables pass 227 KiB
    # 1,026 small spheres in clusters of 2: 513 clusters, 1,027 slots
    big = walk_ab.random_scene(1026)
    opts = TraceOptions(cluster_group=2)
    assert build_grid_clustered(big, group=2, partition="kd").boxes.shape[
        0] == 513
    assert tables.cluster_partition(big, opts) is None
    with pytest.raises(ValueError) as err:
        api.render_image(big, presets.sphereflake_camera(4, 4), 4, 4, 1, 0,
                         opts, device="cpu")
    msg = str(err.value)
    assert f"at most {fs.MAX_SLOTS} slots" in msg and fs.MAX_SLOTS == 1022
    assert "1 to 512 clusters" in msg and "cluster_scan=True)" not in msg


def test_plain_walk_renders_the_sphereflake_as_the_reference(flake):
    """16x16, 2 spp, depth 6, the SPD's camera: the image and the exact
    segment total bit for bit the plain reference's."""
    w = h = 16
    spp, depth = 2, 6
    arrays = flake.numpy()
    basis = reference.camera_basis((2.1, 1.3, 1.7), (0, 0, 0), 45.0, 0.0,
                                   2.9983, w / h, (0.0, 0.0, 1.0))
    key = np.array([0x9E3779B9, 2**31 + 3], np.uint32)
    img, st = api.render_image(flake, camera_from_numpy(basis), w, h, spp,
                               key, TraceOptions(max_depth=depth), None,
                               True, device="cpu")
    px = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2)
    sizes = schedule.fixed_sizes(spp, w * h, len(arrays["radius"]), depth)
    got, segs = reference.fixed_pixels(
        arrays, reference.cam19(basis), w, h, reference.kernel_seed(key),
        px, spp, depth, sizes)
    want = img[torch.as_tensor(px[:, 1]), torch.as_tensor(px[:, 0])]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(segs.sum()) == st["segments_exact"]
    # the flake and the floor are both in view: not all sky
    assert 0.0 < float(img.min()) and float(img.std()) > 0.05


def test_2100_spheres_match_render_image_pallas():
    """A ground and 2,100 random small spheres (132 clusters) at 128x8,
    1 spp, depth 12, roulette from bounce 5, through the port's wide walk
    (plain) and the JAX package's flat scan in interpret mode, the
    JAX-derived cover camera carried across, gamma off. The bounds of
    ``test_render_matches_render_image_pallas``."""
    w, h, spp, depth = 128, 8, 1, 12
    scene = walk_ab.random_scene(2100, seed=3)
    host = scene.numpy()
    j_scene = JaxScene(**{k: jnp.asarray(v) for k, v in host.items()})
    _, j_cam, *_ = jax_presets.get_config("cover", w, h)
    dcam = jax_derive_camera(j_cam)
    jopts = JaxOptions(max_depth=depth, russian_roulette_depth=5,
                       gamma=False)
    ref, ref_stats = pk.render_image_pallas(
        j_scene, dcam, w, h, spp, jax.random.PRNGKey(3), jopts,
        return_stats=True)
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=5,
                        gamma=False)
    part = tables.cluster_partition(scene, opts)
    assert part.boxes.shape[0] == 132 and tables.is_wide(132)
    img, stats = api.render_image(
        scene, camera_from_numpy({f.name: np.asarray(getattr(dcam, f.name))
                                  for f in dataclasses.fields(dcam)}),
        w, h, spp, 3, opts, return_stats=True, device="cpu")
    d = np.abs(img.numpy() - np.asarray(ref)).max(axis=-1) * spp
    assert (d > 1e-3).mean() <= 0.05
    assert (d <= 1e-5).mean() >= 0.70
    assert d.mean() <= 8e-3
    ref_segs = float(ref_stats["segments"])
    assert abs(stats["segments_exact"] - ref_segs) <= 6e-3 * ref_segs


def _same_partition(scene, group):
    host = scene.numpy()
    j_scene = JaxScene(**{k: jnp.asarray(v) for k, v in host.items()})
    got = build_grid_clustered(scene, group=group, partition="kd")
    want = jax_accel.build_grid_clustered(j_scene, group=group,
                                          partition="kd")
    assert got.n_global == int(want.n_global)
    np.testing.assert_array_equal(got.uuid, np.asarray(want.uuid))
    np.testing.assert_array_equal(got.boxes, np.asarray(want.boxes))
    assert got.boxes.dtype == np.float32 and got.uuid.dtype == np.int32
    return got


@pytest.mark.parametrize("group", [16, 4])
def test_flake_partition_is_the_jax_packages(flake, group):
    got = _same_partition(flake, group)
    assert got.boxes.shape[0] == -(-7381 // group)


@pytest.mark.parametrize("seed, n, group", [
    (0, 700, 16), (1, 333, 4), (2, 97, 1), (3, 1000, 64), (4, 2100, 16),
    (5, 5, 8)])
def test_kd_partition_is_the_jax_packages(seed, n, group):
    """Seeded scenes, every other one with centres on a half-unit grid
    (ties in the sort that the recursion keeps in its parent's order),
    and a tenth of the radii negative."""
    scene = walk_ab.random_scene(n, seed)
    centre, radius = scene.center, scene.radius
    if seed % 2 == 0:
        centre = torch.round(centre * 2.0) / 2.0
    g = torch.Generator().manual_seed(seed)
    flip = torch.rand(radius.shape, generator=g) < 0.1
    radius = torch.where(flip & (radius < 1.0), -radius, radius)
    _same_partition(Scene(**{**{f: getattr(scene, f) for f in (
        "material_type", "albedo", "fuzz", "refraction_index", "active")},
        "center": centre, "radius": radius}), group)
