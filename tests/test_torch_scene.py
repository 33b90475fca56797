"""Port parity of the cover render's host side: presets, the kd
partition, the walk tables, the camera basis, the numpy carry-over and
the launch schedule, each against the JAX package on the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu_torch.camera.camera import (
    CameraConfig,
    DerivedCamera,
    camera_from_numpy,
    derive_camera,
)
from raytracer_tpu_torch.render import schedule, tables
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.spheres import Scene, scene_from_numpy

SCENE_FIELDS = ("center", "radius", "material_type", "albedo", "fuzz",
                "refraction_index", "active")


def jax_fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def port_fields(obj) -> dict:
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("config", sorted(presets.BASELINE_CONFIGS))
def test_presets_equal(config):
    """Every preset builds the same scene arrays as the JAX package (the
    cover is drawn from the same numpy generator), and the same camera
    primitives."""
    scene, cam, *rest = presets.get_config(config, 160, 90)
    j_scene, j_cam, *j_rest = jax_presets.get_config(config, 160, 90)
    assert rest == j_rest
    a, b = port_fields(scene), jax_fields(j_scene)
    assert set(a) == set(SCENE_FIELDS)
    for name in SCENE_FIELDS:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    a, b = port_fields(cam), jax_fields(j_cam)
    for name in b:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_cover_kd_partition_equal():
    """The kd partition of the cover: 4 globals and K = 31 leaves of 16,
    with equal slot order (uuid), boxes and reordered scene."""
    opts = TraceOptions()
    part = tables.cluster_partition(presets.cover_scene(), opts)
    j_part = pk._cluster_partition(jax_presets.cover_scene(), JaxOptions())
    assert part.n_global == j_part.n_global == 4
    assert part.boxes.shape == (31, 6)
    np.testing.assert_array_equal(part.uuid, np.asarray(j_part.uuid))
    np.testing.assert_array_equal(part.boxes, np.asarray(j_part.boxes))
    a, b = port_fields(part.scene), jax_fields(j_part.scene)
    for name in SCENE_FIELDS:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_walk_tables_bitwise_equal_jax_tables():
    """globals, box bounds, member and winner tables equal the entries of
    ``pk._cluster_tables`` bit for bit (k1 = (x·x + y·y) + z·z − r·r in
    float32, the JAX reduction's order), minus the TPU layouts: no
    padding rows, no sublane broadcast, no 128-lane banks."""
    part = tables.cluster_partition(presets.cover_scene(), TraceOptions())
    j_part = pk._cluster_partition(jax_presets.cover_scene(), JaxOptions())
    glob, bounds, members, winner = tables.cluster_tables(
        part.scene, part.boxes, part.uuid, part.n_global, part.group
    )
    btab, mtab, wtab, gflat = (
        np.asarray(t) for t in pk._cluster_tables(
            j_part.scene, j_part.boxes, j_part.uuid, j_part.n_global, 16, 8
        )
    )
    k, group = members.shape[:2]
    slots = winner.shape[0]
    n_banks = -(-slots // 128)
    np.testing.assert_array_equal(glob.numpy(), gflat.reshape(-1, 4))
    np.testing.assert_array_equal(bounds.numpy(), btab[:k])
    jm = mtab[:, 0, :k].reshape(group, 4, k).transpose(2, 0, 1)
    np.testing.assert_array_equal(members.numpy(), jm)
    jw = (wtab[:, 0, :].reshape(11, n_banks * 128)[:, :slots]).T
    np.testing.assert_array_equal(winner.numpy(), jw)


def test_slot_encoding_k1_order():
    """k1 sums the squared center as (x·x + y·y) + z·z: bitwise the JAX
    encoding on random scenes, including inactive and far slots."""
    rng = np.random.default_rng(3)
    n = 257
    fields = dict(
        center=(rng.standard_normal((n, 3)) * 50).astype(np.float32),
        radius=rng.uniform(-2, 2, n).astype(np.float32),
        material_type=rng.integers(0, 3, n).astype(np.int32),
        albedo=rng.random((n, 3)).astype(np.float32),
        fuzz=rng.random(n).astype(np.float32),
        refraction_index=rng.uniform(1, 2, n).astype(np.float32),
        active=(rng.random(n) > 0.2).astype(np.float32),
    )
    fields["center"][:3] = 2e5  # beyond MAX_T: encoded unhittable
    j_scene = type(jax_presets.cover_scene())(
        **{k: jnp.asarray(v) for k, v in fields.items()}
    )
    act, c, k1 = tables.slot_encoding(scene_from_numpy(**fields))
    j_act, j_c, j_k1 = (np.asarray(t) for t in pk._slot_encoding(j_scene))
    np.testing.assert_array_equal(act.numpy(), j_act)
    np.testing.assert_array_equal(c.numpy(), j_c)
    np.testing.assert_array_equal(k1.numpy(), j_k1)


#: float32 ulps between the port's and the JAX package's camera basis
#: (measured at most 2, on the demo camera):
#: tan/sin/cos differ by an ulp between the two libraries' float32
#: kernels and the basis compounds a few of them
CAMERA_MAX_ULP = 4


@pytest.mark.parametrize("config", ["cover", "dof", "demo", "two_sphere"])
def test_derive_camera_within_ulps(config):
    _, cam, *_ = presets.get_config(config, 160, 90)
    _, j_cam, *_ = jax_presets.get_config(config, 160, 90)
    a = port_fields(derive_camera(cam))
    b = jax_fields(jax_derive_camera(j_cam))
    for name, ref in b.items():
        np.testing.assert_array_max_ulp(
            a[name], ref.astype(np.float32), maxulp=CAMERA_MAX_ULP
        )


def test_from_numpy_round_trip():
    """Scene, CameraConfig and DerivedCamera fields carry across from the
    JAX dataclasses unchanged, and back out equal."""
    j_scene = jax_presets.cover_scene()
    scene = scene_from_numpy(**jax_fields(j_scene))
    assert isinstance(scene, Scene)
    for name, ref in jax_fields(j_scene).items():
        np.testing.assert_array_equal(scene.numpy()[name], ref)
    j_cam = jax_presets.cover_camera(1200, 800)
    cfg = camera_from_numpy(jax_fields(j_cam))
    assert isinstance(cfg, CameraConfig)
    dcam = camera_from_numpy(jax_fields(jax_derive_camera(j_cam)))
    assert isinstance(dcam, DerivedCamera)
    for obj, j_obj in ((cfg, j_cam), (dcam, jax_derive_camera(j_cam))):
        for name, ref in jax_fields(j_obj).items():
            got = getattr(obj, name)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="unknown"):
        camera_from_numpy({"origin": np.zeros(3), "bogus": 1.0})


SCHEDULE_GRID = [(500, 85), (500, 42), (100, 85), (8, 3), (10, 3), (1, 5),
                 (86, 85), (10000, 85), (100000, 85), (7300, 85),
                 (173, 86), (3, 7), (64, 17), (999, 2)]


def test_schedule_equals_jax():
    """``pick_chunk_spp`` / ``chunk_schedule`` equal the JAX functions over
    a grid of inputs; the full-size cover gives [41, 153, 153, 153]."""
    for spp, chunk in SCHEDULE_GRID:
        assert schedule.chunk_schedule(spp, chunk) == pk._chunk_schedule(
            spp, chunk
        ), (spp, chunk)
    for spp in (1, 4, 10, 500, 4096):
        for p in (64 * 32, 1200 * 800, 1920 * 1080):
            for s_count, depth, rr in ((487, 50, 5), (487, 50, 0),
                                       (9, 8, 0), (2, 2, 1)):
                assert schedule.pick_chunk_spp(
                    spp, p, s_count, depth, rr
                ) == pk._pick_chunk_spp(spp, p, s_count, depth, rr)
    chunk = schedule.pick_chunk_spp(500, 1200 * 800, 487, 50, 5)
    assert schedule.chunk_schedule(500, chunk) == ([41, 153, 153, 153],
                                                    True)
