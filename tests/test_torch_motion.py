"""Scenes with a shutter (moving spheres, the checker texture) through the
motion walk, on the CPU: the walk's plain twin against the benchmark's
plain reference ``benchmark/reference_motion.py``, bitwise against the
narrow walk on a still scene; the swept boxes; planted faults; the
refusals; and static scenes' tables as they were.

Every render is tiny (32x18, a few spp) and runs torch on one thread.
The comparison numbers are ``benchmark/harness.py``'s: the share of
pixels whose largest channel gap passes 1e-4 (``mismatch``), the largest
gap (``gap``), and |segments / the reference's - 1| (``segment_gap``),
here over every pixel."""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as port
from benchmark import reference, reference_motion
from benchmark import schedule as bench_schedule
from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import megakernel, tables
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import accel, presets
from raytracer_tpu_torch.scene.materials import CHECKER, Material
from raytracer_tpu_torch.scene.spheres import (
    MotionScene,
    Scene,
    as_motion,
    is_motion,
    scene_from_numpy,
    update_sphere,
)

W, H = 32, 18
#: bounds of the port against the reference, each above the largest
#: reading of the sound scenes below (the bouncing spheres at depth 12,
#: three random moving scenes and the faults' scene, 4 spp): mismatch 0,
#: gap 0, segment gap 0 in every one (the plain twin and the reference
#: form every value in the same order); so a bound of one pixel in a
#: hundred, 1e-3 and 1e-3 sits above them with room, and below every
#: planted fault's reading (test_planted_faults_read_worse)
BOUNDS = {"mismatch": 0.01, "gap": 1e-3, "segment_gap": 1e-3}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def opts_of(depth: int, **kw) -> TraceOptions:
    return TraceOptions(max_depth=depth, russian_roulette_depth=0,
                        exhaust_black=False, near_zero_guard=False, **kw)


def basis_of(lookfrom, lookat, vfov, aperture, focus):
    return reference.camera_basis(lookfrom, lookat, vfov, aperture, focus,
                                  W / H)


#: the cover's and the bouncing spheres' camera, as the benchmark forms it
BOOK = basis_of((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 20.0, 0.1, 10.0)


def compare(scene, arrays, basis, spp=4, depth=12, key=(0x5EED, 9),
            sampler="random") -> dict:
    """The port's render of ``scene`` against the reference's of
    ``arrays`` (each field of a scene with a shutter), at every pixel."""
    key = np.array(key, np.uint32)
    img, st = port.render_image(scene, port.camera_from_numpy(basis), W, H,
                                spp, key, opts_of(depth, sampler=sampler),
                                None, True, device="cpu")
    flat = np.arange(W * H)
    pix = np.stack([flat % W, flat // W], 1)
    n_sph = arrays["center"].shape[0]
    sizes = bench_schedule.fixed_sizes(spp, W * H, n_sph, depth)
    ref_img, ref_segs = reference_motion.fixed_pixels(
        arrays, reference.cam19(basis), W, H, reference.kernel_seed(key),
        pix, spp, depth, sizes, sampler)
    got = img[torch.as_tensor(pix[:, 1]), torch.as_tensor(pix[:, 0])]
    gap = (got - ref_img).abs().amax(1)
    return {"mismatch": float((gap > 1e-4).float().mean()),
            "gap": float(gap.max()),
            "segment_gap": abs(st["segments_exact"]
                               / float(ref_segs.sum()) - 1.0)}


def within(readings: dict) -> bool:
    return all(readings[k] <= v for k, v in BOUNDS.items())


def random_moving_scene(seed: int) -> MotionScene:
    """A checker ground, two big spheres (one moving) and 40 small ones
    of every material, about 70 % of them moving by up to 0.8 in any
    direction."""
    rng = np.random.default_rng(seed)
    mats = [Material.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)),
            Material.glass(1.5), Material.metal((0.7, 0.6, 0.5), 0.1)]
    centers = [(0.0, -1000.0, 0.0), (0.0, 1.0, 0.0), (-2.5, 1.0, 0.5)]
    ends = [centers[0], centers[1], (-2.5, 1.6, 0.2)]
    radii = [1000.0, 1.0, 1.0]
    for _ in range(40):
        c = (rng.uniform(-3, 3), rng.uniform(0.2, 1.0), rng.uniform(-3, 3))
        kind = rng.integers(0, 4)
        mats.append([Material.diffuse(tuple(rng.random(3))),
                     Material.metal(tuple(rng.random(3) * 0.5 + 0.5),
                                    float(rng.random() * 0.3)),
                     Material.glass(1.5),
                     Material.checker(tuple(rng.random(3)),
                                      tuple(rng.random(3)))][kind])
        move = (rng.uniform(-0.8, 0.8, 3) if rng.random() < 0.7
                else np.zeros(3))
        centers.append(c)
        ends.append(tuple(np.asarray(c) + move))
        radii.append(float(rng.uniform(0.15, 0.3)))
    scene = port.make_scene(list(zip(centers, radii, mats)))
    return dataclasses.replace(scene, center1=torch.tensor(
        np.array(ends, np.float32)))


RANDOM_BASIS = basis_of((8.0, 2.0, 3.0), (0.0, 0.5, 0.0), 35.0, 0.05, 8.0)


def fault_scene() -> MotionScene:
    """Twenty spheres of radius 0.35 in a band across the view, each
    moving 1.2 up or 0.9 sideways over the shutter: far past the box it
    starts in, so every fault shows in many pixels."""
    d = Material.diffuse
    spheres = [((0.0, -1000.0, 0.0), 1000.0,
                Material.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))]
    ends = [spheres[0][0]]
    for i in range(20):
        c = (-3.0 + 6.0 * (i % 10) / 9.0, 0.35, -0.8 + 1.6 * (i // 10))
        spheres.append((c, 0.35, d((0.8, 0.3 + 0.03 * i, 0.2))))
        ends.append((c[0], c[1] + 1.2, c[2]) if i % 2 == 0
                    else (c[0] + 0.9, c[1], c[2]))
    scene = port.make_scene(spheres)
    return dataclasses.replace(scene, center1=torch.tensor(
        np.array(ends, np.float32)))


FAULT_BASIS = basis_of((0.0, 1.5, 8.0), (0.0, 0.8, 0.0), 35.0, 0.0, 8.0)


# --- the port against the reference -----------------------------------


def test_still_scene_is_the_narrow_walk_bitwise():
    """The cover with every end centre its start and a checker ground of
    one colour takes the motion walk, and renders bit for bit as the
    narrow walk renders the cover: image and segments."""
    cover = presets.cover_scene()
    still = update_sphere(cover, 0, material=Material.checker(
        (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)))
    assert is_motion(still) and int(still.material_type[0]) == CHECKER
    cam = presets.cover_camera(W, H)
    got = {}
    for name, sc in (("narrow", cover), ("motion", still)):
        cw.reset_launch_counts()
        got[name] = port.render_image(sc, cam, W, H, 4, 7, opts_of(12),
                                      None, True, device="cpu")
    assert torch.equal(got["narrow"][0], got["motion"][0])
    assert (got["narrow"][1]["segments_exact"]
            == got["motion"][1]["segments_exact"])


@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_bouncing_spheres_match_the_reference(sampler):
    """*The Next Week*'s bouncing spheres at 32x18, 4 spp, depth 12: the
    port's render within BOUNDS of the reference (measured: mismatch 0,
    gap 0, segment gap 0, both samplers)."""
    scene = presets.bouncing_spheres_scene()
    got = compare(scene, scene.numpy(), BOOK, sampler=sampler)
    assert within(got), got


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_random_moving_scenes_match_the_reference(seed):
    """Three seeded random scenes of moving spheres, checkers of random
    colours on small spheres, glass and metal: within BOUNDS (measured:
    mismatch 0, gap 0, segment gap 0 on each)."""
    scene = random_moving_scene(seed)
    got = compare(scene, scene.numpy(), RANDOM_BASIS)
    assert within(got), got


def test_fault_scene_matches_the_reference():
    """The planted faults' scene, sound: within BOUNDS (measured: mismatch
    0, gap 0, segment gap 0)."""
    scene = fault_scene()
    got = compare(scene, scene.numpy(), FAULT_BASIS, depth=8)
    assert within(got), got


def _start_boxes(scene, **kw):
    """The partition built from each sphere's box at time 0 alone."""
    static = Scene(**{f.name: getattr(scene, f.name)
                      for f in dataclasses.fields(Scene)})
    part = accel.build_grid_clustered(static, **kw)
    return dataclasses.replace(part, scene=tables.cluster_reorder(
        scene, torch.as_tensor(part.uuid)))


@pytest.mark.parametrize("fault", ["time_0", "time_half", "reversed",
                                   "start_boxes"])
def test_planted_faults_read_worse(monkeypatch, fault):
    """Each planted fault reads worse than BOUNDS on the faults' scene at
    32x18, 4 spp, depth 8: every ray at time 0, every ray at time 0.5, the
    motion run backwards (the program renders the spheres from their end
    centres to their start), and the kd partition's boxes built from the
    spheres at time 0 (rays that meet a sphere late miss its cluster).
    Measured mismatch 0.354, 0.347, 0.378 and 0.153, gap 0.50-0.73."""
    scene = fault_scene()
    arrays = scene.numpy()
    if fault == "time_0":
        monkeypatch.setattr(cw, "shutter_time",
                            lambda pix, s: torch.zeros(pix.shape))
    elif fault == "time_half":
        monkeypatch.setattr(cw, "shutter_time",
                            lambda pix, s: torch.full(pix.shape, 0.5))
    elif fault == "reversed":
        scene = dataclasses.replace(scene, center=scene.center1,
                                    center1=scene.center)
    else:
        monkeypatch.setattr(tables, "build_grid_clustered", _start_boxes)
    got = compare(scene, arrays, FAULT_BASIS, depth=8)
    assert not within(got), got
    assert got["mismatch"] > 0.05, got


# --- the swept boxes ---------------------------------------------------


@pytest.mark.parametrize("name", ["bouncing", "faults", "random"])
def test_swept_volume_lies_in_its_box(name):
    """Every live cluster member lies inside its cluster's box at 20 times
    in [0, 1] (c0 + t (c1 - c0) ± |r|, in float32); the globals have no
    box, and the walk tests them exactly every bounce. The parents bound
    their clusters."""
    scene = {"bouncing": presets.bouncing_spheres_scene,
             "faults": fault_scene,
             "random": lambda: random_moving_scene(12)}[name]()
    part = tables.motion_partition(scene, opts_of(12))
    k, group = part.boxes.shape[0], part.group
    host = part.scene.numpy()
    live = host["active"][part.n_global:].reshape(k, group) > 0
    c0 = host["center"][part.n_global:].reshape(k, group, 3)
    c1 = host["center1"][part.n_global:].reshape(k, group, 3)
    r = np.abs(host["radius"][part.n_global:]).reshape(k, group, 1)
    lo, hi = part.boxes[:, None, :3], part.boxes[:, None, 3:]
    for t in np.linspace(0.0, 1.0, 20, dtype=np.float32):
        c = c0 + t * (c1 - c0)
        inside = ((c - r >= lo) & (c + r <= hi)).all(2)
        assert inside[live].all(), t
    moving = (c0 != c1).any(2) & live
    assert moving.any()
    parents = tables.parent_boxes(part.boxes)
    kids = np.arange(k) // tables.PARENT_FANOUT
    assert (parents[kids, :3] <= part.boxes[:, :3]).all()
    assert (parents[kids, 3:] >= part.boxes[:, 3:]).all()


def test_small_scene_gets_a_partition_of_its_own():
    """Below the 'auto' threshold a scene with a shutter still takes the
    motion walk: a few small spheres in one cluster, or only globals."""
    d = Material.diffuse
    few = as_motion(port.make_scene([
        ((0.0, -100.5, -1.0), 100.0, d((0.5, 0.5, 0.5))),
        ((0.0, 0.0, -1.0), 0.3, d((0.5, 0.2, 0.2))),
        ((0.7, 0.0, -1.0), 0.3, d((0.2, 0.5, 0.2)))]))
    only_globals = as_motion(port.make_scene([
        ((0.0, -100.5, -1.0), 100.0, d((0.5, 0.5, 0.5))),
        ((0.0, 0.0, -1.0), 0.6, d((0.5, 0.2, 0.2)))]))
    dcam = derive_camera(presets.simple_camera(W, H))
    for scene, k in ((few, 1), (only_globals, 0)):
        choice = megakernel.choose_kernel(scene, dcam, opts_of(8), "cpu")
        assert choice.kernel == "cluster_walk" and choice.tables.motion
        assert choice.tables.members.shape[0] == k
        img = port.render_image(scene, presets.simple_camera(W, H), W, H, 2,
                                3, opts_of(8), device="cpu")
        assert torch.isfinite(img).all() and float(img.mean()) > 0.0


# --- refusals ---------------------------------------------------------


def test_wide_partition_is_refused():
    """A scene with a shutter whose partition passes 128 clusters raises,
    naming the limit: the wide walk has no motion build."""
    rng = np.random.default_rng(0)
    n = 129 * 16 + 5
    c = np.concatenate([rng.uniform(-40, 40, (n, 1)), np.full((n, 1), 0.2),
                        rng.uniform(-40, 40, (n, 1))], 1)
    scene = scene_from_numpy(
        c, np.full(n, 0.2), np.zeros(n), np.full((n, 3), 0.5), np.zeros(n),
        np.zeros(n), np.ones(n), center1=c + [0.0, 0.3, 0.0])
    with pytest.raises(ValueError, match="up to 128 clusters"):
        port.render_image(scene, presets.cover_camera(W, H), W, H, 1, 0,
                          opts_of(4), device="cpu")


@pytest.mark.parametrize("what", ["adaptive", "debug", "jnp"])
def test_unsupported_renders_are_refused(what):
    """An adaptive render, the debug overlay and the jnp backend are
    static-only: each raises ``ValueError`` on a scene with a shutter."""
    kw = {"adaptive": {"adaptive_tolerance": 0.2},
          "debug": {"enable_debug": True},
          "jnp": {"backend": "jnp"}}[what]
    with pytest.raises(ValueError, match="shutter"):
        port.render_image(presets.bouncing_spheres_scene(),
                          presets.bouncing_camera(W, H), W, H, 64, 0,
                          opts_of(4, **kw), device="cpu")


def test_engine_refuses_a_scene_with_a_shutter():
    with pytest.raises(NotImplementedError, match="static scenes only"):
        port.Engine(presets.bouncing_spheres_scene(),
                    presets.bouncing_camera(W, H), W, H, device="cpu")


def test_hints_do_not_stand_for_a_scene_with_a_shutter():
    dcam = derive_camera(presets.bouncing_camera(W, H))
    scene = presets.bouncing_spheres_scene()
    for kw in ({"analyse": False}, {"static_split": (None, 8)}):
        with pytest.raises(ValueError, match="hint"):
            megakernel.choose_kernel(scene, dcam, opts_of(4), "cpu", **kw)


# --- static scenes as they were, and the scene's fields ---------------

#: sha256 (16 hex digits) of the kd boxes, the slot map and the packed
#: walk tables of the cover (64x36 camera) and of the sphereflake at size
#: factor 4 (64x64), as the tree before the motion walk built them
STATIC_TABLES = {
    "cover": ("b66943a4fe766b96", "a410c327b52b3e9b", "3649b14bcb8cf240"),
    "flake": ("9c27e882aec4d39e", "fd01f72496162bc3", "2b63dd4de5f488b1"),
}


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(a)).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(STATIC_TABLES))
def test_static_tables_are_as_before(name):
    """A static scene's partition and walk tables are bit for bit those of
    the tree before the motion walk; the narrow cover's partition is the
    same whether or not its scene has a shutter that moves nothing."""
    scene, cam = {"cover": (presets.cover_scene(),
                            presets.cover_camera(64, 36)),
                  "flake": (presets.sphereflake_scene(4),
                            presets.sphereflake_camera(64, 64))}[name]
    part = tables.cluster_partition(scene, TraceOptions())
    tabs = tables.walk_tables(part, derive_camera(cam), "cpu")
    assert not tabs.motion
    got = (_sha(part.boxes), _sha(part.uuid), _sha(tabs.packed.numpy()))
    assert got == STATIC_TABLES[name]
    if name == "cover":
        still = tables.motion_partition(as_motion(scene), TraceOptions())
        np.testing.assert_array_equal(still.boxes, part.boxes)
        np.testing.assert_array_equal(still.uuid, part.uuid)


def test_scene_fields_travel_with_the_scene():
    """``scene_from_numpy`` without the shutter's fields gives today's
    ``Scene``; with them a ``MotionScene``, whose end centres and odd
    colours follow every padding, copy, read, edit and slot
    permutation."""
    plain = presets.cover_scene().numpy()
    assert type(scene_from_numpy(**plain)) is Scene
    scene = presets.bouncing_spheres_scene()
    assert int((scene.center1 != scene.center).any(1).sum()) == 389
    padded = scene.pad_to(scene.count + 3)
    assert is_motion(padded) and padded.center1.shape == (490, 3)
    assert torch.equal(padded.center1[:487], scene.center1)
    assert set(scene.to("cpu").numpy()) == set(plain) | {"center1",
                                                         "albedo_odd"}
    moved = update_sphere(scene, 1, center=(0.0, 0.2, 0.0))
    np.testing.assert_allclose(
        (moved.center1[1] - moved.center[1]).numpy(),
        (scene.center1[1] - scene.center[1]).numpy(), atol=1e-6)
    perm = np.arange(scene.count)[::-1].copy()
    flipped = megakernel.permute_scene(scene, perm)
    assert torch.equal(flipped.center1, scene.center1.flip(0))
    assert torch.equal(flipped.albedo_odd, scene.albedo_odd.flip(0))
    uuid = torch.tensor([2, -1, 0], dtype=torch.int32)
    gathered = tables.cluster_reorder(scene, uuid)
    assert torch.equal(gathered.center1[0], scene.center1[2])
    assert torch.equal(gathered.albedo_odd[2], scene.albedo_odd[0])
