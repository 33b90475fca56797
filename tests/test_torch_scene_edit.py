"""The port's scene-editing API against the JAX package's
(``raytracer_tpu/scene/spheres.py``: ``Scene.num_active``,
``Scene.pad_to``, ``make_scene(pad_to=)``, ``update_sphere``,
``add_sphere``, ``remove_sphere``).

Seeded sequences of edits go through both packages; after each edit
every field of the port's scene equals the JAX scene's, carried across
with ``scene_from_numpy``, **exactly** (float32 values are rounded the
same way on both sides), and so does ``num_active``. The edits are pure
and keep each field's device.

Edited scenes render: an edited two_sphere (a material changed, a sphere
added in a padded slot, one removed) and an edited demo (a sphere moved,
one removed, one added into its slot), 128x64, 4 spp as chunks [3, 1],
depth 8, rr5, seed 3, gamma off, through the port's plain flat scan
against ``render_image_pallas`` in interpret mode: the chunk bounds of
ROADMAP's ground rules (at most 5 % of pixels off by more than 1e-3, at
least 70 % within 1e-5, mean |delta| of the per-pixel rgb sums at most
8e-3, segments within 0.6 %).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu.scene import spheres as jax_spheres
from raytracer_tpu.scene.materials import Material as JaxMaterial
from raytracer_tpu_torch.camera.camera import camera_from_numpy
from raytracer_tpu_torch.render import api, schedule
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import presets, spheres
from raytracer_tpu_torch.scene.materials import Material
from raytracer_tpu_torch.scene.spheres import scene_from_numpy

W, H, SPP, DEPTH = 128, 64, 4, 8
MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3  # mean |delta| of the per-pixel rgb sums
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


def assert_same(port, j_scene):
    want = port_scene(j_scene)
    for f in dataclasses.fields(want):
        got, exp = getattr(port, f.name), getattr(want, f.name)
        assert got.dtype == exp.dtype, f.name
        assert torch.equal(got, exp), f.name
    assert int(port.num_active()) == int(j_scene.num_active())


def materials(rng):
    """The same material drawn for both packages."""
    kind = int(rng.integers(3))
    albedo = tuple(float(x) for x in rng.random(3))
    fuzz, ri = float(rng.random()), float(1.0 + rng.random())
    if kind == 0:
        return Material.diffuse(albedo), JaxMaterial.diffuse(albedo)
    if kind == 1:
        return Material.metal(albedo, fuzz), JaxMaterial.metal(albedo, fuzz)
    return Material.glass(ri), JaxMaterial.glass(ri)


def edits(seed: int, n: int = 12):
    """``n`` seeded edits, each as (port function, JAX function)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        op = ("update", "add", "remove", "pad")[int(rng.integers(4))]
        center = tuple(float(x) for x in rng.normal(size=3) * 3.0)
        radius = float(rng.uniform(-0.5, 2.0))
        mat, j_mat = materials(rng)
        pick = float(rng.random())
        if op == "update":
            parts = rng.random(4) < 0.6
            active = bool(rng.random() < 0.5) if parts[3] else None

            def args(s, m, parts=parts, center=center, radius=radius,
                     active=active, pick=pick):
                return dict(index=int(pick * s.count),
                            center=center if parts[0] else None,
                            radius=radius if parts[1] else None,
                            material=m if parts[2] else None, active=active)

            yield (lambda s, a=args, m=mat: spheres.update_sphere(
                s, **a(s, m)),
                lambda s, a=args, m=j_mat: jax_spheres.update_sphere(
                    s, **a(s, m)))
        elif op == "add":
            yield (lambda s, c=center, r=radius, m=mat:
                   spheres.add_sphere(s, c, r, m),
                   lambda s, c=center, r=radius, m=j_mat:
                   jax_spheres.add_sphere(s, c, r, m))
        elif op == "remove":
            yield (lambda s, p=pick: spheres.remove_sphere(
                s, int(p * s.count)),
                lambda s, p=pick: jax_spheres.remove_sphere(
                    s, int(p * s.count)))
        else:
            extra = int(rng.integers(0, 4))
            yield (lambda s, e=extra: s.pad_to(s.count + e),
                   lambda s, e=extra: s.pad_to(s.count + e))


@pytest.mark.parametrize("base", ["two_sphere", "demo", "cover"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_sequences_match_jax(base, seed):
    j_scene = jax_presets.get_config(base, 16, 8)[0]
    scene = presets.get_config(base, 16, 8)[0]
    assert_same(scene, j_scene)
    for port_edit, jax_edit in edits(seed * 10 + len(base)):
        before = {k: v.copy() for k, v in scene.numpy().items()}
        edited, j_scene = port_edit(scene), jax_edit(j_scene)
        assert_same(edited, j_scene)
        for k, v in scene.numpy().items():  # pure: the old scene unchanged
            np.testing.assert_array_equal(v, before[k])
        scene = edited


def test_add_sphere_reuses_the_first_inactive_slot_then_grows():
    scene = presets.two_sphere_scene().pad_to(4)
    j_scene = jax_presets.two_sphere_scene().pad_to(4)
    assert_same(scene, j_scene)
    m, jm = Material.glass(1.5), JaxMaterial.glass(1.5)
    for count in (4, 4, 5, 6):
        scene = spheres.add_sphere(scene, (5, 5, 5), 1.0, m)
        j_scene = jax_spheres.add_sphere(j_scene, (5, 5, 5), 1.0, jm)
        assert scene.count == count
        assert_same(scene, j_scene)
    freed = spheres.remove_sphere(scene, 1)
    assert int(freed.num_active()) == 5
    again = spheres.add_sphere(freed, (0, 2, 0), 0.5, m)
    assert again.count == 6 and float(again.center[1, 1]) == 2.0


def test_pad_to_and_make_scene_pad():
    scene = presets.two_sphere_scene()
    assert scene.pad_to(2) is scene
    with pytest.raises(ValueError, match="cannot pad"):
        scene.pad_to(1)
    padded = scene.pad_to(8)
    assert padded.count == 8 and int(padded.num_active()) == 2
    assert float(padded.radius[5]) == 1.0  # 1/r stays finite
    assert float(padded.refraction_index[5]) == 1.0
    m, jm = Material.diffuse((1, 0, 0)), JaxMaterial.diffuse((1, 0, 0))
    made = spheres.make_scene([((0, 0, 0), 1.0, m)], pad_to=3)
    j_made = jax_spheres.make_scene([((0, 0, 0), 1.0, jm)], pad_to=3)
    assert_same(made, j_made)


def test_edits_keep_the_fields_device():
    scene = presets.demo_scene()
    edited = spheres.add_sphere(spheres.remove_sphere(scene, 2), (0, 1, 0),
                                0.3, Material.metal((1, 1, 1), 0.1))
    for f in dataclasses.fields(edited):
        assert getattr(edited, f.name).device == getattr(scene, f.name).device
    assert edited.num_active().device == scene.active.device
    assert edited.num_active().dtype == torch.int32


def edited_two_sphere(sp, pre, mat):
    s = sp.update_sphere(pre.two_sphere_scene().pad_to(4), 0,
                         material=mat.metal((0.9, 0.1, 0.1), 0.2))
    s = sp.add_sphere(s, (0.9, 0.0, -1.2), 0.3, mat.glass(1.5))
    return sp.remove_sphere(s, 3)


def edited_demo(sp, pre, mat):
    s = sp.update_sphere(pre.demo_scene(), 1, center=(0.2, 0.1, -1.1),
                         radius=0.45)
    s = sp.remove_sphere(s, 2)
    return sp.add_sphere(s, (-1.0, 0.2, -0.9), 0.4,
                         mat.diffuse((0.2, 0.8, 0.3)))


@pytest.mark.parametrize("name, edit", [
    ("two_sphere", edited_two_sphere), ("demo", edited_demo),
], ids=["two_sphere", "demo"])
def test_edited_scene_renders_like_render_image_pallas(monkeypatch, name,
                                                       edit):
    monkeypatch.setattr(pk, "_pick_chunk_spp",
                        lambda spp, *a, **k: min(spp, 3))
    monkeypatch.setattr(schedule, "pick_chunk_spp",
                        lambda spp, *a, **k: min(spp, 3))
    j_scene = edit(jax_spheres, jax_presets, JaxMaterial)
    scene = edit(spheres, presets, Material)
    assert_same(scene, j_scene)
    j_cam = jax_presets.get_config(name, W, H)[1]
    dcam = jax_derive_camera(j_cam)
    ref, ref_stats = pk.render_image_pallas(
        j_scene, dcam, W, H, SPP, jax.random.PRNGKey(3),
        JaxOptions(max_depth=DEPTH, russian_roulette_depth=5, gamma=False),
        return_stats=True,
    )
    img, stats = api.render_image(
        scene, camera_from_numpy(carry_across(dcam)), W, H, SPP, 3,
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
