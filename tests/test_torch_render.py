"""The port's whole cover render against ``pk.render_image_pallas`` in
interpret mode, its own sorted/unsorted invariance, and the guards of
the port: no JAX imports, CUDA by default, a clear error for every
option the port does not serve yet, and the flat scan for the scenes the
JAX package renders flat."""

import ast
import dataclasses
import pathlib

import jax
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
from raytracer_tpu_torch.render import api, megakernel, schedule
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.materials import Material
from raytracer_tpu_torch.scene.spheres import make_scene, scene_from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def force_chunks(monkeypatch, chunk: int):
    """A multi-chunk schedule at test size, on both sides."""
    monkeypatch.setattr(pk, "_pick_chunk_spp",
                        lambda spp, *a, **k: min(spp, chunk))
    monkeypatch.setattr(schedule, "pick_chunk_spp",
                        lambda spp, *a, **k: min(spp, chunk))


def test_render_matches_render_image_pallas(monkeypatch):
    """Cover at 128x64, 4 spp as chunks [1, 3] (profile chunk, then one
    sorted chunk), depth 12, roulette from bounce 5, seed 3 vs
    ``PRNGKey(3)``, JAX-derived camera carried across, gamma off so the
    per-pixel sums compare on the chunk test's scale. Same bounds as
    ``test_torch_walk``, for the same reasons; measured 2.4 % of pixels off
    by more than 1e-3, 81.6 % within 1e-5, mean |delta| 4.7e-3, segment
    totals 0.07 % apart."""
    w, h, spp, depth = 128, 64, 4, 12
    force_chunks(monkeypatch, 3)
    j_scene, j_cam, *_ = jax_presets.get_config("cover", w, h)
    dcam = jax_derive_camera(j_cam)
    ref, ref_stats = pk.render_image_pallas(
        j_scene, dcam, w, h, spp, jax.random.PRNGKey(3),
        JaxOptions(max_depth=depth, russian_roulette_depth=5, gamma=False),
        return_stats=True,
    )
    img, stats = api.render_image(
        scene_from_numpy(**carry_across(j_scene)),
        camera_from_numpy(carry_across(dcam)), w, h, spp, 3,
        TraceOptions(max_depth=depth, russian_roulette_depth=5,
                     gamma=False),
        return_stats=True, device="cpu",
    )
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    d = np.abs(img.numpy() - np.asarray(ref)).max(axis=-1) * spp
    assert (d > 1e-3).mean() <= 0.05
    assert (d <= 1e-5).mean() >= 0.70
    assert d.mean() <= 8e-3
    ref_segs = float(ref_stats["segments"])
    assert abs(stats["segments_exact"] - ref_segs) <= 6e-3 * ref_segs
    assert stats["segments"] == float(np.float32(stats["segments_exact"]))


def test_sorted_bitwise_equals_unsorted(monkeypatch):
    """Pixel sorting changes only which lane renders a pixel: the image
    and the exact segment total are bitwise those of the unsorted
    render (chunks [1, 3, 3]: two sorted chunks and a re-plan between
    them; roulette on)."""
    force_chunks(monkeypatch, 2)
    scene, cam, *_ = presets.get_config("cover", 64, 32)
    opts = TraceOptions(max_depth=10, russian_roulette_depth=5)
    assert schedule.chunk_schedule(7, 2) == ([1, 3, 3], True)
    a, sa = api.render_image(scene, cam, 64, 32, 7, 3, opts,
                             return_stats=True, device="cpu")
    b, sb = api.render_image(
        scene, cam, 64, 32, 7, 3,
        dataclasses.replace(opts, sort_pixels=False),
        return_stats=True, device="cpu",
    )
    assert torch.equal(a, b)
    assert sa == sb
    assert torch.isfinite(a).all() and float(a.min()) >= 0.0


def test_schedule_sees_the_original_slot_count(monkeypatch):
    """The schedule is fed the scene's own 487 slots, never the padded
    partition's 500 (a padded count shifts chunk boundaries and with them
    the per-pixel summation order)."""
    seen = []
    real = schedule.pick_chunk_spp

    def spy(spp, p, s_count, *a, **k):
        seen.append(s_count)
        return real(spp, p, s_count, *a, **k)

    monkeypatch.setattr(schedule, "pick_chunk_spp", spy)
    scene, cam, *_ = presets.get_config("cover", 16, 8)
    api.render_image(scene, cam, 16, 8, 1, 0, TraceOptions(max_depth=2),
                     device="cpu")
    assert seen == [487]


def port_sources():
    yield ROOT / "chip_smoke.py"
    yield from sorted((ROOT / "raytracer_tpu_torch").rglob("*.py"))


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax or the
    JAX package (an AST scan: this suite imports jax itself, and a
    site customisation may pre-import it into every process, so
    sys.modules proves nothing)."""
    banned = ("jax", "flax", "raytracer_tpu")
    files = list(port_sources())
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path}: imports {name}"


def test_render_defaults_to_cuda(monkeypatch):
    """Without ``device`` the render runs on CUDA, and raises where there
    is none; it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam, *_ = presets.get_config("cover", 16, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.render_image(scene, cam, 16, 8, 1, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.render_image(scene, cam, 16, 8, 1, 0, device="cuda")


@pytest.mark.parametrize("field, value, item", [
    ("cluster_bounds", "sphere", "box"),
    ("cluster_partition", "grid", "kd"),
])
def test_unported_options_raise(field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        TraceOptions(**{field: value})


@pytest.mark.parametrize("sampler", ["halton", "", None])
def test_unknown_sampler_raises(sampler):
    with pytest.raises(ValueError, match="sampler must be"):
        TraceOptions(sampler=sampler)


def test_ported_options_construct():
    """Adaptive sampling, the stratified sampler and the debug overlay are
    served: the options build, alone and together (a render with the
    overlay strips the adaptive tolerance)."""
    opts = TraceOptions(adaptive_tolerance=0.2, sampler="stratified",
                        adaptive_chunk_spp=24)
    assert (opts.adaptive_tolerance, opts.sampler,
            opts.adaptive_chunk_spp) == (0.2, "stratified", 24)
    assert dataclasses.replace(opts, enable_debug=True).enable_debug


@pytest.mark.parametrize("config", ["two_sphere", "demo", "big_only"])
def test_flat_scan_scenes_render(config):
    """Scenes the JAX package renders with the flat scan (under 64 slots,
    or no small-sphere clusters: ``big_only``'s partition is empty) render
    on the CPU through the flat scan, fixed and adaptive, to a finite
    image; the kernel chosen is the one the JAX package chooses."""
    if config == "big_only":
        spheres = [((3.0 * i, 0.0, 0.0), 1.0, (0.5, 0.5, 0.5))
                   for i in range(70)]
        scene = make_scene([(c, r, Material.diffuse(a))
                            for c, r, a in spheres])
        j_scene = jax_make_scene([(c, r, JaxMaterial.diffuse(a))
                                  for c, r, a in spheres])
        cam = presets.simple_camera(16, 8)
        j_cam = jax_presets.simple_camera(16, 8)
    else:
        scene, cam, *_ = presets.get_config(config, 16, 8)
        j_scene, j_cam, *_ = jax_presets.get_config(config, 16, 8)
    j_opts = JaxOptions()
    jax_flat = not (
        jax_cluster_scan_enabled(j_opts, j_scene.count)
        and pk._cluster_partition(j_scene, j_opts) is not None
    )
    choice = megakernel.choose_kernel(scene, api.to_derived(cam),
                                      TraceOptions(), "cpu")
    assert jax_flat and choice.kernel == "flat_scan"
    split = pk._containable_split(j_scene, jax_derive_camera(j_cam), j_opts)
    assert choice.g_full == (None if split is None else split[1])
    img = api.render_image(scene, cam, 16, 8, 1, 0, device="cpu")
    assert img.shape == (8, 16, 3) and torch.isfinite(img).all()
    img, stats = api.render_image(
        scene, cam, 16, 8, 40, 0,
        TraceOptions(adaptive_tolerance=0.2, sampler="stratified"),
        return_stats=True, device="cpu")
    assert torch.isfinite(img).all() and stats["spp_map"].shape == (8, 16)


def test_bad_arguments_raise():
    scene, cam, *_ = presets.get_config("cover", 16, 8)
    with pytest.raises(ValueError, match="spp"):
        api.render_image(scene, cam, 16, 8, 0, 0, device="cpu")
    with pytest.raises(ValueError, match="max_depth"):
        TraceOptions(max_depth=0)
    with pytest.raises(TypeError, match="camera"):
        api.render_image(scene, "camera", 16, 8, 1, 0, device="cpu")
