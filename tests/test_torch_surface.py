"""The JAX package's import surface in the port, ``render_image_pallas``
and the counterpart of ``__graft_entry__.py``'s ``entry()``.

The walk: every public name of every module of ``raytracer_tpu`` (its
``__all__``, or else its top-level ``def``, ``class`` and assignments,
read from the source), less ``native/``, ``utils/jaxcache.py`` and
``render/primary.py``, resolves in the port's module of the same path.
The names not to port (``NOT_TO_PORT``) are the grid partition and the
TPU's tiling (ROADMAP "Not to port"); a name the JAX package gains fails
the walk until the port has it or the list names it. Each subpackage's
``__all__`` is the JAX package's less that list, and every re-export is
the defining module's object. Each subpackage imports first in a fresh
interpreter.

``render_image_pallas`` is bitwise ``render_image`` (the same path) and
within the chunk bounds of the JAX function in interpret mode (measured on
the 128x64 cover: see :func:`test_render_image_pallas_matches_jax`).
``entry()``'s step is bitwise a directly built step and within the
progressive step's bounds of the JAX step built as ``__graft_entry__.py``
builds it, with ``backend='pallas'`` (interpret mode): the JAX package's
'auto' would mean its jnp tracer off a TPU, the port's means the kernels.
"""

import ast
import dataclasses
import importlib
import inspect
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.core.ray import Ray as JaxRay
from raytracer_tpu.core.vec import vec3 as jax_vec3
from raytracer_tpu.progressive import state as jax_state
from raytracer_tpu.progressive import step as jax_step
from raytracer_tpu.render import pallas_kernel as jax_pk
from raytracer_tpu.render.options import DebugParams as JaxDebug
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import materials as jax_materials
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu_torch import entry as port_entry
from raytracer_tpu_torch.camera.camera import (
    camera_from_numpy,
    derive_camera,
)
from raytracer_tpu_torch.core.ray import Ray
from raytracer_tpu_torch.core.vec import vec3
from raytracer_tpu_torch.progressive.state import (
    RenderState,
    init_render_state,
)
from raytracer_tpu_torch.progressive.step import make_step_fn
from raytracer_tpu_torch.render import api, pallas_kernel, rng, schedule
from raytracer_tpu_torch.render.cluster_walk import LANES_TPU
from raytracer_tpu_torch.render.options import DebugParams, TraceOptions
from raytracer_tpu_torch.scene import materials, presets
from raytracer_tpu_torch.scene.spheres import Scene, scene_from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_ROOT = ROOT / "raytracer_tpu"
#: files of the JAX package outside the walk (ROADMAP "Not to port")
SKIPPED = ("native/__init__.py", "utils/jaxcache.py", "render/primary.py")
#: module → its public names the port does not have, on purpose: the
#: grid partition (``build_clustered``, ``GridClusteredScene``,
#: ``DEFAULT_GROUP``) and the TPU's row tiling (``DEFAULT_R_SUB``)
NOT_TO_PORT = {
    "scene.accel": {"DEFAULT_GROUP", "GridClusteredScene",
                    "build_clustered"},
    "render.pallas_kernel": {"DEFAULT_R_SUB"},
}
#: subpackages whose ``__all__`` is the JAX package's less NOT_TO_PORT;
#: the top level and ``parallel`` keep names of the port's own besides
ALL_EQUAL = ("camera", "interact", "progressive", "render", "scene",
             "utils")
ALL_SUPERSET = ("", "parallel")
SUBPACKAGES = ("app", "camera", "core", "interact", "parallel",
               "progressive", "render", "scene", "utils")

# the bounds against the JAX package (the walk's chunk bounds, ROADMAP's
# ground rules; the progressive step's)
MAX_FORKED_SHARE = 0.05  # pixels off by more than 1e-3
MIN_CLOSE_SHARE = 0.70  # pixels within 1e-5
MAX_MEAN_ABS = 8e-3  # mean |delta|
MAX_SEG_REL_RENDER = 6e-3  # 0.6 %
MAX_SEG_REL_STEP = 6e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Intra-op threads only contend between test workers, and with them
    PyTorch's exp and log were seen to return a thread's chunk off by
    1e-5..1e-4 (ROADMAP §C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the walk ----------------------------------------------------------


def jax_modules() -> dict:
    """Module path relative to the package ('' for the package) → source
    file, for every module of the JAX package outside SKIPPED."""
    found = {}
    for path in sorted(JAX_ROOT.rglob("*.py")):
        rel = path.relative_to(JAX_ROOT).as_posix()
        if rel in SKIPPED:
            continue
        parts = rel[:-3].split("/")
        if parts[-1] == "__init__":
            parts = parts[:-1]
        found[".".join(parts)] = path
    return found


MODULES = jax_modules()


def public_names(path: pathlib.Path) -> list:
    """A module's ``__all__``, or else its top-level ``def``, ``class``
    and assigned names that do not start with an underscore."""
    tree = ast.parse(path.read_text(), str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def port_module(rel: str):
    return importlib.import_module(
        "raytracer_tpu_torch" + (f".{rel}" if rel else ""))


def jax_module(rel: str):
    return importlib.import_module("raytracer_tpu" + (f".{rel}" if rel
                                                      else ""))


def test_the_walk_covers_the_package():
    """Every skipped file exists (the list is not stale), the modules the
    not-to-port list names are walked, and the walk finds the modules it
    should: each subpackage and the JAX ``render.pallas_kernel`` and
    ``core.ray`` among them."""
    for rel in SKIPPED:
        assert (JAX_ROOT / rel).is_file(), rel
    assert set(NOT_TO_PORT) <= set(MODULES)
    assert {"", *SUBPACKAGES, "render.pallas_kernel", "core.ray"} <= set(
        MODULES)


@pytest.mark.parametrize("rel", sorted(MODULES), ids=lambda r: r or "top")
def test_every_public_name_is_in_the_port(rel):
    names = public_names(MODULES[rel])
    port = port_module(rel)
    missing = {n for n in names if not hasattr(port, n)}
    assert missing == NOT_TO_PORT.get(rel, set()), (
        f"raytracer_tpu_torch.{rel}: missing {sorted(missing)}")


@pytest.mark.parametrize("rel", ALL_EQUAL + ALL_SUPERSET,
                         ids=lambda r: r or "top")
def test_all_is_the_jax_packages(rel):
    want = [n for n in jax_module(rel).__all__
            if n not in NOT_TO_PORT.get(rel, ())]
    got = list(port_module(rel).__all__)
    if rel in ALL_EQUAL:
        assert got == want
    else:
        assert set(want) <= set(got)
        assert len(set(got)) == len(got)
    for name in got:
        assert hasattr(port_module(rel), name), name


def jax_init_imports(rel: str) -> list:
    """(port module, name) of each name the JAX ``__init__.py`` of
    ``rel`` imports from its own package, at the port's path."""
    path = JAX_ROOT / rel.replace(".", "/") / "__init__.py"
    pairs = []
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.ImportFrom)
                and node.module.split(".")[0] == "raytracer_tpu"):
            module = "raytracer_tpu_torch" + node.module[len(
                "raytracer_tpu"):]
            pairs += [(module, a.name) for a in node.names]
    return pairs


@pytest.mark.parametrize("rel", ALL_EQUAL + ALL_SUPERSET,
                         ids=lambda r: r or "top")
def test_reexports_are_the_defining_modules_objects(rel):
    """A re-export is the object of the module the JAX ``__init__.py``
    imports it from, at the port's path; every function and class in the
    port's ``__all__`` is its defining module's object."""
    pkg = port_module(rel)
    pairs = jax_init_imports(rel)
    assert pairs
    for module, name in pairs:
        assert getattr(pkg, name) is getattr(
            importlib.import_module(module), name), f"{module}.{name}"
    for name in pkg.__all__:
        obj = getattr(pkg, name)
        if inspect.isfunction(obj) or inspect.isclass(obj):
            assert getattr(sys.modules[obj.__module__], name) is obj, name


def test_render_names_resolve_lazily():
    """``render`` resolves its two names on first read (PEP 562: the
    camera imports ``render.rng``, and ``render.api`` the camera)."""
    render = port_module("render")
    assert render.render_image is api.render_image
    assert render.TraceOptions is TraceOptions
    with pytest.raises(AttributeError):
        render.no_such_name  # noqa: B018


# --- fresh interpreters --------------------------------------------------

#: what each fresh interpreter runs: ``python <args>`` from the root
FRESH = {
    **{f"import {m}": ["-c", f"import raytracer_tpu_torch.{m}"]
       for m in SUBPACKAGES + ("render.pallas_kernel", "entry")},
    "cli --help": ["-W", "error::RuntimeWarning", "-m",
                   "raytracer_tpu_torch.app.cli", "--help"],
    "entry --device cpu": ["-W", "error::RuntimeWarning", "-m",
                           "raytracer_tpu_torch.entry", "--device", "cpu"],
    "entry without a card": ["-m", "raytracer_tpu_torch.entry"],
}


@pytest.fixture(scope="module")
def fresh_runs() -> dict:
    """Every FRESH command, four at a time, on one intra-op thread and
    with no card visible: label → (exit code, stdout, stderr)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT)}

    def run(args):
        p = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                           stdin=subprocess.DEVNULL, capture_output=True,
                           text=True, timeout=300)
        return p.returncode, p.stdout, p.stderr

    with ThreadPoolExecutor(4) as pool:
        futures = {label: pool.submit(run, args)
                   for label, args in FRESH.items()}
        return {label: f.result() for label, f in futures.items()}


@pytest.mark.parametrize("module", SUBPACKAGES + ("render.pallas_kernel",
                                                  "entry"))
def test_imports_first_in_a_fresh_interpreter(fresh_runs, module):
    rc, _, err = fresh_runs[f"import {module}"]
    assert rc == 0, err[-2000:]


def test_cli_runs_as_a_module_without_a_warning(fresh_runs):
    """``app/__init__.py`` stays empty: were ``app.cli`` imported by its
    package, ``python -m`` would warn that it is already in
    ``sys.modules``."""
    rc, out, err = fresh_runs["cli --help"]
    assert rc == 0 and "RuntimeWarning" not in err, err[-2000:]
    assert "--device" in out
    body = ast.parse((ROOT / "raytracer_tpu_torch" / "app" / "__init__.py")
                     .read_text()).body
    assert not [n for n in body if not isinstance(n, ast.Expr)]


# --- constants, Ray, vec3 -----------------------------------------------

PORT_CONSTANTS = {
    "LANES": LANES_TPU,
    "INV_24": rng.INV_24,
    "TWO_PI": rng.TWO_PI,
    "ADAPTIVE_MIN_N": schedule.ADAPTIVE_MIN_N,
    "ADAPTIVE_AUTO_CHUNK": schedule.ADAPTIVE_AUTO_CHUNK,
    "ADAPTIVE_ABS_FLOOR": schedule.ADAPTIVE_ABS_FLOOR,
}


@pytest.mark.parametrize("name", sorted(PORT_CONSTANTS))
def test_constant_is_the_jax_value_and_the_ports_object(name):
    got = getattr(pallas_kernel, name)
    assert got is PORT_CONSTANTS[name]
    want = getattr(jax_pk, name)
    assert type(got) is type(want) and got == want


def test_material_names_are_the_jax_packages():
    assert materials.MATERIAL_NAMES == jax_materials.MATERIAL_NAMES
    assert materials.MATERIAL_NAMES[materials.GLASS] == "glass"


def seeded(shape, seed, lo=-4.0, hi=4.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def test_ray_at_is_the_jax_packages():
    """``Ray(origin, direction).at(t)`` bitwise JAX run eagerly (under
    ``jax.jit`` XLA's CPU backend would contract it to an FMA), for a
    tensor ``t``, a scalar and a Python float; the fields are JAX's in
    its order, and the camera's ``Ray`` is this one."""
    from raytracer_tpu_torch.camera import camera

    o, d = seeded((7, 5, 3), 0), seeded((7, 5, 3), 1)
    for t in (seeded((7, 5), 2, 0.0, 50.0), np.float32(3.3), 0.7):
        want = np.asarray(JaxRay(jnp.asarray(o), jnp.asarray(d)).at(
            jnp.asarray(t)))
        got = Ray(torch.from_numpy(o), torch.from_numpy(d)).at(
            torch.from_numpy(np.asarray(t, np.float32))
            if isinstance(t, np.ndarray) else t)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
    assert Ray._fields == tuple(f.name for f in dataclasses.fields(JaxRay))
    assert camera.Ray is Ray
    ray = camera.center_ray(derive_camera(presets.get_config("demo", 16,
                                                             9)[1]))
    assert isinstance(ray, Ray)


def test_vec3_is_the_jax_packages():
    """Stacked parts of one shape (``jnp.stack`` takes no other), bitwise
    JAX: float64 parts rounded to float32, Python numbers, ints."""
    x, y, z = (np.random.default_rng(s).normal(size=(4, 6)) for s in
               (3, 4, 5))
    cases = [(x, y, z), (1.5, -2.25, 1e-3), (1, 2, 3),
             (np.float32(7.0), 0.1, -3)]
    for parts in cases:
        want = np.asarray(jax_vec3(*[jnp.asarray(p) if np.ndim(p) else p
                                     for p in parts]))
        got = vec3(*parts)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want.reshape(got.shape))


def test_vec3_keeps_a_tensors_device_and_broadcasts():
    """A tensor part sets the device (the meta device here: the CPU
    proves nothing), numbers join it; parts broadcast together."""
    got = vec3(torch.zeros(2, 1, device="meta"), 1.0, torch.zeros(
        5, device="meta"))
    assert got.device.type == "meta" and got.shape == (2, 5, 3)
    assert vec3(1, 2, 3, dtype=torch.float64).dtype == torch.float64
    assert torch.equal(vec3(torch.arange(3.0), 1.0, 2.0)[:, 1],
                       torch.ones(3))


# --- render_image_pallas ------------------------------------------------


def cover(w, h):
    scene, cam, *_ = presets.get_config("cover", w, h)
    return scene, derive_camera(cam)


def demo(w, h):
    scene, cam, *_ = presets.get_config("demo", w, h)
    return scene, derive_camera(cam)


#: case → (scene, w, h, spp, options, debug)
PALLAS_CASES = {
    "fixed cover": ("cover", 24, 12, 3, dict(max_depth=6,
                                             russian_roulette_depth=5),
                    None),
    "stratified": ("demo", 24, 12, 3, dict(max_depth=6,
                                           sampler="stratified"), None),
    "adaptive": ("demo", 16, 8, 48, dict(max_depth=4,
                                         adaptive_tolerance=0.5,
                                         sampler="stratified"), None),
    "debug": ("demo", 24, 12, 2, dict(max_depth=4, enable_debug=True),
              DebugParams((0.0, 0.0, -1.0), 1)),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_render_image_pallas_is_render_image(case):
    """The image and the stats (exact segments; an adaptive render's
    mean spp and sample map) bitwise those of ``render_image`` on the
    same arguments: one path."""
    name, w, h, spp, kw, debug = PALLAS_CASES[case]
    scene, dcam = (cover if name == "cover" else demo)(w, h)
    opts = TraceOptions(**kw)
    img, stats = pallas_kernel.render_image_pallas(
        scene, dcam, w, h, spp, 7, opts, debug, True, device="cpu")
    want, want_stats = api.render_image(scene, dcam, w, h, spp, 7, opts,
                                        debug, True, device="cpu")
    assert img.shape == (h, w, 3) and torch.equal(img, want)
    assert stats.keys() == want_stats.keys()
    assert stats["segments_exact"] == want_stats["segments_exact"] > 0
    if case == "adaptive":
        assert torch.equal(stats["spp_map"], want_stats["spp_map"])
        assert stats["mean_spp"] == want_stats["mean_spp"]
    else:
        assert "spp_map" not in stats
    only = pallas_kernel.render_image_pallas(scene, dcam, w, h, spp, 7,
                                             opts, debug, device="cpu")
    assert torch.equal(only, img)


def test_render_image_pallas_takes_no_tpu_tiling():
    """``r_sub`` and ``k_slots`` (the JAX package's 10th and 11th
    parameters, TPU tiling) raise, by name and by position; the rest of
    the port's own parameters are keyword-only; a camera config, an opts
    of None and a sample offset by position raise too."""
    scene, dcam = demo(16, 8)
    opts = TraceOptions(max_depth=2)
    for kw in ({"r_sub": 8}, {"k_slots": 4}):
        with pytest.raises(TypeError):
            pallas_kernel.render_image_pallas(scene, dcam, 16, 8, 1, 0,
                                              opts, device="cpu", **kw)
    with pytest.raises(TypeError):
        pallas_kernel.render_image_pallas(scene, dcam, 16, 8, 1, 0, opts,
                                          None, False, 8, device="cpu")
    with pytest.raises(TypeError):
        pallas_kernel.render_image_pallas(
            scene, presets.get_config("demo", 16, 8)[1], 16, 8, 1, 0, opts,
            device="cpu")
    with pytest.raises(TypeError):
        pallas_kernel.render_image_pallas(scene, dcam, 16, 8, 1, 0, None,
                                          device="cpu")
    with pytest.raises(ValueError):
        pallas_kernel.render_image_pallas(scene, dcam, 16, 8, 0, 0, opts,
                                          device="cpu")
    params = inspect.signature(pallas_kernel.render_image_pallas).parameters
    kw_only = [n for n, p in params.items()
               if p.kind == inspect.Parameter.KEYWORD_ONLY]
    assert kw_only == ["static_split", "sample_offset", "static_cluster",
                       "device"]


def test_render_image_pallas_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, dcam = demo(16, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pallas_kernel.render_image_pallas(scene, dcam, 16, 8, 1, 0,
                                          TraceOptions(max_depth=2))


def test_hints_take_the_ports_format():
    """The progressive step's hints render what the render without them
    does (cover: its cluster partition; demo: its split); a cluster hint
    the JAX package builds (JAX arrays) raises; a split hint is a numpy
    permutation and an int in both packages, and the JAX package's is
    the port's."""
    opts = TraceOptions(max_depth=4)
    for name, w, h in (("cover", 24, 12), ("demo", 24, 12)):
        scene, cam, *_ = presets.get_config(name, w, h)
        step = make_step_fn(w, h, 1, opts, static_scene=scene,
                            static_camera=cam, device="cpu")
        hints = dict(static_split=step.static_split,
                     static_cluster=step.static_cluster)
        assert sum(v is not None for v in hints.values()) == 1
        dcam = derive_camera(cam)
        got = pallas_kernel.render_image_pallas(scene, dcam, w, h, 2, 3,
                                                opts, device="cpu", **hints)
        want = pallas_kernel.render_image_pallas(scene, dcam, w, h, 2, 3,
                                                 opts, device="cpu")
        assert torch.equal(got, want), name
    j_scene, j_cam, *_ = jax_presets.get_config("cover", 24, 12)
    j_opts = JaxOptions(max_depth=4)
    part = jax_pk._cluster_partition(j_scene, j_opts)
    j_cluster = (jax_pk._part_bounds(part, j_opts), part.uuid,
                 part.n_global)
    scene, dcam = cover(24, 12)
    with pytest.raises(TypeError, match="static_cluster"):
        pallas_kernel.render_image_pallas(scene, dcam, 24, 12, 1, 3, opts,
                                          static_cluster=j_cluster,
                                          device="cpu")
    with pytest.raises(TypeError, match="static_split"):
        pallas_kernel.render_image_pallas(scene, dcam, 24, 12, 1, 3, opts,
                                          static_split=(None, jnp.int32(8)),
                                          device="cpu")
    j_scene, j_cam, *_ = jax_presets.get_config("demo", 24, 12)
    j_split = jax_pk._containable_split(j_scene, jax_derive_camera(j_cam),
                                        j_opts)
    step = make_step_fn(24, 12, 1, opts, static_scene=demo(24, 12)[0],
                        static_camera=presets.get_config("demo", 24, 12)[1],
                        device="cpu")
    assert j_split[1] == step.static_split[1]
    assert (j_split[0] is None and step.static_split[0] is None) or (
        np.array_equal(j_split[0], step.static_split[0]))


def carry_across(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_render_image_pallas_matches_jax():
    """The cover at 128x64, 4 spp, depth 12, roulette from bounce 5, seed
    3 vs ``PRNGKey(3)``, the JAX-derived camera carried across, gamma off
    so the per-pixel sums compare on the chunk test's scale; the bounds
    of ``test_torch_render``, each package through its own schedule.
    Measured: 2.4 % of pixels off by more than 1e-3, 81.6 % within 1e-5,
    mean |delta| 4.7e-3, segment totals 0.073 % apart."""
    w, h, spp, depth = 128, 64, 4, 12
    j_scene, j_cam, *_ = jax_presets.get_config("cover", w, h)
    j_dcam = jax_derive_camera(j_cam)
    ref, ref_stats = jax_pk.render_image_pallas(
        j_scene, j_dcam, w, h, spp, jax.random.PRNGKey(3),
        JaxOptions(max_depth=depth, russian_roulette_depth=5, gamma=False),
        return_stats=True)
    img, stats = pallas_kernel.render_image_pallas(
        scene_from_numpy(**carry_across(j_scene)),
        camera_from_numpy(carry_across(j_dcam)), w, h, spp, 3,
        TraceOptions(max_depth=depth, russian_roulette_depth=5,
                     gamma=False),
        return_stats=True, device="cpu")
    d = np.abs(img.numpy() - np.asarray(ref)).max(axis=-1) * spp
    assert (d > 1e-3).mean() <= MAX_FORKED_SHARE
    assert (d <= 1e-5).mean() >= MIN_CLOSE_SHARE
    assert d.mean() <= MAX_MEAN_ABS
    ref_segs = float(ref_stats["segments"])
    assert abs(stats["segments_exact"] - ref_segs) <= (MAX_SEG_REL_RENDER
                                                       * ref_segs)


# --- entry() -------------------------------------------------------------


def test_entry_returns_a_step_and_its_arguments():
    step, args = port_entry.entry(device="cpu")
    state, scene, cam, debug = args
    assert callable(step)
    assert isinstance(state, RenderState) and isinstance(scene, Scene)
    assert state.accum.shape == (144, 256, 3)
    assert state.accum.dtype == torch.float32
    assert state.accum.device.type == "cpu" and not state.accum.any()
    assert (state.frame, state.render_count) == (0, 0)
    assert state.key == rng.key_data(0)
    assert scene.count == 9
    assert debug == DebugParams.none()
    new, aux = step(*args)
    assert (new.frame, new.render_count) == (1, 1)
    assert aux["segments"].dtype == torch.int64 and int(aux["segments"]) > 0
    assert port_entry.dryrun_multichip is importlib.import_module(
        "raytracer_tpu_torch.parallel.dryrun").dryrun_multichip


def test_entry_step_is_a_make_step_fn_frame(monkeypatch):
    """One ``step(*args)`` is bitwise the frame of a step built directly,
    as ``__graft_entry__.py`` builds it, and the frame is one chunk of the
    flat scan's unsplit, fixed, random, overlay-free instantiation (K2
    ``<0,0,0,0,b>``: 9 spheres, no hints)."""
    from raytracer_tpu_torch.render import flat_scan as fs
    from raytracer_tpu_torch.render import megakernel

    chunks = []
    for name in ("flat_scan", "cluster_walk"):
        real = getattr(megakernel, name)

        def spy(*a, _name=name, _real=real):
            chunks.append((_name, a[7], a[8] if _name == "flat_scan"
                           else None))
            return _real(*a)

        monkeypatch.setattr(megakernel, name, spy)
    step, args = port_entry.entry(device="cpu")
    got, got_aux = step(*args)
    assert len(chunks) == 1
    kernel, opts, g_full = chunks[0]
    assert kernel == "flat_scan" and g_full is None
    assert fs.variant_name(opts, False) == "flat_scan"
    monkeypatch.undo()
    scene, cam, *_ = presets.get_config("demo", 256, 144)
    want, want_aux = make_step_fn(
        256, 144, spp=1, opts=TraceOptions(max_depth=8), jit=False,
        device="cpu")(init_render_state(256, 144, 0, device="cpu"), scene,
                      cam, DebugParams.none())
    assert torch.equal(got.accum, want.accum)
    assert int(got_aux["segments"]) == int(want_aux["segments"])
    assert got.frame == want.frame == 1


def test_entry_step_matches_the_jax_step():
    """The JAX ``entry()``'s step with ``backend='pallas'`` (interpret
    mode), one frame from ``PRNGKey(0)``: the progressive step's bounds
    (``test_torch_progressive``). Measured: 0.12 % of pixels off by more
    than 1e-3, 99.5 % within 1e-5, mean |delta| 1.9e-4, segments 1.6e-4
    apart."""
    w, h = 256, 144
    j_scene, j_cam, *_ = jax_presets.get_config("demo", w, h)
    j_step = jax_step.make_step_fn(
        w, h, spp=1, opts=JaxOptions(max_depth=8, backend="pallas"),
        jit=False)
    js, j_aux = j_step(jax_state.init_render_state(w, h,
                                                   jax.random.PRNGKey(0)),
                       j_scene, j_cam, JaxDebug.none())
    step, args = port_entry.entry(device="cpu")
    ps, p_aux = step(*args)
    d = np.abs(ps.accum.numpy() - np.asarray(js.accum)).max(axis=-1)
    assert (d > 1e-3).mean() <= MAX_FORKED_SHARE
    assert (d <= 1e-5).mean() >= MIN_CLOSE_SHARE
    assert d.mean() <= MAX_MEAN_ABS
    j_segs = float(j_aux["segments"])
    assert abs(int(p_aux["segments"]) - j_segs) <= MAX_SEG_REL_STEP * j_segs
    assert ps.key == tuple(int(v) for v in np.asarray(js.key))


def test_entry_runs_as_a_module_on_the_cpu(fresh_runs):
    """``python -m raytracer_tpu_torch.entry --device cpu`` prints the
    running average's shape and the frame's segments, those of the same
    step in this process."""
    rc, out, err = fresh_runs["entry --device cpu"]
    assert rc == 0 and "RuntimeWarning" not in err, err[-2000:]
    step, args = port_entry.entry(device="cpu")
    _, aux = step(*args)
    assert out.strip().splitlines()[-1] == (
        f"entry OK: (144, 256, 3) {float(aux['segments'])}")


def test_entry_needs_the_card_unless_the_cpu_is_named(fresh_runs,
                                                      monkeypatch):
    """No CPU fallback: without CUDA and without ``--device cpu`` the
    module exits non-zero with ``resolve_device``'s message, and
    ``entry()`` raises it."""
    rc, out, err = fresh_runs["entry without a card"]
    assert rc != 0 and "entry OK" not in out
    assert "CUDA is not available; pass device='cpu'" in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()
