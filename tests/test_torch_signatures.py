"""The port's public calls take the JAX package's arguments in the JAX
package's meaning, or raise.

The rule (ROADMAP): a call the JAX package accepts either means the same
in the port or raises. For every public function and class that a module
of ``raytracer_tpu`` defines (less ``native/`` and ``utils/jaxcache.py``)
and the port's module of the same path also defines:

- the port's positional parameters are the JAX package's, in its order
  and under its names, up to the first one the port lacks; everything
  after that, and every parameter of the port's own, is keyword-only;
- where the JAX package gives a default, the port gives the same one (a
  JAX dtype is compared with its torch dtype). One default differs on
  purpose: ``retry_on_device_fault``'s ``delay_s`` (``DEFAULT_EXCEPTIONS``).

``ClusteredScene`` is a data structure laid out for the port on purpose:
a JAX-shaped construction must raise.

Then the calls of the fault list (ROADMAP queue 3 item 1): each
JAX-style call gives the JAX package's meaning, checked against the JAX
package's value on the CPU where it computes one, or raises; each call in
the port's old order raises.
"""

import dataclasses
import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.render import rng

#: module (relative to either package) → the public names both define
PAIRS = {
    "app.cli": ("build_parser", "main"),
    "app.display": ("encode_frame_png", "kitty_frame",
                    "parse_kitty_commands"),
    "app.engine": ("Engine",),
    "app.io": ("decode_png", "encode_png", "save_png", "tonemap_u8"),
    "app.viewer": ("MouseLook", "frame_to_ansi", "parse_keys", "run_viewer"),
    "camera.camera": ("CameraConfig", "DerivedCamera", "camera_front",
                      "center_ray", "derive_camera", "generate_rays",
                      "pixel_st_grid"),
    "camera.controller": ("KeydownMap", "mouse_look", "set_camera_angles",
                          "set_fov", "update_position", "zoom"),
    "core.ray": ("Ray",),
    "core.sampling": ("alphas_fixed32", "disk_from_uv", "fold",
                      "pixel_jitter", "r2_point", "random_in_unit_disk",
                      "random_in_unit_sphere", "random_unit_vector",
                      "sphere_disk_glass_uniforms", "stratified_rotations",
                      "unit_vector_from_uv"),
    "core.vec": ("cross", "degrees_to_radians", "dot", "length",
                 "length_squared", "mix", "near_zero", "near_zero_signed",
                 "normalize", "reflect", "refract", "vec3"),
    "interact.appstate": ("AppState", "adjusted_screen_dimensions",
                          "cameras_equal"),
    "interact.picking": ("CenterHit", "update_cursor_state"),
    "parallel.sharding": ("make_mesh", "make_sharded_step_fn",
                          "render_image_sharded",
                          "render_image_sharded_pallas",
                          "shard_render_state"),
    "progressive.state": ("RenderState", "init_render_state",
                          "load_render_state", "reset_accumulation",
                          "save_render_state"),
    "progressive.step": ("accumulate", "make_step_fn", "run_frames"),
    "render.api": ("render_image", "resolve_backend"),
    "render.debug": ("render_aov",),
    "render.options": ("DebugParams", "TraceOptions",
                       "cluster_scan_enabled"),
    "render.pallas_kernel": ("render_image_pallas",),
    "render.tracer": ("HitRecord", "background", "hit_world",
                      "render_image_jnp", "render_sample", "scatter",
                      "schlick", "trace_rays"),
    "scene.accel": ("ClusteredScene", "build_grid_clustered"),
    "scene.materials": ("Material",),
    "scene.presets": ("cover_camera", "cover_scene", "demo_camera",
                      "demo_scene", "dof_camera", "get_config",
                      "simple_camera", "three_sphere_scene",
                      "two_sphere_scene", "yaw_pitch_from_lookat"),
    "scene.spheres": ("Scene", "add_sphere", "make_scene", "remove_sphere",
                      "update_sphere"),
    "utils.profiling": ("MraysMeter", "device_trace", "mrays_per_sec"),
    "utils.resilience": ("is_device_fault", "retry_on_device_fault"),
}
#: laid out for the port on purpose (its own test below)
NOT_COMPARED = {("scene.accel", "ClusteredScene")}
#: (module, name, parameter) whose default differs on purpose
DEFAULT_EXCEPTIONS = {("utils.resilience", "retry_on_device_fault",
                       "delay_s")}
SKIPPED_MODULES = ("raytracer_tpu.native", "raytracer_tpu.utils.jaxcache")
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def both(module: str, name: str):
    jax_obj = getattr(importlib.import_module(f"raytracer_tpu.{module}"),
                      name)
    port_obj = getattr(
        importlib.import_module(f"raytracer_tpu_torch.{module}"), name)
    return jax_obj, port_obj


def same_default(jax_default, port_default) -> bool:
    """Equal defaults; a JAX (numpy) dtype equals the torch dtype of the
    same name."""
    if isinstance(port_default, torch.dtype):
        try:
            return np.dtype(jax_default).name == str(port_default).split(
                ".")[-1]
        except TypeError:
            return False
    return bool(jax_default == port_default)


def walk_pairs() -> set:
    import raytracer_tpu

    found = set()
    for info in pkgutil.walk_packages(raytracer_tpu.__path__,
                                      "raytracer_tpu."):
        if info.name.startswith(SKIPPED_MODULES):
            continue
        jax_mod = importlib.import_module(info.name)
        rel = info.name.removeprefix("raytracer_tpu.")
        try:
            port_mod = importlib.import_module(f"raytracer_tpu_torch.{rel}")
        except ImportError:
            continue
        for name, obj in vars(jax_mod).items():
            if (not name.startswith("_")
                    and (inspect.isfunction(obj) or inspect.isclass(obj))
                    and obj.__module__ == info.name
                    and hasattr(port_mod, name)):
                found.add((rel, name))
    return found


def test_the_walk_finds_these_pairs():
    """``PAIRS`` is every public function and class both packages define
    in a module of the same path: a name added to both is checked too."""
    assert walk_pairs() == {(m, n) for m, names in PAIRS.items()
                            for n in names}


CASES = [(m, n) for m, names in PAIRS.items() for n in names
         if (m, n) not in NOT_COMPARED]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m}.{n}" for m, n in CASES])
def test_signature_is_the_jax_packages(module, name):
    """Positional parameters: the JAX package's, in its order, up to the
    first it has that the port lacks; the rest keyword-only. Defaults:
    the JAX package's wherever it gives one."""
    jax_obj, port_obj = both(module, name)
    want = inspect.signature(jax_obj).parameters
    got = inspect.signature(port_obj).parameters
    jax_pos = [a for a, p in want.items() if p.kind in POSITIONAL]
    port_pos = [a for a, p in got.items() if p.kind in POSITIONAL]
    lacked = next((i for i, a in enumerate(jax_pos) if a not in got),
                  len(jax_pos))
    assert port_pos == jax_pos[:lacked], (
        f"positional {port_pos}; the JAX package's shared prefix "
        f"{jax_pos[:lacked]}")
    var = inspect.Parameter.VAR_POSITIONAL
    assert ([p.kind == var for p in want.values()].count(True)
            == [p.kind == var for p in got.values()].count(True))
    for arg, p in want.items():
        if (arg not in got or p.default is inspect.Parameter.empty
                or (module, name, arg) in DEFAULT_EXCEPTIONS):
            continue
        assert same_default(p.default, got[arg].default), (
            f"{arg}: JAX {p.default!r}, port {got[arg].default!r}")


def test_delay_s_is_the_one_default_kept_apart():
    """``delay_s`` exists in both, keyword-only; the port waits 0 s
    (nothing to wait for after an allocation fault), JAX 10 s."""
    jax_fn, port_fn = both("utils.resilience", "retry_on_device_fault")
    want = inspect.signature(jax_fn).parameters["delay_s"]
    got = inspect.signature(port_fn).parameters["delay_s"]
    assert want.kind == got.kind == inspect.Parameter.KEYWORD_ONLY
    assert (want.default, got.default) == (10.0, 0.0)


# --- the fault list's calls ------------------------------------------


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bound(module, name, *args, **kwargs) -> dict:
    """The arguments a call binds, by parameter name, in each package."""
    jax_obj, port_obj = both(module, name)
    j = inspect.signature(jax_obj).bind(*args, **kwargs).arguments
    p = inspect.signature(port_obj).bind(*args, **kwargs).arguments
    return j, p


def small_scene():
    from raytracer_tpu_torch.scene import presets

    return presets.get_config("two_sphere", 16, 8)[:2]


def test_trace_options_positional_is_the_jax_packages():
    from raytracer_tpu.render.options import TraceOptions as JaxOptions

    from raytracer_tpu_torch.render.options import TraceOptions

    args = (8, False, 1e-3, True, True)
    got, want = TraceOptions(*args), JaxOptions(*args)
    assert got.enable_debug is True and got.russian_roulette_depth == 0
    shared = [f.name for f in dataclasses.fields(JaxOptions)][:14]
    assert ([getattr(got, f) for f in shared]
            == [getattr(want, f) for f in shared])
    # the JAX package's whole prefix up to cluster_scan, positionally
    full = (6, True, False, False, False, "jnp", 3, False, 0.5, 4,
            "stratified", False, False, False)
    assert ([getattr(TraceOptions(*full), f) for f in shared]
            == [getattr(JaxOptions(*full), f) for f in shared])


@pytest.mark.parametrize("call", ["fifteen positional", "cluster_cpi",
                                  "cluster_cell", "pad_rng"])
def test_trace_options_raise_where_the_port_has_no_field(call):
    from raytracer_tpu_torch.render.options import TraceOptions

    with pytest.raises(TypeError):
        if call == "fifteen positional":
            TraceOptions(8, False, False, True, False, "auto", 0, True, 0.0,
                         0, "random", True, False, "auto", 1)
        else:
            TraceOptions(**{call: 1})


def test_render_image_debug_is_the_eighth_argument():
    """``render_image(s, c, w, h, n, k, opts, DebugParams)``: an image
    with the overlay, equal to the keyword call; the old positional
    ``return_stats`` raises."""
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import DebugParams, TraceOptions

    scene, cam = small_scene()
    opts = TraceOptions(max_depth=2, enable_debug=True)
    dbg = DebugParams((0.0, 0.0, -1.0), 1)
    j, p = bound("render.api", "render_image", scene, cam, 16, 8, 1, 3,
                 opts, dbg)
    assert list(j) == list(p) and p["debug"] is dbg and p["key"] == 3
    got = render_image(scene, cam, 16, 8, 1, 3, opts, dbg, device="cpu")
    want = render_image(scene, cam, 16, 8, 1, key=3, opts=opts, debug=dbg,
                        device="cpu")
    assert isinstance(got, torch.Tensor) and torch.equal(got, want)
    with pytest.raises(TypeError):
        render_image(scene, cam, 16, 8, 1, 3, opts, True, device="cpu")
    with pytest.raises(TypeError):
        render_image(scene, cam, 16, 8, 1, seed=3, device="cpu")
    with pytest.raises(TypeError):  # device is keyword-only
        render_image(scene, cam, 16, 8, 1, 3, opts, None, False, "cpu")
    _, stats = render_image(scene, cam, 16, 8, 1, 3, opts, dbg, True,
                            device="cpu")
    assert stats["segments"] > 0


def test_make_step_fn_takes_backend_and_jit():
    """``make_step_fn(w, h, 1, opts, True, 1.0, 100000, 'jnp', False)``
    is the JAX package's call (``__graft_entry__.py`` passes
    ``jit=False``): a jnp step, whose frame equals the keyword call's;
    a scene in the old 8th position raises."""
    from raytracer_tpu_torch.progressive.state import init_render_state
    from raytracer_tpu_torch.progressive.step import make_step_fn
    from raytracer_tpu_torch.render.options import TraceOptions

    scene, cam = small_scene()
    opts = TraceOptions(max_depth=2)
    args = (16, 8, 1, opts, True, 1.0, 100000, "jnp", False)
    j, p = bound("progressive.step", "make_step_fn", *args)
    assert j == p
    frames = []
    for step in (make_step_fn(*args, device="cpu"),
                 make_step_fn(16, 8, 1, opts, backend="jnp",
                              device="cpu")):
        state, _ = step(init_render_state(16, 8, 2, device="cpu"), scene,
                        cam)
        frames.append(state.accum)
    assert torch.equal(*frames)
    with pytest.raises(TypeError):
        make_step_fn(16, 8, 1, opts, True, 1.0, 100000, scene,
                     device="cpu")
    with pytest.raises(TypeError):
        make_step_fn(16, 8, 1, opts, jit="no", device="cpu")


def test_engine_backend_is_the_seventh_argument():
    from raytracer_tpu_torch.app.engine import Engine
    from raytracer_tpu_torch.render.rng import key_data

    scene, cam = small_scene()
    j, p = bound("app.engine", "Engine", scene, cam, 16, 8, 1, 2, "jnp", 5,
                 True)
    assert j == p
    eng = Engine(scene, cam, 16, 8, 1, 2, "jnp", 5, True, device="cpu")
    assert eng.backend == "jnp" and eng.app.enable_debugging
    assert eng.render_state.key == key_data(5)
    with pytest.raises(TypeError):  # the old order: the seed 7th
        Engine(scene, cam, 16, 8, 1, 2, 5, device="cpu")
    with pytest.raises(TypeError):  # not ported, kept out on purpose
        Engine(scene, cam, 16, 8, exhaust_black=True, device="cpu")
    with pytest.raises(TypeError):
        Engine(scene, cam, 16, 8, 1, 2, "jnp", 5, True, False,
               device="cpu")


def test_retry_sleeps_delay_s(monkeypatch):
    from raytracer_tpu_torch.utils import resilience

    slept = []
    monkeypatch.setattr(resilience.time, "sleep", slept.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return "done"

    waiting = resilience.retry_on_device_fault(retries=2, delay_s=0.25)
    assert waiting(flaky)() == "done" and slept == [0.25, 0.25]
    calls.clear()
    slept.clear()
    assert resilience.retry_on_device_fault(retries=2)(flaky)() == "done"
    assert slept == []


def test_render_aov_key_is_the_sixth_argument():
    """``render_aov(s, c, w, h, 'uuid', key)`` takes a key, as the JAX
    function does, and renders on the CPU when the CPU is named; a
    defocused camera's view does not depend on the key in either package
    (the lens radius is zeroed), and the port's equals the JAX
    package's."""
    from raytracer_tpu.render import debug as jax_debug
    from raytracer_tpu.scene import presets as jax_presets

    from raytracer_tpu_torch.camera.camera import camera_from_numpy
    from raytracer_tpu_torch.render.debug import render_aov
    from raytracer_tpu_torch.scene.spheres import scene_from_numpy

    w, h = 24, 16
    j_scene, j_cam = jax_presets.get_config("dof", w, h)[:2]
    assert float(j_cam.aperture) > 0
    scene = scene_from_numpy(**{f.name: np.asarray(getattr(j_scene, f.name))
                                for f in dataclasses.fields(j_scene)})
    cam = camera_from_numpy({f.name: np.asarray(getattr(j_cam, f.name))
                             for f in dataclasses.fields(j_cam)})
    j, p = bound("render.debug", "render_aov", scene, cam, w, h, "uuid", 0)
    assert j == p
    jax_views = [np.asarray(jax_debug.render_aov(
        j_scene, j_cam, w, h, "uuid", jax.random.PRNGKey(k)))
        for k in (0, 7)]
    port_views = [render_aov(scene, cam, w, h, "uuid", k, device="cpu")
                  for k in (0, 7)]
    assert np.array_equal(*jax_views)
    assert torch.equal(*port_views)
    assert torch.equal(port_views[0], render_aov(scene, cam, w, h, "uuid",
                                                 device="cpu"))
    # the AOV test's bound (tests/test_torch_debug.py): uuid colours
    # equal on at least 99.9 % of pixels
    same = np.all(port_views[0].numpy() == jax_views[0], axis=-1).mean()
    assert same >= 0.999
    with pytest.raises(TypeError):  # the old order: a device 6th
        render_aov(scene, cam, w, h, "uuid", "cpu")


def test_build_grid_clustered_takes_the_cell_size():
    """``build_grid_clustered(s, 2.0)`` is a grid partition of cell size
    2 in the JAX package: not ported, so it raises; with ``partition=
    'kd'`` the port's partition is the JAX package's."""
    from raytracer_tpu.scene import accel as jax_accel
    from raytracer_tpu.scene import presets as jax_presets

    from raytracer_tpu_torch.scene.accel import build_grid_clustered
    from raytracer_tpu_torch.scene.spheres import scene_from_numpy

    j_scene = jax_presets.get_config("cover", 32, 16)[0]
    scene = scene_from_numpy(**{f.name: np.asarray(getattr(j_scene, f.name))
                                for f in dataclasses.fields(j_scene)})
    for args in ((), (2.0,), (2.0, 0.5, 8)):
        with pytest.raises(NotImplementedError):
            build_grid_clustered(scene, *args)
    got = build_grid_clustered(scene, 2.0, 0.5, 8, "kd")
    want = jax_accel.build_grid_clustered(j_scene, 2.0, 0.5, 8, "kd")
    assert np.array_equal(got.uuid, np.asarray(want.uuid))
    assert got.n_global == int(want.n_global)


def test_clustered_scene_of_the_jax_shape_raises():
    from raytracer_tpu_torch.scene.accel import ClusteredScene

    scene, _ = small_scene()
    with pytest.raises(TypeError):
        ClusteredScene(scene, np.zeros((1, 2, 3), np.float32),
                       np.zeros(2, np.int32))


def test_init_render_state_key_none_is_prngkey_0():
    from raytracer_tpu.progressive import state as jax_state

    from raytracer_tpu_torch.progressive.state import init_render_state

    got = init_render_state(4, 2, device="cpu")
    want = jax_state.init_render_state(4, 2)
    assert got.key == tuple(int(v) for v in np.asarray(want.key))
    assert got.key == init_render_state(4, 2, 0, device="cpu").key
    with pytest.raises(TypeError):  # device is keyword-only
        init_render_state(4, 2, 0, "cpu")


def test_pixel_st_grid_third_argument_is_the_dtype():
    from raytracer_tpu.camera.camera import pixel_st_grid as jax_grid

    from raytracer_tpu_torch.camera.camera import pixel_st_grid

    got = pixel_st_grid(24, 10, torch.float32)
    assert np.array_equal(got.numpy(), np.asarray(jax_grid(24, 10,
                                                           jnp.float32)))
    assert pixel_st_grid(24, 10, torch.float64).dtype == torch.float64
    with pytest.raises(TypeError):  # the old order: a device 3rd
        pixel_st_grid(24, 10, "cpu")


DRAWS = ("pixel_jitter", "random_in_unit_disk", "random_in_unit_sphere",
         "random_unit_vector", "sphere_disk_glass_uniforms")


@pytest.mark.parametrize("name", DRAWS + ("stratified_rotations", "fold"))
def test_draws_take_key(name):
    """The draws' first argument is ``key`` (the port's key data), by
    position or by name; ``device`` is keyword-only."""
    from raytracer_tpu_torch.core import sampling

    fn = getattr(sampling, name)
    kd = rng.key_data(9)
    second = 5 if name == "stratified_rotations" else (3,)
    if name == "fold":
        assert fn(key=kd) == kd
        assert fn(kd, 1, 2) == rng.fold_in(rng.fold_in(kd, 1), 2)
        with pytest.raises(TypeError):
            fn(kd=kd)
        return
    by_pos = fn(kd, second, device="cpu")
    by_name = fn(key=kd, **({"p": second} if name == "stratified_rotations"
                            else {"shape": second}), device="cpu")
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (by_pos, by_name))):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        fn(kd, second, "cpu")
    with pytest.raises(TypeError):
        fn(kd=kd)


@pytest.mark.parametrize("name", ["pixel_jitter", "random_unit_vector"])
def test_draws_are_the_jax_packages(name):
    """By key, the JAX package's draws (Threefry is bitwise; the maps
    within a few ulp, the tolerance of ``tests/test_torch_sampling.py``)."""
    from raytracer_tpu.core import sampling as jax_sampling

    from raytracer_tpu_torch.core import sampling

    key = jax.random.PRNGKey(11)
    want = np.asarray(getattr(jax_sampling, name)(key=key, shape=(64,)))
    got = getattr(sampling, name)(key=rng.key_data(np.asarray(key)),
                                  shape=(64,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_keyword_only_device_in_the_ports_own_parameters():
    """``load_render_state``, ``accumulate``, ``run_viewer`` and
    ``render_image_jnp`` take the port's own parameters by keyword
    only."""
    from raytracer_tpu_torch.progressive.step import accumulate

    prev, new = torch.zeros(2, 2, 3), torch.ones(2, 2, 3)
    out = torch.empty(2, 2, 3)
    accumulate(prev, new, 2, 1.0, out=out)
    assert torch.equal(out, torch.full((2, 2, 3), 1.0 / 3.0))
    with pytest.raises(TypeError):
        accumulate(prev, new, 2, 1.0, out)
    for module, name, param in (
            ("progressive.state", "load_render_state", "device"),
            ("app.viewer", "run_viewer", "device"),
            ("render.tracer", "render_image_jnp", "device")):
        got = inspect.signature(both(module, name)[1]).parameters[param]
        assert got.kind == inspect.Parameter.KEYWORD_ONLY, name
