"""The port's bench line (``python -m raytracer_tpu_torch.bench``)
against the repository's ``bench.py``.

- ``BENCH_DEVICE=cpu BENCH_CONFIG=two_sphere BENCH_SPP=2
  BENCH_REPEATS=1`` (and ``BENCH_CONVERGENCE=golden``, which both skip
  off the cover) prints one JSON line on stdout whose keys equal the keys
  ``bench.py``'s code builds for the same knobs (``bench.py`` run in
  process with its ``render_image`` stubbed);
- its ``segments`` lie within 0.6 % (ROADMAP's ground rules) of the JAX
  package's interpret-mode render (``render_image_pallas``) at the same
  key, ``fold_in(PRNGKey(0), 0)``, the best and only repeat;
- the progressive line has ``bench.py``'s keys;
- ``BENCH_BACKEND=jnp``, ``BENCH_CONVERGENCE=1|full`` and the jnp
  progressive line run on the CPU with ``bench.py``'s keys;
- the knobs the port refuses, and the card missing, give the error line
  (``value`` 0) and exit 1.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.camera.camera import derive_camera as jax_derive_camera
from raytracer_tpu.render import api as jax_api
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions as JaxOptions
from raytracer_tpu.scene import presets as jax_presets
from raytracer_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SEG_REL = 6e-3
KNOBS = {"BENCH_CONFIG": "two_sphere", "BENCH_SPP": "2",
         "BENCH_REPEATS": "1", "BENCH_CONVERGENCE": "golden"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Intra-op threads only contend between test workers, and with them
    PyTorch's exp and log were seen to return a thread's chunk off by
    1e-5..1e-4 (ROADMAP §C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_line(monkeypatch, capsys, knobs) -> dict:
    """``bench.py``'s line for ``knobs``, its renders stubbed (the keys do
    not depend on the pixels). Its device probe stays on: with
    ``BENCH_PROBE_S=0`` its ``main`` never binds ``sys``."""
    for k, v in {**knobs, "BENCH_WATCHDOG_S": "0"}.items():
        monkeypatch.setenv(k, v)

    def stub(scene, cam, w, h, spp, key, opts, **kw):
        return np.zeros((h, w, 3), np.float32), {"segments": 1.0,
                                                 "mean_spp": float(spp)}

    monkeypatch.setattr(jax_api, "render_image", stub)
    capsys.readouterr()
    assert jax_bench().main() == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_run():
    env = {**os.environ, **KNOBS, "BENCH_DEVICE": "cpu",
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "raytracer_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_bench_line_has_the_keys_of_bench_py(port_run, monkeypatch, capsys):
    assert port_run.returncode == 0, port_run.stderr
    lines = port_run.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    want = jax_line(monkeypatch, capsys, KNOBS)
    assert set(line) == set(want)
    assert line["metric"] == want["metric"]
    assert line["unit"] == "Mrays/s" and line["device"] == "cpu"
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 500.0, 4)
    for said in ("rr0 (pure reference physics)", "adaptive(tol=0.2",
                 "golden mode skipped"):
        assert said in port_run.stderr


def test_bench_segments_match_the_interpret_render(port_run):
    """The exact segment total of the best repeat against the JAX
    package's interpret-mode render of the same key and options."""
    line = json.loads(port_run.stdout)
    scene, cam, w, h, _, depth = jax_presets.get_config("two_sphere")
    _, stats = pk.render_image_pallas(
        scene, jax_derive_camera(cam), w, h, 2,
        jax.random.fold_in(jax.random.PRNGKey(0), 0),
        JaxOptions(max_depth=depth, russian_roulette_depth=5),
        return_stats=True)
    ref = float(stats["segments"])
    assert isinstance(line["segments"], int)
    assert abs(line["segments"] - ref) <= MAX_SEG_REL * ref


def test_progressive_line_has_the_keys_of_bench_py(monkeypatch):
    got = bench.bench_progressive(torch.device("cpu"), "demo", 32, 18,
                                  frames=4, batch=2)
    assert set(got) == {"metric", "value", "unit", "vs_baseline",
                        "ms_per_frame", "frames", "segments_per_frame",
                        "backend"}
    assert got["metric"] == "progressive_demo_32x18_1spp_d8 fps"
    assert got["frames"] == 4 and got["segments_per_frame"] > 0
    # the keys bench.py's _bench_progressive builds
    src = open(os.path.join(REPO, "bench.py")).read()
    body = src[src.index("def _bench_progressive"):src.index("def main")]
    ret = body[body.rindex("return {"):]
    for key in got:
        assert f'"{key}":' in ret


QUICK = {"BENCH_CONFIG": "two_sphere", "BENCH_SPP": "1",
         "BENCH_REPEATS": "1", "BENCH_ADAPTIVE": "0", "BENCH_SKIP_RR0": "1",
         "BENCH_DEVICE": "cpu"}


@pytest.mark.parametrize("knobs", [
    {"BENCH_BACKEND": "jnp"},
    {"BENCH_CONVERGENCE": "1"},
    {"BENCH_CONVERGENCE": "full"},
    {"BENCH_CONFIG": "progressive", "BENCH_BACKEND": "jnp"},
], ids=["jnp", "convergence_1", "convergence_full", "progressive_jnp"])
def test_jnp_knobs_print_the_line(monkeypatch, capsys, knobs):
    """``BENCH_BACKEND=jnp`` and ``BENCH_CONVERGENCE=1|full`` run on the
    CPU, the presets cut to 32x18 (the convergence crop is then the whole
    frame) and the progressive line to 4 frames: the line has the keys
    ``bench.py`` builds for the same knobs (its renders stubbed; its
    progressive line's keys read from its source), and the convergence
    keys are numbers."""
    real = bench.presets.get_config
    monkeypatch.setattr(bench.presets, "get_config",
                        lambda name, *a, **k: real(name, 32, 18))
    real_prog = bench.bench_progressive
    monkeypatch.setattr(bench, "bench_progressive", lambda device: real_prog(
        device, frames=4, batch=2))
    knobs = {**QUICK, **knobs}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    assert bench.main() == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert "error" not in line and line["value"] > 0
    assert line["backend"] == knobs.get("BENCH_BACKEND", "auto")
    if knobs["BENCH_CONFIG"] == "progressive":
        assert line["unit"] == "fps" and line["frames"] == 4
        assert line["metric"] == "progressive_demo_32x18_1spp_d8 fps"
        return
    want = jax_line(monkeypatch, capsys, knobs)
    assert set(line) == set(want)
    if "BENCH_CONVERGENCE" in knobs:
        assert 0.0 <= line["convergence_mad_vs_jnp"] < 0.5
        assert isinstance(line["convergence_nan_px"], int)
        assert "vs jnp(rr0) @ 1 spp 32x18" in out.err


@pytest.mark.parametrize("knobs, match", [
    ({"BENCH_CLUSTER_CPI": "2"}, "ROADMAP.md §2"),
    ({"BENCH_CLUSTER_BOUNDS": "sphere"}, "ROADMAP.md §2"),
    ({"BENCH_DEVICE": "cuda"}, "CUDA is not available"),
], ids=["cpi", "sphere", "no_card"])
def test_refused_knobs_print_the_error_line(monkeypatch, capsys, knobs,
                                            match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in {**QUICK, **knobs}.items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert match in line["error"]
    assert line["unit"] == "Mrays/s"


def test_baseline_rate_is_read_from_the_file():
    text = json.load(open(os.path.join(REPO, "BASELINE.json")))["north_star"]
    assert ">500 Mrays/s" in text
    assert bench.baseline_mrays() == 500.0
