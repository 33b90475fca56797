"""The port's offline CLI (``python -m raytracer_tpu_torch.app.cli``)
against the JAX package's (``raytracer_tpu/app/cli.py``).

- ``build_parser()``: the same options with the same defaults and
  choices, apart from the port's ``--device``;
- ``main([... '--device', 'cpu'])`` on two_sphere at 48x27, 2 spp, depth
  3 against the JAX CLI's ``--backend pallas`` (Pallas in interpret mode),
  the PNGs decoded: at least 99.5 % of the u8 values equal and none off
  by more than 1 (measured on seeds 0-5, with and without rr2 and the
  stratified sampler: every value equal); ``--backend jnp`` against the
  JAX CLI's, the same bound (measured: every value equal, a batch render
  and two progressive frames);
- the progressive, AOV, adaptive ``--spp-map`` and warning paths, the
  options the port refuses, and without a card and without ``--device``
  a clear error and a non-zero exit, never a CPU render.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu.app import cli as jax_cli
from raytracer_tpu_torch.app import cli, io
from raytracer_tpu_torch.render import schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_EQUAL_SHARE = 0.995
MAX_U8_DIFF = 1
TINY = ["--config", "two_sphere", "--width", "48", "--height", "27",
        "--max-depth", "3"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Intra-op threads only contend between test workers, and with them
    PyTorch's exp and log were seen to return a thread's chunk off by
    1e-5..1e-4 (ROADMAP §C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def png(path):
    with open(path, "rb") as f:
        return io.decode_png(f.read())


def options(parser) -> dict:
    return {a.dest: (sorted(a.option_strings), a.default,
                     None if a.choices is None else list(a.choices),
                     a.const, a.nargs, a.type)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    port, ref = options(cli.build_parser()), options(jax_cli.build_parser())
    assert port.pop("device") == (["--device"], "cuda", None, None, None,
                                  None)
    assert port == ref
    assert cli.build_parser().parse_args([]).config == "demo"


def test_parser_rejects_bad_config():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--config", "bogus"])


@pytest.mark.parametrize("extra", [[], ["--russian-roulette", "2",
                                        "--sampler", "stratified"]],
                         ids=["default", "rr2_stratified"])
def test_cli_render_matches_jax_cli(tmp_path, capsys, extra):
    base = TINY + ["--spp", "2", "--seed", "1"] + extra
    ref, out = str(tmp_path / "j.png"), str(tmp_path / "p.png")
    assert jax_cli.main(base + ["--backend", "pallas", "--out", ref]) == 0
    capsys.readouterr()
    assert cli.main(base + ["--device", "cpu", "--out", out]) == 0
    msg = capsys.readouterr().out
    assert "two_sphere: 48x27 spp=2 depth=3 backend=auto" in msg
    assert "Mrays/s" in msg
    a, b = png(ref).astype(int), png(out).astype(int)
    assert a.shape == b.shape == (27, 48, 3)
    assert (a == b).mean() >= MIN_EQUAL_SHARE
    assert np.abs(a - b).max() <= MAX_U8_DIFF


def test_cli_progressive_render(tmp_path, capsys):
    out = str(tmp_path / "p.png")
    assert cli.main(TINY + ["--progressive-frames", "3", "--device", "cpu",
                            "--out", out]) == 0
    assert png(out).shape == (27, 48, 3)
    assert "Mrays/s" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["normal", "uuid"])
def test_cli_aov_render(tmp_path, capsys, mode):
    ref, out = str(tmp_path / "j.png"), str(tmp_path / "p.png")
    assert jax_cli.main(TINY + ["--aov", mode, "--out", ref]) == 0
    assert cli.main(TINY + ["--aov", mode, "--device", "cpu",
                            "--out", out]) == 0
    assert f"AOV={mode}" in capsys.readouterr().out
    a, b = png(ref).astype(int), png(out).astype(int)
    assert (a == b).mean() >= MIN_EQUAL_SHARE


def test_cli_book_physics(tmp_path):
    base = TINY + ["--spp", "2", "--max-depth", "1", "--device", "cpu"]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    cli.main(base + ["--out", a])
    cli.main(base + ["--book-physics", "--out", b])
    # depth-1 exhaustion: the reference keeps throughput, the book is black
    assert png(a).astype(int).sum() > png(b).astype(int).sum()


def test_cli_adaptive_spp_map(tmp_path, monkeypatch, capsys):
    """--spp-map saves the sample-density heatmap (a schedule of 3-spp
    chunks and a 4-sample minimum, so pixels stop at this size)."""
    monkeypatch.setattr(schedule, "pick_chunk_spp",
                        lambda spp, *a, **k: min(spp, 3))
    monkeypatch.setattr(schedule, "ADAPTIVE_MIN_N", 4)
    out, mp = str(tmp_path / "r.png"), str(tmp_path / "m.png")
    assert cli.main([
        "--config", "two_sphere", "--width", "128", "--height", "32",
        "--spp", "27", "--max-depth", "4", "--adaptive", "0.05",
        "--sampler", "stratified", "--spp-map", mp, "--device", "cpu",
        "--out", out,
    ]) == 0
    heat = png(mp)
    assert heat.shape == (32, 128, 3)
    assert heat.max() == 255  # normalised to the busiest pixel
    assert heat.min() < heat.max()  # the density varies
    assert "adaptive: mean effective spp" in capsys.readouterr().out


def test_cli_spp_map_warns_without_adaptive(tmp_path, capsys):
    out, mp = str(tmp_path / "r.png"), str(tmp_path / "m.png")
    assert cli.main(TINY + ["--spp", "2", "--spp-map", mp, "--device", "cpu",
                            "--out", out]) == 0
    assert "spp-map" in capsys.readouterr().err
    assert not os.path.exists(mp)


def test_cli_progressive_strips_adaptive_with_warnings(tmp_path, capsys):
    """--adaptive with --progressive-frames warns and renders fixed spp:
    the same PNG as without the tolerance."""
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    base = TINY + ["--progressive-frames", "2", "--device", "cpu"]
    assert cli.main(base + ["--adaptive", "0.2", "--spp-map",
                            str(tmp_path / "m.png"), "--out", a]) == 0
    err = capsys.readouterr().err
    assert "--adaptive" in err and "--spp-map" in err
    assert cli.main(base + ["--out", b]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("flags", [
    ["--spp", "2"],
    ["--spp", "1", "--progressive-frames", "2", "--adaptive", "0.2"],
], ids=["jnp", "jnp_progressive"])
def test_cli_jnp_backend_renders(tmp_path, capsys, flags):
    """``--backend jnp`` on the CPU: the PNG byte for byte the same call's
    PNG made in process (``render_image``, or the jnp step's running
    average), and within the u8 bounds of the JAX CLI's ``--backend jnp``;
    ``--adaptive`` warns as the JAX CLI does and renders fixed spp."""
    from raytracer_tpu_torch.progressive.state import init_render_state
    from raytracer_tpu_torch.progressive.step import make_step_fn, run_frames
    from raytracer_tpu_torch.render.api import render_image
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    out, ref = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    args = TINY + flags + ["--backend", "jnp", "--seed", "3"]
    assert cli.main(args + ["--device", "cpu", "--out", out]) == 0
    said = capsys.readouterr()
    assert "backend=jnp" in said.out
    scene, cam, w, h, _, _ = presets.get_config("two_sphere", 48, 27)
    opts = TraceOptions(max_depth=3, backend="jnp")
    if "--progressive-frames" in flags:
        assert ("warning: --adaptive requires the Pallas batch backend; "
                "rendering fixed spp") in said.err
        step = make_step_fn(w, h, 1, opts, device="cpu")
        state, _ = run_frames(step, init_render_state(w, h, 3, device="cpu"),
                              scene, cam, 2)
        image = state.accum
    else:
        image = render_image(scene, cam, w, h, 2, 3, opts, device="cpu")
    assert open(out, "rb").read() == io.encode_png(image.numpy())
    assert jax_cli.main(args + ["--out", ref]) == 0
    a, b = png(out).astype(int), png(ref).astype(int)
    assert (a == b).mean() >= MIN_EQUAL_SHARE
    assert np.abs(a - b).max() <= MAX_U8_DIFF


@pytest.mark.parametrize("flags, match", [
    (["--cluster-bounds", "sphere"], "ROADMAP.md §2"),
])
def test_cli_refuses_unported_options(tmp_path, flags, match):
    out = str(tmp_path / "r.png")
    with pytest.raises(NotImplementedError, match=match):
        cli.main(TINY + flags + ["--device", "cpu", "--out", out])
    assert not os.path.exists(out)


def test_cli_without_card_and_device_exits_with_an_error(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "r.png")
    with pytest.raises(SystemExit) as got:
        cli.main(TINY + ["--out", out])
    assert got.value.code == 2
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "--device cpu" in err
    assert not os.path.exists(out)


def test_cli_module_runs_on_the_cpu_when_asked(tmp_path):
    """``python -m``: exit 0 with ``--device cpu``; without it, on a
    machine without a card, a non-zero exit and no image."""
    out = str(tmp_path / "x.png")
    run = [sys.executable, "-m", "raytracer_tpu_torch.app.cli",
           "--config", "two_sphere", "--width", "48", "--height", "27",
           "--spp", "2", "--out", out]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    done = subprocess.run(run + ["--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert png(out).shape == (27, 48, 3)
    if torch.cuda.is_available():
        return
    os.remove(out)
    done = subprocess.run(run, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode != 0
    assert "CUDA is not available" in done.stderr
    assert not os.path.exists(out)
