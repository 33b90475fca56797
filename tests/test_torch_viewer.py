"""The port's terminal viewer and kitty display against the JAX
package's (``raytracer_tpu/app/viewer.py``, ``app/display.py``): the
cases of ``tests/test_viewer.py``, each run through both packages, whose
outputs must be **byte-identical** (``frame_to_ansi``, ``parse_keys``,
``MouseLook``, ``kitty_frame``); the kitty payload round-trips to
``tonemap_u8``; and the raw-terminal loop driven under a pty on the CPU.
"""

import base64
import os
import pty
import subprocess
import sys
import time

import numpy as np
import pytest

from raytracer_tpu.app import display as jax_display
from raytracer_tpu.app import viewer as jax_viewer
from raytracer_tpu_torch.app import display, viewer
from raytracer_tpu_torch.app.io import decode_png, tonemap_u8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frame(kind: str):
    rng = np.random.default_rng(7)
    if kind == "red":
        img = np.zeros((8, 16, 3), np.float32)
        img[:, :, 0] = 1.0
        return img, 16
    if kind == "blue_top":
        img = np.zeros((4, 4, 3), np.float32)
        img[-1, :, 2] = 1.0  # the GL top row
        return img, 4
    h, w, cols = {"wide": (32, 200, 50), "odd": (17, 33, 10),
                  "tall": (45, 100, 100), "pty": (36, 64, 24)}[kind]
    # out of gamut too: the clamp is part of the encoding
    return rng.random((h, w, 3), dtype=np.float32) * 1.4 - 0.2, cols


FRAMES = ["red", "blue_top", "wide", "odd", "tall", "pty"]


@pytest.mark.parametrize("kind", FRAMES)
def test_frame_to_ansi_matches_jax(kind):
    img, cols = frame(kind)
    got = viewer.frame_to_ansi(img, cols)
    assert got == jax_viewer.frame_to_ansi(img, cols)
    assert got.endswith("\x1b[0m")
    if kind == "red":
        assert len(got.split("\n")) == 4 and "38;2;255;0;0" in got
    if kind == "blue_top":
        assert "38;2;0;0;255" in got.split("\n")[0]
    if kind == "wide":
        assert got.split("\n")[0].count("▀") == 50


# (chars, pending) drains of tests/test_viewer.py
KEY_CASES = {
    "plain": [(list("wasd+x"), "")],
    "arrows": [(list("\x1b[A\x1b[Bw\x1bOC\x1b[D"), "")],
    "split_arrow": [(["\x1b", "["], ""), (["A", "w"], None)],
    "lone_escape": [(["\x1b"], ""), (["\x1b", "q"], "")],
    "sgr": [(list("\x1b[<0;10;5M\x1b[<32;12;6Mw\x1b[<0;12;6m\x1b[<64;3;3M"),
             "")],
    "split_sgr": [(list("\x1b[<32;1"), ""), (list("40;22Mq"), None)],
    "malformed_sgr": [(list("\x1b[<a;b;cMw"), "")],
    "flooding_sgr": [(list("\x1b[<" + "9" * 40), "")],
}


@pytest.mark.parametrize("drains", KEY_CASES.values(), ids=KEY_CASES)
def test_parse_keys_matches_jax(drains):
    """Each drain with the given pending, or with the previous drain's
    (None), through both packages."""
    pending = jax_pending = ""
    for chars, given in drains:
        if given is not None:
            pending = jax_pending = given
        got = viewer.parse_keys(chars, pending)
        want = jax_viewer.parse_keys(chars, jax_pending)
        assert got == want
        (_, pending), (_, jax_pending) = got, want


MOUSE_FEED = [(32, 5, 5, False), (0, 10, 5, False), (32, 12, 6, False),
              (32, 11, 6, False), (0, 11, 6, True), (32, 20, 9, False),
              (64, 1, 1, False), (65, 1, 1, False), (1, 3, 3, False),
              (0, 3, 3, False), (32, 3, 3, False), (34, 7, 1, False)]


@pytest.mark.parametrize("cell_px", [4.0, 2.5, 0.3])
def test_mouse_look_matches_jax(cell_px):
    port, ref = viewer.MouseLook(cell_px), jax_viewer.MouseLook(cell_px)
    assert port.cell_px == ref.cell_px
    got = [port.feed(*r) for r in MOUSE_FEED]
    assert got == [ref.feed(*r) for r in MOUSE_FEED]
    if cell_px == 4.0:
        assert got[2:4] == [(8.0, 8.0), (-4.0, 0.0)]


@pytest.mark.parametrize("shape, image_id", [
    ((48, 96, 3), 7), ((5, 3, 3), 1), ((128, 200, 3), 2),
])
def test_kitty_frame_matches_jax_and_round_trips(shape, image_id):
    img = np.random.default_rng(3).random(shape, dtype=np.float32)
    got = display.kitty_frame(img, image_id=image_id)
    assert got == jax_display.kitty_frame(img, image_id=image_id)
    cmds = display.parse_kitty_commands(got)
    assert cmds == jax_display.parse_kitty_commands(got)
    assert cmds[0][0] == {"a": "d", "d": "i", "i": str(image_id), "q": "2"}
    first = cmds[1][0]
    assert first["a"] == "T" and first["f"] == "100"
    for kv, chunk in cmds[1:-1]:
        assert kv["m"] == "1" and len(chunk) == display.CHUNK
    assert cmds[-1][0]["m"] == "0"
    payload = "".join(chunk for _, chunk in cmds[1:])
    decoded = decode_png(base64.standard_b64decode(payload))
    assert np.array_equal(decoded, tonemap_u8(img, flip_vertical=True))


def test_run_viewer_runs_the_jnp_backend(monkeypatch):
    """``backend='jnp'`` off a terminal on the CPU: the engine renders
    with the jnp tracer and the frames are drawn as ANSI."""
    import contextlib
    import io as stdio

    made, real = [], viewer.Engine

    def engine(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(viewer, "Engine", engine)
    out = stdio.StringIO()
    with open(os.devnull) as null, contextlib.redirect_stdout(out):
        monkeypatch.setattr(sys, "stdin", null)
        n = viewer.run_viewer("two_sphere", 16, 8, backend="jnp",
                              max_frames=2, target_fps=1e6, device="cpu")
    assert n == 2 and made[0].backend == "jnp"
    assert made[0].render_state.render_count == 2
    assert "\x1b[38;2;" in out.getvalue()


def test_viewer_loop_pty_smoke():
    """The raw-terminal loop in a child process under a pty, on the CPU:
    look, move, zoom, pause, reset, debug and mouse input are consumed,
    frames are drawn as ANSI, and 'q' (or the frame cap) exits cleanly."""
    code = (
        "from raytracer_tpu_torch.app.viewer import run_viewer; "
        "n = run_viewer('two_sphere', 64, 36, max_frames=60, "
        "target_fps=1000.0, cols=24, device='cpu'); "
        "print('VIEWER_DONE', n)"
    )
    master, slave = pty.openpty()
    proc = subprocess.Popen(
        [sys.executable, "-c", code], stdin=slave, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    os.close(slave)
    try:
        # an SGR press, drag, release and wheel among the keys
        for key in [b"i", b"j", b"w", b"+", b"g", b"p", b"p", b"r",
                    b"\x1b[<0;10;5M", b"\x1b[<32;12;6M",
                    b"\x1b[<0;12;6m", b"\x1b[<64;5;5M"]:
            os.write(master, key)
            time.sleep(0.2)
        os.write(master, b"q")
        out, _ = proc.communicate(timeout=120)
    finally:
        os.close(master)
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-500:]
    assert b"VIEWER_DONE" in out
    assert b"\x1b[38;2;" in out  # truecolor half-block frames were drawn
    assert b"fps" in out or b"frame" in out
