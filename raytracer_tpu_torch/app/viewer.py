"""Interactive terminal viewer (counterpart of
``raytracer_tpu/app/viewer.py``): the reference's browser controls on a
raw-mode terminal, over the port's :class:`~raytracer_tpu_torch.app.engine.Engine`.

    w/a/s/d     fly                                i/j/k/l   look
    e/c         up/down                            arrows    look
    p / Esc     pause/resume (Esc only pauses)     +/-       fov zoom
    r           reset scene                        x         save PNG
    g           toggle the debug overlay           q         quit

On a tty the viewer turns on xterm SGR mouse reporting (``CSI ?1002h``
button-event tracking, ``?1006h`` SGR encoding): dragging with the left
button looks around through ``Engine.handle_mouse_move`` and the wheel
zooms. Frames are ANSI truecolor half-blocks (two pixels a character
cell, downsampled to ``cols``), or with ``display='kitty'`` full-resolution
PNG frames through the kitty graphics protocol (``app/display.py``).

Raw terminals deliver key repeats, not key-up events, so each movement
key holds for ``KEY_HOLD_MS``, which the OS key repeat keeps refreshed.
Off a tty (piped output, tests) there is no raw mode and no keys: the
loop draws ``max_frames`` frames and returns.

Each frame is one ``Engine.tick`` (1 spp through the kernels, folded into
the running average) and one copy of the average to the host. The engine
runs on CUDA unless ``device`` names the CPU.

    python -m raytracer_tpu_torch.app.viewer --config demo
"""

from __future__ import annotations

import argparse
import select
import sys
import time

import numpy as np

from raytracer_tpu_torch.app.display import kitty_frame
from raytracer_tpu_torch.app.engine import Engine
from raytracer_tpu_torch.render.options import BACKENDS
from raytracer_tpu_torch.scene import presets


def frame_to_ansi(img: np.ndarray, max_cols: int = 100) -> str:
    """float32 (H, W, 3) framebuffer in GL row order to an ANSI
    half-block string: each character cell shows two stacked pixels (▀,
    foreground the upper, background the lower), downsampled by striding
    to fit ``max_cols``."""
    h, w, _ = img.shape
    stride = max(1, (w + max_cols - 1) // max_cols)
    sub = img[::-1][::stride, ::stride]  # scanline order, downsampled
    if sub.shape[0] % 2:
        sub = sub[:-1]
    u8 = np.clip(sub * 255.0 + 0.5, 0, 255).astype(np.uint8)
    lines = []
    for tr, br in zip(u8[0::2], u8[1::2]):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(tr, br)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class _RawTerminal:
    """Raw-mode stdin for non-blocking single-key reads; a keyless no-op
    when stdin is not a tty."""

    def __enter__(self):
        self.enabled = sys.stdin.isatty()
        if self.enabled:
            import termios
            import tty

            self.fd = sys.stdin.fileno()
            self.saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import termios

            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def read_keys(self):
        if not self.enabled:
            return []
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return keys


#: key → engine key name (held-key semantics through a hold window)
MOVE_KEYS = {"w": "w", "a": "a", "s": "s", "d": "d", "e": "space",
             "c": "shift"}
LOOK_STEP = 15.0  # mouse-movement units a look keypress
#: how long a movement keypress holds its key; the OS key repeat keeps
#: refreshing it while the key is down
KEY_HOLD_MS = 200.0

#: arrow keys arrive as CSI (\x1b[A..D) or SS3 (\x1bOA..OD) sequences,
#: by the terminal's cursor-key mode
_ARROW_SEQS = {
    "[A": "up", "[B": "down", "[C": "right", "[D": "left",
    "OA": "up", "OB": "down", "OC": "right", "OD": "left",
}
_LOOK_TOKENS = {  # token → (dx, dy) mouse move
    "i": (0.0, -LOOK_STEP), "up": (0.0, -LOOK_STEP),
    "k": (0.0, +LOOK_STEP), "down": (0.0, +LOOK_STEP),
    "j": (-LOOK_STEP, 0.0), "left": (-LOOK_STEP, 0.0),
    "l": (+LOOK_STEP, 0.0), "right": (+LOOK_STEP, 0.0),
}

#: the longest plausible SGR mouse report (ESC [ < btn ; col ; row M); a
#: longer unterminated "[<..." run is malformed input, not a split read
_SGR_MAX = 24

#: SGR button codes of the wheel, up and down: fov zoom
MOUSE_WHEEL_UP, MOUSE_WHEEL_DOWN = 64, 65


def parse_keys(chars: list[str], pending: str = ""):
    """Raw characters to key tokens, decoding arrow and SGR mouse escape
    sequences.

    Returns ``(tokens, pending)``: ``pending`` carries an incomplete
    trailing escape sequence into the next drain. A lone ESC stays
    pending until the caller sees a drain with no new input and flushes
    it as the Escape key. Key tokens are strings; a mouse report
    (``CSI < Cb;Cx;Cy M|m``) becomes ``("mouse", Cb, Cx, Cy,
    is_release)``.
    """
    buf = pending + "".join(chars)
    tokens: list = []
    i = 0
    while i < len(buf):
        c = buf[i]
        if c == "\x1b":
            if buf[i + 1:i + 3] == "[<":
                # SGR mouse report: scan for the M/m terminator
                end = i + 3
                while end < len(buf) and buf[end] not in "Mm":
                    end += 1
                if end >= len(buf):
                    if end - i <= _SGR_MAX:
                        return tokens, buf[i:]  # split across reads
                    i = end  # an unterminated flood: dropped
                    continue
                try:
                    cb, cx, cy = (int(p) for p in buf[i + 3:end].split(";"))
                    tokens.append(("mouse", cb, cx, cy, buf[end] == "m"))
                except ValueError:
                    pass  # a malformed report: dropped
                i = end + 1
                continue
            seq = buf[i + 1:i + 3]
            if len(seq) < 2 and (not seq or seq in ("[", "O")):
                return tokens, buf[i:]  # maybe incomplete: held
            if seq in _ARROW_SEQS:
                tokens.append(_ARROW_SEQS[seq])
                i += 3
                continue
            tokens.append("escape")  # ESC followed by a non-arrow key
            i += 1
            continue
        tokens.append(c)
        i += 1
    return tokens, ""


class MouseLook:
    """Left-button drag to look deltas. A terminal reports positions in
    character cells, so a delta is scaled by the cell's size in render
    pixels (``cell_px``; a half-block cell is two pixels tall)."""

    def __init__(self, cell_px: float):
        self.cell_px = max(1.0, float(cell_px))
        self._last: tuple[int, int] | None = None

    def feed(self, cb: int, x: int, y: int, release: bool):
        """One SGR report to a ``(dx, dy)`` look delta, or None."""
        if cb >= 64:  # the wheel: the caller zooms
            return None
        btn, motion = cb & 3, bool(cb & 32)
        if release:
            self._last = None
            return None
        if motion:
            if self._last is None:
                return None
            dx = (x - self._last[0]) * self.cell_px
            dy = (y - self._last[1]) * self.cell_px * 2.0
            self._last = (x, y)
            return (dx, dy) if (dx or dy) else None
        if btn == 0:  # a left press arms the drag
            self._last = (x, y)
        return None


def _handle(engine: Engine, k, mouse: MouseLook, held: dict, now: float,
            frame: int) -> bool:
    """Apply one token to the engine; False for quit."""
    if isinstance(k, tuple):  # ("mouse", cb, x, y, release)
        _, cb, mx, my, rel = k
        if cb == MOUSE_WHEEL_UP and not rel:
            engine.handle_wheel(-1.0)
        elif cb == MOUSE_WHEEL_DOWN and not rel:
            engine.handle_wheel(+1.0)
        else:
            d = mouse.feed(cb, mx, my, rel)
            if d:
                engine.handle_mouse_move(*d)
        return True
    if k == "q":
        return False
    if k == "p":
        engine.set_paused(not engine.app.is_paused)
    elif k == "escape":
        engine.handle_key("escape", True)  # pauses, never resumes
    elif k == "r":
        engine.reset()
    elif k == "x":
        engine.request_save(f"viewer_{frame}.png")
    elif k == "g":
        engine.set_debugging(not engine.app.enable_debugging)
    elif k == "+":
        engine.handle_wheel(-1.0)
    elif k == "-":
        engine.handle_wheel(+1.0)
    elif k in _LOOK_TOKENS:
        engine.handle_mouse_move(*_LOOK_TOKENS[k])
    elif k in MOVE_KEYS:
        held[MOVE_KEYS[k]] = now + KEY_HOLD_MS
    return True


def run_viewer(config: str = "demo", width: int = 320, height: int = 180,
               backend: str = "auto", max_frames: int | None = None,
               target_fps: float = 30.0, cols: int = 100,
               sampler: str = "random", cluster_scan: bool | str = "auto",
               display: str = "ansi", *, device=None) -> int:
    """Run the viewer on preset ``config`` until 'q' or ``max_frames``;
    returns the frames drawn. ``backend`` takes the JAX package's names:
    'auto' and 'pallas' run the kernels, 'jnp' the JAX package's tracer
    (``render/tracer.py``) on the same device."""
    if display not in ("ansi", "kitty"):
        raise ValueError(f"display must be 'ansi' or 'kitty', got "
                         f"{display!r}")
    scene, cam, *_ = presets.get_config(config, width, height)
    engine = Engine(scene, cam, width, height, spp=1, max_depth=8,
                    sampler=sampler, cluster_scan=cluster_scan,
                    device=device, backend=backend)
    engine.set_paused(False)

    held: dict = {}
    pending = ""
    frame = 0
    mouse = MouseLook(width / max(1, cols))
    out = sys.stdout
    with _RawTerminal() as term:
        out.write("\x1b[2J")  # clear
        if term.enabled:
            out.write("\x1b[?1002h\x1b[?1006h")
        try:
            while max_frames is None or frame < max_frames:
                now = time.monotonic() * 1000.0
                raw = term.read_keys()
                tokens, pending = parse_keys(raw, pending)
                if not raw and pending == "\x1b":
                    # a whole frame with nothing after ESC: the Escape key
                    tokens.append("escape")
                    pending = ""
                for k in tokens:
                    if not _handle(engine, k, mouse, held, now, frame):
                        return frame
                for name, until in list(held.items()):
                    engine.handle_key(name, now < until)
                    if now >= until:
                        del held[name]

                engine.tick(now)
                frame += 1

                fps = engine.app.average_fps(now)
                out.write("\x1b[H")  # home
                if display == "kitty":
                    out.write(kitty_frame(engine.framebuffer()))
                else:
                    out.write(frame_to_ansi(engine.framebuffer(), cols))
                status = (f"\n[{config}] frame {frame} "
                          f"acc {int(engine.render_state.render_count)} ")
                if fps is not None:
                    status += f"{fps:5.1f} fps "
                status += ("(wasd/ec move, drag/ijkl/arrows look, wheel/+/- "
                           "zoom, p pause, g debug, x save, q quit)")
                out.write(status + "\x1b[K")
                out.flush()

                dt = time.monotonic() * 1000.0 - now
                sleep_ms = 1000.0 / target_fps - dt
                if sleep_ms > 0:
                    time.sleep(sleep_ms / 1000.0)
        finally:
            if term.enabled:
                out.write("\x1b[?1002l\x1b[?1006l")
            out.write("\x1b[0m\n")
            out.flush()
    return frame


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="interactive terminal path tracer (PyTorch + CUDA)")
    p.add_argument("--config", default="demo",
                   choices=sorted(presets.BASELINE_CONFIGS))
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=180)
    p.add_argument("--backend", default="auto", choices=list(BACKENDS))
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument(
        "--sampler", default="random", choices=("random", "stratified"),
        help="camera-sample sequencer (stratified: per-pixel "
        "low-discrepancy accumulation across frames)")
    p.add_argument(
        "--cluster-scan", dest="cluster_scan", action="store_const",
        const=True, default="auto",
        help="force the cluster walk on (the fixed scene builds its "
        "partition once). Default auto: on for scenes >= 64 slots.")
    p.add_argument(
        "--no-cluster-scan", dest="cluster_scan", action="store_const",
        const=False, help="force the flat scan")
    p.add_argument(
        "--display", default="ansi", choices=("ansi", "kitty"),
        help="frame encoding: ansi half-blocks (any terminal, downsampled "
        "to --cols) or the kitty graphics protocol (full resolution)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                   "PyTorch versions)")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    run_viewer(a.config, a.width, a.height, a.backend, a.max_frames,
               cols=a.cols, sampler=a.sampler, cluster_scan=a.cluster_scan,
               display=a.display, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
