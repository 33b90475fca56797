"""Full-resolution terminal frames through the kitty graphics protocol
(counterpart of ``raytracer_tpu/app/display.py``, over the port's numpy
PNG encoder; the JAX package's optional C++ encoder gives the same bytes).

Protocol framing (kitty graphics spec):

* every command is ``ESC _ G <k=v,...> ; <base64 payload> ESC \\``;
* a payload over ``CHUNK`` base64 bytes is split across commands carrying
  ``m=1`` (more coming), the last one ``m=0``; only the first carries the
  full control keys;
* ``a=T`` transmits and displays at the cursor, ``f=100`` is PNG,
  ``i=<id>`` names the image, ``q=2`` suppresses the terminal's replies;
* each frame starts with ``a=d,d=i,i=<id>``, which deletes the previous
  placement, so a session is one image updated in place.
"""

from __future__ import annotations

import base64

import numpy as np

from raytracer_tpu_torch.app.io import encode_png

#: max base64 bytes per escape command (the kitty spec's chunk limit)
CHUNK = 4096


def encode_frame_png(img: np.ndarray) -> bytes:
    """float32 (H, W, 3) framebuffer in GL row order to PNG bytes, row 0
    at the top."""
    return encode_png(img, flip_vertical=True)


def kitty_frame(img: np.ndarray, image_id: int = 1) -> str:
    """One full-resolution frame as a kitty-graphics command string: the
    delete of the previous placement, then the chunked
    transmit-and-display commands. The caller positions the cursor."""
    payload = base64.standard_b64encode(encode_frame_png(img)).decode("ascii")
    cmds = [f"\x1b_Ga=d,d=i,i={image_id},q=2\x1b\\"]
    chunks = [payload[i:i + CHUNK]
              for i in range(0, len(payload), CHUNK)] or [""]
    for n, chunk in enumerate(chunks):
        more = 1 if n + 1 < len(chunks) else 0
        if n == 0:
            keys = f"a=T,f=100,i={image_id},q=2,m={more}"
        else:
            keys = f"m={more}"
        cmds.append(f"\x1b_G{keys};{chunk}\x1b\\")
    return "".join(cmds)


def parse_kitty_commands(s: str) -> list[tuple[dict, str]]:
    """The inverse of :func:`kitty_frame`, for checks: the commands of
    ``s`` as ``(keys, base64 chunk)`` pairs."""
    out = []
    for part in s.split("\x1b\\"):
        if not part:
            continue
        if not part.startswith("\x1b_G"):
            raise ValueError(f"not a kitty command: {part[:20]!r}")
        keys, _, chunk = part[3:].partition(";")
        out.append((dict(k.split("=") for k in keys.split(",") if k), chunk))
    return out
