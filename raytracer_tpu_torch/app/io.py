"""Image export: float framebuffer to PNG bytes or file (counterpart of
``raytracer_tpu/app/io.py``'s pure-Python path, in numpy and zlib; the
JAX package's native encoder gives the same bytes).

The framebuffer is gamma-encoded float32 (H, W, 3) in GL row order (row 0
at the bottom); export clamps to [0, 1], quantises to 8 bits and flips to
scanline order.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def tonemap_u8(image, flip_vertical: bool = True) -> np.ndarray:
    """Clamp to [0, 1], round to uint8 (x·255 + 0.5, truncated), and flip
    GL row order to scanline order."""
    arr = np.clip(np.ascontiguousarray(image, dtype=np.float32), 0.0, 1.0)
    out = (arr * 255.0 + 0.5).astype(np.uint8)
    if flip_vertical:
        out = out[::-1]
    return np.ascontiguousarray(out)


def _chunk(typ: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + typ + payload
            + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))


def encode_rgb8(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 rows, top first, to an 8-bit RGB PNG: filter 0 on
    every row, zlib level 6."""
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def encode_png(image, flip_vertical: bool = True) -> bytes:
    """float32 (H, W, 3) to PNG bytes."""
    return encode_rgb8(tonemap_u8(image, flip_vertical))


def save_png(path, image, flip_vertical: bool = True) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, flip_vertical))


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB PNG (filters 0-4), for round trips
    and checks."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, w, h, idat = 8, None, None, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        typ = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if typ == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or colour != 2:
                raise ValueError("only 8-bit RGB PNGs are supported")
        elif typ == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        filt = raw[p]
        row = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(
            np.int32)
        p += 1 + stride
        if filt == 0:
            cur = row
        elif filt == 2:  # up
            cur = (row + prev) % 256
        else:  # sub, average and Paeth run left to right
            cur = row.copy()
            for i in range(stride):
                a = cur[i - 3] if i >= 3 else 0
                b = prev[i]
                if filt == 1:
                    cur[i] = (cur[i] + a) % 256
                elif filt == 3:
                    cur[i] = (cur[i] + (a + b) // 2) % 256
                elif filt == 4:
                    c = prev[i - 3] if i >= 3 else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) % 256
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, 3)
