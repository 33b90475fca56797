"""What does it cost per slot to scan spheres held in shared memory, and
does the size of the unrolled block matter? P4 on the card: the
counterpart of ``scripts/bench_scan_layout.py``.

    python -m raytracer_tpu_torch.scripts.bench_scan_layout [--device cpu]
        [--iters N]

Rays (rows of 128 lanes, every 8 rows the script's 8) with fixed
directions scan ``S`` slots of
``RandomState(0)`` spheres ``ITERS`` times, the near root's candidate and
a running minimum per slot, and fold the winner back into their origins
(``csrc/probe_scan.cu`` states the arithmetic). The blocks are the
script's: 512 ("full", one chain over every slot), 64 ("s8"), 32 ("s4")
and 8 ("s1"), which on this card are unrolled inner loops (the 512-slot
block one running minimum, unrolled 64 slots at a time). Every block gives
the same values. Each block runs at the TPU's 8 rows, warm then best of 3,
and prints the script's line (ns per strip-iteration: a trip over 8
slots); then at ``FILL_ROWS`` and ``FILL_ITERS``, which fill the card.

:func:`scan_probe` launches ``csrc/probe_scan.cu`` on CUDA tensors and
counts its launches in ``scan_probe.launches`` (by block in
``scan_probe.launches_by_variant``); on CPU tensors it runs
:func:`scan_probe_plain`, the same arithmetic in the same order.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from raytracer_tpu_torch.render.api import resolve_device
from raytracer_tpu_torch.utils import cuda_build
from raytracer_tpu_torch.utils.profiling import best_seconds, device_name

S = 512          # sphere slots (64 strips of 8)
R_SUB = 8        # ray rows of the TPU's shape
#: trips per launch: half the script's 20000, which keeps a launch at the
#: TPU's 8 rows under 0.5 s on an H100 (the time per trip is reported)
ITERS = 10000
MIN_T = 0.001
LANES = 128
#: block -> the script's label
BLOCKS = {512: "full", 64: "s8", 32: "s4", 8: "s1"}
#: 1056 rows of 128 rays (132 copies of the TPU's 8 rows): eight
#: 128-thread blocks on each of 132 SMs; a fiftieth of the trips keeps a
#: launch of every block under 0.5 s
FILL_ROWS, FILL_ITERS = 1056, 400
#: slots a block's shared memory holds by default (48 KiB of float4)
MAX_SLOTS = 3072
#: operations per ray and trip: the two origin dot products; per slot the
#: two dot products (5 each), nb, c_coef (3), disc (3), the root's compare,
#: abs, root and select, q, the candidate's compare and select, the
#: minimum; the origin's step (a product, three sums) and the output's sum
OPS_TRIP, OPS_SLOT = 10 + 5, 25

F = lambda v: float(np.float32(v))  # noqa: E731  the kernel's constants


def scan_table(slots: int = S) -> torch.Tensor:
    """The script's spheres: ``RandomState(0).uniform(-5, 5, (S, 4))``,
    column 3 (k1) taken as abs, float32."""
    sph = np.random.RandomState(0).uniform(-5, 5, (slots, 4)).astype(
        np.float32)
    sph[:, 3] = np.abs(sph[:, 3])
    return torch.from_numpy(sph)


def variant_name(block: int) -> str:
    return f"probe_scan_{block}"


def probe_ops(slots: int, rows: int, iters: int) -> int:
    """Operations of one launch."""
    return (OPS_TRIP + OPS_SLOT * slots) * iters * rows * LANES


def _check(sph: torch.Tensor, block: int, rows: int, iters: int):
    if block not in BLOCKS:
        raise ValueError(f"block must be one of {tuple(BLOCKS)}, got {block}")
    if (sph.dim() != 2 or sph.shape[1] != 4 or sph.dtype != torch.float32
            or not sph.is_contiguous()):
        raise ValueError("the slot table must be a contiguous (S, 4) float32 "
                         "tensor")
    slots = sph.shape[0]
    if slots < block or slots % block or slots > MAX_SLOTS:
        raise ValueError(f"{slots} slots: need a multiple of the block "
                         f"{block}, at most {MAX_SLOTS}")
    if rows < 1 or not 0 <= iters < 2**31:
        raise ValueError(f"bad rows {rows} or iters {iters}")


def scan_probe(sph: torch.Tensor, block: int, rows: int,
               iters: int) -> torch.Tensor:
    """(rows, 128) sums of every trip's least candidate, scanned in blocks
    of ``block`` slots."""
    _check(sph, block, rows, iters)
    if sph.device.type == "cpu":
        return scan_probe_plain(sph, block, rows, iters)
    if sph.device.type != "cuda":
        raise ValueError(f"no scan probe for device {sph.device}")
    return _launch(sph, block, rows, iters)


scan_probe.launches = 0
scan_probe.launches_by_variant = {}


def reset_launch_counts():
    scan_probe.launches = 0
    scan_probe.launches_by_variant = {}


def scan_probe_plain(sph: torch.Tensor, block: int, rows: int,
                     iters: int) -> torch.Tensor:
    """The kernel's arithmetic as (slots, rays) tensor code: each trip's
    candidates, a minimum within each block of slots, then over the
    blocks."""
    _check(sph, block, rows, iters)
    dev = sph.device
    ray = torch.arange(rows * LANES, device=dev)
    ox = (ray % LANES).to(torch.float32) * F(0.01)
    oy = torch.ones(rows * LANES, dtype=torch.float32, device=dev)
    oz = ((ray // LANES) % R_SUB).to(torch.float32) * F(0.1)
    dx = ox * F(0.1) + F(0.3)
    dy = oy * F(-0.05)
    dz = oz * F(0.07) + F(0.1)
    a = dx * dx + dy * dy + dz * dz
    min_t_a = F(MIN_T) * a
    cx, cy, cz, k1 = (sph[:, j:j + 1] for j in range(4))
    slots = sph.shape[0]
    acc = torch.zeros_like(ox)
    for _ in range(iters):
        odd = ox * dx + oy * dy + oz * dz
        ooo = ox * ox + oy * oy + oz * oz
        c_dot_d = cx * dx + cy * dy + cz * dz
        c_dot_o = cx * ox + cy * oy + cz * oz
        nb = c_dot_d - odd
        c_coef = ooo - 2.0 * c_dot_o + k1
        disc = nb * nb - a * c_coef
        sq = torch.where(disc >= 0.0, torch.sqrt(torch.abs(disc)), F(-3e38))
        q = nb - sq
        cand = torch.where(q >= min_t_a, q, F(3e38))
        bq = cand.view(slots // block, block, -1).amin(1).amin(0)
        step = bq * F(1e-12)
        ox, oy, oz = ox + step, oy + step, oz - step
        acc = acc + bq
    return acc.view(rows, LANES)


def _lib():
    fn = cuda_build.load("probe_scan").probe_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(sph, block, rows, iters):
    cuda_build.check_cuda(sph)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=sph.device)
    fn = _lib()
    with torch.cuda.device(sph.device):
        stream = torch.cuda.current_stream(sph.device).cuda_stream
        err = fn(sph.data_ptr(), out.data_ptr(), block, sph.shape[0],
                 rows * LANES, iters, stream)
    cuda_build.check_launch("probe_scan", err)
    scan_probe.launches += 1
    name = variant_name(block)
    by = scan_probe.launches_by_variant
    by[name] = by.get(name, 0) + 1
    return out


def run(block: int, label: str, sph: torch.Tensor, rows: int, iters: int,
        device) -> dict:
    """One block: warm (one trip), best of 3; prints the script's line.
    Returns the output (on the CPU), seconds, ns per strip-iteration and
    slot tests a second."""
    best, out = best_seconds(lambda: scan_probe(sph, block, rows, iters),
                             device,
                             warm=lambda: scan_probe(sph, block, rows, 1))
    slots = sph.shape[0]
    per_strip_iter = best / (max(iters, 1) * (slots // 8))
    tests = slots * rows * LANES * iters / best
    print(f"{label:5s} block={block:3d} ({rows},{LANES}) x{iters}: "
          f"{best * 1e3:7.2f} ms ({per_strip_iter * 1e9:6.1f} "
          f"ns/strip-iter, {tests / 1e9:.2f} G slot tests/s)")
    return {"out": out.cpu(), "seconds": best,
            "ns_per_strip_iter": per_strip_iter * 1e9, "slot_tests": tests}


def main(device=None, iters: int = ITERS, slots: int = S,
         fill: bool = True):
    """Every block at the TPU's 8 rows (blocks larger than ``slots``
    scan it whole, as the script's ``full``), then (with ``fill``) at
    ``FILL_ROWS`` and ``FILL_ITERS``; returns the device's name and, per
    block, ``tpu`` (and ``fill``) :func:`run` results with the speed-up
    over ``full``."""
    device = resolve_device(device)
    sph = scan_table(slots).to(device)
    plan = [(min(b, slots), label) for b, label in BLOCKS.items()]
    got = {}
    for block, label in plan:
        got[label] = {"block": block,
                      "tpu": run(block, label, sph, R_SUB, iters, device)}
    if fill:
        for block, label in plan:
            got[label]["fill"] = run(block, label, sph, FILL_ROWS,
                                     FILL_ITERS, device)
    for shape in ("tpu", "fill") if fill else ("tpu",):
        base = got["full"][shape]["seconds"]
        for label, r in got.items():
            print(f"{label} ({shape}): {base / r[shape]['seconds']:.2f}x vs "
                  "full")
    return {"device": device_name(device), "iters": iters, "slots": slots,
            "blocks": got}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu for the plain version")
    p.add_argument("--iters", type=int, default=ITERS)
    return p.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
