"""What does a per-lane gather from a table in shared memory cost, set
against reconstructing the value by a one-hot scan? P1 and P1b on the
card: the counterpart of ``scripts/probe_mosaic_gather.py``.

    python -m raytracer_tpu_torch.scripts.probe_gather [--device cpu]
        [--iters N]

Each case sums ``ITERS`` gathers of a table of ``RandomState(0)``
uniforms, the index recomputed from the trip counter i every trip:

- ``take_along_axis`` (P1, table (256, 128), 8 output rows) and the
  same-shape axis-0 forms (P1b): out[r, l] = Σ_i tbl[(l + i) mod S, l];
- the same-shape axis-1 forms (P1b): out[r, l] = Σ_i tbl[r, (r + i) mod W];
- ``onehot_matmul`` (P1): out[r, l] = Σ_i Σ_s tbl[s, 0]·[s = (l + i) mod
  S], the TPU kernel's one-hot product over column 0 only, so its output
  differs from ``take_along_axis`` wherever l ≠ 0. On the card it runs
  on the tensor cores (bf16 MMAs over the exact three-piece split of
  column 0, :func:`bf16_split`; :func:`mma_account` counts its work).

Each case runs at the TPU's shape, warm then best of 3, and prints the
script's line with ns per gather of that shape; then at a card-filling
count of replicas of the same output (``FILL_ELEMENTS``), beside
``torch.gather`` doing the same work (:func:`library_gather`: one call a
trip over all the replicas, summed trip by trip), in ns per gather of
the shape.

:func:`gather_probe` launches ``csrc/probe_gather.cu`` on CUDA tensors
and counts its launches in ``gather_probe.launches`` (by mode in
``gather_probe.launches_by_variant``); on CPU tensors it runs
:func:`gather_probe_plain`, the same sums in the same order.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from raytracer_tpu_torch.render.api import resolve_device
from raytracer_tpu_torch.utils import cuda_build
from raytracer_tpu_torch.utils.profiling import best_seconds, device_name

S = 256
ITERS = 5000
MODES = ("axis0", "axis1", "onehot")
#: (label, mode, table shape, output rows) of the script's six runs
CASES = (
    ("take_along_axis", "axis0", (S, 128), 8),
    ("onehot_matmul", "onehot", (S, 128), 8),
    ("dynamic_gather(8, 128) axis=1", "axis1", (8, 128), 8),
    ("dynamic_gather(8, 128) axis=0", "axis0", (8, 128), 8),
    ("dynamic_gather(8, 512) axis=1", "axis1", (8, 512), 8),
    ("dynamic_gather(32, 128) axis=0", "axis0", (32, 128), 32),
)
#: the opt-in shared memory of an H100 block (227 KiB); the launcher also
#: checks the device's own limit
MAX_SMEM_BYTES = 232448
#: output elements of a card-filling launch: about 10-40 ms at ITERS
FILL_ELEMENTS = {"axis0": 1 << 24, "axis1": 1 << 24, "onehot": 1 << 18}
MAX_REPS = 65535
#: operations per output element and trip: the index sum, its mask and
#: the accumulation (a gather is a load, no operation); the one-hot scan
#: adds a compare, a select, a product and a sum per table row
OPS_TRIP, OPS_ONEHOT_ROW = 3, 4
#: the one-hot product on the tensor cores (``csrc/probe_gather.cu``
#: ``onehot_mma_kernel``, tables of at most ``MMA_MAX_ROWS`` rows): an
#: m16n8k16's outputs, table rows and flops; a thread's CUDA-core
#: operations a trip: per fragment row (two) the index and its mask, its
#: k-tile and the compare with the warp's first, the two column offsets,
#: and two compares and two shifted or zero words (``OPS_MMA_ROW``); once
#: (``OPS_MMA_TRIP``) the warp's first k-tile (a sum, a mask, a shift),
#: the switch on it, eight selects into the first and the next k-tile's
#: words, the sum of the two accumulators (four), and the pieces' two
#: sums, the accumulation and a shuffle for each of the two rows (eight)
MMA_M, MMA_K, MMA_FLOP = 16, 16, 2 * 16 * 8 * 16
MMA_MAX_ROWS = 256
OPS_MMA_ROW, OPS_MMA_TRIP = 11, 24


def gather_table(shape) -> torch.Tensor:
    """The script's table: ``RandomState(0).uniform(size=shape)``, float32."""
    return torch.from_numpy(
        np.random.RandomState(0).uniform(size=shape).astype(np.float32))


def variant_name(mode: str) -> str:
    return f"probe_gather_{mode}"


def probe_ops(mode: str, table_rows: int, rows: int, width: int,
              iters: int, reps: int = 1) -> int:
    """Operations of one launch."""
    per_trip = OPS_TRIP + (OPS_ONEHOT_ROW * table_rows
                           if mode == "onehot" else 0)
    return per_trip * iters * rows * width * reps


def mma_account(table_rows: int, rows: int, width: int, iters: int,
                reps: int = 1) -> dict:
    """What the one-hot product of one launch issues: its m16n8k16 MMAs
    (every k-tile of every trip, for every 16 outputs), their flops, and
    its CUDA-core operations (``OPS_MMA_*`` a thread and trip, 32 threads
    for every 16 outputs)."""
    tiles = max(1, table_rows // MMA_K)
    warps = reps * -(-rows * width // MMA_M)
    mmas = warps * iters * tiles
    per_trip = 2 * OPS_MMA_ROW + OPS_MMA_TRIP
    return {"mmas": mmas, "flop": mmas * MMA_FLOP,
            "cuda_core_ops": warps * 32 * iters * per_trip}


def bf16_split(x: torch.Tensor) -> tuple:
    """The kernel's exact split of float32 ``x`` into three bf16 pieces,
    as float32: ``hi`` its top 16 bits, ``mid`` those of ``x - hi``,
    ``lo = (x - hi) - mid``; ``(hi + mid) + lo`` is ``x`` bit for bit for
    every normal ``x`` of magnitude at least 2^-103 (and zero), where
    ``lo`` has at most 8 significant bits and so is a bf16."""
    def top16(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)

    hi = top16(x)
    r = x - hi
    mid = top16(r)
    return hi, mid, r - mid


def _check(tbl: torch.Tensor, mode: str, rows: int, iters: int, reps: int):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if tbl.dim() != 2 or tbl.dtype != torch.float32 or not tbl.is_contiguous():
        raise ValueError("the table must be a contiguous 2-D float32 tensor")
    s, w = tbl.shape
    if s < 1 or w < 1 or s & (s - 1) or w & (w - 1):
        raise ValueError(f"the table's sides must be powers of two, got "
                         f"{tuple(tbl.shape)}")
    if 4 * s * w > MAX_SMEM_BYTES:
        raise ValueError(
            f"a table of {tuple(tbl.shape)} needs {4 * s * w} bytes of "
            f"shared memory per block, over the {MAX_SMEM_BYTES} a block "
            "can hold")
    if not 1 <= rows or (mode == "axis1" and rows > s):
        raise ValueError(f"bad output rows {rows} for mode {mode} and a "
                         f"table of {s} rows")
    if not 1 <= reps <= MAX_REPS:
        raise ValueError(f"reps must be in [1, {MAX_REPS}], got {reps}")
    if not 0 <= iters <= 2**31 - 1 - max(s, w):
        raise ValueError(f"bad iters {iters}")


def gather_probe(tbl: torch.Tensor, mode: str, rows: int, iters: int,
                 reps: int = 1) -> torch.Tensor:
    """(reps, rows, W) sums of ``iters`` gathers of ``mode`` from ``tbl``
    (S, W); every replica is the same."""
    _check(tbl, mode, rows, iters, reps)
    if tbl.device.type == "cpu":
        return gather_probe_plain(tbl, mode, rows, iters, reps)
    if tbl.device.type != "cuda":
        raise ValueError(f"no gather probe for device {tbl.device}")
    return _launch(tbl, mode, rows, iters, reps)


gather_probe.launches = 0
gather_probe.launches_by_variant = {}


def reset_launch_counts():
    gather_probe.launches = 0
    gather_probe.launches_by_variant = {}


def gather_probe_plain(tbl: torch.Tensor, mode: str, rows: int, iters: int,
                       reps: int = 1) -> torch.Tensor:
    """The kernel's sums as tensor code. Axis 0 and the one-hot scan give
    every row the same values, axis 1 every lane of a row: the distinct
    values are summed once, trip by trip, and broadcast (a view)."""
    _check(tbl, mode, rows, iters, reps)
    s, w = tbl.shape
    dev = tbl.device
    if mode == "axis1":
        r = torch.arange(rows, device=dev)
        acc = torch.zeros(rows, dtype=torch.float32, device=dev)
        for i in range(iters):
            acc = acc + tbl[r, (r + i) % w]
        block = acc[:, None].expand(rows, w)
    else:
        lane = torch.arange(w, device=dev)
        slot = torch.arange(s, device=dev)[:, None]
        col0 = tbl[:, 0:1]
        acc = torch.zeros(w, dtype=torch.float32, device=dev)
        for i in range(iters):
            idx = (lane + i) % s
            if mode == "axis0":
                g = tbl[idx, lane]
            else:
                g = (col0 * (slot == idx).to(torch.float32)).sum(0)
            acc = acc + g
        block = acc[None, :].expand(rows, w)
    return block.expand(reps, rows, w)


def _lib():
    fn = cuda_build.load("probe_gather").probe_gather_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(tbl, mode, rows, iters, reps):
    cuda_build.check_cuda(tbl)
    s, w = tbl.shape
    out = torch.empty((reps, rows, w), dtype=torch.float32, device=tbl.device)
    fn = _lib()
    with torch.cuda.device(tbl.device):
        stream = torch.cuda.current_stream(tbl.device).cuda_stream
        err = fn(tbl.data_ptr(), out.data_ptr(), MODES.index(mode), s, w,
                 rows, reps, iters, stream)
    cuda_build.check_launch("probe_gather", err)
    gather_probe.launches += 1
    name = variant_name(mode)
    by = gather_probe.launches_by_variant
    by[name] = by.get(name, 0) + 1
    return out


def library_inputs(tbl: torch.Tensor, mode: str, rows: int, reps: int):
    """``torch.gather``'s operands for the kernel's gathers, all ``reps``
    replicas in one call a trip: ``(src, dim, index)`` with ``src`` the
    table seen as (reps, S, W) (column 0 broadcast for the one-hot mode)
    and ``index(i)`` trip i's (reps, rows, W) index, every replica's the
    same (broadcast views: nothing is copied)."""
    _check(tbl, mode, rows, 0, reps)
    s, w = tbl.shape
    dev = tbl.device
    if mode == "axis1":
        src, dim, period = tbl, 2, w
        base = torch.arange(rows, device=dev)[:, None].expand(rows, w)
    else:
        src = tbl if mode == "axis0" else tbl[:, :1].expand(s, w)
        dim, period = 1, s
        base = torch.arange(w, device=dev)[None, :].expand(rows, w)
    # the index repeats after one period of trips
    table = [((base + i) % period)[None].expand(reps, rows, w)
             for i in range(period)]
    return src[None].expand(reps, s, w), dim, lambda i: table[i % period]


def library_sums(tbl: torch.Tensor, mode: str, rows: int, iters: int,
                 reps: int = 1) -> torch.Tensor:
    """The kernel's work through ``torch.gather``: ``iters`` trips, each
    one call over the ``reps`` replicas, summed trip by trip; equal to
    :func:`gather_probe_plain` (the library gathers what the kernel
    gathers)."""
    src, dim, index = library_inputs(tbl, mode, rows, reps)
    acc = torch.zeros((reps, rows, tbl.shape[1]), dtype=torch.float32,
                      device=tbl.device)
    for i in range(iters):
        acc += torch.gather(src, dim, index(i))
    return acc


def library_gather(tbl: torch.Tensor, mode: str, rows: int, iters: int,
                   reps: int, device) -> tuple:
    """``(seconds, sums)``: the best of 3 runs of :func:`library_sums` on
    ``device`` (the library doing the kernel's whole work) and its first
    replica's sums, on the CPU."""
    tbl = tbl.to(device)
    best, out = best_seconds(
        lambda: library_sums(tbl, mode, rows, iters, reps), device)
    return best, out[0].cpu()


def fill_reps(mode: str, rows: int, width: int) -> int:
    """Replicas of a card-filling launch."""
    return max(1, min(MAX_REPS, FILL_ELEMENTS[mode] // (rows * width)))


def run(label: str, mode: str, shape, rows: int, iters: int, device,
        reps: int = 1) -> dict:
    """One case: warm, best of 3; prints the script's line. Returns the
    first replica's output (on the CPU), seconds, ns per gather of the
    (rows, W) shape and per element."""
    tbl = gather_table(shape).to(device)
    best, out = best_seconds(
        lambda: gather_probe(tbl, mode, rows, iters, reps), device)
    per_gather = best / max(iters, 1) / reps
    elements = rows * shape[1]
    tag = f" x{reps}" if reps > 1 else ""
    print(f"{label}{tag}: {best * 1e3:.2f} ms total, {per_gather * 1e9:.1f}"
          f" ns per ({rows},{shape[1]})-gather, "
          f"{per_gather / elements * 1e12:.2f} ps per element")
    return {"out": out[0].cpu(), "seconds": best, "reps": reps,
            "ns_per_gather": per_gather * 1e9,
            "ps_per_element": per_gather / elements * 1e12}


def main(device=None, iters: int = ITERS, fill: bool = True):
    """The script's six cases at its shapes, then (with ``fill``) at a
    card-filling count of replicas and through ``torch.gather``; returns
    the device's name and, per case label, ``tpu`` (and ``fill``)
    :func:`run` results (and ``library``: :func:`library_gather`'s
    sums, seconds and ns per gather)."""
    device = resolve_device(device)
    got = {}
    for label, mode, shape, rows in CASES:
        got[label] = {"mode": mode, "shape": shape, "rows": rows,
                      "tpu": run(label, mode, shape, rows, iters, device)}
    if fill:
        for label, mode, shape, rows in CASES:
            reps = fill_reps(mode, rows, shape[1])
            got[label]["fill"] = run(label, mode, shape, rows, iters, device,
                                     reps)
            seconds, out = library_gather(gather_table(shape), mode, rows,
                                          iters, reps, device)
            per_gather = seconds / max(iters, 1) / reps
            got[label]["library"] = {"out": out, "seconds": seconds,
                                     "ns_per_gather": per_gather * 1e9}
            print(f"{label} x{reps}: torch.gather {seconds * 1e3:.2f} ms "
                  f"total, {per_gather * 1e9:.3f} ns per ({rows},"
                  f"{shape[1]})-gather")
    return {"device": device_name(device), "iters": iters, "cases": got}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu for the plain version")
    p.add_argument("--iters", type=int, default=ITERS)
    return p.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
