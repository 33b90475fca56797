"""Does the card run bf16 elementwise products and sums faster than
float32, and what rate does an unfused float32 chain reach? P3 and P2 on
the card: the counterpart of ``scripts/bench_bf16_vpu.py`` (and of
``scripts/roofline.py`` ``vpu_ceiling``, the same float32 function).

    python -m raytracer_tpu_torch.scripts.bench_bf16_chain [--device cpu]
        [--iters N]

Eight independent chains per element, each ``ITERS`` times ``OPS`` steps
of v = v·x[c] + x[(c + k + 1) mod 8], every product and sum rounded to
the type on its own; the chains' sum is the output. Every element of the
input is 1.0000001: in float32 the chains grow to about 3.3e5, in bf16 x
rounds to 1.0 and every chain stops at 256, where 256 + 1 rounds back.
Each row count runs warm, then best of 3, and prints the script's line;
the TPU's 16 rows are 2048 elements (latency), ``FILL_ROWS`` put eight
blocks of 256 threads on each of an H100's 132 SMs (the issue rate).

:func:`chain` launches ``csrc/probe_chain.cu`` on CUDA tensors and counts
its launches in ``chain.launches`` (by instantiation in
``chain.launches_by_variant``); on CPU tensors it runs
:func:`chain_plain`, the same arithmetic in the same order.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from raytracer_tpu_torch.render.api import resolve_device
from raytracer_tpu_torch.utils import cuda_build
from raytracer_tpu_torch.utils.profiling import best_seconds, device_name

ITERS = 20000
CHAINS = 8   # independent streams
OPS = 16     # product + sum pairs per stream per iteration
X_VALUE = 1.0000001
LANES = 128
TPU_ROWS = 16
#: 132 SMs x 2048 threads / 128 lanes
FILL_ROWS = 2112
VARIANTS = {torch.float32: "probe_chain_f32",
            torch.bfloat16: "probe_chain_bf16"}


def chain_input(rows: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The script's input: (CHAINS, rows, 128) of 1.0000001 in ``dtype``."""
    return torch.full((CHAINS, rows, LANES), X_VALUE, dtype=dtype,
                      device=device)


def elem_ops(rows: int, iters: int) -> int:
    """Element operations as the script counts them (the chains' trips)."""
    return iters * CHAINS * OPS * 2 * rows * LANES


def chain_ops(rows: int, iters: int) -> int:
    """Every operation of one launch: the start, the trips, the sum."""
    return elem_ops(rows, iters) + (2 * CHAINS - 1) * rows * LANES


def _check(x: torch.Tensor, iters: int):
    if (x.dim() != 3 or x.shape[0] != CHAINS or x.shape[2] != LANES
            or x.shape[1] < 1):
        raise ValueError(f"x must be ({CHAINS}, rows, {LANES}), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in VARIANTS:
        raise ValueError(f"no chain for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 0 <= iters < 2**31:
        raise ValueError(f"iters must be in [0, 2^31), got {iters}")


def chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """(rows, 128) sums of the eight chains of ``x`` after ``iters``
    trips, in ``x``'s type."""
    _check(x, iters)
    if x.device.type == "cpu":
        return chain_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"no chain for device {x.device}")
    return _launch(x, iters)


chain.launches = 0
chain.launches_by_variant = {}


def reset_launch_counts():
    chain.launches = 0
    chain.launches_by_variant = {}


def chain_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The kernel's arithmetic as tensor code, all chains at once: chain c
    takes x[c] and x[(c + k + 1) mod 8] at step k, elementwise, so a
    step of every chain is one product and one sum. Each rounds to the
    type (a bf16 sum is rounded from float32, which is exact for this
    input)."""
    _check(x, iters)
    c = torch.arange(CHAINS, device=x.device)
    acc = x + c.to(x.dtype).view(CHAINS, 1, 1)
    addends = [x[(c + k + 1) % CHAINS] for k in range(OPS)]
    for _ in range(iters):
        for k in range(OPS):
            acc = acc * x + addends[k]
    out = acc[0]
    for j in range(1, CHAINS):
        out = out + acc[j]
    return out


def _lib():
    fn = cuda_build.load("probe_chain").probe_chain_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, iters: int) -> torch.Tensor:
    cuda_build.check_cuda(x)
    rows = x.shape[1]
    out = torch.empty((rows, LANES), dtype=x.dtype, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
                 rows * LANES, iters, stream)
    cuda_build.check_launch("probe_chain", err)
    chain.launches += 1
    name = VARIANTS[x.dtype]
    chain.launches_by_variant[name] = chain.launches_by_variant.get(name,
                                                                    0) + 1
    return out


def run(dtype: torch.dtype, rows: int, iters: int, device) -> dict:
    """One row count of one type: warm, best of 3; prints the script's
    line. Returns the output (on the CPU), seconds and element rate."""
    x = chain_input(rows, dtype, device)
    best, out = best_seconds(lambda: chain(x, iters), device)
    rate = elem_ops(rows, iters) / best
    name = str(dtype).removeprefix("torch.")
    print(f"{name} ({rows},{LANES}): {best * 1e3:.2f} ms, "
          f"{rate / 1e12:.3f} Telem-ops/s")
    return {"out": out.cpu(), "seconds": best, "rate": rate}


def main(device=None, iters: int = ITERS, rows=(TPU_ROWS, FILL_ROWS)):
    """Both types at each row count; returns the device's name and, per
    row count, each type's :func:`run` and the bf16/float32 ratio."""
    device = resolve_device(device)
    got = {}
    for r in rows:
        f32 = run(torch.float32, r, iters, device)
        bf16 = run(torch.bfloat16, r, iters, device)
        ratio = bf16["rate"] / f32["rate"]
        print(f"bf16/f32 element-throughput ratio at ({r},{LANES}): "
              f"{ratio:.2f}")
        got[r] = {"float32": f32, "bfloat16": bf16, "ratio": ratio}
    return {"device": device_name(device), "iters": iters, "rows": got}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu for the plain version")
    p.add_argument("--iters", type=int, default=ITERS)
    return p.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
