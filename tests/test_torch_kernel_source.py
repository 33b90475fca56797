"""Checks of the CUDA kernel's source and build flags that hold without a
card: the constants the kernel bakes in are the float32 roundings of the
JAX package's Python doubles, the cube root stays exp(log(u)/3), and
nothing fuses or approximates an operation that the plain PyTorch version
(and the TPU kernel) rounds separately. The kernel itself runs only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import re

import numpy as np
import pytest

from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import options, tables
from raytracer_tpu_torch.utils import cuda_build

SOURCE = (cuda_build.CSRC_DIR / "cluster_walk.cu").read_text()

#: kernel constant → the Python double it must round from
EXPECTED = {
    "kFillQ": 3e38,
    "kNegBig": -3e38,
    "kFresh": -1e38,
    "kFillFloor": cw.FILL_FLOOR,
    "kTwoPi": pk.TWO_PI,
    "kInv24": pk.INV_24,
    "kOneThird": 1.0 / 3.0,
    "kMinT": options.MIN_T,
    "kUEps": 1e-12,
    "kNEps": 1e-20,
    "kQCut": 1e20,
    "kSkyG": 0.3,
    "kRRMin": 0.05,
    "kNearZero": 1e-8,
}


def kernel_constants() -> dict:
    found = re.findall(
        r"constexpr float (k\w+) = (-?0x[0-9a-fA-F.]+p[-+]?\d+)f;", SOURCE
    )
    return {name: float.fromhex(lit) for name, lit in found}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_constant_is_float32_rounding(name):
    got = kernel_constants()[name]
    want = float(np.float32(EXPECTED[name]))
    assert got == want, (name, got.hex(), want.hex())


def test_every_float_constant_is_checked():
    assert set(kernel_constants()) == set(EXPECTED)


def test_fill_floor_clears_the_key_bits():
    """FILL_FLOOR is 3e38 with the 7 low mantissa bits (the cluster index
    of a packed key) cleared, as the TPU kernel forms it."""
    bits = np.float32(3e38).view(np.int32) & ~np.int32(127)
    assert cw.FILL_FLOOR == float(bits.view(np.float32))
    assert np.float32(cw.FILL_FLOOR).view(np.int32) & 127 == 0


@pytest.mark.parametrize("banned", [
    "cbrtf", "fmaf", "__fmaf", "__expf", "__logf", "__sinf", "__cosf",
    "__fdividef", "__frsqrt_rn", "__saturatef",
])
def test_no_fused_or_fast_math_calls(banned):
    """The cube root is exp(log(max(u, 1e-12))·(1/3)) and every product
    and sum rounds on its own, as in the plain version."""
    assert not re.search(rf"\b{re.escape(banned)}\s*\(", SOURCE)


def test_nvcc_flags_keep_rounding():
    flags = cuda_build.NVCC_FLAGS
    assert "-fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert "arch=compute_90a,code=sm_90a" in flags


def test_winner_slot_and_key_layout_in_source():
    """The winner slot indexes the reordered scene as n_global +
    cidx·group + m, and the packed key ORs the cluster index into the 7
    cleared low bits of the entry's bit pattern."""
    assert "bs = p.n_global + cidx * p.group + m;" in SOURCE
    assert "(__float_as_int(qe) & ~127) | c" in SOURCE
    assert "__float_as_int(m0) & 127" in SOURCE
    assert tables.MAX_CLUSTERS == 128
