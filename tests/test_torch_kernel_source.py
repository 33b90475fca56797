"""Checks of the CUDA kernels' sources and build flags that hold without a
card: the constants the kernels bake in (``csrc/common.cuh``) are the
float32 roundings of the JAX package's Python doubles, the cube root stays
exp(log(u)/3), nothing fuses or approximates an operation that the plain
PyTorch versions (and the TPU kernel) round separately, the template
instantiations are all there, and the build cache keys on the headers a
source includes. The kernels themselves run only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import re
import shutil

import numpy as np
import pytest

from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu_torch.core import sampling
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import options, rng, tables
from raytracer_tpu_torch.utils import cuda_build

WALK = (cuda_build.CSRC_DIR / "cluster_walk.cu").read_text()
COMMON = (cuda_build.CSRC_DIR / "common.cuh").read_text()
FLAT = (cuda_build.CSRC_DIR / "flat_scan.cu").read_text()
SOURCE = "\n".join((COMMON, WALK, FLAT))

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


#: kernel integer constant → the value it must hold
EXPECTED_U32 = {
    **{f"kA4Fix{d}": pk._A4_FIX[d] for d in range(4)},
    **{f"kAB0Fix{d}": pk._AB0_FIX[d] for d in range(3)},
    "kRotCamera": 0xFFFFFFFC,
    "kRotBounce0": 0xFFFFFFF8,
}


def kernel_u32_constants() -> dict:
    found = re.findall(r"constexpr uint32_t (k\w+) = 0x([0-9a-fA-F]{8})u;",
                       SOURCE)
    return {name: int(lit, 16) for name, lit in found}


@pytest.mark.parametrize("name", sorted(EXPECTED_U32))
def test_stratified_constant_is_the_reference_integer(name):
    """The Kronecker alphas in 32-bit fixed point and the rotation
    counters are those of the TPU kernel and of the port's Python side."""
    assert kernel_u32_constants()[name] == EXPECTED_U32[name]


def test_every_integer_constant_is_checked():
    assert set(kernel_u32_constants()) == set(EXPECTED_U32)
    assert sampling.A4_FIX == pk._A4_FIX and sampling.AB0_FIX == pk._AB0_FIX
    assert (rng.ROT_CAMERA, rng.ROT_BOUNCE0) == (0xFFFFFFFC, 0xFFFFFFF8)


def test_four_template_instantiations():
    """Adaptive and stratified are compile-time template parameters: the
    walk's launcher picks among four instantiations, and the branches sit
    behind the parameters, never behind a run-time argument."""
    assert "template <bool kAdaptive, bool kStratified>" in WALK
    for a in ("true", "false"):
        for s in ("true", "false"):
            assert f"launch<{a}, {s}>(p, blocks, smem, st)" in WALK
    assert "int adaptive, int stratified" in WALK
    assert not re.search(r"p\.(adaptive|stratified|split)\b", SOURCE)
    # a lane without budget writes zeros to all six rows before it returns
    assert ("for (int c = 0; c < 6; ++c) out[c * n + lane] = 0.0f;"
            in COMMON)
    assert "segs[lane] = 0;" in COMMON
    # both kernels run the one shared tail
    for src in (WALK, FLAT):
        assert '#include "common.cuh"' in src
        assert "bounce_tail<kAdaptive, kStratified>(" in src
        assert "lane_setup<kAdaptive>(" in src


def test_eight_flat_instantiations():
    """The flat scan's switches (adaptive, stratified, split) are
    template parameters too: eight instantiations behind one launcher."""
    assert "template <bool kAdaptive, bool kStratified, bool kSplit>" in FLAT
    for a in ("true", "false"):
        for s in ("true", "false"):
            assert (f"launch_split<{a}, {s}>(p, split, blocks, smem, st)"
                    in FLAT)
    for sp in ("true", "false"):
        assert f"launch<kAdaptive, kStratified, {sp}>(p, blocks, smem, st)" \
            in FLAT
    assert "int adaptive, int stratified,\n    int split" in FLAT


def test_flat_candidate_rule_in_source():
    """The scan keeps the lowest slot of equal candidates (strict <), the
    near-only suffix starts at g_full, and the self-test of the last-hit
    slot runs mid-path only and wins only when strictly nearer."""
    assert FLAT.count("if (q < bq) {") == 2
    assert "for (int j = g_full; j < p.slots; ++j) {" in FLAT
    assert "if (path.i >= 1) {" in FLAT
    assert "if (qf >= min_t_a && qf < bq) {" in FLAT
    assert "if (kSplit && r == kPathGoesOn) last = bs;" in FLAT
    assert "return qn >= min_t_a ? qn : kFillQ;" in FLAT
    assert "return nb + sq;" in FLAT
    # the tail reads [1/r, mat, albedo rgb, fuzz, ior] at row + 4
    assert "row, row + 4, bq" in FLAT and "w, w + 3, bq" in WALK


def test_build_key_follows_the_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc header it
    includes: editing common.cuh rebuilds both kernels."""
    assert [p.name for p in cuda_build.sources("flat_scan")] == [
        "flat_scan.cu", "common.cuh"]
    assert [p.name for p in cuda_build.sources("cluster_walk")] == [
        "cluster_walk.cu", "common.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    before = {n: cuda_build.library_path(n)
              for n in ("flat_scan", "cluster_walk")}
    with open(csrc / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    for name, path in before.items():
        assert cuda_build.library_path(name) != path, name


def test_adaptive_and_stratified_arithmetic_in_source():
    """Operation order of the variants, as the plain version has it: the
    luminance is (r + g + b)·float32(1/3), squared and added; the
    Kronecker point wraps in native uint32; the first bounce's direction
    is not normalised again."""
    assert "const float lum = (con_r + con_g + con_b) * kOneThird;" in SOURCE
    assert "sums.l2 = sums.l2 + lum * lum;" in SOURCE
    assert ("lowbias32(pix ^ ((rot + d) * 0x9E3779B9u)) + s_u * a_fix"
            in SOURCE)
    first = SOURCE[SOURCE.index("if (kStratified && path.i == 0) {"):]
    first = first[:first.index("} else {")]
    assert "normalize3" not in first and "uvz = b_hx;" in first


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
