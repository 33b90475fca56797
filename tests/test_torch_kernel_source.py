"""Checks of the CUDA kernels' sources and build flags that hold without a
card: the constants the kernels bake in (``csrc/common.cuh``) are the
float32 roundings of the JAX package's Python doubles, the cube root stays
exp(log(u)/3), nothing fuses or approximates an operation that the plain
PyTorch versions (and the TPU kernel) round separately, the template
instantiations are all there (and the debug overlay's only where the JAX
package can reach them), the overlay's constants and order match the
plain twin's, and the build cache keys on the headers a source includes. The kernels themselves run only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import ctypes
import dataclasses
import inspect
import re
import shutil
import types

import numpy as np
import pytest
import torch

from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.core import sampling
from raytracer_tpu_torch.render import adaptive_plan
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import flat_scan as fs
from raytracer_tpu_torch.render import options, rng, tables
from raytracer_tpu_torch.scene import presets
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
    "kCursorR2": 0.01,
    "kGrazing": -0.05,
    "kMarked": 3.0,
    # the motion walk's checker material code
    "kChecker": float(cw.CHECKER),
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
    # the wide walk's box bit of a list entry: the sign bit, which a
    # positive float key leaves free
    "kListBox": 0x80000000,
    # the motion walk's time draw: its counter block's first counter
    "kShutterCtr": cw.SHUTTER_CTR,
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
    assert "template <bool kAdaptive, bool kStratified, bool kDebug>" in WALK
    for a in ("true", "false"):
        for s in ("true", "false"):
            assert f"launch<{a}, {s}, false>(p, blocks, smem, st)" in WALK
    assert "int adaptive, int stratified,\n    int debug" in WALK
    assert not re.search(r"p\.(adaptive|stratified|split)\b", SOURCE)
    # a lane without budget writes zeros to all six rows before it returns
    assert ("for (int c = 0; c < 6; ++c) out[c * n + lane] = 0.0f;"
            in COMMON)
    assert "segs[lane] = 0;" in COMMON
    # both kernels run the one shared tail
    for src in (WALK, FLAT):
        assert '#include "common.cuh"' in src
        assert "bounce_tail<kAdaptive, kStratified, kDebug>(" in src
        assert "lane_setup<kAdaptive>(" in src


def test_eight_flat_instantiations():
    """The flat scan's switches (adaptive, stratified, split) are
    template parameters too: eight instantiations behind one launcher,
    each built in two scan forms (slot by slot, and in batches), which the
    launcher picks by the table's size."""
    assert ("template <bool kAdaptive, bool kStratified, bool kSplit, "
            "bool kDebug>") in FLAT
    assert ("template <bool kAdaptive, bool kStratified, bool kSplit, "
            "bool kDebug,\n          bool kBatched>\n__global__") in FLAT
    for a in ("true", "false"):
        for s in ("true", "false"):
            assert f"launch_split<{a}, {s}>(p, split, smem, st)" in FLAT
    for sp in ("true", "false"):
        assert (f"launch<kAdaptive, kStratified, {sp}, false>(p, smem, st)"
                in FLAT)
    form = FLAT[FLAT.index("cudaError_t launch(const Params& p"):]
    form = form[:form.index("}")]
    assert "return p.slots >= kBatchedMin" in form
    for batched in ("true", "false"):
        assert (f"launch_form<kAdaptive, kStratified, kSplit, kDebug, "
                f"{batched}>(") in form
    assert "int adaptive,\n    int stratified, int split, int debug" in FLAT


def test_flat_candidate_rule_in_source():
    """The scan keeps the lowest slot of equal candidates (strict <), the
    near-only suffix starts at g_full, and the self-test of the last-hit
    slot runs mid-path only and wins only when strictly nearer. A slot's
    root logic is exact_q's (the near root alone past g_full), its update
    strict; a batch's roots run only where some discriminant of the batch
    is not negative, and then only on those slots, in ascending order."""
    root = FLAT[FLAT.index("void take_root("):FLAT.index("struct Ray {")]
    assert "const float sq = root_of(ds);" in root
    assert ("const float q = kFull ? (qn >= min_t_a ? qn : nb + sq) : qn;"
            in root)
    assert "if (q >= min_t_a && q < bq) {" in root
    assert FLAT.count("< bq) {") == 2
    assert "scan_slots<true, kBatched>(s_tab, 0, g_full, r, bq, bs, cnt);" \
        in FLAT
    assert ("scan_slots<false, kBatched>(s_tab, g_full, p.slots, r, bq, bs, "
            "cnt);") in FLAT
    batch = FLAT[FLAT.index("for (; j + kBatch <= j1; j += kBatch) {"):
                 FLAT.index("scan_each<kFull>(s_tab, j, j1, r, bq, bs, cnt);")]
    assert "miss = miss & (ds[k] < 0.0f);" in batch
    assert "if (!miss) {" in batch and "if (!(ds[k] < 0.0f))" in batch
    assert "take_root<kFull>(nb[k], ds[k], r.min_t_a, j + k, bq, bs);" \
        in batch
    assert "if (path.i >= 1) {" in FLAT
    assert "const float qf = nb + root_of(ds);" in FLAT
    assert "if (qf >= r.min_t_a && qf < bq) {" in FLAT
    assert "if (kSplit && res == kPathGoesOn) last = bs;" in FLAT
    # one quadratic for both kernels: the walk's exact_q and the scan
    assert "discriminant(c[0], c[1], c[2], c[3]," in COMMON
    assert "discriminant(c.x, c.y, c.z, c.w," in FLAT
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
    # the diffuse and metal vectors come from one draw: the first
    # stratified diffuse bounce takes (hx, phi) on the unit sphere, not
    # normalised again; the random draws keep exp(log(u)/3) as radius
    assert "const bool strat0 = kStratified && diffuse && path.i == 0;" \
        in COMMON
    first = COMMON[COMMON.index("if (strat0) {"):]
    first = first[:first.index("} else {")]
    assert "normalize3" not in first and "r2_fixed(pix, kRotBounce0, 0" \
        in first
    assert "vz = strat0 ? hx : r * hx;" in COMMON
    assert "if (diffuse && !strat0) normalize3(vx, vy, vz);" in COMMON
    assert ("r = expf(logf(fmaxf(u01(pix, ctr, salt + 2), kUEps)) * "
            "kOneThird);") in COMMON
    assert "const uint32_t salt = diffuse ? 0u : 3u;" in COMMON


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


def test_walk_culls_boxes_in_source():
    """The walk's box test: one level of parent boxes on a bounce's first
    iteration, then only the children of the parents entered; the hit
    boxes in a bitmask that later iterations re-test, less each visited
    cluster; a lane walks its bounce to the end before the tail. The
    constants agree with the host tables' layout, and the counter build
    is compiled in only on request."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", WALK))
    assert int(consts["kParentFanout"]) == tables.PARENT_FANOUT
    assert int(consts["kBoxFloats"]) == tables.BOX_FLOATS
    assert int(consts["kMaxWords"]) * 32 == tables.MAX_CLUSTERS
    # one mask word up to 32 clusters, kMaxWords past them
    assert "return p.k <= 32" in WALK
    assert "launch_words<kAdaptive, kStratified, kDebug, 1>(" in WALK
    assert "launch_words<kAdaptive, kStratified, kDebug, kMaxWords>(" in WALK
    assert int(consts["kWalkThreads"]) == 1024
    assert "__launch_bounds__(kWalkThreads, 1)" in WALK
    at = WALK.index("if (fresh) {")  # the narrow walk's loop
    fresh = WALK[at:WALK.index("float m0 = INFINITY", at)]
    assert "box_entry(s_par + kBoxFloats * q" in fresh
    assert "mask_or(cand, c0 >> 5, ((1u << nc) - 1u) << (c0 & 31));" in fresh
    assert "BoxMask<kIsWide ? 1 : kWords> cand = hits;" in WALK
    loop = WALK[WALK.index("float m0 = INFINITY", at):
                WALK.index("} while (!bdone);")]
    assert "box_entry(s_box + kBoxFloats * c" in loop
    assert "hits.w[j] |= 1u << (c & 31);" in loop
    assert "mask_clear(hits, cidx);" in loop and "kl = m0;" in loop
    assert "} while (!bdone);" in WALK
    assert WALK.index("} while (!bdone);") < WALK.index("bounce_tail<")
    assert "#ifdef RT_WALK_COUNTERS" in WALK
    assert not any("RT_WALK" in f for f in cuda_build.NVCC_FLAGS)
    assert "s_mem + 4 * cidx * p.mstride" in WALK


def test_walk_grid_spreads_the_map_head_in_source():
    """The persistent grid's first lanes go a warp's 32 at a time to the
    blocks in turn (so an adaptive re-plan's few live lanes, at the map's
    head, reach every SM), later ones come from the counter; the launch
    zeroes the counter on its stream and works out the grid's size only
    when the device or the tables' size changes."""
    spread = COMMON[COMMON.index("int first_lane()"):
                    COMMON.index("int next_lane(int* counter)")]
    assert "32 * (warp * (int)gridDim.x + (int)blockIdx.x)" in spread
    assert "(int)(gridDim.x * blockDim.x) + base" in COMMON
    for src in (WALK, FLAT):
        assert "int lane = first_lane();" in src
        assert "lane = next_lane(p.next_lane);" in src
    launch = WALK[WALK.index("cudaError_t launch_words("):
                  WALK.index("// the box mask's width")]
    assert "if (dev != set_dev || smem != set_smem) {" in launch
    assert launch.index("cudaMemsetAsync(p.next_lane, 0, sizeof(int), "
                        "stream)") < launch.index("kernel<<<")


def test_flat_persistent_grid_in_source():
    """The flat scan runs one persistent block of 1024 threads an SM (64
    registers a thread), its grid capped at the blocks that fit at once,
    worked out again only when the device or the table's size changes;
    the launch zeroes the lane counter on its stream first; a finished
    lane's refill is an if-region the warp's lanes leave together; slots
    go in batches of 8 from 16 slots; the counter build is compiled in
    only on request."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", FLAT))
    cut = re.search(r"#ifndef RT_FLAT_BATCHED_MIN\n#define RT_FLAT_BATCHED_MIN "
                    r"(\d+)\n#endif\nconstexpr int kBatchedMin = "
                    r"RT_FLAT_BATCHED_MIN;", FLAT)
    assert (int(consts["kFlatThreads"]), int(consts["kBatch"]),
            int(cut.group(1))) == (1024, 8, 16)
    assert "__launch_bounds__(kFlatThreads, 1)" in FLAT
    launch = FLAT[FLAT.index("cudaError_t launch_form("):
                  FLAT.index("// the scan's form from the table")]
    assert "if (dev != set_dev || smem != set_smem) {" in launch
    assert "if (blocks > grid_max) blocks = grid_max;" in launch
    assert launch.index("cudaMemsetAsync(p.next_lane, 0, sizeof(int), "
                        "stream)") < launch.index("kernel<<<")
    loop = FLAT[FLAT.index("const int res = bounce_tail<"):]
    assert loop.index("if (res == kLaneDone) {") < loop.index(
        "write_lane<kAdaptive>(") < loop.index("if (lane >= p.n) break;")
    assert "continue;" not in loop[:loop.index("if (lane >= p.n) break;")]
    assert "#ifdef RT_FLAT_COUNTERS" in FLAT
    assert not any("RT_FLAT" in f for f in cuda_build.NVCC_FLAGS)
    assert fs.ABI == 2


def _body(src: str, head: str) -> str:
    """The function of ``src`` that starts at ``head``, to its closing
    brace at the line's start."""
    start = src.index(head)
    return src[start:src.index("\n}\n", start)]


def test_walk_items_only_under_adaptive_in_source():
    """The one-sample items, their scratch and the sample counts are
    compiled only into the adaptive instantiations: the kernel plans its
    deal and ends its block under ``kAdaptive``, and the helpers that
    take and finish work reach the items only in their ``if constexpr
    (kAdaptive)`` branch, so the other instantiations deal whole lanes as
    before. The kernel's item capacity is the one the wrapper passes and
    sizes the scratch by, whose rows are the ones an item stores."""
    kernel = _body(WALK, "    cluster_walk_kernel(Params p) {")
    assert ("if constexpr (kAdaptive) {\n    if (threadIdx.x == 0) "
            "plan_deal(p, smem);\n  }") in kernel
    assert "if constexpr (kAdaptive) end_block(p, smem);" in kernel
    assert "walk<kAdaptive, kStratified, kDebug, kWords>(p, smem);" in kernel
    for head, reach in (("bool take(", "item_setup(p,"),
                        ("void finish(", "finish_item(p,"),
                        ("int work_end(", "deal_of(p, smem)")):
        body = _body(WALK, "__device__ __forceinline__ " + head)
        assert body.index("if constexpr (kAdaptive)") < body.index(reach)
    walk = _body(WALK, "__device__ __forceinline__ void walk(")
    for name in ("item_setup", "finish_item", "counts_of", "p.items",
                 "p.lane_items", "p.samples"):
        assert name not in walk, name
    assert "take<kAdaptive>(p, smem, lane" in walk
    assert "finish<kAdaptive>(p, smem, lane" in walk
    # the capacity is the launch's, which the wrapper sizes the scratch
    # by: the kernel has none of its own; an item stores the kernel's
    # rows, and a launch with a scratch of other rows is refused
    assert "kItemCap" not in WALK
    assert ("(long long)live * stride <= p.item_cap;"
            in _body(WALK, "__device__ __forceinline__ void plan_deal("))
    finish_item = _body(WALK, "__device__ __forceinline__ void finish_item(")
    assert "const int cap = p.item_cap;" in finish_item
    stores = re.findall(r"it\[(?:(\d) \* )?(cap \+ )?t\] = ", finish_item)
    rows = re.search(r"constexpr int kItemRows = (\d+);", WALK)
    assert len(stores) == int(rows.group(1)) == cw.ITEM_ROWS
    assert "item_rows != kItemRows || item_cap < 0" in WALK
    # only the adaptive launch carries the scratch, the extent and the
    # counts, and the extra shared memory
    assert ("(adaptive ? (size_t)kAdaptiveSmemBytes : 0)" in WALK)
    assert "if (items == nullptr || lane_items == nullptr ||" in WALK
    wrapper = inspect.getsource(cw.call)
    assert "if adaptive:" in wrapper and "_item_scratch(dev, stream)" in wrapper
    assert ("profiling.device_counts(\n                dev, WIDE_COUNTS "
            "if wide else SAMPLE_COUNTS)") in wrapper
    assert "(ITEM_ROWS, ITEM_CAP)" in wrapper


@pytest.mark.parametrize("source, symbol, module", [
    ("cluster_walk", "cluster_walk_abi", cw), ("flat_scan", "flat_scan_abi",
                                               fs)])
def test_launch_interface_version_in_source(source, symbol, module):
    """Each library exports the version of its launch arguments, the one
    its wrapper passes."""
    text = (cuda_build.CSRC_DIR / f"{source}.cu").read_text()
    found = re.findall(rf'extern "C" int {symbol}\(\) {{ return (\d+); }}',
                       text)
    assert found == [str(module.ABI)]


def test_winner_slot_and_key_layout_in_source():
    """The winner slot indexes the reordered scene as n_global +
    cidx·group + m, and the packed key ORs the cluster index into the 7
    cleared low bits of the entry's bit pattern (9 in the wide walk); the
    cluster index reads back from the key's bits of the walk's width."""
    assert "bs = p.n_global + cidx * p.group + m;" in SOURCE
    assert "(__float_as_int(qe) & ~127) | c" in SOURCE
    assert "(__float_as_int(qe) & ~kKeyMask<kWide>) | c" in SOURCE
    assert "__float_as_int(m0) & kKeyMask<kWords>" in SOURCE
    assert ("constexpr int kKeyMask = kWords == kWide ? (1 << kWideKeyBits) "
            "- 1 : 127;") in WALK
    assert tables.MAX_CLUSTERS == 128
    assert tables.key_bits(tables.MAX_CLUSTERS) == 7
    assert tables.key_bits(tables.MAX_CLUSTERS + 1) == 9
    assert tables.key_bits(tables.MAX_WIDE_CLUSTERS) == 9


def test_wide_walk_in_source():
    """The wide walk (``RT_WALK_WIDE``, a library of its own): its
    constants agree with the host's (512 clusters in 16 mask words, 9 key
    bits, 48 bytes of counts and deal before the masks), its library
    instantiates the wide walk alone and the narrow one the narrow walk
    alone, it reads its winner rows from global memory, its sweep (the
    fallback of a list that overflows) culls through the grandparents
    after the parents, keeps its masks in shared memory a word per 32
    clusters, and it counts iterations, bounces and sweeps at the indices
    the wrapper reads them."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", WALK))
    assert int(consts["kWide"]) == 0
    assert int(consts["kWideMaxWords"]) * 32 == tables.MAX_WIDE_CLUSTERS
    assert int(consts["kWideKeyBits"]) == tables.key_bits(
        tables.MAX_WIDE_CLUSTERS)
    assert int(consts["kWideExtraBytes"]) == tables.WIDE_EXTRA_BYTES
    assert int(consts["kWalkThreads"]) == tables.WALK_THREADS
    assert cw.WIDE_DEFINE == "RT_WALK_WIDE"
    launch = WALK[WALK.index("cudaError_t launch(const Params& p"):
                  WALK.index("}  // namespace")]
    wide, narrow = launch.split("#else")
    assert "launch_words<kAdaptive, kStratified, kDebug, kWide>(" in wide
    assert "kMaxWords" not in wide and "kWide" not in narrow
    assert "#ifdef RT_WALK_WIDE" in launch
    assert ("const float* s_win = (kIsWide ? p.tables : smem) + p.off_win;"
            in WALK)
    fresh = _body(WALK, "__device__ __forceinline__ int wide_fresh(")
    assert "s_par + kBoxFloats * p.n_parents;" in fresh
    # grandparents, then the parents under each entered one, then the
    # leaves under each entered parent, each lane over its own hits
    order = [fresh.index(t) for t in (
        "s_grand + kBoxFloats * g", "for (; grand != 0u; grand &= grand - 1u)",
        "s_par + kBoxFloats * (q0 + j)", "for (; par != 0u; par &= par - 1u)",
        "s_box + kBoxFloats * c")]
    assert order == sorted(order)
    assert "(__float_as_int(qe) & ~kKeyMask<kWide>) | c" in fresh
    # a word outside `live` holds what an earlier lane or launch left:
    # the bounce's first hit in it assigns it, later ones add to it
    assert "uint32_t& m = mask[(c0 >> 5) * kWalkThreads];" in fresh
    assert "m = (live & word) != 0u ? m | run : run;" in fresh
    assert "live = 0u;" in fresh
    test = _body(WALK, "__device__ __forceinline__ int wide_test(")
    assert "for (uint32_t lw = live; lw != 0u; lw &= lw - 1u) {" in test
    assert "mask[j * kWalkThreads] = kept;" in test
    walk = _body(WALK, "__device__ __forceinline__ void walk(")
    sweep = _body(WALK, "__device__ __forceinline__ int wide_sweep(")
    assert ("tested += wide_fresh(p, s_par, s_box, mask, live, ox, oy, oz, "
            "ivx, ivy,") in sweep
    assert "tested += wide_test(s_box, mask, live, ox, oy, oz," in sweep
    host = WALK[WALK.index('extern "C" int cluster_walk_launch('):]
    assert "p.n_floats = off_win;" in host
    assert "p.n_words = (k + 31) / 32;" in host
    assert "sizeof(uint32_t) * (size_t)p.n_words * kWalkThreads" in host
    assert "k <= 32 * kMaxWords || k > 32 * kWideMaxWords" in host
    # the block's counts lie after the deal (32 bytes in), the launch's
    # at 2 and 3 of WIDE_COUNTS (the enum is checked with the sweeps')
    assert "constexpr int kWalkCountsAt = 2;" in WALK
    assert WALK.count("counts_of(p, smem) + kWalkCountsAt") == 3
    assert 8 * (int(consts["kWalkCountsAt"]) + 3) + 8 <= int(
        consts["kWideExtraBytes"])
    assert "p.n_floats + 4" in _body(
        WALK, "__device__ __forceinline__ Deal& deal_of(")
    assert cw.WIDE_COUNTS[2:4] == ("walk_iterations", "walk_segments")
    assert cw.WIDE_COUNTS[:2] == cw.SAMPLE_COUNTS
    assert "if constexpr (kIsWide) count_walk(p, smem, cost, segs);" in walk
    # the sweep's count: 32 bits after the deal (28 bytes in), the
    # launch's fifth
    assert "enum WalkCount { kWalkIterations = 2, kWalkSegments = 3, " \
        "kWalkSweeps = 4 };" in WALK
    assert cw.WIDE_COUNTS[4] == "walk_sweeps"
    assert "smem + p.n_floats + 7" in _body(
        WALK, "__device__ __forceinline__ uint32_t* sweeps_of(")
    assert "atomicAdd(sweeps_of(p, smem), 1u);" in walk


def test_wide_walk_list_in_source():
    """The wide walk's bounce: the globals' best, the list started from
    the fourth level (global memory, after the winner rows) down to the
    hit grandparents, then each pass expanding boxes until the nearest
    entry is a kd leaf or at the best, a visit, and the flat walk's
    iterations (one a visit, at least one) into the cost row; an
    overflow starts the bounce over as the sweep. A box is keyed a bucket
    below its entry, with the box bit; a run of children is tested
    unrolled and its hits merged into the list (the nearest entry last,
    and in a register); the children are the next level's in shared
    memory. The narrow walk's loop has no trace of it."""
    consts = dict(re.findall(r"constexpr uint32_t (k\w+) = ([^;]+);", WALK))
    assert consts["kListBox"] == "0x80000000u"
    assert consts["kBucket"] == "1u << kWideKeyBits"
    assert consts["kOrderFloor"] == "~kListBox & ~(kBucket - 1u)"
    entry = _body(WALK, "__device__ __forceinline__ uint32_t list_entry(")
    assert ("return box ? kListBox | (b - kBucket) | (uint32_t)id : b | "
            "(uint32_t)id;") in entry
    run = _body(WALK, "__device__ __forceinline__ bool expand_run(")
    assert "if (len + hits > cap) return false;" in run
    assert "const int c = first + min(j, nc - 1);" in run
    assert "h[j] = j < nc && qe < kFillQ ? list_entry(qe, c, box) : ~0u;" \
        in run
    assert run.count("t = min(") == 5  # the four hits sorted
    assert "if (i >= 0 && list_order(f) < list_order(h0)) {" in run
    assert "head = top;" in run
    top = _body(WALK, "__device__ __forceinline__ bool wide_top(")
    assert "const float* top = p.tables + p.off_top;" in top
    assert "top + kBoxFloats * (p.n_l3 + t)" in top
    assert "expand_run(s_par, p.n_parents + g0," in top
    expand = _body(WALK, "__device__ __forceinline__ bool wide_expand(")
    assert "return expand_run(leaves ? s_box : s_par, first," in expand
    sweep = _body(WALK, "__device__ __forceinline__ int wide_sweep(")
    order = [sweep.index(t) for t in ("global_best(", "wide_fresh(",
                                      "visit_cluster(", "wide_test(")]
    assert order == sorted(order)
    walk = _body(WALK, "__device__ __forceinline__ void walk(")
    wide, narrow = walk.split("    } else {\n", 1)
    for t in ("if (__int_as_float(e & kOrderFloor) >= bq) break;",
              "if ((e & kListBox) == 0u) {", "const uint32_t e = head;",
              "over = !wide_expand(", "visit_cluster(p, s_mem, cidx,",
              "visits = wide_sweep(", "cost += (float)max(visits, 1);",
              "if (len > 0) head = mask[(len - 1) * kWalkThreads];"):
        assert t in wide, t
    assert wide.index("wide_top(") < wide.index("while (!over) {")
    for t in ("wide_", "kListBox", "list_"):
        assert t not in narrow.split("} while (!bdone);")[0], t


def test_wide_list_capacity_matches_the_tables():
    """The kernel's list capacity (its mask words, and every word a
    thread's share of the block's 232,448 bytes leaves) is
    ``tables.wide_list_capacity``, the sphereflake's 85 in a block of
    256 threads; the levels past the grandparents lie where
    ``tables.walk_layout`` puts them; and the shared memory by which the
    walk admits a wide partition, ``tables.wide_smem_bytes``, is what it
    was before the list for every partition of 129 to 512 clusters (so
    the same scenes take the wide walk), and never below what the
    kernel's block needs."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", WALK))
    assert int(consts["kMaxWalkSmemBytes"]) == tables.MAX_WALK_SMEM_BYTES
    wide, narrow = WALK.split("#ifdef RT_WALK_WIDE\n", 1)[1].split(
        "#else\n", 1)
    assert "constexpr int kWalkThreads = 256;" in wide
    assert narrow.startswith("constexpr int kWalkThreads = 1024;")
    assert (tables.WIDE_WALK_THREADS, tables.WALK_THREADS) == (256, 1024)
    host = WALK[WALK.index('extern "C" int cluster_walk_launch('):]
    for t in ("p.n_l3 = (p.n_grand + kParentFanout - 1) / kParentFanout;",
              "p.n_l4 = (p.n_l3 + kParentFanout - 1) / kParentFanout;",
              "p.off_top = (off_win + 11 * (n_global + k * group) + 3) / 4 "
              "* 4;",
              "const int n_top = p.n_l3 + p.n_l4 + (p.n_l4 > 1 ? 1 : 0);",
              "if (n_floats < p.off_top + kBoxFloats * n_top)",
              "const size_t need = sizeof(float) * (size_t)off_win + "
              "kWideExtraBytes +",
              "sizeof(uint32_t) * (size_t)p.n_words * kWalkThreads;",
              "const size_t word = sizeof(uint32_t) * kWalkThreads;",
              "p.list_cap = p.n_words + (need < kMaxWalkSmemBytes",
              "? (int)((kMaxWalkSmemBytes - need) / word)",
              "need + word * (size_t)std::max(p.list_cap - p.n_words, 0);"):
        assert t in host, t

    def kernel_side(n_global, k, group):
        """The launcher's arithmetic, from its arguments."""
        lay = tables.walk_layout(n_global, k, group)
        n_grand = -(-lay.n_parents // 4)
        n_l3 = -(-n_grand // 4)
        n_l4 = -(-n_l3 // 4)
        off_top = (lay.off_win + 11 * (n_global + k * group) + 3) // 4 * 4
        n_top = n_l3 + n_l4 + (1 if n_l4 > 1 else 0)
        words = (k + 31) // 32
        need = 4 * lay.off_win + 48 + 4 * words * 256
        cap = words + ((232448 - need) // 1024 if need < 232448 else 0)
        return n_top, off_top, need, cap

    for n_global, group in ((1, 16), (0, 8), (3, 24)):
        for k in range(129, 513):
            lay = tables.walk_layout(n_global, k, group)
            n_top, off_top, need, cap = kernel_side(n_global, k, group)
            assert (lay.n_top, lay.off_top) == (n_top, off_top)
            assert lay.n_floats == off_top + 8 * n_top
            assert tables.wide_list_capacity(lay) == cap
            # before the list: the hit-test tables up to the winner rows
            # (camera, globals, parents and grandparents, leaves, members
            # at their odd stride), the counts and deal, a mask word per
            # 32 clusters a thread
            n_par = -(-k // 4)
            mstride = group | 1
            off_win = (20 + 4 * n_global + 8 * (n_par + -(-n_par // 4))
                       + 8 * k + 4 * k * mstride)
            assert tables.wide_smem_bytes(lay) == (
                4 * off_win + 48 + 4 * -(-k // 32) * 1024)
            assert need <= tables.wide_smem_bytes(lay)
    flake = tables.walk_layout(1, 462, 16)
    assert tables.wide_smem_bytes(flake) == 206672
    assert tables.wide_list_capacity(flake) == 15 + 70


def test_debug_overlay_in_source_and_plain_twin():
    """The overlay (K3) of the shared tail and of its plain twin: the
    cursor's squared distance summed left to right against 0.01, the
    outline on the raw direction and the front-corrected normal against
    -0.05, the fixed colours (blue marker, red outline), and a marked lane
    that skips the scatter (its material reads as absorbing). The same
    constants stand in the TPU kernel."""
    assert (cw.CURSOR_R2, cw.GRAZING) == (0.01, -0.05)
    assert ("dcx * dcx + dcy * dcy + dcz * dcz < kCursorR2;" in COMMON)
    assert ("!cursor_hit && uuid == dbg.sel &&\n"
            "                           dot3(dx, dy, dz, nx, ny, nz) > "
            "kGrazing;") in COMMON
    assert "con_r = outline ? 1.0f : 0.0f;" in COMMON
    assert "con_b = cursor_hit ? 1.0f : 0.0f;" in COMMON
    assert "const float mat = (kDebug && marked) ? kMarked : wm[1];" in COMMON
    # the overlay comes after the front-face correction of the normal
    assert COMMON.index("nz = nz * sgn;") < COMMON.index("if (kDebug) {")
    plain = inspect.getsource(cw.bounce_tail)
    assert "dcx * dcx + dcy * dcy + dcz * dcz < CURSOR_R2" in plain
    assert "rng.dot3(dx, dy, dz, nx, ny, nz) > GRAZING" in plain
    assert "scat = scat & ~cursor & ~outline" in plain
    assert "torch.where(outline, 1.0, con_r)" in plain
    assert "torch.where(cursor, 1.0, con_b)" in plain
    assert plain.index("nx, ny, nz = nx * sgn") < plain.index("cursor = ")
    tpu = inspect.getsource(pk)
    assert "< jnp.float32(0.01))" in tpu and "> jnp.float32(-0.05))" in tpu
    # the uuids: column 10 of the walk's winner row, the flat scan's slot
    assert "kDebug ? w[10] : 0.0f" in WALK and "kDebug ? (float)bs : 0.0f" \
        in FLAT


def test_only_the_reachable_debug_instantiations():
    """Debug strips the adaptive tolerance and turns the split off in the
    JAX package, so exactly four debug instantiations exist: the walk's
    <0,0,1> and <0,1,1>, the flat scan's <0,0,0,1> and <0,1,0,1>; the
    launchers refuse the rest."""
    walk = re.findall(r"launch<(\w+), (\w+), true>\(p, blocks, smem, st\)",
                      WALK)
    assert sorted(walk) == [("false", "false"), ("false", "true")]
    flat = re.findall(r"launch<(\w+), (\w+), (\w+), true>\(p, smem, st\)",
                      FLAT)
    assert sorted(flat) == [("false", "false", "false"),
                            ("false", "true", "false")]
    assert "if (adaptive) return (int)cudaErrorInvalidValue;" in WALK
    assert "if (adaptive || split) return (int)cudaErrorInvalidValue;" in FLAT
    names = {cw.variant_name(options.TraceOptions(
        sampler=s, enable_debug=True)) for s in ("random", "stratified")}
    names |= {fs.variant_name(options.TraceOptions(
        sampler=s, enable_debug=True), False)
        for s in ("random", "stratified")}
    assert names == {"cluster_walk_debug", "cluster_walk_stratified_debug",
                     "flat_scan_debug", "flat_scan_stratified_debug"}


def test_debug_with_split_or_adaptive_is_refused():
    """The wrappers raise on the combinations without an instantiation:
    debug with adaptive (both kernels) and debug with a split."""
    scene, cam, *_ = presets.get_config("demo", 16, 8)
    dcam = derive_camera(cam)
    ident = cw.identity_map(16, 8, "cpu")
    debug = options.TraceOptions(max_depth=2, enable_debug=True)
    both = options.TraceOptions(max_depth=2, enable_debug=True,
                                adaptive_tolerance=0.2)
    ft = tables.flat_tables(scene, dcam, "cpu")
    with pytest.raises(ValueError, match="no split instantiation"):
        fs.flat_scan(ft, ident, 1, 0, 1, 16, 8, debug, g_full=4)
    with pytest.raises(ValueError, match="no adaptive instantiation"):
        fs.flat_scan(ft, ident, 1, 0, 1, 16, 8, both)
    big, bcam, *_ = presets.get_config("cover", 16, 8)
    wt = tables.walk_tables(tables.cluster_partition(big, debug),
                            derive_camera(bcam), "cpu")
    with pytest.raises(ValueError, match="no adaptive instantiation"):
        cw.cluster_walk(wt, ident, 1, 0, 1, 16, 8, both)
    out, segs = fs.flat_scan(ft, ident, 1, 0, 1, 16, 8, debug)
    assert out.shape == (4, 128) and torch.isfinite(out).all()


PROBES = {name: (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
          for name in ("probe_chain", "probe_gather", "probe_scan")}


@pytest.mark.parametrize("banned", [
    "cbrtf", "fmaf", "__fmaf", "__expf", "__logf", "__sinf", "__cosf",
    "__fdividef", "__frsqrt_rn", "__saturatef", "__hfma", "__hfma2",
    "__fsqrt_rn",
])
def test_probe_sources_round_every_operation(banned):
    """The probes' products and sums round on their own, as the TPU kernels
    and the plain versions round them: no fused or approximate call."""
    for name, src in PROBES.items():
        assert not re.search(rf"\b{re.escape(banned)}\s*\(", src), name


def test_probe_instantiations():
    """Two chains (float32, bf16 pairs), three gather modes, four scan
    blocks, each behind one C launcher that refuses the rest."""
    chain, gather, scan = (PROBES[n] for n in ("probe_chain", "probe_gather",
                                               "probe_scan"))
    assert re.findall(r"launch<([\w ]+)>\(x, out", chain) == [
        "__nv_bfloat162", "float"]
    assert "__hmul2(a, b)" in chain and "__hadd2(a, b)" in chain
    assert "v = add(mul(v, xs[c]), xs[(c + k + 1) % kChains]);" in chain
    assert re.findall(r"return \(int\)(launch\w*)(<k\w+>)?\(tbl, out",
                      gather) == [("launch", "<kAxis0>"),
                                  ("launch", "<kAxis1>"),
                                  ("launch_onehot", "")]
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in gather
    assert "cudaDevAttrMaxSharedMemoryPerBlockOptin" in gather
    # the one-hot product on the tensor cores: bf16 MMAs with an fp32
    # accumulator over the exact three-piece split of column 0
    assert re.search(r'"mma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16'
                     r'\.bf16\.f32 "', gather)
    assert "const float lo = r - mid;" in gather
    assert "acc_g = acc_g + ((d[0] + d[1]) + lo_g);" in gather
    assert "__launch_bounds__(kMmaThreads, kMmaMinBlocks)" in gather
    assert sorted(int(b) for b in re.findall(
        r"case (\d+): return \(int\)launch<\1>\(s, out", scan)) == [
            8, 32, 64, 512]
    assert "template <int kBlock>" in scan
    # every block one slot loop under a register cap of 32 warps an SM
    assert "__launch_bounds__(kThreads, kMinBlocks)" in scan
    assert "constexpr int kMinBlocks = 8;" in scan
    for src in PROBES.values():
        assert src.count("return (int)cudaErrorInvalidValue;") >= 1
        assert "return cudaGetLastError();" in src


def test_probes_build_with_the_kernels_flags():
    """Each probe is one source without headers of csrc/, built by the
    same helper and flags (sm_90a, -fmad=false, no fast math) into its own
    library."""
    paths = set()
    for name in PROBES:
        assert [p.name for p in cuda_build.sources(name)] == [f"{name}.cu"]
        path = cuda_build.library_path(name)
        assert path.parent == cuda_build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-")
        paths.add(path)
    assert len(paths) == 3
    test_nvcc_flags_keep_rounding()


# --- the adaptive re-plan (csrc/adaptive_plan.cu) ----------------------------

PLAN = (cuda_build.CSRC_DIR / "adaptive_plan.cu").read_text()


def test_adaptive_plan_builds_with_the_kernels_flags():
    """One source without headers of csrc/, built by the same helper and
    flags (sm_90a, -fmad=false, no fast math) into its own library."""
    assert [p.name for p in cuda_build.sources("adaptive_plan")] == [
        "adaptive_plan.cu"]
    path = cuda_build.library_path(adaptive_plan.LIBRARY[0])
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libadaptive_plan-")
    test_nvcc_flags_keep_rounding()


def test_load_all_builds_what_is_missing_in_one_batch(monkeypatch):
    """``cuda_build.load_all`` loads libraries in the order asked, builds
    those not loaded yet in one ``build_all`` batch (one nvcc each, at
    once), and loads nothing twice."""
    batches = []

    def build_all(specs):
        batches.append(list(specs))
        return [f"/{name}{''.join(d)}" for name, _, d in batches[-1]]

    monkeypatch.setattr(cuda_build, "_loaded", {("flat_scan", ()): "flat"})
    monkeypatch.setattr(cuda_build, "build_all", build_all)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    got = cuda_build.load_all([cw.library(True), fs.LIBRARY,
                               adaptive_plan.LIBRARY, cw.library(True)])
    wide = "/cluster_walk" + cw.WIDE_DEFINE
    assert got == [wide, "flat", "/adaptive_plan", wide]
    assert batches == [[("cluster_walk", None, (cw.WIDE_DEFINE,)),
                        ("adaptive_plan", None, ())]]
    assert cuda_build.load(*adaptive_plan.LIBRARY) == "/adaptive_plan"
    assert cuda_build.load("cluster_walk", (cw.WIDE_DEFINE,)) == wide
    assert len(batches) == 1


@pytest.mark.parametrize("config, kernel, library", [
    ("cover", "cluster_walk", cw.library(False)),
    ("demo", "flat_scan", fs.LIBRARY)])
def test_adaptive_render_builds_the_replan_beside_its_kernel(
        monkeypatch, config, kernel, library):
    """An adaptive render on the card loads the re-plan's library in one
    batch with its kernel's, before its first launch; a fixed render asks
    for no library there (its kernel's loads at its first launch)."""
    from raytracer_tpu_torch.render import megakernel

    loaded = []

    class Loaded(Exception):
        pass

    def load_all(specs):
        loaded.append(list(specs))
        raise Loaded

    scene, cam, *_ = presets.get_config(config, 16, 8)
    dcam = derive_camera(cam)
    opts = options.TraceOptions(max_depth=4, adaptive_tolerance=0.2)
    choice = megakernel.choose_kernel(scene, dcam, opts, "cpu")
    assert choice.kernel == kernel and choice.library() == library
    monkeypatch.setattr(megakernel, "choose_kernel", lambda *a: choice)
    monkeypatch.setattr(cuda_build, "load_all", load_all)
    with pytest.raises(Loaded):
        megakernel.render_sums(scene, dcam, 16, 8, 200, rng.key_data(3),
                               opts, "cuda")
    assert loaded == [[library, adaptive_plan.LIBRARY]]
    fixed = dataclasses.replace(opts, adaptive_tolerance=0.0)
    # past the choice of libraries the fixed render allocates on the card,
    # which this build of torch refuses
    with pytest.raises((AssertionError, RuntimeError)):
        megakernel.render_sums(scene, dcam, 16, 8, 200, rng.key_data(3),
                               fixed, "cuda")
    assert len(loaded) == 1


def test_adaptive_plan_leaves_the_renderer_builds_alone(tmp_path,
                                                        monkeypatch):
    """The walk's and the flat scan's build keys hash no file of the
    re-plan: editing it rebuilds neither kernel, and it includes none of
    their headers."""
    assert not re.search(r'#\s*include\s+"', PLAN)
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    names = ("flat_scan", "cluster_walk", "adaptive_plan")
    before = {n: cuda_build.library_path(n) for n in names}
    with open(csrc / "adaptive_plan.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in names}
    assert after["flat_scan"] == before["flat_scan"]
    assert after["cluster_walk"] == before["cluster_walk"]
    assert after["adaptive_plan"] != before["adaptive_plan"]


def test_adaptive_plan_kernels_are_not_the_renderers():
    """The chain's kernels are counted as device work outside the renderer
    (``benchmark/readers.py`` matches the renderer by these names)."""
    names = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))? "
                       r"(\w+)\(", PLAN)
    assert names == ["accumulate_kernel", "sort_tiles", "merge_pass"]
    for name in names:
        assert "cluster_walk_kernel" not in name
        assert "flat_scan_kernel" not in name


@pytest.mark.parametrize("name, value", [
    ("kOneThird", 1.0 / 3.0), ("kZ975", 1.96), ("kMinChunks", 3.0)])
def test_adaptive_plan_constants_are_float32_roundings(name, value):
    """The convergence test's constants are the float32 roundings of
    ``plan_adaptive``'s Python doubles."""
    (lit,) = re.findall(rf"constexpr float {name} = (-?0x[0-9a-fA-F.]+"
                        r"p[-+]?\d+)f;", PLAN)
    assert float.fromhex(lit) == float(np.float32(value))


@pytest.mark.parametrize("banned", [
    "cbrtf", "fmaf", "__fmaf", "__fdividef", "__frsqrt_rn", "__fsqrt_rn",
    "rsqrtf", "__saturatef", "fminf", "fmaxf",
])
def test_adaptive_plan_rounds_as_plan_adaptive(banned):
    """Every product, quotient and root rounds on its own; the clamps and
    minimum let NaN through, as torch's do."""
    assert not re.search(rf"\b{re.escape(banned)}\s*\(", PLAN)
    assert "x != x ? x : (x < lo ? lo : x)" in PLAN
    assert ("const float mean = (((a[0] + a[1]) + a[2]) * kOneThird) / "
            "n_safe;") in PLAN
    assert "return nn >= c.min_n && ci <= c.tol * (mean + c.abs_floor);" \
        in PLAN


def test_adaptive_plan_interface_matches_the_wrapper():
    """The launcher's parameters, one by one, are the argument types that
    ``adaptive_plan.bind`` sets: a pointer, an int or a float."""
    sig = PLAN[PLAN.index('extern "C" int adaptive_plan_launch('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
             for p in params]
    assert all(p.split()[0] in ("int", "float") or "*" in p
               for p in params)

    class Lib:
        adaptive_plan_launch = types.SimpleNamespace(argtypes=None,
                                                     restype=None)

    fn = adaptive_plan.bind(Lib)
    assert fn.argtypes == kinds and len(kinds) == 24
    assert fn.restype is ctypes.c_int
