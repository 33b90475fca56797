"""The port's card probes (``raytracer_tpu_torch/scripts/``) against the
TPU microbenchmarks in ``scripts/``, whose Pallas kernels run here in
interpret mode, and the op account of ``utils/profiling.py``.

The scripts are not a package: each is loaded by path. Their kernels run
unedited: ``pallas_call`` is wrapped to add ``interpret=True``, the
script's ``np`` is a copy of numpy whose ``asarray`` also records what the
script reads back, and the module constants (``ITERS``, ``S``) are cut so
a run takes seconds. ``scripts/roofline.py`` fixes its chain's trip count
inside ``vpu_ceiling``; its ``jax`` is replaced by a namespace whose
``lax.fori_loop`` runs fewer trips.

Bounds, each set above a measurement (CPU, this test's inputs):

- the chains (P2, P3) and the gathers (P1, P1b): **bitwise** (measured
  equal at 4 and 300 trips, float32 and bf16, and at 7 gather trips);
- the scan (P4, 64 slots, 2 and 3 trips): XLA's CPU backend contracts the
  scan's products and sums into fused multiply-adds and torch's CPU
  ``sqrt`` is not correctly rounded on about 0.7 % of inputs (the kernel's
  ``sqrtf`` and the card's ``torch.sqrt`` are): measured 24.1-24.2 % of the
  outputs off, by at most 1.93e-4 relative. Bounds 35 % and 5e-4. Inside
  the port every block equals the 512-slot block bitwise.
"""

import importlib.util
import inspect
import pathlib
import re
import types

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas

import chip_smoke
from raytracer_tpu.utils import profiling as jax_profiling
from raytracer_tpu_torch.scripts import bench_bf16_chain as bc
from raytracer_tpu_torch.scripts import bench_scan_layout as bs
from raytracer_tpu_torch.scripts import probe_gather as pg
from raytracer_tpu_torch.scripts import roofline
from raytracer_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCAN_MAX_REL, SCAN_MAX_SHARE = 5e-4, 0.35


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def interpreted(mod, monkeypatch) -> list:
    """Runs ``mod``'s Pallas kernels in interpret mode; returns the list
    that collects every array the script reads back with np.asarray."""
    real = pallas.pallas_call
    monkeypatch.setattr(pallas, "pallas_call",
                        lambda *a, **k: real(*a, interpret=True, **k))
    seen = []
    fake = types.ModuleType("numpy")
    fake.__dict__.update(np.__dict__)

    def asarray(a, *args, **kw):
        got = np.asarray(a, *args, **kw)
        seen.append(got)
        return got

    fake.asarray = asarray
    monkeypatch.setattr(mod, "np", fake)
    return seen


# ---- P3 and P2: the chains ----

@pytest.mark.parametrize("iters", [4, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_matches_jax_kernel(dtype, iters, monkeypatch):
    """P3's kernel, called as the script builds it, against the port's
    chain on the CPU: bitwise."""
    mod = load_script("bench_bf16_vpu")
    monkeypatch.setattr(mod, "ITERS", iters)
    jd = getattr(jax.numpy, dtype)
    x = jax.numpy.full((bc.CHAINS, bc.TPU_ROWS, 128), bc.X_VALUE, jd)
    want = np.asarray(pallas.pallas_call(
        mod.make_kernel(jd),
        out_shape=jax.ShapeDtypeStruct((bc.TPU_ROWS, 128), jd),
        interpret=True)(x)).astype(np.float32)
    got = bc.chain(bc.chain_input(bc.TPU_ROWS, getattr(torch, dtype), "cpu"),
                   iters)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_roofline_ceiling_matches_jax_kernel(monkeypatch):
    """P2 (``vpu_ceiling``'s closure) at 5 trips against the port's float
    chain at the same rows: bitwise."""
    mod = load_script("roofline")
    seen = interpreted(mod, monkeypatch)
    iters = 5
    fake_jax = types.SimpleNamespace(
        jit=jax.jit, ShapeDtypeStruct=jax.ShapeDtypeStruct,
        lax=types.SimpleNamespace(
            fori_loop=lambda lo, hi, body, init: jax.lax.fori_loop(
                lo, iters, body, init)))
    monkeypatch.setattr(mod, "jax", fake_jax)
    mod.vpu_ceiling()
    assert len(seen) == 4  # warm + best of 3
    got = bc.chain(bc.chain_input(16, torch.float32, "cpu"), iters)
    for want in seen:
        np.testing.assert_array_equal(got.numpy(), want)


def test_chain_main_matches_jax_main(monkeypatch, capsys):
    """The whole probe: the script's main and the port's main at the
    same trips print one line per type and return the same arrays."""
    mod = load_script("bench_bf16_vpu")
    seen = interpreted(mod, monkeypatch)
    monkeypatch.setattr(mod, "ITERS", 6)
    mod.main()
    got = bc.main("cpu", iters=6, rows=(bc.TPU_ROWS,))
    lines = capsys.readouterr().out
    assert got["device"] == "cpu" and len(seen) == 8
    for want, dtype in zip(seen[::4], ("float32", "bfloat16")):
        out = got["rows"][bc.TPU_ROWS][dtype]["out"]
        np.testing.assert_array_equal(out.float().numpy(),
                                      want.astype(np.float32))
        assert f"{dtype} ({bc.TPU_ROWS},128): " in lines
    assert "element-throughput ratio" in lines


def test_bf16_chain_stops_at_256():
    """x rounds to 1.0 in bf16, so every chain counts up by one a step
    and 256 + 1 rounds back to 256: after 16 trips every sum is 8 x 256;
    float32 keeps growing."""
    x = bc.chain_input(2, torch.bfloat16, "cpu")
    assert float(x[0, 0, 0]) == 1.0
    assert bool((bc.chain(x, 16).float() == 2048.0).all())
    assert bool((bc.chain(x, 40).float() == 2048.0).all())
    f32 = bc.chain(bc.chain_input(2, torch.float32, "cpu"), 40)
    assert float(f32[0, 0]) > 2048.0 and bool((f32 == f32[0, 0]).all())


# ---- P1 and P1b: the gathers ----

@pytest.fixture(scope="module")
def jax_gathers():
    """The script's six runs at 7 trips, in interpret mode: each case's
    first read-back."""
    mod = load_script("probe_mosaic_gather")
    with pytest.MonkeyPatch.context() as mp:
        seen = interpreted(mod, mp)
        mp.setattr(mod, "ITERS", 7)
        mod.main()
    assert len(seen) == 4 * len(pg.CASES)
    return dict(zip((c[0] for c in pg.CASES), seen[::4]))


@pytest.mark.parametrize("case", pg.CASES, ids=[c[0] for c in pg.CASES])
def test_gather_matches_jax_kernel(case, jax_gathers):
    """Every case of P1 and P1b against the port's gather on the CPU, one
    replica and three: bitwise."""
    label, mode, shape, rows = case
    tbl = pg.gather_table(shape)
    for reps in (1, 3):
        got = pg.gather_probe(tbl, mode, rows, 7, reps)
        assert got.shape == (reps, rows, shape[1])
        for r in range(reps):
            np.testing.assert_array_equal(got[r].numpy(), jax_gathers[label])


@pytest.mark.parametrize("case", pg.CASES, ids=[c[0] for c in pg.CASES])
def test_library_gathers_what_the_kernel_gathers(case, jax_gathers):
    """``torch.gather``, the library call the probe is timed against,
    summed trip by trip over three replicas in one call a trip: bitwise
    the JAX kernel's sums and the plain version's."""
    label, mode, shape, rows = case
    tbl = pg.gather_table(shape)
    got = pg.library_sums(tbl, mode, rows, 7, 3)
    assert torch.equal(got, pg.gather_probe_plain(tbl, mode, rows, 7, 3))
    for r in range(3):
        np.testing.assert_array_equal(got[r].numpy(), jax_gathers[label])


def test_gather_main_matches_jax_main(jax_gathers):
    got = pg.main("cpu", iters=7, fill=False)
    assert got["device"] == "cpu"
    for label, *_ in pg.CASES:
        np.testing.assert_array_equal(got["cases"][label]["tpu"]["out"],
                                      jax_gathers[label])


def test_gather_modes_differ_off_lane_zero(jax_gathers):
    """``onehot_matmul`` gathers column 0 only: it equals
    ``take_along_axis`` in lane 0 and differs in every other lane."""
    take = jax_gathers["take_along_axis"]
    onehot = jax_gathers["onehot_matmul"]
    np.testing.assert_array_equal(take[:, 0], onehot[:, 0])
    assert bool((take[:, 1:] != onehot[:, 1:]).all())
    tbl = pg.gather_table((pg.S, 128))
    a = pg.gather_probe(tbl, "axis0", 8, 7)[0]
    b = pg.gather_probe(tbl, "onehot", 8, 7)[0]
    assert torch.equal(a[:, 0], b[:, 0]) and bool((a[:, 1:] != b[:, 1:]).all())


def test_bf16_split_reproduces_the_table_bitwise():
    """The one-hot product's B: column 0 of the script's table split into
    three bf16 pieces (each float32 with zero low 16 bits) whose sum
    ``(hi + mid) + lo`` is every value bit for bit."""
    col0 = pg.gather_table((pg.S, 128))[:, 0].contiguous()
    hi, mid, lo = pg.bf16_split(col0)
    for piece in (hi, mid, lo):
        assert bool(((piece.view(torch.int32) & 0xFFFF) == 0).all())
    assert torch.equal(((hi + mid) + lo).view(torch.int32),
                       col0.view(torch.int32))


def test_bf16_split_is_exact_on_its_domain():
    """The stated domain: zero and every normal float32 of magnitude at
    least 2^-103 (here 2^20 random bit patterns across it, both signs,
    and its edges), so that ``lo`` stays a normal bf16."""
    rs = np.random.RandomState(3)
    bits = rs.randint(0, 2**31 - 1, size=1 << 20, dtype=np.int64)
    x = bits.astype(np.uint32).view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) >= 2.0**-103)]
    edges = np.array([0.0, 2.0**-103, -(2.0**-103), 1.0, -1.0,
                      np.nextafter(np.float32(1), np.float32(0)),
                      np.finfo(np.float32).max, -np.finfo(np.float32).max],
                     np.float32)
    x = torch.from_numpy(np.concatenate([x * rs.choice([-1, 1], x.size)
                                         .astype(np.float32), edges]))
    hi, mid, lo = pg.bf16_split(x)
    assert bool(((lo.view(torch.int32) & 0xFFFF) == 0).all())
    assert torch.equal(((hi + mid) + lo).view(torch.int32),
                       x.view(torch.int32))


def test_mma_account_of_the_card_filling_case():
    """The one-hot product at 256 replicas of (8, 128) outputs, 5000
    trips, 16 k-tiles: 1.31e9 m16n8k16 MMAs, 5.4e12 flop (5.4 ms at the
    data sheet's dense bf16 989e12)."""
    got = pg.mma_account(pg.S, 8, 128, pg.ITERS, 256)
    assert got["mmas"] == 256 * (8 * 128 // 16) * pg.ITERS * 16
    assert got["flop"] == got["mmas"] * 4096
    assert got["flop"] / profiling.BF16_TC_PEAK * 1e3 == pytest.approx(
        5.43, abs=0.01)
    assert got["cuda_core_ops"] == got["mmas"] // 16 * 32 * (
        2 * pg.OPS_MMA_ROW + pg.OPS_MMA_TRIP)


def test_gather_refuses_what_the_kernel_cannot_hold():
    """A table above a block's shared memory, sides that are not powers of
    two, axis-1 rows the table lacks, too many replicas: refused on every
    device. A CPU tensor never reaches the kernel's launcher."""
    big = torch.zeros((512, 128))
    assert 4 * big.numel() > pg.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        pg.gather_probe(big, "axis0", 8, 1)
    largest = torch.zeros((256, 128))
    assert pg.gather_probe(largest, "axis0", 8, 1).shape == (1, 8, 128)
    with pytest.raises(ValueError, match="powers of two"):
        pg.gather_probe(torch.zeros((12, 128)), "axis0", 8, 1)
    with pytest.raises(ValueError, match="rows"):
        pg.gather_probe(torch.zeros((8, 128)), "axis1", 16, 1)
    with pytest.raises(ValueError, match="reps"):
        pg.gather_probe(largest, "axis0", 8, 1, pg.MAX_REPS + 1)
    with pytest.raises(ValueError, match="mode"):
        pg.gather_probe(largest, "axis2", 8, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pg._launch(largest, "axis0", 8, 1, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bc._launch(bc.chain_input(1, torch.float32, "cpu"), 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bs._launch(bs.scan_table(), 8, 1, 1)


# ---- P4: the scan ----

@pytest.fixture(scope="module")
def jax_scans():
    """The script's main at 64 slots and 3 trips (its blocks: 64, 64, 32,
    8), in interpret mode: each block's first read-back."""
    mod = load_script("bench_scan_layout")
    with pytest.MonkeyPatch.context() as mp:
        seen = interpreted(mod, mp)
        mp.setattr(mod, "S", 64)
        mp.setattr(mod, "ITERS", 3)
        mod.main()
    assert len(seen) == 16
    return seen[::4]


def test_scan_matches_jax_kernel(jax_scans):
    """Every block of P4 against the port's scan on the CPU, within the
    measured bounds; the port's blocks equal each other bitwise."""
    sph = bs.scan_table(64)
    got = [bs.scan_probe(sph, block, bs.R_SUB, 3) for block in (64, 32, 8)]
    for g in got[1:]:
        assert torch.equal(g, got[0])
    mine = got[0].numpy()
    for want in jax_scans:
        assert np.isfinite(want).all() and np.isfinite(mine).all()
        rel = np.abs(mine - want) / np.abs(want)
        assert rel.max() <= SCAN_MAX_REL
        assert (mine != want).mean() <= SCAN_MAX_SHARE


def test_scan_main_matches_jax_main(jax_scans):
    got = bs.main("cpu", iters=3, slots=64, fill=False)
    assert [b["block"] for b in got["blocks"].values()] == [64, 64, 32, 8]
    for b, want in zip(got["blocks"].values(), jax_scans):
        rel = np.abs(b["tpu"]["out"].numpy() - want) / np.abs(want)
        assert rel.max() <= SCAN_MAX_REL


def test_scan_blocks_agree_at_512_slots():
    """The four instantiations' blocks at the script's 512 slots and at
    more rows: bitwise equal (a minimum is exact)."""
    sph = bs.scan_table()
    got = [bs.scan_probe(sph, block, 16, 2) for block in bs.BLOCKS]
    assert all(torch.equal(got[0], g) for g in got[1:])
    assert got[0].shape == (16, 128) and bool(torch.isfinite(got[0]).all())


def test_scan_refuses_a_table_the_block_does_not_divide():
    with pytest.raises(ValueError, match="multiple of the block"):
        bs.scan_probe(bs.scan_table(60), 8, 8, 1)
    with pytest.raises(ValueError, match="at most"):
        bs.scan_probe(bs.scan_table(bs.MAX_SLOTS + 8), 8, 8, 1)
    with pytest.raises(ValueError, match="block"):
        bs.scan_probe(bs.scan_table(), 16, 8, 1)


def test_scan_constants_are_the_scripts():
    """The kernel's hex constants are the float32 roundings of the
    script's literals, and the arithmetic order is the script's."""
    src = (ROOT / "raytracer_tpu_torch" / "csrc" / "probe_scan.cu").read_text()
    found = dict(re.findall(
        r"constexpr float (k\w+) = (-?0x[0-9a-fA-F.]+p[-+]?\d+)f;", src))
    want = {"kFillQ": 3e38, "kNegBig": -3e38, "kMinT": bs.MIN_T,
            "kStep": 1e-12, "kLaneX": 0.01, "kTenth": 0.1, "kDirX": 0.3,
            "kDirY": -0.05, "kDirZ": 0.07}
    assert set(found) == set(want)
    for name, value in want.items():
        assert float.fromhex(found[name]) == float(np.float32(value)), name
    script = (ROOT / "scripts" / "bench_scan_layout.py").read_text()
    for line in ("c_coef = ooo_r - 2.0 * c_dot_o + s_k1",
                 "disc = nb * nb - a[row : row + 1] * c_coef",
                 "MIN_T = 0.001"):
        assert line in script
    assert "const float c_coef = r.ooo - 2.0f * c_dot_o + c.w;" in src
    assert "const float disc = nb * nb - r.a * c_coef;" in src


# ---- the roofline and the op account ----

def test_roofline_account_on_the_cpu():
    """The roofline's JSON at a tiny cover render: its operations are the
    module's formula over the render's own segments and samples."""
    w, h, spp = 16, 8, 2
    got = roofline.main("cpu", width=w, height=h, spp=spp, depth=3,
                        chain_rows=1, chain_iters=2)
    assert got["device"] == "cpu" and got["issue_line_telops"] is None
    assert (got["slots"], got["s_pad"], got["g_full"]) == (487, 488, 184)
    assert got["scan_ops_per_segment"] == (
        profiling.OPS_FLAT_TRIP + 487 * profiling.OPS_SLOT_DISC)
    segs = got["segments"]
    assert got["ops"] == profiling.flat_ops(487, 184, False, False, segs,
                                            w * h * spp)
    assert got["ops_per_segment"] == got["ops"] / segs
    useful = got["ops"] / got["cover_wall_s"]
    assert got["useful_telops"] == useful / 1e12
    assert got["share_of_flop_peak"] == useful / profiling.FP32_FLOP_PEAK
    assert got["cover_mrays"] == segs / got["cover_wall_s"] / 1e6


def test_roofline_needs_a_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        roofline.main()
    for main in (bc.main, pg.main, bs.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main()


def _old_flat_ops(slots, g_full, adaptive, stratified, nsegs, samples,
                  debug):
    """``chip_smoke.flat_bound``'s operations, written out: a slot's
    discriminant on every slot and its root logic on none (the account's
    one form since the scan's early rejection)."""
    split = g_full is not None and g_full < slots
    return (nsegs * (23 + 18 * slots + 150
                     + (5 if adaptive else 0))
            + (nsegs - samples) * ((25 if split else 0) + (22 if debug else 0))
            + samples * (90 + ((4 - 26) if stratified else 0)))


@pytest.mark.parametrize("g_full", [None, 184, 487, 600])
@pytest.mark.parametrize("adaptive, stratified, debug", [
    (False, False, False), (True, True, False), (False, True, True)])
def test_flat_account_unchanged_by_the_move(g_full, adaptive, stratified,
                                            debug):
    tabs = types.SimpleNamespace(camera=torch.zeros(19),
                                 spheres=torch.zeros((487, 12)))
    nsegs, samples, lanes = 123457, 40000, 9600
    ops_ms, bytes_ms = profiling.flat_bound(tabs, g_full, adaptive,
                                            stratified, lanes, nsegs,
                                            samples, debug)
    want = _old_flat_ops(487, g_full, adaptive, stratified, nsegs, samples,
                         debug)
    assert ops_ms == want / 67e12 * 1e3
    rows = 6 if adaptive else 4
    assert bytes_ms == ((19 + 487 * 12) * 4 + lanes * 4 * (
        2 + (1 if adaptive else 0) + rows + 1)) / 3.35e12 * 1e3


def test_walk_account_unchanged_by_the_move():
    tabs = types.SimpleNamespace(
        camera=torch.zeros(19), globals=torch.zeros((3, 4)),
        bounds=torch.zeros((2, 6, 8)), members=torch.zeros((5, 8, 4)),
        winner=torch.zeros((43, 11)))
    iters, nsegs, samples = 1000.0, 300, 100
    ops_ms, _ = profiling.walk_bound(tabs, True, True, 64, iters, nsegs,
                                     samples, True)
    want = (iters * (40 + 37 * 5) + (iters - nsegs) * 30 * 8
            + nsegs * (150 + 30 * 3 + 5) + (nsegs - samples) * 22
            + samples * (90 + 4 - 26))
    assert ops_ms == want / 67e12 * 1e3


def _h100_lines(monkeypatch):
    """``profiling.card_lines`` on an H100 SXM as its machine reports it:
    132 SMs, ``clocks.max.sm`` 1980 MHz."""
    calls = []

    def smi(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout="1980\n")

    monkeypatch.setattr(profiling.subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            multi_processor_count=132))
    profiling.card_lines.cache_clear()
    lines = profiling.card_lines()
    assert profiling.card_lines() is lines and len(calls) == 1
    assert "--query-gpu=clocks.max.sm" in calls[0]
    profiling.card_lines.cache_clear()
    return lines


def test_chip_smoke_reads_the_one_account(monkeypatch):
    """chip_smoke.py imports the account and defines no operation count or
    rate of its own; the issue line is read from the card (SMs x 128 x
    the highest clock), half the data sheet's FMA-counted rate on an H100
    within the clock's rounding."""
    assert chip_smoke.walk_bound is profiling.walk_bound
    assert chip_smoke.flat_bound is profiling.flat_bound
    assert chip_smoke.card_lines is profiling.card_lines
    src = inspect.getsource(chip_smoke)
    assert not re.search(r"^(OPS_\w+|FP32_\w+|HBM_RATE)\b.*=", src, re.M)
    lines = _h100_lines(monkeypatch)
    assert lines["fp32"] == 132 * 128 * 1980e6
    assert lines["bf16"] == 2 * lines["fp32"]
    assert lines["smem_words"] == 132 * 32 * 1980e6
    assert abs(lines["fp32"] / (profiling.FP32_FLOP_PEAK / 2) - 1) < 0.002
    pair = (2.0, 0.5)
    assert profiling.issue_bound_ms(pair, lines["fp32"]) == (
        2.0 * profiling.FP32_FLOP_PEAK / lines["fp32"])


def test_probe_bound_names_the_resource_that_limits(monkeypatch):
    """A card-filling gather (2^24 elements, 5000 trips) is bound by the
    SMs' shared-memory words, not by its 3 index operations a trip; the
    scan by its operations. ``bound_ms`` stays the data sheet's."""
    lines = _h100_lines(monkeypatch)
    monkeypatch.setattr(chip_smoke, "card_lines", lambda: lines)
    n = (1 << 24) * 5000
    got = chip_smoke.probe_bound(3 * n, 4 * (1 << 24), 67e12, lines["fp32"],
                                 n)
    assert got["issue_bound_by"] == "smem"
    assert got["issue_bound_ms"] == got["smem_bound_ms"] == (
        n / lines["smem_words"] * 1e3)
    assert abs(got["issue_bound_ms"] - 10.03) < 0.01
    assert got["issue_ops_ms"] == 3 * n / lines["fp32"] * 1e3
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == 3 * n / 67e12 * 1e3
    rays = 1056 * 128 * 400
    scan = chip_smoke.probe_bound(bs.probe_ops(512, 1056, 400), 0.0, 67e12,
                                  lines["fp32"], 512 * rays)
    assert scan["issue_bound_by"] == "operations"
    assert scan["smem_bound_ms"] < scan["issue_bound_ms"] / 6


def test_best_seconds_times_a_window_of_calls_on_a_card(monkeypatch):
    """On a card a short call is timed in a window of back-to-back calls
    at least ``MIN_WINDOW_S`` long, the number set by one timed call; a
    long call is timed alone."""
    for single, calls in ((0.0003, 34), (0.04, 1)):
        seen = []

        def events(fn, n, device):
            seen.append(n)
            return (single if n == 1 else single * 0.9), fn()

        monkeypatch.setattr(profiling, "_events_seconds", events)
        best, got = profiling.best_seconds(lambda: 7, torch.device("cuda"))
        assert seen == [1] + [calls] * 3 and got == 7
        assert best == (single if calls == 1 else single * 0.9)


def test_meter_matches_the_jax_package():
    assert profiling.mrays_per_sec(5e6, 2.0) == jax_profiling.mrays_per_sec(
        5e6, 2.0)
    assert profiling.mrays_per_sec(1.0, 0.0) == 0.0
    meter = profiling.MraysMeter()
    with pytest.raises(ZeroDivisionError):
        with meter.time():
            1 / 0
    assert meter.seconds > 0.0
    meter.add_segments(3e6)
    assert meter.mrays == 3e6 / meter.seconds / 1e6


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(None):
        pass
    assert not list(tmp_path.iterdir())
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_best_seconds_returns_the_last_result():
    calls = []
    best, got = profiling.best_seconds(
        lambda: calls.append(1) or len(calls), torch.device("cpu"), 3)
    assert got == 4 and len(calls) == 4 and best >= 0.0


# ---- the probe A/B's compiler reports ----

def sass_line(addr: int, text: str) -> str:
    return f"        /*{addr:04x}*/                   {text} ;"


def test_probe_ab_counts_the_scan_loop_per_slot_and_ray():
    """The slot loop is the smallest loop holding a root (``MUFU.RSQ``);
    its instructions are counted per root, a slot and ray."""
    from raytracer_tpu_torch.scripts import probe_ab, walk_ab

    body = ["LDS.128 R4, [R2]", "FMUL R6, R4, R8", "FADD R6, R6, R9",
            "MUFU.RSQ R7, R6", "FMNMX R10, R10, R7, PT",
            "MUFU.RSQ R7, R6", "FMNMX R11, R11, R7, PT",
            "ISETP.NE.AND P0, PT, R3, RZ, PT", "@P0 BRA 0x20"]
    lines = [sass_line(0x10, "MOV R1, c[0x0][0x28]")]
    lines += [sass_line(0x20 + 0x10 * j, t) for j, t in enumerate(body)]
    lines += [sass_line(0x20 + 0x10 * len(body), "STL [R1], R4"),
              sass_line(0x30 + 0x10 * len(body), "BRA 0x10"),
              sass_line(0x40 + 0x10 * len(body), "EXIT")]
    insns = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in
             map(walk_ab._SASS_INSN.search, lines) if m]
    got = probe_ab.scan_sass(insns)
    assert got["slot_rays"] == 2 and got["loop_insns"] == len(body)
    assert got["per_slot_ray"] == len(body) / 2
    assert got["by_opcode"]["MUFU.RSQ"] == 1.0
    assert got["by_opcode"]["FMNMX"] == 1.0 and got["local"] == 1
    hmma = [(0x10 * j, "HMMA.16816.F32.BF16", " R4, R8, R12, R4")
            for j in range(3)] + [(0x30, "BRA", " 0x0")]
    assert probe_ab.onehot_sass(hmma)["hmma"] == 3
    assert probe_ab.onehot_sass(hmma)["by_class"]["hmma"] == 3


def test_probe_ab_reads_ptxas_per_instantiation():
    """Registers and spill bytes per kernel instantiation; a device
    function's own report is not its caller's."""
    from raytracer_tpu_torch.scripts import probe_ab

    scan = "_ZN12_GLOBAL__N_111scan_kernelILi512EEEvPK6float4Pfiii"
    mma = "_ZN12_GLOBAL__N_117onehot_mma_kernelILi16EEEvPKfPfiiii"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{scan}' for 'sm_90a'",
        f"ptxas info    : Function properties for {scan}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 380 bytes cmem[0]",
        "ptxas info    : Function properties for __internal_sqrt",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        f"ptxas info    : Compiling entry function '{mma}' for 'sm_90a'",
        f"ptxas info    : Function properties for {mma}",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 64 registers, 380 bytes cmem[0]"])
    assert probe_ab.ptxas(log) == {
        "scan_kernel<512>": {"spill_bytes": 0, "registers": 40},
        "onehot_mma_kernel<16>": {"spill_bytes": 16, "registers": 64}}
    assert probe_ab.instantiation("_Z3foov") is None


def test_probe_ab_builds_the_base_revision(tmp_path):
    """The base revision's two probes, as ``cuda_build.build_all`` takes
    them; without a base, nothing besides the kernels' own builds."""
    from raytracer_tpu_torch.scripts import probe_ab

    assert probe_ab.extra_builds(tmp_path) == [
        ("probe_scan", tmp_path, ()), ("probe_gather", tmp_path, ())]
    assert probe_ab.extra_builds(None) == []
