"""The adaptive render's host side against the JAX package
(``pk._plan_adaptive``, ``pk._finalize_adaptive``, the adaptive schedule
of ``pk._render_pallas``) on a seeded state carried across by
``adaptive_state_from_numpy``, and the port's adaptive render on its own
(the counterparts of ``tests/test_adaptive.py`` on the cover, which is
the scene the port serves)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu_torch import adaptive_state_from_numpy
from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.render import adaptive_plan, api, megakernel, schedule
from raytracer_tpu_torch.render.options import TraceOptions
from raytracer_tpu_torch.render.rng import key_data
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scripts import walk_ab

# a frame that is padded in both directions in the JAX package's pixel
# space: rows of 256, and 40 rows are whole 8-row tiles
PW, PH, R_SUB = 200, 40, 8
WP = 256
CS, TOL = 31, 0.2


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_state(seed: int = 0):
    """A padded (6, Hp·Wp) accumulator and (3, Hp·Wp) chunk statistics
    from a numpy seed: sample counts on both sides of ADAPTIVE_MIN_N,
    interval-to-threshold ratios log-uniform in [1/4, 4] around the
    decision, integer costs with ties, padding all zero."""
    r = np.random.default_rng(seed)
    shape = (PH, PW)
    n = r.integers(20, 200, shape).astype(np.float32)
    mean = r.random(shape).astype(np.float32)
    thr = TOL * (mean + 0.02)
    sd = thr * np.sqrt(n) / 1.96 * np.exp(r.uniform(-1.4, 1.4, shape))
    split = r.dirichlet((1.0, 1.0, 1.0), shape).astype(np.float32)
    rgb = [3.0 * n * mean * split[..., c] for c in range(3)]
    cost = r.integers(50, 400, shape).astype(np.float32)
    lum2 = n * (sd * sd + mean * mean)
    n_c = r.integers(0, 21, shape).astype(np.float32)
    m_mean = mean * (1.0 + 0.01 * r.standard_normal(shape))
    m_sd = thr * np.sqrt(np.maximum(n_c, 1.0)) / 2.2 * np.exp(
        r.uniform(-1.4, 1.4, shape))
    cstats = [n_c, n_c * m_mean, n_c * (m_sd * m_sd + m_mean * m_mean)]

    def pad(planes):
        full = np.zeros((len(planes), PH, WP), np.float32)
        full[:, :, :PW] = np.stack(planes)
        return full.reshape(len(planes), -1)

    return pad(rgb + [cost, n, lum2]), pad(cstats)


def jax_plan(acc, cstats):
    """``pk._plan_adaptive`` reduced to real pixels: the pixel sequence
    in lane order and the per-pixel budget."""
    _, pm = pk._plan_adaptive(
        jnp.asarray(acc), PW, R_SUB, 1, CS, TOL,
        chunk_stats=None if cstats is None else jnp.asarray(cstats),
    )
    ipx, ipy, bud = np.asarray(pm).transpose(1, 0, 2, 3, 4).reshape(3, -1)
    real = (ipx < PW) & (ipy < PH)
    seq = (ipy * PW + ipx)[real]
    budget = np.empty(PW * PH, np.int32)
    budget[seq] = bud[real]
    return seq, budget


@pytest.mark.parametrize("with_chunk_stats", [False, True],
                         ids=["per_sample_ci", "chunk_mean_ci"])
def test_plan_adaptive_matches(with_chunk_stats):
    """Budgets agree on every pixel but those whose interval sits within
    float32 rounding of the threshold (XLA fuses the variance into FMAs):
    measured 0 of 8000 pixels differ on this state, bound 0.2 %. Where
    the budgets agree, the lane order is the same: unconverged pixels in
    descending cost, ties and converged pixels in pixel order."""
    acc_np, cs_np = seeded_state()
    if not with_chunk_stats:
        cs_np = None
    seq_j, bud_j = jax_plan(acc_np, cs_np)
    acc, cstats = adaptive_state_from_numpy(acc_np, PW, PH, cs_np)
    assert acc.shape == (6, PW * PH)
    inv, pmap, budget = adaptive_plan.plan_adaptive(acc, PW, CS, TOL, cstats)
    assert pmap.dtype == torch.int32 and budget.dtype == torch.int32
    seq_p = (pmap[:, 1].to(torch.int64) * PW + pmap[:, 0]).numpy()
    bud_p = np.empty(PW * PH, np.int32)
    bud_p[seq_p] = budget.numpy()
    assert set(np.unique(bud_p)) == {0, CS}
    # both decisions occur, and the chunk statistics change some
    assert 0.2 < (bud_p == 0).mean() < 0.8
    differ = bud_p != bud_j
    assert differ.mean() <= 0.002, differ.sum()
    keep_j = seq_j[~differ[seq_j]]
    keep_p = seq_p[~differ[seq_p]]
    np.testing.assert_array_equal(keep_p, keep_j)
    # inv takes lane-order sums back to pixel order
    assert torch.equal(torch.from_numpy(seq_p)[inv],
                       torch.arange(PW * PH))
    # converged pixels sort last
    assert (np.diff((budget.numpy() == 0).astype(np.int8)) >= 0).all()


def test_chunk_stats_change_the_decision():
    acc_np, cs_np = seeded_state()
    acc, cstats = adaptive_state_from_numpy(acc_np, PW, PH, cs_np)
    _, _, without = adaptive_plan.plan_adaptive(acc, PW, CS, TOL)
    _, _, with_cs = adaptive_plan.plan_adaptive(acc, PW, CS, TOL, cstats)
    # the smaller of two intervals can only converge more pixels
    assert int((with_cs == 0).sum()) > int((without == 0).sum())


def test_chunk_mean_ci_sees_stratification():
    """Pixels whose per-sample interval fails the tolerance converge once
    at least three chunk means are tight; two chunks form no interval."""
    p, cs, mean = 1024, 8, 0.5
    n = torch.full((p,), float(schedule.ADAPTIVE_MIN_N))
    acc = torch.stack([n * mean, n * mean, n * mean, torch.ones(p), n,
                       n * (mean * mean + 0.25)])

    def total_budget(n_c):
        stats = None if n_c is None else torch.stack([
            torch.full((p,), float(n_c)),
            torch.full((p,), n_c * mean),
            torch.full((p,), n_c * mean * mean + 1e-9),
        ])
        budget = adaptive_plan.plan_adaptive(acc, 128, cs, 0.05, stats)[2]
        return int(budget.sum())

    assert total_budget(None) == cs * p
    assert total_budget(8) == 0
    assert total_budget(2) == cs * p
    assert total_budget(40) == 0  # past the table: its last entry holds


@pytest.mark.parametrize("gamma", [False, True])
def test_finalize_adaptive_matches(gamma):
    """Every pixel divides by its own count. Without gamma the image is
    exact (one IEEE division); with gamma within 1 ulp (the two
    libraries' sqrt differ on 0.7 % of inputs). The sample map is exact
    and the mean spp agrees to float32 rounding of the JAX side's sum."""
    acc_np, _ = seeded_state(3)
    acc_np[4, :7] = 0.0  # pixels without a sample divide by 1
    ref, ref_mean, ref_map = pk._finalize_adaptive(
        jnp.asarray(acc_np), PW, PH, gamma, R_SUB, 1)
    acc, _ = adaptive_state_from_numpy(acc_np, PW, PH)
    img, spp_map = megakernel.finalize_adaptive(acc, PW, PH, gamma)
    assert img.shape == (PH, PW, 3) and spp_map.shape == (PH, PW)
    np.testing.assert_array_equal(spp_map.numpy(), np.asarray(ref_map))
    if gamma:
        np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=1.2e-7,
                                   atol=0)
    else:
        np.testing.assert_array_equal(img.numpy(), np.asarray(ref))
    assert float(spp_map.mean(dtype=torch.float64)) == pytest.approx(
        float(ref_mean), rel=1e-6)


def test_adaptive_constants_match():
    assert schedule.ADAPTIVE_MIN_N == pk.ADAPTIVE_MIN_N == 64
    assert schedule.ADAPTIVE_AUTO_CHUNK == pk.ADAPTIVE_AUTO_CHUNK == 16
    assert schedule.ADAPTIVE_ABS_FLOOR == pk.ADAPTIVE_ABS_FLOOR == 0.02
    np.testing.assert_array_equal(
        np.asarray(schedule.T975_BY_CHUNKS, np.float32), pk._T975_BY_CHUNKS)


def test_cover_adaptive_schedule():
    """The cover at 500 spp: 17 launches, a 4-spp profile chunk and
    sixteen 31-spp chunks, so 66 samples are the first possible stop."""
    chunk = schedule.pick_chunk_spp(500, 1200 * 800, 487, 50, 5)
    assert chunk == pk._pick_chunk_spp(500, 1200 * 800, 487, 50, 5) == 85
    sizes = schedule.adaptive_schedule(500, chunk, 0, True)
    assert sizes == [4] + [31] * 16
    assert sizes == pk._chunk_schedule(500, min(chunk, 16))[0]
    # the override, capped by the fixed render's chunk
    assert schedule.adaptive_schedule(500, chunk, 24, True) == \
        pk._chunk_schedule(500, 24)[0]
    assert schedule.adaptive_schedule(500, chunk, 999, True) == \
        pk._chunk_schedule(500, chunk)[0]
    # nothing to gate: one chunk, unsorted pixels, an irregular schedule
    assert schedule.adaptive_schedule(16, chunk, 0, True) is None
    assert schedule.adaptive_schedule(500, chunk, 0, False) is None
    assert pk._chunk_schedule(8, 3) == ([1, 6, 1], False)
    assert schedule.adaptive_schedule(8, 3, 0, True) is None


# --- the port's adaptive render on its own ----------------------------------

W, H, SPP = 64, 32, 27


@pytest.fixture
def forced_chunks(monkeypatch):
    """A multi-chunk schedule at test size, and pixels that may converge
    at test spp (production MIN_N is 64)."""
    monkeypatch.setattr(schedule, "pick_chunk_spp",
                        lambda spp, *a, **k: min(spp, 3))
    monkeypatch.setattr(schedule, "ADAPTIVE_MIN_N", 4)


def render(opts, spp=SPP, seed=0):
    scene, cam, *_ = presets.get_config("cover", W, H)
    return api.render_image(scene, cam, W, H, spp, seed, opts,
                            return_stats=True, device="cpu")


def options(**kw):
    return TraceOptions(max_depth=6, russian_roulette_depth=3, **kw)


def test_adaptive_converges_and_saves_samples(forced_chunks):
    img_a, stats = render(options(adaptive_tolerance=0.1))
    assert img_a.shape == (H, W, 3) and torch.isfinite(img_a).all()
    assert 3.0 <= stats["mean_spp"] < SPP
    assert isinstance(stats["mean_spp"], float)
    img_f, stats_f = render(options())
    assert "mean_spp" not in stats_f and "spp_map" not in stats_f
    assert stats["segments_exact"] < stats_f["segments_exact"]
    # quality: the fixed render within Monte Carlo noise plus tolerance
    assert float((img_a - img_f).abs().mean()) < 0.04


def test_adaptive_deterministic(forced_chunks):
    a, sa = render(options(adaptive_tolerance=0.1))
    b, sb = render(options(adaptive_tolerance=0.1))
    assert torch.equal(a, b)
    assert torch.equal(sa["spp_map"], sb["spp_map"])
    assert sa["segments_exact"] == sb["segments_exact"]
    assert sa["mean_spp"] == sb["mean_spp"]


def test_adaptive_tighter_tolerance_more_samples(forced_chunks):
    loose = render(options(adaptive_tolerance=0.3))[1]["mean_spp"]
    tight = render(options(adaptive_tolerance=0.01))[1]["mean_spp"]
    assert tight > loose


def test_adaptive_stratified(forced_chunks):
    opts = options(adaptive_tolerance=0.1, sampler="stratified")
    img_a, stats = render(opts)
    assert torch.isfinite(img_a).all()
    assert 3.0 <= stats["mean_spp"] < SPP
    img_b, _ = render(opts)
    assert torch.equal(img_a, img_b)
    # against the fixed render of the same sampler the residual is the
    # early stop alone
    img_f, _ = render(options(sampler="stratified"))
    assert float((img_a - img_f).abs().mean()) < 0.04
    # the chunk-mean interval stops pixels that the per-sample one keeps
    rand = render(options(adaptive_tolerance=0.1))[1]
    assert not torch.equal(stats["spp_map"], rand["spp_map"])


def test_adaptive_spp_map(forced_chunks):
    _, stats = render(options(adaptive_tolerance=0.1))
    m = stats["spp_map"]
    assert m.shape == (H, W) and m.dtype == torch.float32
    assert torch.equal(m, m.round())
    sizes = schedule.adaptive_schedule(SPP, 3, 0, True)
    # a pixel stops only between chunks, never before MIN_N samples
    stops = set(np.cumsum(sizes).tolist())
    assert set(m.unique().tolist()) <= stops
    assert float(m.min()) >= 4.0 and float(m.max()) <= SPP
    assert stats["mean_spp"] == pytest.approx(float(m.mean()), rel=1e-6)
    assert float(m.min()) < float(m.max())


def test_adaptive_chunk_override(forced_chunks, monkeypatch):
    """``adaptive_chunk_spp`` replaces the automatic chunk cap and is
    itself capped by the fixed render's chunk (3 here)."""
    caps = []
    real = schedule.chunk_schedule

    def spy(spp, chunk):
        caps.append(chunk)
        return real(spp, chunk)

    monkeypatch.setattr(schedule, "chunk_schedule", spy)
    img, stats = render(options(adaptive_tolerance=0.1,
                                adaptive_chunk_spp=2))
    assert torch.isfinite(img).all() and 2.0 <= stats["mean_spp"] < SPP
    _, capped = render(options(adaptive_tolerance=0.1,
                               adaptive_chunk_spp=999))
    _, auto = render(options(adaptive_tolerance=0.1))
    assert caps == [2, 3, 3]
    assert torch.equal(capped["spp_map"], auto["spp_map"])


@pytest.mark.parametrize("case", ["single_chunk", "unsorted"])
def test_adaptive_strips_to_the_fixed_render(forced_chunks, case):
    """Where no later chunk can be gated the tolerance is dropped: the
    image and segments are bitwise the fixed render's and the stats carry
    no ``mean_spp``."""
    kw = {"sort_pixels": False} if case == "unsorted" else {}
    spp = 3 if case == "single_chunk" else SPP
    for sampler in ("random", "stratified"):
        a, sa = render(options(adaptive_tolerance=0.1, sampler=sampler,
                               **kw), spp=spp)
        f, sf = render(options(sampler=sampler, **kw), spp=spp)
        assert "mean_spp" not in sa and "spp_map" not in sa
        assert torch.equal(a, f) and sa == sf


def test_adaptive_sorted_plan_is_placement_only(forced_chunks, monkeypatch):
    """The plan only places pixels on lanes: an adaptive render whose
    re-plans keep every budget but place the live pixels, and the newly
    converged ones, in the reverse of their sorted order is bitwise the
    sorted one."""
    opts = options(adaptive_tolerance=0.1, sampler="stratified")
    a, sa = render(opts)
    real = adaptive_plan.plan_adaptive
    placed = []

    def reversed_plan(acc, width, cs, tol, chunk_stats=None, t975=None):
        inv, pmap, budget = real(acc, width, cs, tol, chunk_stats, t975)
        n, live = len(budget), int((budget > 0).sum())
        placed.append((n, live))
        flip = torch.cat([torch.arange(live).flip(0),
                          torch.arange(live, n).flip(0)])
        return torch.argsort(flip)[inv], pmap[flip], budget[flip]

    monkeypatch.setattr(adaptive_plan, "plan_adaptive", reversed_plan)
    b, sb = render(opts)
    assert len(placed) == len(schedule.adaptive_schedule(SPP, 3, 0, True)) - 1
    assert placed[0] == (W * H, W * H) and 0 < placed[-1][1] < placed[-1][0]
    assert torch.equal(a, b) and torch.equal(sa["spp_map"], sb["spp_map"])
    assert sa["segments_exact"] == sb["segments_exact"]


def test_stratified_fixed_render_sorted_equals_unsorted(forced_chunks):
    opts = options(sampler="stratified")
    a, sa = render(opts, spp=7)
    b, sb = render(dataclasses.replace(opts, sort_pixels=False), spp=7)
    assert torch.equal(a, b) and sa == sb
    r, _ = render(options(), spp=7)
    assert not torch.equal(a, r)


# --- the re-plan over the live lanes (render/adaptive_plan.py) -------------


def parent_replan(acc, cstats, order, out, segs, cs, tol):
    """The full-width re-plan after one chunk, as the render made it before
    it read only the live lanes: ``accumulate_sorted``, ``chunk_mean_stats``
    and ``plan_adaptive`` over every pixel. Returns ``(acc, cstats,
    segments, pixel_map, budget)``."""
    inv = torch.argsort(order.to(torch.int64))
    lsum_prev, n_prev = acc[0] + acc[1] + acc[2], acc[4]
    acc, segments = megakernel.accumulate_sorted(
        out, segs, acc, torch.zeros((), dtype=torch.int64), inv)
    if cstats is not None:
        cstats = adaptive_plan.chunk_mean_stats(cstats, acc, lsum_prev, n_prev)
    _, pixel_map, budget = adaptive_plan.plan_adaptive(acc, PW, cs, tol, cstats)
    return acc, cstats, segments, pixel_map, budget


REPLAN_CASES = {
    # case: (sampler, tolerance)
    "random": ("random", TOL),
    "stratified": ("stratified", TOL),
    "ties": ("random", TOL),
    "all_live": ("stratified", 1e-9),
    "all_converge": ("stratified", 1e9),
    "none_live": ("random", 1e9),
}


def replan_state(case):
    """A seeded state before a re-plan: the accumulator and chunk
    statistics of ``seeded_state``, the previous plan (its unconverged
    pixels on lanes [0, L) in a seeded order, the converged ones after
    them) and the chunk's lane-order sums (zeros past L)."""
    sampler, tol = REPLAN_CASES[case]
    acc_np, cs_np = seeded_state()
    acc, cstats = adaptive_state_from_numpy(acc_np, PW, PH, cs_np)
    if sampler == "random":
        cstats = None
    n = acc.shape[1]
    if case == "none_live":
        acc[4] += schedule.ADAPTIVE_MIN_N
    if case == "all_converge":
        # one sample short of the minimum: every pixel live, until this
        # chunk's samples
        acc[4] = schedule.ADAPTIVE_MIN_N - 1.0
    if case == "ties":
        acc[3] = 100.0
    inv, _, budget = adaptive_plan.plan_adaptive(acc, PW, CS, tol, cstats)
    before = budget[inv] == 0
    g = torch.Generator().manual_seed(7)
    live = torch.nonzero(~before).flatten()
    done = torch.nonzero(before).flatten()
    order = torch.cat([live[torch.randperm(len(live), generator=g)],
                       done[torch.randperm(len(done), generator=g)]])
    lanes = len(live)
    on = (torch.arange(n) < lanes).to(torch.float32)
    mean = torch.rand(n, generator=g)
    cost = (torch.full((n,), 7.0) if case == "ties"
            else torch.randint(1, 40, (n,), generator=g).to(torch.float32))
    out = torch.stack([CS * mean * 0.9, CS * mean * 1.1, CS * mean,
                       CS * cost, torch.full((n,), float(CS)),
                       CS * (mean * mean + 0.01 * torch.rand(n, generator=g))])
    out = (out * on).contiguous()
    segs = (torch.randint(1, 500, (n,), generator=g, dtype=torch.int32)
            * on.to(torch.int32))
    return (acc, cstats, order.to(torch.int32), lanes, out, segs, sampler,
            tol)


def plain_replan(acc, cstats, order, lanes, out, segs, sampler, tol):
    """``adaptive_plan.PlainPlan`` set to the previous plan, stepped once."""
    plans = adaptive_plan.PlainPlan(acc.clone(), PW, tol,
                                    sampler == "stratified")
    if cstats is not None:
        plans.stats = cstats.clone()
    plans.order = order.clone()
    o = order.to(torch.int64)
    plans.pixel_map = torch.stack([o % PW, o // PW], 1).to(torch.int32)
    plans.budget = torch.where(torch.arange(len(order)) < lanes, CS,
                               0).to(torch.int32)
    plans.live = lanes
    plans.step(out, segs, CS)
    return plans


@pytest.mark.parametrize("case", list(REPLAN_CASES))
def test_live_replan_matches_the_full_width_replan(case):
    """One re-plan over the lanes that had budget against the full-width
    one on seeded states: the sums, chunk statistics and exact segments
    bitwise; the live prefix of the lane map and its budgets equal; the
    map a permutation with budget 0 past the live count. Cases: the
    random and stratified samplers, ties in cost, every pixel live
    before and after, every live pixel converging, none live."""
    acc, cstats, order, lanes, out, segs, sampler, tol = replan_state(case)
    plans = plain_replan(acc, cstats, order, lanes, out, segs, sampler, tol)
    acc_r, cstats_r, seg_r, pmap_r, bud_r = parent_replan(
        acc.clone(), None if cstats is None else cstats.clone(), order, out,
        segs, CS, tol)
    assert torch.equal(plans.acc, acc_r)
    assert (plans.stats is None) == (cstats_r is None)
    if cstats_r is not None:
        assert torch.equal(plans.stats, cstats_r)
    assert int(plans.segments) == int(seg_r)
    live = int((bud_r > 0).sum())
    assert plans.live == live
    assert torch.equal(plans.pixel_map[:live], pmap_r[:live])
    assert torch.equal(plans.budget[:live], bud_r[:live])
    assert (plans.budget[live:] == 0).all()
    pix = plans.pixel_map[:, 1].to(torch.int64) * PW + plans.pixel_map[:, 0]
    assert torch.equal(torch.sort(pix).values, torch.arange(PW * PH))
    assert torch.equal(plans.order.to(torch.int64), pix)
    n = PW * PH
    want = {"all_live": (n, n), "all_converge": (0, n),
            "none_live": (0, 0)}.get(case)
    if want is None:
        assert 0 < live < lanes < n
    else:
        assert (live, lanes) == want


@pytest.mark.parametrize("sampler, band", [
    ("random", False), ("stratified", False), ("stratified", True)],
    ids=["random", "stratified", "band"])
def test_adaptive_render_matches_the_full_width_loop(forced_chunks,
                                                     monkeypatch, sampler,
                                                     band):
    """A whole adaptive render (and a band of rows) through the live
    re-plans against the same launches re-planned at full width: the
    sums and the exact segments bitwise."""
    got = []
    real = megakernel._render_adaptive

    def both(launch, sizes, width, height, opts, device):
        new = real(launch, sizes, width, height, opts, device)
        got.append((new, walk_ab.full_width_render(launch, sizes, width,
                                                   height, opts, device)))
        return new

    monkeypatch.setattr(megakernel, "_render_adaptive", both)
    scene, cam, *_ = presets.get_config("cover", W, H)
    rows = torch.arange(5, 21) if band else None
    opts = options(adaptive_tolerance=0.1, sampler=sampler)
    megakernel.render_sums(scene, derive_camera(cam), W, H, SPP,
                           key_data(3), opts, "cpu", rows=rows)
    ((acc, seg), (acc_r, seg_r)), = got
    assert acc.shape == (6, W * (16 if band else H))
    assert torch.equal(acc, acc_r) and int(seg) == int(seg_r)
    assert 4.0 <= float(acc[4].min()) < float(acc[4].max()) <= SPP
