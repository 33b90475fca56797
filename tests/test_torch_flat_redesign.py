"""The flat scan kernel's exact rewrites, held on the CPU against the plain
flat scan (``csrc/flat_scan.cu`` runs only on the card):

- a slot whose discriminant is negative has the candidate 3e38 (FILLQ)
  bit for bit, under both the near->far logic and the near root alone, so
  the kernel's early rejection of such a slot (no root, no update) changes
  nothing; on seeded random rays and on adversarial ones: grazing rays,
  origins on a sphere, axis-parallel and zero directions, tiny and zero
  discriminants, and coordinates whose squares overflow (a NaN or infinite
  discriminant is never rejected);
- a plain-torch model of the kernel's slot loop, slot by slot and in
  batches of 8 (one branch a batch to the roots, tested against the best
  at the batch's start), with K2s's near-root suffix and self-test, gives
  the plain scan's best candidate and slot bit for bit on the demo's and
  the cover's tables and on random ones, split anywhere;
- the persistent grid's lane dealing (``common.cuh`` ``first_lane``,
  ``next_lane``) takes every lane of the map exactly once, for a map of
  one lane, one shorter than a block, and maps past the grid.
"""

import re

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import rng, tables
from raytracer_tpu_torch.render.options import MIN_T
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.utils import cuda_build

FILLQ = np.float32(cw.FILLQ)
#: the kernel's kBatch
BATCH = int(re.search(r"constexpr int kBatch = (\d+);", (
    cuda_build.CSRC_DIR / "flat_scan.cu").read_text()).group(1))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_rows(name: str) -> torch.Tensor:
    scene, cam, *_ = presets.get_config(name, 64, 32)
    return tables.flat_tables(scene, derive_camera(cam), "cpu").spheres


def random_rows(n: int, seed: int) -> torch.Tensor:
    """(n, 4) [cx, cy, cz, k1] of random spheres, k1 = |c|^2 - r^2 in
    float32 as the tables form it."""
    g = np.random.default_rng(seed)
    c = g.uniform(-12, 12, (n, 3)).astype(np.float32)
    r = g.uniform(0.05, 3.0, n).astype(np.float32)
    r[: n // 8] = 0.0  # points
    k1 = (c * c).sum(1, dtype=np.float32) - r * r
    return torch.from_numpy(np.concatenate([c, k1[:, None]], 1))


def random_rays(n: int, seed: int) -> tuple:
    """(ox, oy, oz, dx, dy, dz) float32 tensors of n seeded rays."""
    g = np.random.default_rng(seed)
    o = g.uniform(-15, 15, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    return tuple(torch.from_numpy(v.copy()) for v in (*o.T, *d.T))


def adversarial_rays(rows: torch.Tensor, seed: int) -> tuple:
    """Rays at the quadratic's edges for the spheres of ``rows``: grazing
    (passing at the radius from a centre), starting on a sphere's
    surface, axis-parallel, of zero and tiny direction, and far out
    (coordinates near 1e20 and 1e30, whose squares overflow)."""
    g = np.random.default_rng(seed)
    c = rows[:, :3].numpy().astype(np.float64)
    r = np.sqrt(np.maximum((c * c).sum(1) - rows[:, 3].numpy(), 0.0))
    pick = g.integers(0, len(c), 600)
    d = g.normal(size=(600, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = np.cross(d, g.normal(size=(600, 3)))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    grazing = c[pick] + r[pick, None] * n - 5.0 * d
    surface_n = g.normal(size=(600, 3))
    surface_n /= np.linalg.norm(surface_n, axis=1, keepdims=True)
    surface = c[pick] + r[pick, None] * surface_n
    axis = np.zeros((600, 3))
    axis[np.arange(600), g.integers(0, 3, 600)] = g.choice([-1.0, 1.0], 600)
    o = np.concatenate([grazing, surface, c[pick] + g.uniform(-3, 3, (600, 3)),
                        g.uniform(-1e20, 1e20, (200, 3)),
                        g.uniform(-1e30, 1e30, (200, 3)),
                        g.uniform(-5, 5, (200, 3))])
    dd = np.concatenate([d, g.normal(size=(600, 3)), axis,
                         g.normal(size=(200, 3)), g.normal(size=(200, 3)),
                         np.concatenate([np.zeros((100, 3)),
                                         1e-20 * g.normal(size=(100, 3))])])
    o, dd = o.astype(np.float32), dd.astype(np.float32)
    return tuple(torch.from_numpy(v.copy()) for v in (*o.T, *dd.T))


def ray_terms(ox, oy, oz, dx, dy, dz):
    a = rng.dot3(dx, dy, dz, dx, dy, dz)
    return (a, rng.dot3(ox, oy, oz, dx, dy, dz),
            rng.dot3(ox, oy, oz, ox, oy, oz), MIN_T * a)


def all_slots(rows, rays):
    """(nb, ds, candidates full, candidates near) of every (ray, slot), as
    (n_rays, slots) tensors, the plain flat scan's way."""
    ox, oy, oz, dx, dy, dz = rays
    a, o_dot_d, o_dot_o, min_t_a = ray_terms(*rays)
    col = [t[:, None] for t in (ox, oy, oz, dx, dy, dz, a, o_dot_d,
                                o_dot_o)]
    cols = [rows[:, j][None, :] for j in range(4)]
    nb, ds = cw.discriminant(*cols, *col)
    sq = cw.root_of(ds)
    qn = nb - sq
    m = min_t_a[:, None]
    q = torch.where(qn >= m, qn, nb + sq)
    full = torch.where(q >= m, q, cw.FILLQ)
    near = torch.where(qn >= m, qn, cw.FILLQ)
    return nb, ds, full, near


def bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("source", ["demo", "cover", "random"])
def test_negative_discriminant_candidate_is_fill(source):
    """Where a slot's discriminant is negative, |nb| < 2^64 (its square is
    finite), and both candidates are exactly FILLQ: the rejected slot's
    candidate, which never beats the best (at most FILLQ)."""
    rows = (random_rows(300, 1) if source == "random"
            else scene_rows(source)[:, :4])
    for rays in (random_rays(3000, 2), adversarial_rays(rows, 3)):
        nb, ds, full, near = all_slots(rows, rays)
        neg = ds < 0.0
        assert bool(neg.any()) and bool((~neg).any())
        assert bool((nb[neg].abs() < 2.0 ** 64).all())
        fill = np.full(int(neg.sum()), FILLQ).view(np.int32)
        assert np.array_equal(bits(full[neg]), fill)
        assert np.array_equal(bits(near[neg]), fill)
    # the adversarial set reaches the cases that must not be rejected:
    # NaN and infinite discriminants and zero ones
    _, ds, _, _ = all_slots(rows, adversarial_rays(rows, 3))
    assert bool(torch.isnan(ds).any()) and bool(torch.isinf(ds).any())
    assert bool((ds == 0.0).any())


def take_root(nb, ds, min_t_a, j, bq, bs, full, mask):
    """The kernel's ``take_root`` on the lanes of ``mask``."""
    sq = cw.root_of(ds)
    qn = nb - sq
    q = torch.where(qn >= min_t_a, qn, nb + sq) if full else qn
    upd = mask & (q >= min_t_a) & (q < bq)
    return torch.where(upd, q, bq), torch.where(upd, j, bs)


def kernel_scan(rows, rays, g_full, batched, last=None):
    """The kernel's slot loop as the model of ``scan_slots`` (slot by slot,
    or in batches of BATCH whose roots run only where some discriminant
    of the batch is not negative, each then guarded), over the full-logic
    slots [0, g_full) and the near-root rest, then K2s's self-test of
    ``last`` (mid-path lanes). Returns (bq, bs)."""
    ox, oy, oz, dx, dy, dz = rays
    a, o_dot_d, o_dot_o, min_t_a = ray_terms(*rays)
    ray = (ox, oy, oz, dx, dy, dz, a, o_dot_d, o_dot_o)
    n = ox.shape[0]
    bq = torch.full((n,), cw.FILLQ)
    bs = torch.zeros((n,), dtype=torch.int64)
    every = torch.ones((n,), dtype=torch.bool)

    def disc(j):
        return cw.discriminant(*rows[j, :4].unbind(), *ray)

    for j0, j1, full in ((0, g_full, True), (g_full, rows.shape[0], False)):
        j = j0
        while batched and j + BATCH <= j1:
            got = [disc(j + k) for k in range(BATCH)]
            miss = every.clone()
            for _, ds in got:
                miss &= ds < 0.0
            for k, (nb, ds) in enumerate(got):
                bq, bs = take_root(nb, ds, min_t_a, j + k, bq, bs, full,
                                   ~miss & ~(ds < 0.0))
            j += BATCH
        for jj in range(j, j1):
            nb, ds = disc(jj)
            bq, bs = take_root(nb, ds, min_t_a, jj, bq, bs, full, every)
    if last is not None:
        own, mid = last
        nb, ds = cw.discriminant(*rows[own, :4].unbind(1), *ray)
        qf = nb + cw.root_of(ds)
        ok = mid & (qf >= min_t_a) & (qf < bq)
        bq, bs = torch.where(ok, qf, bq), torch.where(ok, own, bs)
    return bq, bs


def plain_scan(rows, rays, g_full, last=None):
    """The plain flat scan's choice (``flat_scan_plain``): the first
    minimum of the candidates, then the self-test."""
    _, _, full, near = all_slots(rows, rays)
    slot = torch.arange(rows.shape[0])[None, :]
    bq, bs = cw._first_min(torch.where(slot < g_full, full, near))
    if last is not None:
        own, mid = last
        a, o_dot_d, o_dot_o, min_t_a = ray_terms(*rays)
        nb, sq = cw.roots(*rows[own, :4].unbind(1), *rays, a, o_dot_d,
                          o_dot_o)
        qf = nb + sq
        ok = mid & (qf >= min_t_a) & (qf < bq)
        bq, bs = torch.where(ok, qf, bq), torch.where(ok, own, bs)
    return bq, bs


@pytest.mark.parametrize("batched", [False, True], ids=["each", "batched"])
@pytest.mark.parametrize("source, g_full", [
    ("demo", None), ("demo", 8), ("cover", None), ("cover", 184),
    ("cover", 5), ("random", None), ("random", 83)])
def test_kernel_scan_equals_first_min(source, g_full, batched):
    """The best candidate and its slot, bit for bit, on random and
    adversarial rays; K2s split at the analysis's own place and mid-batch,
    with the self-test of a random last slot on lanes past bounce 0."""
    rows = (random_rows(300, 4) if source == "random"
            else scene_rows(source)[:, :4])
    slots = rows.shape[0]
    split = g_full is not None
    g_full = g_full if split else slots
    for seed, rays in enumerate((random_rays(2000, 5),
                                 adversarial_rays(rows, 6))):
        last = None
        if split:
            g = torch.Generator().manual_seed(seed)
            n = rays[0].shape[0]
            last = (torch.randint(0, slots, (n,), generator=g),
                    torch.rand(n, generator=g) < 0.7)
        want_q, want_s = plain_scan(rows, rays, g_full, last)
        got_q, got_s = kernel_scan(rows, rays, g_full, batched, last)
        assert np.array_equal(bits(got_q), bits(want_q))
        assert torch.equal(got_s, want_s)
        assert bool((want_q < cw.FILLQ).any())


def deal(n: int, blocks: int, threads: int, seed: int) -> tuple:
    """(each thread's first lane, every lane taken in the order taken),
    threads in block order, of a persistent
    grid: warp w of block b starts on lane 32 (w blocks + b) + its rank,
    and a thread whose lane is done (written, or without budget) asks the
    counter for grid + k, the threads asking in a seeded order."""
    g = np.random.default_rng(seed)
    grid = blocks * threads
    lane = [32 * ((t // 32) * blocks + b) + t % 32
            for b in range(blocks) for t in range(threads)]
    first = list(lane)
    taken = []
    counter = 0
    live = [th for th in range(grid) if lane[th] < n]
    while live:
        th = live[g.integers(len(live))]
        taken.append(lane[th])
        lane[th] = grid + counter
        counter += 1
        if lane[th] >= n:
            live.remove(th)
    return first, taken


@pytest.mark.parametrize("n, blocks, threads", [
    (1, 132, 1024), (300, 1, 1024), (5000, 3, 256), (70000, 4, 1024)],
    ids=["one_lane", "under_a_block", "several_blocks", "refilled"])
def test_lane_dealing_takes_every_lane_once(n, blocks, threads):
    """Every lane of the map is taken exactly once and no lane past it;
    the first lanes are the map's head, a warp's 32 consecutive ones to
    each block in turn."""
    first, taken = deal(n, blocks, threads, 8)
    assert sorted(first) == list(range(blocks * threads))
    assert sorted(taken) == list(range(n))
    if blocks > 1:
        # lanes 32-63 go to the second block's first warp
        assert first[threads:threads + 32] == list(range(32, 64))


@pytest.mark.parametrize("g_full", [None, 184])
def test_flat_account_counts_every_discriminant_and_no_root(g_full):
    """The op account's slot: its discriminant on every slot, full-logic
    or near-root alike, and the root logic on none (the early rejection
    skips it wherever a slot's discriminant is negative); the split adds
    only the self-test, on every segment but a sample's first."""
    from raytracer_tpu_torch.utils import profiling as pf

    assert pf.flat_scan_ops(487) == pf.OPS_FLAT_TRIP + pf.OPS_SLOT_DISC * 487
    assert not hasattr(pf, "OPS_SLOT_FULL")
    nsegs, samples = 10**6, 10**4
    got = pf.flat_ops(487, g_full, False, False, nsegs, samples)
    flat = pf.flat_ops(487, None, False, False, nsegs, samples)
    assert got - flat == (pf.OPS_SELF_TEST * (nsegs - samples)
                          if g_full is not None else 0)
    assert flat == nsegs * (pf.flat_scan_ops(487) + pf.OPS_BOUNCE) + (
        samples * pf.OPS_SAMPLE)
