"""The cluster walk kernel's culled box test and packed tables, held on
the CPU against the plain walk's flat selection (``csrc/cluster_walk.cu``
runs only on the card):

- each parent box of ``tables.parent_boxes`` is the exact float32 min /
  max of its run of kd leaves;
- the packed tables (``tables.pack_walk`` in the layout of
  ``tables.walk_layout``) read back every table bit for bit, the members
  at their padded stride;
- a plain-torch version of the kernel's selection (parents first, then
  the children of the parents a ray enters, then on later trips only the
  hit boxes not yet visited) gives the flat selection's m0, m1, done
  flags, visit order and winner, trip by trip, on seeded rays over the
  cover's and the demo's tables, and the cover's in clusters of 4 (121,
  the kernel's four-word mask): camera rays, rays from inside boxes, and
  axis-parallel rays;
- the wide walk's (the SPD sphereflake's 462 clusters): its grandparent
  boxes hold their parents exactly, its layout fits a block's shared
  memory, and its selection (grandparents, then the parents under those
  entered, then their children; 9-bit keys) equals the flat one with the
  same keys.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.camera.camera import derive_camera
from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import rng, tables
from raytracer_tpu_torch.render.options import MIN_T, TraceOptions
from raytracer_tpu_torch.scene import presets

N_RAYS = 3000


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_tables(name: str, group: int = 16):
    if name == "flake":
        scene, cam = (presets.sphereflake_scene(),
                      presets.sphereflake_camera(64, 32))
    else:
        scene, cam, *_ = presets.get_config(name, 64, 32)
    opts = TraceOptions(cluster_scan=True, cluster_group=group)
    part = tables.cluster_partition(scene, opts)
    return tables.walk_tables(part, derive_camera(cam), "cpu")


@pytest.fixture(scope="module", params=[("cover", 16), ("demo", 16),
                                        ("cover", 4), ("flake", 16)],
                ids=["cover", "demo", "cover_121_clusters",
                     "flake_462_clusters"])
def tabs(request):
    return scene_tables(*request.param)


def levels(tabs):
    """(parents, grandparents) of the tables: the wide walk's second
    level follows its parents in ``tabs.parents``; (0, 6) elsewhere."""
    n_par = -(-tabs.bounds.shape[0] // tables.PARENT_FANOUT)
    return tabs.parents[:n_par], tabs.parents[n_par:]


def test_parents_hold_their_children_exactly(tabs):
    k = tabs.bounds.shape[0]
    n_par = -(-k // tables.PARENT_FANOUT)
    n_grand = -(-n_par // tables.PARENT_FANOUT) if tables.is_wide(k) else 0
    assert tabs.parents.shape == (n_par + n_grand, 6)
    assert tabs.parents.dtype == torch.float32
    par, grand = levels(tabs)
    for boxes, under in ((par, tabs.bounds), (grand, par)):
        for p in range(boxes.shape[0]):
            kids = under[p * tables.PARENT_FANOUT:
                         (p + 1) * tables.PARENT_FANOUT]
            assert torch.equal(boxes[p, :3], kids[:, :3].amin(0))
            assert torch.equal(boxes[p, 3:], kids[:, 3:].amax(0))
            assert bool((boxes[p, :3] <= kids[:, :3]).all())
            assert bool((boxes[p, 3:] >= kids[:, 3:]).all())


def test_packed_tables_read_back(tabs):
    k, group = tabs.members.shape[:2]
    n_global = tabs.globals.shape[0]
    lay = tables.walk_layout(n_global, k, group)
    flat = tabs.packed
    assert flat.shape == (lay.n_floats,) and flat.dtype == torch.float32
    assert lay.mstride % 2 == 1 and lay.mstride >= group
    for off in (lay.off_glob, lay.off_par, lay.off_box, lay.off_mem,
                lay.off_win, lay.n_floats):
        assert off % 4 == 0  # 16-byte rows for the kernel's float4 loads
    assert torch.equal(flat[:19], tabs.camera)
    assert torch.equal(
        flat[lay.off_glob:lay.off_glob + 4 * n_global].reshape(-1, 4),
        tabs.globals)
    for off, boxes in ((lay.off_par, tabs.parents),
                       (lay.off_box, tabs.bounds)):
        rows = flat[off:off + tables.BOX_FLOATS * boxes.shape[0]].reshape(
            -1, tables.BOX_FLOATS)
        assert torch.equal(rows[:, :3], boxes[:, :3])
        assert torch.equal(rows[:, 4:7], boxes[:, 3:])
        assert not rows[:, 3].any() and not rows[:, 7].any()
    mem = flat[lay.off_mem:lay.off_win].reshape(k, lay.mstride, 4)
    assert torch.equal(mem[:, :group], tabs.members)
    assert not mem[:, group:].any()
    slots = n_global + k * group
    assert torch.equal(
        flat[lay.off_win:lay.off_win + 11 * slots].reshape(slots, 11),
        tabs.winner)
    # the plain members read back the same parameters from the padded rows
    cidx = torch.arange(k).repeat_interleave(group)
    m = torch.arange(group).repeat(k)
    assert torch.equal(mem[cidx, m], tabs.members[cidx, m])


def test_tables_upload_in_one_copy(tabs):
    """``walk_tables`` packs the very tables it keeps beside ``packed``
    (the parents from the boxes), and ``WalkTables.to`` moves every table
    in one copy: each a view of one buffer, ``packed`` at its start (the
    kernel's 16-byte rows), the others after it, every one contiguous and
    unchanged in shape."""
    assert torch.equal(tabs.packed, tables.pack_walk(
        torch.zeros_like(tabs.packed), tabs.camera, tabs.globals,
        tabs.parents, tabs.bounds, tabs.members, tabs.winner))
    assert np.array_equal(tables.hierarchy_boxes(tabs.bounds.numpy()),
                          tabs.parents.numpy())
    moved = tabs.to("meta")
    base = moved.packed._base
    assert base is not None and moved.packed.storage_offset() == 0
    at = tabs.packed.numel()
    for name in ("camera", "globals", "bounds", "members", "winner",
                 "parents"):
        t = getattr(moved, name)
        assert t._base is base and t.storage_offset() == at
        assert t.shape == getattr(tabs, name).shape and t.is_contiguous()
        at += t.numel()
    assert base.numel() == at
    assert tabs.to("cpu") is tabs  # already there: no copy


@pytest.mark.parametrize("n_global, k, group", [
    (0, 1, 1), (4, 31, 16), (3, 33, 8), (5, 128, 16), (1, 7, 5),
    (1, 462, 16), (0, 129, 16), (2, 512, 16)])
def test_walk_layout_sections(n_global, k, group):
    """The sections follow one another without overlap, each 16-byte
    aligned; members lie an odd number of float4 rows apart, so the same
    member of eight consecutive clusters falls in eight different 16-byte
    bank groups; the largest partition fits a block's shared memory: the
    narrow walk's whole tables, the wide walk's hit-test tables with its
    counts and masks."""
    lay = tables.walk_layout(n_global, k, group)
    n_par = -(-k // tables.PARENT_FANOUT)
    n_grand = -(-n_par // tables.PARENT_FANOUT) if k > 128 else 0
    assert (lay.n_parents, lay.n_grand, lay.k) == (n_par, n_grand, k)
    assert lay.mstride % 2 == 1 and group <= lay.mstride <= group + 1
    assert lay.off_glob == tables.CAMERA_FLOATS
    assert lay.off_par == lay.off_glob + 4 * n_global
    assert lay.off_box == lay.off_par + tables.BOX_FLOATS * (n_par
                                                             + n_grand)
    assert lay.off_mem == lay.off_box + tables.BOX_FLOATS * k
    assert lay.off_win == lay.off_mem + 4 * k * lay.mstride
    slots = n_global + k * group
    assert lay.off_win + 11 * slots <= lay.n_floats < (
        lay.off_win + 11 * slots + 4)
    assert lay.n_floats % 4 == 0
    assert len({(c * lay.mstride) % 8 for c in range(8)}) == 8
    if k <= tables.MAX_CLUSTERS:
        assert 4 * lay.n_floats <= 227 * 1024
    else:
        assert tables.wide_smem_bytes(lay) == (
            4 * lay.off_win + 48 + 4 * -(-k // 32) * 1024)
        assert tables.wide_smem_bytes(lay) <= 227 * 1024
        assert tables.walk_fits(n_global, k, group)


def seeded_rays(tabs, seed: int):
    """Camera-like rays from far outside, rays from points inside random
    boxes, and axis-parallel rays (two direction components exactly 0,
    and one), as numpy float32 made from ``seed``."""
    g = np.random.default_rng(seed)
    b = tabs.bounds.numpy()
    lo, hi = b[:, :3].min(0), b[:, 3:].max(0)
    centre, span = (lo + hi) / 2, (hi - lo)
    n3 = N_RAYS // 3
    # outside: from a sphere around the scene toward points inside it
    u = g.normal(size=(n3, 3))
    o_out = centre + u / np.linalg.norm(u, axis=1, keepdims=True) * (
        1.5 * span.max())
    d_out = centre + (g.random((n3, 3)) - 0.5) * span - o_out
    # inside a box, any direction
    box = g.integers(0, len(b), n3)
    o_in = b[box, :3] + g.random((n3, 3)) * (b[box, 3:] - b[box, :3])
    d_in = g.normal(size=(n3, 3))
    # axis-parallel, from inside the scene's bounds
    n_ax = N_RAYS - 2 * n3
    o_ax = lo + g.random((n_ax, 3)) * (hi - lo)
    d_ax = np.zeros((n_ax, 3))
    axis = g.integers(0, 3, n_ax)
    d_ax[np.arange(n_ax), axis] = g.choice([-1.0, 1.0], n_ax) * (
        0.5 + g.random(n_ax))
    one_zero = np.arange(n_ax) % 2 == 0  # half with only one zero
    d_ax[one_zero, (axis[one_zero] + 1) % 3] = g.normal(size=one_zero.sum())
    o = np.concatenate([o_out, o_in, o_ax]).astype(np.float32)
    d = np.concatenate([d_out, d_in, d_ax]).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def ray_terms(o, d):
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    a = rng.dot3(dx, dy, dz, dx, dy, dz)
    return (ox, oy, oz, dx, dy, dz, a, rng.dot3(ox, oy, oz, dx, dy, dz),
            rng.dot3(ox, oy, oz, ox, oy, oz), MIN_T * a)


def walk_bounce(tabs, ray, culled: bool):
    """One bounce of every ray through the walk's trips, as the plain walk
    runs them (flat: every box every trip) or as the kernel does (culled);
    per trip (m0, m1, live lanes, done), and the final (bq, bs)."""
    n = ray[0].shape[0]
    k, group = tabs.members.shape[:2]
    n_global = tabs.globals.shape[0]
    bits = tables.key_bits(k)
    floor = cw.fill_floor(bits)
    bq = torch.full((n,), cw.FILLQ)
    bs = torch.zeros(n, dtype=torch.int64)
    for gi in range(n_global):
        q = cw._exact_q(*tabs.globals[gi].unbind(0), *ray)
        upd = q < bq
        bq = torch.where(upd, q, bq)
        bs = torch.where(upd, gi, bs)
    kl = torch.full((n,), cw.NEG_BIG)
    live = torch.ones(n, dtype=torch.bool)
    keys = cw.box_keys(ray, tabs.bounds, bits)  # the same on every trip
    hits = None
    trips = []
    while bool(live.any()):
        if not culled:
            m0, m1 = cw.select_two(keys, kl)
        else:
            if hits is None:
                par, grand = levels(tabs)
                entered = cw.box_keys(ray, par, bits) < floor
                if grand.shape[0]:
                    # the wide walk tests parents under grandparents hit
                    entered &= (cw.box_keys(ray, grand, bits) < floor
                                ).repeat_interleave(
                        tables.PARENT_FANOUT, 1)[:, :par.shape[0]]
                cand = entered.repeat_interleave(tables.PARENT_FANOUT,
                                                 1)[:, :k]
            else:
                cand = hits
            hits = cand & (keys < floor)
            sel = torch.where(hits, keys, float("inf"))
            m0 = sel.min(1).values
            m1 = torch.where(sel > m0[:, None], sel, float("inf")).min(
                1).values
        done0 = (cw._key_floor(m0, bits) >= bq) | (m0 >= floor)
        visit = live & ~done0
        cidx = (m0.view(torch.int32) & ((1 << bits) - 1)).to(torch.int64)
        mem = tabs.members[cidx.clamp_max(k - 1)]
        qm = cw._exact_q(mem[..., 0], mem[..., 1], mem[..., 2], mem[..., 3],
                         *(t[:, None] for t in ray))
        qmin, mfirst = cw._first_min(qm)
        upd = visit & (qmin < bq)
        bq = torch.where(upd, qmin, bq)
        bs = torch.where(upd, n_global + cidx * group + mfirst, bs)
        if culled:
            hits = hits & ~(visit[:, None] & (
                torch.arange(k)[None, :] == cidx[:, None]))
        kl = torch.where(visit, m0, kl)
        done = done0 | (visit & ((cw._key_floor(m1, bits) >= bq)
                                 | (m1 >= floor)))
        trips.append((m0, m1, live.clone(), done & live, cidx, visit))
        live = live & ~done
    return trips, bq, bs


@pytest.mark.parametrize("seed", [0, 1])
def test_culled_selection_equals_the_flat_one(tabs, seed):
    o, d = seeded_rays(tabs, seed)
    ray = ray_terms(o, d)
    # the cull is exact: a ray that hits a box enters its parent (and a
    # parent it enters, its grandparent)
    k = tabs.bounds.shape[0]
    bits = tables.key_bits(k)
    floor = cw.fill_floor(bits)
    par, grand = levels(tabs)
    kid_hit = cw.box_keys(ray, tabs.bounds, bits) < floor
    par_hit = cw.box_keys(ray, par, bits) < floor
    grand_hit = cw.box_keys(ray, grand, bits) < floor
    for hit, above, n in ((kid_hit, par_hit, k),
                          (par_hit, grand_hit, par.shape[0])):
        if above.shape[1]:
            assert not (hit & ~above.repeat_interleave(
                tables.PARENT_FANOUT, 1)[:, :n]).any()
    flat, bq_f, bs_f = walk_bounce(tabs, ray, culled=False)
    cull, bq_c, bs_c = walk_bounce(tabs, ray, culled=True)
    assert len(flat) == len(cull)
    visits = 0
    for (m0f, m1f, lf, df, cf, vf), (m0c, m1c, lc, dc, cc, vc) in zip(
            flat, cull):
        assert torch.equal(lf, lc) and torch.equal(df, dc)
        assert torch.equal(vf, vc) and torch.equal(cf[vf], cc[vc])
        for mf, mc in ((m0f, m0c), (m1f, m1c)):
            # a key of a missed box and no key at all end a bounce alike
            real = lf & (mf < floor)
            assert torch.equal(mf[real], mc[real])
            assert bool((mc[lf & ~real] >= floor).all())
        visits += int(vf.sum())
    assert torch.equal(bq_f, bq_c) and torch.equal(bs_f, bs_c)
    assert visits > 0
    # the seeded rays reach every kind of bounce: hits and misses, and
    # with more than one box a bounce of several trips
    assert len(flat) >= min(k, 2)
    assert bool((bq_f < cw.FILLQ).any()) and bool((bq_f == cw.FILLQ).any())
