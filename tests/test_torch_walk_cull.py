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
- the wide walk's (the SPD sphereflake's 462 clusters): each level of
  boxes up to the root holds the one below exactly, its layout fits a
  block's shared memory, and its selection (grandparents, then the
  parents under those entered, then their children; 9-bit keys) equals
  the flat one with the same keys;
- a plain model of the wide walk's pending list (:func:`list_bounce`:
  the levels past the grandparents expanded at the bounce's start down
  to the hit grandparents, then the nearest entry taken each step, a box
  expanded into its hit children, a kd leaf visited) takes the flat
  walk's clusters in the flat walk's order and ends at its key, on the
  same rays; a box and a leaf of one floored entry come off box first.
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
    n_grand = -(-n_par // tables.PARENT_FANOUT) if tables.is_wide(
        tabs.bounds.shape[0]) else 0
    return tabs.parents[:n_par], tabs.parents[n_par:n_par + n_grand]


def all_levels(tabs) -> list:
    """Every level of boxes in ``tabs.parents``, lowest first: the
    parents, and in the wide walk the grandparents and the levels past
    them up to the root."""
    k = tabs.bounds.shape[0]
    counts = [-(-k // tables.PARENT_FANOUT)]
    if tables.is_wide(k):
        counts += [-(-counts[0] // tables.PARENT_FANOUT),
                   *tables.upper_levels(k)]
    ends = np.cumsum([0] + counts)
    return [tabs.parents[a:b] for a, b in zip(ends[:-1], ends[1:])]


def test_parents_hold_their_children_exactly(tabs):
    k = tabs.bounds.shape[0]
    n_par = -(-k // tables.PARENT_FANOUT)
    n_grand = -(-n_par // tables.PARENT_FANOUT) if tables.is_wide(k) else 0
    n_top = sum(tables.upper_levels(k))
    assert tabs.parents.shape == (n_par + n_grand + n_top, 6)
    assert tabs.parents.dtype == torch.float32
    boxes_by_level = all_levels(tabs)
    # the wide walk's levels run up to the root, one box
    assert boxes_by_level[-1].shape[0] == (1 if tables.is_wide(k)
                                           else n_par)
    unders = [tabs.bounds] + boxes_by_level[:-1]
    for boxes, under in zip(boxes_by_level, unders):
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
    n_low = lay.n_parents + lay.n_grand
    assert lay.n_top == tabs.parents.shape[0] - n_low
    for off, boxes in ((lay.off_par, tabs.parents[:n_low]),
                       (lay.off_box, tabs.bounds),
                       (lay.off_top, tabs.parents[n_low:])):
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
    # the wide walk's levels past the grandparents follow the winner rows
    assert lay.off_top == (lay.n_floats - tables.BOX_FLOATS * lay.n_top
                           if lay.n_top else 0)
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
    # the wide walk's levels past the grandparents after the winner rows
    n_top = sum(tables.upper_levels(k))
    assert lay.n_top == n_top and (k > 128) == (n_top > 0)
    end = lay.off_top if n_top else lay.n_floats
    assert lay.off_win + 11 * slots <= end < lay.off_win + 11 * slots + 4
    assert lay.n_floats == end + tables.BOX_FLOATS * n_top
    assert lay.n_floats % 4 == 0 and end % 4 == 0
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


#: the wide walk's list entries (csrc/cluster_walk.cu): a box's carries
#: this bit; its order is the entry without it
LIST_BOX = 1 << 31
ORDER = LIST_BOX - 1
BUCKET = 1 << 9  # one floored step of a 9-bit key


def entry_bits(ray, boxes: torch.Tensor) -> np.ndarray:
    """(n, len(boxes)) int64: each box's slab entry with its 9 low bits
    floored, as the kernel's keys hold it, or -1 where the ray misses."""
    keys = cw.box_keys(ray, boxes, 9)
    bits = keys.view(torch.int32).to(torch.int64) & ~(BUCKET - 1)
    return torch.where(keys < cw.fill_floor(9), bits, -1).numpy()


def list_bounce(leaf, upper, counts, bq, visit, cap, box_lower=True):
    """The wide walk's bounce as its pending list runs it, for one ray:
    ``leaf`` the kd leaves' floored entry bits (-1: missed), ``upper`` the
    same for each level of boxes, lowest first (parents, grandparents,
    then the levels up to the root), ``counts`` their sizes, ``bq`` the
    best q's bits after the globals and ``visit(c, bq)`` the member tests
    of cluster c (returning the new best's bits). The levels past the
    grandparents are expanded at the start: the fourth level's boxes,
    under each one entered its third-level children, and under each of
    those entered its grandparents, whose hit ones go into the list.
    Then the nearest entry comes off each step until one's floored key is
    at or beyond the best: a box's hit children go in, a leaf is visited.
    A box's entry is keyed one bucket below its own (``box_lower``) and
    carries its index among the levels in the list (parents, then
    grandparents). Returns (clusters visited in order, best bits, slab
    tests, the list's high-water mark), or None where the list would
    pass ``cap``. The kernel merges a box's hit children into the list in
    one pass where this model puts them in one by one: they take the
    same order."""
    n1, n2, n3, n4 = counts[1:5]
    k = counts[0]
    lst = []  # descending order: the nearest entry last
    tested = peak = 0

    def insert(e):
        nonlocal peak
        if len(lst) == cap:
            raise OverflowError
        j = len(lst)
        while j > 0 and (lst[j - 1] & ORDER) < (e & ORDER):
            j -= 1
        lst.insert(j, e)
        peak = max(peak, len(lst))

    def box(bits, uid):
        return LIST_BOX | ((bits - BUCKET) if box_lower else bits) | uid

    try:
        for t in range(n4):
            tested += 1
            if upper[3][t] < 0:
                continue
            for j in range(4 * t, min(4 * t + 4, n3)):
                tested += 1
                if upper[2][j] < 0:
                    continue
                for g in range(4 * j, min(4 * j + 4, n2)):
                    tested += 1
                    if upper[1][g] >= 0:
                        insert(box(upper[1][g], n1 + g))
        visits = []
        while True:
            head = None
            while lst:
                e = lst[-1]
                if e & ORDER & ~(BUCKET - 1) >= bq:
                    break
                if not e & LIST_BOX:
                    head = e
                    break
                lst.pop()
                u = e & (BUCKET - 1)
                if u < n1:  # a parent: its kd leaves
                    first, end, bits = 4 * u, k, leaf
                else:  # a grandparent: its parents
                    first, end, bits = 4 * (u - n1), n1, upper[0]
                for c in range(first, min(first + 4, end)):
                    tested += 1
                    if bits[c] >= 0:
                        insert(bits[c] | c if bits is leaf
                               else box(bits[c], c))
            if head is None:
                return visits, bq, tested, peak
            lst.pop()
            visits.append(head & (BUCKET - 1))
            bq = visit(visits[-1], bq)
    except OverflowError:
        return None


def f32_bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).to(torch.int64).numpy()


@pytest.fixture(scope="module")
def flake_tabs():
    return scene_tables("flake")


@pytest.mark.parametrize("seed", [0, 1])
def test_list_order_equals_the_flat_walk(flake_tabs, seed):
    """On the sphereflake's partition (462 clusters, 9-bit keys), the
    list visits each ray's clusters of the flat walk, in its order, and
    ends where it ends: the same best and winner, the same walk
    iterations (the flat walk's: one a visit, at least one), and the
    first unvisited hit leaf's key the flat walk's last one. Its list
    stays within the kernel's capacity (``tables.wide_list_capacity``),
    and it tests fewer boxes than the sweep of every box the ray
    crosses."""
    tabs = flake_tabs
    k, group = tabs.members.shape[:2]
    n_global = tabs.globals.shape[0]
    o, d = seeded_rays(tabs, seed)
    ray = ray_terms(o, d)
    flat, bq_f, bs_f = walk_bounce(tabs, ray, culled=False)
    n = o.shape[0]
    # the flat walk per ray: its visits in order, its iterations, and the
    # key that ended it (m0, or m1 after a visit)
    floor = cw.fill_floor(9)
    seq = [[] for _ in range(n)]
    trips = np.zeros(n, np.int64)
    end_key = np.full(n, -1, np.int64)
    for m0, m1, live, done, cidx, visit in flat:
        trips += live.numpy()
        for r in torch.nonzero(visit).flatten().tolist():
            seq[r].append(int(cidx[r]))
        last = torch.where(visit, m1, m0)
        keyed = done & (last < floor)
        end_key[keyed.numpy()] = f32_bits(last)[keyed.numpy()]
    # the inputs of the list: entry bits of every level, the globals'
    # best, and each cluster's member test
    lvls = all_levels(tabs)
    counts = [k] + [b.shape[0] for b in lvls]
    assert counts[3:] == tables.upper_levels(k) and counts[-1] == 1
    leaf = entry_bits(ray, tabs.bounds)
    upper = [entry_bits(ray, b) for b in lvls]
    bq0 = torch.full((n,), cw.FILLQ)
    bs0 = torch.zeros(n, dtype=torch.int64)
    for gi in range(n_global):
        q = cw._exact_q(*tabs.globals[gi].unbind(0), *ray)
        upd = q < bq0
        bq0 = torch.where(upd, q, bq0)
        bs0 = torch.where(upd, gi, bs0)
    mem = tabs.members
    qm = cw._exact_q(mem[None, ..., 0], mem[None, ..., 1], mem[None, ..., 2],
                     mem[None, ..., 3], *(t[:, None, None] for t in ray))
    qmin, mfirst = cw._first_min(qm)
    qmin_bits = f32_bits(qmin)
    cap = tables.wide_list_capacity(tables.walk_layout(n_global, k, group))
    assert cap == 85
    bq_l = f32_bits(bq0)
    bs_l = bs0.numpy().copy()
    tests, peaks = [], []
    for r in range(n):
        best = {"bs": int(bs_l[r])}

        def visit(c, bq, r=r, best=best):
            if qmin_bits[r, c] < bq:
                best["bs"] = n_global + c * group + int(mfirst[r, c])
                return int(qmin_bits[r, c])
            return bq

        got = list_bounce(leaf[r], [u[r] for u in upper], counts,
                          int(bq_l[r]), visit, cap)
        assert got is not None, f"ray {r}: the list passed {cap}"
        visits, bq, tested, peak = got
        assert visits == seq[r]
        assert max(1, len(visits)) == trips[r]
        assert bq == f32_bits(bq_f)[r] and best["bs"] == int(bs_f[r])
        # the first hit leaf not visited: the key that ended the flat walk
        rest = [int(leaf[r, c]) | c for c in range(k)
                if leaf[r, c] >= 0 and c not in visits]
        assert min(rest, default=-1) == end_key[r]
        tests.append(tested)
        peaks.append(peak)
    # the sweep tested every grandparent, the parents under the entered
    # ones and the leaves under the entered parents
    par, grand = levels(tabs)
    sweep = (grand.shape[0]
             + 4 * (upper[1] >= 0).sum(1)
             + 4 * ((upper[0] >= 0).sum(1)))
    assert np.mean(tests) < 0.8 * np.mean(sweep)
    assert max(peaks) <= cap
    print(f"slab tests a bounce: list {np.mean(tests):.2f}, sweep "
          f"{np.mean(sweep):.2f}; list high-water mark mean "
          f"{np.mean(peaks):.2f}, max {max(peaks)}")


def test_list_keys_a_box_below_leaves_of_its_bucket():
    """A box and a leaf of one floored entry: the box comes off first, so
    a leaf under it with a smaller cluster index is visited before the
    leaf already in the list, as the flat walk orders them. Keyed at its
    own bucket, the box (its index 33 among the levels) would come off
    after leaf 20 and the order break. The tree: 129 clusters (parents
    33, grandparents 9, then 3, 1); a ray that enters the first
    grandparent (leaves 0-15) and the second (16-31) at one bucket F, and
    the parents and leaves 3 and 20 at F too, the second grandparent's
    path one bucket earlier above them."""
    counts = [129, 33, 9, 3, 1]
    f = 0x3F800000  # 1.0
    leaf = np.full(129, -1, np.int64)
    upper = [np.full(n, -1, np.int64) for n in counts[1:]]
    upper[3][0] = upper[2][0] = f - 3 * BUCKET  # the top of the tree
    upper[1][1] = upper[0][5] = f - BUCKET  # over leaf 20
    upper[1][0] = upper[0][0] = f  # over leaf 3
    leaf[3] = leaf[20] = f
    no_hit = lambda c, bq: bq  # noqa: E731
    inf = 0x7F800000
    visits, _, _, _ = list_bounce(leaf, upper, counts, inf, no_hit, 21)
    assert visits == [3, 20]  # the flat order: f | 3 before f | 20
    visits, _, _, _ = list_bounce(leaf, upper, counts, inf, no_hit, 21,
                                  box_lower=False)
    assert visits == [20, 3]
    # a best at the bucket's floor ends the bounce before either leaf
    visits, _, _, _ = list_bounce(leaf, upper, counts, f, no_hit, 21)
    assert visits == []
