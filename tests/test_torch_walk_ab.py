"""The host side of ``raytracer_tpu_torch/scripts/walk_ab.py``, the walk's
A/B and counter harness, which runs whole only on the card: its
``-Xptxas -v`` and SASS readers on sample listings, the flat cases'
budget, the launch arguments of every case at a tiny size (the adaptive
walk's from its render's own re-plans), the binding of a library by its
launch interface version, which revision the A/B holds the tree against,
and the flat scan's form sweep: its scenes, its cases and the cut it
reads. Also the adaptive walk's item checks (their cases at a tiny size,
the plain walk of a map's lanes with budget) and the launcher's live
extent."""

import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.render import flat_scan as fs
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scripts import walk_ab

PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119cluster_walk_kernelILb0ELb1ELb0ELi1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119cluster_walk_kernelILb0ELb1ELb0ELi1EEEvNS_6ParamsE
    80 bytes stack frame, 56 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 80 bytes cumulative stack size
"""

SASS = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_119cluster_walk_kernelILb1ELb0ELb0ELi4EEEvNS_6ParamsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FADD R3, R2, R1 ;
        /*0020*/                   LDS.128 R4, [R2] ;
        /*0030*/                   FMNMX R3, R4, R5, PT ;
        /*0040*/              @!P0 BRA 0x20 ;
        /*0050*/                   MUFU.RSQ R6, R3 ;
        /*0060*/               @P1 BRA 0x10 ;
        /*0070*/                   BRA 0x90 ;
        /*0080*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_114flat_scan_kernelILb0ELb0ELb0ELb0EEEvNS_6ParamsE
        /*0000*/                   EXIT ;
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ptxas_report_names_each_instantiation():
    rows = walk_ab.ptxas_report(PTXAS)
    assert [inst for inst, _ in rows] == ["<0,1,0,1>", "<0,1,0,1>"]
    assert "56 bytes spill stores" in rows[0][1]
    assert "Used 64 registers" in rows[1][1]


@pytest.mark.parametrize("edit, same", [
    (("52d8d6be_15_cluster_walk_cu_5c4f9ae6",
      "0aa1c2d3_15_cluster_walk_cu_77e0b1c2"), True),
    (("FADD R3, R2, R1", "FMUL R3, R2, R1"), False)],
    ids=["file_hash", "instruction"])
def test_sass_equal_reads_past_the_file_hash(monkeypatch, tmp_path, edit,
                                             same):
    """Two revisions of a source name their anonymous namespace by the
    file's hash: the same code compares equal, another instruction
    not."""
    old = SASS.replace("_ZN12_GLOBAL__N_1", "_ZN48_GLOBAL__N__52d8d6be_15_"
                       "cluster_walk_cu_5c4f9ae6")
    listings = {"old": old, "new": old.replace(*edit)}
    monkeypatch.setattr(walk_ab.os.path, "exists", lambda path: True)
    monkeypatch.setattr(walk_ab.subprocess, "run", lambda cmd, **k:
                        types.SimpleNamespace(stdout=listings[
                            Path(cmd[-1]).stem]))
    got = walk_ab.sass_equal(tmp_path / "old.so", tmp_path / "new.so")
    assert list(got.values()) == [same]


def test_sass_report_finds_the_walk_and_its_loops(monkeypatch, tmp_path):
    monkeypatch.setattr(walk_ab.os.path, "exists", lambda path: True)
    monkeypatch.setattr(walk_ab.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=SASS))
    dump = tmp_path / "listing.sass"
    got = walk_ab.sass_report(tmp_path / "lib.so", dump)
    assert dump.read_text() == SASS
    assert list(got) == ["<1,0,0,4>"]  # the flat kernel is not the walk's
    rep = got["<1,0,0,4>"]
    assert rep["insns"] == 9
    # two backward branches: [0x20, 0x40] inside [0x10, 0x60]; the
    # forward BRA is no loop
    assert [(lp["start"], lp["end"], lp["insns"]) for lp in rep["loops"]] \
        == [(2, 4, 3), (1, 6, 6)]
    assert rep["loops"][1]["by_class"] == {
        "fp32": 2, "shared": 1, "control": 2, "mufu": 1}


def test_budgeted_map_puts_converged_lanes_last():
    lane_map = cw.identity_map(40, 25, "cpu")
    got, budget = walk_ab.budgeted(lane_map, 31, "cpu")
    live = budget > 0
    assert budget.dtype == torch.int32 and set(budget.tolist()) == {0, 31}
    n_live = int(live.sum())
    assert 0.45 < n_live / 1000 < 0.75
    assert bool(live[:n_live].all()) and not live[n_live:].any()
    # a permutation of the map's lanes
    key = got[:, 1] * 40 + got[:, 0]
    assert torch.equal(key.sort().values, torch.arange(1000,
                                                       dtype=key.dtype))


def _tiny(mp):
    real = presets.get_config

    def small(name, width=None, height=None):
        # 100 spp: the adaptive schedule [7, 31, 31, 31], whose last launch
        # follows a re-plan after the 64 samples a pixel needs to stop
        scene, cam, *_ = real(name, 32, 16)
        return scene, cam, 32, 16, 100, 6

    mp.setattr(presets, "get_config", small)
    mp.setattr(walk_ab, "ENGINE_W", 24)
    mp.setattr(walk_ab, "ENGINE_H", 12)
    mp.setattr(walk_ab, "PROG_W", 32)
    mp.setattr(walk_ab, "PROG_H", 16)


@pytest.fixture
def tiny(monkeypatch):
    _tiny(monkeypatch)


@pytest.fixture(scope="module")
def walk_cases():
    """``walk_ab.cases`` at the tiny size, once for the module (the plain
    walk renders the adaptive cases' launches)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp)
        got = walk_ab.cases("cpu")
    torch.set_num_threads(n)
    return got


def test_walk_cases_cover_the_six_instantiations(walk_cases):
    got = walk_cases
    assert [n for n in got if " " not in n] == list(walk_ab.VARIANTS)
    assert sorted(n for n in got if n.endswith(" tail")) == [
        "cluster_walk_adaptive tail", "cluster_walk_adaptive_stratified tail"]
    wide = [n for n in got if n.endswith(" clusters")]
    assert [got[n][0].bounds.shape[0] for n in wide] == [61, 128]
    for name, args in got.items():
        tabs, lane_map, _, _, spp, w, h, opts, budget, uniforms = args
        assert cw.variant_name(opts) == name.split(" ")[0]
        assert lane_map.shape == (w * h, 2)
        assert (budget is not None) == (opts.adaptive_tolerance > 0.0)
        assert (uniforms is not None) == opts.enable_debug
        # the kernel's argument checks pass
        cw._check(tabs, lane_map, w, h, spp, opts, budget)


def test_adaptive_cases_are_the_renders_own_launches(walk_cases):
    """The adaptive cases are launches of the adaptive render as its
    re-plans gave them: the first sorted chunk with every lane's budget,
    and the tail launch with its converged lanes at budget 0, last."""
    got = walk_cases
    for name in ("cluster_walk_adaptive", "cluster_walk_adaptive_stratified"):
        tabs, lane_map, _, offset, spp, w, h, opts, budget, _ = got[name]
        assert (offset, spp) == (7, 31)
        assert bool((budget == spp).all())
        _, tail_map, _, t_offset, t_spp, *_, t_budget, _ = got[name + " tail"]
        assert (t_offset, t_spp) == (69, 31)
        assert set(t_budget.unique().tolist()) <= {0, t_spp}
        live = t_budget > 0
        n_live = int(live.sum())
        assert n_live < w * h
        assert bool(live[:n_live].all()) and not live[n_live:].any()
        # both maps are permutations of the frame's pixels
        for m in (lane_map, tail_map):
            key = m[:, 1] * w + m[:, 0]
            assert torch.equal(key.sort().values,
                               torch.arange(w * h, dtype=key.dtype))


def test_flat_cases_cover_the_ten_instantiations(tiny):
    got = walk_ab.flat_cases("cpu")
    names = [n for n in got if " " not in n]
    assert names == list(walk_ab.FLAT_VARIANTS)
    assert {n for n in got if " " in n} == {"flat_scan cover",
                                             "flat_scan_split cover"}
    for name, args in got.items():
        tabs, lane_map, _, _, spp, w, h, opts, g_full, budget, _ = args
        assert fs.variant_name(opts, fs.is_split(tabs, g_full)) \
            == name.split(" ")[0]
        fs._check(tabs, lane_map, w, h, spp, opts, g_full, budget)


class FakeLib:
    """A loaded library's ``<kernel>_launch`` (its ``argtypes`` unset)
    and, where given, its ``<kernel>_abi``."""

    def __init__(self, kernel: str, version=None):
        setattr(self, f"{kernel}_launch",
                types.SimpleNamespace(argtypes=None, restype=None))
        if version is not None:
            setattr(self, f"{kernel}_abi", lambda: version)


@pytest.mark.parametrize("version, n_args", [(cw.ABI, 42), (2, None),
                                             (None, None), (cw.ABI + 1, None)])
def test_walk_library_bound_by_its_interface_version(version, n_args):
    """The current interface (with the live extent, the item scratch, the
    sample counts and the scratch's shape) through ``cluster_walk.bind``;
    version 2 (last exported before the item scratch), a library without
    a version (version 1) and an unknown version not at all: each is left
    out, and ``bind`` raises."""
    lib = FakeLib("cluster_walk", version)
    call = walk_ab.walk_caller(lib)
    if n_args is None:
        assert call is None
        with pytest.raises(RuntimeError, match="launch interface"):
            cw.bind(FakeLib("cluster_walk", version))
    else:
        assert callable(call)
        assert len(lib.cluster_walk_launch.argtypes) == n_args


@pytest.mark.parametrize("version", [None, 1, fs.ABI, fs.ABI + 1])
def test_flat_library_bound_by_its_interface_version(version):
    """The current interface (with the persistent grid's lane counter)
    through ``flat_scan.bind``; version 1 (one thread a lane), a library
    without a version and an unknown version not at all: each is left
    out, and ``bind`` raises."""
    lib = FakeLib("flat_scan", version)
    call = walk_ab.flat_caller(lib)
    if version != fs.ABI:
        assert call is None
        with pytest.raises(RuntimeError, match="launch interface"):
            fs.bind(FakeLib("flat_scan", version))
    else:
        assert callable(call) and len(lib.flat_scan_launch.argtypes) == 29


def _commit(repo, text: str):
    csrc = repo / walk_ab.CSRC_REL
    csrc.mkdir(parents=True, exist_ok=True)
    (csrc / "cluster_walk.cu").write_text(text)
    git = ["git", "-C", str(repo), "-c", "user.name=t", "-c",
           "user.email=t@t"]
    subprocess.run(git + ["add", "-A"], check=True, capture_output=True)
    subprocess.run(git + ["commit", "-qm", text], check=True,
                   capture_output=True)
    return subprocess.run(git + ["rev-parse", "HEAD"], check=True,
                          capture_output=True, text=True).stdout.strip()


@pytest.mark.skipif(shutil.which("git") is None, reason="needs git")
def test_base_revision_is_the_trees_own_parent(tmp_path, monkeypatch):
    """HEAD's parent for a committed tree, HEAD for a tree whose kernels
    differ from it; the base's package unpacks under its commit and BASE
    names it, which a copy without history then reads."""
    repo = tmp_path / "repo"
    subprocess.run(["git", "init", "-q", str(repo)], check=True)
    first = _commit(repo, "one")
    second = _commit(repo, "two")
    assert walk_ab.base_revision(repo) == first
    (repo / walk_ab.CSRC_REL / "cluster_walk.cu").write_text("three")
    assert walk_ab.base_revision(repo) == second

    monkeypatch.setattr(walk_ab, "PARENT_DIR", tmp_path / "parents")
    tree = walk_ab.parent_tree(repo)
    assert tree == tmp_path / "parents" / second
    assert (tree / walk_ab.CSRC_REL / "cluster_walk.cu").read_text() == "two"
    assert (tmp_path / "parents" / "BASE").read_text().strip() == second
    copy = tmp_path / "copy"  # the same tree without .git
    copy.mkdir()
    assert walk_ab.base_revision(copy) is None
    assert walk_ab.parent_tree(copy) == tree
    assert walk_ab.parent_csrc(copy) == tree / walk_ab.CSRC_REL
    (tmp_path / "parents" / "BASE").unlink()
    assert walk_ab.parent_tree(copy) is None


@pytest.mark.parametrize("slots", walk_ab.FORM_SLOTS)
def test_thinned_cover_keeps_the_ground_and_large_spheres(slots):
    """The form sweep's scenes: the cover's ground first, its three large
    spheres last, and a seeded draw of its small ones between, in the
    cover's order; the same draw every time."""
    cover = presets.cover_scene()
    got = walk_ab.thinned_cover(slots)
    assert got.count == slots
    assert float(got.radius[0]) == 1000.0
    assert torch.equal(got.center[-3:], cover.center[-3:])
    assert bool((got.radius[1:-3] == 0.2).all())
    rows = [int((cover.center == c).all(1).nonzero()[0])
            for c in got.center]
    assert rows == sorted(set(rows))
    again = walk_ab.thinned_cover(slots)
    assert torch.equal(got.center, again.center)
    assert torch.equal(got.material_type, again.material_type)


def test_form_cases_cover_every_size(tiny):
    """K2 on the demo and on each thinned cover, K2s where the split
    analysis splits; every case's arguments pass the kernel's checks."""
    got = walk_ab.form_cases("cpu")
    k2 = [n for n in got if n.startswith("K2 ")]
    assert k2 == ["K2 demo 9 slots"] + [f"K2 cover/{k} {k} slots"
                                        for k in walk_ab.FORM_SLOTS]
    for name, args in got.items():
        tabs, lane_map, _, _, spp, w, h, opts, g_full, budget, _ = args
        assert fs.is_split(tabs, g_full) == name.startswith("K2s ")
        assert tabs.spheres.shape[0] == int(name.split()[-2])
        assert (spp, opts.max_depth, budget) == (1, 8, None)
        fs._check(tabs, lane_map, w, h, spp, opts, g_full, budget)


def _form_times(each_batched: dict) -> dict:
    return {f"K2 cover/{k} {k} slots": {"each": [e, e + 1],
                                        "batched": [b, b + 1]}
            for k, (e, b) in each_batched.items()}


@pytest.mark.parametrize("pairs, want", [
    ({9: (1, 2), 16: (1, 2), 32: (2, 1), 63: (2, 1)}, 32),
    ({9: (2, 1), 16: (2, 1), 63: (2, 1)}, 9),
    ({9: (2, 1), 16: (1, 2), 32: (2, 1), 63: (2, 1)}, 32),
    ({9: (2, 1), 32: (2, 1), 63: (1, 2)}, None),
    ({9: (2, 1), 32: (2, 2), 63: (2, 1)}, 63)],
    ids=["cut", "everywhere", "not_monotone", "never_at_the_top", "tie"])
def test_batched_from_reads_the_cut(pairs, want):
    """The smallest size from which the batched form is strictly the
    faster at every size measured, by each build's best time."""
    assert walk_ab.batched_from(_form_times(pairs)) == want


def test_extra_builds_are_the_defined_builds():
    """chip_smoke builds what the A/B runs: the base revision's two
    kernels where there is one, then each kernel's defined builds."""
    defined = [(name, d) for name, b in walk_ab.DEFINED_BUILDS.items()
               for d in b.values()]
    assert [(n, d) for n, _, d in walk_ab.extra_builds(None)] == defined
    old = walk_ab.ROOT / "old"
    got = walk_ab.extra_builds(old)
    assert got[:2] == [("cluster_walk", old, ()), ("flat_scan", old, ())]
    assert [(n, d) for n, _, d in got[2:]] == defined
    assert walk_ab.DEFINED_BUILDS["flat_scan"]["each"] == (
        "RT_FLAT_BATCHED_MIN=1024",)
    assert walk_ab.DEFINED_BUILDS["flat_scan"]["batched"] == (
        "RT_FLAT_BATCHED_MIN=1",)


@pytest.mark.parametrize("budget, want", [
    ([31, 31, 31, 0, 0, 0, 0], [3, 31]),
    ([0, 5, 0, 31, 0, 2, 0, 0], [6, 31]),
    ([0, 0, 0, 0], [0, 0]),
    ([], [0, 0]),
], ids=["sorted", "shuffled", "all_dead", "empty"])
def test_live_extent(budget, want):
    """One past the last lane with budget, and the largest budget: a
    re-plan's map (live lanes first), a shuffled one with budget-0 lanes
    inside its live prefix, one with no live lane, an empty one."""
    got = cw.live_extent(torch.tensor(budget, dtype=torch.int32))
    assert got.dtype == torch.int32 and got.shape == (2,)
    assert got.tolist() == want


@pytest.fixture(scope="module")
def tiny_items():
    """``walk_ab.item_cases`` (K1a) at the tiny size with an item scratch
    of 20 lanes of 31 samples, and each case's expected sample counts
    under that scratch."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp)
        mp.setattr(walk_ab, "CAP_W", 32)
        mp.setattr(walk_ab, "CAP_H", 16)
        mp.setattr(walk_ab, "SHUFFLED_LIVE", 100)
        mp.setattr(cw, "ITEM_CAP", 31 * 20)
        cases = walk_ab.item_cases(False, "cpu")
        counts = {name: walk_ab.expected_samples(args[8])
                  for name, args in cases.items()}
    torch.set_num_threads(n)
    return cases, counts


def test_item_cases_run_both_grains(tiny_items):
    cases, counts = tiny_items
    assert list(cases) == [f"launch {j}" for j in walk_ab.ITEM_LAUNCHES] + [
        "whole lanes", "under cap", "over cap", "none live", "one live",
        "shuffled"]
    ends = {name: int(cw.live_extent(args[8])[0])
            for name, args in cases.items()}
    assert (ends["whole lanes"], ends["under cap"], ends["over cap"],
            ends["none live"], ends["one live"]) == (32 * 16, 20, 21, 0, 1)
    # items where the live lanes' samples fit the scratch, whole lanes
    # past it: the whole frame takes 2 samples a lane (1024 > 620)
    assert cases["whole lanes"][8].unique().tolist() == [2]
    assert counts["whole lanes"] == (0, 32 * 16 * 2)
    assert counts["under cap"] == (20 * 31, 20 * 31)
    assert counts["over cap"] == (0, 21 * 31)
    assert counts["none live"] == (0, 0) and counts["one live"] == (31, 31)
    budget = cases["shuffled"][8]
    assert int(budget[ends["shuffled"]:].abs().sum()) == 0
    inside = budget[:ends["shuffled"]]
    assert (inside == 0).any() and ((inside > 0) & (inside < 31)).any()
    for name, args in cases.items():
        tabs, lane_map, _, _, spp, w, h, opts, budget, _ = args
        assert opts.adaptive_tolerance > 0.0 and budget is not None
        cw._check(tabs, lane_map, w, h, spp, opts, budget)
        if name.startswith("launch"):
            assert opts.russian_roulette_depth == 0


@pytest.mark.parametrize("case", ["launch 4", "whole lanes", "under cap",
                                  "over cap", "none live", "one live",
                                  "shuffled"])
def test_live_lanes_plain_is_the_whole_maps(tiny_items, case):
    """The card tests compare the kernel with the plain walk of the map's
    lanes with budget, zeros elsewhere: bit for bit the plain walk of the
    whole map."""
    args = tiny_items[0][case]
    out, segs = walk_ab.live_lanes_plain(args)
    want_out, want_segs = cw.cluster_walk_plain(*args)
    assert torch.equal(out, want_out)
    assert torch.equal(segs, want_segs)
