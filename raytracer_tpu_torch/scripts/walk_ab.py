"""The cluster walk (K1 and its five other instantiations) and the flat
scan (K2, K2s and their eight other instantiations) against the base
revision of their kernels, on the card, with each kernel's own structure
counters and SASS.

    python -m raytracer_tpu_torch.scripts.walk_ab [--repeats 6] [--out DIR]

The base revision is the commit this tree's kernels are held against:
``HEAD`` where the working tree's ``raytracer_tpu_torch/csrc`` differs
from it, else ``HEAD``'s parent (:func:`base_revision`). Its package is
unpacked with ``git archive`` into ``build/walk_parent/<commit>``, and
``build/walk_parent/BASE`` names it, so that a copy of the tree without
its history (``.git``) still finds it. Without either, the old builds are
left out. A base library is bound only where it exports the launch
interface the current wrappers pass (``cluster_walk_abi``,
``flat_scan_abi``); one at any other version is left out, never called.

1. Builds, one ``nvcc`` each and all at once: the base revision, the
   current source, and the current source with ``-DRT_WALK_COUNTERS``;
   prints ``-Xptxas -v`` of each instantiation and the SASS (``cuobjdump
   -sass``) of each walk instantiation: its instruction count, and per
   loop (a backward branch) its body's instructions by class.
2. Runs every build on the same inputs at the main path's shapes: K1 and
   K1s on one 153-spp sorted chunk of the cover at 1200x800, depth 50,
   roulette from bounce 5 (the fixed render's second chunk), and K1
   there with the cover in clusters of 8 (61: the wide box mask); K1a
   and K1a+K1s on two launches of the cover's adaptive render (tolerance
   0.2), with the lane map and budget its own re-plans gave them: the
   first sorted chunk, where every lane has budget, and one from the
   middle of the tail, where few have; K3 on K1 and on K1s on a 1280x720
   frame, 1 spp, depth 8 (the engine's), the cursor at the centre's hit;
   and K1 on a scene of exactly 128 clusters (``random_scene``), the most
   the narrow walk takes. Every output row and the segments must be
   bitwise equal to the current build's, and the SASS of every narrow
   instantiation the base revision's, instruction for instruction
   (:func:`sass_listings`); the wide walk's too (step 7).
3. Times them in turns (old, new, then the reverse order, and again) by
   CUDA events around one launch each.
4. The counter build on the same inputs: warp trips and the SIMT
   efficiency (active lanes per warp trip over 32) of the trip, of the
   bounce start, of the member loop and of the tail; slab tests per
   completed bounce beside the k a trip the flat walk made.
5. The flat scan (``csrc/flat_scan.cu``), which shares the walk's bounce
   tail: its ten instantiations, base revision and current build, and the
   current source built in each scan form for every table size (``each``:
   slot by slot, ``batched``: in batches; ``-DRT_FLAT_BATCHED_MIN``),
   bitwise and timed in turns the same way, on the demo's 1080p
   progressive frame
   (31-spp chunks for the adaptive ones, 40 % of the lanes without
   budget), the engine's 720p frame for the debug ones, and K2 and K2s on
   a 41-spp chunk of the cover (487 slots, depth 50); ``-Xptxas -v`` and
   the SASS of each flat instantiation (per loop its instructions by
   class, and its square roots: one a slot); and the flat counter build
   (``-DRT_FLAT_COUNTERS``) on the same cases: warp trips, the SIMT
   efficiency of the bounce trip, of the slot loop and of the tail, the
   lanes live per warp trip (and their histogram), slot iterations per
   bounce, the share of lane slot iterations whose discriminant is not
   negative and the share of warp slot iterations where no lane's is
   (the slots an exact early rejection skips), and lanes refilled.
6. The scan form's cut (flat_scan.cu ``kBatchedMin``, the table size from
   which the launcher takes the batched form): K2 and K2s (where the split
   analysis splits) on a 1080p 1-spp depth-8 frame of the demo and of the
   cover thinned to each of ``FORM_SLOTS`` spheres (:func:`thinned_cover`),
   the two form builds bitwise and timed in turns; the smallest size from
   which the batched form is the faster at every size measured.

7. The wide walk (``RT_WALK_WIDE``, partitions of 129 to 512 clusters,
   K1w): its six instantiations on the SPD sphereflake (:func:`flake_cases`)
   bitwise against their plain versions (:func:`flake_check`); then
   (:func:`wide_ab`) the base revision's wide build, the current one, its
   counter build and a build whose pending list holds
   ``TEST_LIST_CAP`` entries (``-DRT_WALK_LIST_CAP``, so that bounces
   overflow into the sweep), bitwise on those cases and on the
   benchmark cell's 29-spp launch (:func:`flake_launch`), timed in turns,
   with ``-Xptxas -v``, the SASS loops, and the counters: slab tests a
   completed bounce, the list's high-water mark (mean and highest), the
   share of bounces that swept, the list's inserts and moves a bounce,
   and the SIMT efficiency of a pass of the bounce loop, of a box
   expansion, of a visit and of the tail.

Writes everything to ``<out>/walk_ab.json`` as well, and the SASS
listings, gzipped, under ``<out>/sass/`` (``--out``, ``build/walk_ab`` by
default).
Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import io
import json
import os
import re
import shutil
import subprocess
import tarfile
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu_torch.render import cluster_walk as cw
from raytracer_tpu_torch.utils import cuda_build

ROOT = cuda_build.PACKAGE_DIR.parent
PARENT_DIR = ROOT / "build" / "walk_parent"
OUT_DIR = ROOT / "build" / "walk_ab"
PACKAGE_REL = "raytracer_tpu_torch"
CSRC_REL = f"{PACKAGE_REL}/csrc"
#: the walk counter build's totals (``WalkCounter`` in cluster_walk.cu);
#: from ``lane_passes`` on the wide walk's list alone
COUNTERS = ("warp_trips", "lane_trips", "warp_fresh", "lane_fresh",
            "warp_visit", "lane_visit", "warp_tail", "lane_tail",
            "slab_tests", "lane_passes", "warp_expand", "lane_expand",
            "list_inserts", "list_moves", "list_peak", "list_peak_max",
            "sweeps")
#: the flat counter build's totals (``FlatCounter`` in flat_scan.cu), then
#: a histogram of the active lanes of a warp trip, 0..32
FLAT_COUNTERS = ("warp_trips", "lane_trips", "warp_slots", "lane_slots",
                 "warp_root", "lane_root", "warp_tail", "lane_tail",
                 "lane_refill", "warp_batch", "warp_batch_root")
LIVE_BINS = 33
#: instantiation name → (adaptive, stratified, debug)
VARIANTS = {
    "cluster_walk": (False, False, False),
    "cluster_walk_stratified": (False, True, False),
    "cluster_walk_adaptive": (True, False, False),
    "cluster_walk_adaptive_stratified": (True, True, False),
    "cluster_walk_debug": (False, False, True),
    "cluster_walk_stratified_debug": (False, True, True),
}
#: flat-scan instantiation → (adaptive, stratified, split, debug)
FLAT_VARIANTS = {
    "flat_scan": (False, False, False, False),
    "flat_scan_stratified": (False, True, False, False),
    "flat_scan_adaptive": (True, False, False, False),
    "flat_scan_adaptive_stratified": (True, True, False, False),
    "flat_scan_split": (False, False, True, False),
    "flat_scan_split_stratified": (False, True, True, False),
    "flat_scan_split_adaptive": (True, False, True, False),
    "flat_scan_split_adaptive_stratified": (True, True, True, False),
    "flat_scan_debug": (False, False, False, True),
    "flat_scan_stratified_debug": (False, True, False, True),
}
PROG_W, PROG_H = 1920, 1080
COVER_FLAT_CHUNK = 41
ADAPTIVE_CHUNK = 31
#: launches of the cover's adaptive render ([4] + [31] x 16) the A/B
#: takes, by case-name suffix: the first sorted chunk (no pixel has the 64
#: samples it needs to stop, so every lane has budget), and one from the
#: middle of the tail (launches 3-16, after pixels begin to stop)
ADAPTIVE_LAUNCHES = {"": 1, " tail": 9}
#: the cover in clusters of 8: 61 clusters, past the one-word box mask
WIDE_GROUP = 8
SASS_LOOPS_SHOWN = 8
ENGINE_W, ENGINE_H, ENGINE_DEPTH = 1280, 720, 8
#: the form sweep's table sizes: the flat scan's default range (it serves
#: scenes under ``options.CLUSTER_AUTO_MIN_SPHERES`` slots)
FORM_SLOTS = (9, 16, 24, 32, 40, 48, 56, 63)


def _git(root: Path, *args) -> subprocess.CompletedProcess:
    return subprocess.run(["git", "-C", str(root), *args],
                          capture_output=True)


def base_revision(root: Path = ROOT) -> str | None:
    """The commit the tree's kernels are held against: ``HEAD`` where the
    working tree's ``csrc`` differs from it, else ``HEAD``'s parent; None
    where the checkout has no history for it."""
    if shutil.which("git") is None or not (root / ".git").exists():
        return None
    changed = _git(root, "diff", "--quiet", "HEAD", "--", CSRC_REL).returncode
    if changed not in (0, 1):
        return None
    rev = _git(root, "rev-parse", "--verify", "-q",
               "HEAD" if changed else "HEAD^")
    return rev.stdout.decode().strip() if rev.returncode == 0 else None


def parent_tree(root: Path = ROOT) -> Path | None:
    """The base revision's tree (its package alone), unpacked under
    ``build/walk_parent/<commit>``; where the checkout has no history, the
    one ``build/walk_parent/BASE`` names; None where neither is there."""
    sha = base_revision(root)
    base = PARENT_DIR / "BASE"
    if sha is None:
        if not base.exists():
            return None
        sha = base.read_text().strip()
        tree = PARENT_DIR / sha
        return tree if (tree / CSRC_REL / "cluster_walk.cu").exists() else None
    tree = PARENT_DIR / sha
    if not (tree / CSRC_REL / "cluster_walk.cu").exists():
        proc = _git(root, "archive", sha, f"{PACKAGE_REL}/")
        if proc.returncode != 0:
            return None
        tree.mkdir(parents=True, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(proc.stdout)) as tar:
            tar.extractall(tree, filter="data")
    base.write_text(sha + "\n")
    return tree


def parent_csrc(root: Path = ROOT) -> Path | None:
    """The base revision's ``csrc`` (see :func:`parent_tree`), or None."""
    tree = parent_tree(root)
    return None if tree is None else tree / CSRC_REL


def walk_caller(lib: ctypes.CDLL):
    """``call(*case)`` for a walk library at the launch interface
    :func:`cluster_walk.call` passes (with the live extent of the case's
    budget); None for any other version."""
    version = cuda_build.abi(lib, "cluster_walk_abi")
    if version == cw.ABI:
        fn = cw.bind(lib)
        return lambda *a: cw.call(fn, *a, extent_of(a[8]))
    print(f"[walk A/B] a walk library with launch interface {version}: no "
          "binder for it here, left out")
    return None


def flat_caller(lib: ctypes.CDLL):
    """``call(*case)`` for a flat-scan library, as :func:`walk_caller`."""
    from raytracer_tpu_torch.render import flat_scan as fs

    version = cuda_build.abi(lib, "flat_scan_abi")
    if version == fs.ABI:
        fn = fs.bind(lib)
        return lambda *a: fs.call(fn, *a)
    print(f"[walk A/B] a flat-scan library with launch interface {version}: "
          "no binder for it here, left out")
    return None


def ptxas_report(log: str) -> list:
    """(instantiation, registers / stack / spill line) from ``-Xptxas -v``."""
    rows, inst = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inst = "<" + ",".join(re.findall(r"L[bi](\d+)E", line)) + ">"
        elif "stack frame" in line or "registers" in line:
            rows.append((inst, line.strip()))
    return rows


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_TARGET = re.compile(r"\b0x([0-9a-f]+)\s*$")
SASS_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK",
             "FSET", "FRND", "FMUL32I", "FADD32I"),
    "int": ("IADD3", "IMAD", "LOP3", "SHF", "ISETP", "LEA", "IABS", "SEL",
            "PRMT", "IMNMX", "FLO", "POPC", "BREV", "IADD", "LOP", "SHL",
            "SHR", "VIMNMX", "I2F", "F2I", "I2FP", "F2IP"),
    "mufu": ("MUFU",),
    "shared": ("LDS", "STS", "LDSM"),
    "global": ("LDG", "STG", "RED", "ATOM", "ATOMG", "LDGSTS", "UBLKCP"),
    "local": ("LDL", "STL"),
    "control": ("BRA", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "CALL", "RET",
                "BMOV", "BREAK", "VOTE", "NOP", "YIELD"),
}


def _sass_class(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in SASS_CLASSES.items():
        if base in ops:
            return name
    return "other"


#: the file hash in an anonymous namespace's mangled name, which differs
#: between two revisions of a source even where their code is the same
_ANON_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def _sass_text(lib: Path) -> str | None:
    """``cuobjdump -sass`` of ``lib``, or None where the tool is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout


def _functions(text: str, kernel: str) -> dict:
    """Mangled name, its anonymous namespace's file hash dropped → the
    listing of each function of ``kernel`` in the SASS ``text``."""
    got = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.splitlines()[0].strip()
        if kernel in name:
            got[_ANON_HASH.sub("", name)] = chunk
    return got


def sass_report(lib: Path, dump: Path | None = None,
                kernel: str = "cluster_walk_kernel") -> dict:
    """Per instantiation of ``kernel`` (``<a,s,d,w>`` for the walk,
    ``<a,s,sp,d>`` for the flat scan): its instruction count and its loops
    (a backward branch), smallest first, each with its body's instructions
    by class and its square roots (``rsq``, ``MUFU.RSQ``: one a slot of
    the flat scan's loops). The whole listing goes to ``dump`` where one
    is given (gzipped where its name ends in ``.gz``). Empty where
    ``cuobjdump`` is missing."""
    text = _sass_text(lib)
    if text is None:
        return {}
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        if dump.suffix == ".gz":
            dump.write_bytes(gzip.compress(text.encode()))
        else:
            dump.write_text(text)
    report = {}
    for name, chunk in _functions(text, kernel).items():
        inst = "<" + ",".join(re.findall(r"L[bi](\d+)E", name)) + ">"
        insns = [(int(m.group(1), 16), m.group(2), m.group(3))
                 for m in map(_SASS_INSN.search, chunk.splitlines()) if m]
        at = {addr: j for j, (addr, _, _) in enumerate(insns)}
        loops = []
        for j, (addr, op, rest) in enumerate(insns):
            t = _SASS_TARGET.search(rest.strip())
            if not (op.startswith("BRA") and t):
                continue
            start = at.get(int(t.group(1), 16))
            if start is None or start > j:
                continue
            by = {}
            for _, o, _ in insns[start:j + 1]:
                c = _sass_class(o)
                by[c] = by.get(c, 0) + 1
            rsq = sum(o.startswith("MUFU.RSQ") for _, o, _ in
                      insns[start:j + 1])
            loops.append({"start": start, "end": j, "insns": j + 1 - start,
                          "by_class": by, "rsq": rsq})
        loops.sort(key=lambda lp: lp["insns"])
        report[inst] = {"insns": len(insns), "loops": loops}
    return report


def engine_debug(scene, cam, device):
    """The cursor and selection at the frame's centre, as the engine's
    pick there gives them."""
    from raytracer_tpu_torch.interact.picking import update_cursor_state
    from raytracer_tpu_torch.render.options import DebugParams

    _, point, sel = update_cursor_state(scene.to(device), cam)
    return DebugParams(point, sel)


def cases(device="cuda") -> dict:
    """Instantiation name → the launch's arguments (as
    :func:`~raytracer_tpu_torch.render.cluster_walk.cluster_walk` takes
    them) at its main path's shape."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import schedule, tables
    from raytracer_tpu_torch.render.megakernel import plan_from_cost
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    seed = kernel_seed(0)
    got = {}
    pmap = None
    for name, (adaptive, stratified, debug) in VARIANTS.items():
        sampler = "stratified" if stratified else "random"
        if debug:
            opts = TraceOptions(max_depth=ENGINE_DEPTH, sampler=sampler,
                                enable_debug=True)
            tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                                      derive_camera(cam), device)
            dbg = engine_debug(scene, cam, device)
            uniforms = cw.overlay(opts, dbg)
            got[name] = (tabs, cw.identity_map(ENGINE_W, ENGINE_H, device),
                         seed, 3, 1, ENGINE_W, ENGINE_H, opts, None,
                         uniforms)
            continue
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5,
                            sampler=sampler,
                            adaptive_tolerance=0.2 if adaptive else 0.0)
        tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                                  derive_camera(cam), device)
        chunk = schedule.pick_chunk_spp(spp, w * h, scene.count, depth, 5)
        sizes, _ = schedule.chunk_schedule(spp, chunk)
        if pmap is None:
            out0, _ = cw.cluster_walk(tabs, cw.identity_map(w, h, device),
                                      seed, 0, sizes[0], w, h, opts)
            _, pmap = plan_from_cost(out0[3], w)
        if adaptive:
            seen = adaptive_launches(tabs, scene.count, w, h, spp, opts, seed,
                                     device)
            for suffix, j in ADAPTIVE_LAUNCHES.items():
                lane_map, offset, cs, budget = seen[min(j, len(seen) - 1)]
                got[name + suffix] = (tabs, lane_map, seed, offset, cs, w, h,
                                      opts, budget, None)
            continue
        got[name] = (tabs, pmap, seed, sizes[0], sizes[-1], w, h, opts,
                     None, None)
    # more than 32 clusters take the four-word box mask: K1 on the same
    # chunk with the cover cut into clusters of WIDE_GROUP
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=5,
                        cluster_group=WIDE_GROUP)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), device)
    got[f"cluster_walk {tabs.bounds.shape[0]} clusters"] = (
        tabs, pmap, seed, sizes[0], sizes[-1], w, h, opts, None, None)
    # the narrow walk's largest partition, on the cover's camera
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=5)
    tabs = tables.walk_tables(tables.cluster_partition(
        random_scene(FULL_NARROW_SPHERES), opts), derive_camera(cam), device)
    got[f"cluster_walk {tabs.bounds.shape[0]} clusters"] = (
        tabs, pmap, seed, sizes[0], sizes[-1], w, h, opts, None, None)
    return got


def adaptive_launches(tabs, count: int, w: int, h: int, spp: int, opts,
                      seed: int, device) -> list:
    """(lane map, sample offset, spp, budget) of every launch of the
    adaptive render of ``spp`` through the walk on ``tabs`` (of a scene of
    ``count`` spheres), as its re-plans (``render/adaptive_plan.py``)
    gave them: copies, since a re-plan rewrites its map and budget in
    place."""
    from raytracer_tpu_torch.render import megakernel, schedule

    chunk = schedule.pick_chunk_spp(spp, w * h, count, opts.max_depth,
                                    opts.russian_roulette_depth)
    sizes = schedule.adaptive_schedule(spp, chunk, opts.adaptive_chunk_spp,
                                       opts.sort_pixels)
    seen = []

    def launch(pixel_map, offset, cs, budget=None, extent=None):
        seen.append((pixel_map.clone(), offset, cs,
                     None if budget is None else budget.clone()))
        return cw.cluster_walk(tabs, pixel_map, seed, offset, cs, w, h, opts,
                               budget, extent=extent)

    megakernel._render_adaptive(launch, sizes, w, h, opts, device)
    return seen


def full_width_render(launch, sizes, width, height, opts, device):
    """``megakernel._render_adaptive`` as the base revision ran it: after
    every chunk a re-plan over every pixel (``accumulate_sorted``,
    ``chunk_mean_stats``, ``plan_adaptive``, in tensor operations). The
    live re-plans (``render/adaptive_plan.py``) must give its sums and
    segments bit for bit. Returns ``(acc, segments)``."""
    from raytracer_tpu_torch.render import adaptive_plan as ap
    from raytracer_tpu_torch.render import megakernel as mk

    tol = opts.adaptive_tolerance
    track = opts.sampler == "stratified"
    acc, segs = launch(mk.identity_map(width, height, device), 0, sizes[0])
    segments = segs.sum(dtype=torch.int64)
    inv, pixel_map, budget = ap.plan_adaptive(acc, width, sizes[1], tol)
    cstats = (torch.zeros((3, acc.shape[1]), dtype=torch.float32,
                          device=acc.device) if track else None)
    offset, spp = sizes[0], sum(sizes)
    for cs in sizes[1:]:
        if track:
            lsum_prev, n_prev = acc[0] + acc[1] + acc[2], acc[4]
        out, segs = launch(pixel_map, offset, cs, budget, extent_of(budget))
        acc, segments = mk.accumulate_sorted(out, segs, acc, segments, inv)
        if track:
            cstats = ap.chunk_mean_stats(cstats, acc, lsum_prev, n_prev)
        offset += cs
        if offset < spp:
            inv, pixel_map, budget = ap.plan_adaptive(acc, width, cs, tol,
                                                      cstats)
    return acc, segments


#: the narrow walk's largest partition: 2048 small spheres in clusters of
#: 16 (and a ground sphere, a global)
FULL_NARROW_SPHERES = 2048
#: the wide walk's checks: the SPD sphereflake (462 clusters) at its
#: 512x512, depth 50; a 64x64 grid of its pixels (every FLAKE_STRIDE-th of
#: each row and column) takes FLAKE_SPP samples from sample FLAKE_OFFSET
FLAKE_STRIDE, FLAKE_SPP, FLAKE_OFFSET = 8, 3, 5
#: its whole-lane adaptive case: every FLAKE_SPARSE-th lane of the whole
#: frame, and the last, live with FLAKE_WHOLE samples, so the live end
#: times the largest budget passes ITEM_CAP
FLAKE_SPARSE, FLAKE_WHOLE = 128, 17
#: the case name of the benchmark cell's own launch (:func:`flake_launch`)
FLAKE_LAUNCH = "29 spp sorted"
#: the list capacity of the wide walk's overflow build
#: (``-DRT_WALK_LIST_CAP``): near the sphereflake's lists' usual
#: high-water marks (about 5, at most 21 of the main build's 85), so that
#: about a fifth of its bounces, some at their start, overflow into the
#: sweep
TEST_LIST_CAP = 8
#: the wide walk's builds besides the base revision's
WIDE_BUILDS = {
    "new": (cw.WIDE_DEFINE,),
    "counters": (cw.WIDE_DEFINE, "RT_WALK_COUNTERS"),
    "list8": (cw.WIDE_DEFINE, "RT_WALK_COUNTERS",
              f"RT_WALK_LIST_CAP={TEST_LIST_CAP}"),
}

#: the item checks' launches of the cover's adaptive render (1-based) at
#: the benchmark cell's settings (1200x800, 500 spp cap, depth 50, rr0,
#: tolerance 0.2): its widest re-plan, one from the middle of the tail,
#: and its last (no lane left)
ITEM_LAUNCHES = (4, 9, 17)
#: the capacity cases: the cover at 640x400, depth 12, rr5, a chunk of 31
#: spp at sample offset 66, on a seeded shuffle of the identity map
CAP_W, CAP_H, CAP_SPP, CAP_OFFSET = 640, 400, 31, 66
#: the shuffled case's live lanes: budgets from 0 to the chunk's
SHUFFLED_LIVE = 4096


def item_cases(stratified: bool, device="cuda") -> dict:
    """Case name → :func:`~raytracer_tpu_torch.render.cluster_walk.
    cluster_walk`'s arguments for K1a (K1a+K1s when ``stratified``) around
    its one-sample items: the cover's own re-planned launches
    (``ITEM_LAUNCHES``), the whole frame at the same settings with the
    fewest samples a lane that overflow the item scratch (whole lanes at
    the main path's shape), live lanes whose samples fill the item
    scratch to just under ``ITEM_CAP`` (items) and just over it (whole
    lanes), none live, one live, and a shuffled map whose first
    ``SHUFFLED_LIVE`` lanes take budgets from 0 to the chunk's."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import tables
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    sampler = "stratified" if stratified else "random"
    seed = kernel_seed(0)
    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=0,
                        sampler=sampler, adaptive_tolerance=0.2)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), device)
    seen = adaptive_launches(tabs, scene.count, w, h, spp, opts, seed,
                             device)
    got = {}
    for j in ITEM_LAUNCHES:
        lane_map, offset, cs, budget = seen[min(j, len(seen)) - 1]
        got[f"launch {j}"] = (tabs, lane_map, seed, offset, cs, w, h, opts,
                              budget, None)
    # the first sorted chunk's map (every lane live), each lane one sample
    # past what the scratch holds for the frame
    lane_map, offset, cs, _ = seen[1]
    whole = min(cw.ITEM_CAP // (w * h) + 1, cs)
    got["whole lanes"] = (tabs, lane_map, seed, offset, cs, w, h, opts,
                          torch.full((w * h,), whole, dtype=torch.int32,
                                     device=device), None)
    scene, cam, *_ = presets.get_config("cover", CAP_W, CAP_H)
    opts = TraceOptions(max_depth=12, russian_roulette_depth=5,
                        sampler=sampler, adaptive_tolerance=0.2)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), device)
    n = CAP_W * CAP_H
    g = torch.Generator(device="cpu").manual_seed(4)
    pmap = cw.identity_map(CAP_W, CAP_H, device)[
        torch.randperm(n, generator=g).to(device)].contiguous()
    lanes = torch.arange(n)
    fit = cw.ITEM_CAP // CAP_SPP  # live lanes whose samples fit
    for label, live in (("under cap", fit), ("over cap", fit + 1),
                        ("none live", 0), ("one live", 1)):
        if live > n:
            raise ValueError(f"{label}: {live} live lanes, the map has {n}")
        budget = torch.where(lanes < live, CAP_SPP, 0)
        got[label] = (tabs, pmap, seed, CAP_OFFSET, CAP_SPP, CAP_W, CAP_H,
                      opts, budget.to(torch.int32).to(device), None)
    budget = torch.where(lanes < SHUFFLED_LIVE,
                         torch.randint(0, CAP_SPP + 1, (n,), generator=g), 0)
    got["shuffled"] = (tabs, pmap, seed, CAP_OFFSET, CAP_SPP, CAP_W, CAP_H,
                       opts, budget.to(torch.int32).to(device), None)
    return got


def random_scene(n_small: int, seed: int = 0):
    """A ground sphere of radius 1000 under ``n_small`` seeded spheres of
    radius 0.05-0.2 in a 16 x 1 x 16 slab, of the three materials:
    ``n_small`` / 16 clusters of the default group."""
    from raytracer_tpu_torch.scene.spheres import scene_from_numpy

    g = np.random.default_rng(seed)
    n = n_small + 1
    center = np.concatenate([[[0.0, -1000.0, 0.0]], g.uniform(
        (-8.0, 0.0, -8.0), (8.0, 1.0, 8.0), (n_small, 3))])
    radius = np.concatenate([[1000.0], g.uniform(0.05, 0.2, n_small)])
    mat = np.concatenate([[0], g.integers(0, 3, n_small)])
    return scene_from_numpy(
        center=center.astype(np.float32), radius=radius.astype(np.float32),
        material_type=mat.astype(np.int32),
        albedo=g.uniform(0.1, 1.0, (n, 3)).astype(np.float32),
        fuzz=np.where(mat == 1, g.uniform(0.0, 0.5, n), 0.0).astype(
            np.float32),
        refraction_index=np.where(mat == 2, 1.5, 0.0).astype(np.float32),
        active=np.ones(n, np.float32))


def flake_cases(device="cuda") -> dict:
    """Case name → :func:`~raytracer_tpu_torch.render.cluster_walk.
    cluster_walk`'s arguments for the wide walk on the SPD sphereflake at
    its 512x512 and depth 50, from sample ``FLAKE_OFFSET``: each of the
    six instantiations on a grid of the frame's pixels, the adaptive ones
    under a seeded budget from 0 to ``FLAKE_SPP`` (one-sample items), the
    debug ones with the cursor at the centre's hit; and the adaptive
    ones on the whole frame with a sparse live set whose extent passes
    the item scratch (whole lanes)."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import tables
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    w = h = 512
    scene = presets.sphereflake_scene()
    cam = presets.sphereflake_camera(w, h)
    seed = kernel_seed(0)
    ident = cw.identity_map(w, h, device)
    grid = ident.reshape(h, w, 2)[::FLAKE_STRIDE, ::FLAKE_STRIDE]
    grid = grid.reshape(-1, 2).contiguous()
    g = torch.Generator(device="cpu").manual_seed(6)
    part = None
    got = {}
    for name, (adaptive, stratified, debug) in VARIANTS.items():
        opts = TraceOptions(max_depth=50,
                            sampler="stratified" if stratified else "random",
                            adaptive_tolerance=0.2 if adaptive else 0.0,
                            enable_debug=debug)
        if part is None:
            part = tables.cluster_partition(scene, opts)
        tabs = tables.walk_tables(part, derive_camera(cam), device)
        dbg = engine_debug(scene, cam, device) if debug else None
        budget = None
        if adaptive:
            budget = torch.randint(0, FLAKE_SPP + 1, (grid.shape[0],),
                                   generator=g).to(torch.int32).to(device)
            lanes = torch.arange(w * h)
            live = (lanes % FLAKE_SPARSE == 0) | (lanes == w * h - 1)
            got[name + " whole lanes"] = (
                tabs, ident, seed, FLAKE_OFFSET, FLAKE_WHOLE, w, h, opts,
                torch.where(live, FLAKE_WHOLE, 0).to(torch.int32).to(device),
                None)
        got[name] = (tabs, grid, seed, FLAKE_OFFSET, FLAKE_SPP, w, h, opts,
                     budget, dbg)
    return got


def flake_launch(device="cuda") -> tuple:
    """:func:`~raytracer_tpu_torch.render.cluster_walk.cluster_walk`'s
    arguments for the benchmark cell flake-offline's own launch of the
    wide walk: the sphereflake at 512x512, depth 50, no roulette, a
    29-spp chunk of its 500 after the 7-spp profile launch, on the lane
    map sorted by that launch's cost (``megakernel.plan_from_cost``), as
    ``render_image`` makes it."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import schedule, tables
    from raytracer_tpu_torch.render.megakernel import plan_from_cost
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    w = h = 512
    scene = presets.sphereflake_scene()
    cam = presets.sphereflake_camera(w, h)
    opts = TraceOptions(max_depth=50, russian_roulette_depth=0,
                        exhaust_black=False, near_zero_guard=False)
    tabs = tables.walk_tables(tables.cluster_partition(scene, opts),
                              derive_camera(cam), device)
    plan = schedule.render_schedule(500, w * h, scene.count, opts)
    sizes, _ = schedule.chunk_schedule(500, plan.chunk)
    seed = kernel_seed(0)
    out0, _ = cw.cluster_walk(tabs, cw.identity_map(w, h, device), seed, 0,
                              sizes[0], w, h, opts)
    _, pmap = plan_from_cost(out0[3], w)
    return (tabs, pmap, seed, sizes[0], sizes[1], w, h, opts, None, None)


def extent_of(budget):
    """The live extent (``cluster_walk.live_extent``) that a walk launch
    under ``budget`` takes on the card; None without a budget."""
    return None if budget is None else cw.live_extent(budget)


def walk(*args):
    """:func:`~raytracer_tpu_torch.render.cluster_walk.cluster_walk` on a
    case's arguments (the budget ninth, where there is one), with its
    budget's live extent."""
    return cw.cluster_walk(
        *args, extent=extent_of(args[8] if len(args) > 8 else None))


def launch_args(args) -> tuple:
    """A case of :func:`~raytracer_tpu_torch.render.cluster_walk.
    cluster_walk` (its debug parameters last) as :func:`walk_caller`'s
    ``call`` takes it (the overlay's uniforms last)."""
    return (*args[:9], cw.overlay(args[7], args[9]))


def live_lanes_plain(args):
    """The plain walk of a launch (:func:`~raytracer_tpu_torch.render.
    cluster_walk.cluster_walk`'s arguments) on its lanes with budget
    alone (every lane without a budget), zeros elsewhere: what the plain
    walk gives for the whole map, as each lane's sums are its own and a
    lane without budget reads zero, at the cost of the live lanes
    alone."""
    tabs, pmap, seed, offset, cs, w, h, opts, budget, debug = args
    if budget is None:
        return cw.cluster_walk_plain(*args)
    n = pmap.shape[0]
    live = torch.nonzero(budget > 0).flatten()
    out = torch.zeros((6, n), dtype=torch.float32, device=pmap.device)
    segs = torch.zeros((n,), dtype=torch.int32, device=pmap.device)
    if live.numel():
        o, s = cw.cluster_walk_plain(tabs, pmap[live].contiguous(), seed,
                                     offset, cs, w, h, opts,
                                     budget[live].contiguous(), debug)
        out[:, live] = o
        segs[live] = s
    return out, segs


def flake_check(device="cuda") -> dict:
    """Step 7: the wide walk's cases bitwise against their plain
    versions, each printed; case name → equal. Prints the wide build's
    ``-Xptxas -v`` first."""
    cw._lib(True)  # built at first use
    for inst, line in ptxas_report(cuda_build.build_log(
            "cluster_walk", (cw.WIDE_DEFINE,))):
        print(f"[ptxas wide {inst}] {line}")
    same = {}
    for name, args in flake_cases(device).items():
        out_k, seg_k = walk(*args)
        out_p, seg_p = live_lanes_plain(args)
        rows = [bool(torch.equal(out_k[r], out_p[r]))
                for r in range(out_k.shape[0])]
        same[name] = all(rows) and bool(torch.equal(seg_k, seg_p))
        print(f"[wide {name}] kernel vs plain: rows {rows}, segments "
              f"{torch.equal(seg_k, seg_p)} (total "
              f"{int(seg_k.sum(dtype=torch.int64))})")
    return same


def expected_samples(budget) -> tuple:
    """(samples run as items, all samples) of an adaptive launch under
    ``budget``: all of them run as items where the live end times the
    largest budget is within ``ITEM_CAP``, none otherwise."""
    end, most = (int(v) for v in cw.live_extent(budget).tolist())
    every = int(budget.clamp_min(0).to(torch.int64).sum())
    return (every if end * most <= cw.ITEM_CAP else 0), every


def budgeted(lane_map, n_spp: int, device):
    """The flat scan's adaptive cases: the map with 40 % of its lanes
    (seeded) converged and sorted last, as a re-plan sorts them, and the
    budget: ``n_spp`` or 0. (The base revision's flat scan launched one
    thread a lane; the persistent grid deals the live lanes first, then
    burns through the converged ones.)"""
    g = torch.Generator(device="cpu").manual_seed(5)
    live = torch.rand(lane_map.shape[0], generator=g) >= 0.4
    order = torch.argsort((~live).to(torch.int8), stable=True)
    budget = torch.where(live[order], n_spp, 0).to(torch.int32).to(device)
    return lane_map[order.to(device)].contiguous(), budget


def flat_cases(device="cuda") -> dict:
    """Flat-scan instantiation → the arguments of
    :func:`~raytracer_tpu_torch.render.flat_scan.call` after its ``fn`` at
    its main path's shape: the demo's progressive frame (1920x1080, 1
    spp, depth 8), the adaptive ones a 31-spp chunk of it (roulette from
    bounce 5) with 40 % of the lanes without budget, the debug ones the
    engine's 1280x720 frame with the cursor at the centre's hit. The split
    ones take the demo's containable split. Then K2 and K2s on the
    cover's 487 slots."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import flat_scan as fs
    from raytracer_tpu_torch.render import megakernel
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    got = {}
    for name, (adaptive, stratified, split, debug) in FLAT_VARIANTS.items():
        w, h = (ENGINE_W, ENGINE_H) if debug else (PROG_W, PROG_H)
        scene, cam, *_ = presets.get_config("demo", w, h)
        opts = TraceOptions(
            max_depth=ENGINE_DEPTH, russian_roulette_depth=5 if adaptive else 0,
            sampler="stratified" if stratified else "random",
            adaptive_tolerance=0.2 if adaptive else 0.0, enable_debug=debug)
        choice = megakernel.choose_kernel(scene, derive_camera(cam), opts,
                                          device, analyse=split)
        if (choice.kernel != "flat_scan"
                or fs.is_split(choice.tables, choice.g_full) != split):
            raise RuntimeError(f"{name}: the demo took {choice}")
        lane_map, budget, spp = cw.identity_map(w, h, device), None, 1
        if adaptive:
            spp = ADAPTIVE_CHUNK
            lane_map, budget = budgeted(lane_map, spp, device)
        uniforms = (cw.overlay(opts, engine_debug(scene, cam, device))
                    if debug else None)
        got[name] = (choice.tables, lane_map, kernel_seed(0), 3, spp, w, h,
                     opts, choice.g_full, budget, uniforms)
    # the cover through K2 and K2s (cluster_scan=False): the fixed
    # render's profile chunk, 41 spp at 1200x800, depth 50, rr5
    scene, cam, w, h, _, depth = presets.get_config("cover")
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=5,
                        cluster_scan=False)
    for name, split in (("flat_scan", False), ("flat_scan_split", True)):
        choice = megakernel.choose_kernel(scene, derive_camera(cam), opts,
                                          device, analyse=split)
        got[f"{name} cover"] = (choice.tables, cw.identity_map(w, h, device),
                                kernel_seed(0), 0, COVER_FLAT_CHUNK, w, h,
                                opts, choice.g_full, None, None)
    return got


def counters(lib: ctypes.CDLL, args_by_name: dict) -> dict:
    """The counter build's totals per instantiation, and the derived
    SIMT efficiencies and slab tests per bounce."""
    read = lib.cluster_walk_counters
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * len(COUNTERS))()
    fn = cw.bind(lib)
    got = {}
    for name, args in args_by_name.items():
        if read(buf, 1) != 0:
            raise RuntimeError("counter reset failed")
        out, segs = cw.call(fn, *args, extent_of(args[8]))
        if read(buf, 1) != 0:
            raise RuntimeError("counter read failed")
        c = dict(zip(COUNTERS, (int(v) for v in buf)))
        k = args[0].members.shape[0]
        bounces = max(c["lane_tail"], 1)
        # a trip of the wide walk's list is a pass of its bounce loop
        passes = c["lane_passes"] or c["lane_trips"]
        got[name] = {
            **c,
            "simt_trip": passes / max(32 * c["warp_trips"], 1),
            "simt_expand": c["lane_expand"] / max(32 * c["warp_expand"], 1),
            "simt_fresh": c["lane_fresh"] / max(32 * c["warp_fresh"], 1),
            "simt_visit": c["lane_visit"] / max(32 * c["warp_visit"], 1),
            "simt_tail": c["lane_tail"] / max(32 * c["warp_tail"], 1),
            "trips_per_bounce": c["lane_trips"] / bounces,
            "visits_per_bounce": c["lane_visit"] / bounces,
            "slab_tests_per_bounce": c["slab_tests"] / bounces,
            "flat_slab_tests_per_bounce": k * c["lane_trips"] / bounces,
            "list_peak_mean": c["list_peak"] / bounces,
            "list_inserts_per_bounce": c["list_inserts"] / bounces,
            "list_moves_per_bounce": c["list_moves"] / bounces,
            "sweep_share": c["sweeps"] / bounces,
            "cost_row_equal": int(out[3].sum(dtype=torch.float64))
            == c["lane_trips"],
            "segs_equal": int(segs.sum(dtype=torch.int64)) == c["lane_tail"],
        }
        print(f"[counters {name}] " + ", ".join(
            f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
            for key, val in got[name].items()))
    return got


def flat_counters(lib: ctypes.CDLL, args_by_name: dict) -> dict:
    """The flat counter build's totals per instantiation, its live-lane
    histogram, and the derived SIMT efficiencies and shares."""
    from raytracer_tpu_torch.render import flat_scan as fs

    read = lib.flat_scan_counters
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (len(FLAT_COUNTERS) + LIVE_BINS))()
    call = flat_caller(lib)
    got = {}
    for name, args in args_by_name.items():
        if read(buf, 1) != 0:
            raise RuntimeError("flat counter reset failed")
        out, segs = call(*args)
        if read(buf, 1) != 0:
            raise RuntimeError("flat counter read failed")
        vals = [int(v) for v in buf]
        c = dict(zip(FLAT_COUNTERS, vals))
        live = vals[len(FLAT_COUNTERS):]
        tabs, g_full = args[0], args[8]
        slots = tabs.spheres.shape[0]
        full = g_full if fs.is_split(tabs, g_full) else slots
        bounces = max(c["lane_tail"], 1)
        got[name] = {
            **c,
            "simt_trip": c["lane_trips"] / max(32 * c["warp_trips"], 1),
            "simt_slot": c["lane_slots"] / max(32 * c["warp_slots"], 1),
            "simt_tail": c["lane_tail"] / max(32 * c["warp_tail"], 1),
            "live_per_warp_trip": c["lane_trips"] / max(c["warp_trips"], 1),
            "slots_per_bounce": c["lane_slots"] / bounces,
            "full_slots": full, "slots": slots,
            "lane_root_share": c["lane_root"] / max(c["lane_slots"], 1),
            "warp_no_root_share": 1.0 - c["warp_root"]
            / max(c["warp_slots"], 1),
            "batch_root_share": c["warp_batch_root"]
            / max(c["warp_batch"], 1),
            "live_hist": live,
            "cost_row_equal": int(out[3].sum(dtype=torch.float64))
            == c["lane_trips"],
            "segs_equal": int(segs.sum(dtype=torch.int64)) == c["lane_tail"],
        }
        print(f"[flat counters {name}] " + ", ".join(
            f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
            for key, val in got[name].items()))
    return got


def time_in_turns(calls: dict, args_by_name: dict, repeats: int,
                  smi: str) -> dict:
    """ms of one launch of each build, for each instantiation, timed in
    turns: the builds' order, then its reverse, ``repeats`` times."""
    times = {name: {b: [] for b in calls} for name in args_by_name}
    order = list(calls)
    for name, args in args_by_name.items():
        for b in order:  # warm-up
            calls[b](*args)
        for r in range(repeats):
            for b in (order if r % 2 == 0 else order[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                calls[b](*args)
                end.record()
                torch.cuda.synchronize()
                times[name][b].append(start.elapsed_time(end))
        print(f"[A/B {name}] " + "; ".join(
            f"{b} {' '.join(f'{t:.3f}' for t in ts)} ms (min "
            f"{min(ts):.3f})" for b, ts in times[name].items())
            + f" [{smi}]")
    return times


def bitwise(calls: dict, args_by_name: dict, reference: str) -> dict:
    """Per instantiation and build: every output row and the segments
    bitwise equal to ``reference``'s."""
    same = {}
    for name, args in args_by_name.items():
        ref_out, ref_segs = calls[reference](*args)
        for b, fn in calls.items():
            if b == reference:
                continue
            out, segs = fn(*args)
            rows = [bool(torch.equal(out[r], ref_out[r]))
                    for r in range(out.shape[0])]
            ok = all(rows) and torch.equal(segs, ref_segs)
            same[(name, b)] = ok
            print(f"[bitwise {name}] {b} vs {reference}: rows {rows}, "
                  f"segments {torch.equal(segs, ref_segs)} "
                  f"(total {int(segs.sum(dtype=torch.int64))})")
    return same


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


#: builds of the current source besides its main path's, by kernel: the
#: counter build, and the flat scan in one form for every table size
DEFINED_BUILDS = {
    "cluster_walk": {"counters": ("RT_WALK_COUNTERS",)},
    "flat_scan": {"counters": ("RT_FLAT_COUNTERS",),
                  "each": ("RT_FLAT_BATCHED_MIN=1024",),
                  "batched": ("RT_FLAT_BATCHED_MIN=1",)},
}
#: the builds whose kernels are the current build's own code (the same
#: SASS), launched in another scan form
FORM_BUILDS = ("each", "batched")


def extra_builds(old: Path | None) -> list:
    """(name, csrc, defines) of the builds besides the main path's: the
    base revision's walk and flat scan (where there is one) and
    ``DEFINED_BUILDS``."""
    specs = [(name, cuda_build.CSRC_DIR, d)
             for name, builds in DEFINED_BUILDS.items()
             for d in builds.values()]
    if old is not None:
        specs = [("cluster_walk", old, ()), ("flat_scan", old, ())] + specs
    return specs


def _builds(name: str, old: Path | None) -> dict:
    """Build name → library of ``csrc/<name>.cu``: the base revision's
    (``old``, where there is one), the current one (``new``) and its
    ``DEFINED_BUILDS``, all built at once."""
    builds = {"old": (old, ())} if old is not None else {}
    builds["new"] = (cuda_build.CSRC_DIR, ())
    for label, defines in DEFINED_BUILDS[name].items():
        builds[label] = (cuda_build.CSRC_DIR, defines)
    return dict(zip(builds, cuda_build.build_all(
        (name, *b) for b in builds.values())))


def _callers(paths: dict, caller) -> dict:
    """Build name → ``call(*case)`` for every build a binder here knows
    (the counter build left out)."""
    calls = {}
    for b, path in paths.items():
        if b != "counters":
            got = caller(ctypes.CDLL(str(path)))
            if got is not None:
                calls[b] = got
    return calls


def _print_ptxas(label: str, paths: dict) -> dict:
    got = {}
    for b, path in paths.items():
        if b in FORM_BUILDS:
            continue
        got[b] = ptxas_report(Path(str(path) + ".log").read_text())
        for inst, line in got[b]:
            print(f"[ptxas {label}{b} {inst}] {line}")
    return got


def _print_sass(label: str, paths: dict, kernel: str, out: Path) -> dict:
    """SASS reports of every build but the counter build (the listings
    under ``out/sass``), printed."""
    got = {}
    for b, path in paths.items():
        if b == "counters" or b in FORM_BUILDS:
            continue
        got[b] = sass_report(path, out / "sass" / f"{label}{b}.sass.gz",
                             kernel)
        for inst, rep in got[b].items():
            print(f"[sass {label}{b} {inst}] {rep['insns']} instructions; "
                  f"the {SASS_LOOPS_SHOWN} largest loops "
                  + "; ".join(f"[{lp['start']}, {lp['end']}] {lp['insns']} "
                              f"rsq {lp['rsq']} {lp['by_class']}"
                              for lp in rep["loops"][-SASS_LOOPS_SHOWN:]))
    return got


def thinned_cover(slots: int, seed: int = 0):
    """The cover cut to ``slots`` spheres (at least 4): its ground, its
    three large spheres and a seeded draw of its small ones, in the
    cover's order."""
    import dataclasses

    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scene.spheres import Scene

    cover = presets.cover_scene()
    n = cover.count
    small = np.random.default_rng(seed).choice(
        np.arange(1, n - 3), slots - 4, replace=False)
    keep = torch.from_numpy(
        np.concatenate([[0], np.sort(small), np.arange(n - 3, n)]))
    return Scene(**{f.name: getattr(cover, f.name)[keep]
                    for f in dataclasses.fields(cover)})


def form_cases(device="cuda") -> dict:
    """Case name → the arguments of
    :func:`~raytracer_tpu_torch.render.flat_scan.call` after its ``fn``:
    K2, and K2s where the split analysis splits, on a 1080p 1-spp depth-8
    frame (the progressive demo's) of the demo and of the cover thinned to
    each of ``FORM_SLOTS``."""
    from raytracer_tpu_torch.camera.camera import derive_camera
    from raytracer_tpu_torch.render import flat_scan as fs
    from raytracer_tpu_torch.render import megakernel
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.render.rng import kernel_seed
    from raytracer_tpu_torch.scene import presets

    opts = TraceOptions(max_depth=ENGINE_DEPTH, russian_roulette_depth=0)
    scenes = {"demo": presets.get_config("demo", PROG_W, PROG_H)[:2]}
    cover_cam = presets.cover_camera(PROG_W, PROG_H)
    scenes.update({f"cover/{k}": (thinned_cover(k), cover_cam)
                   for k in FORM_SLOTS})
    got = {}
    for label, (scene, cam) in scenes.items():
        for split in (False, True):
            choice = megakernel.choose_kernel(scene, derive_camera(cam), opts,
                                              device, analyse=split)
            if choice.kernel != "flat_scan":
                raise RuntimeError(f"{label}: took {choice.kernel}")
            if fs.is_split(choice.tables, choice.g_full) != split:
                continue
            slots = choice.tables.spheres.shape[0]
            got[f"{'K2s' if split else 'K2'} {label} {slots} slots"] = (
                choice.tables, cw.identity_map(PROG_W, PROG_H, device),
                kernel_seed(0), 3, 1, PROG_W, PROG_H, opts, choice.g_full,
                None, None)
    return got


def batched_from(times: dict) -> int | None:
    """The smallest table size from which the batched form is the faster
    (best of its turns) in every case of that size or more; None where it
    is not the faster at the largest size."""
    slots = sorted({int(n.split()[-2]) for n in times})
    cut = None
    for k in reversed(slots):
        if any(min(t["batched"]) >= min(t["each"])
               for n, t in times.items() if int(n.split()[-2]) == k):
            break
        cut = k
    return cut


def form_sweep(paths: dict, repeats: int, smi: str) -> dict:
    """Step 6: the two form builds on :func:`form_cases`, bitwise and
    timed in turns, and the cut their times give."""
    calls = _callers({b: paths[b] for b in FORM_BUILDS}, flat_caller)
    args_by_name = form_cases()
    same = bitwise(calls, args_by_name, "each")
    times = time_in_turns(calls, args_by_name, repeats, smi)
    for name, t in times.items():
        print(f"[flat form {name}] each {min(t['each']):.4f} ms, batched "
              f"{min(t['batched']):.4f} ms: batched/each "
              f"{min(t['batched']) / min(t['each']):.3f} [{smi}]")
    cut = batched_from(times)
    print(f"[flat form] the batched form is the faster from {cut} slots "
          f"on (sizes {list(FORM_SLOTS)}, the demo's 9)")
    return {"bitwise": {f"{n} {b}": ok for (n, b), ok in same.items()},
            "times": times, "batched_from": cut}


def flat_ab(old: Path | None, repeats: int, smi: str,
            out: Path = OUT_DIR) -> dict:
    """The flat scan's ten instantiations (the tail they share with the
    walk): the base revision's build, the current one and its two form
    builds, bitwise and timed in turns as the walk is; ``-Xptxas -v``, the
    SASS loops and the counter build; then the form sweep (step 6)."""
    paths = _builds("flat_scan", old)
    result = {"ptxas": _print_ptxas("flat ", paths),
              "sass": _print_sass("flat_", paths, "flat_scan_kernel", out)}
    calls = _callers(paths, flat_caller)
    args_by_name = flat_cases()
    same = bitwise(calls, args_by_name, "new")
    result["bitwise"] = {f"{n} {b}": ok for (n, b), ok in same.items()}
    result["times"] = time_in_turns(calls, args_by_name, repeats, smi)
    result["counters"] = flat_counters(ctypes.CDLL(str(paths["counters"])),
                                       args_by_name)
    result["form"] = form_sweep(paths, repeats, smi)
    result["bitwise"].update({f"form {k}": ok for k, ok in
                              result["form"]["bitwise"].items()})
    return result


def sass_listings(lib: Path, kernel: str = "cluster_walk_kernel") -> dict:
    """Mangled name (as :func:`_functions` keys it) → the instructions of
    each function of ``kernel`` in ``lib``'s SASS, without their addresses
    and encodings: two builds compiled the same code where these are
    equal. Empty where ``cuobjdump`` is missing."""
    text = _sass_text(lib)
    if text is None:
        return {}
    return {name: [_ANON_HASH.sub("", m.group(2) + m.group(3)) for m in
                   map(_SASS_INSN.search, chunk.splitlines()) if m]
            for name, chunk in _functions(text, kernel).items()}


def sass_equal(old: Path, new: Path) -> dict:
    """Per function of the base revision's walk: its SASS the current
    build's, instruction for instruction; printed."""
    a, b = sass_listings(old), sass_listings(new)
    same = {name: b.get(name) == insns for name, insns in a.items()}
    for name, ok in same.items():
        print(f"[sass equal] {name}: {ok} ({len(a[name])} instructions)")
    return same


def wide_ab(old: Path | None, repeats: int, smi: str,
            out: Path = OUT_DIR) -> dict:
    """Step 7's A/B of the wide walk: the base revision's wide build (where
    there is one), the current one and ``WIDE_BUILDS``' others, bitwise on
    :func:`flake_cases` and :func:`flake_launch`, the base and current
    builds timed in turns, ``-Xptxas -v`` and the SASS loops, and both
    counter builds' counts."""
    builds = {"old": (old, (cw.WIDE_DEFINE,))} if old is not None else {}
    builds.update({b: (cuda_build.CSRC_DIR, d)
                   for b, d in WIDE_BUILDS.items()})
    paths = dict(zip(builds, cuda_build.build_all(
        ("cluster_walk", *b) for b in builds.values())))
    result = {"ptxas": _print_ptxas("wide ", paths),
              "sass": _print_sass("wide_", paths, "cluster_walk_kernel",
                                  out)}
    if "old" in paths:
        result["sass_equal"] = sass_equal(paths["old"], paths["new"])
    calls = _callers({b: p for b, p in paths.items() if b != "counters"},
                     walk_caller)
    args_by_name = {name: launch_args(args) for name, args in {
        **flake_cases(),
        f"cluster_walk {FLAKE_LAUNCH}": flake_launch()}.items()}
    same = bitwise(calls, args_by_name, "new")
    result["bitwise"] = {f"{n} {b}": ok for (n, b), ok in same.items()}
    timed = {b: calls[b] for b in ("old", "new") if b in calls}
    result["times"] = time_in_turns(timed, args_by_name, repeats, smi)
    result["counters"] = {
        f"{b} {n}": c for b in ("counters", "list8")
        for n, c in counters(ctypes.CDLL(str(paths[b])),
                             args_by_name).items()}
    return result


def run(old: Path | None, repeats: int, smi: str,
        out: Path = OUT_DIR) -> dict:
    """Steps 1-4 of the module docstring, the SASS listings under
    ``out``; returns what they measured."""
    paths = _builds("cluster_walk", old)
    result = {"smi": smi, "ptxas": _print_ptxas("", paths),
              "sass": _print_sass("", paths, "cluster_walk_kernel", out)}
    if "old" in paths:
        result["sass_equal"] = sass_equal(paths["old"], paths["new"])
    calls = _callers(paths, walk_caller)
    args_by_name = cases()
    same = bitwise(calls, args_by_name, "new")
    result["bitwise"] = {f"{n} {b}": ok for (n, b), ok in same.items()}
    result["times"] = time_in_turns(calls, args_by_name, repeats, smi)
    result["counters"] = counters(ctypes.CDLL(str(paths["counters"])),
                                  args_by_name)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="where walk_ab.json and the SASS listings go")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("walk_ab needs a CUDA card")
    old = parent_csrc()
    smi = smi_line()
    print(smi)
    result = run(old, a.repeats, smi, a.out)
    result["flat"] = flat_ab(old, a.repeats, smi, a.out)
    result["bitwise"].update(
        {f"flat {k}": ok for k, ok in result["flat"]["bitwise"].items()})
    result["wide"] = flake_check()
    result["bitwise"].update(
        {f"wide {k}": ok for k, ok in result["wide"].items()})
    result["wide_ab"] = wide_ab(old, a.repeats, smi, a.out)
    result["bitwise"].update(
        {f"wide {k}": ok for k, ok in result["wide_ab"]["bitwise"].items()})
    a.out.mkdir(parents=True, exist_ok=True)
    (a.out / "walk_ab.json").write_text(json.dumps(result, default=str))
    bad = [k for k, ok in result["bitwise"].items() if not ok]
    bad += [f"{name} counters" for name, c in {
        **result["counters"], **result["flat"]["counters"],
        **result["wide_ab"]["counters"]}.items()
        if not (c["cost_row_equal"] and c["segs_equal"])]
    bad += [f"{name}: no bounce swept" for name, c in
            result["wide_ab"]["counters"].items()
            if name.startswith("list8") and not c["sweeps"]]
    bad += [f"{name}: SASS not the base revision's" for name, ok in {
        **result.get("sass_equal", {}),
        **result["wide_ab"].get("sass_equal", {})}.items() if not ok]
    if bad:
        raise SystemExit(f"walk_ab: builds disagree: {bad}")
    return result


if __name__ == "__main__":
    main()
