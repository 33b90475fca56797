"""P4 (the closest-hit scan probe, ``csrc/probe_scan.cu``) and P1's
one-hot product (``csrc/probe_gather.cu`` ``kOneHot``) against the base
revision of their kernels, on the card, with each build's registers and
SASS.

    python -m raytracer_tpu_torch.scripts.probe_ab [--repeats 4] [--out DIR]

The base revision is :mod:`.walk_ab`'s (:func:`.walk_ab.parent_csrc`:
``HEAD`` where the working tree's kernels differ from it, else its
parent, unpacked under ``build/walk_parent/``; without it the old builds
are left out). Both probes keep their C interface, so one binder serves
every build.

1. Builds, one ``nvcc`` each and all at once: the base revision's two
   sources and the current ones. Prints ``-Xptxas -v``
   of each instantiation (registers, spill bytes) and from the SASS
   (``cuobjdump -sass``): per scan instantiation, its slot loop's
   instructions per slot and ray by opcode (one ``MUFU.RSQ`` a slot and
   ray: the root) and its local-memory instructions; per one-hot
   instantiation, its HMMA instructions and its trip loop's instructions
   by class.
2. Holds every build bitwise against the current build: each scan block
   at (8,128) x ``SCAN_CHECK_ITERS`` and at (1056,128) x 400 (the
   card-filling shape), and the one-hot product at one replica and at
   ``probe_gather.fill_reps`` (256) with the script's 5000 trips and with
   an odd count, which runs the trip loop's tail; the odd count also
   against the plain version.
3. Times each build in turns (old, new, then the reverse order,
   ``repeats`` times) by CUDA events around one launch:
   each scan block at (1056,128) x 400, the one-hot product with 256
   replicas and 5000 trips.

Writes the results to ``<out>/probe_ab.json`` (``build/probe_ab`` by
default) and the SASS listings, gzipped, under ``<out>/sass/``. Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from raytracer_tpu_torch.scripts import bench_scan_layout as bs
from raytracer_tpu_torch.scripts import probe_gather as pg
from raytracer_tpu_torch.scripts import walk_ab
from raytracer_tpu_torch.utils import cuda_build

OUT_DIR = walk_ab.ROOT / "build" / "probe_ab"
SOURCES = ("probe_scan", "probe_gather")
KERNELS = ("scan_kernel", "gather_kernel", "onehot_mma_kernel")
SCAN_CHECK_ITERS = 50
#: the one-hot product's trips for the tail check: odd, so the last trip
#: runs alone
ODD_ITERS = pg.ITERS - 1


def extra_builds(old: Path | None) -> list:
    """(name, csrc, defines) of the builds besides the kernels' own: the
    base revision's two sources, where there is one."""
    return [] if old is None else [(name, old, ()) for name in SOURCES]


def build_paths(name: str, old: Path | None) -> dict:
    """Build label → library of ``csrc/<name>.cu``: ``old`` (the base
    revision's, where there is one) and ``new``, built at once."""
    builds = {"old": (old, ())} if old is not None else {}
    builds["new"] = (cuda_build.CSRC_DIR, ())
    return dict(zip(builds, cuda_build.build_all(
        (name, *b) for b in builds.values())))


# --- compiler reports -----------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPERTIES = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def instantiation(mangled: str) -> str | None:
    """``kernel<args>`` of a mangled kernel name (the template arguments
    as ``Li512E``), or None for another function."""
    kernel = next((k for k in KERNELS if k in mangled), None)
    if kernel is None:
        return None
    return f"{kernel}<{','.join(re.findall(r'L[bi](\d+)E', mangled))}>"


def ptxas(log: str) -> dict:
    """Instantiation → registers and spill bytes (stores + loads), from
    ``-Xptxas -v``."""
    got, inst, entry = {}, None, None
    for line in log.splitlines():
        m, p = _ENTRY.search(line), _PROPERTIES.search(line)
        if m:
            entry, inst = m.group(1), instantiation(m.group(1))
        elif p and p.group(1) != entry:
            inst = None  # a device function's own report
        elif inst is not None and _REGS.search(line):
            got.setdefault(inst, {})["registers"] = int(
                _REGS.search(line).group(1))
        elif inst is not None and _SPILL.search(line):
            s = _SPILL.search(line)
            got.setdefault(inst, {})["spill_bytes"] = (int(s.group(1))
                                                       + int(s.group(2)))
    return got


def sass_functions(lib: Path, dump: Path | None = None) -> dict:
    """Instantiation → its SASS as (address, opcode, operands), from
    ``cuobjdump -sass`` (the listing gzipped to ``dump``); empty where
    the tool is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_bytes(gzip.compress(text.encode()))
    got = {}
    for chunk in text.split("Function : ")[1:]:
        inst = instantiation(chunk.splitlines()[0].strip())
        if inst is not None:
            got[inst] = [(int(m.group(1), 16), m.group(2), m.group(3))
                         for m in map(walk_ab._SASS_INSN.search,
                                      chunk.splitlines()) if m]
    return got


def loops(insns: list) -> list:
    """The loops of a listing (a backward branch and its target), as
    (first, last) indices, smallest first."""
    at = {addr: j for j, (addr, _, _) in enumerate(insns)}
    found = []
    for j, (_, op, rest) in enumerate(insns):
        t = walk_ab._SASS_TARGET.search(rest.strip())
        if op.startswith("BRA") and t:
            start = at.get(int(t.group(1), 16))
            if start is not None and start <= j:
                found.append((start, j))
    return sorted(found, key=lambda lp: lp[1] - lp[0])


def opcodes(insns: list) -> dict:
    """Opcode (its first word) → count."""
    got = {}
    for _, op, _ in insns:
        base = op.split(".")[0] if not op.startswith("MUFU") else op
        got[base] = got.get(base, 0) + 1
    return got


def scan_sass(insns: list) -> dict:
    """The scan's slot loop: the smallest loop holding a root
    (``MUFU.RSQ``, one a slot and ray); its instructions, slots x rays
    (its roots), instructions per slot and ray by opcode and by class;
    local-memory instructions in the whole kernel."""
    got = {"insns": len(insns),
           "local": sum(walk_ab._sass_class(op) == "local"
                        for _, op, _ in insns)}
    for first, last in loops(insns):
        body = insns[first:last + 1]
        roots = sum(op.startswith("MUFU.RSQ") for _, op, _ in body)
        if roots:
            classes = {}
            for _, op, _ in body:
                c = walk_ab._sass_class(op)
                classes[c] = classes.get(c, 0) + 1
            got.update({
                "loop_insns": len(body), "slot_rays": roots,
                "per_slot_ray": len(body) / roots,
                "by_opcode": {k: v / roots for k, v in sorted(
                    opcodes(body).items(), key=lambda kv: -kv[1])},
                "by_class": {k: v / roots for k, v in classes.items()}})
            break
    return got


def onehot_sass(insns: list) -> dict:
    """The one-hot product: its HMMA instructions, and its trip loop (the
    smallest loop holding an HMMA, else the smallest loop): instructions,
    HMMAs and instructions by class."""
    got = {"insns": len(insns),
           "hmma": sum(op.startswith("HMMA") for _, op, _ in insns),
           "local": sum(walk_ab._sass_class(op) == "local"
                        for _, op, _ in insns)}
    found = loops(insns)
    with_mma = [lp for lp in found if any(
        op.startswith("HMMA") for _, op, _ in insns[lp[0]:lp[1] + 1])]
    for first, last in with_mma[:1] or found[:1]:
        body = insns[first:last + 1]
        classes = {}
        for _, op, _ in body:
            c = ("hmma" if op.startswith("HMMA")
                 else walk_ab._sass_class(op))
            classes[c] = classes.get(c, 0) + 1
        got.update({"loop_insns": len(body), "by_class": classes})
    return got


def reports(paths: dict, out: Path) -> dict:
    """Build → instantiation → its ptxas line and SASS counts, printed."""
    got = {}
    for b, path in paths.items():
        regs = ptxas(Path(str(path) + ".log").read_text())
        sass = sass_functions(path, out / "sass"
                              / f"{path.stem}-{b}.sass.gz")
        got[b] = {}
        for inst in sorted(set(regs) | set(sass)):
            rep = dict(regs.get(inst, {}))
            if inst in sass:
                rep.update(onehot_sass(sass[inst])
                           if inst.startswith("onehot") or inst ==
                           "gather_kernel<2>" else
                           scan_sass(sass[inst])
                           if inst.startswith("scan") else
                           {"insns": len(sass[inst])})
            got[b][inst] = rep
            print(f"[probe A/B {b} {inst}] " + ", ".join(
                f"{k} {v:.2f}" if isinstance(v, float) else
                f"{k} {v}" for k, v in rep.items() if k not in (
                    "by_opcode", "by_class")))
            for key in ("by_opcode", "by_class"):
                if key in rep:
                    print(f"[probe A/B {b} {inst}] {key}: " + ", ".join(
                        f"{k} {v:.3g}" for k, v in rep[key].items()))
    return got


# --- callers ----------------------------------------------------------------


def scan_caller(lib: ctypes.CDLL):
    """``call(sph, block, rows, iters)`` → (rows, 128) sums of ``lib``'s
    scan."""
    fn = lib.probe_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(sph, block, rows, iters):
        out = torch.empty((rows, bs.LANES), dtype=torch.float32,
                          device=sph.device)
        err = fn(sph.data_ptr(), out.data_ptr(), block, sph.shape[0],
                 rows * bs.LANES, iters,
                 torch.cuda.current_stream(sph.device).cuda_stream)
        cuda_build.check_launch("probe_scan", err)
        return out

    return call


def gather_caller(lib: ctypes.CDLL):
    """``call(tbl, mode, rows, iters, reps)`` → (reps, rows, W) sums of
    ``lib``'s gather probe."""
    fn = lib.probe_gather_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(tbl, mode, rows, iters, reps):
        s, w = tbl.shape
        out = torch.empty((reps, rows, w), dtype=torch.float32,
                          device=tbl.device)
        err = fn(tbl.data_ptr(), out.data_ptr(), pg.MODES.index(mode), s, w,
                 rows, reps, iters,
                 torch.cuda.current_stream(tbl.device).cuda_stream)
        cuda_build.check_launch("probe_gather", err)
        return out

    return call


def scan_cases(device="cuda") -> tuple:
    """(bitwise cases, timed cases): name → (sph, block, rows, iters)."""
    sph = bs.scan_table().to(device)
    check, timed = {}, {}
    for block in bs.BLOCKS:
        name = bs.variant_name(block)
        check[f"{name} ({bs.R_SUB},128) x{SCAN_CHECK_ITERS}"] = (
            sph, block, bs.R_SUB, SCAN_CHECK_ITERS)
        fill = (sph, block, bs.FILL_ROWS, bs.FILL_ITERS)
        check[f"{name} ({bs.FILL_ROWS},128) x{bs.FILL_ITERS}"] = fill
        timed[name] = fill
    return check, timed


def onehot_cases(device="cuda") -> tuple:
    """(bitwise cases, timed cases): name → (tbl, mode, rows, iters,
    reps), at the one-hot case's shape (``probe_gather.CASES``)."""
    label, mode, shape, rows = next(c for c in pg.CASES if c[1] == "onehot")
    tbl = pg.gather_table(shape).to(device)
    fill = pg.fill_reps(mode, rows, shape[1])
    name = pg.variant_name(mode)
    check = {f"{name} x{r} x{n}": (tbl, mode, rows, n, r)
             for r in (1, fill) for n in (pg.ITERS, ODD_ITERS)}
    return check, {f"{name} x{fill}": (tbl, mode, rows, pg.ITERS, fill)}


def bitwise(calls: dict, cases: dict, reference: str = "new") -> dict:
    """Case and build → every output bitwise the reference build's."""
    same = {}
    for name, args in cases.items():
        want = calls[reference](*args)
        for b, fn in calls.items():
            if b != reference:
                same[f"{name} {b}"] = bool(torch.equal(fn(*args), want))
        print(f"[probe A/B bitwise {name}] " + ", ".join(
            f"{b} {same[f'{name} {b}']}" for b in calls if b != reference)
            + f" (vs {reference})")
    return same


def run(old: Path | None, repeats: int, smi: str,
        out: Path = OUT_DIR) -> dict:
    """Steps 1-3 of the module docstring; returns what they measured:
    per source its reports, bitwise results and times in turns."""
    result = {"smi": smi, "base": None if old is None else
              old.parent.parent.name}
    for name, caller, make in (("probe_scan", scan_caller, scan_cases),
                               ("probe_gather", gather_caller,
                                onehot_cases)):
        paths = build_paths(name, old)
        got = {"reports": reports(paths, out)}
        calls = {b: caller(ctypes.CDLL(str(p))) for b, p in paths.items()}
        check, timed = make()
        got["bitwise"] = bitwise(calls, check)
        if name == "probe_gather":
            for case, args in check.items():
                if args[3] == ODD_ITERS:
                    plain = pg.gather_probe_plain(*args)
                    ok = bool(torch.equal(calls["new"](*args), plain))
                    got["bitwise"][f"{case} plain"] = ok
                    print(f"[probe A/B bitwise {case}] new vs plain {ok}")
        got["times"] = walk_ab.time_in_turns(calls, timed, repeats, smi)
        result[name] = got
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe_ab.json").write_text(json.dumps(result, default=str))
    return result


def failures(result: dict) -> list:
    """What the run must not show: a build that disagrees, a spill in a
    current scan instantiation, a one-hot product without HMMA."""
    bad = [f"{name} {k}" for name in SOURCES
           for k, ok in result[name]["bitwise"].items() if not ok]
    for inst, rep in result["probe_scan"]["reports"]["new"].items():
        if inst.startswith("scan_kernel") and rep.get("spill_bytes", 0):
            bad.append(f"{inst} spills {rep['spill_bytes']} bytes")
    hmma = [rep.get("hmma", 0) for inst, rep in
            result["probe_gather"]["reports"]["new"].items()
            if inst.startswith("onehot_mma_kernel")]
    if not hmma or min(hmma) < 1:
        bad.append("a one-hot instantiation without HMMA")
    return bad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="where probe_ab.json and the SASS listings go")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_ab needs a CUDA card")
    old = walk_ab.parent_csrc()
    smi = walk_ab.smi_line()
    print(smi)
    result = run(old, a.repeats, smi, a.out)
    bad = failures(result)
    if bad:
        raise SystemExit(f"probe_ab: {bad}")
    return result


if __name__ == "__main__":
    main()
