#!/usr/bin/env python3
"""Readings that set a cell's limits: the comparison numbers of sound runs
of the program over many seeds, and of the control over a few.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 3 [--control-seeds 3] [--out chiprun_out/x.json]

One process sets the cell up once, then for each seed runs a window of
`--seconds` of the cell's own traffic and compares it with the reference
as a run does. The control is the reference computed in bfloat16, one
precision below the configuration's float32, put in the program's place
on the same renders, pixels and picks of the first `--control-seeds`
seeds. A limit lies above every sound reading and below every control
reading (PERF.md gives both). Needs the card."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, run

    run.pin_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    import raytracer_tpu_torch as port

    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload, pending=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    session = harness.session_class(cell.traffic["entry"])(port, cell,
                                                            device)
    counters = run.Counters()
    rows = []
    for k, seed in enumerate(seeds):
        session.warm(seed)
        torch.cuda.synchronize()
        rec = harness.Run(cell, seed, args.seconds, False)
        session.window(rec, torch.cuda.synchronize, counters)
        t = time.perf_counter()
        sound = session.check(rec, device)
        ref_s = time.perf_counter() - t
        row = {"seed": seed, "units": len(rec.units), "sound": sound,
               "reference_s": ref_s}
        if k < args.control_seeds:
            row["control"] = session.check(rec, device, control=True)
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = [n for n, v in rows[0]["sound"].items()
             if isinstance(v, (int, float))]
    summary = {"cell": cell.name, "card": _card()}
    for n in names:
        summary[n] = {
            "sound_max": max(r["sound"][n] for r in rows),
            "control_min": min((r["control"][n] for r in rows
                                if "control" in r), default=None)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))
    return 0


def _card() -> str:
    from benchmark import roofline

    return roofline.card_label(0)


if __name__ == "__main__":
    sys.exit(main())
