"""Spans and the device trace of a `--trace 1` run.

Spans are the benchmark's own, around its calls into each layer of the
port: a host interval (perf_counter) kept in memory for the whole
window, and a `torch.profiler.record_function` of the same name, so that
the profiler's timeline shows what the host was doing. The profiler
covers a steady sub-window of whole renders or frames (one discarded
warm-up step first), and its Chrome trace is reduced here to what the
per-layer readers take: device activity by name, the device's busy time,
the top-level PyTorch calls, and the idle gaps named by the span open on
the host."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

SPAN_PREFIX = "bench::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans of one run: (name, start, end) in perf_counter seconds.
    Enabled, each span is also a profiler annotation; its interval is kept
    once `collect` is set (after the profiled sub-window, whose frames the
    profiler slows)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.collect = False
        self.items: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            yield
        if self.collect:
            self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> list:
        return [b - a for n, a, b in self.items if n == name]


class SubWindow:
    """torch.profiler over steps `first` .. `first + active - 1` of the
    window, after one warm-up step; `step()` is called after each step.
    `result` is the reduced trace once the active steps have run."""

    def __init__(self, first: int, active: int):
        import torch

        self.result = None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(
                wait=max(0, first - 1), warmup=1, active=active, repeat=1),
            on_trace_ready=self._ready)
        self._prof.__enter__()
        self.steps = 0

    def _ready(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.result = reduce(json.load(f))
        finally:
            os.unlink(path)

    @property
    def done(self) -> bool:
        return self.result is not None

    def step(self) -> None:
        if not self.done:
            self._prof.step()
            self.steps += 1

    def close(self) -> None:
        self._prof.__exit__(None, None, None)


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def reduce(trace: dict) -> dict:
    """The parts of a Chrome trace the readers take, times in seconds:
    the profiled window (first profiler step's start to the later of the
    last step's end and the last device activity), device activities
    (name, category, start, duration), the device's busy time in the
    window, top-level aten calls, and the idle gaps with the innermost
    benchmark span open on the host at each gap's start."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in events
             if str(e.get("name", "")).startswith("ProfilerStep#")]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    if not steps:
        return {"window_s": 0.0, "busy_s": 0.0, "device": [],
                "aten_top": 0, "gaps": []}
    t0 = min(e["ts"] for e in steps)
    t1 = max([e["ts"] + e["dur"] for e in steps]
             + [e["ts"] + e["dur"] for e in dev])
    device = [(e["name"], e["cat"], (e["ts"] - t0) * 1e-6, e["dur"] * 1e-6)
              for e in dev]
    busy_iv = [(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
               for e in dev if e["ts"] + e["dur"] > t0 and e["ts"] < t1]
    busy = _union(busy_iv)
    # top-level aten calls: not inside another aten call of their thread
    aten_top = 0
    by_tid: dict = {}
    for e in events:
        if e.get("cat") == "cpu_op" and str(e["name"]).startswith("aten::"):
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for calls in by_tid.values():
        calls.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = -1.0
        for e in calls:
            if e["ts"] >= end:
                aten_top += 1
                end = e["ts"] + e["dur"]
    # idle gaps between merged device activity, named by the innermost
    # benchmark span open at the gap's start
    gaps = []
    merged = []
    for a, b in sorted(busy_iv):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        open_ = [s for s in spans if s["ts"] <= a < s["ts"] + s["dur"]]
        name = (min(open_, key=lambda s: s["dur"])["name"] if open_
                else "(no benchmark span)")
        gaps.append((name, (b - a) * 1e-6))
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6,
            "device": device, "aten_top": aten_top, "gaps": gaps}


def breakdown(reduced: dict, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle time
    by the span the host was in, each as [name, seconds], longest
    first."""
    by_op: dict = {}
    for name, _, _, dur in reduced["device"]:
        by_op[name] = by_op.get(name, 0.0) + dur
    by_gap: dict = {}
    for name, dur in reduced["gaps"]:
        by_gap[name] = by_gap.get(name, 0.0) + dur
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}
