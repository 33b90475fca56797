"""Performance telemetry of the port (counterpart of
``raytracer_tpu/utils/profiling.py``): Mrays/s accounting, a
``torch.profiler`` trace, the render path's span registry, best-of-n
timing, and the flat scan's operation account.

The span registry is the port's own: :func:`span` and :func:`wait` mark
the host phases of a render (``render_image``, ``prep``, ``launch``,
``plan``, ``finish``, ...) and the calls where the host blocks on the
device. Each adds its host seconds and a count to a per-name table that
:func:`counters` reads and :func:`reset_counters` clears (as does either
kernel module's ``reset_launch_counts``). Kernels count on the device
into :func:`device_counts` (the cluster walk's adaptive launches: the
samples they ran as one-sample items, ``walk_item_samples``, and all
their samples, ``walk_samples``), which :func:`counters` reads too.
While a ``torch.profiler`` records, each span is also the annotation
``rt::<name>``, so a :func:`device_trace` shows the host phases over the
device's kernels.

A "ray" is one live ray-bounce segment, counted exactly by the kernels'
segment totals (W·H·spp·mean depth).

The roofline of a render is ``benchmark/roofline.py``'s: it charges only
the work every implementation must do, so a kernel that searches less
cannot lower its own bound. The benchmark reads it as ``walk_roofline``
and ``flat_roofline``. What stays here is the flat scan's account, which
the roofline script (:mod:`raytracer_tpu_torch.scripts.roofline`, the
counterpart of the JAX package's ``scripts/roofline.py``) reads: per unit
of work, the operations the source does, a product and a sum as one each
(the kernels are built with ``-fmad=false``, so none is fused) and a
transcendental as one. Two rates divide them:

- ``FP32_FLOP_PEAK``, NVIDIA's data-sheet float32 rate outside the tensor
  cores (H100 SXM), which counts a fused multiply-add as two operations;
- the card's instruction line (:func:`card_lines`), one float32
  instruction per lane per clock: its SMs × 128 lanes × its highest SM
  clock, read from the card. An unfused product or sum is one
  instruction, so this is the most a kernel built without FMAs can reach;
  the independent-chain probe
  (:mod:`raytracer_tpu_torch.scripts.bench_bf16_chain`) reaches it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import time

import torch

# operations the kernel source does per unit of work, transcendentals
# counted as one: per completed bounce (winner lookup, normal, scatter
# draws and arithmetic, roulette, accumulation) and per sample (camera ray)
OPS_BOUNCE, OPS_SAMPLE = 150, 90
# the adaptive instantiation adds, per completed bounce, the luminance
# (two sums, a product), its square and the sum of squares
OPS_BOUNCE_ADAPTIVE = 5
# the stratified instantiation: each of the four camera draws forms
# index·alpha + rotation hash where the hashed draw forms a counter sum
# (+1 each), and the first bounce's diffuse direction takes 2 Kronecker
# draws, a root, a sine and a cosine (36) where the hashed one takes 3
# draws, exp, log, a root and a normalisation (62); counted for every
# sample, so the bound errs low
OPS_SAMPLE_STRATIFIED = 4 - 26
# the flat scan (flat_scan.cu), per loop trip (one bounce): the ray's dot
# products, reciprocal and counters; per slot its discriminant (two dot
# products, the quadratic's half b and discriminant, its sign test); K2s's
# self-test of the last-hit slot. The tail and the camera ray are
# OPS_BOUNCE's and OPS_SAMPLE's. A slot's root logic (a root, the roots'
# selects, the running minimum) is counted on no slot: only a slot whose
# discriminant is not
# negative needs it (a negative one's candidate is 3e38, which never wins:
# flat_scan.cu's early rejection), and that share is the data's (0.004 of
# the cover's lane slots, 0.2 of the demo frame's), so the bound errs low
OPS_FLAT_TRIP, OPS_SLOT_DISC, OPS_SELF_TEST = 23, 18, 25
# the debug overlay (K3) adds, per completed bounce that hit, the cursor
# distance (3 differences, 3 products, 2 sums, a compare), the outline
# test (a dot product, two compares, the uuid compare) and the colour
# selects. A sample ends at most once on a miss, so it is charged to
# segments less samples: the bound errs low
OPS_BOUNCE_DEBUG = 22

#: H100 SXM data sheet, float32 outside the tensor cores, an FMA as two
FP32_FLOP_PEAK = 67e12
#: H100 SXM data sheet, bf16 on the tensor cores, dense (the one-hot
#: product's MMAs)
BF16_TC_PEAK = 989e12
#: float32 lanes of a Hopper SM, and the 4-byte shared-memory words it
#: serves a clock (32 banks: one warp-wide load without conflict, or one
#: broadcast)
FP32_LANES, SMEM_WORDS = 128, 32


def mrays_per_sec(segments: float, seconds: float) -> float:
    return segments / seconds / 1e6 if seconds > 0 else 0.0


class MraysMeter:
    """Accumulates (segments, wall-clock) across render calls."""

    def __init__(self):
        self.segments = 0.0
        self.seconds = 0.0

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # count the elapsed time even when the block raises, or
            # Mrays/s would be overstated
            self.seconds += time.perf_counter() - t0

    def add_segments(self, n: float) -> None:
        self.segments += float(n)

    @property
    def mrays(self) -> float:
        return mrays_per_sec(self.segments, self.seconds)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Optional ``torch.profiler`` trace around a block, written to
    ``log_dir/trace.json`` (Chrome trace format; CUDA activity where a
    card is present). No-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


#: span name → [count, seconds] since the last :func:`reset_counters`
_SPANS: dict = {}
#: the name under which :func:`counters` reports every :func:`wait`
WAITS = "waits"
#: prefix of a span's profiler annotation
SPAN_PREFIX = "rt::"


class span:
    """``with span(name):`` adds the block's host seconds
    (``time.perf_counter``) and one count to ``name``'s entry of the
    registry, also when the block raises. While a ``torch.profiler``
    records, the block is also ``record_function("rt::" + name)``, nested
    under the annotations open around it; otherwise no annotation is made.
    The registry belongs to the process and is not locked: render from
    one thread."""

    __slots__ = ("name", "t0", "rec")
    #: a wait also counts under :data:`WAITS`
    waits = False

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = None
        if torch._C._autograd._profiler_enabled():
            self.rec = torch.profiler.record_function(SPAN_PREFIX
                                                      + self.name)
            self.rec.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rec is not None:
            self.rec.__exit__(*exc)
        names = (self.name, WAITS) if self.waits else (self.name,)
        for name in names:
            entry = _SPANS.get(name)
            if entry is None:
                _SPANS[name] = [1, dt]
            else:
                entry[0] += 1
                entry[1] += dt
        return False


class wait(span):
    """A :class:`span` around one call in which the host blocks on the
    device (a read back, a synchronize); it also counts one wait under
    :data:`WAITS`. The count is of calls, whether or not the device was
    still busy."""

    __slots__ = ()
    waits = True


#: (names, device index) → the int64 counts that kernels add on the device
_DEVICE_COUNTS: dict = {}


def device_counts(device: torch.device, names: tuple) -> torch.Tensor:
    """The registry's int64 counts ``names`` on ``device``, one a name, in
    a buffer that lives as long as the process: a kernel adds to them
    there, and :func:`counters` reads them as ``(count, 0.0)`` entries
    (summed over devices), which a render never waits for."""
    key = (tuple(names), device.index)
    buf = _DEVICE_COUNTS.get(key)
    if buf is None:
        buf = _DEVICE_COUNTS[key] = torch.zeros((len(names),),
                                                dtype=torch.int64,
                                                device=device)
    return buf


def counters() -> dict:
    """A snapshot of the registry: span name → ``(count, seconds)``, and
    under :data:`WAITS` the number of waits and their seconds. The
    devices' counts (:func:`device_counts`) join it where any is nonzero:
    reading them waits for the device."""
    got = {name: (c, s) for name, (c, s) in _SPANS.items()}
    totals = {}
    for (names, _), buf in _DEVICE_COUNTS.items():
        for name, v in zip(names, buf.tolist()):
            totals[name] = totals.get(name, 0) + v
    if any(totals.values()):
        got.update((name, (v, 0.0)) for name, v in totals.items())
    return got


def reset_counters() -> None:
    """Empty the registry and zero the devices' counts: a window of
    counting starts."""
    _SPANS.clear()
    for buf in _DEVICE_COUNTS.values():
        buf.zero_()


def device_name(device: torch.device) -> str:
    """The name a result carries of the device it ran on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def card_label(device: torch.device) -> str:
    """The device a result ran on: a card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them, or ``cpu``."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


@functools.lru_cache(maxsize=None)
def card_lines(index: int = 0) -> dict:
    """The card's SMs, its highest SM clock (MHz, ``nvidia-smi
    --query-gpu=clocks.max.sm``) and the rates they give a second: float32
    instructions (``fp32``, one per lane per clock), bf16 element operations
    (``bf16``, two per lane) and shared-memory words (``smem_words``)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", str(index)],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    fp32 = sms * FP32_LANES * mhz * 1e6
    return {"sms": sms, "sm_clock_mhz": mhz, "fp32": fp32, "bf16": 2 * fp32,
            "smem_words": sms * SMEM_WORDS * mhz * 1e6}


#: a timed run on a card lasts at least this long
MIN_WINDOW_S = 0.01


def best_seconds(fn, device: torch.device, repeats: int = 3, warm=None):
    """Best of ``repeats`` runs of ``fn()`` in seconds, after one run of
    ``warm`` (``fn`` when None), and the last run's result: timed by CUDA
    events on a card, by the host clock on the CPU. On a card a run is a
    window of back-to-back calls at least ``MIN_WINDOW_S`` long (as many
    as one timed call says), so a short launch's host work overlaps the
    card's and the time per call is the card's."""
    (warm or fn)()
    best, got, calls = None, None, 1
    if device.type == "cuda":
        calls = min(1000, int(MIN_WINDOW_S / _events_seconds(
            fn, 1, device)[0]) + 1)
    for _ in range(repeats):
        if device.type == "cuda":
            dt, got = _events_seconds(fn, calls, device)
        else:
            t0 = time.perf_counter()
            got = fn()
            dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, got


def _events_seconds(fn, calls: int, device: torch.device):
    """Seconds per call of ``calls`` back-to-back calls of ``fn()`` between
    two CUDA events, and the last call's result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(calls):
        got = fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / calls, got


def flat_scan_ops(slots) -> int:
    """The flat scan's operations per segment (one loop trip): the trip's
    own and every slot's discriminant."""
    return OPS_FLAT_TRIP + OPS_SLOT_DISC * slots


def flat_ops(slots, g_full, adaptive, stratified, nsegs, samples,
             debug=False) -> float:
    """Operations of flat-scan launches (K2, K2s and their variants):
    every loop trip is one segment, which tests every slot and runs the
    tail; K2s's self-test runs on every segment but a sample's first."""
    split = g_full is not None and g_full < slots
    return (nsegs * (flat_scan_ops(slots) + OPS_BOUNCE
                     + (OPS_BOUNCE_ADAPTIVE if adaptive else 0))
            + (nsegs - samples) * ((OPS_SELF_TEST if split else 0)
                                   + (OPS_BOUNCE_DEBUG if debug else 0))
            + samples * (OPS_SAMPLE
                         + (OPS_SAMPLE_STRATIFIED if stratified else 0)))
