"""The adaptive render's re-plan after each chunk, over the live lanes.

A pixel whose confidence interval has met the tolerance gets budget 0:
it takes no more samples, so its sums, its chunk statistics and its
decision never change again. A re-plan therefore reads only the lanes
that had budget, whose count ``L`` the previous plan left: lanes [0, L)
of the map are live, the rest converged earlier. After chunk k it

1. folds lane j < L's sums into its pixel's accumulator (and, with the
   stratified sampler, the chunk's mean luminance into the pixel's chunk
   statistics: :func:`chunk_mean_stats`), adds its bounces to the exact
   int64 total, and makes :func:`plan_adaptive`'s convergence decision
   for those pixels;
2. sorts those L pixels as :func:`plan_adaptive` sorts them: the live ones in
   descending cost, ties and the newly converged ones after them in
   pixel order;
3. writes lanes [0, L) of the plan (order, ``pixel_map``, ``budget``: the
   next chunk's spp or 0) in place; lanes past L keep theirs, so the map
   stays a permutation, and the new live count stays where the next
   re-plan reads it.

Lanes past L have budget 0 and zero output, so every sum, count and
decision is bit for bit the full-width re-plan's; lane order is placement
only. After the last chunk only step 1's sums run.

On CUDA tensors :class:`CudaPlan` runs the chain ``csrc/adaptive_plan.cu``
(one accumulate pass, a tile sort and merge passes; the count never comes
back to the host) and writes the walk's live extent into a buffer held
for the stream (:func:`extent_buffer`); each of its re-plans adds the
lanes it read and the image's lane count to the device counts
``PLAN_COUNTS`` (``utils.profiling.device_counts``). Elsewhere
:class:`PlainPlan` runs the same steps in tensor code, through
:func:`chunk_mean_stats` and :func:`plan_adaptive` (the JAX package's
``_plan_adaptive``, which the port's parity tests hold it to), and
counts nothing, as the plain walk counts nothing."""

from __future__ import annotations

import ctypes

import torch

from raytracer_tpu_torch.render import schedule
from raytracer_tpu_torch.render.tables import upload
from raytracer_tpu_torch.utils import cuda_build, profiling

#: ``(name, defines)`` of the chain's library, as ``cuda_build.load``
#: takes it
LIBRARY = ("adaptive_plan", ())
#: lanes a re-plan read, and re-plans times the image's lanes
PLAN_COUNTS = ("plan_lanes", "plan_slots")


def plan_adaptive(acc: torch.Tensor, width: int, cs: int, tol: float,
                  chunk_stats: torch.Tensor | None = None,
                  t975: torch.Tensor | None = None):
    """Adaptive variant of ``megakernel.plan_from_cost``: ``(inv, pixel_map,
    budget)`` with unconverged pixels first in descending cost, converged
    ones last, and a lane-order sample budget (``cs``, or 0 for a
    converged pixel).

    ``acc`` rows: [r, g, b, cost, n, Σ lum²], cumulative. A pixel has
    converged when n >= ``schedule.ADAPTIVE_MIN_N`` and the 95 % half-width
    of its mean luminance is within tol · (mean + ``ADAPTIVE_ABS_FLOOR``).
    The half-width is 1.96 · sqrt(var / n) from the per-sample variance.
    With ``chunk_stats`` ([n_c, Σ m, Σ m²] per pixel, m a full chunk's mean
    luminance; the stratified sampler only) and n_c >= 3 it is the smaller
    of that and the Student-t interval on the between-chunk-mean variance,
    which sees the stratification that the per-sample variance cannot.
    ``t975`` is ``schedule.T975_BY_CHUNKS`` on ``acc``'s device."""
    n = acc[4]
    n_safe = torch.clamp_min(n, 1.0)
    mean = (acc[0] + acc[1] + acc[2]) * (1.0 / 3.0) / n_safe
    var = torch.clamp_min(acc[5] / n_safe - mean * mean, 0.0)
    ci = 1.96 * torch.sqrt(var / n_safe)
    if chunk_stats is not None:
        if t975 is None:
            t975 = t975_table(acc.device)
        n_c = chunk_stats[0]
        nc_safe = torch.clamp_min(n_c, 1.0)
        m_mean = chunk_stats[1] / nc_safe
        s2 = (torch.clamp_min(chunk_stats[2] / nc_safe - m_mean * m_mean, 0.0)
              * nc_safe / torch.clamp_min(n_c - 1.0, 1.0))
        t = t975[torch.clamp(n_c.to(torch.int64), 0, t975.shape[0] - 1)]
        ci_c = t * torch.sqrt(s2 / nc_safe)
        ci = torch.where(n_c >= 3.0, torch.minimum(ci, ci_c), ci)
    converged = (n >= schedule.ADAPTIVE_MIN_N) & (
        ci <= tol * (mean + schedule.ADAPTIVE_ABS_FLOOR)
    )
    key = torch.where(converged, 3e38, -acc[3])
    order = torch.argsort(key, stable=True)
    inv = torch.argsort(order, stable=True)
    pixel_map = torch.stack([order % width, order // width], 1)
    budget = torch.where(converged, 0, cs)[order].to(torch.int32)
    return inv, pixel_map.to(torch.int32).contiguous(), budget.contiguous()


def t975_table(device) -> torch.Tensor:
    """``schedule.T975_BY_CHUNKS`` on ``device``, copied without waiting
    for the card (an adaptive render makes it after its first launch)."""
    return upload(torch.tensor(schedule.T975_BY_CHUNKS, dtype=torch.float32),
                  device)


def chunk_mean_stats(chunk_stats: torch.Tensor, acc: torch.Tensor,
                     lsum_prev: torch.Tensor, n_prev: torch.Tensor):
    """Add one chunk to the per-pixel between-chunk statistics [n_c, Σ m,
    Σ m²]: m is the chunk's mean luminance, from the accumulator after the
    chunk and its rgb sum and count before it; a pixel that took no
    sample adds nothing."""
    dn = acc[4] - n_prev
    sampled = (dn > 0.0).to(torch.float32)
    m_c = ((acc[0] + acc[1] + acc[2] - lsum_prev) * (1.0 / 3.0)
           / torch.clamp_min(dn, 1.0))
    return chunk_stats + torch.stack(
        [sampled, m_c * sampled, m_c * m_c * sampled]
    )


class PlainPlan:
    """One adaptive render's plans as tensor code: the chain's steps in
    its order. ``acc`` is the profile chunk's (6, n) sums, rendered in
    identity order; ``acc``, ``stats``, ``segments``, ``order``,
    ``pixel_map``, ``budget`` and ``live`` (the lanes with budget) are
    the render's state after each :meth:`step`."""

    def __init__(self, acc: torch.Tensor, width: int, tol: float,
                 stratified: bool):
        dev = acc.device
        n = acc.shape[1]
        self.acc, self.width, self.tol, self.n = acc, width, tol, n
        self.stats = (torch.zeros((3, n), dtype=torch.float32, device=dev)
                      if stratified else None)
        self.t975 = t975_table(dev)
        self.segments = torch.zeros((), dtype=torch.int64, device=dev)
        self.order = torch.arange(n, dtype=torch.int32, device=dev)
        self.pixel_map = torch.empty((n, 2), dtype=torch.int32, device=dev)
        self.budget = torch.empty((n,), dtype=torch.int32, device=dev)
        self.live = n
        self.extent = None

    def step(self, out: torch.Tensor | None, segs: torch.Tensor,
             cs: int | None):
        """Fold the chunk just rendered (``out`` None: the profile chunk,
        already in ``acc``) and, unless ``cs`` is None (the last chunk),
        re-plan the next chunk of ``cs`` samples."""
        lanes = self.live
        pix = self.order[:lanes].to(torch.int64)
        a = self.acc[:, pix]
        lsum_prev, n_prev = a[0] + a[1] + a[2], a[4]
        if out is not None:
            a = a + out[:, :lanes]
            self.acc[:, pix] = a
        self.segments += segs[:lanes].sum(dtype=torch.int64)
        st = None
        if self.stats is not None:
            st = self.stats[:, pix]
            if out is not None:
                st = chunk_mean_stats(st, a, lsum_prev, n_prev)
                self.stats[:, pix] = st
        if cs is None:
            return
        # plan_adaptive over these pixels taken in pixel order, as an
        # image one pixel wide: its map's second column orders them
        by_pixel, cols = torch.sort(pix)
        _, lane_map, budget = plan_adaptive(
            a[:, cols], 1, cs, self.tol, None if st is None else st[:, cols],
            self.t975)
        new = by_pixel[lane_map[:, 1].to(torch.int64)]
        self.order[:lanes] = new.to(torch.int32)
        self.pixel_map[:lanes] = torch.stack(
            [new % self.width, new // self.width], 1).to(torch.int32)
        self.budget[:lanes] = budget
        self.live = int((budget > 0).sum())


class CudaPlan(PlainPlan):
    """:class:`PlainPlan`'s state on the card, stepped by the chain
    ``csrc/adaptive_plan.cu``: ``lives`` holds each plan's live count on
    the device (the host never reads it), ``keys`` the sort's buffers,
    ``extent`` the walk's live extent [live count, cs or 0]. ``launches``
    counts the chain's launches (one a step) in the process."""

    launches = 0

    def __init__(self, acc, width, tol, stratified, steps: int):
        _check_rows("acc", acc, acc, 6, torch.float32)
        super().__init__(acc, width, tol, stratified)
        dev = acc.device
        self.live = None
        self.lives = torch.zeros((steps + 1,), dtype=torch.int32,
                                 device=dev)
        self.keys = torch.empty((2, self.n), dtype=torch.int64, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.extent = extent_buffer(dev, self.stream)
        self.counts = profiling.device_counts(dev, PLAN_COUNTS)
        self.index = 0

    def step(self, out, segs, cs):
        # the chain reads out as (6, n) float32 rows and segs as (n,)
        # int32, by raw pointer
        if out is not None:
            _check_rows("out", out, self.acc, 6, torch.float32)
        _check_rows("segs", segs, self.acc, None, torch.int32)
        i = self.index
        self.index += 1
        live = self.lives.data_ptr()
        with torch.cuda.device(self.acc.device):
            err = _lib()(
                None if out is None else out.data_ptr(), segs.data_ptr(),
                self.acc.data_ptr(),
                None if self.stats is None else self.stats.data_ptr(),
                self.segments.data_ptr(), self.order.data_ptr(),
                self.pixel_map.data_ptr(), self.budget.data_ptr(),
                None if i == 0 else live + 4 * i,
                None if cs is None else live + 4 * (i + 1),
                self.keys.data_ptr(), self.t975.data_ptr(),
                self.t975.shape[0], self.counts.data_ptr(),
                self.extent.data_ptr(), self.n, self.width,
                int(out is not None), 0 if cs is None else int(cs),
                max(1, (self.n - 1).bit_length()), self.tol,
                float(schedule.ADAPTIVE_MIN_N), schedule.ADAPTIVE_ABS_FLOOR,
                self.stream)
        cuda_build.check_launch("adaptive_plan", err)
        CudaPlan.launches += 1


def _check_rows(name: str, t: torch.Tensor, acc: torch.Tensor,
                rows: int | None, dtype: torch.dtype) -> None:
    """Raises unless ``t`` is a contiguous ``dtype`` tensor on ``acc``'s
    CUDA device, of shape (``rows``, n) (or (n,) where ``rows`` is None)
    for ``acc``'s n lanes: the chain indexes it by raw pointer."""
    cuda_build.check_cuda(t)
    n = acc.shape[-1]
    shape = (n,) if rows is None else (rows, n)
    if (tuple(t.shape) != shape or t.dtype != dtype
            or not t.is_contiguous() or t.device != acc.device):
        raise ValueError(
            f"the re-plan takes {name} as a contiguous {dtype} tensor of "
            f"shape {shape} on {acc.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
            + ("" if t.is_contiguous() else " (not contiguous)"))


def start(acc: torch.Tensor, width: int, tol: float, stratified: bool,
          steps: int) -> PlainPlan:
    """The plans of an adaptive render of ``steps`` chunks whose profile
    chunk's sums are ``acc``: :class:`CudaPlan` on a CUDA device,
    :class:`PlainPlan` elsewhere."""
    if acc.device.type == "cuda":
        return CudaPlan(acc, width, tol, stratified, steps)
    return PlainPlan(acc, width, tol, stratified)


_EXTENTS = {}


def extent_buffer(dev: torch.device, stream: int) -> torch.Tensor:
    """The live extent that the chain writes for ``stream`` on ``dev``
    and the walk's next launch reads: (2,) int32, held for the process.
    A buffer freed before the launch is enqueued could go to the next
    allocation on the stream and be overwritten before the kernel reads
    it; one held for the stream is rewritten only by the next re-plan,
    after that launch."""
    key = (dev.index, stream)
    if key not in _EXTENTS:
        _EXTENTS[key] = torch.zeros((2,), dtype=torch.int32, device=dev)
    return _EXTENTS[key]


def _lib():
    return bind(cuda_build.load(*LIBRARY))


def bind(lib: ctypes.CDLL):
    """``adaptive_plan_launch`` of a loaded library, its argument types
    set."""
    fn = lib.adaptive_plan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
