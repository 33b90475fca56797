"""Device faults: which ones a retry can clear, and the retry (counterpart
of ``raytracer_tpu/utils/resilience.py``).

The JAX package retries after its TPU worker crashed and came back. A
local CUDA card has no worker; its faults are of two kinds:

- **recoverable**: an allocation failed (``torch.OutOfMemoryError``, or a
  launcher's ``cudaErrorMemoryAllocation``). The context stays usable:
  free the allocator's cached blocks and run the whole call again;
- **sticky**: a kernel touched an illegal or misaligned address, hit a
  trap, or its launch failed. CUDA then fails every later call in the
  process with the same error, so nothing in it can recover: the fault
  re-raises at once as :class:`DeviceContextLost`, whose message says the
  process must be restarted.

Anything else (a build failure, a bad argument, an error code of neither
kind) re-raises unchanged. A fault is sorted by its exception type and its
CUDA error code; only a torch error that carries no code is read by its
message, the text CUDA gives the code.
"""

from __future__ import annotations

import functools
import logging
import os
import time

import torch

from raytracer_tpu_torch.utils.cuda_build import CudaLaunchError

log = logging.getLogger(__name__)

#: cudaErrorMemoryAllocation
RECOVERABLE_CODES = {2: "out of memory"}
#: the errors after which CUDA documents that "the process must be
#: terminated and relaunched", with the text CUDA gives each
STICKY_CODES = {
    700: "an illegal memory access was encountered",
    702: "the launch timed out and was terminated",
    710: "device-side assert triggered",
    714: "hardware stack error",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    717: "operation not supported on global/shared address space",
    718: "invalid program counter",
    719: "unspecified launch failure",
}
RECOVERABLE, STICKY = "recoverable", "sticky"

RESTART_MESSAGE = (
    "the CUDA context is lost after a sticky device fault; no call in "
    "this process can use the card again: restart the process"
)


class DeviceContextLost(RuntimeError):
    """A sticky device fault; the original error is its ``__cause__``."""


def _kind_of_code(code: int) -> str | None:
    if code in RECOVERABLE_CODES:
        return RECOVERABLE
    if code in STICKY_CODES:
        return STICKY
    return None


def fault_kind(exc: BaseException) -> str | None:
    """``'recoverable'``, ``'sticky'`` or None (not a device fault)."""
    if isinstance(exc, torch.OutOfMemoryError):
        return RECOVERABLE
    if isinstance(exc, CudaLaunchError):
        return _kind_of_code(exc.code)
    if not isinstance(exc, RuntimeError):
        return None
    code = getattr(exc, "error_code", None)
    if isinstance(code, int):
        return _kind_of_code(code)
    if isinstance(exc, torch.AcceleratorError) or str(exc).startswith(
            "CUDA error:"):
        # a torch error without a code: CUDA's text for the code
        text = str(exc)
        for code, said in (*STICKY_CODES.items(),
                           *RECOVERABLE_CODES.items()):
            if f"CUDA error: {said}" in text:
                return _kind_of_code(code)
    return None


def is_device_fault(exc: BaseException) -> bool:
    """True for a fault that a retry can clear (a recoverable one)."""
    return fault_kind(exc) == RECOVERABLE


def is_sticky_fault(exc: BaseException) -> bool:
    """True for a fault after which the process must be restarted."""
    return fault_kind(exc) == STICKY


def raise_if_sticky(exc: BaseException) -> None:
    """Raises :class:`DeviceContextLost` from ``exc`` where it is
    sticky."""
    if is_sticky_fault(exc):
        raise DeviceContextLost(f"{RESTART_MESSAGE} ({exc})") from exc


def free_cached_memory() -> None:
    """Hand the caching allocator's free blocks back to the card."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def retry_on_device_fault(fn=None, *, retries: int | None = None,
                          delay_s: float = 0.0):
    """Decorator: run ``fn`` again after a recoverable device fault, with
    the allocator's cache emptied and ``delay_s`` seconds slept in
    between.

    Retries ``retries`` times (default: env RAYTRACER_TPU_DEVICE_RETRIES,
    else 2). A sticky fault raises :class:`DeviceContextLost` at once;
    anything else re-raises unchanged. The wrapped call must be
    restartable from its arguments, and it runs the same code each time.

    ``delay_s`` is the JAX package's argument with another default, on
    purpose: there 10 s let a crashed TPU worker come back; here the
    fault is an allocation that failed, the cache is emptied at once, and
    there is nothing to wait for, so 0.0.
    """

    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            n = retries
            if n is None:
                n = int(os.environ.get("RAYTRACER_TPU_DEVICE_RETRIES", "2"))
            attempt = 0
            while True:
                try:
                    return f(*args, **kwargs)
                except Exception as e:  # noqa: BLE001 — sorted below
                    raise_if_sticky(e)
                    if not is_device_fault(e) or attempt >= n:
                        raise
                    attempt += 1
                    log.warning("device fault (%s); retry %d/%d",
                                str(e)[:120], attempt, n)
                # out of the handler, the failed attempt's frames and the
                # tensors they held are released
                free_cached_memory()
                if delay_s > 0:
                    time.sleep(delay_s)

        return inner

    return wrap(fn) if fn is not None else wrap
