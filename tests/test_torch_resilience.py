"""Device faults in the port: the cases of the JAX package's
``tests/test_resilience.py`` with torch's exceptions, built in Python.

- ``torch.OutOfMemoryError`` and a launcher's ``CudaLaunchError`` with
  code 2 (``cudaErrorMemoryAllocation``) are retried, with the allocator's
  cache emptied in between, and recover;
- codes 700 and 719, a ``torch.AcceleratorError`` carrying such a code or
  only CUDA's text for it, are not retried: they raise
  ``DeviceContextLost`` with the restart message at once;
- an nvcc failure from ``cuda_build``, a ``CudaLaunchError`` of another
  code and any other error re-raise unchanged on the first attempt;
- the budget (``RAYTRACER_TPU_DEVICE_RETRIES``) runs out;
- ``render_image`` retries the whole render on its own device, and the
  retried image is bitwise the unfaulted one;
- the engine absorbs an OOM in its step, rebuilds the session from its
  seed and renders again on the next tick: bitwise the frames of a fresh
  engine (``device='cpu'``); a sticky fault propagates.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.app.engine import Engine
from raytracer_tpu_torch.render import api, pallas_kernel
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.utils import cuda_build, resilience
from raytracer_tpu_torch.utils.cuda_build import CudaLaunchError
from raytracer_tpu_torch.utils.resilience import (
    DeviceContextLost,
    retry_on_device_fault,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Intra-op threads only contend between test workers, and with them
    PyTorch's exp and log were seen to return a thread's chunk off by
    1e-5..1e-4 (ROADMAP §C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def emptied(monkeypatch):
    """Counts the cache frees between attempts."""
    calls = []
    monkeypatch.setattr(resilience, "free_cached_memory",
                        lambda: calls.append(1))
    return calls


def accelerator_error(text: str, code=None):
    e = torch.AcceleratorError(text)
    if code is not None:
        e.error_code = code
    return e


RECOVERABLE = {
    "oom": lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 80.00 GiB"),
    "launch_alloc": lambda: CudaLaunchError("cluster_walk", 2),
    "accelerator_alloc_code": lambda: accelerator_error(
        "CUDA error: out of memory", 2),
}
STICKY = {
    "launch_700": lambda: CudaLaunchError("flat_scan", 700),
    "launch_719": lambda: CudaLaunchError("cluster_walk", 719),
    "accelerator_code_716": lambda: accelerator_error(
        "CUDA error: misaligned address", 716),
    "accelerator_text_700": lambda: accelerator_error(
        "CUDA error: an illegal memory access was encountered\nCUDA "
        "kernel errors might be asynchronously reported"),
    "runtime_text_719": lambda: RuntimeError(
        "CUDA error: unspecified launch failure"),
}
UNCHANGED = {
    "nvcc": lambda: RuntimeError("nvcc failed for csrc/flat_scan.cu:\n"
                                 "error: expected a ';'"),
    "launch_invalid_value": lambda: CudaLaunchError("cluster_walk", 1),
    "value": lambda: ValueError("logic bug"),
    "accelerator_other": lambda: accelerator_error(
        "CUDA error: invalid argument", 1),
}


@pytest.mark.parametrize("make", RECOVERABLE.values(), ids=RECOVERABLE)
def test_retry_recovers_after_recoverable_faults(make, emptied):
    calls = []

    @retry_on_device_fault(retries=3)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise make()
        return 42

    assert resilience.fault_kind(make()) == resilience.RECOVERABLE
    assert flaky() == 42
    assert len(calls) == 3
    assert len(emptied) == 2  # the cache freed before each retry


@pytest.mark.parametrize("make", STICKY.values(), ids=STICKY)
def test_sticky_fault_raises_restart_message_at_once(make, emptied):
    calls = []

    @retry_on_device_fault(retries=3)
    def poisoned():
        calls.append(1)
        raise make()

    with pytest.raises(DeviceContextLost, match="restart the process") as got:
        poisoned()
    assert type(got.value.__cause__) is type(make())
    assert len(calls) == 1
    assert emptied == []


@pytest.mark.parametrize("make", UNCHANGED.values(), ids=UNCHANGED)
def test_other_errors_reraise_unchanged(make, emptied):
    calls = []
    raised = make()

    @retry_on_device_fault(retries=3)
    def broken():
        calls.append(1)
        raise raised

    with pytest.raises(type(raised)) as got:
        broken()
    assert got.value is raised
    assert resilience.fault_kind(raised) is None
    assert len(calls) == 1
    assert emptied == []


def test_nvcc_failure_is_never_a_device_fault(monkeypatch, tmp_path):
    """A build that fails raises cuda_build's own RuntimeError, which the
    retry passes through on the first attempt."""

    class Failed:
        returncode, stdout, stderr = 1, "", "error: expected a ';'"

    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.subprocess, "run",
                        lambda *a, **k: Failed())
    calls = []

    @retry_on_device_fault(retries=3)
    def build():
        calls.append(1)
        cuda_build.build("flat_scan")

    with pytest.raises(RuntimeError, match="nvcc failed") as got:
        build()
    assert not isinstance(got.value, DeviceContextLost)
    assert len(calls) == 1


@pytest.mark.parametrize("retries, env, attempts", [
    (2, None, 3), (None, "1", 2), (None, None, 3),
])
def test_retry_gives_up_after_budget(monkeypatch, emptied, retries, env,
                                     attempts):
    """``retries`` of the call, else the env's, else 2: then the fault
    itself re-raises."""
    if env is None:
        monkeypatch.delenv("RAYTRACER_TPU_DEVICE_RETRIES", raising=False)
    else:
        monkeypatch.setenv("RAYTRACER_TPU_DEVICE_RETRIES", env)
    calls = []

    @retry_on_device_fault(retries=retries)
    def always_out_of_memory():
        calls.append(1)
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.OutOfMemoryError):
        always_out_of_memory()
    assert len(calls) == attempts


def test_render_image_retries_the_whole_render(monkeypatch, caplog):
    """One injected OOM: the render runs again on the same device and
    gives the unfaulted image and segments bit for bit; one warning."""
    scene, cam, *_ = presets.get_config("two_sphere", 32, 16)
    want, want_stats = api.render_image(scene, cam, 32, 16, 2, 5,
                                        return_stats=True, device="cpu")
    real, devices = pallas_kernel.render, []

    def once(*args, **kwargs):
        devices.append(args[7])
        if len(devices) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(*args, **kwargs)

    monkeypatch.setattr(pallas_kernel, "render", once)
    with caplog.at_level("WARNING", logger=resilience.__name__):
        got, got_stats = api.render_image(scene, cam, 32, 16, 2, 5,
                                          return_stats=True, device="cpu")
    assert devices == [torch.device("cpu")] * 2
    assert torch.equal(got, want)
    assert got_stats["segments_exact"] == want_stats["segments_exact"]
    assert len([r for r in caplog.records if "retry 1/" in r.message]) == 1


def test_engine_tick_recovers_from_device_fault(monkeypatch):
    """An OOM mid-session resets the state instead of ending the loop;
    the next ticks render the frames of a fresh engine of the same seed."""
    scene, cam, *_ = presets.get_config("two_sphere", 32, 16)

    def engine():
        eng = Engine(scene, cam, 32, 16, max_depth=2, seed=3, device="cpu")
        eng.set_paused(False)
        return eng

    eng = engine()
    eng.run(3)
    assert eng.render_state.render_count == 3
    drained = eng.total_segments
    assert drained > 0

    def crash(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(eng, "_step_fn", lambda spp: crash)
    assert eng.tick(1000.0) is False  # absorbed, no render this frame
    assert eng.render_state.render_count == 0
    assert eng.render_state.frame == 0
    assert eng.app.render_count == 0 and eng.app.should_render
    assert eng._step_cache == {}
    assert eng.total_segments == drained  # the host's total stays
    monkeypatch.undo()

    fresh = engine()
    for i in range(4):
        assert eng.tick(1016.0 + 16 * i)
        assert fresh.tick(16.0 * (i + 1))
        np.testing.assert_array_equal(eng.framebuffer(), fresh.framebuffer())
    assert np.isfinite(eng.framebuffer()).all()


@pytest.mark.parametrize("make", [STICKY["launch_700"], UNCHANGED["value"]],
                         ids=["sticky", "other"])
def test_engine_tick_propagates_other_faults(monkeypatch, make):
    scene, cam, *_ = presets.get_config("two_sphere", 32, 16)
    eng = Engine(scene, cam, 32, 16, max_depth=2, device="cpu")
    eng.set_paused(False)
    assert eng.tick(0.0)

    def crash(*a, **k):
        raise make()

    monkeypatch.setattr(eng, "_step_fn", lambda spp: crash)
    want = DeviceContextLost if resilience.is_sticky_fault(make()) else \
        type(make())
    with pytest.raises(want):
        eng.tick(16.0)
