"""The yardstick of the rooflines: the work a render needs, counted from
its inputs and its exact outputs only, and the card's published peaks.

Frozen copies of the port's operation account (`utils/profiling.py`)
for the parts every implementation must do: per exact segment the bounce
tail and one ray-sphere test, per completed sample the camera ray. The
closest-hit search beyond one test is charged nothing, since any
acceleration structure may do it; so the share reads the same whatever
kernel does the work, and a kernel that searches less cannot lower its
own bound."""

from __future__ import annotations

import subprocess

OPS_BOUNCE = 150             # the bounce tail: normal, scatter, throughput
OPS_MEMBER = 30              # one exact ray-sphere test
OPS_SAMPLE = 90              # the camera ray
OPS_BOUNCE_ADAPTIVE = 5      # luminance, its square, the sum of squares
OPS_SAMPLE_STRATIFIED = -22  # Kronecker draws in place of hashed ones

#: NVIDIA H100 SXM data sheet: float32 outside the tensor cores (an FMA
#: as two operations), and HBM3 bandwidth
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
#: bytes of a sphere as the scene states it: center, radius, material,
#: albedo, fuzz, index of refraction
SPHERE_BYTES = 10 * 4
FP32_LANES = 128


def render_ops(segments: int, samples: int, adaptive: bool,
               stratified: bool) -> float:
    return (segments * (OPS_BOUNCE + OPS_MEMBER
                        + (OPS_BOUNCE_ADAPTIVE if adaptive else 0))
            + samples * (OPS_SAMPLE
                         + (OPS_SAMPLE_STRATIFIED if stratified else 0)))


def render_bytes(n_spheres: int, width: int, height: int) -> float:
    """The scene read once and the float32 RGB image written once."""
    return n_spheres * SPHERE_BYTES + width * height * 3 * 4


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the float32 peak and the bytes at the HBM rate."""
    return max(ops / FP32_PEAK, nbytes / HBM_BYTES_PER_S)


def card_lines(index: int = 0) -> dict:
    """The card's float32 issue line, one instruction a lane a clock: SMs
    x 128 x the highest SM clock, as `nvidia-smi` reads it. A kernel built
    without fused multiply-adds reaches at most this."""
    import torch

    sms = torch.cuda.get_device_properties(index).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", str(index)],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return {"sms": sms, "sm_clock_mhz": mhz,
            "fp32_line": sms * FP32_LANES * mhz * 1e6}


def card_label(index: int = 0) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True).stdout.strip()


def kernel_share(run, kernel: str):
    """Percent of its roofline that the kernel whose name holds `kernel`
    reached over the profiled renders: their bound (from their exact
    segments and samples) over that kernel's device time. None where the
    trace holds no such kernel."""
    if run.sub is None or not run.sub_units:
        return None
    t = sum(d for name, _, _, d in run.sub["device"] if kernel in name)
    if t <= 0:
        return None
    ops = window_ops(run.sub_units, run.cell.traffic)
    nbytes = len(run.sub_units) * render_bytes(
        run.extra["n_spheres"], run.extra["width"], run.extra["height"])
    return 100.0 * bound_s(ops, nbytes) / t


def window_ops(units, traffic: dict) -> float:
    """The operations of the renders `units` under `traffic`."""
    adaptive = float(traffic.get("adaptive_tolerance", 0.0)) > 0
    stratified = traffic.get("sampler", "random") == "stratified"
    return sum(render_ops(u["segments"], u["samples"], adaptive, stratified)
               for u in units)
