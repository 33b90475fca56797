"""The roofline yardstick of renders with a shutter, frozen: the work
`roofline.py` charges a render, and what moving spheres add to it that
any implementation must do, counted from the render's inputs and exact
outputs only.

- per exact segment, `roofline.py`'s bounce tail and one sphere test,
  and that sphere's centre at the ray's time, c0 + t (c1 - c0): three
  products and three sums, unfused (OPS_CENTRE);
- per completed sample, the camera ray and the ray's time, charged as
  the port charges a hashed draw (OPS_TIME_DRAW: the counter and its
  salt summed, the product by the golden ratio, the xor with the pixel's
  hash, lowbias32's three xor-shifts and two products, the shift to 24
  bits, the conversion and the scale);
- nothing for the checker, which only ground hits pay;
- bytes: each sphere at 16 floats (`roofline.py`'s 10, the end centre and
  the odd colour) and the float32 RGB image, once each.

As in `roofline.py`, the closest-hit search beyond one test is charged
nothing, so the share reads the same whatever acceleration structure
does the work."""

from __future__ import annotations

from benchmark import roofline

OPS_CENTRE = 6
OPS_TIME_DRAW = 14
SPHERE_BYTES = 16 * 4


def render_ops(segments: int, samples: int, adaptive: bool = False,
               stratified: bool = False) -> float:
    return (roofline.render_ops(segments, samples, adaptive, stratified)
            + segments * OPS_CENTRE + samples * OPS_TIME_DRAW)


def render_bytes(n_spheres: int, width: int, height: int) -> float:
    return n_spheres * SPHERE_BYTES + width * height * 3 * 4


def window_ops(units, traffic: dict) -> float:
    """The operations of the renders `units` under `traffic`."""
    adaptive = float(traffic.get("adaptive_tolerance", 0.0)) > 0
    stratified = traffic.get("sampler", "random") == "stratified"
    return sum(render_ops(u["segments"], u["samples"], adaptive, stratified)
               for u in units)


def kernel_share(run, kernel: str):
    """Percent of this count's roofline that the kernel whose name holds
    `kernel` reached over the profiled renders (`roofline.bound_s` of
    their operations and bytes over that kernel's device time); None
    where the trace holds no such kernel."""
    if run.sub is None or not run.sub_units:
        return None
    t = sum(d for name, _, _, d in run.sub["device"] if kernel in name)
    if t <= 0:
        return None
    ops = window_ops(run.sub_units, run.cell.traffic)
    nbytes = len(run.sub_units) * render_bytes(
        run.extra["n_spheres"], run.extra["width"], run.extra["height"])
    return 100.0 * roofline.bound_s(ops, nbytes) / t


def mfu(run):
    """The profiled renders' operations of this count over the wall time
    they took, host gaps included, at `roofline.FP32_PEAK`, in percent;
    None without a profiled window."""
    if run.sub is None or not run.sub_units or run.sub["window_s"] <= 0:
        return None
    ops = window_ops(run.sub_units, run.cell.traffic)
    return 100.0 * ops / (run.sub["window_s"] * roofline.FP32_PEAK)
