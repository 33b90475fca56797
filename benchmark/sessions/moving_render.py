"""The offline driver of scenes with a shutter: `render_image` back to
back, as `harness.OfflineSession`, on a configuration whose spheres move
over the shutter and may wear the checker texture. It reads the
configuration's sphere list itself (`scenes.py` reads static spheres
only), passes the end centres and odd colours to the program's
`scene_from_numpy`, and checks the kept renders against
`reference_motion.py`, with `reference.py`'s comparison numbers
(`pixel_mismatch`, `pixel_gap`, `segment_gap`) and its bfloat16
control."""

from __future__ import annotations

import numpy as np

from benchmark import harness, reference_motion, schedule, scenes

#: the columns of a sphere in the configuration's list: `scenes.py`'s ten
#: (centre, radius, material, albedo, fuzz, index), then the centre at
#: the shutter's close and the checker's odd colour
MATERIALS = {**scenes.MATERIALS, "checker": reference_motion.CHECKER}


def motion_arrays(entry: dict) -> dict:
    """The arrays of a configuration's `scene` with a shutter:
    {"spheres": [[cx, cy, cz, r, material, ar, ag, ab, fuzz, ior, c1x,
    c1y, c1z, or, og, ob], ...]}, material one of diffuse, metal, glass,
    checker. The fields of `scene_from_numpy`, and `center1` and
    `albedo_odd`."""
    s = entry["spheres"]
    out = scenes._arrays([((r[0], r[1], r[2]), r[3], MATERIALS[r[4]],
                           (r[5], r[6], r[7]), r[8], r[9]) for r in s])
    out["center1"] = np.array([r[10:13] for r in s], np.float32)
    out["albedo_odd"] = np.array([r[13:16] for r in s], np.float32)
    return out


class Session(harness.OfflineSession):
    """`harness.OfflineSession` over a scene with a shutter."""

    def __init__(self, port, cell, device, overrides=None):
        self.port, self.cell, self.device = port, cell, device
        self.size = harness.size_of(cell, overrides)
        cfg = dict(cell.config, max_depth=self.size["max_depth"])
        w, h = self.size["width"], self.size["height"]
        self.arrays = motion_arrays(cfg["scene"])
        static = {k: v for k, v in self.arrays.items()
                  if k not in ("center1", "albedo_odd")}
        self.basis = harness.basis_of(cfg["camera"], w / h)
        self.scene = port.scene_from_numpy(
            **static, device=device, center1=self.arrays["center1"],
            albedo_odd=self.arrays["albedo_odd"])
        self.camera = port.camera_from_numpy(self.basis)
        self.opts = harness._opts(port, cfg, cell.traffic)
        if self.opts.adaptive_tolerance > 0.0:
            raise ValueError("the motion walk renders fixed spp only")
        self.adaptive = False

    def _reference(self, seed, pix, cam, n_sph, device, dtype):
        s = self.size
        w, h = s["width"], s["height"]
        sizes = schedule.fixed_sizes(s["spp"], w * h, n_sph, s["max_depth"])
        img, segs = reference_motion.fixed_pixels(
            self.arrays, cam, w, h, seed, pix, s["spp"], s["max_depth"],
            sizes, self.opts.sampler, dtype, device)
        return img, segs, None
