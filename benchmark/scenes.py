"""Scene arrays the benchmark makes itself, from a configuration's
`scene` entry: either the spheres listed in the file, or a named
generator with its seed. Arrays are float32 / int32 numpy, the fields of
the port's `scene_from_numpy`."""

from __future__ import annotations

import numpy as np

DIFFUSE, METAL, GLASS = 0, 1, 2


def _arrays(spheres) -> dict:
    """(center, radius, material, albedo, fuzz, ior) tuples -> arrays."""
    return {
        "center": np.array([s[0] for s in spheres], np.float32),
        "radius": np.array([s[1] for s in spheres], np.float32),
        "material_type": np.array([s[2] for s in spheres], np.int32),
        "albedo": np.array([s[3] for s in spheres], np.float32),
        "fuzz": np.array([s[4] for s in spheres], np.float32),
        "refraction_index": np.array([s[5] for s in spheres], np.float32),
        "active": np.ones(len(spheres), np.float32),
    }


def rtiow_random_scene(seed: int) -> list:
    """Shirley's `random_scene()` (Ray Tracing in One Weekend v3.2,
    section 13.1), drawn from numpy's `default_rng(seed)`: the ground, a
    22 x 22 grid of small spheres (80 % diffuse with albedo the product
    of two uniforms, 15 % metal with albedo in [0.5, 1) and fuzz in [0,
    0.5), 5 % glass of index 1.5), none within 0.9 of (4, 0.2, 0), and
    the three large spheres. Seed 0 gives 487 spheres."""
    rng = np.random.default_rng(seed)
    out = [((0.0, -1000.0, 0.0), 1000.0, DIFFUSE, (0.5, 0.5, 0.5), 0.0,
            0.0)]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.array(center)
                              - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = tuple(rng.random(3) * rng.random(3))
                out.append((center, 0.2, DIFFUSE, albedo, 0.0, 0.0))
            elif choose < 0.95:
                albedo = tuple(rng.random(3) * 0.5 + 0.5)
                fuzz = float(rng.random() * 0.5)
                out.append((center, 0.2, METAL, albedo, fuzz, 0.0))
            else:
                out.append((center, 0.2, GLASS, (1.0, 1.0, 1.0), 0.0, 1.5))
    out.append(((0.0, 1.0, 0.0), 1.0, GLASS, (1.0, 1.0, 1.0), 0.0, 1.5))
    out.append(((-4.0, 1.0, 0.0), 1.0, DIFFUSE, (0.4, 0.2, 0.1), 0.0, 0.0))
    out.append(((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0, 0.0))
    return out


GENERATORS = {"rtiow_random_scene": rtiow_random_scene}
MATERIALS = {"diffuse": DIFFUSE, "metal": METAL, "glass": GLASS}


def scene_arrays(entry: dict) -> dict:
    """The arrays of a configuration's `scene`: {"generator": name,
    "seed": n} or {"spheres": [[cx, cy, cz, r, material, ar, ag, ab,
    fuzz, ior], ...]} with material one of diffuse, metal, glass."""
    if "generator" in entry:
        return _arrays(GENERATORS[entry["generator"]](int(entry["seed"])))
    return _arrays([((s[0], s[1], s[2]), s[3], MATERIALS[s[4]],
                     (s[5], s[6], s[7]), s[8], s[9])
                    for s in entry["spheres"]])
