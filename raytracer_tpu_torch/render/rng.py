"""Counter-based RNG and sampling primitives of the cluster walk, on
tensors (counterpart of ``raytracer_tpu/render/pallas_kernel.py``
``_lowbias32`` … ``_unit_vec`` and ``_r2_fixed``; the CUDA kernel carries
the same functions in ``csrc/cluster_walk.cu``).

Unsigned 32-bit values ride in int64 tensors holding [0, 2^32). Products
are formed from 16-bit halves of the constant so no intermediate leaves
the int64 range: the integer streams are bit-exact with the JAX package.
Float constants are Python doubles that torch rounds once to float32,
as JAX's weakly typed scalars are.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
TWO_PI = 6.2831853071795864
INV_24 = 1.0 / 16777216.0  # 2^-24
GOLDEN = 0x9E3779B9


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x in [0, 2^32) held in int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 integer hash (constants by the Hash Prospector)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def key_data(seed) -> tuple:
    """Key data ``(kd0, kd1)`` as host ints: an integer seed gives those
    of ``jax.random.PRNGKey(seed)``, which without 64-bit mode (never
    enabled by the package) are (0, seed mod 2^32); a pair (a JAX key's
    ``key_data``, or a ``(2,)`` uint32 array) is taken as it is."""
    if isinstance(seed, (int, np.integer)):
        return 0, int(seed) & M32
    kd = np.asarray(seed).reshape(-1)
    if kd.shape != (2,):
        raise ValueError(f"key data must be 2 values, got shape {kd.shape}")
    return int(kd[0]) & M32, int(kd[1]) & M32


def kernel_seed_from_key(kd) -> int:
    """The int32 kernel seed of key data [kd0, kd1], as the JAX package
    derives it: int32(kd0 ^ lowbias32(kd1))."""
    h = int(lowbias32(torch.tensor(int(kd[1]) & M32, dtype=torch.int64)))
    v = (int(kd[0]) ^ h) & M32
    return v - (1 << 32) if v >= (1 << 31) else v


def kernel_seed(seed: int) -> int:
    """The int32 kernel seed of ``jax.random.PRNGKey(seed)``."""
    return kernel_seed_from_key(key_data(seed))


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 numpy values,
    as ``jax.random`` runs it: key (k0, k1), counter words (x0, x1)."""
    with np.errstate(over="ignore"):
        k0, k1, x0, x1 = (np.asarray(v, np.uint32) for v in (k0, k1, x0, x1))
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for j in range(5):
            for r in _THREEFRY_ROTATIONS[j % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(j + 1) % 3]
            x1 = x1 + ks[(j + 2) % 3] + np.uint32(j + 1)
    return x0, x1


def fold_in(kd, data):
    """``jax.random.fold_in`` of key data ``kd`` with 32-bit ``data``
    (an int or a numpy array of them): Threefry-2x32 of the key over the
    counter words (0, data). Returns the new key data (host ints for an
    int ``data``, uint32 arrays otherwise)."""
    k0, k1 = (np.asarray(v, np.uint32) for v in kd)
    d = np.asarray(np.asarray(data, np.int64) & M32, np.uint32)
    y0, y1 = threefry2x32(k0, k1, np.zeros_like(d), d)
    if y0.ndim == 0:
        return int(y0), int(y1)
    return y0, y1


#: counters of the stratified sampler's per-pixel rotations: −4 for the
#: four camera dimensions, −8 for the three first-bounce dimensions; every
#: per-sample counter block starts at a counter >= 0
ROT_CAMERA = 0xFFFFFFFC
ROT_BOUNCE0 = 0xFFFFFFF8


def hash32(pix: torch.Tensor, ctr, salt: int) -> torch.Tensor:
    """hash(pixel ⊕ golden·(ctr + salt)), all mod 2^32; ``ctr`` is a
    tensor or a Python int in [0, 2^32)."""
    c = mul32((ctr + salt) & M32, GOLDEN)
    return lowbias32(pix ^ c)


def to_u01(h: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a 32-bit hash → float32 in [0, 1)."""
    return (h >> 8).to(torch.float32) * INV_24


def u01(pix, ctr, salt: int) -> torch.Tensor:
    return to_u01(hash32(pix, ctr, salt))


def r2_fixed(pix: torch.Tensor, rot: int, d: int, s_u: torch.Tensor,
             a_fix: int) -> torch.Tensor:
    """The ``s_u``-th Kronecker point of dimension ``d`` in 32-bit fixed
    point: the pixel's hash at counter ``rot`` + ``d`` is the rotation
    and (rotation + s·alpha) wraps mod 2^32; top 24 bits → [0, 1)."""
    return to_u01((hash32(pix, rot, d) + mul32(s_u, a_fix)) & M32)


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def normalize3(x, y, z, eps=1e-20):
    inv = torch.rsqrt(torch.clamp_min(x * x + y * y + z * z, eps))
    return x * inv, y * inv, z * inv


def unit_sphere(pix, ctr, salt: int):
    """A point in the unit ball; the cube root is exp(log(u)/3)."""
    hx = u01(pix, ctr, salt) * 2.0 - 1.0
    phi = u01(pix, ctr, salt + 1) * TWO_PI
    u = u01(pix, ctr, salt + 2)
    r = torch.exp(torch.log(torch.clamp_min(u, 1e-12)) * (1.0 / 3.0))
    s = torch.sqrt(torch.clamp_min(1.0 - hx * hx, 0.0))
    return r * s * torch.sin(phi), r * s * torch.cos(phi), r * hx


def unit_vec(pix, ctr, salt: int):
    x, y, z = unit_sphere(pix, ctr, salt)
    return normalize3(x, y, z)
