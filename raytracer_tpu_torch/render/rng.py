"""The port's two random number generators, on tensors.

- The counter hash of the kernels (counterpart of
  ``raytracer_tpu/render/pallas_kernel.py`` ``_lowbias32`` … ``_unit_vec``
  and ``_r2_fixed``; the CUDA kernels carry the same functions in
  ``csrc/common.cuh``).
- Threefry-2x32 as ``jax.random`` runs it (partitionable bits), which the
  jnp tracer (``render/tracer.py``) draws from: ``fold_in``, ``split`` and
  the key data on the host as ints, ``random_bits`` / ``uniform`` /
  ``uniforms`` on the device, one Threefry for both.

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
    if not np.issubdtype(kd.dtype, np.integer):
        raise TypeError(f"a key is an int seed or 2 integers of key data, "
                        f"got {seed!r}")
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


def threefry2x32_tensor(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) as ``jax.random`` runs
    it, on uint32 values held in int64 tensors or in Python ints: key (k0,
    k1) and counter words (x0, x1), broadcasting together. Returns the two
    output words, in [0, 2^32). On Python ints (the host's key
    derivation) it runs no tensor operation.

    x0 is reduced mod 2^32 only at the end (it stays below 2^38: it
    gains one word a round and one at each key injection); x1 is reduced
    after each xor, so every rotation reads a 32-bit word. Only x0's low
    32 bits reach x1 or the output, so the result is the uint32 one."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & M32
    for j in range(5):
        for r in _THREEFRY_ROTATIONS[j % 2]:
            x0 += x1
            hi = x1 << r
            x1 >>= 32 - r
            x1 |= hi
            x1 ^= x0
            x1 &= M32
        x0 += ks[(j + 1) % 3]
        x1 += ks[(j + 2) % 3]
        x1 += j + 1
        x1 &= M32
    return x0 & M32, x1


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) or (
        isinstance(v, np.ndarray) and v.ndim == 0)


def threefry2x32(k0, k1, x0, x1):
    """:func:`threefry2x32_tensor` on uint32 numpy values (or ints),
    for the host's key derivation; returns uint32 arrays."""
    k0, k1, x0, x1 = torch.broadcast_tensors(*(
        torch.from_numpy(np.asarray(v, np.uint32).astype(np.int64))
        for v in (k0, k1, x0, x1)))
    y0, y1 = threefry2x32_tensor(k0, k1, x0, x1)
    return (y0.numpy().astype(np.uint32), y1.numpy().astype(np.uint32))


def fold_in(kd, data):
    """``jax.random.fold_in`` of key data ``kd`` with 32-bit ``data``
    (an int or a numpy array of them): Threefry-2x32 of the key over the
    counter words (0, data). Returns the new key data (host ints for an
    int ``data`` and key, uint32 arrays otherwise)."""
    if _is_int(kd[0]) and _is_int(kd[1]) and _is_int(data):
        return threefry2x32_tensor(int(kd[0]) & M32, int(kd[1]) & M32, 0,
                                   int(data) & M32)
    d = np.asarray(np.asarray(data, np.int64) & M32, np.uint32)
    y0, y1 = threefry2x32(kd[0], kd[1], np.zeros_like(d), d)
    return y0, y1


def fold(key, *counters: int) -> tuple:
    """Fold a chain of counters into key data ``key``, one ``fold_in``
    each."""
    for c in counters:
        key = fold_in(key, c)
    return key


def split(kd, n: int = 2) -> list:
    """``jax.random.split(key, n)`` of key data: Threefry-2x32 of the key
    over the counter words (0, i), i < n; a list of n key-data pairs of
    host ints."""
    k0, k1 = int(kd[0]) & M32, int(kd[1]) & M32
    return [threefry2x32_tensor(k0, k1, 0, i) for i in range(n)]


def _counters(n: int, device) -> torch.Tensor:
    """The low counter word of a draw of n values: its flat C-order
    index (the high word, i >> 32, is 0 below 2^32 values)."""
    if n >= 1 << 32:
        raise ValueError(f"a draw of {n} values needs the high counter word")
    return torch.arange(n, dtype=torch.int64, device=device)


def random_bits(kd, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable Threefry):
    bits1 ^ bits2 of Threefry-2x32 over each element's flat index, as
    int64 in [0, 2^32)."""
    n = int(np.prod(shape, dtype=np.int64))
    lo = _counters(n, device)
    b1, b2 = threefry2x32_tensor(kd[0], kd[1], torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(tuple(shape))


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s map of 32 random bits to float32 [0, 1):
    the top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(kd, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32, [0, 1)) of key data
    ``kd``, bit for bit."""
    return bits_to_uniform(random_bits(kd, shape, device))


def uniforms(draws, device="cpu") -> list:
    """Several ``jax.random.uniform`` draws in one Threefry pass:
    ``draws`` is a list of (key data, n); returns the flat (n,) float32
    draws, each bit for bit ``uniform(kd, (n,))``. The keys ride in int64
    tensors filled from host ints, so nothing is copied to the device."""
    def column(word):
        return torch.cat([torch.full((n,), kd[word], dtype=torch.int64,
                                     device=device) for kd, n in draws])

    lo = torch.cat([_counters(n, device) for _, n in draws])
    b1, b2 = threefry2x32_tensor(column(0), column(1), torch.zeros_like(lo),
                                 lo)
    return list(bits_to_uniform(b1 ^ b2).split([n for _, n in draws]))


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
