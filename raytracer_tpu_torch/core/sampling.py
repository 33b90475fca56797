"""Sampling primitives (counterpart of ``raytracer_tpu/core/sampling.py``):
the stratified sampler's constants, which the kernels read, and the jnp
tracer's ``jax.random`` draws and their maps, on tensors.

The maps are the reference shader's: the unit ball by the polar method
with a cube-root radius, the unit disc by a square-root radius, the unit
vector as the normalised ball point, the sub-pixel jitter in [0, 1)².
Each draw is Threefry over key data (``render/rng.py``), bit for bit
``jax.random``'s. The cube root is ``torch.pow(u, 1/3)``: on a million
uniforms it differs from ``jnp.cbrt`` on 1.46 % of inputs, by 1 ulp at
most (``tests/test_torch_threefry.py``).

The stratified sampler draws a pixel's s-th sample from a Kronecker
(additive-recurrence) sequence, point_s = frac(rotation + s·alpha), in
32-bit fixed point: the four camera dimensions (sub-pixel jitter on the
plastic-constant R2 pair, lens disc on (√2−1, √3−1)) and the three
first-bounce dimensions (diffuse direction on the supergolden pair, the
glass Schlick roll on the golden ratio). The seven alphas are distinct,
because a pixel's dimensions share one index s and a repeated alpha
would tie two of them together for good.
"""

from __future__ import annotations

import math

import torch

from raytracer_tpu_torch.core import vec
from raytracer_tpu_torch.render import rng

_R2_G2 = 1.3247179572447460  # plastic constant: real root of g^3 = g + 1
_SUPERGOLDEN = 1.4655712318767682  # real root of g^3 = g^2 + 1
#: camera dimensions: jitter u, jitter v, lens u, lens v
R2_ALPHAS_4D = (
    1.0 / _R2_G2,
    1.0 / _R2_G2 ** 2,
    math.sqrt(2.0) - 1.0,
    math.sqrt(3.0) - 1.0,
)
#: first-bounce dimensions: diffuse hx, diffuse phi, glass roll
R2_ALPHAS_B0 = (
    1.0 / _SUPERGOLDEN,
    1.0 / _SUPERGOLDEN ** 2,
    (math.sqrt(5.0) - 1.0) / 2.0,
)


def alphas_fixed32(alphas) -> tuple:
    """Each alpha as round(alpha·2^32) mod 2^32. Rejects an alpha whose
    fixed form is 0: every point of that dimension would equal the
    rotation."""
    fixed = tuple(int(round(a * 2.0 ** 32)) & 0xFFFFFFFF for a in alphas)
    if any(f == 0 for f in fixed):
        raise ValueError(f"degenerate fixed-point alpha in {alphas}")
    return fixed


A4_FIX = alphas_fixed32(R2_ALPHAS_4D)
AB0_FIX = alphas_fixed32(R2_ALPHAS_B0)


# --- the jnp tracer's draws (jax.random, Threefry) --------------------------

TWO_PI = 2.0 * math.pi
#: key-fold salts of the stratified sampler's per-pixel rotations
CP_CAMERA_SALT = 0x52D2
CP_BOUNCE0_SALT = 0xB0C

fold = rng.fold


def unit_sphere_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """(..., 3) uniforms → a point inside the unit ball: hx = 2u0 - 1,
    φ = 2π·u1, r = ∛u2, p = r·(s·sin φ, s·cos φ, hx), s = √(1 - hx²)."""
    hx = u[..., 0] * 2.0 - 1.0
    phi = u[..., 1] * TWO_PI
    r = torch.pow(u[..., 2], 1.0 / 3.0)
    s = torch.sqrt(torch.clamp_min(1.0 - hx * hx, 0.0))
    return torch.stack([r * s * torch.sin(phi), r * s * torch.cos(phi),
                        r * hx], dim=-1)


def unit_vector_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """The unit-ball point of ``u``, normalised (guarded: a draw of
    exactly 0 gives the zero point)."""
    return vec.normalize(unit_sphere_from_uniforms(u), eps=1e-20)


def random_in_unit_sphere(key, shape=(), *, device="cpu") -> torch.Tensor:
    """A point inside the unit ball, shape ``shape + (3,)``."""
    return unit_sphere_from_uniforms(rng.uniform(key, tuple(shape) + (3,),
                                                 device))


def random_unit_vector(key, shape=(), *, device="cpu") -> torch.Tensor:
    """A direction on the unit sphere, shape ``shape + (3,)``."""
    return unit_vector_from_uniforms(rng.uniform(key, tuple(shape) + (3,),
                                                 device))


def disk_from_uv(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Uniforms (u, v) → the unit disc: a = 2π·u, r = √v."""
    a = u * TWO_PI
    r = torch.sqrt(v)
    return torch.stack([r * torch.cos(a), r * torch.sin(a)], dim=-1)


def random_in_unit_disk(key, shape=(), *, device="cpu") -> torch.Tensor:
    """A point in the unit disc, shape ``shape + (2,)``."""
    u = rng.uniform(key, tuple(shape) + (2,), device)
    return disk_from_uv(u[..., 0], u[..., 1])


def pixel_jitter(key, shape=(), *, device="cpu") -> torch.Tensor:
    """The sub-pixel jitter in [0, 1)², shape ``shape + (2,)``."""
    return rng.uniform(key, tuple(shape) + (2,), device)


def bounce_keys(kd) -> list:
    """The three keys of one bounce's material draws: ``split(kd, 3)``
    (unit vector, unit ball, glass roll)."""
    return rng.split(kd, 3)


def sphere_disk_glass_uniforms(key, shape=(), *, device="cpu"):
    """One bounce's material draws from one key, in one Threefry pass:
    (unit vector (..., 3), unit-ball point (..., 3), glass roll (...))."""
    n = int(math.prod(shape))
    k1, k2, k3 = bounce_keys(key)
    u1, u2, u3 = rng.uniforms([(k1, 3 * n), (k2, 3 * n), (k3, n)], device)
    shape = tuple(shape)
    return (unit_vector_from_uniforms(u1.reshape(shape + (3,))),
            unit_sphere_from_uniforms(u2.reshape(shape + (3,))),
            u3.reshape(shape))


def unit_vector_from_uv(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Uniforms (u, v) → a unit vector by the cylinder map: hx = 2u - 1,
    φ = 2π·v, (s·sin φ, s·cos φ, hx), s = √(1 - hx²); the law of the
    normalised unit-ball point (the stratified first bounce's diffuse
    draw)."""
    hx = u * 2.0 - 1.0
    phi = v * TWO_PI
    s = torch.sqrt(torch.clamp_min(1.0 - hx * hx, 0.0))
    return torch.stack([s * torch.sin(phi), s * torch.cos(phi), hx], dim=-1)


def r2_point(cp: torch.Tensor, s: int, alphas=R2_ALPHAS_4D) -> torch.Tensor:
    """The s-th Kronecker point under the rotations ``cp`` (..., len
    (alphas)) float32, in 32-bit fixed point: (cp·2^24 as uint32) << 8
    plus s·alpha, mod 2^32, top 24 bits → [0, 1). ``s`` is a host int."""
    cp_fix = (cp * 16777216.0).to(torch.int64) << 8
    # s·alpha mod 2^32 per dimension on the host, so nothing is uploaded
    x = torch.stack([cp_fix[..., d] + ((s * a) & rng.M32)
                     for d, a in enumerate(alphas_fixed32(alphas))], dim=-1)
    return ((x & rng.M32) >> 8).to(torch.float32) * (2.0 ** -24)


def stratified_rotations(key, p: int, *, device="cpu"):
    """The per-pixel Cranley-Patterson rotations of the stratified jnp
    path: ((p, 4) camera dims, (p, 3) first-bounce dims), uniform under
    ``fold_in(key, CP_CAMERA_SALT)`` and ``fold_in(key, CP_BOUNCE0_SALT)``
    (``key``: key data, as for every draw here)."""
    cam, b0 = rng.uniforms([(rng.fold_in(key, CP_CAMERA_SALT), 4 * p),
                            (rng.fold_in(key, CP_BOUNCE0_SALT), 3 * p)],
                           device)
    return cam.reshape(p, 4), b0.reshape(p, 3)
