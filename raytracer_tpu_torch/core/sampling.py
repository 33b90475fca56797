"""Constants of the stratified sampler (counterpart of the part of
``raytracer_tpu/core/sampling.py`` that the cluster walk reads).

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
