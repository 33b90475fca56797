"""The stratified sampler's constants and its fixed-point Kronecker draw
against the JAX package (``core/sampling.py`` ``alphas_fixed32``,
``pallas_kernel._A4_FIX`` / ``_AB0_FIX`` / ``_r2_fixed``): integers
throughout, so everything matches bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import sampling as jax_sampling
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu_torch.core import sampling
from raytracer_tpu_torch.render import rng

N = 200_000


def as_port(a: np.ndarray) -> torch.Tensor:
    """uint32 / int32 bits → the port's int64 in [0, 2^32)."""
    return torch.from_numpy(a.view(np.uint32).astype(np.int64))


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(4321)
    pix = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    # sample indices as the kernel forms them (int32 sums cast to uint32):
    # small ones, and the edges where s·alpha and the int32 cast wrap
    s = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    s[:1000] = np.arange(1000)
    edges = [2**31 - 2, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]
    s[1000:1000 + len(edges)] = edges
    return pix, s


def test_alphas_and_fixed_forms_match():
    assert sampling.R2_ALPHAS_4D == jax_sampling.R2_ALPHAS_4D
    assert sampling.R2_ALPHAS_B0 == jax_sampling.R2_ALPHAS_B0
    assert sampling.A4_FIX == pk._A4_FIX
    assert sampling.AB0_FIX == pk._AB0_FIX
    assert len(set(sampling.A4_FIX + sampling.AB0_FIX)) == 7


def test_alphas_fixed32_rejects_a_constant_dimension():
    for bad in (0.0, 1.0, 2.0**-34, 1.0 - 2.0**-34):
        with pytest.raises(ValueError, match="degenerate"):
            sampling.alphas_fixed32((0.5, bad))
        with pytest.raises(ValueError, match="degenerate"):
            jax_sampling.alphas_fixed32((0.5, bad))


def test_rotation_counters_wrap_inside_32_bits(inputs):
    """The rotation counters are Python ints just under 2^32: counter +
    dimension stays below 2^32 (−4 + 3 = −1), and the hash of an int
    counter equals the hash of the same counter as a tensor."""
    pix, _ = inputs
    p = as_port(pix)
    assert rng.ROT_CAMERA + 3 == 0xFFFFFFFF and rng.ROT_BOUNCE0 + 2 < 2**32
    for rot, dims in ((rng.ROT_CAMERA, 4), (rng.ROT_BOUNCE0, 3)):
        for d in range(dims):
            ref = np.asarray(pk._hash32(jnp.asarray(pix), jnp.uint32(rot), d))
            got = rng.hash32(p, rot, d)
            np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
            as_tensor = rng.hash32(p, torch.full_like(p, rot), d)
            assert torch.equal(got, as_tensor)


CASES = (
    [("camera", d) for d in range(4)] + [("bounce0", d) for d in range(3)]
)


@pytest.mark.parametrize("block, d", CASES)
def test_r2_fixed_bit_exact(inputs, block, d):
    pix, s = inputs
    rot, fix = ((rng.ROT_CAMERA, sampling.A4_FIX) if block == "camera"
                else (rng.ROT_BOUNCE0, sampling.AB0_FIX))
    ref = np.asarray(pk._r2_fixed(jnp.asarray(pix), jnp.uint32(rot), d,
                                  jnp.asarray(s), fix[d]))
    got = rng.r2_fixed(as_port(pix), rot, d, as_port(s), fix[d])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_r2_fixed_is_the_kronecker_sequence():
    """Point s is frac(rotation + s·alpha) to 24 bits: against exact
    integer arithmetic in Python, for indices that overflow a float32
    product."""
    pix = torch.tensor([0x12345678], dtype=torch.int64)
    a = sampling.A4_FIX[2]
    h = int(rng.hash32(pix, rng.ROT_CAMERA, 2))
    for s in (0, 1, 499, 2**17, 2**31 - 1, 2**31, 2**32 - 1):
        want = (((h + s * a) % 2**32) >> 8) / 2.0**24
        got = rng.r2_fixed(pix, rng.ROT_CAMERA, 2,
                           torch.tensor([s], dtype=torch.int64), a)
        assert float(got) == want
