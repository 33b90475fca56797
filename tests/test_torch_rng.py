"""The port's counter-hash RNG against the TPU kernel's
(``pallas_kernel._lowbias32`` … ``_unit_vec``) on the same random
inputs: the integer streams bit for bit, the sampled directions within
the float32 ulps by which the two libraries' transcendentals differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu_torch.render import rng

N = 200_000


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(1234)
    pix = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    # counters as the kernel forms them: int32 products that may wrap
    ctr = r.integers(-(2**31), 2**31, N, dtype=np.int64).astype(np.int32)
    return pix, ctr


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's draws are computed on PyTorch's calling thread alone.
    With intra-op worker threads, PyTorch's ``exp`` and ``log`` (and no
    other function of the draw) were seen to return a whole
    25,000-element thread chunk off by up to 1.0e-4 (log) and 1.4e-5 (exp)
    relative, from a process's first call or from some later one: in 15
    of 76 fresh processes at 8 threads on an 8-core AVX-512 Xeon host (3
    of the 20 among them that ran with ``ATEN_CPU_CAPABILITY=avx2``), in
    none of 20 with the scalar kernels (``ATEN_CPU_CAPABILITY=default``),
    in none of 35 at one thread, loaded or not, and never on the JAX side.
    That moves the unit ball's radius by up to 92 ulps at 1.0 and leaves
    the normalised unit vector alone: the failure this test showed in a
    6-worker run of the whole suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_port(a: np.ndarray) -> torch.Tensor:
    """uint32 / int32 bits → the port's int64 in [0, 2^32)."""
    return torch.from_numpy(a.view(np.uint32).astype(np.int64))


def test_lowbias32_bit_exact(inputs):
    pix, _ = inputs
    ref = np.asarray(pk._lowbias32(jnp.asarray(pix))).astype(np.int64)
    np.testing.assert_array_equal(rng.lowbias32(as_port(pix)).numpy(), ref)


@pytest.mark.parametrize("salt", [0, 1, 3, 6, 7])
def test_hash32_and_u01_bit_exact(inputs, salt):
    pix, ctr = inputs
    h = np.asarray(pk._hash32(jnp.asarray(pix), jnp.asarray(ctr), salt))
    got = rng.hash32(as_port(pix), as_port(ctr), salt)
    np.testing.assert_array_equal(got.numpy(), h.astype(np.int64))
    np.testing.assert_array_equal(
        rng.to_u01(got).numpy(), np.asarray(pk._to_u01(jnp.asarray(h)))
    )
    u = np.asarray(pk._u01(jnp.asarray(pix), jnp.asarray(ctr), salt))
    np.testing.assert_array_equal(
        rng.u01(as_port(pix), as_port(ctr), salt).numpy(), u
    )


#: absolute error bound on the unit-ball and unit-vector components, in
#: float32 ulps at 1.0: sin, cos, log and exp differ by 1 ulp and rsqrt
#: by up to 2 between XLA's and PyTorch's CPU kernels, and a draw chains
#: them. Measured over these 200k draws, per component (x, y, z), with
#: torch at one thread and at 2, 3, 5, 6, 7, 8 and 16, and with XLA held
#: to SSE4.2, AVX, AVX2 and AVX-512: unit ball 1.0, 1.0, 0.5 ulps; unit
#: vector 1.5, 1.5, 1.5.
UNIT_MAX_ABS = 4 * 2.0**-23


@pytest.mark.parametrize("fn", ["unit_sphere", "unit_vec"])
def test_unit_draws_within_ulps(inputs, fn):
    pix, ctr = inputs
    ref = np.stack([np.asarray(t) for t in getattr(pk, "_" + fn)(
        jnp.asarray(pix), jnp.asarray(ctr), 3)])
    got = np.stack([t.numpy() for t in getattr(rng, fn)(
        as_port(pix), as_port(ctr), 3)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=UNIT_MAX_ABS)


@pytest.mark.parametrize(
    "seed", [0, 1, 7, -1, 123456789, 2**31, 2**32 + 5, 2**40 + 3]
)
def test_kernel_seed_matches_prng_key(seed):
    """``seed`` drives the same hash streams as ``PRNGKey(seed)``: the
    kernel seed is int32(kd0 ^ lowbias32(kd1)) of the key data, as
    ``_render_pallas`` derives it."""
    kd = np.asarray(
        jax.random.key_data(jax.random.PRNGKey(seed))
    ).astype(np.uint32)
    ref = np.int32(
        (kd[0] ^ np.asarray(pk._lowbias32(jnp.uint32(kd[1]))))
        .astype(np.uint32).view(np.int32)
    )
    assert rng.kernel_seed(seed) == int(ref)
