"""The port's ``jax.random`` draws (Threefry-2x32, ``render/rng.py``) and
the jnp tracer's sampling maps (``core/sampling.py``, ``core/vec.py``)
against the JAX package's on the same keys and inputs.

Bitwise: ``random_bits``, ``uniform``, ``split``, ``fold_in``, the
concatenated ``uniforms``, ``pixel_jitter``, ``stratified_rotations`` and
``r2_point``; every integer stream and every float the draws make without
a transcendental.

Within ulps, measured over these draws (float32 ulps at 1.0, 2^-23;
XLA's and PyTorch's CPU sin, cos and sqrt differ by an ulp on some
inputs, ROADMAP ground rules, and the cube root is ``torch.pow(u, 1/3)``
against ``jnp.cbrt``): the unit-ball point 4.5 ulps (bound 8), the unit
vector 5.7 (bound 8), the unit disc 1.0 (bound 2); the cylinder map
``unit_vector_from_uv`` 6.6 (bound 8: near the poles 1 - hx² is small,
and XLA forms it with a fused multiply-add) and ``disk_from_uv`` 1.0
(bound 2); vec's reflect, refract, mix and normalize, in ulps of their
magnitude, 0, 0.65, 0 and 1.0 (bound 4).

The cube root: over a million uniforms ``torch.pow(u, 1/3)`` differs
from ``jnp.cbrt`` on 1.46 % of inputs, by 1 ulp at most (``np.cbrt``:
38 %, 3 ulps; ``exp(log(u)/3)``: 12 %, 4 ulps); the test pins the share
at ≤ 2 % and the ulps at ≤ 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import sampling as jsampling
from raytracer_tpu.core import vec as jvec
from raytracer_tpu_torch.core import sampling, vec
from raytracer_tpu_torch.render import rng

ULP = 2.0 ** -23
SEEDS = (0, 42, 2**31 + 5)
SIZES = (7, 4099)
SHAPES = ((1,), (2,), (3,))
UNIT_BALL_MAX_ULPS = 8
DISK_MAX_ULPS = 2
CBRT_MAX_SHARE = 0.02
VEC_MAX_ULPS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jkey(seed):
    """A JAX key of ``seed``, or a folded / split one."""
    if seed == "folded":
        return jax.random.fold_in(jax.random.PRNGKey(3), 2**31 + 11)
    if seed == "split":
        return jax.random.split(jax.random.PRNGKey(5), 4)[2]
    return jax.random.PRNGKey(np.uint32(seed))


def kd(key):
    return rng.key_data(np.asarray(key))


def same_bits(a, b: torch.Tensor) -> bool:
    a = np.asarray(a)
    return a.dtype == b.numpy().dtype and np.array_equal(
        a.view(np.uint32), b.numpy().view(np.uint32))


KEYS = SEEDS + ("folded", "split")


@pytest.mark.parametrize("tail", SHAPES, ids=["P", "Px2", "Px3"])
@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("seed", KEYS)
def test_uniform_bitwise(seed, p, tail):
    shape = (p,) if tail == (1,) else (p,) + tail
    want = jax.random.uniform(jkey(seed), shape, dtype=jnp.float32)
    got = rng.uniform(kd(jkey(seed)), shape)
    assert got.shape == shape and same_bits(want, got)


@pytest.mark.parametrize("seed", KEYS)
def test_random_bits_bitwise(seed):
    want = np.asarray(jax.random.bits(jkey(seed), (37, 3))).astype(np.int64)
    np.testing.assert_array_equal(rng.random_bits(kd(jkey(seed)), (37, 3)),
                                  want)


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("seed", KEYS)
def test_split_bitwise(seed, n):
    want = [tuple(int(v) for v in k)
            for k in np.asarray(jax.random.split(jkey(seed), n))]
    assert rng.split(kd(jkey(seed)), n) == want


@pytest.mark.parametrize("data", [0, 7, 7_000_168, 2**31 + 3, 2**32 - 1])
@pytest.mark.parametrize("seed", KEYS)
def test_fold_in_bitwise(seed, data):
    want = tuple(int(v) for v in np.asarray(
        jax.random.fold_in(jkey(seed), np.uint32(data))))
    assert rng.fold_in(kd(jkey(seed)), data) == want


def test_fold_chains_fold_in():
    k = jax.random.PRNGKey(9)
    want = jax.random.fold_in(jax.random.fold_in(k, 4), 11)
    assert rng.fold(kd(k), 4, 11) == kd(want)
    assert sampling.fold is rng.fold


def test_key_data_takes_jax_keys():
    """An int seed is ``PRNGKey(seed)``'s data; a folded or split key's
    (2,) data is taken as it is."""
    for seed in ("folded", "split"):
        assert rng.key_data(np.asarray(jkey(seed))) == tuple(
            int(v) for v in np.asarray(jkey(seed)))
    assert rng.key_data(42) == kd(jax.random.PRNGKey(42))


def test_uniforms_is_each_draw_bitwise():
    """One Threefry pass over concatenated keys and counters gives each
    draw bit for bit."""
    keys = [kd(jkey(s)) for s in KEYS]
    sizes = [21, 4, 1, 9, 300]
    got = rng.uniforms(list(zip(keys, sizes)))
    for k, n, g in zip(keys, sizes, got):
        assert torch.equal(g, rng.uniform(k, (n,)))
        assert same_bits(jax.random.uniform(
            jax.random.wrap_key_data(np.asarray(k, np.uint32),
                                     impl="threefry2x32"), (n,)), g)


def test_host_threefry_is_the_tensor_form():
    r = np.random.default_rng(4)
    k0, k1, x0, x1 = (r.integers(0, 2**32, 50, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    y0, y1 = rng.threefry2x32(k0, k1, x0, x1)
    t0, t1 = rng.threefry2x32_tensor(*(torch.from_numpy(v.astype(np.int64))
                                       for v in (k0, k1, x0, x1)))
    np.testing.assert_array_equal(y0, t0.numpy())
    np.testing.assert_array_equal(y1, t1.numpy())


def test_pixel_jitter_bitwise():
    k = jax.random.PRNGKey(13)
    assert same_bits(jsampling.pixel_jitter(k, (64, 3)),
                     sampling.pixel_jitter(kd(k), (64, 3)))


@pytest.mark.parametrize("p", SIZES)
def test_stratified_rotations_bitwise(p):
    k = jax.random.fold_in(jax.random.PRNGKey(2), 6)
    want = jsampling.stratified_rotations(k, p)
    got = sampling.stratified_rotations(kd(k), p)
    assert sampling.CP_CAMERA_SALT == jsampling.CP_CAMERA_SALT
    assert sampling.CP_BOUNCE0_SALT == jsampling.CP_BOUNCE0_SALT
    for w, g, dims in zip(want, got, (4, 3)):
        assert g.shape == (p, dims) and same_bits(w, g)


@pytest.mark.parametrize("s", [0, 1, 37, 65_536, 2**31 - 1])
@pytest.mark.parametrize("which", ["camera", "bounce0"])
def test_r2_point_bitwise(which, s):
    """The fixed-point Kronecker point of a float rotation: (cp·2^24 as
    uint32) << 8, plus s·alpha mod 2^32, top 24 bits."""
    cp, cp_b0 = jsampling.stratified_rotations(jax.random.PRNGKey(8), 500)
    cp = cp if which == "camera" else cp_b0
    alphas = (jsampling.R2_ALPHAS_4D if which == "camera"
              else jsampling.R2_ALPHAS_B0)
    edge = jnp.asarray([[0.0] * cp.shape[1], [1.0 - 2**-24] * cp.shape[1]],
                       jnp.float32)
    cp = jnp.concatenate([cp, edge])
    got = sampling.r2_point(torch.from_numpy(np.asarray(cp).copy()), s,
                            alphas)
    assert same_bits(jsampling.r2_point(cp, s, alphas), got)


def ulps(want, got: torch.Tensor) -> float:
    return float(np.abs(np.asarray(want, np.float64)
                        - got.numpy().astype(np.float64)).max()) / ULP


@pytest.mark.parametrize("name, bound", [
    ("random_in_unit_sphere", UNIT_BALL_MAX_ULPS),
    ("random_unit_vector", UNIT_BALL_MAX_ULPS),
    ("random_in_unit_disk", DISK_MAX_ULPS),
])
def test_unit_draws_within_ulps(name, bound):
    k = jax.random.PRNGKey(21)
    want = jax.jit(getattr(jsampling, name), static_argnums=1)(k, (100_000,))
    got = getattr(sampling, name)(kd(k), (100_000,))
    assert got.shape == want.shape
    assert ulps(want, got) <= bound


def test_sphere_disk_glass_uniforms():
    """The bounce's three draws from one key: the glass roll bitwise, the
    directions within the ulps above."""
    k = jax.random.PRNGKey(17)
    want = jax.jit(jsampling.sphere_disk_glass_uniforms,
                   static_argnums=1)(k, (20_000,))
    got = sampling.sphere_disk_glass_uniforms(kd(k), (20_000,))
    assert ulps(want[0], got[0]) <= UNIT_BALL_MAX_ULPS
    assert ulps(want[1], got[1]) <= UNIT_BALL_MAX_ULPS
    assert same_bits(want[2], got[2])


def test_cbrt_share_pinned():
    u = jax.random.uniform(jax.random.PRNGKey(3), (1_000_000,))
    want = np.asarray(jax.jit(jnp.cbrt)(u)).view(np.int32).astype(np.int64)
    got = torch.pow(torch.from_numpy(np.asarray(u).copy()), 1.0 / 3.0)
    d = np.abs(got.numpy().view(np.int32).astype(np.int64) - want)
    assert d.max() <= 1
    assert (d != 0).mean() <= CBRT_MAX_SHARE


def test_uv_maps_within_ulps():
    r = np.random.default_rng(5)
    u, v = (r.random(50_000, dtype=np.float32) for _ in range(2))
    for jf, pf, bound in ((jsampling.unit_vector_from_uv,
                           sampling.unit_vector_from_uv, UNIT_BALL_MAX_ULPS),
                          (jsampling.disk_from_uv, sampling.disk_from_uv,
                           DISK_MAX_ULPS)):
        want = jax.jit(jf)(u, v)
        got = pf(torch.from_numpy(u), torch.from_numpy(v))
        assert ulps(want, got) <= bound


def test_vec_functions():
    r = np.random.default_rng(6)
    a = r.normal(size=(5000, 3)).astype(np.float32)
    n = r.normal(size=(5000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    a_unit = a / np.linalg.norm(a, axis=-1, keepdims=True)
    eta = r.uniform(0.5, 1.6, 5000).astype(np.float32)
    t = r.random(5000, dtype=np.float32)
    ta, tn = torch.from_numpy(a), torch.from_numpy(n)
    cases = [
        (jvec.reflect(a, n), vec.reflect(ta, tn)),
        (jvec.refract(a_unit, n, eta),
         vec.refract(torch.from_numpy(a_unit), tn, torch.from_numpy(eta))),
        (jvec.mix(a, n, t), vec.mix(ta, tn, torch.from_numpy(t))),
        (jvec.normalize(a, eps=1e-20), vec.normalize(ta, eps=1e-20)),
    ]
    for want, got in cases:
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        assert ulps(want, got) <= VEC_MAX_ULPS * scale
    z = np.array([[0, 0, 0], [1e-9, -1e-9, 0], [1e-6, 0, 0], [-1, -1, -1]],
                 np.float32)
    np.testing.assert_array_equal(vec.near_zero(torch.from_numpy(z)).numpy(),
                                  np.asarray(jvec.near_zero(z)))
    np.testing.assert_array_equal(
        vec.near_zero_signed(torch.from_numpy(z)).numpy(),
        np.asarray(jvec.near_zero_signed(z)))
    # a zero vector normalises to 0 under the guard
    assert torch.equal(vec.normalize(torch.zeros(1, 3), eps=1e-20),
                       torch.zeros(1, 3))
