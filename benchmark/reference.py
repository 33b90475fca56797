"""The plain reference that decides `correct`: the renderer's stated
semantics in plain PyTorch, written from the configuration and the
sampler's definition, and independent of the program under test.

What it states, and the program must reproduce:

- the counter-hash RNG: a pixel's hash is lowbias32((py * wp + px) ^
  seed), wp the width rounded up to 128; draw `salt` of counter `ctr` is
  the top 24 bits of lowbias32(pix ^ (ctr + salt) * 0x9E3779B9); sample
  s owns the counters [s * dps, (s + 1) * dps), dps = 4 + 8 * max_depth:
  4 camera draws, then 8 a bounce. The stratified sampler replaces the
  camera draws, and a sample's first diffuse direction and glass roll, by
  the s-th point of a Kronecker sequence under the pixel's hashed
  rotation;
- the camera ray through the jittered pixel, from a point of the lens
  disc;
- the exact sphere quadratic in q = t |d|^2, its nearest root with t at
  least 0.001;
- the book's materials (Lambertian as normal plus a unit vector, metal
  with fuzz, glass with Snell, total reflection and Schlick's roll), the
  sky gradient, no Russian roulette, and a path that runs out of its
  max_depth bounces returning its throughput;
- a segment for every bounce traced, a miss included.

Every lane is one (pixel, sample) pair, and a bounce is a dense (lanes x
spheres) pass: no acceleration structure, no sorting, no chunked
persistent lanes. It computes in `dtype`: float32 as the configurations
state, or bfloat16 for the control (section "How correct is decided").
It imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
DRAWS_PER_BOUNCE = 8
MIN_T = 0.001
Q_CUT = 1e20          # t beyond this is a miss
FILL = 3e38           # q of no candidate
U_EPS = 1e-12
N_EPS = 1e-20
SKY_G = 0.3
ONE_THIRD = np.float32(1.0 / 3.0)
TWO_PI = np.float32(2.0 * math.pi)
INV24 = 2.0 ** -24
MAX_T = 1e5
# stratified sampler: alphas in 32-bit fixed point, rotation counters
A4_FIX = (0xC13FA9A9, 0x91E10DA6, 0x6A09E668, 0xBB67AE86)
AB0_FIX = (0xAEAD08F3, 0x772FAD1F, 0x9E3779B9)
ROT_CAMERA = 0xFFFFFFFC
ROT_BOUNCE0 = 0xFFFFFFF8
#: lanes (pixel, sample pairs) traced together: a (lanes x spheres) pass
#: of 487 spheres holds about 130 MB a temporary
LANE_BLOCK = 1 << 16


# --- RNG (uint32 values in int64 tensors) ----------------------------


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def lowbias32_int(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def kernel_seed(key) -> int:
    """The 32-bit seed of key data (k0, k1): k0 ^ lowbias32(k1)."""
    return (int(key[0]) ^ lowbias32_int(int(key[1]))) & M32


def _top24(h: torch.Tensor, dtype) -> torch.Tensor:
    return (h >> 8).to(torch.float32).mul(INV24).to(dtype)


def u01(pix, ctr, salt: int, dtype):
    """Uniform [0, 1) draw `salt` of counter `ctr` of pixel hash `pix`."""
    return _top24(lowbias32(pix ^ mul32((ctr + salt) & M32, GOLDEN)), dtype)


def r2(pix, rot: int, d: int, s_u, a_fix: int, dtype):
    """The s_u-th Kronecker point of dimension d under the pixel's
    rotation."""
    x = (lowbias32(pix ^ (((rot + d) & M32) * GOLDEN & M32))
         + mul32(s_u & M32, a_fix)) & M32
    return _top24(x, dtype)


def prng_key(seed: int) -> tuple:
    """The key data of jax.random.PRNGKey(seed) for a 32-bit seed, as the
    renderer states it (no 64-bit mode): (0, seed)."""
    return 0, int(seed) & M32


def threefry_fold_in(key, data: int):
    """jax.random.fold_in of key data (k0, k1) with `data`: Threefry-2x32
    (20 rounds) of the key over the counter (0, data)."""
    k0, k1 = int(key[0]) & M32, int(key[1]) & M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = ks[0], (int(data) + ks[1]) & M32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for j in range(5):
        for r in rot[j % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 ^= x0
        x0 = (x0 + ks[(j + 1) % 3]) & M32
        x1 = (x1 + ks[(j + 2) % 3] + j + 1) & M32
    return x0, x1


# --- camera --------------------------------------------------------------


def _unit(v):
    return v / np.linalg.norm(v)


def camera_basis(lookfrom, lookat, vfov_deg: float, aperture: float,
                 focus: float, aspect: float, vup=(0.0, 1.0, 0.0)) -> dict:
    """The thin-lens viewport of Shirley's camera, in float64, rounded
    once to float32: origin, lower-left corner, horizontal, vertical, the
    lens basis u, v, w, the lens radius, and front = -w."""
    origin = np.asarray(lookfrom, np.float64)
    w = _unit(origin - np.asarray(lookat, np.float64))
    u = _unit(np.cross(np.asarray(vup, np.float64), w))
    v = np.cross(w, u)
    vh = 2.0 * math.tan(math.radians(vfov_deg) / 2.0)
    vw = vh * aspect
    horizontal = focus * vw * u
    vertical = focus * vh * v
    lower_left = origin - horizontal / 2 - vertical / 2 - focus * w
    f = {"origin": origin, "lower_left_corner": lower_left,
         "horizontal": horizontal, "vertical": vertical, "u": u, "v": v,
         "w": w, "lens_radius": np.float64(aperture / 2.0), "front": -w}
    return {k: np.asarray(a, np.float32) for k, a in f.items()}


def front_from_yaw_pitch(yaw_deg: float, pitch_deg: float) -> np.ndarray:
    """The viewer's camera direction: (cos yaw cos pitch, sin pitch, sin
    yaw cos pitch)."""
    y, p = math.radians(float(yaw_deg)), math.radians(float(pitch_deg))
    return np.array([math.cos(y) * math.cos(p), math.sin(p),
                     math.sin(y) * math.cos(p)])


def viewer_basis(origin, yaw_deg, pitch_deg, fov_rad, aperture, focus,
                 aspect) -> dict:
    """camera_basis of the viewer's yaw/pitch camera (fov in radians), in
    float64, rounded once to float32."""
    origin = np.asarray(origin, np.float64)
    return camera_basis(origin, origin + front_from_yaw_pitch(yaw_deg,
                                                              pitch_deg),
                        math.degrees(float(fov_rad)), float(aperture),
                        float(focus), float(aspect))


def viewer_basis_f32(origin, yaw_deg, pitch_deg, fov_rad, aperture, focus,
                     aspect) -> dict:
    """The viewer's camera as the viewer computes it, every operation in
    float32 (the reference's Rust state, and its shader's uniforms):
    front from yaw and pitch in degrees, w = -front, u = unit(vup x w), v
    = w x u, the viewport 2 tan(fov / 2) high at the focus distance."""
    f = lambda v: torch.tensor(np.asarray(v, np.float32))  # noqa: E731
    o, yaw, pitch, fov = f(origin), f(yaw_deg), f(pitch_deg), f(fov_rad)
    aperture, focus, aspect = f(aperture), f(focus), f(aspect)
    vup = f((0.0, 1.0, 0.0))
    yr, pr = yaw * (math.pi / 180.0), pitch * (math.pi / 180.0)
    cp = torch.cos(pr)
    front = torch.stack([torch.cos(yr) * cp, torch.sin(pr),
                         torch.sin(yr) * cp])

    def norm(v):
        return v / torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])

    def cross(a, b):
        return torch.stack([a[1] * b[2] - a[2] * b[1],
                            a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])

    w = norm(-front)
    u = norm(cross(vup, w))
    v = cross(w, u)
    vh = 2.0 * torch.tan(fov / 2.0)
    vw = vh * aspect
    horizontal = focus * vw * u
    vertical = focus * vh * v
    lower_left = o - horizontal / 2.0 - vertical / 2.0 - focus * w
    out = {"origin": o, "lower_left_corner": lower_left,
           "horizontal": horizontal, "vertical": vertical, "u": u, "v": v,
           "w": w, "lens_radius": aperture / 2.0, "front": front}
    return {k: t.numpy().astype(np.float32) for k, t in out.items()}


def cam19(basis: dict) -> np.ndarray:
    """The 19 camera numbers a ray is made from: origin, lower-left,
    horizontal, vertical, u, v, lens radius."""
    return np.concatenate([basis[k].reshape(-1) for k in (
        "origin", "lower_left_corner", "horizontal", "vertical", "u", "v",
        "lens_radius")]).astype(np.float32)


# --- scene -----------------------------------------------------------


def sphere_rows(spheres: dict, device, dtype) -> dict:
    """The spheres as tensors: centers, k1 = |c|^2 - r^2 (in float32),
    signed 1/r, material, albedo, fuzz, ior. A sphere that is inactive or
    lies wholly beyond MAX_T is never hit."""
    c = torch.as_tensor(np.asarray(spheres["center"], np.float32))
    r = torch.as_tensor(np.asarray(spheres["radius"], np.float32))
    act = torch.as_tensor(np.asarray(spheres["active"], np.float32)) > 0
    act &= (torch.sqrt(c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]
                       + c[:, 2] * c[:, 2]) - r.abs()) <= MAX_T
    c = torch.where(act[:, None], c, 0.0)
    k1 = torch.where(act, c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]
                     + c[:, 2] * c[:, 2] - r * r, 1.0)
    inv_r = torch.where(r == 0, 1.0, 1.0 / torch.where(r == 0, 1.0, r))
    rows = {
        "c": c, "k1": k1, "inv_r": inv_r,
        "mat": torch.as_tensor(np.asarray(spheres["material_type"],
                                          np.int64)),
        "albedo": torch.as_tensor(np.asarray(spheres["albedo"],
                                             np.float32)),
        "fuzz": torch.as_tensor(np.asarray(spheres["fuzz"], np.float32)),
        "ior": torch.as_tensor(np.asarray(spheres["refraction_index"],
                                          np.float32)),
    }
    return {k: (v.to(device) if v.dtype == torch.int64
                else v.to(device=device, dtype=dtype))
            for k, v in rows.items()}


# --- the tracer ------------------------------------------------------


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    inv = torch.rsqrt(torch.clamp_min(_dot(x, y, z, x, y, z), N_EPS))
    return x * inv, y * inv, z * inv


def trace(spheres: dict, cam: np.ndarray, width: int, height: int,
          seed: int, pixels: np.ndarray, s0: int, count: int,
          max_depth: int, sampler: str = "random",
          dtype=torch.float32, device="cpu"):
    """Samples s0 .. s0 + count - 1 of every pixel in `pixels` ((P, 2)
    [px, py], py counted from the image bottom) of a width x height
    render with kernel seed `seed`. Returns float32 contributions (P,
    count, 3), linear, and int64 segments (P, count)."""
    pixels = np.asarray(pixels, np.int64).reshape(-1, 2)
    n_pix = pixels.shape[0]
    rows = sphere_rows(spheres, device, dtype)
    camt = torch.as_tensor(cam, dtype=torch.float32).to(device=device,
                                                         dtype=dtype)
    wp = -(-width // 128) * 128
    px = torch.as_tensor(pixels[:, 0], device=device)
    py = torch.as_tensor(pixels[:, 1], device=device)
    pix = lowbias32(((py * wp + px) ^ (seed & M32)) & M32)
    lanes_px = px.repeat_interleave(count)
    lanes_py = py.repeat_interleave(count)
    lanes_pix = pix.repeat_interleave(count)
    lanes_s = (torch.arange(count, device=device) + s0).repeat(n_pix)
    n = n_pix * count
    contrib = torch.zeros((n, 3), dtype=torch.float32, device=device)
    segs = torch.zeros((n,), dtype=torch.int64, device=device)
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))
    for lo in range(0, n, LANE_BLOCK):
        sl = slice(lo, min(n, lo + LANE_BLOCK))
        c, g = _trace_lanes(rows, camt, lanes_px[sl], lanes_py[sl],
                            lanes_pix[sl], lanes_s[sl], inv_w, inv_h,
                            max_depth, sampler == "stratified", dtype)
        contrib[sl] = c
        segs[sl] = g
    return contrib.reshape(n_pix, count, 3), segs.reshape(n_pix, count)


def _camera_ray(cam, px, py, pix, s_abs, dps, inv_w, inv_h, stratified,
                dtype):
    if stratified:
        u = [r2(pix, ROT_CAMERA, d, s_abs, A4_FIX[d], dtype)
             for d in range(4)]
    else:
        ctr0 = mul32(s_abs & M32, dps)
        u = [u01(pix, ctr0, d, dtype) for d in range(4)]
    c = [cam[j] for j in range(19)]
    st_s = (px.to(dtype) + 0.5 + u[0]) * inv_w
    st_t = (py.to(dtype) + 0.5 + u[1]) * inv_h
    ang = u[2] * float(TWO_PI)
    rad = c[18] * torch.sqrt(u[3])
    rdx, rdy = rad * torch.cos(ang), rad * torch.sin(ang)
    o = [c[k] + (c[12 + k] * rdx + c[15 + k] * rdy) for k in range(3)]
    d = [c[3 + k] + st_s * c[6 + k] + st_t * c[9 + k] - o[k]
         for k in range(3)]
    return o, d


def _trace_lanes(rows, cam, px, py, pix, s_abs, inv_w, inv_h, max_depth,
                 stratified, dtype):
    """One block of lanes, bounce by bounce, compacting finished ones."""
    dev = px.device
    n = px.shape[0]
    dps = 4 + DRAWS_PER_BOUNCE * max_depth
    (ox, oy, oz), (dx, dy, dz) = _camera_ray(cam, px, py, pix, s_abs, dps,
                                             inv_w, inv_h, stratified,
                                             dtype)
    one = torch.ones(n, dtype=dtype, device=dev)
    tr, tg, tb = one, one.clone(), one.clone()
    idx = torch.arange(n, device=dev)
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    segs = torch.zeros((n,), dtype=torch.int64, device=dev)
    c, k1 = rows["c"], rows["k1"]
    for bounce in range(max_depth):
        if idx.numel() == 0:
            break
        a = _dot(dx, dy, dz, dx, dy, dz)
        o_dot_d = _dot(ox, oy, oz, dx, dy, dz)
        o_dot_o = _dot(ox, oy, oz, ox, oy, oz)
        min_t_a = MIN_T * a
        # the exact quadratic against every sphere: (lanes, spheres)
        cdd = (c[None, :, 0] * dx[:, None] + c[None, :, 1] * dy[:, None]
               + c[None, :, 2] * dz[:, None])
        cdo = (c[None, :, 0] * ox[:, None] + c[None, :, 1] * oy[:, None]
               + c[None, :, 2] * oz[:, None])
        nb = cdd - o_dot_d[:, None]
        del cdd
        cc = o_dot_o[:, None] - 2.0 * cdo + k1[None, :]
        del cdo
        ds = nb * nb - a[:, None] * cc
        del cc
        sq = torch.where(ds >= 0, torch.sqrt(ds.abs()), -FILL)
        qn = nb - sq
        q = torch.where(qn >= min_t_a[:, None], qn, nb + sq)
        del nb, sq, qn, ds
        q = torch.where(q >= min_t_a[:, None], q, FILL)
        bq, bs = q.min(dim=1)
        del q
        segs[idx] += 1
        best_t = bq * (1.0 / a)
        hit = best_t < Q_CUT
        udx, udy, udz = _normalize(dx, dy, dz)
        # a miss: the sky, with the throughput before this bounce
        sky_t = 0.5 * (udy + 1.0)
        con = torch.stack([tr * (1.0 - 0.5 * sky_t),
                           tg * (1.0 - SKY_G * sky_t), tb], 1)
        con = torch.where(hit[:, None], 0.0, con)
        # a hit: normal, material, scatter
        wc = c[bs]
        hpx, hpy, hpz = ox + best_t * dx, oy + best_t * dy, oz + best_t * dz
        inv_r = rows["inv_r"][bs]
        nx, ny, nz = ((hpx - wc[:, 0]) * inv_r, (hpy - wc[:, 1]) * inv_r,
                      (hpz - wc[:, 2]) * inv_r)
        front = _dot(dx, dy, dz, nx, ny, nz) < 0
        sgn = torch.where(front, 1.0, -1.0).to(dtype)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
        mat = rows["mat"][bs]
        diffuse, metal, glass = mat == 0, mat == 1, mat == 2
        ctr = (mul32(s_abs & M32, dps) + 4 + bounce * DRAWS_PER_BOUNCE) & M32
        strat0 = diffuse & stratified & (bounce == 0)
        # diffuse draws 0-2 of the bounce, metal 3-5
        hx = torch.where(diffuse, u01(pix, ctr, 0, dtype),
                         u01(pix, ctr, 3, dtype)) * 2.0 - 1.0
        phi = torch.where(diffuse, u01(pix, ctr, 1, dtype),
                          u01(pix, ctr, 4, dtype)) * float(TWO_PI)
        ur = torch.where(diffuse, u01(pix, ctr, 2, dtype),
                         u01(pix, ctr, 5, dtype))
        r = torch.exp(torch.log(torch.clamp_min(ur, U_EPS)) * float(ONE_THIRD))
        if stratified and bounce == 0:
            hx = torch.where(strat0, r2(pix, ROT_BOUNCE0, 0, s_abs,
                                        AB0_FIX[0], dtype) * 2.0 - 1.0, hx)
            phi = torch.where(strat0, r2(pix, ROT_BOUNCE0, 1, s_abs,
                                         AB0_FIX[1], dtype) * float(TWO_PI),
                              phi)
            r = torch.where(strat0, 1.0, r).to(dtype)
        s = torch.sqrt(torch.clamp_min(1.0 - hx * hx, 0.0))
        rs = r * s
        vx, vy, vz = rs * torch.sin(phi), rs * torch.cos(phi), r * hx
        nvx, nvy, nvz = _normalize(vx, vy, vz)
        keep = strat0 | ~diffuse
        vx = torch.where(keep, vx, nvx)
        vy = torch.where(keep, vy, nvy)
        vz = torch.where(keep, vz, nvz)
        # diffuse: normal + unit vector
        ndx, ndy, ndz = nx + vx, ny + vy, nz + vz
        scat = diffuse.clone()
        # metal: reflect, plus fuzz
        d_dot_n = _dot(dx, dy, dz, nx, ny, nz)
        fuzz = rows["fuzz"][bs]
        mdx = dx - 2.0 * d_dot_n * nx + fuzz * vx
        mdy = dy - 2.0 * d_dot_n * ny + fuzz * vy
        mdz = dz - 2.0 * d_dot_n * nz + fuzz * vz
        m_scat = _dot(nx, ny, nz, mdx, mdy, mdz) > 0
        ndx = torch.where(metal, mdx, ndx)
        ndy = torch.where(metal, mdy, ndy)
        ndz = torch.where(metal, mdz, ndz)
        scat = scat | (metal & m_scat)
        # glass: Snell, total internal reflection, Schlick's roll
        refr = rows["ior"][bs]
        ratio = torch.where(front, 1.0 / refr, refr)
        cos_t = torch.clamp_max(-_dot(udx, udy, udz, nx, ny, nz), 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        cannot = ratio * sin_t > 1.0
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        one_m = 1.0 - cos_t
        one_m2 = one_m * one_m
        schlick = r0 + (1.0 - r0) * one_m2 * one_m2 * one_m
        glass_u = u01(pix, ctr, 6, dtype)
        if stratified and bounce == 0:
            glass_u = r2(pix, ROT_BOUNCE0, 2, s_abs, AB0_FIX[2], dtype)
        reflect = cannot | (schlick > glass_u)
        ud_dot_n = _dot(udx, udy, udz, nx, ny, nz)
        rfx = udx - 2.0 * ud_dot_n * nx
        rfy = udy - 2.0 * ud_dot_n * ny
        rfz = udz - 2.0 * ud_dot_n * nz
        rpx = ratio * (udx + cos_t * nx)
        rpy = ratio * (udy + cos_t * ny)
        rpz = ratio * (udz + cos_t * nz)
        sk = torch.sqrt(torch.clamp_min(
            1.0 - (rpx * rpx + rpy * rpy + rpz * rpz), 0.0))
        gdx = torch.where(reflect, rfx, rpx - sk * nx)
        gdy = torch.where(reflect, rfy, rpy - sk * ny)
        gdz = torch.where(reflect, rfz, rpz - sk * nz)
        ndx = torch.where(glass, gdx, ndx)
        ndy = torch.where(glass, gdy, ndy)
        ndz = torch.where(glass, gdz, ndz)
        scat = (scat | glass) & hit
        alb = rows["albedo"][bs]
        tr = torch.where(scat, tr * alb[:, 0], tr)
        tg = torch.where(scat, tg * alb[:, 1], tg)
        tb = torch.where(scat, tb * alb[:, 2], tb)
        exhausted = scat & (bounce >= max_depth - 1)
        con = torch.where(exhausted[:, None],
                          torch.stack([tr, tg, tb], 1), con)
        out[idx] += con.to(torch.float32)
        go = scat & ~exhausted
        idx = idx[go]
        px, py, pix, s_abs = px[go], py[go], pix[go], s_abs[go]
        ox, oy, oz = hpx[go], hpy[go], hpz[go]
        dx, dy, dz = ndx[go], ndy[go], ndz[go]
        tr, tg, tb = tr[go], tg[go], tb[go]
    return out, segs


# --- what a render makes of the samples ------------------------------


def sum_in_order(contrib: torch.Tensor, sizes) -> torch.Tensor:
    """(P, S, C) per-sample values summed as the renderer's launches sum
    them: each launch's samples in order, then the launches in order.
    Returns (P, C)."""
    acc = torch.zeros_like(contrib[:, 0])
    off = 0
    for cs in sizes:
        part = torch.zeros_like(acc)
        for j in range(off, off + cs):
            part = part + contrib[:, j]
        acc = acc + part
        off += cs
    return acc


def gamma(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x, 0.0))


def fixed_pixels(spheres, cam, width, height, seed, pixels, spp, max_depth,
                 sizes, sampler="random", dtype=torch.float32,
                 device="cpu", sample_offset=0):
    """Pixels of a fixed-spp render: (gamma image (P, 3), segments (P,))."""
    contrib, segs = trace(spheres, cam, width, height, seed, pixels,
                          sample_offset, spp, max_depth, sampler, dtype,
                          device)
    acc = sum_in_order(contrib, sizes)
    return gamma(acc * float(np.float32(1.0 / spp))), segs.sum(1)


# the adaptive stopping rule
ADAPTIVE_MIN_N = 64
ADAPTIVE_ABS_FLOOR = 0.02
T975_BY_CHUNKS = (
    math.inf, math.inf, math.inf, 4.303, 3.182, 2.776, 2.571, 2.447,
    2.365, 2.306, 2.262, 2.228, 2.201, 2.179, 2.160, 2.145, 2.131,
)


def converged(acc: torch.Tensor, tol: float, cstats=None):
    """Which pixels stop: at least ADAPTIVE_MIN_N samples and the 95 %
    half-width of the mean luminance within tol * (mean + 0.02); the
    half-width is 1.96 sqrt(var / n), or with between-chunk statistics
    of 3 chunks or more the smaller of that and the Student-t interval on
    the chunk means. acc rows: r, g, b, n, sum of lum^2 (P, 5)."""
    n = acc[:, 3]
    n_safe = torch.clamp_min(n, 1.0)
    mean = (acc[:, 0] + acc[:, 1] + acc[:, 2]) * (1.0 / 3.0) / n_safe
    var = torch.clamp_min(acc[:, 4] / n_safe - mean * mean, 0.0)
    ci = 1.96 * torch.sqrt(var / n_safe)
    if cstats is not None:
        t975 = torch.tensor(T975_BY_CHUNKS, dtype=torch.float32,
                            device=acc.device)
        n_c = cstats[:, 0]
        nc_safe = torch.clamp_min(n_c, 1.0)
        m_mean = cstats[:, 1] / nc_safe
        s2 = (torch.clamp_min(cstats[:, 2] / nc_safe - m_mean * m_mean, 0.0)
              * nc_safe / torch.clamp_min(n_c - 1.0, 1.0))
        t = t975[torch.clamp(n_c.to(torch.int64), 0, t975.shape[0] - 1)]
        ci = torch.where(n_c >= 3.0, torch.minimum(ci, t * torch.sqrt(
            s2 / nc_safe)), ci)
    return (n >= ADAPTIVE_MIN_N) & (ci <= tol * (mean + ADAPTIVE_ABS_FLOOR))


def adaptive_pixels(spheres, cam, width, height, seed, pixels, max_depth,
                    sizes, tol, sampler="random", dtype=torch.float32,
                    device="cpu"):
    """Pixels of an adaptive render with launch sizes `sizes`: every pixel
    takes the first launch, then each launch's samples only while it has
    not stopped, deciding after each launch but the last. Returns (gamma
    image (P, 3), sample counts (P,), segments (P,))."""
    pixels = np.asarray(pixels, np.int64).reshape(-1, 2)
    n_pix = pixels.shape[0]
    acc = torch.zeros((n_pix, 5), dtype=torch.float32, device=device)
    segs = torch.zeros((n_pix,), dtype=torch.int64, device=device)
    cstats = (torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
              if sampler == "stratified" else None)
    active = torch.ones((n_pix,), dtype=torch.bool, device=device)
    off = 0
    for j, cs in enumerate(sizes):
        act = torch.nonzero(active).flatten()
        if act.numel():
            contrib, sg = trace(spheres, cam, width, height, seed,
                                pixels[act.cpu().numpy()], off, cs,
                                max_depth, sampler, dtype, device)
            lum = (contrib[..., 0] + contrib[..., 1] + contrib[..., 2]) \
                * float(ONE_THIRD)
            per = torch.cat([contrib, torch.ones_like(lum)[..., None],
                             (lum * lum)[..., None]], 2)
            part = sum_in_order(per, [cs])
            part[:, 3] = float(cs)
            prev = acc[act]
            new = prev + part
            if cstats is not None and j > 0:
                m_c = ((new[:, 0] + new[:, 1] + new[:, 2]
                        - (prev[:, 0] + prev[:, 1] + prev[:, 2]))
                       * (1.0 / 3.0) / torch.clamp_min(new[:, 3] - prev[:, 3],
                                                       1.0))
                cstats[act] = cstats[act] + torch.stack(
                    [torch.ones_like(m_c), m_c, m_c * m_c], 1)
            acc[act] = new
            segs[act] += sg.sum(1)
        off += cs
        if j + 1 < len(sizes):
            stop = converged(acc, tol, cstats if j > 0 else None)
            active = ~stop
    n = torch.clamp_min(acc[:, 3], 1.0)
    return gamma(acc[:, :3] / n[:, None]), acc[:, 3], segs


# --- the viewer: running average and picking -------------------------


def blend(prev, new, render_count: int, weight: float = 1.0):
    """The viewer's running average: new where the count is at most 1,
    else (prev * rc + new * w) / (rc + w), in float32."""
    rc, w = np.float32(render_count), np.float32(weight)
    if rc <= 1.0:
        return new.clone()
    out = prev * float(rc) + (new if w == 1.0 else new * float(w))
    return out / torch.tensor(float(rc + w), dtype=torch.float32,
                              device=prev.device)


def pick(spheres: dict, basis: dict, dtype=torch.float64):
    """The centre-of-view pick: the ray from the camera origin through the
    viewport centre, no lens offset, t from 0 to MAX_T; the closest hit,
    the later sphere of a tie. Returns (point (3,), selected index or
    1000 on a miss)."""
    o = torch.as_tensor(basis["origin"], dtype=torch.float64)
    d = (torch.as_tensor(basis["lower_left_corner"], dtype=torch.float64)
         + torch.as_tensor(basis["horizontal"], dtype=torch.float64) / 2
         + torch.as_tensor(basis["vertical"], dtype=torch.float64) / 2 - o)
    o, d = o.to(dtype), d.to(dtype)
    c = torch.as_tensor(np.asarray(spheres["center"]),
                        dtype=torch.float64).to(dtype)
    r = torch.as_tensor(np.asarray(spheres["radius"]),
                        dtype=torch.float64).to(dtype)
    act = torch.as_tensor(np.asarray(spheres["active"])) > 0
    oc = o[None, :] - c
    a = (d * d).sum()
    half_b = (oc * d[None, :]).sum(1)
    cc = (oc * oc).sum(1) - r * r
    disc = half_b * half_b - a * cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    near, far = (-half_b - sq) / a, (-half_b + sq) / a
    root = torch.where(near >= 0, near, far)
    valid = (disc >= 0) & act & (root >= 0) & (root <= MAX_T)
    if not bool(valid.any()):
        return np.zeros(3), 1000
    cand = torch.where(valid, root, torch.inf)
    best = cand.min()
    idx = int(torch.nonzero(valid & (cand == best)).flatten().max())
    point = (o + best * d).to(torch.float64).numpy()
    return point, idx
