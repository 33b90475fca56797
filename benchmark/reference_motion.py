"""The plain reference of scenes with a shutter, which decides `correct`
for them: `reference.py`'s semantics with moving spheres and the checker
texture of *Ray Tracing: The Next Week* (v3.2, sections 2 and 4), in
plain PyTorch, independent of the program under test. It imports torch,
numpy and `benchmark.reference`'s hash, camera and sum helpers only.

What it adds to `reference.py`, and the program must reproduce:

- the time stream: sample s of a pixel (s counted from 0 over the whole
  render, s_abs) takes its time t in [0, 1) from draw 0 of counter
  SHUTTER_CTR + s_abs, u01(pix, 2^31 + s_abs, 0): a counter past every
  sample's block [s * dps, (s + 1) * dps) while those stay below 2^31,
  and apart from the stratified rotations (0xFFFFFFF8 and up), so no
  other draw moves. Both samplers draw it so;
- a moving sphere: centre c0 at time 0, c1 at time 1, tested at
  c(t) = c0 + t * (c1 - c0), computed in that order (c1 - c0 once, in
  the scene's float32), with k1 = |c(t)|^2 - r^2; its normal at a hit
  is taken from c(t) too;
- the checker material (code 3): Lambertian, its albedo the odd colour
  where sin(10 x) * sin(10 y) * sin(10 z) < 0 at the hit point, else the
  even one (the sphere's albedo).

Departures from the book, each stated: the book draws time with its own
random_double() (here the counter hash above) and traces in double (here
float32, the configuration's precision: so `allow_tf32` is off, though
nothing here multiplies matrices); the layout is drawn from numpy's
default_rng(0) (the configuration's file lists it); a path that runs out
of its bounces returns its throughput, and a miss sees the sky gradient,
as in `reference.py`; the checker reads the float32 hit point.

As `reference.fixed_pixels`, every lane is one (pixel, sample) pair and
a bounce is a dense (lanes x spheres) pass, in blocks of LANE_BLOCK lanes,
in `dtype`: float32, or bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference as ref

#: counter of a sample's time, less its absolute index
SHUTTER_CTR = 0x80000000
CHECKER = 3
#: lanes traced together: a (lanes x spheres) pass of 487 spheres forms
#: the centres at each lane's time, four temporaries more than
#: `reference.py`'s, so its block is a quarter of that one's
LANE_BLOCK = 1 << 14


def shutter_time(pix, s_abs, dtype):
    """The time in [0, 1) of absolute sample `s_abs` of pixel hash
    `pix`."""
    return ref.u01(pix, (SHUTTER_CTR + s_abs) & ref.M32, 0, dtype)


def sphere_rows(spheres: dict, device, dtype) -> dict:
    """The spheres as tensors: c0, its motion c1 - c0 (in float32), r^2,
    signed 1/r, material, albedo, odd colour, fuzz, ior. A sphere that is
    inactive, or lies wholly beyond MAX_T at both ends, is never hit: its
    centre and motion are 0 and r^2 is -1, so k1 is 1 at every time."""
    def f32(k):
        return torch.as_tensor(np.asarray(spheres[k], np.float32))

    c0, c1, r = f32("center"), f32("center1"), f32("radius")

    def norm(c):
        return torch.sqrt(c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]
                          + c[:, 2] * c[:, 2])

    act = f32("active") > 0
    act &= (torch.minimum(norm(c0), norm(c1)) - r.abs()) <= ref.MAX_T
    rows = {
        "c0": torch.where(act[:, None], c0, 0.0),
        "mv": torch.where(act[:, None], c1 - c0, 0.0),
        "r2": torch.where(act, r * r, -1.0),
        "inv_r": torch.where(r == 0, 1.0, 1.0 / torch.where(r == 0, 1.0, r)),
        "mat": torch.as_tensor(np.asarray(spheres["material_type"],
                                          np.int64)),
        "albedo": f32("albedo"),
        "odd": f32("albedo_odd"),
        "fuzz": f32("fuzz"),
        "ior": f32("refraction_index"),
    }
    return {k: (v.to(device) if v.dtype == torch.int64
                else v.to(device=device, dtype=dtype))
            for k, v in rows.items()}


def trace(spheres: dict, cam: np.ndarray, width: int, height: int,
          seed: int, pixels: np.ndarray, s0: int, count: int,
          max_depth: int, sampler: str = "random",
          dtype=torch.float32, device="cpu"):
    """`reference.trace` of a scene with a shutter: samples s0 .. s0 +
    count - 1 of every pixel in `pixels` ((P, 2) [px, py]). Returns
    float32 contributions (P, count, 3) and int64 segments (P, count)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pixels = np.asarray(pixels, np.int64).reshape(-1, 2)
    n_pix = pixels.shape[0]
    rows = sphere_rows(spheres, device, dtype)
    camt = torch.as_tensor(cam, dtype=torch.float32).to(device=device,
                                                         dtype=dtype)
    wp = -(-width // 128) * 128
    px = torch.as_tensor(pixels[:, 0], device=device)
    py = torch.as_tensor(pixels[:, 1], device=device)
    pix = ref.lowbias32(((py * wp + px) ^ (seed & ref.M32)) & ref.M32)
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


def _trace_lanes(rows, cam, px, py, pix, s_abs, inv_w, inv_h, max_depth,
                 stratified, dtype):
    """One block of lanes, bounce by bounce, compacting finished ones;
    `reference._trace_lanes` with each lane's time."""
    dev = px.device
    n = px.shape[0]
    dps = 4 + ref.DRAWS_PER_BOUNCE * max_depth
    (ox, oy, oz), (dx, dy, dz) = ref._camera_ray(
        cam, px, py, pix, s_abs, dps, inv_w, inv_h, stratified, dtype)
    tm = shutter_time(pix, s_abs, dtype)
    one = torch.ones(n, dtype=dtype, device=dev)
    tr, tg, tb = one, one.clone(), one.clone()
    idx = torch.arange(n, device=dev)
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    segs = torch.zeros((n,), dtype=torch.int64, device=dev)
    c0, mv, r2 = rows["c0"], rows["mv"], rows["r2"]
    for bounce in range(max_depth):
        if idx.numel() == 0:
            break
        a = ref._dot(dx, dy, dz, dx, dy, dz)
        o_dot_d = ref._dot(ox, oy, oz, dx, dy, dz)
        o_dot_o = ref._dot(ox, oy, oz, ox, oy, oz)
        min_t_a = ref.MIN_T * a
        # every sphere at each lane's time: (lanes, spheres)
        tcol = tm[:, None]
        cx = c0[None, :, 0] + tcol * mv[None, :, 0]
        cy = c0[None, :, 1] + tcol * mv[None, :, 1]
        cz = c0[None, :, 2] + tcol * mv[None, :, 2]
        k1 = cx * cx + cy * cy + cz * cz - r2[None, :]
        cdd = cx * dx[:, None] + cy * dy[:, None] + cz * dz[:, None]
        cdo = cx * ox[:, None] + cy * oy[:, None] + cz * oz[:, None]
        del cx, cy, cz
        nb = cdd - o_dot_d[:, None]
        del cdd
        cc = o_dot_o[:, None] - 2.0 * cdo + k1
        del cdo, k1
        ds = nb * nb - a[:, None] * cc
        del cc
        sq = torch.where(ds >= 0, torch.sqrt(ds.abs()), -ref.FILL)
        qn = nb - sq
        q = torch.where(qn >= min_t_a[:, None], qn, nb + sq)
        del nb, sq, qn, ds
        q = torch.where(q >= min_t_a[:, None], q, ref.FILL)
        bq, bs = q.min(dim=1)
        del q
        segs[idx] += 1
        best_t = bq * (1.0 / a)
        hit = best_t < ref.Q_CUT
        udx, udy, udz = ref._normalize(dx, dy, dz)
        sky_t = 0.5 * (udy + 1.0)
        con = torch.stack([tr * (1.0 - 0.5 * sky_t),
                           tg * (1.0 - ref.SKY_G * sky_t), tb], 1)
        con = torch.where(hit[:, None], 0.0, con)
        # a hit: the winner's centre at the lane's time, its normal
        wc = c0[bs] + tm[:, None] * mv[bs]
        hpx, hpy, hpz = ox + best_t * dx, oy + best_t * dy, oz + best_t * dz
        inv_r = rows["inv_r"][bs]
        nx, ny, nz = ((hpx - wc[:, 0]) * inv_r, (hpy - wc[:, 1]) * inv_r,
                      (hpz - wc[:, 2]) * inv_r)
        front = ref._dot(dx, dy, dz, nx, ny, nz) < 0
        sgn = torch.where(front, 1.0, -1.0).to(dtype)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
        mat = rows["mat"][bs]
        checker = mat == CHECKER
        diffuse, metal, glass = (mat == 0) | checker, mat == 1, mat == 2
        ctr = (ref.mul32(s_abs & ref.M32, dps) + 4
               + bounce * ref.DRAWS_PER_BOUNCE) & ref.M32
        strat0 = diffuse & stratified & (bounce == 0)
        hx = torch.where(diffuse, ref.u01(pix, ctr, 0, dtype),
                         ref.u01(pix, ctr, 3, dtype)) * 2.0 - 1.0
        phi = torch.where(diffuse, ref.u01(pix, ctr, 1, dtype),
                          ref.u01(pix, ctr, 4, dtype)) * float(ref.TWO_PI)
        ur = torch.where(diffuse, ref.u01(pix, ctr, 2, dtype),
                         ref.u01(pix, ctr, 5, dtype))
        r = torch.exp(torch.log(torch.clamp_min(ur, ref.U_EPS))
                      * float(ref.ONE_THIRD))
        if stratified and bounce == 0:
            hx = torch.where(strat0, ref.r2(pix, ref.ROT_BOUNCE0, 0, s_abs,
                                            ref.AB0_FIX[0], dtype) * 2.0
                             - 1.0, hx)
            phi = torch.where(strat0, ref.r2(pix, ref.ROT_BOUNCE0, 1, s_abs,
                                             ref.AB0_FIX[1], dtype)
                              * float(ref.TWO_PI), phi)
            r = torch.where(strat0, 1.0, r).to(dtype)
        s = torch.sqrt(torch.clamp_min(1.0 - hx * hx, 0.0))
        rs = r * s
        vx, vy, vz = rs * torch.sin(phi), rs * torch.cos(phi), r * hx
        nvx, nvy, nvz = ref._normalize(vx, vy, vz)
        keep = strat0 | ~diffuse
        vx = torch.where(keep, vx, nvx)
        vy = torch.where(keep, vy, nvy)
        vz = torch.where(keep, vz, nvz)
        ndx, ndy, ndz = nx + vx, ny + vy, nz + vz
        scat = diffuse.clone()
        d_dot_n = ref._dot(dx, dy, dz, nx, ny, nz)
        fuzz = rows["fuzz"][bs]
        mdx = dx - 2.0 * d_dot_n * nx + fuzz * vx
        mdy = dy - 2.0 * d_dot_n * ny + fuzz * vy
        mdz = dz - 2.0 * d_dot_n * nz + fuzz * vz
        m_scat = ref._dot(nx, ny, nz, mdx, mdy, mdz) > 0
        ndx = torch.where(metal, mdx, ndx)
        ndy = torch.where(metal, mdy, ndy)
        ndz = torch.where(metal, mdz, ndz)
        scat = scat | (metal & m_scat)
        refr = rows["ior"][bs]
        ratio = torch.where(front, 1.0 / refr, refr)
        cos_t = torch.clamp_max(-ref._dot(udx, udy, udz, nx, ny, nz), 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        cannot = ratio * sin_t > 1.0
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        one_m = 1.0 - cos_t
        one_m2 = one_m * one_m
        schlick = r0 + (1.0 - r0) * one_m2 * one_m2 * one_m
        glass_u = ref.u01(pix, ctr, 6, dtype)
        if stratified and bounce == 0:
            glass_u = ref.r2(pix, ref.ROT_BOUNCE0, 2, s_abs, ref.AB0_FIX[2],
                             dtype)
        reflect = cannot | (schlick > glass_u)
        ud_dot_n = ref._dot(udx, udy, udz, nx, ny, nz)
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
        # the checker's colour at the hit point
        odd = checker & ((torch.sin(10.0 * hpx) * torch.sin(10.0 * hpy)
                          * torch.sin(10.0 * hpz)) < 0)
        alb = torch.where(odd[:, None], rows["odd"][bs], rows["albedo"][bs])
        tr = torch.where(scat, tr * alb[:, 0], tr)
        tg = torch.where(scat, tg * alb[:, 1], tg)
        tb = torch.where(scat, tb * alb[:, 2], tb)
        exhausted = scat & (bounce >= max_depth - 1)
        con = torch.where(exhausted[:, None],
                          torch.stack([tr, tg, tb], 1), con)
        out[idx] += con.to(torch.float32)
        go = scat & ~exhausted
        idx = idx[go]
        px, py, pix, s_abs, tm = px[go], py[go], pix[go], s_abs[go], tm[go]
        ox, oy, oz = hpx[go], hpy[go], hpz[go]
        dx, dy, dz = ndx[go], ndy[go], ndz[go]
        tr, tg, tb = tr[go], tg[go], tb[go]
    return out, segs


def fixed_pixels(spheres, cam, width, height, seed, pixels, spp, max_depth,
                 sizes, sampler="random", dtype=torch.float32,
                 device="cpu", sample_offset=0):
    """Pixels of a fixed-spp render of a scene with a shutter: (gamma
    image (P, 3), segments (P,)), as `reference.fixed_pixels`."""
    contrib, segs = trace(spheres, cam, width, height, seed, pixels,
                          sample_offset, spp, max_depth, sampler, dtype,
                          device)
    acc = ref.sum_in_order(contrib, sizes)
    return ref.gamma(acc * float(np.float32(1.0 / spp))), segs.sum(1)
