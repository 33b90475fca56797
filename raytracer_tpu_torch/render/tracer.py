"""The JAX package's wavefront path tracer, its ``jnp`` backend
(counterpart of ``raytracer_tpu/render/tracer.py``), in plain PyTorch on
the caller's device: no kernel of the port runs here, as no Pallas
kernel runs in the JAX function. Every stage works on the whole ray batch
at once, with masks of live lanes.

- :func:`hit_world` — the closest-hit scan; it also serves picking and
  the AOV views;
- :func:`scatter` — diffuse, metal and glass, all computed and selected
  by material;
- :func:`background` — the sky gradient of a miss;
- :func:`trace_rays` — the bounce loop, with the debug overlay, the
  stratified first bounce and Russian roulette;
- :func:`render_sample`, :func:`render_image_jnp` — one jittered pass of
  the pixel grid, and the spp loop with its average and gamma.

The random draws are ``jax.random``'s, bit for bit (Threefry over key
data, ``render/rng.py``): the camera's two keys and, a bounce, the three
material keys of ``split(fold_in(key, bounce), 3)`` and the roulette key
``fold_in(fold_in(key, bounce), 7)``, each over the batch positions. A
bounce evaluates all its draws in one Threefry pass, and draws nothing
that the JAX function draws and then discards (the roulette roll before
its first bounce, the first bounce's draws that the stratified sampler
replaces). Like the JAX function, the loop runs ``max_depth`` bounces
over every lane, live or not.

The closest-hit scan: the JAX function scans the spheres in a loop that
carries the best t and index. A sphere's candidate is its near root
where that is at least ``t_min``, else its far root, and it wins where
it is at least ``t_min`` and no farther than the best so far: ties go to
the later sphere (its ``<=`` test). Each sphere's candidate depends only
on the ray, so the port forms all candidates of a block of rays at once
and takes the last index of the smallest; the result is the loop's. The
arithmetic is plain float32; XLA fuses some of the JAX function's
products into multiply-adds, so t and the point may differ by a few ulps.
Note that the render kernels keep the LOWEST slot of a tie, so on exactly
coincident spheres the overlay's outline may disagree with the pick, as
in the JAX package.

Segments (live ray-bounces) are counted exactly, in int64; the JAX
function sums them in float32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raytracer_tpu_torch.camera.camera import (
    DerivedCamera,
    generate_rays,
    pixel_st_grid,
)
from raytracer_tpu_torch.core import sampling, vec
from raytracer_tpu_torch.render import rng
from raytracer_tpu_torch.render.options import (
    MAX_T,
    MIN_T,
    DebugParams,
    TraceOptions,
)
from raytracer_tpu_torch.render.tables import upload
from raytracer_tpu_torch.scene.materials import DIFFUSE, GLASS, METAL
from raytracer_tpu_torch.scene.spheres import Scene

#: candidates formed at once (rays of a block times spheres), on the CPU
#: and on a card; a ray's result does not depend on its block
BLOCK_ELEMENTS = 1 << 20
BLOCK_ELEMENTS_CUDA = 1 << 24
#: the roulette key's fold of a bounce key
ROULETTE_FOLD = 7
#: the overlay's colours: the cursor marker and the selection outline
MARKER_RGB = (0.0, 0.0, 1.0)
OUTLINE_RGB = (1.0, 0.0, 0.0)
#: the overlay's marker radius and the outline's grazing threshold
MARKER_RADIUS = 0.1
OUTLINE_COS = -0.05
SKY_RGB = (0.5, 0.7, 1.0)


class HitRecord(NamedTuple):
    """The closest hit of each ray, gathered from the winning sphere."""

    hit: torch.Tensor  # (P,) bool
    t: torch.Tensor  # (P,) in units of |d|; t_max on a miss
    point: torch.Tensor  # (P, 3)
    normal: torch.Tensor  # (P, 3), front-face corrected
    front_face: torch.Tensor  # (P,) bool
    uuid: torch.Tensor  # (P,) int32 sphere index; -1 on a miss
    material_type: torch.Tensor  # (P,) int32
    albedo: torch.Tensor  # (P, 3)
    fuzz: torch.Tensor  # (P,)
    refraction_index: torch.Tensor  # (P,)


def _closest(origin, direction, a, inv_a, scene: Scene, t_min, t_max):
    """(best t, best index) of a block of rays."""
    oc = origin[:, None, :] - scene.center[None, :, :]  # (P, S, 3)
    d = direction[:, None, :]
    half_b = vec.dot(oc, d)
    c_coef = vec.dot(oc, oc) - scene.radius * scene.radius
    disc = half_b * half_b - a[:, None] * c_coef
    sqrtd = torch.sqrt(torch.clamp_min(disc, 0.0))
    root_near = (-half_b - sqrtd) * inv_a[:, None]
    root_far = (-half_b + sqrtd) * inv_a[:, None]
    root = torch.where(root_near >= t_min, root_near, root_far)
    valid = ((disc >= 0.0) & (scene.active > 0.0) & (root >= t_min)
             & (root <= t_max))
    cand = torch.where(valid, root, torch.inf)
    best = cand.min(dim=1).values
    won = valid & (cand == best[:, None])
    # the last index of the minimum, -1 where no sphere is valid
    idx = torch.arange(scene.count, device=origin.device)
    best_idx = torch.where(won, idx, -1).max(dim=1).values
    return torch.where(best_idx >= 0, best, t_max), best_idx


def hit_world(origin: torch.Tensor, direction: torch.Tensor, scene: Scene,
              t_min: float = MIN_T, t_max: float = MAX_T) -> HitRecord:
    """Closest hit over all spheres for rays (P, 3) on the scene's
    device."""
    a = vec.length_squared(direction)  # directions are not normalised
    inv_a = 1.0 / a
    per_block = (BLOCK_ELEMENTS_CUDA if origin.device.type == "cuda"
                 else BLOCK_ELEMENTS)
    block = max(1, per_block // max(1, scene.count))
    ts, idxs = [], []
    for lo in range(0, origin.shape[0], block):
        sl = slice(lo, lo + block)
        t, i = _closest(origin[sl], direction[sl], a[sl], inv_a[sl], scene,
                        t_min, t_max)
        ts.append(t)
        idxs.append(i)
    best_t = ts[0] if len(ts) == 1 else torch.cat(ts)
    best_idx = idxs[0] if len(idxs) == 1 else torch.cat(idxs)
    hit = best_idx >= 0
    safe = torch.clamp_min(best_idx, 0)
    center = scene.center[safe]
    radius = scene.radius[safe]
    point = origin + best_t[:, None] * direction
    outward = (point - center) / radius[:, None]
    front_face = vec.dot(direction, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return HitRecord(
        hit=hit, t=best_t, point=point, normal=normal,
        front_face=front_face, uuid=best_idx.to(torch.int32),
        material_type=scene.material_type[safe],
        albedo=scene.albedo[safe], fuzz=scene.fuzz[safe],
        refraction_index=scene.refraction_index[safe])


def schlick(cosine: torch.Tensor, refraction_ratio: torch.Tensor):
    """Schlick's reflectance: r0 + (1 - r0)·(1 - cos)^5, r0 = ((1 - η) /
    (1 + η))². The powers are XLA's ``integer_pow`` by squaring: x² = x·x,
    x⁵ = x·((x·x)·(x·x))."""
    r0 = (1.0 - refraction_ratio) / (1.0 + refraction_ratio)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def scatter(direction: torch.Tensor, rec: HitRecord, key,
            opts: TraceOptions, uniforms=None):
    """Every material's scatter for every lane, selected by material:
    ``(did_scatter (P,), attenuation (P, 3), new_direction (P, 3))``.

    The draws are ``uniforms`` (unit vector (P, 3), unit-ball point
    (P, 3), glass roll (P,)) where given, else those of key data ``key``
    (``sampling.sphere_disk_glass_uniforms``). Diffuse: normal + unit
    vector (re-aimed at the normal where near zero, under
    ``near_zero_guard``). Metal: the reflection plus fuzz times the ball
    point, absorbed below the surface. Glass: Snell with total internal
    reflection and a Schlick roll; it never absorbs. Unknown materials
    absorb."""
    if uniforms is None:
        uniforms = sampling.sphere_disk_glass_uniforms(
            key, tuple(rec.t.shape), device=rec.t.device)
    unit_vec, unit_sphere, glass_u = uniforms
    diffuse_dir = rec.normal + unit_vec
    if opts.near_zero_guard:
        diffuse_dir = torch.where(vec.near_zero(diffuse_dir)[..., None],
                                  rec.normal, diffuse_dir)

    metal_dir = vec.reflect(direction, rec.normal) \
        + rec.fuzz[..., None] * unit_sphere
    metal_ok = vec.dot(rec.normal, metal_dir) > 0.0

    ratio = torch.where(rec.front_face, 1.0 / rec.refraction_index,
                        rec.refraction_index)
    unit_dir = vec.normalize(direction, eps=1e-20)
    cos_theta = torch.clamp_max(vec.dot(-unit_dir, rec.normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    glass_reflects = ((ratio * sin_theta > 1.0)
                      | (schlick(cos_theta, ratio) > glass_u))
    glass_dir = torch.where(glass_reflects[..., None],
                            vec.reflect(unit_dir, rec.normal),
                            vec.refract(unit_dir, rec.normal, ratio))

    mat = rec.material_type
    new_dir = torch.where((mat == DIFFUSE)[..., None], diffuse_dir,
                          torch.where((mat == METAL)[..., None], metal_dir,
                                      glass_dir))
    did_scatter = ((mat == DIFFUSE) | ((mat == METAL) & metal_ok)
                   | (mat == GLASS))
    return did_scatter, rec.albedo, new_dir


def background(direction: torch.Tensor) -> torch.Tensor:
    """The sky gradient of a miss: mix(white, (0.5, 0.7, 1), t), t =
    (ŷ + 1) / 2."""
    unit = vec.normalize(direction, eps=1e-20)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = 1.0 - t  # white · (1 - t)
    return torch.stack([white + c * t for c in SKY_RGB], dim=-1)


def _device_vector(values, device) -> torch.Tensor:
    """A float32 vector filled on ``device`` from host floats (fills, no
    copy to the device, so nothing waits for it)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def trace_rays(origin: torch.Tensor, direction: torch.Tensor, scene: Scene,
               key, opts: TraceOptions, debug: DebugParams | None = None,
               uv_b0: torch.Tensor | None = None):
    """The bounce loop over a flat ray batch (P, 3), with key data
    ``key``: ``(color (P, 3) linear, segments)``, segments the exact
    int64 count of live ray-bounces as a 0-d tensor.

    ``uv_b0`` (P, 3): the stratified first bounce's uniforms [diffuse
    hx, diffuse φ, glass roll]; later bounces draw from the key. With
    ``opts.enable_debug`` a live hit within 0.1 of the cursor ends marker
    blue, and then one on the selected sphere seen at a grazing angle
    (dot(normal, d) > -0.05) outline red. A path that runs out of bounces
    returns its throughput, or black under ``exhaust_black``."""
    p, dev = origin.shape[0], origin.device
    rr = opts.russian_roulette_depth
    if opts.enable_debug:
        dbg = debug if debug is not None else DebugParams.none()
        cursor = _device_vector(dbg.cursor_point, dev)
        marker = _device_vector(MARKER_RGB, dev)
        outline_rgb = _device_vector(OUTLINE_RGB, dev)
    o, d = origin, direction
    color = torch.ones((p, 3), dtype=torch.float32, device=dev)
    result = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((p,), dtype=torch.bool, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(opts.max_depth):
        bkey = rng.fold_in(key, i)
        segments = segments + alive.sum(dtype=torch.int64)
        rec = hit_world(o, d, scene)
        miss = alive & ~rec.hit
        result = torch.where(miss[:, None], color * background(d), result)
        live_hit = alive & rec.hit
        if opts.enable_debug:
            cursor_hit = live_hit & (vec.length(rec.point - cursor)
                                     < MARKER_RADIUS)
            result = torch.where(cursor_hit[:, None], marker, result)
            live_hit = live_hit & ~cursor_hit
            outline = (live_hit & (rec.uuid == dbg.selected_object)
                       & (vec.dot(rec.normal, d) > OUTLINE_COS))
            result = torch.where(outline[:, None], outline_rgb, result)
            live_hit = live_hit & ~outline

        # every draw of the bounce in one Threefry pass
        k_vec, k_ball, k_glass = sampling.bounce_keys(bkey)
        first_strat = uv_b0 is not None and i == 0
        draws = [(k_ball, 3 * p)]
        if not first_strat:
            draws += [(k_vec, 3 * p), (k_glass, p)]
        roll = rr > 0 and i >= rr
        if roll:
            draws.append((rng.fold_in(bkey, ROULETTE_FOLD), p))
        u = rng.uniforms(draws, dev)
        ball = sampling.unit_sphere_from_uniforms(u[0].reshape(p, 3))
        if first_strat:
            unit = sampling.unit_vector_from_uv(uv_b0[:, 0], uv_b0[:, 1])
            glass_u = uv_b0[:, 2]
        else:
            unit = sampling.unit_vector_from_uniforms(u[1].reshape(p, 3))
            glass_u = u[2]
        did_scatter, attenuation, new_dir = scatter(
            d, rec, bkey, opts, uniforms=(unit, ball, glass_u))
        scat = live_hit & did_scatter
        # an absorbed ray contributes black: its result is already 0
        color = torch.where(scat[:, None], color * attenuation, color)
        o = torch.where(scat[:, None], rec.point, o)
        d = torch.where(scat[:, None], new_dir, d)
        if roll:
            # unbiased termination: survive with p = max(throughput)
            p_surv = torch.clamp(color.max(dim=-1).values, 0.05, 1.0)
            survive = u[-1] < p_surv
            color = torch.where((scat & survive)[:, None],
                                color / p_surv[:, None], color)
            scat = scat & survive
        alive = scat
    tail = torch.zeros_like(color) if opts.exhaust_black else color
    return torch.where(alive[:, None], tail, result), segments


def render_sample(scene: Scene, dcam: DerivedCamera, st_flat: torch.Tensor,
                  sample_key, width: int, height: int, opts: TraceOptions,
                  debug: DebugParams | None = None, uv=None, uv_b0=None):
    """One jittered 1-spp pass: ray generation and trace; ``(color (P,
    3), segments)``. ``uv`` (P, 4) and ``uv_b0`` (P, 3): the stratified
    camera and first-bounce uniforms."""
    ray = generate_rays(dcam, st_flat, sample_key, width, height, uv=uv)
    return trace_rays(ray.origin, ray.direction, scene, sample_key, opts,
                      debug, uv_b0=uv_b0)


def scene_on(scene: Scene, device) -> Scene:
    """``scene`` with every field on ``device``; a host field goes to a
    card through pinned memory, without waiting for the card."""
    return dataclasses.replace(scene, **{
        f.name: upload(getattr(scene, f.name), device)
        for f in dataclasses.fields(scene)})


def camera_on(dcam: DerivedCamera, device) -> DerivedCamera:
    """``dcam`` with every field on ``device`` (as :func:`scene_on`)."""
    return dataclasses.replace(dcam, **{
        f.name: upload(getattr(dcam, f.name), device)
        for f in dataclasses.fields(dcam)})


def sample_sums(scene: Scene, dcam: DerivedCamera, st: torch.Tensor, key,
                width: int, height: int, spp: int, opts: TraceOptions,
                debug: DebugParams | None = None, sample_offset: int = 0):
    """The linear colour sums of ``spp`` passes over the pixels ``st``
    (P, 2), on their device: ``(acc (P, 3), segments)``. Sample s draws
    from ``fold_in(key, sample_offset + s)``; with the stratified sampler
    each pixel's rotations come from ``key`` alone (over the P pixels)
    and sample s is the Kronecker point sample_offset + s. The samples
    add in order, as the JAX package's loop adds them."""
    device = st.device
    cp = cp_b0 = None
    if opts.sampler == "stratified":
        cp, cp_b0 = sampling.stratified_rotations(key, st.shape[0],
                                                  device=device)
    acc = torch.zeros((st.shape[0], 3), dtype=torch.float32, device=device)
    segments = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(spp):
        s_abs = sample_offset + s
        uv = uv_b0 = None
        if cp is not None:
            uv = sampling.r2_point(cp, s_abs)
            uv_b0 = sampling.r2_point(cp_b0, s_abs, sampling.R2_ALPHAS_B0)
        color, seg = render_sample(scene, dcam, st, rng.fold_in(key, s_abs),
                                   width, height, opts, debug, uv=uv,
                                   uv_b0=uv_b0)
        acc = acc + color
        segments = segments + seg
    return acc, segments


def render_image_jnp(scene: Scene, dcam: DerivedCamera, width: int,
                     height: int, spp: int, key, opts: TraceOptions,
                     debug: DebugParams | None = None,
                     return_stats: bool = False, sample_offset: int = 0,
                     row_offset: int = 0, band_height: int | None = None,
                     *, device=None):
    """The offline render of the JAX package's ``render_image_jnp``, on
    ``device`` (the scene's when None), with key data ``key``: ``spp``
    passes, their mean and the gamma; (H, W, 3) float32, row 0 at the
    image bottom, and with ``return_stats`` ``{'segments': exact int64
    0-d tensor}``.

    Sample s draws from ``fold_in(key, sample_offset + s)``, so a render
    split into spp chunks draws the unchunked render's samples. With the
    stratified sampler each pixel's rotations come from ``key`` alone
    and sample s is the Kronecker point sample_offset + s.
    ``row_offset`` / ``band_height`` render the band of rows [row_offset,
    row_offset + band_height) of the full image's geometry, its draws
    keyed by batch position (a band is another Monte Carlo estimate of
    those rows, not the full render's pixels)."""
    device = scene.center.device if device is None else torch.device(device)
    scene, dcam = scene_on(scene, device), camera_on(dcam, device)
    bh = band_height if band_height is not None else height
    st = pixel_st_grid(width, height, device=device)[
        row_offset:row_offset + bh]
    st = st.reshape(-1, 2)
    acc, segments = sample_sums(scene, dcam, st, key, width, height, spp,
                                opts, debug, sample_offset)
    color = acc * (1.0 / spp)
    if opts.gamma:
        color = torch.sqrt(torch.clamp_min(color, 0.0))
    image = color.reshape(bh, width, 3)
    if return_stats:
        return image, {"segments": segments}
    return image
