"""Scene and camera presets (counterpart of
``raytracer_tpu/scene/presets.py``): the reference demo scene and the
BASELINE configs from *Ray Tracing in One Weekend*. The cover scene is
drawn from ``np.random.default_rng(seed)`` exactly as the JAX package
draws it, so both packages build equal arrays. The port alone has the
SPD sphereflake (:func:`sphereflake_scene`), a scene past the flat scan
and past a 128-cluster partition, and *The Next Week*'s bouncing spheres
(:func:`bouncing_spheres_scene`), moving spheres over a checker ground:
a :class:`~raytracer_tpu_torch.scene.spheres.MotionScene`."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import CameraConfig
from raytracer_tpu_torch.scene.materials import Material
from raytracer_tpu_torch.scene.spheres import MotionScene, Scene, make_scene


def demo_scene() -> Scene:
    """The reference's default 9-sphere scene."""
    d, m, g = Material.diffuse, Material.metal, Material.glass
    return make_scene(
        [
            ((0.0, -100.5, -1.0), 100.0, d((0.75, 0.6, 0.5))),
            ((0.0, 0.0, -1.0), 0.5, d((0.3, 0.3, 0.4))),
            ((-1.1, 0.0, -1.0), 0.5, m((1.0, 1.0, 1.0))),
            ((1.1, 0.0, -1.0), 0.5, g(1.5)),
            ((-0.5, -0.35, -0.55), -0.15, m((1.0, 1.0, 1.0))),
            ((-0.75, -0.4, -0.35), -0.1, m((1.0, 1.0, 1.0))),
            ((0.0, 1.2, 4.0), 2.0, d((1.0, 0.8, 0.8))),
            ((150.0, 20.0, -500.0), 100.0, d((0.95, 0.95, 1.0))),
            ((170.0, -20.0, -350.0), 30.0, d((1.0, 1.0, 1.0))),
        ]
    )


def demo_camera(width: int, height: int) -> CameraConfig:
    return CameraConfig.create(
        origin=(0.0, 0.0, 1.0), yaw=-90.0, pitch=0.0, fov=math.pi / 3.0,
        aperture=0.0, focus_distance=0.75, aspect_ratio=width / height,
    )


def two_sphere_scene() -> Scene:
    """Config 1: diffuse sphere + ground."""
    d = Material.diffuse
    return make_scene(
        [
            ((0.0, 0.0, -1.0), 0.5, d((0.5, 0.5, 0.5))),
            ((0.0, -100.5, -1.0), 100.0, d((0.5, 0.5, 0.5))),
        ]
    )


def three_sphere_scene(hollow_glass: bool = True) -> Scene:
    """Config 2: diffuse / glass / metal trio, with the hollow-glass inner
    shell when ``hollow_glass``."""
    d, m, g = Material.diffuse, Material.metal, Material.glass
    spheres = [
        ((0.0, -100.5, -1.0), 100.0, d((0.8, 0.8, 0.0))),
        ((0.0, 0.0, -1.0), 0.5, d((0.1, 0.2, 0.5))),
        ((-1.0, 0.0, -1.0), 0.5, g(1.5)),
        ((1.0, 0.0, -1.0), 0.5, m((0.8, 0.6, 0.2), fuzz=0.0)),
    ]
    if hollow_glass:
        spheres.append(((-1.0, 0.0, -1.0), -0.45, g(1.5)))
    return make_scene(spheres)


def simple_camera(width: int, height: int) -> CameraConfig:
    return CameraConfig.create(
        origin=(0.0, 0.0, 0.0), yaw=-90.0, pitch=0.0, fov=math.pi / 2.0,
        aperture=0.0, focus_distance=1.0, aspect_ratio=width / height,
    )


def dof_camera(width: int, height: int) -> CameraConfig:
    """Config 3: lookfrom (3,3,2) → lookat (0,0,-1), fov 20°, aperture 2."""
    lookfrom = np.array([3.0, 3.0, 2.0])
    lookat = np.array([0.0, 0.0, -1.0])
    yaw, pitch = yaw_pitch_from_lookat(lookfrom, lookat)
    return CameraConfig.create(
        origin=tuple(lookfrom), yaw=yaw, pitch=pitch,
        fov=math.radians(20.0), aperture=2.0,
        focus_distance=float(np.linalg.norm(lookfrom - lookat)),
        aspect_ratio=width / height,
    )


def cover_scene(seed: int = 0) -> Scene:
    """Config 5: the RTiOW cover scene (487 spheres for seed 0)."""
    rng = np.random.default_rng(seed)
    d, m, g = Material.diffuse, Material.metal, Material.glass
    spheres = [((0.0, -1000.0, 0.0), 1000.0, d((0.5, 0.5, 0.5)))]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.array(center)
                              - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = tuple(rng.random(3) * rng.random(3))
                spheres.append((center, 0.2, d(albedo)))
            elif choose_mat < 0.95:
                albedo = tuple(rng.random(3) * 0.5 + 0.5)
                fuzz = float(rng.random() * 0.5)
                spheres.append((center, 0.2, m(albedo, fuzz=fuzz)))
            else:
                spheres.append((center, 0.2, g(1.5)))
    spheres.append(((0.0, 1.0, 0.0), 1.0, g(1.5)))
    spheres.append(((-4.0, 1.0, 0.0), 1.0, d((0.4, 0.2, 0.1))))
    spheres.append(((4.0, 1.0, 0.0), 1.0, m((0.7, 0.6, 0.5), fuzz=0.0)))
    return make_scene(spheres)


def cover_camera(width: int, height: int) -> CameraConfig:
    """Cover camera: lookfrom (13,2,3) → (0,0,0), fov 20°, aperture 0.1,
    focus 10."""
    lookfrom = np.array([13.0, 2.0, 3.0])
    lookat = np.array([0.0, 0.0, 0.0])
    yaw, pitch = yaw_pitch_from_lookat(lookfrom, lookat)
    return CameraConfig.create(
        origin=tuple(lookfrom), yaw=yaw, pitch=pitch,
        fov=math.radians(20.0), aperture=0.1, focus_distance=10.0,
        aspect_ratio=width / height,
    )


def bouncing_spheres_scene(seed: int = 0) -> MotionScene:
    """*Ray Tracing: The Next Week* (v3.2), section 2's
    ``random_scene()`` with section 4's checker ground: the cover's
    layout, drawn from ``np.random.default_rng(seed)`` in the book's
    order as :func:`cover_scene` draws it, but every small diffuse sphere
    moves over the shutter [0, 1] from its centre c to c + (0, u, 0),
    u = 0.5 × a draw taken right after its albedo; the ground is
    Lambertian under the checker of even (0.2, 0.3, 0.1) and odd (0.9,
    0.9, 0.9)."""
    rng = np.random.default_rng(seed)
    d, m, g = Material.diffuse, Material.metal, Material.glass
    checker = Material.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    spheres = [((0.0, -1000.0, 0.0), 1000.0, checker)]
    ends = [spheres[0][0]]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.array(center)
                              - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            end = center
            if choose_mat < 0.8:
                albedo = tuple(rng.random(3) * rng.random(3))
                end = (center[0], center[1] + 0.5 * rng.random(), center[2])
                spheres.append((center, 0.2, d(albedo)))
            elif choose_mat < 0.95:
                albedo = tuple(rng.random(3) * 0.5 + 0.5)
                fuzz = float(rng.random() * 0.5)
                spheres.append((center, 0.2, m(albedo, fuzz=fuzz)))
            else:
                spheres.append((center, 0.2, g(1.5)))
            ends.append(end)
    for big in (((0.0, 1.0, 0.0), 1.0, g(1.5)),
                ((-4.0, 1.0, 0.0), 1.0, d((0.4, 0.2, 0.1))),
                ((4.0, 1.0, 0.0), 1.0, m((0.7, 0.6, 0.5), fuzz=0.0))):
        spheres.append(big)
        ends.append(big[0])
    scene = make_scene(spheres)
    return dataclasses.replace(scene, center1=torch.tensor(
        np.array(ends, np.float32)))


def bouncing_camera(width: int, height: int) -> CameraConfig:
    """The bouncing spheres' camera: the cover's (lookfrom (13,2,3) →
    (0,0,0), fov 20°, aperture 0.1, focus 10). Its shutter opens at 0
    and closes at 1: the motion walk draws each camera ray's time
    uniformly in [0, 1)."""
    return cover_camera(width, height)


def _rotation(axis, angle: float) -> np.ndarray:
    """The 3x3 rotation about the unit ``axis`` by ``angle`` (right-hand
    rule), Rodrigues' formula."""
    k = np.asarray(axis, np.float64)
    cross = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                      [-k[1], k[0], 0.0]])
    return (np.eye(3) + math.sin(angle) * cross
            + (1.0 - math.cos(angle)) * cross @ cross)


def sphereflake_directions() -> np.ndarray:
    """(9, 3) unit directions of a sphereflake sphere's children, as the
    SPD's ``balls.c`` makes them: three vectors turned about (1, -1, 0)
    by asin(2/sqrt(6)), then each turned about z by 0, 120 and 240
    degrees. Six lie on the equator (azimuths 15 + 60m degrees), three
    at elevation 54.74 degrees (azimuths 45, 165, 285)."""
    d = 1.0 / math.sqrt(2.0)
    tilt = _rotation((d, -d, 0.0), math.asin(2.0 / math.sqrt(6.0)))
    base = [tilt @ np.array(t) for t in ((d, d, 0.0), (d, 0.0, -d),
                                         (0.0, d, -d))]
    return np.array([_rotation((0.0, 0.0, 1.0), 2.0 * math.pi * k / 3.0)
                     @ t for k in range(3) for t in base])


def _flake(depth: int, center, radius: float, direction, dirs, out):
    """``balls.c``'s recursion: the sphere, then (at depth > 0) its nine
    children of a third its radius, tangent to it, along ``dirs`` turned
    from +z onto ``direction``, depth first."""
    out.append((center, radius))
    if depth == 0:
        return
    z = np.array([0.0, 0.0, 1.0])
    if direction[2] >= 1.0:
        turn = np.eye(3)
    elif direction[2] <= -1.0:
        turn = _rotation((0.0, 1.0, 0.0), math.pi)
    else:
        axis = np.cross(z, direction)
        turn = _rotation(axis / np.linalg.norm(axis),
                         math.acos(float(z @ direction)))
    for o in dirs:
        w = turn @ o
        _flake(depth - 1, center + w * (4.0 * radius / 3.0), radius / 3.0,
               w, dirs, out)


def sphereflake_scene(size_factor: int = 4) -> Scene:
    """Eric Haines' SPD sphereflake (``balls``, "A Proposal for Standard
    Graphics Environments", IEEE CG&A, Nov. 1987) at ``size_factor``: a
    sphere of radius 0.5 at the origin and (9^(n+1) - 1) / 8 spheres in
    all, 7,381 at 4. The flake's spheres are mirrors (metal, fuzz 0,
    albedo (1.0, 0.9, 0.7)); slot 0 stands for the SPD's floor polygon at
    z = -0.5: a diffuse sphere of radius 1000 under it, albedo (1.0,
    0.75, 0.33)."""
    m, d = Material.metal, Material.diffuse
    balls = []
    _flake(size_factor, np.zeros(3), 0.5, np.array([0.0, 0.0, 1.0]),
           sphereflake_directions(), balls)
    flake = m((1.0, 0.9, 0.7), fuzz=0.0)
    return make_scene(
        [((0.0, 0.0, -1000.5), 1000.0, d((1.0, 0.75, 0.33)))]
        + [(tuple(c), r, flake) for c, r in balls])


def sphereflake_camera(width: int, height: int) -> CameraConfig:
    """The SPD's view of the sphereflake: lookfrom (2.1, 1.3, 1.7) to the
    origin, +z up, a 45 degree field of view, a pinhole focused at the
    origin's distance."""
    lookfrom = np.array([2.1, 1.3, 1.7])
    yaw, pitch = yaw_pitch_from_lookat(lookfrom, np.zeros(3))
    return CameraConfig.create(
        origin=tuple(lookfrom), yaw=yaw, pitch=pitch,
        fov=math.radians(45.0), aperture=0.0, focus_distance=2.9983,
        aspect_ratio=width / height, vup=(0.0, 0.0, 1.0),
    )


def yaw_pitch_from_lookat(lookfrom, lookat) -> Tuple[float, float]:
    """Invert front = (cos(yaw)cos(pitch), sin(pitch), sin(yaw)cos(pitch)),
    in degrees."""
    front = (np.asarray(lookat, dtype=np.float64)
             - np.asarray(lookfrom, dtype=np.float64))
    front = front / np.linalg.norm(front)
    pitch = math.degrees(math.asin(np.clip(front[1], -1.0, 1.0)))
    yaw = math.degrees(math.atan2(front[2], front[0]))
    return yaw, pitch


#: name → (scene builder, camera builder, default W, H, spp, depth)
BASELINE_CONFIGS = {
    "two_sphere": (two_sphere_scene, simple_camera, 400, 225, 16, 8),
    "three_sphere": (three_sphere_scene, simple_camera, 1280, 720, 64, 16),
    "dof": (three_sphere_scene, dof_camera, 1920, 1080, 128, 16),
    "progressive": (demo_scene, demo_camera, 1920, 1080, 1, 8),
    "cover": (cover_scene, cover_camera, 1200, 800, 500, 50),
    "demo": (demo_scene, demo_camera, 1280, 720, 1, 8),
}


def get_config(name: str, width: int | None = None,
               height: int | None = None):
    """Resolve a named config → (scene, camera, w, h, spp, depth)."""
    scene_fn, cam_fn, w, h, spp, depth = BASELINE_CONFIGS[name]
    w = width or w
    h = height or h
    return scene_fn(), cam_fn(w, h), w, h, spp, depth
