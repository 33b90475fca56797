"""Struct-of-arrays sphere scene (counterpart of
``raytracer_tpu/scene/spheres.py``).

A negative radius flips the outward normal (hollow glass shells);
``active`` is 1.0 for live slots and 0.0 for padding, which is never hit.

A :class:`MotionScene` (the port's own) adds a shutter: each sphere's
centre at the shutter's close, to which it moves linearly from
``center`` over the frame (a static sphere's equals its start), and the
odd colour of a checker material. Only the motion walk renders one
(``render/megakernel.py`` ``choose_kernel``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from raytracer_tpu_torch.scene.materials import Material
from raytracer_tpu_torch.utils.profiling import wait

#: the selection id of "nothing selected" (the reference's
#: NO_SELECTED_OBJECT_ID)
NO_SELECTED_OBJECT_ID = 1000


@dataclasses.dataclass(frozen=True)
class Scene:
    center: torch.Tensor  # (N, 3) float32
    radius: torch.Tensor  # (N,) float32
    material_type: torch.Tensor  # (N,) int32
    albedo: torch.Tensor  # (N, 3) float32
    fuzz: torch.Tensor  # (N,) float32
    refraction_index: torch.Tensor  # (N,) float32
    active: torch.Tensor  # (N,) float32

    @property
    def count(self) -> int:
        """Slot count, padding included."""
        return self.center.shape[0]

    def num_active(self) -> torch.Tensor:
        """Live slots, as a 0-d int32 tensor on the scene's device."""
        return self.active.sum().to(torch.int32)

    def pad_to(self, n: int) -> "Scene":
        """The scene padded with inactive slots up to ``n``; the padding's
        radius and refraction index are 1, so 1/r stays finite."""
        cur = self.count
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"cannot pad scene of {cur} spheres down to {n}")
        extra = n - cur

        def pad(x, fill=0.0):
            tail = torch.full((extra, *x.shape[1:]), fill, dtype=x.dtype,
                              device=x.device)
            return torch.cat([x, tail])

        return Scene(
            center=pad(self.center),
            radius=pad(self.radius, 1.0),
            material_type=pad(self.material_type, 0),
            albedo=pad(self.albedo),
            fuzz=pad(self.fuzz),
            refraction_index=pad(self.refraction_index, 1.0),
            active=pad(self.active),
        )

    def to(self, device) -> "Scene":
        """The scene with every field on ``device``."""
        return type(self)(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    def numpy(self) -> dict:
        """The fields as host numpy arrays; each field's read waits for
        the device, the wait ``scene_read`` (``utils/profiling.py``)."""
        out = {}
        for f in dataclasses.fields(self):
            with wait("scene_read"):
                out[f.name] = getattr(self, f.name).detach().cpu().numpy()
        return out


@dataclasses.dataclass(frozen=True)
class MotionScene(Scene):
    """A scene with a shutter: sphere i's centre moves linearly from
    ``center[i]`` at time 0 to ``center1[i]`` at time 1, and a checker
    material (``materials.CHECKER``) takes ``albedo[i]`` as its even
    colour and ``albedo_odd[i]`` as its odd one."""

    center1: torch.Tensor  # (N, 3) float32, the centre at time 1
    albedo_odd: torch.Tensor  # (N, 3) float32, a checker's odd colour

    def pad_to(self, n: int) -> "MotionScene":
        """The scene padded with inactive slots up to ``n``; the padding
        does not move."""
        cur = self.count
        base = Scene.pad_to(self, n)
        if base is self:
            return self
        tail = torch.zeros((n - cur, 3), dtype=torch.float32,
                           device=self.center.device)
        return MotionScene(**{f.name: getattr(base, f.name)
                              for f in dataclasses.fields(Scene)},
                           center1=torch.cat([self.center1, tail]),
                           albedo_odd=torch.cat([self.albedo_odd, tail]))


def is_motion(scene: Scene) -> bool:
    """Whether ``scene`` has a shutter (moving spheres or a checker), and
    so renders through the motion walk only."""
    return isinstance(scene, MotionScene)


def as_motion(scene: Scene) -> MotionScene:
    """``scene`` as a :class:`MotionScene`: itself where it is one, else
    its spheres standing still, each checker's odd colour its even one."""
    if is_motion(scene):
        return scene
    return MotionScene(**{f.name: getattr(scene, f.name)
                          for f in dataclasses.fields(Scene)},
                       center1=scene.center.clone(),
                       albedo_odd=scene.albedo.clone())


def scene_from_numpy(center, radius, material_type, albedo, fuzz,
                     refraction_index, active, device="cpu", *,
                     center1=None, albedo_odd=None) -> Scene:
    """Build a :class:`Scene` from the JAX ``Scene`` fields as arrays.
    With ``center1`` (each sphere's centre at the shutter's close) or
    ``albedo_odd`` (a checker's odd colour), a :class:`MotionScene`;
    the other of the two defaults to ``center`` or ``albedo``."""

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    fields = dict(
        center=t(center, torch.float32).reshape(-1, 3),
        radius=t(radius, torch.float32),
        material_type=t(material_type, torch.int32),
        albedo=t(albedo, torch.float32).reshape(-1, 3),
        fuzz=t(fuzz, torch.float32),
        refraction_index=t(refraction_index, torch.float32),
        active=t(active, torch.float32),
    )
    if center1 is None and albedo_odd is None:
        return Scene(**fields)
    return MotionScene(
        **fields,
        center1=(fields["center"].clone() if center1 is None
                 else t(center1, torch.float32).reshape(-1, 3)),
        albedo_odd=(fields["albedo"].clone() if albedo_odd is None
                    else t(albedo_odd, torch.float32).reshape(-1, 3)))


def make_scene(
    spheres: Sequence[Tuple[Tuple[float, float, float], float, Material]],
    pad_to: int | None = None,
) -> Scene:
    """Build a :class:`Scene` from (center, radius, material) triples,
    padded with inactive slots up to ``pad_to`` when given."""
    if not spheres:
        raise ValueError("scene must contain at least one sphere")
    mats = [s[2] for s in spheres]
    odd = (None if all(m.albedo_odd is None for m in mats) else
           np.array([m.albedo if m.albedo_odd is None else m.albedo_odd
                     for m in mats], np.float32))
    scene = scene_from_numpy(
        center=np.array([s[0] for s in spheres], np.float32),
        radius=np.array([s[1] for s in spheres], np.float32),
        material_type=np.array([m.material_type for m in mats], np.int32),
        albedo=np.array([m.albedo for m in mats], np.float32),
        fuzz=np.array([m.fuzz for m in mats], np.float32),
        refraction_index=np.array([m.refraction_index for m in mats],
                                  np.float32),
        active=np.ones(len(spheres), np.float32),
        albedo_odd=odd,
    )
    return scene if pad_to is None else scene.pad_to(pad_to)


def _set(field: torch.Tensor, index: int, value) -> torch.Tensor:
    """A copy of ``field`` with row ``index`` set to ``value`` (cast to the
    field's type, on its device)."""
    out = field.clone()
    out[index] = torch.as_tensor(value, dtype=field.dtype,
                                 device=field.device)
    return out


def update_sphere(scene: Scene, index: int, center=None, radius=None,
                  material: Material | None = None,
                  active: bool | None = None) -> Scene:
    """A new :class:`Scene` with sphere ``index`` changed; ``scene`` is
    left as it was. Restart a progressive average after an edit, as after a
    camera move. In a :class:`MotionScene` a moved sphere keeps its motion
    (its end centre moves with it), and a new material sets its odd
    colour (the even one, but for a checker); a checker put into a static
    scene makes it a :class:`MotionScene`."""
    if material is not None and material.albedo_odd is not None:
        scene = as_motion(scene)
    changes = {}
    if center is not None:
        changes["center"] = _set(scene.center, index, center)
        if is_motion(scene):
            shift = (torch.as_tensor(center, dtype=torch.float32,
                                     device=scene.center.device)
                     - scene.center[index])
            changes["center1"] = _set(scene.center1, index,
                                      scene.center1[index] + shift)
    if radius is not None:
        changes["radius"] = _set(scene.radius, index, radius)
    if material is not None:
        changes.update(
            material_type=_set(scene.material_type, index,
                               material.material_type),
            albedo=_set(scene.albedo, index, material.albedo),
            fuzz=_set(scene.fuzz, index, material.fuzz),
            refraction_index=_set(scene.refraction_index, index,
                                  material.refraction_index),
        )
        if is_motion(scene):
            changes["albedo_odd"] = _set(
                scene.albedo_odd, index, material.albedo
                if material.albedo_odd is None else material.albedo_odd)
    if active is not None:
        changes["active"] = _set(scene.active, index,
                                 1.0 if active else 0.0)
    return dataclasses.replace(scene, **changes)


def add_sphere(scene: Scene, center, radius, material: Material) -> Scene:
    """A new :class:`Scene` with one more live sphere: in the first
    inactive slot where there is one (the slot count stays), else in a
    slot appended at the end. Reads ``active`` on the host."""
    inactive = np.flatnonzero(scene.active.cpu().numpy() == 0.0)
    if inactive.size:
        return update_sphere(scene, int(inactive[0]), center=center,
                             radius=radius, material=material, active=True)
    grown = scene.pad_to(scene.count + 1)
    return update_sphere(grown, scene.count, center=center, radius=radius,
                         material=material, active=True)


def remove_sphere(scene: Scene, index: int) -> Scene:
    """A new :class:`Scene` with sphere ``index`` inactive: it is never
    hit, and :func:`add_sphere` may reuse its slot."""
    return update_sphere(scene, index, active=False)
