"""Scene and camera tables of the cluster walk and the flat scan
(counterpart of ``raytracer_tpu/render/pallas_kernel.py``
``_slot_encoding``, ``_sphere_table``, ``_pad_spheres``,
``_cluster_partition``, ``_cluster_reorder``, ``_cluster_tables`` and
``_camera_uniforms``, whose debug slots 19-22 are :func:`debug_uniforms`).

The TPU layouts (sublane pre-broadcast, 128-lane winner banks, the
bf16-split parameter table, padding to 128 lanes and to 8 rows) are
gone: the tables are plain row-major float32 arrays that the kernels load
into shared memory once per block and index directly. The cluster walk's
kernel reads them packed into one array laid out as its shared memory
(:func:`walk_layout`, :func:`pack_walk`), with one level of parent boxes
over its kd leaves (:func:`parent_boxes`). A partition of more than
``MAX_CLUSTERS`` clusters takes the wide walk: levels of boxes over the
parents up to the root (:func:`hierarchy_boxes`), a 9-bit cluster index
in the visit key (:func:`key_bits`), and only the hit-test tables in
shared memory, the winner rows and the levels past the grandparents read
from global memory (:func:`wide_smem_bytes`); its threads' pending lists
take the rest of a block's shared memory (:func:`wide_list_capacity`).
A :class:`~raytracer_tpu_torch.scene.spheres.MotionScene` takes the
motion walk's tables (:func:`motion_tables`): a global or member row of
two float4, [c0 xyz, r², c1 − c0 xyz, 0], from which the walk forms the
centre at a ray's time and its k1, a winner row of 17 floats, the
static row's 11 then c1 − c0 and the checker's odd colour, and the kd
partition's boxes bounding each sphere's swept volume
(:func:`motion_partition`). Tables are built where the scene lives and
then uploaded (:func:`upload`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import DerivedCamera
from raytracer_tpu_torch.render.options import (
    MAX_T,
    DebugParams,
    TraceOptions,
)
from raytracer_tpu_torch.scene.accel import ClusteredScene, build_grid_clustered
from raytracer_tpu_torch.scene.spheres import MotionScene, Scene, is_motion
from raytracer_tpu_torch.utils.profiling import span

#: the packed visit key carries the cluster index in 7 mantissa bits
MAX_CLUSTERS = 128
#: the wide walk's key carries it in 9: partitions of up to 512 clusters
MAX_WIDE_CLUSTERS = 512
#: kd leaves under one parent box of the walk's culled box test, and
#: parents under one grandparent box of the wide walk's
PARENT_FANOUT = 4
#: threads of a narrow walk block, and the most a walk block has: the
#: wide walk's admission (:func:`wide_smem_bytes`) counts a mask of hit
#: boxes in shared memory for each, a word per 32 clusters
WALK_THREADS = 1024
#: threads of a wide walk block, each with its mask words and its pending
#: list in shared memory (:func:`wide_list_capacity`)
WIDE_WALK_THREADS = 256
#: shared memory a block of the walk may opt in to on the H100 (227 KiB)
MAX_WALK_SMEM_BYTES = 232448
#: bytes of the wide walk's shared memory between its tables and its
#: masks: four sample, iteration and bounce counts and the adaptive deal
WIDE_EXTRA_BYTES = 48
#: floats of a box in the packed tables: [lo xyz, 0, hi xyz, 0]
BOX_FLOATS = 8
#: floats of the camera's 19 uniforms in the packed tables
CAMERA_FLOATS = 20
#: floats of a winner row: [c xyz, 1/r, mat, albedo rgb, fuzz, ior,
#: uuid], and in the motion walk then c1 - c0 and the odd colour
WINNER_FLOATS, MOTION_WINNER_FLOATS = 11, 17
#: floats of a global or member row: [c xyz, k1], and in the motion walk
#: [c0 xyz, r², c1 - c0 xyz, 0]
SPHERE_FLOATS, MOTION_SPHERE_FLOATS = 4, 8


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """(x + y) + z over the last axis, the JAX package's reduction order."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def slot_encoding(scene: Scene):
    """(act, zeroed centers, k1 = |c|² − r²). Inactive slots, and slots
    wholly beyond MAX_T of the origin, are encoded unhittable: center 0
    and k1 = +1 make the discriminant negative for every ray."""
    act = (scene.active > 0.0) & (
        torch.sqrt(_sum3(scene.center * scene.center))
        - torch.abs(scene.radius) <= MAX_T
    )
    c_act = torch.where(act[:, None], scene.center, 0.0)
    k1 = torch.where(
        act, _sum3(c_act * c_act) - scene.radius * scene.radius, 1.0
    )
    return act, c_act, k1


def motion_encoding(scene: MotionScene):
    """(act, c0, c1 - c0, r²) of the motion walk's rows: a sphere is
    live as :func:`slot_encoding` has it, at either end of its motion;
    an inactive one is encoded unhittable, as there: c0 and its motion
    0 and r² = -1, so that k1 = |c|² - r² is +1 at every time. A live
    sphere's k1 at time 0 is :func:`slot_encoding`'s, in the same
    order."""
    r = scene.radius
    c0, c1 = scene.center, scene.center1
    reach = torch.minimum(torch.sqrt(_sum3(c0 * c0)),
                          torch.sqrt(_sum3(c1 * c1)))
    act = (scene.active > 0.0) & (reach - torch.abs(r) <= MAX_T)
    return (act, torch.where(act[:, None], c0, 0.0),
            torch.where(act[:, None], c1 - c0, 0.0),
            torch.where(act, r * r, -1.0))


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` contiguous on ``device``. A host tensor goes to a card
    through pinned memory, without waiting for the card: a copy from
    pageable memory would wait until the card's queue has drained."""
    device = torch.device(device)
    t = t.contiguous()
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_spheres(n: int) -> int:
    """The JAX package's sphere-row padding (a multiple of 8, at least 8):
    the split scan's ``g_full`` is counted in it."""
    return max(8, -(-n // 8) * 8)


def _winner_params(scene: Scene) -> list:
    """The columns the bounce tail reads of a hit sphere: [1/r, mat,
    albedo rgb, fuzz, ior]. 1/r is signed (a negative radius flips the
    normal) and 1 where r == 0, so no inf reaches a table."""
    r = scene.radius
    inv_r = torch.where(r == 0.0, 1.0, 1.0 / torch.where(r == 0.0, 1.0, r))
    return [inv_r, scene.material_type.to(torch.float32),
            scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
            scene.fuzz, scene.refraction_index]


def sphere_table(scene: Scene) -> torch.Tensor:
    """(S, 12) float32 rows [cx, cy, cz, k1, 1/r, mat, albedo rgb, fuzz,
    ior, active], the JAX package's ``_sphere_table`` without its padding
    rows. Centers and k1 come from :func:`slot_encoding` (inactive slots
    unhittable)."""
    _, c, k1 = slot_encoding(scene)
    return torch.stack(
        [c[:, 0], c[:, 1], c[:, 2], k1, *_winner_params(scene),
         scene.active],
        dim=1,
    ).to(torch.float32).contiguous()


def key_bits(k: int) -> int:
    """Low mantissa bits of the packed visit key that hold the cluster
    index, for a partition of ``k`` clusters: 7 up to ``MAX_CLUSTERS``,
    as the JAX package packs it, and 9 in the wide walk."""
    return 7 if k <= MAX_CLUSTERS else 9


def is_wide(k: int) -> bool:
    """Whether a partition of ``k`` clusters takes the wide walk."""
    return k > MAX_CLUSTERS


def wide_smem_bytes(lay: "WalkLayout") -> int:
    """Shared memory by which the walk admits a wide partition
    (:func:`walk_fits`): the hit-test tables (everything before the
    winner rows), the counts and deal, and a mask word per 32 clusters
    for each of ``WALK_THREADS`` threads. A wide walk block, of
    ``WIDE_WALK_THREADS``, needs no more."""
    words = -(-lay.k // 32)
    return 4 * lay.off_win + WIDE_EXTRA_BYTES + 4 * words * WALK_THREADS


def wide_list_capacity(lay: "WalkLayout") -> int:
    """Entries of a thread's pending list in the wide walk: its mask
    words, and every further word a thread's share of the
    ``MAX_WALK_SMEM_BYTES`` a block may hold leaves after the tables,
    the counts and the ``WIDE_WALK_THREADS`` threads' mask words
    (``csrc/cluster_walk.cu`` works it out alike)."""
    words = -(-lay.k // 32)
    need = 4 * lay.off_win + WIDE_EXTRA_BYTES + 4 * words * WIDE_WALK_THREADS
    spare = MAX_WALK_SMEM_BYTES - need
    return words + max(spare, 0) // (4 * WIDE_WALK_THREADS)


def walk_fits(n_global: int, k: int, group: int) -> bool:
    """Whether the walk takes a partition of ``k`` clusters of ``group``
    slots beside ``n_global`` globals: up to ``MAX_CLUSTERS`` clusters (the
    narrow walk, which holds all its tables in shared memory), and up to
    ``MAX_WIDE_CLUSTERS`` where the wide walk's shared memory fits a
    block."""
    if not 1 <= k <= MAX_WIDE_CLUSTERS:
        return False
    return not is_wide(k) or wide_smem_bytes(
        walk_layout(n_global, k, group)) <= MAX_WALK_SMEM_BYTES


def cluster_partition(scene: Scene, opts: TraceOptions):
    """The kd partition of ``scene``, or None where the scene renders with
    the flat scan instead: no small-sphere clusters, or a partition the
    walk cannot take (:func:`walk_fits`). Up to ``MAX_CLUSTERS`` clusters
    this is the JAX package's choice; past it the JAX package takes its
    flat scan, and the port its wide walk. The caller decides first
    whether the cluster walk is wanted at all
    (:func:`~raytracer_tpu_torch.render.options.cluster_scan_enabled`).
    The span ``partition``; its read of the scene, the waits
    ``scene_read``."""
    with span("partition"):
        part = build_grid_clustered(scene, group=opts.cluster_group,
                                    partition=opts.cluster_partition)
    if not walk_fits(part.n_global, part.boxes.shape[0], part.group):
        return None
    return part


def motion_partition(scene: MotionScene, opts: TraceOptions) -> ClusteredScene:
    """The kd partition of a :class:`MotionScene` for the motion walk:
    its boxes bound each sphere's swept volume, and a scene of a few
    spheres gets one of its own (one cluster, or only globals). Raises
    ``ValueError`` where the motion walk cannot take it: past
    ``MAX_CLUSTERS`` clusters (the wide walk has no motion build), or
    tables past a block's shared memory. The span ``partition`` ⊃
    ``swept``; its read of the scene, the waits ``scene_read``."""
    with span("partition"):
        part = build_grid_clustered(scene, group=opts.cluster_group,
                                    partition=opts.cluster_partition)
    k = part.boxes.shape[0]
    if k > MAX_CLUSTERS:
        raise ValueError(
            f"a scene with a shutter renders through the motion walk, "
            f"which takes up to {MAX_CLUSTERS} clusters; its partition has "
            f"{k} (the wide walk and the flat scan are static-only)")
    need = 4 * walk_layout(part.n_global, k, part.group, True).n_floats
    if need > MAX_WALK_SMEM_BYTES:
        raise ValueError(
            f"the motion walk's tables take {need} bytes, past the "
            f"{MAX_WALK_SMEM_BYTES} of a block's shared memory")
    return part


def cluster_reorder(scene: Scene, uuid: torch.Tensor) -> Scene:
    """``scene`` gathered into a prebuilt partition's slot layout (``uuid``
    maps slot → original index, -1 for padding; on the scene's device):
    the progressive step's static-cluster hint, built once from a
    concrete scene and applied to every frame's scene. Padding slots are
    filled as :func:`~raytracer_tpu_torch.scene.accel.build_grid_clustered`
    fills them: inactive, radius and refraction index 1."""
    uuid = uuid.to(torch.int64)
    live = uuid >= 0
    safe = torch.clamp_min(uuid, 0)

    def take(a, fill):
        g = a[safe]
        mask = live[:, None] if g.ndim == 2 else live
        return torch.where(mask, g, torch.full_like(g, fill))

    fields = dict(
        center=take(scene.center, 0.0),
        radius=take(scene.radius, 1.0),
        material_type=take(scene.material_type, 0),
        albedo=take(scene.albedo, 0.0),
        fuzz=take(scene.fuzz, 0.0),
        refraction_index=take(scene.refraction_index, 1.0),
        active=live.to(torch.float32),
    )
    if is_motion(scene):
        return MotionScene(**fields, center1=take(scene.center1, 0.0),
                           albedo_odd=take(scene.albedo_odd, 0.0))
    return Scene(**fields)


@dataclasses.dataclass(frozen=True)
class WalkTables:
    """Everything the cluster walk reads besides the lane→pixel map: the
    tables the plain version reads, and ``packed``, the same tables (with
    ``parents``) as the kernel's shared memory holds them. Built by
    :func:`walk_tables` (and moved by :meth:`to`) as views of one buffer,
    ``packed`` first."""

    camera: torch.Tensor  # (19,) origin, llc, horizontal, vertical, u, v, lens
    globals: torch.Tensor  # (n_global, 4) [cx, cy, cz, k1]; motion: 8
    bounds: torch.Tensor  # (K, 6) member AABBs [lo xyz, hi xyz]
    members: torch.Tensor  # (K, group, 4) [cx, cy, cz, k1]; motion: 8
    # (slots, 11) [c xyz, 1/r, mat, albedo, fuzz, ior, uuid]; motion: 17
    winner: torch.Tensor
    parents: torch.Tensor  # (n_boxes, 6), see hierarchy_boxes
    packed: torch.Tensor  # (walk_layout(...).n_floats,), see pack_walk

    @property
    def motion(self) -> bool:
        """Whether these are the motion walk's tables
        (:func:`motion_tables`)."""
        return self.members.shape[2] == MOTION_SPHERE_FLOATS

    def to(self, device) -> "WalkTables":
        """The tables on ``device``, in one copy."""
        tabs = {name: getattr(self, name) for name in _WALK_ORDER}
        device = torch.device(device)
        if all(t.device.type == device.type
               and device.index in (None, t.device.index)
               for t in tabs.values()):
            return self
        flat = torch.cat([t.reshape(-1) for t in tabs.values()])
        return WalkTables(**_views(upload(flat, device), {
            name: tuple(t.shape) for name, t in tabs.items()}))


#: the walk tables' order in their one buffer: ``packed`` at its start,
#: so the kernel's 16-byte rows stay aligned
_WALK_ORDER = ("packed", "camera", "globals", "bounds", "members", "winner",
               "parents")


def _views(buf, shapes: dict) -> dict:
    """Name → the view of ``buf`` (a 1-D numpy array or tensor) that holds
    that table, the tables one after another in the order of
    ``shapes``."""
    views, at = {}, 0
    for name, shape in shapes.items():
        strides = [1]
        for d in shape[:0:-1]:
            strides.insert(0, strides[0] * d)
        n = strides[0] * shape[0]
        if isinstance(buf, torch.Tensor):
            # one PyTorch call a view: the tables are rebuilt every frame
            views[name] = buf.as_strided(shape, strides, at)
        else:
            views[name] = buf[at:at + n].reshape(shape)
        at += n
    return views


@dataclasses.dataclass(frozen=True)
class FlatTables:
    """Everything the flat scan reads besides the lane→pixel map."""

    camera: torch.Tensor  # (19,) origin, llc, horizontal, vertical, u, v, lens
    spheres: torch.Tensor  # (S, 12), see :func:`sphere_table`

    def to(self, device) -> "FlatTables":
        return FlatTables(camera=upload(self.camera, device),
                          spheres=upload(self.spheres, device))


def camera_uniforms(dcam: DerivedCamera) -> torch.Tensor:
    return torch.cat([
        dcam.origin, dcam.lower_left_corner, dcam.horizontal, dcam.vertical,
        dcam.u, dcam.v, dcam.lens_radius.reshape(1),
    ]).to(torch.float32)


def debug_uniforms(debug: DebugParams) -> tuple:
    """The overlay's four uniforms (the TPU kernel's camera slots 19-22):
    cursor xyz and float32(selected_object), as Python floats that the
    kernels take by value. The selection compares as float32 with the
    winner's uuid, exact below 2^24."""
    return (*debug.cursor_point, float(np.float32(debug.selected_object)))


def flat_tables(scene: Scene, dcam: DerivedCamera, device) -> FlatTables:
    """The scene's and the camera's flat-scan tables, on ``device``. The
    span ``tables``."""
    with span("tables"):
        return FlatTables(camera=camera_uniforms(dcam),
                          spheres=sphere_table(scene)).to(device)


def cluster_tables(scene: Scene, boxes, uuid, n_global: int,
                   group: int) -> tuple:
    """(globals, bounds, members, winner) of a partition's reordered
    scene, bit for bit the entries of the JAX package's tables."""
    k = boxes.shape[0]
    _, c, k1 = slot_encoding(scene)
    mem = torch.cat([c, k1[:, None]], dim=1)
    winner = torch.stack(
        [c[:, 0], c[:, 1], c[:, 2], *_winner_params(scene),
         torch.as_tensor(uuid).to(c.device, torch.float32)],
        dim=1,
    )
    return (
        mem[:n_global].contiguous(),
        torch.as_tensor(np.asarray(boxes, np.float32)).reshape(k, 6),
        mem[n_global:].reshape(k, group, 4).contiguous(),
        winner.contiguous(),
    )


def motion_tables(scene: MotionScene, boxes, uuid, n_global: int,
                  group: int) -> tuple:
    """(globals, bounds, members, winner) of the motion walk, from a
    partition's reordered :class:`MotionScene`: the rows of
    :func:`motion_encoding`, and a winner row that extends
    :func:`cluster_tables`' by the motion and the odd colour."""
    k = boxes.shape[0]
    _, c0, mv, r2 = motion_encoding(scene)
    mem = torch.cat([c0, r2[:, None], mv, torch.zeros_like(r2)[:, None]],
                    dim=1)
    winner = torch.cat([
        torch.stack([c0[:, 0], c0[:, 1], c0[:, 2], *_winner_params(scene),
                     torch.as_tensor(uuid).to(c0.device, torch.float32)],
                    dim=1),
        mv, scene.albedo_odd], dim=1)
    return (
        mem[:n_global].contiguous(),
        torch.as_tensor(np.asarray(boxes, np.float32)).reshape(k, 6),
        mem[n_global:].reshape(k, group, MOTION_SPHERE_FLOATS).contiguous(),
        winner.to(torch.float32).contiguous(),
    )


def parent_boxes(bounds: np.ndarray) -> np.ndarray:
    """(ceil(K / PARENT_FANOUT), 6) float32 from the (K, 6) float32 kd
    leaves: each run of PARENT_FANOUT consecutive leaves (the last run
    may be shorter) under one box, the min of their lows and the max of
    their highs, exact."""
    k = bounds.shape[0]
    n_par = -(-k // PARENT_FANOUT)
    # repeat the last leaf into the short run: it changes no min or max
    runs = np.concatenate(
        [bounds, np.repeat(bounds[-1:], n_par * PARENT_FANOUT - k, 0)]
    ).reshape(n_par, PARENT_FANOUT, 6)
    return np.concatenate([runs[..., :3].min(1), runs[..., 3:].max(1)], 1)


def hierarchy_boxes(bounds: np.ndarray) -> np.ndarray:
    """The boxes over a partition's (K, 6) kd leaves that the walk's
    culled box test reads: the parents (:func:`parent_boxes`), and for a
    wide partition (:func:`is_wide`) after them each level over the one
    below (a box over each run of PARENT_FANOUT), up to the root: the
    grandparents, then (:func:`upper_levels`) the levels the wide walk
    reads from global memory. The span ``hierarchy`` times the levels
    past the parents."""
    parents = parent_boxes(bounds)
    if not is_wide(bounds.shape[0]):
        return parents
    with span("hierarchy"):
        levels = [parents]
        while levels[-1].shape[0] > 1:
            levels.append(parent_boxes(levels[-1]))
        return np.concatenate(levels)


def upper_levels(k: int) -> list:
    """Box counts of the wide walk's levels past the grandparents of a
    partition of ``k`` clusters, up to the root (one box), lowest first;
    [] for a narrow partition."""
    if not is_wide(k):
        return []
    n = [-(-k // PARENT_FANOUT)]
    while n[-1] > 1:
        n.append(-(-n[-1] // PARENT_FANOUT))
    return n[2:]


def member_stride(group: int) -> int:
    """float4 rows from one cluster's members to the next in the packed
    tables: ``group`` made odd, so the same member of clusters a warp
    visits at once lies in different shared-memory banks."""
    return group | 1


@dataclasses.dataclass(frozen=True)
class WalkLayout:
    """Offsets (in floats, each a multiple of 4) of the packed walk
    tables: camera at 0, then globals, parent boxes (and a wide
    partition's grandparents after them), boxes, members (a cluster every
    ``mstride`` float4 rows) and winner rows; in the wide walk then its
    levels past the grandparents up to the root (``n_top`` boxes at
    ``off_top``, lowest level first), which it reads from global
    memory. The motion walk's (``motion``) has rows of two float4 for a
    global or a member and of 17 floats for a winner."""

    n_parents: int
    n_grand: int  # grandparent boxes: 0 but in the wide walk
    k: int
    mstride: int
    off_glob: int
    off_par: int
    off_box: int
    off_mem: int
    off_win: int
    n_floats: int
    n_top: int = 0  # boxes past the grandparents: 0 but in the wide walk
    off_top: int = 0


def walk_layout(n_global: int, k: int, group: int,
                motion: bool = False) -> WalkLayout:
    sphere = MOTION_SPHERE_FLOATS if motion else SPHERE_FLOATS
    n_par = -(-k // PARENT_FANOUT)
    n_grand = -(-n_par // PARENT_FANOUT) if is_wide(k) else 0
    mstride = member_stride(group * sphere // 4)
    off_glob = CAMERA_FLOATS
    off_par = off_glob + sphere * n_global
    off_box = off_par + BOX_FLOATS * (n_par + n_grand)
    off_mem = off_box + BOX_FLOATS * k
    off_win = off_mem + 4 * k * mstride
    win = MOTION_WINNER_FLOATS if motion else WINNER_FLOATS
    end = -(-(off_win + win * (n_global + k * group)) // 4) * 4
    n_top = sum(upper_levels(k))
    return WalkLayout(n_par, n_grand, k, mstride, off_glob, off_par,
                      off_box, off_mem, off_win, end + BOX_FLOATS * n_top,
                      n_top, end if n_top else 0)


def pack_walk(out, camera, globals_, parents, bounds, members, winner):
    """Writes the walk's tables into ``out``, laid out as
    :func:`walk_layout` says: a zeroed (n_floats,) float32 numpy array or
    tensor, with the tables of the same kind (and device). Returns
    ``out``."""
    k, group, floats = members.shape
    lay = walk_layout(globals_.shape[0], k, group,
                      floats == MOTION_SPHERE_FLOATS)
    out[:19] = camera
    out[lay.off_glob:lay.off_par] = globals_.reshape(-1)
    n_low = lay.n_parents + lay.n_grand
    for off, n, boxes in ((lay.off_par, n_low, parents[:n_low]),
                          (lay.off_box, k, bounds),
                          (lay.off_top, lay.n_top, parents[n_low:])):
        rows = out[off:off + BOX_FLOATS * n].reshape(n, BOX_FLOATS)
        rows[:, :3] = boxes[:, :3]
        rows[:, 4:7] = boxes[:, 3:]
    rows = group * floats // 4
    out[lay.off_mem:lay.off_win].reshape(k, lay.mstride, 4)[:, :rows] = \
        members.reshape(k, rows, 4)
    out[lay.off_win:lay.off_win + winner.shape[0] * winner.shape[1]] = \
        winner.reshape(-1)
    return out


def walk_tables(part: ClusteredScene, dcam: DerivedCamera,
                device) -> WalkTables:
    """The partition's and the camera's tables on ``device``: built where
    the scene lives (the boxes and their hierarchy on the host), written
    with the packed array into one buffer there, and uploaded in one
    copy; every table is a view of it. A scene on the host is packed in
    numpy, without a PyTorch call. A :class:`MotionScene`'s are the
    motion walk's (:func:`motion_tables`). The span ``tables``."""
    with span("tables"):
        motion = is_motion(part.scene)
        globals_, bounds, members, winner = (
            motion_tables if motion else cluster_tables)(
            part.scene, part.boxes, part.uuid, part.n_global, part.group
        )
        n_global, (k, group) = globals_.shape[0], members.shape[:2]
        bounds = bounds.numpy()
        tabs = {"camera": camera_uniforms(dcam), "globals": globals_,
                "bounds": bounds, "members": members, "winner": winner,
                "parents": hierarchy_boxes(bounds)}
        shapes = {"packed": (walk_layout(n_global, k, group,
                                         motion).n_floats,),
                  **{name: tuple(t.shape) for name, t in tabs.items()}}
        total = sum(math.prod(shape) for shape in shapes.values())
        at = members.device
        if all(t.device.type == "cpu" for t in (tabs["camera"], globals_,
                                                 members, winner)):
            tabs = {name: np.asarray(t) for name, t in tabs.items()}
            buf = np.zeros(total, np.float32)
        else:
            tabs = {name: torch.as_tensor(t).to(at)
                    for name, t in tabs.items()}
            buf = torch.zeros(total, dtype=torch.float32, device=at)
        views = _views(buf, shapes)
        pack_walk(views.pop("packed"), tabs["camera"], tabs["globals"],
                  tabs["parents"], tabs["bounds"], tabs["members"],
                  tabs["winner"])
        for name, view in views.items():
            view[...] = tabs[name]
        flat = torch.from_numpy(buf) if isinstance(buf, np.ndarray) else buf
        return WalkTables(**_views(upload(flat, device), shapes))
