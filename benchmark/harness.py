"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the plain reference, and the result.

Everything that belongs to a cell is found by name: the cell's entry in
BENCHMARK.json names its configuration and traffic; the configuration's
file (`configs/`), the traffic mix (`traffic/<traffic>.json`), the cell's
check sizes and limits (`workloads/<cell>.json`), and one reader a metric
(`metrics/<metric>.py`, `read(run) -> value or None`). The traffic's
`entry` chooses the driver: `render_image` (offline renders back to back)
or `engine` (the viewer's frame loop under a scripted mouse).

The program is `raytracer_tpu_torch`, passed in as `port`; nothing here
imports it, so the reference and the tests can load this module without
it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np

from benchmark import reference, schedule, scenes
from benchmark.trace import Spans, SubWindow

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
M32 = 0xFFFFFFFF
#: key index of the warm-up renders, apart from the window's 0, 1, ...
WARM_KEYS = (0xFFFFFFF0, 0xFFFFFFF1)
#: a checked pixel whose largest channel gap passes this differs from the
#: reference: far above float32 rounding of a sum over its samples (1e-6),
#: below what one sample taking another path moves (about 1/spp)
MISMATCH_GAP = 1e-4


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_spec(pending: bool = False) -> dict:
    """BENCHMARK.json; with `pending`, also the cells of
    `benchmark/pending.json`: cells whose harness is built and checked but
    which BENCHMARK.json does not list yet (PERF.md says why)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if pending:
        more = json.loads((BENCH_DIR / "pending.json").read_text())
        for key, entries in more.items():
            spec[key] = spec.get(key, []) + entries
    return spec


def load_cell(name: str, pending: bool = False) -> Cell:
    """The cell `name` of BENCHMARK.json (with `pending`, or of
    pending.json) with its files; raises KeyError for a cell it does not
    name."""
    spec = load_spec(pending)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    cell_file = json.loads((BENCH_DIR / "workloads" / f"{name}.json")
                           .read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", cells)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=json.loads((ROOT / cfg["file"]).read_text()),
                traffic=json.loads((BENCH_DIR / "traffic"
                                    / f"{w['traffic']}.json").read_text()),
                check=cell_file["check"], limits=cell_file["limits"],
                end_to_end=e2e, per_layer=per_layer)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name + "_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """`read(run)` of `benchmark/metrics/<metric>.py`."""
    return _load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                        "bench_metric").read


def session_class(entry: str):
    """The driver of a traffic's `entry`: one of SESSIONS, or else the
    `Session` of `benchmark/sessions/<entry>.py`, so that a cell with
    another driver (such as one over several cards) comes as a file of
    its own. A driver takes (port, cell, device, overrides) and has
    warm(seed), window(run, sync, counters), check(run, device,
    control=False) and release()."""
    if entry in SESSIONS:
        return SESSIONS[entry]
    return _load_module(BENCH_DIR / "sessions" / f"{entry}.py",
                        "bench_session").Session


def render_key(seed: int, i: int) -> np.ndarray:
    """Key data of render or session i of a run with `seed`."""
    return np.array([(seed ^ (seed >> 32)) & M32, i & M32], np.uint32)


def basis_of(camera: dict, aspect: float) -> dict:
    """The viewport basis of a configuration's camera at `aspect`."""
    if camera["kind"] == "lookat":
        return reference.camera_basis(
            camera["lookfrom"], camera["lookat"], camera["vfov_deg"],
            camera["aperture"], camera["focus_dist"], aspect,
            camera.get("vup", (0.0, 1.0, 0.0)))
    return reference.viewer_basis(
        camera["origin"], camera["yaw_deg"], camera["pitch_deg"],
        camera["fov_rad"], camera["aperture"], camera["focus_distance"],
        aspect)


class Reservoir:
    """A uniform sample of k of the items offered, drawn from `rng`,
    without knowing their number in advance."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


class Run:
    """What one run measured and kept, for the readers and the check."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool):
        self.cell, self.seed, self.seconds, self.trace = (cell, seed,
                                                          seconds, trace)
        self.setup_s = None
        self.window_s = None
        self.units = []        # per render: dict, or per frame: end event
        self.frame_ms = []     # viewer: completion intervals
        self.launches = {}
        self.spans = Spans(trace)
        self.sub = None        # reduced trace of the sub-window
        self.sub_units = []    # the renders (or frames) it covers
        self.kept = []
        self.attempted = 0
        self.extra = {}

    @property
    def traffic(self):
        return self.cell.traffic


def _opts(port, cfg: dict, traffic: dict):
    phys = cfg["physics"]
    return port.TraceOptions(
        max_depth=int(cfg["max_depth"]),
        exhaust_black=bool(phys["exhaust_black"]),
        near_zero_guard=bool(phys["near_zero_guard"]),
        russian_roulette_depth=int(phys["russian_roulette_depth"]),
        sampler=traffic.get("sampler", "random"),
        adaptive_tolerance=float(traffic.get("adaptive_tolerance", 0.0)))


def size_of(cell: Cell, overrides: dict | None = None):
    """(width, height, spp, max_depth) of the cell; `overrides` (tests
    only) replaces any of them."""
    cfg, tr = cell.config, cell.traffic
    size = {"width": int(cfg["image_width"]),
            "height": int(cfg["image_height"]),
            "spp": int(tr.get("samples_per_pixel",
                              cfg["samples_per_pixel"])),
            "max_depth": int(cfg["max_depth"])}
    size.update(overrides or {})
    return size


class OfflineSession:
    """Back-to-back `render_image` calls, each ending in its synchronize:
    the user who saves finished images."""

    def __init__(self, port, cell: Cell, device, overrides=None):
        self.port, self.cell, self.device = port, cell, device
        self.size = size_of(cell, overrides)
        cfg = dict(cell.config, max_depth=self.size["max_depth"])
        w, h = self.size["width"], self.size["height"]
        self.arrays = scenes.scene_arrays(cfg["scene"])
        self.basis = basis_of(cfg["camera"], w / h)
        self.scene = port.scene_from_numpy(**self.arrays, device=device)
        self.camera = port.camera_from_numpy(self.basis)
        self.opts = _opts(port, cfg, cell.traffic)
        self.adaptive = self.opts.adaptive_tolerance > 0.0

    def render(self, key):
        s = self.size
        return self.port.render_image(
            self.scene, self.camera, s["width"], s["height"], s["spp"], key,
            self.opts, None, True, device=self.device)

    def warm(self, seed: int) -> None:
        for i in WARM_KEYS:
            self.render(render_key(seed, i))

    def window(self, run: Run, sync, counters) -> None:
        """Renders back to back for `run.seconds`. A traced run profiles
        its first renders, then measures its window as an untraced one
        does, with the spans collected."""
        s = self.size
        n_pix = s["width"] * s["height"]
        rng = np.random.default_rng([run.seed & M32, run.seed >> 32, 1])
        keep = Reservoir(int(run.cell.check["renders"]), rng)
        sub = SubWindow(first=2, active=int(run.traffic.get(
            "traced_renders", 5))) if run.trace else None
        measuring = sub is None
        counters.reset()
        t0 = time.perf_counter()
        i = 0
        while True:
            with run.spans("render_image"):
                img, st = self.render(render_key(run.seed, i))
            t = time.perf_counter()
            samples = (int(round(st["mean_spp"] * n_pix)) if self.adaptive
                       else n_pix * s["spp"])
            unit = {"index": i, "t": t - t0,
                    "segments": int(st["segments_exact"]),
                    "samples": samples}
            keep.offer((i, img, st))
            i += 1
            if measuring:
                run.units.append(unit)
                if t - t0 >= run.seconds:
                    break
                continue
            if sub.steps >= 2:
                run.sub_units.append(unit)
            sub.step()
            if sub.done:
                measuring = True
                run.spans.collect = True
                counters.reset()
                t0 = time.perf_counter()
        run.window_s = t - t0
        run.launches = counters.read()
        if sub is not None:
            sub.close()
            run.sub = sub.result
        run.kept = keep.items
        run.attempted = i
        run.extra = {"renders": len(run.units), "width": s["width"],
                     "height": s["height"],
                     "n_spheres": int(self.arrays["center"].shape[0])}

    def release(self) -> None:
        del self.scene, self.camera

    def check(self, run: Run, device, control=False) -> dict:
        """The comparison numbers of the kept renders: for each, a sample
        of pixels drawn from the seed is rendered again by the reference.
        With `control`, the reference computed in bfloat16 stands in the
        program's place. Returns {number: value}."""
        import torch

        s = self.size
        w, h = s["width"], s["height"]
        rng = np.random.default_rng([run.seed & M32, run.seed >> 32, 2])
        n_sph = self.arrays["center"].shape[0]
        cam = reference.cam19(self.basis)
        out = {"pixel_mismatch": 0.0, "pixel_gap": 0.0, "segment_gap": 0.0}
        if self.adaptive:
            out["spp_mismatch"] = 0.0
        for i, img, st in sorted(run.kept, key=lambda k: k[0]):
            flat = rng.choice(w * h, size=min(w * h, int(
                run.cell.check["pixels"])), replace=False)
            pix = np.stack([flat % w, flat // w], 1)
            seed = reference.kernel_seed(render_key(run.seed, i))
            got = self._reference(seed, pix, cam, n_sph, device,
                                  torch.float32)
            if control:
                prog = self._reference(seed, pix, cam, n_sph, device,
                                       torch.bfloat16)
                prog_img, prog_n = prog[0], prog[2]
                prog_total = float(prog[1].sum()) * (w * h) / len(flat)
            else:
                yy = torch.as_tensor(pix[:, 1], device=img.device)
                xx = torch.as_tensor(pix[:, 0], device=img.device)
                prog_img = img[yy, xx].float().cpu()
                prog_n = (st["spp_map"][yy, xx].float().cpu()
                          if self.adaptive else None)
                prog_total = float(st["segments_exact"])
            ref_img, ref_segs, ref_n = got
            per_px = (prog_img.cpu().float() - ref_img.cpu()).abs().amax(1)
            gap = per_px.max().item()
            out["pixel_mismatch"] = _worse(out["pixel_mismatch"], float(
                (~(per_px <= MISMATCH_GAP)).float().mean()))
            est = float(ref_segs.sum()) * (w * h) / len(flat)
            out["pixel_gap"] = _worse(out["pixel_gap"], gap)
            out["segment_gap"] = _worse(out["segment_gap"],
                                        abs(prog_total / est - 1.0))
            if self.adaptive:
                mism = float((prog_n.cpu() != ref_n.cpu()).float().mean())
                out["spp_mismatch"] = _worse(out["spp_mismatch"], mism)
        out["renders_checked"] = len(run.kept)
        return out

    def _reference(self, seed, pix, cam, n_sph, device, dtype):
        s = self.size
        w, h = s["width"], s["height"]
        if self.adaptive:
            sizes = schedule.adaptive_sizes(s["spp"], w * h, n_sph,
                                            s["max_depth"])
            img, n, segs = reference.adaptive_pixels(
                self.arrays, cam, w, h, seed, pix, s["max_depth"], sizes,
                self.opts.adaptive_tolerance, self.opts.sampler, dtype,
                device)
            return img, segs, n
        sizes = schedule.fixed_sizes(s["spp"], w * h, n_sph, s["max_depth"])
        img, segs = reference.fixed_pixels(
            self.arrays, cam, w, h, seed, pix, s["spp"], s["max_depth"],
            sizes, self.opts.sampler, dtype, device)
        return img, segs, None


class _HostMark:
    """A host-clock stand-in for a timing CUDA event, on a CPU device."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _marker(device):
    """A timing event on `device`: a CUDA event on a card, recorded on
    the stream behind the frame's work and read once after the window."""
    import torch

    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostMark()


def _worse(a: float, b: float) -> float:
    """The larger, NaN winning: a NaN must fail its limit."""
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return max(a, b)


#: the reference viewer's own settings (src/state.rs), where a
#: configuration does not state them
VIEWER_DEFAULTS = {"last_frame_weight": 1.0, "max_render_count": 100000,
                   "look_sensitivity": 0.1}


def viewer_camera(camera: dict) -> dict:
    """A configuration's camera as the viewer's yaw/pitch camera: as it
    is, or a look-at camera turned to its view direction (the viewer's up
    is +y, so a look-at camera with another up has no viewer camera)."""
    if camera["kind"] == "yaw_pitch":
        return camera
    if [float(v) for v in camera.get("vup", (0.0, 1.0, 0.0))] != [0.0, 1.0,
                                                                  0.0]:
        raise ValueError("the viewer's camera has +y up; this look-at "
                         "camera has another")
    front = (np.asarray(camera["lookat"], np.float64)
             - np.asarray(camera["lookfrom"], np.float64))
    front /= np.linalg.norm(front)
    return {"kind": "yaw_pitch", "origin": camera["lookfrom"],
            "yaw_deg": math.degrees(math.atan2(front[2], front[0])),
            "pitch_deg": math.degrees(math.asin(front[1])),
            "fov_rad": math.radians(camera["vfov_deg"]),
            "aperture": camera["aperture"],
            "focus_distance": camera["focus_dist"]}


class ViewerSession:
    """The viewer: `Engine.tick` back to back in a closed loop, never
    waiting on the device; the scripted mouse moves before some frames,
    each restarting the average and picking with its one sync. The
    window ends at the end of a cycle of the script, after its still
    frames, so the check always covers a whole still stretch."""

    def __init__(self, port, cell: Cell, device, overrides=None):
        self.port, self.cell, self.device = port, cell, device
        self.size = size_of(cell, overrides)
        cfg = cell.config
        self.viewer = {k: cfg.get(k, v) for k, v in VIEWER_DEFAULTS.items()}
        self.arrays = scenes.scene_arrays(cfg["scene"])
        self.scene = port.scene_from_numpy(**self.arrays, device=device)
        cam = viewer_camera(cfg["camera"])
        if float(cam["aperture"]) > 0.0:
            # a pick refocuses an open lens, which the replay does not do
            raise ValueError("the reference replays a pinhole viewer only")
        w, h = self.size["width"], self.size["height"]
        self.cam_fields = {
            "origin": np.asarray(cam["origin"], np.float32),
            "yaw": np.float32(cam["yaw_deg"]),
            "pitch": np.float32(cam["pitch_deg"]),
            "fov": np.float32(cam["fov_rad"]),
            "aperture": np.float32(cam["aperture"]),
            "focus_distance": np.float32(cam["focus_distance"]),
            "aspect_ratio": np.float32(w / h),
        }
        self.engine = None

    def _engine(self, seed: int):
        cfg, s = self.cell.config, self.size
        eng = self.port.Engine(
            self.scene, self.port.camera_from_numpy(self.cam_fields),
            s["width"], s["height"], spp=int(cfg["samples_per_pixel"]),
            max_depth=s["max_depth"], seed=seed & M32, device=self.device)
        eng.app.last_frame_weight = float(self.viewer["last_frame_weight"])
        eng.app.max_render_count = int(self.viewer["max_render_count"])
        eng.app.look_sensitivity = float(self.viewer["look_sensitivity"])
        eng.set_paused(False)
        return eng

    def script(self, seed: int, stream: int, cycles: int):
        """Mouse moves of `cycles` cycles: per cycle, `moving_frames`
        moves, half drawn uniformly in [-move_px, move_px]^2 less (0, 0)
        and half their negations, in an order drawn from the seed; None
        for each still frame. A cycle's moves sum to zero, so the camera
        wanders no further from run to run."""
        tr = self.cell.traffic
        n_move, n_cycle, px = (int(tr["moving_frames"]),
                               int(tr["cycle_frames"]), int(tr["move_px"]))
        rng = np.random.default_rng([seed & M32, seed >> 32, stream])
        out = []
        for _ in range(cycles):
            half = rng.integers(-px, px + 1, size=(n_move // 2, 2))
            # a move of (0, 0) leaves the camera, and the average, as it is
            while True:
                still = ~half.any(axis=1)
                if not still.any():
                    break
                half[still] = rng.integers(-px, px + 1,
                                           size=(int(still.sum()), 2))
            moves = np.concatenate([half, -half])[rng.permutation(n_move)]
            out.extend((int(dx), int(dy)) for dx, dy in moves)
            out.extend([None] * (n_cycle - n_move))
        return out

    def warm(self, seed: int) -> None:
        eng = self._engine(seed)
        for mv in self.script(seed, 3, 1):
            if mv is not None:
                eng.handle_mouse_move(*mv)
            eng.tick()
        self.engine = self._engine(seed)

    def window(self, run: Run, sync, counters) -> None:
        """Ticks back to back for `run.seconds`, then to the end of the
        script's cycle, never waiting on the device but in the moves'
        picks. A traced run profiles its first frames, then measures its
        window as an untraced one does, with the spans collected."""
        eng = self.engine or self._engine(run.seed)
        self.engine = None
        tr = self.cell.traffic
        n_cycle = int(tr["cycle_frames"])
        traced = int(tr.get("traced_frames", 160)) if run.trace else 0
        # enough script for the longest window at 2000 frames a second
        cycles = int((run.seconds * 2000 + traced + 2) // n_cycle) + 2
        moves = self.script(run.seed, 4, cycles)
        events = [_marker(self.device)]
        sub = SubWindow(first=2, active=traced) if run.trace else None
        picks = []   # (move index, point, selected)
        applied = []
        last_restart = None   # (moves applied, frames rendered before)
        n = n0 = frames = 0

        def start():
            counters.reset()
            sync()
            events[-1].record()
            return time.perf_counter()

        t0 = start() if sub is None else None
        while True:
            mv = moves[n]
            if mv is not None:
                with run.spans("handle_mouse_move"):
                    eng.handle_mouse_move(*mv)
                applied.append(mv)
                picks.append((len(applied) - 1,
                              tuple(eng.app.cursor_point),
                              int(eng.app.selected_object)))
                last_restart = (len(applied), frames)
            with run.spans("tick"):
                frames += bool(eng.tick())
            n += 1
            events.append(_marker(self.device))
            events[-1].record()
            if t0 is None:
                if sub.steps >= 2:
                    run.sub_units.append(n)
                sub.step()
                if sub.done:
                    n0 = n
                    run.spans.collect = True
                    t0 = start()
            elif n % n_cycle == 0 and (time.perf_counter() - t0
                                       >= run.seconds or n == len(moves)):
                break
        sync()
        run.window_s = time.perf_counter() - t0
        run.launches = counters.read()
        if sub is not None:
            sub.close()
            run.sub = sub.result
        run.frame_ms = [events[j].elapsed_time(events[j + 1])
                        for j in range(n0, n)]
        run.units = list(range(n0, n))
        run.attempted = n
        run.kept = {"engine": eng, "picks": picks, "moves": applied,
                    "restart": last_restart, "frame_end": frames}
        run.extra = {"frames": len(run.units), "moves": len(applied)}

    def release(self) -> None:
        self.engine = None

    def check(self, run: Run, device, control=False) -> dict:
        """The framebuffer after the window's last restart, at a sample of
        pixels, and a sample of the picks, against the reference replaying
        the same mouse moves from the session's key, which it works out
        from the seed. With `control` the reference in bfloat16 stands in
        the program's place."""
        import torch

        kept, s = run.kept, self.size
        w, h = s["width"], s["height"]
        rng = np.random.default_rng([run.seed & M32, run.seed >> 32, 5])
        cam = self.cam_fields
        scale = np.float32(np.float32(self.viewer["look_sensitivity"])
                           * cam["fov"])
        yaw, pitch = [cam["yaw"]], [cam["pitch"]]
        for dx, dy in kept["moves"]:
            yaw.append(np.float32(yaw[-1] + np.float32(np.float32(dx)
                                                       * scale)))
            pitch.append(np.float32(np.clip(
                np.float32(pitch[-1] - np.float32(np.float32(dy) * scale)),
                np.float32(-89.0), np.float32(89.0))))

        def basis(k):
            return reference.viewer_basis_f32(
                cam["origin"], yaw[k], pitch[k], cam["fov"],
                cam["aperture"], cam["focus_distance"], cam["aspect_ratio"])

        out = {"frame_mismatch": 0.0, "frame_gap": 0.0, "pick_gap": 0.0}
        # the picks
        n_pick = min(len(kept["picks"]), int(run.cell.check["picks"]))
        for j in sorted(rng.choice(len(kept["picks"]), n_pick,
                                   replace=False)):
            k, point, sel = kept["picks"][j]
            ref_point, ref_sel = reference.pick(self.arrays, basis(k + 1))
            if control:
                point, sel = reference.pick(self.arrays, basis(k + 1),
                                            torch.bfloat16)
            # another sphere picked is as wrong as it gets
            gap = (float(np.abs(np.asarray(point, np.float64)
                                - ref_point).max())
                   if sel == ref_sel else math.inf)
            out["pick_gap"] = _worse(out["pick_gap"], gap)
        # the framebuffer: frames since the last restart, blended
        n_moves, f0 = kept["restart"] if kept["restart"] else (0, 0)
        cam_b = reference.cam19(basis(n_moves))
        flat = rng.choice(w * h, size=min(w * h, int(run.cell.check[
            "pixels"])), replace=False)
        pix = np.stack([flat % w, flat // w], 1)
        weight = float(self.viewer["last_frame_weight"])
        cap = int(self.viewer["max_render_count"])
        key = reference.prng_key(run.seed & M32)

        def frames(dtype):
            acc = None
            for rc, f in enumerate(range(f0, kept["frame_end"]), start=1):
                img, _ = reference.fixed_pixels(
                    self.arrays, cam_b, w, h,
                    reference.kernel_seed(reference.threefry_fold_in(key, f)),
                    pix, 1, s["max_depth"], [1], "random", dtype, device)
                img = img.float()
                acc = (img if acc is None
                       else reference.blend(acc, img, min(rc, cap), weight))
            return acc

        ref = frames(torch.float32)
        if control:
            got = frames(torch.bfloat16)
        else:
            accum = kept["engine"].render_state.accum
            yy = torch.as_tensor(pix[:, 1], device=accum.device)
            xx = torch.as_tensor(pix[:, 0], device=accum.device)
            got = accum[yy, xx].float()
        per_px = (got.cpu() - ref.cpu()).abs().amax(1)
        out["frame_gap"] = per_px.max().item()
        out["frame_mismatch"] = float((~(per_px <= MISMATCH_GAP)).float()
                                      .mean())
        out["frames_checked"] = kept["frame_end"] - f0
        out["picks_checked"] = n_pick
        return out


SESSIONS = {"render_image": OfflineSession, "engine": ViewerSession}


def check_against(values: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit]]): every number with a limit must
    be within it; a NaN never is."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = values.get(name, math.nan)
        good = v <= limit
        ok = ok and bool(good)
        rows.append([name, v, limit])
    return ok, rows
