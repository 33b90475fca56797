"""The interactive engine: a headless frame loop (counterpart of
``raytracer_tpu/app/engine.py``, the rebuild of the reference's
requestAnimationFrame closure).

    tick(now):
      fly-cam             controller.update_position over the frame's dt
      picking             interact/picking.py, on every camera change
      should-render gate  AppState.compute_should_render
      resize debounce     AppState.resize_due / apply_resize
      frame               the progressive step, through the kernels (or
                          the jnp tracer, ``backend='jnp'``), with the
                          debug overlay when it is on
      save                PNG of the framebuffer, when one was requested

Input handlers change host state; the next tick consumes it. A frame
waits for the device nowhere: the step takes host counters, key data and
overlay uniforms, and the running segment total is drained to the host
without waiting. A camera change waits once, to read the pick. The device
is CUDA unless the caller names the CPU.

A device fault in a frame's step is sorted by ``utils/resilience.py``. A
recoverable one (an allocation that failed) is absorbed: the step cache
and the device's running segment total are dropped (the host's drained
total stays), the session's state is rebuilt from its seed, and the tick
returns False; the next tick renders again, through the same kernels. A
sticky one (an illegal address, a failed launch) raises
``DeviceContextLost``: the process must be restarted.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from raytracer_tpu_torch.app import io
from raytracer_tpu_torch.camera import controller
from raytracer_tpu_torch.camera.camera import CameraConfig
from raytracer_tpu_torch.interact.appstate import AppState, cameras_equal
from raytracer_tpu_torch.interact.picking import update_cursor_state
from raytracer_tpu_torch.progressive.state import (
    RenderState,
    init_render_state,
    reset_accumulation,
)
from raytracer_tpu_torch.progressive.step import make_step_fn
from raytracer_tpu_torch.render.api import resolve_device
from raytracer_tpu_torch.render.options import (
    DebugParams,
    TraceOptions,
    check_backend,
)
from raytracer_tpu_torch.scene.spheres import (
    NO_SELECTED_OBJECT_ID,
    Scene,
    is_motion,
)
from raytracer_tpu_torch.utils.resilience import (
    free_cached_memory,
    is_device_fault,
    raise_if_sticky,
    retry_on_device_fault,
)

log = logging.getLogger(__name__)


def _f32(v) -> torch.Tensor:
    return torch.tensor(np.float32(v))


class Engine:
    """Holds the session's scene, camera, running average and host
    :class:`AppState`, and advances one frame per :meth:`tick`."""

    #: frames between drains of the device segment total to the host
    _SEG_FOLD_FRAMES = 64
    #: step functions kept, least recently used dropped first: pause and
    #: unpause (the spp floor), a debug toggle and a few window sizes
    _STEP_CACHE_MAX = 8

    def __init__(self, scene: Scene, camera: CameraConfig, width: int,
                 height: int, spp: int = 1, max_depth: int = 8,
                 backend: str = "auto", seed: int = 0,
                 enable_debugging: bool = False, *,
                 sampler: str = "random",
                 cluster_scan: bool | str = "auto", device=None):
        """The JAX package's arguments in its order, up to
        ``enable_debugging``; it has ``exhaust_black`` and
        ``russian_roulette_depth`` next, which the port's engine does not
        take (its step uses ``TraceOptions``' defaults), so ``sampler``,
        ``cluster_scan`` and the port's ``device`` are keyword-only. A
        scene with a shutter raises ``NotImplementedError``: the
        progressive step and the overlay are static-only."""
        check_backend(backend)
        if is_motion(scene):
            raise NotImplementedError(
                "the engine's progressive step and debug overlay render "
                "static scenes only; a scene with a shutter (moving "
                "spheres, a checker) renders offline through render_image")
        self.device = resolve_device(device)
        self.scene = scene
        self.camera = camera
        # what reset restores
        self._default_scene = scene
        self._default_camera = camera
        self.app = AppState(width=width, height=height,
                            samples_per_pixel=spp, max_depth=max_depth,
                            enable_debugging=enable_debugging)
        self.sampler = sampler
        # 'auto' and 'pallas': the kernels; 'jnp': the JAX package's
        # tracer (render/tracer.py), on the same device
        self.backend = backend
        # the scene is fixed between resets, so 'auto' (or True) gives
        # the step a static scene: a cluster partition built once, which
        # no camera move invalidates
        self.cluster_scan = cluster_scan
        self._seed = seed
        self.render_state: RenderState = init_render_state(
            width, height, seed, device=self.device)
        self._step_cache: dict = {}
        self._saved_images: list = []
        self.on_save: Optional[Callable[[np.ndarray], None]] = None
        self._save_path: Optional[str] = None
        self._pending_resize = None
        self._pick_scene = (None, None)  # (scene, its copy on the device)
        self._segments_dev = None  # device total since the last drain
        self._segments_unfolded = 0
        self._segments_host = 0
        self._segments_landing = []  # (pinned host copy, event) in flight

    # --- segments ------------------------------------------------------

    def _add_segments(self, seg: torch.Tensor) -> None:
        self._segments_dev = (seg if self._segments_dev is None
                              else self._segments_dev + seg)
        self._segments_unfolded += 1
        if self._segments_unfolded >= self._SEG_FOLD_FRAMES:
            self._drain_segments()

    def _drain_segments(self) -> None:
        """Move the device total to the host without waiting: a copy into
        pinned memory lands behind an event, and is added once it has."""
        if self._segments_dev is not None:
            if self.device.type == "cuda":
                host = torch.empty((), dtype=torch.int64, pin_memory=True)
                host.copy_(self._segments_dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                self._segments_landing.append((host, done))
            else:
                self._segments_host += int(self._segments_dev)
            self._segments_dev = None
            self._segments_unfolded = 0
        in_flight = []
        for host, done in self._segments_landing:
            if done.query():
                self._segments_host += int(host)
            else:
                in_flight.append((host, done))
        self._segments_landing = in_flight

    @property
    def total_segments(self) -> int:
        """Segments traced so far, exact. Reading it waits for the
        device."""
        for _, done in self._segments_landing:
            done.synchronize()
        self._drain_segments()
        return self._segments_host

    # --- step functions ------------------------------------------------

    def _step_fn(self, spp: int):
        app = self.app
        key = (app.width, app.height, spp, app.max_depth,
               app.should_average, app.enable_debugging,
               app.last_frame_weight, app.max_render_count)
        if key in self._step_cache:
            # least recently used last out: a hit moves to the end
            self._step_cache[key] = self._step_cache.pop(key)
        else:
            opts = TraceOptions(
                max_depth=app.max_depth, enable_debug=app.enable_debugging,
                sampler=self.sampler, cluster_scan=self.cluster_scan,
                backend=self.backend,
            )
            self._step_cache[key] = make_step_fn(
                app.width, app.height, spp=spp, opts=opts,
                should_average=app.should_average,
                last_frame_weight=app.last_frame_weight,
                max_render_count=app.max_render_count,
                static_scene=self.scene if self.cluster_scan else None,
                device=self.device,
            )
            while len(self._step_cache) > self._STEP_CACHE_MAX:
                self._step_cache.pop(next(iter(self._step_cache)))
        return self._step_cache[key]

    def _debug_params(self) -> DebugParams:
        return DebugParams(self.app.cursor_point, self.app.selected_object)

    def _device_scene(self) -> Scene:
        """The current scene on the engine's device, for picking (copied
        once per scene)."""
        if self._pick_scene[0] is not self.scene:
            self._pick_scene = (self.scene, self.scene.to(self.device))
        return self._pick_scene[1]

    # --- input events --------------------------------------------------

    def handle_wheel(self, delta_y_sign: float) -> None:
        self._apply_camera(controller.zoom(self.camera, delta_y_sign))

    def handle_mouse_move(self, dx: float, dy: float) -> None:
        cam = controller.mouse_look(self.camera, dx, dy,
                                    self.app.look_sensitivity)
        self._apply_camera(cam, update_cursor=True)

    def handle_key(self, name: str, down: bool) -> None:
        if name == "escape" and down:
            self.set_paused(True)
            return
        if hasattr(self.app.keydown_map, name):
            setattr(self.app.keydown_map, name, down)

    def handle_resize(self, raw_w: float, raw_h: float, now_ms=None) -> None:
        self.app.request_resize(now_ms if now_ms is not None else _now_ms())
        self._pending_resize = (raw_w, raw_h)

    def request_save(self, path: Optional[str] = None) -> None:
        """Save a PNG right after the next render (paused: at the 25-spp
        floor), to ``path`` or into ``_saved_images``."""
        self.app.should_render = True
        self.app.should_save = True
        self._save_path = path

    def reset(self) -> None:
        """Restore the construction-time scene and camera (the camera at
        the current aspect) and restart the average."""
        self.scene = self._default_scene
        self.camera = dataclasses.replace(
            self._default_camera,
            aspect_ratio=_f32(self.app.width / self.app.height))
        self.app.selected_object = NO_SELECTED_OBJECT_ID
        self.app.cursor_point = (0.0, 0.0, 0.0)
        self._restart()

    def set_paused(self, paused: bool) -> None:
        self.app.is_paused = paused
        if not paused:
            self.app.should_render = True

    def set_debugging(self, enabled: bool) -> None:
        """Toggle the in-kernel overlay (cursor marker and selection
        outline). The overlay is part of each frame, so the average
        restarts; otherwise the marker would fade out over later frames."""
        if enabled == self.app.enable_debugging:
            return
        self.app.enable_debugging = enabled
        self._restart()

    def _restart(self) -> None:
        self.render_state = reset_accumulation(self.render_state)
        self.app.render_count = 0
        self.app.should_render = True

    def _apply_camera(self, new_cam: CameraConfig,
                      update_cursor: bool = False) -> None:
        if update_cursor or self.app.enable_debugging:
            new_cam, point, selected = update_cursor_state(
                self._device_scene(), new_cam)
            self.app.cursor_point = point
            self.app.selected_object = selected
        if not cameras_equal(new_cam, self.camera):
            self.camera = new_cam
            self._restart()

    # --- the frame loop ------------------------------------------------

    def tick(self, now_ms: Optional[float] = None) -> bool:
        """One frame. Returns True if a render was issued."""
        now = now_ms if now_ms is not None else _now_ms()
        dt = now - self.app.prev_now if self.app.prev_now else 16.0
        if not self.app.keydown_map.all_false():
            cam = controller.update_position(self.camera,
                                             self.app.keydown_map, dt)
            self._apply_camera(cam, update_cursor=True)

        should_render = self.app.compute_should_render()

        if self.app.resize_due(now) and self._pending_resize:
            raw_w, raw_h = self._pending_resize
            self._pending_resize = None
            w, h = self.app.apply_resize(raw_w, raw_h, now)
            # the viewport follows the new canvas's aspect
            self.camera = dataclasses.replace(self.camera,
                                              aspect_ratio=_f32(w / h))
            self.render_state = dataclasses.replace(
                init_render_state(w, h, self.render_state.key,
                                  device=self.device),
                frame=self.render_state.frame)
            self.app.render_count = 0
            self.app.should_render = True

        if not should_render:
            self.app.prev_now = now
            return False

        self.app.update_render_globals()
        self.app.update_moving_fps(now, dt)
        step = self._step_fn(self.app.effective_spp())
        faulted = False
        try:
            self.render_state, aux = step(self.render_state, self.scene,
                                          self.camera, self._debug_params())
            self._add_segments(aux["segments"])
        except Exception as e:  # noqa: BLE001 — sorted below
            raise_if_sticky(e)
            if not is_device_fault(e):
                raise
            log.warning("device fault during the frame's step (%s); "
                        "rebuilding the session's state", str(e)[:120])
            faulted = True
        if faulted:
            # out of the handler, so the failed step's tensors are freed
            self._recover()
            return False

        if self.app.should_save:
            self.app.should_save = False
            path, self._save_path = self._save_path, None
            self.save_image(path)
        return True

    def _recover(self) -> None:
        """After a recoverable fault: drop what the failed step may have
        left half done and start the average again from the seed."""
        self._step_cache.clear()
        # the device total may hold the failed frame; the host's drained
        # total keeps everything up to the last drain
        self._segments_dev = None
        self._segments_unfolded = 0
        free_cached_memory()
        self.render_state = retry_on_device_fault(
            lambda: init_render_state(self.app.width, self.app.height,
                                      self._seed, device=self.device))()
        self.app.render_count = 0
        self.app.should_render = True

    # --- output --------------------------------------------------------

    def framebuffer(self) -> np.ndarray:
        """The running average, (H, W, 3) float32 in GL row order: one
        copy to the host."""
        return self.render_state.accum.to("cpu", copy=True).numpy()

    def save_image(self, path: Optional[str] = None):
        """PNG of the framebuffer: written to ``path`` (returned), else
        kept in ``_saved_images`` and handed to ``on_save`` (the bytes
        returned)."""
        img = self.framebuffer()
        if path is not None:
            io.save_png(path, img)
            return path
        data = io.encode_png(img)
        self._saved_images.append(data)
        if self.on_save:
            self.on_save(img)
        return data

    def run(self, n_frames: int, frame_time_ms: float = 16.0) -> None:
        """Drive ``n_frames`` ticks with a synthetic clock."""
        start = self.app.prev_now or 0.0
        for i in range(n_frames):
            self.tick(start + (i + 1) * frame_time_ms)

    def fps(self) -> float:
        return float(self.app.prev_fps.mean())


def _now_ms() -> float:
    return time.monotonic() * 1000.0
