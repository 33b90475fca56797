"""AppState: the interactive session's host state (counterpart of
``raytracer_tpu/interact/appstate.py``): render flags, input, the resize
debounce, the selection and the fps window. The running average, scene
and camera are tensors the engine holds; :func:`cameras_equal` is the
change test that resets the average."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracer_tpu_torch.camera.camera import CameraConfig
from raytracer_tpu_torch.camera.controller import KeydownMap
from raytracer_tpu_torch.scene.spheres import NO_SELECTED_OBJECT_ID

#: the longest canvas edge (the reference's src/dom.rs:13)
MAX_CANVAS_SIZE = 1280
RESIZE_DEBOUNCE_MS = 500.0
#: spp floor while paused, for a quality still
PAUSED_SPP_FLOOR = 25
#: frames in the moving fps window
FPS_WINDOW = 50


def cameras_equal(a: CameraConfig, b: CameraConfig) -> bool:
    """Every field equal, element for element (as ``np.array_equal``)."""
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def adjusted_screen_dimensions(raw_width: float, raw_height: float,
                               max_size: int = MAX_CANVAS_SIZE):
    """Cap the longest edge at ``max_size``, keeping the aspect. The
    portrait branch caps by the raw WIDTH, a quirk of the reference that
    the JAX package keeps."""
    aspect = raw_width / raw_height
    if raw_width > raw_height:
        w = min(raw_width, float(max_size))
        return int(w), int(w / aspect)
    h = min(raw_width, float(max_size))
    return int(h * aspect), int(h)


@dataclasses.dataclass
class AppState:
    """Host render flags, input and analytics."""

    width: int
    height: int
    samples_per_pixel: int = 1
    max_depth: int = 8

    is_paused: bool = True
    should_average: bool = True
    should_render: bool = True
    should_save: bool = False
    render_count: int = 0
    last_frame_weight: float = 1.0
    max_render_count: int = 100_000
    prev_now: float = 0.0
    should_update_to_match_window_size: bool = False
    last_resize_time: float = 0.0

    keydown_map: KeydownMap = dataclasses.field(default_factory=KeydownMap)
    look_sensitivity: float = 0.1

    enable_debugging: bool = False
    cursor_point: tuple = (0.0, 0.0, 0.0)
    selected_object: int = NO_SELECTED_OBJECT_ID

    prev_fps_update_time: float = 0.0
    prev_fps: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.prev_fps is None:
            self.prev_fps = np.zeros(FPS_WINDOW)

    def effective_spp(self) -> int:
        """spp, floored at PAUSED_SPP_FLOOR while paused."""
        if self.is_paused:
            return max(self.samples_per_pixel, PAUSED_SPP_FLOOR)
        return self.samples_per_pixel

    def compute_should_render(self) -> bool:
        """Render when unpaused, when saving, or for the very first
        frame."""
        return (
            (self.should_render and not self.is_paused)
            or (self.should_render and self.is_paused and self.should_save)
            or (self.should_render and self.is_paused
                and not self.should_save and self.render_count == 0)
        )

    def update_render_globals(self) -> None:
        """One-shot rendering unless averaging; the frame count clamps."""
        if not self.should_average:
            self.should_render = False
        self.render_count = min(self.render_count + 1, self.max_render_count)

    def request_resize(self, now_ms: float) -> None:
        self.should_update_to_match_window_size = True
        self.last_resize_time = now_ms

    def resize_due(self, now_ms: float) -> bool:
        return (self.should_update_to_match_window_size
                and now_ms - self.last_resize_time > RESIZE_DEBOUNCE_MS)

    def apply_resize(self, raw_width: float, raw_height: float,
                     now_ms: float):
        """The new (width, height), capped."""
        self.should_update_to_match_window_size = False
        self.last_resize_time = now_ms
        self.width, self.height = adjusted_screen_dimensions(raw_width,
                                                             raw_height)
        return self.width, self.height

    def update_moving_fps(self, now_ms: float, dt_ms: float) -> None:
        self.prev_now = now_ms
        if dt_ms > 0:
            self.prev_fps[:-1] = self.prev_fps[1:]
            self.prev_fps[-1] = 1000.0 / dt_ms

    def average_fps(self, now_ms: float, throttle_ms: float = 250.0):
        """The window's mean fps, at most every ``throttle_ms``; None
        between updates."""
        if now_ms - self.prev_fps_update_time > throttle_ms:
            self.prev_fps_update_time = now_ms
            return float(self.prev_fps.mean())
        return None
