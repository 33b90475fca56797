"""RenderState: the resumable progressive-render state (counterpart of
``raytracer_tpu/progressive/state.py``).

The running average lives on the device; the frame counters and the
session's key data are host ints, so a step derives its frame key and
sample offset without waiting for the device. The ``.npz`` checkpoint
uses the JAX package's field names (``accum``, ``render_count``,
``frame``, ``key``), so a state saved by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.render.api import resolve_device
from raytracer_tpu_torch.render.rng import key_data


@dataclasses.dataclass
class RenderState:
    accum: torch.Tensor  # (H, W, 3) float32 running average (post-gamma)
    render_count: int  # frames folded into accum, clamped at the maximum
    frame: int  # increases every step; folds into the random key
    key: tuple  # (kd0, kd1): the session's key data

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]


def init_render_state(width: int, height: int, key=None, *,
                      device=None) -> RenderState:
    """A fresh session: zero average, counters at 0. ``key`` is an int
    seed (``jax.random.PRNGKey(seed)``'s data) or key data; None is the
    JAX package's default, ``PRNGKey(0)``. ``device`` defaults to CUDA."""
    if key is None:
        key = 0
    return RenderState(
        accum=torch.zeros((height, width, 3), dtype=torch.float32,
                          device=resolve_device(device)),
        render_count=0, frame=0, key=key_data(key),
    )


def reset_accumulation(state: RenderState) -> RenderState:
    """Restart the running average (the camera or the scene changed); the
    frame counter keeps advancing, so the random streams never replay."""
    return dataclasses.replace(state, accum=torch.zeros_like(state.accum),
                               render_count=0)


def render_state_from_numpy(accum, render_count, frame, key,
                            device=None) -> RenderState:
    """The port's state from a JAX ``RenderState``'s fields as arrays (or
    from the arrays of its ``.npz`` checkpoint)."""
    return RenderState(
        accum=torch.tensor(np.asarray(accum, np.float32),
                           device=resolve_device(device)),
        render_count=int(np.asarray(render_count)),
        frame=int(np.asarray(frame)),
        key=key_data(np.asarray(key, np.uint32)),
    )


def save_render_state(path, state: RenderState) -> None:
    """Checkpoint to an ``.npz`` with the JAX package's fields and types:
    int32 counters and a (2,) uint32 key."""
    np.savez(
        path,
        accum=state.accum.detach().cpu().numpy(),
        render_count=np.asarray(state.render_count, np.int32),
        frame=np.asarray(state.frame, np.int32),
        key=np.asarray(state.key, np.uint32),
    )


def load_render_state(path, *, device=None) -> RenderState:
    with np.load(path) as data:
        return render_state_from_numpy(data["accum"], data["render_count"],
                                       data["frame"], data["key"], device)
