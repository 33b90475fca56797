"""Interaction layer (counterpart of ``raytracer_tpu/interact/``):
picking, autofocus, selection and the host app state."""

from raytracer_tpu_torch.interact.appstate import AppState
from raytracer_tpu_torch.interact.picking import (
    CenterHit,
    center_hit,
    update_cursor_state,
)

__all__ = ["CenterHit", "center_hit", "update_cursor_state", "AppState"]
