"""Progressive rendering (counterpart of ``raytracer_tpu/progressive/``):
the resumable state and the step that folds a frame into its running
average on the device."""

from raytracer_tpu_torch.progressive.state import (
    RenderState,
    init_render_state,
)
from raytracer_tpu_torch.progressive.step import accumulate, make_step_fn

__all__ = ["RenderState", "init_render_state", "accumulate", "make_step_fn"]
