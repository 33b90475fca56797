"""Multi-device sharding over ``torch.distributed`` (counterpart of
``raytracer_tpu/parallel/``): one process per device, a (rows, spp) mesh
over the ranks of the default process group.

- pixel rows are shared out as bands, with no collective while tracing;
- samples per pixel are shared out as ranges of absolute sample indices,
  with one all-reduce of linear sums per render or frame;
- a progressive session's accumulation buffer stays on each rank as its
  band, frame to frame;
- the kernels' paths (``render_image_sharded_pallas``, the step) render
  what one device renders; the jnp tracer's (``render_image_sharded``,
  the step with ``backend='jnp'`` or the overlay) key each shard apart,
  as the JAX package's do.

Start one process per card, for example
``python -m torch.distributed.run --nproc-per-node 4 my_render.py``, where
the script calls ``init_process_group`` and :func:`make_mesh`;
:func:`~raytracer_tpu_torch.parallel.dryrun.dryrun_multichip` spawns its
own ranks.
"""

from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
from raytracer_tpu_torch.parallel.mesh import Mesh, make_mesh
from raytracer_tpu_torch.parallel.sharding import (
    gather_rows,
    make_sharded_step_fn,
    render_image_sharded,
    render_image_sharded_pallas,
    shard_render_state,
)
from raytracer_tpu_torch.parallel.spawn import run_ranks

__all__ = [
    "Mesh",
    "dryrun_multichip",
    "gather_rows",
    "make_mesh",
    "make_sharded_step_fn",
    "render_image_sharded",
    "render_image_sharded_pallas",
    "run_ranks",
    "shard_render_state",
]
