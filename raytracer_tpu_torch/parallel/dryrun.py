"""A dry run of every sharded path on n ranks (counterpart of
``__graft_entry__.py`` ``dryrun_multichip``):

    python -m raytracer_tpu_torch.parallel.dryrun [N] [--device cpu]

It spawns N gloo ranks (several may share one card) and runs, at the JAX
dry run's tiny shapes: the progressive step over a (rows, spp) mesh (once
through the jnp tracer, which is what the JAX dry run's 'auto' gives on
CPU devices, and once through the kernels), the
sharded render, the sorted stratified render and the cluster walk under
a forced multi-chunk schedule, the adaptive render and the interleaved
one over a rows mesh of all N ranks, the step again at 128 columns, a
rows mesh of an odd number of ranks (N, or N - 1, in ranks of its own)
and the indivisible height's ``ValueError``. Rank 0 prints one line with
the keys of the JAX dry run's (``MULTICHIP_r05.json``).
"""

from __future__ import annotations

import argparse
import dataclasses

from raytracer_tpu_torch.parallel.spawn import run_ranks


def mesh_layout(n_devices: int) -> tuple:
    """(rows, spp) of the dry run's mesh, as the JAX dry run lays out n."""
    if n_devices % 2 == 0 and n_devices > 2:
        return n_devices // 2, 2
    return n_devices, 1


def _mesh(rows: int, spp: int, device):
    from raytracer_tpu_torch.parallel.mesh import make_mesh

    if spp > 1:
        return make_mesh((rows, spp), device=device)
    return make_mesh((rows,), ("rows",), device=device)


def _dryrun_rank(n_devices: int, device) -> dict:
    from raytracer_tpu_torch.parallel.sharding import (
        make_sharded_step_fn,
        render_image_sharded_pallas,
        shard_render_state,
    )
    from raytracer_tpu_torch.progressive.state import init_render_state
    from raytracer_tpu_torch.render import schedule
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    rows, spp_axis = mesh_layout(n_devices)
    mesh = _mesh(rows, spp_axis, device)
    width, height = 64, 8 * rows
    scene, cam, *_ = presets.get_config("demo", width, height)
    opts = TraceOptions(max_depth=4)
    got = {"mesh": mesh.shape, "image": (height, width)}

    def step_segments(w: int, key: int, backend: str = "auto") -> int:
        step = make_sharded_step_fn(
            w, height, mesh, spp=spp_axis,
            opts=dataclasses.replace(opts, backend=backend))
        state = shard_render_state(
            init_render_state(w, height, key, device="cpu"), mesh)
        _, aux = step(state, scene, cam)
        return int(aux["segments"])

    got["jnp_segments"] = step_segments(width, 0, "jnp")
    got["segments"] = step_segments(width, 0)
    if got["segments"] <= 0 or got["jnp_segments"] <= 0:
        raise AssertionError("the sharded step counted no segment")
    got["pallas_sharded"] = tuple(render_image_sharded_pallas(
        scene, cam, 128, 8 * rows, spp_axis, 0, mesh, opts).shape)
    real_pick = schedule.pick_chunk_spp
    # a multi-chunk schedule at dry-run scale: spp_local 9 gives the
    # uniform [1, 4, 4], so the sorted (and adaptive) paths run
    schedule.pick_chunk_spp = lambda spp, *a, **k: min(spp, 2)
    try:
        got["pallas_sorted"] = tuple(render_image_sharded_pallas(
            scene, cam, 128, 32 * rows, 9 * spp_axis, 2, mesh,
            dataclasses.replace(opts, sampler="stratified")).shape)
        mesh_rows = _mesh(n_devices, 1, device)
        _, stats = render_image_sharded_pallas(
            scene, cam, 128, 32 * n_devices, 9, 3, mesh_rows,
            dataclasses.replace(opts, adaptive_tolerance=0.2),
            return_stats=True)
        got["pallas_adaptive_mean_spp"] = stats["mean_spp"]
        got["pallas_cluster"] = tuple(render_image_sharded_pallas(
            scene, cam, 128, 32 * rows, 9 * spp_axis, 2, mesh,
            dataclasses.replace(opts, cluster_scan=True)).shape)
        # 64-row bands of two 32-row blocks: the interleave engages
        got["pallas_interleaved"] = tuple(render_image_sharded_pallas(
            scene, cam, 128, 64 * n_devices, 9, 3, mesh_rows,
            dataclasses.replace(opts, adaptive_tolerance=0.2,
                                interleave_rows=True)).shape)
    finally:
        schedule.pick_chunk_spp = real_pick
    got["pallas_progressive_segments"] = step_segments(128, 1)
    try:
        render_image_sharded_pallas(scene, cam, 128, 8 * n_devices + 4, 1,
                                    5, mesh_rows, opts)
    except ValueError as e:
        if "divisible" not in str(e):
            raise AssertionError(f"wrong indivisibility error: {e}") from e
        got["indivisible"] = "ValueError"
    else:
        raise AssertionError("indivisible height did not raise ValueError")
    return got


def _odd_rank(n_odd: int, device) -> dict:
    from raytracer_tpu_torch.parallel.sharding import (
        render_image_sharded_pallas,
    )
    from raytracer_tpu_torch.render.options import TraceOptions
    from raytracer_tpu_torch.scene import presets

    mesh = _mesh(n_odd, 1, device)
    scene, cam, *_ = presets.get_config("demo", 64, 8 * n_odd)
    image = render_image_sharded_pallas(scene, cam, 128, 8 * n_odd, 1, 4,
                                        mesh, TraceOptions(max_depth=4))
    return {"odd_mesh": mesh.shape, "shape": tuple(image.shape)}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the dry run on ``n_devices`` spawned gloo ranks, on ``device``
    (each rank's card by default; ``'cpu'`` on the host); prints rank 0's
    summary line and returns it as a dict."""
    got = run_ranks(_dryrun_rank, n_devices, n_devices, device)[0]
    n_odd = n_devices if n_devices % 2 else n_devices - 1
    got["odd_mesh"] = None
    if n_odd >= 3:
        got["odd_mesh"] = run_ranks(_odd_rank, n_odd, n_odd,
                                    device)[0]["odd_mesh"]
    print(
        f"dryrun_multichip OK: mesh={got['mesh']} "
        f"image={got['image'][0]}x{got['image'][1]} "
        f"jnp_segments={got['jnp_segments']} segments={got['segments']} "
        f"pallas_sharded={got['pallas_sharded']} "
        f"pallas_sorted={got['pallas_sorted']} "
        f"pallas_cluster={got['pallas_cluster']} "
        f"pallas_adaptive_mean_spp={got['pallas_adaptive_mean_spp']:.1f} "
        f"pallas_interleaved={got['pallas_interleaved']} "
        f"pallas_progressive_segments={got['pallas_progressive_segments']} "
        f"odd_mesh={got['odd_mesh']} indivisible={got['indivisible']}"
    )
    return got


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="cpu for gloo ranks on the host; each rank's card "
                        "by default")
    a = p.parse_args(argv)
    dryrun_multichip(a.n_devices, a.device)


if __name__ == "__main__":
    main()
