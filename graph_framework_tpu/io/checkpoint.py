"""Sharded mid-trace checkpointing of ray ensembles (Orbax).

The reference's only checkpoint mechanism is its NetCDF result files: the
3-phase xrays pipeline communicates solely through ``result<n>.nc``
(absorption reopens the trace file and appends; output.hpp:73-82,
absorption.hpp:298-316).  ``io.output.ResultFile`` reproduces that flow.

This module adds a piece the reference never had: a
device-sharding-aware checkpoint of the live ray state itself, so a long
multi-host trace can stop and resume without round-tripping through the
per-step result file.  Arrays are saved with their shardings (each host
writes its own shards) and restored to any compatible mesh.
"""

from __future__ import annotations

import pathlib

import jax

from graph_framework_tpu.models.rays import RayState


def save_ray_state(path, state: RayState, *, step: int | None = None,
                   force: bool = True) -> None:
    """Write a RayState (or any pytree of arrays) checkpoint.

    Multi-host safe: under ``jax.distributed`` every process must call this
    with its view of the same global arrays; each host writes the shards it
    owns (Orbax/TensorStore OCDBT).
    """
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).absolute()
    if step is not None:
        path = path / f"step_{step}"
    with ocp.StandardCheckpointer() as ckpt:
        ckpt.save(path, state, force=force)


def restore_ray_state(path, template: RayState | None = None, *,
                      step: int | None = None,
                      sharding=None) -> RayState:
    """Restore a checkpoint written by :func:`save_ray_state`.

    ``template``: a RayState of matching shapes/dtypes (e.g. the freshly
    initialized state) used to direct restoration; with ``sharding`` (a
    ``jax.sharding.Sharding``) the arrays are restored directly onto the
    target mesh without a host-memory detour.
    Without a template the raw pytree is restored and wrapped.
    """
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).absolute()
    if step is not None:
        path = path / f"step_{step}"
    with ocp.StandardCheckpointer() as ckpt:
        if template is None:
            out = ckpt.restore(path)
            return RayState(**out) if isinstance(out, dict) else out
        abstract = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(
                a.shape, a.dtype,
                sharding=sharding if sharding is not None
                else getattr(a, "sharding", None)),
            template)
        return ckpt.restore(path, abstract)


def latest_step(path) -> int | None:
    """Highest ``step_N`` saved under ``path`` (None when empty) - lets a
    restarted trace pick up where the last periodic checkpoint left off."""
    path = pathlib.Path(path)
    steps = [int(p.name.split("_", 1)[1]) for p in path.glob("step_*")
             if p.name.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None
