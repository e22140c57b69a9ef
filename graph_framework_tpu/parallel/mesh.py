"""Data-parallel ray sharding over a device mesh.

Replacement for the reference's thread-per-device data
parallelism (reference: graph_driver/xrays.cpp:419-527 - one std::thread,
graph, JIT context and NetCDF file per CUDA/Metal device, rays split
batch = N/devices, zero communication).  Here a single SPMD program runs on
every chip: the ray axis is sharded over a 1D ``Mesh("rays")``, equilibrium
tables are replicated, and XLA inserts the only collective the workload
needs - the ensemble-max in the Newton convergence loop (the reference's
per-device max-reduction kernel, cuda_context.hpp:954-995) - as an
all-reduce.

Multi-host: call ``jax.distributed.initialize()`` before building the mesh
and the same code spans hosts; per-host output shards mirror the
reference's result<n>.nc-per-device scheme (io.output).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


RAY_AXIS = "rays"


def ray_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1D mesh over all (or the given) devices with axis "rays"."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def shard_rays(tree, mesh: Mesh):
    """Place every leaf of a ray-ensemble pytree with its leading axis
    sharded over the mesh (pad the ensemble to a multiple of the device
    count before calling)."""
    sharding = NamedSharding(mesh, P(RAY_AXIS))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (equilibrium tables) on every device."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda a: jax.device_put(a, sharding) if hasattr(a, "shape") else a,
        tree)


def sharded_trace_fn(solver, mesh: Mesh, num_steps: int):
    """jit the whole trace with sharded-in/sharded-out ray state.

    The step itself is embarrassingly parallel; XLA keeps every per-ray
    array sharded and runs collective-free.  Newton init (if traced inside)
    all-reduces only its scalar convergence max.
    """
    state_sharding = NamedSharding(mesh, P(RAY_AXIS))

    def run(state):
        return solver.trace(state, num_steps)

    return jax.jit(run, in_shardings=(state_sharding,),
                   out_shardings=(state_sharding, state_sharding))


def pad_to_devices(n: int, mesh: Mesh) -> int:
    """Smallest multiple of the mesh size >= n (the reference instead gives
    remainder rays to low-numbered threads, xrays.cpp:424-432; padding with
    dead rays is the SPMD-friendly equivalent)."""
    d = mesh.devices.size
    return ((n + d - 1) // d) * d


def make_blocked_sharded_fn(solver, num_steps: int, mesh: Mesh,
                            block_rays: Optional[int] = None):
    """Build the jitted sharded+blocked trace function ``state -> state``
    (see :func:`run_blocked_sharded`).  Build ONCE and reuse when timing:
    each call to run_blocked_sharded constructs a fresh jit wrapper whose
    retrace would pollute a measurement."""
    spec = P(RAY_AXIS)
    step = solver.raw_step_fn()

    def local_run(s):
        n_local = s.x.shape[0]
        inner = step
        if block_rays and block_rays < n_local:
            if n_local % block_rays:
                raise ValueError(
                    f"block_rays={block_rays} must divide the per-device "
                    f"ray count {n_local}")
            nb = n_local // block_rays

            def inner(c, _step=step):
                return jax.lax.map(_step, c)

            s = jax.tree.map(
                lambda a: a.reshape((nb, block_rays) + a.shape[1:]), s)

        def body(c, _):
            return inner(c), None

        s, _ = jax.lax.scan(body, solver.init_carry(s), None,
                            length=num_steps)
        s = solver.carry_state(s)
        if block_rays and block_rays < n_local:
            s = jax.tree.map(
                lambda a: a.reshape((-1,) + a.shape[2:]), s)
        return s

    fn = jax.shard_map(local_run, mesh=mesh, in_specs=(spec,),
                       out_specs=spec, check_vma=False)
    return jax.jit(fn)


def run_blocked_sharded(solver, state, num_steps: int, mesh: Mesh,
                        block_rays: Optional[int] = None):
    """Advance ``num_steps`` recorded steps with the ensemble sharded
    over the mesh AND blocked per device - the production composition
    for pod-scale 1M-rays-per-chip runs.

    ``Solver.run(block_rays=...)`` alone must not be used on a sharded
    ensemble: its ``lax.map`` would scan over a SHARDED axis,
    serializing the devices.  Here ``shard_map`` first splits the
    ensemble into per-device locals (collective-free, like the whole
    step kernel), and each device scans its own resident blocks - the
    working-set fix of tools/probe_1m_chunking.py applied per chip.
    ``block_rays`` is the PER-DEVICE block size (None: no blocking).
    """
    # run the separability guard EAGERLY here: inside shard_map/jit the
    # state is traced and Solver._ensure_separable skips itself, so a
    # non-separable Hamiltonian would silently symplectic-step without
    # the reference's "Hamiltonian is not separable." error
    # (solver.hpp:1076-1094).
    solver._ensure_separable(state)
    return make_blocked_sharded_fn(solver, num_steps, mesh,
                                   block_rays)(state)
