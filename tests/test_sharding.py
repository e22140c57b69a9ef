"""Multi-device sharding tests on the 8-device virtual CPU mesh.

What the reference never had (SURVEY.md section 4 carry-over): the
thread-per-device scheme (xrays.cpp:419-527) becomes a single SPMD program
over a ray mesh; these tests prove the trace stays sharded, results match
the single-device run exactly, and the Newton ensemble-max lowers to a
collective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_framework_tpu.models import dispersion as disp
from graph_framework_tpu.models.equilibrium import make_slab_density
from graph_framework_tpu.parallel.mesh import (
    ray_mesh, shard_rays, replicate, pad_to_devices, RAY_AXIS)
from graph_framework_tpu.solver import Solver, make_ray_state, init_k
from jax.sharding import NamedSharding, PartitionSpec as P


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _problem(n):
    eq = make_slab_density()
    st = make_ray_state(n, w=900.0, x=0.1,
                        kx=jnp.linspace(700.0, 900.0, n),
                        ky=25.0, kz=400.0)
    return eq, st


def test_sharded_trace_matches_single_device():
    n = 64
    eq, st = _problem(n)
    st = init_k(st, disp.cold_plasma, eq, "kx", tolerance=1e-24)
    sol = Solver(disp.cold_plasma, eq, method="rk4", dt=1e-4, sub_steps=5)

    fin_single, _ = sol.trace(st, 3)

    mesh = ray_mesh()
    st_sharded = shard_rays(st, mesh)
    fin_sharded, _ = sol.trace(st_sharded, 3)

    for f in st._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(fin_single, f)),
            np.asarray(getattr(fin_sharded, f)))

    # outputs remain sharded over the ray axis
    sh = fin_sharded.x.sharding
    assert sh.is_equivalent_to(NamedSharding(mesh, P(RAY_AXIS)), 1)


def test_sharded_newton_collective():
    """init_k's convergence loop reduces the residual with a global max;
    with sharded inputs XLA inserts the all-reduce and the result matches
    the unsharded solve."""
    n = 64
    eq, st = _problem(n)
    mesh = ray_mesh()
    st_sharded = shard_rays(st, mesh)

    solved_single = init_k(st, disp.cold_plasma, eq, "kx", tolerance=1e-24)
    solved_sharded = init_k(st_sharded, disp.cold_plasma, eq, "kx",
                            tolerance=1e-24)
    np.testing.assert_allclose(np.asarray(solved_single.kx),
                               np.asarray(solved_sharded.kx), rtol=1e-14)


def test_efit_tables_replicated(efit_file):
    from graph_framework_tpu.models import make_efit
    eq = make_efit(efit_file)
    mesh = ray_mesh()
    eq_rep = replicate(eq, mesh)
    assert eq_rep.psi_coeffs.sharding.is_equivalent_to(
        NamedSharding(mesh, P()), eq_rep.psi_coeffs.ndim)

    n = 32
    st = make_ray_state(n, w=500.0, x=2.3, kx=-400.0)
    st = shard_rays(st, mesh)
    sol = Solver(disp.cold_plasma, eq_rep, method="rk4", dt=1e-4,
                 sub_steps=2)
    fin = sol.step_fn()(st)
    assert np.isfinite(np.asarray(fin.x)).all()


def test_pad_to_devices():
    mesh = ray_mesh()
    assert pad_to_devices(1, mesh) == 8
    assert pad_to_devices(8, mesh) == 8
    assert pad_to_devices(9, mesh) == 16


def test_collective_in_lowering():
    """The Newton loop over a sharded ensemble must contain a cross-device
    reduction in its lowered HLO."""
    n = 16
    eq, st = _problem(n)
    mesh = ray_mesh()
    st_sharded = shard_rays(st, mesh)

    def solve(s):
        return init_k(s, disp.cold_plasma, eq, "kx", tolerance=1e-20,
                      max_iterations=8)

    lowered = jax.jit(solve).lower(st_sharded)
    hlo = lowered.compile().as_text()
    assert "all-reduce" in hlo or "all_reduce" in hlo


def test_scaling_efficiency_smoke():
    """Weak-scaling sanity on virtual devices: the sharded step executes
    the same program per shard (no communication in the step), so per-step
    wall time should not blow up with devices.  (True scaling numbers come
    from real hardware; this guards the program structure.)"""
    n = 8 * 16
    eq, st = _problem(n)
    mesh = ray_mesh()
    sol = Solver(disp.cold_plasma, eq, method="rk4", dt=1e-4, sub_steps=2)
    step = sol.step_fn()
    fin = step(shard_rays(st, mesh))
    hlo = jax.jit(step).lower(shard_rays(st, mesh)).compile().as_text()
    # the integrator step itself is collective-free
    assert "all-reduce" not in hlo and "all-gather" not in hlo


def test_run_blocked_sharded_matches_plain(efit_file):
    """run_blocked_sharded (shard_map over the ray mesh + per-device
    ensemble blocking, the pod-scale production composition) is a pure
    layout change: identical results to Solver.run on one device."""
    from graph_framework_tpu.models import make_efit
    from graph_framework_tpu.parallel.mesh import run_blocked_sharded

    eq = make_efit(efit_file, dtype=jnp.float32)
    n = 64
    st = make_ray_state(n, w=500.0, x=2.2, y=0.0, z=0.0,
                        kx=-300.0, ky=150.0, kz=0.0, dtype=jnp.float32)
    sol = Solver(disp.cold_plasma, eq, method="rk4", dt=1e-4, sub_steps=2)
    ref = sol.run(st, 3)

    mesh = ray_mesh()
    st_sh = shard_rays(st, mesh)
    eq_sh = replicate(eq, mesh)
    import dataclasses
    sol_sh = dataclasses.replace(sol, eq=eq_sh)
    out = run_blocked_sharded(sol_sh, st_sh, 3, mesh, block_rays=4)
    assert out.x.sharding.is_equivalent_to(
        NamedSharding(mesh, P("rays")), out.x.ndim)
    for f in st._fields:
        np.testing.assert_allclose(np.asarray(getattr(out, f)),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=1e-7)
