"""Solver integration tests (port of graph_tests/solver_test.cpp).

For each dispersion/solver pair: Newton-init kx so D = 0, then step and
assert the dispersion residual stays below the init tolerance for 5 steps
(solver_test.cpp:28-60).  Configurations mirror run_tests
(solver_test.cpp:93-99): gaussian_density equilibrium with
(omega0, kx0, dt) = simple(0.5, 0.25, 1.0), gaussian_well(0.5, 0.25, 1e-5),
cold_plasma(900, 1000, 5e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_framework_tpu.models import dispersion as disp
from graph_framework_tpu.models.equilibrium import make_gaussian_density
from graph_framework_tpu.models.rays import residual_fn
from graph_framework_tpu.solver import Solver, make_ray_state, init_k


CASES = [
    # (dispersion, omega0, kx0, dt, residual_tol)
    (disp.simple, 0.5, 0.25, 1.0, 1.0e-30),
    (disp.gaussian_well, 0.5, 0.25, 1.0e-5, 1.0e-30),
    (disp.cold_plasma, 900.0, 1000.0, 0.5e-4, 1.0e-25),
]


@pytest.mark.parametrize("method", ["rk2", "rk4"])
@pytest.mark.parametrize(
    "dfun,omega0,kx0,dt,tol", CASES,
    ids=[c[0].__name__ for c in CASES])
def test_residual_preserved(method, dfun, omega0, kx0, dt, tol):
    eq = make_gaussian_density()
    st = make_ray_state(1, w=omega0, kx=kx0, ky=0.25, kz=0.15,
                        x=0.0, y=0.0, z=0.0)
    st = init_k(st, dfun, eq, "kx", tolerance=tol)
    res = residual_fn(dfun, eq)
    assert float(jnp.max(res(st))) < tol * 10, "Newton init failed"

    sol = Solver(dfun, eq, method=method, dt=dt, sub_steps=1)
    step = sol.step_fn()
    for _ in range(5):
        st = step(st)
        assert float(jnp.max(jnp.abs(res(st)))) < tol, (
            "Solver failed to retain initial accuracy")


def test_trace_scan_matches_loop():
    """lax.scan trace must equal the step-by-step host loop."""
    eq = make_gaussian_density()
    st = make_ray_state(4, w=0.5, kx=0.25, ky=0.25, kz=0.15)
    st = init_k(st, disp.simple, eq, "kx")
    sol = Solver(disp.simple, eq, method="rk4", dt=0.5, sub_steps=2)
    fin, traj = sol.trace(st, 6)
    st2 = st
    step = sol.step_fn()
    for _ in range(6):
        st2 = step(st2)
    for f in st._fields:
        np.testing.assert_allclose(np.asarray(getattr(fin, f)),
                                   np.asarray(getattr(st2, f)), rtol=1e-14)
    assert traj.t.shape == (7, 4)


def test_trace_streaming_writer():
    eq = make_gaussian_density()
    st = make_ray_state(2, w=0.5, kx=0.25, ky=0.25, kz=0.15)
    st = init_k(st, disp.simple, eq, "kx")
    sol = Solver(disp.simple, eq, method="rk2", dt=0.5, sub_steps=1)
    seen = []
    sol.trace_streaming(st, 5, lambda i, s: seen.append((i, float(s.t[0]))))
    assert [i for i, _ in seen] == list(range(6))
    assert seen[-1][1] == pytest.approx(2.5)


def test_adaptive_rk4_runs():
    """adaptive_rk4 (solver.hpp:343-530): per-ray (dt, lambda) Newton then
    RK4.  Check it steps and keeps the residual small on the simple
    dispersion."""
    eq = make_gaussian_density()
    st = make_ray_state(2, w=0.5, kx=0.25, ky=0.25, kz=0.15)
    st = init_k(st, disp.simple, eq, "kx")
    sol = Solver(disp.simple, eq, method="adaptive_rk4", dt=0.5, sub_steps=1)
    step = sol.step_fn()
    st2 = step(st)
    assert float(st2.t[0]) > float(st.t[0])
    res = residual_fn(disp.simple, eq)
    assert float(jnp.max(res(st2))) < 1e-20


def test_split_symplectic_separable():
    """split_simplextic on a separable case (simple dispersion in uniform
    plasma is separable: dx/dt depends only on k, dk/dt == 0)."""
    from graph_framework_tpu.models.equilibrium import make_slab_density
    from graph_framework_tpu.ops.integrators import check_separable
    from graph_framework_tpu.models.rays import make_ray_rhs

    eq = make_gaussian_density()
    st = make_ray_state(1, w=0.5, kx=0.4, ky=0.1, kz=0.1, x=3.0, y=3.0)
    rhs = make_ray_rhs(disp.simple, eq)
    assert check_separable(rhs, st)

    sol = Solver(disp.simple, eq, method="split_simplextic", dt=0.1)
    st2 = sol.step_fn()(st)
    # vacuum: k unchanged, x advances along vg
    np.testing.assert_allclose(float(st2.kx[0]), float(st.kx[0]), rtol=1e-14)
    assert float(st2.x[0]) != float(st.x[0])


def test_split_symplectic_rejects_non_separable(efit_file):
    """Construction-time guard parity (solver.hpp:1076-1094): cold_plasma
    in a magnetized EFIT equilibrium is NOT separable (dx/dt depends on x
    through B), and the symplectic solver must refuse it with the
    reference's wording rather than silently stepping."""
    from graph_framework_tpu.models import make_efit

    eq = make_efit(efit_file)
    # interior launch point: at the vacuum edge (x = 2.5) the local
    # Jacobian blocks happen to vanish and the one-point numeric check
    # cannot see the coupling
    st = make_ray_state(2, w=500.0, x=2.2, y=0.0, z=0.0,
                        kx=-300.0, ky=50.0, kz=50.0)
    sol = Solver(disp.cold_plasma, eq, method="split_simplextic", dt=1e-5)
    with pytest.raises(ValueError, match="not separable"):
        sol.step_fn()(st)
    with pytest.raises(ValueError, match="not separable"):
        sol.run(st, 1)


def test_adaptive_dt_persists_and_adapts():
    """VERDICT r1 item 5 / solver.hpp:881-1006: the per-ray (dt, lambda)
    are persistent variables - each step's Newton starts from the previous
    step's adapted values, and on the stiff system the adapted dt visibly
    differs from the configured scalar and keeps changing between recorded
    steps."""
    from graph_framework_tpu.models.equilibrium import make_no_magnetic_field

    eq = make_no_magnetic_field()
    st = make_ray_state(4, w=1.0, x=1.0, kx=1.0)
    sol = Solver(disp.stiff, eq, method="adaptive_rk4", dt=1.0e-4,
                 sub_steps=1)

    step = sol.carry_step_fn()
    carry = sol.init_carry(st)
    np.testing.assert_allclose(np.asarray(carry.dt), 1.0e-4)

    c1 = step(carry)
    c2 = step(c1)
    # dt adapted away from the configured scalar...
    assert float(jnp.max(jnp.abs(c1.dt - 1.0e-4))) > 1.0e-7
    # ...and kept adapting from the *persisted* value, not re-broadcast
    assert float(jnp.max(jnp.abs(c2.dt - c1.dt))) > 0.0
    # time advanced by the adapted dt (adaptation precedes the RK step),
    # not by the configured scalar
    np.testing.assert_allclose(np.asarray(c1.state.t), np.asarray(c1.dt),
                               rtol=1e-12)


def test_run_block_rays_matches_monolithic():
    """Ensemble blocking (Solver.run(block_rays=...), the 1M-ray
    working-set fix) is a pure layout change: results must be bitwise
    identical to the monolithic run."""
    eq = make_gaussian_density()
    st = make_ray_state(16, w=0.5, kx=0.25, ky=0.25, kz=0.15)
    st = init_k(st, disp.simple, eq, "kx")
    sol = Solver(disp.simple, eq, method="rk4", dt=0.5, sub_steps=2)
    fin = sol.run(st, 4)
    fin_b = sol.run(st, 4, block_rays=4)
    for f in st._fields:
        np.testing.assert_array_equal(np.asarray(getattr(fin, f)),
                                      np.asarray(getattr(fin_b, f)))
    with pytest.raises(ValueError, match="must divide"):
        sol.run(st, 1, block_rays=5)


def test_newton_diagnostics_real_counts():
    """ops.newton exposes the converge_item's telemetry
    (workflow.hpp:184-204): true iteration count and final max residual."""
    from graph_framework_tpu.ops.newton import newton_solve

    x0 = jnp.array([3.0, 10.0, 0.5])
    x, converged, diag = newton_solve(lambda x: x * x - 2.0, x0,
                                      tolerance=1.0e-28)
    np.testing.assert_allclose(np.asarray(x), np.sqrt(2.0), rtol=1e-12)
    assert bool(converged)
    assert int(diag.iterations) >= 3          # sqrt(2) from 10 takes > 3
    assert float(diag.residual) <= 1.0e-28
    assert bool(diag.converged)

    # non-convergence is reported, not silent: zero iterations allowed
    _, conv2, diag2 = newton_solve(lambda x: x * x - 2.0, x0,
                                   tolerance=1.0e-30, max_iterations=2)
    assert int(diag2.iterations) == 2
    assert not bool(conv2) and not bool(diag2.converged)


def test_init_k_returns_diagnostics():
    eq = make_gaussian_density()
    st = make_ray_state(3, w=0.5, kx=0.25, ky=0.25, kz=0.15)
    st2, diag = init_k(st, disp.simple, eq, "kx", tolerance=1.0e-26,
                       return_diagnostics=True)
    assert int(diag.iterations) > 0
    assert bool(diag.converged)


def test_init_k_dtype_aware_default_tolerance(efit_file):
    """init_k's default tolerance is dtype-aware (solver.init_k
    docstring): the reference's 1e-30 is below f32 resolution, and
    the spent iterations can wander the Newton root to a
    neighbouring dispersion branch whose trajectory is singular.  The
    f32 default must land on the same root as an explicit
    dtype-resolvable tolerance."""
    from graph_framework_tpu.models import make_efit

    eq = make_efit(efit_file, dtype=jnp.float32)
    st = make_ray_state(4, w=500.0, x=2.5, y=0.0, z=0.0,
                        kx=-500.0, ky=150.0, kz=0.0, dtype=jnp.float32)
    auto = init_k(st, disp.cold_plasma, eq, "kx")
    explicit = init_k(st, disp.cold_plasma, eq, "kx", tolerance=1e-10)
    np.testing.assert_allclose(np.asarray(auto.kx),
                               np.asarray(explicit.kx), rtol=1e-6)
    # f64 keeps the reference default (root refined beyond f32)
    eq64 = make_efit(efit_file)
    st64 = jax.tree.map(lambda a: a.astype(jnp.float64), st)
    auto64 = init_k(st64, disp.cold_plasma, eq64, "kx")
    res = jnp.max(jnp.abs(
        __import__("graph_framework_tpu.models.rays",
                   fromlist=["residual_fn"]).residual_fn(
            disp.cold_plasma, eq64)(auto64)))
    assert float(res) < 1e-20


def test_trace_segmented_matches_trace():
    """Segment-buffered streaming (Solver.trace_segmented) delivers the
    exact rows of the device-resident trace, including an odd tail
    segment, traced extras, and the compensated carry."""
    eq = make_gaussian_density()
    st = make_ray_state(8, w=20.0, x=-2.0, kx=19.0)
    st = init_k(st, disp.simple, eq, "kx")

    for kwargs in (dict(), dict(compensated=True)):
        sol = Solver(disp.simple, eq, method="rk2", dt=1e-4, sub_steps=5,
                     **kwargs)
        _, traj = sol.trace(st, 7)
        res_raw = residual_fn(disp.simple, eq)

        rows = {}

        def writer(i, row):
            s, ex = row
            rows[i] = (s, ex["residual"])

        final = sol.trace_segmented(
            st, 7, writer, segment=3,
            extras=lambda s: {"residual": res_raw(s)})
        assert sorted(rows) == list(range(8))
        for i in range(8):
            s, r = rows[i]
            row_ref = jax.tree.map(lambda a: a[i], traj)
            for f in st._fields:
                np.testing.assert_allclose(
                    np.asarray(getattr(s, f)),
                    np.asarray(getattr(row_ref, f)), rtol=0, atol=0)
            np.testing.assert_allclose(
                r, np.asarray(res_raw(row_ref)), rtol=1e-12)
        np.testing.assert_array_equal(np.asarray(final.x),
                                      np.asarray(rows[7][0].x))

    # without extras the writer receives plain RayState rows
    sol = Solver(disp.simple, eq, method="rk4", dt=1e-4, sub_steps=2)
    _, traj = sol.trace(st, 4)
    got = {}
    sol.trace_segmented(st, 4, lambda i, s: got.update({i: s}), segment=4)
    for i in range(5):
        np.testing.assert_array_equal(
            np.asarray(got[i].x),
            np.asarray(jax.tree.map(lambda a: a[i], traj).x))
