"""Reference-parity golden suite (VERDICT r1 item 1).

Every fixture in ``tests/fixtures/golden_config*.npz`` was generated by
``tools/golden_reference.py`` - an INDEPENDENT referee implementation of
the same published physics (scipy DOP853 at rtol 1e-12, Richardson finite
differences instead of autodiff, raw global-coordinate spline polynomials
instead of the framework's cell-local gathers, scipy wofz instead of the
Weideman Faddeeva).  Agreement therefore cross-validates, at once:

  * the jax.grad-assembled ray equations (models/rays.py) against the
    reference's symbolic form (dispersion.hpp:1392-1433),
  * the Newton init-k solve (solver.init_k <- solver.hpp:252-298),
  * the scan-based RK4 integrator (ops/integrators.py <- solver.hpp:676),
  * the cell-local EFIT bicubic path (models/efit.py <- equilibrium.hpp:
    1278-1382) including the reference's documented quirks,
  * reverse-mode endpoint gradients (the BASELINE.md north-star
    "gradient allclose" target) against full-re-integration central FD,
  * the weak-damping kamp update (models/absorption.py <-
    absorption.hpp:328-484) with its Z function.

Test pattern mirrors the reference's golden-file tests
(graph_tests/efit_test.cpp:23-60, solver_test.cpp:104-116): load fixture,
re-run, assert allclose at per-quantity tolerances.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_framework_tpu.models import make_efit, dispersion as disp
from graph_framework_tpu.models.vmec import make_vmec
from graph_framework_tpu.models.equilibrium import (
    make_slab_density, make_gaussian_density)
from graph_framework_tpu.solver import Solver, make_ray_state, init_k

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
EFIT_FILE = "/root/reference/graph_tests/efit.nc"
VMEC_FILE = "/root/reference/graph_tests/vmec.nc"

# name -> (dispersion fn, equilibrium factory, substep dt)
CONFIGS = {
    "golden_config1_omode_slab": (
        disp.ordinary_wave, make_slab_density, 1.0e-3),
    "golden_config2_xmode_slab": (
        disp.extra_ordinary_wave, make_slab_density, 1.0e-3),
    "golden_config2_bohm_gross": (
        disp.bohm_gross, make_gaussian_density, 2.5e-4),
    "golden_config3_efit": (
        disp.cold_plasma, lambda: make_efit(EFIT_FILE), 2.5e-4),
    # config 4: VMEC stellarator, integrated in flux coordinates with the
    # canonical generalized-coordinate ray equations; the referee's
    # D_cold_flux wrapper is the same published Hamiltonian form evaluated
    # through doubly-nested finite differences (basis vectors inside the
    # ray-equation stencils) over raw global-coordinate mode splines.
    "golden_config4_vmec": (
        disp.cold_plasma, lambda: make_vmec(VMEC_FILE), 2.0e-6),
}

K_NAMES = ("kx", "ky", "kz")


def load(name):
    path = FIXTURES / f"{name}.npz"
    if not path.exists():
        pytest.skip(f"fixture {name} not generated "
                    "(run tools/golden_reference.py)")
    return dict(np.load(path))


def _solver_for(name, gold):
    d, make_eq, dt = CONFIGS[name]
    eq = make_eq()
    t_final = float(gold["t_record"][-1])
    n_rec = len(gold["t_record"]) - 1
    interval = t_final / n_rec
    sub = int(round(interval / dt))
    assert abs(sub * dt - interval) < 1e-12 * max(1.0, interval)
    sol = Solver(d, eq, method="rk4", dt=dt, sub_steps=sub)
    return sol, eq, n_rec


def _launch_state(gold, eq, k):
    p = gold["p_launch"]
    n = p.shape[0]
    return make_ray_state(
        n, w=float(gold["w"]),
        x=jnp.asarray(p[:, 0]), y=jnp.asarray(p[:, 1]),
        z=jnp.asarray(p[:, 2]),
        kx=jnp.asarray(k[:, 0]), ky=jnp.asarray(k[:, 1]),
        kz=jnp.asarray(k[:, 2]), dtype=jnp.float64)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_newton_init_k_matches_referee(name):
    """init_k reproduces scipy.optimize-style FD-Newton roots (referee
    newton_k) on the same guesses - same root to ~1e-9 relative."""
    gold = load(name)
    _, eq, _ = _solver_for(name, gold)
    d = CONFIGS[name][0]
    st = _launch_state(gold, eq, gold["k_guess"])
    which = K_NAMES[int(gold["which"])]
    st = init_k(st, d, eq, which, tolerance=1.0e-24, max_iterations=100)
    ours = np.stack([np.asarray(st.kx), np.asarray(st.ky),
                     np.asarray(st.kz)], axis=1)
    # The spline-field referees solve through (doubly-)nested FD (field
    # derivatives inside the Newton derivative), flooring their root
    # precision around 1e-8 relative (config 3: 2.3e-8 measured,
    # config 4: 3.2e-9); the analytic referees resolve to 1e-9.
    rtol = 1e-9 if name.startswith(("golden_config1",
                                    "golden_config2")) else 5e-8
    np.testing.assert_allclose(ours, gold["k_init"], rtol=rtol, atol=1e-9)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trajectory_matches_referee(name):
    """Full recorded trajectories (positions AND wave numbers) match the
    referee's DOP853(rtol=1e-12)+FD integration of the same rays.

    Tolerance: the referee's RHS carries ~1e-10 relative FD-derivative
    error which accumulates linearly in time; 1e-6 relative with a
    k-scaled absolute floor holds with two orders of margin in practice."""
    gold = load(name)
    sol, eq, n_rec = _solver_for(name, gold)
    st = _launch_state(gold, eq, gold["k_init"])
    _, traj = sol.trace(st, n_rec)

    ours = np.stack([
        np.asarray(traj.x), np.asarray(traj.y), np.asarray(traj.z),
        np.asarray(traj.kx), np.asarray(traj.ky), np.asarray(traj.kz),
    ], axis=-1).transpose(1, 0, 2)          # (n_rays, n_rec+1, 6)

    k_scale = float(np.abs(gold["k_init"]).max())
    # k floor 2e-8 * scale: the referee's own Richardson-certified
    # integration error (~2.4e-6 absolute on k ~ 355 for config 3) plus
    # the framework's truncation land within 1.4e-8 relative of each
    # other; positions agree to ~1e-8 absolute.
    np.testing.assert_allclose(ours[..., :3], gold["traj"][..., :3],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ours[..., 3:], gold["traj"][..., 3:],
                               rtol=1e-6, atol=2e-8 * k_scale)


def _endpoint_fn(name, gold):
    """endpoint(w, p0, k0) -> (3,) via the framework, differentiable.

    Integrates to the fixture's gradient horizon ``t_grad`` (may be
    shorter than the trajectory horizon - see tools/golden_reference.py
    gen_analytic_config)."""
    d, make_eq, dt = CONFIGS[name]
    eq = make_eq()
    t_grad = float(gold.get("t_grad", gold["t_record"][-1]))
    sub = int(round(t_grad / dt))
    assert abs(sub * dt - t_grad) < 1e-12 * max(1.0, t_grad)
    sol = Solver(d, eq, method="rk4", dt=dt, sub_steps=sub)

    def endpoint(w, p0, k0):
        st = make_ray_state(
            1, w=w, x=p0[0], y=p0[1], z=p0[2],
            kx=k0[0], ky=k0[1], kz=k0[2], dtype=jnp.float64)
        fin = sol.run(st, 1)
        return jnp.stack([fin.x[0], fin.y[0], fin.z[0]])

    return endpoint


@pytest.mark.parametrize("name,key", [
    ("golden_config1_omode_slab", "grad_k_0"),
    ("golden_config1_omode_slab", "grad_p_0"),
    ("golden_config1_omode_slab", "grad_w"),
    ("golden_config2_xmode_slab", "grad_k_0"),
    ("golden_config2_bohm_gross", "grad_k_0"),
    ("golden_config3_efit", "grad_k_0"),
    ("golden_config3_efit", "grad_p_2"),
    ("golden_config4_vmec", "grad_k_0"),
    ("golden_config4_vmec", "grad_p_0"),
])
def test_endpoint_gradients_match_referee(name, key):
    """Reverse-mode d(endpoint xyz)/d(launch param) through the whole scan
    matches the referee's central FD over full re-integrations (the
    BASELINE.md 'gradient allclose vs reference' target).

    FD truncation is O(h^2 f''') - trajectories are mildly nonlinear in
    their launch parameters, so 1e-4 relative is the referee's own
    accuracy floor, not the framework's.  For the spline-field configs
    (3, 4) the floor is higher: the FD signal g*h sits ~1e3x above the
    integrators' Richardson-certified endpoint error, so components are
    resolved to ~0.2% of the gradient scale."""
    gold = load(name)
    if key not in gold:
        pytest.skip(f"{name} has no {key}")
    endpoint = _endpoint_fn(name, gold)
    w0 = jnp.float64(gold["w"])
    p0 = jnp.asarray(gold["p_launch"][0])
    k0 = jnp.asarray(gold["k_init"][0])

    if key == "grad_w":
        grad = jax.jacrev(endpoint, argnums=0)(w0, p0, k0)
        ours = np.asarray(grad)
    elif key.startswith("grad_p"):
        i = int(key.split("_")[-1])
        jac = jax.jacrev(endpoint, argnums=1)(w0, p0, k0)
        ours = np.asarray(jac)[:, i]
    else:
        i = int(key.split("_")[-1])
        jac = jax.jacrev(endpoint, argnums=2)(w0, p0, k0)
        ours = np.asarray(jac)[:, i]

    scale = float(np.abs(gold[key]).max())
    spline_cfg = not name.startswith(("golden_config1", "golden_config2"))
    rtol = 2e-3 if spline_cfg else 2e-4
    np.testing.assert_allclose(ours, gold[key], rtol=rtol,
                               atol=rtol * scale)


def test_weak_damping_kamp_matches_referee():
    """Weak-damping kamp (real and imaginary parts) along an EFIT ray
    matches the referee's wofz-based evaluation with FD cold-plasma
    derivatives (absorption.hpp:328-484 semantics)."""
    gold = load("golden_kamp_efit")
    from graph_framework_tpu.models.absorption import make_weak_damping_split
    eq = make_efit(EFIT_FILE)
    update = jax.jit(make_weak_damping_split(eq))

    p, k = gold["p"], gold["k"]
    n = p.shape[0]
    st = make_ray_state(
        n, w=float(gold["w"]),
        x=jnp.asarray(p[:, 0]), y=jnp.asarray(p[:, 1]),
        z=jnp.asarray(p[:, 2]),
        kx=jnp.asarray(k[:, 0]), ky=jnp.asarray(k[:, 1]),
        kz=jnp.asarray(k[:, 2]), dtype=jnp.float64)
    re, im = update(st)
    np.testing.assert_allclose(np.asarray(re), gold["kamp_re"],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(im), gold["kamp_im"],
                               rtol=1e-5)


def test_root_finder_kamp_matches_referee():
    """Complex-Newton kamp roots of the FULL hot-plasma D (split-complex
    path, absorption.hpp:145-317) match the referee's wofz-based
    complex Newton from the same a = 0 start."""
    gold = load("golden_rootfind_efit")
    from graph_framework_tpu.models.absorption import make_root_finder_split
    eq = make_efit(EFIT_FILE)
    update = jax.jit(make_root_finder_split(eq, tolerance=1e-26,
                                            max_iterations=80))

    p, k = gold["p"], gold["k"]
    n = p.shape[0]
    st = make_ray_state(
        n, w=float(gold["w"]),
        x=jnp.asarray(p[:, 0]), y=jnp.asarray(p[:, 1]),
        z=jnp.asarray(p[:, 2]),
        kx=jnp.asarray(k[:, 0]), ky=jnp.asarray(k[:, 1]),
        kz=jnp.asarray(k[:, 2]), dtype=jnp.float64)
    re, im = update(st)
    k_scale = float(np.abs(gold["kamp_re"]).max())
    np.testing.assert_allclose(np.asarray(re), gold["kamp_re"], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(im), gold["kamp_im"],
                               rtol=1e-5, atol=1e-10 * k_scale)


def test_adaptive_rk4_matches_referee():
    """adaptive_rk4 referee parity (VERDICT r3 weak 9; solver.hpp:881-
    1006) on the stiff system the scheme is built for - the one
    configuration where D drifts fast enough that the reference's
    (dt, lambda) coordinate-Newton (newton.hpp:42-47) has a well-defined
    target.  The referee is ANALYTIC: D = (1e3 (x - e^-t) - e^-t) kx + w
    gives dx/dt = 1001 e^-t - 1000 x, dkx/dt = 1000 kx in closed form.

    Parity contract: every state the adaptive integrator produces lies ON
    the referee trajectory at its ACHIEVED time (the integrator adapts
    dt per ray, so fixed record times don't exist), and the first step
    visibly adapts dt away from the configured value.

    Documented scheme property (replicated faithfully, not fixed): the
    persisted (dt, lambda) pair drives dt toward zero after the first
    few steps - the loss root 1/dt = -lambda D^2 collapses as lambda
    grows - so long traces STALL rather than drift off the trajectory;
    states remain referee-consistent throughout.  On residual-conserving
    dispersions the same reference math diverges instead (lambda <-
    lambda - loss/D^2 with D^2 ~ 0), see
    test_adaptive_scheme_domain_boundary."""
    gold = load("golden_adaptive_stiff")
    from graph_framework_tpu.models.equilibrium import make_no_magnetic_field
    eq = make_no_magnetic_field()
    ts_ref = gold["t_record"]
    traj_ref = gold["traj"][0]
    st = make_ray_state(1, w=float(gold["w"]), x=1.0, kx=1.0,
                        dtype=jnp.float64)
    sol = Solver(disp.stiff, eq, method="adaptive_rk4", dt=1.0e-4,
                 sub_steps=1)
    step = sol.carry_step_fn()
    carry = sol.init_carry(st)
    first_dt = None
    for i in range(10):
        carry = step(carry)
        if first_dt is None:
            first_dt = float(carry.dt[0])
        s = sol.carry_state(carry)
        t = float(s.t[0])
        assert t < float(ts_ref[-1])
        x_ref = float(np.interp(t, ts_ref, traj_ref[:, 0]))
        k_ref = float(np.interp(t, ts_ref, traj_ref[:, 3]))
        np.testing.assert_allclose(float(s.x[0]), x_ref, atol=5e-8)
        np.testing.assert_allclose(float(s.kx[0]), k_ref, rtol=1e-5)
    # the first step adapted dt away from the configured scalar
    assert abs(first_dt - 1.0e-4) > 1.0e-6


def test_adaptive_scheme_domain_boundary():
    """The reference's adaptive (dt, lambda) coordinate-Newton
    (newton.hpp:42-47, solver.hpp:946-972) is only well-posed when the
    post-step dispersion residual drifts; on a residual-CONSERVING
    dispersion (O-mode slab: rk4 preserves D to ~1e-12) the lambda
    update lambda <- lambda - loss/D^2 blows up and dt leaves the
    physical domain.  Replicated faithfully and documented: this test
    pins the failure mode so a future 'fix' that silently changes the
    scheme gets noticed, and the dense referee fixture doubles as an
    any-time validation of the fixed-step RK4 path."""
    gold = load("golden_adaptive_omode_slab")
    eq = make_slab_density()
    st = _launch_state(gold, eq, gold["k_init"])
    sol = Solver(disp.ordinary_wave, eq, method="adaptive_rk4",
                 dt=1.0e-3, sub_steps=1)
    carry = sol.init_carry(st)
    carry = sol.carry_step_fn()(carry)
    assert float(np.min(np.asarray(carry.dt))) < 0.0  # left the domain

    # the SAME fixture validates fixed-step rk4 at arbitrary record
    # times (dense DOP853 rtol 1e-12 referee): integrate 40 steps and
    # compare at the exact landed times.
    ts_ref = gold["t_record"]
    traj_ref = gold["traj"]
    sol4 = Solver(disp.ordinary_wave, eq, method="rk4", dt=1.0e-3,
                  sub_steps=10)
    s = st
    step = sol4.step_fn()
    for _ in range(8):
        s = step(s)
    t = float(s.t[0])
    for r in range(traj_ref.shape[0]):
        x_ref = np.array([np.interp(t, ts_ref, traj_ref[r][:, c])
                          for c in range(6)])
        ours = np.array([float(a[r]) for a in
                         (s.x, s.y, s.z, s.kx, s.ky, s.kz)])
        scale = np.maximum(np.abs(x_ref), 1.0)
        np.testing.assert_allclose(ours / scale, x_ref / scale,
                                   rtol=0, atol=1e-6)
