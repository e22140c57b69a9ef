"""Tests for the Boris pusher (xkorc) and the PIC demo (xpic)."""

import numpy as np
import jax
import jax.numpy as jnp

from graph_framework_tpu.models.korc import (
    ParticleState, initialize_gamma, make_boris_step, run_korc,
    Q_KORC, ME_KORC, C_KORC)
from graph_framework_tpu.models.equilibrium import make_slab_density
from graph_framework_tpu.models import pic


def test_initialize_gamma():
    st = ParticleState(
        x=jnp.zeros(2), y=jnp.zeros(2), z=jnp.zeros(2),
        ux=jnp.zeros(2), uy=jnp.full(2, 0.99), uz=jnp.full(2, 0.1),
        gamma=jnp.ones(2))
    st = initialize_gamma(st)
    g = 1.0 / np.sqrt(1 - (0.99 ** 2 + 0.1 ** 2))
    np.testing.assert_allclose(np.asarray(st.gamma), g, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(st.uy), g * 0.99, rtol=1e-12)


def test_boris_energy_conservation():
    """Pure magnetic field: gamma (energy) is exactly conserved by the
    Boris rotation; check to machine precision over many steps."""
    eq = make_slab_density()     # B = (0, 0, 1)
    st = ParticleState(
        x=jnp.asarray([1.7]), y=jnp.asarray([0.0]), z=jnp.asarray([0.0]),
        ux=jnp.asarray([0.3]), uy=jnp.asarray([0.4]), uz=jnp.asarray([0.1]),
        gamma=jnp.ones(1))
    st = initialize_gamma(st)
    g0 = float(st.gamma[0])
    step = make_boris_step(eq, b0=1.0, dt=0.3, larmor_radius=1.0)
    for _ in range(200):
        st = step(st)
    np.testing.assert_allclose(float(st.gamma[0]), g0, rtol=1e-12)


def test_boris_gyro_radius():
    """Uniform B = z-hat, u perpendicular: the orbit radius in units of the
    Larmor radius is |u_perp| (= gamma v/c); check the trajectory stays on
    that circle."""
    eq = make_slab_density()
    uperp = 0.5
    st = ParticleState(
        x=jnp.asarray([0.0]), y=jnp.asarray([0.0]), z=jnp.asarray([0.0]),
        ux=jnp.asarray([uperp]), uy=jnp.asarray([0.0]),
        uz=jnp.asarray([0.0]), gamma=jnp.ones(1))
    st = initialize_gamma(st)
    rl = 1.0
    # In these normalized units the orbit radius (in Larmor-radius units)
    # is |u| = gamma v/c after the gamma init.
    expected_r = float(st.ux[0])        # = gamma * 0.5
    step = make_boris_step(eq, b0=1.0, dt=0.05, larmor_radius=rl)
    xs, ys = [], []
    for _ in range(400):
        st = step(st)
        xs.append(float(st.x[0]))
        ys.append(float(st.y[0]))
    xs, ys = np.array(xs), np.array(ys)
    r_est = (xs.max() - xs.min()) / 2.0
    np.testing.assert_allclose(r_est, expected_r, rtol=0.02)


def test_run_korc_smoke(efit_file):
    from graph_framework_tpu.models import make_efit
    eq = make_efit(efit_file)
    st = run_korc(eq, num_particles=8, num_steps=50, dt=0.5)
    assert np.isfinite(np.asarray(st.x)).all()
    # particles stay near the device (no NaN blowup): R in [0.8, 2.6]
    r = np.hypot(np.asarray(st.x), np.asarray(st.y))
    assert (r > 0.5).all() and (r < 3.0).all()


def test_pic_deposit_matches_direct():
    """The blocked deposit equals the direct dense sum."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 0.25, 500), jnp.float64)
    num_grid = 64
    scale = 2.0 / (num_grid - 1)
    grid = -1.0 + scale * jnp.arange(num_grid, dtype=jnp.float64)
    n, e = pic.deposit(x, grid, scale, -1.0)
    dxm = np.asarray(x)[None, :] - np.asarray(grid)[:, None]
    n_direct = np.exp(-dxm ** 2 / 1e-4).sum(axis=1)
    e_direct = (2.0 * dxm / 1e-4).sum(axis=1)
    np.testing.assert_allclose(np.asarray(n), n_direct, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(e), e_direct, rtol=1e-10)


def test_pic_run_smoke():
    # The reference's per-pair E model is linear in distance, making the
    # demo an explosive expansion; keep dt tiny and steps few for a finite
    # smoke check (xpic.cpp is likewise untested upstream).
    st = pic.run_pic(num_particles=2000, num_grid=64, num_steps=3,
                     dt=1e-9, dtype=jnp.float64)
    assert np.isfinite(np.asarray(st.x)).all()
    assert np.isfinite(np.asarray(st.epara)).all()
    assert float(jnp.max(st.n)) > 0


def test_boris_chunked_scan_matches_step_loop():
    """The korc bench's chunked lax.scan push (the plain XLA path that
    replaced the multi-step kernel) equals the eager step loop."""
    from graph_framework_tpu.models.equilibrium import make_slab
    eq = make_slab()
    rng = np.random.default_rng(5)
    n = 64
    st = initialize_gamma(ParticleState(
        x=jnp.asarray(1.7 + 0.01 * rng.standard_normal(n)),
        y=jnp.zeros(n), z=jnp.zeros(n), ux=jnp.zeros(n),
        uy=jnp.full(n, 0.99), uz=jnp.full(n, 0.1), gamma=jnp.ones(n)))
    step = make_boris_step(eq, float(eq.characteristic_field()), 0.5, 1.0)

    @jax.jit
    def chunk(s):
        return jax.lax.scan(lambda c, _: (step(c), None), s, None,
                            length=10)[0]

    loop = st
    for _ in range(20):
        loop = step(loop)
    scanned = chunk(chunk(st))
    for f in ParticleState._fields:
        np.testing.assert_allclose(np.asarray(getattr(scanned, f)),
                                   np.asarray(getattr(loop, f)),
                                   rtol=1e-12, atol=1e-12)


def test_make_deposit_is_the_dense_deposit():
    """make_deposit builds the dense XLA deposit over its own grid."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(0, 0.25, 300), jnp.float64)
    num_grid = 32
    scale = 2.0 / (num_grid - 1)
    dep = pic.make_deposit(num_grid, scale, -1.0, jnp.float64)
    grid = -1.0 + scale * jnp.arange(num_grid, dtype=jnp.float64)
    n, e = dep(x)
    n_ref, e_ref = pic.deposit(x, grid, scale, -1.0)
    np.testing.assert_allclose(np.asarray(n), np.asarray(n_ref), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(e), np.asarray(e_ref), rtol=1e-14)
