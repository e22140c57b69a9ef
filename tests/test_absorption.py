"""Absorption pipeline tests: kamp updates, file round-trip, power binning."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graph_framework_tpu.models import dispersion as disp
from graph_framework_tpu.models.equilibrium import make_slab
from graph_framework_tpu.models.absorption import (
    make_weak_damping, make_root_finder, run_absorption, bin_power)
from graph_framework_tpu.models.rays import RayState
from graph_framework_tpu.solver import Solver, make_ray_state, init_k
from graph_framework_tpu.io.output import ResultFile, state_row


def _complex_state(n=4):
    """A propagating X-mode-ish state in the slab field."""
    st = make_ray_state(n, w=900.0, x=0.1, y=0.0, z=0.0,
                        kx=400.0, ky=0.0, kz=700.0, dtype=jnp.complex128)
    return st


def test_weak_damping_finite():
    eq = make_slab()
    st = _complex_state()
    kamp = make_weak_damping(eq)(st)
    k = np.asarray(kamp)
    assert k.shape == (4,)
    assert np.isfinite(k.real).all() and np.isfinite(k.imag).all()
    # kamp ~ |k| + small complex correction
    klen = np.sqrt(400.0 ** 2 + 700.0 ** 2)
    assert np.allclose(k.real, klen, rtol=0.2)


def test_root_finder_converges_to_hot_root():
    """After the Newton solve, D_hot(k + (kamp - |k|) khat) ~ 0."""
    eq = make_slab()
    st = _complex_state(2)
    kamp = make_root_finder(eq, tolerance=1e-24)(st)
    d_hot = disp.make_hot_plasma()
    pos = jnp.stack([st.x, st.y, st.z], axis=-1)
    kcov = jnp.stack([st.kx, st.ky, st.kz], axis=-1)
    kvec = kcov  # slab is cartesian
    klen = jnp.sqrt(jnp.sum(kvec * kvec, axis=-1))
    khat = kvec / klen[..., None]
    kshift = kvec + (kamp - klen)[..., None] * khat
    d = jax.vmap(d_hot, in_axes=(0, 0, 0, 0, None))(
        st.w, kshift, pos, st.t, eq)
    assert float(jnp.max(jnp.abs(d))) < 1e-10


def test_run_absorption_file_roundtrip(tmp_path):
    """Trace -> write file -> absorption appends kamp -> read back
    (the reference's 3-phase checkpoint-through-file flow,
    xrays.cpp:1083-1111)."""
    eq = make_slab()
    st = make_ray_state(3, w=900.0, x=0.1, kx=400.0, kz=700.0)
    st = init_k(st, disp.cold_plasma, eq, "kx", tolerance=1e-20)
    sol = Solver(disp.cold_plasma, eq, method="rk4", dt=1e-4, sub_steps=2)

    path = tmp_path / "result0.nc"
    with ResultFile(path, num_rays=3) as f:
        for name in ("time", "w", "x", "y", "z", "kx", "ky", "kz"):
            f.create_variable(name)
        sol.trace_streaming(st, 4, lambda i, s: f.write_step(
            i, state_row(s)))
        assert f.num_steps == 5

    with ResultFile(path, mode="r+") as f:
        run_absorption(f, eq, method="weak_damping")
        kamp = f.read_step(2, ["kamp"], complex_valued=True)["kamp"]
        assert kamp.shape == (3,)
        assert np.isfinite(kamp).all()


def test_bin_power_analytic():
    """Straight ray with constant Im(kamp): power_j = exp(-2 K v dt (j-1))."""
    nt, nr = 6, 2
    t = np.arange(nt)[:, None] * 0.1
    x = np.broadcast_to(t, (nt, nr)).copy()        # unit velocity in x
    y = np.zeros((nt, nr))
    z = np.zeros((nt, nr))
    K = 0.7
    kamp_im = np.full((nt, nr), K)
    power, d_power = bin_power(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(z), jnp.asarray(kamp_im))
    power = np.asarray(power)
    expect = np.ones(nt)
    for j in range(2, nt):
        expect[j] = np.exp(-2 * K * 0.1 * (j - 1))
    np.testing.assert_allclose(power[:, 0], expect, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(d_power)[2, 0],
                               expect[1] - expect[2], rtol=1e-12)


def test_bin_power_monotone_decay():
    rng = np.random.default_rng(0)
    nt, nr = 10, 5
    x = np.cumsum(rng.uniform(0.01, 0.1, (nt, nr)), axis=0)
    y = np.cumsum(rng.uniform(0.0, 0.05, (nt, nr)), axis=0)
    z = np.zeros((nt, nr))
    kamp_im = rng.uniform(0.0, 1.0, (nt, nr))
    power, _ = bin_power(*map(jnp.asarray, (x, y, z, kamp_im)))
    p = np.asarray(power)
    assert (np.diff(p[1:], axis=0) <= 1e-15).all()
    assert (p <= 1.0 + 1e-12).all()


def test_split_complex_weak_damping_matches_native():
    """The complex-free path (real-argument Z via Rybicki Dawson) must
    equal the native-complex weak damping, including nonzero Landau/
    cyclotron damping near resonance."""
    eq = make_slab()
    st_r = make_ray_state(4, w=600.0, x=0.0, kx=50.0, ky=0.0, kz=500.0)
    st_c = jax.tree.map(lambda a: a.astype(jnp.complex128), st_r)
    from graph_framework_tpu.models.absorption import make_weak_damping_split
    kc = np.asarray(make_weak_damping(eq)(st_c))
    kr, ki = make_weak_damping_split(eq)(st_r)
    got = np.asarray(kr) + 1j * np.asarray(ki)
    assert abs(kc[0].imag) > 0.1      # actually damped here
    np.testing.assert_allclose(got, kc, rtol=1e-12)


def test_dawson_rybicki():
    import scipy.special as sps
    from graph_framework_tpu.ops.special import dawson_real
    xs = np.linspace(-10, 10, 401)
    np.testing.assert_allclose(np.asarray(dawson_real(jnp.asarray(xs))),
                               sps.dawsn(xs), atol=1e-14)


def test_split_root_finder_matches_native():
    """The complex-free hot-plasma Newton root finder (Cplx arithmetic +
    Cauchy-Riemann jvp derivative) equals the native-complex path."""
    from graph_framework_tpu.models.absorption import make_root_finder_split
    eq = make_slab()
    st_r = make_ray_state(3, w=600.0, x=0.1, kx=50.0, ky=0.0, kz=500.0)
    st_c = jax.tree.map(lambda a: a.astype(jnp.complex128), st_r)
    native = np.asarray(make_root_finder(eq, tolerance=1e-24)(st_c))
    kr, ki = make_root_finder_split(eq, tolerance=1e-26,
                                    max_iterations=60)(st_r)
    got = np.asarray(kr) + 1j * np.asarray(ki)
    assert abs(native[0].imag) > 0.1
    np.testing.assert_allclose(got, native, rtol=1e-12)


def test_wofz_split_matches_scipy():
    import scipy.special as sps
    from graph_framework_tpu.ops.cplx import Cplx, wofz_split
    rng = np.random.default_rng(1)
    z = rng.uniform(-8, 8, 200) + 1j * rng.uniform(-5, 5, 200)
    w = wofz_split(Cplx(jnp.asarray(z.real), jnp.asarray(z.imag)))
    got = np.asarray(w.re) + 1j * np.asarray(w.im)
    err = np.abs(got - sps.wofz(z)) / np.abs(sps.wofz(z))
    assert err.max() < 1e-12


def test_weak_damping_vmec_finite(vmec_file):
    """Exercise the absorption path through the 3D VMEC equilibrium
    (non-cartesian basis: the covariant k-gradient maps through esup;
    absorption.hpp:408-412).  The reference never exercises this
    combination in its tests; capability check that it is finite and
    kamp ~ |k| here."""
    from graph_framework_tpu.models import make_vmec
    eq = make_vmec(vmec_file)
    # kz (toroidal covariant component) gives k a parallel component; a
    # purely-perpendicular launch makes zeta ~ 1e3 and the weak-damping
    # expansion meaningless (correction >> |k|).
    st = make_ray_state(3, w=900.0, x=0.5, y=0.5, z=0.0,
                        kx=500.0, ky=0.0, kz=300.0, dtype=jnp.complex128)
    st = init_k(st, disp.cold_plasma, eq, "kx", tolerance=1e-18)
    kamp = make_weak_damping(eq)(st)
    k = np.asarray(kamp)
    assert np.isfinite(k.real).all() and np.isfinite(k.imag).all()
    pos = jnp.stack([st.x, st.y, st.z], axis=-1)
    kcov = jnp.stack([st.kx, st.ky, st.kz], axis=-1)
    kvec = jax.vmap(eq.kvec)(kcov, pos)
    klen = np.sqrt(np.abs(np.sum(np.asarray(kvec) ** 2, axis=-1)))
    assert np.allclose(k.real, klen, rtol=0.3)


def test_split_root_finder_early_exit_and_diagnostics():
    """Convergence parity for the split root finder (VERDICT r2 item 4):
    tolerance is honored via the converge_item criteria (workflow.hpp:
    179-205) instead of a blind fixed-length scan, and NewtonDiagnostics
    surface the true iteration count.  At this state the solve converges
    in a handful of iterations - the old 200-iteration scan wasted 195."""
    from graph_framework_tpu.models.absorption import make_root_finder_split
    eq = make_slab()
    st_r = make_ray_state(3, w=600.0, x=0.1, kx=50.0, ky=0.0, kz=500.0)
    upd = make_root_finder_split(eq, tolerance=1e-24, max_iterations=200,
                                 return_diagnostics=True)
    (kr, ki), diag = upd(st_r)
    assert bool(diag.converged)
    assert float(diag.residual) <= 1e-24
    assert int(diag.iterations) <= 20          # early exit, not 200 trips
    # root unchanged by the new loop: still matches the native-complex path
    st_c = jax.tree.map(lambda a: a.astype(jnp.complex128), st_r)
    native = np.asarray(make_root_finder(eq, tolerance=1e-24)(st_c))
    got = np.asarray(kr) + 1j * np.asarray(ki)
    np.testing.assert_allclose(got, native, rtol=1e-12)


def test_split_root_finder_nonconvergence_surfaced():
    """An unreachable tolerance must be *reported* (converged=False at
    max_iterations with finite outputs), not silently returned as if
    converged - the converge_item's non-convergence report
    (workflow.hpp:184-204)."""
    from graph_framework_tpu.models.absorption import make_root_finder_split
    eq = make_slab()
    st_r = make_ray_state(2, w=600.0, x=0.1, kx=50.0, ky=0.0, kz=500.0)
    upd = make_root_finder_split(eq, tolerance=1e-60, max_iterations=50,
                                 return_diagnostics=True)
    (kr, ki), diag = upd(st_r)
    assert not bool(diag.converged)
    # the loop ends via stagnation (residual stops changing at the
    # machine-exact root) or the iteration cap - both are converge_item
    # exits (workflow.hpp:184-192); either way the unreachable tolerance
    # is REPORTED via converged=False
    assert 0 < int(diag.iterations) <= 50
    assert float(diag.residual) > 1e-60
    assert np.isfinite(np.asarray(kr)).all()
    assert np.isfinite(np.asarray(ki)).all()


def test_run_absorption_split_matches_native(tmp_path):
    """The split=True run_absorption path writes the same kamp as the
    native-complex path, at f32 tolerance."""
    import jax.numpy as jnp
    from graph_framework_tpu.io.output import ResultFile
    from graph_framework_tpu.models.absorption import run_absorption

    eq = make_slab()
    n, steps = 6, 3
    rng = np.random.default_rng(0)

    def write_trace(path):
        with ResultFile(path, num_rays=n) as f:
            for name in ("time", "w", "x", "y", "z", "kx", "ky", "kz"):
                f.create_variable(name)
            for i in range(steps):
                f.write_step(i, {
                    "time": np.full(n, i * 1e-4), "w": np.full(n, 600.0),
                    "x": np.full(n, 0.1) + 0.01 * i,
                    "y": np.zeros(n), "z": np.zeros(n),
                    "kx": np.full(n, 50.0), "ky": np.zeros(n),
                    "kz": np.full(n, 500.0)})
        return path

    p_native = write_trace(tmp_path / "native.nc")
    p_split = write_trace(tmp_path / "split.nc")
    with ResultFile(p_native, mode="r+") as f:
        run_absorption(f, eq, split=False)
        k_native = np.stack([
            f.read_step(i, ["kamp"], complex_valued=True)["kamp"]
            for i in range(steps)])
    with ResultFile(p_split, mode="r+") as f:
        run_absorption(f, eq, split=True)
        k_split = np.stack([
            f.read_step(i, ["kamp"], complex_valued=True)["kamp"]
            for i in range(steps)])
    np.testing.assert_allclose(k_split, k_native, rtol=1e-5, atol=1e-6)
