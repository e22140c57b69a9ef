"""Roundtrip tests for the spline-file generator (tools/make_splines.py).

The reference produces its EFIT input files with Mathematica notebooks
(utilities/BiCubicSplines.nb); these tests check that the numpy generator
fits splines whose evaluation through the *production loader + evaluators*
(make_efit -> eval_bicubic_2d / eval_cubic_1d) reproduces the sampled
analytic fields to spline accuracy.
"""

import numpy as np
import jax.numpy as jnp

from graph_framework_tpu.models.efit import make_efit
from graph_framework_tpu.ops.spline import eval_cubic_1d
from graph_framework_tpu.tools import (
    cubic_spline_coeffs, bicubic_spline_coeffs, write_efit_file)


def test_cubic_1d_interpolates_samples_and_converges():
    x = np.linspace(0.0, 2.0 * np.pi, 41)
    y = np.sin(x)
    c = cubic_spline_coeffs(y)                    # global-coordinate tables
    tabs = jnp.asarray(np.ascontiguousarray(c.T))  # (ncells, 4) cell-major
    dx = x[1] - x[0]
    # exact at the knots
    at_knots = eval_cubic_1d(tabs, jnp.asarray(x[:-1]), dx, x[0])
    np.testing.assert_allclose(np.asarray(at_knots), y[:-1], atol=1e-12)
    # interior accuracy between knots ~ h^4
    fine = np.linspace(x[3], x[-4], 301)
    vals = eval_cubic_1d(tabs, jnp.asarray(fine), dx, x[0])
    assert np.max(np.abs(np.asarray(vals) - np.sin(fine))) < 5e-5


def test_bicubic_2d_interpolates_samples():
    r = np.linspace(1.0, 2.0, 33)
    z = np.linspace(-0.5, 0.5, 33)
    f = np.sin(2.0 * r)[:, None] * np.cos(3.0 * z)[None, :]
    c = bicubic_spline_coeffs(f)                  # (4, 4, nr-1, nz-1)
    # evaluate cell (i, j) at its lower-left knot in global coordinates
    # u = i, v = j: value must equal the sample (longdouble rebase check)
    i, j = 5, 7
    u, v = float(i), float(j)
    val = sum(c[a, b, i, j] * u ** a * v ** b
              for a in range(4) for b in range(4))
    np.testing.assert_allclose(val, f[i, j], rtol=1e-10)


def test_efit_file_roundtrip(tmp_path):
    r = np.linspace(1.0, 2.4, 57)
    z = np.linspace(-0.7, 0.7, 57)
    # smooth tokamak-ish flux surface map
    psi = ((r[:, None] - 1.7) ** 2 / 0.49
           + (z[None, :] ** 2) / 0.25
           + 0.05 * np.sin(3.0 * r)[:, None] * np.cos(2.0 * z)[None, :])
    pgrid = np.linspace(psi.min(), psi.max() + 0.1, 65)
    ne = 1.0e19 * (1.0 - 0.8 * (pgrid - pgrid[0]) / np.ptp(pgrid))
    te = 2.0e3 * (1.0 - 0.9 * (pgrid - pgrid[0]) / np.ptp(pgrid)) ** 2
    pres = 1.60218e-19 * ne * te * 2.5
    fpol = 3.4 + 0.1 * np.sin(pgrid)

    path = tmp_path / "gen_efit.nc"
    write_efit_file(path, r=r, z=z, psi=psi, psi_profile=pgrid,
                    ne=ne, te=te, pressure=pres, fpol=fpol)

    eq = make_efit(str(path))                     # production loader

    # psi surface through the production bicubic evaluator (interior)
    rt = np.linspace(r[4], r[-5], 40)
    zt = np.linspace(z[4], z[-5], 40)
    got = np.asarray(eq.psi_rz(jnp.asarray(rt), jnp.asarray(zt)))
    want = ((rt - 1.7) ** 2 / 0.49 + zt ** 2 / 0.25
            + 0.05 * np.sin(3.0 * rt) * np.cos(2.0 * zt))
    np.testing.assert_allclose(got, want, atol=5e-5)

    # profiles roundtrip at their knots (note the loader's reference-quirk
    # default copies te_c0/c1 into ne; disable for a clean roundtrip)
    eq_clean = make_efit(str(path), replicate_reference_quirks=False)
    pos = jnp.stack([jnp.asarray(rt), jnp.zeros(40), jnp.asarray(zt)])
    psi_here = np.asarray(eq_clean.psi(pos))
    ne_got = np.asarray(eq_clean.electron_density(pos))
    ne_want = np.interp(psi_here, pgrid, ne)      # linear ref; loose tol
    np.testing.assert_allclose(ne_got, ne_want, rtol=2e-3)

    # B field is finite and divergence behaves: spot check values
    b = np.asarray(eq.magnetic_field(pos))
    assert np.all(np.isfinite(b))
    # toroidal component ~ fpol / r
    fpol_here = np.interp(psi_here, pgrid, fpol)
    bphi_mag = np.abs(b[0] * (-np.sin(0.0)) + b[1] * np.cos(0.0))
    np.testing.assert_allclose(bphi_mag, fpol_here / rt, rtol=2e-3)


def test_vmec_file_roundtrip(tmp_path):
    from graph_framework_tpu.models.vmec import make_vmec
    from graph_framework_tpu.tools import write_vmec_file

    ns = 21
    s_full = np.linspace(0.0, 1.0, ns)
    ds = s_full[1] - s_full[0]
    s_half = s_full - ds / 2.0
    # linear-in-s mode profiles: natural cubic splines reproduce them
    # exactly, so the roundtrip check is exact up to float64
    xm = np.array([0.0, 1.0])
    xn = np.array([0.0, 0.0])
    rmnc = np.stack([np.full(ns, 3.0), 0.5 * s_full])
    zmns = np.stack([np.zeros(ns), 0.4 * s_full])
    lmns = np.stack([np.zeros(ns), 0.1 * s_half])
    chi = 0.7 * s_full                           # linear flux profile

    path = tmp_path / "gen_vmec.nc"
    write_vmec_file(path, s_full=s_full, s_half=s_half, chi=chi,
                    rmnc=rmnc, zmns=zmns, lmns=lmns, xm=xm, xn=xn,
                    signj=-1.0, dphi=0.9)

    eq = make_vmec(str(path))                    # production loader

    s, u, v = 0.4, 0.9, 0.3
    r, z, l = eq._rzl(jnp.asarray(s), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(float(r), 3.0 + 0.5 * s * np.cos(u),
                               rtol=1e-12)
    np.testing.assert_allclose(float(z), 0.4 * s * np.sin(u), rtol=1e-12)
    np.testing.assert_allclose(float(l), 0.1 * s * np.sin(u), rtol=1e-10)

    pos = jnp.asarray([s, u, v])
    b = np.asarray(eq.magnetic_field(pos))
    assert np.all(np.isfinite(b))
    # dchi/ds through the loaded spline equals the linear slope
    np.testing.assert_allclose(
        float(eq.chi(jnp.asarray(0.6))) - float(eq.chi(jnp.asarray(0.2))),
        0.7 * 0.4, rtol=1e-10)


def test_make_efit_from_mapping_equals_from_file(tmp_path):
    from graph_framework_tpu.tools.make_splines import (
        tokamak_tables, write_tables)
    tables = tokamak_tables(seed=3, nr=17, nz=17, npsi=17)
    path = write_tables(tmp_path / "efit.nc", tables)
    a, b = make_efit(tables), make_efit(str(path))
    for f in ("psi_coeffs", "profile_coeffs", "ne_coeffs", "fpol_coeffs"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    assert (a.rmin, a.dr, a.psimin, a.ne_scale) == \
        (b.rmin, b.dr, b.psimin, b.ne_scale)


def test_make_vmec_from_mapping_equals_from_file(tmp_path):
    from graph_framework_tpu.models.vmec import make_vmec
    from graph_framework_tpu.tools.make_splines import (
        vmec_tables, write_tables)
    ns = 11
    s_full = np.linspace(0.0, 1.0, ns)
    s_half = s_full - 0.05
    tables = vmec_tables(
        s_full=s_full, s_half=s_half, chi=0.7 * s_full,
        rmnc=np.stack([np.full(ns, 3.0), 0.5 * s_full]),
        zmns=np.stack([np.zeros(ns), 0.4 * s_full]),
        lmns=np.stack([np.zeros(ns), 0.1 * s_half]),
        xm=np.array([0.0, 1.0]), xn=np.array([0.0, 0.0]),
        signj=-1.0, dphi=0.9)
    path = write_tables(tmp_path / "vmec.nc", tables)
    a, b = make_vmec(tables), make_vmec(str(path))
    for f in ("chi_coeffs", "rmnc_coeffs", "zmns_coeffs", "lmns_coeffs"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    assert (a.ds, a.sminf, a.signj) == (b.ds, b.sminf, b.signj)


def test_generated_tokamak_keeps_the_smoke_launch_in_domain():
    """The chip_smoke.py launch (w=650 from R=2.0 m, Newton kx) on the
    generated equilibrium: rays stay finite and inside the psi table over
    10 x 10 substeps, and the bench launch (R=2.5 m) starts in near
    vacuum (n^2 = 1, so kx solves to -sqrt(500^2 - 150^2))."""
    import jax
    from graph_framework_tpu.models.dispersion import cold_plasma
    from graph_framework_tpu.solver import Solver, init_k, make_ray_state
    from graph_framework_tpu.tools.make_splines import tokamak_tables

    eq = make_efit(tokamak_tables())
    assert eq.psi_coeffs.shape[:2] == (64, 64)
    rng = np.random.default_rng(0)
    st = init_k(make_ray_state(
        32, w=650.0, x=2.0 + 0.01 * rng.standard_normal(32), y=0.0,
        z=0.02 * rng.standard_normal(32), kx=-400.0,
        ky=150.0 + 2.0 * rng.standard_normal(32), kz=0.0),
        cold_plasma, eq, "kx")
    out = Solver(cold_plasma, eq, method="rk4", dt=1e-4,
                 sub_steps=10).run(st, 10)
    assert bool(jax.numpy.all(eq.in_domain(out.x, out.y, out.z)))
    assert np.isfinite(np.asarray(out.kx)).all()
    vac = init_k(make_ray_state(1, w=500.0, x=2.5, kx=-500.0, ky=150.0),
                 cold_plasma, eq, "kx")
    np.testing.assert_allclose(float(vac.kx[0]),
                               -np.sqrt(500.0 ** 2 - 150.0 ** 2), rtol=2e-3)
