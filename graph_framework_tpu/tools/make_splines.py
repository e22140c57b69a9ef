"""Generate spline-coefficient equilibrium files from raw grid samples.

The reference's EFIT input files (equilibrium.hpp:84-115) are produced by
Mathematica notebooks (utilities/BiCubicSplines.nb): natural cubic splines of
the 1D profiles and a tensor-product bicubic of psi(R, Z), stored as per-cell
polynomial coefficients **in the global normalized coordinate**
u = (x - offset)/scale (the format ``build_1D_spline`` evaluates,
equilibrium.hpp:1120-1131).  This module is the pure-numpy replacement: feed
it raw uniform-grid samples, get a file ``models.efit.make_efit`` loads.

The bicubic construction mirrors the evaluation structure the reference
documents ("four 1D splines in z combined cubically in r",
equilibrium.hpp:1278-1313): spline each grid row in z, then spline each of
the four z-coefficient fields in r.

All coefficient algebra runs in ``np.longdouble``: the local->global
monomial rebase is ill-conditioned at large cell indices (see
ops.spline.rebase_cells_1d, which performs the inverse rebase at load time),
so extended precision keeps the written tables faithful to the fitted
splines.
"""

from __future__ import annotations

import math

import numpy as np


def _natural_spline_local(y, axis=0):
    """Natural cubic spline of uniformly-spaced samples, cell-local form.

    ``y``: samples along ``axis`` (n points -> n-1 cells).  Returns an array
    with a new leading axis of size 4: coefficients (c0, c1, c2, c3) of
    c0 + c1 t + c2 t^2 + c3 t^3 with t in [0, 1] the in-cell coordinate.
    Second derivatives solve the standard tridiagonal system with natural
    boundary conditions (M_0 = M_{n-1} = 0).
    """
    y = np.moveaxis(np.asarray(y, dtype=np.longdouble), axis, 0)
    n = y.shape[0]
    if n < 2:
        raise ValueError("need at least 2 samples")
    m = np.zeros_like(y)
    if n > 2:
        # tridiagonal [1, 4, 1] m_inner = 6 * second difference
        rhs = 6.0 * (y[2:] - 2.0 * y[1:-1] + y[:-2])
        k = n - 2
        diag = np.full(k, 4.0, dtype=np.longdouble)
        lower = np.ones(k - 1, dtype=np.longdouble)
        upper = np.ones(k - 1, dtype=np.longdouble)
        # Thomas algorithm (vectorized over trailing dims)
        cp = np.zeros(k, dtype=np.longdouble)
        dp = np.zeros((k,) + y.shape[1:], dtype=np.longdouble)
        cp[0] = upper[0] / diag[0] if k > 1 else 0.0
        dp[0] = rhs[0] / diag[0]
        for i in range(1, k):
            denom = diag[i] - lower[i - 1] * cp[i - 1]
            if i < k - 1:
                cp[i] = upper[i] / denom
            dp[i] = (rhs[i] - lower[i - 1] * dp[i - 1]) / denom
        sol = np.zeros_like(dp)
        sol[-1] = dp[-1]
        for i in range(k - 2, -1, -1):
            sol[i] = dp[i] - cp[i] * sol[i + 1]
        m[1:-1] = sol
    c0 = y[:-1]
    c1 = (y[1:] - y[:-1]) - (2.0 * m[:-1] + m[1:]) / 6.0
    c2 = m[:-1] / 2.0
    c3 = (m[1:] - m[:-1]) / 6.0
    out = np.stack([c0, c1, c2, c3])              # (4, n-1, ...)
    return np.moveaxis(out, 1, axis + 1)


def _local_to_global_1d(coeffs):
    """Rebase (4, ncells, ...) cell-local coefficients to the global
    normalized coordinate u = t + i (the file format; inverse of
    ops.spline.rebase_cells_1d)."""
    c = np.asarray(coeffs, dtype=np.longdouble)
    ncells = c.shape[1]
    cells = np.arange(ncells, dtype=np.longdouble)
    cells = cells.reshape((ncells,) + (1,) * (c.ndim - 2))
    out = np.zeros_like(c)
    # c_k t^k = c_k (u - i)^k = sum_{a<=k} C(k,a) c_k (-i)^(k-a) u^a
    for k in range(4):
        for a in range(k + 1):
            out[a] += math.comb(k, a) * c[k] * (-cells) ** (k - a)
    return out


def cubic_spline_coeffs(y, *, local=False):
    """Natural cubic spline coefficients of 1D uniform-grid samples.

    Returns (4, n-1) float64: tables c0..c3 in the file's global normalized
    coordinate (or cell-local when ``local=True``), ready to write as
    ``<name>_c0..3`` and load with ``eval_cubic_1d`` / ``spline_1d``.
    """
    c = _natural_spline_local(y, axis=0)
    if not local:
        c = _local_to_global_1d(c)
    return c.astype(np.float64)


def bicubic_spline_coeffs(f, *, local=False):
    """Tensor-product bicubic coefficients of 2D uniform-grid samples.

    ``f``: (nr, nz) samples.  Returns (4, 4, nr-1, nz-1) float64 indexed
    [a, b, i, j] with a the power of the normalized r coordinate and b the
    power of the normalized z coordinate - the reference's ``psi_cAB``
    layout (equilibrium.hpp:84-115).
    """
    f = np.asarray(f, dtype=np.longdouble)
    # splines along z for every r grid line: (4, nr, nz-1) local in t_z
    cz = _natural_spline_local(f, axis=1)
    # spline each z-coefficient field along r: (4, 4, nr-1, nz-1),
    # [a (r power), b (z power), i, j] local in t_r
    cr = np.stack([_natural_spline_local(cz[b], axis=0)
                   for b in range(4)], axis=1)
    if not local:
        # _local_to_global_1d expects (power, cells, ...): rebase r with
        # the r-cell axis i second, then z with the z-cell axis j second.
        t = np.moveaxis(cr, 2, 1)                 # (4a, i, 4b, j)
        t = _local_to_global_1d(t)                # rebase over i
        t = np.moveaxis(t, 1, 2)                  # (4a, 4b, i, j)
        t = np.transpose(t, (1, 3, 0, 2))         # (4b, j, 4a, i)
        t = _local_to_global_1d(t)                # rebase over j
        cr = np.transpose(t, (2, 0, 3, 1))        # (4a, 4b, i, j)
    return cr.astype(np.float64)


def _uniform_step(g, name):
    d = np.diff(g)
    if not np.allclose(d, d[0], rtol=1e-10, atol=0.0):
        raise ValueError(f"{name} grid must be uniform")
    return float(d[0])


def efit_tables(*, r, z, psi, psi_profile, ne, te, pressure, fpol):
    """The tables of an EFIT spline file in the reference's format, as a
    mapping of dataset name to float64 array.

    ``r``/``z``: uniform 1D grids [m]; ``psi``: (nr, nz) flux samples;
    ``psi_profile``: uniform 1D grid of psi values the profile samples live
    on; ``ne``/``te``/``pressure``/``fpol``: 1D profile samples on that
    grid (SI units; ne/te/pressure are normalized by their max into the
    ``*_scale`` scalars, as the reference's files are).

    :func:`models.efit.make_efit` takes the mapping directly or the file
    :func:`write_tables` makes of it (loader keys:
    equilibrium.hpp:1627-1844).
    """
    r = np.asarray(r, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    psi_profile = np.asarray(psi_profile, dtype=np.float64)
    out = {"rmin": r[0], "dr": _uniform_step(r, "r"),
           "zmin": z[0], "dz": _uniform_step(z, "z"),
           "psimin": psi_profile[0],
           "dpsi": _uniform_step(psi_profile, "psi_profile")}
    psi_tables = bicubic_spline_coeffs(psi)
    for a in range(4):
        for b in range(4):
            out[f"psi_c{a}{b}"] = psi_tables[a, b]
    # loader scale keys: ne_scale/te_scale/pres_scale; fpol unscaled
    for name, scale_key, samples in (
            ("ne", "ne_scale", ne), ("te", "te_scale", te),
            ("pressure", "pres_scale", pressure), ("fpol", None, fpol)):
        samples = np.asarray(samples, dtype=np.float64)
        scale = 1.0
        if scale_key is not None:
            scale = float(np.max(np.abs(samples))) or 1.0
            out[scale_key] = scale
        tabs = cubic_spline_coeffs(samples / scale)
        for k in range(4):
            out[f"{name}_c{k}"] = tabs[k]
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def vmec_tables(*, s_full, s_half, chi, rmnc, zmns, lmns, xm, xn, signj,
                dphi):
    """The tables of a VMEC spline file in the reference's format (make_vmec
    loader keys, equilibrium.hpp:2424-2651; replaces
    utilities/VMECSplines.nb), as a mapping of dataset name to array.

    ``s_full``/``s_half``: uniform radial grids (full / half mesh);
    ``chi``: poloidal-flux samples on the full grid; ``rmnc``/``zmns``:
    (num_modes, ns_full) Fourier-coefficient samples on the full grid;
    ``lmns``: (num_modes, ns_half) on the half grid; ``xm``/``xn``: mode
    numbers; ``signj``: Jacobian sign; ``dphi``: toroidal flux derivative.
    Radial cubic splines are fitted per mode (natural BC) and stored in the
    global normalized coordinate, as :func:`models.vmec.make_vmec` expects.
    """
    s_full = np.asarray(s_full, dtype=np.float64)
    s_half = np.asarray(s_half, dtype=np.float64)
    ds = _uniform_step(s_full, "s_full")
    dsh = _uniform_step(s_half, "s_half")
    if not np.isclose(ds, dsh, rtol=1e-10):
        raise ValueError("full and half mesh must share the step ds")

    def mode_tables(samples):
        # (num_modes, ns) -> (4, num_modes, ncells): spline along s per mode
        c = cubic_spline_coeffs(np.asarray(samples, dtype=np.float64).T)
        return np.moveaxis(c, 2, 1)    # (4, ns-1, m) -> (4, m, ns-1)

    out = {"signj": signj, "dphi": dphi, "sminf": s_full[0],
           "sminh": s_half[0], "ds": ds, "xm": xm, "xn": xn}
    chi_tabs = cubic_spline_coeffs(np.asarray(chi, dtype=np.float64))
    for k in range(4):
        out[f"chi_c{k}"] = chi_tabs[k]
    for name, samples in (("rmnc", rmnc), ("zmns", zmns), ("lmns", lmns)):
        tabs = mode_tables(samples)
        for k in range(4):
            out[f"{name}_c{k}"] = tabs[k]
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def write_tables(path, tables):
    """Write a mapping of dataset name to array as a NetCDF4/HDF5 file
    (the format make_efit/make_vmec read from a path)."""
    import h5py

    with h5py.File(path, "w") as h:
        for name, data in tables.items():
            h.create_dataset(name, data=data)
    return path


def write_efit_file(path, **samples):
    """Write an EFIT spline file: :func:`efit_tables` of the samples."""
    return write_tables(path, efit_tables(**samples))


def write_vmec_file(path, **samples):
    """Write a VMEC spline file: :func:`vmec_tables` of the samples."""
    return write_tables(path, vmec_tables(**samples))


def tokamak_samples(seed=0, *, nr=65, nz=65, npsi=65):
    """Grid samples of a seeded DIII-D-sized tokamak equilibrium.

    Geometry and field follow DIII-D's published size: major radius
    1.67 m, minor radius 0.67 m, elongation 1.8, toroidal field 2.0 T on
    axis, on an EFIT-style grid R in [0.84, 2.54] m, Z in [-1.6, 1.6] m.
    ``nr`` x ``nz`` samples give (nr-1) x (nz-1) bicubic cells (64 x 64 =
    4,096 by default, the reference file's resolution).  The flux is a
    Solov'ev-like ellipse with a Shafranov shift plus a few low-order
    ripples whose amplitudes come from ``seed``; psi = 0 on the axis and
    0.25 Wb/rad on the last closed surface (a poloidal field of about
    0.3 T at the outboard edge).  Profiles fall off as (1 - psi^2)^3 to a
    floor of 1e-3 of the core value outside the plasma, so rays launched
    at R = 2.5 m start in near vacuum.  The density and temperature
    profiles share one normalized shape, which makes the reference
    loader's ne/te table quirk (make_efit replicate_reference_quirks)
    harmless.

    Returns the keyword arguments of :func:`efit_tables`.
    """
    rng = np.random.default_rng(seed)
    r0, a, kappa, b0, psi_edge = 1.67, 0.67, 1.8, 2.0, 0.25
    shift = 0.05 * (1.0 + 0.2 * rng.uniform(-1.0, 1.0))
    ripple = 0.01 * rng.uniform(-1.0, 1.0, size=(3, 2))
    r = np.linspace(0.84, 2.54, nr)
    z = np.linspace(-1.6, 1.6, nz)
    rr, zz = np.meshgrid(r, z, indexing="ij")
    rho2 = (((rr - r0 - shift * (1.0 - ((rr - r0) / a) ** 2)) / a) ** 2
            + (zz / (kappa * a)) ** 2)
    theta = np.arctan2(zz / kappa, rr - r0)
    psi = psi_edge * rho2 * (1.0 + sum(
        rho2 * (ripple[m, 0] * np.cos((m + 2) * theta)
                + ripple[m, 1] * np.sin((m + 2) * theta))
        for m in range(3)))
    psi_profile = np.linspace(0.0, float(psi.max()) * 1.01, npsi)
    psin = psi_profile / psi_edge
    shape = (1.0 - 1e-3) * np.clip(1.0 - psin ** 2, 0.0, None) ** 3 + 1e-3
    ne0 = 1.0e19 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0))
    te0 = 3.0e3 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0))
    ne = ne0 * shape
    te = te0 * shape
    pressure = 2.0 * 1.60218e-19 * ne * te
    # toroidal field function F = R B_phi with a weak diamagnetic dip
    fpol = r0 * b0 * (1.0 - 0.02 * shape)
    return dict(r=r, z=z, psi=psi, psi_profile=psi_profile, ne=ne, te=te,
                pressure=pressure, fpol=fpol)


def tokamak_tables(seed=0, **grid):
    """EFIT tables of :func:`tokamak_samples` (the mapping make_efit
    takes in place of a file)."""
    return efit_tables(**tokamak_samples(seed, **grid))
