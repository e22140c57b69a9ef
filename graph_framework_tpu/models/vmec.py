"""VMEC stellarator equilibrium: Fourier-mode radial splines in flux coords.

Counterpart of ``equilibrium::vmec`` + ``make_vmec`` (reference:
graph_framework/equilibrium.hpp:1867-2651).  Coordinates are flux coordinates
(s, u, v); the cylindrical R, Z and the stream function lambda are Fourier
series over (xm, xn) modes with per-mode cubic radial splines:

    R(s,u,v) = sum_m rmnc_m(s) cos(xm_m u - xn_m v)        (:2113-2119)
    Z(s,u,v) = sum_m zmns_m(s) sin(xm_m u - xn_m v)
    l(s,u,v) = sum_m lmns_m(s) sin(xm_m u - xn_m v)        (half grid)

Covariant basis vectors come from jax.jacfwd of (R, Z) w.r.t. (s, u, v)
plus the cylinder rotation (the reference differentiates symbolically,
:1958-2018); the contravariant basis and B follow from cross products and
the Jacobian (:2030-2140).

The mode dimension is a dense vector axis (86 modes in vmec.nc), so the
Fourier sums are elementwise products and reductions, and the radial spline
gather fetches a (4, num_modes) block per point.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from graph_framework_tpu.models.equilibrium import Equilibrium, open_tables
from graph_framework_tpu.ops.tables import table_index_1d


def _spline_modes(coeffs, s, scale, offset, local):
    """Evaluate all per-mode radial splines at scalar s.

    ``coeffs``: cell-major (num_s, 4, num_modes) - one contiguous
    (4, num_modes) block gather per point (see ops.spline docstring for the
    measured one-index-gather win).  Returns (num_modes,).
    """
    u = (s - offset) / scale
    ns = coeffs.shape[0]
    idx = table_index_1d(s, scale, offset, ns)
    if local:
        u = u - idx.astype(u.dtype)
    block = _block_fetch(coeffs, idx)
    u = u[..., None] if jnp.ndim(u) else u       # broadcast over modes
    return (block[..., 0, :] + u * (block[..., 1, :]
            + u * (block[..., 2, :] + u * block[..., 3, :])))


def _block_fetch(coeffs, idx):
    """Fetch the (4, m) coefficient block of each ray's radial cell: one
    flat gather over a single trailing dimension.  The integer index
    carries no gradient (the reference's piecewise-constant-in-index
    semantics, piecewise.hpp:241-243)."""
    ns, _, m = coeffs.shape
    flat = coeffs.reshape(ns, 4 * m)
    return flat[idx].reshape(jnp.shape(idx) + (4, m))


def _spline_modes_jet(coeffs, s, scale, offset, local):
    """All per-mode radial splines AND their s-derivatives from one block
    fetch (see :func:`_block_fetch`).

    The derivative is the Horner of the analytically differentiated
    polynomial over the same block (the mechanism of
    ops.spline.eval_bicubic_jet), so the radial tangent costs no extra
    memory traffic.  Returns (value, d/ds), each (..., num_modes).
    """
    u = (s - offset) / scale
    ns = coeffs.shape[0]
    idx = table_index_1d(s, scale, offset, ns)
    if local:
        u = u - idx.astype(u.dtype)
    block = _block_fetch(coeffs, idx)
    u = u[..., None] if jnp.ndim(u) else u
    c0, c1 = block[..., 0, :], block[..., 1, :]
    c2, c3 = block[..., 2, :], block[..., 3, :]
    val = c0 + u * (c1 + u * (c2 + u * c3))
    dval = (c1 + u * (2.0 * c2 + 3.0 * u * c3)) / scale
    return val, dval


def _mode_trig(xm, xn, u, v):
    """cos/sin of every mode angle (xm u - xn v), direct per-mode form."""
    angle = ((xm * u[..., None] if jnp.ndim(u) else xm * u)
             - (xn * v[..., None] if jnp.ndim(v) else xn * v))
    return jnp.cos(angle), jnp.sin(angle)


def _grid_trig(xm_u, xn_u, u, v):
    """cos/sin of every (unique-xm x unique-xn) grid angle via outer
    products.

    cos(a-b) = cos a cos b + sin a sin b over a = xm_i u, b = xn_j v: the
    transcendentals are evaluated only at the UNIQUE poloidal and toroidal
    mode numbers (vmec.nc: 86 modes but only 10 distinct xm and 9 distinct
    xn), then combined for the whole (n_xm, n_xn) grid by outer-product
    broadcasts - no per-mode gather, so reverse-mode AD transposes to
    broadcasts/reductions instead of scatters (a static-index take here
    measured 1.7x SLOWER end-to-end: its backward is a scatter-add).
    Transcendental count per point drops from 2*num_modes to
    2*(n_xm + n_xn).  Exact algebraic identity, holomorphic in u, v.

    Returns (ca, sa), each (..., n_xm * n_xn), grid index g = i*n_xn + j.
    """
    au = u[..., None] * xm_u if jnp.ndim(u) else u * xm_u   # (..., n_xm)
    bv = v[..., None] * xn_u if jnp.ndim(v) else v * xn_u   # (..., n_xn)
    cm, sm = jnp.cos(au), jnp.sin(au)
    cn, sn = jnp.cos(bv), jnp.sin(bv)
    ca = cm[..., :, None] * cn[..., None, :] + sm[..., :, None] * sn[..., None, :]
    sa = sm[..., :, None] * cn[..., None, :] - cm[..., :, None] * sn[..., None, :]
    shape = ca.shape[:-2] + (ca.shape[-2] * ca.shape[-1],)
    return ca.reshape(shape), sa.reshape(shape)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VmecEquilibrium(Equilibrium):
    """Stellarator equilibrium in VMEC flux coordinates."""

    chi_coeffs: jax.Array       # (numsf, 4) poloidal flux chi(s), cell-major
    rmnc_coeffs: jax.Array      # (numsf, 4, num_modes) cell-major
    zmns_coeffs: jax.Array      # (numsf, 4, num_modes) cell-major
    lmns_coeffs: jax.Array      # (numsh, 4, num_modes) half grid, cell-major
    xm: jax.Array               # (num_modes,) poloidal mode numbers
    xn: jax.Array               # (num_modes,) toroidal mode numbers
    signj: float = dataclasses.field(metadata=dict(static=True))
    dphi: float = dataclasses.field(metadata=dict(static=True))
    sminf: float = dataclasses.field(metadata=dict(static=True))
    sminh: float = dataclasses.field(metadata=dict(static=True))
    ds: float = dataclasses.field(metadata=dict(static=True))
    cell_local: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # replicate the reference's double-normalized chi argument (see chi()).
    quirky_chi: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # mode-GRID metadata (built by make_vmec): the runtime path scatters
    # the coefficient tables onto the dense (unique-xm x unique-xn) grid -
    # 90 slots for vmec.nc's 86 modes - so the angle factors come from
    # outer products of per-unique trig vectors (_grid_trig) instead of
    # per-mode transcendentals.  The scatter runs on the (num_s, 4,
    # num_modes) TABLE inside the trace (constant-folded by XLA when the
    # tables are closure constants), keeping ``rmnc_coeffs`` etc. the
    # single differentiable source of truth.
    grid_scatter: jax.Array = None  # (num_modes,) int32 grid slot per mode
    xm_unique: jax.Array = None     # (n_xm,)
    xn_unique: jax.Array = None     # (n_xn,)
    xm_grid: jax.Array = None       # (n_xm * n_xn,) grid mode numbers
    xn_grid: jax.Array = None

    def _grid_table(self, coeffs):
        """Scatter a (num_s, 4, num_modes) table onto the dense mode grid."""
        n_grid = self.xm_grid.shape[0]
        out = jnp.zeros(coeffs.shape[:-1] + (n_grid,), coeffs.dtype)
        return out.at[..., self.grid_scatter].set(coeffs)

    @property
    def ion_masses(self):
        # Single deuterium species (equilibrium.hpp:2206).
        return (3.34449469e-27,)

    @property
    def ion_charges(self):
        return (1,)

    def is_cartesian(self):
        return False

    def supports_batched(self):
        return True       # geometry is batched-polymorphic (see _geometry)

    # -- Fourier geometry --------------------------------------------------
    def _rzl(self, s, u, v):
        """R, Z, lambda at a flux-space point (equilibrium.hpp:2083-2121)."""
        if self.grid_scatter is not None:
            rm = _spline_modes(self._grid_table(self.rmnc_coeffs), s,
                               self.ds, self.sminf, self.cell_local)
            zm = _spline_modes(self._grid_table(self.zmns_coeffs), s,
                               self.ds, self.sminf, self.cell_local)
            lm = _spline_modes(self._grid_table(self.lmns_coeffs), s,
                               self.ds, self.sminh, self.cell_local)
            ca, sa = _grid_trig(self.xm_unique, self.xn_unique, u, v)
        else:
            rm = _spline_modes(self.rmnc_coeffs, s, self.ds, self.sminf,
                               self.cell_local)
            zm = _spline_modes(self.zmns_coeffs, s, self.ds, self.sminf,
                               self.cell_local)
            lm = _spline_modes(self.lmns_coeffs, s, self.ds, self.sminh,
                               self.cell_local)
            ca, sa = _mode_trig(self.xm, self.xn, u, v)
        return (jnp.sum(rm * ca, axis=-1), jnp.sum(zm * sa, axis=-1),
                jnp.sum(lm * sa, axis=-1))

    def chi(self, s):
        """Poloidal flux spline chi(s).

        NOTE: the reference evaluates chi at the *normalized* radial
        coordinate (``get_chi(s_norm_f)``, equilibrium.hpp:2131), which
        double-normalizes the argument: with vmec.nc's sminf = -1,
        ds = 1/99 the table index saturates at the last cell for any
        s > -0.99 and the polynomial is evaluated ~1e4 cells outside its
        range, making |B| ~ 1e6 T.  The VMEC field path has no golden test
        in the reference (graph_tests has no vmec_test), so we implement
        the physically-intended chi(s); ``quirky_chi=True`` reproduces the
        literal reference arithmetic for comparison runs."""
        arg = (s - self.sminf) / self.ds if self.quirky_chi else s
        un = (arg - self.sminf) / self.ds
        idx = table_index_1d(arg, self.ds, self.sminf,
                             self.chi_coeffs.shape[0])
        if self.cell_local:
            un = un - idx.astype(un.dtype)
        c = self.chi_coeffs[idx]
        return c[..., 0] + un * (c[..., 1] + un * (c[..., 2]
                                                   + un * c[..., 3]))

    def phi(self, s):
        """Toroidal flux: signj * dphi * s (equilibrium.hpp:2061)."""
        return self.signj * self.dphi * s

    # -- basis vectors ----------------------------------------------------
    def _geometry(self, pos):
        """Covariant/contravariant bases, Jacobian, B at (s, u, v).

        Mirrors set_cache (equilibrium.hpp:2073-2141) with a vmapped jvp
        supplying dR/d(s,u,v), dZ/d(s,u,v), dl/d(s,u,v).  Batched
        polymorphic: ``pos`` is (3,) per point or (3, num_rays), and all
        vector algebra is componentwise with the component axis leading
        (see models/rays.py for the measured lane-layout rationale)."""
        s, u, v = pos[0], pos[1], pos[2]

        (r, z, _l), (dr, dz, dl) = _rzl_and_jac(self, s, u, v)

        phip = self.signj * self.dphi                     # d(phi)/ds

        # grad-of-sum = elementwise derivative (chi is elementwise in s)
        def chi_sum(s_):
            return jnp.sum(self.chi(s_))
        dchi_ds = jax.grad(chi_sum,
                           holomorphic=jnp.iscomplexobj(s))(s)

        return _assemble_geometry(v, r, z, dr, dz, dl, dchi_ds, phip)

    def esup(self, pos):
        return self._geometry(pos)["esup"]

    def magnetic_field(self, pos):
        return self._geometry(pos)["bvec"]

    def bind_point(self, pos):
        """One-geometry view (see Equilibrium.bind_point): the ray RHS
        needs the contravariant basis (kvec) AND B (dispersion) at the
        same flux-space point; binding evaluates the Fourier geometry
        once and serves both, halving the mode-sum work per RHS and - more
        importantly - halving the reverse-mode cotangent paths through the
        spline gathers and trig grids."""
        return _BoundVmec(self, self._geometry(pos))

    def freeze_cells(self, pos):
        """Radial freeze window (VERDICT r4 next-4): fetch each ray's
        radial spline blocks (rmnc+zmns concatenated, lmns, chi) ONCE at
        the window-base s and return a view whose geometry evaluates the
        radial polynomials against them with cell-local coordinates -
        only the slow radial CELL is frozen; the polynomial in s and the
        poloidal/toroidal trig stay exact at every stage.  Same narrowed
        extrapolation contract as models/efit.FrozenCellEfit (s drifts
        O(dt * v_s) per substep against ds = 1/99 cells).  Enables
        ``Solver(frozen_cells=True, freeze_every=K)`` for VMEC.
        """
        if not self.cell_local:
            raise ValueError("freeze_cells requires cell_local tables")
        if self.quirky_chi:
            raise ValueError("freeze_cells with quirky_chi is not "
                             "supported (comparison-only path)")
        s = pos[0]
        if self.grid_scatter is not None:
            rz_tab = jnp.concatenate(
                [self._grid_table(self.rmnc_coeffs),
                 self._grid_table(self.zmns_coeffs)], axis=-1)
            l_tab = self._grid_table(self.lmns_coeffs)
        else:
            rz_tab = jnp.concatenate(
                [self.rmnc_coeffs, self.zmns_coeffs], axis=-1)
            l_tab = self.lmns_coeffs
        idx_f = table_index_1d(s, self.ds, self.sminf, rz_tab.shape[0])
        idx_h = table_index_1d(s, self.ds, self.sminh, l_tab.shape[0])
        idx_c = table_index_1d(s, self.ds, self.sminf,
                               self.chi_coeffs.shape[0])
        f = jnp.real(s).dtype
        return _FrozenRadialVmec(
            base=self,
            rz_block=_block_fetch(rz_tab, idx_f),
            l_block=_block_fetch(l_tab, idx_h),
            chi_block=self.chi_coeffs[idx_c],
            idx_f=idx_f.astype(f), idx_h=idx_h.astype(f),
            idx_c=idx_c.astype(f))

    def characteristic_field(self):
        """|B| at the axis (s, u, v) = 0 (equilibrium.hpp:2198-2205)."""
        zero = jnp.zeros(3, dtype=self.rmnc_coeffs.dtype)
        b = self.magnetic_field(zero)
        return jnp.sqrt(jnp.sum(b * b))

    def to_xyz(self, pos):
        s, u, v = pos[0], pos[1], pos[2]
        r, z, _ = self._rzl(s, u, v)
        return jnp.stack([r * jnp.cos(v), r * jnp.sin(v), z])

    # -- profiles (analytic in s; equilibrium.hpp:2150-2172) ---------------
    def profile(self, s):
        """(1 - (sqrt(s^2))^1.5)^2 (equilibrium.hpp:2150-2153)."""
        return (1.0 - jnp.sqrt(s * s) ** 1.5) ** 2

    def electron_density(self, pos):
        return 1.0e19 * self.profile(pos[0])

    def ion_density(self, index, pos):
        return self.electron_density(pos)

    def electron_temperature(self, pos):
        return 1000.0 * self.profile(pos[0])

    def ion_temperature(self, index, pos):
        return self.electron_temperature(pos)


def _assemble_geometry(v, r, z, dr, dz, dl, dchi_ds, phip):
    """Covariant/contravariant bases, Jacobian and B from the (R, Z, l)
    jet - the basis algebra of ``_geometry`` (equilibrium.hpp:2073-2141),
    shared by the full and frozen-radial paths."""
    cv, sv = jnp.cos(v), jnp.sin(v)

    # rot(v) applied to (a, b, c): (a cv - b sv, a sv + b cv, c)
    def rot(a, b, c):
        return (a * cv - b * sv, a * sv + b * cv, c)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    zero = jnp.zeros_like(r)
    esub_s = rot(dr[0], zero, dz[0])
    esub_u = rot(dr[1], zero, dz[1])
    esub_v = rot(dr[2], r, dz[2])

    cuv = cross(esub_u, esub_v)
    jac = dot(esub_s, cuv)
    inv_jac = 1.0 / jac

    def scale(vec, f):
        return jnp.stack([vec[0] * f, vec[1] * f, vec[2] * f])

    esup_s = scale(cuv, inv_jac)
    esup_u = scale(cross(esub_v, esub_s), inv_jac)
    esup_v = scale(cross(esub_s, esub_u), inv_jac)

    jbsupu = (dchi_ds - phip * dl[2]) * inv_jac
    jbsupv = phip * (1.0 + dl[1]) * inv_jac
    bvec = jnp.stack([
        jbsupu * esub_u[0] + jbsupv * esub_v[0],
        jbsupu * esub_u[1] + jbsupv * esub_v[1],
        jbsupu * esub_u[2] + jbsupv * esub_v[2]])

    return dict(r=r, z=z, esup=jnp.stack([esup_s, esup_u, esup_v]),
                bvec=bvec, jac=jac)


class _BoundVmec:
    """Point-bound VMEC view: all geometry (basis vectors, B, Jacobian)
    comes from ONE ``_geometry`` evaluation shared by every accessor.
    Built inside traces by :meth:`VmecEquilibrium.bind_point`; positions
    passed to the accessors are ignored - they are the binding point by
    contract (the reference's set_cache hit path, equilibrium.hpp:2073).
    """

    __slots__ = ("_eq", "_geo")

    def __init__(self, eq: VmecEquilibrium, geo: dict):
        self._eq = eq
        self._geo = geo

    # -- pass-throughs ----------------------------------------------------
    @property
    def ion_masses(self):
        return self._eq.ion_masses

    @property
    def ion_charges(self):
        return self._eq.ion_charges

    @property
    def num_ion_species(self):
        return self._eq.num_ion_species

    def is_cartesian(self):
        return False

    def supports_batched(self):
        return True

    def bind_point(self, pos):
        return self

    # -- shared-geometry accessors ----------------------------------------
    def esup(self, pos):
        return self._geo["esup"]

    def magnetic_field(self, pos):
        return self._geo["bvec"]

    def kvec(self, kcov, pos):
        esup = self._geo["esup"]
        return (kcov[0] * esup[0] + kcov[1] * esup[1]
                + kcov[2] * esup[2])

    def plasma_quantities(self, pos) -> "PlasmaQuantities":
        from graph_framework_tpu.models.equilibrium import PlasmaQuantities
        n = self._eq.num_ion_species
        return PlasmaQuantities(
            b=self._geo["bvec"],
            ne=self._eq.electron_density(pos),
            te=self._eq.electron_temperature(pos),
            ni=tuple(self._eq.ion_density(i, pos) for i in range(n)),
            ti=tuple(self._eq.ion_temperature(i, pos) for i in range(n)),
        )

    def electron_density(self, pos):
        return self._eq.electron_density(pos)

    def electron_temperature(self, pos):
        return self._eq.electron_temperature(pos)

    def ion_density(self, index, pos):
        return self._eq.ion_density(index, pos)

    def ion_temperature(self, index, pos):
        return self._eq.ion_temperature(index, pos)


def _frozen_jet(block, u, scale):
    """Horner value + d/ds over an already-fetched (..., 4, M) radial
    block and cell-local coordinate (may run slightly past [0, 1) - the
    frozen-window extrapolation contract)."""
    u = u[..., None] if jnp.ndim(u) else u
    c0, c1 = block[..., 0, :], block[..., 1, :]
    c2, c3 = block[..., 2, :], block[..., 3, :]
    val = c0 + u * (c1 + u * (c2 + u * c3))
    dval = (c1 + u * (2.0 * c2 + 3.0 * u * c3)) / scale
    return val, dval


class _FrozenRadialVmec:
    """Radial-cell-frozen VMEC view (see VmecEquilibrium.freeze_cells).

    Geometry evaluates the radial polynomials against the window-base
    blocks; trig/mode sums and the analytic profiles stay exact functions
    of the CURRENT (s, u, v).  Built inside traces by freeze_cells; the
    Solver's frozen-cell stepper rebuilds the ray RHS against it each
    window (solver.raw_step_fn)."""

    __slots__ = ("base", "rz_block", "l_block", "chi_block",
                 "idx_f", "idx_h", "idx_c")

    def __init__(self, base, rz_block, l_block, chi_block,
                 idx_f, idx_h, idx_c):
        self.base = base
        self.rz_block = rz_block
        self.l_block = l_block
        self.chi_block = chi_block
        self.idx_f = idx_f
        self.idx_h = idx_h
        self.idx_c = idx_c

    @property
    def ion_masses(self):
        return self.base.ion_masses

    @property
    def ion_charges(self):
        return self.base.ion_charges

    @property
    def num_ion_species(self):
        return self.base.num_ion_species

    def is_cartesian(self):
        return False

    def supports_batched(self):
        return True

    def _geometry(self, pos):
        eq = self.base
        s, u, v = pos[0], pos[1], pos[2]
        un_f = (s - eq.sminf) / eq.ds - self.idx_f
        un_h = (s - eq.sminh) / eq.ds - self.idx_h
        rzm, rzm_s = _frozen_jet(self.rz_block, un_f, eq.ds)
        lm, lm_s = _frozen_jet(self.l_block, un_h, eq.ds)
        if eq.grid_scatter is not None:
            ca, sa = _grid_trig(eq.xm_unique, eq.xn_unique, u, v)
            xm = eq.xm_grid.astype(ca.dtype)
            xn = eq.xn_grid.astype(ca.dtype)
        else:
            ca, sa = _mode_trig(eq.xm, eq.xn, u, v)
            xm = eq.xm.astype(ca.dtype)
            xn = eq.xn.astype(ca.dtype)
        m = ca.shape[-1]
        rm, zm = rzm[..., :m], rzm[..., m:]
        rm_s, zm_s = rzm_s[..., :m], rzm_s[..., m:]
        (r, z, _l), (dr, dz, dl) = _mode_sums(
            rm, zm, lm, rm_s, zm_s, lm_s, ca, sa, xm, xn)

        un_c = (s - eq.sminf) / eq.ds - self.idx_c
        cb = self.chi_block
        dchi_ds = (cb[..., 1] + un_c * (2.0 * cb[..., 2]
                   + 3.0 * un_c * cb[..., 3])) / eq.ds
        return _assemble_geometry(v, r, z, dr, dz, dl, dchi_ds,
                                  eq.signj * eq.dphi)

    def bind_point(self, pos):
        return _BoundVmec(self, self._geometry(pos))

    def esup(self, pos):
        return self._geometry(pos)["esup"]

    def magnetic_field(self, pos):
        return self._geometry(pos)["bvec"]

    # profiles are analytic in s - exact, delegate to the base
    def electron_density(self, pos):
        return self.base.electron_density(pos)

    def electron_temperature(self, pos):
        return self.base.electron_temperature(pos)

    def ion_density(self, index, pos):
        return self.base.ion_density(index, pos)

    def ion_temperature(self, index, pos):
        return self.base.ion_temperature(index, pos)


def _rzl_and_jac(eq: VmecEquilibrium, s, u, v):
    """(R, Z, l) and their (s, u, v) derivatives in one analytic pass.

    The reference differentiates the Fourier-spline graphs symbolically
    (equilibrium.hpp:1958-2018); here the full 3x3 Jacobian is written out
    analytically so that ONE radial-block gather per table and ONE factored
    trig evaluation (see :func:`_mode_trig`) serve the values and all nine
    derivatives:

        dR/ds = sum rm' ca      dR/du = -sum xm rm sa   dR/dv = sum xn rm sa
        dZ/ds = sum zm' sa      dZ/du =  sum xm zm ca   dZ/dv = -sum xn zm ca
        (l identical in shape to Z)

    This replaces a 3-tangent vmapped jvp whose tangents re-derived the
    trig products per tangent; everything here is gathers + polynomials +
    factored trig, so reverse-mode autodiff on top (the ray equations need
    d/dx of the basis) stays exact and cheap.  Holomorphic for complex
    coordinates (polynomials and trig are entire).

    Returns ((R, Z, l), (dR, dZ, dl)) with each dX = (d/ds, d/du, d/dv).
    """
    if eq.grid_scatter is not None:
        # rmnc and zmns share the full radial grid: ONE concatenated
        # (num_s, 4, 2*n_grid) table -> one block gather serves both
        # (halves the gather-op count of the hot path; the concat is over
        # constant tables, folded away by XLA at compile time)
        rz = jnp.concatenate([eq._grid_table(eq.rmnc_coeffs),
                              eq._grid_table(eq.zmns_coeffs)], axis=-1)
        rzm, rzm_s = _spline_modes_jet(rz, s, eq.ds, eq.sminf,
                                       eq.cell_local)
        n_grid = eq.xm_grid.shape[0]
        rm, zm = rzm[..., :n_grid], rzm[..., n_grid:]
        rm_s, zm_s = rzm_s[..., :n_grid], rzm_s[..., n_grid:]
        lm, lm_s = _spline_modes_jet(eq._grid_table(eq.lmns_coeffs), s,
                                     eq.ds, eq.sminh, eq.cell_local)
        ca, sa = _grid_trig(eq.xm_unique, eq.xn_unique, u, v)
        xm = eq.xm_grid.astype(ca.dtype)
        xn = eq.xn_grid.astype(ca.dtype)
    else:
        rz = jnp.concatenate([eq.rmnc_coeffs, eq.zmns_coeffs], axis=-1)
        rzm, rzm_s = _spline_modes_jet(rz, s, eq.ds, eq.sminf,
                                       eq.cell_local)
        m = eq.xm.shape[0]
        rm, zm = rzm[..., :m], rzm[..., m:]
        rm_s, zm_s = rzm_s[..., :m], rzm_s[..., m:]
        lm, lm_s = _spline_modes_jet(eq.lmns_coeffs, s, eq.ds, eq.sminh,
                                     eq.cell_local)
        ca, sa = _mode_trig(eq.xm, eq.xn, u, v)
        xm = eq.xm.astype(ca.dtype)
        xn = eq.xn.astype(ca.dtype)

    return _mode_sums(rm, zm, lm, rm_s, zm_s, lm_s, ca, sa, xm, xn)


def _mode_sums(rm, zm, lm, rm_s, zm_s, lm_s, ca, sa, xm, xn):
    """Fourier mode sums for (R, Z, l) and the nine derivatives (the tail
    of :func:`_rzl_and_jac`, shared with the frozen-radial path)."""
    rm_sa = rm * sa
    zm_ca = zm * ca
    lm_ca = lm * ca

    def msum(t):
        return jnp.sum(t, axis=-1)

    r = msum(rm * ca)
    z = msum(zm * sa)
    l = msum(lm * sa)
    dr = (msum(rm_s * ca), -msum(xm * rm_sa), msum(xn * rm_sa))
    dz = (msum(zm_s * sa), msum(xm * zm_ca), -msum(xn * zm_ca))
    dl = (msum(lm_s * sa), msum(xm * lm_ca), -msum(xn * lm_ca))
    return (r, z, l), (dr, dz, dl)


def make_vmec(source, dtype=jnp.float64, cell_local=True, quirky_chi=False):
    """Load a VMEC equilibrium (make_vmec, equilibrium.hpp:2424-2651) from a
    spline file's path or from the mapping of its tables
    (tools.make_splines.vmec_tables).

    ``cell_local``: rebase radial spline tables to cell-local coordinates at
    load time for well-conditioned evaluation (see efit.make_efit).
    """
    from graph_framework_tpu.ops.spline import (
        rebase_cells_1d, to_cell_major_1d)

    with open_tables(source) as arr:
        chi = np.stack([arr(f"chi_c{i}") for i in range(4)])

        def stack_modes(prefix):
            # file layout (num_modes, num_s) per coefficient
            return np.stack([arr(f"{prefix}_c{i}") for i in range(4)])

        rmnc = stack_modes("rmnc")      # (4, 86, numsf)
        zmns = stack_modes("zmns")
        lmns = stack_modes("lmns")      # (4, 86, numsh)

        if cell_local:
            chi = rebase_cells_1d(chi)

            def rebase_modes(c):
                return np.stack([
                    rebase_cells_1d(c[:, m, :]) for m in range(c.shape[1])
                ], axis=1)

            rmnc = rebase_modes(rmnc)
            zmns = rebase_modes(zmns)
            lmns = rebase_modes(lmns)

        # cell-major runtime layout: (num_s, 4, num_modes) / (numsf, 4)
        chi = to_cell_major_1d(chi)
        rmnc = np.ascontiguousarray(rmnc.transpose(2, 0, 1))
        zmns = np.ascontiguousarray(zmns.transpose(2, 0, 1))
        lmns = np.ascontiguousarray(lmns.transpose(2, 0, 1))

        # mode-grid layout: scatter (num_modes,) coefficients onto the
        # dense (n_xm, n_xn) grid so the runtime trig factors come from
        # outer products (_grid_trig); missing combinations hold zeros.
        xm_np, xn_np = arr("xm"), arr("xn")
        xm_vals, iu = np.unique(xm_np, return_inverse=True)
        xn_vals, jv = np.unique(xn_np, return_inverse=True)
        n_xm, n_xn = len(xm_vals), len(xn_vals)
        gidx = iu * n_xn + jv

        xm_grid = np.repeat(xm_vals, n_xn)
        xn_grid = np.tile(xn_vals, n_xm)

        return VmecEquilibrium(
            grid_scatter=jnp.asarray(gidx, dtype=jnp.int32),
            xm_unique=jnp.asarray(xm_vals, dtype=dtype),
            xn_unique=jnp.asarray(xn_vals, dtype=dtype),
            xm_grid=jnp.asarray(xm_grid, dtype=dtype),
            xn_grid=jnp.asarray(xn_grid, dtype=dtype),
            chi_coeffs=jnp.asarray(chi, dtype=dtype),
            rmnc_coeffs=jnp.asarray(rmnc, dtype=dtype),
            zmns_coeffs=jnp.asarray(zmns, dtype=dtype),
            lmns_coeffs=jnp.asarray(lmns, dtype=dtype),
            xm=jnp.asarray(arr("xm"), dtype=dtype),
            xn=jnp.asarray(arr("xn"), dtype=dtype),
            signj=float(arr("signj")),
            dphi=float(arr("dphi")),
            sminf=float(arr("sminf")),
            sminh=float(arr("sminh")),
            ds=float(arr("ds")),
            cell_local=cell_local,
            quirky_chi=quirky_chi,
        )
