"""EFIT tokamak equilibrium: bicubic psi(R, Z) + cubic profiles of psi.

Counterpart of ``equilibrium::efit`` + ``make_efit`` (reference:
graph_framework/equilibrium.hpp:1145-1844).  The spline coefficient tables
live in device memory cell-major - (nr, nz, 4, 4), gathered as one
contiguous 16-value block per point via a linearized index (the
layout-level version of the reference's USE_INDEX_CACHE / texture tricks,
piecewise.hpp:256-325) - and the
field derivatives dpsi/dr, dpsi/dz come from ``jax.grad`` of the spline
evaluation, exactly where the reference uses symbolic ``df``
(equilibrium.hpp:1366,1375).

File format: NetCDF4/HDF5 with scalars psimin/dpsi/rmin/dr/zmin/dz and
scale factors, 1D profile tables {ne,te,pressure,fpol}_c0..c3[numpsi], and
2D tables psi_cAB[numr, numz] where A is the power of the normalized radius
and B the power of the normalized height (equilibrium.hpp:84-115 and
make_efit:1627-1844).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from graph_framework_tpu.models.equilibrium import (
    Equilibrium, PlasmaQuantities, open_tables)
from graph_framework_tpu.ops.spline import (
    eval_cubic_1d, eval_cubic_multi, eval_bicubic_2d, eval_bicubic_jet,
    eval_bicubic_jet_block, eval_cubic_multi_block,
    rebase_cells_1d, rebase_cells_2d, to_cell_major_1d, to_cell_major_2d)
from graph_framework_tpu.ops.tables import table_index_1d
from graph_framework_tpu.ops.newton import newton_solve_multi


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EfitEquilibrium(Equilibrium):
    """Tokamak equilibrium from EFIT bicubic-spline data."""

    # 2D psi tables, cell-major (nr, nz, 4, 4): [i, j, r_power, z_power].
    psi_coeffs: jax.Array
    # 1D profile tables, cell-major (numpsi, 4).
    ne_coeffs: jax.Array
    te_coeffs: jax.Array
    pres_coeffs: jax.Array
    fpol_coeffs: jax.Array
    # fused profile stack (numpsi, 4, 4): [cell, (ne,te,pres,fpol), power];
    # one contiguous block gather serves all four profiles (they share the
    # psi argument).
    profile_coeffs: jax.Array

    # grid/profile normalization (compile-time constants, like the
    # reference's baked-in scale/offset kernel literals).
    psimin: float = dataclasses.field(metadata=dict(static=True))
    dpsi: float = dataclasses.field(metadata=dict(static=True))
    rmin: float = dataclasses.field(metadata=dict(static=True))
    dr: float = dataclasses.field(metadata=dict(static=True))
    zmin: float = dataclasses.field(metadata=dict(static=True))
    dz: float = dataclasses.field(metadata=dict(static=True))
    ne_scale: float = dataclasses.field(metadata=dict(static=True))
    te_scale: float = dataclasses.field(metadata=dict(static=True))
    pres_scale: float = dataclasses.field(metadata=dict(static=True))
    # True when the coefficient tables were rebased to cell-local
    # coordinates at load time (well-conditioned evaluation; see
    # ops.spline.rebase_cells_*).
    cell_local: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # Use the analytic-jet custom_jvp for the FROZEN path's
    # plasma_quantities (_make_frozen_pq_jet): hand-derived jet-linear
    # tangent rule instead of autodiff through the polynomial/algebra
    # chain.  Gradient-parity-tested; opt-in for fwd+bwd benchmarks.
    custom_jet: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @property
    def ion_masses(self):
        # Single deuterium species (equilibrium.hpp:1475).
        return (3.34449469e-27,)

    @property
    def ion_charges(self):
        return (1,)

    # -- flux surface ------------------------------------------------------
    def psi_rz(self, r, z):
        """psi(R, Z) via the bicubic stack (efit::build_psi,
        equilibrium.hpp:1278-1313)."""
        return eval_bicubic_2d(self.psi_coeffs, r, self.dr, self.rmin,
                               z, self.dz, self.zmin,
                               local=self.cell_local)

    def psi(self, pos):
        r = jnp.sqrt(pos[0] * pos[0] + pos[1] * pos[1])
        return self.psi_rz(r, pos[2])

    def profiles(self, psi_val):
        """(ne, te, pressure, fpol) at a psi value with one fused gather."""
        vals = eval_cubic_multi(self.profile_coeffs, psi_val,
                                self.dpsi, self.psimin,
                                local=self.cell_local)
        return (self.ne_scale * vals[..., 0], self.te_scale * vals[..., 1],
                self.pres_scale * vals[..., 2], vals[..., 3])

    # -- profiles (cubic splines of psi; equilibrium.hpp:1338-1362) --------
    def electron_density(self, pos):
        return self.ne_scale * eval_cubic_1d(
            self.ne_coeffs, self.psi(pos), self.dpsi, self.psimin,
            local=self.cell_local)

    def electron_temperature(self, pos):
        return self.te_scale * eval_cubic_1d(
            self.te_coeffs, self.psi(pos), self.dpsi, self.psimin,
            local=self.cell_local)

    def pressure(self, pos):
        return self.pres_scale * eval_cubic_1d(
            self.pres_coeffs, self.psi(pos), self.dpsi, self.psimin,
            local=self.cell_local)

    def ion_density(self, index, pos):
        # Faithful to the reference: ni_cache = te_cache
        # (equilibrium.hpp:1361).  Physically this should be ne, but the
        # reference ships (and is golden-tested) with the te profile here;
        # its contribution to cold-plasma D is ~1e-15 of the electron term,
        # which is presumably why it went unnoticed.  Replicated for
        # trajectory parity.
        return self.electron_temperature(pos)

    def ion_temperature(self, index, pos):
        # ti = (pressure - ne te q) / (ni q) with q = 1.60218e-19
        # (note: the reference uses this rounded q here, not the exact
        # elementary charge; equilibrium.hpp:1358-1362).  ni = te quirk
        # as in ion_density.
        q = 1.60218e-19
        ne, te, pres, _ = self.profiles(self.psi(pos))
        ni = te
        return (pres - ne * te * q) / (ni * q)

    # -- magnetic field (equilibrium.hpp:1364-1382) ------------------------
    def magnetic_field(self, pos):
        x, y, z = pos[0], pos[1], pos[2]
        r = jnp.sqrt(x * x + y * y)
        cplx = jnp.iscomplexobj(pos)

        # dpsi/dz and dpsi/dr from the analytic spline jet (the reference
        # differentiates the spline graph symbolically at :1366,:1375).
        # The jet shares one coefficient gather between value and
        # derivatives and keeps the outer ray-equation gradient from
        # differentiating through a nested grad transpose; it is exact for
        # complex coordinates too (polynomials in the coordinate).
        psi_val, dpsi_dr, dpsi_dz = eval_bicubic_jet(
            self.psi_coeffs, r, self.dr, self.rmin, z, self.dz, self.zmin,
            local=self.cell_local)

        br = dpsi_dz / r
        bp = eval_cubic_1d(self.fpol_coeffs, psi_val, self.dpsi,
                           self.psimin, local=self.cell_local) / r
        bz = -dpsi_dr / r

        # cos(atan2(y, x)) = x/r, sin(atan2(y, x)) = y/r: three
        # transcendentals replaced by exact algebraic identities.  For
        # complex coordinates this is the analytic continuation; the
        # reference's complex convention atan(y/x) (backend.hpp:1130-1150)
        # branch-flips the rotation for Re(x) < 0, which x/r avoids.
        c, s = x / r, y / r
        return jnp.stack([br * c - bp * s, br * s + bp * c, bz])

    # -- fused dispersion inputs -------------------------------------------
    def plasma_quantities(self, pos):
        """All dispersion inputs from TWO gathers: one bicubic jet block
        (psi + its R/Z derivatives) and one fused profile block
        (ne, te, pressure, fpol share the psi cell index).

        This is the layout-level version of the reference's subgraph
        memoization (equilibrium.hpp ``set_cache``, :1324-1384): inside one
        compiled kernel the cold-plasma D reads ne, ni(=te), and B, and all
        of them key on the same psi(R, Z) evaluation.
        """
        x, y, z = pos[0], pos[1], pos[2]
        r = jnp.sqrt(x * x + y * y)
        psi_val, dpsi_dr, dpsi_dz = eval_bicubic_jet(
            self.psi_coeffs, r, self.dr, self.rmin, z, self.dz, self.zmin,
            local=self.cell_local)
        ne, te, pres, fpol = self.profiles(psi_val)
        # named for remat policies: Solver(remat_policy="spline_jet")
        # saves these gather products so a surrounding checkpoint's
        # backward recompute skips the gather-heavy table reads (the
        # 56%-of-substep fusion block, NOTES_r3 profile account)
        from jax.ad_checkpoint import checkpoint_name
        psi_val, dpsi_dr, dpsi_dz, ne, te, pres, fpol = [
            checkpoint_name(a, "spline_jet")
            for a in (psi_val, dpsi_dr, dpsi_dz, ne, te, pres, fpol)]

        br = dpsi_dz / r
        bp = fpol / r
        bz = -dpsi_dr / r
        c, s = x / r, y / r        # algebraic rotation (see magnetic_field)
        b = jnp.stack([br * c - bp * s, br * s + bp * c, bz])

        # ni = te quirk and the rounded q, as in ion_density/ion_temperature.
        q = 1.60218e-19
        ni = te
        ti = (pres - ne * te * q) / (ni * q)
        return PlasmaQuantities(b=b, ne=ne, te=te, ni=(ni,), ti=(ti,))

    def freeze_cells(self, pos):
        """Gather this position's spline blocks ONCE and return a
        :class:`FrozenCellEfit` view that evaluates plasma_quantities
        against them - the shared-gather substep optimization (see
        FrozenCellEfit for the narrowed contract and error bound).
        """
        if not self.cell_local:
            raise ValueError("freeze_cells requires cell_local tables "
                             "(the default load path)")
        x, y, z = pos[0], pos[1], pos[2]
        r = jnp.sqrt(x * x + y * y)
        nr, nc = self.psi_coeffs.shape[:2]
        i = table_index_1d(r, self.dr, self.rmin, nr)
        j = table_index_1d(z, self.dz, self.zmin, nc)
        psi_block = self.psi_coeffs.reshape(nr * nc, 16)[i * nc + j]
        u = (r - self.rmin) / self.dr - i.astype(r.dtype)
        v = (z - self.zmin) / self.dz - j.astype(r.dtype)
        psi_val, _, _ = eval_bicubic_jet_block(psi_block, u, v,
                                               self.dr, self.dz)
        npsi, nprof = self.profile_coeffs.shape[:2]
        pidx = table_index_1d(psi_val, self.dpsi, self.psimin, npsi)
        prof_block = self.profile_coeffs.reshape(npsi, nprof * 4)[pidx]
        prof_block = prof_block.reshape(jnp.shape(pidx) + (nprof, 4))
        f = r.dtype
        return FrozenCellEfit(
            psi_block=psi_block, iu=i.astype(f), jv=j.astype(f),
            prof_block=prof_block, pidx=pidx.astype(f), base=self)

    def in_domain(self, x, y, z):
        """Whether each point is finite and inside the psi table's (R, Z)
        box - a trace can leave it and go on with extrapolated fields."""
        r = jnp.sqrt(x * x + y * y)
        nr, nz = self.psi_coeffs.shape[:2]
        return (jnp.isfinite(r) & (r >= self.rmin)
                & (r <= self.rmin + self.dr * nr)
                & (z >= self.zmin) & (z <= self.zmin + self.dz * nz))

    def characteristic_field(self):
        """|B| at the magnetic axis, found by Newton on the normalized flux
        from the seed (1.7, 0, 0) with step 0.1
        (equilibrium.hpp:1584-1615)."""

        def fl(xa, za):
            p = jnp.stack([xa, jnp.zeros_like(xa), za])
            return (self.psi(p) - self.psimin) / self.dpsi

        x0 = jnp.asarray(1.7, dtype=self.psi_coeffs.dtype)
        z0 = jnp.asarray(0.0, dtype=self.psi_coeffs.dtype)
        (xa, za), _, _ = newton_solve_multi(
            fl, (x0, z0), tolerance=1.0e-30, max_iterations=1000, step=0.1)
        pos = jnp.stack([xa, jnp.zeros_like(xa), za])
        b = self.magnetic_field(pos)
        return jnp.sqrt(jnp.sum(b * b))


def _block_jet2(block, u, v, dr, dz):
    """Value + first + second derivatives of the bicubic from one (..., 16)
    block: (psi, psi_r, psi_z, psi_rr, psi_rz, psi_zz).  Pure polynomials
    over the same block as eval_bicubic_jet_block - the 'second jet' the
    analytic-tangent rule below needs."""
    b = block.reshape(block.shape[:-1] + (4, 4))
    v_ = v[..., None] if jnp.ndim(v) else v
    ca = b[..., 0] + v_ * (b[..., 1] + v_ * (b[..., 2] + v_ * b[..., 3]))
    cb = b[..., 1] + v_ * (2.0 * b[..., 2] + 3.0 * v_ * b[..., 3])
    cc = 2.0 * b[..., 2] + 6.0 * v_ * b[..., 3]
    val = ca[..., 0] + u * (ca[..., 1] + u * (ca[..., 2] + u * ca[..., 3]))
    p_u = ca[..., 1] + u * (2.0 * ca[..., 2] + 3.0 * u * ca[..., 3])
    p_v = cb[..., 0] + u * (cb[..., 1] + u * (cb[..., 2] + u * cb[..., 3]))
    p_uu = 2.0 * ca[..., 2] + 6.0 * u * ca[..., 3]
    p_uv = cb[..., 1] + u * (2.0 * cb[..., 2] + 3.0 * u * cb[..., 3])
    p_vv = cc[..., 0] + u * (cc[..., 1] + u * (cc[..., 2] + u * cc[..., 3]))
    return (val, p_u / dr, p_v / dz, p_uu / (dr * dr),
            p_uv / (dr * dz), p_vv / (dz * dz))


def _make_frozen_pq_jet(base):
    """Analytic-jet plasma_quantities for the frozen path (VERDICT r4
    next-5): a jax.custom_jvp whose tangent rule is a hand-derived
    jet-linear map instead of autodiff through the polynomial/algebra
    chain - the XLA-level version of the round-3 VMEC geometry-jet
    pattern (pallas/vmec_geom.py custom_jvp).  Under the trace gradient
    (reverse over the RHS's grad-of-D), jax linearizes this rule once per
    evaluation point and transposes the LINEAR map, so the backward pass
    consumes precomputed jet entries (matvecs) rather than re-deriving
    and transposing the full chain.

    Differentiable in positions AND blocks (the bicubic/profile values
    are linear in their coefficients, so block tangents are the same
    Horner over the tangent blocks - table gradients stay exact, as the
    config5 test pins); iu/jv/pidx tangents are ignored (frozen indices:
    the reference's piecewise-constant-in-index semantics,
    piecewise.hpp:241-243)."""
    dr, dz, dpsi = base.dr, base.dz, base.dpsi
    rmin, zmin, psimin = base.rmin, base.zmin, base.psimin
    nes, tes, ps = base.ne_scale, base.te_scale, base.pres_scale
    q = 1.60218e-19                # reference's rounded q + ni=te quirk

    def _prof(block, up):
        """Profile Horner values + d/dup over one (..., 4, 4) block."""
        u_ = up[..., None] if jnp.ndim(up) else up
        val = (block[..., 0] + u_ * (block[..., 1]
               + u_ * (block[..., 2] + u_ * block[..., 3])))
        dv = (block[..., 1] + u_ * (2.0 * block[..., 2]
              + 3.0 * u_ * block[..., 3]))
        return val, dv

    @jax.custom_jvp
    def pq(psi_block, prof_block, iu, jv, pidx, x, y, z):
        r = jnp.sqrt(x * x + y * y)
        u = (r - rmin) / dr - iu
        v = (z - zmin) / dz - jv
        psi_val, dpsi_dr, dpsi_dz = eval_bicubic_jet_block(
            psi_block, u, v, dr, dz)
        up = (psi_val - psimin) / dpsi - pidx
        vals, _ = _prof(prof_block, up)
        ne = nes * vals[..., 0]
        te = tes * vals[..., 1]
        pres = ps * vals[..., 2]
        fpol = vals[..., 3]
        br = dpsi_dz / r
        bp = fpol / r
        bz = -dpsi_dr / r
        c, s = x / r, y / r
        ti = (pres - ne * te * q) / (te * q)
        return (br * c - bp * s, br * s + bp * c, bz, ne, te, ti)

    @pq.defjvp
    def pq_jvp(primals, tangents):
        psi_block, prof_block, iu, jv, pidx, x, y, z = primals
        tC, tQ, _, _, _, tx, ty, tz = tangents

        r = jnp.sqrt(x * x + y * y)
        c, s = x / r, y / r
        u = (r - rmin) / dr - iu
        v = (z - zmin) / dz - jv
        psi_val, psi_r, psi_z, psi_rr, psi_rz, psi_zz = _block_jet2(
            psi_block, u, v, dr, dz)
        up = (psi_val - psimin) / dpsi - pidx
        vals, dvals = _prof(prof_block, up)
        ne = nes * vals[..., 0]
        te = tes * vals[..., 1]
        pres = ps * vals[..., 2]
        fpol = vals[..., 3]
        br = psi_z / r
        bp = fpol / r
        bz = -psi_r / r
        ti = (pres - ne * te * q) / (te * q)
        out = (br * c - bp * s, br * s + bp * c, bz, ne, te, ti)

        # --- tangents: linear in (tx, ty, tz, tC, tQ) --------------------
        tr = c * tx + s * ty
        tu, tv = tr / dr, tz / dz
        # block tangents: the SAME jet over the tangent coefficients
        # (bicubic value is linear in its block)
        pt, pt_r, pt_z, _, _, _ = _block_jet2(tC, u, v, dr, dz)
        tpsi = psi_r * tr + psi_z * tz + pt
        tpsi_r = psi_rr * tr + psi_rz * tz + pt_r
        tpsi_z = psi_rz * tr + psi_zz * tz + pt_z
        tup = tpsi / dpsi
        qt, _ = _prof(tQ, up)       # profile linear in its block
        tq_all = dvals * (tup[..., None] if jnp.ndim(tup) else tup) + qt
        tne = nes * tq_all[..., 0]
        tte = tes * tq_all[..., 1]
        tpres = ps * tq_all[..., 2]
        tfpol = tq_all[..., 3]
        tc = (tx - c * tr) / r
        ts = (ty - s * tr) / r
        tbr = (tpsi_z - br * tr) / r
        tbp = (tfpol - bp * tr) / r
        tbz = (-tpsi_r - bz * tr) / r
        tbx = tbr * c + br * tc - tbp * s - bp * ts
        tby = tbr * s + br * ts + tbp * c + bp * tc
        tti = tpres / (te * q) - tne - pres * tte / (q * te * te)
        return out, (tbx, tby, tbz, tne, tte, tti)

    return pq


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrozenCellEfit(Equilibrium):
    """Cell-frozen view for shared-gather RK stepping (narrowed contract).

    ``EfitEquilibrium.freeze_cells(pos)`` gathers each ray's bicubic psi
    block and fused profile block ONCE (at the RK substep's base state);
    this view then serves every stage's ``plasma_quantities`` from those
    blocks with cell-local coordinates that may run slightly past
    [0, 1).  Contract:

      * valid when stage positions stay within O(dt * v_g) of the base
        point - the RK stages of one substep.  When a stage crosses a
        cell boundary the base cell's polynomial extrapolates; cubic
        pieces are C2, so the deviation from the true neighbouring
        polynomial is |third-derivative jump| * delta^3 / 6 with delta
        the crossing depth in cell units (bench dt: drift <= 1e-4 m vs
        0.027 m cells -> delta <= 4e-3, error ~ 1e-8 relative, far
        below f32 resolution; measured endpoint validation in
        tests/test_efit.py and NOTES_r4);
      * the profile cell is frozen from the base state's psi likewise;
      * requires cell_local tables.

    Reference analogue: USE_INDEX_CACHE (piecewise.hpp, CMakeLists.txt:
    8-17) caches table indices within one kernel; this freezes index AND
    coefficient block across the stages of a substep, deleting 3/4 of
    rk4's table gathers (the binding resource of the EFIT step kernel -
    NOTES_r3 profile account).
    """
    psi_block: jax.Array       # (..., 16) bicubic coefficients
    iu: jax.Array              # frozen r-cell index (as float)
    jv: jax.Array              # frozen z-cell index
    prof_block: jax.Array      # (..., 4, 4) [profile, power]
    pidx: jax.Array            # frozen psi-cell index (as float)
    base: EfitEquilibrium

    @property
    def ion_masses(self):
        return self.base.ion_masses

    @property
    def ion_charges(self):
        return self.base.ion_charges

    def plasma_quantities(self, pos):
        base = self.base
        x, y, z = pos[0], pos[1], pos[2]
        if base.custom_jet:
            bx, by, bz, ne, te, ti = _make_frozen_pq_jet(base)(
                self.psi_block, self.prof_block, self.iu, self.jv,
                self.pidx, x, y, z)
            return PlasmaQuantities(b=jnp.stack([bx, by, bz]), ne=ne,
                                    te=te, ni=(te,), ti=(ti,))
        r = jnp.sqrt(x * x + y * y)
        u = (r - base.rmin) / base.dr - self.iu
        v = (z - base.zmin) / base.dz - self.jv
        psi_val, dpsi_dr, dpsi_dz = eval_bicubic_jet_block(
            self.psi_block, u, v, base.dr, base.dz)
        up = (psi_val - base.psimin) / base.dpsi - self.pidx
        vals = eval_cubic_multi_block(self.prof_block, up)
        ne = base.ne_scale * vals[..., 0]
        te = base.te_scale * vals[..., 1]
        pres = base.pres_scale * vals[..., 2]
        fpol = vals[..., 3]

        # same named-residual labels as the base path, so
        # Solver(remat_policy="spline_jet") keeps saving the jet products
        # when frozen_cells is on (without them save_only_these_names
        # would silently save nothing and degrade to full recompute)
        from jax.ad_checkpoint import checkpoint_name
        psi_val, dpsi_dr, dpsi_dz, ne, te, pres, fpol = [
            checkpoint_name(a, "spline_jet")
            for a in (psi_val, dpsi_dr, dpsi_dz, ne, te, pres, fpol)]

        br = dpsi_dz / r
        bp = fpol / r
        bz = -dpsi_dr / r
        c, s = x / r, y / r
        b = jnp.stack([br * c - bp * s, br * s + bp * c, bz])

        q = 1.60218e-19          # reference's rounded q + ni=te quirk
        ni = te
        ti = (pres - ne * te * q) / (ni * q)
        return PlasmaQuantities(b=b, ne=ne, te=te, ni=(ni,), ti=(ti,))


def make_efit(source, dtype=jnp.float64, replicate_reference_quirks=True,
              cell_local=True, custom_jet=False):
    """Load an EFIT equilibrium (make_efit, equilibrium.hpp:1627-1844) from
    a spline file's path or from the mapping of its tables
    (tools.make_splines.efit_tables, tokamak_tables).

    ``replicate_reference_quirks``: the reference's efit constructor
    initializes the ne_c0/ne_c1 tables from the *te* tables
    (equilibrium.hpp:1478 - `ne_c0(te_c0), ne_c1(te_c1)`), and the golden
    data was generated against that behaviour.  True (default) replicates
    it for trajectory/golden parity; False loads the physically-intended
    tables.

    ``cell_local``: rebase the coefficient tables to cell-local coordinates
    at load time (extended precision).  The file stores polynomials in the
    global normalized coordinate, whose f64 evaluation is ill-conditioned
    (terms up to ~4e7 times the value cancel in efit.nc's psi tables, giving
    ~4e-9 relative psi error and ~2e-8 div(B) residuals).  The rebased form
    evaluates to near machine accuracy.  Default True; set False for
    bit-level parity with the reference's evaluation order.
    """
    with open_tables(source) as arr:
        psi = np.stack([
            np.stack([arr(f"psi_c{a}{b}") for b in range(4)])
            for a in range(4)])                      # (4, 4, nr, nz)

        def stack1d(prefix):
            return np.stack([arr(f"{prefix}_c{i}") for i in range(4)])

        ne = stack1d("ne")
        te = stack1d("te")
        if replicate_reference_quirks:
            ne = np.stack([te[0], te[1], ne[2], ne[3]])

        pres = stack1d("pressure")
        fpol = stack1d("fpol")
        if cell_local:
            psi = rebase_cells_2d(psi)
            ne, te = rebase_cells_1d(ne), rebase_cells_1d(te)
            pres, fpol = rebase_cells_1d(pres), rebase_cells_1d(fpol)

        psi = to_cell_major_2d(psi)
        ne, te = to_cell_major_1d(ne), to_cell_major_1d(te)
        pres, fpol = to_cell_major_1d(pres), to_cell_major_1d(fpol)
        profile = np.stack([ne, te, pres, fpol], axis=1)   # (n, 4, 4)

        return EfitEquilibrium(
            psi_coeffs=jnp.asarray(psi, dtype=dtype),
            ne_coeffs=jnp.asarray(ne, dtype=dtype),
            te_coeffs=jnp.asarray(te, dtype=dtype),
            pres_coeffs=jnp.asarray(pres, dtype=dtype),
            fpol_coeffs=jnp.asarray(fpol, dtype=dtype),
            profile_coeffs=jnp.asarray(profile, dtype=dtype),
            cell_local=cell_local,
            custom_jet=custom_jet,
            psimin=float(arr("psimin")),
            dpsi=float(arr("dpsi")),
            rmin=float(arr("rmin")),
            dr=float(arr("dr")),
            zmin=float(arr("zmin")),
            dz=float(arr("dz")),
            ne_scale=float(arr("ne_scale")),
            te_scale=float(arr("te_scale")),
            pres_scale=float(arr("pres_scale")),
        )
