"""Offset-normalized cubic / bicubic spline evaluation (cell-major tables).

The reference stores cubic splines as four per-cell coefficient tables
(c0..c3) and evaluates the polynomial in the *global* normalized coordinate
u = (x - offset)/scale with the coefficients gathered from the cell
containing u (equilibrium.hpp ``build_1D_spline``, :1120-1131 - the
offset/scale algebra there is exactly the expansion of
c0 + c1*u + c2*u^2 + c3*u^3 in powers of raw x).  Bicubic surfaces use 16
tables c_ab and evaluate sum_ab c_ab * v^b * u^a (equilibrium.hpp
``efit::build_psi``, :1278-1313: four 1D splines in z combined cubically
in r).

Layout: tables here are CELL-MAJOR - all coefficients of one cell are
contiguous - and bicubic lookups use a single linearized index
``i*nz + j`` into a (ncells, 16) view: one contiguous-block gather per
point instead of a two-index strided gather over a [power, power, i, j]
stack - the layout analogue of the reference's texture/const-memory table
packing (piecewise.hpp:256-325).

  * 1D:    (n, 4)         [cell, power]
  * multi: (n, P, 4)      [cell, profile, power]
  * 2D:    (nr, nz, 4, 4) [i, j, u-power, v-power], gathered flat

Derivatives: coefficients are piecewise constant w.r.t. the coordinate
(tables.py), so autodiff differentiates the polynomial only - matching the
reference's symbolic ``df`` through ``piecewise_*`` nodes.
"""

import math

import numpy as np
import jax.numpy as jnp

from graph_framework_tpu.ops.tables import table_index_1d


def rebase_cells_1d(coeffs):
    """Rebase (4, n) global-coordinate cell tables to cell-local form.

    The file format stores polynomials in the *global* normalized coordinate
    u, which makes f64 evaluation ill-conditioned at large u (terms up to
    ~4e7 times the value cancel in the efit.nc psi tables).  Rebasing each
    cell's polynomial to t = u - i (t in [0, 1)) at load time - in extended
    precision, so the rebase itself doesn't reintroduce the cancellation -
    gives near-machine-accurate evaluation.  Pass the result (transposed to
    cell-major) to :func:`eval_cubic_1d` with ``local=True``.
    """
    c = np.asarray(coeffs, dtype=np.longdouble)
    n = c.shape[1]
    cells = np.arange(n, dtype=np.longdouble)
    out = np.zeros((4, n), dtype=np.float64)
    for k in range(4):
        acc = np.zeros(n, dtype=np.longdouble)
        for i in range(k, 4):
            acc += math.comb(i, k) * c[i] * cells ** (i - k)
        out[k] = acc.astype(np.float64)
    return out


def rebase_cells_2d(coeffs):
    """Rebase a (4, 4, nr, nc) global-coordinate bicubic stack to
    cell-local coordinates in both directions (see :func:`rebase_cells_1d`).
    """
    c = np.asarray(coeffs, dtype=np.longdouble)
    _, _, nr, nc = c.shape
    iu = np.arange(nr, dtype=np.longdouble)[:, None]
    jv = np.arange(nc, dtype=np.longdouble)[None, :]
    out = np.zeros((4, 4, nr, nc), dtype=np.float64)
    for k in range(4):
        for l in range(4):
            acc = np.zeros((nr, nc), dtype=np.longdouble)
            for a in range(k, 4):
                for b in range(l, 4):
                    acc += (math.comb(a, k) * math.comb(b, l)
                            * c[a, b] * iu ** (a - k) * jv ** (b - l))
            out[k, l] = acc.astype(np.float64)
    return out


def to_cell_major_1d(coeffs):
    """(4, n) file/rebase orientation -> (n, 4) runtime layout."""
    return np.ascontiguousarray(np.asarray(coeffs).T)


def to_cell_major_2d(coeffs):
    """(4, 4, nr, nc) file/rebase orientation -> (nr, nc, 4, 4) runtime
    layout (one contiguous 16-coefficient block per cell)."""
    return np.ascontiguousarray(np.asarray(coeffs).transpose(2, 3, 0, 1))


def spline_1d(c0, c1, c2, c3, x, scale, offset, local=False):
    """Evaluate a 1D cubic spline from four separate coefficient tables.

    Equivalent to ``equilibrium::build_1D_spline`` applied to four
    ``piecewise_1D`` gathers (equilibrium.hpp:1120-1131): the value is the
    Horner evaluation c0[i] + u*(c1[i] + u*(c2[i] + u*c3[i])) with
    u = (x - offset)/scale and i = clamp(trunc(u)).  This is the literal
    four-gather form (kept for the embedding/test surface); the hot paths
    use the fused cell-major :func:`eval_cubic_1d`.
    """
    u = (x - offset) / scale
    idx = table_index_1d(x, scale, offset, c0.shape[0])
    if local:
        u = u - idx.astype(u.dtype)
    a0 = jnp.take(c0, idx, axis=0)
    a1 = jnp.take(c1, idx, axis=0)
    a2 = jnp.take(c2, idx, axis=0)
    a3 = jnp.take(c3, idx, axis=0)
    return a0 + u * (a1 + u * (a2 + u * a3))


def eval_cubic_1d(coeffs, x, scale, offset, local=False):
    """Evaluate a 1D cubic spline from a cell-major (n, 4) table: one
    contiguous 4-value block gather per point."""
    u = (x - offset) / scale
    idx = table_index_1d(x, scale, offset, coeffs.shape[0])
    if local:
        u = u - idx.astype(u.dtype)
    b = coeffs[idx]                               # (..., 4)
    return b[..., 0] + u * (b[..., 1] + u * (b[..., 2] + u * b[..., 3]))


def eval_cubic_multi(coeffs, x, scale, offset, local=False):
    """Evaluate several cubic splines sharing one argument and index.

    ``coeffs``: (n, P, 4) cell-major.  One gather fetches the contiguous
    (P, 4) coefficient block per point - the EFIT profile splines (ne, te,
    pressure, fpol) all key on the same psi, so fusing them quarters the
    gather count of the hot loop.  Returns shape (...batch, P).
    """
    u = (x - offset) / scale
    n, P = coeffs.shape[0], coeffs.shape[1]
    idx = table_index_1d(x, scale, offset, n)
    if local:
        u = u - idx.astype(u.dtype)
    # gather FLAT (one trailing offset dim) and reshape back; the
    # reshape is free.
    b = coeffs.reshape(n, P * 4)[idx]
    b = b.reshape(jnp.shape(idx) + (P, 4))        # (..., P, 4)
    u = u[..., None] if jnp.ndim(u) else u
    return b[..., 0] + u * (b[..., 1] + u * (b[..., 2] + u * b[..., 3]))


def _flat_block_2d(coeffs, x, x_scale, x_offset, y, y_scale, y_offset,
                   local):
    """Shared index/gather for the bicubic evaluators: one linearized-index
    gather of the cell's contiguous 16-coefficient block."""
    nr, nc = coeffs.shape[:2]
    u = (x - x_offset) / x_scale
    v = (y - y_offset) / y_scale
    i = table_index_1d(x, x_scale, x_offset, nr)
    j = table_index_1d(y, y_scale, y_offset, nc)
    if local:
        u = u - i.astype(u.dtype)
        v = v - j.astype(v.dtype)
    block = coeffs.reshape(nr * nc, 16)[i * nc + j]   # (..., 16)
    return block, u, v


def _block44(block, v):
    """Reshape a flat (..., 16) block to (..., a, b) and broadcast v.

    The Horner runs vectorized over the (..., 4) axis instead of over 16
    scalar column slices."""
    b = block.reshape(block.shape[:-1] + (4, 4))
    v_ = v[..., None] if jnp.ndim(v) else v
    return b, v_


def eval_bicubic_2d(coeffs, x, x_scale, x_offset, y, y_scale, y_offset,
                    local=False):
    """Evaluate a bicubic spline surface from a cell-major (nr, nc, 4, 4)
    table.

    ``coeffs[i, j, a, b]`` is the u^a * v^b coefficient of cell (i, j) where
    u = (x - x_offset)/x_scale indexes rows and v = (y - y_offset)/y_scale
    indexes columns.  Mirrors ``efit::build_psi``
    (equilibrium.hpp:1278-1313): 16 piecewise_2D gathers, a cubic in v per
    row of coefficients, then a cubic in u - but fetched as ONE contiguous
    16-value block per point via a linearized index (see module docstring
    for the measured 2.8x gather speedup).
    """
    block, u, v = _flat_block_2d(coeffs, x, x_scale, x_offset,
                                 y, y_scale, y_offset, local)
    b, v_ = _block44(block, v)
    ca = b[..., 0] + v_ * (b[..., 1] + v_ * (b[..., 2] + v_ * b[..., 3]))
    return (ca[..., 0] + u * (ca[..., 1]
            + u * (ca[..., 2] + u * ca[..., 3])))


def eval_bicubic_jet_block(block, u, v, x_scale, y_scale):
    """Jet polynomial part of :func:`eval_bicubic_jet` over an
    already-gathered (..., 16) block and CELL-LOCAL coordinates (u, v).

    Split out so frozen-cell stepping (models/efit.freeze_cells) can
    re-evaluate RK stages against one base-state gather; u/v may run
    slightly outside [0, 1) there (polynomial extrapolation across at
    most a fraction of the neighbouring cell - the narrowed contract is
    documented at the caller)."""
    b, v_ = _block44(block, v)
    ca = b[..., 0] + v_ * (b[..., 1] + v_ * (b[..., 2] + v_ * b[..., 3]))
    cb = b[..., 1] + v_ * (2.0 * b[..., 2] + 3.0 * v_ * b[..., 3])
    val = (ca[..., 0] + u * (ca[..., 1]
           + u * (ca[..., 2] + u * ca[..., 3])))
    dval_du = ca[..., 1] + u * (2.0 * ca[..., 2] + 3.0 * u * ca[..., 3])
    dval_dv = (cb[..., 0] + u * (cb[..., 1]
               + u * (cb[..., 2] + u * cb[..., 3])))
    return val, dval_du / x_scale, dval_dv / y_scale


def eval_bicubic_jet(coeffs, x, x_scale, x_offset, y, y_scale, y_offset,
                     local=False):
    """Bicubic value and first derivatives from ONE coefficient gather.

    Returns (value, d/dx, d/dy).  The derivative polynomials are evaluated
    analytically from the same gathered 16-value block, so callers needing
    the spline gradient (the B field, equilibrium.hpp:1364-1382) avoid a
    nested jax.grad whose transpose the outer ray-equation gradient would
    then have to differentiate through.  The jet itself is built from
    gathers + polynomials only, so higher derivatives via plain autodiff
    remain exact and cheap.
    """
    block, u, v = _flat_block_2d(coeffs, x, x_scale, x_offset,
                                 y, y_scale, y_offset, local)
    return eval_bicubic_jet_block(block, u, v, x_scale, y_scale)


def eval_cubic_multi_block(block, u):
    """Polynomial part of :func:`eval_cubic_multi` over an
    already-gathered (..., P, 4) block and cell-local coordinate u."""
    u = u[..., None] if jnp.ndim(u) else u
    return (block[..., 0] + u * (block[..., 1]
            + u * (block[..., 2] + u * block[..., 3])))
