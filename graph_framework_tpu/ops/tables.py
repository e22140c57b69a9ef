"""Piecewise-constant table lookups (the reference's gather primitives).

Analogue of ``graph::piecewise_1D/piecewise_2D/index_1D`` (reference:
graph_framework/piecewise.hpp).  The reference emits the tables into
generated kernel source as ``__constant__`` arrays or binds CUDA/Metal
textures; here the tables are ordinary device arrays and the lookup is an
XLA gather.

Index semantics replicated exactly from the generated-kernel index expression
(piecewise.hpp ``compile_index``, :26-60):

    i = (uint) min(max((x - offset)/scale, 0), len-1)

i.e. normalize, clamp to the table range *as a float*, then truncate.  Because
the value is clamped non-negative before truncation, this equals
``clip(floor(u), 0, len-1)`` for all inputs.

Derivative semantics: the lookup is piecewise constant - its derivative with
respect to the argument is identically zero (piecewise.hpp ``df``, :241-243
returns ``is_match(x)``).  JAX gathers already have a zero gradient w.r.t. an
integer index, so plain autodiff through these functions reproduces the
reference's "derivatives flow through the spline polynomial only" behaviour
with no extra stop_gradient needed.  We still stop_gradient the normalized
coordinate used for indexing so that nothing (e.g. int-cast rules) can change
under future JAX versions.
"""

import jax
import jax.numpy as jnp


def _real(x):
    """Take the real part for complex arguments (piecewise.hpp compile_index
    wraps the normalized coordinate in ``real()`` for complex scalars)."""
    return x.real if jnp.iscomplexobj(x) else x


def table_index_1d(x, scale, offset, length):
    """Compute the clamped table index for coordinate ``x``.

    Mirrors the generated ``compile_index`` expression
    (piecewise.hpp:26-60): u = (x - offset)/scale, clamped to
    [0, length-1], truncated to int.
    """
    u = (_real(x) - offset) / scale
    u = jax.lax.stop_gradient(u)
    u = jnp.clip(u, 0.0, float(length - 1))
    return u.astype(jnp.int32)


def piecewise_1d(data, x, scale, offset):
    """Gather ``data[(x - offset)/scale]`` with clamped truncation.

    Equivalent of ``graph::piecewise_1D`` (piecewise.hpp:105-...).
    ``data``: (n,) table; ``x``: scalar or array of coordinates.
    """
    idx = table_index_1d(x, scale, offset, data.shape[0])
    return jnp.take(data, idx, axis=0)


def piecewise_2d(data, x, x_scale, x_offset, y, y_scale, y_offset):
    """Gather from a 2D table: rows indexed by ``x``, columns by ``y``.

    Equivalent of ``graph::piecewise_2D`` (piecewise.hpp:686-...), whose
    generated kernel computes ``i*num_cols + j`` with ``i`` from the first
    coordinate clamped to num_rows and ``j`` from the second clamped to
    num_cols (piecewise.hpp:1078-1125).

    ``data``: (num_rows, num_cols) table.
    """
    num_rows, num_cols = data.shape
    i = table_index_1d(x, x_scale, x_offset, num_rows)
    j = table_index_1d(y, y_scale, y_offset, num_cols)
    # one linearized index: a single-index gather instead of the strided
    # two-index form (see ops/spline.py).
    return data.reshape(-1)[i * num_cols + j]


def index_1d(values, x, scale, offset):
    """Gather from a *mutable* per-step array (PIC field gather).

    Equivalent of ``graph::index_1D`` (piecewise.hpp:1448-1755): identical
    index arithmetic to :func:`piecewise_1d` but the source is a runtime
    variable (e.g. the electric-field grid in xpic.cpp:80-93) instead of a
    baked-in constant table.  In JAX there is no distinction - both are traced
    array gathers - but the separate entry point keeps call sites aligned with
    the reference API.
    """
    idx = table_index_1d(x, scale, offset, values.shape[0])
    return jnp.take(values, idx, axis=0)
