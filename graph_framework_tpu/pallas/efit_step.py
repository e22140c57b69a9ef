"""Frozen-window EFIT stepping as one Pallas kernel through Triton.

The XLA frozen-window path (solver.py ``frozen_cells`` + ``freeze_every``)
gathers each ray's spline blocks once per window and then runs the K
substeps of the window as a ``lax.scan``: one launch per substep, each
reading and writing the ray state (and re-reading the frozen blocks)
through device memory.  Within a window the right-hand side is
gather-free elementwise math over the blocks in hand, so one program per
block of rays can keep the state and the 16 + 16 coefficients in
registers for all K substeps:

  1. XLA gathers the frozen blocks at the window's base state
     (``EfitEquilibrium.freeze_cells``, the same freeze the XLA path
     uses, so the numerics agree by construction) and lays them out
     coefficient-leading, (16, N), so that each program's loads of one
     coefficient are contiguous;
  2. one ``pallas_call`` (``backend="triton"``) advances the window: each
     program loads its (B,) slice of the state and (16, B) slices of the
     coefficients, loops the rk2/rk4 stepper (optionally under the
     compensated double-word accumulator) K times, and stores the state
     once.

Device-memory traffic per ray per window drops from K state round trips
plus K block reads to one of each.

Reference analogue: the single fused "solver_kernel" launched per step
(cuda_context.hpp:524-529) - here fused across the substeps of a window,
which the reference never does (its kernel is one substep; the host
loops).

The dispersion algebra inside the kernel is the very Python the XLA path
traces (models/rays.make_ray_rhs, models/dispersion.*, ops/integrators.*,
ops/compensated.*).  It keeps 3-vectors as stacked (3, B) arrays, which
Triton cannot hold (its tensors have power-of-two sizes), so the substep
is first traced to a jaxpr and re-evaluated by :func:`unstack_call` with
every small leading axis split into a list of (B,) arrays.

Reverse mode: :func:`differentiable_window` gives the kernel a
``jax.custom_vjp`` whose backward is ``jax.vjp`` of the XLA frozen window,
with the spline tables as primal inputs, so launch-state and table
gradients both flow.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax._src.interpreters import partial_eval as pe
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton
from jax.extend.core import Literal

from graph_framework_tpu.models.equilibrium import PlasmaQuantities
from graph_framework_tpu.models.rays import RayState, make_ray_rhs
from graph_framework_tpu.ops.integrators import STEPPERS, INCREMENTS
from graph_framework_tpu.ops.compensated import (
    CompCarry, compensated_stepper)


class _FrozenView:
    """Equilibrium view over frozen coefficient rows.

    Same narrowed contract and algebra as ``models.efit.FrozenCellEfit``
    (cell-local polynomial evaluation against the window-base blocks,
    stages may extrapolate slightly past the cell), but the 16 bicubic and
    16 profile coefficients arrive as separate (B,) arrays instead of a
    trailing (..., 16) block axis.
    """

    def __init__(self, psi, prof, iu, jv, pidx, base):
        self.psi = psi          # 16 arrays: [a * 4 + b]
        self.prof = prof        # 16 arrays: [p * 4 + k]
        self.iu = iu
        self.jv = jv
        self.pidx = pidx
        self.base = base        # EfitEquilibrium (static scalars only)

    # -- protocol bits make_ray_rhs / dispersion need ---------------------
    @property
    def ion_masses(self):
        return self.base.ion_masses

    @property
    def ion_charges(self):
        return self.base.ion_charges

    @property
    def num_ion_species(self):
        return len(self.base.ion_masses)

    def is_cartesian(self):
        return True

    def supports_batched(self):
        return True

    def bind_point(self, pos):
        return self

    def kvec(self, kcov, pos):
        return kcov

    def plasma_quantities(self, pos):
        """FrozenCellEfit.plasma_quantities with the coefficient axis
        unrolled (models/efit.py; bicubic jet = ops/spline.py
        eval_bicubic_jet_block, profiles = eval_cubic_multi_block)."""
        base = self.base
        c = self.psi
        x, y, z = pos[0], pos[1], pos[2]
        r = jnp.sqrt(x * x + y * y)
        u = (r - base.rmin) / base.dr - self.iu
        v = (z - base.zmin) / base.dz - self.jv

        # cubic in v per u-power row, then cubic (and its derivative) in u
        ca = [c[4 * a + 0] + v * (c[4 * a + 1]
              + v * (c[4 * a + 2] + v * c[4 * a + 3])) for a in range(4)]
        cb = [c[4 * a + 1] + v * (2.0 * c[4 * a + 2]
              + 3.0 * v * c[4 * a + 3]) for a in range(4)]
        psi_val = ca[0] + u * (ca[1] + u * (ca[2] + u * ca[3]))
        dpsi_dr = (ca[1] + u * (2.0 * ca[2] + 3.0 * u * ca[3])) / base.dr
        dpsi_dz = (cb[0] + u * (cb[1] + u * (cb[2] + u * cb[3]))) / base.dz

        p = self.prof
        up = (psi_val - base.psimin) / base.dpsi - self.pidx
        vals = [p[4 * k + 0] + up * (p[4 * k + 1]
                + up * (p[4 * k + 2] + up * p[4 * k + 3]))
                for k in range(4)]
        ne = base.ne_scale * vals[0]
        te = base.te_scale * vals[1]
        pres = base.pres_scale * vals[2]
        fpol = vals[3]

        br = dpsi_dz / r
        bp = fpol / r
        bz = -dpsi_dr / r
        cr, sr = x / r, y / r      # algebraic rotation (models/efit.py)
        b = jnp.stack([br * cr - bp * sr, br * sr + bp * cr, bz])

        q = 1.60218e-19            # reference's rounded q + ni=te quirk
        ni = te
        ti = (pres - ne * te * q) / (ni * q)
        return PlasmaQuantities(b=b, ne=ne, te=te, ni=(ni,), ti=(ti,))


# ---------------------------------------------------------------------------
# Unstacking: (n, B) arrays -> lists of n (B,) arrays
# ---------------------------------------------------------------------------
class _Stack(tuple):
    """An (n, ...) array held as the tuple of its n leading slices."""


# parameters that name an axis: a primitive carrying one acts along a
# dimension and is not elementwise
_AXIS_PARAMS = {"axes", "axis", "dimension", "dimensions",
                "broadcast_dimensions", "dimension_numbers", "new_sizes",
                "start_indices", "padding_config", "permutation", "sizes"}


# call-like primitives: their body runs once on their operands, so it
# can be inlined (loops and conditionals are not among them)
_CALLS = {"pjit", "jit", "closed_call", "core_call", "custom_jvp_call",
          "custom_vjp_call", "custom_vjp_call_jaxpr", "remat",
          "checkpoint"}


def _call_jaxpr(eqn):
    """The inner jaxpr of a call-like primitive, or None."""
    if eqn.primitive.name not in _CALLS:
        return None
    for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
        inner = eqn.params.get(key)
        if inner is None:
            continue
        if hasattr(inner, "consts"):
            return inner.jaxpr, inner.consts
        return inner, ()
    return None


def _bcast(x, shape):
    return jax.lax.broadcast_in_dim(x, shape, tuple(
        range(len(shape) - jnp.ndim(x), len(shape))))


def _broadcast_rule(eqn, x):
    shape = eqn.params["shape"]
    dims = eqn.params["broadcast_dimensions"]
    if len(shape) < 2:
        return None
    n, rest = shape[0], tuple(shape[1:])
    if isinstance(x, _Stack):
        if dims[0] != 0:
            raise NotImplementedError("broadcast moving a stacked axis")
        parts = [_bcast(p, rest) for p in x]
        return _Stack(parts * n if len(parts) == 1 and n > 1 else parts)
    if dims and dims[0] == 0:
        raise NotImplementedError("broadcast stacking a traced vector")
    return _Stack([_bcast(x, rest)] * n)


def _concatenate_rule(eqn, *xs):
    if eqn.params["dimension"] != 0 or len(eqn.outvars[0].aval.shape) < 2:
        return None
    return _Stack(sum((tuple(x) for x in xs), ()))


def _slice_rule(eqn, x):
    if not isinstance(x, _Stack):
        return None
    start = eqn.params["start_indices"]
    limit = eqn.params["limit_indices"]
    strides = eqn.params["strides"] or (1,) * len(start)
    shape = eqn.invars[0].aval.shape
    if any(s != 0 or l != d or st != 1 for s, l, d, st in
           zip(start[1:], limit[1:], shape[1:], strides[1:])):
        raise NotImplementedError("slice of a stacked value along rays")
    return _Stack(x[start[0]:limit[0]:strides[0]])


def _squeeze_rule(eqn, x):
    if not isinstance(x, _Stack):
        return None
    if tuple(eqn.params["dimensions"]) != (0,) or len(x) != 1:
        raise NotImplementedError("squeeze of a non-leading axis")
    return x[0]


def _reshape_rule(eqn, x):
    out = tuple(eqn.outvars[0].aval.shape)
    if isinstance(x, _Stack):
        if len(x) == 1 and out == tuple(eqn.invars[0].aval.shape[1:]):
            return x[0]
        raise NotImplementedError(f"reshape of a stacked value to {out}")
    if len(out) == 2 and out[0] == 1:
        return _Stack([jnp.reshape(x, out[1:])])
    return None


def _split_rule(eqn, x):
    if not isinstance(x, _Stack):
        return None
    if eqn.params["axis"] != 0:
        raise NotImplementedError("split along rays")
    out, i = [], 0
    for size in eqn.params["sizes"]:
        out.append(_Stack(x[i:i + size]))
        i += size
    return out


def _pad_rule(eqn, x, pad_value):
    if not isinstance(x, _Stack):
        return None
    (lo, hi, interior), *rest = eqn.params["padding_config"]
    if interior or any(c != (0, 0, 0) for c in rest):
        raise NotImplementedError("pad of a stacked value along rays")
    fill = jnp.full_like(x[0], pad_value)
    return _Stack((fill,) * lo + tuple(x) + (fill,) * hi)


def _reduce_sum_rule(eqn, x):
    if not isinstance(x, _Stack):
        return None
    axes = tuple(eqn.params["axes"])
    if 0 not in axes:
        return _Stack([jnp.sum(p, axis=tuple(a - 1 for a in axes))
                       for p in x])
    total = functools.reduce(jnp.add, x)
    rest = tuple(a - 1 for a in axes if a)
    return jnp.sum(total, axis=rest) if rest else total


_RULES = {
    "broadcast_in_dim": _broadcast_rule,
    "concatenate": _concatenate_rule,
    "slice": _slice_rule,
    "squeeze": _squeeze_rule,
    "reshape": _reshape_rule,
    "split": _split_rule,
    "pad": _pad_rule,
    "reduce_sum": _reduce_sum_rule,
}


def _eval_unstacked(jaxpr, consts, args):
    env = {}

    def read(v):
        return v.val if isinstance(v, Literal) else env[v]

    def write(v, val):
        if len(v.aval.shape) >= 2 and not isinstance(val, _Stack):
            val = _Stack([val[i] for i in range(v.aval.shape[0])])
        env[v] = val

    for v, c in zip(jaxpr.constvars, consts):
        write(v, c)
    for v, a in zip(jaxpr.invars, args):
        write(v, a)
    for eqn in jaxpr.eqns:
        ins = [read(v) for v in eqn.invars]
        stacked = any(isinstance(x, _Stack) for x in ins)
        rule = _RULES.get(eqn.primitive.name)
        out = rule(eqn, *ins) if rule is not None else None
        if out is None:
            inner = _call_jaxpr(eqn)
            if inner is not None:
                out = _eval_unstacked(inner[0], inner[1], ins)
            elif not stacked:
                out = eqn.primitive.bind(*ins, **eqn.params)
            elif _AXIS_PARAMS & set(eqn.params) or any(
                    hasattr(p, "eqns") or hasattr(p, "jaxpr")
                    for p in eqn.params.values()):
                raise NotImplementedError(
                    f"{eqn.primitive.name} on a stacked value")
            else:
                # elementwise: apply per slice, broadcasting unstacked
                # operands and size-1 stacks
                n = max(len(x) for x in ins if isinstance(x, _Stack))
                per = [x * (n // len(x)) if isinstance(x, _Stack)
                       else (x,) * n for x in ins]
                res = [eqn.primitive.bind(*a, **eqn.params)
                       for a in zip(*per)]
                if eqn.primitive.multiple_results:
                    out = [_Stack(r) for r in zip(*res)]
                else:
                    out = _Stack(res)
        if eqn.primitive.multiple_results:
            for v, o in zip(eqn.outvars, out):
                write(v, o)
        else:
            write(eqn.outvars[0], out)
    return [read(v) for v in jaxpr.outvars]


def unstack_call(fn: Callable, args):
    """Evaluate ``fn(*args)`` with every (n, ...) intermediate held as a
    list of n arrays of the args' shape.

    ``fn`` is traced to a jaxpr over the args' shapes, dead code is
    dropped, and the jaxpr is re-evaluated primitive by primitive: stacks
    (``jnp.stack``), component slices, their transposes (pads) and sums
    over the component axis become list operations, and elementwise
    primitives apply slice by slice.  What is left binds only primitives
    over arrays shaped like the args, which a Triton kernel can hold.
    Returns the flat list of outputs.
    """
    closed = jax.make_jaxpr(fn)(
        *[jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a))
          for a in args])
    jaxpr, used = pe.dce_jaxpr(closed.jaxpr,
                               [True] * len(closed.jaxpr.outvars))
    kept = [a for a, u in zip(args, used) if u]
    outs = _eval_unstacked(jaxpr, closed.consts, kept)
    if any(isinstance(o, _Stack) for o in outs):
        raise NotImplementedError("a stacked value reached the output")
    return outs


# ---------------------------------------------------------------------------
# The window kernel
# ---------------------------------------------------------------------------
def _window_kernel(*refs, substep, steps, ns):
    """Advance one block of rays ``steps`` substeps against its frozen
    coefficients.  Ref order: state (8, or 16 with compensated lo
    words), psi (16, B), prof (16, B), iu, jv, pidx, then the state
    outputs."""
    psi_ref, prof_ref = refs[ns], refs[ns + 1]
    frozen = ([psi_ref[i, :] for i in range(16)]
              + [prof_ref[i, :] for i in range(16)]
              + [r[...] for r in refs[ns + 2:ns + 5]])

    def body(_, state):
        return tuple(unstack_call(substep, list(state) + frozen))

    state = tuple(r[...] for r in refs[:ns])
    state = jax.lax.fori_loop(0, steps, body, state)
    for r, v in zip(refs[ns + 5:], state):
        r[...] = v


def frozen_window_kernel(eq, dispersion: Callable, *, method, dt, steps,
                         compensated=False, block=128, num_warps=4,
                         interpret=False):
    """Build ``window(carry, psi_table, prof_table) -> carry``: one
    window-base freeze gather (against the given tables) plus one kernel
    launch advancing ``steps`` substeps.

    ``carry`` is a flat (N,) RayState (or CompCarry of two) with N a
    multiple of ``block`` (see :func:`pad_rays`).  ``block`` is the number
    of rays per program, a power of two; ``num_warps`` sets the threads
    per program against register pressure (each thread holds
    block / (32 * num_warps) rays' state and coefficients).
    ``interpret=True`` runs the kernel through the Pallas interpreter (the
    CPU test path).
    """
    if method not in ("rk2", "rk4"):
        raise ValueError("frozen window kernel supports rk2/rk4 only")
    if block < 1 or block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")

    def substep(*args):
        ns = 16 if compensated else 8
        state, (psi, prof, iu, jv, pidx) = args[:ns], (
            args[ns:ns + 16], args[ns + 16:ns + 32], *args[ns + 32:])
        view = _FrozenView(psi=list(psi), prof=list(prof), iu=iu, jv=jv,
                           pidx=pidx, base=eq)
        rhs = make_ray_rhs(dispersion, view, holomorphic=False)
        if compensated:
            step = compensated_stepper(
                lambda s: INCREMENTS[method](rhs, s, dt))
            out = step(CompCarry(RayState(*state[:8]),
                                 RayState(*state[8:])))
            return tuple(out.hi) + tuple(out.lo)
        return tuple(STEPPERS[method](rhs, RayState(*state), dt))

    ns = 16 if compensated else 8
    kernel = functools.partial(_window_kernel, substep=substep,
                               steps=steps, ns=ns)

    def window(carry, psi_table, prof_table):
        hi = carry.hi if compensated else carry
        n = hi.x.shape[0]
        if n % block:
            raise ValueError(f"num_rays={n} must be a multiple of "
                             f"block={block} (pad the ensemble; see "
                             "pad_rays)")
        feq = dataclasses.replace(
            eq, psi_coeffs=psi_table, profile_coeffs=prof_table
        ).freeze_cells(jnp.stack([hi.x, hi.y, hi.z]))
        psi = feq.psi_block.T                          # (16, n)
        prof = feq.prof_block.reshape(n, 16).T         # (16, n)
        leaves = (list(carry.hi) + list(carry.lo) if compensated
                  else list(carry))
        spec = pl.BlockSpec((block,), lambda i: (i,))
        cspec = pl.BlockSpec((16, block), lambda i: (0, i))
        outs = pl.pallas_call(
            kernel,
            grid=(n // block,),
            in_specs=[spec] * ns + [cspec, cspec] + [spec] * 3,
            out_specs=[spec] * ns,
            out_shape=[jax.ShapeDtypeStruct((n,), hi.x.dtype)] * ns,
            backend="triton",
            compiler_params=pl_triton.CompilerParams(
                num_warps=num_warps, num_stages=1),
            interpret=interpret,
            name="efit_frozen_window",
        )(*leaves, psi, prof, feq.iu, feq.jv, feq.pidx)
        if compensated:
            return CompCarry(RayState(*outs[:8]), RayState(*outs[8:]))
        return RayState(*outs)

    return window


def differentiable_window(kernel_window: Callable, xla_window: Callable,
                          eq):
    """``carry -> carry`` running ``kernel_window`` forward, with a
    ``custom_vjp`` whose backward is ``jax.vjp`` of
    ``xla_window(carry, eq)`` - the same window through XLA.  The spline
    tables are primal inputs, so table gradients flow too."""

    def xla(carry, psi_table, prof_table):
        return xla_window(carry, dataclasses.replace(
            eq, psi_coeffs=psi_table, profile_coeffs=prof_table))

    @jax.custom_vjp
    def window(carry, psi_table, prof_table):
        return kernel_window(carry, psi_table, prof_table)

    def fwd(carry, psi_table, prof_table):
        return (kernel_window(carry, psi_table, prof_table),
                (carry, psi_table, prof_table))

    def bwd(res, ct):
        return jax.vjp(xla, *res)[1](ct)

    window.defvjp(fwd, bwd)
    return lambda carry: window(carry, eq.psi_coeffs, eq.profile_coeffs)


def pad_rays(state, block=128):
    """Pad a flat RayState up to a multiple of ``block`` rays by repeating
    rays cyclically.  Returns (padded_state, original_n)."""
    n = state.x.shape[0]
    m = -(-n // block) * block
    if m == n:
        return state, n
    idx = jnp.arange(m) % n
    return jax.tree.map(lambda a: a[idx], state), n
