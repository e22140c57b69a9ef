"""Hamiltonian ray equations from the dispersion relation via jax.grad.

Counterpart of ``dispersion::dispersion_interface``
(reference: graph_framework/dispersion.hpp:1319-1448).  The reference builds

    dx/dt = -D_k / D_w
    dk/dt = (D_x - D_kvec . dkvec/dx) / D_w     (its generalized-coordinate
                                                 "correction", :1392-1433)

by symbolic differentiation of one big expression DAG; here the same
quantities come from a single reverse-mode pass over the scalar function

    F(w, kcov, pos) = D(w, kvec(kcov, pos), pos)

with ``kvec(kcov, pos) = kx e^1(pos) + ky e^2(pos) + kz e^3(pos)``
(dispersion.hpp:1387-1389).

Generalized coordinates - a deliberate deviation from the reference
------------------------------------------------------------------
The coordinates x^i and the *covariant* components k_i are canonically
conjugate, so Hamilton's equations in these variables are simply

    dx^i/dt = -dF/dk_i / dF/dw
    dk_i/dt = +dF/dx^i / dF/dw          (TOTAL x-derivative, including the
                                         basis dependence inside kvec)

which conserve D(x, k) = 0 along the ray exactly (Poisson-bracket
antisymmetry).  The reference instead subtracts the basis term
(D_kvec . dkvec/dx), derived by expanding dk/dt = sum k_i' e^i while
neglecting that the e^i themselves rotate along the ray
(dispersion.hpp "Generalized to arbitrary coordinates" docs).  That form
drifts off the dispersion surface at a rate independent of the integrator
step (measured: |D| ~ 6e-4 after t = 4e-4 on a VMEC cold-plasma trace,
versus 1e-11 for the canonical form with identical stepping; the reference
has no VMEC golden test to catch this).  In cartesian coordinates the basis
is constant and both forms coincide - which is why every reference test
still passes.  ``make_ray_rhs(..., reference_correction=True)`` reproduces
the reference's literal equations for comparison runs.

Complex dtypes use holomorphic gradients (the dispersion stack is built
from holomorphic primitives), matching the reference's symbolic d/dz.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class RayState(NamedTuple):
    """Per-ray phase-space state; each leaf has shape (num_rays,).

    Mirrors the eight variables of the reference's solver kernel
    (solver.hpp:303-349): time, frequency, position, covariant wave number.
    """
    t: jax.Array
    w: jax.Array
    x: jax.Array
    y: jax.Array
    z: jax.Array
    kx: jax.Array
    ky: jax.Array
    kz: jax.Array

    @property
    def pos(self):
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @property
    def kcov(self):
        return jnp.stack([self.kx, self.ky, self.kz], axis=-1)


class RayDerivatives(NamedTuple):
    """dx/dt, dk/dt and the path-length rate ds/dt = |dx/dt|
    (dispersion.hpp:1436-1438)."""
    dxdt: jax.Array
    dydt: jax.Array
    dzdt: jax.Array
    dkxdt: jax.Array
    dkydt: jax.Array
    dkzdt: jax.Array

    @property
    def dsdt(self):
        return jnp.sqrt(self.dxdt * self.dxdt + self.dydt * self.dydt
                        + self.dzdt * self.dzdt)


def dispersion_residual(dispersion: Callable, eq):
    """Per-ray D evaluated at the state (for Newton init and the residual
    output; dispersion.hpp:1482-1486 returns D*D - we return D and square
    at the call site).

    For cartesian equilibria this function is batched-polymorphic: the
    dispersion stack keeps the component axis leading (see
    dispersion._vdot), so passing (num_rays,) arrays evaluates all rays in
    one lane-major pass with no vmap.
    """

    def d_one(t, w, x, y, z, kx, ky, kz):
        pos = jnp.stack([x, y, z])
        kcov = jnp.stack([kx, ky, kz])
        geq = eq.bind_point(pos)       # one shared-geometry evaluation
        kvec = geq.kvec(kcov, pos)
        return dispersion(w, kvec, pos, t, geq)

    return d_one


def make_ray_rhs(dispersion: Callable, eq, *, holomorphic=None,
                 reference_correction: bool = False):
    """Build the vectorized ray right-hand side.

    Returns ``rhs(state) -> RayDerivatives`` with each output of shape
    (num_rays,).  One reverse-mode pass per ray produces all seven
    derivatives (D_w, D_kx, D_ky, D_kz, D_x, D_y, D_z); the reference
    instead instantiated seven symbolic derivative graphs
    (dispersion.hpp:1404-1412).

    ``reference_correction``: use the reference's literal generalized-
    coordinate equations (subtracting D_kvec . dkvec/dx) instead of the
    canonical form; see the module docstring.  No effect for cartesian
    equilibria.

    Layout: for cartesian equilibria the whole ensemble is evaluated
    BATCHED - vectors keep the component axis leading, every intermediate
    is a full (num_rays,) array, and the seven per-ray derivatives come
    from one reverse pass over sum(D) (per-ray independence makes
    grad-of-sum the per-ray gradient, as in ops.newton._elementwise_grad).
    A vmapped per-ray formulation would materialize (num_rays, 3)
    intermediates with a 3-wide trailing axis.  The equilibrium stack is batched-polymorphic
    (component axis leading), so this applies to EFIT and VMEC alike; only
    ``reference_correction`` on a non-cartesian equilibrium falls back to
    the per-ray vmapped path.
    """
    batched_ok = getattr(eq, "supports_batched", eq.is_cartesian)()
    if batched_ok and not (reference_correction and not eq.is_cartesian()):
        def rhs_batched(state: RayState) -> RayDerivatives:
            holo = holomorphic
            if holo is None:
                holo = jnp.iscomplexobj(state.w)

            t = state.t

            def F(w, x, y, z, kx, ky, kz):
                pos = jnp.stack([x, y, z])
                kcov = jnp.stack([kx, ky, kz])
                # bind once: kvec's basis and the dispersion's B share ONE
                # geometry evaluation (and one reverse-mode path) instead
                # of relying on XLA CSE to merge duplicate subtrees
                geq = eq.bind_point(pos)
                kvec = geq.kvec(kcov, pos)
                return jnp.sum(dispersion(w, kvec, pos, t, geq))

            dw, dx, dy, dz, dkx, dky, dkz = jax.grad(
                F, argnums=(0, 1, 2, 3, 4, 5, 6), holomorphic=holo)(
                state.w, state.x, state.y, state.z,
                state.kx, state.ky, state.kz)
            return RayDerivatives(-dkx / dw, -dky / dw, -dkz / dw,
                                  dx / dw, dy / dw, dz / dw)

        return rhs_batched

    def rhs_one(t, w, x, y, z, kx, ky, kz):
        pos = jnp.stack([x, y, z])
        kcov = jnp.stack([kx, ky, kz])

        holo = holomorphic
        if holo is None:
            holo = jnp.iscomplexobj(w)

        if reference_correction and not eq.is_cartesian():
            # dispersion.hpp:1392-1433: separate the basis position so the
            # spatial gradient excludes the flow through kvec.
            def F(w_, kcov_, pos_k, pos_x):
                kvec = eq.kvec(kcov_, pos_k)
                return dispersion(w_, kvec, pos_x, t, eq)

            dDdw, dDdk, dDdx = jax.grad(
                F, argnums=(0, 1, 3), holomorphic=holo)(w, kcov, pos, pos)
        else:
            def F(w_, kcov_, pos_):
                geq = eq.bind_point(pos_)
                kvec = geq.kvec(kcov_, pos_)
                return dispersion(w_, kvec, pos_, t, geq)

            dDdw, dDdk, dDdx = jax.grad(
                F, argnums=(0, 1, 2), holomorphic=holo)(w, kcov, pos)

        dxdt = -dDdk / dDdw
        dkdt = dDdx / dDdw
        return RayDerivatives(dxdt[0], dxdt[1], dxdt[2],
                              dkdt[0], dkdt[1], dkdt[2])

    vrhs = jax.vmap(rhs_one)

    def rhs(state: RayState) -> RayDerivatives:
        return vrhs(state.t, state.w, state.x, state.y, state.z,
                    state.kx, state.ky, state.kz)

    return rhs


def residual_fn(dispersion: Callable, eq):
    """Vectorized D^2 residual of a RayState (solver residual output,
    solver.hpp:331)."""
    d_one = dispersion_residual(dispersion, eq)
    vd = d_one if getattr(eq, "supports_batched", eq.is_cartesian)() \
        else jax.vmap(d_one)

    def residual(state: RayState):
        d = vd(state.t, state.w, state.x, state.y, state.z,
               state.kx, state.ky, state.kz)
        return d * d

    return residual
