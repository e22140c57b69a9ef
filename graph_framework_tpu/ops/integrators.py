"""Runge-Kutta / symplectic steppers over RayState pytrees.

Counterpart of the ``solver::rk2/rk4/adaptive_rk4/
split_simplextic`` classes (reference: graph_framework/solver.hpp:550-1131).
The reference re-derives the ray equations at shifted states by wrapping the
shifted expressions in pseudo-variables (solver.hpp:642-649, 811-855); in
JAX a substage is simply the RHS function applied to a shifted state - the
retracing is free and exact.

Every stepper maps ``(rhs, state, dt) -> next_state`` where ``dt`` is a
scalar or per-ray array in normalized time units (t' = c t, meters).
All steppers advance ``t`` by dt and leave ``w`` untouched.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from graph_framework_tpu.models.rays import RayState, RayDerivatives


def _shift(state: RayState, d: RayDerivatives, f, dt_shift=None) -> RayState:
    """state + f*derivs, advancing t by dt_shift (default f... explicit)."""
    return RayState(
        t=state.t + (0.0 if dt_shift is None else dt_shift),
        w=state.w,
        x=state.x + f * d.dxdt,
        y=state.y + f * d.dydt,
        z=state.z + f * d.dzdt,
        kx=state.kx + f * d.dkxdt,
        ky=state.ky + f * d.dkydt,
        kz=state.kz + f * d.dkzdt,
    )


def rk2_step(rhs: Callable, state: RayState, dt) -> RayState:
    """Heun's method (solver.hpp rk2:95-125): k1 at the state, k2 at
    state + k1, average."""
    d1 = rhs(state)
    s2 = _shift(state, d1, dt, dt_shift=dt)
    d2 = rhs(s2)
    half = dt / 2.0
    return RayState(
        t=state.t + dt,
        w=state.w,
        x=state.x + half * (d1.dxdt + d2.dxdt),
        y=state.y + half * (d1.dydt + d2.dydt),
        z=state.z + half * (d1.dzdt + d2.dzdt),
        kx=state.kx + half * (d1.dkxdt + d2.dkxdt),
        ky=state.ky + half * (d1.dkydt + d2.dkydt),
        kz=state.kz + half * (d1.dkzdt + d2.dkzdt),
    )


def rk4_step(rhs: Callable, state: RayState, dt) -> RayState:
    """Classical RK4 (solver.hpp rk4:263-330)."""
    half = dt / 2.0
    d1 = rhs(state)
    d2 = rhs(_shift(state, d1, half, dt_shift=half))
    d3 = rhs(_shift(state, d2, half, dt_shift=half))
    d4 = rhs(_shift(state, d3, dt, dt_shift=dt))
    sixth = dt / 6.0
    return RayState(
        t=state.t + dt,
        w=state.w,
        x=state.x + sixth * (d1.dxdt + 2.0 * (d2.dxdt + d3.dxdt) + d4.dxdt),
        y=state.y + sixth * (d1.dydt + 2.0 * (d2.dydt + d3.dydt) + d4.dydt),
        z=state.z + sixth * (d1.dzdt + 2.0 * (d2.dzdt + d3.dzdt) + d4.dzdt),
        kx=state.kx + sixth * (d1.dkxdt + 2.0 * (d2.dkxdt + d3.dkxdt)
                               + d4.dkxdt),
        ky=state.ky + sixth * (d1.dkydt + 2.0 * (d2.dkydt + d3.dkydt)
                               + d4.dkydt),
        kz=state.kz + sixth * (d1.dkzdt + 2.0 * (d2.dkzdt + d3.dkzdt)
                               + d4.dkzdt),
    )


def split_symplectic_step(rhs: Callable, state: RayState, dt) -> RayState:
    """Position-kick-position splitting (solver.hpp split_simplextic:
    1016-1130): half drift with dx/dt at the current k, full kick of k at
    the drifted position, half drift with dx/dt at the new k.

    Valid only for separable Hamiltonians (dx/dt independent of x, dk/dt
    independent of k); the reference asserts this symbolically
    (solver.hpp:1076-1094), see ``check_separable`` for the numeric
    equivalent.
    """
    half = dt / 2.0
    d1 = rhs(state)
    # half drift (positions only)
    s1 = RayState(t=state.t, w=state.w,
                  x=state.x + half * d1.dxdt,
                  y=state.y + half * d1.dydt,
                  z=state.z + half * d1.dzdt,
                  kx=state.kx, ky=state.ky, kz=state.kz)
    d2 = rhs(s1)
    # full kick (wave numbers only)
    s2 = RayState(t=s1.t, w=s1.w, x=s1.x, y=s1.y, z=s1.z,
                  kx=state.kx + dt * d2.dkxdt,
                  ky=state.ky + dt * d2.dkydt,
                  kz=state.kz + dt * d2.dkzdt)
    d3 = rhs(s2)
    return RayState(
        t=state.t + dt, w=state.w,
        x=s1.x + half * d3.dxdt,
        y=s1.y + half * d3.dydt,
        z=s1.z + half * d3.dzdt,
        kx=s2.kx, ky=s2.ky, kz=s2.kz)


def check_separable(rhs: Callable, state: RayState, rtol=1e-6) -> bool:
    """Numeric stand-in for the reference's symbolic separability assert
    (solver.hpp:1076-1094): finite-difference the drift rates (dx/dt)
    w.r.t. position and the kick rates (dk/dt) w.r.t. wave number at the
    given sample state; all cross-derivatives must vanish.

    Each 3x3 block is judged against its OWN rate scale (drift rates are
    O(group velocity) while kick rates can be 1e3x larger in physical
    units - a shared scale lets the kick magnitude mask real drift
    coupling), with a relative state bump (1e-4 of the field magnitude)
    and an absolute rtol floor so identically-zero blocks pass.
    """
    d0 = rhs(state)
    blocks = ((("x", "y", "z"), ("dxdt", "dydt", "dzdt")),
              (("kx", "ky", "kz"), ("dkxdt", "dkydt", "dkzdt")))
    ok = True
    for fields, comps in blocks:
        scale = max(max(float(jnp.max(jnp.abs(getattr(d0, c))))
                        for c in comps), 1e-30)
        for field in fields:
            v = getattr(state, field)
            eps = 1e-4 * max(float(jnp.max(jnp.abs(v))), 1.0)
            d = rhs(state._replace(**{field: v + eps}))
            for comp in comps:
                diff = float(jnp.max(jnp.abs(
                    getattr(d, comp) - getattr(d0, comp))))
                ok &= diff <= rtol * (scale + 1.0)
    return bool(ok)


def rk2_increment(rhs: Callable, state: RayState, dt) -> RayState:
    """Heun increment WITHOUT folding it into the state - the raw
    delta the compensated (double-word) accumulator needs (the rounding
    of ``state + delta`` is exactly the error it eliminates)."""
    d1 = rhs(state)
    d2 = rhs(_shift(state, d1, dt, dt_shift=dt))
    half = dt / 2.0
    return RayState(
        t=jnp.full_like(state.t, dt), w=jnp.zeros_like(state.w),
        x=half * (d1.dxdt + d2.dxdt),
        y=half * (d1.dydt + d2.dydt),
        z=half * (d1.dzdt + d2.dzdt),
        kx=half * (d1.dkxdt + d2.dkxdt),
        ky=half * (d1.dkydt + d2.dkydt),
        kz=half * (d1.dkzdt + d2.dkzdt),
    )


def rk4_increment(rhs: Callable, state: RayState, dt) -> RayState:
    """Classical RK4 increment (see rk2_increment for why unfolded)."""
    half = dt / 2.0
    d1 = rhs(state)
    d2 = rhs(_shift(state, d1, half, dt_shift=half))
    d3 = rhs(_shift(state, d2, half, dt_shift=half))
    d4 = rhs(_shift(state, d3, dt, dt_shift=dt))
    sixth = dt / 6.0
    return RayState(
        t=jnp.full_like(state.t, dt), w=jnp.zeros_like(state.w),
        x=sixth * (d1.dxdt + 2.0 * (d2.dxdt + d3.dxdt) + d4.dxdt),
        y=sixth * (d1.dydt + 2.0 * (d2.dydt + d3.dydt) + d4.dydt),
        z=sixth * (d1.dzdt + 2.0 * (d2.dzdt + d3.dzdt) + d4.dzdt),
        kx=sixth * (d1.dkxdt + 2.0 * (d2.dkxdt + d3.dkxdt) + d4.dkxdt),
        ky=sixth * (d1.dkydt + 2.0 * (d2.dkydt + d3.dkydt) + d4.dkydt),
        kz=sixth * (d1.dkzdt + 2.0 * (d2.dkzdt + d3.dkzdt) + d4.dkzdt),
    )


STEPPERS = {
    "rk2": rk2_step,
    "rk4": rk4_step,
    "split_simplextic": split_symplectic_step,
}

INCREMENTS = {
    "rk2": rk2_increment,
    "rk4": rk4_increment,
}
