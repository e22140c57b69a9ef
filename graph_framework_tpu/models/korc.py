"""Relativistic Boris particle pusher (the xkorc application).

Counterpart of graph_korc/xkorc.cpp:10-188: push 1e6 particles
for 1e6 steps through an EFIT field, with time normalized to the gyro
period at the axis field b0 and lengths to the Larmor radius.

The u'/tau/sigma rotation algebra (xkorc.cpp:87-103) is the exactly-
energy-conserving relativistic Boris variant; all quantities are per
particle and the step is one fused jitted function scanned on device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class ParticleState(NamedTuple):
    """Positions, normalized momenta u = gamma v/c, and gamma."""
    x: jax.Array
    y: jax.Array
    z: jax.Array
    ux: jax.Array
    uy: jax.Array
    uz: jax.Array
    gamma: jax.Array


#: physical constants as used by xkorc.cpp:33-35 (note: me here is the
#: CODATA-2022 value 9.1093837139e-31, different from dispersion.hpp's
#: 9.1093837015e-31).
Q_KORC = 1.602176634e-19
ME_KORC = 9.1093837139e-31
C_KORC = 299792458.0


def initialize_gamma(state: ParticleState) -> ParticleState:
    """The "initialize_gamma" pre-item (xkorc.cpp:76-86):
    gamma = 1/sqrt(1 - u.u) for u given as velocity fraction, then
    u <- gamma u."""
    u2 = (state.ux * state.ux + state.uy * state.uy + state.uz * state.uz)
    gamma = 1.0 / jnp.sqrt(1.0 - u2)
    return state._replace(ux=gamma * state.ux, uy=gamma * state.uy,
                          uz=gamma * state.uz, gamma=gamma)


def make_boris_step(eq, b0, dt: float, larmor_radius: float):
    """One Boris step (xkorc.cpp:87-118), jittable and BATCHED.

    ``b0``: normalizing field (equilibrium characteristic field);
    ``larmor_radius``: c me/(q b0) in meters (xkorc.cpp:37-40).

    The rotation algebra is written out componentwise on (num_particles,)
    arrays rather than as a vmapped 3-vector formulation, which would
    materialize (N, 3) intermediates with a 3-wide trailing axis.
    """

    def step(st: ParticleState) -> ParticleState:
        pos = jnp.stack([st.x, st.y, st.z])          # (3, N): component-leading
        b = eq.magnetic_field(pos)
        bx, by, bz = b[0] / b0, b[1] / b0, b[2] / b0
        g = st.gamma
        h = dt / (2.0 * g)

        # u' = u - h (u x b)
        upx = st.ux - h * (st.uy * bz - st.uz * by)
        upy = st.uy - h * (st.uz * bx - st.ux * bz)
        upz = st.uz - h * (st.ux * by - st.uy * bx)

        tx, ty, tz = -0.5 * dt * bx, -0.5 * dt * by, -0.5 * dt * bz
        tau_sq = tx * tx + ty * ty + tz * tz
        speed_sq = upx * upx + upy * upy + upz * upz
        sigma = 1.0 + speed_sq - tau_sq
        ustar = upx * tx + upy * ty + upz * tz
        gamma_next = jnp.sqrt(0.5 * (
            sigma + jnp.sqrt(sigma * sigma
                             + 4.0 * (tau_sq + ustar * ustar))))
        inv_gn = 1.0 / gamma_next
        tvx, tvy, tvz = tx * inv_gn, ty * inv_gn, tz * inv_gn
        s = 1.0 + tvx * tvx + tvy * tvy + tvz * tvz
        updt = upx * tvx + upy * tvy + upz * tvz
        inv_s = 1.0 / s
        unx = (upx + updt * tvx + (upy * tvz - upz * tvy)) * inv_s
        uny = (upy + updt * tvy + (upz * tvx - upx * tvz)) * inv_s
        unz = (upz + updt * tvz + (upx * tvy - upy * tvx)) * inv_s

        f = larmor_radius * dt * inv_gn
        return ParticleState(st.x + f * unx, st.y + f * uny,
                             st.z + f * unz, unx, uny, unz, gamma_next)

    return step


def run_korc(eq, num_particles=1024, num_steps=1000, dt=0.5,
             dtype=jnp.float64, x0=1.7, u0=(0.0, 0.99, 0.1)):
    """The xkorc main loop (xkorc.cpp:10-160) as a scanned device loop.

    Returns the final ParticleState.  Default initial conditions match the
    reference (x = 1.7 m on the midplane, u = (0, 0.99, 0.1) c).
    """
    b0 = float(eq.characteristic_field())
    gyro_period = ME_KORC / (Q_KORC * b0)
    larmor_radius = C_KORC * gyro_period

    n = num_particles
    state = ParticleState(
        x=jnp.full(n, x0, dtype), y=jnp.zeros(n, dtype),
        z=jnp.zeros(n, dtype),
        ux=jnp.full(n, u0[0], dtype), uy=jnp.full(n, u0[1], dtype),
        uz=jnp.full(n, u0[2], dtype), gamma=jnp.ones(n, dtype))
    state = initialize_gamma(state)

    step = make_boris_step(eq, b0, dt, larmor_radius)

    @jax.jit
    def run(s):
        def body(s, _):
            return step(s), None
        s, _ = jax.lax.scan(body, s, None, length=num_steps)
        return s

    return run(state)
