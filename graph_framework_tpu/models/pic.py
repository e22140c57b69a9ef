"""1D electrostatic particle-in-cell demo (the xpic application).

Counterpart of graph_pic/xpic.cpp:10-192.  The reference's field deposit
is a serial trick: a loop_item walks particle indices with ``index_1D``
gathers in batches of 1000, accumulating density/E-field on the grid
(xpic.cpp:99-131) - a workaround for having no scatter primitive.  Here
the deposit is a dense blocked reduction over particles (see
:func:`deposit`).

Model (xpic.cpp:17-35): gaussian shape function
n(x) = exp(-x^2/1e-4); E_par = -(1/q n) d(n te)/dx per particle-grid
distance; RK4 push with grid-gathered E (index_1D, xpic.cpp:80-93).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from graph_framework_tpu.ops.tables import index_1d


class PicState(NamedTuple):
    x: jax.Array        # particle positions
    vpara: jax.Array    # particle parallel velocities
    epara: jax.Array    # grid electric field
    n: jax.Array        # grid density


def shape_density(dx):
    """Particle shape function exp(-dx^2/1e-4) (xpic.cpp:17-20)."""
    return jnp.exp(dx * dx / -1.0e-4)


def shape_efield(dx, te=1.0, q=1.0):
    """E = -(1/(q n)) d(n te)/dx evaluated analytically through autodiff
    (the reference differentiates the density graph symbolically,
    xpic.cpp:27-35)."""
    def pe(d):
        return shape_density(d) * te
    # -(1/(q n)) dpe/dx ; elementwise grad
    dpe = jax.grad(lambda d: jnp.sum(pe(d)))(dx)
    return -dpe / (q * shape_density(dx))


def deposit(x, grid_position, scale, offset):
    """Deposit density and E-field from all particles onto the grid.

    The reference accumulates sum_p f(x_p - x_i) for every grid point i by
    looping particles serially (xpic.cpp:99-131).  Equivalent dense form:
    for each grid point, sum the shape function over all particles - an
    outer-product reduction, a (grid x particle) contraction.  Grids are small (1000) so we evaluate in
    particle blocks to bound memory.
    """
    num_grid = grid_position.shape[0]

    def body(carry, blk):
        xp_block, mask = blk
        n_acc, e_acc = carry
        dxm = xp_block[None, :] - grid_position[:, None]
        # the per-pair E is linear in dx (unbounded), so padding must be
        # masked explicitly, not relied on to vanish.
        n_acc = n_acc + jnp.sum(shape_density(dxm) * mask[None, :], axis=1)
        e_acc = e_acc + jnp.sum(_efield_dense(dxm) * mask[None, :], axis=1)
        return (n_acc, e_acc), None

    block = 4096
    npad = ((x.shape[0] + block - 1) // block) * block
    xp = jnp.pad(x, (0, npad - x.shape[0]))
    mask = jnp.pad(jnp.ones_like(x), (0, npad - x.shape[0]))
    (n, e), _ = jax.lax.scan(
        body, (jnp.zeros(num_grid, x.dtype), jnp.zeros(num_grid, x.dtype)),
        (xp.reshape(-1, block), mask.reshape(-1, block)))
    return n, e


def _efield_dense(dx, te=1.0, q=1.0):
    # analytic derivative of pe = te exp(-dx^2/1e-4):
    # E = -(1/(q n)) dpe/dx = (te/q) * 2 dx / 1e-4
    # (evaluated per-pair; the reference's symbolic df of the same graph)
    return (te / q) * (2.0 * dx / 1.0e-4)


def make_push_step(grid_scale, grid_offset, dt=1.0e-5, q=1.0, m=1.0):
    """RK4 particle push with grid-field gathers (xpic.cpp:80-96)."""

    def step(state: PicState) -> PicState:
        x, v, e = state.x, state.vpara, state.epara

        def accel(xq):
            return -q / m * index_1d(e, xq, grid_scale, grid_offset)

        x1 = dt * v
        v1 = accel(x)
        x2 = dt * (v + v1 / 2.0)
        v2 = accel(x + x1 / 2.0)
        x3 = dt * (v + v2 / 2.0)
        v3 = accel(x + x2 / 2.0)
        x4 = dt * (v + v3)
        v4 = accel(x + x3)
        # NOTE: the reference's v-update omits the dt factor on the
        # acceleration stages (xpic.cpp:82-93: vparaN = -q/m E with no dt,
        # summed directly into vpara_next) - an apparent bug in the demo.
        # We apply the standard RK4 dt factor.
        x_next = x + (x1 + 2.0 * (x2 + x3) + x4) / 6.0
        v_next = v + dt * (v1 + 2.0 * (v2 + v3) + v4) / 6.0
        return state._replace(x=x_next, vpara=v_next)

    return step


def make_deposit(num_grid, scale, offset, dtype):
    """Build the deposit callable ``dep(x) -> (n, epara)``: the XLA
    blocked outer-difference scan above over this grid."""
    grid = offset + scale * jnp.arange(num_grid, dtype=dtype)

    def dep(x):
        return deposit(x, grid, scale, offset)
    return dep


def run_pic(num_particles=100_000, num_grid=1000, num_steps=100,
            dt=1.0e-5, seed=0, dtype=jnp.float32):
    """The xpic main loop (xpic.cpp:43-178): deposit fields, push
    particles, repeat.  Returns the final PicState."""
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    x = 0.25 * jax.random.normal(k1, (num_particles,), dtype)
    v = 0.25 * jax.random.normal(k2, (num_particles,), dtype)

    scale = 2.0 / (num_grid - 1.0)
    offset = -1.0

    dep = make_deposit(num_grid, scale, offset, dtype)
    push = make_push_step(scale, offset, dt)

    state = PicState(x=x, vpara=v,
                     epara=jnp.zeros(num_grid, dtype),
                     n=jnp.zeros(num_grid, dtype))

    @jax.jit
    def run(s):
        def body(s, _):
            n, e = dep(s.x)
            s = s._replace(n=n, epara=e)
            return push(s), None
        s, _ = jax.lax.scan(body, s, None, length=num_steps)
        return s

    return run(state)
