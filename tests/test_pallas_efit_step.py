"""Tests of the frozen-window EFIT step kernel (Pallas through Triton).

The kernel (pallas/efit_step.py) must reproduce the XLA frozen-cell path
(Solver frozen_cells/freeze_every): same window-base freeze, same stepper
algebra, same compensated accumulation.  In interpret mode on the CPU at
f64 the two agree to ~1e-14 (the only differences are operation
orderings).  Lowering for CUDA runs here too (Pallas -> Triton IR, no
card needed); compiling and running it needs the card (``gpu`` marker,
and chip_smoke.py's phase 2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_framework_tpu.solver import Solver, make_ray_state, init_k
from graph_framework_tpu.models.dispersion import cold_plasma
from graph_framework_tpu.models.efit import make_efit
from graph_framework_tpu.pallas.efit_step import (
    frozen_window_kernel, pad_rays, unstack_call)
from graph_framework_tpu.ops.compensated import init_comp_carry, comp_state
from graph_framework_tpu.tools.make_splines import tokamak_tables


@pytest.fixture(scope="module")
def eq():
    return make_efit(tokamak_tables(), dtype=jnp.float64)


@pytest.fixture(scope="module")
def state(eq):
    rng = np.random.default_rng(1)
    st = make_ray_state(256, w=650.0, x=2.0 + 0.01 * rng.standard_normal(256),
                        y=0.0, z=0.0, kx=-400.0, ky=150.0, kz=0.0)
    return init_k(st, cold_plasma, eq, "kx")


def _max_dev(a, b):
    return max(float(jnp.max(jnp.abs(getattr(a, f) - getattr(b, f))))
               for f in a._fields)


def _kernel_run(eq, method, k, compensated, steps, carry, block=64):
    win = frozen_window_kernel(eq, cold_plasma, method=method, dt=1e-4,
                               steps=k, compensated=compensated,
                               block=block, interpret=True)

    def go(c):
        def body(c, _):
            return win(c, eq.psi_coeffs, eq.profile_coeffs), None
        return jax.lax.scan(body, c, None, length=steps * 10 // k)[0]

    return jax.jit(go)(carry)


@pytest.mark.parametrize("method,k", [("rk2", 1), ("rk2", 5), ("rk4", 5)])
def test_window_kernel_matches_xla_frozen(eq, state, method, k):
    sol = Solver(cold_plasma, eq, method=method, dt=1e-4, sub_steps=10,
                 frozen_cells=True, freeze_every=k)
    ref = sol.run(state, 3)
    out = _kernel_run(eq, method, k, False, 3, state)
    assert _max_dev(out, ref) < 1e-12


def test_window_kernel_compensated(eq, state):
    sol = Solver(cold_plasma, eq, method="rk2", dt=1e-4, sub_steps=10,
                 frozen_cells=True, freeze_every=5, compensated=True)
    ref = sol.run(state, 3)
    out = comp_state(_kernel_run(eq, "rk2", 5, True, 3,
                                 init_comp_carry(state)))
    assert _max_dev(out, ref) < 1e-12


def test_solver_pallas_window_path(eq, state):
    """Solver(pallas_window=True) routes run/trace through the kernel
    (interpreted on the CPU) and matches the XLA frozen path."""
    ref = Solver(cold_plasma, eq, method="rk2", dt=1e-4, sub_steps=10,
                 frozen_cells=True, freeze_every=5).run(state, 2)
    sol = Solver(cold_plasma, eq, method="rk2", dt=1e-4, sub_steps=10,
                 frozen_cells=True, freeze_every=5,
                 pallas_window=True, pallas_block=64)
    out = sol.run(state, 2)
    assert _max_dev(out, ref) < 1e-12
    # compensated composition too
    refc = Solver(cold_plasma, eq, method="rk2", dt=1e-4, sub_steps=10,
                  frozen_cells=True, freeze_every=5,
                  compensated=True).run(state, 2)
    outc = Solver(cold_plasma, eq, method="rk2", dt=1e-4, sub_steps=10,
                  frozen_cells=True, freeze_every=5, compensated=True,
                  pallas_window=True, pallas_block=64).run(state, 2)
    assert _max_dev(outc, refc) < 1e-12


def test_solver_pallas_window_validation(eq):
    with pytest.raises(ValueError, match="frozen_cells"):
        Solver(cold_plasma, eq, method="rk2", pallas_window=True)
    with pytest.raises(ValueError, match="rk2/rk4"):
        Solver(cold_plasma, eq, method="split_simplextic",
               frozen_cells=True, pallas_window=True)
    with pytest.raises(ValueError, match="redundant"):
        Solver(cold_plasma, eq, method="rk2", frozen_cells=True,
               pallas_window=True, remat_substeps=True)
    with pytest.raises(ValueError, match="power of two"):
        frozen_window_kernel(eq, cold_plasma, method="rk2", dt=1e-4,
                             steps=5, block=96)


@pytest.mark.parametrize("method,k", [("rk2", 5), ("rk4", 5)])
def test_window_kernel_gradient_matches_xla_frozen(eq, state, method, k):
    """Reverse mode through the kernel's custom_vjp (backward = vjp of the
    XLA frozen window) must match the XLA frozen path's autodiff: both
    treat the frozen blocks/indices as piecewise-constant in the
    window-base state (floor has zero gradient)."""
    def make_loss(sol):
        step = sol.raw_step_fn()

        def loss(s):
            def body(c, _):
                return step(c), None
            c, _ = jax.lax.scan(body, s, None, length=2)
            return (jnp.sum(c.x) + jnp.sum(c.z)
                    + 1e-3 * jnp.sum(c.kx)) / c.x.shape[0]
        return loss

    kw = dict(method=method, dt=1e-4, sub_steps=10, frozen_cells=True,
              freeze_every=k)
    g_ref = jax.jit(jax.grad(make_loss(Solver(cold_plasma, eq, **kw))))(
        state)
    g_ker = jax.jit(jax.grad(make_loss(Solver(
        cold_plasma, eq, pallas_window=True, pallas_block=64, **kw))))(state)

    for f in g_ref._fields:
        a, b = getattr(g_ref, f), getattr(g_ker, f)
        scale = float(jnp.max(jnp.abs(a))) + 1e-30
        assert float(jnp.max(jnp.abs(a - b))) / scale < 1e-10, f


def test_window_kernel_table_gradients(eq, state):
    """Spline-TABLE cotangents through the kernel (the tables are primal
    inputs of its custom_vjp) must match the XLA frozen path's."""
    def loss_fn(pallas):
        def loss(psi_coeffs):
            eq2 = dataclasses.replace(eq, psi_coeffs=psi_coeffs)
            sol = Solver(cold_plasma, eq2, method="rk2", dt=1e-4,
                         sub_steps=10, frozen_cells=True, freeze_every=5,
                         pallas_window=pallas, pallas_block=64)
            s = sol.run(state, 2)
            return jnp.sum(s.x) + jnp.sum(s.kx)
        return loss

    g_ref = jax.jit(jax.grad(loss_fn(False)))(eq.psi_coeffs)
    g_ker = jax.jit(jax.grad(loss_fn(True)))(eq.psi_coeffs)
    scale = float(jnp.max(jnp.abs(g_ref)))
    assert scale > 0
    assert float(jnp.max(jnp.abs(g_ref - g_ker))) / scale < 1e-10


def test_pad_rays(eq, state):
    sub = jax.tree.map(lambda a: a[:100], state)   # 100 not a block multiple
    padded, n = pad_rays(sub, block=64)
    assert n == 100 and padded.x.shape[0] == 128
    # cyclic repetition: padded rays are copies of early rays
    assert jnp.allclose(padded.x[100:], sub.x[:28])
    # stepping the padded ensemble reproduces the unpadded rays
    sol = Solver(cold_plasma, eq, method="rk2", dt=1e-4, sub_steps=10,
                 frozen_cells=True, freeze_every=5,
                 pallas_window=True, pallas_block=64)
    out = sol.run(padded, 2)
    ref = Solver(cold_plasma, eq, method="rk2", dt=1e-4, sub_steps=10,
                 frozen_cells=True, freeze_every=5).run(sub, 2)
    dev = max(float(jnp.max(jnp.abs(getattr(out, f)[:100]
                                    - getattr(ref, f))))
              for f in ref._fields)
    assert dev < 1e-12
    with pytest.raises(ValueError, match="multiple of block"):
        sol.run(sub, 1)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("method", ["rk2", "rk4"])
def test_window_kernel_lowers_for_cuda(method, compensated):
    """Pallas -> Triton lowering for CUDA, run on the CPU: every primitive
    of the unstacked substep has a Triton lowering, and the kernel becomes
    one Triton custom call."""
    eq32 = make_efit(tokamak_tables(), dtype=jnp.float32)
    st = make_ray_state(256, w=650.0, x=2.0, y=0.0, z=0.0, kx=-290.0,
                        ky=150.0, kz=0.0, dtype=jnp.float32)
    carry = init_comp_carry(st) if compensated else st
    win = frozen_window_kernel(eq32, cold_plasma, method=method, dt=1e-4,
                               steps=10, compensated=compensated,
                               block=128, num_warps=4, interpret=False)
    text = jax.jit(win).trace(
        carry, eq32.psi_coeffs, eq32.profile_coeffs).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


def test_unstack_call_matches_direct_evaluation():
    """unstack_call evaluates stacked 3-vector algebra (stack, component
    slices, their transposes in a gradient, sums over the component axis)
    with only per-ray arrays, to the same values."""
    def f(x, y, z, w):
        def d(x, y, z):
            v = jnp.stack([x * w, y, z + 1.0])
            b = jnp.stack([y, z, x]) / jnp.sqrt(jnp.sum(v * v, axis=0))
            return jnp.sum(jnp.sum(v * b, axis=0) ** 2)
        gx, gy, gz = jax.grad(d, argnums=(0, 1, 2))(x, y, z)
        return gx, gy + gz, d(x, y, z) * jnp.ones_like(x)

    rng = np.random.default_rng(2)
    args = [jnp.asarray(rng.standard_normal(16)) for _ in range(4)]
    want = f(*args)
    got = unstack_call(f, args)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-13, atol=1e-13)
    # and no primitive of the re-evaluated function sees a stacked shape
    shapes = {tuple(v.aval.shape)
              for e in jax.make_jaxpr(
                  lambda *a: unstack_call(f, list(a)))(*args).jaxpr.eqns
              for v in e.outvars}
    assert shapes <= {(16,), ()}, shapes


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (runs in chip_smoke.py phase 2)")


@pytest.mark.gpu
def test_window_kernel_compiled_matches_xla(gpu):
    """On the card: the compiled kernel against the XLA frozen window
    after one recorded step, f32 (rounding-level agreement)."""
    eq32 = make_efit(tokamak_tables(), dtype=jnp.float32)
    st = init_k(make_ray_state(4096, w=650.0, x=2.0, y=0.0, z=0.0,
                               kx=-400.0, ky=150.0, kz=0.0,
                               dtype=jnp.float32), cold_plasma, eq32, "kx")
    kw = dict(method="rk2", dt=1e-4, sub_steps=10, frozen_cells=True,
              freeze_every=10)
    ref = Solver(cold_plasma, eq32, **kw).run(st, 1)
    out = Solver(cold_plasma, eq32, pallas_window=True, **kw).run(st, 1)
    for f in ("x", "y", "z", "kx", "ky", "kz"):
        a, b = getattr(out, f), getattr(ref, f)
        assert float(jnp.max(jnp.abs(a - b))) <= 1e-5 * float(
            jnp.max(jnp.abs(b))), f
