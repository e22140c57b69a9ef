"""Gradient-based launch optimization - the differentiable-framework payoff.

The reference computes analytic derivatives *along* rays (for the ray
equations themselves); being JAX end to end, this framework also gives
reverse-mode gradients *through entire traces*: here we optimize a ray's
launch wave-number direction so the ray hits a target point in the EFIT
tokamak, using nothing but jax.grad over the full Newton-init + RK4 trace.

Run:  JAX_PLATFORMS=cpu python examples/optimize_launch.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from graph_framework_tpu.models import make_efit, dispersion as disp  # noqa
from graph_framework_tpu.solver import (  # noqa: E402
    Solver, make_ray_state, init_k)
from graph_framework_tpu.tools.make_splines import tokamak_tables  # noqa

# the generated DIII-D-sized tokamak (an EFIT file's path works as well)
EQ = make_efit(tokamak_tables())


def trace_endpoint(ky, kz):
    """Launch one ray with free (ky, kz); kx Newton-solved onto D = 0."""
    eq = EQ
    st = make_ray_state(1, w=500.0, x=2.5, y=0.0, z=0.0,
                        kx=-500.0, ky=ky, kz=kz)
    st = init_k(st, disp.cold_plasma, eq, "kx",
                tolerance=1e-22, max_iterations=50)
    sol = Solver(disp.cold_plasma, eq, method="rk4", dt=2e-3, sub_steps=10)
    fin, _ = sol.trace(st, 30)          # t = 0.6: deep inside the plasma
    return jnp.stack([fin.x[0], fin.y[0], fin.z[0]])


# the endpoint of the (ky, kz) = (45, 60) launch: exactly reachable, so the
# optimizer (starting from (30, 30)) should drive the miss to ~0
TARGET = trace_endpoint(45.0, 60.0)


def loss(params):
    end = trace_endpoint(params[0], params[1])
    d = end - TARGET
    return jnp.sum(d * d)


def main():
    params = jnp.asarray([30.0, 30.0])
    value_and_grad = jax.jit(jax.value_and_grad(loss))

    # normalized steepest descent with backtracking step size: robust to
    # the wide dynamic range of d(miss)/dk along a refracting ray
    step = 8.0
    v, g = value_and_grad(params)
    for i in range(40):
        cand = params - step * g / (jnp.linalg.norm(g) + 1e-30)
        v_new, g_new = value_and_grad(cand)
        if float(v_new) < float(v):
            params, v, g = cand, v_new, g_new
            step *= 1.2
        else:
            step *= 0.5
        if i % 5 == 0 or v < 1e-6:
            print(f"iter {i:2d}  miss^2 = {float(v):.3e}  "
                  f"ky = {float(params[0]):+.3f}  kz = {float(params[1]):+.3f}")
        if v < 1e-7:
            break

    end = trace_endpoint(params[0], params[1])
    print(f"final endpoint {[round(float(c), 4) for c in end]} "
          f"target {[float(c) for c in TARGET]}")


if __name__ == "__main__":
    main()
