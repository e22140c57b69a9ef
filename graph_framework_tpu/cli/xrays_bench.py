"""xrays_bench: fixed benchmark (counterpart of
graph_benchmark/xrays_bench.cpp): 100k rays x 1000 steps (sub_steps=10),
rk4 + cold_plasma + EFIT, phase timers for setup/init/compile/steps, run
for each requested dtype."""

from __future__ import annotations

import argparse
import time


def bench_one(dtype_name, efit_file, num_rays, num_times, sub_steps):
    import jax
    import jax.numpy as jnp

    from graph_framework_tpu.runtime import enable_compile_cache
    enable_compile_cache()

    from graph_framework_tpu.models import make_efit
    from graph_framework_tpu.models import dispersion as disp
    from graph_framework_tpu.solver import Solver, make_ray_state, init_k

    dtype = dict(float=jnp.float32, double=jnp.float64,
                 complex_float=jnp.complex64,
                 complex_double=jnp.complex128)[dtype_name]
    print(f"{dtype_name} ".ljust(80, "-"))

    t0 = time.perf_counter()
    if efit_file is None:
        from graph_framework_tpu.tools.make_splines import tokamak_tables
        efit_file = tokamak_tables()
    eq = make_efit(efit_file, dtype=jnp.float64
                   if dtype_name in ("double", "complex_double")
                   else jnp.float32)
    # xrays_bench.cpp:63-72 launch, with the round-4 ky=150 parallel
    # component: the reference's ky=kz=0 launch is branch-degenerate at
    # the perpendicular cutoff (bench.py:_make has the measured story)
    state = make_ray_state(num_rays, w=500.0, x=2.5, y=0.0, z=0.0,
                           kx=-600.0, ky=150.0, kz=0.0, dtype=dtype)
    num_steps = num_times // sub_steps
    sol = Solver(disp.cold_plasma, eq, method="rk4",
                 dt=1.0 / num_times, sub_steps=sub_steps)
    print(f"Setup Time {time.perf_counter()-t0:.3f}s")

    t0 = time.perf_counter()
    state = init_k(state, disp.cold_plasma, eq, "kx",
                   tolerance=1e-10, max_iterations=200)
    jax.block_until_ready(state)
    print(f"Init Time {time.perf_counter()-t0:.3f}s")

    step = sol.step_fn()
    t0 = time.perf_counter()
    state = step(state)
    jax.block_until_ready(state)
    print(f"Compile(+1st step) Time {time.perf_counter()-t0:.3f}s")

    t0 = time.perf_counter()
    for _ in range(num_steps - 1):
        state = step(state)
    jax.block_until_ready(state)
    el = time.perf_counter() - t0
    print(f"Time Steps {el:.3f}s "
          f"({num_rays*(num_steps-1)*sub_steps/el:.4g} ray-steps/s)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="xrays_bench", description=__doc__)
    p.add_argument("--equilibrium_file", default=None,
                   help="EFIT spline file (default: the generated "
                        "DIII-D-sized equilibrium, "
                        "tools.make_splines.tokamak_tables)")
    p.add_argument("--num_rays", type=int, default=100_000)
    p.add_argument("--num_times", type=int, default=1000)
    p.add_argument("--sub_steps", type=int, default=10)
    p.add_argument("--dtypes", default="float",
                   help="comma list: float,double,complex_float,"
                        "complex_double")
    args = p.parse_args(argv)

    import jax
    if any(d in args.dtypes for d in ("double", "complex_double")):
        jax.config.update("jax_enable_x64", True)
    for name in args.dtypes.split(","):
        bench_one(name.strip(), args.equilibrium_file, args.num_rays,
                  args.num_times, args.sub_steps)


if __name__ == "__main__":
    main()
