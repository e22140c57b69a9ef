"""xkorc: relativistic Boris particle pushing in an EFIT field.

Counterpart of graph_korc/xkorc.cpp - defaults mirror the reference
(1e6 particles, 1e6 steps, dt=0.5 gyro-normalized, u=(0, 0.99, 0.1)c from
x=1.7 m); scaled down via flags for interactive runs.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="xkorc", description=__doc__)
    p.add_argument("--equilibrium_file", required=True)
    p.add_argument("--num_particles", type=int, default=1_000_000)
    p.add_argument("--num_steps", type=int, default=1_000_000)
    p.add_argument("--dt", type=float, default=0.5)
    p.add_argument("--output", default="korc_0.nc")
    p.add_argument("--f32", action="store_true")
    args = p.parse_args(argv)

    import jax

    from graph_framework_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from graph_framework_tpu.models import make_efit
    from graph_framework_tpu.models.korc import run_korc
    from graph_framework_tpu.io.output import ResultFile

    dtype = jnp.float32 if args.f32 else jnp.float64
    eq = make_efit(args.equilibrium_file, dtype=dtype)

    t0 = time.perf_counter()
    st = run_korc(eq, num_particles=args.num_particles,
                  num_steps=args.num_steps, dt=args.dt, dtype=dtype)
    jax.block_until_ready(st)
    el = time.perf_counter() - t0
    print(f"Run Time: {el:.2f}s = "
          f"{args.num_particles*args.num_steps/el:.3g} particle-steps/s")

    with ResultFile(args.output, num_rays=args.num_particles) as f:
        for name in ("x", "y", "z", "ux", "uy", "uz", "gamma"):
            f.create_variable(name)
        f.write_step(0, {"x": st.x, "y": st.y, "z": st.z, "ux": st.ux,
                         "uy": st.uy, "uz": st.uz, "gamma": st.gamma})


if __name__ == "__main__":
    main()
