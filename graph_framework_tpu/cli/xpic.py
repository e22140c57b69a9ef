"""xpic: 1D electrostatic PIC demo (counterpart of graph_pic/xpic.cpp)."""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="xpic", description=__doc__)
    p.add_argument("--num_particles", type=int, default=1_000_000)
    p.add_argument("--num_grid", type=int, default=1000)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--dt", type=float, default=1.0e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--particles_output", default="pic_particles.nc")
    p.add_argument("--fields_output", default="pic_fields.nc")
    args = p.parse_args(argv)

    import jax

    from graph_framework_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    from graph_framework_tpu.models import pic
    from graph_framework_tpu.io.output import ResultFile

    t0 = time.perf_counter()
    st = pic.run_pic(num_particles=args.num_particles,
                     num_grid=args.num_grid, num_steps=args.num_steps,
                     dt=args.dt, seed=args.seed)
    jax.block_until_ready(st)
    el = time.perf_counter() - t0
    print(f"Run Time: {el:.2f}s = "
          f"{args.num_particles*args.num_steps/el:.3g} particle-steps/s")

    with ResultFile(args.particles_output,
                    num_rays=args.num_particles) as f:
        f.create_variable("x")
        f.create_variable("vpara")
        f.write_step(0, {"x": st.x, "vpara": st.vpara})
    with ResultFile(args.fields_output, num_rays=args.num_grid) as f:
        f.create_variable("epara")
        f.create_variable("n")
        f.write_step(0, {"epara": st.epara, "n": st.n})


if __name__ == "__main__":
    main()
