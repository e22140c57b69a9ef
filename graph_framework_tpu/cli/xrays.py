"""xrays: RF ray tracing driver (3-phase pipeline).

Counterpart of graph_driver/xrays.cpp: trace rays (phase 1),
compute the complex absorption amplitude kamp over the saved trajectory
(phase 2), bin absorbed power along rays (phase 3) - the phases communicate
through the result file exactly as the reference's do (xrays.cpp:1083-1111),
making the file a checkpoint boundary.

Option names mirror the reference CLI (xrays.cpp:808-880).  Notable
semantics replicated:
 * init_<var>_mean/sigma/dist: per-ray initial sampling (uniform = all rays
   at the mean; normal = gaussian spread; xrays.cpp:56-97)
 * use_cyl_xy: interpret init_x as radius, init_y as angle (xrays.cpp:76-136)
 * the k component named by a set init_k*_mean without a _dist is
   Newton-solved to put every ray on the dispersion surface
   (xrays.cpp:192-204)
 * time step dt = endtime/num_times; a row is written every sub_steps
   integrator steps (xrays.cpp:240-254)

Usage:  python -m graph_framework_tpu.cli.xrays --dispersion=cold_plasma \
            --equilibrium=efit --equilibrium_file=efit.nc --num_rays=1000 ...
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="xrays", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dispersion", default="simple",
                   choices=["simple", "bohm_gross", "ordinary_wave",
                            "extra_ordinary_wave", "cold_plasma",
                            "cold_plasma_expansion", "light_wave",
                            "acoustic_wave", "ion_cyclotron",
                            "gaussian_well", "stiff"])
    p.add_argument("--solver", default=None,
                   choices=["rk2", "rk4", "split_simplextic",
                            "adaptive_rk4"],
                   help="integrator (default: rk4, the reference's "
                        "default - but on a GPU with an EFIT equilibrium "
                        "the production stack is used instead unless "
                        "--portable or an explicit --solver is given; "
                        "see --portable)")
    p.add_argument("--portable", action="store_true",
                   help="force the reference-parity defaults (plain rk4, "
                        "no frozen cells/compensation/kernel) even on a "
                        "GPU.  Without it, a GPU run over an EFIT "
                        "equilibrium defaults to the production stack - "
                        "frozen rk2, freeze_every=10, compensated f32, "
                        "window kernel - whose endpoint tracks native "
                        "f64 rk4 more closely than plain f32 rk4 does "
                        "(tests/test_cli_e2e.py)")
    p.add_argument("--equilibrium", default="slab",
                   choices=["no_magnetic_field", "slab", "slab_density",
                            "slab_field", "gaussian_density", "efit",
                            "vmec"])
    p.add_argument("--equilibrium_file", default=None)
    p.add_argument("--num_rays", type=int, default=1000)
    p.add_argument("--num_times", type=int, default=1000)
    p.add_argument("--sub_steps", type=int, default=10)
    p.add_argument("--endtime", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=12345)
    for var in ("w", "x", "y", "z", "kx", "ky", "kz"):
        p.add_argument(f"--init_{var}_mean", type=float, default=None)
        p.add_argument(f"--init_{var}_sigma", type=float, default=0.0)
        p.add_argument(f"--init_{var}_dist", default="uniform",
                       choices=["uniform", "normal"])
    p.add_argument("--use_cyl_xy", action="store_true")
    p.add_argument("--print", dest="print_ray", action="store_true",
                   help="print a sampled ray each recorded step")
    p.add_argument("--print_expressions", action="store_true",
                   help="dump the jaxprs of D and the ray RHS")
    p.add_argument("--absorption_model", default=None,
                   choices=["weak_damping", "root_find"])
    p.add_argument("--output", default="result0.nc")
    p.add_argument("--x64", action="store_true", default=None,
                   help="force f64 (the reference's default dtype; "
                        "resolved automatically when omitted - f64 "
                        "portable, compensated f32 under the "
                        "production stack)")
    p.add_argument("--f32", dest="x64", action="store_false")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="checkify float checks on the hot kernels: the "
                        "first NaN/inf raises a located error (the "
                        "sanitizer-build equivalent, CMakeLists.txt:104-130)")
    p.add_argument("--compensated", action="store_true",
                   help="double-word (hi, lo) f32 state accumulation "
                        "(ops/compensated.py); rk2/rk4 only")
    p.add_argument("--freeze_every", type=int, default=1,
                   help="with --frozen_cells: re-gather the spline "
                        "blocks every N substeps (must divide "
                        "sub_steps; accuracy bound in "
                        "models/efit.FrozenCellEfit + Solver docstring)")
    p.add_argument("--frozen_cells", action="store_true",
                   help="frozen-cell stepping: one spline-block gather "
                        "per substep serves all RK stages (EFIT rk2/rk4; "
                        "models/efit.FrozenCellEfit documents the "
                        "narrowed contract and 1e-9 error bound)")
    p.add_argument("--stream_segment", type=int, default=16,
                   help="buffer N recorded rows on device and stream "
                        "them to the writer as one bulk block "
                        "(Solver.trace_segmented; amortizes per-transfer "
                        "overhead ~Nx).  1 = per-row streaming (the "
                        "reference's write_step cadence)")
    p.add_argument("--pallas_window", action="store_true",
                   help="with --frozen_cells (EFIT): run each freeze "
                        "window as one Pallas/Triton kernel "
                        "(pallas/efit_step.py; the ensemble is padded "
                        "cyclically to a multiple of the kernel's block "
                        "and trimmed back for output)")
    p.add_argument("--timing_json", default=None,
                   help="write per-phase wall-clock timings (the "
                        "reference's setup/init/compile/steps timer "
                        "story, timing.hpp + xrays_bench.cpp:41-44) to "
                        "this file as one JSON object")
    return p


def sample_initial(args, rng, num_rays, var, default=0.0):
    """set_variable (xrays.cpp:56-74)."""
    mean = getattr(args, f"init_{var}_mean")
    if mean is None:
        mean = default
    if getattr(args, f"init_{var}_dist") == "normal":
        sigma = getattr(args, f"init_{var}_sigma")
        return rng.normal(mean, sigma, num_rays)
    return np.full(num_rays, mean)


def make_equilibrium(args, dtype):
    from graph_framework_tpu.models import (
        make_no_magnetic_field, make_slab, make_slab_density,
        make_slab_field, make_gaussian_density, make_efit, make_vmec)
    name = args.equilibrium
    if name == "efit":
        return make_efit(args.equilibrium_file, dtype=dtype)
    if name == "vmec":
        return make_vmec(args.equilibrium_file, dtype=dtype)
    return {"no_magnetic_field": make_no_magnetic_field,
            "slab": make_slab,
            "slab_density": make_slab_density,
            "slab_field": make_slab_field,
            "gaussian_density": make_gaussian_density}[name]()


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    from graph_framework_tpu.runtime import (
        enable_compile_cache, production_platform)
    from graph_framework_tpu.solver import production_stack
    enable_compile_cache()

    # production-stack defaults: when no explicit integrator/dtype/stack
    # flags are given, a GPU run over an EFIT equilibrium uses frozen rk2
    # + freeze window + compensated f32 + the window kernel.  --portable
    # or any explicit flag restores reference-parity behaviour.
    production = (args.solver is None and not args.portable
                  and production_platform()
                  and args.equilibrium == "efit"
                  and not (args.frozen_cells or args.compensated
                           or args.pallas_window
                           or args.freeze_every != 1))
    if production:
        stack = production_stack(args.sub_steps)
        args.solver = stack["method"]
        args.frozen_cells = stack["frozen_cells"]
        args.compensated = stack["compensated"]
        args.pallas_window = stack["pallas_window"]
        args.freeze_every = stack["freeze_every"]
        if args.x64 is None:
            args.x64 = False
        if args.verbose:
            print("production stack: frozen rk2 "
                  f"freeze_every={args.freeze_every} compensated "
                  "pallas_window f32 (use --portable for plain rk4)",
                  file=sys.stderr)
    if args.solver is None:
        args.solver = "rk4"
    if args.x64 is None:
        # the reference's default dtype is double - except when the
        # window kernel (an f32 production path) was asked for
        args.x64 = not args.pallas_window

    if args.x64:
        jax.config.update("jax_enable_x64", True)
    if args.debug:
        from graph_framework_tpu.utils import set_debug
        set_debug(True)
    import jax.numpy as jnp

    from graph_framework_tpu.models import dispersion as disp
    from graph_framework_tpu.models.rays import RayState, residual_fn
    from graph_framework_tpu.solver import Solver, init_k
    from graph_framework_tpu.io.output import (
        ResultFile, AsyncWriter, state_row)

    dtype = jnp.float64 if args.x64 else jnp.float32
    rng = np.random.default_rng(args.seed)
    n = args.num_rays
    timings = {}
    t_setup0 = time.perf_counter()

    # initial conditions (xrays.cpp:56-136)
    vals = {v: sample_initial(args, rng, n, v)
            for v in ("w", "x", "y", "z", "kx", "ky", "kz")}
    if args.use_cyl_xy:
        radius = sample_initial(args, rng, n, "x")
        phi = sample_initial(args, rng, n, "y")
        vals["x"] = radius * np.cos(phi)
        vals["y"] = radius * np.sin(phi)
    state = RayState(
        t=jnp.zeros(n, dtype),
        **{k if k != "w" else "w": jnp.asarray(v, dtype)
           for k, v in vals.items()})

    eq = make_equilibrium(args, dtype)
    dfun = disp.DISPERSIONS[args.dispersion]

    # Newton init on the first k component given as a bare mean
    # (xrays.cpp:192-204)
    timings["setup_s"] = round(time.perf_counter() - t_setup0, 3)
    for which in ("kx", "ky", "kz"):
        if (getattr(args, f"init_{which}_mean") is not None
                and getattr(args, f"init_{which}_dist") == "uniform"):
            t0 = time.perf_counter()
            state = init_k(state, dfun, eq, which)
            import jax as _jax
            _jax.block_until_ready(state)
            timings["init_s"] = round(time.perf_counter() - t0, 3)
            if args.verbose:
                print(f"init {which}: {time.perf_counter()-t0:.2f}s",
                      file=sys.stderr)
            break

    dt = args.endtime / args.num_times
    num_steps = args.num_times // args.sub_steps
    sol = Solver(dfun, eq, method=args.solver, dt=dt,
                 sub_steps=args.sub_steps,
                 compensated=args.compensated,
                 frozen_cells=args.frozen_cells,
                 freeze_every=args.freeze_every,
                 pallas_window=args.pallas_window)
    if args.pallas_window:
        # pad the ensemble cyclically to a kernel-tile multiple; output
        # rows are trimmed back to the launched ray count below
        from graph_framework_tpu.pallas.efit_step import pad_rays
        state, _ = pad_rays(state, block=sol.pallas_block)
    res = jax.jit(residual_fn(dfun, eq))

    if args.print_expressions:
        from graph_framework_tpu.models.rays import make_ray_rhs
        print(jax.make_jaxpr(make_ray_rhs(dfun, eq))(state))

    sample = int(rng.integers(0, n))

    with ResultFile(args.output, num_rays=n) as f:
        for name in ("time", "residual", "w", "x", "y", "z",
                     "kx", "ky", "kz"):
            f.create_variable(name)
        writer = AsyncWriter(f)

        def write(i, s):
            if s.x.shape[0] != n:      # trim pallas_window padding
                s = jax.tree.map(lambda a: a[:n], s)
            writer.write_step(i, state_row(s, residual=res(s)))
            if args.print_ray:
                print(f"step {i}: t={float(s.t[sample]):.6g} "
                      f"x={float(s.x[sample]):.6g} "
                      f"y={float(s.y[sample]):.6g} "
                      f"z={float(s.z[sample]):.6g}")

        def write_seg(i, row):
            s, ex = row                # host (numpy-backed) row
            if s.x.shape[0] != n:      # trim pallas_window padding
                s = jax.tree.map(lambda a: a[:n], s)
                ex = jax.tree.map(lambda a: a[:n], ex)
            writer.write_step(i, state_row(s, residual=ex["residual"]))
            if args.print_ray:
                print(f"step {i}: t={float(s.t[sample]):.6g} "
                      f"x={float(s.x[sample]):.6g} "
                      f"y={float(s.y[sample]):.6g} "
                      f"z={float(s.z[sample]):.6g}")

        seg = max(1, min(args.stream_segment, num_steps))
        while num_steps % seg:       # avoid a second (tail-length)
            seg -= 1                 # segment compile during the trace
        res_raw = residual_fn(dfun, eq)

        def extras_fn(s):
            return {"residual": res_raw(s)}

        # compile the recorded step separately so the trace timer tells
        # the reference's compile-vs-steps story (xrays_bench.cpp:41-44);
        # both paths warm the SAME cached executable the trace drives
        t0 = time.perf_counter()
        if seg > 1:
            warm = (sol.make_segment_fn(seg, extras_fn)(
                        sol.init_carry(state)),
                    sol.extras_jit(extras_fn)(state))
        else:
            warm = sol.carry_step_fn()(sol.init_carry(state))
        jax.block_until_ready(warm)
        del warm
        timings["compile_s"] = round(time.perf_counter() - t0, 3)

        t0 = time.perf_counter()
        if seg > 1:
            # segment-buffered streaming: K recorded rows per bulk
            # device->host block (Solver.trace_segmented)
            sol.trace_segmented(state, num_steps, write_seg,
                                segment=seg, extras=extras_fn)
        else:
            sol.trace_streaming(state, num_steps, write)
        writer.close()
        el = time.perf_counter() - t0
        steps = num_steps * args.sub_steps
        timings["trace_s"] = round(el, 3)
        timings["trace_ray_steps_per_s"] = round(n * steps / el, 1)
        if args.verbose:
            print(f"trace: {el:.2f}s = {n*steps/el:.3g} ray-steps/s",
                  file=sys.stderr)

    # phases 2+3: absorption + power binning (xrays.cpp:598-793)
    if args.absorption_model:
        from graph_framework_tpu.models.absorption import (
            run_absorption, bin_power)
        method = ("weak_damping" if args.absorption_model == "weak_damping"
                  else "root_finder")
        t0 = time.perf_counter()
        with ResultFile(args.output, mode="r+") as f:
            # phase 2 writes ride an AsyncWriter so the next slice's
            # kernel overlaps the previous slice's file write - the
            # reference's double-buffered writer thread
            # (absorption.hpp:465-483)
            run_absorption(f, eq, method=method, writer=AsyncWriter(f))
            timings["absorption_s"] = round(time.perf_counter() - t0, 3)
            t0 = time.perf_counter()
            nt = f.num_steps
            names = ["x", "y", "z"]
            xs = np.stack([f.read_step(i, names)["x"] for i in range(nt)])
            ys = np.stack([f.read_step(i, names)["y"] for i in range(nt)])
            zs = np.stack([f.read_step(i, names)["z"] for i in range(nt)])
            kamp = np.stack([
                f.read_step(i, ["kamp"], complex_valued=True)["kamp"]
                for i in range(nt)])
            power, d_power = bin_power(
                jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(zs),
                jnp.asarray(kamp.imag))
            f.create_variable("power")
            f.create_variable("d_power")
            pw = AsyncWriter(f)
            for i in range(nt):
                pw.write_step(i, {"power": power[i],
                                  "d_power": d_power[i]})
            pw.close()
            timings["bin_power_s"] = round(time.perf_counter() - t0, 3)
        if args.verbose:
            print(f"power: min {float(power.min()):.4g}", file=sys.stderr)

    if args.timing_json:
        import json
        timings["num_rays"] = n
        timings["num_times"] = args.num_times
        timings["sub_steps"] = args.sub_steps
        timings["solver"] = args.solver
        timings["dispersion"] = args.dispersion
        timings["equilibrium"] = args.equilibrium
        timings["absorption_model"] = args.absorption_model
        timings["backend"] = jax.default_backend()
        with open(args.timing_json, "w") as fh:
            json.dump(timings, fh)


if __name__ == "__main__":
    main()
