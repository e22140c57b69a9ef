"""Time the three forms of the production stack's freeze window on a GPU.

    python tools/bench_window.py [--rays 100000,1000000] [--blocks 128]

The production stack (frozen rk2, freeze_every=10, compensated f32) is run
for 100 recorded x 10 substeps from a Newton-initialised launch (the
chip_smoke.py rays) with each window as

* ``scan``: the XLA frozen window, one ``lax.scan`` step per substep;
* ``unroll``: the same window with its K substeps unrolled
  (``unrolled_step`` below), so XLA may fuse a window into one kernel;
* ``kernel<B>``: the Pallas/Triton window kernel with B rays per program.

Each form is one jitted trace of all 100 recorded steps; its compile time
is set-up and is reported apart.  The forms run in turns (A B C, C B A,
A B C, ... for ``--passes``), so that drift of the card's clocks shows
as spread between passes; each line lists every pass's time and rates the
best.  Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from graph_framework_tpu.models.dispersion import cold_plasma  # noqa: E402
from graph_framework_tpu.models.efit import make_efit  # noqa: E402
from graph_framework_tpu.models.rays import make_ray_rhs  # noqa: E402
from graph_framework_tpu.ops.compensated import (  # noqa: E402
    compensated_stepper)
from graph_framework_tpu.ops.integrators import INCREMENTS  # noqa: E402
from graph_framework_tpu.pallas.efit_step import pad_rays  # noqa: E402
from graph_framework_tpu.runtime import enable_compile_cache  # noqa: E402
from graph_framework_tpu.solver import (  # noqa: E402
    Solver, init_k, make_ray_state, production_stack)
from graph_framework_tpu.tools.make_splines import tokamak_tables  # noqa

STEPS, SUB_STEPS, DT = 100, 10, 1.0e-4


def unrolled_step(sol):
    """The recorded step of a frozen, compensated ``sol`` with each freeze
    window's K substeps written out, not scanned: the XLA frozen window
    (Solver.raw_step_fn) as one straight-line program per window."""
    def window(carry):
        base = sol.carry_state(carry)
        feq = sol.eq.freeze_cells(jnp.stack([base.x, base.y, base.z]))
        rhs = make_ray_rhs(sol.dispersion, feq)
        sub = compensated_stepper(
            lambda s: INCREMENTS[sol.method](rhs, s, sol.dt))
        for _ in range(sol.freeze_every):
            carry = sub(carry)
        return carry

    def step(carry):
        return jax.lax.scan(lambda c, _: (window(c), None), carry, None,
                            length=sol.sub_steps // sol.freeze_every)[0]
    return step


def trace_fn(sol, unroll=False):
    step = unrolled_step(sol) if unroll else sol.raw_step_fn()

    def go(carry):
        return jax.lax.scan(lambda c, _: (step(c), None), carry, None,
                            length=STEPS)[0]
    return jax.jit(go)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rays", default="100000,1000000")
    p.add_argument("--blocks", default="128")
    p.add_argument("--passes", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("bench_window: no GPU", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    eq = make_efit(tokamak_tables(args.seed), dtype=jnp.float32)
    forms = ["scan", "unroll"] + [f"kernel{b}"
                                  for b in args.blocks.split(",")]
    for n in (int(r) for r in args.rays.split(",")):
        rng = np.random.default_rng(args.seed)
        state = init_k(make_ray_state(
            n, w=650.0, x=2.0 + 0.01 * rng.standard_normal(n), y=0.0,
            z=0.02 * rng.standard_normal(n), kx=-400.0,
            ky=150.0 + 2.0 * rng.standard_normal(n), kz=0.0,
            dtype=jnp.float32), cold_plasma, eq, "kx")
        runs, ref = {}, None
        for form in forms:
            block = int(form[6:]) if form.startswith("kernel") else 128
            sol = Solver(cold_plasma, eq, dt=DT, sub_steps=SUB_STEPS,
                         **dict(production_stack(SUB_STEPS),
                                pallas_window=form.startswith("kernel"),
                                pallas_block=block))
            s0 = pad_rays(state, block)[0] if sol.pallas_window else state
            carry = sol.init_carry(s0)
            t0 = time.perf_counter()
            compiled = trace_fn(sol, form == "unroll").lower(
                carry).compile()
            t_compile = time.perf_counter() - t0
            runs[form] = (sol, compiled, carry, t_compile)
        times, devs = {f: [] for f in forms}, {}
        order = [f for i in range(args.passes)
                 for f in (forms if i % 2 == 0 else forms[::-1])]
        for form in order:
            sol, compiled, carry, _ = runs[form]
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(carry))
            times[form].append(time.perf_counter() - t0)
            if form == "scan":
                ref = sol.carry_state(out)
            else:
                got = jax.tree.map(lambda a: a[:n], sol.carry_state(out))
                devs[form] = max(float(jnp.max(jnp.abs(
                    getattr(got, k) - getattr(ref, k))))
                    for k in ("x", "y", "z"))
        for form in forms:
            best = min(times[form])
            print(f"[window {form}] rays={n} steps={STEPS}x{SUB_STEPS} "
                  f"compile_s={runs[form][3]:.3f} "
                  f"steps_s={','.join(f'{t:.4f}' for t in times[form])} "
                  f"ray_steps_per_s={n * STEPS * SUB_STEPS / best:.6g} "
                  f"max_dev_vs_scan_m={devs.get(form, 0.0):.3e} "
                  f"card={card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
