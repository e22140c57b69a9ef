"""Run the EFIT ray-tracing path once on a GPU and check what comes out.

    python chip_smoke.py               # one card
    python chip_smoke.py --devices 4   # the ray-sharded path over 4 cards

One process owns the card(s).  Phases (one card):

0. device: refuse anything but a GPU; print the card, JAX and h5py.
1. main path at a size users run: 1,000,000 rays with a seeded spread of
   launch position and wave number on a generated DIII-D-sized EFIT
   equilibrium, Newton init_k, then 100 recorded x 10 substeps
   (dt = 1e-4) with the production stack, with plain rk4 in f32, and with
   rk4 in native f64 as the reference.  Finite and in-domain fractions
   must be >= 0.999 and the production endpoint within 2e-5 m of f64.
2. the window kernel against the XLA frozen window it replaces, at 1M
   rays, after one recorded step and after 100, plain and compensated.
3. the three-phase ``xrays`` CLI (trace, weak-damping absorption, power
   binning) on 100,000 rays through a result file; needs h5py.

``--devices 4`` runs only the sharded path: 1M rays over a 4-card ray
mesh (Newton init_k, whose convergence max is the collective, then the
production stack through make_blocked_sharded_fn), checks that the shards
sit on 4 distinct cards, and compares the endpoints with the same rays on
one card.

Every check raises; the last line of standard output is one JSON object
naming the device, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from graph_framework_tpu.models.dispersion import cold_plasma  # noqa: E402
from graph_framework_tpu.models.efit import make_efit  # noqa: E402
from graph_framework_tpu.pallas.efit_step import pad_rays  # noqa: E402
from graph_framework_tpu.runtime import enable_compile_cache  # noqa: E402
from graph_framework_tpu.solver import (  # noqa: E402
    Solver, init_k, make_ray_state, production_stack)
from graph_framework_tpu.tools.make_splines import (  # noqa: E402
    tokamak_tables, write_tables)

STEPS, SUB_STEPS, DT = 100, 10, 1.0e-4   # tests/test_cli_e2e.py launch
ENDPOINT_TOL = 2.0e-5                    # m, the CPU test's bound
FRACTION_MIN = 0.999
# Window kernel against the XLA frozen window, f32, per accumulation mode
# (compensated?) and number of recorded steps: max|diff| / max|XLA| per
# component.  Triton and XLA order operations and contract FMAs
# differently.  Set from the H100's readings (PERF.md): plain 2.4e-6 after
# one step and 3.4e-6 after 100, compensated 5.3e-7 and 1.1e-7.  The
# compensated limits sit below what a plain accumulation reads, so a
# kernel that dropped its low words fails them.
KERNEL_TOL = {False: {1: 1.0e-5, STEPS: 1.0e-5},
              True: {1: 1.0e-6, STEPS: 5.0e-7}}


def check(ok, what):
    """Fail the run; unlike ``assert``, also under ``python -O``."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    """Name and power limit of the card(s), from nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def launch(num_rays, seed, dtype):
    """Seeded spread around the CLI e2e launch (w=650, x=2.0, ky=150,
    kx=-400 Newton-solved)."""
    rng = np.random.default_rng(seed)
    return make_ray_state(
        num_rays, w=650.0,
        x=2.0 + 0.01 * rng.standard_normal(num_rays), y=0.0,
        z=0.02 * rng.standard_normal(num_rays),
        kx=-400.0, ky=150.0 + 2.0 * rng.standard_normal(num_rays), kz=0.0,
        dtype=dtype)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def run_leg(name, eq, state, card, **solver_kw):
    """Newton init_k, then STEPS recorded steps through the solver's
    cached recorded-step function.  Returns (solver, endpoint state)."""
    n = state.x.shape[0]
    state, t_init = timed(lambda s: init_k(s, cold_plasma, eq, "kx"), state)
    sol = Solver(cold_plasma, eq, dt=DT, sub_steps=SUB_STEPS, **solver_kw)
    if sol.pallas_window:
        state, _ = pad_rays(state, sol.pallas_block)
    step = sol.carry_step_fn()
    carry = sol.init_carry(state)
    _, t_compile = timed(lambda c: step(c), carry)   # compile + one step
    t0 = time.perf_counter()
    for _ in range(STEPS):
        carry = step(carry)
    carry = jax.block_until_ready(carry)
    t_steps = time.perf_counter() - t0
    out = jax.tree.map(lambda a: a[:n], sol.carry_state(carry))
    rate = n * STEPS * SUB_STEPS / t_steps
    print(f"[{name}] rays={n} init_s={t_init:.3f} "
          f"compile_and_first_step_s={t_compile:.3f} "
          f"steps_s={t_steps:.3f} ray_steps_per_s={rate:.6g} "
          f"card={card}")
    return sol, state, out


def fractions(eq, s):
    finite = float(jnp.mean(jnp.isfinite(s.x) & jnp.isfinite(s.kx)))
    inside = float(jnp.mean(eq.in_domain(s.x, s.y, s.z)))
    return finite, inside


def endpoint_dev(a, b):
    """Max |a - b| over the position components, in metres."""
    return max(float(jnp.max(jnp.abs(getattr(a, k).astype(jnp.float64)
                                     - getattr(b, k).astype(jnp.float64))))
               for k in ("x", "y", "z"))


def rel_dev(a, b):
    """Per component max |a - b| / max |b|, the worst over the state
    (on the host, so a and b may live on different devices)."""
    def dev(k):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        return float(np.max(np.abs(x - y)) / (np.max(np.abs(y)) + 1e-30))
    return max(dev(k) for k in ("x", "y", "z", "kx", "ky", "kz"))


def phase_main(tables, num_rays, seed, card):
    eq32 = make_efit(tables, dtype=jnp.float32)
    eq64 = make_efit(tables, dtype=jnp.float64)
    prod_kw = production_stack(SUB_STEPS)
    sol, state, prod = run_leg("production", eq32,
                               launch(num_rays, seed, jnp.float32), card,
                               **prod_kw)
    _, _, rk4_32 = run_leg("rk4 f32", eq32,
                           launch(num_rays, seed, jnp.float32), card,
                           method="rk4")
    _, _, ref = run_leg("rk4 f64 (reference)", eq64,
                        launch(num_rays, seed, jnp.float64), card,
                        method="rk4")

    # the README's library path: Solver.trace keeps the trajectory
    final, traj = sol.trace(state, STEPS)
    check(traj.x.shape == (STEPS + 1, state.x.shape[0]),
          f"trajectory shape {traj.x.shape}")
    check(rel_dev(jax.tree.map(lambda a: a[:num_rays], final), prod) < 1e-6,
          "Solver.trace differs from the stepped endpoint")
    del traj

    for name, s, eq in (("production", prod, eq32),
                        ("rk4 f32", rk4_32, eq32),
                        ("rk4 f64", ref, eq64)):
        finite, inside = fractions(eq, s)
        print(f"[{name}] finite_fraction={finite:.6f} "
              f"in_domain_fraction={inside:.6f}")
        check(finite >= FRACTION_MIN and inside >= FRACTION_MIN,
              f"{name}: finite {finite}, in domain {inside}")
    dev_prod = endpoint_dev(prod, ref)
    dev_rk4 = endpoint_dev(rk4_32, ref)
    print(f"endpoint deviation from f64 rk4 [m]: production={dev_prod:.3e} "
          f"(limit {ENDPOINT_TOL:.1e}) rk4_f32={dev_rk4:.3e}")
    check(dev_prod < ENDPOINT_TOL, f"production endpoint {dev_prod} m")

    compiled = sol.carry_step_fn().lower(sol.init_carry(state)).compile()
    print(f"production recorded step memory_analysis: "
          f"{compiled.memory_analysis()}")
    return eq32


def kernel_vs_xla(eq32, state, steps, kernel_compensated,
                  xla_compensated):
    """rel_dev of the window kernel's endpoint from the XLA frozen
    window's after ``steps`` recorded steps of the production stack, each
    side with its own accumulation mode."""
    def solver(comp, kernel):
        return Solver(cold_plasma, eq32, dt=DT, sub_steps=SUB_STEPS,
                      **dict(production_stack(SUB_STEPS), compensated=comp,
                             pallas_window=kernel))
    ker = solver(kernel_compensated, True)
    padded, n = pad_rays(state, ker.pallas_block)
    a = jax.tree.map(lambda v: v[:n], ker.run(padded, steps))
    return rel_dev(a, solver(xla_compensated, False).run(state, steps))


def phase_kernel(eq32, num_rays, seed, card):
    """The window kernel against the XLA frozen window it replaces."""
    state = init_k(launch(num_rays, seed, jnp.float32), cold_plasma, eq32,
                   "kx")
    print("window kernel vs XLA frozen window, f32: tolerance = max|diff| "
          "/ max|XLA| per component, per accumulation mode and recorded "
          f"steps {KERNEL_TOL} (Triton and XLA order operations and "
          "contract FMAs differently; the compensated limits sit below "
          "what a plain accumulation reads)")
    for comp, tol in KERNEL_TOL.items():
        for steps in tol:
            dev = kernel_vs_xla(eq32, state, steps, comp, comp)
            print(f"[kernel vs xla] compensated={comp} recorded_steps="
                  f"{steps} rays={num_rays} rel_dev={dev:.3e} "
                  f"tol={tol[steps]:.0e} card={card}")
            check(dev < tol[steps],
                  f"kernel vs XLA, compensated={comp}, {steps} steps: {dev}")


def phase_cli(tables, num_rays, card):
    from graph_framework_tpu.cli import xrays
    from graph_framework_tpu.io.output import ResultFile

    with tempfile.TemporaryDirectory() as tmp:
        eq_file = write_tables(pathlib.Path(tmp) / "efit.nc", tables)
        out = pathlib.Path(tmp) / "result.nc"
        tj = pathlib.Path(tmp) / "timing.json"
        t0 = time.perf_counter()
        xrays.main([
            "--dispersion=cold_plasma", "--equilibrium=efit",
            f"--equilibrium_file={eq_file}", f"--num_rays={num_rays}",
            "--num_times=1000", "--endtime=0.1", "--sub_steps=10",
            "--init_w_mean=650", "--init_x_mean=2.0",
            "--init_ky_mean=150", "--init_kx_mean=-400",
            "--absorption_model=weak_damping", f"--output={out}",
            f"--timing_json={tj}"])
        wall = time.perf_counter() - t0
        timing = json.loads(tj.read_text())
        with ResultFile(out, mode="r+") as f:
            names = set(f.variables())
            nt = f.num_steps
            power = np.stack([f.read_step(i, ["power"])["power"]
                              for i in range(nt)])
    for name in ("x", "kamp", "power", "d_power"):
        check(name in names, f"{name} missing from the result file")
    check(nt == STEPS + 1 and power.shape[1] == num_rays,
          f"power rows {power.shape}")
    check(np.all(np.isfinite(power)) and np.all(power <= 1.0 + 1e-6),
          "power not finite or above 1")
    check(np.all(np.diff(power, axis=0) <= 1e-6), "power increases")
    print(f"[xrays cli] rays={num_rays} wall_s={wall:.3f} "
          f"timing={json.dumps(timing)} card={card}")


def phase_sharded(tables, num_rays, seed, card, num_devices):
    from graph_framework_tpu.parallel.mesh import (
        make_blocked_sharded_fn, ray_mesh, replicate, shard_rays)

    devices = jax.devices()[:num_devices]
    check(len(devices) == num_devices, f"devices {jax.devices()}")
    mesh = ray_mesh(devices)
    eq = make_efit(tables, dtype=jnp.float32)
    sol = Solver(cold_plasma, eq, dt=DT, sub_steps=SUB_STEPS,
                 **production_stack(SUB_STEPS))
    state, n = pad_rays(launch(num_rays, seed, jnp.float32),
                        sol.pallas_block * num_devices)

    sharded = shard_rays(state, mesh)
    sol_m = Solver(cold_plasma, replicate(eq, mesh), dt=DT,
                   sub_steps=SUB_STEPS, **production_stack(SUB_STEPS))
    run = make_blocked_sharded_fn(sol_m, STEPS, mesh)
    init, t_init = timed(
        lambda s: init_k(s, cold_plasma, sol_m.eq, "kx"), sharded)
    _, t_compile = timed(run, init)
    out, t_steps = timed(run, init)
    homes = {sh.device for sh in out.x.addressable_shards}
    print(f"[sharded] devices={num_devices} shard_devices="
          f"{sorted(d.id for d in homes)} rays={n} init_s={t_init:.3f} "
          f"compile_and_run_s={t_compile:.3f} steps_s={t_steps:.3f} "
          f"ray_steps_per_s={n * STEPS * SUB_STEPS / t_steps:.6g} "
          f"card={card}")
    check(len(homes) == num_devices, f"shards on {homes}")

    one = jax.device_put(state, devices[0])
    one = init_k(one, cold_plasma, eq, "kx")
    ref = jax.block_until_ready(sol.run(one, STEPS))
    dev = rel_dev(jax.tree.map(lambda a: a[:n], out),
                  jax.tree.map(lambda a: a[:n], ref))
    print(f"[sharded vs one card] rel_dev={dev:.3e} (tol 1e-6: the same "
          "per-ray program)")
    check(dev < 1e-6, f"sharded vs one card: {dev}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=1, choices=[1, 4])
    p.add_argument("--rays", type=int, default=1_000_000)
    p.add_argument("--cli_rays", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    # phase 0: device
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform!r})",
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)     # the f64 reference leg
    card = card_line()
    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    print(f"device: {dev.device_kind} x{len(jax.devices())} "
          f"jax {jax.__version__} compile_cache={cache}")
    print(f"card: {card}")
    print(f"h5py: {'yes' if have_h5py else 'no'}")

    tables = tokamak_tables(args.seed)
    if args.devices > 1:
        phase_sharded(tables, args.rays, args.seed, card, args.devices)
        count = args.devices
    else:
        eq32 = phase_main(tables, args.rays, args.seed, card)
        phase_kernel(eq32, args.rays, args.seed, card)
        if have_h5py:
            phase_cli(tables, args.cli_rays, card)
        count = 1
    check(count == len(jax.devices()), f"{count} vs {jax.devices()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
