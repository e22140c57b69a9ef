"""Benchmark: ray-steps/s/chip on the reference's xrays_bench configuration.

Mirrors graph_benchmark/xrays_bench.cpp:41-132 - rk4 + cold_plasma + an
EFIT equilibrium, 100k rays, 1000 recorded steps x sub_steps=10 (the full
reference duration) - and reports integrator ray-steps per second per chip
(setup/init/compile excluded, as the reference's scaling measurements do;
graph_docs/code_performance.dox:24-25).  The EFIT equilibrium is the
generated DIII-D-sized one (tools.make_splines.tokamak_tables).

Where the reference times four scalar types (float/double/complex<float>/
complex<double>, xrays_bench.cpp:129-132), this sweeps f32, compensated
f32, f64 and the split-complex kamp update.

Roofline accounting: FLOPs and bytes per ray-step come from the compiled
executable's XLA cost analysis, divided by the published peaks of the
device kind (``PEAKS``; an unknown kind raises).  This workload has no
matrix products, so the f32 peak outside the tensor cores is the compute
denominator.  Gather "bytes accessed" are XLA's whole-operand accounting,
an upper bound on true traffic for table gathers.  A CPU run (the tests'
rehearsal) reports no roofline: its numbers are not device metrics.

Prints exactly one JSON line with the headline value plus the full sweep
in extra fields:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "dtypes": {...}, "roofline": {...}}

vs_baseline normalizes against 1e6 ray-steps/s/chip - the order of the
reference's single-A100 throughput inferred from its "800x one CPU core"
claim (code_performance.dox:27-30); no absolute numbers are published.

Env knobs: BENCH_MODE=fwd|grad|absorption|config5|korc|pic|adaptive,
BENCH_EQ=efit|vmec (vmec needs BENCH_VMEC_FILE), BENCH_SOLVER=rk4|rk2,
BENCH_RAYS, BENCH_STEPS, BENCH_SUB_STEPS, BENCH_DTYPES
(f32,f32c,f64,c-split), BENCH_FROZEN (frozen-cell stepping),
BENCH_PALLAS_WINDOW (the window kernel), BENCH_BLOCK_RAYS
(ensemble blocking), BENCH_GRAD_REPS, BENCH_GRAD_POLICY,
BENCH_C5_BATCHES, BENCH_PARTICLES, BENCH_KORC_STEPS, BENCH_KORC_CHUNK,
BENCH_PIC_PARTICLES/GRID/STEPS/CHUNK.
"""

import functools
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graph_framework_tpu.runtime import (  # noqa: E402
    enable_compile_cache, production_platform)

BENCH_EQ = os.environ.get("BENCH_EQ", "efit")     # efit | vmec (config 4)
BENCH_MODE = os.environ.get("BENCH_MODE", "fwd")  # fwd|grad|absorption|config5
NUM_RAYS = int(os.environ.get("BENCH_RAYS", 100_000))
# full reference duration (xrays_bench.cpp:129-132): 1000 recorded steps
NUM_STEPS = int(os.environ.get("BENCH_STEPS", 1000))
SUB_STEPS = int(os.environ.get("BENCH_SUB_STEPS", 10))
DTYPES = os.environ.get("BENCH_DTYPES", "f32,f32c,f64,c-split").split(",")
BASELINE_RAY_STEPS_PER_S = 1.0e6

# Published peaks per device kind (dense rates, no sparsity): f32 outside
# the tensor cores and device-memory bandwidth.  Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM column; they assume the full 700 W power
# limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32_flops_per_s=67e12,
                                  hbm_bytes_per_s=3.35e12,
                                  source="NVIDIA H100 data sheet (SXM)"),
}


def device_peaks(kind):
    """Published peaks of a device kind; an unknown kind is an error."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       "add them to bench.PEAKS with their source")
    return PEAKS[kind]


def _cost(step_fn, arg):
    """(flops, bytes) per call from the compiled executable."""
    ca = jax.jit(step_fn).lower(arg).compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def _efit(dtype, **kw):
    from graph_framework_tpu.models import make_efit
    from graph_framework_tpu.tools.make_splines import tokamak_tables
    return make_efit(tokamak_tables(), dtype=dtype, **kw)


def _make(dtype):
    from graph_framework_tpu.models import make_vmec
    from graph_framework_tpu.solver import make_ray_state

    if BENCH_EQ == "vmec":
        # BASELINE.json staged config 4: 3D stellarator trace in flux
        # coords, over the VMEC spline file BENCH_VMEC_FILE names (the
        # repository generates no VMEC equilibrium yet)
        eq = make_vmec(os.environ["BENCH_VMEC_FILE"], dtype=dtype)
        state = make_ray_state(NUM_RAYS, w=900.0, x=0.5, y=0.5, z=0.0,
                               kx=500.0, ky=0.0, kz=0.0, dtype=dtype)
    else:
        # BENCH_CUSTOM_JET=1: analytic-jet custom_jvp for the frozen
        # path's plasma_quantities (models/efit._make_frozen_pq_jet)
        eq = _efit(dtype, custom_jet=os.environ.get("BENCH_CUSTOM_JET",
                                                     "0") == "1")
        # Launch matches xrays_bench.cpp:63-72 (w=500, x=2.5, radial
        # launch) EXCEPT ky: the reference's ky=kz=0 launch is purely
        # perpendicular (B is toroidal ~ y-hat here), which makes the
        # O/X branches degenerate at the cutoff, so the trajectory can
        # hop branches under any rounding change.  ky=150 gives the wave
        # a parallel component and the ray refracts cleanly inward.
        state = make_ray_state(NUM_RAYS, w=500.0, x=2.5, y=0.0, z=0.0,
                               kx=-500.0, ky=150.0, kz=0.0, dtype=dtype)
    return eq, state


def _bench_trace(dtype, num_steps, compensated=False):
    """Timed init + step loop at one dtype; returns per-dtype record.

    ``compensated``: the double-word f32 high-precision path
    (ops/compensated.py) - state carried as (hi, lo) pairs across the
    whole loop, RHS at f32 speed.
    """
    from graph_framework_tpu.models import dispersion as disp
    from graph_framework_tpu.solver import Solver, init_k

    eq, state = _make(dtype)
    # endtime: EFIT integrates the reference's unit duration; the VMEC
    # ray leaves the s <= 1 plasma at t ~ 0.027, so its trace spans the
    # in-plasma flight (throughput is duration-independent).
    endtime = 0.025 if BENCH_EQ == "vmec" else 1.0
    method = os.environ.get("BENCH_SOLVER", "rk4")
    # BENCH_FROZEN=1: frozen-cell stepping (one spline-block gather per
    # substep serves all RK stages; models/efit.FrozenCellEfit contract)
    frozen = (os.environ.get("BENCH_FROZEN", "0") == "1"
              and hasattr(eq, "freeze_cells"))
    # BENCH_PALLAS_WINDOW=1 (with BENCH_FROZEN): run each freeze window
    # as one Pallas/Triton kernel (pallas/efit_step.py).  The ensemble is
    # padded cyclically to a block multiple; throughput counts the
    # NUM_RAYS launched rays, not the padding.
    pallas_win = (os.environ.get("BENCH_PALLAS_WINDOW", "0") == "1"
                  and frozen)
    sol = Solver(disp.cold_plasma, eq, method=method,
                 dt=endtime / (NUM_STEPS * SUB_STEPS),
                 sub_steps=SUB_STEPS, compensated=compensated,
                 frozen_cells=frozen,
                 freeze_every=int(os.environ.get("BENCH_FREEZE_EVERY",
                                                 1)) if frozen else 1,
                 pallas_window=pallas_win)
    num_rays = NUM_RAYS
    if pallas_win:
        from graph_framework_tpu.pallas.efit_step import pad_rays
        state, _ = pad_rays(state, block=sol.pallas_block)
        num_rays = state.x.shape[0]

    t0 = time.perf_counter()
    state = init_k(state, disp.cold_plasma, eq, "kx",
                   tolerance=1.0e-10, max_iterations=100)
    jax.block_until_ready(state)
    t_init = time.perf_counter() - t0

    # host loop dispatching the jitted recorded step; async dispatch
    # keeps the device busy.  BENCH_BLOCK_RAYS > 0 evaluates the ensemble
    # in sequential blocks of that many rays inside one jitted call
    # (lax.map); off by default.
    block = int(os.environ.get("BENCH_BLOCK_RAYS", 0))
    if pallas_win:
        block = 0     # the kernel's grid streams blocks itself
    if block and num_rays % block == 0 and num_rays // block > 1:
        raw = sol.raw_step_fn()
        nb = num_rays // block

        def _blocked(carry):
            return jax.lax.map(raw, carry)

        step = jax.jit(_blocked, donate_argnums=(0,))
        carry = jax.tree.map(
            lambda a: a.reshape((nb, block) + a.shape[1:]),
            sol.init_carry(state))
    else:
        block = 0
        step = sol.carry_step_fn()
        carry = sol.init_carry(state)
    t0 = time.perf_counter()
    carry = step(carry)       # compile + first step
    jax.block_until_ready(carry)
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(num_steps - 1):
        carry = step(carry)
    jax.block_until_ready(carry)
    elapsed = time.perf_counter() - t0
    state = sol.carry_state(carry)
    if block:
        state = jax.tree.map(
            lambda a: a.reshape((-1,) + a.shape[2:]), state)
    assert state.x.dtype == dtype, state.x.dtype

    integrator_steps = (num_steps - 1) * SUB_STEPS
    rsps = NUM_RAYS * integrator_steps / elapsed
    # XLA's cost analysis cannot see into a Pallas call, so the kernel
    # leg reports no flops or bytes rather than the wrapper's
    cost = {k: None for k in ("flops_per_ray_step", "bytes_per_ray_step",
                              "achieved_gflops", "achieved_gbs")}
    if not pallas_win:
        flops, nbytes = _cost(sol.raw_step_fn(), sol.init_carry(state))
        per = num_rays * SUB_STEPS
        cost = dict(flops_per_ray_step=round(flops / per, 1),
                    bytes_per_ray_step=round(nbytes / per, 1),
                    achieved_gflops=round(rsps * flops / per / 1e9, 1),
                    achieved_gbs=round(rsps * nbytes / per / 1e9, 1))
    state = jax.tree.map(lambda a: a[:NUM_RAYS], state)   # drop padding
    # rays leaving the spline domain can produce non-finite state;
    # throughput is unaffected, the record keeps the fraction
    finite_frac = float(jnp.mean(jnp.isfinite(state.x)
                                 .astype(jnp.float32)))
    # trajectory validity: fraction of rays whose final position is
    # finite AND inside the spline table - finite alone can be
    # clamped-extrapolation garbage
    if BENCH_EQ == "efit":
        in_domain_frac = float(jnp.mean(
            eq.in_domain(state.x, state.y, state.z).astype(jnp.float32)))
    else:
        s_f = state.x
        in_domain_frac = float(jnp.mean(
            (jnp.isfinite(s_f) & (jnp.abs(s_f) <= 1.0))
            .astype(jnp.float32)))
    return dict(
        ray_steps_per_s=round(rsps, 1),
        **({"padded_rays": num_rays} if num_rays != NUM_RAYS else {}),
        finite_fraction=round(finite_frac, 4),
        in_domain_fraction=round(in_domain_frac, 4),
        num_steps=num_steps,
        t_init_s=round(t_init, 2),
        t_compile_s=round(t_compile, 2),
        t_steps_s=round(elapsed, 2),
        **cost,
        final_x0=float(state.x[0]),
    )


def _bench_absorption_split(num_slices):
    """Split-complex weak-damping kamp throughput - the real-pair form of
    the reference's complex-dtype phase (phase 2 of xrays;
    absorption.hpp:328-484)."""
    from graph_framework_tpu.models.absorption import make_weak_damping_split

    eq, state = _make(jnp.float32)
    update = jax.jit(make_weak_damping_split(eq))

    # representative damping-region state: inside the plasma (te > 0) with
    # a parallel wave-number component (zeta finite); the launch state sits
    # in the vacuum edge where weak damping is NaN-guarded.
    state = state._replace(
        x=jnp.full_like(state.x, 2.0),
        kz=jnp.full_like(state.kz, 50.0))

    t0 = time.perf_counter()
    re, im = update(state)
    jax.block_until_ready((re, im))
    t_compile = time.perf_counter() - t0

    # the per-slice time variables mirror the real phase 2, which reads a
    # new time row per kernel run (absorption.hpp:465-483)
    times = [state.t + jnp.float32(1e-6 * i) for i in range(num_slices)]
    t0 = time.perf_counter()
    outs = [update(state._replace(t=ti)) for ti in times]
    jax.block_until_ready(outs)
    elapsed = time.perf_counter() - t0
    re, im = outs[-1]

    ups = NUM_RAYS * num_slices / elapsed
    flops, nbytes = _cost(make_weak_damping_split(eq), state)
    return dict(
        kamp_updates_per_s=round(ups, 1),
        num_slices=num_slices,
        t_compile_s=round(t_compile, 2),
        flops_per_update=round(flops / NUM_RAYS, 1),
        achieved_gflops=round(ups * flops / NUM_RAYS / 1e9, 1),
        kamp_im0=float(im[0]),
    )


def run_korc_bench():
    """The reference's framework-comparison axis (code_performance.dox:
    42-60, Comparison.png): 1e8 particles x 1e3 steps of relativistic
    Boris gyro push, reported as particle-steps/s/chip.  Field is the
    slab B = z_hat (1 + 0.1 x) (equilibrium.hpp:611-719) - one fused
    multiply-add per step, cost-equivalent to a uniform field; the push
    itself is the u'/tau/sigma energy-conserving Boris rotation
    (xkorc.cpp:87-103).  Steps run as device-scanned chunks of
    BENCH_KORC_CHUNK steps dispatched from the host.
    """
    from graph_framework_tpu.models.korc import (
        ParticleState, initialize_gamma, make_boris_step)
    from graph_framework_tpu.models.equilibrium import make_slab

    n = int(os.environ.get("BENCH_PARTICLES", 100_000_000))
    steps = int(os.environ.get("BENCH_KORC_STEPS", 1000))
    chunk = int(os.environ.get("BENCH_KORC_CHUNK", 100))
    assert steps % chunk == 0

    eq = make_slab()
    b0 = float(eq.characteristic_field())
    dt = 0.5
    state = ParticleState(
        x=jnp.full(n, 1.7, jnp.float32), y=jnp.zeros(n, jnp.float32),
        z=jnp.zeros(n, jnp.float32),
        ux=jnp.zeros(n, jnp.float32),
        uy=jnp.full(n, 0.99, jnp.float32),
        uz=jnp.full(n, 0.1, jnp.float32),
        gamma=jnp.ones(n, jnp.float32))
    state = jax.jit(initialize_gamma)(state)
    step = make_boris_step(eq, b0, dt, 1.0)

    # donate the state: each chunk reuses its input buffers
    @functools.partial(jax.jit, donate_argnums=0)
    def run_chunk(s):
        def body(s, _):
            return step(s), None
        s, _ = jax.lax.scan(body, s, None, length=chunk)
        return s

    t0 = time.perf_counter()
    state = jax.block_until_ready(run_chunk(state))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(steps // chunk - 1):
        state = run_chunk(state)
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0
    done = (steps - chunk) * n
    pps = done / elapsed
    print(json.dumps({
        "metric": f"particle-steps/s/chip (relativistic Boris gyro push, "
                  f"{n} particles f32, {steps} steps)",
        "value": round(pps, 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(pps / 7.2e9, 4),
        "detail": {
            "num_particles": n, "num_steps": steps, "chunk": chunk,
            "t_compile_s": round(t_compile, 2),
            "t_steps_s": round(elapsed, 2),
            "gamma0": float(state.gamma[0]),
            "baseline_note": "vs_baseline is against the reference "
                             "README's 7.2e9 particle-steps/s prose "
                             "figure (M2 Max)",
        },
    }))


def run_pic_bench():
    """xpic throughput: particle-steps/s for the full PIC step (field
    deposit + RK4 push; graph_pic/xpic.cpp:99-131 is the deposit this
    replaces).  The deposit dominates: it is an O(particles x grid) dense
    contraction per step.
    """
    from graph_framework_tpu.models import pic

    n = int(os.environ.get("BENCH_PIC_PARTICLES", 1_000_000))
    g = int(os.environ.get("BENCH_PIC_GRID", 1000))
    steps = int(os.environ.get("BENCH_PIC_STEPS", 50))
    chunk = int(os.environ.get("BENCH_PIC_CHUNK", 5))
    assert steps % chunk == 0
    # the reference's per-pair E model is explosively unstable (see
    # models/pic.py) and the per-particle field scales with the ensemble
    # (1e6 particles -> |E| ~ 1e10); dt must shrink accordingly to keep
    # the 50-step artifact finite - per-step COST is dt-independent.
    dt = float(os.environ.get("BENCH_PIC_DT", 1.0e-14))

    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    x0 = 0.25 * jax.random.normal(k1, (n,), jnp.float32)
    v0 = 0.25 * jax.random.normal(k2, (n,), jnp.float32)
    scale, offset = 2.0 / (g - 1.0), -1.0
    push = pic.make_push_step(scale, offset, dt)

    dep = pic.make_deposit(g, scale, offset, jnp.float32)

    @functools.partial(jax.jit, donate_argnums=0)
    def run_chunk(s):
        def body(s, _):
            nn, e = dep(s.x)
            return push(s._replace(n=nn, epara=e)), None
        s, _ = jax.lax.scan(body, s, None, length=chunk)
        return s

    state = pic.PicState(x=x0, vpara=v0,
                         epara=jnp.zeros(g, jnp.float32),
                         n=jnp.zeros(g, jnp.float32))
    t0 = time.perf_counter()
    state = jax.block_until_ready(run_chunk(state))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(steps // chunk - 1):
        state = run_chunk(state)
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0
    pps = (steps - chunk) * n / elapsed
    print(json.dumps({
        "metric": f"particle-steps/s/chip (1D PIC deposit+push, {n} "
                  f"particles x {g} grid f32, {steps} steps)",
        "value": round(pps, 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(pps / 1.0e6, 4),
        "detail": dict(
            pair_updates_per_s=round(pps * g, 1),
            t_compile_s=round(t_compile, 2),
            t_steps_s=round(elapsed, 2),
            finite=bool(jnp.isfinite(state.x).all()
                        & jnp.isfinite(state.epara).all()),
            n_max=float(jnp.max(state.n))),
    }))


def run_adaptive_bench():
    """adaptive_rk4 throughput on the stiff system - the configuration
    the reference's (dt, lambda) coordinate-Newton scheme is built for
    and the one its referee validates (tests/test_reference_parity.py;
    solver.hpp:881-1006).  Each recorded step runs the per-ray Newton
    adaptation (a while_loop with the converge_item criteria) plus the
    RK4 step, so the metric counts ADAPTED steps - Newton iterations are
    the price of the adaptation and vary per step.
    """
    from graph_framework_tpu.models import dispersion as disp
    from graph_framework_tpu.models.equilibrium import make_no_magnetic_field
    from graph_framework_tpu.solver import Solver, make_ray_state

    n = NUM_RAYS
    steps = min(NUM_STEPS, 50)
    eq = make_no_magnetic_field()
    state = make_ray_state(n, w=1.0, x=1.0, kx=1.0, dtype=jnp.float32)
    sol = Solver(disp.stiff, eq, method="adaptive_rk4", dt=1.0e-4,
                 sub_steps=1)
    step = jax.jit(sol.raw_step_fn(), donate_argnums=(0,))

    carry = sol.init_carry(state)
    t0 = time.perf_counter()
    carry = step(carry)
    jax.block_until_ready(carry)
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(steps - 1):
        carry = step(carry)
    jax.block_until_ready(carry)
    elapsed = time.perf_counter() - t0
    rsps = n * (steps - 1) / elapsed
    print(json.dumps({
        "metric": f"adapted ray-steps/s/chip (adaptive_rk4+stiff, {n} "
                  f"rays f32, {steps} steps)",
        "value": round(rsps, 1),
        "unit": "ray-steps/s",
        "vs_baseline": round(rsps / BASELINE_RAY_STEPS_PER_S, 4),
        "detail": {
            "t_compile_s": round(t_compile, 2),
            "t_steps_s": round(elapsed, 2),
            "dt_final": float(carry.dt[0]),
            "t_final": float(carry.state.t[0]),
            "note": "per-step cost includes the full (dt, lambda) "
                    "Newton converge loop; referee parity in "
                    "tests/test_reference_parity.py",
        },
    }))


def main():
    enable_compile_cache()
    if BENCH_MODE == "grad":
        return run_grad()
    if BENCH_MODE == "adaptive":
        return run_adaptive_bench()
    if BENCH_MODE == "pic":
        return run_pic_bench()
    if BENCH_MODE == "korc":
        return run_korc_bench()
    if BENCH_MODE == "config5":
        return run_config5()
    if BENCH_MODE == "absorption":
        rec = _bench_absorption_split(max(10, min(NUM_STEPS, 100)))
        print(json.dumps({
            "metric": f"kamp updates/s/chip (split-complex weak damping, "
                      f"{BENCH_EQ.upper()}, {NUM_RAYS} rays f32)",
            "value": rec["kamp_updates_per_s"],
            "unit": "ray-slices/s",
            "vs_baseline": round(
                rec["kamp_updates_per_s"] / BASELINE_RAY_STEPS_PER_S, 4),
            "detail": rec,
        }))
        return

    # -- full dtype sweep (fwd) --------------------------------------------
    records = {}

    # production-stack leg (frozen rk2, freeze_every=10, compensated f32,
    # window kernel) where it is the CLI's default, unless the
    # environment asks for a specific solver stack
    if (BENCH_EQ == "efit" and production_platform()
            and not any(k in os.environ for k in
                        ("BENCH_SOLVER", "BENCH_FROZEN",
                         "BENCH_FREEZE_EVERY", "BENCH_PALLAS_WINDOW"))):
        os.environ.update(BENCH_SOLVER="rk2", BENCH_FROZEN="1",
                          BENCH_FREEZE_EVERY="10",
                          BENCH_PALLAS_WINDOW="1")
        try:
            records["production"] = _bench_trace(jnp.float32, NUM_STEPS,
                                                 compensated=True)
        finally:
            for k in ("BENCH_SOLVER", "BENCH_FROZEN",
                      "BENCH_FREEZE_EVERY", "BENCH_PALLAS_WINDOW"):
                os.environ.pop(k, None)

    if any(d in DTYPES for d in ("f64",)):
        jax.config.update("jax_enable_x64", True)
    if "f32" in DTYPES:
        records["f32"] = _bench_trace(jnp.float32, NUM_STEPS)
    if "f32c" in DTYPES:
        # compensated double-word f32 (ops/compensated.py)
        records["f32c"] = _bench_trace(jnp.float32, NUM_STEPS,
                                       compensated=True)
    if "f64" in DTYPES:
        # full duration by default; BENCH_STEPS_F64 can shorten it
        records["f64"] = _bench_trace(
            jnp.float64, int(os.environ.get("BENCH_STEPS_F64",
                                            NUM_STEPS)))
    if "c-split" in DTYPES:
        records["c-split"] = _bench_absorption_split(100)

    # the production record headlines when present
    trace_dtypes = [d for d in ("production", "f32", "f32c", "f64")
                    if d in records]
    if not trace_dtypes:
        # c-split-only sweep: no trace record to headline; report the
        # absorption metric the way BENCH_MODE=absorption does
        rec = records["c-split"]
        print(json.dumps({
            "metric": f"kamp updates/s/chip (split-complex weak damping, "
                      f"{BENCH_EQ.upper()}, {NUM_RAYS} rays f32)",
            "value": rec["kamp_updates_per_s"],
            "unit": "ray-slices/s",
            "vs_baseline": round(
                rec["kamp_updates_per_s"] / BASELINE_RAY_STEPS_PER_S, 4),
            "detail": rec,
        }))
        return
    head_dtype = trace_dtypes[0]
    head = records[head_dtype]

    # -- roofline ----------------------------------------------------------
    dev = jax.devices()[0]
    roofline = None
    # over the first leg XLA's cost analysis can see (not the window
    # kernel's): the plain f32 leg where it ran
    rf = next((records[d] for d in ("f32", "f32c", "f64")
               if d in records), None)
    if dev.platform != "cpu" and rf is not None:
        peaks = device_peaks(dev.device_kind)
        roofline = {
            "device_kind": dev.device_kind,
            "f32_peak_flops_per_s": peaks["f32_flops_per_s"],
            "hbm_peak_bytes_per_s": peaks["hbm_bytes_per_s"],
            "peaks_source": peaks["source"],
            "flops_share_of_f32_peak": round(
                rf["achieved_gflops"] * 1e9 / peaks["f32_flops_per_s"], 4),
            "hbm_share_upper_bound": round(
                rf["achieved_gbs"] * 1e9 / peaks["hbm_bytes_per_s"], 4),
            "note": "elementwise+gather workload without matrix products; "
                    "bytes are XLA whole-operand accounting (an upper "
                    "bound for table gathers)",
        }

    solver_desc = ("production[frozen rk2 K=10 comp window-kernel]"
                   if head_dtype == "production"
                   else os.environ.get("BENCH_SOLVER", "rk4"))
    print(json.dumps({
        "metric": f"ray-steps/s/chip "
                  f"({solver_desc}"
                  f"+cold_plasma+{BENCH_EQ.upper()}, "
                  f"{NUM_RAYS} rays {head_dtype}, "
                  f"{head['num_steps']}x{SUB_STEPS} steps)",
        "value": head["ray_steps_per_s"],
        "unit": "ray-steps/s",
        "vs_baseline": round(
            head["ray_steps_per_s"] / BASELINE_RAY_STEPS_PER_S, 4),
        "dtypes": records,
        "roofline": roofline,
    }))


def run_grad():
    """Forward+backward bench: reverse-mode gradient of the trace endpoint
    w.r.t. the full launch state (config 5's reverse-mode grads w.r.t.
    launch params).

    Remat structure: substep-level jax.checkpoint
    (Solver(remat_substeps=True)) inside an outer per-recorded-step
    checkpoint.  The forward sweep saves each recorded step's input state
    (the outer checkpoint's residuals, one RayState per recorded step);
    the backward replays per-step vjps in a reverse scan over them.
    With the window kernel (BENCH_PALLAS_WINDOW=1) the backward is the
    XLA frozen window's vjp (pallas/efit_step.differentiable_window).
    """
    from graph_framework_tpu.models import dispersion as disp
    from graph_framework_tpu.solver import Solver, init_k

    eq, state = _make(jnp.float32)
    frozen = os.environ.get("BENCH_FROZEN", "0") == "1"
    pallas_win = (os.environ.get("BENCH_PALLAS_WINDOW", "0") == "1"
                  and frozen)
    sol = Solver(disp.cold_plasma, eq,
                 method=os.environ.get("BENCH_SOLVER", "rk4"),
                 dt=1.0 / (NUM_STEPS * SUB_STEPS), sub_steps=SUB_STEPS,
                 remat_substeps=not pallas_win,
                 frozen_cells=frozen,
                 freeze_every=int(os.environ.get("BENCH_FREEZE_EVERY", 1)),
                 remat_policy=os.environ.get("BENCH_GRAD_POLICY") or None,
                 pallas_window=pallas_win)

    t0 = time.perf_counter()
    state = init_k(state, disp.cold_plasma, eq, "kx",
                   tolerance=1.0e-10, max_iterations=100)
    jax.block_until_ready(state)
    t_init = time.perf_counter() - t0
    if pallas_win:
        from graph_framework_tpu.pallas.efit_step import pad_rays
        state, _ = pad_rays(state, block=sol.pallas_block)

    # prevent_cse=False: the checkpointed step sits inside lax.scan, where
    # the CSE-defeating optimization barriers jax.checkpoint inserts by
    # default are documented unnecessary - and they block XLA fusion.
    step = jax.checkpoint(sol.raw_step_fn(), prevent_cse=False)

    def endpoint_loss(s):
        # endpoint functional: mean final position/wave-vector magnitude
        return (jnp.sum(s.x) + jnp.sum(s.y) + jnp.sum(s.z)
                + jnp.sum(s.kx)) / s.x.shape[0]

    @jax.jit
    def vg(s0):
        def fwd(s, _):
            return step(s), s
        s, traj = jax.lax.scan(fwd, s0, None, length=NUM_STEPS)
        v, ct = jax.value_and_grad(endpoint_loss)(s)

        def bwd(c, s_in):
            return jax.vjp(step, s_in)[1](c)[0], None
        ct, _ = jax.lax.scan(bwd, ct, traj, reverse=True)
        return v, ct

    t0 = time.perf_counter()
    v, g = jax.block_until_ready(vg(state))
    t_compile = time.perf_counter() - t0

    reps = max(1, int(os.environ.get("BENCH_GRAD_REPS", 3)))
    t0 = time.perf_counter()
    outs = [vg(state) for _ in range(reps)]
    jax.block_until_ready(outs)
    elapsed = (time.perf_counter() - t0) / reps
    v, g = outs[-1]

    # the launched rays only; the padding is not counted
    ray_steps_per_s = NUM_RAYS * NUM_STEPS * SUB_STEPS / elapsed
    print(json.dumps({
        "metric": f"fwd+bwd ray-steps/s/chip (grad of endpoint w.r.t. "
                  f"launch state, "
                  f"{os.environ.get('BENCH_SOLVER', 'rk4')}"
                  f"+cold_plasma+{BENCH_EQ.upper()}, "
                  f"{NUM_RAYS} rays f32, {NUM_STEPS}x{SUB_STEPS} steps)",
        "value": round(ray_steps_per_s, 1),
        "unit": "ray-steps/s",
        "vs_baseline": round(ray_steps_per_s / BASELINE_RAY_STEPS_PER_S, 4),
        "detail": {
            "remat": ("window kernel forward, XLA frozen-window vjp "
                      "backward, stored step-boundary states"
                      if pallas_win else
                      "substep checkpoint, stored step-boundary states, "
                      "reverse-scan transpose"),
            "pallas_window": pallas_win,
            "t_init_s": round(t_init, 2),
            "t_compile_s": round(t_compile, 2),
            "t_fwd_bwd_s": round(elapsed, 2),
        },
    }))
    print(f"# init {t_init:.1f}s  compile {t_compile:.1f}s  "
          f"fwd+bwd trace {elapsed:.2f}s  loss {float(v):.5f}  "
          f"|dL/dkx0| {float(jnp.abs(g.kx).max()):.3e}", file=sys.stderr)


def run_config5():
    """BASELINE.json staged config 5: 1M-ray EFIT trace with per-step
    weak-damping absorption and reverse-mode gradient of TOTAL ABSORBED
    POWER w.r.t. launch wave numbers AND the psi spline tables, ray-sharded
    over the available mesh.

    Power accumulation follows xrays.cpp:673-793: k_sum += Im(kamp) dl per
    recorded step, power = exp(-2 k_sum); absorbed = 1 - power summed over
    rays.  The kamp update is the split-complex weak-damping kernel.
    """
    import dataclasses
    from graph_framework_tpu.models import dispersion as disp
    from graph_framework_tpu.models.absorption import make_weak_damping_split
    from graph_framework_tpu.solver import Solver, init_k
    from graph_framework_tpu.parallel.mesh import ray_mesh, shard_rays

    rays = int(os.environ.get("BENCH_RAYS", 1_000_000))
    steps = int(os.environ.get("BENCH_STEPS", 20))
    sub = SUB_STEPS

    from graph_framework_tpu.solver import make_ray_state
    eq0 = _efit(jnp.float32)
    state = make_ray_state(rays, w=800.0, x=2.0, y=0.0, z=0.0,
                           kx=-400.0, ky=-410.0, kz=50.0, dtype=jnp.float32)

    mesh = ray_mesh(jax.devices())
    state = shard_rays(state, mesh)

    t0 = time.perf_counter()
    state = init_k(state, disp.cold_plasma, eq0, "kx",
                   tolerance=1.0e-10, max_iterations=100)
    jax.block_until_ready(state)
    t_init = time.perf_counter() - t0

    # BENCH_PALLAS_WINDOW=1: run the trace forward through the window
    # kernel; its custom_vjp differentiates the XLA frozen window, tables
    # included.  Batches are padded to block multiples with a mask
    # zeroing the padded rays' power (their cotangents vanish, so the
    # padded grads are exact).
    pallas_win = os.environ.get("BENCH_PALLAS_WINDOW", "0") == "1"
    frozen = os.environ.get("BENCH_FROZEN", "0") == "1" or pallas_win
    freeze_k = int(os.environ.get("BENCH_FREEZE_EVERY",
                                  10 if pallas_win else 1))

    def absorbed_power(psi_coeffs, kz0, batch, mask):
        eq = dataclasses.replace(eq0, psi_coeffs=psi_coeffs)
        # BENCH_FROZEN=1: frozen-cell stepping; table gradients flow
        # through the frozen block gathers exactly (verified to 7e-16
        # relative vs the plain path, tests/test_gradients.py)
        sol = Solver(disp.cold_plasma, eq, method="rk4",
                     dt=1.0 / (steps * sub), sub_steps=sub,
                     remat_substeps=not pallas_win,
                     frozen_cells=frozen, freeze_every=freeze_k,
                     pallas_window=pallas_win)
        kamp_fn = make_weak_damping_split(eq)
        step = jax.checkpoint(sol.raw_step_fn(), prevent_cse=False)
        s0 = batch._replace(kz=jnp.full_like(batch.kz, kz0))

        def body(carry, _):
            s, ksum = carry
            s2 = step(s)
            dl = jnp.sqrt((s2.x - s.x) ** 2 + (s2.y - s.y) ** 2
                          + (s2.z - s.z) ** 2)
            _, kim = kamp_fn(s2)
            # vacuum-edge guard (SAFE_MATH scrub, xrays.cpp:1096)
            kim = jnp.nan_to_num(kim, nan=0.0, posinf=0.0, neginf=0.0)
            return (s2, ksum + kim * dl), None

        (s_fin, ksum), _ = jax.lax.scan(
            body, (s0, jnp.zeros_like(s0.x)), None, length=steps)
        power = jnp.exp(-2.0 * jnp.abs(ksum))
        return jnp.sum((1.0 - power) * mask)

    # argnums (0, 1) only: differentiating w.r.t. the ray batch would
    # materialize eight per-ray cotangent arrays per batch for nothing
    vg = jax.jit(jax.value_and_grad(absorbed_power, argnums=(0, 1)))

    # Ray-batched gradient accumulation (BENCH_C5_BATCHES) bounds the
    # reverse pass's residual memory.  Rays are independent and the loss
    # is a sum, so grads over ray batches sum exactly.
    nb = int(os.environ.get("BENCH_C5_BATCHES", 8))
    assert rays % nb == 0
    bsz = rays // nb
    batches = [jax.tree.map(lambda a: a[i * bsz:(i + 1) * bsz], state)
               for i in range(nb)]
    if pallas_win:
        from graph_framework_tpu.pallas.efit_step import pad_rays
        padded = [pad_rays(b, block=Solver.pallas_block)
                  for b in batches]
        batches = [p for p, _ in padded]
        masks = [(jnp.arange(b.x.shape[0]) < n).astype(jnp.float32)
                 for b, n in zip(batches, (n for _, n in padded))]
    else:
        masks = [jnp.ones_like(b.x) for b in batches]

    def vg_all(kz0):
        v = 0.0
        g_psi = jnp.zeros_like(eq0.psi_coeffs)
        g_kz = 0.0
        for b, m in zip(batches, masks):
            vb, (gp, gk) = vg(eq0.psi_coeffs, kz0, b, m)
            v, g_psi, g_kz = v + vb, g_psi + gp, g_kz + gk
        return v, (g_psi, g_kz)

    t0 = time.perf_counter()
    v, (g_psi, g_kz) = vg_all(jnp.float32(50.0))
    jax.block_until_ready(g_psi)
    t_compile = time.perf_counter() - t0

    reps = max(1, int(os.environ.get("BENCH_GRAD_REPS", 2)))
    t0 = time.perf_counter()
    outs = [vg_all(jnp.float32(50.0)) for _ in range(reps)]
    jax.block_until_ready(outs)
    elapsed = (time.perf_counter() - t0) / reps
    v, (g_psi, g_kz) = outs[-1]

    rsps = rays * steps * sub / elapsed
    print(json.dumps({
        "metric": f"config5 fwd+bwd ray-steps/s (1M-ray EFIT absorption "
                  f"trace, grad of absorbed power wrt psi tables + launch "
                  f"kz, {len(jax.devices())} device(s))",
        "value": round(rsps, 1),
        "unit": "ray-steps/s",
        "vs_baseline": round(rsps / BASELINE_RAY_STEPS_PER_S, 4),
        "detail": {
            "rays": rays, "steps": steps, "sub_steps": sub,
            "ray_batches": nb,
            "t_init_s": round(t_init, 2),
            "t_compile_s": round(t_compile, 2),
            "t_fwd_bwd_s": round(elapsed, 2),
            "absorbed_power": float(v),
            "grad_kz": float(g_kz),
            "grad_psi_norm": float(jnp.linalg.norm(g_psi.ravel())),
        },
    }))


if __name__ == "__main__":
    main()
