"""Top-level ray-tracing driver: Newton init + scan-based time loop.

Counterpart of ``solver::solver_interface`` and the xrays driver
loop (reference: graph_framework/solver.hpp:120-530,
graph_driver/xrays.cpp:161-260).  The reference compiles one "solver_kernel"
applying the next-state setter maps and loops it from the host; here the
whole inner loop (sub_steps integrator steps) is one jitted function, and
the outer loop either runs ``lax.scan`` (trajectory captured on device) or a
host loop with asynchronous dispatch (trajectory streamed to the writer).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from graph_framework_tpu.models.rays import (
    RayState, make_ray_rhs, residual_fn, dispersion_residual)
from graph_framework_tpu.ops.compensated import compensated_stepper
from graph_framework_tpu.ops.integrators import INCREMENTS, STEPPERS
from graph_framework_tpu.ops.newton import newton_solve
from graph_framework_tpu.utils import checked_jit


def make_ray_state(num_rays=None, *, t=0.0, w, x=0.0, y=0.0, z=0.0,
                   kx=0.0, ky=0.0, kz=0.0, dtype=jnp.float64) -> RayState:
    """Build a RayState from scalars or arrays, broadcast to num_rays."""
    leaves = dict(t=t, w=w, x=x, y=y, z=z, kx=kx, ky=ky, kz=kz)
    if num_rays is None:
        num_rays = max(jnp.ndim(v) and jnp.shape(v)[0] or 1
                       for v in leaves.values())
    return RayState(**{
        k: jnp.broadcast_to(jnp.asarray(v, dtype=dtype), (num_rays,))
        for k, v in leaves.items()})


def init_k(state: RayState, dispersion, eq, which: str = "kx", *,
           tolerance: Optional[float] = None, max_iterations: int = 1000,
           holomorphic: Optional[bool] = None,
           return_diagnostics: bool = False):
    """Newton-solve D = 0 for one wave-number component per ray.

    Counterpart of ``solver_interface::init`` -> ``dispersion::solve`` ->
    ``solver::newton`` (solver.hpp:252-298, dispersion.hpp:1450-1475):
    iterate k <- k - D/dD/dk until the ensemble-max of D^2 converges.

    ``tolerance``: default None = dtype-aware - the reference's 1.0e-30
    (newton.hpp:39) for f64/c128, 1.0e-10 for f32/c64.  In f32 the
    residual D^2 bottoms out at rounding noise far above 1e-30, and
    once there each further Newton step divides noise by a small
    derivative: in f32 at the benchmark launch the
    iteration WANDERED from the physical root (kx = -477.72) to a
    neighbouring branch's (kx = -476.97) whose trajectory is singular -
    the whole 100k-ray trace NaN'd from step one.  A tolerance the
    dtype can actually resolve stops at the first root reached.

    ``return_diagnostics``: also return the NewtonDiagnostics (iteration
    count, final max residual, converged flag) - the converge_item's
    non-convergence report (workflow.hpp:184-204).
    """
    if holomorphic is None:
        holomorphic = jnp.iscomplexobj(state.w)
    if tolerance is None:
        fine = jnp.dtype(state.w.dtype) in (jnp.dtype(jnp.float64),
                                            jnp.dtype(jnp.complex128))
        tolerance = 1.0e-30 if fine else 1.0e-10
    d_one = dispersion_residual(dispersion, eq)
    vd = d_one if getattr(eq, "supports_batched", eq.is_cartesian)() \
        else jax.vmap(d_one)

    others = {f: getattr(state, f) for f in state._fields if f != which}

    def f(kval):
        kw = dict(others)
        kw[which] = kval
        s = RayState(**kw)
        return vd(s.t, s.w, s.x, s.y, s.z, s.kx, s.ky, s.kz)

    k0 = getattr(state, which)
    k_solved, converged, diag = newton_solve(
        f, k0, tolerance=tolerance, max_iterations=max_iterations,
        holomorphic=holomorphic)
    out = state._replace(**{which: k_solved})
    if return_diagnostics:
        return out, diag
    return out


def production_stack(sub_steps: int) -> dict:
    """Solver options of the production stack: frozen-cell rk2 with a
    freeze window of up to 10 substeps (the largest of 10, 5, 2, 1 that
    divides ``sub_steps``), compensated f32 accumulation and the window
    kernel.  Its endpoints track a native f64 rk4 trace more closely than
    plain f32 rk4 does (tests/test_cli_e2e.py)."""
    return dict(method="rk2", frozen_cells=True,
                freeze_every=next(k for k in (10, 5, 2, 1)
                                  if sub_steps % k == 0),
                compensated=True, pallas_window=True)


@dataclasses.dataclass(frozen=True)
class Solver:
    """A compiled ray tracer for one (dispersion, equilibrium, method).

    ``method``: "rk2" | "rk4" | "split_simplextic" | "adaptive_rk4".
    ``dt``: scalar time step (ignored per-step when adaptive).
    ``sub_steps``: integrator steps per recorded output step
    (xrays.cpp:246-254 inner loop).
    """
    dispersion: Callable
    eq: object
    method: str = "rk4"
    dt: float = 1.0e-4
    sub_steps: int = 1
    holomorphic: Optional[bool] = None
    # Substep-level rematerialization for reverse-mode traces: wrap each
    # integrator substep in jax.checkpoint so a surrounding grad/vjp
    # rematerializes one substep at a time instead of the whole recorded
    # step, which keeps the backward's working set small.  Residual
    # memory: one RayState per substep boundary per *live* recorded step -
    # combine with an outer per-step jax.checkpoint (bench.py run_grad)
    # to bound it for long traces.
    remat_substeps: bool = False
    # Named-residual remat policy for the substep checkpoints:
    # "spline_jet" saves the EFIT gather products (see
    # models/efit.plasma_quantities) so backward recomputes skip the
    # gather-heavy reads.  None = save nothing (pure recompute).
    remat_policy: Optional[str] = None
    # Compensated (double-word) state accumulation: carry the ray state
    # as (hi, lo) f32 pairs and fold each substep increment in with an
    # exact TwoSum (ops/compensated.py): high precision at f32 cost.
    # Fixed dt methods.
    compensated: bool = False
    # Frozen-cell stepping: gather each ray's spline blocks ONCE per
    # substep (at the base state) and evaluate all RK stages against
    # them (models/efit.FrozenCellEfit - the narrowed contract and the
    # 1e-8-relative extrapolation bound live there).  Deletes 3/4 of
    # rk4's table gathers.
    # rk2/rk4 (plain or compensated), spline equilibria with
    # freeze_cells only.
    frozen_cells: bool = False
    # Freeze window in SUBSTEPS: with frozen_cells, re-gather the blocks
    # every freeze_every substeps instead of every substep.  Drift over
    # the window stays O(freeze_every * dt * v_g); measured f64
    # full-duration endpoint error vs exact rk4 (bench config):
    # K=1 1.1e-9, K=2 8.2e-9, K=5 6.7e-9, K=10 5.8e-9 in x - all far
    # below the f32 noise floor (1.4e-4).  Must divide sub_steps.
    freeze_every: int = 1
    # Run each freeze window as ONE Pallas kernel through Triton
    # (pallas/efit_step.py): a block of rays keeps its state and frozen
    # coefficients in registers for the whole window, so device memory
    # sees one state round trip per WINDOW instead of per substep.
    # Requires frozen_cells, rk2/rk4, an EFIT equilibrium and num_rays a
    # multiple of pallas_block (pallas.efit_step.pad_rays).  Compiled on
    # a GPU, interpreted on the CPU (runtime.interpret_kernels).  Reverse
    # mode differentiates the XLA frozen window (launch state and spline
    # tables alike), so gradients equal the XLA path's.
    pallas_window: bool = False
    # rays per kernel program (a power of two; one ray per thread)
    pallas_block: int = 128

    def __post_init__(self):
        if self.method not in set(STEPPERS) | {"adaptive_rk4"}:
            raise ValueError(f"unknown method {self.method!r}")
        if self.compensated and self.is_adaptive():
            raise ValueError("compensated accumulation supports the "
                             "fixed-dt methods only")
        if self.frozen_cells:
            if self.method not in ("rk2", "rk4"):
                raise ValueError("frozen_cells supports rk2/rk4 only")
            if not hasattr(self.eq, "freeze_cells"):
                raise ValueError(
                    f"{type(self.eq).__name__} has no freeze_cells "
                    "(frozen-cell stepping is a spline-equilibrium "
                    "optimization)")
        if self.freeze_every != 1:
            if not self.frozen_cells:
                raise ValueError("freeze_every needs frozen_cells=True")
            if self.freeze_every < 1 or self.sub_steps % self.freeze_every:
                raise ValueError(
                    f"freeze_every={self.freeze_every} must divide "
                    f"sub_steps={self.sub_steps}")
        if self.pallas_window:
            if not self.frozen_cells:
                raise ValueError("pallas_window needs frozen_cells=True")
            if self.method not in ("rk2", "rk4"):
                raise ValueError("pallas_window supports rk2/rk4 only")
            if not hasattr(self.eq, "profile_coeffs"):
                raise ValueError("pallas_window supports EFIT only")
            if self.remat_substeps:
                raise ValueError(
                    "remat_substeps is redundant with pallas_window: its "
                    "backward already differentiates one window at a time; "
                    "set remat_substeps=False")

    # -- single recorded step (sub_steps integrator steps, jitted) --------
    def is_adaptive(self):
        return self.method == "adaptive_rk4"

    def _ensure_separable(self, state: RayState) -> None:
        """Refuse to symplectic-step a non-separable system.

        The reference asserts separability symbolically at solver
        construction (solver.hpp:1076-1094, "Hamiltonian is not
        separable."); the numeric equivalent here needs a sample state, so
        it runs once at the first eager entry (init_carry / step_fn call)
        and is skipped under trace (the eager entry already checked)."""
        if self.method != "split_simplextic":
            return
        if getattr(self, "_separability_ok", False):
            return
        if any(isinstance(leaf, jax.core.Tracer)
               for leaf in jax.tree.leaves(state)):
            return
        from graph_framework_tpu.ops.integrators import check_separable
        rhs = make_ray_rhs(self.dispersion, self.eq,
                           holomorphic=self.holomorphic)
        if not check_separable(rhs, state):
            raise ValueError("Hamiltonian is not separable.")
        object.__setattr__(self, "_separability_ok", True)

    def init_carry(self, state: RayState):
        """The integration carry: the RayState itself for fixed-dt methods,
        an AdaptiveCarry holding persistent per-ray (dt, lambda) for
        adaptive_rk4 (the reference's device variables,
        solver.hpp:887-903)."""
        self._ensure_separable(state)
        if self.is_adaptive():
            from graph_framework_tpu.ops.adaptive import init_adaptive_carry
            return init_adaptive_carry(state, self.dt)
        if self.compensated:
            from graph_framework_tpu.ops.compensated import init_comp_carry
            return init_comp_carry(state)
        return state

    @staticmethod
    def carry_state(carry) -> RayState:
        if hasattr(carry, "state"):
            return carry.state
        if hasattr(carry, "hi"):
            return carry.hi
        return carry

    def raw_step_fn(self):
        """UNJITTED recorded step over the integration carry - the pure
        function run/trace compose under their own jit.  Keep jit (or
        checked_jit) at the outermost composition only: in debug mode the
        checkify wrapper raises host-side and must not be re-traced."""
        rhs = make_ray_rhs(self.dispersion, self.eq,
                           holomorphic=self.holomorphic)
        dt = self.dt
        if self.compensated and not self.is_adaptive():
            if self.method not in INCREMENTS:
                raise ValueError(
                    f"compensated accumulation needs an increment-form "
                    f"stepper; available: {sorted(INCREMENTS)}")

        def substep_fn(rhs_):
            if self.compensated:
                return compensated_stepper(
                    lambda s: INCREMENTS[self.method](rhs_, s, dt))
            return lambda s: STEPPERS[self.method](rhs_, s, dt)

        if self.is_adaptive():
            from graph_framework_tpu.ops.adaptive import (
                adaptive_rk4_carry_step)

            def stepper(c):
                return adaptive_rk4_carry_step(
                    self.dispersion, self.eq, rhs, c)
        elif self.frozen_cells:
            K = self.freeze_every

            def window(carry, eq):
                # one freeze at the window base serves every RK stage of
                # the window's K substeps
                base = self.carry_state(carry)
                feq = eq.freeze_cells(jnp.stack([base.x, base.y, base.z]))
                sub = substep_fn(make_ray_rhs(
                    self.dispersion, feq, holomorphic=self.holomorphic))
                if K == 1:
                    return sub(carry)
                carry, _ = jax.lax.scan(lambda c, _: (sub(c), None), carry,
                                        None, length=K)
                return carry

            if self.pallas_window:
                from graph_framework_tpu.pallas.efit_step import (
                    differentiable_window, frozen_window_kernel)
                from graph_framework_tpu.runtime import interpret_kernels
                kernel = frozen_window_kernel(
                    self.eq, self.dispersion, method=self.method, dt=dt,
                    steps=K, compensated=self.compensated,
                    block=self.pallas_block,
                    num_warps=max(1, self.pallas_block // 32),
                    interpret=interpret_kernels())
                stepper = differentiable_window(kernel, window, self.eq)
            else:
                def stepper(c):
                    return window(c, self.eq)
        else:
            stepper = substep_fn(rhs)

        if self.remat_substeps:
            policy = None
            if self.remat_policy == "spline_jet":
                policy = jax.checkpoint_policies.save_only_these_names(
                    "spline_jet")
            elif self.remat_policy is not None:
                raise ValueError(self.remat_policy)
            # prevent_cse=False: the substep sits inside lax.scan, where
            # checkpoint's CSE-defeating barriers are documented
            # unnecessary - and they block XLA fusion.
            stepper = jax.checkpoint(stepper, prevent_cse=False,
                                     policy=policy)

        # with a freeze window, the scanned unit is the K-substep window
        sub = self.sub_steps
        if self.frozen_cells and not self.is_adaptive():
            sub = self.sub_steps // self.freeze_every

        def step(carry):
            # scan (not fori_loop) so whole traces stay reverse-mode
            # differentiable - gradients of endpoints/absorbed power w.r.t.
            # launch parameters flow through every sub-step.
            def body(c, _):
                return stepper(c), None
            out, _ = jax.lax.scan(body, carry, None, length=sub)
            return out

        return step

    def carry_step_fn(self):
        """Jitted recorded step over the integration carry (sub_steps
        integrator substeps); for adaptive_rk4 the per-ray (dt, lambda)
        persist and keep adapting across recorded steps, as the reference's
        variables do (solver.hpp:881-1006).

        checked_jit = jax.jit normally; checkify float checks under debug
        mode (utils.set_debug) so a NaN-producing configuration raises a
        located error instead of silently poisoning the trace.

        The compiled wrapper is CACHED on the solver: every call returns
        the same object, so warming it once (cli/xrays.py compile timer)
        covers the executable trace_streaming then drives - a fresh
        closure per call would retrace and recompile under its own jit
        cache, silently folding a second compile into the trace timing."""
        cached = getattr(self, "_carry_step_cache", None)
        if cached is None:
            cached = checked_jit(self.raw_step_fn())
            object.__setattr__(self, "_carry_step_cache", cached)
        return cached

    def step_fn(self):
        """Jitted recorded step over a plain RayState.  For adaptive_rk4
        the (dt, lambda) adaptation persists across the sub_steps substeps
        of one call but starts fresh each call; use run/trace (or
        carry_step_fn) for cross-step persistence."""
        raw = self.raw_step_fn()
        if not (self.is_adaptive() or self.compensated):
            jitted = checked_jit(raw)
            if self.method != "split_simplextic":
                return jitted

            def checked_step(state: RayState) -> RayState:
                self._ensure_separable(state)
                return jitted(state)

            return checked_step

        def step(state: RayState) -> RayState:
            return self.carry_state(raw(self.init_carry(state)))

        return checked_jit(step)

    def residual(self):
        """Jitted D^2 residual (the solver kernel's diagnostic output,
        solver.hpp:331)."""
        return checked_jit(residual_fn(self.dispersion, self.eq))

    def run(self, state: RayState, num_steps: int,
            return_carry: bool = False, block_rays: Optional[int] = None):
        """Advance num_steps recorded steps entirely on device (one scan,
        no trajectory storage, no host dispatch per step) - the
        configuration of the reference's benchmark loop, which writes no
        output (xrays_bench.cpp:97-101 with filename="").

        ``return_carry``: also return the final integration carry (for
        adaptive_rk4, the persisted per-ray dt/lambda).

        ``block_rays``: evaluate the ensemble in sequential blocks of this
        many rays inside the compiled step (lax.map over a (num_blocks,
        block_rays) reshape), for working-set locality of the fused
        substep chain on large ensembles.  Requires the ray count to be a
        multiple of block_rays."""
        step = self.raw_step_fn()
        num_rays = state.x.shape[0]
        blocked = bool(block_rays) and block_rays < num_rays
        if blocked:
            if num_rays % block_rays:
                raise ValueError(
                    f"block_rays={block_rays} must divide {num_rays}")
            inner = step
            nb = num_rays // block_rays

            def step(c):
                return jax.lax.map(inner, c)

        def go(c):
            def body(c, _):
                return step(c), None
            out, _ = jax.lax.scan(body, c, None, length=num_steps)
            return out

        carry = self.init_carry(state)
        if blocked:
            carry = jax.tree.map(
                lambda a: a.reshape((nb, block_rays) + a.shape[1:]), carry)
        carry = checked_jit(go)(carry)
        if blocked:
            carry = jax.tree.map(
                lambda a: a.reshape((-1,) + a.shape[2:]), carry)
        if return_carry:
            return self.carry_state(carry), carry
        return self.carry_state(carry)

    # -- whole-trace scan (device-resident trajectory) ---------------------
    def trace(self, state: RayState, num_steps: int):
        """Run num_steps recorded steps; returns (final_state, trajectory)
        where trajectory is a RayState with a leading (num_steps + 1) axis
        including the initial state - the device-side analogue of the
        per-step NetCDF rows (solver.hpp write_step)."""
        step = self.raw_step_fn()

        def body(c, _):
            c2 = step(c)
            return c2, self.carry_state(c2)

        def go(c0):
            return jax.lax.scan(body, c0, None, length=num_steps)

        final, traj = checked_jit(go)(self.init_carry(state))
        full = jax.tree.map(
            lambda a, b: jnp.concatenate([a[None], b], axis=0), state, traj)
        return self.carry_state(final), full

    def trace_streaming(self, state: RayState, num_steps: int,
                        writer: Callable[[int, RayState], None]):
        """Host loop with async dispatch: the writer callback receives each
        recorded state while the next step runs on device (the double
        buffered writer thread of solver.hpp:418-424)."""
        step = self.carry_step_fn()
        carry = self.init_carry(state)
        writer(0, state)
        for i in range(1, num_steps + 1):
            carry = step(carry)     # async dispatch; not blocked on write
            writer(i, self.carry_state(carry))
        jax.block_until_ready(carry)
        return self.carry_state(carry)

    def make_segment_fn(self, k: int, extras=None):
        """Jitted ``carry -> (carry, block)`` advancing k recorded steps
        and stacking the k recorded states (+ extras) as the scan output -
        the device-side row buffer of :meth:`trace_segmented`.  Cached per
        (k, extras) so a warm-up call compiles the same executable the
        trace then drives."""
        cache = getattr(self, "_seg_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_seg_cache", cache)
        key = (k, extras)
        if key not in cache:
            step = self.raw_step_fn()

            def seg_fn(c):
                def body(c, _):
                    c2 = step(c)
                    s = self.carry_state(c2)
                    out = (s, extras(s)) if extras else s
                    return c2, out
                c, block = jax.lax.scan(body, c, None, length=k)
                # flatten each stacked (k, rays) leaf to 1D on device
                # (one contiguous transfer each); the host reshapes back
                # for free.
                return c, jax.tree.map(lambda a: a.reshape(-1), block)

            cache[key] = checked_jit(seg_fn)
        return cache[key]

    def extras_jit(self, extras):
        """Cached jit of a trace_segmented ``extras`` callback (used for
        the initial recorded row; segment bodies trace it inline)."""
        cache = getattr(self, "_extras_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_extras_cache", cache)
        if extras not in cache:
            cache[extras] = checked_jit(extras)
        return cache[extras]

    def trace_segmented(self, state: RayState, num_steps: int, writer,
                        segment: int = 16, extras=None):
        """Segment-buffered streaming: capture ``segment`` recorded rows
        in a device-side scan buffer and hand the host ONE bulk
        (segment, rays) block per transfer.

        ``trace_streaming`` dispatches one device->host row per recorded
        step and pays the per-transfer overhead each time.  Buffering K
        rows on device amortizes it K-fold, and the next segment's
        compute is dispatched BEFORE the previous block is fetched, so
        the copy overlaps compute - the counterpart of the reference's
        double-buffered writer thread + host mirror buffers
        (solver.hpp:418-424, cpu_context.hpp:596-610).

        ``extras``: optional traced callback ``state -> dict of arrays``
        evaluated INSIDE the segment scan (fused with the step kernel) and
        streamed alongside - the per-row residual diagnostic of the
        reference's solver kernel (solver.hpp:331) without a separate
        host-dispatched evaluation per row.

        ``writer(i, row)`` receives host-side (numpy-backed) rows, where
        ``row`` is ``(RayState, extras_dict)`` if extras else a RayState.
        Device memory: one (segment, rays) trajectory block per leaf.
        """
        def run_seg(c, k):
            return self.make_segment_fn(k, extras)(c)

        # row template for reshaping the device-flattened blocks back
        # (extras shapes via eval_shape: no extra compute)
        row_tpl = (state, jax.eval_shape(extras, state)) if extras \
            else state
        row_leaves, treedef = jax.tree.flatten(row_tpl)

        def drain(block, start, k):
            host = jax.device_get(jax.tree.leaves(block))  # bulk 1D D2H
            host = [a.reshape((k,) + tuple(l.shape))
                    for a, l in zip(host, row_leaves)]
            for j in range(k):
                writer(start + j,
                       jax.tree.unflatten(treedef, [a[j] for a in host]))

        carry = self.init_carry(state)
        if extras:
            # jit the initial row's extras (an eager evaluation would
            # dispatch op by op); cached so a warm-up call covers the
            # compile
            writer(0, jax.device_get((state,
                                      self.extras_jit(extras)(state))))
        else:
            writer(0, jax.device_get(state))
        pending = None
        i = 1
        while i <= num_steps:
            k = min(segment, num_steps - i + 1)
            carry, block = run_seg(carry, k)   # async dispatch
            if pending:
                drain(*pending)                # overlaps the running seg
            pending = (block, i, k)
            i += k
        if pending:
            drain(*pending)
        jax.block_until_ready(carry)
        return self.carry_state(carry)
