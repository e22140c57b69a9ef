"""Compensated (double-word) state accumulation: a high-precision trace
path at f32 cost.

The reference's primary dtype is double with "no measurable f32/f64
difference" on CPU (graph_docs/code_performance.dox:30-31).  Whether f32
plus compensation beats native f64 on a given device is a measurement
(PERF.md).  The f32 trace does not lose accuracy uniformly: the RHS evaluation's rounding
errors are random-walk (sqrt(N) growth on 10^4 steps) while the per-step
STATE UPDATE ``x <- x + dt*k`` rounds systematically against the large
state magnitude - N * ulp(x) growth, the dominant f32 trajectory error.

This module therefore carries the 8 ray-state arrays as double-word
(hi, lo) f32 pairs and folds each integrator increment in with an exact
TwoSum (Knuth 1969; branch-free, 6 flops per state element per substep -
noise next to the RHS cost), while the RHS itself runs plain
f32 on the hi words.  Error model: state-accumulation rounding is
eliminated; what remains is the RHS's own f32 noise, so the trajectory
tracks the f64 one to ~single-RHS-evaluation f32 accuracy instead of
drifting.  Validated against the f64 trace at intermediate tolerances
(tests/test_compensated.py), as the reference validates per-dtype
(solver_test.cpp:104-116).

The increment MUST come unfolded from the integrator (the INCREMENTS
steppers in ops.integrators): extracting it afterwards as
``delta = step(hi) - hi`` recovers the already-rounded increment and the
compensation becomes a no-op, because the rounding of ``hi + delta`` is
precisely the error being eliminated (see ``compensated_stepper`` and
NOTES_r3 item 5 for the failed-attempt record).

Forward tracing only (the production bench/CLI path); reverse-mode trace
gradients use the f32 or f64 paths.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CompCarry(NamedTuple):
    """Double-word ray-state: value = hi + lo (|lo| <= ulp(hi)/2)."""
    hi: object       # RayState (f32)
    lo: object       # RayState (f32)


def _two_sum(a, b):
    """Error-free transform: a + b = s + e exactly (branch-free Knuth
    TwoSum; no magnitude ordering assumed)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def init_comp_carry(state) -> CompCarry:
    return CompCarry(state, jax.tree.map(jnp.zeros_like, state))


def comp_state(carry: CompCarry):
    """Collapse to a plain f32 RayState (hi is already the correctly
    rounded sum by the TwoSum invariant)."""
    return carry.hi


def comp_state_f64(carry: CompCarry):
    """Promote to f64 with the low words re-added - the full-precision
    view for accuracy comparisons."""
    return jax.tree.map(
        lambda h, l: h.astype(jnp.float64) + l.astype(jnp.float64),
        carry.hi, carry.lo)


def compensated_stepper(increment_fn: Callable) -> Callable:
    """Wrap an increment-form stepper ``state -> delta`` (RayState-shaped
    raw increments, ops.integrators.INCREMENTS) into a double-word carry
    stepper ``CompCarry -> CompCarry``: fold (delta + lo) into hi with an
    exact TwoSum, renormalizing the pair.

    The increment must come UNFOLDED from the integrator: extracting it
    from ``stepper(hi) - hi`` would recover the already-rounded
    increment, making the compensation a no-op (the rounding of
    ``hi + delta`` is precisely the error being eliminated).
    """

    def step(carry: CompCarry) -> CompCarry:
        hi, lo = carry
        delta = increment_fn(hi)

        def fold(i):
            def leaf(h, d, l):
                return _two_sum(h, d + l)[i]
            return leaf

        # two passes over the tree; XLA CSEs the duplicated TwoSum
        return CompCarry(jax.tree.map(fold(0), hi, delta, lo),
                         jax.tree.map(fold(1), hi, delta, lo))

    return step
