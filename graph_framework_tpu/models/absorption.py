"""Power absorption along traced rays: complex kamp update + binning.

Counterpart of ``absorption::weak_damping/root_finder`` and the
xrays ``bin_power`` phase (reference: graph_framework/absorption.hpp:111-487,
graph_driver/xrays.cpp:598-793).  The reference re-opens the trace NetCDF,
and for every saved timestep loads the 8 state arrays to the device, runs a
complex-dtype kernel updating the wave amplitude kamp, and writes it back;
power binning then accumulates Im(kamp) dl along each trajectory.

Complex dtypes: the kamp physics is genuinely complex (hot-plasma Z
function) and runs in native complex by default; the split (re, im)
real-pair kernels stay available on request (``run_absorption(split=True)``).

The covariant-to-cartesian basis products run at full f32/f64 precision
(``HIGHEST``): on a GPU a default-precision f32 matrix product may run in
TF32, which keeps about three decimal digits.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from graph_framework_tpu.models import dispersion as disp
from graph_framework_tpu.models.rays import RayState
from graph_framework_tpu.ops.newton import newton_solve
from graph_framework_tpu.ops.special import z_erfi, z_plasma

HIGHEST = jax.lax.Precision.HIGHEST


def _matvec(v, m):
    """``v @ m`` at full precision."""
    return jnp.matmul(v, m, precision=HIGHEST)


def make_weak_damping(eq, z_function=None):
    """Analytic weak-damping kamp update (absorption.hpp:328-432):

        kamp <- |k| - Dw / (khat . dDc/dk)

    with Dc the cold-plasma expansion and Dw the hot-plasma expansion,
    the k-gradient taken in covariant components mapped through the
    contravariant basis (absorption.hpp:408-412).
    Returns a jittable ``update(state) -> kamp`` over complex RayState.
    """
    # z_plasma = i sqrt(pi) w(zeta) is analytically the reference's z_erfi
    # (dispersion.hpp:288-302) but avoids its exp(-z^2)*erfi 0*inf overflow
    # at large zeta - the failure mode the reference papers over with
    # SAFE_MATH NaN scrubbing (cuda_context.hpp:883-899).
    zf = z_function or z_plasma
    dw_fn = disp.make_hot_plasma_expansion(zf)

    def kamp_one(t, w, x, y, z, kx, ky, kz):
        pos = jnp.stack([x, y, z])
        kcov = jnp.stack([kx, ky, kz])
        esup = eq.esup(pos).astype(kcov.dtype)
        kvec = _matvec(kcov, esup)
        klen = jnp.sqrt(jnp.sum(kvec * kvec))
        k_unit = kvec / klen

        def dc_of(kcov_):
            kvec_ = _matvec(kcov_, esup)
            return disp.cold_plasma_expansion(w, kvec_, pos, t, eq)

        ddc_dkcov = jax.grad(dc_of, holomorphic=True)(kcov)
        # dDc/dk as a physical vector: sum_i dDc/dk_i e^i
        ddc_vec = _matvec(ddc_dkcov, esup)
        dw = dw_fn(w, kvec, pos, t, eq)
        return klen - dw / jnp.sum(k_unit * ddc_vec)

    vk = jax.vmap(kamp_one)

    def update(state: RayState):
        return vk(state.t, state.w, state.x, state.y, state.z,
                  state.kx, state.ky, state.kz)

    return update


def make_root_finder(eq, z_function=None, *, tolerance=1.0e-30,
                     max_iterations=1000):
    """Newton root-find of the full hot-plasma D for the complex amplitude
    correction (absorption.hpp:145-317):

        kamp := 0;  solve D_hot(k + kamp * khat) = 0 for kamp;
        kamp <- |k| + kamp.

    Returns ``update(state) -> kamp``.
    """
    zf = z_function or z_plasma
    d_hot = disp.make_hot_plasma(zf)

    def update(state: RayState):
        pos = jnp.stack([state.x, state.y, state.z], axis=-1)
        kcov = jnp.stack([state.kx, state.ky, state.kz], axis=-1)
        esup = jax.vmap(eq.esup)(pos).astype(kcov.dtype)
        kvec = jnp.einsum("ri,rij->rj", kcov, esup, precision=HIGHEST)
        klen = jnp.sqrt(jnp.sum(kvec * kvec, axis=-1))
        k_unit = kvec / klen[..., None]

        def f(kamp):
            kshift = kvec + kamp[..., None] * k_unit
            return jax.vmap(d_hot, in_axes=(0, 0, 0, 0, None))(
                state.w, kshift, pos, state.t, eq)

        kamp0 = jnp.zeros_like(state.w)
        kamp, _, _ = newton_solve(
            f, kamp0, tolerance=tolerance, max_iterations=max_iterations,
            holomorphic=True)
        return klen + kamp

    return update


def make_weak_damping_split(eq):
    """Complex-free weak-damping kamp update (real-pair arithmetic).

    For *real* trajectory data (which is what the trace phase saves) the only complex
    quantity in the weak-damping update is Z(zeta) with real zeta:
    Dc and its k-gradient are real, and Dw factors as

        Dw = R * (1/Z + zeta)        (hot_plasma_expansion,
                                      dispersion.hpp:1208-1299)

    with R and zeta real.  So kamp = |k| - Dw/(khat . dDc/dk) splits into
    explicit (re, im) arithmetic around a real-argument Z
    (ops.special.z_plasma_real).  Returns ``update(state) -> (re, im)``
    over a real RayState.
    """
    from graph_framework_tpu.constants import (
        Q, ME, C, plasma_frequency_squared, cyclotron_frequency)
    from graph_framework_tpu.ops.special import z_plasma_real

    def kamp_batched(t, w, pos, kvec, ddc_vec):
        """Batched (component-axis-leading) kamp body: vectors are
        (3, ...) so every intermediate is a full per-ray array (see
        models/rays.py for the layout rationale).  ``ddc_vec`` is
        the cold-expansion k-gradient as a physical vector, computed by the
        caller (covariant-through-esup for non-cartesian equilibria,
        absorption.hpp:408-412)."""
        klen = jnp.sqrt(jnp.sum(kvec * kvec, axis=0))
        k_unit = kvec / klen
        denom = jnp.sum(k_unit * ddc_vec, axis=0)

        # real pieces of Dw (transcription of make_hot_plasma_expansion
        # with the complex Z factored out)
        b = eq.magnetic_field(pos)
        b_len = jnp.sqrt(jnp.sum(b * b, axis=0))
        bhat = b / b_len
        ne = eq.electron_density(pos)
        te = eq.electron_temperature(pos)
        ve = jnp.sqrt(te * (2.0 * Q / ME))
        ec = cyclotron_frequency(Q, b_len, ME)
        wpe2 = plasma_frequency_squared(ne, Q, ME)
        P = wpe2 / (w * w)
        q = P / (2.0 * (1.0 + ec / w))
        n = kvec / w
        n2 = jnp.sum(n * n, axis=0)
        npara = jnp.sum(bhat * n, axis=0)
        npara2 = npara * npara
        nperp2 = n2 - npara2
        vt = ve / C
        zeta = (1.0 - ec / w) / (npara * vt)

        q_func = 1.0 - 2.0 * q
        n_func = n2 + npara2
        p_func = 1.0 - P
        gamma5 = P * (n2 * npara2 - (1.0 - q) * n_func + q_func)
        gamma2 = (P * w / ec * nperp2 * (n2 - q_func)
                  + P * P * w * w / (4.0 * ec * ec)
                  * (n_func - 2.0 * q_func) * nperp2 / npara2)
        gamma1 = ((1.0 - q) * n2 * nperp2
                  + p_func * (n2 * npara2 - (1.0 - q) * n_func)
                  + q_func * (p_func - nperp2))
        R = (-(1.0 + ec / w) * npara * vt
             * (gamma1 + gamma2 + nperp2 / (2.0 * npara)
                * (w * w / (ec * ec)) * vt * zeta * gamma5))

        # Dw = R (1/Z + zeta): split 1/Z = conj(Z)/|Z|^2
        z_re, z_im = z_plasma_real(zeta)
        zabs2 = z_re * z_re + z_im * z_im
        dw_re = R * (z_re / zabs2 + zeta)
        dw_im = R * (-z_im / zabs2)
        return klen - dw_re / denom, -dw_im / denom

    def update(state: RayState):
        pos = jnp.stack([state.x, state.y, state.z])
        kcov = jnp.stack([state.kx, state.ky, state.kz])
        if eq.is_cartesian():
            t, w = state.t, state.w

            # per-ray independence makes grad-of-sum the per-ray gradient
            def dc_sum(kvec_):
                return jnp.sum(
                    disp.cold_plasma_expansion(w, kvec_, pos, t, eq))

            ddc_vec = jax.grad(dc_sum)(kcov)
            return kamp_batched(t, w, pos, kcov, ddc_vec)

        def one(t, w, x, y, z, kx, ky, kz):
            p = jnp.stack([x, y, z])
            kc = jnp.stack([kx, ky, kz])
            esup = eq.esup(p)
            kv = _matvec(kc, esup)

            def dc_of(kc_):
                return disp.cold_plasma_expansion(w, _matvec(kc_, esup), p, t,
                                                  eq)

            ddc_vec = _matvec(jax.grad(dc_of)(kc), esup)
            return kamp_batched(t, w, p, kv, ddc_vec)

        return jax.vmap(one)(state.t, state.w, state.x, state.y, state.z,
                             state.kx, state.ky, state.kz)

    return update


def hot_plasma_split(w, kvec_c, pos, t, eq):
    """Hot-plasma D (dispersion.hpp:1099-1199) in split-complex form.

    ``w``, ``pos``, ``t`` real per-ray scalars; ``kvec_c`` a Cplx 3-vector
    (tuple of 3 Cplx) - complex through the kamp shift along khat.
    Transcription of make_hot_plasma with Cplx arithmetic (no complex
    dtypes).
    """
    from graph_framework_tpu.constants import (
        Q, ME, C, plasma_frequency_squared, cyclotron_frequency)
    from graph_framework_tpu.ops.cplx import Cplx, z_plasma_split

    b = eq.magnetic_field(pos)
    b_len = jnp.sqrt(jnp.sum(b * b, axis=0))
    bhat = b / b_len
    ne = eq.electron_density(pos)
    te = eq.electron_temperature(pos)
    ve = jnp.sqrt(te * (2.0 * Q / (ME * C * C)))
    ec = cyclotron_frequency(Q, b_len, ME)
    wpe2 = plasma_frequency_squared(ne, Q, ME)

    P = wpe2 / (w * w)
    q = P / (2.0 * (1.0 + ec / w))

    n = tuple(k / w for k in kvec_c)                     # Cplx 3-vector
    n2 = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    npara = n[0] * bhat[0] + n[1] * bhat[1] + n[2] * bhat[2]
    npara2 = npara * npara
    # nperp^2 = n.n - npara^2 (identity |bhat x n|^2 for unit bhat)
    nperp2 = n2 - npara2

    zeta = Cplx.of(1.0 - ec / w) / (npara * ve)
    Zf = z_plasma_split(zeta)
    zeta_func = zeta * Zf + 1.0
    F = zeta * (ve * w / (2.0 * ec)) / npara
    isigma = Zf * (P / (2.0 * ve)) / npara

    q_func = 1.0 - 2.0 * q
    p_func = 1.0 - P
    n_func = n2 + npara2

    gamma5 = n2 * npara2 - n_func * (1.0 - q) + q_func
    gamma2 = (n2 - q_func) + (n_func - 2.0 * q_func) \
        * (P * w / (4.0 * ec)) / npara2
    gamma1 = nperp2 * (n2 * (1.0 - q) - q_func) \
        + (n2 * npara2 - n_func * (1.0 - q) + q_func) * p_func
    gamma0 = nperp2 * (n2 - 2.0 * q_func) + (q_func * 2.0 - n_func) * p_func

    return (isigma * gamma0 + gamma1
            + nperp2 * zeta_func * (gamma2 + gamma5 * F) * (P * w / ec))


def make_root_finder_split(eq, *, tolerance=1.0e-30, max_iterations=1000,
                           return_diagnostics=False):
    """Complex-free Newton root finder for kamp (the real-pair form of
    make_root_finder): solve D_hot(k + kamp khat) = 0 for complex kamp
    carried as (re, im), Newton-updating with the holomorphic derivative
    obtained from one jvp (Cauchy-Riemann: tangent (1, 0) on (re, im)
    yields (Re D', Im D')).

    Convergence follows the converge_item criteria (workflow.hpp:179-205,
    same loop as ops.newton.newton_solve): iterate until the ensemble-max
    of |D|^2 drops below ``tolerance``, stagnates, 2-cycle oscillates, or
    ``max_iterations`` is reached.  Rays whose Newton step is undefined
    (dD/dkamp -> 0) or non-finite are frozen instead of poisoned - the
    stagnation criterion then terminates the loop (the reference relies on
    SAFE_MATH store scrubbing here, absorption.hpp:145-317 +
    cuda_context.hpp:883-899).

    Returns ``update(state) -> (kamp_re, kamp_im)`` over a real RayState;
    with ``return_diagnostics=True``, ``update(state) ->
    ((kamp_re, kamp_im), NewtonDiagnostics)``.
    """
    from graph_framework_tpu.ops.cplx import Cplx
    from graph_framework_tpu.ops.newton import NewtonDiagnostics

    def update(state: RayState):
        if getattr(eq, "supports_batched", eq.is_cartesian)():
            # lane-major ensemble: vectors (3, N), hot_plasma_split is
            # already componentwise (see models/rays.py for rationale)
            pos = jnp.stack([state.x, state.y, state.z])
            kcov = jnp.stack([state.kx, state.ky, state.kz])
            kvec = eq.kvec(kcov, pos)
            klen = jnp.sqrt(jnp.sum(kvec * kvec, axis=0))
            khat = kvec / klen

            def d_split(a_re, a_im):
                kc = tuple(Cplx(kvec[i] + a_re * khat[i],
                                a_im * khat[i]) for i in range(3))
                d = hot_plasma_split(state.w, kc, pos, state.t, eq)
                return d.re, d.im
        else:
            pos = jnp.stack([state.x, state.y, state.z], axis=-1)
            kcov = jnp.stack([state.kx, state.ky, state.kz], axis=-1)
            esup = jax.vmap(eq.esup)(pos)
            kvec = jnp.einsum("ri,rij->rj", kcov, esup, precision=HIGHEST)
            klen = jnp.sqrt(jnp.sum(kvec * kvec, axis=-1))
            khat = kvec / klen[..., None]

            def d_split(a_re, a_im):
                """D_hot with the shift kamp = a_re + i a_im, per ray."""
                def one(are, aim, kv, kh, p, w, t):
                    kc = tuple(
                        Cplx(kv[i] + are * kh[i], aim * kh[i])
                        for i in range(3))
                    d = hot_plasma_split(w, kc, p, t, eq)
                    return d.re, d.im
                return jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, 0))(
                    a_re, a_im, kvec, khat, pos, state.w, state.t)

        def eval_and_update(a_re, a_im):
            """One 'kernel call' in the reference's sense: a single fused
            evaluation producing the residual at (a_re, a_im) AND the
            Newton-updated point (the converge_item's kernel computes the
            residual output and applies the setter maps in one launch, so
            the loop costs ONE dispersion evaluation per iteration)."""
            (f_re, f_im), (df_re, df_im) = jax.jvp(
                d_split, (a_re, a_im), (jnp.ones_like(a_re),
                                        jnp.zeros_like(a_im)))
            cur = jnp.max(f_re * f_re + f_im * f_im)
            f = Cplx(f_re, f_im)
            df = Cplx(df_re, df_im)
            step = f / df
            # df -> 0 makes the Newton step undefined; a non-finite step
            # would poison the ray permanently.  Freeze such rays: the
            # stagnation criterion then ends the loop.
            ok = ((df.re * df.re + df.im * df.im) > 0.0) \
                & jnp.isfinite(step.re) & jnp.isfinite(step.im)
            return (jnp.where(ok, a_re - step.re, a_re),
                    jnp.where(ok, a_im - step.im, a_im), cur)

        # Carry invariant (reference parity, workflow.hpp:179-205): ``cur``
        # is the residual measured by the evaluation that PRODUCED the
        # current (a_re, a_im) - i.e. at the pre-update point, exactly the
        # reference's max_residual after each max_kernel() call.
        def cond(carry):
            a_re, a_im, cur, last, off_last, it = carry
            keep = cur > tolerance
            keep &= jnp.abs(last - cur) > tolerance
            keep &= jnp.abs(off_last - cur) > tolerance
            keep &= it < max_iterations
            return keep

        def body(carry):
            a_re, a_im, cur, last, off_last, it = carry
            new_off = jnp.where((it + 1) % 2 == 0, cur, off_last)
            a_re2, a_im2, cur2 = eval_and_update(a_re, a_im)
            return a_re2, a_im2, cur2, cur, new_off, it + 1

        a0 = jnp.zeros_like(state.w)
        big = jnp.asarray(jnp.finfo(jnp.result_type(a0)).max)
        a_re1, a_im1, cur1 = eval_and_update(a0, a0)
        a_re, a_im, res, _, _, it = jax.lax.while_loop(
            cond, body,
            (a_re1, a_im1, cur1, big, big, jnp.asarray(0, dtype=jnp.int32)))
        out = (klen + a_re, a_im)
        if return_diagnostics:
            return out, NewtonDiagnostics(it, res, res <= tolerance)
        return out

    return update


def run_absorption(file, eq, method="weak_damping", *,
                   dtype=jnp.complex128, writer=None,
                   update_fn: Optional[Callable] = None,
                   safe_math: bool = True,
                   split: bool = False):
    """Drive a kamp update over every timestep of a trace result file
    (the reference's per-time_index read/run/write loop,
    absorption.hpp:465-483, xrays.cpp:551-585).

    Appends a complex "kamp" variable to the file.

    ``split``: use the complex-free (re, im) real-pair kernels
    (make_weak_damping_split / make_root_finder_split) instead of the
    native-complex ones.  The complex combination and SAFE_MATH scrub then
    happen host-side in numpy.
    """
    import numpy as np

    if split:
        if update_fn is not None:
            raise ValueError(
                "update_fn expects complex RayStates and is not supported "
                "with split=True; pass split=False to use a custom update")
        # real counterpart of the requested complex dtype (f64 from
        # complex128 where x64 is enabled), derived host-side
        import numpy as _np
        real_dtype = jax.dtypes.canonicalize_dtype(
            _np.zeros((), dtype=dtype).real.dtype)
        upd = jax.jit(
            make_weak_damping_split(eq) if method == "weak_damping"
            else make_root_finder_split(eq))

        def update(state):
            re, im = upd(state)
            return np.asarray(re) + 1j * np.asarray(im)
    else:
        real_dtype = dtype
        update = jax.jit(update_fn or (
            make_weak_damping(eq) if method == "weak_damping"
            else make_root_finder(eq)))

    file.create_variable("kamp", complex_valued=True)
    names = ["time", "w", "x", "y", "z", "kx", "ky", "kz"]
    try:
        _run_absorption_loop(file, names, real_dtype, update, split,
                             safe_math, writer)
    finally:
        if writer is not None:
            writer.close()


def _run_absorption_loop(file, names, real_dtype, update, split,
                         safe_math, writer):
    import numpy as np
    for i in range(file.num_steps):
        row = file.read_step(i, names)
        state = RayState(
            t=jnp.asarray(row["time"], dtype=real_dtype),
            w=jnp.asarray(row["w"], dtype=real_dtype),
            x=jnp.asarray(row["x"], dtype=real_dtype),
            y=jnp.asarray(row["y"], dtype=real_dtype),
            z=jnp.asarray(row["z"], dtype=real_dtype),
            kx=jnp.asarray(row["kx"], dtype=real_dtype),
            ky=jnp.asarray(row["ky"], dtype=real_dtype),
            kz=jnp.asarray(row["kz"], dtype=real_dtype))
        kamp = update(state)
        if safe_math:
            # SAFE_MATH store scrubbing (cuda_context.hpp:883-899): the
            # reference's complex phase replaces non-finite stores with 0.
            kamp = jnp.where(jnp.isfinite(kamp.real)
                             & jnp.isfinite(kamp.imag), kamp, 0.0) \
                if not split else np.where(
                    np.isfinite(kamp.real) & np.isfinite(kamp.imag),
                    kamp, 0.0)
        target = writer or file
        target.write_step(i, {"kamp": kamp})


def bin_power(x, y, z, kamp_imag):
    """Accumulate absorbed power along trajectories (xrays.cpp:673-793).

    Inputs are (num_steps+1, num_rays) trajectory arrays; kamp_imag is
    Im(kamp).  Returns (power, d_power) of the same shape:

        dl_j    = |pos_j - pos_(j-1)|
        kdl_j   = Im(kamp_j) dl_j
        power_j = exp(-2 sum_(i<j) kdl_i)       (power_0 = power_1 = 1)
        d_power_j = |power_j - power_(j-1)|

    matching the reference's running k_sum kernel (p_next computed from the
    pre-update k_sum, xrays.cpp:718-724).
    """
    pos = jnp.stack([x, y, z], axis=-1)
    dl = jnp.linalg.norm(jnp.diff(pos, axis=0), axis=-1)   # (nt-1, nrays)
    kdl = kamp_imag[1:] * dl
    ksum_before = jnp.concatenate(
        [jnp.zeros_like(kdl[:1]), jnp.cumsum(kdl, axis=0)[:-1]], axis=0)
    power_tail = jnp.exp(-2.0 * ksum_before)
    power = jnp.concatenate([jnp.ones_like(power_tail[:1]), power_tail],
                            axis=0)
    d_power = jnp.concatenate(
        [jnp.zeros_like(power[:1]), jnp.abs(jnp.diff(power, axis=0))],
        axis=0)
    return power, d_power
