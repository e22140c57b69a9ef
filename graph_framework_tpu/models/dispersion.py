"""Dispersion relations D(omega, k, x, t) and the zoo of plasma waves.

Counterpart of ``dispersion.hpp`` (reference:
graph_framework/dispersion.hpp:227-1305).  Each dispersion function is a
plain per-ray scalar JAX function

    D(w, kvec, pos, t, eq) -> scalar residual

with ``kvec`` the *physical* wave vector (3,) and ``pos`` the coordinate
3-vector.  The ray right-hand sides come from ``jax.grad`` of D (see
``rays.py``), replacing the reference's symbolic ``df`` assembly
(dispersion.hpp:1369-1434).

Frequencies are normalized to the speed of light (w' = w/c in 1/m; see
constants.py), so D values are directly comparable with the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp

from graph_framework_tpu.constants import (
    Q, ME, plasma_frequency_squared, cyclotron_frequency)
from graph_framework_tpu.ops.special import z_plasma, z_power_series, z_erfi


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _vdot(a, b):
    """Dot product over the leading component axis.

    Vector quantities here are shaped (3,) per point or (3, num_rays)
    batched - the component axis LEADS so that under batched evaluation
    every intermediate is a full (num_rays,) array; a vmapped formulation
    would instead materialize (num_rays, 3) intermediates with a 3-wide
    trailing axis.
    """
    return jnp.sum(a * b, axis=0)


def _norm(v):
    return jnp.sqrt(_vdot(v, v))


def _bhat_or_zero(b):
    """Unit vector of b; the callers below are only used with non-zero B."""
    return b / _norm(b)


# ---------------------------------------------------------------------------
# the zoo (each mirrors one class in dispersion.hpp)
# ---------------------------------------------------------------------------

def stiff(w, kvec, pos, t, eq):
    """Stiff test system (dispersion.hpp:399-443):
    D = (1e3 (x - e^-t) - e^-t) kx + w."""
    return (1.0e3 * (pos[0] - jnp.exp(-t)) - jnp.exp(-t)) * kvec[0] + w


def simple(w, kvec, pos, t, eq):
    """Vacuum wave (dispersion.hpp:450-505): D = |k|^2 c^2/w^2 - 1 with
    c = 1 in normalized units."""
    return _vdot(kvec, kvec) / (w * w) - 1.0


def bohm_gross(w, kvec, pos, t, eq):
    """Warm electron plasma wave (dispersion.hpp:511-567):
    D = wpe^2 + 3/2 k_par^2 vth^2 - w^2, with k parallel to B when a field
    is present, vth^2 = 2 q te / (me c^2)."""
    pq = eq.plasma_quantities(pos)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    # scalar factor folded in Python f64 (see constants.py:
    # plasma_frequency_squared's underflow note)
    vterm2 = pq.te * (2.0 * Q / (ME * _C2))

    b = pq.b
    b2 = _vdot(b, b)
    kpar2 = jnp.where(
        b2 == 0.0,
        _vdot(kvec, kvec),
        _vdot(b, kvec) ** 2 / jnp.where(b2 == 0.0, 1.0, b2))
    return wpe2 + 1.5 * kpar2 * vterm2 - w * w


def light_wave(w, kvec, pos, t, eq):
    """Electromagnetic wave in unmagnetized plasma (dispersion.hpp:574-619):
    D = wpe^2 + |k|^2 - w^2."""
    ne = eq.plasma_quantities(pos).ne
    wpe2 = plasma_frequency_squared(ne, Q, ME)
    return wpe2 + _vdot(kvec, kvec) - w * w


def acoustic_wave(w, kvec, pos, t, eq):
    """Ion acoustic wave (dispersion.hpp:626-676):
    D = k_par^2 vs^2 - w^2, vs^2 = (q te + 3 q ti)/(mi c^2)."""
    mi = eq.ion_masses[0]
    pq = eq.plasma_quantities(pos)
    vs2 = pq.te * (Q / (mi * _C2)) + pq.ti[0] * (3.0 * Q / (mi * _C2))
    b = pq.b
    b2 = _vdot(b, b)
    kpar2 = jnp.where(
        b2 == 0.0,
        _vdot(kvec, kvec),
        _vdot(b, kvec) ** 2 / jnp.where(b2 == 0.0, 1.0, b2))
    return kpar2 * vs2 - w * w


def gaussian_well(w, kvec, pos, t, eq):
    """Gaussian refractive well (dispersion.hpp:683-714):
    D = |n|^2 - (1 - 0.5 exp(-(x^2+y^2)/0.1))."""
    well = 1.0 - 0.5 * jnp.exp(-(pos[0] * pos[0] + pos[1] * pos[1]) / 0.1)
    n2 = _vdot(kvec, kvec) / (w * w)
    return n2 - well


def ion_cyclotron(w, kvec, pos, t, eq):
    """Electrostatic ion-cyclotron wave (dispersion.hpp:722-776):
    D = wce - kperp^2 vs^2 - w^2 (as written in the reference, including
    the first-power wce term)."""
    mi = eq.ion_masses[0]
    pq = eq.plasma_quantities(pos)
    vs2 = pq.te * (Q / (mi * _C2)) + pq.ti[0] * (3.0 * Q / (mi * _C2))
    b = pq.b
    wce = cyclotron_frequency(-Q, _norm(b), ME)
    bhat = _bhat_or_zero(b)
    kperp2 = _vdot(kvec, kvec) - _vdot(bhat, kvec) ** 2
    return wce - kperp2 * vs2 - w * w


def ordinary_wave(w, kvec, pos, t, eq):
    """O mode (dispersion.hpp:784-829): D = 1 - wpe^2/w^2 - nperp^2."""
    pq = eq.plasma_quantities(pos)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    n = kvec / w
    bhat = _bhat_or_zero(pq.b)
    nperp2 = _vdot(n, n) - _vdot(bhat, n) ** 2
    return 1.0 - wpe2 / (w * w) - nperp2


def extra_ordinary_wave(w, kvec, pos, t, eq):
    """X mode (dispersion.hpp:837-895):
    D = 1 - wpe^2/w^2 (w^2 - wpe^2)/(w^2 - wh^2) - nperp^2 with
    wh^2 = wpe^2 + wce^2."""
    pq = eq.plasma_quantities(pos)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    b = pq.b
    wce = cyclotron_frequency(-Q, _norm(b), ME)
    n = kvec / w
    bhat = _bhat_or_zero(b)
    nperp2 = _vdot(n, n) - _vdot(bhat, n) ** 2
    wh2 = wpe2 + wce * wce
    w2 = w * w
    return 1.0 - wpe2 / w2 * (w2 - wpe2) / (w2 - wh2) - nperp2


def cold_plasma(w, kvec, pos, t, eq):
    """Multi-species cold-plasma determinant (dispersion.hpp:903-1009):
    D = det(eps + n n - n.n I) written out with Onsager symmetry; electrons
    plus every ion species contribute to eps11/eps12/eps33."""
    pq = eq.plasma_quantities(pos)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    b = pq.b
    b_len = _norm(b)
    ec = cyclotron_frequency(-Q, b_len, ME)

    w2 = w * w
    denome = 1.0 - ec * ec / w2
    e11 = 1.0 - (wpe2 / w2) / denome
    e12 = ((ec / w) * (wpe2 / w2)) / denome
    e33 = wpe2

    for i in range(eq.num_ion_species):
        mi = eq.ion_masses[i]
        charge = float(eq.ion_charges[i]) * Q
        wpi2 = plasma_frequency_squared(pq.ni[i], charge, mi)
        ic = cyclotron_frequency(charge, b_len, mi)
        denomi = 1.0 - ic * ic / w2
        e11 = e11 - (wpi2 / w2) / denomi
        e12 = e12 + ((ic / w) * (wpi2 / w2)) / denomi
        e33 = e33 + wpi2

    e12 = -e12
    e33 = 1.0 - e33 / w2

    n = kvec / w
    bhat = b / b_len
    n2 = _vdot(n, n)
    npara = _vdot(bhat, n)
    npara2 = npara * npara
    # |n x bhat|^2 = |n|^2 - (n.bhat)^2: the Lagrange identity replaces the
    # cross product, and m13 enters the determinant only squared, so the
    # reference's nperp = sqrt(...) never needs evaluating.
    nperp2 = n2 - npara2

    m11 = e11 - npara2
    m12 = e12
    m13_sq = npara2 * nperp2
    m22 = e11 - n2
    m33 = e33 - nperp2
    return (m11 * m22 - m12 * m12) * m33 - m22 * m13_sq


def cold_plasma_expansion(w, kvec, pos, t, eq):
    """Electron cold-plasma expansion Dc (dispersion.hpp:1017-1092):
    Dc = -P/2 (1 + ec/w) Gamma0 + (1 - ec^2/w^2) Gamma1."""
    pq = eq.plasma_quantities(pos)
    b = pq.b
    b_len = _norm(b)
    bhat = b / b_len

    ec = cyclotron_frequency(Q, b_len, ME)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)

    P = wpe2 / (w * w)
    q = P / (2.0 * (1.0 + ec / w))

    n = kvec / w
    n2 = _vdot(n, n)
    npara = _vdot(n, bhat)
    npara2 = npara * npara
    nperp2 = n2 - npara2
    n2nperp2 = n2 * nperp2

    q_func = 1.0 - 2.0 * q
    n_func = n2 + npara2
    p_func = 1.0 - P

    gamma1 = ((1.0 - q) * n2nperp2
              + p_func * (n2 * npara2 - (1.0 - q) * n_func)
              + q_func * (p_func - nperp2))
    gamma0 = (nperp2 * (n2 - 2.0 * q_func)
              + p_func * (2.0 * q_func - n_func))

    return (-P / 2.0 * (1.0 + ec / w) * gamma0
            + (1.0 - ec * ec / (w * w)) * gamma1)


def make_hot_plasma(z_function: Callable = z_plasma):
    """Hot electron plasma with Landau damping (dispersion.hpp:1099-1199):
    D = i sigma Gamma0 + Gamma1 + nperp^2 P w/ec (1 + zeta Z)(Gamma2 +
    Gamma5 F).  Complex-only; ``z_function`` selects the Z evaluation
    (z_plasma == the reference's z_erfi analytically)."""

    def hot_plasma(w, kvec, pos, t, eq):
        pq = eq.plasma_quantities(pos)
        b = pq.b
        b_len = _norm(b)
        bhat = b / b_len
        ne, te = pq.ne, pq.te

        ve = jnp.sqrt(2.0 * Q * te / ME) / _C
        ec = cyclotron_frequency(Q, b_len, ME)
        wpe2 = plasma_frequency_squared(ne, Q, ME)

        P = wpe2 / (w * w)
        q = P / (2.0 * (1.0 + ec / w))

        n = kvec / w
        n2 = _vdot(n, n)
        npara = _vdot(n, bhat)
        npara2 = npara * npara
        nperp2 = n2 - npara2

        zeta = (1.0 - ec / w) / (npara * ve)
        Zf = z_function(zeta)
        zeta_func = 1.0 + zeta * Zf
        F = ve * zeta * w / (2.0 * npara * ec)
        isigma = P * Zf / (2.0 * npara * ve)

        q_func = 1.0 - 2.0 * q
        n_func = n2 + npara2
        p_func = 1.0 - P

        gamma5 = n2 * npara2 - (1.0 - q) * n_func + q_func
        gamma2 = ((n2 - q_func)
                  + P * w / (4.0 * ec * npara2) * (n_func - 2.0 * q_func))
        gamma1 = (nperp2 * ((1.0 - q) * n2 - q_func)
                  + p_func * (n2 * npara2 - (1.0 - q) * n_func + q_func))
        gamma0 = (nperp2 * (n2 - 2.0 * q_func)
                  + p_func * (2.0 * q_func - n_func))

        return (isigma * gamma0 + gamma1
                + nperp2 * P * w / ec * zeta_func * (gamma2 + gamma5 * F))

    return hot_plasma


def make_hot_plasma_expansion(z_function: Callable = z_plasma):
    """Weakly-damped hot-plasma expansion Dw (dispersion.hpp:1208-1299):
    Dw = -(1 + ec/w) npara vt (Gamma1 + Gamma2 + nperp^2/(2 npara)
    (w^2/ec^2) vt zeta Gamma5)(1/Z + zeta)."""

    def hot_plasma_expansion(w, kvec, pos, t, eq):
        pq = eq.plasma_quantities(pos)
        b = pq.b
        b_len = _norm(b)
        bhat = b / b_len
        ne, te = pq.ne, pq.te

        ve = jnp.sqrt(2.0 * Q * te / ME)
        ec = cyclotron_frequency(Q, b_len, ME)
        wpe2 = plasma_frequency_squared(ne, Q, ME)

        P = wpe2 / (w * w)
        q = P / (2.0 * (1.0 + ec / w))

        n = kvec / w
        n2 = _vdot(n, n)
        npara = _vdot(bhat, n)
        npara2 = npara * npara
        nperp2 = n2 - npara2

        vtnorm = ve / _C
        zeta = (1.0 - ec / w) / (npara * vtnorm)
        Zf = z_function(zeta)

        q_func = 1.0 - 2.0 * q
        n_func = n2 + npara2
        n2nperp2 = n2 * nperp2
        p_func = 1.0 - P

        gamma5 = P * (n2 * npara2 - (1.0 - q) * n_func + q_func)
        gamma2 = (P * w / ec * nperp2 * (n2 - q_func)
                  + P * P * w * w / (4.0 * ec * ec)
                  * (n_func - 2.0 * q_func) * nperp2 / npara2)
        gamma1 = ((1.0 - q) * n2nperp2
                  + p_func * (n2 * npara2 - (1.0 - q) * n_func)
                  + q_func * (p_func - nperp2))

        return (-(1.0 + ec / w) * npara * vtnorm
                * (gamma1 + gamma2
                   + nperp2 / (2.0 * npara) * (w * w / (ec * ec))
                   * vtnorm * zeta * gamma5)
                * (1.0 / Zf + zeta))

    return hot_plasma_expansion


# speed of light in m/s and its square, local aliases
from graph_framework_tpu.constants import C as _C  # noqa: E402
_C2 = _C * _C

#: registry used by the CLI (--dispersion=...; xrays.cpp:955-1037)
DISPERSIONS = {
    "simple": simple,
    "stiff": stiff,
    "bohm_gross": bohm_gross,
    "light_wave": light_wave,
    "acoustic_wave": acoustic_wave,
    "gaussian_well": gaussian_well,
    "ion_cyclotron": ion_cyclotron,
    "ordinary_wave": ordinary_wave,
    "extra_ordinary_wave": extra_ordinary_wave,
    "cold_plasma": cold_plasma,
    "cold_plasma_expansion": cold_plasma_expansion,
    "hot_plasma": make_hot_plasma(),
    "hot_plasma_expansion": make_hot_plasma_expansion(),
}
