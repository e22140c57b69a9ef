"""Split-complex arithmetic: complex values as (re, im) real pairs.

A ``Cplx`` carries (re, im) real arrays and implements the holomorphic
operations the absorption physics needs; the Faddeeva function ports to
split form directly (its algorithm is real-coefficient rational/polynomial
arithmetic around complex adds/multiplies).  Registered as a pytree so it
passes through jit/vmap/grad; derivatives of a holomorphic split function
f follow from the Cauchy-Riemann relations - jvp with tangent (1, 0) on
the (re, im) inputs yields (Re f', Im f').
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

_SQRT_PI = math.sqrt(math.pi)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Cplx:
    re: jax.Array
    im: jax.Array

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- construction ------------------------------------------------------
    @staticmethod
    def of(v):
        if isinstance(v, Cplx):
            return v
        v = jnp.asarray(v)
        if jnp.iscomplexobj(v):
            return Cplx(v.real, v.imag)
        return Cplx(v, jnp.zeros_like(v))

    def to_complex(self):
        return jax.lax.complex(self.re, self.im)

    # -- field operations --------------------------------------------------
    def __add__(self, o):
        o = Cplx.of(o)
        return Cplx(self.re + o.re, self.im + o.im)

    __radd__ = __add__

    def __neg__(self):
        return Cplx(-self.re, -self.im)

    def __sub__(self, o):
        o = Cplx.of(o)
        return Cplx(self.re - o.re, self.im - o.im)

    def __rsub__(self, o):
        return Cplx.of(o) - self

    def __mul__(self, o):
        o = Cplx.of(o)
        return Cplx(self.re * o.re - self.im * o.im,
                    self.re * o.im + self.im * o.re)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = Cplx.of(o)
        d = o.re * o.re + o.im * o.im
        return Cplx((self.re * o.re + self.im * o.im) / d,
                    (self.im * o.re - self.re * o.im) / d)

    def __rtruediv__(self, o):
        return Cplx.of(o) / self

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def conj(self):
        return Cplx(self.re, -self.im)


def csqrt(z: Cplx) -> Cplx:
    """Principal complex square root in split form."""
    r = jnp.sqrt(z.re * z.re + z.im * z.im)
    re = jnp.sqrt(jnp.maximum((r + z.re) / 2.0, 0.0))
    im_mag = jnp.sqrt(jnp.maximum((r - z.re) / 2.0, 0.0))
    im = jnp.where(z.im >= 0, im_mag, -im_mag)
    return Cplx(re, im)


def cexp(z: Cplx) -> Cplx:
    e = jnp.exp(z.re)
    return Cplx(e * jnp.cos(z.im), e * jnp.sin(z.im))


def cwhere(cond, a: Cplx, b: Cplx) -> Cplx:
    return Cplx(jnp.where(cond, a.re, b.re), jnp.where(cond, a.im, b.im))


# ---------------------------------------------------------------------------
# Faddeeva w(z) in split form (same regions as ops.special.wofz)
# ---------------------------------------------------------------------------

def _w_contfrac_split(z: Cplx, levels=12) -> Cplx:
    r = Cplx(jnp.zeros_like(z.re), jnp.zeros_like(z.im))
    for n in range(levels, 0, -1):
        r = Cplx.of(0.5 * n) / (z - r)
    inv = Cplx.of(1.0) / (z - r)
    # (i/sqrt(pi)) * inv
    return Cplx(-inv.im / _SQRT_PI, inv.re / _SQRT_PI)


def _w_weideman_split(z: Cplx, n_terms=64) -> Cplx:
    from graph_framework_tpu.ops.special import _weideman_coeffs
    ell, a_np = _weideman_coeffs(n_terms)
    a = jnp.asarray(a_np, dtype=z.re.dtype)
    iz = Cplx(-z.im, z.re)                       # i z
    recip = Cplx.of(1.0) / (Cplx.of(ell) - iz)   # 1/(L - iz)
    bigz = (Cplx.of(ell) + iz) * recip
    poly = Cplx(jnp.zeros_like(z.re), jnp.zeros_like(z.im))
    for i in range(n_terms):
        poly = poly * bigz + Cplx.of(a[i])
    return recip * recip * 2.0 * poly + recip * (1.0 / _SQRT_PI)


def wofz_split(z: Cplx) -> Cplx:
    """Faddeeva w(z) on the whole plane, complex-dtype-free."""
    upper = z.im >= 0.0
    zu = cwhere(upper, z, -z)
    big = zu.abs2() >= 36.0
    z_big = cwhere(big, zu, Cplx.of(8.0))
    z_small = cwhere(big, Cplx(jnp.zeros_like(zu.re),
                               jnp.zeros_like(zu.im)), zu)
    wu = cwhere(big, _w_contfrac_split(z_big), _w_weideman_split(z_small))
    # lower half plane: w(z) = 2 exp(-z^2) - w(-z)
    mre = (z.im - z.re) * (z.im + z.re)
    mim = -2.0 * z.re * z.im
    expmz2 = Cplx(jnp.exp(jnp.where(upper, 0.0, mre)) * jnp.cos(mim),
                  jnp.exp(jnp.where(upper, 0.0, mre)) * jnp.sin(mim))
    return cwhere(upper, wu, expmz2 * 2.0 - wu)


def z_plasma_split(zeta: Cplx) -> Cplx:
    """Plasma dispersion function Z = i sqrt(pi) w(zeta), split form."""
    w = wofz_split(zeta)
    return Cplx(-_SQRT_PI * w.im, _SQRT_PI * w.re)
