"""Plasma equilibrium models (fields + profiles).

Counterpart of ``equilibrium::generic`` and the analytic
equilibria (reference: graph_framework/equilibrium.hpp:235-1104).  Instead of
virtual methods returning graph nodes, an equilibrium here is a *pytree
dataclass* whose methods are plain per-point JAX functions: they take a
position 3-vector of scalars and return scalars / 3-vectors.  Ray-ensemble
evaluation comes from ``jax.vmap`` over the ray axis, and derivatives (e.g.
grad-B in the ray equations, div-B in tests) from ``jax.grad``/``jacfwd``
instead of symbolic ``df``.

All quantities use the reference's units: densities in 1/m^3, temperatures in
eV, magnetic fields in T, positions in m.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Mapping
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graph_framework_tpu.constants import MI_DEUTERIUM


@contextlib.contextmanager
def open_tables(source):
    """Yield ``arr(name) -> float64 array`` over an equilibrium's tables.

    ``source`` is either a mapping of table name to array (as
    tools.make_splines.efit_tables / vmec_tables return) or the path of a
    spline file in the reference's NetCDF4/HDF5 format; only the latter
    needs h5py.
    """
    if isinstance(source, Mapping):
        yield lambda name: np.asarray(source[name], dtype=np.float64)
        return
    import h5py

    with h5py.File(source, "r") as h:
        yield lambda name: np.asarray(h[name][...], dtype=np.float64)


class PlasmaQuantities(NamedTuple):
    """Everything a dispersion relation reads from the equilibrium at one
    point, fetched together.

    The reference memoizes equilibrium subgraphs keyed on the evaluation
    point (``set_cache``, equilibrium.hpp:1324-1384) so the ne/te/B
    expressions share their psi lookup inside one kernel; the equivalent
    here is this fused accessor - spline equilibria serve all fields
    from a single coefficient-block gather instead of one gather per
    accessor call (see ``EfitEquilibrium.plasma_quantities``).
    """
    b: jax.Array                 # magnetic field (3,) [T]
    ne: jax.Array                # electron density [1/m^3]
    te: jax.Array                # electron temperature [eV]
    ni: Tuple[jax.Array, ...]    # per-species ion densities
    ti: Tuple[jax.Array, ...]    # per-species ion temperatures


class Equilibrium:
    """Base interface (equilibrium.hpp:235-466).

    Subclasses implement the profile/field methods; the basis/coordinate
    methods default to cartesian (identity), matching ``generic::get_esup*``
    and ``get_x/y/z`` (equilibrium.hpp:383-466).
    """

    #: per-species ion masses [kg] / charges [e] (equilibrium.hpp:240-243).
    ion_masses: Tuple[float, ...] = ()
    ion_charges: Tuple[int, ...] = ()

    @property
    def num_ion_species(self) -> int:
        return len(self.ion_masses)

    # -- profiles ----------------------------------------------------------
    def electron_density(self, pos):
        raise NotImplementedError

    def ion_density(self, index, pos):
        raise NotImplementedError

    def electron_temperature(self, pos):
        raise NotImplementedError

    def ion_temperature(self, index, pos):
        raise NotImplementedError

    def magnetic_field(self, pos):
        raise NotImplementedError

    def plasma_quantities(self, pos) -> PlasmaQuantities:
        """All dispersion inputs at one point (see PlasmaQuantities).

        Default: delegate to the individual accessors - correct for the
        analytic equilibria, whose quantities share no work.  Spline
        equilibria override this to share the table gathers; unused
        outputs are dead-code-eliminated by XLA.
        """
        n = self.num_ion_species
        return PlasmaQuantities(
            b=self.magnetic_field(pos),
            ne=self.electron_density(pos),
            te=self.electron_temperature(pos),
            ni=tuple(self.ion_density(i, pos) for i in range(n)),
            ti=tuple(self.ion_temperature(i, pos) for i in range(n)),
        )

    def characteristic_field(self):
        """Normalizing field magnitude (used by the Boris pusher;
        equilibrium.hpp get_characteristic_field)."""
        raise NotImplementedError

    # -- coordinates -------------------------------------------------------
    def esup(self, pos):
        """Contravariant basis vectors as rows of a (3, 3) matrix
        (e^1; e^2; e^3).  Cartesian default: identity
        (equilibrium.hpp:383-440)."""
        return jnp.eye(3, dtype=jnp.result_type(pos))

    def kvec(self, kcov, pos):
        """Physical wave vector from covariant components:
        k = kx e^1 + ky e^2 + kz e^3 (dispersion.hpp:1387-1389).

        Batched polymorphic: ``kcov``/``pos`` are (3,) per point or
        (3, num_rays); ``esup(pos)`` rows broadcast against the covariant
        components, so k = sum_i k_i e^i works for both shapes."""
        if self.is_cartesian():
            return kcov        # identity basis: skip the 3x3 contraction
        esup = self.esup(pos)  # (3 basis, 3 comp[, rays])
        return (kcov[0] * esup[0] + kcov[1] * esup[1]
                + kcov[2] * esup[2])

    def is_cartesian(self) -> bool:
        """True when esup() is the identity everywhere - lets the ray
        equations skip the metric correction term."""
        return True

    def bind_point(self, pos):
        """Return an equilibrium *view* with any shared geometry
        precomputed at ``pos`` - the counterpart of the reference's
        subgraph memoization keyed on the evaluation point (``set_cache``,
        equilibrium.hpp:1324-1384, 2073-2141).

        Callers that evaluate several quantities at ONE point (the ray
        right-hand side needs kvec's basis AND the dispersion's B at the
        same pos) should bind once and query the view, so the expensive
        geometry appears exactly once in the traced graph - guaranteed, as
        opposed to hoping XLA CSE merges duplicate subtrees (and their
        doubled reverse-mode cotangent paths).  Default: ``self`` - the
        analytic/cartesian equilibria share no work between accessors.
        """
        return self

    def supports_batched(self) -> bool:
        """True when the field/basis methods are batched-polymorphic
        (accept (3, num_rays) positions as well as (3,)), enabling the
        lane-major ensemble paths in models/rays.py.  Cartesian equilibria
        qualify by construction; non-cartesian subclasses with polymorphic
        geometry (VMEC) override this."""
        return self.is_cartesian()

    def to_xyz(self, pos):
        """Map the equilibrium's coordinates to cartesian x, y, z
        (identity by default; equilibrium.hpp get_x/get_y/get_z)."""
        return pos


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _AnalyticEquilibrium(Equilibrium):
    """Shared bits of the closed-form equilibria: one deuterium ion species
    (mass 3.34449469e-27 kg, charge 1; equilibrium.hpp:488,617,...)."""

    @property
    def ion_masses(self):
        return (MI_DEUTERIUM,)

    @property
    def ion_charges(self):
        return (1,)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NoMagneticField(_AnalyticEquilibrium):
    """Linear density ramp, B = 0 (equilibrium.hpp:482-595):
    ne = ni = 1e19 (0.1 x + 1), te = ti = 1000 eV."""

    def electron_density(self, pos):
        return 1.0e19 * (0.1 * pos[0] + 1.0)

    def ion_density(self, index, pos):
        return self.electron_density(pos)

    def electron_temperature(self, pos):
        return jnp.asarray(1000.0, dtype=jnp.result_type(pos))

    def ion_temperature(self, index, pos):
        return self.electron_temperature(pos)

    def magnetic_field(self, pos):
        return jnp.zeros_like(pos)

    def characteristic_field(self):
        return 1.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Slab(_AnalyticEquilibrium):
    """Uniform density, sheared field (equilibrium.hpp:611-719):
    ne = ni = 1e19, te = ti = 1000 eV, B = (0, 0, 0.1 x + 1)."""

    def electron_density(self, pos):
        return jnp.asarray(1.0e19, dtype=jnp.result_type(pos))

    def ion_density(self, index, pos):
        return self.electron_density(pos)

    def electron_temperature(self, pos):
        return jnp.asarray(1000.0, dtype=jnp.result_type(pos))

    def ion_temperature(self, index, pos):
        return self.electron_temperature(pos)

    def magnetic_field(self, pos):
        zero = jnp.zeros_like(pos[0])
        return jnp.stack([zero, zero, 0.1 * pos[0] + 1.0])

    def characteristic_field(self):
        return 1.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SlabDensity(_AnalyticEquilibrium):
    """Linear density ramp, uniform field (equilibrium.hpp:735-848):
    ne = ni = 1e19 (0.1 x + 1), te = ti = 1000 eV, B = (0, 0, 1)."""

    def electron_density(self, pos):
        return 1.0e19 * (0.1 * pos[0] + 1.0)

    def ion_density(self, index, pos):
        return self.electron_density(pos)

    def electron_temperature(self, pos):
        return jnp.asarray(1000.0, dtype=jnp.result_type(pos))

    def ion_temperature(self, index, pos):
        return self.electron_temperature(pos)

    def magnetic_field(self, pos):
        zero = jnp.zeros_like(pos[0])
        return jnp.stack([zero, zero, zero + 1.0])

    def characteristic_field(self):
        return 1.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SlabField(_AnalyticEquilibrium):
    """Gentle density+temperature+field ramps (equilibrium.hpp:864-977):
    ne = ni = 1e19 (0.01 x + 1), te = ti = 2000 (0.01 x + 1) eV,
    B = (0, 0, 0.01 x + 1)."""

    def electron_density(self, pos):
        return 1.0e19 * (0.01 * pos[0] + 1.0)

    def ion_density(self, index, pos):
        return self.electron_density(pos)

    def electron_temperature(self, pos):
        return 2000.0 * (0.01 * pos[0] + 1.0)

    def ion_temperature(self, index, pos):
        return self.electron_temperature(pos)

    def magnetic_field(self, pos):
        zero = jnp.zeros_like(pos[0])
        return jnp.stack([zero, zero, 0.01 * pos[0] + 1.0])

    def characteristic_field(self):
        return 1.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GaussianDensity(_AnalyticEquilibrium):
    """Gaussian density well, uniform x-directed field
    (equilibrium.hpp:991-1104): ne = ni = 1e19 exp(-(x^2+y^2)/0.2),
    te = ti = 1000 eV, B = (1, 0, 0)."""

    def electron_density(self, pos):
        return 1.0e19 * jnp.exp((pos[0] * pos[0] + pos[1] * pos[1]) / -0.2)

    def ion_density(self, index, pos):
        return self.electron_density(pos)

    def electron_temperature(self, pos):
        return jnp.asarray(1000.0, dtype=jnp.result_type(pos))

    def ion_temperature(self, index, pos):
        return self.electron_temperature(pos)

    def magnetic_field(self, pos):
        zero = jnp.zeros_like(pos[0])
        return jnp.stack([zero + 1.0, zero, zero])

    def characteristic_field(self):
        return 1.0


# -- factories matching the reference's make_* helpers ----------------------
def make_no_magnetic_field():
    return NoMagneticField()


def make_slab():
    return Slab()


def make_slab_density():
    return SlabDensity()


def make_slab_field():
    return SlabField()


def make_gaussian_density():
    return GaussianDensity()
