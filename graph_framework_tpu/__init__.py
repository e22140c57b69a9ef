"""graph_framework_tpu: a differentiable plasma ray-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ORNL-Fusion/graph_framework (a C++20 computational-graph framework with
symbolic autodiff and runtime kernel codegen;
https://github.com/ORNL-Fusion/graph_framework).

Where the reference builds a symbolic expression DAG, differentiates it with
per-node ``df`` rules, and string-prints CUDA/Metal/C++ kernels that are JIT
compiled per device (reference: graph_framework/node.hpp, jit.hpp,
cuda_context.hpp), this framework expresses the physics as plain JAX functions
and obtains

* analytic derivatives via ``jax.grad`` (one fused backward pass instead of a
  symbolic-derivative graph),
* the single fused per-step kernel via ``jax.jit``/XLA fusion (plus optional
  Pallas kernels for the gather-heavy spline evaluation),
* data-parallel scaling over rays via ``jax.sharding`` meshes instead of one
  host thread per device (reference: graph_driver/xrays.cpp:419-527).

Public subpackages
------------------
``ops``       Low-level numerics: table gathers, spline evaluation, special
              functions (Faddeeva/erfi), Newton iteration, RK integrators.
``models``    Physics: equilibria (slab/EFIT/VMEC), the dispersion-relation
              zoo, ray-equation assembly, absorption, particle pushers.
``parallel``  Device-mesh sharding helpers for multi-chip ray ensembles.
``io``        NetCDF-compatible result files and equilibrium loaders.
``cli``       Drivers mirroring the reference binaries (xrays, xkorc, xpic,
              xrays_bench).
``expr``      A small traced-expression compatibility layer backing the C API
              (reference: graph_c_binding/).
"""

__version__ = "0.1.0"

from graph_framework_tpu import constants  # noqa: F401
