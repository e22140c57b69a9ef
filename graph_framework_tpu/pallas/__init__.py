"""Pallas kernels.

* ``efit_step`` - the frozen-window EFIT step as one Pallas kernel through
  Triton (``Solver(pallas_window=True)``): a block of rays keeps its state
  and frozen spline coefficients in registers for a whole freeze window.

A kernel runs compiled on a GPU and through the Pallas interpreter on the
CPU (``runtime.interpret_kernels``).  It stays only while it beats the
plain XLA path end to end on the card; PERF.md holds both numbers.
"""
