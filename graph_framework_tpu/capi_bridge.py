"""Python side of the C binding (handle management + dtype plumbing).

The native library (capi/graph_c_binding.c) embeds CPython and calls these
functions; graph nodes cross the boundary as raw PyObject pointers owned by
the C side.  Mirrors the object model of the reference's C binding
(graph_c_binding/graph_c_binding.cpp): a context owns a workflow manager
and a scalar type; nodes are expression handles.
"""

from __future__ import annotations

import numpy as np

from graph_framework_tpu import expr as g

_DTYPES = {0: np.float32, 1: np.float64,
           2: np.complex64, 3: np.complex128}


class Context:
    def __init__(self, type_code: int, safe_math: bool):
        self.type_code = type_code
        self.dtype = _DTYPES[type_code]
        self.safe_math = bool(safe_math)
        self.work = g.Workflow()

    @property
    def is_complex(self):
        return self.type_code >= 2


def make_context(type_code, safe_math):
    import jax
    if int(type_code) in (1, 3):     # DOUBLE / COMPLEX_DOUBLE
        jax.config.update("jax_enable_x64", True)
    return Context(int(type_code), bool(safe_math))


def variable(ctx, size, symbol):
    return g.variable(int(size), 0.0, symbol or "v")


def constant(ctx, value):
    return g.constant(ctx.dtype(value))


def constant_c(ctx, re, im):
    return g.constant(ctx.dtype(complex(re, im)))


def set_variable(ctx, var, buf):
    arr = np.frombuffer(buf, dtype=ctx.dtype, count=var.size).copy()
    var.set(arr.astype(np.complex128 if ctx.is_complex else np.float64))


def pseudo_variable(ctx, node):
    return g.pseudo_variable(node)


def remove_pseudo(ctx, node):
    return node.remove_pseudo()


def add(ctx, a, b):
    return a + b


def sub(ctx, a, b):
    return a - b


def mul(ctx, a, b):
    return a * b


def div(ctx, a, b):
    return a / b


def sqrt(ctx, a):
    return g.sqrt(a)


def exp(ctx, a):
    return g.exp(a)


def log(ctx, a):
    return g.log(a)


def pow(ctx, a, b):
    return g.pow_(a, b)


def erfi(ctx, a):
    return g.erfi(a)


def sin(ctx, a):
    return g.sin(a)


def cos(ctx, a):
    return g.cos(a)


def atan(ctx, a, b):
    return g.atan(a, b)


def random_state(ctx, seed):
    # the state handle just carries the seed; graph_random builds the node
    return int(seed)


def random(ctx, state_or_seed):
    seed = state_or_seed if isinstance(state_or_seed, int) else 0
    return g.random(1, seed=seed)


def piecewise_1d(ctx, arg, scale, offset, buf, size):
    data = np.frombuffer(buf, dtype=ctx.dtype, count=int(size))
    return g.piecewise_1D(data, arg, scale, offset)


def piecewise_2d(ctx, num_cols, x, x_scale, x_offset, y, y_scale,
                 y_offset, buf, size):
    data = np.frombuffer(buf, dtype=ctx.dtype, count=int(size))
    return g.piecewise_2D(data, int(num_cols), x, x_scale, x_offset,
                          y, y_scale, y_offset)


def index_1d(ctx, var, arg, scale, offset):
    return g.index_1D(var, arg, scale, offset)


def index_2d(ctx, var, num_cols, x, x_scale, x_offset, y, y_scale,
             y_offset):
    return g.index_2D(var, int(num_cols), x, x_scale, x_offset,
                      y, y_scale, y_offset)


def df(ctx, a, b):
    return a.df(b)


def get_max_concurrency(ctx):
    import jax
    return len(jax.devices())


def set_device_number(ctx, num):
    pass   # single-program SPMD; device selection is mesh-level


def _items(inputs, outputs, map_in, map_out):
    setters = list(zip(map_in, map_out))
    return list(inputs), list(outputs), setters


def add_pre_item(ctx, inputs, outputs, map_in, map_out, name, size):
    i, o, s = _items(inputs, outputs, map_in, map_out)
    ctx.work.add_preitem(i, o, s, name=name or "pre")


def add_item(ctx, inputs, outputs, map_in, map_out, name, size):
    i, o, s = _items(inputs, outputs, map_in, map_out)
    ctx.work.add_item(i, o, s, name=name or "item")


def add_converge_item(ctx, inputs, outputs, map_in, map_out, name, size,
                      tol, max_iter):
    i, o, s = _items(inputs, outputs, map_in, map_out)
    ctx.work.add_converge_item(i, o, s, name=name or "converge",
                               tol=float(tol), max_iter=int(max_iter))


def compile(ctx):
    ctx.work.compile()


def pre_run(ctx):
    ctx.work.pre_run()


def run(ctx):
    ctx.work.run()


def wait(ctx):
    ctx.work.wait()


def copy_to_device(ctx, node, buf):
    set_variable(ctx, node, buf)


def copy_to_host(ctx, node):
    """Return the node's bytes in the context dtype."""
    if isinstance(node, g.Variable):
        data = node.data
    else:
        data = np.asarray(node.evaluate())
    return np.ascontiguousarray(data.astype(ctx.dtype)).tobytes()


def print_nodes(ctx, index, nodes):
    vals = [np.broadcast_to(np.asarray(n.evaluate()), (max(1, 1),))
            for n in nodes]
    print(" ".join(str(np.asarray(n.evaluate()).ravel()[
        min(index, np.asarray(n.evaluate()).size - 1)]) for n in nodes))
