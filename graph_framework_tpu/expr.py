"""Traced-expression compatibility layer (graph building + workflow).

The reference's user-facing embedding API is symbolic graph construction -
``graph::variable/constant/add/.../df`` - plus a ``workflow::manager`` that
compiles setter kernels (reference: graph_c_binding/graph_c_binding.h:177-639,
graph_framework/workflow.hpp).  The physics stack (models/,
solver.py) does not need any of this - JAX traces Python functions directly -
but legacy embedders (the C and Fortran bindings) speak this API, so this
module provides a thin expression tree whose

* ``evaluate()`` runs through jax.numpy (jitted per workflow),
* ``df()`` applies textbook derivative rules producing new expression nodes,
* factory functions (``add/sub/mul/div/fma_/...`` - also reached through
  operator sugar) apply the numerically load-bearing subset of the
  reference's ``reduce()`` rewrite system at construction time (constant
  folding, identity elimination, fma formation, exponent gathering,
  exp/log inverses; arithmetic.hpp:132-3736, math.hpp) so repeated ``df``
  stays compact; the deep kernel-level simplification is XLA's job now,
* ``Workflow`` mirrors manager/work_item/converge_item semantics
  (workflow.hpp:215-425): ordered items, setter maps applied as a batch,
  convergence loops on a max-reduced residual.

This is deliberately NOT used by the performance path; see models/rays.py.
"""

from __future__ import annotations

import itertools
import math
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp


#: hash-consing cache: structural key -> live node (weak, so unreferenced
#: subgraphs are evicted rather than leaking across graph builds).
_INTERN: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class _InternMeta(type):
    """Hash-consing constructor cache (node.hpp:946-960).

    Constructing a structurally identical immutable node returns the cached
    instance, so identical subexpressions share one object (and one emit
    per evaluation) - the reference's thread_local node caches with
    linear-probe collision handling, done with a Python dict.  Classes
    opt in by defining ``_intern_key`` (returning None skips the cache);
    mutable nodes (Variable, Random) and identity-like wrappers
    (PseudoVariable) stay uncached.
    """

    def __call__(cls, *args, **kw):
        keyfn = getattr(cls, "_intern_key", None)
        key = keyfn(*args, **kw) if keyfn is not None else None
        if key is None:
            return super().__call__(*args, **kw)
        key = (cls, *key)
        hit = _INTERN.get(key)
        if hit is None:
            hit = super().__call__(*args, **kw)
            _INTERN[key] = hit
        return hit


class Expr(metaclass=_InternMeta):
    """Base expression node."""

    _ids = itertools.count()

    def __init__(self):
        self.id = next(Expr._ids)

    # -- operator sugar (matches the C API's graph_add/sub/mul/div);
    # routed through the reducing factories so graphs simplify as they
    # are built, like the reference's factory functions (node.hpp
    # constant()/add()/... each call reduce()).
    def __add__(self, o):
        return add(self, o)

    def __radd__(self, o):
        return add(o, self)

    def __sub__(self, o):
        return sub(self, o)

    def __rsub__(self, o):
        return sub(o, self)

    def __mul__(self, o):
        return mul(self, o)

    def __rmul__(self, o):
        return mul(o, self)

    def __truediv__(self, o):
        return div(self, o)

    def __rtruediv__(self, o):
        return div(o, self)

    def __neg__(self):
        return mul(Constant(-1.0), self)

    def __pow__(self, o):
        return pow_(self, o)

    # -- interface ---------------------------------------------------------
    def children(self) -> Tuple["Expr", ...]:
        return ()

    def emit(self, env):
        """Return the jnp value of this node given variable values."""
        raise NotImplementedError

    def df(self, var: "Expr") -> "Expr":
        """Symbolic derivative w.r.t. ``var`` (node.hpp df)."""
        raise NotImplementedError

    def evaluate(self, env=None):
        """Host evaluation (leaf_node::evaluate)."""
        return _eval(self, env or {})

    # latex / visualization (node.hpp to_latex/to_vizgraph)
    def to_latex(self) -> str:
        raise NotImplementedError

    def _match_payload(self):
        """Structural payload for is_match; None = identity-only node
        (Variable, PseudoVariable, Random - the reference's variable-like
        nodes match only themselves)."""
        return ()

    def is_match(self, other: "Expr") -> bool:
        """Structural equality (node.hpp is_match).  With the constructor
        cache (hash-consing) structurally identical graphs are usually the
        same object, so this is an O(1) identity hit in practice; the
        recursive compare covers nodes built outside the cache
        (_rebuild clones, uncacheable payloads)."""
        if self is other:
            return True
        if type(self) is not type(other):
            return False
        pa, pb = self._match_payload(), other._match_payload()
        if pa is None or pb is None or pa != pb:
            return False
        ca, cb = self.children(), other.children()
        return len(ca) == len(cb) and all(
            x.is_match(y) for x, y in zip(ca, cb))

    def remove_pseudo(self) -> "Expr":
        """Strip pseudo-variable wrappers (node.hpp remove_pseudo)."""
        subs = tuple(c.remove_pseudo() for c in self.children())
        if subs == self.children():
            return self
        return self._rebuild(subs)

    def reduce(self) -> "Expr":
        """Bottom-up algebraic simplification (leaf_node::reduce).

        Graphs built through the factories/operators are already reduced
        as constructed; this re-runs the rules over a whole tree (useful
        after ``remove_pseudo`` or for hand-assembled nodes)."""
        ch = tuple(c.reduce() for c in self.children())
        fac = _REDUCE_FACTORIES.get(type(self))
        if fac is not None:
            return fac(*ch)
        if ch == self.children():
            return self
        return self._rebuild(ch)

    def _rebuild(self, children):
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.id = next(Expr._ids)
        clone._set_children(children)
        return clone

    def _set_children(self, children):
        raise NotImplementedError


def as_expr(v):
    return v if isinstance(v, Expr) else Constant(v)


def _eval(root: Expr, env: Dict["Variable", np.ndarray]):
    vals = {}

    def rec(e):
        if e.id not in vals:
            vals[e.id] = e.emit_cached(rec, env)
        return vals[e.id]

    return rec(root)


def walk(root: Expr):
    """Yield every node in the tree once."""
    seen = set()
    stack = [root]
    while stack:
        e = stack.pop()
        if e.id in seen:
            continue
        seen.add(e.id)
        yield e
        stack.extend(e.children())


class Constant(Expr):
    def __init__(self, value):
        super().__init__()
        self.value = value

    @staticmethod
    def _intern_key(value):
        if isinstance(value, (bool, int, float, complex,
                              np.integer, np.floating, np.complexfloating)):
            return (type(value), value)
        return None           # array-valued constants: not interned

    def _match_payload(self):
        if isinstance(self.value, np.ndarray):
            return (self.value.tobytes(), self.value.shape)
        return (self.value,)

    def emit_cached(self, rec, env):
        return jnp.asarray(self.value)

    def df(self, var):
        return Constant(0.0)

    def is_(self, v):
        return (not isinstance(self.value, np.ndarray)
                and complex(self.value) == v)

    def to_latex(self):
        return f"{self.value}"


class Variable(Expr):
    """Named mutable buffer (node.hpp variable_node)."""

    def __init__(self, size: int, value=0.0, name: str = "v"):
        super().__init__()
        self.size = size
        self.name = name
        self.data = np.full(size, value) if np.ndim(value) == 0 \
            else np.asarray(value)
        assert np.isfinite(self.data).all(), \
            "NaN or inf in variable buffer (node.hpp:1426)"

    def _match_payload(self):
        return None           # a variable matches only itself

    def set(self, value):
        self.data = (np.full(self.size, value)
                     if np.ndim(value) == 0 else np.asarray(value))

    def emit_cached(self, rec, env):
        if self in env:
            return jnp.asarray(env[self])
        return jnp.asarray(self.data)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return self.name


class PseudoVariable(Expr):
    """Wrap a subexpression so df treats it as independent
    (node.hpp:1745-1860)."""

    def __init__(self, inner: Expr):
        super().__init__()
        self.inner = inner

    def _match_payload(self):
        return None           # pseudo variables are distinct variables

    def children(self):
        return (self.inner,)

    def _set_children(self, c):
        (self.inner,) = c

    def emit_cached(self, rec, env):
        return rec(self.inner)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def remove_pseudo(self):
        return self.inner.remove_pseudo()

    def to_latex(self):
        return self.inner.to_latex()


class _Binary(Expr):
    sym = "?"

    def __init__(self, a: Expr, b: Expr):
        super().__init__()
        self.a, self.b = a, b

    @staticmethod
    def _intern_key(a, b):
        if isinstance(a, Expr) and isinstance(b, Expr):
            return (id(a), id(b))
        return None

    def children(self):
        return (self.a, self.b)

    def _set_children(self, c):
        self.a, self.b = c

    def to_latex(self):
        return f"\\left({self.a.to_latex()}{self.sym}{self.b.to_latex()}\\right)"


class Add(_Binary):
    sym = "+"

    def emit_cached(self, rec, env):
        return rec(self.a) + rec(self.b)

    def df(self, var):
        return self.a.df(var) + self.b.df(var)


class Sub(_Binary):
    sym = "-"

    def emit_cached(self, rec, env):
        return rec(self.a) - rec(self.b)

    def df(self, var):
        return self.a.df(var) - self.b.df(var)


class Mul(_Binary):
    sym = " "

    def emit_cached(self, rec, env):
        return rec(self.a) * rec(self.b)

    def df(self, var):
        return self.a.df(var) * self.b + self.a * self.b.df(var)


class Div(_Binary):
    sym = "/"

    def emit_cached(self, rec, env):
        return rec(self.a) / rec(self.b)

    def df(self, var):
        return (self.a.df(var) * self.b - self.a * self.b.df(var)) \
            / (self.b * self.b)


class Fma(Expr):
    """fma(a, b, c) = a*b + c (arithmetic.hpp fma_node)."""

    @staticmethod
    def _intern_key(a, b, c):
        if all(isinstance(v, Expr) for v in (a, b, c)):
            return (id(a), id(b), id(c))
        return None

    def __init__(self, a, b, c):
        super().__init__()
        self.a, self.b, self.c = as_expr(a), as_expr(b), as_expr(c)

    def children(self):
        return (self.a, self.b, self.c)

    def _set_children(self, ch):
        self.a, self.b, self.c = ch

    def emit_cached(self, rec, env):
        return rec(self.a) * rec(self.b) + rec(self.c)

    def df(self, var):
        return fma_(self.a.df(var), self.b,
                    fma_(self.a, self.b.df(var), self.c.df(var)))

    def to_latex(self):
        return (f"\\left({self.a.to_latex()} {self.b.to_latex()}"
                f"+{self.c.to_latex()}\\right)")


class _Unary(Expr):
    fn = None
    name = "?"

    @staticmethod
    def _intern_key(a):
        return (id(a),) if isinstance(a, Expr) else None

    def __init__(self, a: Expr):
        super().__init__()
        self.a = as_expr(a)

    def children(self):
        return (self.a,)

    def _set_children(self, c):
        (self.a,) = c

    def emit_cached(self, rec, env):
        return type(self).fn(rec(self.a))

    def to_latex(self):
        return f"\\{self.name}\\left({self.a.to_latex()}\\right)"


class Sqrt(_Unary):
    fn = jnp.sqrt
    name = "sqrt"

    def df(self, var):
        return self.a.df(var) / (Constant(2.0) * Sqrt(self.a))


class Exp(_Unary):
    fn = jnp.exp
    name = "exp"

    def df(self, var):
        return self.a.df(var) * Exp(self.a)


class Log(_Unary):
    fn = jnp.log
    name = "ln"

    def df(self, var):
        return self.a.df(var) / self.a


class Sin(_Unary):
    fn = jnp.sin
    name = "sin"

    def df(self, var):
        return self.a.df(var) * Cos(self.a)


class Cos(_Unary):
    fn = jnp.cos
    name = "cos"

    def df(self, var):
        return Constant(-1.0) * self.a.df(var) * Sin(self.a)


class Erfi(_Unary):
    name = "erfi"

    @staticmethod
    def fn(x):
        from graph_framework_tpu.ops.special import erfi as _erfi
        return _erfi(x)

    def df(self, var):
        # d erfi/dz = 2/sqrt(pi) exp(z^2) (math.hpp erfi_node df)
        return (Constant(2.0 / math.sqrt(math.pi))
                * Exp(self.a * self.a) * self.a.df(var))


class Pow(_Binary):
    sym = "^"

    def emit_cached(self, rec, env):
        return rec(self.a) ** rec(self.b)

    def df(self, var):
        # general rule a^b (b constant in practice; math.hpp pow_node)
        if isinstance(self.b, Constant):
            return (self.b * pow_(self.a, Constant(self.b.value - 1))
                    * self.a.df(var))
        return pow_(self.a, self.b) * (
            self.b.df(var) * log(self.a) + self.b * self.a.df(var) / self.a)


class Atan(_Binary):
    """atan(x, y) = atan2(y, x) for real; atan(y/x) for complex
    (trigonometry.hpp arctan, backend.hpp:1130-1150)."""
    sym = ","

    def emit_cached(self, rec, env):
        x, y = rec(self.a), rec(self.b)
        if jnp.iscomplexobj(x) or jnp.iscomplexobj(y):
            return jnp.arctan(y / x)
        return jnp.arctan2(y, x)

    def df(self, var):
        x, y = self.a, self.b
        return (x * y.df(var) - y * x.df(var)) / (x * x + y * y)


class Random(Expr):
    """Uniform random node (random.hpp random_node): a fresh sample per
    evaluation per element.  Carries its own counter-based state; kernels
    use jax.random instead of the reference's Mersenne-twister device
    code."""

    def __init__(self, size: int, seed: int = 0):
        super().__init__()
        self.size = size
        self.key = jax.random.PRNGKey(seed)

    def _match_payload(self):
        return None           # every random node is an independent stream

    def emit_cached(self, rec, env):
        # workflows feed a fresh key through env per kernel invocation
        # (the reference advances per-thread MT state on device,
        # random.hpp:314-340); direct evaluate() advances the node's key.
        if self in env:
            return jax.random.uniform(env[self], (self.size,))
        self.key, sub = jax.random.split(self.key)
        return jax.random.uniform(sub, (self.size,))

    def df(self, var):
        return Constant(0.0)

    def to_latex(self):
        return "\\mathrm{rand}"


class Piecewise1D(Expr):
    """piecewise_1D table lookup (piecewise.hpp:105-...)."""

    @staticmethod
    def _intern_key(data, arg, scale, offset):
        # hash the table data like the reference does (piecewise.hpp:140-189)
        if isinstance(arg, Expr) and np.isscalar(scale) and np.isscalar(offset):
            d = np.asarray(data)
            return (hash(d.tobytes()), d.shape, id(arg), scale, offset)
        return None

    def _match_payload(self):
        return (self.data.tobytes(), self.scale, self.offset)

    def __init__(self, data, arg: Expr, scale, offset):
        super().__init__()
        self.data = np.asarray(data)
        self.arg = as_expr(arg)
        self.scale, self.offset = scale, offset

    def children(self):
        return (self.arg,)

    def _set_children(self, c):
        (self.arg,) = c

    def emit_cached(self, rec, env):
        from graph_framework_tpu.ops.tables import piecewise_1d
        return piecewise_1d(jnp.asarray(self.data), rec(self.arg),
                            self.scale, self.offset)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return "\\mathrm{table}\\left(%s\\right)" % self.arg.to_latex()


class Piecewise2D(Expr):
    """piecewise_2D table lookup (piecewise.hpp:686-...)."""

    @staticmethod
    def _intern_key(data, num_cols, x, x_scale, x_offset,
                    y, y_scale, y_offset):
        if isinstance(x, Expr) and isinstance(y, Expr):
            d = np.asarray(data)
            return (hash(d.tobytes()), d.shape, int(num_cols), id(x),
                    x_scale, x_offset, id(y), y_scale, y_offset)
        return None

    def _match_payload(self):
        return (self.data.tobytes(), self.x_scale, self.x_offset,
                self.y_scale, self.y_offset)

    def __init__(self, data, num_cols, x, x_scale, x_offset,
                 y, y_scale, y_offset):
        super().__init__()
        self.data = np.asarray(data).reshape(-1, num_cols)
        self.x, self.y = as_expr(x), as_expr(y)
        self.x_scale, self.x_offset = x_scale, x_offset
        self.y_scale, self.y_offset = y_scale, y_offset

    def children(self):
        return (self.x, self.y)

    def _set_children(self, c):
        self.x, self.y = c

    def emit_cached(self, rec, env):
        from graph_framework_tpu.ops.tables import piecewise_2d
        return piecewise_2d(jnp.asarray(self.data), rec(self.x),
                            self.x_scale, self.x_offset, rec(self.y),
                            self.y_scale, self.y_offset)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return "\\mathrm{table2d}\\left(%s,%s\\right)" % (
            self.x.to_latex(), self.y.to_latex())


class Index1D(Expr):
    """index_1D gather from a mutable variable (piecewise.hpp:1448-1755):
    the PIC field gather - identical arithmetic to Piecewise1D but the
    source is a workflow variable updated between runs."""

    @staticmethod
    def _intern_key(var, arg, scale, offset):
        if isinstance(var, Variable) and isinstance(arg, Expr):
            return (id(var), id(arg), scale, offset)
        return None

    def _match_payload(self):
        return (self.scale, self.offset)

    def __init__(self, var: "Variable", arg: Expr, scale, offset):
        super().__init__()
        self.var = var
        self.arg = as_expr(arg)
        self.scale, self.offset = scale, offset

    def children(self):
        return (self.var, self.arg)

    def _set_children(self, c):
        self.var, self.arg = c

    def emit_cached(self, rec, env):
        from graph_framework_tpu.ops.tables import index_1d
        return index_1d(rec(self.var), rec(self.arg),
                        self.scale, self.offset)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return "%s\\left[%s\\right]" % (self.var.to_latex(),
                                        self.arg.to_latex())


class Index2D(Expr):
    """index_2D gather from a mutable variable over a 2D grid
    (the 2D analogue of Index1D; reference graph_c_binding.h index_2D)."""

    @staticmethod
    def _intern_key(var, num_cols, x, x_scale, x_offset,
                    y, y_scale, y_offset):
        if isinstance(var, Variable) and isinstance(x, Expr) \
                and isinstance(y, Expr):
            return (id(var), int(num_cols), id(x), x_scale, x_offset,
                    id(y), y_scale, y_offset)
        return None

    def _match_payload(self):
        return (self.num_cols, self.x_scale, self.x_offset,
                self.y_scale, self.y_offset)

    def __init__(self, var: "Variable", num_cols, x, x_scale, x_offset,
                 y, y_scale, y_offset):
        super().__init__()
        self.var = var
        self.num_cols = int(num_cols)
        self.x, self.y = as_expr(x), as_expr(y)
        self.x_scale, self.x_offset = x_scale, x_offset
        self.y_scale, self.y_offset = y_scale, y_offset

    def children(self):
        return (self.var, self.x, self.y)

    def _set_children(self, c):
        self.var, self.x, self.y = c

    def emit_cached(self, rec, env):
        from graph_framework_tpu.ops.tables import piecewise_2d
        data = rec(self.var).reshape(-1, self.num_cols)
        return piecewise_2d(data, rec(self.x), self.x_scale, self.x_offset,
                            rec(self.y), self.y_scale, self.y_offset)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return "%s\\left[%s,%s\\right]" % (
            self.var.to_latex(), self.x.to_latex(), self.y.to_latex())


def to_vizgraph(root: Expr) -> str:
    """GraphViz DAG dump (node.hpp make_vizgraph, :700-717)."""
    lines = ["digraph G {"]
    for e in walk(root):
        label = type(e).__name__
        if isinstance(e, Variable):
            label = f"var {e.name}"
        elif isinstance(e, Constant):
            label = f"{e.value}"
        lines.append(f'  n{e.id} [label="{label}"];')
        for c in e.children():
            lines.append(f"  n{e.id} -> n{c.id};")
    lines.append("}")
    return "\n".join(lines)


# factory helpers mirroring the graph:: namespace
def variable(size, value=0.0, name="v"):
    return Variable(size, value, name)


def constant(v):
    return Constant(v)


def pseudo_variable(e):
    return PseudoVariable(e)


def one():
    return Constant(1.0)


def zero():
    return Constant(0.0)


# ---------------------------------------------------------------------------
# reducing factories: the numerically load-bearing subset of the
# reference's reduce() rewrite system (arithmetic.hpp:132-3736,
# math.hpp:26-1439), applied at construction time like the reference's
# graph:: factory functions.  Rules involving structural identity
# (a+a -> 2a, a-a -> 0, a*a -> a^2, a/a -> 1) are guarded against random
# subtrees: two uses of a random stream are NOT the same value
# (random_test.cpp graph-identity rules), while identity elimination
# (r+0 -> r, r*1 -> r) is always safe.
# ---------------------------------------------------------------------------

def _has_random(e: Expr) -> bool:
    flag = getattr(e, "_rand_flag", None)
    if flag is None:
        flag = isinstance(e, Random) or any(
            _has_random(c) for c in e.children())
        e._rand_flag = flag
    return flag


def _same(a: Expr, b: Expr) -> bool:
    return (a is b or a.is_match(b)) and not _has_random(a)


def _c(e):
    """Constant payload or None."""
    return e.value if isinstance(e, Constant) else None


def _fold_tables(op, a, b):
    """Piecewise-table folding (the is_constant_combinable branch of the
    reference's arithmetic reduce, arithmetic.hpp:24-61, 192-248):
    ``scalar-constant OP table`` folds into ONE new table, and
    ``table OP table`` with matching argument/scale/offset likewise -
    the kernel then carries a single gather where the source had two
    nodes.  Returns the folded Expr or None."""
    va, vb = _c(a), _c(b)
    with np.errstate(all="ignore"):
        if isinstance(a, Piecewise1D):
            if vb is not None:
                return piecewise_1D(op(a.data, vb), a.arg,
                                    a.scale, a.offset)
            if (isinstance(b, Piecewise1D) and _same(a.arg, b.arg)
                    and a.scale == b.scale and a.offset == b.offset
                    and a.data.shape == b.data.shape):
                return piecewise_1D(op(a.data, b.data), a.arg,
                                    a.scale, a.offset)
        if isinstance(b, Piecewise1D) and va is not None:
            return piecewise_1D(op(va, b.data), b.arg, b.scale, b.offset)
        if isinstance(a, Piecewise2D):
            if vb is not None:
                return piecewise_2D(op(a.data, vb), a.data.shape[1],
                                    a.x, a.x_scale, a.x_offset,
                                    a.y, a.y_scale, a.y_offset)
            if (isinstance(b, Piecewise2D) and _same(a.x, b.x)
                    and _same(a.y, b.y)
                    and (a.x_scale, a.x_offset, a.y_scale, a.y_offset)
                    == (b.x_scale, b.x_offset, b.y_scale, b.y_offset)
                    and a.data.shape == b.data.shape):
                return piecewise_2D(op(a.data, b.data), a.data.shape[1],
                                    a.x, a.x_scale, a.x_offset,
                                    a.y, a.y_scale, a.y_offset)
        if isinstance(b, Piecewise2D) and va is not None:
            return piecewise_2D(op(va, b.data), b.data.shape[1],
                                b.x, b.x_scale, b.x_offset,
                                b.y, b.y_scale, b.y_offset)
    return None


def add(a, b) -> Expr:
    """a + b with reductions (add_node::reduce, arithmetic.hpp:132-870)."""
    a, b = as_expr(a), as_expr(b)
    va, vb = _c(a), _c(b)
    if va is not None and vb is not None:
        return Constant(va + vb)
    if va is not None and a.is_(0):
        return b
    if vb is not None and b.is_(0):
        return a
    folded = _fold_tables(np.add, a, b)
    if folded is not None:
        return folded
    if _same(a, b):
        return mul(Constant(2.0), a)
    # fma formation: a*b + c -> fma(a, b, c) (arithmetic.hpp:271-277)
    if isinstance(a, Mul):
        return Fma(a.a, a.b, b)
    if isinstance(b, Mul):
        return Fma(b.a, b.b, a)
    return Add(a, b)


def sub(a, b) -> Expr:
    """a - b with reductions (subtract_node::reduce,
    arithmetic.hpp:879-1710)."""
    a, b = as_expr(a), as_expr(b)
    va, vb = _c(a), _c(b)
    if va is not None and vb is not None:
        return Constant(va - vb)
    if vb is not None and b.is_(0):
        return a
    if va is not None and a.is_(0):
        return mul(Constant(-1.0), b)
    folded = _fold_tables(np.subtract, a, b)
    if folded is not None:
        return folded
    if _same(a, b):
        return Constant(0.0)
    return Sub(a, b)


def mul(a, b) -> Expr:
    """a * b with reductions (multiply_node::reduce,
    arithmetic.hpp:1720-2760): folding, identities, constant-left
    normalization, exponent gathering."""
    a, b = as_expr(a), as_expr(b)
    va, vb = _c(a), _c(b)
    if va is not None and vb is not None:
        return Constant(va * vb)
    if (va is not None and a.is_(0)) or (vb is not None and b.is_(0)):
        return Constant(0.0)
    if va is not None and a.is_(1):
        return b
    if vb is not None and b.is_(1):
        return a
    if vb is not None and va is None:            # constants move left
        a, b = b, a
        va, vb = vb, va
    if va is not None and isinstance(b, Mul) and isinstance(b.a, Constant):
        return mul(Constant(va * b.a.value), b.b)
    folded = _fold_tables(np.multiply, a, b)
    if folded is not None:
        return folded
    # exponent gathering: x*x -> x^2, x * x^c -> x^(c+1), x^c1 * x^c2
    if _same(a, b):
        return Pow(a, Constant(2.0))
    if (isinstance(b, Pow) and isinstance(b.b, Constant)
            and _same(a, b.a)):
        return pow_(a, Constant(b.b.value + 1))
    if (isinstance(a, Pow) and isinstance(a.b, Constant)
            and _same(a.a, b)):
        return pow_(b, Constant(a.b.value + 1))
    if (isinstance(a, Pow) and isinstance(b, Pow)
            and isinstance(a.b, Constant) and isinstance(b.b, Constant)
            and _same(a.a, b.a)):
        return pow_(a.a, Constant(a.b.value + b.b.value))
    return Mul(a, b)


def div(a, b) -> Expr:
    """a / b with reductions (divide_node::reduce,
    arithmetic.hpp:2769-3730)."""
    a, b = as_expr(a), as_expr(b)
    va, vb = _c(a), _c(b)
    if va is not None and vb is not None and np.all(np.asarray(vb) != 0):
        return Constant(va / vb)
    if va is not None and a.is_(0):
        return Constant(0.0)
    if vb is not None and b.is_(1):
        return a
    folded = _fold_tables(np.divide, a, b)
    if folded is not None:
        return folded
    if _same(a, b):
        return Constant(1.0)
    return Div(a, b)


def fma_(a, b, c) -> Expr:
    """fma(a, b, c) = a*b + c with reductions (fma_node::reduce,
    arithmetic.hpp:3736+)."""
    a, b, c = as_expr(a), as_expr(b), as_expr(c)
    va, vb, vc = _c(a), _c(b), _c(c)
    if va is not None and vb is not None:
        return add(Constant(va * vb), c)
    if (va is not None and a.is_(0)) or (vb is not None and b.is_(0)):
        return c
    if va is not None and a.is_(1):
        return add(b, c)
    if vb is not None and b.is_(1):
        return add(a, c)
    if vc is not None and c.is_(0):
        return mul(a, b)
    return Fma(a, b, c)


def pow_(a, b) -> Expr:
    """a ** b with reductions (pow_node::reduce, math.hpp:844-1439):
    x^0 -> 1, x^1 -> x, constant folding, sqrt(x)^2 -> x, (x^a)^b."""
    a, b = as_expr(a), as_expr(b)
    vb = _c(b)
    if vb is not None:
        if b.is_(0):
            return Constant(1.0)
        if b.is_(1):
            return a
        va = _c(a)
        if va is not None:
            return Constant(va ** vb)
        if isinstance(a, Sqrt) and b.is_(2):
            return a.a
        if isinstance(a, Pow) and isinstance(a.b, Constant):
            return pow_(a.a, Constant(a.b.value * vb))
    return Pow(a, b)


def sqrt(a) -> Expr:
    """sqrt with reductions (sqrt_node::reduce, math.hpp:26-330):
    constant folding, sqrt(x^2) -> x (the reference's sqrt(x*x) rule -
    x*x gathers to x^2 in mul)."""
    a = as_expr(a)
    va = _c(a)
    if va is not None:
        return Constant(np.sqrt(va))
    if isinstance(a, Pow) and isinstance(a.b, Constant) and a.b.is_(2):
        return a.a
    return Sqrt(a)


def exp(a) -> Expr:
    """exp with reductions (exp_node::reduce, math.hpp:337-595):
    constant folding, exp(log(x)) -> x."""
    a = as_expr(a)
    va = _c(a)
    if va is not None:
        return Constant(np.exp(va))
    if isinstance(a, Log):
        return a.a
    return Exp(a)


def log(a) -> Expr:
    """log with reductions (log_node::reduce, math.hpp:602-840):
    constant folding, log(exp(x)) -> x."""
    a = as_expr(a)
    va = _c(a)
    if va is not None:
        return Constant(np.log(va))
    if isinstance(a, Exp):
        return a.a
    return Log(a)


def tan(a) -> Expr:
    """tan(x) = sin(x)/cos(x) - a composite, exactly as the reference
    builds it (trigonometry.hpp:539: `return sin(x)/cos(x)`)."""
    a = as_expr(a)
    return div(Sin(a), Cos(a))


def piecewise_1D(data, arg, scale, offset) -> Expr:
    """piecewise_1D with reductions (piecewise_1D_node::reduce,
    piecewise.hpp:~200-240): a CONSTANT argument collapses to the gathered
    constant, and an all-equal table is a constant regardless of the
    argument.  Index convention: clamp(trunc((x - offset)/scale)) - the
    convention the reference's generated kernels use (compile_index,
    piecewise.hpp:26-60; its host-side reduce uses `(x + offset)/scale`,
    :880-899 - a sign inconsistency with its own kernels, reachable only
    through constant args, which we do not replicate)."""
    data = np.asarray(data)
    arg = as_expr(arg)
    va = _c(arg)
    if va is not None:
        i = int(np.clip(np.real(va - offset) / scale, 0,
                        data.shape[0] - 1))
        return Constant(data[i])
    if data.size and np.all(data == data.flat[0]):
        return Constant(data.flat[0])
    return Piecewise1D(data, arg, scale, offset)


def piecewise_2D(data, num_cols, x, x_scale, x_offset,
                 y, y_scale, y_offset) -> Expr:
    """piecewise_2D with reductions (piecewise_2D_node::reduce,
    piecewise.hpp:856-940): both args constant -> the gathered constant;
    one arg constant -> a piecewise_1D over the extracted row/column;
    all-equal table -> constant.  Same kernel-consistent index convention
    as :func:`piecewise_1D`."""
    data = np.asarray(data).reshape(-1, int(num_cols))
    x, y = as_expr(x), as_expr(y)
    vx, vy = _c(x), _c(y)
    nr, nc = data.shape
    if vx is not None and vy is not None:
        i = int(np.clip(np.real(vx - x_offset) / x_scale, 0, nr - 1))
        j = int(np.clip(np.real(vy - y_offset) / y_scale, 0, nc - 1))
        return Constant(data[i, j])
    if vx is not None:          # row extraction (piecewise.hpp:901-916)
        i = int(np.clip(np.real(vx - x_offset) / x_scale, 0, nr - 1))
        return piecewise_1D(data[i, :], y, y_scale, y_offset)
    if vy is not None:          # column extraction (piecewise.hpp:917-933)
        j = int(np.clip(np.real(vy - y_offset) / y_scale, 0, nc - 1))
        return piecewise_1D(data[:, j], x, x_scale, x_offset)
    if data.size and np.all(data == data.flat[0]):
        return Constant(data.flat[0])
    return Piecewise2D(data, nc, x, x_scale, x_offset,
                       y, y_scale, y_offset)


#: node-type -> reducing factory, for Expr.reduce()
_REDUCE_FACTORIES = {
    Add: add, Sub: sub, Mul: mul, Div: div, Fma: fma_, Pow: pow_,
    Sqrt: sqrt, Exp: exp, Log: log,
}

fma = fma_
sin, cos, atan = Sin, Cos, Atan
erfi = Erfi
random = Random
index_1D = Index1D
index_2D = Index2D


# ---------------------------------------------------------------------------
# workflow manager (workflow.hpp:215-425)
# ---------------------------------------------------------------------------

class _Item:
    def __init__(self, inputs, outputs, setters, name, kind="item",
                 tol=1e-30, max_iter=1000, loops=1):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.setters = list(setters)   # [(expr, target_variable)]
        self.name = name
        self.kind = kind
        self.tol = tol
        self.max_iter = max_iter
        self.loops = loops
        self._fn = None

    def compile(self):
        exprs = [e for e, _ in self.setters] + self.outputs
        in_vars = list(self.inputs)
        # random nodes get a fresh key per invocation (random.hpp device MT)
        rand_nodes = sorted(
            {r.id: r for e in exprs for r in walk(e)
             if isinstance(r, Random)}.values(), key=lambda r: r.id)

        def kernel(in_vals, keys):
            env = dict(zip(in_vars, in_vals))
            env.update(zip(rand_nodes, keys))
            vals = {}

            def rec(e):
                if e.id not in vals:
                    vals[e.id] = e.emit_cached(rec, env)
                return vals[e.id]

            return [rec(e) for e in exprs]

        jitted = jax.jit(kernel)
        self._key = jax.random.PRNGKey(1234 + len(self.setters))

        def run_once():
            in_vals = [jnp.asarray(v.data) for v in in_vars]
            if rand_nodes:
                self._key, *keys = jax.random.split(
                    self._key, len(rand_nodes) + 1)
            else:
                keys = []
            results = jitted(in_vals, keys)
            # all setters read pre-update state; write as a batch
            # (work_item setter-map semantics, workflow.hpp:21-80)
            for (expr, tgt), val in zip(self.setters, results):
                tgt.data = np.broadcast_to(
                    np.asarray(val), (tgt.size,)).copy()
            return results[len(self.setters):]

        self._fn = run_once

    def run(self):
        if self.kind == "item":
            for _ in range(self.loops):
                out = self._fn()
            return out
        # converge item (workflow.hpp:179-205)
        it = 0
        last = off_last = float("inf")
        out = self._fn()
        res = float(np.max(np.abs(np.asarray(out[-1]))))
        while (abs(res) > self.tol and abs(last - res) > self.tol
               and abs(off_last - res) > self.tol and it < self.max_iter):
            last = res
            if it % 2 == 0:
                off_last = res
            out = self._fn()
            res = float(np.max(np.abs(np.asarray(out[-1]))))
            it += 1
        return out


class Workflow:
    """Ordered pre-items + items (workflow::manager)."""

    def __init__(self, index: int = 0):
        self.index = index
        self.pre_items: List[_Item] = []
        self.items: List[_Item] = []

    def add_preitem(self, inputs, outputs, setters, name="pre", **kw):
        self.pre_items.append(_Item(inputs, outputs, setters, name, **kw))

    def add_item(self, inputs, outputs, setters, name="item", **kw):
        self.items.append(_Item(inputs, outputs, setters, name, **kw))

    def add_loop_item(self, inputs, outputs, setters, name="loop",
                      loops=1, **kw):
        self.items.append(_Item(inputs, outputs, setters, name,
                                loops=loops, **kw))

    def add_converge_item(self, inputs, outputs, setters, name="converge",
                          tol=1e-30, max_iter=1000):
        self.items.append(_Item(inputs, outputs, setters, name,
                                kind="converge", tol=tol,
                                max_iter=max_iter))

    def compile(self):
        for item in self.pre_items + self.items:
            item.compile()

    def pre_run(self):
        for item in self.pre_items:
            item.run()

    def run(self):
        out = None
        for item in self.items:
            out = item.run()
        return out

    def wait(self):
        pass   # host-synchronous by construction

    def copy_to_host(self, var: Variable):
        return var.data

    def copy_to_device(self, var: Variable, data):
        var.set(np.asarray(data))

    def check_value(self, index: int, expr: Expr):
        return np.asarray(expr.evaluate())[index]


def newton(work: Workflow, vars: Sequence[Variable], inputs, func: Expr,
           tolerance=1e-30, max_iterations=1000, step=1.0):
    """solver::newton (newton.hpp:34-51): register setters
    x <- x - step*f/f'(x) and a converge item on f*f."""
    setters = [(v - Constant(step) * func / func.df(v), v) for v in vars]
    work.add_converge_item(inputs, [func * func], setters,
                           name="loss_kernel", tol=tolerance,
                           max_iter=max_iterations)
