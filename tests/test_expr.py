"""Tests of the traced-expression compatibility layer (ports of patterns
from graph_tests/node_test.cpp, math_test.cpp, workflow_test.cpp and the
C-binding round-trip)."""

import numpy as np
import pytest

from graph_framework_tpu import expr as g


def test_evaluate_arithmetic():
    a = g.variable(3, 2.0, "a")
    b = g.variable(3, 5.0, "b")
    e = (a + b) * a - b / a
    np.testing.assert_allclose(np.asarray(e.evaluate()),
                               (2 + 5) * 2 - 5 / 2)


def test_df_product_rule():
    x = g.variable(1, 3.0, "x")
    e = x * x * x
    d = e.df(x)
    np.testing.assert_allclose(np.asarray(d.evaluate()), 27.0)  # 3x^2


def test_df_chain_rules():
    x = g.variable(1, 0.7, "x")
    cases = [
        (g.sqrt(x), lambda v: 0.5 / np.sqrt(v)),
        (g.exp(x), np.exp),
        (g.log(x), lambda v: 1 / v),
        (g.sin(x), np.cos),
        (g.cos(x), lambda v: -np.sin(v)),
        (g.pow_(x, g.constant(3.0)), lambda v: 3 * v ** 2),
    ]
    for e, dref in cases:
        np.testing.assert_allclose(np.asarray(e.df(x).evaluate()),
                                   dref(0.7), rtol=1e-12)


def test_df_erfi():
    import scipy.special as sps
    x = g.variable(1, 0.5, "x")
    e = g.erfi(x)
    np.testing.assert_allclose(np.asarray(e.evaluate()), sps.erfi(0.5),
                               rtol=1e-12)
    d = float(np.asarray(e.df(x).evaluate()).ravel()[0])
    np.testing.assert_allclose(d, 2 / np.sqrt(np.pi) * np.exp(0.25),
                               rtol=1e-12)


def test_pseudo_variable_blocks_df():
    """pseudo variables stop the derivative (node.hpp:1745-1860,
    used by RK substages)."""
    x = g.variable(1, 2.0, "x")
    p = g.pseudo_variable(x * x)
    e = p * p
    # d/dx through the pseudo variable is zero...
    np.testing.assert_allclose(np.asarray(e.df(x).evaluate()), 0.0)
    # ...but d/dp is 2p
    np.testing.assert_allclose(np.asarray(e.df(p).evaluate()), 8.0)
    # remove_pseudo restores the full expression
    full = e.remove_pseudo()
    np.testing.assert_allclose(np.asarray(full.df(x).evaluate()),
                               4 * 2.0 ** 3)


def test_atan_conventions():
    x = g.variable(1, 1.0, "x")
    y = g.variable(1, 1.0, "y")
    e = g.atan(x, y)
    np.testing.assert_allclose(np.asarray(e.evaluate()), np.pi / 4)


def test_workflow_setter_loop():
    """a <- a + 1 looped 10 times gives 10 (workflow_test.cpp:36-96)."""
    a = g.variable(4, 0.0, "a")
    w = g.Workflow()
    w.add_loop_item([a], [], [(a + g.one(), a)], loops=10)
    w.compile()
    w.run()
    np.testing.assert_allclose(a.data, 10.0)


def test_workflow_setters_read_pre_update_state():
    """All setters in one item read the same pre-update inputs
    (the kernel reads inputs then writes outputs)."""
    a = g.variable(1, 1.0, "a")
    b = g.variable(1, 10.0, "b")
    w = g.Workflow()
    w.add_item([a, b], [], [(b, a), (a, b)])   # swap
    w.compile()
    w.run()
    assert float(a.data[0]) == 10.0 and float(b.data[0]) == 1.0


def test_workflow_newton_sqrt2():
    """Newton via the workflow converge item: solve x^2 - 2 = 0
    (newton.hpp:34-51 + converge_item loop)."""
    x = g.variable(8, 3.0, "x")
    f = x * x - g.constant(2.0)
    w = g.Workflow()
    g.newton(w, [x], [x], f, tolerance=1e-28)
    w.compile()
    w.run()
    np.testing.assert_allclose(x.data, np.sqrt(2.0), rtol=1e-12)


def test_random_node_changes_per_run():
    r = g.random(16, seed=7)
    a = g.variable(16, 0.0, "a")
    w = g.Workflow()
    w.add_item([a], [], [(g.as_expr(r) + a * g.zero(), a)])
    w.compile()
    w.run()
    first = a.data.copy()
    w.run()
    assert not np.allclose(first, a.data)
    assert (a.data >= 0).all() and (a.data < 1).all()


def test_random_df_zero_and_identity():
    """r + 0 -> r semantics and d(random)/dx = 0 (random_test.cpp:29-80)."""
    r = g.random(4)
    x = g.variable(4, 1.0, "x")
    assert float(np.asarray((g.as_expr(r).df(x)).evaluate())) == 0.0


def test_piecewise_node():
    data = np.arange(8.0)
    x = g.variable(3, 0.0, "x")
    x.set(np.array([0.5, 3.7, 9.0]))
    e = g.piecewise_1D(data, x, 1.0, 0.0)
    np.testing.assert_allclose(np.asarray(e.evaluate()), [0, 3, 7])
    assert float(np.asarray(e.df(x).evaluate())) == 0.0


def test_latex_output():
    x = g.variable(1, 1.0, "x")
    s = (g.sin(x) * x).to_latex()
    assert "sin" in s and "x" in s


def test_hash_consing_dedupes_structural_builds():
    """node.hpp:946-960 constructor cache: building the same expression
    twice yields the same node object; variables/randoms stay distinct."""
    x = g.Variable(4, name="x")
    assert (x + 2.0) is (x + 2.0)
    assert g.Sin(x * x) is g.Sin(x * x)
    assert (x + 2.0) is not (x + 2.5)
    assert (x + 2.0) is not (x - 2.0)
    # random nodes never collapse (each is an independent stream;
    # random_test.cpp graph-identity rules)
    assert g.Random(4) is not g.Random(4)
    # pseudo variables are distinct df barriers
    assert g.PseudoVariable(x + 1.0) is not g.PseudoVariable(x + 1.0)


def test_is_match_structural_equality():
    """leaf_node::is_match: structural equality, with variables matching
    only themselves (node.hpp:364-672)."""
    x = g.Variable(4, name="x")
    y = g.Variable(4, name="y")
    a = (x + 1.0) * g.Cos(y)
    b = (x + 1.0) * g.Cos(y)
    assert a.is_match(b)
    assert not a.is_match((x + 1.0) * g.Sin(y))
    assert not (x + 1.0).is_match(y + 1.0)
    # clones built outside the constructor cache still match structurally
    clone = a._rebuild(a.children())
    assert clone is not a and a.is_match(clone)


def test_random_statistical_quality():
    """Autocorrelation bound on the uniform stream (random_test.cpp:29-80:
    the reference checks lag autocorrelations of its MT kernel stay small;
    same bound applied to the counter-based generator)."""
    r = g.random(20000, seed=11)
    x = np.asarray(r.evaluate())
    assert 0.45 < x.mean() < 0.55
    assert 0.07 < x.var() < 0.10          # uniform: 1/12 ~ 0.0833
    xc = x - x.mean()
    for lag in (1, 2, 5, 10):
        ac = float(np.mean(xc[:-lag] * xc[lag:]) / x.var())
        assert abs(ac) < 0.05, (lag, ac)
