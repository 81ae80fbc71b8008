"""The port's arithmetic against the JAX package's, and against Java's
integer semantics.

Inputs are numpy-seeded LONG, INT and DOUBLE columns with NULLs, zero
divisors and every sign pairing of dividend and divisor (-7 / 2,
7 / -2, -7 / -2 ...), and doubles with NaN, infinities and -0.0.  The
results must be equal exactly (NaN equal to NaN, the sign of a zero
included): div, %, pmod, unary minus and plus, abs, least and
greatest.  Java's own answers pin the sign rules, MIN_VALUE / -1
included (the JAX function is not asked there: numpy's floor division
of MIN_VALUE by -1 overflows).
"""

import math
import types

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.exprs import arithmetic as JA
from spark_rapids_tpu.exprs import base as JB

from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as B
from torch_jax_eval import jax_eval, port_eval

JAX = types.SimpleNamespace(A=JA, col=JB.ColumnReference, lit=JB.Literal.of)
PORT = types.SimpleNamespace(A=A, col=B.col, lit=B.Literal.of)
SIGNS = [(-7, 2), (7, -2), (-7, -2), (7, 2), (-6, 3), (6, -3), (0, -5),
         (5, 0), (-5, 0), (1, 1), (-1, 1), (-9, 4), (9, -4)]
DOUBLES = [-7.5, 7.5, 2.0, -2.0, 0.0, -0.0, float("nan"), float("inf"),
           float("-inf"), 3.25, -1e300, 1e-300]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(17)
    n = 240
    fixed = len(SIGNS)
    a = np.concatenate([[x for x, _ in SIGNS],
                        rng.integers(-1000, 1000, n - fixed)])
    b = np.concatenate([[y for _, y in SIGNS],
                        rng.integers(-12, 12, n - fixed)])
    d = np.array(DOUBLES)[rng.integers(0, len(DOUBLES), n)]
    e = np.array(DOUBLES)[rng.integers(0, len(DOUBLES), n)]
    return pa.table({
        "a": pa.array(a, pa.int64(), mask=rng.random(n) < 0.08),
        "b": pa.array(b, pa.int64(), mask=rng.random(n) < 0.08),
        "i": pa.array(b.astype(np.int32), pa.int32()),
        "d": pa.array(d, mask=rng.random(n) < 0.08),
        "e": pa.array(e),
    })


def _cases(ns):
    A_, c, lit = ns.A, ns.col, ns.lit
    a, b, i, d, e = (c(n) for n in "abide")
    return {
        "integral_divide": [A_.IntegralDivide(a, b), A_.IntegralDivide(a, i),
                            A_.IntegralDivide(i, lit(3))],
        "remainder": [A_.Remainder(a, b), A_.Remainder(a, i),
                      A_.Remainder(i, b), A_.Remainder(d, e),
                      A_.Remainder(d, lit(2.0)), A_.Remainder(a, d)],
        "pmod": [A_.Pmod(a, b), A_.Pmod(i, lit(-3)), A_.Pmod(d, e),
                 A_.Pmod(a, lit(0))],
        "unary": [A_.UnaryMinus(a), A_.UnaryMinus(d), A_.UnaryMinus(i),
                  A_.UnaryPositive(a), A_.Abs(a), A_.Abs(d), A_.Abs(i)],
        "least_greatest": [A_.Least(a, b), A_.Greatest(a, b),
                           A_.Least(d, e), A_.Greatest(d, e),
                           A_.Least(a, i, lit(0)), A_.Greatest(i, d),
                           A_.Least(lit(None), b)],
    }


def _bits(v):
    if isinstance(v, float):
        return ("nan",) if math.isnan(v) else (v, math.copysign(1.0, v))
    return v


@pytest.mark.parametrize("case", list(_cases(PORT)))
def test_port_equals_the_jax_functions(case, table):
    got = port_eval(table, _cases(PORT)[case])
    want = jax_eval(table, _cases(JAX)[case])
    assert got.schema.types == want.schema.types
    for k in range(got.num_columns):
        g = [_bits(v) for v in got.column(k).to_pylist()]
        w = [_bits(v) for v in want.column(k).to_pylist()]
        assert g == w, (case, k)


def _java(a: int, b: int):
    """Java's a / b and a % b on longs."""
    q = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
    return q, a - q * b


def test_signs_follow_java():
    tbl = pa.table({"a": pa.array([x for x, _ in SIGNS], pa.int64()),
                    "b": pa.array([y for _, y in SIGNS], pa.int64())})
    got = port_eval(tbl, [A.IntegralDivide(B.col("a"), B.col("b")),
                          A.Remainder(B.col("a"), B.col("b")),
                          A.Pmod(B.col("a"), B.col("b"))])
    for (x, y), q, r, p in zip(SIGNS, *(got.column(k).to_pylist()
                                       for k in range(3))):
        if y == 0:
            assert (q, r, p) == (None, None, None)
            continue
        jq, jr = _java(x, y)
        jp = jr if jr >= 0 else _java(jr + y, y)[1]
        assert (q, r, p) == (jq, jr, jp), (x, y)


def test_min_value_divided_by_minus_one_wraps_as_java():
    lo = -(2 ** 63)
    tbl = pa.table({"a": pa.array([lo, lo, lo], pa.int64()),
                    "b": pa.array([-1, 1, lo], pa.int64())})
    got = port_eval(tbl, [A.IntegralDivide(B.col("a"), B.col("b")),
                          A.Remainder(B.col("a"), B.col("b")),
                          A.UnaryMinus(B.col("a")), A.Abs(B.col("a"))])
    assert got.column(0).to_pylist() == [lo, lo, 1]
    assert got.column(1).to_pylist() == [0, 0, 0]
    assert got.column(2).to_pylist() == [lo] * 3
    assert got.column(3).to_pylist() == [lo] * 3
