"""The port's math expressions against the JAX package's.

Inputs are numpy-seeded doubles and longs with NULLs, NaN, +/-inf, -0.0,
values outside the log and inverse-trigonometric domains, and .5 ties
on both signs at round scales 0, 2 and -1.  Rounding, ceil / floor,
signum, rint, nanvl and the NaN / zero normalisation must be equal
exactly (NaN equal to NaN, the sign of a zero included).  sqrt and the
transcendental functions (exp, the logs, trigonometric and hyperbolic
ones, pow, cbrt, degrees / radians) come from different libraries on
each side (torch's, XLA's; on the CPU neither rounds sqrt correctly
every time), so they are held within a relative 1e-13, NaN and
infinities exactly.
"""

import math
import types

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import math as JM

from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import math as M
from torch_jax_eval import jax_eval, port_eval

#: relative tolerance of the transcendental functions
TRANSCENDENTAL_RTOL = 1e-13
SPECIAL = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1.0, -1.0,
           0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.125, -0.125, 0.375, -0.375,
           12.5, -12.5, 15.0, -15.0, 25.0, -25.0, 1e300, -1e-300, 0.99,
           1.01, 2.0]

JAX = types.SimpleNamespace(M=JM, col=JB.ColumnReference, lit=JB.Literal.of)
PORT = types.SimpleNamespace(M=M, col=B.col, lit=B.Literal.of)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(3)
    n = 300
    x = np.concatenate([rng.normal(0, 50, n - len(SPECIAL)), SPECIAL])
    return pa.table({
        "x": pa.array(x, mask=rng.random(n) < 0.1),
        "y": pa.array(rng.permutation(x)),
        "u": pa.array(rng.uniform(-1.2, 1.2, n), mask=rng.random(n) < 0.1),
        "l": pa.array(np.concatenate([
            rng.integers(-10_000, 10_000, n - 8),
            [15, -15, 25, -25, 5, -5, 150, -150]]), pa.int64(),
            mask=rng.random(n) < 0.1),
    })


def _exact(ns):
    M_, c, lit = ns.M, ns.col, ns.lit
    x, y, lng = c("x"), c("y"), c("l")
    return {
        "round": [M_.Round(x, s) for s in (0, 2, -1, 1)]
        + [M_.Round(lng, s) for s in (0, -1, -2)],
        "bround": [M_.BRound(x, s) for s in (0, 2, -1, 1)]
        + [M_.BRound(lng, s) for s in (0, -1, -2)],
        "ceil_floor": [M_.Ceil(x), M_.Floor(x), M_.Ceil(lng),
                       M_.Floor(lng)],
        "signum_rint": [M_.Signum(x), M_.Rint(x)],
        "nan": [M_.NaNvl(x, y), M_.NaNvl(x, lit(0.0)),
                M_.NormalizeNaNAndZero(x),
                M_.KnownFloatingPointNormalized(x)],
    }


def _transcendental(ns):
    M_, c, lit = ns.M, ns.col, ns.lit
    x, u, y = c("x"), c("u"), c("y")
    return {
        "exp_log": [M_.Exp(u), M_.Expm1(u), M_.Log(x), M_.Log10(x),
                    M_.Log2(x), M_.Log1p(x), M_.Log1p(u),
                    M_.Logarithm(lit(3.0), x), M_.Logarithm(u, y)],
        "trig": [M_.Sin(x), M_.Cos(x), M_.Tan(u), M_.Cot(u), M_.Asin(u),
                 M_.Acos(u), M_.Atan(x)],
        "hyperbolic": [M_.Sinh(u), M_.Cosh(u), M_.Tanh(x), M_.Asinh(x),
                       M_.Acosh(x), M_.Atanh(u)],
        "pow_sqrt_cbrt_degrees": [M_.Pow(u, lit(3.0)), M_.Pow(x, lit(0.5)),
                                  M_.Sqrt(x), M_.Cbrt(x), M_.ToDegrees(x),
                                  M_.ToRadians(x)],
    }


def _bits(v):
    """A float with its sign (for -0.0) and NaN-ness, for exact
    comparison."""
    if isinstance(v, float):
        return ("nan",) if math.isnan(v) else (v, math.copysign(1.0, v))
    return v


@pytest.mark.parametrize("case", list(_exact(PORT)))
def test_exact_functions_equal_the_jax_functions(case, table):
    got = port_eval(table, _exact(PORT)[case])
    want = jax_eval(table, _exact(JAX)[case])
    assert got.schema.types == want.schema.types
    for k in range(got.num_columns):
        g = [_bits(v) for v in got.column(k).to_pylist()]
        w = [_bits(v) for v in want.column(k).to_pylist()]
        assert g == w, (case, k)


@pytest.mark.parametrize("case", list(_transcendental(PORT)))
def test_transcendental_functions_within_tolerance(case, table):
    got = port_eval(table, _transcendental(PORT)[case])
    want = jax_eval(table, _transcendental(JAX)[case])
    for k in range(got.num_columns):
        g, w = got.column(k), want.column(k)
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), (case, k)
        gv = np.array(g.fill_null(0.0).to_pylist(), dtype=np.float64)
        wv = np.array(w.fill_null(0.0).to_pylist(), dtype=np.float64)
        np.testing.assert_allclose(gv, wv, rtol=TRANSCENDENTAL_RTOL, atol=0,
                                   equal_nan=True, err_msg=f"{case} {k}")


def test_round_is_half_up_and_bround_half_even_at_ties():
    tbl = pa.table({"x": [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.125, -0.375],
                    "l": pa.array([15, -15, 25, -25, 5, -5, 150, -250],
                                  pa.int64())})
    got = port_eval(tbl, [M.Round(B.col("x"), 0), M.BRound(B.col("x"), 0),
                          M.Round(B.col("x"), 2), M.BRound(B.col("x"), 2),
                          M.Round(B.col("l"), -1), M.BRound(B.col("l"), -1)])
    assert got.column(0).to_pylist()[:6] == [1.0, -1.0, 2.0, -2.0, 3.0,
                                             -3.0]
    assert got.column(1).to_pylist()[:6] == [0.0, -0.0, 2.0, -2.0, 2.0,
                                             -2.0]
    assert got.column(2).to_pylist()[6:] == [0.13, -0.38]
    assert got.column(3).to_pylist()[6:] == [0.12, -0.38]
    assert got.column(4).to_pylist() == [20, -20, 30, -30, 10, -10, 150,
                                         -250]
    assert got.column(5).to_pylist() == [20, -20, 20, -20, 0, 0, 150, -250]


def test_logs_of_out_of_domain_inputs_are_null():
    tbl = pa.table({"x": [0.0, -1.0, -0.0, 1.0, -2.0]})
    got = port_eval(tbl, [M.Log(B.col("x")), M.Log1p(B.col("x"))])
    assert got.column(0).to_pylist() == [None, None, None, 0.0, None]
    assert got.column(1).to_pylist()[:2] == [0.0, None]


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
