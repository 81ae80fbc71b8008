"""The port's SQL frontend against the JAX package's.

- Parsing: over all 99 TPC-DS texts, the port's ``_Parser`` accepts
  exactly the texts the JAX ``_Parser`` accepts, and fails on the others
  with the same ``SqlError`` class.
- Lowering and running: each query below runs through the port's
  ``SqlSession(device="cpu")`` and through the JAX ``SqlSession``, whose
  plan the JAX CPU oracle runs (``collect(engine="cpu")``), over the same
  numpy-seeded tables (NULLs, multi-byte UTF-8, dates before 1970).
  The results must be equal under ``differential.assert_tables_equal``:
  names, integers, strings and NULLs exact, floats to 9 decimals
  (``approx_float``; summation order may differ).  The queries cover
  named parameters, CTEs, IN / NOT IN / EXISTS subqueries, scalar
  subqueries (in WHERE and HAVING), the scalar functions the frontend
  maps, date literals with interval arithmetic, LIKE, unions, self
  joins, grouping sets, windows and explicit outer / semi / anti joins.
- ``greatest`` is held against the JAX engine (``engine="tpu"``): the
  CPU oracle computes least() for it; a CASE without ELSE against
  Spark's NULL, which the JAX frontend cannot select (ROADMAP.md §3).
- Casts to the scalar types and EXTRACT of a TIMESTAMP's time fields,
  which raised ``SqlError`` before the port had the types, run as the
  JAX engine runs them; a DOUBLE to DECIMAL cast fails in both engines.
"""

import datetime as dt

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.frontends import sql as JSQL
from spark_rapids_tpu.tools.tpcds_queries import QUERIES as JQUERIES

from differential import assert_tables_equal
from spark_rapids_tpu_torch.frontends import sql as SQL
from spark_rapids_tpu_torch.tpcds_queries import QUERIES

N = 60
WORDS = ["a", "ab", "abc", "b", "é", "日本", "ba", " pad ", "A"]


def _tables():
    rng = np.random.default_rng(21)
    days = rng.integers(-3000, 12000, N).astype(np.int32)
    t1 = pa.table({
        "k": pa.array(rng.integers(0, 8, N), pa.int64(),
                      mask=rng.random(N) < 0.1),
        "g": pa.array(np.array(WORDS, dtype=object)[
            rng.integers(0, len(WORDS), N)], pa.string(),
            mask=rng.random(N) < 0.1),
        "x": pa.array(np.round(rng.normal(0, 10, N), 3),
                      mask=rng.random(N) < 0.1),
        "d": pa.array(days, pa.int32(),
                      mask=rng.random(N) < 0.1).cast(pa.date32()),
        "n": pa.array(rng.integers(-5, 5, N).astype(np.int32), pa.int32()),
    })
    m = 20
    t2 = pa.table({
        "k2": pa.array(rng.integers(0, 12, m), pa.int64(),
                       mask=rng.random(m) < 0.15),
        "v": pa.array(np.round(rng.normal(1, 5, m), 3)),
        "h": pa.array(np.array(WORDS, dtype=object)[
            rng.integers(0, len(WORDS), m)], pa.string()),
    })
    return {"t1": t1, "t2": t2}


@pytest.fixture(scope="module")
def frontends():
    port = SQL.SqlSession(device="cpu")
    jax = JSQL.SqlSession()
    for name, t in _tables().items():
        port.register_table(name, t)
        jax.register_table(name, t)
    return port, jax


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_parser_accepts_what_the_jax_parser_accepts(q):
    def outcome(mod):
        try:
            mod._Parser(QUERIES[q]).parse_select()
            return "ok"
        except mod.SqlError as e:
            return type(e).__name__

    assert QUERIES[q] == JQUERIES[q]
    assert outcome(SQL) == outcome(JSQL)


CASES = {
    "params": ("select k, x from t1 where k = :k and g <> :g",
               {"k": 3, "g": "b"}),
    "params_date": ("select k from t1 where d < :day",
                    {"day": dt.date(1975, 6, 1)}),
    "cte": ("with a as (select g, sum(x) s, count(*) c from t1 group by g), "
            "b as (select g, s from a where c > 2) "
            "select g, s from b order by g", None),
    "in_subquery": ("select k, g from t1 where k in (select k2 from t2 "
                    "where v > 0)", None),
    "not_in_subquery": ("select k, g from t1 where k not in (select k2 "
                        "from t2 where k2 is not null and v > 0)", None),
    "not_in_with_a_null": ("select k from t1 where k not in "
                           "(select k2 from t2)", None),
    "not_in_empty": ("select k from t1 where k not in "
                     "(select k2 from t2 where v > 1000)", None),
    "exists": ("select k, g from t1 where exists (select * from t2 "
               "where t2.k2 = t1.k and v < 3)", None),
    "not_exists": ("select k, g from t1 where not exists (select * from t2 "
                   "where t2.k2 = t1.k)", None),
    "scalar_subquery": ("select k, x from t1 where x > (select avg(v) "
                        "from t2)", None),
    "scalar_subquery_in_having": (
        "select g, sum(x) s from t1 group by g "
        "having sum(x) > (select 0.5 * avg(v) from t2)", None),
    "string_functions": (
        "select upper(g) u, lower(g) l, length(g) n, substr(g, 2, 2) s, "
        "substring(g, -2) s2, concat(g, '-', g) c, g || '!' c2, trim(g) t, "
        "ltrim(g) lt, rtrim(g) rt, coalesce(g, 'none') co from t1", None),
    "number_functions": (
        "select round(x, 1) r, round(x) r0, bround(x, 1) b, abs(x) a, "
        "abs(n) an, least(k, 5) le, least(k, n) le2, k % 3 md, "
        "pmod(n, 3) pm, -x neg, nullif(k, 3) nu, "
        "if(k > 2, 'y', 'n') i from t1", None),
    "date_functions": (
        "select year(d) y, month(d) m, day(d) dd, dayofmonth(d) dm, "
        "quarter(d) q, extract(year from d) ey, "
        "extract(dayofyear from d) doy from t1", None),
    "date_intervals": (
        "select k, d + interval '1' month dm, d - interval '3' day ds, "
        "d + interval '2' week dw from t1 where d between date "
        "'1975-01-01' and date '1975-01-01' + interval '20' year", None),
    "casts": ("select cast(k as double) cd, cast(n as bigint) cl, "
              "cast(x as int) ci, cast(0 as double) z from t1", None),
    "like": ("select g from t1 where g like 'a%' or g like '%c' "
             "or g not like '%b%'", None),
    "case": ("select case when x > 0 then 'pos' when x < 0 then 'neg' "
             "else 'zero' end c, "
             "case g when 'a' then 1 when 'b' then 2 else 0 end c2, "
             "case when k is null then -1 else k end c3 from t1", None),
    "in_list_and_between": ("select k from t1 where k in (1, 2 + 1, 5) and "
                            "n not between -1 and 1", None),
    "union_all": ("select k, x from t1 union all select k2, v from t2", None),
    "union_distinct": ("select g from t1 union select h from t2", None),
    "self_join": ("select a.k, a.g, b.g g2 from t1 a, t1 b "
                  "where a.k = b.k and a.g < b.g", None),
    "order_ordinal_limit": ("select g, count(*) c from t1 group by g "
                            "order by 2 desc, 1 nulls last limit 4", None),
    "order_by_aggregate": ("select g, sum(x) from t1 group by g "
                           "order by sum(x) desc", None),
    "distinct": ("select distinct g, n from t1", None),
    "count_distinct": ("select g, count(distinct k) c from t1 group by g",
                       None),
    "rollup": ("select g, n, sum(x) s, count(*) c from t1 "
               "group by rollup (g, n)", None),
    "grouping_sets": ("select g, n, avg(x) a from t1 "
                      "group by grouping sets ((g, n), (g), ())", None),
    "window": ("select k, g, rank() over (partition by g order by x desc) r, "
               "row_number() over (partition by g order by x, k) rn, "
               "sum(x) over (partition by g) s from t1 where x is not null",
               None),
    "outer_semi_anti": ("select t1.k, v from t1 left outer join t2 "
                        "on k = k2 where n > -3", None),
    "left_semi": ("select k, g from t1 left semi join t2 on k = k2", None),
    "left_anti": ("select k, g from t1 left anti join t2 on k = k2", None),
    "derived_table": ("select g, m from (select g, max(x) m from t1 "
                      "group by g) z where m > 0", None),
    "or_of_joins": ("select count(*) c from t1, t2 where (k = k2 and v > 0) "
                    "or (k = k2 and g = 'a')", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_the_jax_frontend(case, frontends):
    port, jax = frontends
    text, params = CASES[case]
    got = port.sql(text, params=params).collect()
    want = jax.sql(text, params=params).collect(engine="cpu")
    assert_tables_equal(got, want, approx_float=True)


def test_case_without_else_is_null(frontends):
    """The JAX frontend raises AttributeError on a CASE without ELSE in a
    SELECT list (ROADMAP.md §3); Spark and the port give NULL there."""
    got = frontends[0].sql("select x, case when x > 0 then 1 when x < 0 "
                           "then -1 end c from t1").collect().to_pylist()
    assert got and all(
        r["c"] == (None if r["x"] is None or r["x"] == 0 else
                   1 if r["x"] > 0 else -1) for r in got)


def test_greatest_equals_the_jax_engine(frontends):
    port, jax = frontends
    text = ("select greatest(k, n) g, greatest(x, n, k) g2, "
            "greatest(k, 5) g3 from t1")
    got = port.sql(text).collect()
    assert_tables_equal(got, jax.sql(text).collect(engine="tpu"),
                        approx_float=True)


@pytest.mark.parametrize("text,params", [
    ("select k from t1 where k = :k", None),
    ("select k from t1", {"k": 1}),
    ("select k from t1 where k = :k", {"k": object()}),
])
def test_bad_parameters_raise_sql_error_in_both(text, params, frontends):
    for fe, err in ((frontends[0], SQL.SqlError),
                    (frontends[1], JSQL.SqlError)):
        with pytest.raises(err):
            fe.sql(text, params=params)


@pytest.mark.parametrize("text", [
    "select cast(k as timestamp) from t1",
    "select cast(x as float) from t1",
    "select extract(hour from d) from t1",
])
def test_scalar_type_texts_run_as_the_jax_engine_runs_them(text, frontends):
    """These raised SqlError while the port lacked the scalar types; now
    each gives the JAX engine's result."""
    port, jax = frontends
    assert_tables_equal(port.sql(text).collect(),
                        jax.sql(text).collect(engine="tpu"))


def test_double_to_decimal_cast_fails_in_both_engines(frontends):
    """A DOUBLE to DECIMAL cast is outside the JAX cast matrix: both
    planners send it to their CPU engine.  The JAX one fails inside its
    pyarrow conversion; the port's refuses the cast by name."""
    port, jax = frontends
    text = "select cast(x as decimal(7, 2)) from t1"
    with pytest.raises(pa.ArrowInvalid):
        jax.sql(text).collect(engine="tpu")
    with pytest.raises(NotImplementedError,
                       match=r"cast double -> decimal\(7,2\)"):
        port.sql(text).collect()


def test_scalar_subquery_runs_once_per_plan_and_splices_a_literal(frontends):
    from spark_rapids_tpu_torch.exprs.subquery import ScalarSubquery

    df = frontends[0].sql("select k from t1 where x > (select max(v) "
                          "from t2)")
    cond = df._plan.condition if hasattr(df._plan, "condition") else \
        df._plan.children[0].condition
    assert any(isinstance(e, ScalarSubquery) for e in [cond, *cond.children])
    assert "scalar_subquery" not in df.physical_plan().tree_string()


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
