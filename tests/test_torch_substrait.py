"""The port's Substrait frontend (``frontends/substrait.py``) against the
JAX package's.

Counterparts of the seven tests of ``tests/test_substrait.py``: each
plan goes through both frontends over the same numpy-seeded tables
(the port on ``device="cpu"``, the JAX package on its device engine on
the JAX CPU backend), and the results must be equal (q6's float sum
within rel 1e-12: XLA adds in another order); a plan either one
refuses raises ``SubstraitError`` in both, with the same fragment in
the message.  Then ``tpch.py``'s q6 and q1 plans, equal to the port's
q6 and q1 DataFrames bit for bit, with the same calls of the hash
kernel's wrapper (one a map batch of q1's exchange).
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.frontends.substrait import SubstraitError as JError
from spark_rapids_tpu.frontends.substrait import SubstraitFrontend as JFront

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import tpch
from spark_rapids_tpu_torch.frontends.substrait import (
    SubstraitError,
    SubstraitFrontend,
)
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.plugin import TorchPlugin, frontend
from spark_rapids_tpu_torch.session import TorchSession


def _sel(i):
    return {"selection": {"directReference": {"structField": {"field": i}}}}


def _fn(anchor, *args):
    return {"scalarFunction": {"functionReference": anchor,
                               "arguments": [{"value": a} for a in args]}}


def _lit(key, v):
    return {"literal": {key: v}}


def _extensions(names):
    return [{"extensionFunction": {"functionAnchor": i, "name": n}}
            for i, n in enumerate(names, start=1)]


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    rng = np.random.default_rng(42)
    n = 60_000
    t = pa.table({
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n), 2),
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
    })
    p = str(tmp_path_factory.mktemp("substrait") / "lineitem.parquet")
    pq.write_table(t, p)
    return t, p


def _fronts(**tables):
    port, jax = SubstraitFrontend(device="cpu"), JFront()
    for name, source in tables.items():
        port.register_table(name, source)
        jax.register_table(name, source)
    return port, jax


def _q6_plan():
    fns = ["gte:fp64_fp64", "lt:fp64_fp64", "lte:fp64_fp64",
           "and:bool", "multiply:fp64_fp64", "sum:fp64"]
    GTE, LT, LTE, AND, MUL, _SUM = 1, 2, 3, 4, 5, 6
    cond = _fn(AND,
               _fn(GTE, _sel(3), _lit("i32", 8766)),
               _fn(LT, _sel(3), _lit("i32", 9131)),
               _fn(GTE, _sel(2), _lit("fp64", 0.05)),
               _fn(LTE, _sel(2), _lit("fp64", 0.07)),
               _fn(LT, _sel(0), _lit("fp64", 24.0)))
    return {
        "extensions": _extensions(fns),
        "relations": [{"root": {
            "names": ["revenue"],
            "input": {"aggregate": {
                "input": {"project": {
                    "common": {"emit": {"outputMapping": [4]}},
                    "input": {"filter": {
                        "input": {"read": {"namedTable": {
                            "names": ["lineitem"]}}},
                        "condition": cond,
                    }},
                    "expressions": [_fn(MUL, _sel(1), _sel(2))],
                }},
                "groupings": [],
                "measures": [{"measure": {
                    "functionReference": _SUM,
                    "arguments": [{"value": _sel(0)}]}}],
            }},
        }}],
    }


def test_q6_foreign_plan_runs_on_the_port(lineitem):
    t, path = lineitem
    fe = TorchPlugin.get_or_create(C.TorchConf(), "cpu").session("substrait")
    assert isinstance(fe, SubstraitFrontend)
    fe.register_table("lineitem", path)
    jfe = JFront()
    jfe.register_table("lineitem", path)
    df = fe.dataframe(_q6_plan())
    explain = df.explain()
    assert "Filter" in explain and "Aggregate" in explain, explain
    assert "!" not in explain.split("\n")[0]
    out = df.collect().to_pydict()
    q, price = np.asarray(t["l_quantity"]), np.asarray(t["l_extendedprice"])
    disc, ship = np.asarray(t["l_discount"]), np.asarray(t["l_shipdate"])
    mask = ((ship >= 8766) & (ship < 9131) & (disc >= 0.05)
            & (disc <= 0.07) & (q < 24.0))
    want = float((price[mask] * disc[mask]).sum())
    assert abs(out["revenue"][0] - want) <= 1e-6 * max(1.0, abs(want))
    # XLA sums in another order than torch: equal within rel 1e-12
    jax_out = jfe.execute_plan(_q6_plan(), engine="tpu").to_pydict()
    assert out["revenue"] == pytest.approx(jax_out["revenue"], rel=1e-12)


def test_seam_resolves_by_name():
    fe = frontend("substrait")(None, "cpu")
    assert isinstance(fe, SubstraitFrontend)
    assert fe.session.device.type == "cpu"


def test_filter_project_sort_fetch(lineitem):
    _t, path = lineitem
    port, jax = _fronts(lineitem=path)
    plan = {
        "extensions": _extensions(["lt:fp64_fp64"]),
        "relations": [{"root": {
            "names": ["qty", "disc"],
            "input": {"fetch": {
                "count": 5,
                "input": {"sort": {
                    "sorts": [{"expr": _sel(0),
                               "direction":
                               "SORT_DIRECTION_DESC_NULLS_LAST"},
                              {"expr": _sel(1)}],
                    "input": {"project": {
                        "common": {"emit": {"outputMapping": [0, 2]}},
                        "input": {"filter": {
                            "input": {"read": {"namedTable": {
                                "names": ["lineitem"]}}},
                            "condition": _fn(1, _sel(0),
                                             _lit("fp64", 3.0)),
                        }},
                        "expressions": [],
                    }},
                }},
            }},
        }}],
    }
    out = port.execute_plan(plan)
    assert out.num_rows == 5 and out.column_names == ["qty", "disc"]
    assert all(v < 3.0 for v in out.to_pydict()["qty"])
    assert out.to_pydict() == jax.execute_plan(plan,
                                               engine="tpu").to_pydict()


@pytest.mark.parametrize("join_type", ["JOIN_TYPE_INNER", "JOIN_TYPE_LEFT",
                                       "JOIN_TYPE_LEFT_SEMI"])
def test_join_plan(join_type):
    left = pa.table({"k": pa.array([1, 2, 3, 4], pa.int64()),
                     "v": pa.array([10.0, 20.0, 30.0, 40.0])})
    right = pa.table({"k2": pa.array([2, 4, 9], pa.int64()),
                      "w": pa.array([200, 400, 900], pa.int64())})
    port, jax = _fronts(l=left, r=right)
    names = ["k", "v"] if join_type.endswith("SEMI") else ["k", "v", "k2",
                                                           "w"]
    plan = {
        "extensions": _extensions(["equal:any_any"]),
        "relations": [{"root": {
            "names": names,
            "input": {"join": {
                "type": join_type,
                "left": {"read": {"namedTable": {"names": ["l"]}}},
                "right": {"read": {"namedTable": {"names": ["r"]}}},
                "expression": _fn(1, _sel(0), _sel(2)),
            }},
        }}],
    }
    out = port.execute_plan(plan)
    want = jax.execute_plan(plan, engine="tpu")
    assert out.column_names == want.column_names == names
    assert sorted(out.to_pylist(), key=repr) == sorted(want.to_pylist(),
                                                       key=repr)
    if join_type == "JOIN_TYPE_INNER":
        assert sorted(zip(out["k"].to_pylist(), out["w"].to_pylist())) \
            == [(2, 200), (4, 400)]


def test_self_join_keeps_names_apart():
    """Both sides of one table: the port renames the right side's
    columns, so positions still resolve (the JAX frontend binds by
    position throughout)."""
    t = pa.table({"k": pa.array([1, 2, 2], pa.int64()),
                  "v": pa.array([1.0, 2.0, 3.0])})
    port, jax = _fronts(t=t)
    plan = {
        "extensions": _extensions(["equal:any_any", "add:fp64_fp64"]),
        "relations": [{"root": {
            "names": ["k", "s"],
            "input": {"project": {
                "common": {"emit": {"outputMapping": [0, 4]}},
                "input": {"join": {
                    "type": "JOIN_TYPE_INNER",
                    "left": {"read": {"namedTable": {"names": ["t"]}}},
                    "right": {"read": {"namedTable": {"names": ["t"]}}},
                    "expression": _fn(1, _sel(0), _sel(2)),
                }},
                "expressions": [_fn(2, _sel(1), _sel(3))],
            }},
        }}],
    }
    out = port.execute_plan(plan)
    want = jax.execute_plan(plan, engine="tpu")
    assert sorted(out.to_pylist(), key=repr) == sorted(want.to_pylist(),
                                                       key=repr)


def _raise_alike(plan, fragment: str, **tables) -> None:
    port, jax = _fronts(**tables)
    with pytest.raises(SubstraitError, match=fragment):
        port.dataframe(plan)
    with pytest.raises(JError, match=fragment):
        jax.dataframe(plan)
    assert issubclass(SubstraitError, ValueError)


def test_unsupported_rel_raises():
    _raise_alike({"relations": [{"root": {"input": {"exchange": {}},
                                          "names": []}}]}, "not supported")


def test_unsupported_scalar_function_raises():
    plan = {
        "extensions": _extensions(["sqrt_banana:fp64"]),
        "relations": [{"root": {
            "names": ["y"],
            "input": {"project": {
                "common": {"emit": {"outputMapping": [1]}},
                "input": {"read": {"namedTable": {"names": ["t"]}}},
                "expressions": [_fn(1, _sel(0))],
            }},
        }}],
    }
    _raise_alike(plan, "sqrt_banana", t=pa.table({"x": pa.array([1.0])}))


@pytest.mark.parametrize("plan, fragment", [
    ({"relations": []}, "exactly 1 relation"),
    ({"relations": [{"root": {"names": [], "input": {"read": {
        "namedTable": {"names": ["nope"]}}}}}]}, "not registered"),
    ({"relations": [{"root": {"names": [], "input": {"fetch": {
        "offset": 2, "count": 1, "input": {"read": {
            "namedTable": {"names": ["t"]}}}}}}}]}, "offset"),
    ({"relations": [{"root": {"names": ["a", "b"], "input": {"read": {
        "namedTable": {"names": ["t"]}}}}}]}, "do not match"),
])
def test_refused_plans_raise_alike(plan, fragment):
    _raise_alike(plan, fragment, t=pa.table({"x": pa.array([1.0])}))


def test_translatable_but_gpu_unsupported_falls_back():
    """A decimal divide translates but runs on the CPU engine, through
    the planner's tags, shown by explain()."""
    t = pa.table({"d": pa.array([decimal.Decimal("1.50"),
                                 decimal.Decimal("2.25")]),
                  "x": pa.array([1.0, 2.0])})
    port, jax = _fronts(t=t)
    plan = {
        "extensions": _extensions(["divide:dec_dec"]),
        "relations": [{"root": {
            "names": ["q"],
            "input": {"project": {
                "common": {"emit": {"outputMapping": [2]}},
                "input": {"read": {"namedTable": {"names": ["t"]}}},
                "expressions": [_fn(1, _sel(0), _sel(0))],
            }},
        }}],
    }
    df = port.dataframe(plan)
    explain = df.explain()
    assert "cannot run on the GPU" in explain and "CpuFallbackExec" in \
        explain, explain
    out = df.collect().to_pydict()
    assert out == jax.execute_plan(plan, engine="tpu").to_pydict()
    assert [float(v) for v in out["q"]] == [1.0, 1.0]


@pytest.fixture(scope="module")
def q1_lineitem(tmp_path_factory):
    d = tmp_path_factory.mktemp("substrait_q1")
    return tpch.make_lineitem(str(d), n_files=3, with_q1_cols=True,
                              rows_per_file=1 << 13)


@pytest.mark.parametrize("name", ["q6", "q1"])
def test_tpch_plans_equal_the_dataframes(q1_lineitem, name, monkeypatch):
    """Bit for bit, and one call of the hash wrapper a map batch of q1's
    exchange either way (``scan.taskTargetBytes`` = 1: a scan task a
    file)."""
    keys = {C.TASK_TARGET_BYTES: 1}
    fe = SubstraitFrontend(keys, device="cpu")
    fe.register_table("lineitem", q1_lineitem)
    session = TorchSession(keys, device="cpu")
    calls = []
    wrapper = kernels.hash_columns

    def counted(*args, **kwargs):
        calls.append(1)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(kernels, "hash_columns", counted)
    runs = {}
    for how, make in (
            ("substrait", lambda: fe.dataframe(
                getattr(tpch, f"{name}_substrait")())),
            ("dataframe", lambda: getattr(tpch, f"{name}_dataframe")(
                session, q1_lineitem))):
        calls.clear()
        out = make().collect()
        runs[how] = (sorted(out.to_pylist(), key=repr), len(calls))
    assert runs["substrait"] == runs["dataframe"]
    assert runs["dataframe"][1] == (3 if name == "q1" else 0)


from torch_quiet import quiet_ladder  # noqa: E402,F401
