"""The port's file reads (``plan/logical.py``'s file relations,
``io/scan.py``'s ORC, CSV and partitioned Parquet scans, the CPU
engine's reads) against the JAX package's.

The same numpy-seeded files go through both packages: the port on
``device="cpu"`` and on its CPU engine (``cpu/engine.py::execute_cpu``),
the JAX package on its device engine (the JAX CPU backend) and on its
CPU engine.  Rows are compared as multisets (floats exact: nothing
sums them in another order).  The cases: ORC (a round trip, a
projection under a filter and an aggregate, many stripes; JAX
``tests/test_orc.py``), ``read_csv`` (JAX ``test_session.py::
test_csv_scan``, and ``input_file_name()`` over a CSV file), Hive
partition discovery (LONG and STRING inference, ``%XX`` escapes, the
NULL directory), pruning (``filesPruned`` equal to the JAX scan's,
JAX ``test_pushdown.py::test_partition_pruning`` and
``::test_prune_preserves_hive_partition_columns``) on both Parquet
decode paths, partition columns beside ``input_file_name()``, a
runtime filter whose probe side is a partitioned ORC scan, and the
shared-scan key of two directories.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.cpu.engine import execute_cpu as jexecute_cpu
from spark_rapids_tpu.config import get_conf
from spark_rapids_tpu.exprs.base import lit as jlit
from spark_rapids_tpu.exprs.nondeterministic import InputFileName as JIFN
from spark_rapids_tpu.io.scan import ParquetScanExec as JParquetScan
from spark_rapids_tpu.plan.planner import collect_exec as jcollect
from spark_rapids_tpu.plan.planner import plan_query as jplan_query
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum
from tests.differential import gen_table

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.cpu.engine import execute_cpu
from spark_rapids_tpu_torch.exprs.nondeterministic import InputFileName
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.plan.planner import collect_exec
from spark_rapids_tpu_torch.plan.share_key import scan_share_key
from spark_rapids_tpu_torch.session import TorchSession, col, lit, sum_


def _port(**keys) -> TorchSession:
    return TorchSession(keys or None, device="cpu")


def _multiset(t: pa.Table) -> list:
    return sorted(tuple(repr(r[n]) for n in sorted(r))
                  for r in t.to_pylist())


def _same(port_df, jax_df) -> pa.Table:
    """The port's device run, its CPU engine, the JAX device run and
    the JAX CPU engine give one multiset of rows; the port's run."""
    got = port_df.collect()
    assert got.column_names == list(jax_df.schema.names)
    want = _multiset(jax_df.collect())
    assert _multiset(got) == want
    assert _multiset(execute_cpu(port_df._plan)) == want
    assert _multiset(jexecute_cpu(jax_df._plan)) == want
    return got


def _scan(plan, cls=ParquetScanExec):
    return next(n for n in plan.walk() if isinstance(n, cls))


# -- ORC -- #

def test_orc_round_trip(tmp_path):
    t = gen_table({"a": "int64", "b": "float64", "s": "string"}, 500,
                  seed=5)
    p = str(tmp_path / "t.orc")
    paorc.write_table(t, p)
    got = _same(_port().read_orc(p), TpuSession().read_orc(p))
    assert got.column("a").to_pylist() == t.column("a").to_pylist()
    assert got.column("s").to_pylist() == t.column("s").to_pylist()


def test_orc_query_and_projection(tmp_path):
    t = pa.table({"x": pa.array(np.arange(1000), pa.int64()),
                  "v": pa.array(np.linspace(0, 1, 1000))})
    p = str(tmp_path / "q.orc")
    paorc.write_table(t, p)
    got = _same(_port().read_orc(p, columns=["x"]).where(col("x") < lit(100))
                .agg((sum_(col("x")), "sx")),
                TpuSession().read_orc(p, columns=["x"])
                .where(jcol("x") < jlit(100)).agg((jsum(jcol("x")), "sx")))
    assert got.to_pydict()["sx"] == [sum(range(100))]
    # a projection in another order than the file's (the JAX scan casts
    # the stripe's columns by position there, and fails; ROADMAP.md
    # section 3): held against pyarrow
    df = _port().read_orc(p, columns=["v", "x"])
    want = _multiset(t.select(["v", "x"]))
    assert df.collect().column_names == ["v", "x"]
    assert _multiset(df.collect()) == _multiset(execute_cpu(df._plan)) \
        == want


def test_orc_multistripe(tmp_path):
    t = pa.table({"x": pa.array(np.arange(50_000), pa.int64())})
    p = str(tmp_path / "m.orc")
    with paorc.ORCWriter(p, stripe_size=64 * 1024) as w:
        w.write(t)
    assert paorc.ORCFile(p).nstripes > 1
    s = _port(**{C.BATCH_ROWS: 4096})
    got = _same(s.read_orc(p).agg((sum_(col("x")), "s")),
                TpuSession().read_orc(p).agg((jsum(jcol("x")), "s")))
    assert got.to_pydict()["s"] == [sum(range(50_000))]


# -- CSV -- #

def test_csv_scan(tmp_path):
    t = pa.table({"a": pa.array([1, 2, 3], pa.int64()),
                  "b": pa.array([1.5, 2.5, 3.5])})
    path = str(tmp_path / "t.csv")
    pacsv.write_csv(t, path)
    _same(_port().read_csv(path).select((col("a") + lit(1)).alias("a1"),
                                        col("b")),
          TpuSession().read_csv(path).select(
              (jcol("a") + jlit(1)).alias("a1"), jcol("b")))


def test_csv_with_schema(tmp_path):
    rng = np.random.default_rng(11)
    t = pa.table({"k": pa.array(rng.integers(0, 9, 200), pa.int64()),
                  "v": pa.array(rng.random(200))})
    path = str(tmp_path / "t.csv")
    pacsv.write_csv(t, path)
    schema = T.Schema([T.Field("k", T.INT), T.Field("v", T.DOUBLE)])
    from spark_rapids_tpu import types as JT

    jschema = JT.Schema([JT.Field("k", JT.INT), JT.Field("v", JT.DOUBLE)])
    got = _same(_port().read_csv(path, schema=schema),
                TpuSession().read_csv(path, schema=jschema))
    assert got.schema.field("k").type == pa.int32()
    assert _multiset(got) == _multiset(t.cast(got.schema))


#: TIMESTAMP text as CSV writers spell it: with no zone offset (space-
#: or ``T``-separated), in UTC (``Z``) and at an offset
_STAMP_FORMATS = {"naive": "%Y-%m-%d %H:%M:%S",
                  "t_separated": "%Y-%m-%dT%H:%M:%S",
                  "zulu": "%Y-%m-%dT%H:%M:%SZ",
                  "offset": "%Y-%m-%d %H:%M:%S+02:00"}


def _stamp_csv(tmp_path, kind: str) -> str:
    """50 seeded instants in ``kind``'s spelling, every seventh NULL."""
    import datetime

    rng = np.random.default_rng(17)
    lines = ["a,t"]
    for i, s in enumerate(rng.integers(0, 2_000_000_000, 50)):
        text = "" if i % 7 == 3 else datetime.datetime.fromtimestamp(
            int(s), datetime.timezone.utc).strftime(_STAMP_FORMATS[kind])
        lines.append(f"{i},{text}")
    path = str(tmp_path / f"{kind}.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("engine", ["scan", "cpu_engine"])
@pytest.mark.parametrize("given", [False, True], ids=["inferred", "schema"])
@pytest.mark.parametrize("kind", sorted(_STAMP_FORMATS))
def test_csv_timestamp_reads_as_the_jax_package(tmp_path, kind, given,
                                                engine):
    """F8: a TIMESTAMP column of naive, ``T``-separated or zoned text,
    with NULLs, inferred or given by ``schema=``, reads as the JAX
    package's read of the same file, on the scan and on the CPU
    engine's read."""
    from spark_rapids_tpu import types as JT

    path = _stamp_csv(tmp_path, kind)
    schema = T.Schema([T.Field("a", T.LONG), T.Field("t", T.TIMESTAMP)]) \
        if given else None
    jschema = JT.Schema([JT.Field("a", JT.LONG),
                         JT.Field("t", JT.TIMESTAMP)]) if given else None
    df = _port().read_csv(path, schema=schema)
    got = df.collect() if engine == "scan" else execute_cpu(df._plan)
    jdf = TpuSession().read_csv(path, schema=jschema)
    want = jdf.collect()
    assert got.schema.field("t").type == pa.timestamp("us", tz="UTC")
    assert got.to_pylist() == want.to_pylist()
    assert jexecute_cpu(jdf._plan).to_pylist() == want.to_pylist()
    assert got.column("t").null_count == 7


def test_input_file_name_over_csv(tmp_path):
    p = str(tmp_path / "a.csv")
    with open(p, "w") as f:
        f.write("v\n1\n2\n")
    got = _port().read_csv(p).select(col("v"),
                                     InputFileName().alias("fn")).collect()
    want = TpuSession().read_csv(p).select(
        jcol("v"), JIFN().alias("fn")).collect(engine="tpu")
    assert got.to_pydict() == want.to_pydict() == {"v": [1, 2],
                                                   "fn": [p, p]}


# -- Hive partitions -- #

def _hive(tmp_path, fmt: str = "parquet") -> str:
    """k=<int> / s=<escaped string or NULL> directories, a file each,
    and a stray file and directory discovery must skip."""
    root = tmp_path / f"hive-{fmt}"
    rng = np.random.default_rng(3)
    for k in (1, 2, 3):
        for s in ("a%2Fb", "x", "__HIVE_DEFAULT_PARTITION__"):
            d = root / f"k={k}" / f"s={s}"
            d.mkdir(parents=True)
            t = pa.table({"v": pa.array(rng.random(40)),
                          "n": pa.array(rng.integers(0, 100, 40),
                                        pa.int64())})
            if fmt == "parquet":
                pq.write_table(t, str(d / "part-0.parquet"),
                               row_group_size=16)
            elif fmt == "orc":
                paorc.write_table(t, str(d / "part-0.orc"))
            else:
                pacsv.write_csv(t, str(d / "part-0.csv"))
    (root / "_SUCCESS").write_text("")
    (root / "notes").mkdir()
    (root / "k=1" / ".hidden.parquet").write_text("not a file to read")
    return str(root)


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_partition_discovery_and_types(tmp_path, fmt):
    root = _hive(tmp_path, fmt)
    read = {"parquet": "read_parquet", "orc": "read_orc", "csv": "read_csv"}
    port = getattr(_port(), read[fmt])(root)
    jax = getattr(TpuSession(), read[fmt])(root)
    rel = port._plan
    assert rel.paths == jax._plan.paths and len(rel.paths) == 9
    assert [(f.name, f.dtype.name) for f in rel.partition_fields] == \
        [("k", "bigint"), ("s", "string")]
    assert rel.schema.names == ["v", "n", "k", "s"]
    got = _same(port, jax)
    assert sorted(set(got.column("s").to_pylist()),
                  key=str) == [None, "a/b", "x"]


@pytest.mark.parametrize("fast", [False, True])
def test_partition_pruning(tmp_path, fast):
    root = _hive(tmp_path)
    s = _port(**{C.FAST_DECODE: fast, C.TASK_TARGET_BYTES: 1})
    cases = [
        (col("k").eq(lit(2)), jcol("k").eq(jlit(2)), 6),
        (col("s").is_null(), jcol("s").is_null(), 6),
        ((col("k") > lit(1)) & col("s").eq(lit("a/b")),
         (jcol("k") > jlit(1)) & jcol("s").eq(jlit("a/b")), 7),
        ((col("k") < lit(3)) & (col("v") < lit(0.5)),
         (jcol("k") < jlit(3)) & (jcol("v") < jlit(0.5)), 3),
    ]
    for cond, jcond, pruned in cases:
        df = s.read_parquet(root).where(cond)
        plan = df.physical_plan()
        got = collect_exec(plan, s.conf)
        jdf = TpuSession().read_parquet(root).where(jcond)
        jex, _ = jplan_query(jdf._plan, get_conf())
        want = jcollect(jex)
        jscan = next(n for n in jex._walk()
                     if isinstance(n, JParquetScan))
        assert _scan(plan).metrics["filesPruned"] == \
            jscan.metrics["filesPruned"].value == pruned
        assert _multiset(got) == _multiset(want)
        assert _multiset(execute_cpu(df._plan)) == _multiset(want)


def test_prune_preserves_hive_partition_columns(tmp_path):
    for part in ("x=1", "x=2"):
        d = tmp_path / part
        d.mkdir()
        pq.write_table(pa.table({"a": np.arange(10),
                                 "b": np.arange(10) * 2.0}),
                       str(d / "f.parquet"))
    df = _port().read_parquet(str(tmp_path)).select(col("a"), col("x"))
    rel = df._plan.children[0]
    assert [f.name for f in rel.partition_fields] == ["x"]
    scan = _scan(df.physical_plan())
    assert scan.columns == ["a", "x"]
    out = _same(df, TpuSession().read_parquet(str(tmp_path)).select(
        jcol("a"), jcol("x"))).to_pydict()
    assert sorted(set(out["x"])) == [1, 2] and len(out["a"]) == 20
    projected = _port().read_parquet(str(tmp_path), columns=["x", "a"])
    assert projected._plan.columns == ["a"]
    _same(projected, TpuSession().read_parquet(str(tmp_path),
                                               columns=["x", "a"]))


def test_partition_columns_beside_input_file_name(tmp_path):
    root = _hive(tmp_path)
    for fast in (False, True):
        got = (_port(**{C.FAST_DECODE: fast}).read_parquet(root)
               .where(col("k").eq(lit(3)))
               .select(col("n"), col("k"), col("s"),
                       InputFileName().alias("fn"))).collect()
        want = (TpuSession().read_parquet(root).where(jcol("k").eq(jlit(3)))
                .select(jcol("n"), jcol("k"), jcol("s"),
                        JIFN().alias("fn"))).collect(engine="tpu")
        assert _multiset(got) == _multiset(want)
        assert all(f"{os.sep}k=3{os.sep}" in f for f in got["fn"].to_pylist())


def test_runtime_filter_probes_a_partitioned_orc_scan(tmp_path):
    root = _hive(tmp_path, "orc")
    dim = pa.table({"dk": pa.array([2, 7], pa.int64()),
                    "w": pa.array(["two", "seven"])})
    s = _port(**{C.TASK_TARGET_BYTES: 1})
    df = s.read_orc(root).join(s.create_dataframe(dim),
                               left_on=[col("k")], right_on=[col("dk")])
    plan = df.physical_plan()
    applied = [c for n in plan.walk()
               for c, _ in getattr(n, "runtime_filters", ())]
    assert applied == ["k"]
    got = collect_exec(plan, s.conf)
    jdf = TpuSession().read_orc(root).join(
        TpuSession().create_dataframe(dim), left_on=[jcol("k")],
        right_on=[jcol("dk")])
    assert _multiset(got) == _multiset(jdf.collect(engine="cpu"))
    assert _scan(plan).metrics["rfPrunedRows"] == 240


def test_sql_register_parquet_takes_a_directory(tmp_path):
    """``SqlSession.register_parquet`` over a Hive directory, as the JAX
    frontend's: its partition columns are columns of the table."""
    from spark_rapids_tpu.frontends.sql import SqlSession as JSql

    from spark_rapids_tpu_torch.frontends.sql import SqlSession

    root = _hive(tmp_path)
    text = ("SELECT k, s, COUNT(*) AS n, SUM(n) AS sn FROM t "
            "WHERE k >= 2 GROUP BY k, s")
    port, jax = SqlSession(device="cpu"), JSql()
    port.register_parquet("t", root)
    jax.register_parquet("t", root)
    got = port.sql(text).collect()
    assert got.num_rows == 6
    assert _multiset(got) == _multiset(jax.sql(text).collect())


def test_two_directories_never_share_a_scan(tmp_path):
    root = _hive(tmp_path)
    scan = _scan(_port().read_parquet(root).physical_plan())
    key = scan_share_key(scan, 0, C.TorchConf())
    assert key is not None
    scan.partition_values = [dict(pv, k="9") for pv in scan.partition_values]
    assert scan_share_key(scan, 0, C.TorchConf()) not in (None, key)


from torch_quiet import quiet_ladder  # noqa: E402,F401
