"""The port's writers (``io/write.py``, ``DataFrame.write``) against the
JAX package's.

Each case writes the same frame (numpy-seeded) through both packages'
sessions into two directories, the port's on ``device="cpu"``, and
holds them to each other: the same relative partition directories with
a ``_SUCCESS`` marker at the root, the same rows under each directory
(read with pyarrow, compared as multisets), the port reading the
JAX-written tree and the JAX package the port's to equal tables, and
equal ``WriteStats`` rows and partitions.  The counterparts of the nine
tests of ``tests/test_write.py`` and of ``tests/test_orc.py``'s two
write tests, then the card split's edge values: NULL, NaN, -0.0 and
0.0, and strings with ``/``, ``=`` and ``%``, written with the split
on the batch's device and with the plain host loop.  There the JAX
writer writes each zero row once per sign of zero in the batch, into
one directory named by the first zero's sign (its Arrow ``group_by``
keeps -0.0 and 0.0 apart, its filters and its file keys do not); the
port writes each row once, -0.0 under ``0.0`` (ROADMAP.md section 3),
and that case holds it to exactly that.
"""

import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.config import get_conf, set_conf
from spark_rapids_tpu.cpu.engine import execute_cpu as jexecute_cpu
from spark_rapids_tpu.exprs.base import lit as jlit
from spark_rapids_tpu.io.scan import OrcScanExec as JOrcScan
from spark_rapids_tpu.plan.planner import collect_exec as jcollect
from spark_rapids_tpu.plan.planner import plan_query as jplan_query
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu.session import sum_ as jsum

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.cpu.engine import execute_cpu
from spark_rapids_tpu_torch.io import write as W
from spark_rapids_tpu_torch.io.scan import OrcScanExec
from spark_rapids_tpu_torch.plan.planner import collect_exec
from spark_rapids_tpu_torch.session import TorchSession, col, lit, sum_

READERS = {
    ".parquet": lambda p: pq.ParquetFile(p).read(),
    ".orc": lambda p: paorc.ORCFile(p).read(),
    ".csv": pacsv.read_csv,
}


class _JaxConf:
    """The JAX process-global conf with some keys set, restored after."""

    def __init__(self, **keys):
        self.keys = keys

    def __enter__(self):
        conf = get_conf()
        self.saved = dict(conf._values)
        for k, v in self.keys.items():
            conf.set(k, v)
        set_conf(conf)
        return conf

    def __exit__(self, *exc):
        conf = get_conf()
        conf._values.clear()
        conf._values.update(self.saved)
        set_conf(conf)


def _port(**keys) -> TorchSession:
    return TorchSession(keys or None, device="cpu")


def _sample_table(n=100, seed=5) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "f": pa.array(rng.random(n), pa.float64()),
        "s": pa.array([None if x % 7 == 0 else f"s✓{x % 13}"
                       for x in range(n)], pa.string()),
    })


def _key(v):
    """A cell as a sortable, NaN-safe, signed-zero-telling key."""
    if isinstance(v, float):
        return ("f", repr(v))
    return (type(v).__name__, repr(v))


def _multiset(t: pa.Table) -> list:
    return sorted(tuple(_key(r[n]) for n in sorted(r))
                  for r in t.to_pylist())


def _tree(root: str) -> dict:
    """Relative directory -> the multiset of rows of its data files."""
    out: dict = {}
    for d, _dirs, names in os.walk(root):
        files = [n for n in names if n.endswith(tuple(READERS))]
        if not files:
            continue
        rel = os.path.relpath(d, root)
        rows = []
        for n in files:
            t = READERS[os.path.splitext(n)[1]](os.path.join(d, n))
            rows += _multiset(t)
        out[rel] = sorted(rows)
    return out


def _stats(s) -> tuple:
    return (s.num_rows, s.partitions)


def _read(session, kind: str, path: str):
    return {"parquet": session.read_parquet, "orc": session.read_orc,
            "csv": session.read_csv}[kind](path)


def _assert_same_write(pdir: str, jdir: str, kind: str, pstats,
                       jstats) -> None:
    """The port's tree against the JAX tree (module docstring)."""
    assert os.path.exists(os.path.join(pdir, "_SUCCESS"))
    assert os.path.exists(os.path.join(jdir, "_SUCCESS"))
    assert _tree(pdir) == _tree(jdir)
    assert _stats(pstats) == _stats(jstats)
    port_of_jax = _read(_port(), kind, jdir).collect()
    jax_of_port = _read(TpuSession(), kind, pdir).collect()
    port_of_port = _read(_port(), kind, pdir).collect()
    assert port_of_jax.column_names == jax_of_port.column_names \
        == port_of_port.column_names
    assert _multiset(port_of_jax) == _multiset(jax_of_port) \
        == _multiset(port_of_port)


def _both(tmp_path, table: pa.Table, kind: str, partition_by=(),
          name: str = "out"):
    pdir, jdir = str(tmp_path / f"port-{name}"), str(tmp_path / f"jax-{name}")
    pw = _port().create_dataframe(table).write.partition_by(*partition_by)
    jw = TpuSession().create_dataframe(table).write.partition_by(
        *partition_by)
    return pdir, jdir, getattr(pw, kind)(pdir), getattr(jw, kind)(jdir)


def test_parquet_round_trip(tmp_path):
    t = _sample_table()
    pdir, jdir, ps, js = _both(tmp_path, t, "parquet")
    assert ps.num_rows == t.num_rows and ps.num_files == js.num_files == 1
    assert ps.num_bytes > 0
    _assert_same_write(pdir, jdir, "parquet", ps, js)
    assert _multiset(_port().read_parquet(pdir).collect()) == _multiset(t)


def test_csv_round_trip(tmp_path):
    t = pa.table({"i": pa.array([1, 2, 3], pa.int64()),
                  "f": pa.array([0.5, 1.5, -2.0], pa.float64())})
    pdir, jdir, ps, js = _both(tmp_path, t, "csv")
    _assert_same_write(pdir, jdir, "csv", ps, js)
    assert _multiset(_port().read_csv(pdir).collect()) == _multiset(t)


def test_write_query_result_multi_partition(tmp_path):
    """A query over a three-file scan, one task a file: one part file a
    scan partition."""
    src = tmp_path / "src"
    os.makedirs(src)
    tables = []
    for i in range(3):
        t = _sample_table(50, seed=i)
        pq.write_table(t, str(src / f"f{i}.parquet"))
        tables.append(t)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    ps = (_port(**{C.TASK_TARGET_BYTES: 1}).read_parquet(str(src))
          .where(col("i") >= col("i")).write_parquet(pdir))
    with _JaxConf(**{C.TASK_TARGET_BYTES: 1}):
        js = (TpuSession().read_parquet(str(src))
              .where(jcol("i") >= jcol("i")).write_parquet(jdir))
    assert ps.num_files == js.num_files == 3
    assert ps.num_rows == 150
    _assert_same_write(pdir, jdir, "parquet", ps, js)
    assert _multiset(_port().read_parquet(pdir).collect()) == \
        _multiset(pa.concat_tables(tables))


def test_save_modes(tmp_path):
    t = pa.table({"x": pa.array([1, 2], pa.int64())})
    seen = {}
    for name, session in (("port", _port()), ("jax", TpuSession())):
        df = session.create_dataframe(t)
        p = str(tmp_path / name)
        steps = [df.write_parquet(p).num_rows]
        with pytest.raises(FileExistsError):
            df.write_parquet(p)
        steps.append(df.write.mode("ignore").parquet(p))
        steps.append(df.write.mode("append").parquet(p).num_rows)
        steps.append(session.read_parquet(p).collect().num_rows)
        steps.append(df.write.mode("overwrite").parquet(p).num_rows)
        steps.append(session.read_parquet(p).collect().num_rows)
        seen[name] = steps
    assert seen["port"] == seen["jax"] == [2, None, 2, 4, 2, 2]
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="save mode"):
        _port().create_dataframe(t).write.mode("bogus").parquet(
            str(tmp_path / "port"))


def test_partitioned_write_and_discovery(tmp_path):
    t = pa.table({
        "k": pa.array([1, 1, 2, 2, 3], pa.int64()),
        "name": pa.array(["a", "b", "a", "c", None], pa.string()),
        "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0], pa.float64()),
    })
    pdir, jdir, ps, js = _both(tmp_path, t, "parquet", ["k"])
    assert ps.partitions == 3
    assert sorted(os.listdir(pdir)) == ["_SUCCESS", "k=1", "k=2", "k=3"]
    _assert_same_write(pdir, jdir, "parquet", ps, js)
    s = _port()
    back = s.read_parquet(pdir).collect()
    assert back.schema.names[-1] == "k"
    assert back.schema.field("k").type == pa.int64()
    # the CPU engine reads the same partitioned relation
    assert _multiset(execute_cpu(s.read_parquet(pdir)._plan)) == \
        _multiset(back) == _multiset(jexecute_cpu(
            TpuSession().read_parquet(pdir)._plan))
    agg = (s.read_parquet(pdir).group_by(col("k"))
           .agg((sum_(col("v")), "sv")).collect().to_pydict())
    jagg = (TpuSession().read_parquet(pdir).group_by(jcol("k"))
            .agg((jsum(jcol("v")), "sv")).collect().to_pydict())
    assert dict(zip(agg["k"], agg["sv"])) == dict(zip(jagg["k"],
                                                      jagg["sv"])) \
        == {1: 3.0, 2: 7.0, 3: 5.0}
    only_k = s.read_parquet(pdir, columns=["k"]).collect()
    assert only_k.column_names == ["k"]
    assert sorted(only_k.to_pydict()["k"]) == sorted(
        TpuSession().read_parquet(pdir, columns=["k"]).collect()
        .to_pydict()["k"]) == [1, 1, 2, 2, 3]


def test_partitioned_write_null_and_string_values(tmp_path):
    t = pa.table({
        "cat": pa.array(["x/y", None, "plain"], pa.string()),
        "v": pa.array([1, 2, 3], pa.int64()),
    })
    pdir, jdir, ps, js = _both(tmp_path, t, "parquet", ["cat"])
    assert sorted(os.listdir(pdir)) == [
        "_SUCCESS", "cat=__HIVE_DEFAULT_PARTITION__", "cat=plain",
        "cat=x%2Fy"]
    _assert_same_write(pdir, jdir, "parquet", ps, js)
    back = _port().read_parquet(pdir).collect().to_pydict()
    assert sorted(zip(back["v"], back["cat"]), key=lambda x: x[0]) == [
        (1, "x/y"), (2, None), (3, "plain")]


def test_empty_write_round_trip(tmp_path):
    t = pa.table({"x": pa.array([], pa.float64())})
    pdir, jdir, ps, js = _both(tmp_path, t, "parquet")
    assert ps.num_files == js.num_files == 1
    _assert_same_write(pdir, jdir, "parquet", ps, js)
    back = _port().read_parquet(pdir).collect()
    assert back.num_rows == 0 and back.schema.names == ["x"]


def test_csv_partitioned_round_trip(tmp_path):
    t = pa.table({"k": pa.array([1, 1, 2], pa.int64()),
                  "v": pa.array([1.5, 2.5, 3.5], pa.float64())})
    pdir, jdir, ps, js = _both(tmp_path, t, "csv", ["k"])
    _assert_same_write(pdir, jdir, "csv", ps, js)
    s = _port()
    back = s.read_csv(pdir).collect()
    assert sorted(zip(back.to_pydict()["v"], back.to_pydict()["k"])) == [
        (1.5, 1), (2.5, 1), (3.5, 2)]
    assert _multiset(execute_cpu(s.read_csv(pdir)._plan)) == _multiset(back)


def test_partitioned_write_nan_value(tmp_path):
    t = pa.table({"k": pa.array([1.0, float("nan"), 2.0], pa.float64()),
                  "v": pa.array([1, 2, 3], pa.int64())})
    pdir, jdir, ps, js = _both(tmp_path, t, "parquet", ["k"])
    assert ps.num_rows == 3
    _assert_same_write(pdir, jdir, "parquet", ps, js)
    back = _port().read_parquet(pdir).collect().to_pydict()
    assert sorted(back["v"]) == [1, 2, 3]
    assert math.isnan(float(dict(zip(back["v"], back["k"]))[2]))


def test_orc_write_read_back(tmp_path):
    rng = np.random.default_rng(6)
    t = pa.table({"i": pa.array(rng.integers(-500, 500, 300), pa.int64()),
                  "f": pa.array(rng.random(300))})
    pdir, jdir, ps, js = _both(tmp_path, t, "orc")
    assert ps.num_rows == 300 and ps.num_files >= 1
    _assert_same_write(pdir, jdir, "orc", ps, js)
    assert _multiset(_port().read_orc(pdir).collect()) == _multiset(t)


def test_orc_partitioned_write_and_prune(tmp_path):
    t = pa.table({"k": pa.array([1, 1, 2, 3], pa.int64()),
                  "v": pa.array([1.0, 2.0, 3.0, 4.0])})
    pdir, jdir, ps, js = _both(tmp_path, t, "orc", ["k"])
    _assert_same_write(pdir, jdir, "orc", ps, js)
    s = _port()
    df = s.read_orc(pdir).where(col("k").eq(lit(2)))
    plan = df.physical_plan()
    got = collect_exec(plan, s.conf)
    scan = next(n for n in plan.walk() if isinstance(n, OrcScanExec))
    jdf = TpuSession().read_orc(jdir).where(jcol("k").eq(jlit(2)))
    jex, _ = jplan_query(jdf._plan, get_conf())
    jgot = jcollect(jex)
    jscan = next(n for n in jex._walk() if isinstance(n, JOrcScan))
    assert got.to_pydict()["v"] == jgot.to_pydict()["v"] == [3.0]
    assert scan.metrics["filesPruned"] == \
        jscan.metrics["filesPruned"].value == 2


EDGE = pa.table({
    "d": pa.array([0.0, -0.0, float("nan"), 1.5, None, -0.0, float("nan"),
                   0.0, 1.5, None], pa.float64()),
    "s": pa.array(["a/b", "k=v", "50%", None, "a/b", "plain", "k=v",
                   "50%", None, "x"], pa.string()),
    "v": pa.array(np.arange(10), pa.int64()),
})


def _vs(root: str) -> dict:
    """Relative directory -> the sorted ``v`` of its rows."""
    out: dict = {}
    for d, _dirs, names in os.walk(root):
        vs = [v for n in names if n.endswith(".parquet")
              for v in pq.ParquetFile(os.path.join(d, n)).read()
              .column("v").to_pylist()]
        if vs:
            out[os.path.relpath(d, root)] = sorted(vs)
    return out


@pytest.mark.parametrize("part", [["s"], ["d"], ["s", "d"]])
def test_card_split_edge_values_against_the_jax_writer(tmp_path, part):
    pdir, jdir, ps, js = _both(tmp_path, EDGE, "parquet", part)
    hdir = str(tmp_path / "port-host")
    session = _port()
    df = session.create_dataframe(EDGE)
    hs = df._run_command(lambda tree, runtime: W.ParquetWriteExec(
        hdir, tree, part, runtime=runtime, host_split=True))
    # the host loop splits as the device split does
    assert _tree(hdir) == _tree(pdir) and _stats(hs) == _stats(ps)
    assert _stats(ps) == _stats(js)
    pvs, jvs = _vs(pdir), _vs(jdir)
    # each row once, under its own values; -0.0 under 0.0
    assert sorted(v for vs in pvs.values() for v in vs) == list(range(10))
    d = EDGE.column("d").to_pylist()
    s = EDGE.column("s").to_pylist()
    for rel, vs in pvs.items():
        for v in vs:
            want = {"s": W._part_str(s[v]),
                    "d": W._part_str(None if d[v] is None else d[v] + 0.0)}
            assert rel == "/".join(f"{c}={want[c]}" for c in part)
    # the JAX tree: the same directories (its zero one named by the
    # first zero's sign), each zero row there once per sign of zero
    assert {r.replace("d=-0.0", "d=0.0") for r in jvs} == set(pvs)
    for rel, vs in jvs.items():
        mine = pvs[rel.replace("d=-0.0", "d=0.0")]
        signs = len({math.copysign(1, d[v]) for v in mine
                     if d[v] == 0}) if "d=" in rel else 0
        assert vs == sorted(mine * max(signs, 1)), rel


from torch_quiet import quiet_ladder  # noqa: E402,F401
