"""Partition-context expressions in the port against the JAX package.

``spark_partition_id()``, ``monotonically_increasing_id()``,
``rand(seed)`` and the input-file expressions run through the port's
``TorchSession(device="cpu")`` and the JAX package's ``TpuSession`` on
its device engine (the JAX CPU backend) and, where the JAX test does,
its CPU engine: integers, strings and NULLs exact, ``rand`` bit for bit
(doubles compared by their bit patterns, no tolerance).

- The threefry recipe of ``exprs/nondeterministic.py`` equals
  ``jax.random`` (``PRNGKey``, ``fold_in``, ``uniform``) for seeds,
  partitions and row indices at and above 2^32, on torch tensors and on
  numpy arrays.
- Ids and draws carry the scan task as the partition: the port numbers
  its scan tasks as the JAX planner does for the same files and
  ``scan.taskTargetBytes``, and a partition's row index runs on across
  its batches.
- Above a Filter the port numbers the rows that pass, as Spark does; the
  JAX package numbers a fused chain's input rows, so the two agree when
  each partition is one batch, and the port's ids stay consecutive
  where JAX's jump between batches (ROADMAP section 3).
- A partition-aware expression in a sort key or an aggregate runs on
  the CPU engine, with the JAX reason; ``input_file_name()`` without a
  scan below gives Spark's default ''.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import session as JS
from spark_rapids_tpu.exprs import arithmetic as JA
from spark_rapids_tpu.exprs import nondeterministic as JND
from spark_rapids_tpu.exprs import strings as JSTR
from spark_rapids_tpu.exprs.base import lit as jlit

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import nondeterministic as ND
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.exprs.base import lit
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from test_torch_nested import assert_tables_equal
from torch_quiet import quiet_ladder  # noqa: F401

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
ROWS = "spark.rapids.tpu.sql.batchSizeRows"


def bits(values) -> list:
    """Doubles as their int64 bit patterns: equal means bit for bit."""
    return np.asarray(values, np.float64).view(np.int64).tolist()


def write_files(tmp_path, sizes, row_group_size=None) -> list:
    paths = []
    start = 0
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"x": pa.array(np.arange(start, start + n,
                                                         dtype=np.int64))}),
                       p, row_group_size=row_group_size)
        paths.append(p)
        start += n
    return paths


def sessions(conf: dict):
    port = TorchSession(conf, device="cpu")
    jax_session = JS.TpuSession()
    for k, v in conf.items():
        jax_session.conf.set(k, v)
    return port, jax_session


@pytest.mark.parametrize("seed", [0, 42, 2 ** 32 + 9, 2 ** 62 + 1])
@pytest.mark.parametrize("partition", [0, 3, 2 ** 31 - 1])
def test_threefry_recipe_equals_jax_random(seed, partition):
    idx = np.array([0, 1, 7, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 3,
                    3 * 2 ** 32 + 11, 2 ** 40 + 5], np.int64)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), partition)
    want = []
    for i in idx.tolist():
        k = jax.random.fold_in(jax.random.fold_in(key, i >> 32),
                               i & 0xFFFFFFFF)
        want.append(float(jax.random.uniform(k, dtype=jnp.float64)))
    assert bits(ND.rand_uniform(seed, partition, idx)) == bits(want)
    hi, lo = ND.rand_bits(seed, partition, torch.from_numpy(idx))
    got = ND.uniform_bits(hi, lo).view(torch.float64) - 1.0
    assert bits(got.numpy()) == bits(want)
    jax_fn = JND._rand_uniform(seed, jnp.asarray(partition, jnp.int32),
                               jnp.asarray(idx))
    assert bits(np.asarray(jax_fn)) == bits(want)


def test_rand_folds_a_batch_that_crosses_a_high_word_per_row():
    """A batch whose indices cross 2^32 folds the high word per row;
    one that does not folds it on the host: both equal the recipe."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.base import EvalContext

    n = 16
    b = ColumnarBatch([Column(torch.zeros(n, dtype=torch.int64),
                              torch.ones(n, dtype=torch.bool), T.LONG)], n,
                      T.Schema([T.Field("x", T.LONG)]), torch.device("cpu"))
    for offset in (2 ** 32 - 5, 2 ** 33 + 1):
        got = ND.Rand(7).eval(EvalContext.for_batch(b, 2, offset)).data
        want = ND.rand_uniform(7, 2, np.arange(offset, offset + n))
        assert bits(got.numpy()) == bits(want)


def test_mid_single_partition_matches_both_jax_engines():
    rng = np.random.default_rng(1)
    t = pa.table({"a": pa.array(rng.integers(-2 ** 40, 2 ** 40, 400))})
    port = TorchSession(device="cpu").create_dataframe(t).select(
        PS.col("a"), PS.monotonically_increasing_id().alias("id"))
    assert "!" not in port.explain()
    got = port.collect()
    jq = JS.TpuSession().create_dataframe(t).select(
        JS.col("a"), JS.monotonically_increasing_id().alias("id"))
    assert_tables_equal(got, jq.collect(engine="tpu"), ignore_order=False)
    assert_tables_equal(got, jq.collect(engine="cpu"), ignore_order=False)
    assert got.to_pydict()["id"] == list(range(400))


def test_mid_and_partition_id_over_several_scan_tasks(tmp_path):
    paths = write_files(tmp_path, [100, 130, 70])
    port_s, jax_s = sessions({TTB: 1})

    def build(s, m):
        return s.read_parquet(*paths).select(
            m.col("x"), m.monotonically_increasing_id().alias("id"),
            m.spark_partition_id().alias("p"))

    got = build(port_s, PS).collect()
    assert_tables_equal(got, build(jax_s, JS).collect(engine="tpu"),
                        ignore_order=False)
    d = got.to_pydict()
    by_part: dict = {}
    for i, p in zip(d["id"], d["p"]):
        by_part.setdefault(p, []).append(i)
    assert sorted(by_part) == [0, 1, 2]
    for p, ids in by_part.items():
        assert ids == [(p << 33) + k for k in range(len(ids))]


def test_mid_offset_advances_across_batches(tmp_path):
    (p,) = write_files(tmp_path, [1000], row_group_size=100)
    port_s, jax_s = sessions({ROWS: 128})
    got = port_s.read_parquet(p).select(
        PS.monotonically_increasing_id().alias("id")).collect()
    assert got.to_pydict()["id"] == list(range(1000))
    want = jax_s.read_parquet(p).select(
        JS.monotonically_increasing_id().alias("id")).collect(engine="tpu")
    assert_tables_equal(got, want, ignore_order=False)


def test_rand_deterministic_batch_invariant_and_bit_equal(tmp_path):
    (p,) = write_files(tmp_path, [600], row_group_size=100)
    port_s, jax_s = sessions({})
    q = port_s.read_parquet(p).select(PS.rand(42).alias("r"))
    a = q.collect().to_pydict()["r"]
    assert a == q.collect().to_pydict()["r"]
    assert all(0.0 <= v < 1.0 for v in a) and len(set(a)) > 590
    small = TorchSession({ROWS: 128}, device="cpu").read_parquet(p).select(
        PS.rand(42).alias("r")).collect().to_pydict()["r"]
    assert bits(small) == bits(a)
    jq = jax_s.read_parquet(p).select(JS.rand(42).alias("r"))
    assert bits(jq.collect(engine="tpu").to_pydict()["r"]) == bits(a)
    assert bits(jq.collect(engine="cpu").to_pydict()["r"]) == bits(a)


def test_rand_over_several_scan_tasks_equals_jax(tmp_path):
    paths = write_files(tmp_path, [200, 250, 50, 300], row_group_size=64)
    port_s, jax_s = sessions({TTB: 1, ROWS: 100})

    def build(s, m):
        return s.read_parquet(*paths).select(
            m.col("x"), m.rand(7).alias("r"), m.spark_partition_id()
            .alias("p"), m.monotonically_increasing_id().alias("id"))

    got = build(port_s, PS).collect()
    want = build(jax_s, JS).collect(engine="tpu")
    assert got.column_names == want.column_names
    for c in got.column_names:
        g, w = got.column(c).to_pylist(), want.column(c).to_pylist()
        assert (bits(g) == bits(w)) if c == "r" else g == w, c
    d = got.to_pydict()
    for x, r, p, i in zip(d["x"], d["r"], d["p"], d["id"]):
        assert bits([r]) == bits(ND.rand_uniform(7, p, [i & (2 ** 33 - 1)]))


def test_rand_seed_changes_stream():
    t = pa.table({"a": pa.array(np.arange(100))})
    df = TorchSession(device="cpu").create_dataframe(t)
    a = df.select(PS.rand(1).alias("r")).collect().to_pydict()["r"]
    b = df.select(PS.rand(2).alias("r")).collect().to_pydict()["r"]
    assert a != b


def test_order_by_rand_runs_on_the_cpu_engine():
    t = pa.table({"a": pa.array(np.arange(50))})
    q = TorchSession(device="cpu").create_dataframe(t).order_by(PS.rand(7))
    text = q.explain()
    assert "nondeterministic expression as sort key is only supported " \
        "in project/filter" in text
    assert sum(isinstance(n, CpuFallbackExec)
               for n in q.physical_plan().walk()) == 1
    out = q.collect()
    assert out.num_rows == 50
    jout = JS.TpuSession().create_dataframe(t).order_by(JS.rand(7)).collect()
    assert out.equals(jout)  # both: the CPU engine's partition-0 draws


@pytest.mark.parametrize("where,build,rows", [
    ("grouping key", lambda df: df.group_by(
        PS.spark_partition_id()).agg((PS.count_star(), "n")), 1),
    ("aggregate input", lambda df: df.group_by(PS.col("a")).agg(
        (PS.sum_(PS.rand(1)), "s")), 3),
])
def test_partition_aware_outside_project_filter_runs_on_the_cpu_engine(
        where, build, rows):
    t = pa.table({"a": pa.array([1, 2, 1, 3])})
    q = build(TorchSession(device="cpu").create_dataframe(t))
    assert f"nondeterministic expression as {where}" in q.explain()
    assert q.collect().num_rows == rows


def test_mid_unique_above_explode():
    t = pa.table({"l": pa.array([[1, 2, 3]] * 200, pa.list_(pa.int64()))})
    port_s, jax_s = sessions({ROWS: 64})

    def build(s, m):
        return s.create_dataframe(t).select(m.explode(m.col("l")).alias(
            "e")).select(m.col("e"), m.monotonically_increasing_id()
                         .alias("id"))

    got = build(port_s, PS).collect().to_pydict()["id"]
    assert len(got) == 600 and len(set(got)) == 600
    want = build(jax_s, JS).collect(engine="tpu").to_pydict()["id"]
    assert got == want


def _filtered(s, m, paths):
    rem = (A.Remainder if m is PS else JA.Remainder)(m.col("x"), m.lit(3))
    return s.read_parquet(*paths).where(rem.ne(m.lit(0))).select(
        m.col("x"), m.monotonically_increasing_id().alias("id"),
        m.rand(5).alias("r"), m.spark_partition_id().alias("p"))


def test_mid_and_rand_above_a_filter_one_batch_a_partition(tmp_path):
    """Each scan task one batch: the JAX fused chain's positions (its
    input compacted) are the rows that pass, as the port's are."""
    paths = write_files(tmp_path, [90, 120, 33])
    port_s, jax_s = sessions({TTB: 1})
    got = _filtered(port_s, PS, paths).collect()
    want = _filtered(jax_s, JS, paths).collect(engine="tpu")
    for c in got.column_names:
        g, w = got.column(c).to_pylist(), want.column(c).to_pylist()
        assert (bits(g) == bits(w)) if c == "r" else g == w, c


@pytest.mark.parametrize("prefilter", [True, False])
def test_mid_and_rand_above_a_filter_across_files_and_batches(tmp_path,
                                                              prefilter):
    """Several batches a partition: the port numbers the rows that pass
    consecutively (Spark's numbering); its rand is the recipe at those
    positions.  With the host prefilter on, the scan drops the rows
    before the JAX chain counts them and JAX agrees; with it off, JAX's
    ids jump at each batch by the rows its filter dropped there (logged
    in ROADMAP section 3)."""
    paths = write_files(tmp_path, [300, 500], row_group_size=100)
    conf = {TTB: 1, ROWS: 128,
            "spark.rapids.tpu.sql.scan.hostPrefilter": prefilter}
    port_s, jax_s = sessions(conf)
    d = _filtered(port_s, PS, paths).collect().to_pydict()
    by_part: dict = {}
    for x, i, r, p in zip(d["x"], d["id"], d["r"], d["p"]):
        by_part.setdefault(p, []).append((x, i, r))
    assert sorted(by_part) == [0, 1]
    for p, rows in by_part.items():
        ids = [i for _, i, _ in rows]
        assert ids == [(p << 33) + k for k in range(len(rows))]
        want = ND.rand_uniform(5, p, np.arange(len(rows)))
        assert bits([r for _, _, r in rows]) == bits(want)
    jd = _filtered(jax_s, JS, paths).collect(engine="tpu").to_pydict()
    assert jd["x"] == d["x"]
    if prefilter:
        assert jd["id"] == d["id"] and bits(jd["r"]) == bits(d["r"])
    else:  # JAX's positions count the filter's input
        assert jd["id"] != d["id"] and jd["id"][85] == 128


def test_rand_filter_keeps_the_rows_the_recipe_keeps(tmp_path):
    """rand() in a Filter over a scan: nothing is pushed into the scan,
    the rows kept are those whose draw at their scan position passes."""
    paths = write_files(tmp_path, [400, 350], row_group_size=100)
    port_s, jax_s = sessions({TTB: 1, ROWS: 128})

    def build(s, m):
        return s.read_parquet(*paths).where(m.rand(42) < m.lit(0.3)).select(
            m.col("x"), m.spark_partition_id().alias("p"))

    q = build(port_s, PS)
    assert "pushed=" not in q.explain()
    got = q.collect().to_pydict()
    want = []
    for p, n, base in ((0, 400, 0), (1, 350, 400)):
        keep = ND.rand_uniform(42, p, np.arange(n)) < 0.3
        want += [base + i for i in np.flatnonzero(keep)]
    assert got["x"] == want
    assert build(jax_s, JS).collect(engine="tpu").to_pydict()["x"] == want


def test_input_file_exprs_above_scan(tmp_path):
    rng = np.random.default_rng(3)
    paths, sizes = [], {}
    for i in range(3):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({"v": rng.integers(0, 100, 200 + i)}), p)
        paths.append(p)
        sizes[p] = os.path.getsize(p)
    port_s, jax_s = sessions({TTB: 1})

    def build(s, m, nd):
        return s.read_parquet(*paths).select(
            m.col("v"), nd.InputFileName().alias("fn"),
            nd.InputFileBlockStart().alias("bs"),
            nd.InputFileBlockLength().alias("bl"))

    q = build(port_s, PS, ND)
    assert "!" not in q.explain()
    got = q.collect()
    assert_tables_equal(got, build(jax_s, JS, JND).collect(engine="tpu"),
                        ignore_order=False)
    out = got.to_pydict()
    assert set(out["fn"]) == set(paths) and set(out["bs"]) == {0}
    assert all(bl == sizes[fn] for fn, bl in zip(out["fn"], out["bl"]))
    assert sorted(out["fn"].count(p) for p in paths) == [200, 201, 202]


def test_input_file_name_in_filter(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"part{i}.parquet")
        pq.write_table(pa.table({"v": rng.integers(0, 9, 100)}), p)
        paths.append(p)
    port_s, jax_s = sessions({})

    def build(s, m, strings, litf):
        return s.read_parquet(*paths).where(
            strings.Contains(m.nd.InputFileName(), litf("part1")))

    got = build(port_s, type("M", (), {"nd": ND}), S, lit).collect()
    assert got.num_rows == 100 and got.column_names == ["v"]
    want = build(jax_s, type("M", (), {"nd": JND}), JSTR, jlit).collect(
        engine="tpu")
    assert_tables_equal(got, want, ignore_order=False)


def test_input_file_grouped_after_a_projection(tmp_path):
    """The chip run's sample query, small: the partition and the file
    projected first, then grouped (an exchange over several tasks)."""
    paths = write_files(tmp_path, [120, 80, 60])
    port_s, jax_s = sessions({TTB: 1})

    def build(s, m, nd):
        return s.read_parquet(*paths).where(m.rand(3) < m.lit(0.5)).select(
            m.spark_partition_id().alias("p"),
            nd.InputFileName().alias("f")).group_by(
            m.col("p"), m.col("f")).agg((m.count_star(), "n"))

    q = build(port_s, PS, ND)
    assert not [n for n in q.physical_plan().walk()
                if isinstance(n, CpuFallbackExec)]
    assert_tables_equal(q.collect(), build(jax_s, JS, JND).collect(
        engine="tpu"))


def test_input_file_name_without_scan_runs_on_the_cpu_engine():
    t = pa.table({"v": pa.array([1, 2, 3])})
    q = TorchSession(device="cpu").create_dataframe(t).select(
        PS.col("v"), ND.InputFileName().alias("fn"))
    assert "input_file_name() is only supported directly above a file " \
        "scan" in q.explain()
    assert q.collect().to_pydict()["fn"] == ["", "", ""]
    j = JS.TpuSession().create_dataframe(t).select(
        JS.col("v"), JND.InputFileName().alias("fn"))
    assert j.collect(engine="tpu").to_pydict()["fn"] == ["", "", ""]


def test_nanvl():
    t = pa.table({"a": pa.array([1.0, float("nan"), None, 4.0]),
                  "b": pa.array([9.0, 8.0, 7.0, None])})
    got = TorchSession(device="cpu").create_dataframe(t).select(
        PS.nanvl(PS.col("a"), PS.col("b")).alias("v")).collect()
    assert got.to_pydict()["v"] == [1.0, 8.0, None, 4.0]
    j = JS.TpuSession().create_dataframe(t).select(
        JS.nanvl(JS.col("a"), JS.col("b")).alias("v"))
    assert_tables_equal(got, j.collect(engine="tpu"), ignore_order=False)


def test_cpu_engine_equals_the_jax_cpu_engine():
    """rand (partition 0), the row ids and the partition on both CPU
    engines, bit for bit."""
    from spark_rapids_tpu.cpu.engine import execute_cpu as jexecute

    from spark_rapids_tpu_torch.cpu.engine import execute_cpu

    t = pa.table({"a": pa.array(np.arange(300))})

    def build(s, m):
        return s.create_dataframe(t).select(
            m.rand(11).alias("r"), m.monotonically_increasing_id()
            .alias("id"), m.spark_partition_id().alias("p"))

    got = execute_cpu(build(TorchSession(device="cpu"), PS)._plan)
    want = jexecute(build(JS.TpuSession(), JS)._plan)
    assert bits(got.column("r").to_pylist()) == bits(
        want.column("r").to_pylist())
    assert got.column("id").to_pylist() == want.column("id").to_pylist()
    assert got.column("p").to_pylist() == want.column("p").to_pylist()


def test_input_file_columns_from_a_scan_on_the_cpu_engine(tmp_path):
    """With the Parquet scan's switch off the scan runs on the CPU
    engine, which appends the hidden input-file columns itself."""
    paths = write_files(tmp_path, [40, 25])
    off = {"spark.rapids.tpu.sql.exec.ParquetRelation": False}
    port_s, jax_s = sessions(off)

    def build(s, m, nd):
        return s.read_parquet(*paths).select(
            m.col("x"), nd.InputFileName().alias("fn"),
            nd.InputFileBlockLength().alias("bl"))

    q = build(port_s, PS, ND)
    assert sum(isinstance(n, CpuFallbackExec)
               for n in q.physical_plan().walk()) == 1
    got = q.collect()
    assert_tables_equal(got, build(jax_s, JS, JND).collect(engine="tpu"))
    d = got.to_pydict()
    assert d["fn"] == [paths[0]] * 40 + [paths[1]] * 25
    assert set(d["bl"]) == {os.path.getsize(p) for p in paths}
