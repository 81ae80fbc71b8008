"""The PyTorch port on its own: package isolation, the device rule,
Arrow conversion, expression semantics, the aggregate exec, and (on a
card only) K1 against its plain version.

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port.py -m cuda
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu_torch import TorchSession, avg, col, count_star, lit
from spark_rapids_tpu_torch import sum_
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.exprs.base import EvalContext, bind_references
from spark_rapids_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = REPO / "spark_rapids_tpu_torch"


def _port_modules():
    for p in sorted(PORT_DIR.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = list(_port_modules())
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'bench'\n"
        "             or m == 'spark_rapids_tpu'\n"
        "             or m.startswith('spark_rapids_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) >= 20
    # the grouping-set and union slice's modules are among them, and the
    # SQL slice's
    assert {"spark_rapids_tpu_torch.execs.expand",
            "spark_rapids_tpu_torch.exprs.cast",
            "spark_rapids_tpu_torch.execs.basic",
            "spark_rapids_tpu_torch.io.scan",
            "spark_rapids_tpu_torch.frontends.sql",
            "spark_rapids_tpu_torch.exprs.strings",
            "spark_rapids_tpu_torch.exprs.datetime",
            "spark_rapids_tpu_torch.exprs.math",
            "spark_rapids_tpu_torch.exprs.subquery",
            "spark_rapids_tpu_torch.tpcds_queries"} <= set(mods)


def test_port_sources_name_no_jax_import():
    files = sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "bench",
                                    "spark_rapids_tpu"), (f, n)


def test_session_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default session is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession(device="cuda")
    assert TorchSession(device="cpu").device.type == "cpu"


def test_unlowerable_plan_raises():
    from spark_rapids_tpu_torch.plan.logical import LogicalPlan
    from spark_rapids_tpu_torch.plan.planner import Planner

    class Sort(LogicalPlan):
        children = []

    s = TorchSession(device="cpu")
    with pytest.raises(NotImplementedError):
        Planner(s.conf, s.device, s.shuffle_manager).plan(Sort())


def test_unknown_conf_key_raises():
    with pytest.raises(KeyError):
        TorchSession({"spark.rapids.tpu.sql.nope": 1}, device="cpu")


def _table():
    return pa.table({
        "i": pa.array([1, None, -3, 4, 5], pa.int32()),
        "l": pa.array([10, 20, None, -(1 << 40), 7], pa.int64()),
        "d": pa.array([0.5, float("nan"), None, -0.0, 1e300], pa.float64()),
        "b": pa.array([True, False, None, True, False], pa.bool_()),
        "dt": pa.array([0, 19000, None, 3, 4], pa.int32()).cast(pa.date32()),
        "s": pa.array(["", "ab", None, "ünïcode", "x" * 33], pa.string()),
    })


def test_arrow_round_trip_keeps_values_and_nulls():
    t = _table()
    b = from_arrow(t, torch.device("cpu"))
    assert b.schema.names == t.schema.names
    assert b.columns[5].chars.shape == (5, 33)
    back = to_arrow(b)
    assert back.schema.types == t.schema.types
    # 64-bit types never narrow
    assert b.columns[1].data.dtype == torch.int64
    assert b.columns[2].data.dtype == torch.float64
    for name in t.schema.names:
        want = t[name].to_pylist()
        got = back[name].to_pylist()
        if name == "d":
            assert np.isnan(got[1]) and got[:1] + got[2:] == \
                want[:1] + want[2:]
        else:
            assert got == want, name


def test_dictionary_strings_carry_codes(tmp_path):
    t = pa.table({"s": pa.array(["b", "a", None, "b", "ccc"])})
    pq.write_table(t, tmp_path / "f.parquet")
    rb = pq.ParquetFile(tmp_path / "f.parquet",
                        read_dictionary=["s"]).read()
    b = from_arrow(rb, torch.device("cpu"))
    c = b.columns[0]
    assert c.codes is not None and c.dict_chars.shape[0] == 3
    assert to_arrow(b)["s"].to_pylist() == t["s"].to_pylist()
    # bytes past each row's length are zero, as the JAX layout
    assert c.chars[1, 1:].tolist() == [0, 0]


def _eval(expr, table):
    b = from_arrow(table, torch.device("cpu"))
    out = bind_references(expr, b.schema).eval(EvalContext.for_batch(b))
    return [bool(v) if ok else None
            for v, ok in zip(out.data.tolist(), out.validity.tolist())]


def test_kleene_logic_and_null_comparisons():
    t = pa.table({"a": pa.array([1, 1, None, None, 5], pa.int64()),
                  "b": pa.array([2, None, 2, None, 1], pa.int64())})
    assert _eval(col("a") < col("b"), t) == [True, None, None, None, False]
    lt = col("a") < lit(3)  # T T N N F
    gt = col("b") > lit(1)  # T N T N F
    assert _eval(lt & gt, t) == [True, None, None, None, False]
    assert _eval(lt | gt, t) == [True, True, True, None, False]
    assert _eval(~lt, t) == [False, False, None, None, True]


def test_nan_is_greatest_and_equal_to_itself():
    t = pa.table({"x": pa.array([float("nan"), 1.0, float("inf")])})
    assert _eval(col("x").eq(lit(float("nan"))), t) == [True, False, False]
    assert _eval(col("x") > lit(1e308), t) == [True, False, True]


def test_int_column_compares_with_long_literal():
    t = pa.table({"x": pa.array([1, 2, 3], pa.int32())})
    assert _eval(col("x") <= lit(2), t) == [True, True, False]


def test_divide_by_zero_is_null():
    from spark_rapids_tpu_torch.exprs.arithmetic import Divide

    t = pa.table({"a": pa.array([1.0, 2.0]), "b": pa.array([0.0, 4.0])})
    b = from_arrow(t, torch.device("cpu"))
    out = bind_references(Divide(col("a"), col("b")), b.schema).eval(
        EvalContext.for_batch(b))
    assert out.validity.tolist() == [False, True]
    assert out.data[1].item() == 0.5


def _write(tmp_path, tables):
    paths = []
    for i, t in enumerate(tables):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(t, p)
        paths.append(p)
    return paths


def test_grand_aggregate_of_filtered_out_input(tmp_path):
    paths = _write(tmp_path, [pa.table({"x": pa.array([1.0, 2.0])})] * 2)
    s = TorchSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1},
                     device="cpu")
    df = s.read_parquet(*paths).where(col("x") > lit(5.0))
    out = df.agg((sum_(col("x")), "s"), (count_star(), "n"),
                 (avg(col("x")), "a")).collect()
    assert out.to_pylist() == [{"s": None, "n": 0, "a": None}]
    grouped = df.group_by(col("x")).agg((count_star(), "n")).collect()
    assert grouped.num_rows == 0 and grouped.schema.names == ["x", "n"]


def test_count_star_only_and_select(tmp_path):
    t = pa.table({"k": pa.array(["a", "b", "a", None]),
                  "v": pa.array([1, 2, 3, 4], pa.int64())})
    paths = _write(tmp_path, [t, t, t])
    s = TorchSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1,
                      "spark.rapids.tpu.sql.shuffle.partitions": 3},
                     device="cpu")
    assert s.read_parquet(*paths).agg(
        (count_star(), "n")).collect().to_pylist() == [{"n": 12}]
    out = (s.read_parquet(*paths)
           .select(col("k"), (col("v") * lit(2)).alias("w"))
           .group_by(col("k"))
           .agg((sum_(col("w")), "sw"), (count_star(), "n"))
           .collect())
    rows = sorted(out.to_pylist(),
                  key=lambda r: (r["k"] is None, r["k"] or ""))
    assert rows == [{"k": "a", "sw": 24, "n": 6}, {"k": "b", "sw": 12, "n": 3},
                    {"k": None, "sw": 24, "n": 3}]
    assert out.schema.field("sw").type == pa.int64()


# --------------------------------------------------------------------- #
# On the card only
# --------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 4, 5, 33, 200])
def test_k1_kernel_matches_plain_version(cuda, width):
    g = torch.Generator(device=cuda)
    g.manual_seed(width)
    n = 4099
    chars = torch.randint(0, 256, (n, width), generator=g, device=cuda,
                          dtype=torch.int32).to(torch.uint8)
    lengths = torch.randint(0, width + 1, (n,), generator=g, device=cuda,
                            dtype=torch.int32)
    chars *= torch.arange(width, device=cuda)[None, :] < lengths[:, None]
    seeds = torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                          device=cuda, dtype=torch.int64).to(torch.int32)
    before = kernels.hash_string.launches
    got = kernels.hash_string(chars, lengths, seeds)
    torch.cuda.synchronize()
    assert kernels.hash_string.launches == before + 1
    assert torch.equal(got, kernels.hash_string_bytes_reference(
        chars, lengths, seeds))


def _random_column(kind, n, g, offset=0):
    """A random column with 20 % NULLs; doubles hold -0.0, 0.0 and NaNs
    with several payloads.  ``offset`` rows are cut off the front of
    every tensor, so its data_ptr() is not aligned."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import Column, StringColumn

    dev, m = g.device, n + offset
    valid = (torch.rand(m, generator=g, device=dev) >= 0.2)[offset:]
    if kind.startswith("s"):
        width = int(kind[1:])
        chars = torch.randint(0, 256, (m, width), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        lengths = torch.randint(0, width + 1, (m,), generator=g, device=dev,
                                dtype=torch.int32)
        chars *= torch.arange(width, device=dev)[None, :] < lengths[:, None]
        return StringColumn(chars[offset:], lengths[offset:], valid)
    if kind == "d":
        x = torch.randn(m, generator=g, device=dev, dtype=torch.float64)
        x[::7] = -0.0
        x[1::11] = 0.0
        x[2::13] = float("nan")
        bits = x.view(torch.int64)
        bits[3::13] = 0x7FF0000000000001
        bits[4::17] = -0x0008000000000000
        return Column(x[offset:], valid, T.DOUBLE)
    if kind == "b":
        data = torch.randint(0, 2, (m,), generator=g, device=dev).bool()
        return Column(data[offset:], valid, T.BOOLEAN)
    if kind == "l":
        data = torch.randint(-(1 << 62), 1 << 62, (m,), generator=g,
                             device=dev, dtype=torch.int64)
        return Column(data[offset:], valid, T.LONG)
    data = torch.randint(-(1 << 31), 1 << 31, (m,), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)
    return Column(data[offset:], valid, T.DATE if kind == "t" else T.INT)


@pytest.mark.cuda
@pytest.mark.parametrize("kinds,offset", [
    (["i", "l", "d", "t", "b", "s3", "s64"], 0),
    (["s16", "l", "d", "s57"], 3),   # row slices: unaligned data_ptr()
    (["s256", "s2", "s128", "s8000"], 1),  # staged, narrow and direct
    (["s1", "i", "l", "d", "s7", "b", "t", "s33", "l", "s4", "d", "i",
      "s1", "b", "s200", "t", "s16"], 0),  # 17 columns: two launches
])
def test_hash_columns_kernel_matches_plain_version(cuda, kinds, offset):
    g = torch.Generator(device=cuda)
    g.manual_seed(len(kinds) + offset)
    n = 4099
    cols = [_random_column(k, n, g, offset) for k in kinds]
    for parts, seed in ((0, 42), (8, 42), (200, 7)):
        before = kernels.hash_columns.launches
        got = kernels.hash_columns(cols, n, cuda, seed, parts)
        torch.cuda.synchronize()
        assert kernels.hash_columns.launches == before + -(-len(kinds) // 16)
        seeds = torch.full((n,), seed, dtype=torch.int32, device=cuda)
        want = kernels.hash_columns_reference(cols, seeds, parts)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_q1_on_the_card_launches_k1(cuda, tmp_path):
    from spark_rapids_tpu_torch import tpch

    paths = tpch.make_lineitem(str(tmp_path), n_files=3, with_q1_cols=True,
                               rows_per_file=4096)
    ttb = {"spark.rapids.tpu.sql.scan.taskTargetBytes": 1}
    kernels.hash_columns.launches = 0
    kernels.hash_string.launches = 0
    gpu = tpch.q1_dataframe(TorchSession(ttb), paths).collect()
    # one launch per map batch hashes its whole key tuple
    assert kernels.hash_columns.launches == 3
    assert kernels.hash_string.launches == 0
    cpu = tpch.q1_dataframe(TorchSession(ttb, device="cpu"),
                            paths).collect()
    key = lambda r: (r["l_returnflag"], r["l_linestatus"])  # noqa: E731
    for g, c in zip(sorted(gpu.to_pylist(), key=key),
                    sorted(cpu.to_pylist(), key=key)):
        assert key(g) == key(c) and g["count_order"] == c["count_order"]
        for k in ("sum_qty", "sum_charge", "avg_disc"):
            assert g[k] == pytest.approx(c[k], rel=1e-12)


@pytest.mark.cuda
def test_k1_from_eight_threads_counts_every_launch(cuda):
    """Pool threads launch K1 at once: every launch is counted, and each
    thread's hashes equal the plain version's."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.execs.base import run_tasks

    g = torch.Generator(device=cuda)
    g.manual_seed(8)
    n = 70_000
    keys = Column(torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                                device=cuda),
                  torch.rand(n, generator=g, device=cuda) > 0.1, T.LONG)
    seeds = torch.full((n,), 42, dtype=torch.int32, device=cuda)
    want = kernels.hash_columns_reference([keys], seeds, 8)
    kernels.hash_columns.launches = 0

    def task(i):
        outs = [kernels.hash_columns([keys], n, cuda, 42, 8)
                for _ in range(50)]
        torch.cuda.synchronize()
        return all(torch.equal(o, want) for o in outs)

    assert all(run_tasks(task, 8, 8))
    assert kernels.hash_columns.launches == 400


def _map_batches(plan) -> int:
    """Non-empty batches the plan's hash exchanges hash: each exchange's
    child drained on its own (a range exchange hashes nothing)."""
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.ops.partition import HashPartitioning

    n = 0
    for ex in plan.walk():
        if isinstance(ex, TpuShuffleExchangeExec) and isinstance(
                ex.partitioning, HashPartitioning):
            child = ex.children[0]
            n += sum(1 for p in range(child.num_partitions)
                     for b in child.execute_partition(p) if b.num_rows)
    for node in plan.walk():
        if hasattr(node, "close"):
            node.close()
    return n


@pytest.mark.cuda
def test_q3_on_the_card_launches_k1_per_map_batch(cuda, tmp_path):
    from spark_rapids_tpu_torch import tpch

    paths = tpch.make_lineitem(str(tmp_path), n_files=3, with_orderkey=True,
                               n_orders=2048, rows_per_file=4096)
    orders = tpch.make_orders(str(tmp_path), n_orders=2048)
    # the shuffled shape, with no runtime filter: these orders would
    # broadcast, and their keys would add two filter lanes
    ttb = {"spark.rapids.tpu.sql.scan.taskTargetBytes": 1,
           "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes": -1,
           "spark.rapids.tpu.sql.runtimeFilter.enabled": False}
    session = TorchSession(ttb)
    planned = _map_batches(tpch.q3_dataframe(session, paths,
                                             orders).physical_plan())
    assert planned == 3 + 1 + 8  # lineitem files, orders, partials
    kernels.hash_columns.launches = 0
    kernels.hash_string.launches = 0
    gpu = tpch.q3_dataframe(session, paths, orders).collect()
    assert kernels.hash_columns.launches == planned
    assert kernels.hash_string.launches == 0
    cpu = tpch.q3_dataframe(TorchSession(ttb, device="cpu"), paths,
                            orders).collect()
    assert gpu.num_rows == cpu.num_rows == 10
    for g, c in zip(gpu.to_pylist(), cpu.to_pylist()):
        assert [g[k] for k in ("l_orderkey", "o_orderdate",
                               "o_shippriority")] == \
            [c[k] for k in ("l_orderkey", "o_orderdate", "o_shippriority")]
        assert g["revenue"] == pytest.approx(c["revenue"], rel=1e-12)


@pytest.mark.cuda
def test_q67_on_the_card_launches_k1_per_hash_map_batch(cuda, tmp_path):
    from spark_rapids_tpu_torch import tpcds

    paths = tpcds.make_store_sales(str(tmp_path), n_rows=3 * 4096,
                                   n_files=3)
    ttb = {"spark.rapids.tpu.sql.scan.taskTargetBytes": 1}
    session = TorchSession(ttb)
    planned = _map_batches(tpcds.q67_dataframe(session,
                                               paths).physical_plan())
    assert planned == 3 + 8  # scan tasks' partials, final partitions
    kernels.hash_columns.launches = 0
    kernels.hash_string.launches = 0
    gpu = tpcds.q67_dataframe(session, paths).collect()
    assert kernels.hash_columns.launches == planned
    assert kernels.hash_string.launches == 0
    cpu = tpcds.q67_dataframe(TorchSession(ttb, device="cpu"),
                              paths).collect()
    assert gpu.num_rows == cpu.num_rows >= 80
    keys = ("ss_store_sk", "ss_item_sk", "rk")
    for g, c in zip(gpu.to_pylist(), cpu.to_pylist()):
        assert [g[k] for k in keys] == [c[k] for k in keys]
        assert g["sumsales"] == pytest.approx(c["sumsales"], rel=1e-12)


@pytest.mark.cuda
def test_q3ds_on_the_card_builds_its_filter_with_k1(cuda, tmp_path):
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.plan import runtime_filter as RF

    dd, ss, item = tpcds.write_q3_tables(str(tmp_path), n_files=2,
                                         rows_per_file=1 << 14)
    ttb = {"spark.rapids.tpu.sql.scan.taskTargetBytes": 1}
    calls = []
    real = kernels.hash_columns

    def recording(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append((list(cols), num_rows, seed, num_partitions))
        return real(cols, num_rows, device, seed, num_partitions)

    kernels.hash_columns = recording
    try:
        plan = tpcds.q3_dataframe(TorchSession(ttb), dd, ss,
                                  item).physical_plan()
        real.launches = 0
        gpu = list(plan.execute())
    finally:
        kernels.hash_columns = real
    [rf] = RF.plan_runtime_filters(plan)
    assert rf.ready and rf.n_keys == 6000  # November of 200 years
    # the two lanes over the build keys, then over the key range for the
    # range table
    lanes = [c for c in calls if c[3] == 0]
    assert [c[2] for c in lanes] == [RF.BLOOM_SEED1, RF.BLOOM_SEED2] * 2
    span = rf.max_val - rf.min_val + 1
    assert [c[1] for c in lanes] == [6000, 6000, span, span]
    # the card's range table gives the numpy lanes' answers
    direct = RF.RuntimeFilter("k", rf.dtype, "inner", rf.n_bits,
                              rf.n_hashes)
    direct.publish(rf.min_val, rf.max_val, rf.n_keys, rf.bloom_words, 0.0)
    keys = np.arange(rf.min_val, rf.max_val + 1, dtype=np.int64)
    np.testing.assert_array_equal(rf.range_table[1:-1],
                                  direct.probe_host(keys))
    # one launch a call: the lanes, then each map batch's partition ids
    assert real.launches == len(calls)
    assert 1 <= sum(1 for c in calls if c[3] == 8) <= 2
    for cols, n, seed, _ in lanes:
        assert cols[0].validity.is_cuda
        seeds = torch.full((n,), seed - (1 << 32) if seed >= 1 << 31
                           else seed, dtype=torch.int32, device=cuda)
        assert torch.equal(real(cols, n, cuda, seed),
                           kernels.hash_columns_reference(cols, seeds))
    cpu = tpcds.q3_dataframe(TorchSession(ttb, device="cpu"), dd, ss,
                             item).collect()
    from spark_rapids_tpu_torch.columnar.arrow import batches_to_arrow

    got = batches_to_arrow(gpu, plan.schema)
    assert got.num_rows == cpu.num_rows > 0
    keys = ("d_year", "i_brand_id", "i_brand")
    for g, c in zip(got.to_pylist(), cpu.to_pylist()):
        assert [g[k] for k in keys] == [c[k] for k in keys]
        assert g["sum_agg"] == pytest.approx(c["sum_agg"], rel=1e-12)


@pytest.mark.cuda
def test_q93_outer_join_on_the_card(cuda, tmp_path):
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.columnar.arrow import batches_to_arrow

    _, ss, _ = tpcds.write_q3_tables(str(tmp_path), n_files=2,
                                     rows_per_file=1 << 15)
    sr, reason = tpcds.write_q93_tables(str(tmp_path), ss)
    # store_returns (~6 500 rows) shuffles, the reason row broadcasts
    conf = {"spark.rapids.tpu.sql.scan.taskTargetBytes": 1,
            "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes": 4096}
    plan = tpcds.q93_dataframe(TorchSession(conf), ss, sr,
                               reason).physical_plan()
    [outer] = [n for n in plan.walk()
               if getattr(n, "join_type", "") == "left_outer"]
    assert outer.partition_wise
    kernels.hash_columns.launches = 0
    got = batches_to_arrow(list(plan.execute()), plan.schema)
    assert kernels.hash_columns.launches >= 3
    cpu = tpcds.q93_dataframe(TorchSession(conf, device="cpu"), ss, sr,
                              reason).collect()
    assert got.num_rows == cpu.num_rows == 100
    for g, c in zip(got.to_pylist(), cpu.to_pylist()):
        assert g["sumsales"] == pytest.approx(c["sumsales"], rel=1e-9)
    assert got.column("ss_customer_sk").to_pylist() == \
        cpu.column("ss_customer_sk").to_pylist()


def _rows_close(got: pa.Table, want: pa.Table) -> None:
    """Rows in order: floats within rel 1e-9, everything else equal."""
    assert got.schema.names == want.schema.names
    assert got.num_rows == want.num_rows
    for g, w in zip(got.to_pylist(), want.to_pylist()):
        for k in g:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=1e-9, nan_ok=True), k
            else:
                assert g[k] == w[k], (k, g, w)


@pytest.mark.cuda
def test_grouping_sets_union_and_value_aggregates_on_the_card(cuda,
                                                             tmp_path):
    """q67 as written (an Expand under the partial aggregate, K1 over
    its 9-column tuple), q5 (a union), and min / max / first / last /
    count_distinct by store, on the card against the CPU."""
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.session import (
        count_distinct,
        first,
        last,
        max_,
        min_,
    )

    d = str(tmp_path)
    dd, ss, item = tpcds.write_q3_tables(d, n_files=2, rows_per_file=1 << 15)
    store = tpcds.write_store(d)
    sr, _ = tpcds.write_q93_tables(d, ss)

    def run(device):
        s = TorchSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1},
                         device=device)
        sales = s.read_parquet(*ss)
        by_store = sales.group_by(col("ss_store_sk"))
        return {
            "q67": tpcds.q67_rollup_dataframe(s, dd, ss, item, store),
            "q5": tpcds.q5_dataframe(s, dd, ss, sr, store),
            "values": by_store.agg(
                (min_(col("ss_sales_price")), "a"),
                (max_(col("ss_net_profit")), "b"),
                (first(col("ss_customer_sk")), "c"),
                (last(col("ss_sold_date_sk"), True), "d")).order_by(
                col("ss_store_sk")),
            "distinct": by_store.agg((count_distinct(
                col("ss_customer_sk")), "n")).order_by(col("ss_store_sk")),
        }

    kernels.hash_columns.launches = 0
    got = {k: df.collect() for k, df in run("cuda").items()}
    assert kernels.hash_columns.launches > 0
    for k, df in run("cpu").items():
        _rows_close(got[k], df.collect())
    assert got["q67"].num_rows == 100 and got["q5"].num_rows == 12


@pytest.mark.cuda
def test_sql_texts_and_new_expressions_on_the_card(cuda, tmp_path):
    """Store-channel TPC-DS texts through the SQL frontend (string, date
    and math functions, the scalar subquery of q24's variant) on the
    card against the CPU, over the 13 tables at a small size."""
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.tpcds_queries import QUERIES, variant

    paths = tpcds.write_store_channel(str(tmp_path), n_files=2,
                                      rows_per_file=1 << 15)
    texts = [QUERIES[q] for q in (7, 13, 46, 59, 79, 93)] + [
        variant(24), variant(84),
        "select upper(s_city) u, lower(s_state) l, substr(s_store_name, 2) "
        "s, concat(s_city, ', ', s_state) c, trim(s_street_name) t, "
        "length(s_county) n, year(d_date) y, month(d_date) m, "
        "d_date + interval '1' month dm, round(s_tax_precentage * 100, 1) "
        "r, pmod(s_store_sk - 7, 5) p, s_store_sk % 4 md, "
        "greatest(s_store_sk, 3) g, cast(s_store_sk as string) cs "
        "from store, date_dim where s_closed_date_sk is null "
        "and d_date_sk = 2451545 + s_store_sk and s_city like 'F%' "
        "order by cs"]

    def run(device):
        fe = SqlSession({"spark.rapids.tpu.sql.scan.taskTargetBytes": 1},
                        device=device)
        for name, ps in paths.items():
            fe.register_parquet(name, *ps)
        return [fe.sql(t).collect() for t in texts]

    kernels.hash_columns.launches = 0
    got = run("cuda")
    assert kernels.hash_columns.launches > 0
    for g, w in zip(got, run("cpu")):
        _rows_close(g, w)


def test_exchange_reads_blocks_concatenated_in_map_order():
    """A reduce partition yields its blocks concatenated in map-task
    order, in batches of at most ``batch_rows`` rows (one block larger
    than that alone): a chain of partition-wise joins keeps one batch a
    partition instead of multiplying blocks at every exchange."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.exprs.base import BoundReference
    from spark_rapids_tpu_torch.io.scan import ArrowSourceExec
    from spark_rapids_tpu_torch.ops.partition import HashPartitioning
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

    t = pa.table({"k": pa.array(np.arange(1000) % 7, pa.int64()),
                  "v": pa.array(np.arange(1000), pa.int64())})
    src = ArrowSourceExec(t, T.Schema([T.Field("k", T.LONG),
                                       T.Field("v", T.LONG)]),
                          torch.device("cpu"), 64)
    key = [BoundReference(0, T.LONG, True, "k")]
    for batch_rows, most in ((1 << 20, 1), (150, 150)):
        ex = TpuShuffleExchangeExec(HashPartitioning(key, 3), src,
                                    ShuffleManager(), batch_rows=batch_rows)
        seen = []
        for p in range(3):
            batches = list(ex.execute_partition(p))
            assert len(batches) <= -(-1000 // batch_rows) + 1
            assert all(b.num_rows <= max(batch_rows, 64) for b in batches)
            v = torch.cat([b.columns[1].data for b in batches]).tolist()
            assert v == sorted(v)  # map-task (and row) order kept
            seen += v
            if batch_rows > 1000:
                assert len(batches) == most
        assert sorted(seen) == list(range(1000))


def test_build_paths_live_in_the_package():
    assert kernels.BUILD_DIR == PORT_DIR / "_build"
    assert kernels.library_path("hash_string").parent == kernels.BUILD_DIR
    assert (PORT_DIR / "csrc" / "hash_string.cu").exists()
    assert os.path.basename(kernels.library_path("hash_string")).startswith(
        "hash_string-")
