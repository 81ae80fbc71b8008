"""The port's pooled engine on the CPU: map tasks, coalesced partitions
and a scan task's files on pools of host threads, the scan's decode and
upload and the result fetch as stages (the default conf), held bit for
bit against the serial run (``config.SERIAL``).

The queries run at the sizes of their own test files, on the port's
generators; those files hold the same queries, under the default (now
pooled) conf, three ways against both JAX engines.  Here each query's
pooled result equals its serial one by ``pyarrow.Table.equals`` (floats
included), with the same K1 calls and runtime filter counts, and no
pool or stage thread outlives a ``collect()``.  Also: one map stage
under eight threads, K1's launch count under eight threads, a failure
in scan task 3, a LIMIT cut short, and the coalesce's reorder window.
"""

from __future__ import annotations

import random
import sys
import threading
import time
import traceback

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu_torch import TorchSession, col, tpcds, tpch
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.execs import exchange as X
from spark_rapids_tpu_torch.execs.base import live_pool_threads, run_tasks
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.io.scan import ParquetScanExec
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.parallel.pipeline import live_stage_threads

TTB = "spark.rapids.tpu.sql.scan.taskTargetBytes"
BCAST = "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes"
RF_ON = "spark.rapids.tpu.sql.runtimeFilter.enabled"
BATCH = "spark.rapids.tpu.sql.batchSizeRows"
ROWS, N_FILES = 4096, 3


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    d = tmp_path_factory.mktemp("conc_tpch")
    q1 = tpch.make_lineitem(str(d), n_files=N_FILES, with_q1_cols=True,
                            rows_per_file=ROWS)
    d3 = tmp_path_factory.mktemp("conc_q3")
    li = tpch.make_lineitem(str(d3), n_files=N_FILES, with_orderkey=True,
                            n_orders=2048, rows_per_file=ROWS)
    return q1, li, tpch.make_orders(str(d3), n_orders=2048)


@pytest.fixture(scope="module")
def store_sales(tmp_path_factory):
    return tpcds.make_store_sales(str(tmp_path_factory.mktemp("conc_q67")),
                                  n_rows=N_FILES * ROWS, n_files=N_FILES)


@pytest.fixture(scope="module")
def star(tmp_path_factory):
    d = tmp_path_factory.mktemp("conc_star")
    dd, ss, item = tpcds.write_q3_tables(str(d), n_files=N_FILES,
                                         rows_per_file=20_000)
    sr, reason = tpcds.write_q93_tables(str(d), ss)
    return dd, ss, item, sr, reason


#: query -> (data fixture, its conf, the DataFrame from (session, data))
QUERIES = {
    "q6": ("lineitem", {}, lambda s, d: tpch.q6_dataframe(s, d[0])),
    "q1": ("lineitem", {}, lambda s, d: tpch.q1_dataframe(s, d[0])),
    "q3_rf_on": ("lineitem", {BCAST: -1},
                 lambda s, d: tpch.q3_dataframe(s, d[1], d[2])),
    "q3_rf_off": ("lineitem", {BCAST: -1, RF_ON: False},
                  lambda s, d: tpch.q3_dataframe(s, d[1], d[2])),
    "q67": ("store_sales", {}, lambda s, d: tpcds.q67_dataframe(s, d)),
    "q3ds": ("star", {}, lambda s, d: tpcds.q3_dataframe(s, *d[:3])),
    "q93": ("star", {BCAST: 4096},
            lambda s, d: tpcds.q93_dataframe(s, d[1], d[3], d[4])),
    "q42": ("star", {}, lambda s, d: tpcds.q42_dataframe(s, *d[:3])),
}


def _no_threads_left():
    deadline = time.monotonic() + 5
    while (live_stage_threads() or live_pool_threads()) and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    return live_stage_threads() == 0 and live_pool_threads() == 0


def _run(make_df, data, conf, monkeypatch):
    """One collect() under ``conf``: the table, the hash_columns calls
    (rows, seed, partitions; sorted: pooled calls come in any order)
    and the runtime filter counts of one more run of the plan."""
    s = TorchSession({TTB: 1, **conf}, device="cpu")
    calls = []
    real = kernels.hash_columns

    def spy(cols, num_rows, device, seed=42, num_partitions=0):
        calls.append((num_rows, seed, num_partitions))
        return real(cols, num_rows, device, seed, num_partitions)

    monkeypatch.setattr(kernels, "hash_columns", spy)
    table = make_df(s, data).collect()
    monkeypatch.setattr(kernels, "hash_columns", real)
    assert _no_threads_left()
    plan = make_df(s, data).physical_plan()
    list(plan.execute())
    scans = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
    counts = [(n.metrics["rfPrunedRows"], n.metrics["rfRowGroupsPruned"],
               n.metrics["numOutputRows"]) for n in scans]
    for n in plan.walk():
        if hasattr(n, "close"):
            n.close()
    assert s.semaphore.usage()["in_use"] == 0
    return table, sorted(calls), counts


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_pooled_run_equals_the_serial_run_bit_for_bit(name, request,
                                                      monkeypatch):
    fixture, conf, make_df = QUERIES[name]
    data = request.getfixturevalue(fixture)
    pooled = _run(make_df, data, conf, monkeypatch)
    serial = _run(make_df, data, {**conf, **C.SERIAL}, monkeypatch)
    assert pooled[0].num_rows > 0
    assert pooled[0].equals(serial[0])
    assert pooled[1] == serial[1]
    assert pooled[2] == serial[2]
    if name in ("q3_rf_on", "q3ds", "q42"):
        assert sum(c[0] for c in pooled[2]) > 0  # the filter pruned


def test_default_conf_pools_everything(lineitem):
    s = TorchSession({TTB: 1}, device="cpu")
    plan = tpch.q1_dataframe(s, lineitem[0]).physical_plan()
    ex = next(n for n in plan.walk() if isinstance(n, TpuShuffleExchangeExec))
    rt = ex.runtime
    assert (rt.task_threads, rt.decode_threads, rt.stage_depth) == (4, 4, 2)
    assert rt.semaphore is s.semaphore and rt.semaphore.permits == 2
    assert all(n.runtime is rt for n in plan.walk()
               if isinstance(n, ParquetScanExec))


def test_map_stage_runs_once_under_eight_threads(lineitem):
    s = TorchSession({TTB: 1}, device="cpu")
    plan = tpch.q1_dataframe(s, lineitem[0]).physical_plan()
    ex = next(n for n in plan.walk() if isinstance(n, TpuShuffleExchangeExec))
    child = ex.children[0]
    pulled = []
    real = child.execute_partition

    def counting(p):
        pulled.append(p)
        time.sleep(0.05)  # hold the stage open while the others arrive
        return real(p)

    child.execute_partition = counting
    barrier = threading.Barrier(8)
    rows = [0] * 8

    def reduce(p):
        barrier.wait(10)
        rows[p] = sum(b.num_rows for b in ex.execute_partition(p))

    threads = [threading.Thread(target=reduce, args=(p,)) for p in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(pulled) == list(range(child.num_partitions))
    direct = sum(b.num_rows for p in range(child.num_partitions)
                 for b in real(p))
    assert sum(rows) == direct > 0
    ex.close()


def test_k1_launch_count_is_exact_under_eight_threads():
    """The wrappers' launch counter (its CUDA path is held on the card
    by test_torch_port.py's cuda cases)."""
    counter = kernels.hash_columns
    saved = counter.launches
    counter.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run_tasks(lambda i: [counter._launched() for _ in range(5000)], 8, 8)
        assert counter.launches == 40_000
    finally:
        sys.setswitchinterval(old)
        counter.launches = saved


def test_first_use_of_a_kernel_from_eight_threads_builds_once(monkeypatch):
    built = []

    def slow_build(name):
        built.append(name)
        time.sleep(0.05)
        return "libc.so.6"  # any loadable library stands in

    monkeypatch.setattr(kernels, "build_library", slow_build)
    try:
        libs = run_tasks(lambda i: kernels.load_library("stand_in"), 8, 8)
    finally:
        kernels._LIBS.pop("stand_in", None)
    assert built == ["stand_in"]
    assert all(lib is libs[0] for lib in libs)


@pytest.mark.parametrize("query", ["q1", "q6"])
def test_failure_in_scan_task_3_surfaces_from_collect(query, lineitem,
                                                      tmp_path):
    paths = list(lineitem[0])
    bad = tmp_path / "corrupt.parquet"
    bad.write_bytes(b"this is not parquet" * 64)
    paths.insert(3, str(bad))
    s = TorchSession({TTB: 1}, device="cpu")
    df = (tpch.q1_dataframe if query == "q1" else tpch.q6_dataframe)(
        s, paths + list(lineitem[0]))
    with pytest.raises(pa.ArrowInvalid):
        df.collect()
    assert _no_threads_left()
    assert s.semaphore.usage()["in_use"] == 0


def test_limit_over_a_pooled_scan_closes_every_stage(lineitem):
    s = TorchSession({TTB: 1, BATCH: 256}, device="cpu")
    df = s.read_parquet(*lineitem[0]).select(col("l_quantity")).limit(10)
    assert df.collect().num_rows == 10
    assert _no_threads_left()
    plan = df.physical_plan()
    it = plan.execute()
    assert next(it).num_rows == 10
    assert live_stage_threads() > 0
    it.close()
    assert _no_threads_left()
    [scan] = [n for n in plan.walk() if isinstance(n, ParquetScanExec)]
    assert scan.metrics["numOutputRows"] < N_FILES * ROWS


class _Batches:
    """A stand-in child: partition p yields (p, 0) .. (p, n_p - 1)
    after random short waits."""

    def __init__(self, sizes):
        self.sizes = sizes
        self.num_partitions = len(sizes)

    def execute_partition(self, p):
        for i in range(self.sizes[p]):
            time.sleep(random.random() * 0.002)
            yield (p, i)


@pytest.mark.parametrize("permits", [1, 2])
def test_coalesce_yields_in_partition_order_through_its_window(
        permits, monkeypatch):
    sizes = [7, 0, 30, 1, 12, 25, 3, 9]
    peak = [0]
    real_put = X._ReorderWindow.put

    def put(self, p, batch, on_block):
        ok = real_put(self, p, batch, on_block)
        peak[0] = max(peak[0], self.size)
        return ok

    monkeypatch.setattr(X._ReorderWindow, "put", put)
    sem = TpuSemaphore(permits)
    got = list(X.drain_in_order(_Batches(sizes), 4, sem))
    assert got == [(p, i) for p, n in enumerate(sizes) for i in range(n)]
    assert 0 < peak[0] <= 2 * 4
    assert sem.usage()["in_use"] == 0 and _no_threads_left()
    # leaving early stops the workers and joins them
    it = X.drain_in_order(_Batches(sizes), 4, sem)
    assert next(it) == (0, 0)
    it.close()
    assert sem.usage()["in_use"] == 0 and _no_threads_left()


def test_run_tasks_raises_the_first_failure_and_joins_its_pool():
    started = []

    def task(i):
        started.append(i)
        if i == 3:
            raise KeyError("task 3")
        time.sleep(0.05)
        return i

    with pytest.raises(KeyError, match="task 3") as info:
        run_tasks(task, 40, 4)
    assert any(f.name == "task" for f in traceback.extract_tb(info.tb))
    assert len(started) < 40  # the tasks not started were cancelled
    assert live_pool_threads() == 0
    assert run_tasks(lambda i: i * i, 10, 4) == [i * i for i in range(10)]
    assert run_tasks(lambda i: threading.current_thread(), 3, 1) == \
        [threading.current_thread()] * 3


def test_scan_task_decodes_its_files_on_the_pool_in_file_order(
        lineitem, monkeypatch):
    """One scan task of three files (the default task target): the files
    decode on the pool, and their rows come out in file order."""
    paths = lineitem[0]
    threads_seen = set()
    real = ParquetScanExec._file_batches

    def spy(self, fi, rfs):
        threads_seen.add(threading.current_thread().name)
        yield from real(self, fi, rfs)

    monkeypatch.setattr(ParquetScanExec, "_file_batches", spy)
    got = {}
    for name, conf in (("pooled", {BATCH: 1000}),
                       ("serial", {BATCH: 1000, **C.SERIAL})):
        s = TorchSession(conf, device="cpu")
        df = s.read_parquet(*paths).select(col("l_quantity"),
                                           col("l_returnflag"))
        assert df.physical_plan().num_partitions == 1
        got[name] = df.collect()
        assert _no_threads_left()
    want = pa.concat_tables([pq.read_table(p, columns=[
        "l_quantity", "l_returnflag"]) for p in paths])
    assert got["pooled"].equals(got["serial"])
    assert got["pooled"].column("l_quantity").equals(
        want.column("l_quantity"))
    assert got["pooled"]["l_returnflag"].to_pylist() == \
        want["l_returnflag"].to_pylist()
    assert any(n.startswith("srt-pool-decode") for n in threads_seen)
    assert threading.current_thread().name in threads_seen  # serial run
