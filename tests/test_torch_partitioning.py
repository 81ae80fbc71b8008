"""Round-robin and single partitioning, and the take-ordered-and-project
exec: the port against the JAX package on the same numpy-seeded rows.

Counterparts of ``tests/test_shuffle.py::test_roundrobin_balances`` and
``test_single_partitioning``, and of ``tests/test_agg_sort_limit.py::
test_take_ordered_and_project``.  Neither partitioning hashes, so
neither reaches K1 (``kernels.hash_columns``); a hash exchange over the
same rows does, as the control.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.execs.basic import TpuBatchSourceExec as JSource
from spark_rapids_tpu.execs.exchange import TpuShuffleExchangeExec as JEx
from spark_rapids_tpu.execs.sort import SortKey as JSortKey
from spark_rapids_tpu.execs.sort import (
    TpuTakeOrderedAndProjectExec as JTakeOrdered,
)
from spark_rapids_tpu.exprs.base import ColumnReference as JC
from spark_rapids_tpu.ops import partition as JP

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batches_to_arrow
from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.execs.sort import (
    SortKey,
    TpuTakeOrderedAndProjectExec,
)
from spark_rapids_tpu_torch.exprs.base import BoundReference, ColumnReference
from spark_rapids_tpu_torch.io.scan import ArrowSourceExec
from spark_rapids_tpu_torch.ops import kernels
from spark_rapids_tpu_torch.ops.partition import (
    HashPartitioning,
    RoundRobinPartitioning,
    SinglePartitioning,
)
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

JSCHEMA = JT.Schema([JT.Field("k", JT.LONG), JT.Field("v", JT.LONG)])
SCHEMA = T.Schema([T.Field("k", T.LONG), T.Field("v", T.LONG)])


def _rows(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-50, 50, n).astype(np.int64),
            "v": np.arange(n, dtype=np.int64)}


def _port_source(data: dict, batch_rows: int) -> ArrowSourceExec:
    """One map task a ``batch_rows`` chunk."""
    return ArrowSourceExec(pa.table(data), SCHEMA, torch.device("cpu"),
                           batch_rows)


def _jax_source(data: dict) -> JSource:
    return JSource([JBatch.from_numpy(data, JSCHEMA)], JSCHEMA)


def _port_parts(ex) -> list[list[int]]:
    """Each partition's ``v`` values, sorted."""
    return [sorted(v for b in ex.execute_partition(p)
                   for v in b.columns[1].data.tolist())
            for p in range(ex.num_partitions)]


def _jax_parts(ex) -> list[list[int]]:
    return [sorted(v for b in ex.execute_partition(p)
                   for v in b.to_pydict()["v"])
            for p in range(ex.num_partitions)]


@pytest.fixture
def k1_calls(monkeypatch):
    """Calls of K1's wrapper (on the CPU the wrapper runs its plain
    version and counts no launch: count the calls instead)."""
    calls = []
    real = kernels.hash_columns

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, "hash_columns", counting)
    return calls


def test_roundrobin_balances(k1_calls):
    data = _rows(64, 7)
    ex = TpuShuffleExchangeExec(RoundRobinPartitioning(4),
                                _port_source(data, 64), ShuffleManager())
    parts = _port_parts(ex)
    sizes = [len(p) for p in parts]
    assert sum(sizes) == 64
    assert max(sizes) - min(sizes) <= 1
    # the JAX exchange deals the same rows to the same partitions
    assert parts == _jax_parts(JEx(JP.RoundRobinPartitioning(4),
                                   _jax_source(data)))
    assert not k1_calls
    assert ex.metrics["mapBatches"] == 1


@pytest.mark.parametrize("n_rows,batch_rows,n_parts",
                         [(64, 16, 4), (103, 10, 8), (7, 7, 8)])
def test_roundrobin_start_differs_by_map_task(n_rows, batch_rows, n_parts):
    """Map task t starts at partition t % n (the JAX exchange's offset):
    every task's rows spread from another partition, so the partitions
    stay within a row a task of each other and every row lands once."""
    data = _rows(n_rows, 3)
    ex = TpuShuffleExchangeExec(RoundRobinPartitioning(n_parts),
                                _port_source(data, batch_rows),
                                ShuffleManager())
    parts = _port_parts(ex)
    assert sorted(v for p in parts for v in p) == list(range(n_rows))
    tasks = -(-n_rows // batch_rows)
    for t in range(tasks):
        rows = list(range(t * batch_rows, min(n_rows, (t + 1) * batch_rows)))
        for i, v in enumerate(rows):
            assert v in parts[(i + t % n_parts) % n_parts]
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= tasks


def test_single_partitioning(k1_calls):
    data = _rows(30, 8)
    ex = TpuShuffleExchangeExec(SinglePartitioning(),
                                _port_source(data, 7), ShuffleManager())
    assert ex.num_partitions == 1
    assert ex.node_desc() == "TpuShuffleExchangeExec single"
    n = sum(b.num_rows for b in ex.execute())
    assert n == 30
    jex = JEx(JP.SinglePartitioning(), _jax_source(data))
    assert _port_parts(ex) == _jax_parts(jex) == [list(range(30))]
    assert not k1_calls


def test_hash_exchange_is_the_control(k1_calls):
    """The same rows under a hash exchange reach K1 once a map batch."""
    data = _rows(30, 8)
    key = [BoundReference(0, T.LONG, True, "k")]
    ex = TpuShuffleExchangeExec(HashPartitioning(key, 4),
                                _port_source(data, 7), ShuffleManager())
    assert sum(len(p) for p in _port_parts(ex)) == 30
    assert len(k1_calls) == 5


def test_roundrobin_describe_and_partitioning():
    assert RoundRobinPartitioning(8).describe() == "roundrobin(8)"
    assert RoundRobinPartitioning(8).bind(SCHEMA) == RoundRobinPartitioning(8)
    ex = TpuShuffleExchangeExec(RoundRobinPartitioning(8),
                                _port_source(_rows(5, 1), 5),
                                ShuffleManager())
    assert ex.num_partitions == 8
    assert ex.node_desc() == "TpuShuffleExchangeExec roundrobin(8)"


def _take_ordered_jax(chunks, n, keys, project):
    src = JSource([JBatch.from_numpy({"k": np.asarray(k, np.int64),
                                      "v": np.asarray(v, np.int64)}, JSCHEMA)
                   for k, v in chunks], JSCHEMA)
    out: dict = {}
    for b in JTakeOrdered(n, keys, src, project=project).execute():
        for name, vs in b.to_pydict().items():
            out.setdefault(name, []).extend(vs)
    return out


def _take_ordered_port(chunks, n, keys, project, batch_rows):
    k = np.concatenate([np.asarray(c[0], np.int64) for c in chunks])
    v = np.concatenate([np.asarray(c[1], np.int64) for c in chunks])
    ex = TpuTakeOrderedAndProjectExec(
        n, keys, _port_source({"k": k, "v": v}, batch_rows), project=project)
    assert ex.num_partitions == 1
    return batches_to_arrow(ex.execute(), ex.schema).to_pydict()


def test_take_ordered_and_project():
    chunks = [([7, 1, 9], [1, 2, 3]), ([4, 8, 2], [4, 5, 6])]
    got = _take_ordered_port(
        chunks, 3, [SortKey(ColumnReference("k"))],
        [ColumnReference("k"), (ColumnReference("v") * 10).alias("w")], 3)
    assert got == {"k": [1, 2, 4], "w": [20, 60, 40]}
    want = _take_ordered_jax(
        chunks, 3, [JSortKey(JC("k"))], [JC("k"), (JC("v") * 10).alias("w")])
    assert got == want


@pytest.mark.parametrize("n", [0, 1, 100, 5000])
@pytest.mark.parametrize("descending", [False, True])
def test_take_ordered_matches_jax_on_seeded_rows(n, descending):
    """Unique keys over several batches, with and without a projection:
    the same rows in the same order as the JAX exec's."""
    rng = np.random.default_rng(17 + n)
    k = rng.permutation(3000).astype(np.int64) - 1500
    v = rng.integers(0, 1 << 40, 3000).astype(np.int64)
    chunks = [(k[i:i + 700], v[i:i + 700]) for i in range(0, 3000, 700)]
    for proj in (None, "kv"):
        pp = None if proj is None else [ColumnReference("v"),
                                        ColumnReference("k")]
        jp = None if proj is None else [JC("v"), JC("k")]
        got = _take_ordered_port(
            chunks, n, [SortKey(ColumnReference("k"), descending,
                                descending)], pp, 700)
        want = _take_ordered_jax(
            chunks, n, [JSortKey(JC("k"), descending, descending)], jp)
        if n == 0:
            assert not got.get("k") and not want.get("k")
            continue
        assert got == want
        assert len(got["k"]) == min(n, 3000)


def test_take_ordered_ties_as_a_multiset():
    """Ties are free to trade places: the key column and the multiset of
    rows with a key strictly inside the cut equal the JAX exec's."""
    rng = np.random.default_rng(5)
    k = rng.integers(0, 20, 1000).astype(np.int64)
    v = np.arange(1000, dtype=np.int64)
    chunks = [(k[i:i + 128], v[i:i + 128]) for i in range(0, 1000, 128)]
    got = _take_ordered_port(chunks, 100, [SortKey(ColumnReference("k"))],
                             None, 128)
    want = _take_ordered_jax(chunks, 100, [JSortKey(JC("k"))], None)
    assert got["k"] == want["k"]
    cut = got["k"][-1]
    inside = sorted(v for kk, v in zip(got["k"], got["v"]) if kk < cut)
    assert inside == sorted(v for kk, v in zip(want["k"], want["v"])
                            if kk < cut)


# the OOM ladder and the spill store stay quiet on these tests
from torch_quiet import quiet_ladder  # noqa: E402,F401
