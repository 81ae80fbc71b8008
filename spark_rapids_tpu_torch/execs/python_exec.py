"""The Python execs: user functions over Arrow and pandas batches.

Counterpart of ``spark_rapids_tpu/execs/python_exec.py``, all six execs
(Spark's GpuMapInPandasExec, GpuFlatMapGroupsInPandasExec,
GpuAggregateInPandasExec, GpuWindowInPandasExec and
GpuFlatMapCoGroupsInPandasExec, and mapInArrow).  Each device batch
crosses to a host Arrow table (``columnar/arrow.py::to_arrow``: one
device-to-host copy of each of its tensors, counted in ``hostCopies``),
runs through the worker pool (``python_worker``), is cast to the
declared schema and uploads again.  The round trip is inherent to a
Python function on any accelerator; the reference pays it too.

- ``TpuMapInArrowExec`` / ``TpuMapInPandasExec``: batch by batch,
  partition by partition.
- ``_GroupedPandasBase`` (applyInPandas, agg_in_pandas,
  transform_in_pandas): the planner hash-exchanges the child on the
  keys, so a partition holds whole groups; each partition's batches
  concatenate to one table and make one worker round.  A keyless
  aggregate over no rows still makes its one row.
- ``TpuFlatMapCoGroupsInPandasExec``: both sides exchanged on their
  keys; a partition's two sides travel as one table (``__side``, then
  the left's columns, then the right's, each NULL on the other side's
  rows).

The worker-side wrappers (``_map_in_pandas_wrapper``,
``_grouped_apply_wrapper``, ``_grouped_agg_wrapper``,
``_window_in_pandas_wrapper``, ``_cogroup_wrapper``) live in
``python_worker/wrappers.py``, which imports no torch, and are
re-exported here.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Iterator, Optional

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import (
    finish_upload,
    schema_to_arrow,
    stage_upload,
    to_arrow,
)
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch,
    concat_batches,
    empty_batch,
)
from spark_rapids_tpu_torch.execs.base import Metrics, TaskRuntime, TpuExec
from spark_rapids_tpu_torch.python_worker import PYTHON_WORKERS, PythonWorkerPool
from spark_rapids_tpu_torch.python_worker.wrappers import (  # noqa: F401
    _cogroup_wrapper,
    cogroup_table,
    _grouped_agg_wrapper,
    _grouped_apply_wrapper,
    _map_in_pandas_wrapper,
    _window_in_pandas_wrapper,
)

PYTHON_METRICS = ("pythonBatches", "hostCopies", "numOutputRows")

#: sidecars ``to_arrow`` does not copy down
_SIDECARS = ("codes", "dict_values")


def host_copies(batch: ColumnarBatch) -> int:
    """The device-to-host copies ``to_arrow`` makes of ``batch``: one a
    tensor of its columns (0 for a batch already on the host)."""
    if batch.device.type != "cuda":
        return 0

    def count(x) -> int:
        if isinstance(x, torch.Tensor):
            return 1
        if isinstance(x, (tuple, list)):
            return sum(count(y) for y in x)
        if dataclasses.is_dataclass(x):
            return sum(count(getattr(x, f.name))
                       for f in dataclasses.fields(x)
                       if f.name not in _SIDECARS)
        return 0

    return sum(count(c) for c in batch.columns)


class _PythonExecBase(TpuExec):
    """What every Python exec shares: the pool (made on first use,
    closed with the exec), the device and the counters."""

    def __init__(self, fn, schema: T.Schema, *children: TpuExec,
                 device: torch.device,
                 runtime: Optional[TaskRuntime] = None,
                 max_workers: int = C.DEFAULTS[PYTHON_WORKERS]):
        super().__init__(*children)
        self.fn = fn
        self._schema = schema
        self.device = torch.device(device)
        self.runtime = runtime or TaskRuntime.serial()
        self.max_workers = max_workers
        self.metrics = Metrics(*PYTHON_METRICS)
        self._pool: Optional[PythonWorkerPool] = None
        self._pool_lock = threading.Lock()

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def worker_fn(self):
        """What the workers run over each table."""
        return self.fn

    def pool(self) -> PythonWorkerPool:
        with self._pool_lock:
            if self._pool is None:
                self._pool = PythonWorkerPool(self.worker_fn(),
                                              self.max_workers)
            return self._pool

    def _to_host(self, batch: ColumnarBatch) -> pa.Table:
        self.metrics.add("hostCopies", host_copies(batch))
        return to_arrow(batch)

    def _round(self, table: pa.Table) -> ColumnarBatch:
        """One worker round: the result cast to the declared schema and
        uploaded."""
        out = self.pool().run(table).cast(schema_to_arrow(self._schema))
        self.metrics.add("pythonBatches", 1)
        self.metrics.add("numOutputRows", out.num_rows)
        return finish_upload(stage_upload(out, self.device, self._schema,
                                          self.runtime.upload_stream))

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()


class TpuMapInArrowExec(_PythonExecBase):
    """mapInArrow: ``fn(pa.Table) -> pa.Table`` over each batch."""

    def __init__(self, fn, schema: T.Schema, child: TpuExec, **kw):
        super().__init__(fn, schema, child, **kw)

    def node_desc(self) -> str:
        return f"{self.name} [{getattr(self.fn, '__name__', 'fn')}]"

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for b in self.children[0].execute_partition(p):
            yield self._round(self._to_host(b))


class TpuMapInPandasExec(TpuMapInArrowExec):
    """mapInPandas: the Arrow exec with the pandas conversion in the
    worker."""

    def worker_fn(self):
        return functools.partial(_map_in_pandas_wrapper, fn=self.fn,
                                 aschema=schema_to_arrow(self._schema))


class _GroupedPandasBase(_PythonExecBase):
    """A partition of whole groups (the planner's exchange), its batches
    concatenated, in one worker round."""

    def __init__(self, key_names, payload, schema: T.Schema,
                 child: TpuExec, **kw):
        super().__init__(payload, schema, child, **kw)
        self.key_names = list(key_names)

    #: a keyless aggregate makes one row over no input
    def _keyless_emits_on_empty(self) -> bool:
        return False

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        child = self.children[0]
        batches = list(child.execute_partition(p))
        if not batches:
            if not (p == 0 and self._keyless_emits_on_empty()):
                return
            batches = [empty_batch(child.schema, self.device)]
        big = batches[0] if len(batches) == 1 else concat_batches(batches)
        if big.num_rows == 0 and not (p == 0
                                      and self._keyless_emits_on_empty()):
            return
        yield self._round(self._to_host(big))


class TpuFlatMapGroupsInPandasExec(_GroupedPandasBase):
    """applyInPandas: ``fn(group frame) -> frame``."""

    def worker_fn(self):
        return functools.partial(
            _grouped_apply_wrapper, fn=self.fn, key_names=self.key_names,
            aschema=schema_to_arrow(self._schema))

    def node_desc(self) -> str:
        return (f"{self.name} [{getattr(self.fn, '__name__', 'fn')}] "
                f"keys={self.key_names}")


class TpuAggregateInPandasExec(_GroupedPandasBase):
    """Pandas aggregates: ``fn`` is [(output name, fn(Series) -> scalar,
    input column)]; a row of the keys and the scalars a group."""

    def worker_fn(self):
        return functools.partial(
            _grouped_agg_wrapper, aggs=list(self.fn),
            key_names=self.key_names, aschema=schema_to_arrow(self._schema))

    def _keyless_emits_on_empty(self) -> bool:
        return not self.key_names

    def node_desc(self) -> str:
        return (f"{self.name} [{', '.join(n for n, _, _ in self.fn)}] "
                f"keys={self.key_names}")


class TpuWindowInPandasExec(_GroupedPandasBase):
    """Pandas window functions over unbounded frames: ``fn(Series) ->
    scalar`` given to every row of its group, appended to the row."""

    def worker_fn(self):
        return functools.partial(
            _window_in_pandas_wrapper, fns=list(self.fn),
            key_names=self.key_names, aschema=schema_to_arrow(self._schema))

    def node_desc(self) -> str:
        return (f"{self.name} [{', '.join(n for n, _, _ in self.fn)}] "
                f"keys={self.key_names}")


class TpuFlatMapCoGroupsInPandasExec(_PythonExecBase):
    """cogroup().applyInPandas: the two children exchanged on their keys
    into as many partitions; ``fn(left group, right group)``."""

    def __init__(self, left_keys, right_keys, fn, schema: T.Schema,
                 left: TpuExec, right: TpuExec, **kw):
        super().__init__(fn, schema, left, right, **kw)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)

    def node_desc(self) -> str:
        return (f"{self.name} [{getattr(self.fn, '__name__', 'fn')}] "
                f"keys={self.left_keys}")

    def worker_fn(self):
        ls, rs = (c.schema for c in self.children)
        return functools.partial(
            _cogroup_wrapper, fn=self.fn, left_keys=self.left_keys,
            right_keys=self.right_keys,
            aschema=schema_to_arrow(self._schema),
            n_left_cols=len(ls.fields), left_names=ls.names,
            right_names=rs.names)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        sides = []
        for child in self.children:
            batches = list(child.execute_partition(p))
            if batches:
                big = batches[0] if len(batches) == 1 \
                    else concat_batches(batches)
                sides.append(self._to_host(big))
            else:
                sides.append(schema_to_arrow(child.schema).empty_table())
        if sides[0].num_rows == 0 and sides[1].num_rows == 0:
            return
        yield self._round(cogroup_table(*sides))
