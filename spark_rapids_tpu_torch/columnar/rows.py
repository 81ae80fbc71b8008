"""Row <-> columnar converters and the export surface.

Counterpart of ``spark_rapids_tpu/columnar/rows.py`` (the reference's
GpuRowToColumnarExec / GpuColumnarToRowExec and ColumnarRdd):

- ``rows_to_batch`` / ``batch_to_rows``: Python tuples or dicts to one
  batch on a device, and a batch back to tuples;
- ``columnar_export``: a DataFrame's result as Arrow record batches,
  streamed, honouring ``spark.rapids.tpu.sql.enabled`` as ``collect()``
  does.  On the device engine it is the session's ``_stream``, so the
  export holds its admission slot, passes the cancellation checkpoints
  and is recorded in the history (JAX's ``columnar_export`` drains the
  plan bare, outside all three);
- ``device_arrays``: a physical plan's batches as torch tensors on the
  device (``DataFrame.to_device_arrays``).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import (
    from_arrow,
    schema_to_arrow,
    to_arrow,
)
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column


def rows_to_batch(rows: Iterable, schema: T.Schema,
                  device="cpu") -> ColumnarBatch:
    """Row tuples (in ``schema``'s order) or dicts (by name; a missing
    name is NULL) -> one batch on ``device``."""
    aschema = schema_to_arrow(schema)
    names = schema.names
    cols: list[list] = [[] for _ in names]
    for r in rows:
        if isinstance(r, dict):
            for i, n in enumerate(names):
                cols[i].append(r.get(n))
        else:
            for i, v in enumerate(r):
                cols[i].append(v)
    arrays = [pa.array(c, aschema.field(i).type) for i, c in enumerate(cols)]
    return from_arrow(pa.Table.from_arrays(arrays, schema=aschema),
                      torch.device(device), schema)


def batch_to_rows(batch: ColumnarBatch) -> Iterator[tuple]:
    """A batch's rows as tuples, in its schema's order."""
    tbl = to_arrow(batch)
    cols = [c.to_pylist() for c in tbl.columns]
    for i in range(tbl.num_rows):
        yield tuple(c[i] for c in cols)


def columnar_export(df, batch_rows: Optional[int] = None
                    ) -> Iterator[pa.RecordBatch]:
    """``df``'s result as Arrow record batches of at most ``batch_rows``
    rows (None: as the plan makes them), without one whole result in
    memory.  With ``spark.rapids.tpu.sql.enabled`` off the CPU engine
    runs the plan and its table is cut into batches, as in JAX."""
    if not df._session.conf.get(C.SQL_ENABLED):
        yield from df.collect(engine="cpu").to_batches(
            max_chunksize=batch_rows)
        return
    yield from df._stream(batch_rows=batch_rows)


def device_arrays(exec_) -> list[dict]:
    """Drain ``exec_``: one dict a batch, ``{name: values, name +
    "__valid": bool validity, "__num_rows": rows}``, each tensor a copy
    on the batch's device (a device-to-device copy: a batch may be a view
    of a buffer the tree's store entries own, which a spill or the
    tree's close frees or reuses).  No byte crosses to the host.  A
    STRING or nested column has no flat form and raises TypeError.  The
    tree is closed on every exit."""
    from spark_rapids_tpu_torch.plan.planner import _checked, close_tree

    out = []
    try:
        for b in _checked(exec_.execute()):
            d: dict = {}
            for f, c in zip(b.schema.fields, b.columns):
                if type(c) is not Column:
                    raise TypeError(
                        f"column {f.name!r} ({f.dtype.name}) has no flat "
                        "device array form — project it first")
                d[f.name] = c.data.clone()
                d[f.name + "__valid"] = c.validity.clone()
            d["__num_rows"] = b.num_rows
            out.append(d)
        return out
    finally:
        close_tree(exec_)
