"""Evaluate expression lists of both packages over one Arrow table.

The module-level tests of the port's expressions (``test_torch_strings``,
``test_torch_datetime``, ``test_torch_math``, ``test_torch_arithmetic``)
build the same expressions from each package's classes, evaluate them
directly on one batch made from the same Arrow table (the port on the
CPU, the JAX package eagerly on its CPU backend: no engine, no
compilation) and compare the results as Arrow tables.  ``raw`` gives
every string column as bytes, so invalid UTF-8 compares too.
"""

from __future__ import annotations

import pyarrow as pa
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.arrow import from_arrow as jfrom_arrow
from spark_rapids_tpu.columnar.arrow import to_arrow as jto_arrow
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.exprs.base import EvalContext as JEvalContext
from spark_rapids_tpu.exprs.base import bind_references as jbind

from spark_rapids_tpu_torch.columnar.arrow import column_to_arrow, from_arrow
from spark_rapids_tpu_torch.exprs.base import EvalContext, bind_references


def raw(table: pa.Table) -> pa.Table:
    """Every string column as binary, so its bytes compare as they are."""
    return pa.table([c.cast(pa.binary()) if pa.types.is_string(c.type)
                     else c for c in table.columns], names=table.column_names)


def port_eval(table: pa.Table, exprs) -> pa.Table:
    """The port's expressions over ``table`` on the CPU, as c0, c1, ..."""
    b = from_arrow(table, torch.device("cpu"))
    arrays = []
    for e in exprs:
        bound = bind_references(e, b.schema)
        arrays.append(column_to_arrow(bound.eval(EvalContext.for_batch(b)),
                                      bound.dtype))
    return pa.table(arrays, names=[f"c{i}" for i in range(len(exprs))])


def jax_eval(table: pa.Table, exprs) -> pa.Table:
    """The JAX package's expressions over ``table``, as c0, c1, ..."""
    b = jfrom_arrow(table)
    cols, fields = [], []
    for i, e in enumerate(exprs):
        bound = jbind(e, b.schema)
        cols.append(bound.eval(JEvalContext.for_batch(b)))
        fields.append(JT.Field(f"c{i}", bound.dtype, True))
    return jto_arrow(JBatch(cols, b.num_rows, JT.Schema(fields)))
