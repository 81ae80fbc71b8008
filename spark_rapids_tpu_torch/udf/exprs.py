"""The UDF expression nodes.

Counterpart of ``spark_rapids_tpu/udf/exprs.py``.

- ``TorchScalarUDF`` (JAX ``JaxScalarUDF``, Spark's RapidsUDF
  ``evaluateColumnar``): the user's columnar function over the
  children's data tensors, on their own device, in the surrounding
  exec.  A port batch holds only its live rows, so the result has shape
  ``(num_rows,)`` (the JAX function's is the batch capacity).  A result
  that is not a tensor, lies on another device or has another shape
  raises: nothing moves or reshapes it quietly.  A row is NULL when any
  input is NULL; the function sees the data tensors as they are (NULL
  slots hold whatever the column holds there) and must not write into
  them.  The result is cast to the declared type.
- ``OpaquePythonUDF``: any Python scalar function.  The planner does
  not register it, so the node holding it runs on the CPU engine, row
  by row in-process, NULLs passed to the function as ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import AnyColumn, Column
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression


@dataclasses.dataclass(repr=False)
class _PythonUDF(Expression):
    fn: Callable
    _dtype: T.DataType
    args: tuple
    fn_name: str = "udf"

    #: the UDF tier ``explain()`` shows
    tier = ""

    @property
    def children(self) -> tuple[Expression, ...]:
        return tuple(self.args)

    def with_children(self, children) -> "_PythonUDF":
        return dataclasses.replace(self, args=tuple(children))

    @property
    def dtype(self) -> T.DataType:
        return self._dtype

    @property
    def name(self) -> str:
        return self.fn_name

    def __repr__(self) -> str:
        return (f"{self.fn_name}[{self.tier}]"
                f"({', '.join(map(repr, self.args))})")


class TorchScalarUDF(_PythonUDF):
    """The user's columnar function over the children's data tensors."""

    tier = "torch"

    def eval(self, ctx: EvalContext) -> AnyColumn:
        cols = [a.eval(ctx) for a in self.args]
        n = ctx.batch.num_rows
        # the batch's device with its index ("cuda" is "cuda:0" here)
        device = torch.empty(0, device=ctx.batch.device).device
        out = self.fn(*[c.data for c in cols])
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"torch UDF {self.fn_name!r} returned "
                            f"{type(out).__name__}, not a tensor")
        if out.device != device:
            raise ValueError(f"torch UDF {self.fn_name!r} returned a tensor "
                             f"on {out.device}, expected {device}")
        if tuple(out.shape) != (n,):
            raise ValueError(f"torch UDF {self.fn_name!r} returned shape "
                             f"{tuple(out.shape)}, expected ({n},)")
        valid = torch.ones(n, dtype=torch.bool, device=device)
        for c in cols:
            valid = valid & c.validity
        return Column(out.to(T.to_torch_dtype(self._dtype)), valid,
                      self._dtype)


    def eval_numpy(self, datas: list, n: int):
        """The function over CPU tensors of numpy arrays (the CPU
        engine's inputs, NULL slots 0): its result as a numpy array of
        the declared type."""
        out = self.fn(*[torch.from_numpy(np.array(d)) for d in datas])
        if not isinstance(out, torch.Tensor) or tuple(out.shape) != (n,):
            raise ValueError(f"torch UDF {self.fn_name!r} returned "
                             f"{getattr(out, 'shape', type(out).__name__)}"
                             f", expected a tensor of shape ({n},)")
        return out.to(T.to_torch_dtype(self._dtype)).numpy()


class OpaquePythonUDF(_PythonUDF):
    """A Python scalar function: the CPU engine's only."""

    tier = "opaque"

    def eval(self, ctx: EvalContext) -> AnyColumn:
        raise NotImplementedError(
            "OpaquePythonUDF runs on the CPU engine only")
