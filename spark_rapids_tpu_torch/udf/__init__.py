"""User-defined functions, in three tiers, best first.

Counterpart of ``spark_rapids_tpu/udf/__init__.py``:

1. ``@udf(T)`` tries the compiler (``compiler.py``): a function inside
   its subset becomes a tree of built-in expressions (tier
   ``compiled``) and runs on the card like any other.
2. ``@torch_udf(T)`` (JAX ``jax_udf``; Spark's RapidsUDF): the user
   writes the columnar function over torch tensors (tier ``torch``),
   and it runs in the exec on the batch's device.
3. Anything else ``@udf`` cannot compile is an ``OpaquePythonUDF``
   (tier ``opaque``), evaluated row by row on the CPU engine, where the
   planner's tags send its node; a return type is then required.

``explain()`` names the tier of each torch and opaque UDF of a plan.
"""

from __future__ import annotations

from typing import Callable, Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import Expression, _column
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.udf.compiler import UncompilableUDF, compile_udf
from spark_rapids_tpu_torch.udf.exprs import OpaquePythonUDF, TorchScalarUDF

__all__ = ["udf", "torch_udf", "UserDefinedFunction", "UncompilableUDF",
           "TorchScalarUDF", "OpaquePythonUDF"]


class UserDefinedFunction:
    """A Python function bound to column expressions when called."""

    def __init__(self, fn: Callable, return_type: Optional[T.DataType],
                 columnar: bool = False):
        self.fn = fn
        self.return_type = return_type
        self.name = getattr(fn, "__name__", "udf")
        self._factory = None
        if columnar:
            self.tier = "torch"
        else:
            try:
                self._factory = compile_udf(fn)
                self.tier = "compiled"
            except UncompilableUDF:
                if return_type is None:
                    raise
                self.tier = "opaque"

    def __call__(self, *cols) -> Expression:
        args = tuple(_column(c) for c in cols)
        if self.tier == "compiled":
            out = self._factory(*args)
            if self.return_type is None:
                return out
            try:  # a name's type is known only once bound
                same = out.dtype == self.return_type
            except (KeyError, NotImplementedError, RuntimeError, TypeError,
                    ValueError):
                same = False
            return out if same else Cast(out, self.return_type)
        cls = TorchScalarUDF if self.tier == "torch" else OpaquePythonUDF
        return cls(self.fn, self.return_type, args, self.name)


def udf(return_type: Optional[T.DataType] = None):
    """``@udf(T.DOUBLE)``, ``udf(T.DOUBLE)(fn)`` or a bare ``@udf``: the
    compiled tier when the function compiles, else an opaque UDF (which
    needs the return type)."""
    if callable(return_type):  # a bare @udf
        return UserDefinedFunction(return_type, None)

    def wrap(fn: Callable) -> UserDefinedFunction:
        return UserDefinedFunction(fn, return_type)

    return wrap


def torch_udf(return_type: T.DataType):
    """A columnar UDF: the function takes the children's data tensors
    (the batch's rows, on its device) and returns one tensor of as many
    rows."""

    def wrap(fn: Callable) -> UserDefinedFunction:
        return UserDefinedFunction(fn, return_type, columnar=True)

    return wrap
