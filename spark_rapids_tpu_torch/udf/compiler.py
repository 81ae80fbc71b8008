"""The UDF compiler: a plain Python scalar function to an expression
tree of the port's built-in expressions.

Counterpart of ``spark_rapids_tpu/udf/compiler.py`` (Spark's
udf-compiler, which turns JVM bytecode into Catalyst expressions): it
reads the function's ``ast``.  A function inside the subset compiles
to a tree that runs on the card as any built-in expression does; any
other raises ``UncompilableUDF``, and ``udf`` makes an opaque UDF.

The subset: arithmetic, comparisons (chained ones fold into AND),
boolean logic, ``x is (not) None``, conditional expressions, if/return
chains, ``in`` a literal collection, ``math.*`` functions and
constants, ``abs`` / ``min`` / ``max`` / ``len`` / ``round``, and the
string methods ``upper`` / ``lower`` / ``strip`` / ``lstrip`` /
``rstrip`` / ``startswith`` / ``endswith`` / ``replace``.
"""

from __future__ import annotations

import ast
import inspect
import math
import textwrap
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import math as M
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.exprs.base import (
    ColumnReference,
    Expression,
    Literal,
)


class UncompilableUDF(Exception):
    """The function uses a construct outside the compilable subset."""


_BINOPS = {
    ast.Add: A.Add, ast.Sub: A.Subtract, ast.Mult: A.Multiply,
    ast.Div: A.Divide, ast.FloorDiv: A.IntegralDivide,
    ast.Mod: A.Remainder, ast.Pow: M.Pow,
}
_CMPOPS = {ast.Lt: P.LessThan, ast.LtE: P.LessThanOrEqual,
           ast.Gt: P.GreaterThan, ast.GtE: P.GreaterThanOrEqual,
           ast.Eq: P.EqualTo}
_MATH_CALLS = {
    "sqrt": M.Sqrt, "exp": M.Exp, "expm1": M.Expm1, "log": M.Log,
    "log10": M.Log10, "log2": M.Log2, "log1p": M.Log1p, "sin": M.Sin,
    "cos": M.Cos, "tan": M.Tan, "asin": M.Asin, "acos": M.Acos,
    "atan": M.Atan, "sinh": M.Sinh, "cosh": M.Cosh, "tanh": M.Tanh,
    "degrees": M.ToDegrees, "radians": M.ToRadians, "floor": M.Floor,
    "ceil": M.Ceil,
}
_MATH_CONSTS = {"pi": math.pi, "e": math.e, "inf": math.inf,
                "nan": math.nan}
_STR_METHODS = {"upper": S.Upper, "lower": S.Lower, "strip": S.StringTrim,
                "lstrip": S.StringTrimLeft, "rstrip": S.StringTrimRight}


class _Translator:
    def __init__(self, params: Sequence[str]):
        self.params = list(params)

    def fail(self, node, why: str):
        raise UncompilableUDF(f"{why} (line {getattr(node, 'lineno', '?')})")

    def block(self, stmts, args) -> Expression:
        """A statement list that returns on every path; an if/return
        chain becomes If expressions."""
        if not stmts:
            self.fail(stmts, "missing return")
        st, rest = stmts[0], stmts[1:]
        if isinstance(st, ast.Return):
            if st.value is None:
                self.fail(st, "bare return")
            return self.expr(st.value, args)
        if isinstance(st, ast.If):
            return P.If(self.expr(st.test, args), self.block(st.body, args),
                        self.block(st.orelse or rest, args))
        self.fail(st, f"unsupported statement {type(st).__name__}")

    def expr(self, node: ast.AST, args) -> Expression:  # noqa: C901
        if isinstance(node, ast.Constant):
            v = node.value
            if v is None or isinstance(v, (bool, int, float, str)):
                return Literal.of(v)
            self.fail(node, f"unsupported constant {v!r}")
        if isinstance(node, ast.Name):
            if node.id in self.params:
                return args[self.params.index(node.id)]
            self.fail(node, f"free variable {node.id!r}")
        if isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                self.fail(node, f"operator {type(node.op).__name__}")
            return op(self.expr(node.left, args), self.expr(node.right, args))
        if isinstance(node, ast.UnaryOp):
            c = self.expr(node.operand, args)
            unary = {ast.USub: A.UnaryMinus, ast.UAdd: A.UnaryPositive,
                     ast.Not: P.Not}.get(type(node.op))
            if unary is None:
                self.fail(node, f"operator {type(node.op).__name__}")
            return unary(c)
        if isinstance(node, ast.BoolOp):
            parts = [self.expr(v, args) for v in node.values]
            cls = P.And if isinstance(node.op, ast.And) else P.Or
            out = parts[0]
            for p in parts[1:]:
                out = cls(out, p)
            return out
        if isinstance(node, ast.Compare):
            return self._compare(node, args)
        if isinstance(node, ast.IfExp):
            return P.If(self.expr(node.test, args), self.expr(node.body, args),
                        self.expr(node.orelse, args))
        if isinstance(node, ast.Call):
            return self._call(node, args)
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "math" \
                    and node.attr in _MATH_CONSTS:
                return Literal.of(_MATH_CONSTS[node.attr])
            self.fail(node, f"attribute {node.attr!r}")
        self.fail(node, f"unsupported syntax {type(node).__name__}")

    def _compare(self, node: ast.Compare, args) -> Expression:
        out: Optional[Expression] = None
        left = node.left
        for op, right in zip(node.ops, node.comparators):
            term = self._compare_one(left, op, right, node, args)
            out = term if out is None else P.And(out, term)
            left = right
        return out

    def _compare_one(self, left, op, right, node, args) -> Expression:
        def is_none(n):
            return isinstance(n, ast.Constant) and n.value is None

        if isinstance(op, (ast.Is, ast.IsNot)):
            if is_none(right):
                child = self.expr(left, args)
            elif is_none(left):
                child = self.expr(right, args)
            else:
                self.fail(node, "`is` only supported against None")
            return P.IsNull(child) if isinstance(op, ast.Is) \
                else P.IsNotNull(child)
        if isinstance(op, (ast.In, ast.NotIn)):
            if not isinstance(right, (ast.List, ast.Tuple, ast.Set)) \
                    or not all(isinstance(e, ast.Constant)
                               for e in right.elts):
                self.fail(node, "`in` needs a literal collection")
            out = P.In(self.expr(left, args),
                       tuple(e.value for e in right.elts))
            return P.Not(out) if isinstance(op, ast.NotIn) else out
        cls = _CMPOPS.get(type(op))
        if cls is not None:
            return cls(self.expr(left, args), self.expr(right, args))
        if isinstance(op, ast.NotEq):
            return P.Not(P.EqualTo(self.expr(left, args),
                                   self.expr(right, args)))
        self.fail(node, f"comparison {type(op).__name__}")

    def _call(self, node: ast.Call, args) -> Expression:  # noqa: C901
        if node.keywords:
            self.fail(node, "keyword arguments")
        cargs = [self.expr(a, args) for a in node.args]
        f = node.func
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "math":
                cls = _MATH_CALLS.get(f.attr)
                if cls is not None and len(cargs) == 1:
                    return cls(cargs[0])
                if f.attr == "pow" and len(cargs) == 2:
                    return M.Pow(cargs[0], cargs[1])
                self.fail(node, f"math.{f.attr}")
            recv = self.expr(f.value, args)  # a string method
            if f.attr in _STR_METHODS and not cargs:
                return _STR_METHODS[f.attr](recv)
            if f.attr == "startswith" and len(cargs) == 1:
                return S.StartsWith(recv, cargs[0])
            if f.attr == "endswith" and len(cargs) == 1:
                return S.EndsWith(recv, cargs[0])
            if f.attr == "replace" and len(cargs) == 2:
                return S.StringReplace(recv, cargs[0], cargs[1])
            self.fail(node, f"method .{f.attr}()")
        if isinstance(f, ast.Name):
            if f.id == "abs" and len(cargs) == 1:
                return A.Abs(cargs[0])
            if f.id == "len" and len(cargs) == 1:
                return S.Length(cargs[0])
            if f.id == "min" and len(cargs) >= 2:
                return A.Least(*cargs)
            if f.id == "max" and len(cargs) >= 2:
                return A.Greatest(*cargs)
            if f.id == "round" and len(cargs) in (1, 2):
                scale = 0
                if len(cargs) == 2:
                    if not (isinstance(cargs[1], Literal)
                            and isinstance(cargs[1].value, int)):
                        self.fail(node, "round() scale must be literal")
                    scale = cargs[1].value
                return M.Round(cargs[0], scale)
            self.fail(node, f"call {f.id}()")
        self.fail(node, "computed call target")


def compile_udf(fn: Callable) -> Callable[..., Expression]:
    """``fn`` as a factory of expression trees: called with child
    expressions, it puts them in place of the parameters.  Raises
    UncompilableUDF outside the subset, at once (the factory is tried
    on placeholder columns)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError) as e:
        raise UncompilableUDF(f"no source available: {e}") from None
    try:
        tree = ast.parse(src)
    except SyntaxError:
        # a lambda inside a larger expression has no parsable source
        raise UncompilableUDF("cannot parse function source") from None
    fndef = next((n for n in ast.walk(tree)
                  if isinstance(n, (ast.FunctionDef, ast.Lambda))), None)
    if fndef is None:
        raise UncompilableUDF("no function definition found")
    a = fndef.args
    if a.vararg or a.kwarg or a.kwonlyargs or a.defaults or a.posonlyargs:
        raise UncompilableUDF("only plain positional parameters")
    params = [p.arg for p in a.args]
    tr = _Translator(params)

    def factory(*child_exprs: Expression) -> Expression:
        if len(child_exprs) != len(params):
            raise TypeError(f"UDF takes {len(params)} args, got "
                            f"{len(child_exprs)}")
        if isinstance(fndef, ast.Lambda):
            return tr.expr(fndef.body, list(child_exprs))
        return tr.block(fndef.body, list(child_exprs))

    factory(*[ColumnReference(f"__p{i}") for i in range(len(params))])
    return factory
