"""The port's string expressions against the JAX package's.

Each case builds the same expressions from both packages' classes and
evaluates them over one numpy-seeded table: NULLs, empty strings,
multi-byte UTF-8 (2-, 3- and 4-byte characters, and 'ß' / 'ı', whose
case mappings change their byte length), NUL bytes, leading and
trailing spaces.  The results must be equal byte for byte (strings
compared as binary; no tolerance: nothing here is floating point).
Invalid UTF-8 goes through upper / lower on its own table.
"""

import types

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.arrow import from_arrow as jfrom_arrow
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import strings as JS

from spark_rapids_tpu_torch.columnar.arrow import from_arrow
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import strings as S
from torch_jax_eval import jax_eval, port_eval, raw

N = 120
WORDS = ["", "a", "A", "a\0", "a\0b", "ab", "abc", "Abc", "abcabc", "b",
         "  pad ", " ", "x  ", "  y", "é", "É", "ünï", "ÜNÏ", "日本語",
         "straße", "ıi", "Σίσυφος", "a🙂b", "🙂", "MiXeD cAsE",
         "zzzzzzzzzzzzzzzz", "c%_d"]

JAX = types.SimpleNamespace(S=JS, col=JB.ColumnReference, lit=JB.Literal.of)
PORT = types.SimpleNamespace(S=S, col=B.col, lit=B.Literal.of)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(9)

    def words():
        return pa.array(np.array(WORDS, dtype=object)[
            rng.integers(0, len(WORDS), N)], pa.string(),
            mask=rng.random(N) < 0.15)

    return pa.table({"s": words(), "t": words(),
                     "e": pa.array([""] * N, mask=rng.random(N) < 0.2)})


def _cases(ns):
    S_, c, lit = ns.S, ns.col, ns.lit
    s, t, e = c("s"), c("t"), c("e")
    return {
        "length": [S_.Length(s), S_.Length(e)],
        "case": [S_.Upper(s), S_.Lower(s), S_.Upper(e), S_.Lower(t)],
        "search": [S_.StartsWith(s, lit("a")), S_.StartsWith(s, lit("")),
                   S_.EndsWith(s, lit("c")), S_.EndsWith(s, lit("ße")),
                   S_.Contains(s, lit("b")), S_.Contains(s, lit("\0")),
                   S_.Contains(s, lit("日本")),
                   S_.StartsWith(s, lit("a very long needle past W"))],
        "like": [S_.Like(s, p) for p in (
            "a%", "%c", "%b%", "a%c", "abc", "", "%", "%%", "%é%",
            "ab%abc", "a\0%")],
        "substring": [S_.Substring(s, pos, n)
                      for pos in (1, 0, 2, -1, -3, 7, -100)
                      for n in (None, 0, 1, 3, -2, 100)],
        "trim": [S_.StringTrim(s), S_.StringTrimLeft(s),
                 S_.StringTrimRight(s), S_.StringTrim(e)],
        "concat": [S_.Concat(s, t), S_.Concat(s, lit(", "), t),
                   S_.Concat(lit("x"), e), S_.Concat(s)],
    }


@pytest.mark.parametrize("case", list(_cases(PORT)))
def test_port_equals_the_jax_functions(case, table):
    got = port_eval(table, _cases(PORT)[case])
    want = jax_eval(table, _cases(JAX)[case])
    assert raw(got).equals(raw(want)), (raw(got).slice(0, 8).to_pylist(),
                                        raw(want).slice(0, 8).to_pylist())


@pytest.mark.parametrize("pattern", ["a_c", "a%b%c", "a\\%", "_"])
def test_like_raises_on_the_patterns_jax_refuses(pattern, table):
    for ns, run in ((PORT, port_eval), (JAX, jax_eval)):
        with pytest.raises(TypeError):
            run(table, [ns.S.Like(ns.col("s"), pattern)])


def _invalid_utf8_table():
    words = [b"a\x80b", b"\xc3", b"\xc3A", b"\xe6\x97", b"x\xff\xfey",
             b"\xc3\xa9\x80\x80", b"\xf0\x9f\x99\x82\xc3\xa9", b"\x80",
             b"ab\xe2\x82", b"AB\xc3\x89"]
    offsets = np.concatenate([[0], np.cumsum([len(w) for w in words])])
    arr = pa.Array.from_buffers(pa.string(), len(words), [
        None, pa.py_buffer(offsets.astype(np.int32)),
        pa.py_buffer(b"".join(words))])
    return pa.table({"s": arr})


def _row_bytes(chars, lengths, n):
    chars, lengths = np.asarray(chars), np.asarray(lengths)
    return [bytes(chars[i, :lengths[i]]) for i in range(n)]


def test_case_mapping_of_invalid_utf8_equals_the_jax_function():
    """Bytes compared straight from the columns: the JAX package's Arrow
    conversion decodes UTF-8, which these rows are not."""
    tbl = _invalid_utf8_table()
    pb = from_arrow(tbl, torch.device("cpu"))
    jb = jfrom_arrow(tbl)
    for fn in ("Upper", "Lower"):
        got = getattr(S, fn)(B.bind_references(B.col("s"), pb.schema)).eval(
            B.EvalContext.for_batch(pb))
        want = getattr(JS, fn)(JB.bind_references(
            JB.ColumnReference("s"), jb.schema)).eval(
            JB.EvalContext.for_batch(jb))
        n = tbl.num_rows
        assert _row_bytes(got.chars, got.lengths, n) == _row_bytes(
            want.chars, want.lengths, n), fn


def test_case_mapping_keeps_byte_lengths_and_spark_results():
    tbl = pa.table({"s": ["straße", "ıi", "Σίσυφος", "é", "a🙂b"]})
    got = port_eval(tbl, [S.Upper(B.col("s")), S.Lower(B.col("s"))])
    # 'ß' -> 'SS' and 'ı' -> 'I' change the UTF-8 length: they stay
    assert got.column("c0").to_pylist() == ["STRAßE", "ıI", "ΣΊΣΥΦΟΣ", "É",
                                            "A🙂B"]
    assert got.column("c1").to_pylist() == ["straße", "ıi", "σίσυφος", "é",
                                            "a🙂b"]


def test_substring_counts_characters_and_spark_positions():
    tbl = pa.table({"s": ["abc", "日本語", "a🙂b"]})
    got = port_eval(tbl, [S.Substring(B.col("s"), 2, 1),
                          S.Substring(B.col("s"), 0, 2),
                          S.Substring(B.col("s"), -5, 3),
                          S.Substring(B.col("s"), -2)])
    assert got.to_pylist() == [
        {"c0": "b", "c1": "ab", "c2": "a", "c3": "bc"},
        {"c0": "本", "c1": "日本", "c2": "日", "c3": "本語"},
        {"c0": "🙂", "c1": "a🙂", "c2": "a", "c3": "🙂b"}]


def test_outputs_carry_no_dictionary_and_zero_padding():
    tbl = pa.table({"s": pa.array(["ab", "abc", None, "ab"]).dictionary_encode()})
    b = from_arrow(tbl, torch.device("cpu"))
    ctx = B.EvalContext.for_batch(b)
    ref = B.bind_references(B.col("s"), b.schema)
    for e in (S.Upper(ref), S.Substring(ref, 2), S.Concat(ref, ref),
              S.StringTrim(ref)):
        out = e.eval(ctx)
        assert out.codes is None and out.dict_chars is None
        pos = torch.arange(out.width)[None, :]
        assert not bool(((pos >= out.lengths[:, None])
                         & (out.chars != 0)).any())
        assert int(out.lengths[2]) == 0 and not bool(out.validity[2])


# --------------------------------------------------------------------- #
# Casts between strings and numbers or dates
# --------------------------------------------------------------------- #

NUMBER_TEXTS = ["0", "7", "-7", "+12", "  42  ", "\t-3\n", "3.99", "-3.99",
                ".5", "5.", "", " ", "-", "+", "1e3", "0x10", "12a", "a12",
                "2147483647", "2147483648", "-2147483648", "-2147483649",
                "9223372036854775807", "9223372036854775808",
                "-9223372036854775808", "-9223372036854775809",
                "00000000000000000000123", "１２", "1 2", "--1", "1.2.3"]


def test_string_to_integers_equals_the_jax_cast():
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.exprs.cast import Cast as JCast

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.cast import Cast

    tbl = pa.table({"s": pa.array(NUMBER_TEXTS + [None])})
    got = port_eval(tbl, [Cast(B.col("s"), T.INT), Cast(B.col("s"), T.LONG)])
    want = jax_eval(tbl, [JCast(JB.ColumnReference("s"), JT.INT),
                          JCast(JB.ColumnReference("s"), JT.LONG)])
    assert got.equals(want), (got.to_pylist(), want.to_pylist())


def test_numbers_and_booleans_to_string_equal_the_jax_cast():
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.exprs.cast import Cast as JCast

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.cast import Cast

    rng = np.random.default_rng(4)
    longs = np.concatenate([[0, 1, -1, 9, 10, -10, 2 ** 63 - 1, -2 ** 63,
                             2 ** 31, -2 ** 31], rng.integers(
                                 -2 ** 62, 2 ** 62, 40)])
    tbl = pa.table({
        "l": pa.array(longs, pa.int64(), mask=rng.random(len(longs)) < 0.1),
        "i": pa.array(longs.astype(np.int32), pa.int32()),
        "b": pa.array(rng.random(len(longs)) < 0.5,
                      mask=rng.random(len(longs)) < 0.1)})
    cols = ("l", "i", "b")
    got = port_eval(tbl, [Cast(B.col(c), T.STRING) for c in cols])
    want = jax_eval(tbl, [JCast(JB.ColumnReference(c), JT.STRING)
                          for c in cols])
    assert got.equals(want)
    back = port_eval(got.rename_columns(["l", "i", "b"]),
                     [Cast(B.col("l"), T.LONG)])
    assert back.column(0).to_pylist() == tbl.column("l").to_pylist()


def test_date_to_string_is_iso():
    import datetime as dt

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.cast import Cast

    days = [-25567, -1, 0, 10957, 11016, 47482, 2932896, None]
    tbl = pa.table({"d": pa.array(days, pa.int32()).cast(pa.date32())})
    got = port_eval(tbl, [Cast(B.col("d"), T.STRING)]).column(0).to_pylist()
    assert got == [None if d is None else
                   (dt.date(1970, 1, 1) + dt.timedelta(days=d)).isoformat()
                   for d in days]
