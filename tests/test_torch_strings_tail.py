"""The string long tail in the port against the JAX package.

Each case runs one DataFrame through the port's
``TorchSession(device="cpu")`` and the JAX package's ``TpuSession`` on
its device engine (the JAX CPU backend) and on its CPU engine, over
hand-written or numpy-seeded strings (NULLs, empty strings, multi-byte
UTF-8): ``replace``, ``regexp_replace`` (plain patterns on the device,
real regexes on the CPU engine), ``lpad`` / ``rpad``, ``locate``,
``substring_index``, ``initcap``, ``concat_ws``, ``split(s, d)[i]``
(rewritten to ``SplitPart``), a bare ``split`` and ``get_json_object``
(CPU engine only).  Strings, integers and NULLs must be equal exactly
(no tolerance: nothing here is floating point), in order where the
query keeps its input's order.  The nodes JAX keeps off its device are
the port's CPU nodes too, with the reason in ``explain()``.  Each
expression also runs directly on one batch in both packages (bytes
compared as they are) and through both CPU engines.

``test_every_jax_expression_class_has_a_port_namesake`` holds that
every class of each ``spark_rapids_tpu/exprs/*.py`` has a class of the
same name in the port's module of the same name, with no exception;
``test_every_jax_exec_class_has_a_port_namesake`` that every exec class
of JAX ``execs/*.py`` and ``io/*.py`` has a namesake in the port or is
listed with the ROADMAP.md item that brings it.
"""

import ast
import os
import types

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import session as JS
from spark_rapids_tpu.exprs import base as JB
from spark_rapids_tpu.exprs import collections as JCOLL
from spark_rapids_tpu.exprs import strings as JSTR

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import session as PS
from spark_rapids_tpu_torch.exprs import base as B
from spark_rapids_tpu_torch.exprs import collections as COLL
from spark_rapids_tpu_torch.exprs import strings as S
from spark_rapids_tpu_torch.execs.fallback import CpuFallbackExec
from test_torch_nested import assert_tables_equal
from torch_jax_eval import jax_eval, port_eval, raw
from torch_quiet import quiet_ladder  # noqa: F401

_FNS = ("col", "replace_", "regexp_replace", "lpad", "rpad", "locate",
        "substring_index", "initcap", "concat_ws", "lower")
PORT = types.SimpleNamespace(
    lit=B.lit, S=S, COLL=COLL,
    **{f: getattr(PS, f) for f in _FNS if f != "lower"},
    lower=lambda e: S.Lower(PS.col(e) if isinstance(e, str) else e))
JAX = types.SimpleNamespace(
    lit=JB.lit, S=JSTR, COLL=JCOLL,
    **{f: getattr(JS, f) for f in _FNS if f != "lower"},
    lower=lambda e: JSTR.Lower(JS.col(e) if isinstance(e, str) else e))

STRINGS = pa.table({"s": pa.array(
    ["hello world", "a.b.c.d", "", None, "  pad me  ", "xxx", "aaa", "ab",
     "no dots here", "ünïcode str", ".lead", "trail.", "a..b", "ab ab ab",
     "日本.語", "aaaa", "abab"], pa.string())})
WORDS = ["", "a", "ab", "aaa", "a.b", ". .", "日本語", "ünï", "x y z",
         "straße", "l", "hello", "ll", "a🙂b", "Σίσυφος", "@@", "MiXeD cAsE"]


def both(table, build, ordered=True):
    """The port's rows, held against the JAX device engine's and its
    CPU engine's (in order when ``ordered``)."""
    port = build(TorchSession(device="cpu").create_dataframe(table),
                 PORT).collect()
    jdf = build(JS.TpuSession().create_dataframe(table), JAX)
    assert_tables_equal(port, jdf.collect(engine="tpu"),
                        ignore_order=not ordered)
    assert_tables_equal(port, jdf.collect(engine="cpu"),
                        ignore_order=not ordered)
    return port.to_pydict()


def port_df(table, build):
    return build(TorchSession(device="cpu").create_dataframe(table), PORT)


def cpu_nodes(df) -> list:
    return [n for n in df.physical_plan().walk()
            if isinstance(n, CpuFallbackExec)]


def seeded_words(n: int, seed: int) -> pa.Table:
    """Two columns of words joined from ``WORDS``, 15 % NULL."""
    rng = np.random.default_rng(seed)

    def col():
        parts = rng.integers(0, len(WORDS), (n, 3))
        seps = np.array(["", ".", " ", "l"])[rng.integers(0, 4, (n, 2))]
        vals = [WORDS[a] + s1 + WORDS[b] + s2 + WORDS[c]
                for (a, b, c), (s1, s2) in zip(parts, seps)]
        return pa.array(vals, pa.string(), mask=rng.random(n) < 0.15)

    return pa.table({"s": col(), "t": col()})


def test_replace():
    out = both(STRINGS, lambda df, a: df.select(
        a.replace_(a.col("s"), "a", "XY").alias("r1"),
        a.replace_(a.col("s"), ".", "--").alias("r2"),
        a.replace_(a.col("s"), "ab", "").alias("r3"),
        a.replace_(a.col("s"), "", "z").alias("r4"),
        a.replace_(a.col("s"), "aa", "b").alias("r5"),
        a.replace_(a.col("s"), "aba", "_").alias("r6"),
        a.replace_(a.col("s"), "日本", "x").alias("r7")))
    assert out["r1"][6] == "XYXYXY"  # greedy, non-overlapping
    assert out["r2"][1] == "a--b--c--d"
    assert out["r3"][13] == "  "
    assert out["r4"][0] == "hello world"  # an empty search changes nothing
    assert out["r5"][15] == "bb" and out["r5"][6] == "ba"
    assert out["r7"][14] == "x.語"


def test_regexp_replace_plain_pattern_runs_on_the_device():
    df = port_df(STRINGS, lambda df, a: df.select(
        a.regexp_replace(a.col("s"), "ab", "Z").alias("r")))
    assert "cannot run" not in df.explain()
    out = both(STRINGS, lambda df, a: df.select(
        a.regexp_replace(a.col("s"), "ab", "Z").alias("r")))
    assert out["r"][13] == "Z Z Z"


@pytest.mark.parametrize("pattern,replacement,reason", [
    ("a+", "Z", "real regular expression"),
    ("[.]", "-", "real regular expression"),
    ("o", "$1", "backrefs"),
])
def test_regexp_replace_real_regex_runs_on_the_cpu_engine(
        pattern, replacement, reason):
    def build(df, a):
        return df.select(a.regexp_replace(a.col("s"), pattern,
                                          replacement).alias("r"))

    df = port_df(STRINGS, build)
    assert reason in df.explain()
    assert len(cpu_nodes(df)) == 1
    if "$" not in replacement:  # Python's re reads $1 literally
        out = both(STRINGS, build)
        if pattern == "a+":
            assert out["r"][6] == "Z"


def test_pads():
    out = both(STRINGS, lambda df, a: df.select(
        a.lpad(a.col("s"), 8, "*").alias("l1"),
        a.rpad(a.col("s"), 8, "ab").alias("r1"),
        a.lpad(a.col("s"), 3).alias("l2"),
        a.lpad(a.col("s"), 0, "*").alias("l3"),
        a.rpad(a.col("s"), 5, "").alias("r2"),
        a.rpad(a.col("s"), 12, "xyz").alias("r3"),
        a.lpad(a.col("s"), -1, "x").alias("l4")))
    assert out["l1"][5] == "*****xxx"
    assert out["r1"][7] == "abababab"
    assert out["l2"][0] == "hel"  # a longer string is cut
    assert out["l3"][0] == "" and out["l4"][0] == ""
    assert out["l1"][9] == "ünïcode "  # characters, not bytes
    assert out["r1"][14] == "日本.語abab"


def test_pads_with_a_multibyte_pad_run_on_the_cpu_engine():
    def build(df, a):
        return df.select(a.lpad(a.col("s"), 6, "é").alias("l"),
                         a.rpad(a.col("s"), 2, "日").alias("r"))

    df = port_df(STRINGS, build)
    assert "non-ASCII pad strings not supported" in df.explain()
    out = both(STRINGS, build)
    assert out["l"][5] == "éééxxx" and out["r"][14] == "日本"


def test_locate():
    out = both(STRINGS, lambda df, a: df.select(
        a.locate("b", a.col("s")).alias("p1"),
        a.locate(".", a.col("s"), 3).alias("p2"),
        a.locate("", a.col("s"), 4).alias("p3"),
        a.locate("zz", a.col("s")).alias("p4"),
        a.locate("語", a.col("s")).alias("p5"),
        a.locate("c", a.col("s"), 0).alias("p6"),
        a.locate("aa", a.col("s"), 2).alias("p7")))
    assert out["p1"][1] == 3 and out["p2"][1] == 4 and out["p4"][0] == 0
    assert out["p5"][14] == 4  # characters, not bytes
    assert out["p6"][1] == 0 and out["p3"][2] == 1
    assert out["p7"][6] == 2


def test_substring_index():
    out = both(STRINGS, lambda df, a: df.select(
        a.substring_index(a.col("s"), ".", 2).alias("a"),
        a.substring_index(a.col("s"), ".", -2).alias("b"),
        a.substring_index(a.col("s"), ".", 10).alias("c"),
        a.substring_index(a.col("s"), " ", 1).alias("d"),
        a.substring_index(a.col("s"), ".", 0).alias("e"),
        a.substring_index(a.col("s"), "aa", -1).alias("f"),
        a.substring_index(a.col("s"), "ab", 2).alias("g"),
        a.substring_index(a.col("s"), "a long delimiter", 1).alias("h")))
    assert out["a"][1] == "a.b" and out["b"][1] == "c.d"
    assert out["c"][1] == "a.b.c.d" and out["d"][0] == "hello"
    assert out["e"][0] == "" and out["f"][15] == ""
    assert out["g"][16] == "ab" and out["h"][0] == "hello world"


def test_initcap():
    out = both(STRINGS, lambda df, a: df.select(
        a.initcap(a.col("s")).alias("i")))
    assert out["i"][0] == "Hello World" and out["i"][13] == "Ab Ab Ab"
    assert out["i"][9] == "Ünïcode Str"


def test_concat_ws():
    t = pa.table({
        "a": pa.array(["x", None, "p", None, "日"], pa.string()),
        "b": pa.array(["y", "q", None, None, "本"], pa.string()),
    })
    out = both(t, lambda df, a: df.select(
        a.concat_ws("-", a.col("a"), a.col("b")).alias("c"),
        a.concat_ws("", a.col("a"), a.col("b"), a.col("a")).alias("d"),
        a.concat_ws(" :: ", a.col("b")).alias("e")))
    # NULL inputs are skipped (unlike concat), never a NULL result
    assert out["c"] == ["x-y", "q", "p", "", "日-本"]
    assert out["d"][0] == "xyx" and out["e"][3] == ""


def test_concat_ws_with_a_null_separator_is_null():
    def build(df, a):
        return df.select(a.S.ConcatWs(a.lit(None), a.col("a")).alias("c"))

    t = pa.table({"a": pa.array(["x", None])})
    port = port_df(t, build).collect().to_pydict()
    assert port["c"] == [None, None]


SPLIT_VALUES = ["a,b,c", "", None, "x", ",lead", "trail,", "a,,c", "日本,語",
                "one,two,three,four"]


def test_split_indexed_runs_on_the_device_as_split_part():
    def build(df, a):
        def part(i):
            return a.COLL.GetArrayItem(a.S.StringSplit(a.col("s"),
                                                       a.lit(",")),
                                       a.lit(i))
        return df.select(part(0).alias("p0"), part(1).alias("p1"),
                         part(3).alias("p3"))

    t = pa.table({"s": pa.array(SPLIT_VALUES * 30)})
    df = port_df(t, build)
    assert "!" not in df.explain().splitlines()[0]
    assert not cpu_nodes(df)
    assert "SplitPart" not in df.explain()  # named as split(s, d)[i]
    got = both(t, build)
    assert got["p0"][:9] == ["a", "", None, "x", "", "trail", "a", "日本",
                             "one"]
    assert got["p1"][:9] == ["b", None, None, None, "lead", "", "", "語",
                             "two"]
    assert got["p3"][:9] == [None] * 8 + ["four"]


def test_split_multichar_delimiter():
    def build(df, a):
        return df.select(a.COLL.GetArrayItem(a.S.StringSplit(
            a.col("s"), a.lit("::")), a.lit(1)).alias("p"))

    t = pa.table({"s": pa.array(["a::b::c", "::x", "y::", "zz", "a:::b"])})
    out = both(t, build)
    assert out["p"] == ["b", "x", "", None, ":b"]


def test_bare_split_runs_on_the_cpu_engine():
    def build(df, a):
        return df.select(a.S.StringSplit(a.col("s"), a.lit(",")).alias(
            "parts"))

    t = pa.table({"s": pa.array(["a,b", "c", None, ",x,"])})
    df = port_df(t, build)
    assert "bare split() produces array<string>" in df.explain()
    assert len(cpu_nodes(df)) == 1
    assert df.collect().to_pydict()["parts"] == [["a", "b"], ["c"], None,
                                                 ["", "x", ""]]
    jout = build(JS.TpuSession().create_dataframe(t), JAX).collect(
        engine="tpu").to_pydict()["parts"]
    assert jout == [["a", "b"], ["c"], None, ["", "x", ""]]


def test_regex_split_runs_on_the_cpu_engine():
    def build(df, a):
        return df.select(a.COLL.GetArrayItem(a.S.StringSplit(
            a.col("s"), a.lit("[0-9]+")), a.lit(1)).alias("p"))

    t = pa.table({"s": pa.array(["a1b22c", "x9y", "none"])})
    df = port_df(t, build)
    assert len(cpu_nodes(df)) == 1
    out = both(t, build)
    assert out["p"] == ["b", "y", None]


def test_get_json_object_runs_on_the_cpu_engine():
    rows = ['{"a": 1, "b": {"c": "hi"}, "d": [10, 20]}', '{"a": null}',
            "not json", None, '{"b": {"c": "日本"}}', '{"d": [true, false]}']

    def build(df, a):
        g = a.S.GetJsonObject
        return df.select(g(a.col("j"), a.lit("$.a")).alias("a"),
                         g(a.col("j"), a.lit("$.b.c")).alias("bc"),
                         g(a.col("j"), a.lit("$.d[1]")).alias("d1"),
                         g(a.col("j"), a.lit("$.b")).alias("b"))

    t = pa.table({"j": pa.array(rows)})
    df = port_df(t, build)
    assert "get_json_object evaluates JSON paths on the CPU engine" \
        in df.explain()
    assert len(cpu_nodes(df)) == 1
    got = both(t, build)
    assert got["a"] == ["1", None, None, None, None, None]
    assert got["bc"] == ["hi", None, None, None, "日本", None]
    assert got["d1"] == ["20", None, None, None, None, "false"]
    assert got["b"] == ['{"c":"hi"}', None, None, None, '{"c":"日本"}', None]


def _tail_exprs(ns):
    S_, lit = ns.S, ns.lit
    c = (lambda n: B.col(n)) if ns is PORT else JB.ColumnReference
    s, t = c("s"), c("t")
    return [
        S_.StringReplace(s, lit("l"), lit("LL")),
        S_.StringReplace(s, lit(". "), lit("")),
        S_.StringReplace(s, lit("日本"), lit("x")),
        S_.RegExpReplace(t, lit("ab"), lit("-")),
        S_.StringLPad(s, lit(9), lit("_")),
        S_.StringRPad(t, lit(4), lit("+-")),
        S_.StringLocate(lit("l"), s, lit(2)),
        S_.StringLocate(lit("ï"), t, lit(1)),
        S_.SubstringIndex(s, lit("l"), lit(1)),
        S_.SubstringIndex(t, lit("."), lit(-1)),
        S_.SubstringIndex(s, lit("ll"), lit(2)),
        S_.InitCap(s),
        S_.ConcatWs(lit(", "), s, t),
        S_.SplitPart(t, lit(" "), 1),
        S_.SplitPart(s, lit("l"), 0),
    ]


def test_the_expressions_equal_the_jax_functions_byte_for_byte():
    """Each long-tail expression evaluated directly on one batch in both
    packages (no engine), bytes compared as they are."""
    table = seeded_words(300, 5)
    got = port_eval(table, _tail_exprs(PORT))
    want = jax_eval(table, _tail_exprs(JAX))
    assert raw(got).equals(raw(want))


@pytest.mark.parametrize("seed", range(6))
def test_string_tail_fuzz(seed):
    """The JAX ``test_batch3_fuzz`` functions over seeded words, through
    both packages' sessions and engines."""
    both(seeded_words(300, 40 + seed), lambda df, a: df.select(
        a.replace_(a.col("s"), "a", "@@").alias("r"),
        a.lpad(a.col("s"), 6, "_").alias("lp"),
        a.rpad(a.col("t"), 6, "+").alias("rp"),
        a.locate("l", a.col("s"), 2).alias("lc"),
        a.substring_index(a.col("s"), "l", 1).alias("si"),
        a.substring_index(a.col("t"), ".", -2).alias("sn"),
        a.initcap(a.col("t")).alias("ic"),
        a.concat_ws("|", a.col("s"), a.col("t")).alias("cw")))


def test_names_and_addresses_like_the_chip_query():
    """The chip run's names query, small: initcap over lower, pads,
    a plain regexp_replace, substring_index, locate and split()[1],
    then grouped by two computed STRING keys."""
    rng = np.random.default_rng(3)
    n = 400
    first = np.array(["JAMES", "mary", "Robert", "LINDA"])[
        rng.integers(0, 4, n)]
    street = np.array(["Street", "Ave", "Blvd", "Ct."])[rng.integers(0, 4, n)]
    suite = np.array(["Suite 10", "Suite 2", "Suite", ""])[
        rng.integers(0, 4, n)]
    t = pa.table({"f": pa.array(first), "st": pa.array(street),
                  "su": pa.array(suite, mask=rng.random(n) < 0.1),
                  "zip": pa.array(rng.integers(100, 99999, n).astype(str))})

    def build(df, a):
        part = a.COLL.GetArrayItem(a.S.StringSplit(a.col("su"), a.lit(" ")),
                                   a.lit(1))
        proj = df.select(
            a.concat_ws(" ", a.initcap(a.lower("f")),
                        a.initcap(a.lower("f"))).alias("name"),
            a.lpad(a.col("zip"), 10, "0").alias("zip10"),
            a.regexp_replace(a.col("st"), "Street", "St").alias("st2"),
            part.alias("suite"), a.locate("a", a.col("f")).alias("loc"))
        return proj

    both(t, build)


JAX_EXPRS = os.path.join(os.path.dirname(JB.__file__))
PORT_EXPRS = os.path.join(os.path.dirname(B.__file__))


def _classes(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body if isinstance(n, ast.ClassDef)}


@pytest.mark.parametrize("module", sorted(
    f for f in os.listdir(JAX_EXPRS)
    if f.endswith(".py") and f != "__init__.py"))
def test_every_jax_expression_class_has_a_port_namesake(module):
    want = _classes(os.path.join(JAX_EXPRS, module))
    port_path = os.path.join(PORT_EXPRS, module)
    got = _classes(port_path) if os.path.exists(port_path) else set()
    assert not want - got, f"{module}: not in the port: {sorted(want - got)}"


JAX_PKG = os.path.dirname(JAX_EXPRS)
PORT_PKG = os.path.dirname(PORT_EXPRS)

#: the JAX exec classes the port does not have yet, each with the
#: ROADMAP.md item that brings it
EXECS_TO_PORT = {
    "FusableExec": "item 9 (the fused chains)",
    "TpuCollectiveHashAggregateExec": "item 10 (multi-GPU)",
    "TpuCollectiveHashJoinExec": "item 10 (multi-GPU)",
    "TpuCollectiveSortExec": "item 10 (multi-GPU)",
}


def _exec_classes(path: str) -> set:
    return {c for c in _classes(path) if c.endswith("Exec")}


def _port_exec_classes() -> set:
    out: set = set()
    for root, _dirs, files in os.walk(PORT_PKG):
        out |= {c for f in files if f.endswith(".py")
                for c in _exec_classes(os.path.join(root, f))}
    return out


@pytest.mark.parametrize("module", sorted(
    os.path.join(d, f) for d in ("execs", "io")
    for f in os.listdir(os.path.join(JAX_PKG, d))
    if f.endswith(".py") and f != "__init__.py"))
def test_every_jax_exec_class_has_a_port_namesake(module):
    """Each exec class of JAX ``execs/*.py`` and ``io/*.py`` is a class
    of the port, or listed with the item that ports it (and a listed one
    the port has fails too: the list stays true)."""
    want = _exec_classes(os.path.join(JAX_PKG, module))
    missing = want - _port_exec_classes()
    assert missing == {c for c in want if c in EXECS_TO_PORT}, (
        f"{module}: not in the port and not listed: "
        f"{sorted(missing - set(EXECS_TO_PORT))}; listed but ported: "
        f"{sorted(set(EXECS_TO_PORT) & want - missing)}")


@pytest.mark.parametrize("k", range(len(_tail_exprs(PORT))))
def test_cpu_engine_equals_the_jax_cpu_engine(k):
    """Each long-tail expression through the port's ``execute_cpu`` and
    the JAX package's CPU engine."""
    from spark_rapids_tpu.cpu.engine import execute_cpu as jexecute

    from spark_rapids_tpu_torch.cpu.engine import execute_cpu

    table = seeded_words(200, 11)
    got = execute_cpu(port_df(table, lambda df, a: df.select(
        _tail_exprs(PORT)[k].alias("v")))._plan)
    want = jexecute(JS.TpuSession().create_dataframe(table).select(
        _tail_exprs(JAX)[k].alias("v"))._plan)
    assert_tables_equal(got, want, ignore_order=False)
