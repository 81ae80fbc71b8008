"""The program keys and the program census: a thin view over the device
ledger (``trace/ledger.py``).

Counterpart of ``spark_rapids_tpu/execs/jit_cache.py`` (the name is
kept so a reader finds it).  There, two execs whose compute is
determined by equal expression trees and specs share one jitted
program, so a repeated query compiles nothing.  PyTorch compiles
nothing, so there is no program to keep: a program here is the Python
callable an exec runs on each batch (a projection's expressions, a
filter's predicate, an aggregate's update step, a join's pairing, a
sort's permutation, a hash exchange's split, a window's evaluation),
and what equal keys share is the ledger's entry.  What this module
keeps of the JAX one:

- the structural key (:func:`exprs_key` over the port's expression
  trees: class, ordinals, dtypes, literal values; with the aggregate
  specs and output schema the caller adds): equal keys compute the
  same thing, so the second query's execs dispatch under the first's
  entry;
- :func:`cache_size`, :func:`cache_stats` (hits, misses: a miss is a
  key's first entry), :func:`reset_cache_stats`,
  :func:`program_census` (programs per key tag), :func:`clear`, and
  the ``jit.cache_miss`` trace event.

Keys are built only while the ledger is on
(``execs/base.py::TpuExec.program``): off, an exec dispatches its
callable directly, and every figure here stays as it was.  No CUDA
graphs: port batches have dynamic shapes (ROADMAP's perf note on a
graph cache).  Buffer donation, which the JAX cache threads into XLA,
has no PyTorch analog: a torch op allocates its outputs from the
caching allocator and frees its inputs when their last reference goes,
so there is nothing to donate and nothing here emulates it.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch.exprs.base import expr_key
from spark_rapids_tpu_torch.trace import ledger as _ledger

_LOCK = threading.Lock()
_HITS = 0
_MISSES = 0
#: the keys of trees that do not serialise (see ``_key_or_identity``)
_UNIQUE = itertools.count()


def _key_or_identity(e) -> str:
    """``expr_key(e)``, or, for a tree holding a non-dataclass
    expression whose state does not serialise, a key of its own: a
    program over such a tree is never shared."""
    try:
        return expr_key(e)
    except TypeError:
        return f"{type(e).__name__}#{next(_UNIQUE)}"


def exprs_key(es: Sequence) -> tuple:
    """The structural keys of a list of expressions (a non-expression
    keys by its repr)."""
    return tuple(_key_or_identity(e) for e in es)


def cached_program(key: tuple, fn: Callable,
                   op: Optional[str] = None) -> Callable:
    """``fn``, an exec's program, dispatched under the ledger entry of
    ``key`` (made on the first lookup: a miss).  ``op`` (the owning
    exec's name) labels the program in the ledger."""
    global _HITS, _MISSES
    entry, made = _ledger.LEDGER.lookup(key, op)
    with _LOCK:
        if made:
            _MISSES += 1
        else:
            _HITS += 1
    if made and _trace.TRACER.enabled:
        _trace.event("jit.cache_miss", key=repr(key)[:200],
                     cache_size=cache_size())
    return _ledger.LEDGER.bind(entry, fn)


def cache_size() -> int:
    """Programs the ledger holds an entry for."""
    return len(_ledger.LEDGER.entries())


def cache_stats() -> dict:
    """Cumulative lookup counters: {hits, misses, size, hit_rate}."""
    with _LOCK:
        hits, misses = _HITS, _MISSES
    total = hits + misses
    return {
        "hits": hits,
        "misses": misses,
        "size": cache_size(),
        "hit_rate": round(hits / total, 3) if total else 0.0,
    }


def reset_cache_stats() -> None:
    """Zero the lookup counters (the entries are untouched)."""
    global _HITS, _MISSES
    with _LOCK:
        _HITS = 0
        _MISSES = 0


def program_census() -> dict[str, int]:
    """Distinct programs per key tag (the leading string of every key):
    a steady workload whose census grows run over run leaks per-query
    values into its keys."""
    census: dict[str, int] = {}
    for e in _ledger.LEDGER.entries():
        census[e.tag] = census.get(e.tag, 0) + 1
    return census


def clear() -> None:
    """Drop every program's entry (``ledger.reset_stats``)."""
    _ledger.reset_stats()
