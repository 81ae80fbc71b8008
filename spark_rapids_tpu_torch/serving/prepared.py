"""PreparedQuery: the prepared-statement handle over the plan cache.

Counterpart of ``spark_rapids_tpu/serving/prepared.py``.
``TorchSession.prepare(df)`` and ``SqlSession.prepare(text)`` return
one.  ``execute()`` resolves the template in the session's
:class:`~spark_rapids_tpu_torch.serving.plan_cache.PlanCache`: a hit
drains the cached lowered exec tree with no parsing, planning or
lowering (``plan/planner.plan_query`` is not entered), through the
collect path an ad-hoc query takes (admission, the cancel token, the
result cache).  ``execute_stream()`` yields the result as Arrow record
batches as the fetch stage yields them; the stage's depth is the
backpressure.  ``cancel()`` cancels this template's executions in
flight; ``explain()`` is ``DataFrame.explain()``'s text for the cached
tree.

Re-drains of one cached tree serialize on its entry's lock; different
templates, and one template in different sessions' caches, run at once
under admission.
"""

from __future__ import annotations

from typing import Iterator, Optional

import pyarrow as pa

from spark_rapids_tpu_torch.serving.cancel import TokenSet
from spark_rapids_tpu_torch.serving.plan_cache import (
    CacheEntry,
    binding_key,
    sql_template_key,
    template_key,
)


class PreparedQuery:
    """A prepared template: a DataFrame plan, or a SQL text whose named
    parameters (``:name``) are bound at each execution."""

    def __init__(self, session, df=None, sql_text: Optional[str] = None,
                 sql_session=None, param_names: Optional[frozenset] = None):
        assert (df is None) != (sql_text is None)
        self._session = session
        self._df = df
        self._sql_text = sql_text
        self._sql_session = sql_session
        self.param_names = param_names or frozenset()
        #: (conf fingerprint, binding) -> key: the structural key
        #: digests in-memory tables, so it is not recomputed per
        #: execution
        self._key_memo: dict = {}
        #: conf fingerprint -> the binding-independent template key (the
        #: admission-batching group)
        self._group_memo: dict = {}
        self.last_plan_hash: Optional[str] = None
        #: the cancel tokens of this template's executions in flight
        self._inflight = TokenSet()

    # -- resolution -------------------------------------------------- #

    def _key(self, conf, params: Optional[dict]) -> str:
        from spark_rapids_tpu_torch.eventlog import conf_fingerprint

        fp = conf_fingerprint(conf)
        binding = binding_key(params)
        memo = self._key_memo.get((fp, binding))
        if memo is not None:
            return memo
        if self._sql_text is not None:
            key = sql_template_key(self._sql_text, conf, params)
        else:
            key = template_key(self._df._plan, conf)
        if len(self._key_memo) > 64:  # conf epochs and bindings are few
            self._key_memo.clear()
        self._key_memo[(fp, binding)] = key
        return key

    def _group_key(self, conf) -> str:
        """The binding-independent identity this template admits under
        (admission-aware batching): SQL on its normalized text x conf,
        a DataFrame on its structural key x conf."""
        from spark_rapids_tpu_torch.eventlog import conf_fingerprint

        fp = conf_fingerprint(conf)
        memo = self._group_memo.get(fp)
        if memo is not None:
            return memo
        if self._sql_text is not None:
            key = sql_template_key(self._sql_text, conf, None)
        else:
            key = template_key(self._df._plan, conf)
        if len(self._group_memo) > 64:
            self._group_memo.clear()
        self._group_memo[fp] = key
        return key

    def _resolve(self, params: Optional[dict]) -> tuple[CacheEntry, bool]:
        """(entry, hit): the template in the session's plan cache; on a
        miss, parse (SQL) and lower once, and insert."""
        from spark_rapids_tpu_torch.eventlog import plan_fingerprint
        from spark_rapids_tpu_torch.plan import planner as _planner

        conf = self._session.conf
        if params and self._sql_text is None:
            raise ValueError("params are only valid for SQL templates "
                             "(prepare(sql) with :name placeholders)")
        key = self._key(conf, params)
        cache = self._session.plan_cache
        entry = cache.lookup(key)
        hit = entry is not None
        if entry is None:
            if self._sql_text is not None:
                df = self._sql_session.sql(self._sql_text,
                                           params=params or {})
            else:
                df = self._df
            exec_, meta = _planner.plan_query(df._plan, df._planner())
            mine = CacheEntry(exec_, meta, plan_fingerprint(meta.explain()),
                              df)
            entry = cache.insert(key, mine)
            if entry is not mine:
                # another thread lowered the same template first
                _planner.close_tree(exec_)
        self.last_plan_hash = entry.plan_hash
        return entry, hit

    def _facts(self, hit: bool, extra_facts: Optional[dict]) -> dict:
        """The serving facts deposited inside admission; an ingress
        layer's ``extra_facts`` (the connect server's ``connect``
        section) ride along."""
        facts = {"plan_cache": "hit" if hit else "miss",
                 "admission_group": self._group_key(self._session.conf)}
        if extra_facts:
            facts.update(extra_facts)
        return facts

    # -- execution --------------------------------------------------- #

    def execute(self, params: Optional[dict] = None,
                extra_facts: Optional[dict] = None) -> pa.Table:
        """Run the template (binding ``params`` for SQL) and return the
        whole result.  The entry's drain lock is taken inside admission:
        taking it here would deadlock against an admitted query that
        executes this template nested."""
        entry, hit = self._resolve(params)
        return entry.df._collect(
            exec_=entry.exec_, meta=entry.meta, drain_lock=entry.lock,
            serving_facts=self._facts(hit, extra_facts),
            token_sink=self._inflight)[0]

    def execute_stream(self, params: Optional[dict] = None,
                       batch_rows: Optional[int] = None,
                       extra_facts: Optional[dict] = None
                       ) -> Iterator[pa.RecordBatch]:
        """Run the template and yield the result as Arrow record batches
        (re-chunked to at most ``batch_rows``).  The admission slot and
        the entry's lock are held until the stream is drained or
        closed: close an abandoned stream."""
        entry, hit = self._resolve(params)
        yield from entry.df._stream(
            exec_=entry.exec_, meta=entry.meta, batch_rows=batch_rows,
            drain_lock=entry.lock,
            serving_facts=self._facts(hit, extra_facts),
            token_sink=self._inflight)

    def cancel(self, reason: str = "cancelled") -> int:
        """Cancel this template's executions in flight (narrower than
        ``session.cancel()``); how many were newly cancelled."""
        return self._inflight.cancel(reason=reason)

    # -- introspection ----------------------------------------------- #

    def explain(self, params: Optional[dict] = None) -> str:
        """``DataFrame.explain()``'s text for the cached lowered plan."""
        from spark_rapids_tpu_torch.eventlog import render_plan_report

        entry, _hit = self._resolve(params)
        return render_plan_report(entry.exec_, entry.meta)

    def __repr__(self) -> str:
        what = ("sql" if self._sql_text is not None
                else type(self._df._plan).__name__)
        return (f"PreparedQuery[{what}, "
                f"params={sorted(self.param_names) or '-'}]")
