"""The deterministic mini TPC-DS catalog the sweep runs over.

Counterpart of ``spark_rapids_tpu/tools/tpcds_schema.py``: all 24 tables
from one ``numpy.random.default_rng(seed)``, each table's rows ``ROWS``
times ``scale`` (at least 4).  ``tpcds.py`` already reproduces every one
of its tables, equal to the JAX generator's table by table at a scale
that keeps at most its 5 ship modes (``scale`` <= 1.0, the sweep's
default), so this module names that generator and keeps no second copy.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.tpcds import CATALOG_ROWS as ROWS
from spark_rapids_tpu_torch.tpcds import DATE_SK_EPOCH, generate

__all__ = ["DATE_SK_EPOCH", "ROWS", "generate"]
