"""Datetime rebase policy for Parquet reads.

Counterpart of ``spark_rapids_tpu/io/rebase.py``.  Files written by
Spark 2.x, or by Spark 3.x in LEGACY mode (the
``org.apache.spark.legacyDateTime`` file metadata key), hold datetimes
on the hybrid Julian / Gregorian calendar, which would read shifted
before 1582.  The policy is Spark's ``datetimeRebaseModeInRead``:

- EXCEPTION (the default): a legacy-calendar file is refused when the
  read includes a DATE or TIMESTAMP column;
- CORRECTED: the values are read as proleptic Gregorian (right for
  every value after 1582, the common case);
- LEGACY's rebase arithmetic is not implemented, in either package.

The scan checks each file right after opening it, as the JAX scan does
(``io/scan.py::ParquetScanExec._file_batches``).
"""

from __future__ import annotations

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T

_SPARK_VERSION_KEY = b"org.apache.spark.version"
_SPARK_LEGACY_KEY = b"org.apache.spark.legacyDateTime"

REBASE_MODE_READ = C.register(
    "spark.rapids.tpu.sql.parquet.datetimeRebaseModeInRead", "EXCEPTION")
MODES = ("EXCEPTION", "CORRECTED")


def file_is_legacy_calendar(file_metadata) -> bool:
    """Whether the file's key-value metadata marks hybrid-calendar
    datetimes."""
    kv = file_metadata.metadata or {}
    version = kv.get(_SPARK_VERSION_KEY)
    if version is None:
        return False  # not written by Spark: proleptic (pyarrow et al.)
    if kv.get(_SPARK_LEGACY_KEY) is not None:
        return True  # Spark 3.x LEGACY mode
    return version.decode(errors="replace") < "3.0.0"


def check_rebase(path: str, file_metadata, schema: T.Schema,
                 mode: str) -> None:
    """Raise, under EXCEPTION, for a legacy-calendar file whose read
    includes a DATE or TIMESTAMP column."""
    if mode not in MODES:
        raise ValueError(f"{REBASE_MODE_READ} must be one of {MODES}, "
                         f"got {mode!r}")
    if mode == "CORRECTED":
        return
    has_datetime = any(isinstance(f.dtype, (T.DateType, T.TimestampType))
                       for f in schema.fields)
    if has_datetime and file_is_legacy_calendar(file_metadata):
        raise ValueError(
            f"Parquet file {path!r} was written with the legacy hybrid "
            "Julian/Gregorian calendar; pre-1582 datetimes would read "
            "shifted. Set "
            "spark.rapids.tpu.sql.parquet.datetimeRebaseModeInRead="
            "CORRECTED to read the stored values as proleptic "
            "Gregorian (ref: Spark's datetimeRebaseModeInRead).")
