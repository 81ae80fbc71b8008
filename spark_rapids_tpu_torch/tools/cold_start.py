"""The cold-process harness of the warm-start store.

Counterpart of ``spark_rapids_tpu/tools/cold_start.py``.  A restart is
the one cost the in-process caches cannot see: every prepared plan and
cached result dies with its process.  One run of this module is one
fresh process that prepares and executes the q1-shaped scan -> filter ->
aggregate -> sort fixture on the card against a given store directory
(``persist.py``) and prints one JSON line:

- ``wall_ms``: session construction to the collected result, the part
  a restart pays again per query; ``import_ms`` (torch and the package)
  and ``context_ms`` (CUDA's context, 0 on the CPU) beside it, not in
  it;
- the result's ``digest`` and ``rows``;
- the device ledger's ``dispatches`` and K1's (``k1_dispatches``, and
  ``k1_launches`` from the kernel's counter, which counts on the card
  only);
- ``compiles``: the kernel libraries this process built with ``nvcc``
  (0 when ``_build/`` holds them; the port compiles no programs);
- ``prepares``: the template's prepare lineage (1 in a process that
  found no persisted metadata, one more than the last process's when
  it did), and the ``persist.*`` and result-cache counters (a frame
  whose inputs changed counts under ``result_invalidations``).

Two modes.  ``plan`` (the default) sets only the fixture's keys and the
store's, so the plan tier is the one probed: with a warm directory the
child restores the lineage and dispatches exactly as with persistence
off.  ``result`` also sets ``spark.rapids.tpu.serving.sharing.enabled``:
the first such child writes the result frame back, and a later one
restores it from disk (``result_hits`` 1) and dispatches nothing.

The fixture's four files are each a scan task, so the aggregate's
partials go through a hash exchange, whose map batches K1 hashes.  The
JAX harness pins ``sql.fusion.enabled``; the port has no fused chains,
so this child leaves that key out.

Run::

    python -m spark_rapids_tpu_torch.tools.cold_start --data DIR \\
        [--persist DIR] [--mode plan|result] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

#: the JAX fixture's seed and rows, split over FIXTURE_FILES files
FIXTURE_SEED = 0xF05E
FIXTURE_ROWS = 1 << 14
FIXTURE_FILES = 4
MODES = ("plan", "result")


def fixture_paths(dir_: str) -> list[str]:
    return [os.path.join(dir_, f"li-{i}.parquet")
            for i in range(FIXTURE_FILES)]


def make_fixture(dir_: str) -> list[str]:
    """Write the fixture (the JAX harness's table, one file a quarter)
    into ``dir_``; its paths.  Every process seeds the same generator,
    so parent and children agree on the content."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(FIXTURE_SEED)
    n = FIXTURE_ROWS
    t = pa.table({
        "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
        "l_key": rng.integers(0, 4, n).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n).astype(np.int64),
        "l_price": rng.integers(900, 105000, n).astype(np.int64),
    })
    paths = fixture_paths(dir_)
    per = n // FIXTURE_FILES
    for i, path in enumerate(paths):
        pq.write_table(t.slice(i * per, per), path)
    return paths


def fixture_conf(persist_dir: Optional[str], mode: str) -> dict:
    """The keys a child sets: a fixed dispatch pattern (serial, no
    speculation, one batch a file, each file a scan task, one reduce
    partition), the store's with ``persist_dir``, and sharing in the
    ``result`` mode."""
    from spark_rapids_tpu_torch import config as C

    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    keys = {**C.SERIAL, C.SPECULATION_ENABLED: False,
            C.BATCH_ROWS: FIXTURE_ROWS // FIXTURE_FILES,
            C.TASK_TARGET_BYTES: 1, C.SHUFFLE_PARTITIONS: 1}
    if persist_dir is not None:
        keys[C.PERSIST_ENABLED] = True
        keys[C.PERSIST_DIR] = persist_dir
    if mode == "result":
        keys[C.SHARING_ENABLED] = True
    return keys


def fixture_query(session, paths: list[str]):
    """The JAX harness's query: sums and a count per key of the rows
    shipped by the cut-off date, by key."""
    from spark_rapids_tpu_torch.exprs.base import col, lit
    from spark_rapids_tpu_torch.session import count_star, sum_

    return (session.read_parquet(*paths)
            .where(col("l_shipdate") <= lit(10471))
            .group_by(col("l_key"))
            .agg((sum_(col("l_quantity")), "sum_qty"),
                 (sum_(col("l_price")), "sum_price"),
                 (count_star(), "n"))
            .order_by(col("l_key")))


def run_once(data_dir: str, persist_dir: Optional[str] = None,
             mode: str = "plan", device: str = "cuda",
             import_ms: float = 0.0) -> dict:
    """Prepare and execute the fixture once in this process; the
    record (module docstring).  The store's writes are flushed before
    it returns, so a later process sees every entry."""
    import torch

    from spark_rapids_tpu_torch import persist
    from spark_rapids_tpu_torch.eventlog import table_digest
    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.serving import work_share
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.trace import ledger

    context_ms = 0.0
    if device == "cuda":
        t0 = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        context_ms = (time.perf_counter() - t0) * 1e3
    paths = fixture_paths(data_dir)
    ledger.enable()
    ledger.LEDGER.flush(timeout=30.0)
    before = ledger.snapshot()
    k1_before = kernels.hash_columns.launches
    t0 = time.perf_counter()
    session = TorchSession(fixture_conf(persist_dir, mode), device=device)
    prepared = session.prepare(fixture_query(session, paths))
    result = prepared.execute()
    if device == "cuda":
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ledger.LEDGER.flush(timeout=30.0)
    programs = ledger.delta(before, ledger.snapshot())
    summary = ledger.summarize(programs)
    if persist_dir is not None and not persist.flush(timeout=30.0):
        raise RuntimeError("the warm-start store's writes did not land "
                           "within 30 s")
    lineage = prepared.last_rehydrated or {}
    ws = work_share.stats()
    return {
        "mode": mode,
        "device": device,
        "wall_ms": round(wall_ms, 3),
        "import_ms": round(import_ms, 3),
        "context_ms": round(context_ms, 3),
        "digest": table_digest(result),
        "rows": result.num_rows,
        "dispatches": summary["totals"]["dispatches"],
        "k1_dispatches": sum(
            p["dispatches"] for p in programs.values()
            if p["tag"] == kernels.hash_columns.PROGRAM),
        "k1_launches": kernels.hash_columns.launches - k1_before,
        "compiles": len(kernels.BUILDS),
        "prepares": int(lineage.get("prepares", 0)) + 1,
        "result_hits": ws["result_hits"],
        "result_misses": ws["result_misses"],
        "result_invalidations": ws["result_invalidations"],
        "persist": persist.stats(),
    }


def run_subprocess(data_dir: str, persist_dir: Optional[str] = None,
                   mode: str = "plan", device: str = "cuda",
                   timeout: float = 300.0) -> dict:
    """One fresh interpreter running this module's CLI; its record.
    The child inherits the environment with the repo root first on
    ``PYTHONPATH``; a child that fails raises."""
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "spark_rapids_tpu_torch.tools.cold_start",
           "--data", data_dir, "--mode", mode, "--device", device]
    if persist_dir is not None:
        cmd += ["--persist", persist_dir]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"cold-start child failed ({proc.returncode}):\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    return json.loads(lines[-1])


def main(argv: Optional[list] = None) -> int:
    import argparse

    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.tools.cold_start",
        description="one cold process of the warm-start fixture")
    ap.add_argument("--data", required=True,
                    help="the fixture's directory (written if missing)")
    ap.add_argument("--persist", default=None,
                    help="the warm-start store's directory (default: "
                         "persistence off)")
    ap.add_argument("--mode", choices=MODES, default="plan")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch  # noqa: F401

    import spark_rapids_tpu_torch  # noqa: F401

    import_ms = (time.perf_counter() - t0) * 1e3
    if not all(os.path.exists(p) for p in fixture_paths(args.data)):
        os.makedirs(args.data, exist_ok=True)
        make_fixture(args.data)
    print(json.dumps(run_once(args.data, args.persist, args.mode,
                              args.device, import_ms)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
