#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  device   card name, and its name and power limit from nvidia-smi;
  build    nvcc build of every kernel from csrc/, with its time, and
           the g++ build of the Parquet decoder's host codec
           (native/hostcodec.cpp), with its time and g++ --version;
  kernels  both entry points of K1 (hash_string: one string column;
           hash_columns: a key tuple -> hash or partition id) against
           their plain PyTorch versions, bit for bit, over a grid of
           widths (the direct-load width included), row counts,
           partition counts, type mixes (``new_types``: TINYINT,
           SMALLINT, FLOAT, TIMESTAMP and DECIMAL beside a STRING and a
           LONG) and a row slice whose data_ptr()
           is not aligned; then timed at N = 6 x 2^20 rows (the
           device's own time per launch, from torch.profiler); the
           seconds each of the three parts took;
  q6, q1   TPC-H q6 and q1 over 6 x 2^20 generated lineitem rows (about
           SF1) through TorchSession(device="cuda") under the default
           keys (map tasks, coalesced partitions and scan files on pools
           of host threads, decode / upload / result fetch as stages,
           uploads on a side stream), six scan tasks
           (scan.taskTargetBytes = 8 MiB): one warm-up, then the median
           of 3 wall times; each result held against a pyarrow.compute
           reference on the same files.  Each query's breakdown drains
           its scans alone twice, serially and with their tasks on the
           pool, and prints each run's host split (decode, Arrow ->
           numpy, owned copy, pin, copy enqueue, the wait on the upload
           event, and how many batches' copies were still running).
           Kernel launch counts are reset just before each query's runs
           and read just after; q1 must launch hash_columns once per map
           batch and hash_string never;
  q3       TPC-H q3 (lineitem JOIN orders, revenue per order, ORDER BY
           revenue DESC LIMIT 10) over 6 x 2^20 lineitem rows with order
           keys and 2^20 orders, the same way: the top 10 held against
           a pyarrow join / group_by / sort of the same files (keys
           exact, revenue within REL_TOL; rows tied on revenue at the
           10th place by revenue only); hash_columns must launch once
           per non-empty map batch of its three exchanges (counted as
           each exchange's child feeds it in the warm-up run) and
           hash_string never.  Its orders side is too large to
           broadcast, so with the adaptive key off it plans a
           partition-wise shuffled join.  It runs first with the runtime
           filter off (the earlier slices' plan and launches), then with
           it on: a filter from the orders keys, built under the orders
           side's exchange, on the lineitem scan, which adds two
           hash_columns launches per batch it folds and two for its
           range table; then ``q3_adaptive``, the plan users get (the
           default keys): an adaptive join over the two exchanges, the
           filter's map stage first, one profiled run, counted and
           timed, its decision, its rows and its K1 launches;
  q67      TPC-DS q67 (sales per store and item, ranked within each store
           by a rank() window, the top 10 of each store ORDER BY store,
           rank, item) over 6 x 2^20 generated store_sales rows in six
           files, one scan task each (scan.taskTargetBytes = 4 MiB, below
           one ~4.6 MiB file), the same way: the rows held against a
           pyarrow group_by and a numpy rank of the same files (keys and
           ranks exact, sums within REL_TOL; two rows of one store whose
           sums agree within REL_TOL may come in either order);
           hash_columns must launch once per non-empty map batch of its
           two hash exchanges (the range exchange of its ORDER BY hashes
           nothing) and hash_string never;
  q3ds     TPC-DS q3 (date_dim JOIN store_sales JOIN item, November sales
           of manufacturer 128's brands by year, ORDER BY year, sales DESC,
           brand LIMIT 100) over the whole calendar (73 049 days), 18 000
           items and 6 x 2^20 store_sales rows in six files, a scan task
           each, the same way: two broadcast joins (date_dim built left,
           item built right), a runtime filter from date_dim's keys on the
           store_sales scan, whose two Bloom lanes K1 hashes; the 100 rows
           held against a pyarrow join / group_by / sort (keys exact, sums
           within REL_TOL, rows tied on sales may trade places); the
           filter's state, what it pruned and the rows each scan uploaded
           from one more run; then all of it again with the filter off,
           whose rows must be the same.  hash_columns must launch once per
           non-empty map batch of the aggregate's exchange plus twice per
           non-empty batch the filter folds plus twice per filter
           published with a range table, and hash_string never;
  trace    the observability and dispatch layer (trace/, ledger,
           telemetry, the program cache, deferred readbacks) on q3 (the
           static partition-wise plan, filter on) and q3ds (filter on)
           at the sizes above: A. each query untraced (a counted run),
           then with tracing, the device ledger and telemetry on (its
           session's conf), the results bit for bit equal to each other
           and held against the pyarrow references; B. the span and
           event names the JAX package records for them present, every
           span of a pool, stage or reaper thread carrying the query's
           id, and each name's count and total ms; C. the Chrome trace
           (TorchSession.export_trace) parsed, its event count; D. the
           union of the ledger's event windows at most the query's
           wall, the kernel.hash_columns program's dispatches equal to
           the K1 launches of that run, its window ms (an upper bound
           of its device time) beside torch.profiler's
           hash_columns_kernel time of the same run; E. the readbacks
           per tag (stage_snapshot) beside the planned map batches, and
           the syncs torch.cuda.set_sync_debug_mode("warn") reports
           outside device_read* in one q3 run, with their top sites (a
           finding, not a check); F. TRACE_PAIRS off/on pairs of walls
           in alternating order, and whether Event.synchronize (the
           settle worker's and the reaper's wait) releases the GIL: a
           spin loop's iterations beside a thread waiting on an event,
           at least half those alone; G. no telemetry, settle or
           reaper thread after disable();
  scan_host
           the scan's host path (io/scan.py, io/fastpar.py) on q6, q1
           and q3ds at the sizes above, with scan.fastDecode on (the
           native decoder, which filters on the Parquet dictionaries)
           and off (pyarrow, the default), one line each (``scan_host_<query>``):
           for each setting the scans' counters from one kept run
           (files on the fast and the standard path, rows decoded,
           filtered on the host, pruned by the runtime filter and
           uploaded, row groups pruned on the footers), the scans
           alone serially and pooled with their host split, and
           SCAN_HOST_PAIRS pairs of walls in alternating order; every
           result held against the query's reference, every lineitem
           and store_sales file on the fast path when it is on, and no
           TpuFilterExec in q6's plan (the scan applies its condition
           on the host, exactly);
  wire     the scan's wire path (columnar/transfer.py: the host
           encode, every component in one pinned buffer and one copy,
           the device decode; columnar/compression/: the array codecs)
           on q6, q1 and q3ds at the sizes above, on three upload paths:
           sql.scan.packedUpload off, on, and on with
           sql.wireCompression.enabled (default codecs), one line each
           (``wire_<query>``): A. each path's rows bit for bit the plain
           path's (floats by their bits, rows in a canonical order) and
           held against the query's reference; each codec alone on q1
           the same; B. per path the batches, bytes and copies per batch
           (upload_stats: one copy a wire batch), the plan's component
           kinds (bias8/16/32, dict, scaled, raw, null, sdict, sraw) and
           the codec chooser's picks and ratios; C. the scans' host
           split of one kept run (decode, encode, pin, host copy, copy
           enqueue, upload wait), the wire.decode program's dispatches
           (one a batch) and event-window ms a batch from the device
           ledger, and the fact scan's first batch decoded alone under
           torch.profiler (kernels, their device ms); D. WIRE_ROUNDS
           rounds of walls, the order rotating; F. K1's launches equal
           on the three paths, its calls held against its plain version
           in ``main``.  ``wire_spill`` (E): q3's exchange blocks (the
           static plan) under a plugin brought up with
           memory.spill.compressHostTier and spill.compression.codec
           zlib, spilled to host frames (stored bytes below raw), then to
           disk (TPUB frames naming zlib), read back through the plan:
           the rows bit for bit an unspilled run's.  ``wire``: the
           medians wire / plain and compressed / plain per query, and
           whether the wire path was no slower on all three (what sets
           packedUpload's port default);
  q93      TPC-DS q93 over the same store_sales files and a store_returns
           derived from them (~10 % of the sales rows, the spec's SF1
           ratio; each return copies the keys of a sale) with the ten
           reasons, the same way: store_sales LEFT OUTER JOIN
           store_returns, too large to broadcast, plans with the
           adaptive key off a partition-wise shuffled join (a hash
           exchange on each side's (LONG, LONG) key; the default's
           adaptive join is the adaptive phase's aqe_coalesce), and the
           one reason row broadcasts; no runtime filter;
           the 100 rows held against a pyarrow left outer join /
           filter / CASE / group_by / sort (customers exact, sums within
           REL_TOL, rows whose sums tie may trade places); hash_columns
           must launch once per non-empty map batch of its three
           exchanges and hash_string never;
  formats  the file formats (``formats_phase``) over q3ds's store_sales
           and q6's lineitem: A. the store_sales columns q3ds and q93
           read (6 x 2^20 rows) written as ORC by df.write.orc (one
           file a scan task), q3ds over the ORC directory equal to
           q3ds over the Parquet files by pyarrow.Table.equals; B. one
           file (2^20 rows) through write.csv and read_csv(schema=),
           equal to the Parquet file; C. sum(ss_net_paid) and count(*)
           by store and date (a sale with no customer booked to no
           store, so the NULL directory has rows) through K1's exchange,
           written partition_by("ss_store_sk") as Parquet with the split
           on the card and again by the host loop (host_split):
           directories and rows equal to pyarrow.dataset's Hive write of
           the pyarrow reference (dates and counts exact, sums within
           REL_TOL), then read back with ss_store_sk = 1 and IS NULL,
           each keeping its directory's files only (filesPruned); D.
           tpch.q6_substrait() and q1_substrait() through
           SubstraitFrontend equal to the DataFrames by Table.equals,
           with the same K1 launches; every part's launches equal its
           planned map batches; files, bytes, writeTime, splitTime and
           the walls;
  ops      the query history, the event log, the connect server and the
           ops plane (``ops_phase``): a ConnectServer in this process
           (event log on, gzip; ops plane on an ephemeral port; the
           device ledger on) takes q1 and q6 as Substrait plans and
           q3ds as its SQL text from a client process that imports no
           torch and no engine module (its sys.modules is printed); the
           results equal the q1, q6 and q3ds references; while q1 runs,
           /queries shows it and two /metrics scrapes see no counter
           fall; tools/history reads the log: one record a query with
           its connect section, K1's ledger dispatches in each equal to
           its planned launches (q1 6, q6 0, q3ds its text's counted
           run), no error health finding; explain("analyze") of TPC-H
           q3 (its root 10 rows), a prepared q3 executed twice (each
           record's root 10 rows), and q3 with the event log on and off
           in OPS_PAIRS alternating pairs, with nvidia-smi's name and
           power limit;
  surface  the session's and the planner's last surface
           (``surface_phase``): q1 through collect(), to_batches
           (SURFACE_BATCH_ROWS) and rows(), all equal; q6's filter and
           projection through to_device_arrays() (tensors on the card,
           the revenue sum equal to q6's); q1 and q6 with
           spark.rapids.tpu.sql.enabled off, collected and prepared:
           every node a CPU fallback on purpose with the switch's reason
           in explain(), equal to the references, no ledger dispatch and
           no K1 launch, their walls beside the device walls; the
           cost-based demotion on (q6 stays on the card; q1 and the
           2000-row sandwiched island demote whole with its reason, as
           under the JAX cost model); TPC-H q3 at
           sql.topn.maxRows 5 (a full sort) equal to the top-n run;
           q3ds with a Bloom-only filter (minMaxEnabled off, fpp 0.5)
           equal to the default run, no rf# at maxBuildRows 10;
           collect_metrics() at each sql.metrics.level; a CSV TIMESTAMP
           in four spellings read on the card (F8);
  speculation
           the speculative output sizing (parallel/speculation.py) on
           q3 (the static partition-wise plan), q1 and q93 at the sizes
           above, each with sql.speculation.enabled on (the default,
           predictors reset before its first run) and off:
           A. every run's result equal to the first off run's (bit for
           bit, or keys exact and floats within REL_TOL, said which)
           and held against the query's pyarrow reference; B. per tag
           (join.probe, agg.size, exchange.split) and run: the loop's
           dispatches, blocking, async and late readbacks (a late one
           had not landed when asked for), hits, overflows, warm-up
           syncs, the joins' declined dispatches (past the in-flight
           budget) and continuation chunks, and each join exec's hits
           and overflows; after the first on run (the warm-up prefix)
           no blocking join.probe read but late ones, none declined,
           and every join exec speculated; each loop's dispatch half under
           torch.cuda.set_sync_debug_mode("error") in a serial run
           (any sync raises); C. the syncs outside device_read* of one
           q3 run on and off, per site; D. q3 under a forced undershoot
           (testForceCapacity SPEC_UNDER: overflows, same rows) and at
           the chunk ceiling (no overflow; the join's own output has
           the off run's rows and no NULL key: no dead row); E. the
           kill switch (adaptive.minHitRate 0.99, window 2, the forced
           undershoot) convicting join.probe, whose next run reads
           blocking with the same rows, disabled_total() >= 1; F. the
           device ledger's live_capacity_ratio of the speculated
           programs (join.expand, agg.update) on q3, below 1 on and
           exactly 1 off; G. K1's launches equal on and off in every
           pair, its calls held against its plain version in ``main``;
           H. SPEC_PAIRS on / off pairs of walls in alternating order,
           and one profiled run of each side (device busy, idle share,
           kernels, the kernel counts that differ);
  star     TPC-DS q42, q52 and q55 (the star join under other filters
           and STRING group keys) once each over the same tables, not
           profiled: two broadcast joins and the runtime filter on the
           store_sales scan, the rows held against a pyarrow reference,
           and hash_columns launched as q3ds's rule says;
  q67_rollup
           TPC-DS q67 as written (store_sales x date_dim x store x item,
           months 1200-1211, the sales ROLLUP over eight keys: nine
           grouping sets, an Expand of nine projections under the
           partial aggregate, K1 hashing the 9-column key tuple with
           NULLs where a set drops a key; a rank within each category,
           its NULL one too; the first 100 rows in key order) over q3ds's
           tables and SF1's 12 stores, the same way: three broadcast
           joins, the date filter on the store_sales scan, the rows held
           against a pyarrow reference (nine group_bys concatenated, a
           numpy rank; keys exact, sums within REL_TOL, a rank within
           the span of sums tied within REL_TOL), hash_columns as q3ds's
           rule says; the joined rows, the expanded rows (x 9) and the
           groups;
  q5       TPC-DS q5's store channel: store_sales UNION ALL q93's
           store_returns (the union's partitions its members', seven),
           two weeks of dates and the 12 stores, summed by store id, the
           same way: two broadcast joins, no runtime filter (none
           reaches through a union, as in the JAX plan), the rows against
           pyarrow;
  q27      TPC-DS q27 with SF1's 1 920 800 customer_demographics rows
           (too large to broadcast: a partition-wise shuffled join whose
           runtime filter prunes the store_sales scan) and the three
           grouping sets of (item id, state): the text's states match
           no store, so it gives 0 rows and, its store join's build side
           empty, launches nothing (one run, no profile); the variant
           asks for the state most stores are in, and its 100 rows are
           held against pyarrow; both with the adaptive key off, and the
           variant once more under the default keys
           (``variant_adaptive``: an adaptive join, its decision);
  agg_family
           store_sales in (ticket, item) order (a range exchange and a
           sort of each partition) grouped by store with min, max, first
           and last (NULLs kept and skipped), and COUNT(DISTINCT
           ss_customer_sk) by store, each against pyarrow: the first and
           last rows of the stable sort, exact;
  sql      the 22 store-channel TPC-DS texts as written
           (``tpcds_queries.STORE_CHANNEL``) through
           ``SqlSession(device="cuda")`` over the 13 store-channel tables
           (``tpcds.write_store_channel``: q3ds's six store_sales files,
           q93's store_returns, the whole calendar and every dimension at
           its SF1 count), one line each (``sql_text``): the plan's
           joins, the rows, one profiled run (device busy, idle share,
           kernel count; no scans-alone breakdown) that is also the
           counted run, timed (SQL_SINGLE_RUN: no warm-up), and
           hash_columns launches equal to runs x (the map batches, filter folds and range tables a run
           reaches, and what planning launches: q24's scalar subquery
           runs while its query is planned); a text that gives 0 rows
           runs its variant (``tpcds_queries.variant``) next.  A text
           with a hand-built twin (q3, q42, q52, q55, q93, q67, q5, q27's
           variant) is held against the twin's pyarrow reference; every
           other against the port's device="cpu" run of the same text
           over SQL_CPU_FILES of the store_sales files, which the card
           runs once more for it (integers, strings and NULLs exact,
           floats within REL_TOL, rows as multisets);
  types    the scalar types over the same data (``types_phase``): q3,
           q42, q52 and q55 through the SQL frontend over store_sales
           written again with its twelve money columns DECIMAL(7,2)
           (INT32 in Parquet), no CPU node, their DECIMAL(17,2) sums
           exactly pyarrow's decimal group_by and 100 x the DOUBLE
           text's rounded to cents; q7 and q27 (and its variant) with
           exactly their Aggregate on the CPU engine (a decimal
           average, the JAX reason in ``explain()``), their rows
           against pyarrow's averages of the decimals as DOUBLE over
           the six files (within REL_TOL), and on one file their rows
           and transitions against the port's CPU run; then a
           TIMESTAMP, TINYINT, SMALLINT and FLOAT column beside the
           DECIMAL one in two queries whose exchanges hash a key of
           each new type, exactly pyarrow's; one ``types_text`` line a
           text (its one run profiled, counted and timed, as the sql
           texts', K1 launches against the planned map batches; the
           two type queries: a profiled run that is the warm-up, one
           counted run, timed), then the ``types`` line;
  nested   arrays, structs and maps (``nested_phase``) over q3ds's
           store_sales files, the sql phase's dimensions and 100 000
           customers: ``baskets`` (collect_list of items and
           collect_set of stores per customer: an exchange on the
           customer, the partitioned collect; every array ascends and
           equals pyarrow's list / distinct aggregation sorted),
           ``explode_back`` (posexplode of the items, counted per item
           through an exchange on the exploded column, against
           pyarrow's value_counts; size, get_item, element_at and
           array_contains over the baskets against pyarrow's count,
           min, max and membership), ``baskets_joined`` (the baskets
           joined to customer with the broadcast threshold off and the
           adaptive key off: both sides hash-exchanged, the arrays
           gathered, parked and concatenated; ``baskets_joined_adaptive``
           the same under the default keys: an adaptive join, its
           decision), ``q43_pivot`` (q43's join as a pivot of seven
           masked sums, equal to the sql phase's q43 text rows) and
           ``nested_scan`` (the files written again with a struct and a
           map column, filtered on a struct field, a map value
           summed, against pyarrow's struct_field / map_lookup; one
           file's nested columns round trip to Arrow exactly); a
           ``nested_query`` line a query (a profiled run that is the
           warm-up, one counted run, timed, K1 launches against the
           planned map batches, no CPU node), then the ``nested`` line;
  long_tail
           the expression long tail (``long_tail_phase``) over the same
           store_sales files and the sql phase's SF1 dimensions:
           ``names`` (customer JOIN customer_address, each written again
           in LONG_TAIL_SPLIT files, broadcast off so both sides are
           hash-exchanged; concat_ws / initcap / lower, lpad, rpad, a
           plain regexp_replace, substring_index, locate and split()[1],
           grouped by (split()[1], regexp_replace): every column against
           Python's str methods), ``tickets_md5`` and ``tickets_bucket``
           (md5 of concat_ws(ticket, item), (ticket >> 4) & 1023 and
           item ^ customer, grouped by the md5's first two characters
           over MD5_FILES files and by the bucket over six: against
           numpy and hashlib, one file's md5 column row for row),
           ``sample`` (a Filter rand(42) < 0.05,
           then monotonically_increasing_id, spark_partition_id,
           input_file_name and rand projected and grouped by partition
           and file: each file's count is the rows the threefry recipe
           keeps, the ids unique and carrying their partition, the
           draws the recipe's, the sample within 5 standard
           deviations), ``ansi`` (ticket * quantity summed by store with
           spark.rapids.tpu.sql.ansi.enabled on: one poll a batch, the
           rows those of the key off; an overflowing Multiply, a zero
           divisor and a malformed cast raise the JAX messages and,
           with the key off, wrap or give NULL as numpy does), and four
           plans with one CPU node each (get_json_object, a bare split,
           a real regex, ORDER BY rand) against Python's json / re / the
           recipe, their transitions counted; one ``long_tail_query``
           line a query (a profiled run that is the warm-up, one counted
           run, timed, K1 launches against the planned map batches), then
           ``long_tail`` with md5 of one MD5_BATCH_ROWS batch profiled
           (K7's launches and device time);
  python   the cache, the Python execs and the UDF tiers
           (``python_phase``) over the same six store_sales files and
           q93's store_returns: ``cache_sales`` (ss_quantity > 10,
           five columns, cached; by store and by item, three collects
           each: the first against pyarrow, the rest bit for bit the
           first, reading no file, cacheHits the cached batches, K1 the
           map batches; the store's device bytes back after
           unpersist(); the uncached, materializing and served walls),
           ``cache_consumers`` (a Filter, a torch UDF adding to its
           input in place, an ORDER BY and a join over one cache, three
           rounds, a spill to host before the third, bit for bit),
           then one ``python_query`` line each for ``udf_compiled``,
           ``udf_torch``, ``udf_opaque`` (one CPU node, over the first
           file), ``map_in_arrow`` and, with pandas, ``map_in_pandas``,
           ``apply_in_pandas``, ``agg_in_pandas``, ``cogroup`` and
           ``transform_in_pandas`` (over the first file), each against
           pyarrow or numpy with a profiled run and one counted run;
           ``python`` with the compute processes nvidia-smi lists while
           a worker pool is live (one: the children see no card);
  adaptive adaptive execution (``adaptive_phase``) over the same six
           store_sales files and q93's store_returns: ``aqe_broadcast``
           (store_sales JOIN the returns of q93's reason, four columns,
           by (item, ticket), summed by customer: estimated over the
           broadcast threshold, measured under it, so a runtime
           broadcast of the right side; the runtime filter prunes the
           store_sales scan, its build's map stage first; the store's
           device bytes back after the query), ``aqe_coalesce`` (q93 as
           written: the left outer join on coalesced reduce groups) and
           ``aqe_skew`` (half the tickets' item made one hot key, JOIN
           item, money summed in cents by category, broadcast off: the
           hot reduce partition split into block-wise slices, each read
           without a second map stage and holding rows): each one
           profiled run, counted and timed, its decision and counters,
           its rows against pyarrow, and ADAPTIVE_PAIRS pairs with the
           adaptive key on and off in alternating order, the same rows
           both ways (bit for bit; q93's DOUBLE sums, which coalescing
           adds in another order, within REL_TOL); ``round_robin`` (the
           six files dealt into 8 partitions: sizes within a map batch
           a partition of each other, the rows the files', no K1) and
           ``take_ordered`` (TpuTakeOrderedAndProjectExec: the top 100
           by ss_net_paid, two columns, pyarrow's, ties free); an
           ``adaptive_query`` line a workload, then ``adaptive``.  The
           sql, channel and concurrency lines carry each adaptive
           join's decision;
  channels the 29 catalog and web TPC-DS texts the JAX sweep runs
           correctly (``tpcds_queries.CATALOG_WEB``) the same way, over
           those 13 tables and the 11 channel tables at SF1's rows
           (``tpcds.write_channels``: catalog_sales 1 441 548 rows in 3
           files, web_sales 719 384 in 2, their returns, inventory
           11 745 000 in 6, and the six dimensions), one
           ``channel_text`` line each: the plan's joins and CPU nodes
           (only q37's date_dim Filter, whose two transitions are
           counted against date_dim's rows and the rows it keeps; no
           other text plans one), the rows, one profiled run that is
           also the counted run, timed (CHANNEL_SINGLE_RUN: no warm-up),
           K1 launches
           as the plan says; q97 and q82 held against pyarrow over the
           full tables, every other text against
           ``cpu/engine.execute_cpu`` of its logical plan over the first
           file of each fact table, which the card runs once more (q72
           reads the first Q72_INVENTORY_ROWS of inventory, card and
           reference alike: at 2^20 its store passes the device budget
           and spills to disk); a text that gives 0 rows runs its
           variant; each record carries its store peak and
           torch.cuda.max_memory_allocated;
  fallback q3ds and q93 over one store_sales file with each of the
           Filter, Project, Aggregate, Join and Sort switches off in
           turn (the rows equal the all-on run's, ``explain()`` marks
           exactly those nodes, K1 as planned), then a left outer join
           with a residual condition, min / max over strings and a
           keyless left join, each planned on the CPU engine and held
           against pyarrow.  Every other phase's plans must hold no
           CpuFallbackExec;
  serving  the serving tier: SERVING_SESSIONS SqlSessions on the card
           in as many threads over two tenants (t0 at priority 1, t1 at
           4), serving.maxConcurrent 2 and queueDepth 40, over the sql
           phase's tables.  Each pair (one session of each tenant)
           prepares one of q3, q42, q52 and q55 with its constants made
           :params (SERVING_TEMPLATES) and
           executes it 4 times, 2 bindings each twice: every result
           equal, by table_digest, to a serial uncached collect of the
           text with the literals written in; every repeat a plan-cache
           hit that enters plan_query 0 times (each first execution of
           a binding once); then execute_stream equal to its collect,
           a q93 stream cancelled from another thread after its first
           batch (QueryCancelled; the store back to its bytes, 0
           running, every semaphore permit free), and two tenants
           running one text at once with serving.sharing.enabled (a
           result-cache hit, equal digests).  Prints p50 / p99 latency
           (and each tenant's), queries a second, the admission wait's
           p50 / p99 (and each tenant's), the plan-cache
           hit rate and K1's launches beside nvidia-smi's line.  Every
           session shares the process store and task semaphore
           (``plugin.py``), brought up at the start of the run;
  persist  the warm-start store (persist.py) and the operator tools.
           tools/cold_start children, each a fresh process on the card,
           one after another, over its four-file fixture (q1's scan ->
           filter -> aggregate through a hash exchange -> sort):
           persistence off, an empty store, the warm store, then, once
           this process has written the result tier (the fixture in the
           result-tier mode, serving.sharing.enabled set), a child in
           that mode restoring it; equal digests and rows everywhere,
           held against the same query in this process and a pyarrow
           reference; off, empty, warm and the writer equal in ledger
           dispatches and K1 launches (a map batch each), compiles 0;
           the warm child's plan_hits 1 and prepares 2; the restoring
           child's result_hits 1, no dispatch and no K1 launch; each
           child's wall, import and context times.  Then qualify over
           the 51 texts of the sql and channels phases (fallback nodes
           beyond an unrewritten scalar subquery's, as the JAX tool
           counts them, only in q37, as their cpu_nodes);
           api_validation's counts (nothing missing, no drift);
           ``tools.top --once`` as a process against the ops plane
           while a prepared q3's stream is open; tools.trace over a
           script running the fixture; and a sweep slice of q3, q42
           and q52 through the oracle and the connect wire subset;
  memory   the memory runtime on the card.  Spill: q93, q67_rollup and
           q72 (at its inventory cut) under memory.hbm.budgetBytes = a
           quarter of the query's unconstrained store peak and
           memory.host.spillStorageSize = a half, so batches go to host
           and on to disk (q72 over the first Q72_MEMORY_ROWS inventory
           rows); each result equal to the unconstrained
           run's rows bit for bit, with the store's spill bytes per
           hop, restores, time inside spill and restore, its peak
           device_used gauge beside torch.cuda.max_memory_allocated,
           and an empty leak_report (each run on a store of its own:
           the plugin restarts with the budget keys, then without).
           Forced split: q93 and q1's
           grouped aggregate serially under robustness.faults.spec
           exec.batch:nth=3,times=2: splits > 0, no task retry, the
           result equal to the unconstrained run's (floats within
           REL_TOL), K1's launches = the planned map batches + the
           exchanges' ladder re-runs.  Real OOM: OOM_QUERY serially, in
           a child process (``--oom-step``) so that no earlier phase's
           tensors shape the allocator, under
           torch.cuda.set_per_process_memory_fraction(f), f the
           share of the card that is the allocator's reserved bytes
           before it + OOM_SHARE of its unconstrained peak above the
           allocated bytes before it: at least one
           torch.cuda.OutOfMemoryError absorbed by the ladder and the
           result equal to the unconstrained run's; the fraction goes
           back to 1.0 however the step ends.  Out-of-core sort: ORDER
           BY every column of q6's 6 x 2^20 lineitem rows, no LIMIT,
           sort.rangeExchange off, so the global sort passes
           sort.singleBatchRows (2^21): rows equal to pyarrow's
           sort_indices order, with its buckets and host-parked rows.
           Every earlier phase must leave retry_stats() and every
           store's spill counters at zero;
  concurrency
           q6, q1, q3 (filter on), q67, q3ds and q93 at the sizes above,
           and q67_rollup and q5,
           each serially (config.SERIAL: one task thread, one decode
           thread, no stages) and pooled (the default keys) in
           alternating pairs (CONCURRENCY_PAIRS, NEW_PAIRS for the
           last two) after a warm-up of each:
           every result equal to the first serial one by
           pyarrow.Table.equals (floats included), the K1 launches of
           every run equal, and no stage or pool thread alive after any
           run; both walls of every pair, the medians, the pairs the
           pooled run won, and one profiled run of each side (device
           busy, idle share, kernel count: the profiler sees the pool
           threads' kernels);
  main     hash_columns at the calls q1, q3 (filter off and on, and
           adaptive), q67,
           q3ds, q93, the star queries, q67_rollup, q5, q27, agg_family,
           the sql, types and channel texts, the nested, long_tail,
           python and adaptive queries and the fallback phase made,
           and the ``new_types`` mix at 6 x 2^20 rows (the
           largest call of
           each key signature and seed in each phase: the filters'
           lanes and range tables hash from seeds 42 and 0x9747B28C),
           and hash_string on one of q1's key columns, against their
           plain versions, with the device's own time per launch
           (torch.profiler kernel time over a loop) and the
           host-inclusive time per call (host clock over the same loop)
           reported apart; a call under TIMED_MIN_ROWS rows that is not
           its phase's largest is checked and not timed.
Then the per-kernel summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure raises before that line and
exits non-zero.  Without CUDA, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import datetime
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the 32-bit rate
#: outside the tensor cores, which bounds the integer mixing arithmetic
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

#: direct loads up to 56, staged from 57 (kernels.NARROW_WIDTH)
EXACT_WIDTHS = (1, 2, 3, 4, 5, 7, 8, 16, 33, 56, 57, 64, 128, 200)
#: staged through shared memory, and read straight from global memory
WIDE_WIDTH, DIRECT_WIDTH = 256, 8000
#: (and 65 537 until the memory phase and q72's larger cut pushed the
#: run past 750 s on an H100 80GB HBM3 at 700 W)
EXACT_ROWS = (1, 1023, 1025)
#: the row counts DIRECT_WIDTH (and the mix holding it) is checked at:
#: its plain version takes ~2 s a call on the card (EXACT_ROWS until the
#: channels phase pushed the run past 750 s on an H100 80GB HBM3 at
#: 700 W; (1, 1025) until the types phase took the run to 780 s, past
#: the 717 s before it, on an H100 80GB HBM3 at 700 W: every other
#: width is checked at 1 row).  The mix holding it is checked at
#: DIRECT_ROWS hashed and, on a row slice, partitioned (each row count
#: x EXACT_PARTITIONS, a slice and a seed until then)
DIRECT_ROWS = (1025,)
#: (0 = hashes; 1 and 8 until the sql phase pushed the run past ten
#: minutes on an H100 80GB HBM3 at 700 W: 8 stays in the unaligned case)
EXACT_PARTITIONS = (0, 200)
#: rows cut off the front of a matrix so its data_ptr() is unaligned
SLICE_ROWS = 3
TIMED_ROWS = 6 * (1 << 20)
#: hash_string's timed widths: one under and one over the 56 bytes a
#: string stages through shared memory (1, 16, 64 and 256 until the
#: python phase needed the run's time; the kernel has had no main-path
#: launch since PR 2; the timed part took 17.1 s on an H100 80GB HBM3
#: at 700 W)
TIMED_WIDTHS = (16, 64)
#: hash_columns' timed tuple: (STRING W=16, LONG, DOUBLE), 20 % NULLs
TIMED_TUPLE = (("string", 16), ("long",), ("double",))
TIMED_PARTITIONS = 8
NULL_SHARE = 0.2
#: type mixes of the exact check (17 columns: two launches, chained)
MIXES = {
    "timed": TIMED_TUPLE,
    "all_types": (("bool",), ("int",), ("date",), ("long",), ("double",),
                  ("string", 3), ("string", 64)),
    "strings": (("string", WIDE_WIDTH), ("string", 2), ("string", 128)),
    "direct": (("string", DIRECT_WIDTH), ("string", 5), ("int",)),
    "new_types": (("tinyint",), ("smallint",), ("float",), ("timestamp",),
                  ("decimal",), ("string", 16), ("long",)),
    "chained_17": (("string", 1), ("int",), ("long",), ("double",),
                   ("string", 7), ("bool",), ("date",), ("string", 33),
                   ("long",), ("string", 4), ("double",), ("int",),
                   ("string", 1), ("bool",), ("string", 200), ("date",),
                   ("string", 16)),
}
TASK_TARGET_BYTES = 8 << 20
#: q67: six files of 2^20 store_sales rows, ~4.6 MiB each, a task each
Q67_ROWS, Q67_FILES, Q67_TASK_TARGET_BYTES = 6 << 20, 6, 4 << 20
#: q3ds: six store_sales files of 2^20 rows and 23 columns, a task each
Q3DS_FILES, Q3DS_ROWS_PER_FILE, Q3DS_TASK_TARGET_BYTES = 6, 1 << 20, 8 << 20
REL_TOL = 1e-9
#: launches timed at each main-path shape: the kernel's, and its plain
#: version's (tens to hundreds of PyTorch kernels a call, so fewer; 10
#: until the run passed 9 minutes; 50 and 5 until the channels phase
#: pushed it past 750 s on an H100 80GB HBM3 at 700 W).  The plain
#: version is timed by the host clock only (also under torch.profiler
#: until the types phase took the run to 780 s, past the 717 s before
#: it, on an H100 80GB HBM3 at 700 W)
KERNEL_ITERS, PLAIN_ITERS = 20, 2
#: main-path calls below this many rows are checked, not timed, unless
#: they are their phase's largest (all were until the sql phase pushed
#: the run past ten minutes on an H100 80GB HBM3 at 700 W)
TIMED_MIN_ROWS = 1 << 14
#: serial / pooled pairs of each earlier query in the concurrency phase
#: (4 until the run passed 9 minutes, 2 until the sql phase pushed it
#: past ten, on an H100 80GB HBM3 at 700 W), and of q67_rollup and q5
CONCURRENCY_PAIRS, NEW_PAIRS = 1, 1


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script began."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - _START,
                      **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn over iters launches, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def string_inputs(torch, n: int, width: int, gen):
    """Random bytes (>= 0x80 included), lengths 0..W, zeroed padding."""
    dev = gen.device
    chars = torch.randint(0, 256, (n, width), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    lengths = torch.randint(0, width + 1, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    pad = torch.arange(width, device=dev)[None, :] < lengths[:, None]
    return (chars * pad).contiguous(), lengths


def random_seeds(torch, n: int, gen):
    return torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                         device=gen.device, dtype=torch.int64).to(
                             torch.int32)


def k1_bound_ms(torch, lengths, width: int) -> tuple[float, str]:
    """Least time for hash_string on these inputs: bytes (N*W chars +
    4N lengths + 4N seeds read, 4N hashes written) over HBM bandwidth,
    or the integer operations these lengths need over the 32-bit ALU
    rate (~15 per 4-byte block, ~11 per tail byte, ~12 for fmix and the
    loads of length and seed), whichever is larger."""
    n = int(lengths.shape[0])
    lens = lengths.clamp(0, width).long()
    blocks = int((lens // 4).sum())
    tails = int((lens % 4).sum())
    ops = 15 * blocks + 11 * tails + 12 * n
    return bound(n * width + 12 * n, ops)


def bound(n_bytes: float, ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tile_of(geo) -> dict:
    return {"threads": geo.threads, "pitches": geo.pitches,
            "smem_words": geo.smem_words}


def check_k1(torch, kernels, dev) -> dict:
    """hash_string against its plain version, bit for bit, with chained
    seeds, over every width and row count, and over row slices whose
    data_ptr() is not 4-byte aligned."""
    def staged(width):
        return kernels.tile_geometry([(kernels.STRING_TAG, width)],
                                     max(EXACT_ROWS)).pitches[0] > 0

    if (staged(DIRECT_WIDTH) or not staged(WIDE_WIDTH) or staged(56)
            or not staged(57)):
        raise AssertionError("the widths no longer take the branches "
                             "they are meant to check")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    checked = 0
    widths = EXACT_WIDTHS + (WIDE_WIDTH, DIRECT_WIDTH)
    for width in widths:
        for n in DIRECT_ROWS if width == DIRECT_WIDTH else EXACT_ROWS:
            c1, l1 = string_inputs(torch, n, width, gen)
            c2, l2 = string_inputs(torch, n + SLICE_ROWS, width, gen)
            c2, l2 = c2[SLICE_ROWS:], l2[SLICE_ROWS:]
            seeds = random_seeds(torch, n, gen)
            k = kernels.hash_string(c1, l1, seeds)
            r = kernels.hash_string_bytes_reference(c1, l1, seeds)
            k2 = kernels.hash_string(c2, l2, k)  # chained: hash seeds next
            r2 = kernels.hash_string_bytes_reference(c2, l2, r)
            torch.cuda.synchronize()
            for got, want in ((k, r), (k2, r2)):
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(
                        f"hash_string disagrees with its plain version at "
                        f"N={n} W={width}: {bad} rows differ")
            checked += 2
    return {"cases": checked, "widths": list(widths),
            "rows": list(EXACT_ROWS), "direct_rows": list(DIRECT_ROWS),
            "sliced_rows": SLICE_ROWS,
            "max_abs_err": 0}


def make_column(torch, spec: tuple, n: int, gen, offset: int = 0):
    """One random column of ``spec`` with NULL_SHARE NULLs; doubles and
    floats hold -0.0, 0.0 and NaNs with several payloads (floats +/-inf
    too), tinyints and smallints their MIN_VALUE, timestamps instants
    before 1970, decimals negative values.  ``offset`` > 0 cuts that
    many rows off the front of every tensor (unaligned data_ptr())."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import Column, StringColumn

    dev = gen.device
    m = n + offset
    valid = (torch.rand(m, generator=gen, device=dev) >= NULL_SHARE)[offset:]
    kind = spec[0]
    if kind == "string":
        chars, lengths = string_inputs(torch, m, spec[1], gen)
        return StringColumn(chars[offset:], lengths[offset:], valid)
    if kind == "double":
        x = torch.randn(m, generator=gen, device=dev,
                        dtype=torch.float64) * 1e6
        x[::7] = -0.0
        x[1::11] = 0.0
        x[2::13] = float("nan")
        bits = x.view(torch.int64)
        bits[3::13] = 0x7FF0000000000001      # signalling NaN payload
        bits[4::17] = -0x0008000000000000     # 0xFFF8...: negative NaN
        return Column(x[offset:], valid, T.DOUBLE)
    if kind == "float":
        x = (torch.randn(m, generator=gen, device=dev) * 1e3).float()
        x[::7] = -0.0
        x[1::11] = 0.0
        x[2::13] = float("nan")
        x[5::19] = float("inf")
        x[6::23] = float("-inf")
        bits = x.view(torch.int32)
        bits[3::13] = 0x7F800001              # signalling NaN payload
        bits[4::17] = -0x00400000             # 0xFFC00000: negative NaN
        return Column(x[offset:], valid, T.FLOAT)
    if kind in ("tinyint", "smallint"):
        dtype = torch.int8 if kind == "tinyint" else torch.int16
        info = torch.iinfo(dtype)
        data = torch.randint(info.min, info.max + 1, (m,), generator=gen,
                             device=dev, dtype=torch.int32).to(dtype)
        data[::9] = info.min
        return Column(data[offset:], valid,
                      T.BYTE if kind == "tinyint" else T.SHORT)
    if kind == "timestamp":  # microseconds, before 1970 too
        data = torch.randint(-(1 << 55), 1 << 55, (m,), generator=gen,
                             device=dev, dtype=torch.int64)
        return Column(data[offset:], valid, T.TIMESTAMP)
    if kind == "decimal":  # negative unscaled values too
        data = torch.randint(-(10 ** 17 - 1), 10 ** 17, (m,), generator=gen,
                             device=dev, dtype=torch.int64)
        return Column(data[offset:], valid, T.DecimalType(17, 2))
    if kind == "bool":
        data = torch.randint(0, 2, (m,), generator=gen, device=dev).bool()
        return Column(data[offset:], valid, T.BOOLEAN)
    if kind == "long":
        data = torch.randint(-(1 << 62), 1 << 62, (m,), generator=gen,
                             device=dev, dtype=torch.int64)
        return Column(data[offset:], valid, T.LONG)
    data = random_seeds(torch, m, gen)
    return Column(data[offset:], valid, T.DATE if kind == "date" else T.INT)


def check_hash_columns(torch, kernels, dev) -> dict:
    """hash_columns against its plain version, bit for bit: every type
    mix x row count x partition count (0 = hashes), each mix once more
    on row slices with unaligned data_ptr(), and once from a seed other
    than 42."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    checked = 0
    for name, mix in MIXES.items():
        if name == "direct":
            cases = [(n, 0, 0, 42) for n in DIRECT_ROWS]
            cases += [(n, SLICE_ROWS, 8, 42) for n in DIRECT_ROWS]
        else:
            cases = [(n, 0, parts, 42) for n in EXACT_ROWS
                     for parts in EXACT_PARTITIONS]
            cases += [(1025, SLICE_ROWS, 8, 42), (1023, 0, 0, 7)]
        for n, offset, parts, seed in cases:
            cols = [make_column(torch, spec, n, gen, offset) for spec in mix]
            seeds = torch.full((n,), seed, dtype=torch.int32, device=dev)
            got = kernels.hash_columns(cols, n, dev, seed, parts)
            want = kernels.hash_columns_reference(cols, seeds, parts)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(
                    f"hash_columns disagrees with its plain version on "
                    f"{name} N={n} offset={offset} partitions={parts} "
                    f"seed={seed}: {bad} rows differ")
            checked += 1
    return {"cases": checked, "mixes": {k: [list(s) for s in v]
                                        for k, v in MIXES.items()},
            "rows": list(EXACT_ROWS), "direct_rows": list(DIRECT_ROWS),
            "partitions": list(EXACT_PARTITIONS),
            "max_abs_err": 0}


def time_k1(torch, kernels, dev, n: int, width: int, gen,
            plain_iters: int) -> dict:
    chars, lengths = string_inputs(torch, n, width, gen)
    seeds = random_seeds(torch, n, gen)
    got = kernels.hash_string(chars, lengths, seeds)
    want = kernels.hash_string_bytes_reference(chars, lengths, seeds)
    max_abs_err = int((got.long() - want.long()).abs().max()) if n else 0
    if max_abs_err:
        raise AssertionError(f"hash_string disagrees at N={n} W={width}")
    t = device_and_host_ms(
        torch, lambda: kernels.hash_string(chars, lengths, seeds), iters=20)
    plain_ms = cuda_ms(
        torch, lambda: kernels.hash_string_bytes_reference(
            chars, lengths, seeds), iters=plain_iters)
    bound_ms, bound_by = k1_bound_ms(torch, lengths, width)
    return {"n": n, "w": width, "ms": t["device_ms"],
            "host_ms": t["host_ms"], "event_ms": t["event_ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / t["device_ms"],
            "max_abs_err": max_abs_err,
            "tile": tile_of(kernels.tile_geometry(
                [(kernels.STRING_TAG, width)], n))}


def tuple_bound_ms(torch, cols, n: int, num_partitions: int):
    """Least time for hash_columns: every column read once (values or
    chars + lengths, and validity), the output written once, over HBM
    bandwidth; or the integer operations the values need (~15 per
    4-byte block, ~11 per string tail byte, ~12 per fmix, ~10 for a
    double's normalisation and ~10 for pmod) over the 32-bit rate."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn

    n_bytes = (8 if num_partitions else 4) * n
    ops = (10 * n if num_partitions else 0)
    for c in cols:
        n_bytes += c.validity.numel()
        if isinstance(c, StringColumn):
            n_bytes += c.chars.numel() + 4 * n
            lens = c.lengths.clamp(0, c.width).long()
            ops += 15 * int((lens // 4).sum()) + 11 * int((lens % 4).sum())
            ops += 12 * n
        else:
            size = c.data.element_size()
            n_bytes += size * n
            ops += (15 * max(1, size // 4) + 12) * n
            if c.data.is_floating_point():
                ops += 10 * n
    return bound(n_bytes, ops)


def time_hash_columns(torch, kernels, dev, n: int, gen) -> dict:
    cols = [make_column(torch, spec, n, gen) for spec in TIMED_TUPLE]
    seeds = torch.full((n,), 42, dtype=torch.int32, device=dev)
    got = kernels.hash_columns(cols, n, dev, num_partitions=TIMED_PARTITIONS)
    want = kernels.hash_columns_reference(cols, seeds, TIMED_PARTITIONS)
    max_abs_err = int((got - want).abs().max())
    if max_abs_err:
        raise AssertionError(f"hash_columns disagrees at N={n}")
    t = device_and_host_ms(torch, lambda: kernels.hash_columns(
        cols, n, dev, num_partitions=TIMED_PARTITIONS), iters=20)
    plain_ms = cuda_ms(torch, lambda: kernels.hash_columns_reference(
        cols, seeds, TIMED_PARTITIONS), iters=3)
    bound_ms, bound_by = tuple_bound_ms(torch, cols, n, TIMED_PARTITIONS)
    return {"n": n, "tuple": [list(s) for s in TIMED_TUPLE],
            "null_share": NULL_SHARE, "partitions": TIMED_PARTITIONS,
            "ms": t["device_ms"], "host_ms": t["host_ms"],
            "event_ms": t["event_ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / t["device_ms"],
            "max_abs_err": max_abs_err,
            "tile": tile_of(kernels.tile_geometry(
                [(kernels.STRING_TAG, 16), (kernels.INT64_TAG, 0),
                 (kernels.FLOAT64_TAG, 0)], n))}


def host_ms(torch, fn, iters: int) -> float:
    """Host-inclusive milliseconds a call: the host clock over ``iters``
    calls after one more, ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_and_host_ms(torch, fn, iters: int) -> dict:
    """The device's own time per call, the host-inclusive time per call
    (host clock over ``iters`` calls ending in a synchronize, profiler
    off) and the CUDA-event time of the same loop, reported apart: where
    the host enqueues a call more slowly than the device runs it, the
    event time is the host's, not the device's.  The device time comes
    from torch.profiler over a second loop of ``iters`` calls, after a
    warm-up loop under the profiler's schedule (it records fewer kernels
    than ran when it starts cold): each kernel's mean time, times how
    many of it a call launches (its count over ``iters``, rounded), so a
    launch the profiler still missed does not lower it;
    ``device_kernels_per_call`` is the count it recorded over ``iters``.
    The profiler now and then records no device event for a loop; it is
    asked up to 3 times, then the event time stands in, and
    ``device_ms_source`` says which it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(2):
        fn()
    host = host_ms(torch, fn, iters)
    event_ms = cuda_ms(torch, fn, iters)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
        device_us = sum(e.self_device_time_total / e.count
                        * round(e.count / iters) for e in kern)
        if device_us > 0:
            return {"device_ms": device_us / 1e3,
                    "device_ms_source": "profiler", "host_ms": host,
                    "event_ms": event_ms,
                    "device_kernels_per_call":
                        sum(e.count for e in kern) / iters}
    return {"device_ms": event_ms, "device_ms_source": "cuda_events",
            "host_ms": host, "event_ms": event_ms,
            "device_kernels_per_call": None}


def signature(cols) -> tuple:
    """A key tuple's column types, strings with their width."""
    return tuple(f"{c.dtype.name}{getattr(c, 'width', '')}" for c in cols)


def at_main_path(torch, kernels, calls: dict) -> dict:
    """hash_columns at the largest call of each key signature each phase
    of the main path made (``calls``: phase -> its calls): held against
    its plain version on the same inputs, then timed both ways where it
    hashes at least TIMED_MIN_ROWS rows or is its phase's largest call
    (a smaller one times the launch, not the kernel)."""
    largest: dict = {}
    for phase, phase_calls in calls.items():
        for call in phase_calls:
            cols, n, seed, parts = call
            key = (phase, signature(cols), seed, parts)
            if key not in largest or n > largest[key][1]:
                largest[key] = call
    phase_top = {}
    for (phase, *_), call in largest.items():
        phase_top[phase] = max(phase_top.get(phase, 0), call[1])
    rows = []
    for (phase, sig, _, _), (cols, n, seed, parts) in largest.items():
        key = (n, sig, seed, parts)
        dev = cols[0].validity.device if cols else torch.device("cuda")
        seeds = torch.full((n,), seed - (1 << 32) if seed >= 1 << 31
                           else seed, dtype=torch.int32, device=dev)
        got = kernels.hash_columns(cols, n, dev, seed, parts)
        want = kernels.hash_columns_reference(cols, seeds, parts)
        err = int((got.long() - want.long()).abs().max()) if n else 0
        if err:
            raise AssertionError(f"hash_columns disagrees at {key}")
        if n < TIMED_MIN_ROWS and n < phase_top[phase]:
            rows.append({"phase": phase, "n": n, "columns": list(sig),
                         "seed": seed, "partitions": parts,
                         "max_abs_err": err, "timed": False})
            continue
        kt = device_and_host_ms(
            torch, lambda: kernels.hash_columns(cols, n, dev, seed, parts),
            iters=KERNEL_ITERS)
        plain_ms = host_ms(
            torch, lambda: kernels.hash_columns_reference(cols, seeds, parts),
            iters=PLAIN_ITERS)
        bound_ms, bound_by = tuple_bound_ms(torch, cols, n, parts)
        rows.append({"phase": phase, "n": n, "columns": list(sig),
                     "seed": seed,
                     "partitions": parts,
                     "max_abs_err": err, "ms": kt["device_ms"],
                     "ms_source": kt["device_ms_source"],
                     "host_ms": kt["host_ms"],
                     "plain_ms": plain_ms,
                     "kernels_per_call": kt["device_kernels_per_call"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "share_of_bound": bound_ms / kt["device_ms"]})
    return max((r for r in rows if "ms" in r), key=lambda r: r["ms"]), rows


def new_types_call(torch, dev) -> tuple:
    """A hash_columns call over the ``new_types`` mix at TIMED_ROWS rows,
    TIMED_PARTITIONS partitions: the scalar types' K1 shape in the
    ``main`` phase's table."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    cols = [make_column(torch, spec, TIMED_ROWS, gen)
            for spec in MIXES["new_types"]]
    return cols, TIMED_ROWS, 42, TIMED_PARTITIONS


def k1_at_main_path(torch, kernels, calls: list) -> dict:
    """hash_string on the first string key column of q1's first call
    (the shape a per-column hash of q1's keys takes), against its plain
    version, timed both ways."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn

    cols, n, seed, _ = calls[0]
    c = next(c for c in cols if isinstance(c, StringColumn))
    seeds = torch.full((n,), seed, dtype=torch.int32, device=c.chars.device)
    got = kernels.hash_string(c.chars, c.lengths, seeds)
    want = kernels.hash_string_bytes_reference(c.chars, c.lengths, seeds)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"hash_string disagrees at q1's ({n}, "
                             f"{c.width})")
    kt = device_and_host_ms(
        torch, lambda: kernels.hash_string(c.chars, c.lengths, seeds),
        iters=KERNEL_ITERS)
    plain_ms = host_ms(
        torch, lambda: kernels.hash_string_bytes_reference(
            c.chars, c.lengths, seeds), iters=PLAIN_ITERS)
    bound_ms, bound_by = k1_bound_ms(torch, c.lengths, c.width)
    return {"n": n, "w": c.width, "max_abs_err": err,
            "ms": kt["device_ms"], "host_ms": kt["host_ms"],
            "event_ms": kt["event_ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def reference_q1(pa, pc, tables) -> dict:
    t = tables.filter(pc.less_equal(tables["l_shipdate"], 10471))
    price, disc = t["l_extendedprice"], t["l_discount"]
    disc_price = pc.multiply(price, pc.subtract(1.0, disc))
    charge = pc.multiply(disc_price, pc.add(1.0, t["l_tax"]))
    t = t.append_column("disc_price", disc_price).append_column(
        "charge", charge)
    g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "sum"),
        ("disc_price", "sum"), ("charge", "sum"), ("l_quantity", "mean"),
        ("l_extendedprice", "mean"), ("l_discount", "mean"),
        ("l_quantity", "count")])
    names = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
             "avg_qty", "avg_price", "avg_disc", "count_order"]
    cols = ["l_quantity_sum", "l_extendedprice_sum", "disc_price_sum",
            "charge_sum", "l_quantity_mean", "l_extendedprice_mean",
            "l_discount_mean", "l_quantity_count"]
    out = {}
    for row in g.to_pylist():
        key = (row["l_returnflag"], row["l_linestatus"])
        out[key] = {n: row[c] for n, c in zip(names, cols)}
    return out


def reference_q6(pa, pc, tables) -> dict:
    t = tables
    cond = pc.and_(
        pc.and_(pc.and_(pc.greater_equal(t["l_shipdate"], 8766),
                        pc.less(t["l_shipdate"], 9131)),
                pc.and_(pc.greater_equal(t["l_discount"], 0.05),
                        pc.less_equal(t["l_discount"], 0.07))),
        pc.less(t["l_quantity"], 24.0))
    t = t.filter(cond)
    rev = pc.sum(pc.multiply(t["l_extendedprice"], t["l_discount"]))
    return {(): {"revenue": rev.as_py()}}


def reference_q3(pa, pc, lineitem, orders):
    """q3 by pyarrow: every (order, date, priority) group with its
    revenue, largest revenue first."""
    li = lineitem.filter(pc.greater(lineitem["l_shipdate"], 9500))
    od = orders.filter(pc.less(orders["o_orderdate"], 9500))
    j = li.join(od, keys="l_orderkey", right_keys="o_orderkey",
                join_type="inner")
    j = j.append_column("rev", pc.multiply(
        j["l_extendedprice"], pc.subtract(1.0, j["l_discount"])))
    g = j.group_by(["l_orderkey", "o_orderdate", "o_shippriority"]) \
        .aggregate([("rev", "sum")])
    return g.sort_by([("rev_sum", "descending")])


def compare_ranked(got_table, want: list, n: int, keys: tuple, got_sum: str,
                   want_sum: str) -> float:
    """Rows of a ranking against the reference's first n (``want``: every
    group, in order), place by place: keys exact and sums within
    REL_TOL, except that a row may trade places with one whose sum
    agrees within REL_TOL (rows tied at the n-th place included).
    Returns the largest relative sum error."""
    got = got_table.to_pylist()
    sums = {tuple(r[k] for k in keys): r[want_sum] for r in want}
    want = want[:n]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        key = tuple(g[k] for k in keys)
        if key not in sums:
            raise AssertionError(f"place {i}: unexpected group {key}")
        ref_sum = sums[key]
        rel = abs(g[got_sum] - ref_sum) / max(abs(ref_sum), 1e-300)
        worst = max(worst, rel)
        if rel > REL_TOL:
            raise AssertionError(f"place {i} {key}: {g[got_sum]} vs "
                                 f"{ref_sum} (rel {rel:.3e})")
        tied = abs(g[got_sum] - w[want_sum]) <= REL_TOL * max(
            abs(w[want_sum]), 1e-300)
        if key != tuple(w[k] for k in keys) and not tied:
            raise AssertionError(f"place {i}: {g} vs reference {w}")
    return worst


def reference_q67(pc, tables):
    """q67 by pyarrow and numpy: every (store, item) group's sales, and
    the rows q67 keeps (rank within the store by sales, descending, ties
    sharing the lowest rank; rank <= 10), by (store, rank, item)."""
    import numpy as np

    t = tables.append_column("sales", pc.multiply(
        tables["ss_sales_price"], tables["ss_quantity"]))
    g = t.group_by(["ss_store_sk", "ss_item_sk"]).aggregate(
        [("sales", "sum")])
    store = g["ss_store_sk"].to_numpy()
    item = g["ss_item_sk"].to_numpy()
    sums = g["sales_sum"].to_numpy()
    rows = []
    for s in np.unique(store):
        m = store == s
        desc = np.sort(-sums[m])
        rank = np.searchsorted(desc, -sums[m], side="left") + 1
        for it, v, rk in zip(item[m], sums[m], rank):
            if rk <= 10:
                rows.append({"ss_store_sk": int(s), "ss_item_sk": int(it),
                             "sumsales": float(v), "rk": int(rk)})
    rows.sort(key=lambda r: (r["ss_store_sk"], r["rk"], r["ss_item_sk"]))
    all_sums = {(int(a), int(b)): float(v)
                for a, b, v in zip(store, item, sums)}
    return rows, all_sums


def compare_q67(got_table, want: list, all_sums: dict) -> float:
    """q67's rows against the reference's, place by place: keys and ranks
    exact and sums within REL_TOL, except that two rows of one store
    whose sums agree within REL_TOL may come in either order.  Returns
    the largest relative sum error."""
    got = got_table.to_pylist()
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    order = [(r["ss_store_sk"], r["rk"], r["ss_item_sk"]) for r in got]
    if order != sorted(order):
        raise AssertionError("rows are not in (store, rank, item) order")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        key = (g["ss_store_sk"], g["ss_item_sk"])
        if key not in all_sums:
            raise AssertionError(f"place {i}: unexpected group {key}")
        ref = all_sums[key]
        rel = abs(g["sumsales"] - ref) / abs(ref)
        worst = max(worst, rel)
        if rel > REL_TOL:
            raise AssertionError(f"place {i} {key}: sales {g['sumsales']} "
                                 f"vs {ref} (rel {rel:.3e})")
        same = all(g[k] == w[k] for k in ("ss_store_sk", "ss_item_sk", "rk"))
        tied = g["ss_store_sk"] == w["ss_store_sk"] and abs(
            ref - w["sumsales"]) <= REL_TOL * abs(w["sumsales"])
        if not (same or tied):
            raise AssertionError(f"place {i}: {g} vs reference {w}")
    return worst


def reference_star(pc, star, date_cond, item_cond, keys: list,
                   names: dict, order: list) -> list:
    """A star query by pyarrow: the date_dim rows ``date_cond(date_dim)``
    keeps x store_sales x the items ``item_cond(item)`` keeps, the sales
    summed by ``keys``; every group as a row of the query's output names
    (``names``: key -> output name) and ``sum``, sorted by ``order``
    ((output name, descending), most significant first)."""
    dd, item = star["date_dim"], star["item"]
    dd = dd.filter(date_cond(dd)).select(["d_date_sk", "d_year"])
    it = item.filter(item_cond(item)).select(
        ["i_item_sk"] + [k for k in keys if k.startswith("i_")])
    j = dd.join(star["sales"], keys="d_date_sk",
                right_keys="ss_sold_date_sk", join_type="inner")
    j = j.join(it, keys="ss_item_sk", right_keys="i_item_sk",
               join_type="inner")
    g = j.group_by(keys).aggregate([("ss_ext_sales_price", "sum")])
    rows = [{**{names.get(k, k): r[k] for k in keys},
             "sum": r["ss_ext_sales_price_sum"]} for r in g.to_pylist()]
    for col_name, desc in reversed(order):
        rows.sort(key=lambda r: r[col_name], reverse=desc)
    return rows


def same_rows(a, b, keys=("d_year", "i_brand_id", "i_brand"),
              sum_col: str = "sum_agg") -> float:
    """Two runs of a ranked query (q3ds's by default): keys equal place
    by place, sums within REL_TOL (the card's atomic adds sum in no fixed
    order).  Returns the largest relative sum difference."""
    worst = 0.0
    ra, rb = a.to_pylist(), b.to_pylist()
    if len(ra) != len(rb):
        raise AssertionError(f"{len(ra)} rows against {len(rb)}")
    for i, (x, y) in enumerate(zip(ra, rb)):
        rel = abs(x[sum_col] - y[sum_col]) / abs(y[sum_col])
        worst = max(worst, rel)
        if [x[k] for k in keys] != [y[k] for k in keys] or rel > REL_TOL:
            raise AssertionError(f"place {i}: {x} against {y}")
    return worst


def join_strategies(plan) -> list:
    """Each join of the plan: its exec, type, and the side it builds."""
    return [[type(n).__name__, n.join_type,
             "right" if n.build_is_right else "left"]
            for n in plan.walk() if hasattr(n, "build_is_right")]


def filtered_run(make_df, RF) -> dict:
    """One more run of the plan, kept: its filter's state and build
    time, what each scan pruned, and the rows each uploaded."""
    plan = make_df().physical_plan()
    t0 = time.perf_counter()
    rows = sum(b.num_rows for b in plan.execute())
    wall = time.perf_counter() - t0
    filters = RF.plan_runtime_filters(plan)
    scans = [n for n in plan.walk() if type(n).__name__ == "ParquetScanExec"]
    out = {"rows": rows, "wall_s": wall,
           "pruned_rows": sum(n.metrics["rfPrunedRows"] for n in scans),
           "filters": [{"describe": rf.describe(), "n_keys": rf.n_keys,
                        "min": rf.min_val, "max": rf.max_val,
                        "range_table": None if rf.range_table is None
                        else len(rf.range_table),
                        "build_ms": rf.build_ms} for rf in filters],
           "scans": [{"columns": n.schema.names, "files": len(n.paths),
                      "filters": [c for c, _ in n.runtime_filters],
                      **n.metrics} for n in scans]}
    for node in plan.walk():
        if hasattr(node, "close"):
            node.close()
    return out


def counted_run(make_df, counter) -> tuple:
    """One run of ``make_df()`` that counts, as it goes, what K1 must
    hash: the non-empty batches its hash exchanges' children feed their
    map tasks (an Expand under one counts its batches: it multiplies
    rows, not batches; a union its members' partitions; a range exchange
    hashes nothing), and the non-empty batches each runtime-filter build
    exec folds (times its filters), then the filters published with a
    range table (each fold and each table hashes two lanes, a launch
    each); and the K1 launches (``counter``: the kernel wrapper) its
    planning makes (a scalar subquery runs while its query is planned).
    What the run never pulls (the stream side of a join whose build
    side is empty) counts nothing.  The session's fault schedule, if
    any, is armed for the run; ``ladder_reruns`` counts the hash
    exchanges' map batches that the OOM ladder ran again (each a K1
    launch more).  Returns (the result, the counts and ``per_run``,
    what one run must launch without re-runs)."""
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.robustness import faults

    df = make_df()
    plan, tally = counted_plan(df, counter)
    with faults.query_scope(df._session.conf):
        result = collect_exec(plan, df._session.conf)
    return result, tally()


def counted_plan(df, counter) -> tuple:
    """``df``'s physical plan with ``counted_run``'s counters on it, and
    the function that reads them once the plan has run."""
    import threading

    lock = threading.Lock()
    counts = {"map": 0, "folds": 0}

    def counted(feed, key, weight):
        def execute_partition(p):
            for batch in feed(p):
                if batch.num_rows:
                    with lock:
                        counts[key] += weight
                yield batch
        return execute_partition

    before = counter.launches
    plan = df.physical_plan()
    planning = counter.launches - before
    builds = []
    for node in plan.walk():
        if type(node).__name__ == "TpuShuffleExchangeExec" and type(
                node.partitioning).__name__ == "HashPartitioning":
            child = node.children[0]
            child.execute_partition = counted(child.execute_partition,
                                              "map", 1)
        elif type(node).__name__ == "TpuRuntimeFilterBuildExec":
            builds.append(node)
            node.execute_partition = counted(node.execute_partition,
                                             "folds", len(node.entries))

    def tally() -> dict:
        # read after the drain: closing the tree set each filter
        # pending again, and ``last`` is what it published
        tables = sum(rf.last is not None and rf.last.range_table is not None
                     for node in builds for _k, rf in node.entries)
        reruns = sum(n.metrics["mapBatchRuns"] - n.metrics["mapBatches"]
                     for n in plan.walk()
                     if type(n).__name__ == "TpuShuffleExchangeExec")
        return {"planned_map_batches": counts["map"],
                "ladder_reruns": reruns,
                "planned_filter_folds": counts["folds"],
                "planned_range_tables": tables,
                "planning_launches": planning,
                "per_run": counts["map"] + 2 * counts["folds"]
                + 2 * tables + planning}

    return plan, tally


def check_launches(name: str, rec: dict, planned: dict) -> None:
    want = {"hash_columns": rec["runs"] * planned["per_run"],
            "hash_string": 0}
    if rec["launches"] != want:
        raise AssertionError(f"{name} launched {rec['launches']}, expected "
                             f"{want} ({planned} a run)")


def compare(got_table, want: dict, n_keys: int) -> float:
    """Keys, integer columns and NULLs exact, floats within REL_TOL;
    returns the largest relative float error."""
    rows = got_table.to_pylist()
    names = got_table.schema.names
    if len(rows) != len(want):
        raise AssertionError(f"{len(rows)} result rows, reference has "
                             f"{len(want)}")
    worst = 0.0
    for row in rows:
        key = tuple(row[n] for n in names[:n_keys])
        if key not in want:
            raise AssertionError(f"unexpected group {key}")
        for name, ref in want[key].items():
            v = row[name]
            if ref is None or isinstance(ref, int):
                if v != ref:
                    raise AssertionError(f"{key} {name}: {v} != {ref}")
                continue
            rel = abs(v - ref) / max(abs(ref), 1e-300)
            worst = max(worst, rel)
            if rel > REL_TOL:
                raise AssertionError(
                    f"{key} {name}: {v} vs {ref} (rel {rel:.3e})")
    return worst


class RecordingHashColumns:
    """The hash_columns wrapper recording each call's inputs in
    ``calls``; its ``launches`` are the wrapper's, which the profiler
    reads."""

    def __init__(self, original, calls: list):
        self.original = original
        self.calls = calls

    @property
    def launches(self) -> int:
        return self.original.launches

    def __call__(self, cols, num_rows, device, seed=42, num_partitions=0):
        self.calls.append((list(cols), num_rows, seed, num_partitions))
        return self.original(cols, num_rows, device, seed, num_partitions)


def run_query(torch, make_df, kernels, check, calls: list,
              quick: bool = False, scans: bool = True,
              timed: int = 3, fallback: int = 0,
              counted: bool = False, single: bool = False,
              kept: dict = None) -> dict:
    """The main path: ``make_df()`` is the query's DataFrame, ``check``
    holds a result against its reference and returns the largest
    relative float error.  Its plan must hold ``fallback``
    CpuFallbackExecs (none: every node on the card).  One warm-up,
    ``timed`` timed runs and ``breakdown`` (``scans`` False: the
    profiled run only); ``timed`` 0 (``scans`` False): the profiled run
    comes first and is the warm-up, and the one run after it, counted
    when ``counted``, is timed; ``quick``: one timed run only, no
    profile.  Counts reset just before the runs, read just after; every
    hash_columns call is recorded with its inputs.  ``counted``: the
    first of the runs is a ``counted_run``, and the record holds what
    it counted (``per_run``...) for ``check_launches``.  ``single``: one
    run only, profiled, counted and timed at once (no warm-up; a blind
    profile runs it again, and ``runs`` counts both); ``kept`` then gets
    its plan."""
    nodes = fallback_nodes(make_df().physical_plan())
    if len(nodes) != fallback:
        raise AssertionError(f"the plan holds {len(nodes)} CPU nodes, "
                             f"expected {fallback}: "
                             f"{[n.node_desc() for n in nodes]}")
    runs = 1 if quick else 1 + timed
    profile_first = not (quick or scans or timed or single)
    if profile_first:
        extra = profiled_run(torch, make_df)
        del extra["kernel_counts"]
    original = kernels.hash_columns

    from spark_rapids_tpu_torch.execs import retry as R

    kernels.hash_columns = RecordingHashColumns(original, calls)
    original.launches = 0
    kernels.hash_string.launches = 0
    R.reset_retry_stats()
    torch.cuda.reset_peak_memory_stats()
    walls, planned = [], {}
    try:
        if single:
            kept = {} if kept is None else kept
            kept["counter"] = original
            extra = profiled_run(torch, make_df, kept)
            del extra["kernel_counts"]
            result, planned = kept["result"], kept["planned"]
            walls, runs = [extra["profiled_wall_s"]], \
                extra["profile_attempts"]
        for i in range(0 if single else runs):
            t0 = time.perf_counter()
            if counted and i == 0:
                result, planned = counted_run(make_df, original)
            else:
                result = make_df().collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        kernels.hash_columns = original
    launches = {"hash_columns": original.launches,
                "hash_string": kernels.hash_string.launches}
    ladder = ladder_quiet("run_query", [make_df()._session])
    if planned.get("ladder_reruns"):
        raise AssertionError(f"the ladder re-ran map batches: {planned}")
    worst = check(result)
    warm = None if quick or not timed else walls.pop(0)
    if quick:
        extra = {}
    elif scans:
        extra = breakdown(torch, make_df)
    elif not (profile_first or single):
        extra = profiled_run(torch, make_df)
        del extra["kernel_counts"]
    return {"rows": result.num_rows, "warmup_s": warm,
            "wall_s": walls, "median_s": statistics.median(walls),
            "runs": runs, "launches": launches, "max_rel_err": worst,
            "ladder": ladder,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            **planned, **extra}


#: the scan's host split (io/scan.py, columnar/arrow.py): nanosecond
#: timers, then the count of batches whose copy was still running
SCAN_SPLIT = ("decodeTime", "convertTime", "hostCopyTime", "pinTime",
              "copyEnqueueTime", "uploadWaitTime")


def scan_alone(torch, plan, serial: bool) -> dict:
    """Every task of every scan of ``plan`` drained with nothing above
    them: one after another with the scans' stages and decode pool off
    (``serial``, as the earlier slices ran them), or through
    ``run_tasks`` on the session's task threads, as the query's map
    tasks run them.  The wall, and the scans' host split summed."""
    import dataclasses

    from spark_rapids_tpu_torch.execs.base import run_tasks

    scans = [n for n in plan.walk() if not n.children]
    if serial:
        for scan in scans:
            scan.runtime = dataclasses.replace(
                scan.runtime, task_threads=1, decode_threads=1,
                stage_depth=0)
    t0 = time.perf_counter()
    for scan in scans:
        run_tasks(lambda p, scan=scan: sum(
            b.num_rows for b in scan.execute_partition(p)),
            scan.num_partitions, scan.runtime.task_threads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = {k: sum(n.metrics[k] for n in scans) / 1e9 for k in SCAN_SPLIT}
    return {"wall_s": wall, "host_split_s": split,
            "upload_pending": sum(n.metrics["uploadPending"] for n in scans),
            "batches_rows": sum(n.metrics["numOutputRows"] for n in scans)}


class ProfilerBlind(AssertionError):
    """A profiled run showed no device time though it put work on the
    card."""


#: profiled runs of a query before a blind profiler fails the script:
#: late in a long process the profiler can miss a whole run (PERF.md
#: §7); it missed fallback_order_rand's in one run on an H100 80GB HBM3
#: at 700 W, and only a second blind run fails
PROFILE_ATTEMPTS = 2


def profiled_run(torch, make_df, kept: dict = None) -> dict:
    """``profiled_once``, again when the profiler saw nothing of a run
    that put work on the card, up to PROFILE_ATTEMPTS runs; the record
    says how many it took (``profile_attempts``).  ``kept``: see
    ``profiled_once``."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        try:
            rec = profiled_once(torch, make_df, kept)
        except ProfilerBlind:
            if attempt == PROFILE_ATTEMPTS:
                raise
            continue
        rec["profile_attempts"] = attempt
        return rec


def profiled_once(torch, make_df, kept: dict = None) -> dict:
    """One run under torch.profiler: the device's busy time and kernel
    count, and busy over wall as the device's idle share.  It traces the
    device's activity only and sums the raw device events:
    ``key_averages()`` builds a Python event per kernel and per host
    operator first, ~0.2 ms each, which made the profile of a text of
    100 000 kernels cost four times its run on an H100 80GB HBM3 at
    700 W.  A run that shows no device time fails, unless every leaf of
    its plan is a Parquet scan and they handed up no row.  ``kept`` (a
    dict) makes the run a ``counted_run`` too: it gets the run's
    ``result``, its ``plan`` and ``counted_run``'s counts (``planned``),
    counting the planning launches of ``kept["counter"]``."""
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.robustness import faults

    def k1_launches() -> int:
        return kernels.hash_columns.launches + kernels.hash_string.launches

    lock = threading.Lock()
    shipped = {"rows": 0, "other_leaves": 0}

    def counted(feed):
        def execute_partition(p):
            for batch in feed(p):
                if batch.columns:
                    with lock:
                        shipped["rows"] += batch.num_rows
                yield batch
        return execute_partition

    k1 = k1_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df = make_df()
        if kept is None:
            plan = df.physical_plan()
        else:
            plan, tally = counted_plan(df, kept["counter"])
        for node in plan.walk():
            if node.children:
                continue
            if type(node).__name__ == "ParquetScanExec":
                node.execute_partition = counted(node.execute_partition)
            else:
                shipped["other_leaves"] += 1
        with faults.query_scope(df._session.conf):
            result = collect_exec(plan, df._session.conf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k1 = k1_launches() - k1
    counts: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = counts.get(e.name(), (0, 0))
            counts[e.name()] = (n + 1, ns + e.duration_ns())
    busy_s = sum(ns for _, ns in counts.values()) / 1e9
    # rows the run's Parquet scans handed up, each batch uploaded (a
    # copy on the card) before it is; None when another kind of leaf
    # (a source, a range) may have put work on the card uncounted
    uploaded = None if shipped["other_leaves"] else shipped["rows"]
    if not busy_s and uploaded != 0:
        # a run may reach the card with nothing at all (q27's and q56's
        # texts: the host filters keep no dimension row, and a join
        # whose build side is empty never reads its stream); any other
        # run that shows no device time means the profiler is blind
        raise ProfilerBlind(
            f"the profiler saw no device time in a run whose scans "
            f"uploaded {uploaded} rows and that launched K1 {k1} times")
    top = sorted(counts.items(), key=lambda kv: -kv[1][1])[:8]
    if kept is not None:
        kept.update(result=result, plan=plan, planned=tally())
    return {"profiled_wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "k1_launches": k1, "rows_uploaded": uploaded,
            "device_kernel_count": sum(n for n, _ in counts.values()),
            "device_kernels": [[k[:60], n, ns / 1e6] for k, (n, ns) in top],
            "kernel_counts": {k: n for k, (n, _) in counts.items()}}


def breakdown(torch, make_df) -> dict:
    """Where one run's time goes: the scans alone (Parquet decode and
    upload of every task of every scan, drained with nothing above
    them), serially and pooled, each with its host split; and the
    device's busy time and kernel count over a profiled run, whose busy
    time over the run's wall time gives the device's idle share."""
    serial = scan_alone(torch, make_df().physical_plan(), serial=True)
    pooled = scan_alone(torch, make_df().physical_plan(), serial=False)
    prof = profiled_run(torch, make_df)
    del prof["kernel_counts"]
    return {"scan_only_s": serial["wall_s"],
            "scan_only_pooled_s": pooled["wall_s"],
            "scan_split_serial": serial, "scan_split_pooled": pooled,
            **prof}


def q3_phase(torch, kernels, RF, tpch, session, li_paths, orders_path, ref3,
             rf_on: bool) -> tuple:
    """TPC-H q3 in one session: the plan's shape (six lineitem tasks,
    one partition-wise shuffled join; with the filter on, its build exec
    under the orders side's exchange and the filter on the lineitem
    scan), the top 10 against the reference, and K1's launches.  Returns
    the record and the hash_columns calls."""
    def q3_df():
        return tpch.q3_dataframe(session, li_paths, orders_path)

    plan = q3_df().physical_plan()
    tasks = [n.num_partitions for n in plan.walk() if not n.children]
    if tasks != [len(li_paths), 1]:
        raise AssertionError(f"q3 scan tasks {tasks}, expected "
                             f"{[len(li_paths), 1]}")
    joins = join_strategies(plan)
    join = next(n for n in plan.walk() if hasattr(n, "build_is_right"))
    if joins != [["TpuShuffledHashJoinExec", "inner", "right"]] or \
            not join.partition_wise:
        raise AssertionError(f"q3 joins {joins}, expected one "
                             f"partition-wise shuffled join")
    built = type(join.children[1].children[0]).__name__ == \
        "TpuRuntimeFilterBuildExec"
    applied = [(n.paths, c) for n in plan.walk()
               for c, _ in getattr(n, "runtime_filters", ())]
    want_rf = (True, [(li_paths, "l_orderkey")]) if rf_on else (False, [])
    if (built, applied) != want_rf:
        raise AssertionError(f"q3 (filter {'on' if rf_on else 'off'}): "
                             f"build exec under the orders exchange "
                             f"{built}, filters {applied}")
    calls: list = []
    rec = run_query(torch, q3_df, kernels,
                    lambda t: compare_ranked(
                        t, ref3, 10, ("l_orderkey", "o_orderdate",
                                      "o_shippriority"), "revenue",
                        "rev_sum"), calls, counted=True)
    check_launches(f"q3 (filter {'on' if rf_on else 'off'})", rec, rec)
    out = {"joins": joins,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    if rf_on:
        run = filtered_run(q3_df, RF)
        if not (run["pruned_rows"] > 0 and run["filters"][0]["n_keys"] > 0):
            raise AssertionError(f"q3 filter pruned nothing: {run}")
        # the scans alone run with nothing built: no filter applies
        out["scan_only_unfiltered_s"] = out.pop("scan_only_s")
        out["scan_only_pooled_unfiltered_s"] = out.pop("scan_only_pooled_s")
        out["kept_run"] = run
    return out, calls


def q3ds_phase(torch, pc, star, kernels, RF, TorchSession, tpcds, TTB,
               RF_ENABLED):
    """TPC-DS q3 with its runtime filter, then without: each run held
    against the pyarrow reference, the plan's shape and K1's launches
    checked; emits the phase's line.  ``star``: the tables' paths and
    what the references read of them.  Returns both runs' records and
    the filtered runs' hash_columns calls."""
    dd_path, ss_paths, item_path = star["paths"]
    date_dim, sales, item = star["date_dim"], star["sales"], star["item"]
    gen_s = star["datagen_s"]
    ref = reference_star(
        pc, star, lambda d: pc.equal(d["d_moy"], 11),
        lambda i: pc.equal(i["i_manufact_id"], 128),
        ["d_year", "i_brand_id", "i_brand"], {},
        [("d_year", False), ("sum", True), ("i_brand_id", False)])
    results: dict = {}
    records = {}
    calls_on: list = []
    for rf_on in (True, False):
        session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES,
                                RF_ENABLED: rf_on}, device="cuda")

        def q3ds_df():
            return tpcds.q3_dataframe(session, dd_path, ss_paths, item_path)

        plan = q3ds_df().physical_plan()
        tasks = [n.num_partitions for n in plan.walk() if not n.children]
        if tasks != [1, Q3DS_FILES, 1]:
            raise AssertionError(f"q3ds scan tasks {tasks}, expected "
                                 f"{[1, Q3DS_FILES, 1]}")
        joins = join_strategies(plan)
        want_joins = [["TpuBroadcastHashJoinExec", "inner", "right"],
                      ["TpuBroadcastHashJoinExec", "inner", "left"]]
        if joins != want_joins:
            raise AssertionError(f"q3ds joins {joins}, expected "
                                 f"{want_joins}")
        builds = [n for n in plan.walk()
                  if type(n).__name__ == "TpuRuntimeFilterBuildExec"]
        applied = [(n.paths, c) for n in plan.walk()
                   for c, _ in getattr(n, "runtime_filters", ())]
        want_rf = ([(ss_paths, "ss_sold_date_sk")], 1) if rf_on else ([], 0)
        if (applied, len(builds)) != want_rf:
            raise AssertionError(f"q3ds runtime filters {applied} from "
                                 f"{len(builds)} builds")
        calls: list = calls_on if rf_on else []
        kept: list = []

        def check(t):
            kept.append(t)
            return compare_ranked(t, ref, 100, ("d_year", "i_brand_id",
                                                "i_brand"), "sum_agg", "sum")

        rec = run_query(torch, q3ds_df, kernels, check, calls, counted=True)
        results[rf_on] = kept[-1]
        # the scans alone run with nothing built: no filter applies
        rec["scan_only_unfiltered_s"] = rec.pop("scan_only_s")
        rec["scan_only_pooled_unfiltered_s"] = rec.pop("scan_only_pooled_s")
        check_launches(f"q3ds (filter {'on' if rf_on else 'off'})", rec,
                       rec)
        run = filtered_run(q3ds_df, RF)
        if rf_on and not (run["pruned_rows"] > 0
                          and run["filters"][0]["n_keys"] > 0):
            raise AssertionError(f"q3ds filter pruned nothing: {run}")
        records[rf_on] = {"plan": plan.tree_string().splitlines(),
                          "joins": joins,
                          "hash_columns_calls": sorted(
                              {(n, signature(cols), seed, parts)
                               for cols, n, seed, parts in calls}),
                          "kept_run": run, **rec}
    off_err = same_rows(results[True], results[False])
    on, off = records[True], records[False]
    emit("q3ds", rows_in=sales.num_rows, date_dim_rows=date_dim.num_rows,
         item_rows=item.num_rows, groups=len(ref),
         file_bytes=[os.path.getsize(p) for p in ss_paths],
         datagen_s=gen_s, rf_off_max_rel_diff=off_err,
         rf_off_median_s=off["median_s"],
         rf_off_wall_s=off["wall_s"], rf_off_launches=off["launches"],
         rf_off_scan_rows=[sc["numOutputRows"]
                           for sc in off["kept_run"]["scans"]],
         rf_off_device_busy_s=off["device_busy_s"],
         rf_off_device_idle_share=off["device_idle_share"],
         rf_off_profiled_wall_s=off["profiled_wall_s"], **on)
    return on, off, calls_on


#: off / on pairs of walls in the trace phase, each pair's order
#: alternating (off, on), (on, off) (5 until the formats phase, 3 until
#: the ops phase needed the run's time)
TRACE_PAIRS = 2
#: the span and event names the JAX package records on q3 and q3ds (a
#: pool's stage names folded to ``*``), which the trace phase requires
TRACE_NAMES = ("query.plan", "query.tag", "query.lower", "query.execute",
               "query.fetch.batch", "exchange.task", "pipe.readback",
               "rf.build", "rf.apply", "shuffle.block.send",
               "shuffle.block.recv", "metric.settle.*", "exec.*",
               "pipe.*.run", "pipe.*.enqueue", "pipe.*.dequeue")
#: threads whose spans must carry the query's id
TRACE_POOL_PREFIXES = ("srt-pool-", "srt-pipe-", "srt-metric-reaper")
#: threads the observability layer starts, gone after disable()
TRACE_THREADS = ("srt-telemetry", "srt-ledger-settle", "srt-metric-reaper")


def trace_name(name: str) -> str:
    """A span name with its exec or stage folded to ``*``."""
    for pre in ("exec.", "metric.settle."):
        if name.startswith(pre):
            return pre + "*"
    if name.startswith("pipe.") and name != "pipe.readback":
        return "pipe.*." + name.rsplit(".", 1)[1]
    return name


def sync_sites(torch, make_df, top=8) -> dict:
    """One run under torch.cuda.set_sync_debug_mode("warn"): the syncs
    it reports, those outside the readback helpers (device_read*, the
    ledger's settle worker, the metric reaper) apart, with their
    ``top`` Python sites (None: every site)."""
    import collections
    import warnings

    sanctioned = ("parallel/pipeline.py", "trace/ledger.py",
                  "execs/base.py")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            make_df().collect()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    outside = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in syncs
        if not any(s in w.filename.replace(os.sep, "/")
                   for s in sanctioned))
    return {"syncs": len(syncs), "outside_device_read": sum(outside.values()),
            "top_sites": outside.most_common(top)}


def gil_check(torch) -> dict:
    """Whether ``Event.synchronize`` (the ledger's settle worker, the
    metric reaper) releases the GIL: a Python loop on this thread counts
    its iterations while another thread waits on an event behind
    ``torch.cuda._sleep``, and again while nothing waits."""
    def spin(seconds: float) -> int:
        n, end = 0, time.perf_counter() + seconds
        while time.perf_counter() < end:
            n += 1
        return n

    cycles = int(2e9 * 0.3)  # ~0.3 s at ~2 GHz
    torch.cuda._sleep(cycles)
    ev = torch.cuda.Event()
    ev.record()
    waiter = threading.Thread(target=ev.synchronize)
    waiter.start()
    busy = spin(0.1)
    waiter.join()
    torch.cuda.synchronize()
    alone = spin(0.1)
    return {"spins_while_waiting": busy, "spins_alone": alone,
            "ratio": busy / alone}


def trace_phase(torch, pc, kernels, TorchSession, tpch, tpcds, TTB,
                li_paths, orders_path, ref3, star) -> dict:
    """The observability layer on the main path (checks A-G of the
    module docstring); emits the phase's line."""
    import json as _json

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import trace
    from spark_rapids_tpu_torch.execs.base import REAPER
    from spark_rapids_tpu_torch.parallel import pipeline as P
    from spark_rapids_tpu_torch.trace import ledger, telemetry

    on_keys = {C.TRACE_ENABLED: True, C.LEDGER_ENABLED: True,
               C.TELEMETRY_ENABLED: True, C.TELEMETRY_HZ: 20.0}
    dd_path, ss_paths, item_path = star["paths"]
    ref_ds = reference_star(
        pc, star, lambda d: pc.equal(d["d_moy"], 11),
        lambda i: pc.equal(i["i_manufact_id"], 128),
        ["d_year", "i_brand_id", "i_brand"], {},
        [("d_year", False), ("sum", True), ("i_brand_id", False)])
    queries = {
        "q3": ({TTB: TASK_TARGET_BYTES, ADAPTIVE: False},
               lambda s: tpch.q3_dataframe(s, li_paths, orders_path),
               lambda t: compare_ranked(
                   t, ref3, 10, ("l_orderkey", "o_orderdate",
                                 "o_shippriority"), "revenue", "rev_sum")),
        "q3ds": ({TTB: Q3DS_TASK_TARGET_BYTES},
                 lambda s: tpcds.q3_dataframe(s, dd_path, ss_paths,
                                              item_path),
                 lambda t: compare_ranked(
                     t, ref_ds, 100, ("d_year", "i_brand_id", "i_brand"),
                     "sum_agg", "sum")),
    }

    def all_off() -> None:
        trace.disable()
        ledger.disable()
        telemetry.stop()
        REAPER.flush()

    out: dict = {}
    t_phase = time.perf_counter()
    for name, (keys, make, check) in queries.items():
        off_s = TorchSession(keys, device="cuda")
        on_s = TorchSession({**keys, **on_keys}, device="cuda")
        all_off()  # the on session's build turned them on
        # A: untraced, counted (the planned map batches for E)
        off_result, planned = counted_run(lambda: make(off_s),
                                          kernels.hash_columns)
        # the on run: a conf-driven capture, profiled for D
        trace.clear()
        ledger.reset_stats()
        P.reset_stage_counters()
        kernels.hash_columns.launches = 0
        before = ledger.snapshot()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            on_result = make(on_s).collect()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.hash_columns.launches
        ledger.LEDGER.flush(60)
        REAPER.flush()
        programs = ledger.delta(before, ledger.snapshot())
        events = trace.snapshot()
        stages = P.stage_snapshot()
        samples = telemetry.SAMPLER.samples
        if not on_result.equals(off_result):
            raise AssertionError(f"trace {name}: traced result differs "
                                 f"from the untraced one")
        err = check(on_result)
        # B: names, query ids, per-name stats
        qids = {e.attrs.get("query_id") for e in events
                if e.name == "query.execute"}
        if len(qids) != 1:
            raise AssertionError(f"trace {name}: query ids {qids}")
        qid = qids.pop()
        names = {trace_name(e.name) for e in events}
        missing = [n for n in TRACE_NAMES if n not in names
                   and not (name == "q3ds" and n in (
                       "exchange.task", "shuffle.block.send",
                       "shuffle.block.recv"))]
        if missing:
            raise AssertionError(f"trace {name}: no {missing} among "
                                 f"{sorted(names)}")
        unattributed = sorted({e.name for e in events if e.ph != "C"
                               and e.thread_name.startswith(
                                   TRACE_POOL_PREFIXES)
                               and e.attrs.get("query_id") != qid})
        if unattributed:
            raise AssertionError(f"trace {name}: pool-thread spans "
                                 f"without query {qid}: {unattributed}")
        per_name: dict = {}
        for e in events:
            n, ms = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, ms + e.dur_ns / 1e6)
        # C: the Chrome trace
        with tempfile.TemporaryDirectory() as tmp:
            path = on_s.export_trace(os.path.join(tmp, "trace.json"))
            with open(path) as f:
                doc = _json.load(f)
        n_chrome = len(doc["traceEvents"])
        counters = sum(1 for ev in doc["traceEvents"] if ev["ph"] == "C")
        # D: the ledger against the wall and the profiler
        totals = ledger.summarize(programs)["totals"]
        window_ms = totals["window_ms"]
        if not 0 < window_ms <= wall_ms:
            raise AssertionError(f"trace {name}: ledger windows "
                                 f"{window_ms} ms against a wall of "
                                 f"{wall_ms} ms")
        k1 = [p for p in programs.values()
              if p["tag"] == "kernel.hash_columns"]
        k1_dispatches = sum(p["dispatches"] for p in k1)
        if k1_dispatches != launches or launches == 0:
            raise AssertionError(f"trace {name}: kernel.hash_columns "
                                 f"dispatched {k1_dispatches}, K1 "
                                 f"launched {launches}")
        prof_k1_ms = sum(
            e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and "hash_columns_kernel" in e.name()) / 1e6
        prof_busy_ms = sum(
            e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA) / 1e6
        # E: readbacks per tag, and the syncs outside them
        readbacks = {k: v["readbacks"] for k, v in stages.items()
                     if v["readbacks"] or v["async_readbacks"]}
        syncs = sync_sites(torch, lambda: make(off_s)) if name == "q3" \
            else None
        # F: off / on walls, alternating
        walls = {"off": [], "on": []}
        for i in range(TRACE_PAIRS):
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                if mode == "off":
                    all_off()
                sess = off_s if mode == "off" else on_s
                t0 = time.perf_counter()
                got = make(sess).collect()
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
                if not got.equals(off_result):
                    raise AssertionError(f"trace {name}: {mode} run "
                                         f"{i} differs")
        all_off()
        # G: nothing of the layer left running
        deadline = time.monotonic() + 2.0
        while True:
            left = sorted(t.name for t in threading.enumerate()
                          if t.name.startswith(TRACE_THREADS))
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if left or P.live_stage_threads():
            raise AssertionError(f"trace {name}: threads left {left}, "
                                 f"stage threads {P.live_stage_threads()}")
        out[name] = {
            "max_rel_err": err, "query_id": qid, "wall_ms": wall_ms,
            "events": len(events), "names": sorted(names),
            "span_stats": {k: [n, round(ms, 3)]
                           for k, (n, ms) in sorted(per_name.items())},
            "chrome_events": n_chrome, "counter_events": counters,
            "telemetry_samples": samples,
            "ledger_window_ms": window_ms,
            "ledger_dispatch_ms": totals["dispatch_ms"],
            "ledger_programs": totals["programs"],
            "ledger_top": totals["top"],
            "k1_launches": launches, "k1_dispatches": k1_dispatches,
            "k1_ledger_window_ms": sum(p["window_ms"] for p in k1),
            "k1_profiler_ms": prof_k1_ms, "profiler_busy_ms": prof_busy_ms,
            "readbacks": readbacks,
            "planned_map_batches": planned["planned_map_batches"],
            "planned_filter_folds": planned["planned_filter_folds"],
            "sync_debug": syncs,
            "off_s": walls["off"], "on_s": walls["on"],
            "off_median_s": statistics.median(walls["off"]),
            "on_median_s": statistics.median(walls["on"])}
    out["gil"] = gil_check(torch)
    if out["gil"]["ratio"] < 0.5:
        raise AssertionError(f"trace: Event.synchronize holds the GIL: "
                             f"{out['gil']}")
    emit("trace", seconds=time.perf_counter() - t_phase, **out)
    return out


#: fastDecode on / off pairs of the scan_host phase, each pair's order
#: alternating (on, off), (off, on) (2 until the ops phase needed the
#: run's time)
SCAN_HOST_PAIRS = 1
def scan_counts(plan) -> list:
    """Every Parquet scan of ``plan``: its files, output columns,
    whether its Filter was elided, and its counters, with the rows it
    decoded (what the footers kept: emitted + filtered on the host +
    pruned by a runtime filter)."""
    from spark_rapids_tpu_torch.io.scan import SCAN_COUNTERS

    out = []
    for n in plan.walk():
        if type(n).__name__ != "ParquetScanExec":
            continue
        c = {k: n.metrics[k] for k in SCAN_COUNTERS}
        c["rows_decoded"] = (c["numOutputRows"] + c["hostFilteredRows"]
                             + c["rfPrunedRows"])
        out.append({"files": [os.path.basename(p) for p in n.paths[:1]]
                    + ([f"+{len(n.paths) - 1}"] if len(n.paths) > 1
                       else []),
                    "columns": n.schema.names,
                    "elided_filter": n.exact_prefilter, **c})
    return out


def scan_host_phase(torch, pc, TorchSession, tpch, tpcds, TTB, paths,
                    ref6, ref1, star) -> dict:
    """The scan's host path (io/scan.py, io/fastpar.py): q6, q1 and q3ds
    with scan.fastDecode on and off.  For each setting one kept run: its
    scans' counters (files on the fast and the standard path, rows
    decoded, filtered on the host, pruned by the runtime filter and
    uploaded, row groups pruned), every lineitem and store_sales file on
    the fast path when it is on; then the scans alone, serially and
    pooled, with their host split; then SCAN_HOST_PAIRS pairs of walls
    in alternating order.  Every run's result is held against its
    reference; q6's plan must hold no TpuFilterExec (its Filter elided
    into the scan)."""
    from spark_rapids_tpu_torch.config import FAST_DECODE
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    dd_path, ss_paths, item_path = star["paths"]
    ref3ds = reference_star(
        pc, star, lambda d: pc.equal(d["d_moy"], 11),
        lambda i: pc.equal(i["i_manufact_id"], 128),
        ["d_year", "i_brand_id", "i_brand"], {},
        [("d_year", False), ("sum", True), ("i_brand_id", False)])
    queries = {
        "q6": ({TTB: TASK_TARGET_BYTES},
               lambda s: tpch.q6_dataframe(s, paths),
               lambda t: compare(t, ref6, 0), paths),
        "q1": ({TTB: TASK_TARGET_BYTES},
               lambda s: tpch.q1_dataframe(s, paths),
               lambda t: compare(t, ref1, 2), paths),
        "q3ds": ({TTB: Q3DS_TASK_TARGET_BYTES},
                 lambda s: tpcds.q3_dataframe(s, dd_path, ss_paths,
                                              item_path),
                 lambda t: compare_ranked(
                     t, ref3ds, 100, ("d_year", "i_brand_id", "i_brand"),
                     "sum_agg", "sum"), ss_paths),
    }
    out = {}
    for name, (conf, make, check, facts) in queries.items():
        sessions = {fd: TorchSession({**conf, FAST_DECODE: fd},
                                     device="cuda") for fd in (True, False)}
        rec: dict = {}
        worst = 0.0
        for fd, session in sessions.items():
            side = "fast" if fd else "standard"
            make(session).collect()  # warm-up: the runtime filter built
            plan = make(session).physical_plan()
            worst = max(worst, check(collect_exec(plan, session.conf)))
            torch.cuda.synchronize()
            counts = scan_counts(plan)
            if name == "q6" and any(type(n).__name__ == "TpuFilterExec"
                                    for n in plan.walk()):
                raise AssertionError("q6 plans a TpuFilterExec: "
                                     + plan.tree_string())
            fact = [c for c in counts
                    if c["files"][0] == os.path.basename(facts[0])]
            if len(fact) != 1:
                raise AssertionError(f"{name}: no one scan of its fact "
                                     f"files in {counts}")
            f = fact[0]
            if fd and not (f["standardDecodedFiles"] == 0
                           and f["fastDecodedFiles"] > 0):
                raise AssertionError(f"{name}: a fact file left the fast "
                                     f"path: {f}")
            if not fd and f["fastDecodedFiles"]:
                raise AssertionError(f"{name}: fastDecode off, yet {f}")
            alone = {mode: scan_alone(torch, make(session).physical_plan(),
                                      serial=mode == "serial")
                     for mode in ("serial", "pooled")}
            rec[side] = {"scans": counts,
                         "scan_only_s": alone["serial"]["wall_s"],
                         "scan_only_pooled_s": alone["pooled"]["wall_s"],
                         "scan_split_serial": alone["serial"],
                         "scan_split_pooled": alone["pooled"]}
        walls = {True: [], False: []}
        for i in range(SCAN_HOST_PAIRS):
            for fd in ((True, False) if i % 2 == 0 else (False, True)):
                session = sessions[fd]
                t0 = time.perf_counter()
                result = make(session).collect()
                torch.cuda.synchronize()
                walls[fd].append(time.perf_counter() - t0)
                worst = max(worst, check(result))
        rec["fast"]["wall_s"], rec["standard"]["wall_s"] = (walls[True],
                                                            walls[False])
        rec["pairs_fast_won"] = sum(a < b for a, b in zip(walls[True],
                                                          walls[False]))
        rec["max_rel_err"] = worst
        emit(f"scan_host_{name}", **rec)
        out[name] = rec
    return out



#: off / on / compressed rounds of the wire phase's walls, each round's
#: order rotating (plain, wire, compressed), (compressed, plain, wire) ...
#: (3 until the formats phase, 2 until the persist phase needed the
#: run's time)
WIRE_ROUNDS = 1
#: the wire phase's upload paths: sql.scan.packedUpload off, on, and on
#: with sql.wireCompression.enabled under its default codec list
WIRE_PATHS = ("plain", "wire", "compressed")
#: the array codecs, each also run alone on q1
WIRE_CODECS = ("bitpack", "delta", "rle")
#: the scan's host split the wire phase prints (ns timers)
WIRE_SPLIT = ("decodeTime", "encodeTime", "pinTime", "hostCopyTime",
              "copyEnqueueTime", "uploadWaitTime")


def wire_keys(C, path: str, codecs: str = None) -> dict:
    keys = {C.PACKED_UPLOAD: path != "plain",
            C.WIRE_COMPRESSION: path == "compressed"}
    if codecs is not None:
        keys[C.WIRE_CODECS] = codecs
    return keys


def sorted_bits(np, pa, table) -> list:
    """A result's rows in a canonical order, floats as their bits: two
    paths' results agree bit for bit when these lists are equal."""
    cols = []
    for c in table.columns:
        c = c.combine_chunks() if hasattr(c, "combine_chunks") else c
        if pa.types.is_floating(c.type):
            vals = c.fill_null(0.0).to_numpy(zero_copy_only=False)
            valid = c.is_valid().to_numpy(zero_copy_only=False)
            cols.append([int(b) if ok else None for b, ok in
                         zip(vals.astype(np.float64).view(np.int64), valid)])
        else:
            cols.append(c.to_pylist())
    return sorted(zip(*cols), key=repr)


def plan_kinds(encode, tally: dict):
    """``encode`` (``transfer.encode_for_device``) tallying each plan
    entry's kind (bias8 / bias16 / bias32, dict, scaled, raw, null,
    sdict, sraw)."""
    import numpy as np

    def tallied(arrays, schema, n, wire_cfg=None, use_native=True):
        comps, plan = encode(arrays, schema, n, wire_cfg, use_native)
        for e in plan[3]:
            kind = e[0] if e[0] != "fixed" else e[1]
            if kind == "bias":
                ref = e[2]
                dt = np.dtype(ref[4] if ref[0] == "comp"
                              else comps[ref[1]].dtype)
                kind = f"bias{8 * dt.itemsize}"
            tally[kind] = tally.get(kind, 0) + 1
        return comps, plan

    return tallied


def decode_profile(torch, arrow, transfer, table, schema, wire) -> dict:
    """One batch's wire decode alone on the card: staged and copied
    first, then ``finish_upload`` under torch.profiler: its kernels, their
    device time, and the host time of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    arrow.finish_upload(arrow.stage_upload(table, dev, schema, wire=wire))
    unit = arrow.stage_upload(table, dev, schema, wire=wire)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        arrow.finish_upload(unit)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    n, ns = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA \
                and not e.name().startswith("Memcpy"):
            n += 1
            ns += e.duration_ns()
    return {"rows": table.num_rows, "kernels": n, "kernel_ms": ns / 1e6,
            "call_ms": host_s * 1e3, "wire_bytes": int(unit.wire[0].numel())}


def wire_phase(torch, pa, pc, pq, kernels, TorchSession, tpch, tpcds,
               TTB, paths, ref6, ref1, star, li_paths, orders_path) -> tuple:
    """The wire path (columnar/transfer.py, columnar/compression/) on q6,
    q1 and q3ds at full width, on the three upload paths: A. each path's
    rows bit for bit the plain path's and held against the query's
    reference, and each codec alone on q1 the same; B. per path the
    batches, wire and plain bytes and copies (upload_stats), the plan's
    component kinds and the codec chooser's picks and ratios; C. the
    scans' host split of one kept run, the wire.decode program's
    dispatches and event-window ms per batch from the device ledger, and
    one batch's decode alone under the profiler; D. WIRE_ROUNDS rounds
    of walls; F. K1's launches equal on the three paths.  Returns the
    phase's record, its K1 launches and its hash_columns calls."""
    import numpy as np

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.columnar import arrow
    from spark_rapids_tpu_torch.columnar import compression as WC
    from spark_rapids_tpu_torch.columnar import transfer
    from spark_rapids_tpu_torch.execs.base import REAPER
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.trace import ledger

    dd_path, ss_paths, item_path = star["paths"]
    ref3ds = reference_star(
        pc, star, lambda d: pc.equal(d["d_moy"], 11),
        lambda i: pc.equal(i["i_manufact_id"], 128),
        ["d_year", "i_brand_id", "i_brand"], {},
        [("d_year", False), ("sum", True), ("i_brand_id", False)])
    queries = {
        "q6": ({TTB: TASK_TARGET_BYTES},
               lambda s: tpch.q6_dataframe(s, paths),
               lambda t: compare(t, ref6, 0), paths[0]),
        "q1": ({TTB: TASK_TARGET_BYTES},
               lambda s: tpch.q1_dataframe(s, paths),
               lambda t: compare(t, ref1, 2), paths[0]),
        "q3ds": ({TTB: Q3DS_TASK_TARGET_BYTES},
                 lambda s: tpcds.q3_dataframe(s, dd_path, ss_paths,
                                              item_path),
                 lambda t: compare_ranked(
                     t, ref3ds, 100, ("d_year", "i_brand_id", "i_brand"),
                     "sum_agg", "sum"), ss_paths[0]),
    }
    calls: list = []
    k1_total = 0
    original = kernels.hash_columns
    out = {}
    for name, (conf, make, check, fact) in queries.items():
        sessions = {p: TorchSession({**conf, **wire_keys(C, p)},
                                    device="cuda") for p in WIRE_PATHS}
        rec: dict = {}
        worst = 0.0
        first = None
        for path, session in sessions.items():
            make(session).collect()  # warm-up: the runtime filter built
            tally: dict = {}
            transfer.reset_upload_stats()
            WC.reset_stats()
            original.launches = 0
            kernels.hash_string.launches = 0
            kernels.hash_columns = RecordingHashColumns(original, calls)
            encode = transfer.encode_for_device
            transfer.encode_for_device = plan_kinds(encode, tally)
            try:
                plan = make(session).physical_plan()
                result = collect_exec(plan, session.conf)
                torch.cuda.synchronize()
            finally:
                kernels.hash_columns = original
                transfer.encode_for_device = encode
            k1 = {"hash_columns": original.launches,
                  "hash_string": kernels.hash_string.launches}
            k1_total += k1["hash_columns"]
            worst = max(worst, check(result))
            bits = sorted_bits(np, pa, result)
            if first is None:
                first = bits
            elif bits != first:
                raise AssertionError(f"wire {name}: the {path} path's rows "
                                     "differ from the plain path's")
            st = transfer.upload_stats()
            scans = [n for n in plan.walk() if not n.children]
            split = {k: sum(n.metrics[k] for n in scans) / 1e9
                     for k in WIRE_SPLIT}
            encoded = sum(n.metrics["encodedBatches"] for n in scans)
            plain = sum(n.metrics["plainBatches"] for n in scans)
            if path == "plain":
                if st["batches"] or encoded or not plain:
                    raise AssertionError(f"wire {name}: plain path {st}")
            else:
                if st["plain_batches"] or plain or not encoded \
                        or st["copies"] != st["batches"]:
                    raise AssertionError(
                        f"wire {name}: the {path} path took another: {st}, "
                        f"{encoded} encoded, {plain} plain batches")
            batches = st["batches"] + st["plain_batches"]
            rec[path] = {
                "rows": result.num_rows, "k1": k1,
                "upload": st, "batches": batches,
                "bytes_per_batch": (st["wire_bytes"] + st["plain_bytes"])
                / max(batches, 1),
                "copies_per_batch": (st["copies"] + st["plain_copies"])
                / max(batches, 1),
                "kinds": tally, "codecs": WC.stats(),
                "host_split_s": split}
            if rec[path]["k1"] != rec["plain"]["k1"]:
                raise AssertionError(f"wire {name}: K1 launched "
                                     f"{rec[path]['k1']} on {path}, "
                                     f"{rec['plain']['k1']} plain")
        for path in ("wire", "compressed"):
            rec[path]["bytes_vs_plain"] = (rec[path]["bytes_per_batch"]
                                           / rec["plain"]["bytes_per_batch"])
        # C: the decode program in the device ledger, and one batch alone
        ledger.enable()
        try:
            before = ledger.snapshot()
            make(sessions["compressed"]).collect()
            torch.cuda.synchronize()
            ledger.LEDGER.flush(60)
            progs = ledger.delta(before, ledger.snapshot())
        finally:
            ledger.disable()
            REAPER.flush()
        dec = [p for p in progs.values() if p.get("op") == "WireDecode"]
        n_dec = sum(p["dispatches"] for p in dec)
        rec["ledger_wire_decode"] = {
            "programs": len(dec), "dispatches": n_dec,
            "window_ms_per_batch": sum(p["window_ms"] for p in dec)
            / max(n_dec, 1),
            "dispatch_ms_per_batch": sum(p["dispatch_ms"] for p in dec)
            / max(n_dec, 1)}
        if n_dec != rec["compressed"]["upload"]["batches"]:
            raise AssertionError(f"wire {name}: {n_dec} WireDecode "
                                 "dispatches, batches "
                                 f"{rec['compressed']['upload']['batches']}")
        # the fact scan's first batch, read as the scan reads it
        scan = next(n for n in make(sessions["wire"]).physical_plan().walk()
                    if not n.children and fact in getattr(n, "paths", ()))
        strings = [f.name for f in scan.schema.fields
                   if type(f.dtype).__name__ == "StringType"]
        table = pq.ParquetFile(fact, read_dictionary=strings).read(
            columns=scan.schema.names)
        table = table.slice(0, min(table.num_rows, scan.batch_rows))
        rec["decode_alone"] = {
            path: decode_profile(torch, arrow, transfer, table, scan.schema,
                                 transfer.WirePolicy.from_conf(
                                     sessions[path].conf))
            for path in ("wire", "compressed")}
        # D: the walls, each round's order rotated
        walls = {p: [] for p in WIRE_PATHS}
        for i in range(WIRE_ROUNDS):
            order = WIRE_PATHS[i % 3:] + WIRE_PATHS[:i % 3]
            for path in order:
                t0 = time.perf_counter()
                result = make(sessions[path]).collect()
                torch.cuda.synchronize()
                walls[path].append(time.perf_counter() - t0)
                worst = max(worst, check(result))
        for path in WIRE_PATHS:
            rec[path]["wall_s"] = walls[path]
            rec[path]["median_s"] = statistics.median(walls[path])
        rec["max_rel_err"] = worst
        if name == "q1":
            rec["codec_alone"] = {}
            for codec in WIRE_CODECS:
                s = TorchSession({**conf, **wire_keys(C, "compressed",
                                                      codec)},
                                 device="cuda")
                WC.reset_stats()
                original.launches = 0
                result = make(s).collect()
                torch.cuda.synchronize()
                k1_total += original.launches
                if sorted_bits(np, pa, result) != first:
                    raise AssertionError(f"wire q1: {codec} alone differs")
                check(result)
                rec["codec_alone"][codec] = WC.stats()
        emit(f"wire_{name}", **rec)
        out[name] = rec
    out["spill"], spill_k1 = wire_spill(torch, np, pa, kernels, TorchSession,
                                        tpch, TTB, calls, li_paths,
                                        orders_path)
    k1_total += spill_k1
    emit("wire_spill", **out["spill"])
    slower = {q: out[q]["wire"]["median_s"] / out[q]["plain"]["median_s"]
              for q in queries}
    out["verdict"] = {
        "wire_over_plain_median": slower,
        "compressed_over_plain_median": {
            q: out[q]["compressed"]["median_s"] / out[q]["plain"]["median_s"]
            for q in queries},
        "packed_upload_default": all(r <= 1.0 for r in slower.values()),
        "port_default": C.DEFAULTS[C.PACKED_UPLOAD]}
    emit("wire", **out["verdict"], k1_launches=k1_total)
    return out, k1_total, calls


def wire_spill(torch, np, pa, kernels, TorchSession, tpch, TTB,
               calls: list, li_paths, orders_path) -> tuple:
    """E. the spill codecs on a q3 run's exchange blocks (the static
    partition-wise plan, filter off): the process store brought up with
    memory.spill.compressHostTier and spill.compression.codec=zlib; the
    blocks spilled by spill_all_unpinned to host frames, then each on to
    disk; the rows, read back through every block, equal to an unspilled
    run's bit for bit.  The store's other entries (the broadcast build
    the map stage parked) spill with the blocks.  The plugin comes back
    with the default keys."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.config import TorchConf
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.plugin import TorchPlugin

    keys = {C.SPILL_CODEC: "zlib", C.SPILL_COMPRESS_HOST: True}
    plugin = TorchPlugin.restart(TorchConf(keys), "cuda")
    original = kernels.hash_columns
    original.launches = 0
    kernels.hash_columns = RecordingHashColumns(original, calls)
    try:
        session = TorchSession({TTB: TASK_TARGET_BYTES, C.RF_ENABLED: False,
                                ADAPTIVE: False, **keys}, device="cuda")
        make = lambda: tpch.q3_dataframe(session, li_paths,  # noqa: E731
                                         orders_path)
        want = sorted_bits(np, pa, make().collect())
        store = plugin.store
        plan = make().physical_plan()
        exchanges = [n for n in plan.walk()
                     if type(n).__name__ == "TpuShuffleExchangeExec"]
        for ex in exchanges:
            ex.materialize_stats()
        blocks = sum(sum(ex.block_counts()) for ex in exchanges)
        torch.cuda.synchronize()
        before = store.spill_stats()
        t0 = time.perf_counter()
        spilled = store.spill_all_unpinned()
        to_host_s = time.perf_counter() - t0
        on_host = store.spill_stats()
        t0 = time.perf_counter()
        with store._lock:
            while store._spill_one_host_locked():
                pass
        to_disk_s = time.perf_counter() - t0
        on_disk = store.spill_stats()
        frames = [e.path for e in store._entries.values() if e.path]
        with open(frames[0], "rb") as f:
            head = f.read(4096)
        t0 = time.perf_counter()
        got = collect_exec(plan, session.conf)
        torch.cuda.synchronize()
        back_s = time.perf_counter() - t0
        after = store.spill_stats()
    finally:
        kernels.hash_columns = original
        TorchPlugin.restart(TorchConf(), "cuda")
    rec = {"exchanges": len(exchanges), "blocks": blocks,
           "entries_spilled": spilled,
           "host_stored_bytes": on_host["host_used"],
           "host_raw_bytes": on_host["host_raw_bytes"],
           "host_ratio": on_host["host_raw_bytes"]
           / max(on_host["host_used"], 1),
           "disk_bytes": on_disk["disk_used"], "frames": len(frames),
           "frame_magic": head[:4].decode("latin-1"),
           "frame_codec_zlib": b'"codec": "zlib"' in head,
           "restores": after["restores"] - before["restores"],
           "to_host_s": to_host_s, "to_disk_s": to_disk_s,
           "read_back_s": back_s, "rows": got.num_rows,
           "k1_launches": original.launches}
    if not (blocks and on_host["host_used"] < on_host["host_raw_bytes"]
            and frames and len(frames) == spilled >= blocks
            and rec["frame_magic"] == "TPUB" and rec["frame_codec_zlib"]
            and rec["restores"] >= blocks):
        raise AssertionError(f"wire_spill: {rec}")
    if sorted_bits(np, pa, got) != want:
        raise AssertionError("wire_spill: the rows read back from the "
                             "spilled blocks differ from an unspilled run")
    return rec, original.launches

def star_tables(pa, pq, data_dir, tpcds) -> dict:
    """q3ds's tables (the whole calendar, 18 000 items, six store_sales
    files), written once for q3ds, q93 and q42/q52/q55, and what the
    star references read of them."""
    star_dir = os.path.join(data_dir, "q3ds")
    os.makedirs(star_dir)
    t0 = time.perf_counter()
    paths = tpcds.write_q3_tables(star_dir, n_files=Q3DS_FILES,
                                  rows_per_file=Q3DS_ROWS_PER_FILE)
    gen_s = time.perf_counter() - t0
    dd_path, ss_paths, item_path = paths
    return {"dir": star_dir, "paths": paths, "datagen_s": gen_s,
            "date_dim": pq.read_table(dd_path),
            "item": pq.read_table(item_path),
            "sales": pa.concat_tables([pq.read_table(p, columns=[
                "ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
                for p in ss_paths])}


def reference_q93(pa, pc, sales, returns, reason, reason_desc: str):
    """q93 by pyarrow: store_sales LEFT OUTER JOIN store_returns, the
    reason filter, the CASE per row, the sum per customer; every group,
    by (sum, customer with NULL first).  Returns the rows and the row
    counts after the outer join and after the reason filter."""
    keys = reason.filter(pc.equal(reason["r_reason_desc"], reason_desc))[
        "r_reason_sk"]
    j = sales.join(returns, keys=["ss_item_sk", "ss_ticket_number"],
                   right_keys=["sr_item_sk", "sr_ticket_number"],
                   join_type="left outer")
    joined_rows = j.num_rows
    j = j.filter(pc.is_in(j["sr_reason_sk"], value_set=keys))
    qty, rq, price = j["ss_quantity"], j["sr_return_quantity"], \
        j["ss_sales_price"]
    act = pc.if_else(pc.is_valid(rq),
                     pc.multiply(pc.subtract(qty, rq), price),
                     pc.multiply(qty, price))
    g = pa.table({"ss_customer_sk": j["ss_customer_sk"], "act": act}) \
        .group_by(["ss_customer_sk"]).aggregate([("act", "sum")])
    rows = sorted(g.to_pylist(), key=lambda r: (
        r["act_sum"], r["ss_customer_sk"] is not None,
        r["ss_customer_sk"] or 0))
    return rows, joined_rows, j.num_rows


def q93_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB):
    """TPC-DS q93 over q3ds's store_sales files and a store_returns
    derived from them: the plan (a partition-wise shuffled left outer
    join under the broadcast reason join, no runtime filter), the 100
    rows against the pyarrow reference, and K1's launches: one
    hash_columns per map batch of its three exchanges.  Emits the
    phase's line; returns its record and hash_columns calls."""
    _, ss_paths, _ = star["paths"]
    t0 = time.perf_counter()
    sr_path, reason_path = tpcds.write_q93_tables(star["dir"], ss_paths)
    gen_s = time.perf_counter() - t0
    star["q93_paths"] = (sr_path, reason_path)
    # the static plan; the adaptive phase's aqe_coalesce is the default's
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES, ADAPTIVE: False},
                           device="cuda")

    def q93_df():
        return tpcds.q93_dataframe(session, ss_paths, sr_path, reason_path)

    plan = q93_df().physical_plan()
    tasks = [n.num_partitions for n in plan.walk() if not n.children]
    if tasks != [Q3DS_FILES, 1, 1]:
        raise AssertionError(f"q93 scan tasks {tasks}, expected "
                             f"{[Q3DS_FILES, 1, 1]}")
    joins = join_strategies(plan)
    want_joins = [["TpuBroadcastHashJoinExec", "inner", "right"],
                  ["TpuShuffledHashJoinExec", "left_outer", "right"]]
    outer = [n for n in plan.walk() if hasattr(n, "partition_wise")]
    if joins != want_joins or not outer[0].partition_wise:
        raise AssertionError(f"q93 joins {joins}, expected {want_joins} "
                             f"with the outer join partition-wise")
    if any(type(n).__name__ == "TpuRuntimeFilterBuildExec"
           or getattr(n, "runtime_filters", None) for n in plan.walk()):
        raise AssertionError("q93 planned a runtime filter")
    sales = pa.concat_tables([pq.read_table(p, columns=[
        "ss_item_sk", "ss_ticket_number", "ss_customer_sk", "ss_quantity",
        "ss_sales_price"]) for p in ss_paths])
    returns = pq.read_table(sr_path, columns=[
        "sr_item_sk", "sr_ticket_number", "sr_reason_sk",
        "sr_return_quantity"])
    ref, joined_rows, reason_rows = reference_q93(
        pa, pc, sales, returns, pq.read_table(reason_path), tpcds.Q93_REASON)
    star["q93_ref"] = ref
    calls: list = []
    rec = run_query(torch, q93_df, kernels, lambda t: compare_ranked(
        t, ref, 100, ("ss_customer_sk",), "sumsales", "act_sum"), calls,
        counted=True)
    check_launches("q93", rec, rec)
    out = {"plan": plan.tree_string().splitlines(), "joins": joins,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    emit("q93", rows_in=sales.num_rows, returns_in=returns.num_rows,
         store_returns_bytes=os.path.getsize(sr_path), datagen_s=gen_s,
         outer_join_rows=joined_rows, reason_rows=reason_rows,
         groups=len(ref), **out)
    return out, calls


#: the store_sales columns the formats phase writes as ORC: those q3ds
#: and q93 read
FORMATS_COLUMNS = ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                   "ss_ticket_number", "ss_quantity", "ss_sales_price",
                   "ss_ext_sales_price")
#: the store whose directory the formats phase's first pruned read keeps
FORMATS_STORE = 1


def timed_launches(torch, counter, fn) -> tuple:
    """(``fn()``, its wall in s, the K1 launches it made)."""
    before = counter.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, counter.launches - before


def hive_rows(pq, root: str) -> dict:
    """Relative partition directory -> its data files' rows, by file
    name order (each file read alone: ``pq.read_table`` would take the
    directory's ``key=value`` for a partition of its own)."""
    out: dict = {}
    for d, _dirs, names in os.walk(root):
        files = sorted(n for n in names if n.endswith(".parquet"))
        if files:
            out[os.path.relpath(d, root)] = [
                r for n in files
                for r in pq.ParquetFile(os.path.join(d, n)).read()
                .to_pylist()]
    return out


def same_store_rows(got: list, want: list, where: str) -> float:
    """One store's (date, net_paid, sales) rows against the reference's:
    dates and counts exact, sums within REL_TOL; the largest relative
    error."""
    ref = {r["ss_sold_date_sk"]: r for r in want}
    if len(got) != len(ref):
        raise AssertionError(f"{where}: {len(got)} rows, reference has "
                             f"{len(ref)}")
    worst = 0.0
    for r in got:
        w = ref.get(r["ss_sold_date_sk"])
        if w is None or r["sales"] != w["sales"]:
            raise AssertionError(f"{where}: row {r} against {w}")
        rel = abs(r["net_paid"] - w["net_paid"]) / max(abs(w["net_paid"]),
                                                       1e-300)
        worst = max(worst, rel)
        if rel > REL_TOL:
            raise AssertionError(f"{where}: {r} vs {w} (rel {rel:.3e})")
    return worst


def formats_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpch,
                  tpcds, TTB, li_paths) -> tuple:
    """The file formats on the card (module docstring): A. store_sales'
    FORMATS_COLUMNS written as ORC with ``df.write.orc`` and q3ds over
    the ORC directory equal to q3ds over the Parquet files bit for bit;
    B. one store_sales file through ``write.csv`` and ``read_csv``
    equal to the Parquet file; C. a grouped aggregate (net paid and
    sales by store and date, through K1's exchange) written with
    ``partition_by("ss_store_sk")``, split on the card and by the plain
    host loop, both trees equal to ``pyarrow.dataset``'s Hive write of
    the pyarrow reference, then read back with each pruned filter; D.
    TPC-H q6 and q1 as Substrait plans over lineitem, equal to the
    DataFrames bit for bit with the same K1 launches.  Each part's
    launches equal its planned map batches (the card-split write's those
    its host-loop twin's counted plan planned: the plans are alike).
    Emits the phase's line; returns its record and its K1 launches."""
    import pyarrow.dataset as ds

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.arrow import schema_from_arrow
    from spark_rapids_tpu_torch.exprs.base import Literal
    from spark_rapids_tpu_torch.exprs.predicates import If
    from spark_rapids_tpu_torch.frontends.substrait import SubstraitFrontend
    from spark_rapids_tpu_torch.io.scan import OrcScanExec, ParquetScanExec
    from spark_rapids_tpu_torch.io.write import ParquetWriteExec
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.session import col, count_star, lit, sum_

    t_phase = time.perf_counter()
    counter = kernels.hash_columns
    dd_path, ss_paths, item_path = star["paths"]
    root = os.path.join(star["dir"], "formats")
    os.makedirs(root)
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    launches = 0

    def stats(st) -> dict:
        return {"files": st.num_files, "rows": st.num_rows,
                "bytes": st.num_bytes, "partitions": st.partitions,
                "writeTime_ms": st.write_time_ns / 1e6,
                "splitTime_ms": st.split_time_ns / 1e6}

    # A. ORC round trip, q3ds on both formats
    names = [n for n in pq.read_schema(ss_paths[0]).names
             if n in FORMATS_COLUMNS]
    orc_dir = os.path.join(root, "store_sales_orc")
    st, wall, n = timed_launches(torch, counter, lambda: session.read_parquet(
        *ss_paths, columns=names).write.orc(orc_dir))
    rows_in = sum(pq.read_metadata(p).num_rows for p in ss_paths)
    if (st.num_rows, st.num_files, n) != (rows_in, len(ss_paths), 0):
        raise AssertionError(f"ORC write: {st}, {n} K1 launches")
    orc = {"write_wall_s": wall, **stats(st)}
    q3 = {}
    for fmt, where in (("parquet", ss_paths), ("orc", [orc_dir])):
        def q3ds_df(fmt=fmt, where=where):
            return tpcds.q3_dataframe(session, dd_path, where, item_path,
                                      fmt=fmt)

        plan = q3ds_df().physical_plan()
        fact = [n for n in plan.walk()
                if getattr(n, "runtime_filters", None)]
        cls = OrcScanExec if fmt == "orc" else ParquetScanExec
        if len(fact) != 1 or type(fact[0]) is not cls:
            raise AssertionError(f"q3ds over {fmt}: runtime-filtered "
                                 f"scans {fact}")
        (result, tally), wall, n = timed_launches(
            torch, counter, lambda: counted_run(q3ds_df, counter))
        if n != tally["per_run"]:
            raise AssertionError(f"q3ds over {fmt} launched {n}, "
                                 f"planned {tally}")
        launches += n
        q3[fmt] = {"wall_s": wall, "launches": n, "rows": result.num_rows,
                   "table": result, "tasks": fact[0].num_partitions}
    if not q3["orc"].pop("table").equals(q3["parquet"].pop("table")):
        raise AssertionError("q3ds over ORC differs from q3ds over Parquet")
    orc["q3ds"] = q3

    # B. CSV round trip of one file
    csv_dir = os.path.join(root, "store_sales_csv")
    st, wall_w, _ = timed_launches(torch, counter, lambda: session
                                   .read_parquet(ss_paths[0])
                                   .write.csv(csv_dir))
    schema = schema_from_arrow(pq.read_schema(ss_paths[0]))
    back, wall_r, _ = timed_launches(torch, counter, lambda: session
                                     .read_csv(csv_dir, schema=schema)
                                     .collect())
    want = pq.read_table(ss_paths[0])
    if not back.equals(want):
        bad = [c for c in want.column_names
               if not back.column(c).equals(want.column(c))]
        raise AssertionError(f"CSV round trip differs in {bad}")
    csv = {"write_wall_s": wall_w, "read_wall_s": wall_r,
           "rows": back.num_rows, **stats(st)}

    # C. the partitioned write, split on the card and on the host
    def agg_df():
        # the generator draws no NULL store; a sale with no customer is
        # booked to no store, so the NULL directory has rows
        store = If(col("ss_customer_sk").is_null(), Literal.of(None, T.LONG),
                   col("ss_store_sk"))
        return (session.read_parquet(*ss_paths)
                .select(store.alias("ss_store_sk"), col("ss_sold_date_sk"),
                        col("ss_net_paid"))
                .group_by(col("ss_store_sk"), col("ss_sold_date_sk"))
                .agg((sum_(col("ss_net_paid")), "net_paid"),
                     (count_star(), "sales")))

    t = pa.concat_tables([pq.read_table(p, columns=[
        "ss_store_sk", "ss_sold_date_sk", "ss_net_paid", "ss_customer_sk"])
        for p in ss_paths])
    store = pc.if_else(pc.is_null(t["ss_customer_sk"]),
                       pa.scalar(None, pa.int64()), t["ss_store_sk"])
    g = pa.table({"ss_store_sk": store,
                  "ss_sold_date_sk": t["ss_sold_date_sk"],
                  "ss_net_paid": t["ss_net_paid"]}).group_by(
        ["ss_store_sk", "ss_sold_date_sk"]).aggregate(
        [("ss_net_paid", "sum"), ([], "count_all")])
    ref = pa.table({"ss_sold_date_sk": g["ss_sold_date_sk"],
                    "net_paid": g["ss_net_paid_sum"],
                    "sales": g["count_all"], "ss_store_sk": g["ss_store_sk"]})
    ref_dir = os.path.join(root, "reference")
    ds.write_dataset(ref, ref_dir, format="parquet",
                     partitioning=ds.partitioning(
                         pa.schema([("ss_store_sk", pa.int64())]),
                         flavor="hive"))
    ref_tree = hive_rows(pq, ref_dir)
    if "ss_store_sk=__HIVE_DEFAULT_PARTITION__" not in ref_tree:
        raise AssertionError(f"no NULL store directory: {sorted(ref_tree)}")
    part = {}
    trees = {}
    planned = None
    for mode in ("host", "card"):
        out_dir = os.path.join(root, f"by_store_{mode}")
        df = agg_df()
        if mode == "host":
            # counted: its planned map batches are the card write's too
            plan, tally = counted_plan(df, counter)
            make = ParquetWriteExec(out_dir, plan, ["ss_store_sk"],
                                    runtime=df._planner().runtime,
                                    host_split=True).run
        else:
            def make(df=df, out_dir=out_dir):
                return df.write.partition_by("ss_store_sk").parquet(out_dir)
        st, wall, n = timed_launches(torch, counter, make)
        if planned is None:
            planned = tally()["per_run"]
        launches += n
        if n != planned:
            raise AssertionError(f"partitioned write ({mode} split) "
                                 f"launched {n}, planned {planned}")
        trees[mode] = hive_rows(pq, out_dir)
        if set(trees[mode]) != set(ref_tree):
            raise AssertionError(f"{mode} split directories "
                                 f"{sorted(trees[mode])} against "
                                 f"{sorted(ref_tree)}")
        worst = max(same_store_rows(trees[mode][d], ref_tree[d], d)
                    for d in ref_tree)
        part[mode] = {"wall_s": wall, "launches": n, "planned": planned,
                      "max_rel_err": worst, **stats(st)}
    if {d: sorted(r, key=repr) for d, r in trees["card"].items()} != \
            {d: sorted(r, key=repr) for d, r in trees["host"].items()}:
        raise AssertionError("the card split and the host loop wrote "
                             "other rows")
    card_dir = os.path.join(root, "by_store_card")
    files = {d: sum(1 for n in os.listdir(os.path.join(card_dir, d))
                    if n.endswith(".parquet")) for d in trees["card"]}
    pruned = {}
    for key, cond in ((FORMATS_STORE, col("ss_store_sk").eq(
            lit(FORMATS_STORE))), (None, col("ss_store_sk").is_null())):
        d = "ss_store_sk=" + ("__HIVE_DEFAULT_PARTITION__" if key is None
                              else str(key))
        df = session.read_parquet(card_dir).where(cond)
        plan = df.physical_plan()
        got, wall, _ = timed_launches(torch, counter,
                                      lambda: collect_exec(plan, session.conf))
        scan = next(n for n in plan.walk()
                    if isinstance(n, ParquetScanExec))
        want_pruned = sum(files.values()) - files[d]
        if scan.metrics["filesPruned"] != want_pruned:
            raise AssertionError(f"read of {d} pruned "
                                 f"{scan.metrics['filesPruned']} files, "
                                 f"expected {want_pruned}")
        rows = got.to_pylist()
        if any(r["ss_store_sk"] != key for r in rows):
            raise AssertionError(f"read of {d} kept another store")
        pruned[d] = {"wall_s": wall, "rows": len(rows),
                     "files_pruned": want_pruned, "files_read": files[d],
                     "max_rel_err": same_store_rows(rows, ref_tree[d], d)}

    # D. Substrait q6 and q1 against the DataFrames
    li_keys = {TTB: TASK_TARGET_BYTES}
    fe = SubstraitFrontend(li_keys, device="cuda")
    fe.register_table("lineitem", li_paths)
    li_session = TorchSession(li_keys, device="cuda")
    substrait = {}
    for name, keys in (("q6", []), ("q1", ["l_returnflag", "l_linestatus"])):
        got = {}
        for how, make_df in (
                ("substrait", lambda name=name: fe.dataframe(
                    getattr(tpch, f"{name}_substrait")())),
                ("dataframe", lambda name=name: getattr(
                    tpch, f"{name}_dataframe")(li_session, li_paths))):
            (result, tally), wall, n = timed_launches(
                torch, counter, lambda: counted_run(make_df, counter))
            if n != tally["per_run"]:
                raise AssertionError(f"{name} ({how}) launched {n}, "
                                     f"planned {tally}")
            launches += n
            order = [(k, "ascending") for k in keys]
            got[how] = (result.sort_by(order) if order else result, wall, n)
        if not got["substrait"][0].equals(got["dataframe"][0]):
            raise AssertionError(f"Substrait {name} differs from the "
                                 f"DataFrame's")
        if got["substrait"][2] != got["dataframe"][2]:
            raise AssertionError(f"Substrait {name} launched "
                                 f"{got['substrait'][2]}, the DataFrame "
                                 f"{got['dataframe'][2]}")
        substrait[name] = {"rows": got["substrait"][0].num_rows,
                           "launches": got["substrait"][2],
                           "wall_s": got["substrait"][1],
                           "dataframe_wall_s": got["dataframe"][1]}
    rec = {"seconds": time.perf_counter() - t_phase, "rows_in": rows_in,
           "orc": orc, "csv": csv, "partitioned": part,
           "split_card_ms": part["card"]["splitTime_ms"],
           "split_host_ms": part["host"]["splitTime_ms"],
           "pruned_reads": pruned, "substrait": substrait,
           "hash_columns_launches": launches}
    emit("formats", **rec)
    return rec, launches


#: the engine-free client of the ops phase, run as its own process:
#: argv = host, port, the plans' JSON file, the result directory.  It
#: sends q1 and q6 as Substrait plans and q3ds as SQL text, writes each
#: result as an Arrow IPC file, and prints the modules it imported that
#: a client must not (torch, JAX, an engine module of the port).
OPS_CLIENT = r"""
import json, os, sys, time
from spark_rapids_tpu_torch.connect.client import ConnectClient
import pyarrow as pa
host, port, plans_path, out_dir = sys.argv[1:5]
plans = json.load(open(plans_path))
walls = {}
with ConnectClient(host, int(port), tenant="ops") as cli:
    for name in ("q1", "q6", "q3ds"):
        t0 = time.perf_counter()
        if name == "q3ds":
            t = cli.execute_sql(plans[name])
        else:
            t = cli.execute_plan(plans[name])
        walls[name] = time.perf_counter() - t0
        with pa.OSFile(os.path.join(out_dir, name + ".arrow"), "wb") as f:
            with pa.ipc.new_file(f, t.schema) as w:
                w.write_table(t)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "torch", "jax", "spark_rapids_tpu") or (
    m.startswith("spark_rapids_tpu_torch.")
    and m.split(".")[1] not in ("connect",)))
print(json.dumps({"walls_s": walls, "forbidden_modules": bad,
                  "modules": len(sys.modules)}))
"""

#: the history / event-log on and off pairs of q3 in the ops phase
OPS_PAIRS = 2


def ops_scraper(url: str, stop, found: dict) -> None:
    """Poll ``/queries`` until a query is in flight, then read it
    (``/queries/<id>``) and scrape ``/metrics`` twice; keeps the first
    such observation in ``found``."""
    import urllib.error
    import urllib.request

    def get(path):
        return urllib.request.urlopen(url + path, timeout=10).read().decode()

    while not stop.is_set():
        live = json.loads(get("/queries"))
        if not live:
            continue
        qid = live[0]["query_id"]
        m1, m2 = get("/metrics"), get("/metrics")
        try:
            detail = json.loads(get(f"/queries/{qid}"))
        except urllib.error.HTTPError:
            detail = None  # it finished between the reads
        found.update(live=live, metrics=(m1, m2), detail=detail)
        return


def ops_phase(torch, pa, pc, kernels, TorchSession, tpch, tpcds, TTB,
              paths, ref6, ref1, star, li_paths, orders_path, ref3) -> tuple:
    """The query history, the event log, the wire front door and the ops
    plane on the card.  A ``ConnectServer`` on 127.0.0.1 in this process
    (the event log on, gzip; the ops plane on an ephemeral port; the
    device ledger on for the wire queries) takes q1 and q6 as Substrait
    plans (the formats phase's) and q3ds as its SQL text from a client
    process that imports no torch and no engine module; each result is
    held against its reference.  While q1 runs, ``/queries`` shows it
    and two ``/metrics`` scrapes show no counter falling.  The log, read
    back by ``tools/history``, holds one record a query with its
    ``connect`` section, K1's dispatches in each record's ledger section
    equal its planned launches (q1 6, q6 0, q3ds its counted run's), and
    ``health_check`` finds no error.  Then ``explain("analyze")`` of
    TPC-H q3 (its root's rows are the result's 10), a prepared q3
    executed twice (each record's root 10 rows), and q3 with the event
    log on and off in OPS_PAIRS alternating pairs, the walls beside the
    card's name and power limit.  Emits the phase's line; returns its
    record and its K1 launches."""
    import urllib.request

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import obs
    from spark_rapids_tpu_torch.connect.server import ConnectServer
    from spark_rapids_tpu_torch.eventlog.reader import read_log_all
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.obs import metrics as om
    from spark_rapids_tpu_torch.tools import history as H
    from spark_rapids_tpu_torch.tools.profiling import QueryHistory
    from spark_rapids_tpu_torch.tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.trace import ledger

    t_phase = time.perf_counter()
    counter = kernels.hash_columns
    k1_before = counter.launches
    dd_path, ss_paths, item_path = star["paths"]
    root = os.path.join(star["dir"], "ops")
    log_dir = os.path.join(root, "wire_log")
    os.makedirs(os.path.join(root, "results"))
    q3ds_text = QUERIES[3]
    names3 = {"i_brand_id": "brand_id", "i_brand": "brand"}
    ref3ds = reference_star(
        pc, star, lambda d: pc.equal(d["d_moy"], 11),
        lambda i: pc.equal(i["i_manufact_id"], 128),
        ["d_year", "i_brand_id", "i_brand"], names3,
        [("d_year", False), ("sum", True), ("brand_id", False)])

    # q3ds's planned K1 launches: the text's counted run in process
    fe = SqlSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    for name, where in (("date_dim", [dd_path]), ("store_sales", ss_paths),
                        ("item", [item_path])):
        fe.register_parquet(name, *where)
    local3ds, tally = counted_run(lambda: fe.sql(q3ds_text), counter)
    planned = {"q1": len(paths), "q6": 0, "q3ds": tally["per_run"]}

    # the server, the plane, the client process
    server = ConnectServer(conf={
        TTB: TASK_TARGET_BYTES, C.EVENTLOG_ENABLED: True,
        C.EVENTLOG_DIR: log_dir, C.EVENTLOG_COMPRESS: True,
        C.OBS_ENABLED: True, C.OBS_PORT: 0}, device="cuda")
    server.register_table("lineitem", paths)
    server.register_table("date_dim", dd_path)
    server.register_table("store_sales", ss_paths)
    server.register_table("item", item_path)
    plans_path = os.path.join(root, "plans.json")
    with open(plans_path, "w") as f:
        json.dump({"q1": tpch.q1_substrait(), "q6": tpch.q6_substrait(),
                   "q3ds": q3ds_text}, f)
    ledger.enable()
    # on before the first request, so that the scraper knows its port
    obs.start(port=0)
    server.start()
    found: dict = {}
    stop = threading.Event()
    try:
        host, port = server.address
        url = f"http://127.0.0.1:{obs.plane().port}"
        scraper = threading.Thread(target=ops_scraper,
                                   args=(url, stop, found), daemon=True)
        scraper.start()
        env = dict(os.environ, PYTHONPATH=ROOT)
        k1_wire = counter.launches
        t0 = time.perf_counter()
        client = subprocess.run(
            [sys.executable, "-c", OPS_CLIENT, host, str(port), plans_path,
             os.path.join(root, "results")], capture_output=True, text=True,
            timeout=600, env=env, cwd=root)
        client_s = time.perf_counter() - t0
        k1_wire = counter.launches - k1_wire
        stop.set()
        scraper.join()
        if client.returncode != 0:
            raise AssertionError(f"the ops client failed: {client.stderr}")
        client_out = json.loads(client.stdout.strip().splitlines()[-1])
        if client_out["forbidden_modules"]:
            raise AssertionError(f"the client imported "
                                 f"{client_out['forbidden_modules']}")
        QueryHistory.shutdown_worker()  # every record appended
    finally:
        stop.set()
        server.shutdown()
        ledger.disable()
        obs.stop()
    if obs.is_enabled() or any(t.name.startswith("srt-obs")
                               for t in threading.enumerate()):
        raise AssertionError("the ops plane outlived its phase")

    # the results against their references
    def result(name):
        with pa.memory_map(os.path.join(root, "results",
                                        name + ".arrow")) as f:
            return pa.ipc.open_file(f).read_all()

    errs = {"q1": compare(result("q1"), ref1, 2),
            "q6": compare(result("q6"), ref6, 0),
            "q3ds": compare_ranked(result("q3ds"), ref3ds, 100,
                                   ("d_year", "brand_id", "brand"),
                                   "sum_agg", "sum")}
    if not result("q3ds").equals(local3ds):
        raise AssertionError("q3ds over the wire differs from the same "
                             "text run in process")

    # the live view
    if not found:
        raise AssertionError("no scrape saw a query in flight")
    detail = found["detail"]
    if detail is not None and "l_returnflag" not in (detail["plan"] or ""):
        raise AssertionError(f"the first query in flight was not q1: "
                             f"{detail['plan']}")
    m1, m2 = (om.parse_openmetrics(m) for m in found["metrics"])
    falls = [(n, om.scrape_value(m1, n), om.scrape_value(m2, n))
             for n, fam in m1.items() if fam["type"] == "counter"
             and (om.scrape_value(m2, n) or 0) < (om.scrape_value(m1, n)
                                                  or 0)]
    if falls or om.scrape_value(m1, "tpu_queries_in_flight") != 1:
        raise AssertionError(f"scrapes during q1: in flight "
                             f"{om.scrape_value(m1, 'tpu_queries_in_flight')}"
                             f", counters falling {falls}")

    # the log, read back
    files = sorted(os.listdir(log_dir))
    apps = [H.load_application(os.path.join(log_dir, f)) for f in files]
    queries = [q for a in apps for q in a.queries]
    if len(queries) != 3:
        raise AssertionError(f"{len(queries)} query records in {files}")
    by_name = {}
    # the client sends them in this order, one after another
    for name, q in zip(("q1", "q6", "q3ds"),
                       sorted(queries, key=lambda q: q.query_id)):
        k1 = sum(p.get("dispatches", 0) for p in
                 ((q.programs or {}).get("programs") or {}).values()
                 if p.get("tag") == counter.PROGRAM)
        conn = q.raw.get("connect") or {}
        by_name[name] = {"rows": q.rows, "k1": k1, "wall_s": q.wall_s,
                         "engine": q.engine,
                         "root_rows": q.operators.metrics["numOutputRows"],
                         "connect": conn}
        if not conn.get("peer", "").startswith("127.0.0.1:") \
                or conn.get("wire_bytes", 0) <= 0:
            raise AssertionError(f"{name}'s record has no connect section: "
                                 f"{conn}")
        if k1 != planned[name]:
            raise AssertionError(f"{name}'s record counts {k1} K1 "
                                 f"launches, planned {planned[name]}")
        if q.rows != result(name).num_rows != q.operators.metrics[
                "numOutputRows"]:
            raise AssertionError(f"{name}'s record: {q.rows} rows")
    if "i_manufact_id" not in max(queries, key=lambda q: q.query_id).plan:
        raise AssertionError("the last record is not q3ds's")
    if k1_wire != sum(planned.values()):
        raise AssertionError(f"the wire queries launched {k1_wire}, "
                             f"planned {planned}")
    findings = [f for a in apps for f in H.health_check(a)]
    if any(f.severity == "error" for f in findings):
        raise AssertionError(f"health: {[f.render() for f in findings]}")
    header = read_log_all(os.path.join(log_dir, files[0]))[0]

    # explain("analyze") and a prepared q3 executed twice, the log on
    q3_log = os.path.join(root, "q3_log")
    on = TorchSession({TTB: TASK_TARGET_BYTES, C.EVENTLOG_ENABLED: True,
                       C.EVENTLOG_DIR: q3_log}, device="cuda")

    def q3_of(session):
        return tpch.q3_dataframe(session, li_paths, orders_path)

    def ranked(t):
        return compare_ranked(t, ref3, 10, ("l_orderkey", "o_orderdate",
                                            "o_shippriority"), "revenue",
                              "rev_sum")

    analyzed = q3_of(on).explain("analyze")
    root_line = analyzed.splitlines()[1]
    if " rows=10 " not in root_line:
        raise AssertionError(f"explain('analyze') root: {root_line}")
    prepared = on.prepare(q3_of(on))
    prepared_rows = []
    for _ in range(2):
        errs["q3_prepared"] = ranked(prepared.execute())
        prepared_rows.append(on.history.events[-1].root.metrics[
            "numOutputRows"])
    _, q3_recs = read_log_all(on.event_log_path)[:2]
    rec_rows = [r["operators"]["metrics"]["numOutputRows"]
                for r in q3_recs]
    if prepared_rows != [10, 10] or rec_rows != [10, 10, 10]:
        raise AssertionError(f"prepared q3 recorded {prepared_rows}, the "
                             f"log {rec_rows}")

    # q3 with the log on and off, in alternating pairs
    off = TorchSession({TTB: TASK_TARGET_BYTES}, device="cuda")
    walls = {"on": [], "off": []}
    for i in range(OPS_PAIRS):
        for which in (("on", "off") if i % 2 == 0 else ("off", "on")):
            session = on if which == "on" else off
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = q3_of(session).collect()
            torch.cuda.synchronize()
            walls[which].append(time.perf_counter() - t0)
            ranked(out)
    _ = on.history.events
    rec = {"seconds": time.perf_counter() - t_phase,
           "client_s": client_s, "client": client_out,
           "wire_k1": k1_wire,
           "planned_k1": planned, "records": by_name,
           "log_files": files, "log_env": header["env"] if header else None,
           "health": [f.render() for f in findings],
           "in_flight": found["live"], "detail_plan_hash":
           detail["plan_hash"] if detail else None,
           "metric_families": len(m1), "max_rel_err": errs,
           "analyze": analyzed.splitlines(), "prepared_rows": prepared_rows,
           "q3_walls_s": walls, "nvidia_smi": nvidia_smi(),
           "hash_columns_launches": counter.launches - k1_before}
    emit("ops", **rec)
    return rec, rec["hash_columns_launches"]


#: rows a batch the surface phase's q1 export asks ``to_batches`` for
SURFACE_BATCH_ROWS = 1 << 16
#: CSV spellings of one TIMESTAMP the surface phase reads on the card
#: (F8): no zone offset, ``T``-separated, UTC and at an offset
SURFACE_STAMPS = {"naive": "2001-02-03 04:05:06",
                  "t_separated": "2001-02-03T04:05:06",
                  "zulu": "2001-02-03T04:05:06Z",
                  "offset": "2001-02-03 06:05:06+02:00"}


def ledger_dispatches(ledger, fn) -> tuple:
    """(``fn()``, the device ledger's dispatches during it), the ledger
    on for the call and left as it was."""
    was = ledger.LEDGER.enabled
    ledger.enable()
    try:
        before = ledger.snapshot()
        out = fn()
        ledger.LEDGER.flush(timeout=5.0)
        moved = ledger.delta(before, ledger.snapshot())
    finally:
        if not was:
            ledger.disable()
    return out, sum(p["dispatches"] for p in moved.values())


def same_table(a, b, keys: tuple) -> float:
    """Two results of one query in ``keys``' order: keys, counts and
    strings equal, floats within REL_TOL; the largest relative float
    difference."""
    order = [(k, "ascending") for k in keys]
    ra = (a.sort_by(order) if keys else a).to_pylist()
    rb = (b.sort_by(order) if keys else b).to_pylist()
    if len(ra) != len(rb):
        raise AssertionError(f"{len(ra)} rows against {len(rb)}")
    worst = 0.0
    for x, y in zip(ra, rb):
        for name, v in y.items():
            if isinstance(v, float):
                rel = abs(x[name] - v) / max(abs(v), 1e-300)
                worst = max(worst, rel)
                if rel <= REL_TOL:
                    continue
            elif x[name] == v:
                continue
            raise AssertionError(f"{x} against {y}")
    return worst


def surface_phase(torch, np, pa, kernels, TorchSession, tpch, tpcds, TTB,
                  paths, ref6, ref1, star, li_paths, orders_path,
                  ref3) -> tuple:
    """The session's and the planner's last surface on the card: A. q1
    (its hash exchange launching K1) through ``collect()``,
    ``to_batches(batch_rows=SURFACE_BATCH_ROWS)`` and ``rows()``, each
    equal to the collected table and to the q1 reference, each with its
    planned K1 launches; B. q6's filter and projection (no sum) through
    ``to_device_arrays()``: every tensor on the card, the valid
    revenues' sum equal to q6's ``collect()`` within REL_TOL; C. q1 and
    q6 with ``spark.rapids.tpu.sql.enabled`` off, collected and
    prepared: every node a CPU fallback on purpose, the switch's reason
    on each node of ``explain()``, each result equal to its reference
    and to its device run of A or B within REL_TOL, the device ledger's dispatches and K1's launches 0
    in those runs, the switch-off walls beside the device walls of A
    and B; D. the cost-based demotion on, under the JAX cost model as it
    is: q6 keeps every node on the card and equals B's table; q1 demotes
    whole, as JAX's q1 does (its grouped aggregate's estimate is its
    input's rows, so the island's exit transfer outweighs the card),
    every node a CPU fallback with the demotion's reason, equal to its
    reference with no dispatch and no K1 launch; and the JAX test's
    2000-row island sandwiched between two CPU Filters demotes, equal
    to the CPU engine; E. TPC-H q3 with ``sql.topn.maxRows`` = 5 plans a full
    sort and equals the default (top-n) run; F. q3ds with the runtime
    filter's ``minMaxEnabled`` off and ``fpp`` = 0.5 equals the default
    run (a Bloom-only filter), and with ``maxBuildRows`` = 10 shows no
    ``rf#`` in ``explain()``; G. ``collect_metrics()`` of q1's tree at
    each ``sql.metrics.level``; H. F8's four TIMESTAMP spellings read
    with ``read_csv`` on the card as one UTC instant.  Emits the phase's
    line; returns its record and its K1 launches."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.execs import base as EB
    from spark_rapids_tpu_torch.plan import cost
    from spark_rapids_tpu_torch.plan.planner import (
        EXEC_SWITCHES,
        SWITCH_OFF_REASON,
        collect_exec,
    )
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.session import col, lit
    from spark_rapids_tpu_torch.trace import ledger

    t_phase = time.perf_counter()
    counter = kernels.hash_columns
    li8 = {TTB: TASK_TARGET_BYTES}
    session = TorchSession(li8, device="cuda")
    launches = 0
    rec: dict = {}

    # A. q1 exported three ways
    def q1(s=session):
        return tpch.q1_dataframe(s, paths)

    want1, wall1, n = timed_launches(torch, counter, lambda: q1().collect())
    compare(want1, ref1, 2)
    batches, wall_b, n_b = timed_launches(
        torch, counter,
        lambda: list(q1().to_batches(batch_rows=SURFACE_BATCH_ROWS)))
    rows_, wall_r, n_r = timed_launches(torch, counter,
                                        lambda: list(q1().rows()))
    if not pa.Table.from_batches(batches, schema=want1.schema).equals(want1):
        raise AssertionError("q1's to_batches differs from its collect()")
    if any(b.num_rows > SURFACE_BATCH_ROWS for b in batches):
        raise AssertionError("a to_batches batch passed batch_rows")
    if rows_ != [tuple(r.values()) for r in want1.to_pylist()]:
        raise AssertionError("q1's rows() differs from its collect()")
    if (n, n_b, n_r) != (len(paths),) * 3:
        raise AssertionError(f"q1 launched {(n, n_b, n_r)}, expected "
                             f"{len(paths)} a run")
    launches += n + n_b + n_r
    rec["export_q1"] = {"rows": want1.num_rows, "collect_wall_s": wall1,
                        "to_batches_wall_s": wall_b, "rows_wall_s": wall_r,
                        "batches": len(batches), "launches": n}

    # B. q6's filter and projection as device tensors
    q6_cond = ((col("l_shipdate") >= lit(8766))
               & (col("l_shipdate") < lit(9131))
               & (col("l_discount") >= lit(0.05))
               & (col("l_discount") <= lit(0.07))
               & (col("l_quantity") < lit(24.0)))
    want6, wall6, n6 = timed_launches(
        torch, counter, lambda: tpch.q6_dataframe(session, paths).collect())
    compare(want6, ref6, 0)
    arrays, wall_d, n_d = timed_launches(
        torch, counter, lambda: session.read_parquet(*paths).where(
            q6_cond).select((col("l_extendedprice") * col("l_discount"))
                            .alias("revenue")).to_device_arrays())
    if not arrays or any(t.device.type != "cuda" for b in arrays
                         for k, t in b.items() if k != "__num_rows"):
        raise AssertionError("to_device_arrays handed over a host tensor")
    total = float(sum(torch.where(b["revenue__valid"], b["revenue"],
                                  0.0).sum() for b in arrays).item())
    want_rev = want6.column("revenue")[0].as_py()
    rel6 = abs(total - want_rev) / abs(want_rev)
    if rel6 > REL_TOL or n6 or n_d:
        raise AssertionError(f"to_device_arrays' revenue {total} against "
                             f"{want_rev} (rel {rel6:.3e}), K1 {n6}, {n_d}")
    rec["device_arrays_q6"] = {
        "batches": len(arrays), "rows": sum(b["__num_rows"] for b in arrays),
        "collect_wall_s": wall6, "to_device_arrays_wall_s": wall_d,
        "rel_err": rel6}

    # C. the master switch off: the CPU engine on purpose, nothing on
    # the card
    off = TorchSession({**li8, C.SQL_ENABLED: False}, device="cuda")
    switch_off = {}
    for name, make, ref, keys, device_wall, device_out in (
            ("q1", tpch.q1_dataframe, ref1, ("l_returnflag", "l_linestatus"),
             wall1, want1),
            ("q6", tpch.q6_dataframe, ref6, (), wall6, want6)):
        df = make(off, paths)
        plan, meta = df._planner().plan_with_meta(df._plan)
        n_nodes = len(list(meta.walk()))
        if len(fallback_nodes(plan)) != len(list(plan.walk())) or any(
                n.device.type != "cpu" for n in fallback_nodes(plan)):
            raise AssertionError(f"{name} with the switch off plans a "
                                 f"device node: {plan.tree_string()}")
        text = df.explain()
        if text.count("because " + SWITCH_OFF_REASON) != n_nodes:
            raise AssertionError(f"{name}'s explain() lacks the switch's "
                                 f"reason on a node:\n{text}")
        out = {}
        for how, run in (("collect", lambda: make(off, paths).collect()),
                         ("prepared", lambda: off.prepare(
                             make(off, paths)).execute())):
            k0 = counter.launches
            t0 = time.perf_counter()
            got, dispatches = ledger_dispatches(ledger, run)
            wall = time.perf_counter() - t0
            k = counter.launches - k0
            err = compare(got, ref, len(keys))
            diff = same_table(got, device_out, keys)
            if dispatches or k:
                raise AssertionError(f"{name} ({how}) with the switch off "
                                     f"dispatched {dispatches}, K1 {k}")
            out[how] = {"wall_s": wall, "dispatches": dispatches,
                        "launches": k, "max_rel_err": err,
                        "max_rel_diff_to_device": diff}
        switch_off[name] = {"cpu_nodes": n_nodes,
                            "device_wall_s": device_wall, **out}
    rec["switch_off"] = switch_off

    # D. the cost-based demotion, the JAX cost model as it is: q6's
    # grand aggregate leaves one row and stays on the card; q1's grouped
    # aggregate is estimated at its input's rows, so its island's exit
    # transfer outweighs the card and it demotes, as JAX's does
    cbo = TorchSession({**li8, C.CBO_ENABLED: True}, device="cuda")
    q6_plan = tpch.q6_dataframe(cbo, paths).physical_plan()
    if fallback_nodes(q6_plan):
        raise AssertionError("the demotion moved q6 off the card: "
                             f"{q6_plan.tree_string()}")
    got, wall_cbo6, n = timed_launches(
        torch, counter, lambda: tpch.q6_dataframe(cbo, paths).collect())
    if not got.equals(want6) or n:
        raise AssertionError(f"q6 with the demotion on differs (K1 {n})")
    cbo_q1 = q1(cbo)
    q1_plan = cbo_q1.physical_plan()
    text = cbo_q1.explain()
    if len(fallback_nodes(q1_plan)) != len(list(q1_plan.walk())) or \
            text.count(cost.DEMOTION_REASON) != len(list(q1_plan.walk())):
        raise AssertionError(f"q1 with the demotion on:\n{text}")
    k0 = counter.launches
    t0 = time.perf_counter()
    got, dispatches = ledger_dispatches(ledger, lambda: q1(cbo).collect())
    wall_cbo1 = time.perf_counter() - t0
    err_cbo1 = compare(got, ref1, 2)
    if dispatches or counter.launches != k0:
        raise AssertionError(f"the demoted q1 dispatched {dispatches}, K1 "
                             f"{counter.launches - k0}")
    rng = np.random.default_rng(5)
    island = pa.table({"a": rng.integers(0, 100, 2000),
                       "b": rng.random(2000)})
    sandwich = TorchSession({C.CBO_ENABLED: True,
                             EXEC_SWITCHES[L.Filter]: False}, device="cuda")
    sdf = (sandwich.create_dataframe(island).where(col("a") > lit(10))
           .select((col("a") + col("a")).alias("a2"), col("b"))
           .where(col("a2") > lit(50)))
    splan = sdf.physical_plan()
    stext = sdf.explain()
    if len(fallback_nodes(splan)) != len(list(splan.walk())) \
            or cost.DEMOTION_REASON not in stext:
        raise AssertionError(f"the sandwiched island stayed:\n{stext}")
    sgot = sdf.collect()
    if not sgot.equals(sdf.collect(engine="cpu")):
        raise AssertionError("the demoted island differs from the CPU "
                             "engine")
    rec["demotion"] = {"q6_on_card": True, "q6_wall_s": wall_cbo6,
                       "q1_demoted_nodes": len(fallback_nodes(q1_plan)),
                       "q1_wall_s": wall_cbo1, "q1_max_rel_err": err_cbo1,
                       "island_cpu_nodes": len(fallback_nodes(splan)),
                       "island_rows": sgot.num_rows,
                       "reason": cost.DEMOTION_REASON}

    # E. sql.topn.maxRows below q3's LIMIT: a full sort
    q3_keys = ("l_orderkey", "o_orderdate", "o_shippriority")
    default3, wall3, n3 = timed_launches(
        torch, counter, lambda: tpch.q3_dataframe(
            session, li_paths, orders_path).collect())
    s5 = TorchSession({**li8, C.TOPN_MAX_ROWS: 5}, device="cuda")
    plan5 = tpch.q3_dataframe(s5, li_paths, orders_path).physical_plan()
    kinds = {type(n).__name__ for n in plan5.walk()}
    if "TpuTopNExec" in kinds or "TpuSortExec" not in kinds:
        raise AssertionError(f"q3 at topn.maxRows 5 plans {kinds}")
    got5, wall5, n5 = timed_launches(torch, counter, lambda: tpch.q3_dataframe(
        s5, li_paths, orders_path).collect())
    launches += n3 + n5
    compare_ranked(default3, ref3, 10, q3_keys, "revenue", "rev_sum")
    rel3 = same_rows(got5, default3, q3_keys, "revenue")
    if n5 != n3:
        raise AssertionError(f"q3 launched {n5} at topn.maxRows 5, {n3} "
                             "by default")
    rec["topn_max_rows"] = {"default_wall_s": wall3, "sort_wall_s": wall5,
                            "launches": n3, "max_rel_diff": rel3}

    # F. the runtime filter's keys on q3ds
    dd_path, ss_paths, item_path = star["paths"]
    ds8 = {TTB: Q3DS_TASK_TARGET_BYTES}

    def q3ds(keys=None):
        s = TorchSession({**ds8, **(keys or {})}, device="cuda")
        return tpcds.q3_dataframe(s, dd_path, ss_paths, item_path)

    base, wall_base, n_base = timed_launches(
        torch, counter, lambda: q3ds().collect())
    bloom_only = {C.RF_MINMAX_ENABLED: False, C.RF_FPP: 0.5}
    filters = [rf.describe() for n in q3ds(bloom_only).physical_plan().walk()
               if type(n).__name__ == "TpuRuntimeFilterBuildExec"
               for _k, rf in n.entries]
    if not filters or any("minmax" in f or "bloom[" not in f
                          for f in filters):
        raise AssertionError(f"q3ds's Bloom-only filters: {filters}")
    got_b, wall_bo, n_bo = timed_launches(
        torch, counter, lambda: q3ds(bloom_only).collect())
    rel_ds = same_rows(got_b, base)
    capped = q3ds({C.RF_MAX_BUILD_ROWS: 10}).explain()
    if "rf#" in capped or "rf#" not in q3ds().explain():
        raise AssertionError(f"q3ds at maxBuildRows 10:\n{capped}")
    launches += n_base + n_bo
    rec["runtime_filter_keys"] = {
        "default_wall_s": wall_base, "default_launches": n_base,
        "bloom_only_wall_s": wall_bo, "bloom_only_launches": n_bo,
        "bloom_only_filters": filters, "max_rel_diff": rel_ds}

    # G. collect_metrics at each level, over one drained q1 tree
    levels = {}
    for level in C.METRIC_LEVELS:
        s = TorchSession({**li8, C.METRICS_LEVEL: level}, device="cuda")
        tree = q1(s).physical_plan()
        k0 = counter.launches
        collect_exec(tree, s.conf)
        launches += counter.launches - k0
        levels[level] = {name: sorted(keys) for name, keys
                         in tree.collect_metrics().items()}
    for name in levels["DEBUG"]:
        e, m, d = (set(levels[lv].get(name, ())) for lv in C.METRIC_LEVELS)
        if not ({"numOutputRows", "numOutputBatches", "totalTime"} <= e
                <= m <= d) or not e <= EB.ESSENTIAL_METRICS \
                or not m <= EB.ESSENTIAL_METRICS | EB.MODERATE_METRICS:
            raise AssertionError(f"{name}'s metric levels: {e}, {m}, {d}")
    if "scanTime" not in levels["MODERATE"]["ParquetScanExec"] or \
            "scanTime" in levels["ESSENTIAL"]["ParquetScanExec"]:
        raise AssertionError(f"the scan's metric levels: {levels}")
    rec["metric_levels"] = levels

    # H. F8: a CSV TIMESTAMP in four spellings, read on the card
    import datetime as _datetime

    csv_dir = os.path.join(star["dir"], "surface_csv")
    os.makedirs(csv_dir)
    instant = _datetime.datetime(2001, 2, 3, 4, 5, 6,
                                 tzinfo=_datetime.timezone.utc)
    read = {}
    for kind, text in SURFACE_STAMPS.items():
        p = os.path.join(csv_dir, f"{kind}.csv")
        with open(p, "w") as f:
            f.write(f"a,t\n1,{text}\n2,\n")
        got = session.read_csv(p).collect()
        if got.column("t").to_pylist() != [instant, None] or \
                got.schema.field("t").type != pa.timestamp("us", tz="UTC"):
            raise AssertionError(f"read_csv of {text!r}: {got.to_pylist()}")
        read[kind] = text
    rec["csv_timestamps"] = read

    rec.update(launches=launches, seconds=time.perf_counter() - t_phase,
               nvidia_smi=nvidia_smi())
    emit("surface", **rec)
    return rec, launches


#: on / off pairs of the speculation phase, each pair's order alternating
#: (3 until the formats phase, 2 until the persist phase needed the
#: run's time)
SPEC_PAIRS = 1
#: the speculation phase's forced undershoot: a capacity far below a
#: stream batch's pairs
SPEC_UNDER = 8
#: each sizing tag and the pipelined loop whose dispatches it sizes
SPEC_LOOPS = {"join.probe": "join.stream", "agg.size": "agg.update",
              "exchange.split": "exchange.map"}
#: the programs a speculated dispatch runs at a capacity above its rows
SPEC_PROGRAMS = ("join.expand", "agg.update")


def spec_same(pa, got, want, keys: tuple) -> dict:
    """A speculation-on result against the off one: bit for bit, or the
    rows in ``keys`` order with every non-float column equal and floats
    within REL_TOL."""
    if got.equals(want):
        return {"bitwise": True, "max_rel_diff": 0.0}
    order = [(k, "ascending") for k in keys]
    a, b = got.sort_by(order), want.sort_by(order)
    if a.num_rows != b.num_rows or a.schema != b.schema:
        raise AssertionError(f"speculation: {a.num_rows} rows against "
                             f"{b.num_rows}")
    worst = 0.0
    for name in a.schema.names:
        x, y = a[name].to_pylist(), b[name].to_pylist()
        if not pa.types.is_floating(a.schema.field(name).type):
            if x != y:
                raise AssertionError(f"speculation: column {name} differs")
            continue
        for u, v in zip(x, y):
            if (u is None) != (v is None):
                raise AssertionError(f"speculation: {name} NULLs differ")
            if u is not None:
                worst = max(worst, abs(u - v) / max(abs(v), 1e-300))
    if worst > REL_TOL:
        raise AssertionError(f"speculation: floats differ by {worst}")
    return {"bitwise": False, "max_rel_diff": worst}


def spec_run(torch, kernels, make, session) -> dict:
    """One run with its sizing counted: per tag, the loop's dispatches,
    blocking / async / late readbacks (``stage_snapshot``), hits,
    overflows, warm-up syncs and declined dispatches
    (``speculation.stats`` deltas), and the joins' continuation chunks;
    each sizing join exec's hits and overflows; K1's launches; the
    wall."""
    from spark_rapids_tpu_torch.parallel import pipeline as P
    from spark_rapids_tpu_torch.parallel import speculation as SP

    from spark_rapids_tpu_torch.plan.planner import collect_exec

    P.reset_stage_counters()
    before = SP.stats()
    launches = kernels.hash_columns.launches
    with P.trace_events() as events:
        t0 = time.perf_counter()
        plan = make(session).physical_plan()
        table = collect_exec(plan, session.conf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after, stages = SP.stats(), P.stage_snapshot()
    continued = sum(n.metrics["specContinuationChunks"]
                    for n in plan.walk()
                    if "specContinuationChunks" in getattr(n, "metrics", {}))
    tags = {}
    for tag, loop in SPEC_LOOPS.items():
        st = stages.get(tag, {})
        a, b = after.get(tag, {}), before.get(tag, {})
        tags[tag] = {
            "dispatches": sum(1 for k, t in events
                              if k == "dispatch" and t == loop),
            "blocking": st.get("readbacks", 0),
            "async": st.get("async_readbacks", 0),
            "late": st.get("late_readbacks", 0),
            **{k: a.get(k, 0) - b.get(k, 0)
               for k in ("hits", "overflows", "synced", "declined")}}
    tags["join.probe"]["continuation_chunks"] = continued
    joins = [{"join": n.node_desc()[:80], "hits": n.metrics["specHits"],
              "overflows": n.metrics["specOverflows"]}
             for n in plan.walk()
             if "specContinuationChunks" in getattr(n, "metrics", {})
             and n.join_type not in ("left_semi", "left_anti")]
    return {"table": table, "wall_s": wall, "tags": tags, "joins": joins,
            "k1": kernels.hash_columns.launches - launches}


def strict_dispatch_run(torch, make, session) -> dict:
    """One run in which every dispatch half of the three speculated
    loops runs under torch.cuda.set_sync_debug_mode("error"), so a sync
    in one raises; the run is serial (no other thread syncs meanwhile).
    Returns the dispatches checked per loop."""
    from spark_rapids_tpu_torch.execs import aggregate, exchange, join
    from spark_rapids_tpu_torch.parallel import pipeline as P

    checked: dict = {}

    def strict(items, dispatch, retire, depth=None, tag=None):
        def guarded(item):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(item)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                checked[tag] = checked.get(tag, 0) + 1
        return P.pipelined(items, guarded, retire, depth, tag)

    saved = {m: m.pipelined for m in (aggregate, exchange, join)}
    for m in saved:
        m.pipelined = strict
    try:
        make(session).collect()
        torch.cuda.synchronize()
    finally:
        for m, f in saved.items():
            m.pipelined = f
    return checked


def spec_ratio(programs: dict) -> dict:
    """live / capacity rows of the speculated programs in a ledger
    delta."""
    live = sum(p["live_rows"] for p in programs.values()
               if p["tag"] in SPEC_PROGRAMS)
    cap = sum(p["capacity_rows"] for p in programs.values()
              if p["tag"] in SPEC_PROGRAMS)
    return {"live_rows": live, "capacity_rows": cap,
            "live_capacity_ratio": live / cap if cap else None}


def speculation_phase(torch, pa, pc, kernels, TorchSession, tpch, tpcds,
                      TTB, paths, ref1, li_paths, orders_path, ref3,
                      star) -> tuple:
    """Checks A-H of the module docstring's ``speculation`` entry; emits
    the phase's line.  Returns (its record, the K1 launches it made,
    its hash_columns calls)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.execs.base import REAPER
    from spark_rapids_tpu_torch.parallel import speculation as SP
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.trace import ledger

    t_phase = time.perf_counter()
    launches0 = kernels.hash_columns.launches
    _, ss_paths, _ = star["paths"]
    sr_path, reason_path = star["q93_paths"]
    q3_keys = {TTB: TASK_TARGET_BYTES, ADAPTIVE: False}
    # q3 last: checks D-F run on its warm predictors
    queries = {
        "q1": ({TTB: TASK_TARGET_BYTES},
               lambda s: tpch.q1_dataframe(s, paths),
               lambda t: compare(t, ref1, 2),
               ("l_returnflag", "l_linestatus")),
        "q93": ({TTB: Q3DS_TASK_TARGET_BYTES, ADAPTIVE: False},
                lambda s: tpcds.q93_dataframe(s, ss_paths, sr_path,
                                              reason_path),
                lambda t: compare_ranked(
                    t, star["q93_ref"], 100, ("ss_customer_sk",),
                    "sumsales", "act_sum"),
                ("ss_customer_sk",)),
        "q3": (q3_keys,
               lambda s: tpch.q3_dataframe(s, li_paths, orders_path),
               lambda t: compare_ranked(
                   t, ref3, 10, ("l_orderkey", "o_orderdate",
                                 "o_shippriority"), "revenue", "rev_sum"),
               ("l_orderkey",)),
    }
    off = {C.SPECULATION_ENABLED: False}
    out: dict = {}
    calls: list = []
    for name, (keys, make, check, order) in queries.items():
        on_s = TorchSession(keys, device="cuda")
        off_s = TorchSession({**keys, **off}, device="cuda")
        SP.reset_predictors()
        SP.reset_stats()
        original = kernels.hash_columns
        kernels.hash_columns = RecordingHashColumns(original, calls)
        try:
            first_on = spec_run(torch, kernels, make, on_s)
        finally:
            kernels.hash_columns = original
        first_off = spec_run(torch, kernels, make, off_s)
        want = first_off["table"]
        same = [spec_same(pa, first_on["table"], want, order)]
        err = max(check(first_on["table"]), check(want))
        runs = {"on": [], "off": []}
        for i in range(SPEC_PAIRS):
            for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
                r = spec_run(torch, kernels, make,
                             on_s if side == "on" else off_s)
                same.append(spec_same(pa, r["table"], want, order))
                del r["table"]
                runs[side].append(r)
        if len({r["k1"] for r in runs["on"] + runs["off"]}
               | {first_on["k1"], first_off["k1"]}) != 1:
            raise AssertionError(f"speculation {name}: K1 launches differ "
                                 f"on and off")
        for r in runs["off"] + [first_off]:
            if any(t["async"] or t["hits"] or t["overflows"]
                   for t in r["tags"].values()):
                raise AssertionError(f"speculation {name}: an off run "
                                     f"speculated: {r['tags']}")
        for r in runs["on"]:
            # past the warm-up a count blocks only when it had not
            # landed (late, counted apart); no chunk is declined, and
            # each join exec speculated (one join's hits cannot cover
            # another's blocking reads)
            probe = r["tags"]["join.probe"]
            if probe["blocking"] != probe["late"] or probe["synced"] \
                    or probe["declined"]:
                raise AssertionError(f"speculation {name}: a steady-state "
                                     f"join.probe read blocked: {probe}")
            idle = [j for j in r["joins"] if not j["hits"] + j["overflows"]]
            if idle or (name != "q1" and not r["joins"]):
                raise AssertionError(f"speculation {name}: a join did not "
                                     f"speculate: {r['joins']}")
        del first_on["table"], first_off["table"]
        prof = {side: profiled_run(torch, lambda s=s: make(s))
                for side, s in (("on", on_s), ("off", off_s))}
        counts = {side: prof[side].pop("kernel_counts") for side in prof}
        diff = {k: counts["on"].get(k, 0) - counts["off"].get(k, 0)
                for k in set(counts["on"]) | set(counts["off"])}
        prof["kernel_count_on_minus_off"] = sorted(
            ((k[:60], v) for k, v in diff.items() if v),
            key=lambda kv: -abs(kv[1]))[:12]
        strict = strict_dispatch_run(torch, make, TorchSession(
            {**keys, **C.SERIAL}, device="cuda"))
        out[name] = {
            "max_rel_err": err, "same": same,
            "first_on": first_on, "first_off": first_off,
            "on": runs["on"], "off": runs["off"],
            "on_wall_s": [r["wall_s"] for r in runs["on"]],
            "off_wall_s": [r["wall_s"] for r in runs["off"]],
            "on_median_s": statistics.median(
                r["wall_s"] for r in runs["on"]),
            "off_median_s": statistics.median(
                r["wall_s"] for r in runs["off"]),
            "profiled": prof, "strict_dispatches": strict}
    make3, check3 = queries["q3"][1], queries["q3"][2]
    want3 = make3(TorchSession({**q3_keys, **off}, device="cuda")).collect()
    # C: the syncs outside device_read*, per site
    out["q3_syncs"] = {
        side: sync_sites(torch, lambda side=side: make3(TorchSession(
            {**q3_keys, **(off if side == "off" else {})}, device="cuda")),
            top=None) for side in ("on", "off")}

    def join_rows(keys) -> dict:
        """q3's join output alone: its rows and NULL order keys."""
        s = TorchSession(keys, device="cuda")
        plan = make3(s).physical_plan()
        j = next(n for n in plan.walk()
                 if type(n).__name__.endswith("HashJoinExec"))
        t = collect_exec(j, s.conf)
        return {"rows": t.num_rows,
                "null_keys": t["l_orderkey"].null_count}

    # D: forced undershoot and overshoot
    forced = {}
    for label, cap in (("under", SPEC_UNDER),
                       ("over", C.DEFAULTS[C.JOIN_OUTPUT_CHUNK_ROWS])):
        keys = {**q3_keys, C.SPECULATION_TEST_FORCE_CAPACITY: cap}
        r = spec_run(torch, kernels, make3, TorchSession(keys,
                                                         device="cuda"))
        r["same"] = spec_same(pa, r.pop("table"), want3, ("l_orderkey",))
        probe = r["tags"]["join.probe"]
        if label == "under" and not probe["overflows"]:
            raise AssertionError(f"speculation: no overflow at {cap}: "
                                 f"{r['tags']}")
        if label == "over" and (probe["overflows"] or not probe["hits"]):
            raise AssertionError(f"speculation: forced {cap}: {probe}")
        r["join"] = join_rows(keys)
        forced[label] = r
    forced["off_join"] = join_rows({**q3_keys, **off})
    if forced["over"]["join"] != forced["off_join"] \
            or forced["off_join"]["null_keys"]:
        raise AssertionError(f"speculation: dead rows at the ceiling: "
                             f"{forced['over']['join']} against "
                             f"{forced['off_join']}")
    out["forced"] = forced
    # E: the kill switch
    SP.reset_stats()
    total0 = SP.disabled_total()
    kill_s = TorchSession({**q3_keys, C.SPECULATION_TEST_FORCE_CAPACITY:
                           SPEC_UNDER, C.SPECULATION_MIN_HIT_RATE: 0.99,
                           C.SPECULATION_WINDOW: 2}, device="cuda")
    convicting = spec_run(torch, kernels, make3, kill_s)
    convicted = SP.disabled_tags()
    after = spec_run(torch, kernels, make3, kill_s)
    kill = {"disabled_tags": convicted,
            "disabled_total": SP.disabled_total() - total0,
            "convicting_run": convicting["tags"],
            "next_run": after["tags"],
            "same": [spec_same(pa, convicting.pop("table"), want3,
                               ("l_orderkey",)),
                     spec_same(pa, after.pop("table"), want3,
                               ("l_orderkey",))]}
    probe = after["tags"]["join.probe"]
    if "join.probe" not in convicted or kill["disabled_total"] < 1 \
            or probe["async"] or probe["blocking"] != probe["dispatches"]:
        raise AssertionError(f"speculation: the kill switch {kill}")
    SP.reset_stats()
    out["kill_switch"] = kill
    # F: the ledger's occupancy of the speculated programs
    occupancy = {}
    for side in ("on", "off"):
        s = TorchSession({**q3_keys, **(off if side == "off" else {})},
                         device="cuda")
        ledger.enable()
        try:
            before = ledger.snapshot()
            got = make3(s).collect()
            torch.cuda.synchronize()
            ledger.LEDGER.flush(60)
            occupancy[side] = spec_ratio(ledger.delta(before,
                                                      ledger.snapshot()))
        finally:
            ledger.disable()
            REAPER.flush()
        spec_same(pa, got, want3, ("l_orderkey",))
    if not (occupancy["on"]["live_capacity_ratio"] or 1) < 1 \
            or occupancy["off"]["live_capacity_ratio"] != 1.0:
        raise AssertionError(f"speculation: occupancy {occupancy}")
    out["occupancy"] = occupancy
    out["stats"] = SP.stats()
    launches = kernels.hash_columns.launches - launches0
    emit("speculation", seconds=time.perf_counter() - t_phase,
         k1_launches=launches, **out)
    return out, launches, calls


#: query -> (DataFrame name, (year, manager), group keys, output names of
#: keys, sum column, the order: (column, descending) over output names)
STAR_QUERIES = {
    "q42": ("q42_dataframe", (2000, 1),
            ["d_year", "i_category_id", "i_category"], {}, "sum_agg",
            [("sum", True), ("d_year", False), ("i_category_id", False),
             ("i_category", False)]),
    "q52": ("q52_dataframe", (2000, 1), ["d_year", "i_brand", "i_brand_id"],
            {"i_brand_id": "brand_id", "i_brand": "brand"}, "ext_price",
            [("d_year", False), ("sum", True), ("brand_id", False)]),
    "q55": ("q55_dataframe", (1999, 28), ["i_brand", "i_brand_id"],
            {"i_brand_id": "brand_id", "i_brand": "brand"}, "ext_price",
            [("sum", True), ("brand_id", False)]),
}


def star_phase(torch, pc, star, kernels, TorchSession, tpcds, TTB):
    """TPC-DS q42, q52 and q55 once each over q3ds's tables: the plan
    (two broadcast joins, the runtime filter on the store_sales scan),
    the rows against the pyarrow reference, and K1's launches (the
    aggregate's map batches, the filter's two lanes per folded batch and
    per range table).  No profile.  Emits the phase's line; returns the
    records and the hash_columns calls."""
    dd_path, ss_paths, item_path = star["paths"]
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    records, calls = {}, []
    for name, (fn, (year, manager), keys, names, sum_col, order) in \
            STAR_QUERIES.items():
        def star_df(fn=fn):
            return getattr(tpcds, fn)(session, dd_path, ss_paths, item_path)

        plan = star_df().physical_plan()
        joins = join_strategies(plan)
        want_joins = [["TpuBroadcastHashJoinExec", "inner", "right"],
                      ["TpuBroadcastHashJoinExec", "inner", "left"]]
        applied = [(n.paths, c) for n in plan.walk()
                   for c, _ in getattr(n, "runtime_filters", ())]
        if joins != want_joins or applied != [(ss_paths,
                                               "ss_sold_date_sk")]:
            raise AssertionError(f"{name}: joins {joins}, runtime filters "
                                 f"{applied}")
        ref = reference_star(
            pc, star, lambda d, y=year: pc.and_(pc.equal(d["d_moy"], 11),
                                                pc.equal(d["d_year"], y)),
            lambda i, m=manager: pc.equal(i["i_manager_id"], m), keys,
            names, order)
        out_keys = tuple(names.get(k, k) for k in keys)
        rec = run_query(torch, star_df, kernels, lambda t: compare_ranked(
            t, ref, 100, out_keys, sum_col, "sum"), calls, quick=True,
            counted=True)
        check_launches(name, rec, rec)
        records[name] = {"groups": len(ref), "joins": joins, **rec}
    emit("star", **records)
    return records, calls


def dimension_tables(pq, star, tpcds) -> None:
    """SF1's 12 stores and 1 920 800 customer_demographics rows, written
    beside q3ds's tables; their paths (and the stores) go into ``star``."""
    t0 = time.perf_counter()
    star["store_path"] = tpcds.write_store(star["dir"])
    star["cdemo_path"] = tpcds.write_customer_demographics(star["dir"])
    star["dimensions_datagen_s"] = time.perf_counter() - t0
    star["store"] = pq.read_table(star["store_path"])


def read_sales(pa, pq, star, columns: list):
    return pa.concat_tables([pq.read_table(p, columns=columns)
                             for p in star["paths"][1]])


def reference_q67_rollup(pa, pc, pq, star, tpcds) -> dict:
    """q67 as written by pyarrow and numpy: the year's joined rows, the
    sales of each of the nine ROLLUP levels (the dropped keys NULL),
    ranked within each category (its NULL one too) by sum, descending,
    ties sharing the lowest rank; the rows ranked 1-100 in the text's
    order (keys with NULLs first, sum, rank), the first 100.  Returns
    those rows, each category's sums sorted descending (for ties), the
    joined rows and the groups."""
    import numpy as np

    keys = list(tpcds.Q67_KEYS)
    dd = star["date_dim"]
    dd = dd.filter(pc.and_(pc.greater_equal(dd["d_month_seq"], 1200),
                           pc.less_equal(dd["d_month_seq"], 1211))).select(
        ["d_date_sk", "d_year", "d_qoy", "d_moy"])
    item = star["item"].select(["i_item_sk", "i_category", "i_class",
                                "i_brand", "i_product_name"])
    store = star["store"].select(["s_store_sk", "s_store_id"])
    j = read_sales(pa, pq, star, ["ss_sold_date_sk", "ss_item_sk",
                                  "ss_store_sk", "ss_quantity",
                                  "ss_sales_price"])
    j = j.join(dd, keys="ss_sold_date_sk", right_keys="d_date_sk",
               join_type="inner")
    j = j.join(store, keys="ss_store_sk", right_keys="s_store_sk",
               join_type="inner")
    j = j.join(item, keys="ss_item_sk", right_keys="i_item_sk",
               join_type="inner")
    j = j.append_column("sales", pc.coalesce(pc.multiply(
        j["ss_sales_price"], pc.cast(j["ss_quantity"], pa.float64())), 0.0))
    levels = []
    for n in range(len(keys), -1, -1):
        if n:
            g = j.group_by(keys[:n]).aggregate([("sales", "sum")])
        else:
            g = pa.table({"sales_sum": [pc.sum(j["sales"]).as_py()]})
        cols = [g[k] if k in keys[:n] else pa.nulls(g.num_rows,
                                                     j.schema.field(k).type)
                for k in keys]
        levels.append(pa.table(cols + [g["sales_sum"]],
                               names=keys + ["sumsales"]))
    groups = pa.concat_tables(levels)
    cat = groups["i_category"].combine_chunks().dictionary_encode()
    codes = cat.indices.fill_null(-1).to_numpy(zero_copy_only=False)
    sums = groups["sumsales"].to_numpy()
    order = np.lexsort((-sums, codes))
    cs, ss = codes[order], sums[order]
    idx = np.arange(len(order))
    new_cat = np.r_[True, cs[1:] != cs[:-1]]
    new_run = new_cat | np.r_[True, ss[1:] != ss[:-1]]
    seg = np.maximum.accumulate(np.where(new_cat, idx, 0))
    run = np.maximum.accumulate(np.where(new_run, idx, 0))
    rank = np.empty(len(order), np.int64)
    rank[order] = run - seg + 1
    kept = groups.take(pa.array(np.nonzero(rank <= 100)[0])).append_column(
        "rk", pa.array(rank[rank <= 100]))
    rows = sorted(kept.to_pylist(), key=lambda r: [
        *[(r[k] is not None, r[k]) for k in keys], r["sumsales"], r["rk"]])
    by_cat = {}
    for c in {r["i_category"] for r in rows[:100]}:
        m = codes == (-1 if c is None else cat.dictionary.index(c).as_py())
        by_cat[c] = np.sort(sums[m])[::-1]
    return {"rows": rows[:100], "sums_by_category": by_cat,
            "joined_rows": j.num_rows, "groups": groups.num_rows}


def compare_q67_rollup(got_table, ref: dict) -> float:
    """q67's 100 rows against the reference's, place by place: keys
    exact, sums within REL_TOL, and the rank exact unless other sums of
    the category lie within REL_TOL of the row's (then within their
    span).  Returns the largest relative sum error."""
    import numpy as np

    got, want = got_table.to_pylist(), ref["rows"]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        keys = [k for k in g if k not in ("sumsales", "rk")]
        if [g[k] for k in keys] != [w[k] for k in keys]:
            raise AssertionError(f"place {i}: {g} vs reference {w}")
        rel = abs(g["sumsales"] - w["sumsales"]) / max(abs(w["sumsales"]),
                                                       1e-300)
        worst = max(worst, rel)
        if rel > REL_TOL:
            raise AssertionError(f"place {i}: sum {g['sumsales']} vs "
                                 f"{w['sumsales']} (rel {rel:.3e})")
        desc = ref["sums_by_category"][g["i_category"]]
        tol = REL_TOL * abs(w["sumsales"])
        lo = 1 + int(np.sum(desc > w["sumsales"] + tol))
        hi = 1 + int(np.sum(desc > w["sumsales"] - tol))
        if not lo <= g["rk"] <= hi:
            raise AssertionError(f"place {i}: rank {g['rk']}, reference "
                                 f"{w['rk']} (ties allow {lo}-{hi})")
    return worst


def expect_plan(name: str, plan, star, joins: list, filters: list) -> None:
    """The plan's joins (exec, type, build side, in plan order) and the
    runtime filters' keys on the store_sales scan."""
    got = join_strategies(plan)
    if got != joins:
        raise AssertionError(f"{name} joins {got}, expected {joins}")
    applied = [(n.paths, c) for n in plan.walk()
               for c, _ in getattr(n, "runtime_filters", ())]
    if applied != [(star["paths"][1], k) for k in filters]:
        raise AssertionError(f"{name} runtime filters {applied}, expected "
                             f"{filters} on the store_sales scan")


BCAST_RIGHT = ["TpuBroadcastHashJoinExec", "inner", "right"]


def q67_rollup_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
                     TTB) -> tuple:
    """TPC-DS q67 as written over q3ds's tables and the 12 stores: the
    plan (three broadcast joins, the date filter on the store_sales
    scan, the Expand of nine projections under the partial aggregate),
    the 100 rows against the pyarrow reference, K1's launches, and the
    expanded rows and groups.  Emits the phase's line; returns its
    record and hash_columns calls."""
    dd_path, ss_paths, item_path = star["paths"]
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")

    def q67r_df():
        return tpcds.q67_rollup_dataframe(session, dd_path, ss_paths,
                                          item_path, star["store_path"])

    plan = q67r_df().physical_plan()
    expect_plan("q67_rollup", plan, star, [BCAST_RIGHT] * 3,
                ["ss_sold_date_sk"])
    [expand] = [n for n in plan.walk() if type(n).__name__ ==
                "TpuExpandExec"]
    partial = [n for n in plan.walk() if getattr(n, "mode", "") ==
               "partial"]
    if len(expand.projections) != 9 or partial[0].children[0] is not expand:
        raise AssertionError("q67_rollup: no Expand of 9 projections under "
                             "the partial aggregate")
    t0 = time.perf_counter()
    ref = reference_q67_rollup(pa, pc, pq, star, tpcds)
    ref_s = time.perf_counter() - t0
    calls: list = []
    rec = run_query(torch, q67r_df, kernels,
                    lambda t: compare_q67_rollup(t, ref), calls,
                    counted=True)
    check_launches("q67_rollup", rec, rec)
    out = {"plan": plan.tree_string().splitlines(),
           "joined_rows": ref["joined_rows"],
           "expanded_rows": 9 * ref["joined_rows"], "groups": ref["groups"],
           "reference_s": ref_s,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    emit("q67_rollup", stores=star["store"].num_rows, **out)
    return out, calls


def reference_q5(pa, pc, pq, star, tpcds) -> dict:
    """q5's store channel by pyarrow: each store id's sales, returns and
    profit net of losses over the two weeks."""
    dd = star["date_dim"]
    d = pc.cast(dd["d_date"], pa.int32())
    keys = dd.filter(pc.and_(pc.greater_equal(d, tpcds.Q5_DATES[0]),
                             pc.less_equal(d, tpcds.Q5_DATES[1])))[
        "d_date_sk"]
    names = ["store_sk", "date_sk", "sales_price", "profit", "return_amt",
             "net_loss"]
    ss = read_sales(pa, pq, star, ["ss_store_sk", "ss_sold_date_sk",
                                   "ss_ext_sales_price", "ss_net_profit"])
    zero = pa.array([0.0] * ss.num_rows)
    ss = pa.table(list(ss.columns) + [zero, zero], names=names)
    sr = pq.read_table(star["q93_paths"][0], columns=[
        "sr_store_sk", "sr_returned_date_sk", "sr_return_amt",
        "sr_net_loss"])
    zero = pa.array([0.0] * sr.num_rows)
    sr = pa.table([sr.column(0), sr.column(1), zero, zero, sr.column(2),
                   sr.column(3)], names=names)
    u = pa.concat_tables([ss, sr])
    u = u.filter(pc.is_in(u["date_sk"], value_set=keys))
    u = u.join(star["store"].select(["s_store_sk", "s_store_id"]),
               keys="store_sk", right_keys="s_store_sk", join_type="inner")
    g = u.group_by(["s_store_id"]).aggregate([
        ("sales_price", "sum"), ("profit", "sum"), ("return_amt", "sum"),
        ("net_loss", "sum")])
    return {(r["s_store_id"],): {
        "sales": r["sales_price_sum"], "returns_amt": r["return_amt_sum"],
        "profit": r["profit_sum"] - r["net_loss_sum"]}
        for r in g.to_pylist()}, u.num_rows


def q5_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
             TTB) -> tuple:
    """TPC-DS q5's store channel over q3ds's store_sales, q93's
    store_returns and the 12 stores: the plan (the union of both,
    numbered member after member, under the date and store broadcasts;
    no runtime filter reaches through the union, as in the JAX plan),
    the rows against the pyarrow reference, K1's launches.  Emits the
    phase's line; returns its record and hash_columns calls."""
    dd_path, ss_paths, _ = star["paths"]
    sr_path = star["q93_paths"][0]
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")

    def q5_df():
        return tpcds.q5_dataframe(session, dd_path, ss_paths, sr_path,
                                  star["store_path"])

    plan = q5_df().physical_plan()
    expect_plan("q5", plan, star, [BCAST_RIGHT] * 2, [])
    [union] = [n for n in plan.walk() if type(n).__name__ == "TpuUnionExec"]
    if union.num_partitions != Q3DS_FILES + 1:
        raise AssertionError(f"q5 union of {union.num_partitions} "
                             f"partitions, expected {Q3DS_FILES + 1}")
    ref, union_rows = reference_q5(pa, pc, pq, star, tpcds)

    def check(t):
        ids = t["s_store_id"].to_pylist()
        if ids != sorted(ids):
            raise AssertionError("q5 rows are not in store id order")
        return compare(t, ref, 1)

    calls: list = []
    rec = run_query(torch, q5_df, kernels, check, calls, counted=True)
    check_launches("q5", rec, rec)
    out = {"plan": plan.tree_string().splitlines(),
           "union_rows_in_dates": union_rows,
           "hash_columns_calls": sorted({(n, signature(cols), seed, parts)
                                         for cols, n, seed, parts in calls}),
           **rec}
    emit("q5", returns_in=pq.read_metadata(sr_path).num_rows, **out)
    return out, calls


#: the columns q7 and q27 average, and their names in the result
AVG_COLUMNS = [("ss_quantity", "agg1"), ("ss_list_price", "agg2"),
               ("ss_coupon_amt", "agg3"), ("ss_sales_price", "agg4")]


def demographic_sales(pa, pc, pq, star, tpcds, year: int, keys: list):
    """The year's store_sales rows sold to the demographic q7 and q27
    both ask for (``tpcds.Q27_DEMOGRAPHICS``): ``keys`` and AVG_COLUMNS,
    these as DOUBLE (a decimal too, as the average gives it)."""
    gender, marital, education = tpcds.Q27_DEMOGRAPHICS
    cd = pq.read_table(star["cdemo_path"])
    cd = cd.filter(pc.and_(pc.and_(
        pc.equal(cd["cd_gender"], gender),
        pc.equal(cd["cd_marital_status"], marital)),
        pc.equal(cd["cd_education_status"], education)))
    dd = star["date_dim"]
    dd = dd.filter(pc.equal(dd["d_year"], year))
    j = read_sales(pa, pq, star, ["ss_sold_date_sk", "ss_cdemo_sk", *keys,
                                  *(c for c, _ in AVG_COLUMNS)])
    j = j.filter(pc.is_in(j["ss_cdemo_sk"], value_set=cd["cd_demo_sk"]))
    j = j.filter(pc.is_in(j["ss_sold_date_sk"], value_set=dd["d_date_sk"]))
    for c, _ in AVG_COLUMNS:
        j = j.set_column(j.schema.get_field_index(c), c,
                         j[c].cast(pa.float64()))
    return j


def reference_q7(pa, pc, pq, star, tpcds, promotion) -> list:
    """q7 by pyarrow: the year 2000's sales to the demographic under a
    promotion not by email or not by event, averaged by item id; the
    rows by item id (NULL first), the first 100."""
    j = demographic_sales(pa, pc, pq, star, tpcds, 2000,
                          ["ss_item_sk", "ss_promo_sk"])
    p = promotion.filter(pc.or_kleene(
        pc.equal(promotion["p_channel_email"], "N"),
        pc.equal(promotion["p_channel_event"], "N")))
    j = j.filter(pc.is_in(j["ss_promo_sk"], value_set=p["p_promo_sk"]))
    j = j.join(star["item"].select(["i_item_sk", "i_item_id"]),
               keys="ss_item_sk", right_keys="i_item_sk", join_type="inner")
    g = j.group_by(["i_item_id"]).aggregate(
        [(c, "mean") for c, _ in AVG_COLUMNS])
    rows = [{"i_item_id": r["i_item_id"],
             **{a: r[f"{c}_mean"] for c, a in AVG_COLUMNS}}
            for r in g.to_pylist()]
    rows.sort(key=lambda r: (r["i_item_id"] is not None,
                             r["i_item_id"] or ""))
    return rows[:100]


def reference_q27(pa, pc, pq, star, tpcds, states) -> list:
    """q27 by pyarrow: the year's sales to the text's demographic in the
    stores of ``states``, averaged over its three grouping sets; the
    rows by item id and state (NULLs last), the first 100."""
    st = star["store"]
    st = st.filter(pc.is_in(st["s_state"], value_set=pa.array(states)))
    j = demographic_sales(pa, pc, pq, star, tpcds, 2002,
                          ["ss_item_sk", "ss_store_sk"])
    j = j.join(st.select(["s_store_sk", "s_state"]), keys="ss_store_sk",
               right_keys="s_store_sk", join_type="inner")
    j = j.join(star["item"].select(["i_item_sk", "i_item_id"]),
               keys="ss_item_sk", right_keys="i_item_sk", join_type="inner")
    rows = []
    for keys in (["i_item_id", "s_state"], ["i_item_id"], []):
        if keys:
            g = j.group_by(keys).aggregate(
                [(c, "mean") for c, _ in AVG_COLUMNS])
            got = g.to_pylist()
        else:  # a grouping set's groups: none over no rows
            got = [{f"{c}_mean": pc.mean(j[c]).as_py()
                    for c, _ in AVG_COLUMNS}] if j.num_rows else []
        for r in got:
            rows.append({"i_item_id": r.get("i_item_id"),
                         "s_state": r.get("s_state"),
                         **{a: r[f"{c}_mean"] for c, a in AVG_COLUMNS}})
    rows.sort(key=lambda r: [(r[k] is None, r[k] or "")
                             for k in ("i_item_id", "s_state")])
    return rows[:100]


def compare_rows(got_table, want: list, n_keys: int) -> float:
    """Rows place by place: the first ``n_keys`` columns exact, the rest
    within REL_TOL (NULL where the reference has None).  Returns the
    largest relative error."""
    got = got_table.to_pylist()
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        names = list(g)
        if [g[k] for k in names[:n_keys]] != [w[k] for k in names[:n_keys]]:
            raise AssertionError(f"place {i}: {g} vs reference {w}")
        for k in names[n_keys:]:
            if g[k] is None or w[k] is None:
                if g[k] is not w[k]:
                    raise AssertionError(f"place {i} {k}: {g[k]} vs "
                                         f"{w[k]}")
                continue
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-300)
            worst = max(worst, rel)
            if rel > REL_TOL:
                raise AssertionError(f"place {i} {k}: {g[k]} vs {w[k]} "
                                     f"(rel {rel:.3e})")
    return worst


def q27_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
              TTB) -> tuple:
    """TPC-DS q27 over q3ds's tables, the 12 stores and SF1's
    customer_demographics: the text's values (Tennessee, which no store
    of the catalog is in) give 0 rows and launch nothing (the empty
    store side ends the joins above the exchanges); the variant with the
    state most of the stores are in gives the rows of the pyarrow
    reference of its three grouping sets.  Each with the plan
    (customer_demographics too large to broadcast: a shuffled join, its
    filter on the store_sales scan) and K1's launches.  Emits the
    phase's line; returns its records and the variant's hash_columns
    calls."""
    dd_path, ss_paths, item_path = star["paths"]
    states = star["store"]["s_state"].to_pylist()
    state = max(sorted(set(states)), key=states.count)
    # the static plans; the variant's adaptive sibling runs the default
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES, ADAPTIVE: False},
                           device="cuda")
    default = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    records, calls = {}, []
    for name, st in (("text", tpcds.Q27_STATES), ("variant", (state,))):
        def q27_df(st=st):
            return tpcds.q27_dataframe(session, dd_path, ss_paths, item_path,
                                       star["store_path"],
                                       star["cdemo_path"], states=st)

        plan = q27_df().physical_plan()
        expect_plan(f"q27 {name}", plan, star, [BCAST_RIGHT] * 3 + [
            ["TpuShuffledHashJoinExec", "inner", "right"]], ["ss_cdemo_sk"])
        ref = reference_q27(pa, pc, pq, star, tpcds, st)
        if name == "text" and (ref or set(states) & set(st)):
            raise AssertionError(f"q27's text matched {len(ref)} rows")
        if name == "variant" and len(ref) < 100:
            raise AssertionError(f"q27's variant matched {len(ref)} rows")
        rec = run_query(torch, q27_df, kernels,
                        lambda t, ref=ref: compare_rows(t, ref, 2),
                        calls if name == "variant" else [],
                        quick=name == "text", counted=True)
        # the text: no store is in its states, so the store join's build
        # side is empty, never pulls the joins under it, and no exchange
        # or filter runs
        check_launches(f"q27 {name}", rec,
                       rec if name == "variant" else {"per_run": 0})
        records[name] = {"states": list(st),
                         "plan": plan.tree_string().splitlines(), **rec}
        if name == "variant":
            records["variant_adaptive"] = adaptive_sibling(
                torch, kernels, "q27 variant (adaptive)",
                lambda: tpcds.q27_dataframe(
                    default, dd_path, ss_paths, item_path,
                    star["store_path"], star["cdemo_path"], states=st),
                lambda t, ref=ref: compare_rows(t, ref, 2),
                [BCAST_RIGHT] * 3 + [["TpuAdaptiveJoinExec", "inner",
                                      "right"]], calls, must_prune=True)
    emit("q27", cdemo_rows=pq.read_metadata(star["cdemo_path"]).num_rows,
         store_states=states,
         dimensions_datagen_s=star["dimensions_datagen_s"],
         hash_columns_calls=sorted({(n, signature(cols), seed, parts)
                                    for cols, n, seed, parts in calls}),
         **records)
    return records, calls


def agg_family_dataframes(session, ss_paths) -> dict:
    """store_sales in (ticket, item) order, grouped by store with min,
    max, first and last (both NULL modes); and the distinct customers of
    each store."""
    from spark_rapids_tpu_torch.session import (
        col,
        count_distinct,
        first,
        last,
        max_,
        min_,
    )

    ss = session.read_parquet(*ss_paths)
    ordered = ss.order_by(col("ss_ticket_number"), col("ss_item_sk"))
    return {
        "values": ordered.group_by(col("ss_store_sk")).agg(
            (min_(col("ss_sales_price")), "min_price"),
            (max_(col("ss_sales_price")), "max_price"),
            (min_(col("ss_sold_date_sk")), "min_date"),
            (max_(col("ss_net_profit")), "max_profit"),
            (first(col("ss_customer_sk")), "first_customer"),
            (last(col("ss_customer_sk"), True), "last_customer"),
            (first(col("ss_sold_date_sk"), True), "first_date"),
            (last(col("ss_sold_date_sk")), "last_date")),
        "distinct": ss.group_by(col("ss_store_sk")).agg(
            (count_distinct(col("ss_customer_sk")), "customers")),
    }


def reference_agg_family(pa, pc, pq, star) -> dict:
    """The agg_family queries by pyarrow and numpy: the rows in (ticket,
    item) order (a stable sort of the files' rows in file order), each
    store's extremes, and its first and last rows' values by position
    (all rows, or the non-NULL ones)."""
    import numpy as np

    t = read_sales(pa, pq, star, [
        "ss_store_sk", "ss_ticket_number", "ss_item_sk", "ss_sales_price",
        "ss_sold_date_sk", "ss_net_profit", "ss_customer_sk"])
    distinct = {(r["ss_store_sk"],): {"customers": r[
        "ss_customer_sk_count_distinct"]} for r in t.group_by(
        ["ss_store_sk"]).aggregate([("ss_customer_sk",
                                     "count_distinct")]).to_pylist()}
    t = t.take(pc.sort_indices(t, sort_keys=[
        ("ss_ticket_number", "ascending"), ("ss_item_sk", "ascending")]))
    store = t["ss_store_sk"].to_numpy()

    def pick(column: str, last: bool, skip_nulls: bool) -> dict:
        arr = t[column]
        valid = arr.is_valid().to_numpy(zero_copy_only=False)
        vals = arr.to_pylist()
        rows = np.nonzero(valid)[0] if skip_nulls else np.arange(len(vals))
        if last:
            rows = rows[::-1]
        _, at = np.unique(store[rows], return_index=True)
        return {int(store[rows[i]]): vals[rows[i]] for i in at}

    g = t.group_by(["ss_store_sk"]).aggregate([
        ("ss_sales_price", "min"), ("ss_sales_price", "max"),
        ("ss_sold_date_sk", "min"), ("ss_net_profit", "max")])
    picks = {"first_customer": pick("ss_customer_sk", False, False),
             "last_customer": pick("ss_customer_sk", True, True),
             "first_date": pick("ss_sold_date_sk", False, True),
             "last_date": pick("ss_sold_date_sk", True, False)}
    values = {}
    for r in g.to_pylist():
        s = r["ss_store_sk"]
        values[(s,)] = {"min_price": r["ss_sales_price_min"],
                        "max_price": r["ss_sales_price_max"],
                        "min_date": r["ss_sold_date_sk_min"],
                        "max_profit": r["ss_net_profit_max"],
                        **{k: v[s] for k, v in picks.items()}}
    return {"values": values, "distinct": distinct}


def agg_family_phase(torch, pa, pc, pq, star, kernels, TorchSession,
                     TTB) -> tuple:
    """min / max / first / last over store_sales after an ORDER BY (a
    range exchange and a sort of each partition under the group-by, so
    first and last follow the sort), and COUNT(DISTINCT) of the
    customers, each store's rows against pyarrow (the first / last
    exact, as the extremes), and K1's launches.  Emits the phase's
    line; returns its records and hash_columns calls."""
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    ref = reference_agg_family(pa, pc, pq, star)
    records, calls = {}, []
    for name in ("values", "distinct"):
        def family_df(name=name):
            return agg_family_dataframes(session, star["paths"][1])[name]

        rec = run_query(torch, family_df, kernels,
                        lambda t, name=name: compare(t, ref[name], 1),
                        calls, counted=True)
        check_launches(f"agg_family {name}", rec, rec)
        records[name] = {"plan": family_df().physical_plan().tree_string()
                         .splitlines(), "groups": len(ref[name]), **rec}
    emit("agg_family", hash_columns_calls=sorted(
        {(n, signature(cols), seed, parts)
         for cols, n, seed, parts in calls}), **records)
    return records, calls


#: store_sales files the sql phase's CPU runs read (its card runs read
#: all Q3DS_FILES): the texts without a hand-built twin are held against
#: the port's device="cpu" run of the same text over these files; and
#: each text's timed runs after its warm-up (2 files and 3 runs until a
#: run of the script took 844 s on an H100 80GB HBM3 at 700 W)
#: (2 timed runs until the channels phase pushed the run past 750 s on
#: an H100 80GB HBM3 at 700 W; 1 until the types phase came, to keep the
#: run within the 717 s it took before on an H100 80GB HBM3 at 700 W: 0
#: makes the profiled run the warm-up and times the one counted run
#: after it)
SQL_CPU_FILES, SQL_TIMED_RUNS = 1, 0
#: a text's one profiled run is its counted run, timed (run_query's
#: ``single``): a warm-up run before it until the python phase needed
#: the run's time (the sql texts took 107.9 s and the channel texts
#: 260.2 s of a run that reached main at 784.2 s on an H100 80GB HBM3
#: at 700 W); its wall is now the text's first run in the process
SQL_SINGLE_RUN = True


def sql_twin_checks(pa, pc, pq, star, tpcds) -> dict:
    """Text -> a check of its card result against the pyarrow reference
    of its hand-built twin's DataFrame (the twin computes what the text
    does): q3 (q3ds), q42, q52, q55, q93, q67 (q67_rollup), q5 and q27's
    variant (the state most stores are in, as the q27 phase's)."""
    def star_check(name, sum_col, names=None):
        _fn, (year, manager), keys, star_names, _, order = \
            STAR_QUERIES[name]
        names = star_names if names is None else names
        ref = reference_star(
            pc, star, lambda d: pc.and_(pc.equal(d["d_moy"], 11),
                                        pc.equal(d["d_year"], year)),
            lambda i: pc.equal(i["i_manager_id"], manager), keys, names,
            order)
        out_keys = tuple(names.get(k, k) for k in keys)
        return lambda t: compare_ranked(t, ref, 100, out_keys, sum_col,
                                        "sum")

    names3 = {"i_brand_id": "brand_id", "i_brand": "brand"}
    ref3 = reference_star(
        pc, star, lambda d: pc.equal(d["d_moy"], 11),
        lambda i: pc.equal(i["i_manufact_id"], 128),
        ["d_year", "i_brand_id", "i_brand"], names3,
        [("d_year", False), ("sum", True), ("brand_id", False)])
    sales = read_sales(pa, pq, star, [
        "ss_item_sk", "ss_ticket_number", "ss_customer_sk", "ss_quantity",
        "ss_sales_price"])
    returns = pq.read_table(star["q93_paths"][0], columns=[
        "sr_item_sk", "sr_ticket_number", "sr_reason_sk",
        "sr_return_quantity"])
    ref93, _, _ = reference_q93(pa, pc, sales, returns,
                                pq.read_table(star["q93_paths"][1]),
                                tpcds.Q93_REASON)
    del sales, returns
    ref67 = reference_q67_rollup(pa, pc, pq, star, tpcds)
    ref5, _ = reference_q5(pa, pc, pq, star, tpcds)
    states = star["store"]["s_state"].to_pylist()
    state = max(sorted(set(states)), key=states.count)
    ref27 = reference_q27(pa, pc, pq, star, tpcds, (state,))

    def check5(t):
        ids = t["s_store_id"].to_pylist()
        if ids != sorted(ids):
            raise AssertionError("q5 rows are not in store id order")
        return compare(t, ref5, 1)

    return {
        "q3": lambda t: compare_ranked(t, ref3, 100,
                                       ("d_year", "brand_id", "brand"),
                                       "sum_agg", "sum"),
        "q42": star_check("q42", "sum"),
        "q52": star_check("q52", "ext_price"),
        "q55": star_check("q55", "ext_price"),
        "q93": lambda t: compare_ranked(t, ref93, 100, ("ss_customer_sk",),
                                        "sumsales", "act_sum"),
        "q67": lambda t: compare_q67_rollup(t, ref67),
        "q5": check5,
        "q27_variant": (state, lambda t: compare_rows(t, ref27, 2)),
    }


def same_result(got, want) -> float:
    """The card's result against the CPU's, as multisets of rows: names
    equal, integers, strings and NULLs exact, floats within REL_TOL.
    Rows pair up after sorting on their non-float values, then their
    floats rounded to 9 significant digits.  Returns the largest
    relative float difference."""
    if got.schema.names != want.schema.names:
        raise AssertionError(f"columns {got.schema.names} vs "
                             f"{want.schema.names}")
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{got.num_rows} rows, the CPU run has "
                             f"{want.num_rows}")

    def key(row):
        return ([(v is None, 0 if isinstance(v, float) or v is None else v)
                 for v in row],
                [(v is None, float(f"{v:.9g}") if isinstance(v, float)
                  else 0) for v in row])

    def rows(t):  # by position: a text may name two columns alike (q13)
        return list(zip(*(c.to_pylist() for c in t.columns)))

    g, w = sorted(rows(got), key=key), sorted(rows(want), key=key)
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                rel = abs(x - y) / max(abs(y), 1e-300) if x != y else 0.0
                worst = max(worst, rel)
                if rel > REL_TOL:
                    raise AssertionError(f"row {i}: {a} vs CPU {b}")
            elif x != y or type(x) is not type(y):
                raise AssertionError(f"row {i}: {a} vs CPU {b}")
    return worst


def sql_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
              TTB) -> tuple:
    """The 22 store-channel TPC-DS texts as written, through the SQL
    frontend on the card, over the 13 tables (``write_store_channel``:
    q3ds's six store_sales files, q93's store_returns, the whole
    calendar and SF1's dimensions): for each text its plan's joins, the
    rows, one profiled run (device busy, idle share, kernel count) that
    is also the counted run, timed (SQL_SINGLE_RUN), and K1's
    launches (equal to runs x its plan's map batches, folds and range
    tables, and what planning launches).  A text with
    a hand-built twin is held against the twin's pyarrow reference; the
    others against the port's device="cpu" run of the same text over
    SQL_CPU_FILES store_sales files, with the card's run over the same
    files.  A text that gives 0 rows runs its variant too.  Emits the
    phase's line; returns its records and hash_columns calls."""
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.tpcds_queries import (
        QUERIES,
        STORE_CHANNEL,
        variant,
    )

    dd_path, ss_paths, item_path = star["paths"]
    t0 = time.perf_counter()
    tables = tpcds.write_store_channel(star["dir"], written={
        "date_dim": [dd_path], "store_sales": ss_paths,
        "item": [item_path], "store": [star["store_path"]],
        "customer_demographics": [star["cdemo_path"]],
        "store_returns": [star["q93_paths"][0]],
        "reason": [star["q93_paths"][1]]})
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    twins = sql_twin_checks(pa, pc, pq, star, tpcds)
    ref_s = time.perf_counter() - t0
    conf = {TTB: Q3DS_TASK_TARGET_BYTES}

    def frontend(device, n_sales):
        fe = SqlSession(conf, device=device)
        for name, paths in tables.items():
            fe.register_parquet(name, *(
                paths[:n_sales] if name == "store_sales" else paths))
        return fe

    card, card_cut = frontend("cuda", Q3DS_FILES), \
        frontend("cuda", SQL_CPU_FILES)
    cpu = frontend("cpu", SQL_CPU_FILES)
    texts = [(f"q{q}", QUERIES[q]) for q in STORE_CHANNEL]
    records, largest = {}, {}
    cpu_s = 0.0
    i = 0
    while i < len(texts):
        name, text = texts[i]
        i += 1

        def text_df(text=text):
            return card.sql(text)

        plan = text_df().physical_plan()
        twin = twins.get(name)
        if isinstance(twin, tuple):  # q27's variant: the phase's state
            state, twin = twin
            text = text.replace("'LA'", f"'{state}'")
        if twin is not None:
            check, versus = twin, "twin's pyarrow reference"
        else:
            t0 = time.perf_counter()
            want = cpu.sql(text).collect()
            cpu_s += time.perf_counter() - t0
            got = card_cut.sql(text).collect()
            cut = {"cut_rows": got.num_rows,
                   "cut_max_rel_err": same_result(got, want)}
            check, versus = (lambda t: 0.0), \
                f"device='cpu' over {SQL_CPU_FILES} files"
        if name == "q43":  # the nested phase's pivot is held to its rows
            def check(t, base=check):
                star["q43_text_rows"] = t
                return base(t)
        calls: list = []
        ran: dict = {}
        rec = run_query(torch, text_df, kernels, check, calls, scans=False,
                        timed=SQL_TIMED_RUNS, counted=True,
                        single=SQL_SINGLE_RUN, kept=ran)
        check_launches(name, rec, rec)
        records[name] = {"checked_against": versus,
                         **({} if twin is not None else cut),
                         "joins": join_strategies(plan),
                         "adaptive": adaptive_decisions(ran.get("plan")),
                         "hash_columns_calls": sorted(
                             {(n, signature(cols), seed, parts)
                              for cols, n, seed, parts in calls}), **rec}
        emit("sql_text", name=name, **{k: v for k, v in records[name].items()
                                        if k != "device_kernels"})
        # keep the largest call of each signature only: the card memory
        # the recorded inputs hold stays small
        for call in calls:
            key = (signature(call[0]), call[2], call[3])
            if key not in largest or call[1] > largest[key][1]:
                largest[key] = call
        if rec["rows"] == 0 and not name.endswith("_variant"):
            q = int(name[1:])
            texts.insert(i, (f"{name}_variant", variant(q)))
    emit("sql", tables={k: [os.path.basename(p) for p in v]
                        for k, v in tables.items()},
         table_rows={k: sum(pq.read_metadata(p).num_rows for p in v)
                     for k, v in tables.items()},
         datagen_s=gen_s, reference_s=ref_s, cpu_files=SQL_CPU_FILES,
         cpu_s=cpu_s, summary={
             name: {k: r[k] for k in (
                 "rows", "median_s", "device_busy_s", "device_idle_share",
                 "device_kernel_count", "launches", "checked_against")}
             for name, r in records.items()})
    return records, list(largest.values()), tables


#: the decimal sums of the spec-typed texts: DECIMAL(7,2) summed
TYPES_SUM_TYPE = "decimal128(17, 2)"
#: the text -> (its sum column, and the reference_star arguments: the
#: date_dim year (None: every year), the item filter, keys, output
#: names, order), as sql_twin_checks holds the DOUBLE texts
TYPES_STAR = {
    "q3": ("sum_agg", None, ("i_manufact_id", 128),
           ["d_year", "i_brand_id", "i_brand"],
           {"i_brand_id": "brand_id", "i_brand": "brand"},
           [("d_year", False), ("sum", True), ("brand_id", False)]),
    "q42": ("sum", 2000, ("i_manager_id", 1), *STAR_QUERIES["q42"][2:4],
            STAR_QUERIES["q42"][5]),
    "q52": ("ext_price", 2000, ("i_manager_id", 1),
            *STAR_QUERIES["q52"][2:4], STAR_QUERIES["q52"][5]),
    "q55": ("ext_price", 1999, ("i_manager_id", 28),
            *STAR_QUERIES["q55"][2:4], STAR_QUERIES["q55"][5]),
}
#: the texts whose Aggregate averages DECIMAL(7,2) money: on the CPU
#: engine, as the JAX planner puts it
TYPES_AVG_TEXTS = ("q7", "q27")
AVG_REASON = "aggregate average does not support input type decimal(7,2)"


def exact_ranked(got_table, want: list, n: int, keys: tuple, got_sum: str,
                 want_sum: str) -> None:
    """Rows of a ranking against the reference's first n, place by
    place: keys and sums equal exactly (Decimals), a row free to trade
    places with one of the same sum."""
    got = got_table.to_pylist()
    sums = {tuple(r[k] for k in keys): r[want_sum] for r in want}
    want = want[:n]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, reference has {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        key = tuple(g[k] for k in keys)
        if sums.get(key) != g[got_sum]:
            raise AssertionError(f"place {i} {key}: {g[got_sum]} vs "
                                 f"{sums.get(key)}")
        if key != tuple(w[k] for k in keys) and g[got_sum] != w[want_sum]:
            raise AssertionError(f"place {i}: {g} vs reference {w}")


def cents_agree(dec_table, dbl_table, keys: tuple, col: str) -> int:
    """The decimal text's sums are 100 x its DOUBLE twin's, rounded to
    cents, group by group; a group in one LIMIT and not the other only
    where it ties the last place.  Returns the groups compared."""
    def by_key(t):
        return {tuple(r[k] for k in keys): r[col] for r in t.to_pylist()}

    dec, dbl = by_key(dec_table), by_key(dbl_table)
    if len(dec) != len(dbl):
        raise AssertionError(f"{len(dec)} groups against {len(dbl)}")
    last = min(dec.values(), default=None)
    for key, v in dec.items():
        if key not in dbl:
            if v != last:
                raise AssertionError(f"group {key} is not in the DOUBLE "
                                     "text's result")
            continue
        if int(v.scaleb(2)) != round(dbl[key] * 100):
            raise AssertionError(f"{key}: {v} against {dbl[key]}")
    return len(dec)


def exact_multiset(got, want) -> None:
    """Two tables equal as multisets of rows: names, and every value
    exactly (decimals, timestamps as their microseconds, floats by
    their bits, NULLs), both sorted by every column in Arrow: no Python
    object a value (a timestamp with a zone costs milliseconds apiece
    to make on some hosts)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    if got.schema.names != want.schema.names:
        raise AssertionError(f"columns {got.schema.names} vs "
                             f"{want.schema.names}")

    def canon(t):
        cols = []
        for c in t.columns:
            c = c.combine_chunks()
            if pa.types.is_timestamp(c.type):
                c = c.cast(pa.int64())
            elif pa.types.is_floating(c.type):
                bits = pc.fill_null(c, 0).to_numpy(zero_copy_only=False)
                c = pa.array(bits.view(f"int{8 * bits.itemsize}"),
                             mask=np.asarray(c.is_null()))
            cols.append(c)
        names = [f"c{i}" for i in range(len(cols))]
        tt = pa.table(cols, names=names)
        return tt.take(pc.sort_indices(
            tt, sort_keys=[(n, "ascending") for n in names]))

    g, w = canon(got), canon(want)
    if g.num_rows != w.num_rows:
        raise AssertionError(f"{g.num_rows} rows against {w.num_rows}")
    for i, (a, b) in enumerate(zip(g.columns, w.columns)):
        if not a.equals(b):
            raise AssertionError(f"column {got.schema.names[i]} differs")


#: the other four types' queries: TIMESTAMP, FLOAT, TINYINT and SMALLINT
#: columns beside a DECIMAL one; between them K1 hashes a key of each
TYPES_HOUR_TEXT = (
    "select extract(hour from ss_sold_at) as hr, ss_store_sk, ss_quantity, "
    "sum(ss_ext_sales_price) as sales, max(ss_sales_price) as top_price, "
    "min(ss_sold_at) as first_sale from ss_types "
    "group by extract(hour from ss_sold_at), ss_store_sk, ss_quantity")
#: query 2 keeps the rows of few items, so that its groups (one a sale
#: of a price on a day) stay few and its month strings, formatted on the
#: CPU engine, cheap
TYPES_DAY_MAX_QUANTITY = 5


def types_day_df(session, paths):
    """Query 2 of the types phase, through the DataFrame API: sales of
    fewer than TYPES_DAY_MAX_QUANTITY items grouped by (the day of
    ``ss_sold_at`` as a TIMESTAMP at midnight, the FLOAT price, the
    DECIMAL amount), with their count and summed TINYINT quantity, and
    the day's ``date_format(day, 'yyyy-MM')``: a format the device
    refuses (as the JAX package's), so that Project runs on the CPU
    engine."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.cast import Cast
    from spark_rapids_tpu_torch.session import (
        col,
        count_star,
        date_format,
        lit,
        sum_,
    )

    day = Cast(Cast(col("ss_sold_at"), T.DATE), T.TIMESTAMP).alias("day")
    return (session.read_parquet(*paths)
            .where(col("ss_quantity") < lit(TYPES_DAY_MAX_QUANTITY))
            .group_by(day, col("ss_sales_price"), col("ss_ext_sales_price"))
            .agg((count_star(), "n"), (sum_(col("ss_quantity")), "qty"))
            .select(col("day"), date_format(col("day"), "yyyy-MM")
                    .alias("month"), col("ss_sales_price"),
                    col("ss_ext_sales_price"), col("n"), col("qty")))


def reference_types(pa, pc, pq, paths) -> tuple:
    """The types phase's two queries by pyarrow and numpy over the same
    files, timestamps as int64 microseconds (no time-zone arithmetic)."""
    import numpy as np

    t = pa.concat_tables([pq.read_table(p) for p in paths])
    us = t["ss_sold_at"].cast(pa.int64()).combine_chunks()
    ok = np.asarray(us.is_valid())
    v = np.asarray(pc.fill_null(us, 0))
    day_us = 86_400_000_000
    hr = pa.array(((v // 3_600_000_000) % 24).astype(np.int32), mask=~ok)
    g = pa.table({"hr": hr, "ss_store_sk": t["ss_store_sk"],
                  "ss_quantity": t["ss_quantity"],
                  "s": t["ss_ext_sales_price"],
                  "p": t["ss_sales_price"], "a": us}
                 ).group_by(["hr", "ss_store_sk", "ss_quantity"]).aggregate(
        [("s", "sum"), ("p", "max"), ("a", "min")])
    utc = pa.timestamp("us", tz="UTC")
    hour = pa.table({
        "hr": g["hr"], "ss_store_sk": g["ss_store_sk"],
        "ss_quantity": g["ss_quantity"],
        "sales": g["s_sum"].cast(pa.decimal128(17, 2)),
        "top_price": g["p_max"], "first_sale": g["a_min"].cast(utc)})
    few = np.asarray(pc.fill_null(pc.less(
        t["ss_quantity"].cast(pa.int64()), TYPES_DAY_MAX_QUANTITY), False))
    day = pa.array((v[few] // day_us) * day_us, mask=~ok[few])
    sub = t.filter(pa.array(few))
    d = pa.table({"day": day, "ss_sales_price": sub["ss_sales_price"],
                  "ss_ext_sales_price": sub["ss_ext_sales_price"],
                  "q": sub["ss_quantity"].cast(pa.int64())}).group_by(
        ["day", "ss_sales_price", "ss_ext_sales_price"]).aggregate(
        [([], "count_all"), ("q", "sum")])
    dv = d["day"].combine_chunks()
    months = np.datetime_as_string(np.asarray(pc.fill_null(dv, 0)).astype(
        "datetime64[us]").astype("datetime64[M]"))
    days = pa.table({"day": dv.cast(utc),
                     "month": pa.array(months.astype(object),
                                       mask=np.asarray(dv.is_null())),
                     "ss_sales_price": d["ss_sales_price"],
                     "ss_ext_sales_price": d["ss_ext_sales_price"],
                     "n": d["count_all"], "qty": d["q_sum"]})
    return hour, days


def types_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB,
                store_tables: dict) -> tuple:
    """The scalar types on the card, at full width.  (a) store_sales as
    the spec types it (``tpcds.write_decimal_store_sales``: the q3ds
    files with the twelve money columns DECIMAL(7,2), INT32 in Parquet)
    beside the store channel's other tables, through the SQL frontend:
    q3, q42, q52 and q55 plan no CPU node, sum DECIMAL(17,2) exactly as
    pyarrow's decimal group_by of the same files and as 100 x the
    DOUBLE text's sums rounded to cents; q7 and q27 (each with its
    variant when it gives no rows, in the state most stores are in, as
    the sql phase's) plan exactly their Aggregate on the CPU engine,
    which ``explain()`` marks with AVG_REASON, their rows against
    pyarrow's averages of the decimals as DOUBLE over the six files
    (``reference_q7``, ``reference_q27``; within REL_TOL), and, over the
    first file, against the port's device="cpu" run, with their
    transitions' rows and batches against what the CPU engine feeds and
    makes there.  Each text: one run, profiled, counted and timed at
    once, as the sql phase's (no warm-up since PR 18), K1's launches
    equal to runs x its plan's map batches, folds and range tables.
    (b) the
    same rows with a TIMESTAMP, a TINYINT, a SMALLINT and a FLOAT
    column (``tpcds.write_scalar_types_sales``): TYPES_HOUR_TEXT and
    ``types_day_df``, each exactly equal to pyarrow's, K1 as planned
    and, between them, hashing a key of each of the five new types.
    Emits ``types_text`` lines and the ``types`` line; returns the
    records and the largest hash_columns call of each signature."""
    from spark_rapids_tpu_torch.cpu.engine import execute_cpu
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.tpcds_queries import QUERIES, variant

    _dd, ss_paths, _item = star["paths"]
    types_dir = os.path.join(star["dir"], "types")
    os.makedirs(types_dir)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:  # a file a task: pyarrow and
        # numpy let go of the GIL
        dec = [pool.submit(tpcds.write_decimal_store_sales, types_dir, [p])
               for p in ss_paths]
        typed = [pool.submit(tpcds.write_scalar_types_sales, types_dir,
                             [p]) for p in ss_paths]
        dec_paths = [f.result()[0] for f in dec]
        typed_paths = [f.result()[0] for f in typed]
    gen_s = time.perf_counter() - t0
    conf = {TTB: Q3DS_TASK_TARGET_BYTES}

    def frontend(device, sales):
        fe = SqlSession(conf, device=device)
        for name, paths in store_tables.items():
            fe.register_parquet(name, *(
                sales if name == "store_sales" else paths))
        return fe

    card, card_double = frontend("cuda", dec_paths), \
        frontend("cuda", store_tables["store_sales"])
    card_cut, cpu_cut = frontend("cuda", dec_paths[:1]), \
        frontend("cpu", dec_paths[:1])
    t0 = time.perf_counter()
    dec_star = {"date_dim": star["date_dim"], "item": star["item"],
                "sales": pa.concat_tables([pq.read_table(p, columns=[
                    "ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
                    for p in dec_paths])}
    refs = {}
    for name, (_c, year, (icol, ival), keys, names, order) in \
            TYPES_STAR.items():
        refs[name] = reference_star(
            pc, dec_star, lambda d, y=year: pc.equal(d["d_moy"], 11)
            if y is None else pc.and_(pc.equal(d["d_moy"], 11),
                                      pc.equal(d["d_year"], y)),
            lambda i, c=icol, v=ival: pc.equal(i[c], v), keys, names, order)
    states = star["store"]["s_state"].to_pylist()
    state = max(sorted(set(states)), key=states.count)
    by_files = dict(star, paths=(star["paths"][0], dec_paths,
                                 star["paths"][2]))
    avg_refs = {
        "q7": (1, reference_q7(pa, pc, pq, by_files, tpcds, pq.read_table(
            store_tables["promotion"][0]))),
        "q27": (2, reference_q27(pa, pc, pq, by_files, tpcds,
                                 tpcds.Q27_STATES)),
        "q27_variant": (2, reference_q27(pa, pc, pq, by_files, tpcds,
                                         (state,)))}
    ref_s = time.perf_counter() - t0
    records, largest = {}, {}

    def keep_largest(calls):
        # the card memory the recorded inputs hold stays small
        for call in calls:
            key = (signature(call[0]), call[2], call[3])
            if key not in largest or call[1] > largest[key][1]:
                largest[key] = call

    texts = [(f"q{q}", QUERIES[q]) for q in (3, 42, 52, 55, 7, 27)]
    i = 0
    while i < len(texts):
        name, text = texts[i]
        i += 1
        base = name.split("_")[0]
        if name == "q27_variant":  # the state of avg_refs's variant
            text = text.replace("'LA'", f"'{state}'")

        def text_df(text=text):
            return card.sql(text)

        plan = text_df().physical_plan()
        cpu_nodes = [n.node_desc() for n in fallback_nodes(plan)]
        extra: dict = {}
        if base in TYPES_STAR:
            if cpu_nodes:
                raise AssertionError(f"{name} plans {cpu_nodes}")
            col, _y, _i, keys, names, _o = TYPES_STAR[base]
            out_keys = tuple(names.get(k, k) for k in keys)

            def check(t, col=col, ref=refs[base], out_keys=out_keys):
                if str(t.schema.field(col).type) != TYPES_SUM_TYPE:
                    raise AssertionError(f"{name}'s {col} is "
                                         f"{t.schema.field(col).type}")
                exact_ranked(t, ref, 100, out_keys, col, "sum")
                extra["cents_groups"] = cents_agree(
                    t, card_double.sql(text).collect(), out_keys, col)
                return 0.0
            versus = "pyarrow's decimal group_by, and the DOUBLE text"
        else:
            marked = [ln for ln in text_df().explain().splitlines()
                      if ln.lstrip().startswith("!")]
            if len(cpu_nodes) != 1 or not cpu_nodes[0].startswith(
                    "CpuFallbackExec [Aggregate") or len(marked) != 1 \
                    or "Aggregate" not in marked[0] \
                    or AVG_REASON not in marked[0]:
                raise AssertionError(f"{name} plans {cpu_nodes}, explain "
                                     f"marks {marked}")
            t0 = time.perf_counter()
            cut_df = cpu_cut.sql(text)
            want = execute_cpu(cut_df._plan)
            nodes, stack = [], [cut_df._plan]
            while stack:
                nodes.append(stack.pop())
                stack += nodes[-1].children
            (agg,) = [n for n in nodes if isinstance(n, L.Aggregate)]
            fed = execute_cpu(agg.children[0]).num_rows
            made = execute_cpu(agg).num_rows
            cpu_s = time.perf_counter() - t0
            cut_plan = card_cut.sql(text).physical_plan()
            got = collect_exec(cut_plan, card_cut.session.conf)
            (fb,) = fallback_nodes(cut_plan)
            moved = dict(fb.metrics)
            if (moved["toHostRows"], moved["toDeviceRows"]) != (fed, made):
                raise AssertionError(f"{name} moved {moved}, the CPU "
                                     f"engine fed {fed} rows and made "
                                     f"{made}")
            extra.update(cut_rows=got.num_rows, cpu_s=cpu_s,
                         cut_max_rel_err=same_result(got, want),
                         transitions=moved, marked=marked[0].strip())
            n_keys, ref = avg_refs[name]

            def check(t, ref=ref, n_keys=n_keys):
                return compare_rows(t, ref, n_keys)
            versus = ("pyarrow's averages as DOUBLE over the six decimal "
                      "files; device='cpu' over the first")
        calls: list = []
        rec = run_query(torch, text_df, kernels, check, calls, scans=False,
                        timed=0, fallback=len(cpu_nodes),
                        counted=True, single=True)
        check_launches(name, rec, rec)
        records[name] = {"checked_against": versus, "cpu_nodes": cpu_nodes,
                         "joins": join_strategies(plan), **extra,
                         "hash_columns_calls": sorted(
                             {(n, signature(cols), seed, parts)
                              for cols, n, seed, parts in calls}), **rec}
        emit("types_text", name=name, **{
            k: v for k, v in records[name].items() if k != "device_kernels"})
        keep_largest(calls)
        if rec["rows"] == 0 and not name.endswith("_variant"):
            texts.insert(i, (f"{name}_variant", variant(int(name[1:]))))

    # (b) the other four types
    t0 = time.perf_counter()
    want_hour, want_day = reference_types(pa, pc, pq, typed_paths)
    ref_s += time.perf_counter() - t0
    fe = SqlSession(conf, device="cuda")
    fe.register_parquet("ss_types", *typed_paths)
    session = TorchSession(conf, device="cuda")
    hashed = set()
    for name, make_df, want, n_cpu in (
            ("hour", lambda: fe.sql(TYPES_HOUR_TEXT), want_hour, 0),
            ("day", lambda: types_day_df(session, typed_paths), want_day,
             1)):
        calls = []
        rec = run_query(torch, make_df, kernels,
                        lambda t, w=want: exact_multiset(t, w) or 0.0, calls,
                        scans=False, timed=0, fallback=n_cpu,
                        counted=True)
        check_launches(name, rec, rec)
        sigs = sorted({(n, signature(cols), seed, parts)
                       for cols, n, seed, parts in calls})
        hashed |= {c for _n, sig, _s, _p in sigs for c in sig}
        records[name] = {"checked_against": "pyarrow, exactly",
                         "hash_columns_calls": sigs, **rec}
        emit("types_text", name=name, **{
            k: v for k, v in records[name].items() if k != "device_kernels"})
        keep_largest(calls)
    missing = [t for t in ("tinyint", "smallint", "float", "timestamp",
                           "decimal(7,2)") if t not in hashed]
    if missing:
        raise AssertionError(f"K1 hashed no key of {missing}: {hashed}")
    emit("types", datagen_s=gen_s, reference_s=ref_s,
         decimal_files=[os.path.basename(p) for p in dec_paths],
         typed_files=[os.path.basename(p) for p in typed_paths],
         hashed_types=sorted(hashed), summary={
             name: {k: r.get(k) for k in (
                 "rows", "median_s", "device_busy_s", "device_idle_share",
                 "device_kernel_count", "launches", "planned_map_batches",
                 "checked_against", "cpu_nodes")}
             for name, r in records.items()})
    return records, list(largest.values())


#: q43's day columns: the pivot's values, the text's names
Q43_DAYS = {"Sunday": "sun_sales", "Monday": "mon_sales",
            "Tuesday": "tue_sales", "Wednesday": "wed_sales",
            "Thursday": "thu_sales", "Friday": "fri_sales",
            "Saturday": "sat_sales"}
#: the key a NULL customer groups under in the references (customer
#: keys start at 1)
NULL_KEY = -1


def keyed_lists(np, pc, keys, lists, sort_within: bool) -> tuple:
    """(keys, NULL as NULL_KEY, ascending; each row's array length; the
    arrays' elements in that row order, each array's own sorted when
    ``sort_within``) of one array column beside its keys."""
    import pyarrow as pa

    k = np.asarray(pc.fill_null(keys, NULL_KEY))
    order = np.argsort(k, kind="stable")
    lists = lists.take(pa.array(order))
    if isinstance(lists, pa.ChunkedArray):
        lists = lists.combine_chunks()
    lens = np.asarray(pc.fill_null(pc.list_value_length(lists), 0))
    vals = np.asarray(pc.list_flatten(lists))
    if sort_within:
        parent = np.asarray(pc.list_parent_indices(lists))
        vals = vals[np.lexsort((vals, parent))]
    return k[order], lens, vals


def ascending_within(np, pc, lists) -> bool:
    """Whether every array of a column ascends."""
    import pyarrow as pa

    if isinstance(lists, pa.ChunkedArray):
        lists = lists.combine_chunks()
    vals = np.asarray(pc.list_flatten(lists))
    parent = np.asarray(pc.list_parent_indices(lists))
    return bool(np.all((np.diff(vals) >= 0) | (np.diff(parent) != 0)))


def same_lists(np, pc, got, want, key: str, cols: dict) -> dict:
    """A table of arrays by key against the reference's (``cols``: got
    column -> (reference column, sort the reference's arrays)): the same
    keys, and per key the same elements in the same order.  Returns the
    groups and elements compared."""
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{got.num_rows} groups, the reference has "
                             f"{want.num_rows}")
    out = {"groups": got.num_rows}
    for gc, (wc, sort_want) in cols.items():
        gk, gl, gv = keyed_lists(np, pc, got.column(key), got.column(gc),
                                 False)
        wk, wl, wv = keyed_lists(np, pc, want.column(key), want.column(wc),
                                 sort_want)
        if not (np.array_equal(gk, wk) and np.array_equal(gl, wl)
                and np.array_equal(gv, wv)):
            raise AssertionError(f"{gc}'s arrays differ from the reference")
        out[f"{gc}_elements"] = int(len(gv))
    return out


def nested_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB,
                 store_tables: dict, q43_text_rows) -> tuple:
    """Nested types on the card, over q3ds's six store_sales files (6 x
    2^20 rows), the sql phase's SF1 dimensions and its 100 000
    customers.  Five queries, each: one profiled run that is the
    warm-up, one counted run, timed, K1's launches equal to runs x the
    map batches its hash exchanges are fed (and the runtime filter's
    folds and range tables), no CPU node in its plan.
    (1) ``baskets``: store_sales grouped by ss_customer_sk with
    collect_list(ss_item_sk) and collect_set(ss_store_sk): a hash
    exchange on the customer (K1 on a LONG), then the partitioned
    collect; every array ascends, and equals pyarrow's ``list`` and
    ``distinct`` aggregations sorted, customer by customer (the NULL
    customer's group too).  (2) ``explode_back``: posexplode of the
    baskets' items, grouped by item (an exchange hashing the exploded
    column): the counts equal pyarrow's value_counts; and, over the
    baskets once, array_size, get_item(items, 0), element_at(items, -1)
    and array_contains(stores, 1) equal pyarrow's count, min, max and
    membership per customer.  (3) ``baskets_joined``: the baskets joined
    to customer on c_customer_sk with the broadcast threshold off: a
    partition-wise shuffled join whose stream side, the one with the
    two arrays, is hash-exchanged; its rows equal the baskets' keyed by
    customer.  (4) ``q43_pivot``: the q43 join (d_year = 2000,
    s_gmt_offset = -5) as group_by(s_store_name, s_store_id).pivot(
    d_day_name, the seven days).agg(sum(ss_sales_price)): K1 hashes the
    (STRING, STRING) key; the rows equal the sql phase's q43 text rows
    (keys exact, sums within REL_TOL).  (5) ``nested_scan``: the six
    files written again (8 at a time) with ``ss_pricing`` (a struct of
    three prices, 5 % NULL) and ``ss_extras`` (a map<bigint, double>
    of 0-3 entries, 12 % NULL), filtered on ss_pricing.ss_sales_price,
    element_at(ss_extras, 3) projected, both summed by store: equal to
    pyarrow's struct_field and map_lookup over the same files; and one
    file's two nested columns round trip to Arrow exactly.  Emits a
    ``nested_query`` line a query, then ``nested``; returns the
    records and the largest hash_columns call of each signature."""
    import numpy as np

    from spark_rapids_tpu_torch.session import (
        array_contains,
        array_size,
        col,
        collect_list,
        collect_set,
        count,
        get_item,
        lit,
        posexplode,
        sum_,
    )

    _dd, ss_paths, _item = star["paths"]
    conf = {TTB: Q3DS_TASK_TARGET_BYTES}
    session = TorchSession(conf, device="cuda")
    # baskets_joined's static plan; baskets_joined_adaptive the default's
    unbroadcast = TorchSession(
        {**conf, "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes": -1,
         ADAPTIVE: False}, device="cuda")
    unbroadcast_adaptive = TorchSession(
        {**conf, "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes": -1},
        device="cuda")
    t0 = time.perf_counter()
    sales = pa.concat_tables(pq.read_table(p, columns=[
        "ss_customer_sk", "ss_item_sk", "ss_store_sk"]) for p in ss_paths)
    ref_baskets = sales.group_by("ss_customer_sk").aggregate(
        [("ss_item_sk", "list"), ("ss_store_sk", "distinct")])
    items = sales.column("ss_item_sk")
    ref_counts = pc.value_counts(items.drop_null())
    ref_counts = dict(zip(ref_counts.field("values").to_pylist(),
                          ref_counts.field("counts").to_pylist()))
    ref_fns = sales.append_column("at1", pc.equal(
        sales.column("ss_store_sk"), 1)).group_by("ss_customer_sk").aggregate(
        [("ss_item_sk", "count"), ("ss_item_sk", "min"),
         ("ss_item_sk", "max"), ("at1", "any")])
    ref_s = time.perf_counter() - t0
    basket_cols = {"items": ("ss_item_sk_list", True),
                   "stores": ("ss_store_sk_distinct", True)}

    def baskets(s=session):
        return s.read_parquet(*ss_paths).group_by(col("ss_customer_sk")).agg(
            (collect_list(col("ss_item_sk")), "items"),
            (collect_set(col("ss_store_sk")), "stores"))

    extra: dict = {}

    def check_baskets(t):
        for c in ("items", "stores"):
            if not ascending_within(np, pc, t.column(c)):
                raise AssertionError(f"a baskets array of {c} does not "
                                     "ascend")
        extra.update(same_lists(np, pc, t, ref_baskets, "ss_customer_sk",
                                basket_cols))
        return 0.0

    def explode_back():
        return baskets().select(col("ss_customer_sk"),
                                posexplode(col("items"))).group_by(
            col("col")).agg((count(col("pos")), "n"))

    def check_explode(t):
        got = dict(zip(t.column("col").to_pylist(),
                       t.column("n").to_pylist()))
        if got != ref_counts:
            raise AssertionError("exploded item counts differ from "
                                 "pyarrow's value_counts")
        extra["exploded_rows"] = sum(got.values())
        return 0.0

    def joined(s=unbroadcast):
        cust = s.read_parquet(*store_tables["customer"]).select(
            col("c_customer_sk"))
        return baskets(s).join(
            cust, left_on=[col("ss_customer_sk")],
            right_on=[col("c_customer_sk")])

    def check_joined(t):
        if not pc.all(pc.equal(t.column("ss_customer_sk"),
                               t.column("c_customer_sk"))).as_py():
            raise AssertionError("joined rows pair other customers")
        want = ref_baskets.filter(pc.is_valid(
            ref_baskets.column("ss_customer_sk")))
        extra.update(same_lists(np, pc, t, want, "ss_customer_sk",
                                basket_cols))
        return 0.0

    def q43_pivot():
        dd = session.read_parquet(*store_tables["date_dim"]).where(
            col("d_year").eq(lit(2000))).select(col("d_date_sk"),
                                                 col("d_day_name"))
        st = session.read_parquet(*store_tables["store"]).where(
            col("s_gmt_offset").eq(lit(-5))).select(
            col("s_store_sk"), col("s_store_name"), col("s_store_id"))
        ss = session.read_parquet(*ss_paths)
        return (dd.join(ss, left_on=[col("d_date_sk")],
                        right_on=[col("ss_sold_date_sk")])
                .join(st, left_on=[col("ss_store_sk")],
                      right_on=[col("s_store_sk")])
                .group_by(col("s_store_name"), col("s_store_id"))
                .pivot(col("d_day_name"), list(Q43_DAYS))
                .agg((sum_(col("ss_sales_price")), "sales")))

    q43_want = {(r["s_store_name"], r["s_store_id"]): {
        day: r[name] for day, name in Q43_DAYS.items()}
        for r in q43_text_rows.to_pylist()}

    def check_q43(t):
        if t.num_rows != len(q43_want):
            raise AssertionError(f"{t.num_rows} pivot rows, the q43 text "
                                 f"has {len(q43_want)}")
        return compare(t, q43_want, 2)

    nested_dir = os.path.join(star["dir"], "nested")
    os.makedirs(nested_dir)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:  # a file a task, each its seed
        nested_paths = [f.result()[0] for f in [
            pool.submit(tpcds.write_nested_store_sales, nested_dir, [p],
                        14 + i) for i, p in enumerate(ss_paths)]]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntab = pa.concat_tables(pq.read_table(p, columns=[
        "ss_store_sk", "ss_pricing", "ss_extras"]) for p in nested_paths)
    price = pc.struct_field(ntab.column("ss_pricing"), "ss_sales_price")
    price = pc.if_else(pc.is_valid(ntab.column("ss_pricing")), price, None)
    keep = pc.fill_null(pc.greater(price, 50.0), False)
    ref_scan = pa.table({
        "ss_store_sk": ntab.column("ss_store_sk"), "price": price,
        "x3": pc.map_lookup(ntab.column("ss_extras"), 3, "first")}).filter(
        keep).group_by("ss_store_sk").aggregate(
        [("price", "sum"), ("x3", "sum"), ("x3", "count")])
    scan_want = {(r["ss_store_sk"],): {
        "price": r["price_sum"], "x3": r["x3_sum"], "n3": r["x3_count"]}
        for r in ref_scan.to_pylist()}
    ref_s += time.perf_counter() - t0

    def nested_scan():
        return session.read_parquet(*nested_paths).where(
            col("ss_pricing").get_field("ss_sales_price") > lit(50.0)).select(
            col("ss_store_sk"),
            col("ss_pricing").get_field("ss_sales_price").alias("price"),
            col("ss_extras").element_at(3).alias("x3")).group_by(
            col("ss_store_sk")).agg((sum_(col("price")), "price"),
                                    (sum_(col("x3")), "x3"),
                                    (count(col("x3")), "n3"))

    records, largest = {}, {}
    for name, make_df, check in (
            ("baskets", baskets, check_baskets),
            ("explode_back", explode_back, check_explode),
            ("baskets_joined", joined, check_joined),
            ("q43_pivot", q43_pivot, check_q43),
            ("nested_scan", nested_scan,
             lambda t: compare(t, scan_want, 1))):
        extra.clear()
        plan = make_df().physical_plan()
        calls: list = []
        rec = run_query(torch, make_df, kernels, check, calls, scans=False,
                        timed=0, counted=True)
        check_launches(name, rec, rec)
        records[name] = {
            "joins": join_strategies(plan), **extra,
            "hash_columns_calls": sorted(
                {(n, signature(cols), seed, parts)
                 for cols, n, seed, parts in calls}), **rec}
        if name == "explode_back":
            records[name]["functions"] = basket_functions(
                pa, pc, baskets(), ref_fns, array_size, get_item,
                array_contains, col)
        if name == "baskets_joined":
            # the side with the arrays is hash-exchanged into a
            # partition-wise join, as the customer side is
            (join,) = [n for n in plan.walk() if type(n).__name__
                       == "TpuShuffledHashJoinExec"]
            sides = [type(c).__name__ for c in join.children]
            if not join.partition_wise or sides != [
                    "TpuShuffleExchangeExec"] * 2:
                raise AssertionError(f"baskets_joined plans "
                                     f"{plan.tree_string()}")
        # the top kernels stay in the line: what explode and collect
        # launch on the card (PERF.md section 7)
        emit("nested_query", name=name, **records[name])
        for call in calls:
            key = (signature(call[0]), call[2], call[3])
            if key not in largest or call[1] > largest[key][1]:
                largest[key] = call
    calls = []
    records["baskets_joined_adaptive"] = adaptive_sibling(
        torch, kernels, "baskets_joined (adaptive)",
        lambda: joined(unbroadcast_adaptive), check_joined,
        [["TpuAdaptiveJoinExec", "inner", "right"]], calls)
    emit("nested_query", name="baskets_joined_adaptive",
         **records["baskets_joined_adaptive"])
    for call in calls:
        key = (signature(call[0]), call[2], call[3])
        if key not in largest or call[1] > largest[key][1]:
            largest[key] = call
    one = nested_paths[0]
    back = session.read_parquet(one).select(
        col("ss_pricing"), col("ss_extras")).collect()
    orig = pq.read_table(one, columns=["ss_pricing", "ss_extras"])
    for c in ("ss_pricing", "ss_extras"):
        if not back.column(c).combine_chunks().equals(
                orig.column(c).combine_chunks()):
            raise AssertionError(f"{c} did not round trip exactly")
    emit("nested", datagen_s=gen_s, reference_s=ref_s,
         nested_files=[os.path.basename(p) for p in nested_paths],
         round_trip=["ss_pricing", "ss_extras"], summary={
             name: {k: r.get(k) for k in (
                 "rows", "median_s", "device_busy_s", "device_idle_share",
                 "device_kernel_count", "launches", "planned_map_batches")}
             for name, r in records.items()})
    return records, list(largest.values())


def basket_functions(pa, pc, df, ref_fns, array_size, get_item,
                     array_contains, col) -> dict:
    """array_size, get_item(items, 0), element_at(items, -1) and
    array_contains(stores, 1) over the baskets, once: the count, the
    minimum, the maximum and the membership pyarrow computes per
    customer (the arrays ascend)."""
    got = df.select(col("ss_customer_sk"),
                    array_size(col("items")).alias("n"),
                    get_item(col("items"), 0).alias("lo"),
                    col("items").element_at(-1).alias("hi"),
                    array_contains(col("stores"), 1).alias("at1")).collect()
    g = got.sort_by("ss_customer_sk")
    w = ref_fns.sort_by("ss_customer_sk")
    for gc, wc in (("ss_customer_sk", "ss_customer_sk"),
                   ("n", "ss_item_sk_count"), ("lo", "ss_item_sk_min"),
                   ("hi", "ss_item_sk_max"), ("at1", "at1_any")):
        a = g.column(gc).combine_chunks()
        b = w.column(wc).combine_chunks().cast(a.type)
        if not a.equals(b):
            raise AssertionError(f"baskets' {gc} differs from pyarrow's "
                                 f"{wc}")
    return {"rows": got.num_rows, "checked": ["array_size", "get_item",
                                              "element_at", "array_contains"]}


#: the files customer and customer_address are written again in for the
#: long_tail phase's names query (one file each would make one scan task
#: a side: a single-partition join and aggregate, which hash nothing)
LONG_TAIL_SPLIT = 4
#: the sample query's rand(42) threshold and its seed
SAMPLE_SHARE, SAMPLE_SEED = 0.05, 42
#: rows of the one md5 batch the phase profiles (K7 on the card)
MD5_BATCH_ROWS = 1 << 20
#: store_sales files the tickets_md5 query and its hashlib reference
#: read: hashlib over all six took 11 s in six processes, the phase
#: 44 s, and chip_smoke 716.5 s to its main line, at the 717 s limit, on
#: an H100 80GB HBM3 at 700 W whose earlier phases ran 20-45 s slower
#: than on the call before the phase came
MD5_FILES = 2
#: rows of customer_demographics the ORDER BY rand fallback sorts (a
#: run over item's 18 000 rows was too short for the profiler to see
#: its device work; all 1 920 800 took 7.7 s of the phase)
ORDER_RAND_ROWS = 1 << 19


def initcap_py(s: str) -> str:
    """initcap as the port defines it: upper after a space or at the
    start, lower elsewhere."""
    out, prev = [], " "
    for ch in s:
        out.append(ch.upper() if prev == " " else ch.lower())
        prev = ch
    return "".join(out)


def names_reference(pa, cust, addr) -> tuple:
    """The names query's columns by Python's ``str`` methods, customer by
    customer (every customer's address exists), and its groups."""
    by_sk = {sk: i for i, sk in enumerate(
        addr.column("ca_address_sk").to_pylist())}
    a = {c: addr.column(c).to_pylist() for c in (
        "ca_zip", "ca_street_number", "ca_street_type", "ca_suite_number")}
    c = {n: cust.column(n).to_pylist() for n in (
        "c_customer_sk", "c_first_name", "c_last_name", "c_email_address",
        "c_current_addr_sk")}
    rows, groups = {}, {}
    for k, sk in enumerate(c["c_customer_sk"]):
        j = by_sk[c["c_current_addr_sk"][k]]
        first, last = c["c_first_name"][k], c["c_last_name"][k]
        email = c["c_email_address"][k]
        zip_, num = a["ca_zip"][j], a["ca_street_number"][j]
        stype, suite = a["ca_street_type"][j], a["ca_suite_number"][j]
        parts = None if suite is None else suite.split(" ")
        row = {
            "name": " ".join(initcap_py(x.lower()) for x in (first, last)
                             if x is not None),
            "zip10": None if zip_ is None else zip_.rjust(10, "0")[:10],
            "number": None if num is None else num.ljust(6, ".")[:6],
            "street_type": None if stype is None
            else stype.replace("Street", "St"),
            "user": None if email is None else email.split("@", 1)[0],
            "a_at": None if last is None else last.find("a") + 1,
            "suite": parts[1] if parts is not None and len(parts) > 1
            else None}
        rows[sk] = row
        key = (row["suite"], row["street_type"])
        groups[key] = groups.get(key, 0) + 1
    return rows, {k: {"n": n} for k, n in groups.items()}


def md5_reference(args) -> tuple:
    """hashlib's md5 of ``f"{ticket}|{item}"`` for one file's rows: the
    first byte of each digest (its two hex characters as 0-255), and
    with ``full`` every hex digest.  Runs in a worker process."""
    import hashlib

    import numpy as np

    tickets, items, full = args
    digests = [hashlib.md5(f"{a}|{b}".encode()).digest()
               for a, b in zip(tickets.tolist(), items.tolist())]
    first = np.frombuffer(b"".join(d[:1] for d in digests), np.uint8)
    return first.astype(np.int64), ([d.hex() for d in digests]
                                    if full else None)


def md5_batch_profile(torch, pa, dev, strings) -> dict:
    """K7 on the card: md5 of one batch of ``strings`` (a pyarrow string
    array), its launches and device time from torch.profiler, and its
    time per call from CUDA events over a few calls; the digests held
    against hashlib."""
    import hashlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.arrow import from_arrow
    from spark_rapids_tpu_torch.exprs.hashing import md5_string_bytes

    col = from_arrow(pa.table({"s": strings}), dev).columns[0]
    if not isinstance(col.dtype, T.StringType):
        raise AssertionError(f"md5 batch column is {col.dtype}")

    def run():
        return md5_string_bytes(col.chars, col.lengths)

    out = run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    launches, busy_ns = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            launches += 1
            busy_ns += e.duration_ns()
    ms = cuda_ms(torch, run, 3)
    got = [bytes(r).decode() for r in out.cpu().numpy()[:1000]]
    want = [hashlib.md5(v.encode()).hexdigest()
            for v in strings.to_pylist()[:1000]]
    if got != want:
        raise AssertionError("md5 on the card differs from hashlib")
    return {"rows": len(strings), "width": col.width,
            "blocks": (col.width + 9 + 63) // 64, "launches": launches,
            "device_ms": busy_ns / 1e6, "ms": ms}


def long_tail_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
                    TTB, store_tables: dict) -> tuple:
    """The expression long tail on the card (``long_tail_phase``) over
    q3ds's six store_sales files (6 x 2^20 rows) and the sql phase's SF1
    dimensions (100 000 customers, 50 000 addresses, 18 000 items),
    widths and types as written.  Each query: one profiled run that is
    the warm-up, one counted run, timed, K1's launches equal to the map
    batches its hash exchanges are fed, and no CPU node but in the
    fallbacks.  (1) ``names``: customer JOIN customer_address (each
    written again in LONG_TAIL_SPLIT files, broadcast off: both sides
    hash-exchanged on a LONG) projecting concat_ws / initcap / lower,
    lpad, rpad, a plain regexp_replace, substring_index, locate and
    split()[1], grouped by (split()[1], regexp_replace) with a count:
    K1 on a (STRING, STRING) key; every projected column of every
    customer against Python's str methods, the groups against them.
    (2) ``tickets_md5`` / ``tickets_bucket``: md5(concat_ws('|',
    ticket, item)), (ticket >> 4) & 1023 and item ^ customer, grouped by
    the md5's first two characters (256 groups, K1 on a 2-byte STRING;
    over the first MD5_FILES files, hashlib's cost) and by the bucket
    (1 024 groups, K1 on a LONG; six files) with a count and the sums of
    ss_net_paid and the xor: against numpy and hashlib, and one file's
    md5 column against hashlib row for row.
    (3) ``sample``: a Filter rand(42) < 0.05, then
    monotonically_increasing_id(), spark_partition_id(),
    input_file_name() and rand(42) projected, grouped by (partition,
    file) with a count (K1 on an (INT, STRING) key): each file's count
    equals the rows whose draw passes (the recipe in numpy at every
    row), and the kept rows' ids are unique, carry their partition, and
    their rand is the recipe at their position; the sample within 5
    standard deviations of 5 %.  (4) ``ansi``: ticket * quantity
    projected and summed by store with the ANSI key on: one poll a
    batch, the rows those of the key off (whose wall is kept) and
    numpy's; a Multiply that overflows, a zero divisor and a malformed
    STRING to INT cast raise AnsiError with the JAX messages, and with
    the key off wrap or give NULL as numpy does; no ANSI poll may have
    run before the phase (every earlier phase runs with the key off).
    (5) ``fallback_json``,
    ``fallback_split``, ``fallback_regex``, ``fallback_order_rand``:
    get_json_object over a JSON text made from item, a bare split, a
    regexp_replace with a real regex and ORDER BY rand(7) (over the
    first ORDER_RAND_ROWS customer_demographics rows), each beside a
    projection on the card (lengths, lower-case, sums), each one CPU
    node with the JAX reason, its transitions counted, its rows those
    of Python's json / re / the recipe at partition 0.  Then md5 of one
    MD5_BATCH_ROWS batch profiled (K7's launches and device time).
    Emits a ``long_tail_query`` line a query, then ``long_tail``;
    returns the records and the largest hash_columns call of each
    signature."""
    import hashlib
    import json
    import re

    import numpy as np

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.config import ANSI_ENABLED, BATCH_ROWS
    from spark_rapids_tpu_torch.config import DEFAULTS
    from spark_rapids_tpu_torch.exprs.arithmetic import IntegralDivide
    from spark_rapids_tpu_torch.exprs.base import AnsiError, ansi_polls
    from spark_rapids_tpu_torch.exprs.bitwise import (
        BitwiseAnd,
        BitwiseXor,
        ShiftRight,
    )
    from spark_rapids_tpu_torch.exprs.cast import Cast
    from spark_rapids_tpu_torch.exprs.collections import GetArrayItem
    from spark_rapids_tpu_torch.exprs.hashing import Md5
    from spark_rapids_tpu_torch.exprs.nondeterministic import (
        InputFileName,
        rand_uniform,
    )
    from spark_rapids_tpu_torch.exprs.strings import (
        GetJsonObject,
        Length,
        Lower,
        StringSplit,
        Substring,
    )
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.session import (
        col,
        concat_ws,
        count,
        count_star,
        initcap,
        lit,
        locate,
        lpad,
        max_,
        monotonically_increasing_id,
        rand,
        regexp_replace,
        rpad,
        spark_partition_id,
        substring_index,
        sum_,
    )

    if ansi_polls():  # the key is off in every earlier phase: no sync
        raise AssertionError(f"{ansi_polls()} ANSI polls before the "
                             "long_tail phase")
    _dd, ss_paths, item_path = star["paths"]
    lt_dir = os.path.join(star["dir"], "long_tail")
    os.makedirs(lt_dir)
    t0 = time.perf_counter()
    cust = pq.read_table(store_tables["customer"][0])
    addr = pq.read_table(store_tables["customer_address"][0])
    split_paths = {}
    for name, tbl in (("customer", cust), ("customer_address", addr)):
        step = -(-tbl.num_rows // LONG_TAIL_SPLIT)
        split_paths[name] = []
        for k in range(LONG_TAIL_SPLIT):
            path = os.path.join(lt_dir, f"{name}_{k}.parquet")
            pq.write_table(tbl.slice(k * step, step), path)
            split_paths[name].append(path)
    gen_s = time.perf_counter() - t0
    ref_s = {}
    t0 = time.perf_counter()
    name_rows, name_groups = names_reference(pa, cust, addr)
    ref_s["names"] = time.perf_counter() - t0

    conf = {TTB: Q3DS_TASK_TARGET_BYTES}
    session = TorchSession(conf, device="cuda")
    split_session = TorchSession({
        TTB: 1, "spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes": -1},
        device="cuda")

    def names_projection():
        c = split_session.read_parquet(*split_paths["customer"])
        a = split_session.read_parquet(*split_paths["customer_address"])
        suite = GetArrayItem(StringSplit(col("ca_suite_number"), lit(" ")),
                             lit(1))
        return c.join(a, left_on=[col("c_current_addr_sk")],
                      right_on=[col("ca_address_sk")]).select(
            col("c_customer_sk"),
            concat_ws(" ", initcap(Lower(col("c_first_name"))),
                      initcap(Lower(col("c_last_name")))).alias("name"),
            lpad("ca_zip", 10, "0").alias("zip10"),
            rpad("ca_street_number", 6, ".").alias("number"),
            regexp_replace("ca_street_type", "Street", "St").alias(
                "street_type"),
            substring_index("c_email_address", "@", 1).alias("user"),
            locate("a", "c_last_name").alias("a_at"),
            suite.alias("suite"))

    def names():
        return names_projection().group_by(
            col("suite"), col("street_type")).agg((count_star(), "n"))

    def check_names(t):
        if t.num_rows != len(name_groups):
            raise AssertionError(f"{t.num_rows} name groups, reference "
                                 f"has {len(name_groups)}")
        return compare(t, name_groups, 2)

    def tickets_projection(key):
        """The grouping key (the md5's first two characters or the
        bucket), the xor and ss_net_paid (a projection computes every
        expression it holds, so each query projects only its key)."""
        md5 = Md5(concat_ws("|", Cast(col("ss_ticket_number"), T.STRING),
                            Cast(col("ss_item_sk"), T.STRING)))
        made = Substring(md5, 1, 2) if key == "h2" else BitwiseAnd(
            ShiftRight(col("ss_ticket_number"), lit(4)), lit(1023))
        files = ss_paths[:MD5_FILES] if key == "h2" else ss_paths
        return session.read_parquet(*files).select(
            made.alias(key),
            BitwiseXor(col("ss_item_sk"), col("ss_customer_sk")).alias("x"),
            col("ss_net_paid"))

    def ticket_aggs(df, key):
        return df.group_by(col(key)).agg(
            (count_star(), "n"), (sum_(col("ss_net_paid")), "paid"),
            (sum_(col("x")), "x"))

    def tickets_md5():
        return ticket_aggs(tickets_projection("h2"), "h2")

    def tickets_bucket():
        return ticket_aggs(tickets_projection("bucket"), "bucket")

    t0 = time.perf_counter()
    sales = [pq.read_table(p, columns=[
        "ss_ticket_number", "ss_item_sk", "ss_customer_sk", "ss_net_paid",
        "ss_quantity", "ss_store_sk"]) for p in ss_paths]
    ticket = np.concatenate([t.column("ss_ticket_number").to_numpy()
                             for t in sales])
    item = np.concatenate([t.column("ss_item_sk").to_numpy()
                           for t in sales])
    paid = np.concatenate([t.column("ss_net_paid").to_numpy()
                           for t in sales])
    cust_sk = pa.chunked_array([t.column("ss_customer_sk") for t in sales])
    cust_ok = pc.is_valid(cust_sk).to_numpy(zero_copy_only=False)
    xor = np.where(cust_ok, item ^ pc.fill_null(cust_sk, 0).to_numpy(), 0)
    # hashlib over each of the md5 query's files in its own process
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(MD5_FILES) as pool:
        hashed = pool.map(md5_reference, [
            (t.column("ss_ticket_number").to_numpy(),
             t.column("ss_item_sk").to_numpy(), k == 0)
            for k, t in enumerate(sales[:MD5_FILES])])
    first_md5 = hashed[0][1]
    prefix = np.concatenate([h[0] for h in hashed])
    ref_s["tickets_md5"] = time.perf_counter() - t0

    def grouped(codes, names_of):
        rows = len(codes)
        n = np.bincount(codes)
        psum = np.bincount(codes, weights=paid[:rows])
        xs = np.bincount(codes, weights=xor[:rows])  # < 2^17 a row: exact
        return {(names_of[k],): {"n": int(n[k]), "paid": float(psum[k]),
                                 "x": int(xs[k])}
                for k in range(len(n)) if n[k]}

    md5_want = grouped(prefix, [f"{k:02x}" for k in range(256)])
    bucket = (ticket >> 4) & 1023
    bucket_want = grouped(bucket, list(range(1024)))
    del prefix

    def check_md5(t):  # 256 prefixes at 2 x 2^20 rows
        return compare(t, md5_want, 1)

    def check_bucket(t):  # 1 024 buckets at 6 x 2^20 rows
        return compare(t, bucket_want, 1)

    t0 = time.perf_counter()
    sizes = [t.num_rows for t in sales]
    passing = [rand_uniform(SAMPLE_SEED, p, np.arange(n)) < SAMPLE_SHARE
               for p, n in enumerate(sizes)]
    sample_want = {(p, ss_paths[p]): {"n": int(keep.sum())}
                   for p, keep in enumerate(passing)}
    ref_s["sample"] = time.perf_counter() - t0

    def sample_projection():
        return session.read_parquet(*ss_paths).where(
            rand(SAMPLE_SEED) < lit(SAMPLE_SHARE)).select(
            monotonically_increasing_id().alias("id"),
            spark_partition_id().alias("p"),
            InputFileName().alias("f"), rand(SAMPLE_SEED).alias("r"))

    def sample():
        return sample_projection().group_by(col("p"), col("f")).agg(
            (count_star(), "n"))

    ansi_on = TorchSession({**conf, ANSI_ENABLED: True}, device="cuda")
    ansi_off = TorchSession({**conf, ANSI_ENABLED: False}, device="cuda")

    def ansi_query(s):
        return s.read_parquet(*ss_paths).select(
            col("ss_store_sk"),
            (col("ss_ticket_number") * col("ss_quantity")).alias("tq")
        ).group_by(col("ss_store_sk")).agg((sum_(col("tq")), "tq"),
                                           (count_star(), "n"))

    qty = np.concatenate([t.column("ss_quantity").to_numpy() for t in sales])
    store = np.concatenate([t.column("ss_store_sk").to_numpy()
                            for t in sales])
    tq = ticket * qty
    ansi_want = {(int(k),): {"tq": int(tq[store == k].sum()),
                             "n": int((store == k).sum())}
                 for k in np.unique(store)}
    polls = {}

    def ansi_df():
        polls.setdefault("before", ansi_polls())
        return ansi_query(ansi_on)

    def check_ansi(t):
        return compare(t, ansi_want, 1)

    item_tbl = pq.read_table(item_path, columns=[
        "i_item_sk", "i_brand", "i_current_price"])
    docs = [json.dumps({"brand": b, "price": p}) for b, p in zip(
        item_tbl.column("i_brand").to_pylist(),
        item_tbl.column("i_current_price").to_pylist())]
    json_table = pa.table({"i_item_sk": item_tbl.column("i_item_sk"),
                           "j": pa.array(docs)})

    def json_value(doc, field):
        v = json.loads(doc).get(field)
        if v is None or isinstance(v, str):
            return v
        return json.dumps(v, separators=(",", ":"))

    addr_path = store_tables["customer_address"][0]
    cdemo = pq.read_table(store_tables["customer_demographics"][0])
    cdemo_path = os.path.join(lt_dir, "customer_demographics_part.parquet")
    pq.write_table(cdemo.slice(0, ORDER_RAND_ROWS), cdemo_path)
    cdemo_sk = cdemo.column("cd_demo_sk").to_numpy()[:ORDER_RAND_ROWS]
    addr_names = addr.column("ca_street_name").to_pylist()
    addr_types = addr.column("ca_street_type").to_pylist()
    # each plan puts work on the card beside its CPU node: the profiled
    # run must see device time, and on an H100 80GB HBM3 the profiler
    # saw none of a run over item's 18 000 rows that took ~20 ms, so
    # ORDER BY rand sorts ORDER_RAND_ROWS customer_demographics rows
    # and adds a projection on the card after its CPU node
    fallbacks = {
        "fallback_json": (
            lambda: session.create_dataframe(json_table).select(
                col("i_item_sk"), col("j"),
                Length(col("j")).alias("len")).select(
                col("i_item_sk"), col("len"),
                GetJsonObject(col("j"), lit("$.brand")).alias("brand"),
                GetJsonObject(col("j"), lit("$.price")).alias("price")),
            "get_json_object evaluates JSON paths on the CPU engine",
            {"len": [len(d) for d in docs],
             "brand": [json_value(d, "brand") for d in docs],
             "price": [json_value(d, "price") for d in docs]}),
        "fallback_split": (
            lambda: session.read_parquet(addr_path).select(
                col("ca_address_sk"),
                Lower(col("ca_street_name")).alias("name")).select(
                col("ca_address_sk"),
                StringSplit(col("name"), lit(" ")).alias("parts")),
            "bare split() produces array<string>",
            {"parts": [None if v is None else v.lower().split(" ")
                       for v in addr_names]}),
        "fallback_regex": (
            lambda: session.read_parquet(addr_path).select(
                col("ca_address_sk"),
                Lower(col("ca_street_type")).alias("t0")).select(
                col("ca_address_sk"),
                regexp_replace("t0", "[aeiou]+", "").alias("t")),
            "is a real regular expression",
            {"t": [None if v is None else re.sub("[aeiou]+", "", v.lower())
                   for v in addr_types]}),
        "fallback_order_rand": (
            lambda: session.read_parquet(cdemo_path).select(
                col("cd_demo_sk"),
                (col("cd_demo_sk") * lit(2)).alias("twice")).order_by(
                rand(7)).select(col("twice"),
                                (col("twice") + lit(1)).alias("odd")),
            "nondeterministic expression as sort key",
            {"odd": (2 * cdemo_sk[np.argsort(rand_uniform(
                7, 0, np.arange(len(cdemo_sk))), kind="stable")]
                + 1).tolist()}),
    }

    def exact(want: dict):
        def check(t):
            for c, w in want.items():
                if t.column(c).to_pylist() != w:
                    raise AssertionError(f"column {c} differs from its "
                                         "Python reference")
            return 0.0
        return check

    records, largest = {}, {}
    queries = [("names", names, check_names, 0),
               ("tickets_md5", tickets_md5, check_md5, 0),
               ("tickets_bucket", tickets_bucket, check_bucket, 0),
               ("sample", sample, lambda t: compare(t, sample_want, 2), 0),
               ("ansi", ansi_df, check_ansi, 0)]
    queries += [(name, make, exact(want), 1)
                for name, (make, _reason, want) in fallbacks.items()]
    for name, make_df, check, n_cpu in queries:
        plan = make_df().physical_plan()
        calls: list = []
        rec = run_query(torch, make_df, kernels, check, calls, scans=False,
                        timed=0, counted=True, fallback=n_cpu)
        check_launches(name, rec, rec)
        records[name] = {
            "joins": join_strategies(plan),
            "hash_columns_calls": sorted(
                {(n, signature(cols), seed, parts)
                 for cols, n, seed, parts in calls}), **rec}
        for call in calls:
            key = (signature(call[0]), call[2], call[3])
            if key not in largest or call[1] > largest[key][1]:
                largest[key] = call
        if name in fallbacks:
            records[name].update(fallback_detail(
                make_df, fallbacks[name][1], collect_exec))
        if name == "ansi":
            # the profiled warm-up polls as the counted runs do
            batches = (records[name]["runs"] + 1) * sum(
                -(-n // DEFAULTS[BATCH_ROWS]) for n in sizes)
            records[name]["ansi_polls"] = ansi_polls() - polls["before"]
            if records[name]["ansi_polls"] != batches:
                raise AssertionError(f"ansi polled {records[name]}"
                                     f"['ansi_polls'] times, expected "
                                     f"{batches} (one a batch)")
            records[name].update(ansi_checks(
                torch, ansi_on, ansi_off, ansi_query, ss_paths, ticket, qty,
                col, lit, concat_ws, Cast, IntegralDivide, T, max_, count,
                AnsiError))
        emit("long_tail_query", name=name, **records[name])
    names_rows = extra_names_check(names_projection, name_rows)
    first = session.read_parquet(ss_paths[0]).select(
        Md5(concat_ws("|", Cast(col("ss_ticket_number"), T.STRING),
                      Cast(col("ss_item_sk"), T.STRING))).alias(
            "md5")).collect().column("md5").to_pylist()
    if first != first_md5:
        raise AssertionError("one file's md5 column differs from hashlib")
    sample_rows = sample_projection_check(
        pa, sample_projection, rand_uniform, ss_paths, sizes)
    texts = pa.array([f"{a}|{b}" for a, b in zip(
        sales[0].column("ss_ticket_number").to_pylist()[:MD5_BATCH_ROWS],
        sales[0].column("ss_item_sk").to_pylist()[:MD5_BATCH_ROWS])])
    md5_batch = md5_batch_profile(torch, pa, torch.device("cuda"), texts)
    emit("long_tail", datagen_s=gen_s, reference_s=ref_s,
         names_rows_checked=names_rows, md5_rows_checked=len(first),
         sample=sample_rows, md5_batch=md5_batch, summary={
             name: {k: r.get(k) for k in (
                 "rows", "median_s", "device_busy_s", "device_idle_share",
                 "device_kernel_count", "launches", "planned_map_batches")}
             for name, r in records.items()})
    return records, list(largest.values())


#: the cached frame's columns (python phase)
CACHE_COLUMNS = ("ss_store_sk", "ss_item_sk", "ss_customer_sk",
                 "ss_quantity", "ss_net_paid")
#: the opaque UDF runs row by row in Python: it reads the first of the
#: six files (2^20 rows), as does transform_in_pandas (its output is a
#: row a row)
PYTHON_OPAQUE_FILES = 1
#: quantity bands of the opaque UDF (a dict lookup: nothing compiles it)
QUANTITY_BANDS = {0: "small", 1: "medium", 2: "large", 3: "bulk"}


def py_paid_times_quantity(tbl):
    """map_in_arrow's function (python phase)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    return pa.table({"ss_store_sk": tbl["ss_store_sk"],
                     "v": pc.multiply(tbl["ss_net_paid"],
                                      pc.cast(tbl["ss_quantity"],
                                              pa.float64()))})


def py_paid_times_quantity_pd(df):
    """map_in_pandas's function."""
    import pandas as pd

    return pd.DataFrame({"ss_store_sk": df["ss_store_sk"],
                         "v": df["ss_net_paid"] * df["ss_quantity"]})


def py_store_summary(g):
    """apply_in_pandas's function: a row a store."""
    import pandas as pd

    return pd.DataFrame({"ss_store_sk": [g["ss_store_sk"].iloc[0]],
                         "n": [len(g)],
                         "paid": [float(g["ss_net_paid"].sum())]})


def py_mean(s):
    return float(s.mean())


def py_max(s):
    return float(s.max())


def py_store_cogroup(sales, returns):
    """cogroup's function: a store's sales and returns."""
    import pandas as pd

    k = sales["ss_store_sk"].iloc[0] if len(sales) \
        else returns["sr_store_sk"].iloc[0]
    return pd.DataFrame({"store": [k], "sold": [len(sales)],
                         "returned": [len(returns)],
                         "loss": [float(returns["sr_net_loss"].sum())]})


def py_child_facts(tbl):
    """The worker child's pid and whether it sees a card."""
    import os as _os

    import pyarrow as pa

    return pa.table({"pid": [_os.getpid()], "cuda_visible": [
        _os.environ.get("CUDA_VISIBLE_DEVICES")]})


# the compiled UDF: a plain function in the compiler's subset (with no
# docstring: the compiler, as JAX's, takes no statement but if / return)
def paid_per_unit(paid, qty):
    return paid / qty if qty > 0 else 0.0


def paid_per_unit_torch(paid, qty):
    """The torch UDF: the same on the card's tensors."""
    import torch

    return torch.where(qty > 0, paid / qty, torch.zeros_like(paid))


def quantity_band(qty):
    """The opaque UDF: a dict lookup, outside the compiler's subset."""
    return QUANTITY_BANDS.get(qty // 25, "other")


def bump_in_place(v):
    """A torch UDF that writes into its input (cache_consumers)."""
    return v.add_(1.0)


def compute_apps() -> list:
    """The compute processes nvidia-smi lists on the card: (pid, MiB)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def cache_run(torch, kernels, df) -> tuple:
    """One collect of a frame over a cache: its result, wall, what its
    scans uploaded, what its cache served and stored, and the K1
    launches against the map batches its hash exchanges were fed."""
    import threading

    from spark_rapids_tpu_torch.plan.planner import collect_exec

    lock = threading.Lock()
    fed = {"map": 0}

    def counted(feed):
        def execute_partition(p):
            for batch in feed(p):
                if batch.num_rows:
                    with lock:
                        fed["map"] += 1
                yield batch
        return execute_partition

    plan = df.physical_plan()
    for node in plan.walk():
        if type(node).__name__ == "TpuShuffleExchangeExec":
            child = node.children[0]
            child.execute_partition = counted(child.execute_partition)
    k1 = kernels.hash_columns.launches
    t0 = time.perf_counter()
    result = collect_exec(plan, df._session.conf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nodes = list(plan.walk())
    cache = [n for n in nodes if type(n).__name__ == "TpuCacheExec"]
    return result, {
        "wall_s": wall,
        "scan_rows": sum(n.metrics["numOutputRows"] for n in nodes
                         if type(n).__name__ == "ParquetScanExec"),
        "cache_hits": sum(n.metrics["cacheHits"] for n in cache),
        "cache_writes": sum(n.metrics["cacheWrites"] for n in cache),
        "map_batches": fed["map"],
        "k1": kernels.hash_columns.launches - k1}


def cache_sales(torch, pc, kernels, TorchSession, TTB, ss_paths,
                sales) -> tuple:
    """``cache_sales``: ss_quantity > 10 over the six files, projected to
    CACHE_COLUMNS and cached; by store (sum of ss_net_paid, count) and
    by item (count) over it.  The uncached by-store query through
    run_query; then three collects of each over the cache, the first
    materializing it: every result equal to pyarrow's, every later one
    bit for bit the first, no scan row uploaded once the slot is filled
    and cacheHits the cached batches, K1 the map batches each run; after
    unpersist() the store's device bytes are where they were.  Returns
    the uncached run's hash_columns calls and the record."""
    from spark_rapids_tpu_torch import col, count_star, lit, sum_

    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    store = session.store

    def base():
        return session.read_parquet(*ss_paths).where(
            col("ss_quantity") > lit(10)).select(
            *[col(c) for c in CACHE_COLUMNS])

    def by_store(df):
        return df.group_by(col("ss_store_sk")).agg(
            (sum_(col("ss_net_paid")), "paid"), (count_star(), "n"))

    def by_item(df):
        return df.group_by(col("ss_item_sk")).agg((count_star(), "n"))

    kept = sales.filter(pc.greater(sales["ss_quantity"], 10))
    g = kept.group_by(["ss_store_sk"]).aggregate(
        [("ss_net_paid", "sum"), ("ss_net_paid", "count")])
    want_store = {(r["ss_store_sk"],): {
        "paid": r["ss_net_paid_sum"], "n": r["ss_net_paid_count"]}
        for r in g.to_pylist()}
    gi = kept.group_by(["ss_item_sk"]).aggregate([("ss_item_sk", "count")])
    want_item = {(r["ss_item_sk"],): {"n": r["ss_item_sk_count"]}
                 for r in gi.to_pylist()}
    calls: list = []
    uncached = run_query(torch, lambda: by_store(base()), kernels,
                         lambda t: compare(t, want_store, 1), calls,
                         scans=False, timed=0, counted=True)
    check_launches("cache_sales_uncached", uncached, uncached)
    before = store.device_used
    cached = base().cache()
    runs, first = [], {}
    for name, query, want, key in (
            ("by_store", by_store, want_store, "ss_store_sk"),
            ("by_item", by_item, want_item, "ss_item_sk")):
        for i in range(3):
            result, rec = cache_run(torch, kernels, query(cached))
            rec.update(query=name, run=i)
            rec["max_rel_err"] = compare(result, want, 1)
            result = result.sort_by(key)
            if name not in first:
                first[name] = result
            elif not result.equals(first[name]):
                raise AssertionError(f"{name} run {i} differs from the "
                                     "first bit for bit")
            runs.append(rec)
    slot = cached._plan.slot
    cached_batches = sum(len(h) for h in slot.parts)
    for rec in runs:
        materializing = rec is runs[0]
        if rec["k1"] != rec["map_batches"]:
            raise AssertionError(f"cache_sales launched K1 {rec['k1']} "
                                 f"times for {rec['map_batches']} batches")
        if materializing != bool(rec["scan_rows"]) or rec["cache_hits"] != (
                0 if materializing else cached_batches) or rec[
                "cache_writes"] != (cached_batches if materializing else 0):
            raise AssertionError(f"cache_sales run {rec}: the scans or the "
                                 f"cache moved wrongly ({cached_batches} "
                                 "cached batches)")
    served = profiled_run(torch, lambda: by_store(cached))
    del served["kernel_counts"]
    held = store.device_used - before
    cached.unpersist()
    if store.device_used != before or slot.filled:
        raise AssertionError(f"after unpersist the store holds "
                             f"{store.device_used} device bytes, "
                             f"{before} before the cache")
    return calls, {"uncached": {k: uncached[k] for k in (
        "median_s", "device_busy_s", "device_idle_share",
        "device_kernel_count", "launches", "planned_map_batches")},
        "runs": runs, "cached_batches": cached_batches,
        "cached_device_bytes": held,
        "walls_s": {"uncached": uncached["median_s"],
                    "materializing": runs[0]["wall_s"],
                    "served": statistics.median(
                        r["wall_s"] for r in runs[1:3])},
        "served_profile": served, "store_device_bytes_after": before}


def cache_consumers(TorchSession, TTB, ss_paths, store_path) -> dict:
    """``cache_consumers``: one cached frame under a Filter, a torch UDF
    that adds to its input in place (then summed by store), an ORDER BY
    and a join with store, collected in three rounds, the store's cached
    batches spilled to host before the third: every round's tables equal
    the first's bit for bit, and the first equal to the same queries
    uncached."""
    from spark_rapids_tpu_torch import col, count_star, lit, sum_
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.execs.sort import SortKey
    from spark_rapids_tpu_torch.udf import torch_udf

    mod = python_fn_module()
    bump = torch_udf(T.DOUBLE)(mod.bump_in_place)
    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")

    def base():
        return session.read_parquet(*ss_paths).select(
            *[col(c) for c in CACHE_COLUMNS])

    dim = session.read_parquet(store_path).select(
        col("s_store_sk"), col("s_store_name"))

    def consumers(df):
        return {
            "filter": df.where(col("ss_quantity") < lit(30)),
            "bump": df.select(col("ss_store_sk"), bump(
                col("ss_net_paid")).alias("b")).group_by(
                col("ss_store_sk")).agg((sum_(col("b")), "b")),
            "order_by": df.order_by(
                SortKey(col("ss_net_paid"), descending=True),
                SortKey(col("ss_item_sk")), SortKey(col("ss_customer_sk"))
            ).select(col("ss_net_paid"), col("ss_item_sk")),
            "join": df.join(dim, left_on=[col("ss_store_sk")],
                            right_on=[col("s_store_sk")]).group_by(
                col("s_store_name")).agg((count_star(), "n"),
                                         (sum_(col("ss_net_paid")), "paid"))}

    def tables(qs: dict) -> dict:
        out = {}
        for name, df in qs.items():
            t = df.collect()
            out[name] = t if name == "order_by" else t.sort_by(
                t.schema.names[0])
        return out

    cached = base().cache()
    t0 = time.perf_counter()
    rounds = [tables(consumers(cached))]
    round_s = [time.perf_counter() - t0]
    want = tables(consumers(base()))
    spill = {}
    for r in range(2):
        if r == 1:
            moved = session.store.spill_all_unpinned()
            spill = {k: v for k, v in session.spill_stats().items()
                     if k in ("spilled_device_to_host", "restores")}
            if not moved:
                raise AssertionError("no cached batch spilled to host")
        t0 = time.perf_counter()
        rounds.append(tables(consumers(cached)))
        round_s.append(time.perf_counter() - t0)
    restores = session.spill_stats()["restores"]
    for name, t in rounds[0].items():
        if name == "bump":
            if not (t.column("ss_store_sk").equals(
                    want["bump"].column("ss_store_sk"))):
                raise AssertionError("bump groups differ")
        for k, other in enumerate(rounds[1:] + [want]):
            if not other[name].equals(t):
                raise AssertionError(f"cache_consumers {name}: round "
                                     f"{k + 2} differs bit for bit")
    cached.unpersist()
    if session.store.leak_report():
        raise AssertionError(session.store.leak_report())
    # the spill moved the process store's counters, which the later
    # phases hold at zero: they start on a fresh store
    fresh_store()
    return {"rows": {n: t.num_rows for n, t in rounds[0].items()},
            "round_s": round_s, "spill": spill,
            "restores_after": restores}


def python_fn_module():
    """chip_smoke under its module name: the worker children unpickle the
    python phase's functions by reference, and a function of the script
    run as __main__ is not found there."""
    import importlib

    return importlib.import_module("chip_smoke")


def python_phase(torch, pa, pc, pq, star, kernels, TorchSession,
                 TTB) -> tuple:
    """The cache, the Python execs and the UDF tiers on the card
    (``python_phase``) over q3ds's six store_sales files (6 x 2^20 rows
    of 23 columns) and q93's 627 996 store_returns; no data is written.
    ``cache_sales`` and ``cache_consumers`` (above), then one
    ``python_query`` line each for ``udf_compiled`` (``@udf``, compiled
    to built-in expressions, no CPU node), ``udf_torch``
    (``@torch_udf`` on the card's tensors; both summed by store against
    pyarrow), ``udf_opaque`` (a dict lookup: one CPU node over the first
    PYTHON_OPAQUE_FILES file, its transitions counting the rows, grouped
    by band against Python), ``map_in_arrow`` (six files, pythonBatches
    six a run, one device-to-host copy of each tensor a batch) and, with
    pandas present, ``map_in_pandas``, ``apply_in_pandas`` and
    ``agg_in_pandas`` by ss_store_sk (K1 in their exchange),
    ``cogroup`` of store_sales with store_returns by store and
    ``transform_in_pandas`` over the first file: each a profiled run
    that is the warm-up and one counted run, timed, K1 against the
    planned map batches, the rows against pyarrow.  Last, the compute
    processes nvidia-smi lists while a worker pool is live: one, this
    process (the children see no card)."""
    import collections
    import importlib.util

    import numpy as np

    from spark_rapids_tpu_torch import col, count_star, sum_
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.python_worker import PythonWorkerPool
    from spark_rapids_tpu_torch.udf import torch_udf, udf

    mod = python_fn_module()
    has_pandas = importlib.util.find_spec("pandas") is not None
    _dd, ss_paths, _item = star["paths"]
    sr_path, _reason = star["q93_paths"]
    t0 = time.perf_counter()
    sales = pa.concat_tables([pq.read_table(p, columns=list(CACHE_COLUMNS))
                              for p in ss_paths])
    returns = pq.read_table(sr_path, columns=["sr_store_sk", "sr_net_loss"])
    load_s = time.perf_counter() - t0
    out = {"pandas": has_pandas}
    t0 = time.perf_counter()
    cache_calls, out["cache_sales"] = cache_sales(
        torch, pc, kernels, TorchSession, TTB, ss_paths, sales)
    emit("python_query", name="cache_sales", **out["cache_sales"])
    out["cache_consumers"] = cache_consumers(TorchSession, TTB, ss_paths,
                                             star["store_path"])
    emit("python_query", name="cache_consumers", **out["cache_consumers"])
    cache_s = time.perf_counter() - t0

    session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    paid, qty = sales["ss_net_paid"], sales["ss_quantity"]
    store_sk = sales["ss_store_sk"].to_numpy()

    def by_store(values: np.ndarray) -> dict:
        sums = np.zeros(int(store_sk.max()) + 1)
        np.add.at(sums, store_sk, values)
        counts = np.bincount(store_sk)
        return {(int(k),): {"s": float(sums[k]), "n": int(counts[k])}
                for k in np.nonzero(counts)[0]}

    paid_np = paid.to_numpy()
    qty_np = qty.to_numpy()
    per_unit = np.where(qty_np > 0, paid_np / np.maximum(qty_np, 1), 0.0)
    want_unit = by_store(per_unit)
    want_pxq = by_store(paid_np * qty_np)
    first_n = pq.read_metadata(ss_paths[0]).num_rows
    bands = collections.Counter(
        QUANTITY_BANDS.get(int(q) // 25, "other") for q in qty_np[:first_n])
    want_bands = {(b,): {"n": n} for b, n in bands.items()}

    compiled = udf(T.DOUBLE)(mod.paid_per_unit)
    columnar = torch_udf(T.DOUBLE)(mod.paid_per_unit_torch)
    opaque = udf(T.STRING)(mod.quantity_band)
    tiers = {"compiled": compiled.tier, "torch": columnar.tier,
             "opaque": opaque.tier}
    if tiers != {"compiled": "compiled", "torch": "torch",
                 "opaque": "opaque"}:
        raise AssertionError(f"UDF tiers {tiers}")

    def sales3():
        return session.read_parquet(*ss_paths).select(
            col("ss_store_sk"), col("ss_net_paid"), col("ss_quantity"))

    def summed(df, value: str):
        return df.group_by(col("ss_store_sk")).agg(
            (sum_(col(value)), "s"), (count_star(), "n"))

    pxq_schema = pa.schema([("ss_store_sk", pa.int64()), ("v", pa.float64())])
    queries = [
        ("udf_compiled", lambda: summed(sales3().select(
            col("ss_store_sk"), compiled(col("ss_net_paid"),
                                         col("ss_quantity")).alias("u")),
            "u"), lambda t: compare(t, want_unit, 1), 0),
        ("udf_torch", lambda: summed(sales3().select(
            col("ss_store_sk"), columnar(col("ss_net_paid"),
                                         col("ss_quantity")).alias("u")),
            "u"), lambda t: compare(t, want_unit, 1), 0),
        ("udf_opaque", lambda: session.read_parquet(
            *ss_paths[:PYTHON_OPAQUE_FILES]).select(opaque(
                col("ss_quantity")).alias("band")).group_by(
            col("band")).agg((count_star(), "n")),
            lambda t: compare(t, want_bands, 1), 1),
        ("map_in_arrow", lambda: summed(sales3().map_in_arrow(
            mod.py_paid_times_quantity, pxq_schema), "v"),
            lambda t: compare(t, want_pxq, 1), 0),
    ]
    if has_pandas:
        kept_first = {}
        first = sales.slice(0, first_n)
        f_store = first["ss_store_sk"].to_numpy()
        f_paid = first["ss_net_paid"].to_numpy()
        for k in np.unique(f_store):
            kept_first[int(k)] = float(f_paid[f_store == k].mean())
        g = sales.group_by(["ss_store_sk"]).aggregate(
            [("ss_net_paid", "sum"), ("ss_net_paid", "count"),
             ("ss_net_paid", "mean"), ("ss_net_paid", "max")])
        want_summary = {(r["ss_store_sk"],): {
            "n": r["ss_net_paid_count"], "paid": r["ss_net_paid_sum"]}
            for r in g.to_pylist()}
        want_agg = {(r["ss_store_sk"],): {
            "mean_paid": r["ss_net_paid_mean"],
            "max_paid": r["ss_net_paid_max"]} for r in g.to_pylist()}
        rg = returns.group_by(["sr_store_sk"]).aggregate(
            [("sr_net_loss", "sum"), ("sr_net_loss", "count")])
        ret = {r["sr_store_sk"]: r for r in rg.to_pylist()}
        want_cogroup = {(k,): {
            "sold": v["n"],
            "returned": ret.get(k, {}).get("sr_net_loss_count", 0),
            "loss": float(ret.get(k, {}).get("sr_net_loss_sum", 0.0))}
            for (k,), v in want_summary.items()}
        for k, r in ret.items():
            if (k,) not in want_cogroup:
                want_cogroup[(k,)] = {"sold": 0,
                                      "returned": r["sr_net_loss_count"],
                                      "loss": r["sr_net_loss_sum"]}

        def check_transform(t):
            stores = t.column("ss_store_sk").to_numpy()
            means = t.column("store_mean").to_numpy()
            ref = np.array([kept_first[int(s)] for s in stores])
            if t.num_rows != first_n:
                raise AssertionError(f"{t.num_rows} rows, {first_n} read")
            rel = np.abs(means - ref) / np.maximum(np.abs(ref), 1e-300)
            if rel.max() > REL_TOL:
                raise AssertionError(f"store_mean off by {rel.max()}")
            return float(rel.max())

        summary_schema = pa.schema([("ss_store_sk", pa.int64()),
                                    ("n", pa.int64()),
                                    ("paid", pa.float64())])
        cogroup_schema = pa.schema([("store", pa.int64()),
                                    ("sold", pa.int64()),
                                    ("returned", pa.int64()),
                                    ("loss", pa.float64())])
        queries += [
            ("map_in_pandas", lambda: summed(sales3().map_in_pandas(
                mod.py_paid_times_quantity_pd, pxq_schema), "v"),
                lambda t: compare(t, want_pxq, 1), 0),
            ("apply_in_pandas", lambda: sales3().group_by(
                "ss_store_sk").apply_in_pandas(mod.py_store_summary,
                                               summary_schema),
                lambda t: compare(t, want_summary, 1), 0),
            ("agg_in_pandas", lambda: sales3().group_by(
                "ss_store_sk").agg_in_pandas(
                ("mean_paid", mod.py_mean, "ss_net_paid"),
                ("max_paid", mod.py_max, "ss_net_paid")),
                lambda t: compare(t, want_agg, 1), 0),
            ("cogroup", lambda: sales3().group_by("ss_store_sk").cogroup(
                session.read_parquet(sr_path).select(
                    col("sr_store_sk"), col("sr_net_loss")).group_by(
                    "sr_store_sk")).apply_in_pandas(
                mod.py_store_cogroup, cogroup_schema),
                lambda t: compare(t, want_cogroup, 1), 0),
            ("transform_in_pandas", lambda: session.read_parquet(
                *ss_paths[:PYTHON_OPAQUE_FILES]).select(
                col("ss_store_sk"), col("ss_net_paid")).group_by(
                "ss_store_sk").transform_in_pandas(
                ("store_mean", mod.py_mean, "ss_net_paid")),
                check_transform, 0),
        ]
    else:
        emit("python_pandas", present=False,
             note="pandas is not installed: the pandas workloads do not "
                  "run")
    records, largest = {}, {}
    for name, make_df, check, n_cpu in queries:
        calls: list = []
        rec = python_run(torch, kernels, name, make_df, check, calls, n_cpu,
                         len(ss_paths))
        records[name] = rec
        emit("python_query", name=name, **rec)
        for call in calls + (cache_calls if name == "udf_compiled"
                             else []):
            key = (signature(call[0]), call[2], call[3])
            if key not in largest or call[1] > largest[key][1]:
                largest[key] = call
    pool = PythonWorkerPool(mod.py_child_facts, max_workers=1)
    try:
        child = pool.run(pa.table({"x": [1]})).to_pylist()[0]
        apps = compute_apps()
    finally:
        pool.close()
    pids = [a.split(",")[0].strip() for a in apps]
    if len(apps) != 1 or str(child["pid"]) in pids \
            or child["cuda_visible"] != "":
        raise AssertionError(f"compute processes while the pool is live: "
                             f"{apps}; the child {child}")
    emit("python", pandas=has_pandas, load_s=load_s, cache_s=cache_s,
         compute_apps=apps, this_pid=os.getpid(), child=child,
         summary={name: {k: r.get(k) for k in (
             "rows", "median_s", "device_busy_s", "device_idle_share",
             "device_kernel_count", "launches", "planned_map_batches",
             "python_batches", "host_copies")}
             for name, r in records.items()})
    k1 = out["cache_sales"]["uncached"]["launches"]["hash_columns"] + sum(
        r["k1"] for r in out["cache_sales"]["runs"])
    return records, k1, list(largest.values())


def python_run(torch, kernels, name: str, make_df, check, calls: list,
               n_cpu: int, n_files: int) -> dict:
    """A python workload's one run, profiled, counted and timed at once
    (``run_query``'s ``single``: a second run would start its worker
    children again, each run of a Python query being cold), K1 checked
    against its plan, and the Python execs' counters
    (``python_metrics``)."""
    kept: dict = {}
    rec = run_query(torch, make_df, kernels, check, calls, scans=False,
                    timed=0, fallback=n_cpu, counted=True, single=True,
                    kept=kept)
    check_launches(name, rec, rec)
    rec.update(python_metrics(kept["plan"], name, n_files))
    return rec


def python_metrics(plan, name: str, n_files: int) -> dict:
    """The counted run's Python exec counters (pythonBatches, the
    device-to-host copies) and, for the opaque UDF, its CPU node's
    transitions; map_in_arrow must make one worker round a file."""
    out = {}
    execs = [n for n in plan.walk() if hasattr(n, "metrics")
             and "pythonBatches" in n.metrics]
    if execs:
        out["python_batches"] = sum(n.metrics["pythonBatches"]
                                    for n in execs)
        out["host_copies"] = sum(n.metrics["hostCopies"] for n in execs)
        if name in ("map_in_arrow", "map_in_pandas") \
                and out["python_batches"] != n_files:
            raise AssertionError(f"{name} made {out['python_batches']} "
                                 f"worker rounds, expected {n_files}")
    nodes = fallback_nodes(plan)
    if nodes:
        (node,) = nodes
        out["transitions"] = {k: node.metrics[k] for k in (
            "toHostRows", "toHostBatches", "toDeviceRows",
            "toDeviceBatches", "cpuTime")}
        out["cpu_node"] = node.node_desc()
        if not out["transitions"]["toHostRows"]:
            raise AssertionError(f"{name}: no row crossed to the CPU node")
    return out


def fallback_detail(make_df, reason: str, collect_exec) -> dict:
    """One more run of a fallback query: its one CPU node's reason and
    transitions."""
    df = make_df()
    text = df.explain()
    if reason not in text:
        raise AssertionError(f"explain() lacks {reason!r}: {text}")
    plan = df.physical_plan()
    collect_exec(plan, df._session.conf)
    (node,) = fallback_nodes(plan)
    moved = {k: node.metrics[k] for k in (
        "toHostRows", "toHostBatches", "toDeviceRows", "toDeviceBatches",
        "cpuTime")}
    if not (moved["toHostRows"] and moved["toDeviceRows"]):
        raise AssertionError(f"{node.node_desc()} moved {moved}")
    return {"reason": reason, "cpu_node": node.node_desc(),
            "transitions": moved}


def ansi_checks(torch, on, off, ansi_query, ss_paths, ticket, qty, col,
                lit, concat_ws, Cast, IntegralDivide, T, max_, count,
                AnsiError) -> dict:
    """The ansi query's rows with the key off (its wall kept), and three
    queries that raise with the key on and wrap or give NULL with it
    off, each against numpy."""
    import numpy as np

    out = {}
    t0 = time.perf_counter()
    off_rows = ansi_query(off).collect()
    torch.cuda.synchronize()
    out["key_off_wall_s"] = time.perf_counter() - t0
    on_rows = ansi_query(on).collect()
    if not on_rows.sort_by("ss_store_sk").equals(
            off_rows.sort_by("ss_store_sk")):
        raise AssertionError("ansi rows differ with the key off")
    suffix = (". If necessary set spark.rapids.tpu.sql.ansi.enabled to "
              "false to bypass this error.")
    cases = {
        "overflow": (lambda s: s.read_parquet(*ss_paths).select(
            (col("ss_ticket_number") * lit(1 << 62)).alias("v")).agg(
            (max_(col("v")), "v")), "long overflow",
            int((ticket * np.int64(1 << 62)).max())),
        "divide_by_zero": (lambda s: s.read_parquet(*ss_paths).select(
            IntegralDivide(col("ss_ticket_number"), col("ss_quantity")
                           - col("ss_quantity")).alias("v")).agg(
            (count(col("v")), "v")), "Division by zero", 0),
        "malformed_cast": (lambda s: s.read_parquet(*ss_paths).select(
            Cast(concat_ws("", lit("x"), Cast(col("ss_ticket_number"),
                                              T.STRING)), T.INT)
            .alias("v")).agg((count(col("v")), "v")),
            "invalid input syntax for type int (ANSI cast)", 0),
    }
    for name, (build, message, want) in cases.items():
        try:
            build(on).collect()
        except AnsiError as exc:
            if str(exc) != message + suffix:
                raise AssertionError(f"{name}: {exc}") from exc
        else:
            raise AssertionError(f"{name} did not raise with ANSI on")
        got = build(off).collect().column("v")[0].as_py()
        if got != want:
            raise AssertionError(f"{name} with ANSI off: {got} != {want}")
        out[name] = {"raised": message, "key_off": got}
    return out


def extra_names_check(names_projection, want: dict) -> int:
    """Every projected column of every customer against Python's str
    methods."""
    got = names_projection().collect().to_pylist()
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} joined customers, {len(want)} "
                             "expected")
    for row in got:
        ref = want[row["c_customer_sk"]]
        for k, v in ref.items():
            if row[k] != v:
                raise AssertionError(f"customer {row['c_customer_sk']} "
                                     f"{k}: {row[k]!r} != {v!r}")
    return len(got)


def sample_projection_check(pa, sample_projection, rand_uniform, ss_paths,
                            sizes) -> dict:
    """The kept rows: unique ids carrying their partition, their file the
    partition's, their rand the recipe at their position; the sample's
    size within 5 standard deviations of SAMPLE_SHARE."""
    import numpy as np

    t = sample_projection().collect()
    ids = t.column("id").to_numpy()
    p = t.column("p").to_numpy().astype(np.int64)
    if len(np.unique(ids)) != len(ids):
        raise AssertionError("sample ids repeat")
    if not (ids >> 33 == p).all():
        raise AssertionError("a sample id does not carry its partition")
    files = t.column("f").to_pylist()
    if any(f != ss_paths[q] for f, q in zip(files, p.tolist())):
        raise AssertionError("a sampled row names another file")
    r = t.column("r").to_numpy()
    pos = ids & ((1 << 33) - 1)
    for q in np.unique(p):
        m = p == q
        want = rand_uniform(SAMPLE_SEED, int(q), pos[m])
        if not np.array_equal(want.view(np.int64), r[m].view(np.int64)):
            raise AssertionError(f"partition {q}: rand differs from the "
                                 "recipe")
    total = sum(sizes)
    sd = (total * SAMPLE_SHARE * (1 - SAMPLE_SHARE)) ** 0.5
    if abs(len(ids) - total * SAMPLE_SHARE) > 5 * sd:
        raise AssertionError(f"sample of {len(ids)} rows from {total}")
    return {"rows": len(ids), "of": total, "sd": sd}


#: the adaptive phase: on / off pairs a workload, in alternating order
#: (3 until the formats phase, 2 until the persist phase needed the
#: run's time)
ADAPTIVE_PAIRS = 1
#: the adaptive key (execs/adaptive.py); checks of a static join shape
#: set it off for their plan, and their sibling runs the default
ADAPTIVE = "spark.rapids.tpu.sql.adaptive.enabled"
ADAPTIVE_METRICS = ("adaptiveBroadcasts", "coalescedPartitions",
                    "skewSplits")


def adaptive_decisions(plan) -> list:
    """Each adaptive join of a plan that ran: its type, decision and
    counters, and its readers' lines and the rows each skew slice
    read."""
    if plan is None:
        return []
    return [{"join_type": n.join_type, "decision": n.decision,
             **{k: n.metrics[k] for k in ADAPTIVE_METRICS},
             "readers": [r.node_desc() for r in n.readers()],
             "slice_rows": [r.slice_rows() for r in n.readers()]}
            for n in plan.walk() if type(n).__name__ == "TpuAdaptiveJoinExec"]


def adaptive_nodes_fresh(name: str, plan) -> list:
    """The plan's adaptive joins, each over two hash exchanges and
    undecided (planning ran no map stage)."""
    nodes = [n for n in plan.walk()
             if type(n).__name__ == "TpuAdaptiveJoinExec"]
    for n in nodes:
        kids = [type(c).__name__ for c in n.children]
        if kids != ["TpuShuffleExchangeExec"] * 2 or \
                n.decision != "undecided" or any(
                    c.metrics["mapBatches"] for c in n.children):
            raise AssertionError(f"{name}: adaptive join over {kids}, "
                                 f"{n.decision} before its run")
    return nodes


def adaptive_sibling(torch, kernels, name: str, make_df, check,
                     want_joins: list, calls: list,
                     must_prune: bool = False) -> dict:
    """The default plan of a workload whose own check pins the static
    join (``ADAPTIVE`` off): its joins as ``want_joins`` (the adaptive
    node named TpuAdaptiveJoinExec, the static plan's build side), each
    adaptive join over two fresh exchanges, one profiled run that is
    counted and timed, the result held by ``check``, K1 as planned,
    and the decisions taken.  ``must_prune``: its runtime filter prunes
    rows (its build side's map stage ran before the probe side's
    scan)."""
    plan = make_df().physical_plan()
    joins = join_strategies(plan)
    if joins != want_joins:
        raise AssertionError(f"{name} joins {joins}, expected {want_joins}")
    if not adaptive_nodes_fresh(name, plan):
        raise AssertionError(f"{name}: no adaptive join under the default")
    kept: dict = {}
    rec = run_query(torch, make_df, kernels, check, calls, scans=False,
                    timed=0, counted=True, single=True, kept=kept)
    check_launches(name, rec, rec)
    decisions = adaptive_decisions(kept["plan"])
    if any(d["decision"] == "undecided" for d in decisions):
        raise AssertionError(f"{name}: {decisions}")
    filtered = [n for n in kept["plan"].walk()
                if getattr(n, "runtime_filters", None)]
    pruned = sum(n.metrics["rfPrunedRows"] for n in filtered)
    if must_prune and not pruned:
        raise AssertionError(f"{name}: its runtime filter pruned nothing")
    return {"joins": joins, "adaptive": decisions, "rf_pruned_rows": pruned,
            **rec}


def exact_pairs(torch, name: str, make_df, sessions: dict, same) -> dict:
    """ADAPTIVE_PAIRS runs of ``make_df(session)`` with the adaptive key
    on and off in alternating order after a warm-up of each: every
    result ``same`` as the first key-on one (``same(a, b)`` raises or
    returns the largest relative float difference); both sides'
    walls."""
    def run(side):
        t0 = time.perf_counter()
        table = make_df(sessions[side]).collect()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, table

    _, want = run("on")
    run("off")
    walls: dict = {"on": [], "off": []}
    worst = 0.0
    for i in range(ADAPTIVE_PAIRS):
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            wall, table = run(side)
            walls[side].append(wall)
            worst = max(worst, same(table, want))
    ladder_quiet(f"adaptive {name}", sessions.values())
    return {"on_wall_s": walls["on"], "off_wall_s": walls["off"],
            "on_median_s": statistics.median(walls["on"]),
            "off_median_s": statistics.median(walls["off"]),
            "on_off_max_rel_diff": worst}


def bit_for_bit(key_cols: list):
    """``same`` for ``exact_pairs``: the rows in key order equal by
    ``pyarrow.Table.equals``."""
    def same(got, want) -> float:
        order = [(k, "ascending") for k in key_cols]
        if not got.sort_by(order).equals(want.sort_by(order)):
            raise AssertionError("a result differs from the first "
                                 "key-on run")
        return 0.0
    return same


def cents(pa, pc, arr):
    """A money column as LONG cents, as the adaptive workloads compute
    them on the card (x * 100 + 0.5, truncated)."""
    return pc.cast(pc.add(pc.multiply(arr, 100.0), 0.5), pa.int64(),
                   safe=False)


def adaptive_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
                   TTB) -> tuple:
    """Adaptive execution on the card, over q3ds's six store_sales files
    and q93's store_returns, no new data.  Each of ``aqe_broadcast``,
    ``aqe_coalesce`` and ``aqe_skew``: the plan (an adaptive join over
    two fresh exchanges, undecided before the run), one profiled run
    that is counted and timed (device busy, idle share, kernel count;
    K1 against the planned map batches), the rows against a pyarrow
    reference made here, the decision and its counters, then
    ADAPTIVE_PAIRS pairs with the adaptive key on and off in
    alternating order, the same rows both ways.  Then ``round_robin``
    (the six files into 8 partitions: balanced within a map batch a
    partition, the rows those of the files, no K1) and
    ``take_ordered`` (TpuTakeOrderedAndProjectExec, 100 rows by
    ss_net_paid descending, two columns: pyarrow's top 100, ties
    free).  Emits an ``adaptive_query`` line a workload, then
    ``adaptive``; returns the records and the hash_columns calls."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.arrow import to_arrow
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.execs.sort import (
        SortKey,
        TpuTakeOrderedAndProjectExec,
    )
    from spark_rapids_tpu_torch.exprs import arithmetic as A
    from spark_rapids_tpu_torch.exprs.cast import Cast
    from spark_rapids_tpu_torch.exprs.predicates import CaseWhen
    from spark_rapids_tpu_torch.ops.partition import RoundRobinPartitioning
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.session import col, count, lit, sum_

    _dd, ss_paths, item_path = star["paths"]
    sr_path, reason_path = star["q93_paths"]
    base = {TTB: Q3DS_TASK_TARGET_BYTES}
    t0 = time.perf_counter()
    reason = pq.read_table(reason_path)
    reason_sk = reason.filter(pc.equal(reason["r_reason_desc"],
                                       tpcds.Q93_REASON))["r_reason_sk"][
        0].as_py()
    sales = pa.concat_tables([pq.read_table(p, columns=[
        "ss_item_sk", "ss_ticket_number", "ss_customer_sk", "ss_quantity",
        "ss_net_paid", "ss_ext_sales_price", "ss_list_price"])
        for p in ss_paths])
    returns = pq.read_table(sr_path, columns=[
        "sr_item_sk", "sr_ticket_number", "sr_reason_sk",
        "sr_return_quantity"])
    item = pq.read_table(item_path, columns=["i_item_sk", "i_category"])
    hot = item["i_item_sk"][0].as_py()

    # aqe_broadcast: the returns of q93's reason, joined on (item,
    # ticket), summed by customer
    kept_returns = returns.filter(pc.equal(returns["sr_reason_sk"],
                                           reason_sk))
    j = sales.join(kept_returns, keys=["ss_item_sk", "ss_ticket_number"],
                   right_keys=["sr_item_sk", "sr_ticket_number"],
                   join_type="inner")
    g = j.group_by(["ss_customer_sk"]).aggregate([
        ("ss_quantity", "sum"), ("sr_return_quantity", "sum"),
        ("ss_item_sk", "count")])
    ref_bcast = {(r["ss_customer_sk"],): {
        "qty": r["ss_quantity_sum"], "returned": r["sr_return_quantity_sum"],
        "n": r["ss_item_sk_count"]} for r in g.to_pylist()}

    # aqe_skew: half the tickets' item made one hot key
    even = pc.fill_null(pc.equal(pc.bit_wise_and(
        sales["ss_ticket_number"], 1), 0), False)
    skewed = pa.table({
        "item_key": pc.if_else(even, pa.scalar(hot, pa.int64()),
                               sales["ss_item_sk"]),
        "paid": cents(pa, pc, sales["ss_net_paid"]),
        "qty": sales["ss_quantity"],
        "ext": cents(pa, pc, sales["ss_ext_sales_price"]),
        "list": cents(pa, pc, sales["ss_list_price"])})
    sj = skewed.join(item, keys=["item_key"], right_keys=["i_item_sk"],
                     join_type="inner")
    g = sj.group_by(["i_category"]).aggregate([
        ("paid", "sum"), ("qty", "sum"), ("ext", "sum"), ("list", "sum"),
        ("item_key", "count")])
    ref_skew = {(r["i_category"],): {
        "paid": r["paid_sum"], "qty": r["qty_sum"], "ext": r["ext_sum"],
        "list": r["list_sum"], "n": r["item_key_count"]}
        for r in g.to_pylist()}
    hot_rows = int(pc.sum(even).as_py())
    ref_s = time.perf_counter() - t0

    def broadcast_df(s):
        rt = s.read_parquet(sr_path).where(
            col("sr_reason_sk").eq(lit(reason_sk))).select(
            col("sr_item_sk"), col("sr_ticket_number"), col("sr_reason_sk"),
            col("sr_return_quantity"))
        return s.read_parquet(*ss_paths).join(
            rt, left_on=[col("ss_item_sk"), col("ss_ticket_number")],
            right_on=[col("sr_item_sk"), col("sr_ticket_number")]).group_by(
            col("ss_customer_sk")).agg(
            (sum_(col("ss_quantity")), "qty"),
            (sum_(col("sr_return_quantity")), "returned"),
            (count(col("ss_item_sk")), "n"))

    def coalesce_df(s):
        return tpcds.q93_dataframe(s, ss_paths, sr_path, reason_path)

    def to_cents(name):
        return Cast(col(name) * lit(100.0) + lit(0.5), T.LONG)

    def skew_df(s):
        key = CaseWhen(((A.Remainder(col("ss_ticket_number"), lit(2)).eq(
            lit(0)), lit(hot)),), col("ss_item_sk"))
        facts = s.read_parquet(*ss_paths).select(
            key.alias("item_key"), to_cents("ss_net_paid").alias("paid"),
            col("ss_quantity"), to_cents("ss_ext_sales_price").alias("ext"),
            to_cents("ss_list_price").alias("list"))
        items = s.read_parquet(item_path).select(col("i_item_sk"),
                                                 col("i_category"))
        return facts.join(items, left_on=[col("item_key")],
                          right_on=[col("i_item_sk")]).group_by(
            col("i_category")).agg(
            (sum_(col("paid")), "paid"), (sum_(col("ss_quantity")), "qty"),
            (sum_(col("ext")), "ext"), (sum_(col("list")), "list"),
            (count(col("item_key")), "n"))

    def q93_same(got, want) -> float:
        return compare_ranked(got, want.to_pylist(), 100,
                              ("ss_customer_sk",), "sumsales", "sumsales")

    skew_keys = {"spark.rapids.tpu.sql.autoBroadcastJoinThresholdBytes": 1}
    adaptive_inner = ["TpuAdaptiveJoinExec", "inner", "right"]
    workloads = (
        ("aqe_broadcast", broadcast_df, {},
         lambda t: compare(t, ref_bcast, 1), bit_for_bit(["ss_customer_sk"]),
         "broadcast[right ", [adaptive_inner]),
        ("aqe_coalesce", coalesce_df, {},
         lambda t: compare_ranked(t, star["q93_ref"], 100,
                                  ("ss_customer_sk",), "sumsales",
                                  "act_sum"), q93_same, "shuffled[",
         [BCAST_RIGHT, ["TpuAdaptiveJoinExec", "left_outer", "right"]]),
        ("aqe_skew", skew_df, skew_keys, lambda t: compare(t, ref_skew, 1),
         bit_for_bit(["i_category"]), "shuffled[skew: ", [adaptive_inner]))
    records, calls = {}, []
    for name, make, keys, check, same, want_decision, want_joins \
            in workloads:
        on = TorchSession({**base, **keys}, device="cuda")
        off = TorchSession({**base, **keys, ADAPTIVE: False}, device="cuda")
        plan = make(on).physical_plan()
        joins = join_strategies(plan)
        if len(adaptive_nodes_fresh(name, plan)) != 1 or joins != want_joins:
            raise AssertionError(f"{name} plans {joins}, expected "
                                 f"{want_joins}")
        if any(type(n).__name__ == "TpuAdaptiveJoinExec"
               for n in make(off).physical_plan().walk()):
            raise AssertionError(f"{name}: an adaptive join with the key off")
        explained = make(on).explain()
        if "strategy=undecided" not in explained:
            raise AssertionError(f"{name}: explain() shows no undecided "
                                 f"adaptive join")
        device_before = on.store.spill_stats()["device_used"]
        kept: dict = {}
        rec = run_query(torch, lambda: make(on), kernels, check, calls,
                        scans=False, timed=0, counted=True, single=True,
                        kept=kept)
        check_launches(name, rec, rec)
        device_after = on.store.spill_stats()["device_used"]
        peak = on.store.spill_stats()["peak_device_used"]
        [dec] = adaptive_decisions(kept["plan"])
        scans = [n for n in kept["plan"].walk()
                 if type(n).__name__ == "ParquetScanExec"]
        pruned = sum(n.metrics["rfPrunedRows"] for n in scans)
        if not dec["decision"].startswith(want_decision):
            raise AssertionError(f"{name} decided {dec}, expected "
                                 f"{want_decision}...")
        groups = None
        if name == "aqe_broadcast":
            if dec["adaptiveBroadcasts"] != 1 or pruned <= 0:
                raise AssertionError(f"{name}: {dec}, rfPrunedRows {pruned}")
            # the blocks and the broadcast build were in the store, and
            # are gone once the query closed
            if device_after != device_before or peak <= device_before:
                raise AssertionError(
                    f"{name}: the store holds {device_after} device bytes "
                    f"after the query, {device_before} before it, "
                    f"{peak} at its peak")
        if name == "aqe_coalesce":
            [node] = [n for n in kept["plan"].walk()
                      if type(n).__name__ == "TpuAdaptiveJoinExec"]
            readers = node.readers()
            groups = len(readers[0].groups) if readers else 8
            if dec["coalescedPartitions"] != 8 - groups:
                raise AssertionError(f"{name}: {dec}, {groups} groups")
        if name == "aqe_skew":
            slices = [r for rows in dec["slice_rows"] for r in rows]
            if dec["skewSplits"] < 2 or not slices or min(slices) <= 0:
                raise AssertionError(f"{name}: {dec}")
            [node] = [n for n in kept["plan"].walk()
                      if type(n).__name__ == "TpuAdaptiveJoinExec"]
            # one map stage a side: a batch a scan task (a file of
            # Q3DS_ROWS_PER_FILE rows, or item), each split once
            for ex in node.children:
                tasks = ex.children[0].num_partitions
                if not ex.metrics["mapBatches"] == \
                        ex.metrics["mapBatchRuns"] == tasks:
                    raise AssertionError(f"{name}: {dict(ex.metrics)} over "
                                         f"{tasks} map tasks")
        pairs = exact_pairs(torch, name, make, {"on": on, "off": off}, same)
        records[name] = {
            "plan": kept["plan"].tree_string().splitlines(),
            **dec, "rf_pruned_rows": pruned,
            "store_device_bytes": [device_before, device_after],
            "store_peak_device_bytes": peak,
            "groups": groups, **pairs, **rec}
        if name == "aqe_skew":
            records[name]["hot_rows"] = hot_rows
        emit("adaptive_query", name=name, **records[name])

    # round_robin: the six files, three columns, dealt into 8 partitions
    s = TorchSession(base, device="cuda")
    cols3 = ["ss_ticket_number", "ss_item_sk", "ss_net_paid"]
    df3 = s.read_parquet(*ss_paths).select(*[col(c) for c in cols3])
    scan = df3.physical_plan()
    k1 = kernels.hash_columns.launches
    t0 = time.perf_counter()
    ex = TpuShuffleExchangeExec(RoundRobinPartitioning(8), scan,
                                s.shuffle_manager,
                                runtime=df3._planner().runtime,
                                batch_rows=1 << 30)
    parts = []
    for p in range(8):
        parts.append(pa.concat_tables(
            [to_arrow(b) for b in ex.execute_partition(p)]
            or [pa.table({c: pa.array([], sales[c].type) for c in cols3})]))
    rr_wall = time.perf_counter() - t0
    ex.close()
    sizes = [t.num_rows for t in parts]
    map_batches = ex.metrics["mapBatches"]
    order = [(c, "ascending") for c in cols3]
    got_rows = pa.concat_tables(parts).sort_by(order)
    want_rows = sales.select(cols3).sort_by(order)
    if kernels.hash_columns.launches != k1:
        raise AssertionError("the round-robin exchange launched K1")
    if max(sizes) - min(sizes) > map_batches or \
            not got_rows.equals(want_rows):
        raise AssertionError(f"round_robin sizes {sizes} over "
                             f"{map_batches} map batches, rows equal "
                             f"{got_rows.equals(want_rows)}")
    records["round_robin"] = {"partition_rows": sizes,
                              "map_batches": map_batches,
                              "wall_s": rr_wall, "k1_launches": 0}
    emit("adaptive_query", name="round_robin", **records["round_robin"])

    # take_ordered: the top 100 by ss_net_paid, two columns projected
    scan = s.read_parquet(*ss_paths).physical_plan()
    top = TpuTakeOrderedAndProjectExec(
        100, [SortKey(col("ss_net_paid"), descending=True, nulls_last=True)],
        scan, project=[col("ss_ticket_number"), col("ss_net_paid")])
    t0 = time.perf_counter()
    got = pa.concat_tables([to_arrow(b) for b in top.execute()])
    torch.cuda.synchronize()
    to_wall = time.perf_counter() - t0
    ranked = sales.select(["ss_ticket_number", "ss_net_paid"]).filter(
        pc.is_valid(sales["ss_net_paid"])).sort_by(
        [("ss_net_paid", "descending")])
    want = ranked.slice(0, 100)
    cut = want["ss_net_paid"][99].as_py()
    inside = sorted((r["ss_ticket_number"], r["ss_net_paid"])
                    for r in got.to_pylist() if r["ss_net_paid"] > cut)
    if got.schema.names != ["ss_ticket_number", "ss_net_paid"] or \
            got["ss_net_paid"].to_pylist() != \
            want["ss_net_paid"].to_pylist() or inside != sorted(
                (r["ss_ticket_number"], r["ss_net_paid"])
                for r in want.to_pylist() if r["ss_net_paid"] > cut):
        raise AssertionError("take_ordered differs from pyarrow's top 100")
    tied = {(r["ss_ticket_number"], r["ss_net_paid"]) for r in
            ranked.filter(pc.equal(ranked["ss_net_paid"], cut)).to_pylist()}
    if any((r["ss_ticket_number"], r["ss_net_paid"]) not in tied
           for r in got.to_pylist() if r["ss_net_paid"] == cut):
        raise AssertionError("take_ordered kept a row tied at the cut "
                             "that the files do not hold")
    records["take_ordered"] = {"rows": got.num_rows, "wall_s": to_wall,
                               "cut": cut}
    emit("adaptive_query", name="take_ordered", **records["take_ordered"])
    emit("adaptive", reference_s=ref_s, reason_sk=reason_sk, hot_item=hot,
         summary={name: {k: r[k] for k in (
             "decision", *ADAPTIVE_METRICS, "on_median_s", "off_median_s",
             "device_busy_s", "device_idle_share", "device_kernel_count",
             "launches", "planned_map_batches")}
             for name, r in records.items() if "decision" in r})
    largest: dict = {}
    for call in calls:
        key = (signature(call[0]), call[2], call[3])
        if key not in largest or call[1] > largest[key][1]:
            largest[key] = call
    return records, list(largest.values())


#: catalog and web texts: timed runs after the warm-up (1 until the
#: types phase came, to keep the run within the 717 s it took before on
#: an H100 80GB HBM3 at 700 W: 0 makes the profiled run the warm-up and
#: times the one counted run after it)
CHANNEL_TIMED_RUNS = 0
#: as SQL_SINGLE_RUN, for the catalog and web texts
CHANNEL_SINGLE_RUN = True
#: q72 joins catalog_sales to inventory on the item before any filter
#: (its WHERE waits above its two outer joins): ~650 inventory rows a
#: sale at SF1, ~940 M pairs through nine more joins.  Its card run and
#: its reference read the first Q72_INVENTORY_ROWS rows of inventory
#: (the text unchanged; 2^19 until the types phase took the run to
#: 736 s, past the 717 s before it, on an H100 80GB HBM3 at 700 W,
#: where q72 took 55 s of it; 2^18 until the persist phase took the run
#: to 989.8 s, where q72 took 29.8 s)
Q72_INVENTORY_ROWS = 1 << 17
#: the exec switches the fallback phase turns off, one at a time
FALLBACK_SWITCHES = ("Filter", "Project", "Aggregate", "Join", "Sort")


def fallback_nodes(plan) -> list:
    return [n for n in plan.walk() if type(n).__name__ == "CpuFallbackExec"]


def reference_q97(pa, pc, pq, tables) -> dict:
    """q97 by pyarrow over the full tables: the year's distinct
    (customer, item) pairs of store_sales and of catalog_sales, and
    their full outer join's three counts (a pair with a NULL customer
    counts in none)."""
    dd = pq.read_table(tables["date_dim"][0],
                       columns=["d_date_sk", "d_month_seq"])
    year = dd.filter(pc.and_(pc.greater_equal(dd["d_month_seq"], 1200),
                             pc.less_equal(dd["d_month_seq"], 1211)))
    sks = year["d_date_sk"]

    def pairs(table, date, cust, item):
        t = pa.concat_tables(pq.read_table(p, columns=[date, cust, item])
                             for p in tables[table])
        t = t.filter(pc.is_in(t[date], value_set=sks))
        t = t.group_by([cust, item]).aggregate([])
        return t.filter(pc.is_valid(t[cust])).rename_columns(["c", "i"])

    ss = pairs("store_sales", "ss_sold_date_sk", "ss_customer_sk",
               "ss_item_sk")
    cs = pairs("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk",
               "cs_item_sk")
    both = ss.join(cs, keys=["c", "i"], join_type="inner").num_rows
    return {(): {"store_only": ss.num_rows - both,
                 "catalog_only": cs.num_rows - both,
                 "store_and_catalog": both}}


def reference_q82(pa, pc, pq, tables, text: str) -> list:
    """q82 (or its variant) by pyarrow over the full tables: the items of
    the text's manufacturers and prices with an inventory row of 100-500
    on hand in its date window and a store sale, by item id; returns
    every such (id, desc, price) row in id order (the text keeps 100)."""
    import datetime as dt
    import re

    m = re.search(r"between (\d+) and \d+ \+ (\d+)", text)
    lo_price = int(m.group(1))
    hi_price = lo_price + int(m.group(2))
    manu = [int(x) for x in re.search(r"i_manufact_id in \(([^)]*)\)",
                                      text).group(1).split(",")]
    first = dt.date.fromisoformat(re.search(r"date '([\d-]+)'",
                                            text).group(1))
    days = int(re.search(r"interval '(\d+)' day", text).group(1))
    item = pq.read_table(tables["item"][0], columns=[
        "i_item_sk", "i_item_id", "i_item_desc", "i_current_price",
        "i_manufact_id"])
    item = item.filter(pc.and_(pc.and_(
        pc.greater_equal(item["i_current_price"], lo_price),
        pc.less_equal(item["i_current_price"], hi_price)),
        pc.is_in(item["i_manufact_id"], value_set=pa.array(manu))))
    dd = pq.read_table(tables["date_dim"][0], columns=["d_date_sk",
                                                       "d_date"])
    lo, hi = (pa.scalar(first, pa.date32()),
              pa.scalar(first + dt.timedelta(days=days), pa.date32()))
    window = dd.filter(pc.and_(pc.greater_equal(dd["d_date"], lo),
                               pc.less_equal(dd["d_date"], hi)))["d_date_sk"]
    stocked = set()
    for p in tables["inventory"]:
        inv = pq.read_table(p, columns=["inv_date_sk", "inv_item_sk",
                                        "inv_quantity_on_hand"])
        q = inv["inv_quantity_on_hand"]
        inv = inv.filter(pc.and_(pc.and_(pc.greater_equal(q, 100),
                                         pc.less_equal(q, 500)),
                                 pc.is_in(inv["inv_date_sk"],
                                          value_set=window)))
        stocked |= set(pc.unique(inv["inv_item_sk"]).to_pylist())
    sold = set()
    for p in tables["store_sales"]:
        sold |= set(pc.unique(pq.read_table(
            p, columns=["ss_item_sk"])["ss_item_sk"]).to_pylist())
    rows = {(r["i_item_id"], r["i_item_desc"], r["i_current_price"])
            for r in item.to_pylist()
            if r["i_item_sk"] in stocked and r["i_item_sk"] in sold}
    return sorted(rows)


def compare_q82(got_table, ref: list) -> float:
    """The card's rows: the first 100 of ``ref`` by item id (rows tied
    on the id at the 100th place may trade places)."""
    got = [(r["i_item_id"], r["i_item_desc"], r["i_current_price"])
           for r in got_table.to_pylist()]
    want_ids = [r[0] for r in ref][:100]
    if [r[0] for r in got] != want_ids or not set(got) <= set(ref):
        raise AssertionError(f"q82: {got[:5]} ... vs {ref[:5]} ...")
    return 0.0


def channels_phase(torch, pa, pc, pq, star, kernels, tpcds, TTB,
                   store_tables: dict) -> tuple:
    """The 29 catalog and web TPC-DS texts as written, through the SQL
    frontend on the card, over the store channel's 13 tables and the 11
    channel tables at SF1's rows (``tpcds.write_channels``): for each
    text its plan's joins and CPU nodes (only q37's date_dim Filter),
    the rows, one profiled run that is also the counted run, timed
    (CHANNEL_SINGLE_RUN), and K1's launches (runs x its plan's map batches,
    folds and range tables).  q97 and q82 are held against pyarrow over
    the full tables; every other text against ``cpu/engine.execute_cpu``
    of its logical plan over the first file of each fact table, with
    the card's run over the same files.  q37's two transitions are
    counted against date_dim's rows and the rows its Filter keeps.  A
    text that gives 0 rows runs its variant too.  Emits the phase's
    line; returns its records and hash_columns calls."""
    from spark_rapids_tpu_torch.cpu.engine import execute_cpu
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.plan.planner import collect_exec
    from spark_rapids_tpu_torch.tpcds_queries import (
        CATALOG_WEB,
        QUERIES,
        VARIANT_EDITS,
        variant,
    )

    t0 = time.perf_counter()
    channel = tpcds.write_channels(os.path.join(star["dir"], "channels"))
    q72_inv = os.path.join(star["dir"], "channels", "inventory-q72.parquet")
    pq.write_table(pq.read_table(channel["inventory"][0]).slice(
        0, Q72_INVENTORY_ROWS), q72_inv)
    gen_s = time.perf_counter() - t0
    tables = {**store_tables, **channel}
    star["channel_tables"], star["q72_inv"] = tables, q72_inv
    facts = ("store_sales", "catalog_sales", "web_sales", "inventory")
    conf = {TTB: Q3DS_TASK_TARGET_BYTES}

    def frontend(device, cut, inventory=None):
        fe = SqlSession(conf, device=device)
        for name, paths in tables.items():
            if name == "inventory" and inventory is not None:
                paths = [inventory]
            elif cut and name in facts:
                paths = paths[:1]
            fe.register_parquet(name, *paths)
        return fe

    card, card_cut = frontend("cuda", False), frontend("cuda", True)
    q72_card = frontend("cuda", False, q72_inv)
    q72_cut = frontend("cuda", True, q72_inv)
    t0 = time.perf_counter()
    ref97 = reference_q97(pa, pc, pq, tables)
    ref_s = time.perf_counter() - t0
    texts = [(f"q{q}", QUERIES[q]) for q in CATALOG_WEB]
    records, largest = {}, {}
    cpu_s = 0.0
    i = 0
    while i < len(texts):
        name, text = texts[i]
        i += 1
        base = name.split("_")[0]
        if name == "q27_variant":  # the state of avg_refs's variant
            text = text.replace("'LA'", f"'{state}'")
        fe, fe_cut = (q72_card, q72_cut) if base == "q72" \
            else (card, card_cut)

        def text_df(text=text, fe=fe):
            return fe.sql(text)

        plan = text_df().physical_plan()
        cpu_nodes = [n.node_desc() for n in fallback_nodes(plan)]
        if base == "q37":
            if len(cpu_nodes) != 1 or not cpu_nodes[0].startswith(
                    "CpuFallbackExec [Filter [") or "d_date" not in \
                    cpu_nodes[0]:
                raise AssertionError(f"{name} plans {cpu_nodes}")
        elif cpu_nodes:
            raise AssertionError(f"{name} plans {cpu_nodes}")
        cut: dict = {}
        if base == "q97":
            check, versus = (lambda t: compare(t, ref97, 0)), \
                "pyarrow over the full tables"
        elif base == "q82":
            t0 = time.perf_counter()
            ref82 = reference_q82(pa, pc, pq, tables, text)
            ref_s += time.perf_counter() - t0
            check, versus = (lambda t, r=ref82: compare_q82(t, r)), \
                "pyarrow over the full tables"
        else:
            t0 = time.perf_counter()
            want = execute_cpu(fe_cut.sql(text)._plan)
            cpu_s += time.perf_counter() - t0
            got = fe_cut.sql(text).collect()
            cut = {"cut_rows": got.num_rows,
                   "cut_max_rel_err": same_result(got, want)}
            check, versus = (lambda t: 0.0), \
                "cpu/engine over the first file of each fact table"
        calls: list = []
        ran: dict = {}
        rec = run_query(torch, text_df, kernels, check, calls, scans=False,
                        timed=CHANNEL_TIMED_RUNS, fallback=len(cpu_nodes),
                        counted=True, single=CHANNEL_SINGLE_RUN, kept=ran)
        check_launches(name, rec, rec)
        if base == "q37":
            plan = text_df().physical_plan()
            collect_exec(plan, fe.session.conf)
            (fb,) = fallback_nodes(plan)
            dd = pq.read_table(tables["date_dim"][0], columns=["d_date"])
            lo = pa.scalar(datetime.date(2000, 2, 1), pa.date32())
            months = 12 if name.endswith("_variant") else 2
            hi = pa.scalar(datetime.date(2000 + (1 + months) // 12,
                                         (1 + months) % 12 + 1, 1),
                           pa.date32())
            kept = pc.sum(pc.and_(pc.greater_equal(dd["d_date"], lo),
                                  pc.less_equal(dd["d_date"], hi))).as_py()
            moved = dict(fb.metrics)
            if (moved["toHostRows"], moved["toDeviceRows"]) != (
                    dd.num_rows, kept):
                raise AssertionError(f"{name} moved {moved}, date_dim has "
                                     f"{dd.num_rows} rows, {kept} kept")
            cut["transitions"] = moved
        records[name] = {"checked_against": versus, **cut,
                         "joins": join_strategies(plan),
                         "adaptive": adaptive_decisions(ran.get("plan")),
                         "cpu_nodes": cpu_nodes,
                         "hash_columns_calls": sorted(
                             {(n, signature(cols), seed, parts)
                              for cols, n, seed, parts in calls}), **rec}
        emit("channel_text", name=name, **{
            k: v for k, v in records[name].items() if k != "device_kernels"})
        for call in calls:
            key = (signature(call[0]), call[2], call[3])
            if key not in largest or call[1] > largest[key][1]:
                largest[key] = call
        if rec["rows"] == 0 and not name.endswith("_variant") \
                and int(name[1:]) in VARIANT_EDITS:
            texts.insert(i, (f"{name}_variant", variant(int(name[1:]))))
    emit("channels", tables={k: [os.path.basename(p) for p in v]
                             for k, v in channel.items()},
         table_rows={k: sum(pq.read_metadata(p).num_rows for p in v)
                     for k, v in channel.items()},
         q72_inventory_rows=Q72_INVENTORY_ROWS, datagen_s=gen_s,
         reference_s=ref_s, cpu_s=cpu_s, summary={
             name: {k: r[k] for k in (
                 "rows", "median_s", "device_busy_s", "device_idle_share",
                 "device_kernel_count", "launches", "checked_against",
                 "cpu_nodes")}
             for name, r in records.items()})
    return records, list(largest.values())


def fallback_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpcds,
                   TTB) -> tuple:
    """q3ds and q93 over one store_sales file with each of
    FALLBACK_SWITCHES off in turn: the rows equal the run with every
    switch on, ``explain()`` marks exactly the nodes of that kind, and
    K1 launches as the plan says.  Then a DataFrame for each point
    where the port raised before it had a CPU engine: a left outer join
    with a residual condition (store_sales and store_returns, counted
    on the card above it), min and max over strings, and a keyless
    left join; each plans its CpuFallbackExec and equals pyarrow.
    Emits the phase's line; returns its records and hash_columns
    calls."""
    from spark_rapids_tpu_torch import col, count, count_star, max_, min_
    from spark_rapids_tpu_torch import sum_
    from spark_rapids_tpu_torch.plan.planner import EXEC_SWITCHES

    dd_path, ss_paths, item_path = star["paths"]
    sr_path, reason_path = star["q93_paths"]
    ss1 = ss_paths[:1]
    switch = {cls.__name__: key for cls, key in EXEC_SWITCHES.items()}
    queries = {
        "q3ds": lambda s: tpcds.q3_dataframe(s, dd_path, ss1, item_path),
        "q93": lambda s: tpcds.q93_dataframe(s, ss1, sr_path, reason_path),
    }
    out, all_calls = {}, []
    for qname, make in queries.items():
        base_session = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES},
                                    device="cuda")
        want = make(base_session).collect()
        for kind in FALLBACK_SWITCHES:
            s = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES,
                              switch[kind]: False}, device="cuda")
            df = make(s)
            lines = [ln.strip() for ln in df.explain().splitlines()
                     if ln.lstrip()[:2] in ("* ", "! ")]
            marked = [ln[2:].split()[0] for ln in lines if ln[0] == "!"]
            of_kind = [ln for ln in lines if ln[2:].split()[0] == kind]
            if not marked or set(marked) != {kind} or \
                    len(marked) != len(of_kind):
                raise AssertionError(f"{qname} with {kind} off marks "
                                     f"{marked}, has {len(of_kind)}")
            calls: list = []
            rec = run_query(torch, lambda s=s: make(s), kernels,
                            lambda t: same_result(t, want), calls,
                            quick=True, fallback=len(marked), counted=True)
            check_launches(f"{qname} {kind} off", rec, rec)
            all_calls += calls
            out[f"{qname}_{kind}_off"] = {"cpu_nodes": len(marked), **rec}

    s = TorchSession({TTB: Q3DS_TASK_TARGET_BYTES}, device="cuda")
    sales = s.read_parquet(*ss1).select(
        col("ss_item_sk"), col("ss_ticket_number"), col("ss_quantity"))
    returns = s.read_parquet(sr_path).select(
        col("sr_item_sk"), col("sr_ticket_number"),
        col("sr_return_quantity"))
    item = s.read_parquet(item_path)
    store = s.read_parquet(star["store_path"])
    reason = s.read_parquet(reason_path)
    ss = pq.read_table(ss1[0], columns=["ss_item_sk", "ss_ticket_number",
                                        "ss_quantity"])
    ss = ss.append_column("row", pa.array(range(ss.num_rows), pa.int64()))
    sr = pq.read_table(sr_path, columns=["sr_item_sk", "sr_ticket_number",
                                         "sr_return_quantity"])
    pairs = ss.join(sr, keys=["ss_item_sk", "ss_ticket_number"],
                    right_keys=["sr_item_sk", "sr_ticket_number"],
                    join_type="inner")
    pairs = pairs.filter(pc.less(pairs["sr_return_quantity"],
                                 pairs["ss_quantity"]))
    matched = pc.count_distinct(pairs["row"]).as_py()
    # each sale no return matches is one NULL-extended row
    ref_outer = {(): {"n": pairs.num_rows + ss.num_rows - matched,
                      "returned": pairs.num_rows,
                      "qty": pc.sum(pairs["sr_return_quantity"]).as_py()}}
    it = pq.read_table(item_path, columns=["i_category", "i_item_desc",
                                           "i_brand"])
    ref_min = it.group_by("i_category").aggregate([
        ("i_item_desc", "min"), ("i_brand", "max")]).rename_columns(
        ["i_category", "lo", "hi"])
    stores = pq.read_table(star["store_path"])["s_store_sk"].to_pylist()
    reasons = pq.read_table(reason_path)["r_reason_sk"].to_pylist()
    ref_keyless = {(sk,): {"n": max(1, sum(r < sk for r in reasons)),
                           "m": sum(r < sk for r in reasons)}
                   for sk in stores}
    former = {
        "left_outer_residual": (
            lambda: sales.join(
                returns, how="left_outer",
                left_on=[col("ss_item_sk"), col("ss_ticket_number")],
                right_on=[col("sr_item_sk"), col("sr_ticket_number")],
                condition=col("sr_return_quantity") < col("ss_quantity"))
            .agg((count_star(), "n"), (count(col("sr_ticket_number")),
                                       "returned"),
                 (sum_(col("sr_return_quantity")), "qty")),
            lambda t: compare(t, ref_outer, 0), "Join"),
        "string_min_max": (
            lambda: item.group_by(col("i_category")).agg(
                (min_(col("i_item_desc")), "lo"),
                (max_(col("i_brand")), "hi")),
            lambda t: same_result(t, ref_min), "Aggregate"),
        "keyless_left": (
            lambda: store.join(reason, how="left_outer",
                               condition=col("s_store_sk")
                               > col("r_reason_sk"))
            .group_by(col("s_store_sk"))
            .agg((count_star(), "n"), (count(col("r_reason_sk")), "m")),
            lambda t: compare(t, ref_keyless, 1), "Join"),
    }
    for name, (make_df, check, kind) in former.items():
        df = make_df()
        marked = [ln.strip()[2:].split()[0] for ln in
                  df.explain().splitlines() if ln.lstrip()[:2] == "! "]
        if marked != [kind]:
            raise AssertionError(f"{name} marks {marked}, not [{kind}]")
        calls: list = []
        rec = run_query(torch, make_df, kernels, check, calls, quick=True,
                        fallback=1)
        all_calls += calls
        out[name] = {"rows": rec["rows"], "wall_s": rec["wall_s"],
                     "launches": rec["launches"],
                     "max_rel_err": rec["max_rel_err"],
                     "reasons": fallback_nodes(df.physical_plan())[0]
                     .reasons}
    emit("fallback", **out)
    return out, all_calls


def concurrency_phase(torch, kernels, TorchSession, SERIAL,
                      queries: dict) -> dict:
    """Each query serially (``config.SERIAL``: one task thread, one
    decode thread, no stages) and pooled (the default keys) in
    alternating pairs after one warm-up of each: every result equal to
    the first serial one by ``pyarrow.Table.equals`` (floats included),
    every run's K1 launches equal, and no stage or pool thread alive
    after any run.  Then one profiled run of each side.  ``queries``:
    name -> (conf, a function of a session giving the DataFrame, the
    pairs to run).  Emits the phase's line."""
    from spark_rapids_tpu_torch.execs.base import live_pool_threads
    from spark_rapids_tpu_torch.parallel.pipeline import live_stage_threads

    from spark_rapids_tpu_torch.execs import retry as R

    R.reset_retry_stats()
    out = {}
    for name, (conf, make, n_pairs) in queries.items():
        sessions = {"serial": TorchSession({**conf, **SERIAL},
                                           device="cuda"),
                    "pooled": TorchSession(conf, device="cuda")}

        def run(side):
            before = (kernels.hash_columns.launches,
                      kernels.hash_string.launches)
            t0 = time.perf_counter()
            table = make(sessions[side]).collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if live_stage_threads() or live_pool_threads():
                raise AssertionError(
                    f"{name} ({side}): {live_stage_threads()} stage and "
                    f"{live_pool_threads()} pool threads outlived collect()")
            return wall, table, (kernels.hash_columns.launches - before[0],
                                 kernels.hash_string.launches - before[1])

        _, want, want_launches = run("serial")
        run("pooled")
        walls: dict = {"serial": [], "pooled": []}
        won = 0
        for i in range(n_pairs):
            order = ("serial", "pooled") if i % 2 == 0 \
                else ("pooled", "serial")
            for side in order:
                wall, table, launches = run(side)
                walls[side].append(wall)
                if not table.equals(want):
                    raise AssertionError(
                        f"{name}: a {side} result differs from the first "
                        f"serial one")
                if launches != want_launches:
                    raise AssertionError(
                        f"{name}: {side} launched {launches}, serial "
                        f"{want_launches}")
            won += walls["pooled"][-1] < walls["serial"][-1]
        ladder_quiet(f"concurrency {name}", sessions.values())
        ran = {side: {"counter": kernels.hash_columns}
               for side in ("serial", "pooled")}
        prof = {side: profiled_run(torch, lambda side=side: make(
            sessions[side]), ran[side]) for side in ("serial", "pooled")}
        decided = {side: adaptive_decisions(ran[side]["plan"])
                   for side in ran}
        if [d["decision"] for d in decided["serial"]] != \
                [d["decision"] for d in decided["pooled"]]:
            raise AssertionError(f"{name}: serial and pooled runs decided "
                                 f"{decided}")
        counts = {side: prof[side].pop("kernel_counts") for side in prof}
        diff = {k: counts["pooled"].get(k, 0) - counts["serial"].get(k, 0)
                for k in set(counts["serial"]) | set(counts["pooled"])}
        diff = sorted(((k[:60], v) for k, v in diff.items() if v),
                      key=lambda kv: -abs(kv[1]))[:10]
        out[name] = {
            "rows": want.num_rows, "pairs": n_pairs,
            "launches_per_run": {"hash_columns": want_launches[0],
                                 "hash_string": want_launches[1]},
            "serial_wall_s": walls["serial"],
            "pooled_wall_s": walls["pooled"],
            "serial_median_s": statistics.median(walls["serial"]),
            "pooled_median_s": statistics.median(walls["pooled"]),
            "pooled_won": won,
            "adaptive": decided["pooled"],
            "serial_profiled": prof["serial"],
            "pooled_profiled": prof["pooled"],
            "kernel_count_pooled_minus_serial": diff}
    emit("concurrency", **out)
    return out


#: the memory phase: the device budget is the query's unconstrained
#: store peak over MEMORY_BUDGET_DIVISOR, the host budget its peak over
#: MEMORY_HOST_DIVISOR
MEMORY_BUDGET_DIVISOR, MEMORY_HOST_DIVISOR = 4, 2
#: the memory phase's q72 reads the first Q72_MEMORY_ROWS inventory
#: rows: under a quarter of its store peak it spills about three times
#: that peak to the host and part of it on to disk, so this cut keeps
#: the phase's time and disk writes small
Q72_MEMORY_ROWS = 1 << 16
#: the forced split's fault schedule
SPLIT_SPEC = "exec.batch:nth=3,times=2"
#: the real-OOM step: its query, and f = (the bytes the allocator holds
#: before it + OOM_SHARE x (its unconstrained peak - the bytes allocated
#: before it)) / the card's memory.  q1's grouped
#: aggregate cannot serve: its peak is the scan's batches, which the
#: ladder cannot cut (an upload fails before any ladder unit)
OOM_QUERY, OOM_SHARE = "q93", 0.8


def exact_rows(got, want) -> None:
    """The same columns and the same multiset of rows, floats bit for
    bit."""
    if got.schema.names != want.schema.names:
        raise AssertionError(f"columns {got.schema.names} vs "
                             f"{want.schema.names}")
    g = sorted(zip(*(c.to_pylist() for c in got.columns)), key=repr)
    w = sorted(zip(*(c.to_pylist() for c in want.columns)), key=repr)
    if g != w:
        bad = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b) \
            if len(g) == len(w) else None
        raise AssertionError(f"{len(g)} rows vs {len(w)}; first difference "
                             f"at {bad}")


def ladder_quiet(where: str, sessions) -> dict:
    """Raise unless the OOM ladder absorbed nothing and none of the
    sessions' stores spilled; their spill stats."""
    from spark_rapids_tpu_torch.execs import retry as R

    st = R.retry_stats()
    if any(st.values()):
        raise AssertionError(f"{where}: the ladder moved {st}")
    out = []
    for s in sessions:
        sp = s.spill_stats()
        if sp["spilled_device_to_host"] or sp["spilled_host_to_disk"]:
            raise AssertionError(f"{where}: a store spilled: {sp}")
        out.append(sp)
    return {"retry_stats": st, "peak_device_used": max(
        (sp["peak_device_used"] for sp in out), default=0)}


def _fresh(torch) -> int:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _timed_collect(torch, df) -> tuple:
    t0 = time.perf_counter()
    table = df.collect()
    torch.cuda.synchronize()
    return table, time.perf_counter() - t0


def fresh_store(keys=None) -> None:
    """Restart the process plugin on the card: a new store, sized from
    ``keys`` (the buffer store is process-wide; a session's memory keys
    size it only when it brings the plugin up)."""
    from spark_rapids_tpu_torch.config import TorchConf
    from spark_rapids_tpu_torch.plugin import TorchPlugin

    TorchPlugin.restart(TorchConf(keys), "cuda")


def spill_step(torch, name: str, make) -> dict:
    """``make(conf)``: the query's DataFrame in a new session with
    those keys over the phase's base keys.  The unconstrained run gets
    a fresh store (its peak is this query's), the constrained one a
    store sized by the budget keys, and a default store follows."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.execs import retry as R

    R.reset_retry_stats()
    fresh_store()
    base = _fresh(torch)
    df = make({})
    want, wall = _timed_collect(torch, df)
    un = {**ladder_quiet(name, [df._session]),
          "max_memory_allocated": torch.cuda.max_memory_allocated() - base,
          "wall_s": wall}
    budget = max(1, un["peak_device_used"] // MEMORY_BUDGET_DIVISOR)
    host = max(1, un["peak_device_used"] // MEMORY_HOST_DIVISOR)
    base = _fresh(torch)
    keys = {C.HBM_BUDGET_BYTES: budget, C.HOST_SPILL_BYTES: host}
    fresh_store(keys)
    df = make(keys)
    got, wall = _timed_collect(torch, df)
    st = df._session.spill_stats()
    leaks = df._session.store.leak_report()
    fresh_store()
    if not (st["spilled_device_to_host"] and st["spilled_host_to_disk"]):
        raise AssertionError(f"{name}: no spill to host and disk: {st}")
    if leaks:
        raise AssertionError(f"{name}: {len(leaks)} entries left: {leaks[:3]}")
    if any(R.retry_stats().values()):
        raise AssertionError(f"{name}: the ladder moved {R.retry_stats()}")
    exact_rows(got, want)
    return {"rows": got.num_rows, "unconstrained": un,
            "device_budget": budget, "host_budget": host,
            "spill_stats": st, "spill_s": st["spill_ns"] / 1e9,
            "restore_s": st["restore_ns"] / 1e9,
            "max_memory_allocated": torch.cuda.max_memory_allocated() - base,
            "wall_s": wall, "leak_report": leaks,
            "equal_to_unconstrained": "bit for bit"}


def split_step(torch, kernels, name: str, make, want) -> dict:
    """The query serially under SPLIT_SPEC, counted (``counted_run``)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.execs import retry as R
    from spark_rapids_tpu_torch.robustness import faults

    R.reset_retry_stats()
    kernels.hash_columns.launches = 0
    kernels.hash_string.launches = 0
    conf = {**C.SERIAL, C.FAULTS_ENABLED: True, C.FAULTS_SPEC: SPLIT_SPEC}
    t0 = time.perf_counter()
    got, planned = counted_run(lambda: make(conf), kernels.hash_columns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"hash_columns": kernels.hash_columns.launches,
                "hash_string": kernels.hash_string.launches}
    st = R.retry_stats()
    if st["splits"] < 1 or st["task_retries"]:
        raise AssertionError(f"{name}: {st} under {SPLIT_SPEC}")
    expect = planned["per_run"] + planned["ladder_reruns"]
    if launches != {"hash_columns": expect, "hash_string": 0}:
        raise AssertionError(f"{name}: K1 launched {launches}, expected "
                             f"{expect} ({planned})")
    if faults.fault_stats():
        raise AssertionError("the schedule outlived its query")
    return {"rows": got.num_rows, "retry_stats": st, "launches": launches,
            **planned, "wall_s": wall,
            "max_rel_err": same_result(got, want)}


def oom_step(torch, name: str, make) -> dict:
    """The query serially, unconstrained, then under a per-process
    memory fraction below its peak: it must end through the ladder with
    at least one allocator OOM absorbed."""
    from spark_rapids_tpu_torch.config import SERIAL
    from spark_rapids_tpu_torch.execs import retry as R

    R.reset_retry_stats()
    base = _fresh(torch)
    # the fraction caps the allocator's reserved bytes; the earlier
    # phases' live tensors hold segments that empty_cache cannot return
    held = torch.cuda.memory_reserved()
    want, wall = _timed_collect(torch, make(SERIAL))
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    frac = (held + OOM_SHARE * (peak - base)) / total
    _fresh(torch)
    try:
        torch.cuda.set_per_process_memory_fraction(frac)
        got, oom_wall = _timed_collect(torch, make(SERIAL))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    st = R.retry_stats()
    if st["device_ooms"] < 1:
        raise AssertionError(f"{name}: no OOM under fraction {frac}: {st}")
    return {"query": name, "fraction": frac, "oom_share": OOM_SHARE,
            "baseline_bytes": base, "baseline_reserved_bytes": held,
            "unconstrained_peak_bytes": peak,
            "card_bytes": total, "retry_stats": st,
            "unconstrained_wall_s": wall, "wall_s": oom_wall,
            "rows": got.num_rows, "max_rel_err": same_result(got, want)}


def oom_in_child(TTB, paths: tuple) -> dict:
    """``oom_step`` for OOM_QUERY in a new process on the same card: the
    earlier phases' live tensors (the calls the ``main`` phase re-times)
    leave the allocator's segments in a layout no fraction can be set
    against, so the step starts from a fresh one.  Its record."""
    cmd = [sys.executable, os.path.abspath(__file__), "--oom-step",
           json.dumps({"ttb": TTB, "paths": paths})]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the OOM step failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def oom_child(arg: str) -> int:
    """The child of ``oom_in_child``: OOM_QUERY's step; its record as
    the last line of standard output."""
    import torch

    sys.path.insert(0, ROOT)
    from spark_rapids_tpu_torch import TorchSession, tpcds, tpch
    from spark_rapids_tpu_torch.ops import kernels

    spec = json.loads(arg)
    kernels.load_library("hash_string")
    paths = spec["paths"]

    def make(conf):
        if OOM_QUERY == "q93":
            return tpcds.q93_dataframe(TorchSession(
                {spec["ttb"]: Q3DS_TASK_TARGET_BYTES, **conf},
                device="cuda"), *paths)
        return tpch.q1_dataframe(TorchSession(
            {spec["ttb"]: TASK_TARGET_BYTES, **conf}, device="cuda"),
            paths[0])

    print(json.dumps(oom_step(torch, OOM_QUERY, make)), flush=True)
    return 0


def ooc_sort_step(torch, pa, pc, pq, TorchSession, paths, TTB) -> dict:
    """ORDER BY every lineitem column (a total order up to identical
    rows), no LIMIT, range exchange off: the global sort of 6 x 2^20
    rows goes out of core.  Rows equal to pyarrow's order."""
    from spark_rapids_tpu_torch import col
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.execs.sort import TpuSortExec
    from spark_rapids_tpu_torch.plan.planner import collect_exec

    fresh_store()  # its spill stats are its own
    s = TorchSession({TTB: TASK_TARGET_BYTES,
                      C.SORT_RANGE_EXCHANGE: False}, device="cuda")
    table = pa.concat_tables([pq.read_table(p) for p in paths])
    keys = table.schema.names
    plan = s.read_parquet(*paths).order_by(
        *[col(k) for k in keys]).physical_plan()
    [sort] = [n for n in plan.walk() if isinstance(n, TpuSortExec)]
    if sort.scope != "global" or table.num_rows <= sort.single_batch_rows:
        raise AssertionError(f"sort {sort.node_desc()} over "
                             f"{table.num_rows} rows is not out of core")
    _fresh(torch)
    t0 = time.perf_counter()
    got = collect_exec(plan, s.conf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the generated columns hold no NULL, so NULL placement is moot
    want = table.take(pc.sort_indices(table, [(k, "ascending")
                                              for k in keys]))
    ref_s = time.perf_counter() - t0
    want = want.select(got.schema.names).cast(got.schema)
    if not got.equals(want):
        bad = [n for n in got.schema.names
               if not got.column(n).equals(want.column(n))]
        raise AssertionError(f"out-of-core sort differs from pyarrow in "
                             f"{bad}")
    if s.store.leak_report():
        raise AssertionError("the sort left store entries")
    spill = s.spill_stats()
    m = dict(sort.metrics)
    if m["oocRows"] != table.num_rows or m["hostRows"] != table.num_rows:
        raise AssertionError(f"sort metrics {m}")
    return {"rows": got.num_rows, "keys": keys, **m, "wall_s": wall,
            "reference_s": ref_s, "spill_stats": spill,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def memory_phase(torch, pa, pc, pq, star, kernels, TorchSession, tpch,
                 tpcds, TTB, li_paths) -> dict:
    """Spill, forced split, real OOM and the out-of-core sort (module
    docstring).  Emits the phase's line."""
    from spark_rapids_tpu_torch.execs import retry as R
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.tpcds_queries import QUERIES

    t_phase = time.perf_counter()
    quiet = ladder_quiet("the earlier phases", [])
    dd_path, ss_paths, item_path = star["paths"]
    sr_path, reason_path = star["q93_paths"]
    ds8 = {TTB: Q3DS_TASK_TARGET_BYTES}

    def q93(conf):
        return tpcds.q93_dataframe(TorchSession({**ds8, **conf},
                                                device="cuda"),
                                   ss_paths, sr_path, reason_path)

    def q67r(conf):
        return tpcds.q67_rollup_dataframe(
            TorchSession({**ds8, **conf}, device="cuda"), dd_path,
            ss_paths, item_path, star["store_path"])

    q72_inv = os.path.join(star["dir"], "channels", "inventory-mem.parquet")
    pq.write_table(pq.read_table(star["q72_inv"]).slice(
        0, Q72_MEMORY_ROWS), q72_inv)

    def q72(conf):
        fe = SqlSession({**ds8, **conf}, device="cuda")
        for tname, tpaths in star["channel_tables"].items():
            fe.register_parquet(tname, *([q72_inv] if tname == "inventory"
                                         else tpaths))
        return fe.sql(QUERIES[72])

    def q1_agg(conf):
        return tpch.q1_dataframe(TorchSession(
            {TTB: TASK_TARGET_BYTES, **conf}, device="cuda"), li_paths)

    spill = {}
    for name, make in (("q93", q93), ("q67_rollup", q67r), ("q72", q72)):
        spill[name] = spill_step(torch, name, make)
        emit("memory_spill", query=name, **spill[name])
    split = {}
    for name, make in (("q93", q93), ("q1_agg", q1_agg)):
        want = make({}).collect()
        split[name] = split_step(torch, kernels, name, make, want)
        emit("memory_split", query=name, **split[name])
    oom = oom_in_child(TTB, {"q93": (ss_paths, sr_path, reason_path),
                             "q1_agg": (li_paths,)}[OOM_QUERY])
    emit("memory_oom", **oom)
    ooc = ooc_sort_step(torch, pa, pc, pq, TorchSession, li_paths, TTB)
    emit("memory_ooc_sort", **ooc)
    R.reset_retry_stats()
    # the split steps' spill retries and the sort moved the store's
    # counters, which the later phases hold at zero
    fresh_store()
    out = {"earlier_phases": quiet, "spill": {
        k: {f: v[f] for f in ("device_budget", "host_budget", "spill_stats",
                              "max_memory_allocated", "wall_s")}
        for k, v in spill.items()},
        "split": {k: {f: v[f] for f in ("retry_stats", "launches",
                                        "ladder_reruns", "max_rel_err")}
                  for k, v in split.items()},
        "oom": oom, "ooc_sort": {k: ooc[k] for k in (
            "rows", "sortBuckets", "hostRows", "wall_s")},
        "seconds": time.perf_counter() - t_phase}
    emit("memory", **out)
    return out


#: the serving phase's templates: the port's TPC-DS texts with their
#: constants made parameters, and two bindings each (the text's own
#: constants first)
SERVING_TEMPLATES = {
    "q3": (3, (("item.i_manufact_id = 128", "item.i_manufact_id = :manufact"),
               ("dt.d_moy = 11", "dt.d_moy = :moy")),
           ({"manufact": 128, "moy": 11}, {"manufact": 128, "moy": 12})),
    "q42": (42, (("item.i_manager_id = 1", "item.i_manager_id = :manager"),
                 ("dt.d_moy = 11", "dt.d_moy = :moy"),
                 ("dt.d_year = 2000", "dt.d_year = :year")),
            ({"manager": 1, "moy": 11, "year": 2000},
             {"manager": 1, "moy": 12, "year": 2001})),
    "q52": (52, (("item.i_manager_id = 1", "item.i_manager_id = :manager"),
                 ("dt.d_moy = 11", "dt.d_moy = :moy"),
                 ("dt.d_year = 2000", "dt.d_year = :year")),
            ({"manager": 1, "moy": 11, "year": 2000},
             {"manager": 1, "moy": 12, "year": 1999})),
    "q55": (55, (("i_manager_id = 28", "i_manager_id = :manager"),
                 ("d_moy = 11", "d_moy = :moy"),
                 ("d_year = 1999", "d_year = :year")),
            ({"manager": 28, "moy": 11, "year": 1999},
             {"manager": 28, "moy": 12, "year": 2000})),
}
SERVING_SESSIONS = 8
#: (tenant, priority) of session i: i % 2
SERVING_TENANTS = (("t0", 1), ("t1", 4))
SERVING_MAX_CONCURRENT = 2
SERVING_QUEUE_DEPTH = 40


def serving_texts(QUERIES) -> dict:
    """name -> (the template, its bindings, the text of each binding
    with the literals written in)."""
    out = {}
    for name, (q, subs, bindings) in SERVING_TEMPLATES.items():
        template = QUERIES[q]
        for lit_, param in subs:
            if template.count(lit_) != 1:
                raise AssertionError(f"{name}: {lit_!r} is not in the text "
                                     "once")
            template = template.replace(lit_, param)
        literal = []
        for b in bindings:
            text = template
            for k, v in b.items():
                text = text.replace(f":{k}", str(v))
            literal.append(text)
        out[name] = (template, bindings, literal)
    return out


def serving_phase(torch, pa, kernels, TTB, tables) -> dict:
    """8 sessions on the card in 8 threads over 2 tenants (t0 at
    priority 1, t1 at 4), admission at 2 queries at once and a queue of
    40: each pair of sessions (one of each tenant) prepares one of q3 /
    q42 / q52 / q55 through ``SqlSession.prepare`` and executes it 4
    times (2 bindings, each twice).  Checked: every result equals, bit for bit, a serial
    uncached collect of the text with the literals written in; every
    repeat is a plan-cache hit that enters ``plan_query`` 0 times; a
    stream equals its collect; q93, cancelled from another thread when
    its first map task parks a block, raises QueryCancelled before its
    map tasks have all committed and leaves the store at its bytes, 0
    running, every permit free and no stage or pool thread, and its
    cached tree then drains to the serial result; a second tenant's
    first execution of a text the first tenant ran is a result-cache
    hit, and two tenants running a text at once with no result cache
    share dimension scans (``scan_subscribes``), all with equal
    digests.  Emits the phase's line and returns (its record, K1
    launches)."""
    from spark_rapids_tpu_torch.eventlog import table_digest
    from spark_rapids_tpu_torch.execs.base import live_pool_threads
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.parallel.pipeline import live_stage_threads
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
    from spark_rapids_tpu_torch.plan import planner as planner_mod
    from spark_rapids_tpu_torch.serving import cancel as K
    from spark_rapids_tpu_torch.serving import plan_cache, scheduler
    from spark_rapids_tpu_torch.serving import work_share
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.tpcds_queries import QUERIES

    t_phase = time.perf_counter()
    base = {TTB: Q3DS_TASK_TARGET_BYTES}
    serve = {**base, C.SERVING_MAX_CONCURRENT: SERVING_MAX_CONCURRENT,
             C.SERVING_QUEUE_DEPTH: SERVING_QUEUE_DEPTH}

    def frontend(conf, **kw):
        fe = SqlSession(conf, device="cuda", **kw)
        for name, paths in tables.items():
            fe.register_parquet(name, *paths)
        return fe

    texts = serving_texts(QUERIES)
    # the references: each binding's text with its literals, collected
    # alone by a session outside the serving tier
    ref_fe = frontend(base)
    t0 = time.perf_counter()
    want, ref_rows = {}, {}
    for name, (_t, _b, lits) in texts.items():
        for i, lit_ in enumerate(lits):
            ref = ref_fe.sql(lit_).collect()
            want[(name, i)] = table_digest(ref)
            ref_rows[(name, i)] = ref.num_rows
    ref_s = time.perf_counter() - t0

    calls: dict = {}
    calls_lock = threading.Lock()
    original = planner_mod.plan_query

    def counting(*a, **kw):
        with calls_lock:
            key = threading.get_ident()
            calls[key] = calls.get(key, 0) + 1
        return original(*a, **kw)

    names = list(texts)

    def template_of(i: int) -> str:
        # sessions 2k and 2k + 1 run one template, one for each tenant
        return names[(i // 2) % len(names)]

    fes = [frontend(serve, tenant=SERVING_TENANTS[i % 2][0],
                    priority=SERVING_TENANTS[i % 2][1])
           for i in range(SERVING_SESSIONS)]
    prepared = [fe.prepare(texts[template_of(i)][0])
                for i, fe in enumerate(fes)]
    records: list = []
    errors: list = []
    start = threading.Barrier(SERVING_SESSIONS)

    def run(i: int) -> None:
        name = template_of(i)
        bindings = texts[name][1]
        try:
            start.wait()
            for j, b in enumerate((0, 0, 1, 1)):
                with calls_lock:
                    before = calls.get(threading.get_ident(), 0)
                t0 = time.perf_counter()
                got = prepared[i].execute(params=bindings[b])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                with calls_lock:
                    entered = calls.get(threading.get_ident(), 0) - before
                records.append({"session": i, "template": name,
                                "tenant": SERVING_TENANTS[i % 2][0],
                                "binding": b, "repeat": j % 2,
                                "wall_s": wall, "plan_query": entered,
                                "rows": got.num_rows,
                                "equal": table_digest(got) == want[
                                    (name, b)]})
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append((i, repr(e)))

    scheduler.reset()
    plan_cache.reset_stats()
    kernels.hash_columns.launches = 0
    kernels.hash_string.launches = 0
    planner_mod.plan_query = counting
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(SERVING_SESSIONS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
    finally:
        planner_mod.plan_query = original
    launches = {"hash_columns": kernels.hash_columns.launches,
                "hash_string": kernels.hash_string.launches}
    sched = scheduler.scheduler_stats()
    tenant_waits = scheduler.tenant_wait_stats()
    cache = plan_cache.stats()
    if errors:
        raise AssertionError(f"serving sessions failed: {errors}")
    bad = [r for r in records if not r["equal"]]
    if bad:
        raise AssertionError(f"results differ from the serial collect: "
                             f"{bad}")
    wrong = [r for r in records if r["plan_query"] != (0 if r["repeat"]
                                                       else 1)]
    if wrong or cache["hits"] != len(records) // 2:
        raise AssertionError(f"plan cache: {cache}, plan_query entries "
                             f"{wrong}")
    if sched["admitted"] != len(records) or sched["running"] \
            or sched["rejected"]:
        raise AssertionError(f"scheduler {sched}")
    if launches["hash_columns"] < 1:
        raise AssertionError(f"the served queries launched no K1: "
                             f"{launches}")
    def pct(q, rs=records):
        walls = sorted(r["wall_s"] for r in rs)
        return walls[min(len(walls) - 1, int(round(q * (len(walls) - 1))))]

    # streaming: one template's stream equals its collect
    pq0 = prepared[0]
    b0 = texts[template_of(0)][1][0]
    streamed = pa.Table.from_batches(list(pq0.execute_stream(params=b0)))
    collected = pq0.execute(params=b0)
    if table_digest(streamed.cast(collected.schema)) != table_digest(
            collected) or streamed.schema != collected.schema:
        raise AssertionError("execute_stream differs from collect")

    # cancellation: q93 cancelled from another thread while its first
    # map stage runs, at the first block a map task parks; the query
    # must raise before its map tasks have all committed
    store = fes[0].session.store
    before = (store.spill_stats()["device_used"],
              store.spill_stats()["host_used"], len(store.leak_report()))
    q93_fe = frontend(serve, tenant="t0")
    q93 = q93_fe.prepare(QUERIES[93])
    map_tasks = sum(n.children[0].num_partitions
                    for n in q93_fe.sql(QUERIES[93]).physical_plan().walk()
                    if isinstance(n, TpuShuffleExchangeExec))
    parked = threading.Event()
    commits = [0]
    park, commit = TpuShuffleExchangeExec._park, ShuffleManager.commit_task

    def parking(self, *a):
        park(self, *a)
        parked.set()

    def committing(self, *a):
        with calls_lock:
            commits[0] += 1
        commit(self, *a)

    def canceller():
        if parked.wait(120):
            q93_fe.session.cancel()

    TpuShuffleExchangeExec._park = parking
    ShuffleManager.commit_task = committing
    th = threading.Thread(target=canceller)
    t0 = time.perf_counter()
    try:
        th.start()
        try:
            q93.execute()
            raise AssertionError("the cancelled q93 ran to its end")
        except K.QueryCancelled as e:
            reason = e.reason
        unwind_s = time.perf_counter() - t0
    finally:
        TpuShuffleExchangeExec._park = park
        ShuffleManager.commit_task = commit
        parked.set()
        th.join()
    committed = commits[0]
    after = (store.spill_stats()["device_used"],
             store.spill_stats()["host_used"], len(store.leak_report()))
    sched_after = scheduler.scheduler_stats()
    usage = TpuSemaphore.get().usage()
    threads = (live_stage_threads(), live_pool_threads())
    if reason != "cancelled" or after != before or sched_after["running"] \
            or usage["in_use"] or any(threads) \
            or not 0 <= committed < map_tasks:
        raise AssertionError(f"q93 cancel: {reason}, {committed} of "
                             f"{map_tasks} map tasks committed, store "
                             f"{before} -> {after}, scheduler {sched_after}, "
                             f"semaphore {usage}, threads {threads}")
    # the cancelled tree drains again, to the serial collect's result
    again = table_digest(q93.execute())
    if again != table_digest(ref_fe.sql(QUERIES[93]).collect()):
        raise AssertionError("q93 after its cancel differs from a serial "
                             "collect")
    cancel = {"map_tasks": map_tasks, "committed_at_raise": committed,
              "reason": reason, "unwind_s": unwind_s,
              "store_before": before, "store_after": after,
              "running": sched_after["running"], "semaphore": usage,
              "redrain_equal": True}

    # work sharing across tenants, with the result cache: t0 executes
    # the text and stores its result; t1's first execution of it is then
    # a hit.  Shared scans: both tenants at once with the other binding
    # and a result cache of 0 bytes, so neither is served a result and
    # the dimension scans are shared (store_sales carries runtime
    # filters, which never share)
    work_share.reset()
    share = {**serve, C.SHARING_ENABLED: True}
    name = names[1]
    text, bindings, _lits = texts[name]
    first = [frontend(share, tenant=t, priority=p).prepare(text)
             for t, p in SERVING_TENANTS]
    d0 = table_digest(first[0].execute(params=bindings[0]))
    stored = work_share.stats()
    d1 = table_digest(first[1].execute(params=bindings[0]))
    ws_hit = work_share.stats()
    cross_hits = ws_hit["result_hits"] - stored["result_hits"]
    if stored["result_hits"] or cross_hits != 1 \
            or {d0, d1} != {want[(name, 0)]}:
        raise AssertionError(f"cross-tenant result hit: {stored} -> "
                             f"{ws_hit}, digests {d0} {d1}")
    scans = {**share, C.RESULT_CACHE_BUDGET: 0}
    pair = [frontend(scans, tenant=t, priority=p).prepare(text)
            for t, p in SERVING_TENANTS]
    shared: dict = {}
    go = threading.Barrier(2)

    def tenant_run(i: int) -> None:
        try:
            go.wait()
            shared[i] = table_digest(pair[i].execute(params=bindings[1]))
        except BaseException as e:  # noqa: BLE001 - raised below
            shared[i] = repr(e)

    ths = [threading.Thread(target=tenant_run, args=(i,)) for i in (0, 1)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    ws = work_share.stats()
    subscribes = ws["scan_subscribes"] - ws_hit["scan_subscribes"]
    if subscribes < 1 or ws["result_hits"] != ws_hit["result_hits"] \
            or set(shared.values()) != {want[(name, 1)]}:
        raise AssertionError(f"shared scans: {ws_hit} -> {ws}, digests "
                             f"{shared}")
    work_share.reset()
    out = {
        "sessions": SERVING_SESSIONS, "tenants": dict(SERVING_TENANTS),
        "max_concurrent": SERVING_MAX_CONCURRENT,
        "queue_depth": SERVING_QUEUE_DEPTH,
        "executions": len(records), "wall_s": wall,
        "qps": len(records) / wall, "p50_ms": pct(0.5) * 1e3,
        "p99_ms": pct(0.99) * 1e3,
        "tenant_ms": {t: {q: pct(v, [r for r in records
                                     if r["tenant"] == t]) * 1e3
                          for q, v in (("p50", 0.5), ("p99", 0.99))}
                      for t, _p in SERVING_TENANTS},
        "admission_wait_p50_ms": sched["wait_p50_ms"],
        "admission_wait_p99_ms": sched["wait_p99_ms"],
        "tenant_admission": tenant_waits,
        "plan_cache": cache, "plan_cache_hit_rate": cache["hit_rate"],
        "k1_launches": launches,
        "rows": {f"{n}[{b}]": r for (n, b), r in ref_rows.items()},
        "miss_p50_ms": statistics.median(
            r["wall_s"] for r in records if not r["repeat"]) * 1e3,
        "hit_p50_ms": statistics.median(
            r["wall_s"] for r in records if r["repeat"]) * 1e3,
        "reference_s": ref_s, "stream_equals_collect": True,
        "cancel": cancel, "sharing": {
            "cross_tenant_result_hits": cross_hits,
            "pair_scan_subscribes": subscribes,
            **{k: ws[k] for k in ("result_hits", "result_misses",
                                  "scan_subscribes", "scan_units_shared")}},
        "nvidia_smi": nvidia_smi(),
        "seconds": time.perf_counter() - t_phase}
    emit("serving", **out)
    return out, launches


#: the sweep slice of the persist phase: three texts of its wire subset
PERSIST_SWEEP = (3, 42, 52)

#: the script the persist phase runs under tools.trace
PERSIST_TRACE_SCRIPT = r"""
import sys
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.tools import cold_start as cs
data, device = sys.argv[1:3]
s = TorchSession(cs.fixture_conf(None, "plan"), device=device)
assert cs.fixture_query(s, cs.fixture_paths(data)).collect().num_rows == 4
"""


def fixture_reference(pa, pc, pq, paths) -> list:
    """The cold-start fixture's query in pyarrow: rows of (l_key,
    sum_qty, sum_price, n) by key."""
    t = pa.concat_tables([pq.read_table(p) for p in paths])
    t = t.filter(pc.less_equal(t["l_shipdate"], 10471))
    g = t.group_by("l_key").aggregate([("l_quantity", "sum"),
                                       ("l_price", "sum"),
                                       ("l_key", "count")])
    return sorted((r["l_key"], r["l_quantity_sum"], r["l_price_sum"],
                   r["l_key_count"]) for r in g.to_pylist())


def persist_phase(torch, pa, pc, pq, kernels, TorchSession, tpch, TTB,
                  star, li_paths, orders_path, ref3, sql_records,
                  channel_records, device="cuda") -> tuple:
    """The warm-start store and the operator tools (the module
    docstring's ``persist``).  Emits the phase's line; returns its
    record and its K1 launches (this process's and the children's)."""
    from spark_rapids_tpu_torch import obs, persist
    from spark_rapids_tpu_torch import trace as tracer
    from spark_rapids_tpu_torch.eventlog import table_digest
    from spark_rapids_tpu_torch.frontends.sql import SqlSession
    from spark_rapids_tpu_torch.tools import api_validation
    from spark_rapids_tpu_torch.tools import cold_start as cs
    from spark_rapids_tpu_torch.tools import qualification, sweep
    from spark_rapids_tpu_torch.tools import trace as trace_tool
    from spark_rapids_tpu_torch.tpcds_queries import (
        CATALOG_WEB,
        QUERIES,
        STORE_CHANNEL,
    )
    from spark_rapids_tpu_torch.trace import ledger

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    counter = kernels.hash_columns
    k1_before = counter.launches
    root = os.path.join(star["dir"], "persist")
    data, store = os.path.join(root, "data"), os.path.join(root, "store")
    os.makedirs(data)
    paths = cs.make_fixture(data)

    # the fixture in this process, against pyarrow
    want = fixture_reference(pa, pc, pq, paths)
    here = cs.fixture_query(TorchSession(cs.fixture_conf(None, "plan"),
                                         device=device), paths).collect()
    sync()
    if sorted(tuple(r.values()) for r in here.to_pylist()) != want:
        raise AssertionError(f"the fixture gave {here.to_pylist()}, "
                             f"pyarrow {want}")

    # the cold processes, one after another; between the third and the
    # fourth, this process writes the result tier (the fixture prepared
    # with sharing on), so that the fourth restores it
    if device == "cuda":
        torch.cuda.empty_cache()
    children = {}
    for name, where, mode in (("off", None, "plan"), ("empty", store, "plan"),
                              ("warm", store, "plan"),
                              ("result_restore", store, "result")):
        if name == "result_restore":
            written = cs.run_once(data, store, mode="result", device=device)
            ledger.disable()
            ledger.reset_stats()
            persist.reset_for_tests()
        t0 = time.perf_counter()
        rec = cs.run_subprocess(data, where, mode=mode, device=device,
                                timeout=300)
        rec["process_s"] = time.perf_counter() - t0
        children[name] = rec
    off, empty, warm = children["off"], children["empty"], children["warm"]
    restore = children["result_restore"]
    runs = [*children.values(), written]
    if {r["digest"] for r in runs} != {table_digest(here)} \
            or {r["rows"] for r in runs} != {len(want)}:
        raise AssertionError(f"children's results differ: {children}")
    same = ("dispatches", "k1_dispatches", "k1_launches")
    if not [off[k] for k in same] == [empty[k] for k in same] \
            == [warm[k] for k in same] == [written[k] for k in same]:
        raise AssertionError(f"children dispatch differently: {children}, "
                             f"the result tier's writer {written}")
    want_k1 = cs.FIXTURE_FILES if device == "cuda" else 0
    if off["k1_launches"] != want_k1 or off["k1_dispatches"] \
            != cs.FIXTURE_FILES:
        raise AssertionError(f"the fixture launched {off['k1_launches']} "
                             f"K1, {cs.FIXTURE_FILES} map batches")
    if {r["compiles"] for r in children.values()} != {0}:
        raise AssertionError(f"a child built a kernel: {children}")
    if (warm["persist"]["plan_hits"], warm["prepares"]) != (1, 2) \
            or empty["persist"]["plan_hits"] != 0:
        raise AssertionError(f"the plan tier: empty {empty['persist']}, "
                             f"warm {warm['persist']}")
    if written["persist"]["result_writes"] != 1:
        raise AssertionError(f"the result tier's writer: {written}")
    if (restore["result_hits"], restore["persist"]["result_hits"],
            restore["dispatches"], restore["k1_launches"],
            restore["persist"]["errors"]) != (1, 1, 0, 0, 0):
        raise AssertionError(f"the result tier's restore: {restore}")
    child_k1 = sum(r["k1_launches"] for r in children.values())

    # qualify over the 51 texts, held against the phases' CPU nodes
    fe = SqlSession({TTB: Q3DS_TASK_TARGET_BYTES}, device=device)
    for name, tpaths in star["channel_tables"].items():
        fe.register_parquet(name, *tpaths)
    subquery = "expression ScalarSubquery is not supported on the GPU"
    qualified = {}
    t0 = time.perf_counter()
    for q in sorted(set(STORE_CHANNEL) | set(CATALOG_WEB)):
        name = f"q{q}"
        rep = qualification.qualify(fe.sql(QUERIES[q]))
        beyond = sum(n for r, n in rep.reasons.items() if r != subquery)
        rec = channel_records.get(name) or sql_records[name]
        cpu = len(rec.get("cpu_nodes", []))
        qualified[name] = {"ops": rep.total_ops, "fallback": rep.fallback_ops,
                           "beyond_subquery": beyond, "cpu_nodes": cpu}
        if beyond != cpu or (cpu and name != "q37"):
            raise AssertionError(f"{name}: qualify {rep.reasons}, the "
                                 f"phase's cpu_nodes {cpu}")
    qualify_s = time.perf_counter() - t0
    validation = api_validation.counts()
    api_validation.assert_no_drift()
    if validation["expressions_missing"] or validation["execs_missing"]:
        raise AssertionError(f"api_validation: {validation}")

    # top --once, a process, while a prepared q3's stream is open
    obs.start(port=0)
    try:
        url = f"http://127.0.0.1:{obs.plane().port}"
        s3 = TorchSession({TTB: TASK_TARGET_BYTES}, device=device,
                          tenant="top")
        stream = s3.prepare(tpch.q3_dataframe(s3, li_paths, orders_path)
                            ).execute_stream(batch_rows=1)
        first = next(stream)
        frame = subprocess.run(
            [sys.executable, "-m", "spark_rapids_tpu_torch.tools.top",
             "--url", url, "--once"], capture_output=True, text=True,
            timeout=60, env=dict(os.environ, PYTHONPATH=ROOT), cwd=root)
        rows = pa.Table.from_batches([first, *stream])
        sync()
    finally:
        obs.stop()
    if frame.returncode != 0 or "in-flight queries (1):" not in frame.stdout \
            or " top " not in frame.stdout:
        raise AssertionError(f"top --once: {frame.stdout} {frame.stderr}")
    top_err = compare_ranked(rows, ref3, 10, ("l_orderkey", "o_orderdate",
                                              "o_shippriority"),
                             "revenue", "rev_sum")

    # the trace tool over a script
    script = os.path.join(root, "traced.py")
    with open(script, "w") as f:
        f.write(PERSIST_TRACE_SCRIPT)
    trace_json = os.path.join(root, "trace.json")
    saved = sys.argv
    try:
        code = trace_tool.main(["-o", trace_json, script, data, device])
    finally:
        sys.argv = saved
        tracer.disable()
        tracer.clear()
    with open(trace_json) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    if code != 0 or not {"query.plan", "query.execute"} <= names:
        raise AssertionError(f"the trace tool: exit {code}, {len(names)} "
                             f"names")

    # the sweep slice, its wire subset included
    t0 = time.perf_counter()
    report = sweep.run_sweep(query_ids=list(PERSIST_SWEEP), device=device)
    sweep_s = time.perf_counter() - t0
    statuses = {k: v["status"] for k, v in report["queries"].items()}
    if set(statuses.values()) != {"correct"} or sorted(report["wire"]) \
            != sorted(statuses) or not all(
                v["digest_match"] for v in report["wire"].values()):
        raise AssertionError(f"the sweep slice: {statuses} "
                             f"{report['wire']}")

    in_process_k1 = counter.launches - k1_before
    rec = {"seconds": time.perf_counter() - t_phase,
           "children": children, "result_writer": written,
           "child_walls_ms": {k: r["wall_ms"] for k, r in children.items()},
           "child_import_ms": {k: r["import_ms"]
                               for k, r in children.items()},
           "child_context_ms": {k: r["context_ms"]
                                for k, r in children.items()},
           "fixture_rows": want, "qualified": qualified,
           "qualify_s": qualify_s, "api_validation": validation,
           "top_frame": frame.stdout.splitlines(), "top_max_rel_err": top_err,
           "trace_events": len(names), "sweep": statuses,
           "sweep_wire": report["wire"], "sweep_s": sweep_s,
           "sweep_advances": report["satellite_advances"],
           "in_process_launches": in_process_k1,
           "child_launches": child_k1, "nvidia_smi": nvidia_smi()
           if device == "cuda" else None}
    emit("persist", **rec)
    return rec, in_process_k1 + child_k1


#: seconds after which the script prints every thread's stack and exits
#: non-zero (the run's limit is 1200 s)
WATCHDOG_S = 1150


def main() -> int:
    if sys.argv[1:2] == ["--oom-step"]:
        return oom_child(sys.argv[2])
    import faulthandler

    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on an NVIDIA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import TorchSession, tpcds, tpch
    from spark_rapids_tpu_torch.config import RF_ENABLED, SERIAL
    from spark_rapids_tpu_torch.config import TASK_TARGET_BYTES as TTB
    from spark_rapids_tpu_torch.ops import kernels
    from spark_rapids_tpu_torch.plan import runtime_filter as RF

    dev = torch.device("cuda")
    # the process plugin: one store (memory.fraction of the card) and
    # one task semaphore, shared by every session below
    from spark_rapids_tpu_torch.config import TorchConf
    from spark_rapids_tpu_torch.plugin import TorchPlugin

    TorchPlugin.get_or_create(TorchConf(), "cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = kernels.build_library("hash_string")
    kernels.load_library("hash_string")
    build_s = time.perf_counter() - t0
    ptxas = built.with_suffix(".log").read_text() if \
        built.with_suffix(".log").exists() else ""
    from spark_rapids_tpu_torch import native

    t0 = time.perf_counter()
    codec = native.build()
    native.load()
    codec_s = time.perf_counter() - t0
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    emit("build", seconds=build_s, library=os.path.relpath(built, ROOT),
         ptxas=[ln for ln in ptxas.splitlines() if "registers" in ln
                or "spill" in ln or "smem" in ln],
         host_codec_s=codec_s, host_codec=os.path.relpath(codec, ROOT),
         gxx=gxx)

    parts_s = {}
    t0 = time.perf_counter()
    exact = check_k1(torch, kernels, dev)
    parts_s["exact_hash_string"] = time.perf_counter() - t0
    exact_cols = check_hash_columns(torch, kernels, dev)
    parts_s["exact_hash_columns"] = time.perf_counter() - t0 - sum(
        parts_s.values())
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    large = [time_k1(torch, kernels, dev, TIMED_ROWS, w, gen,
                     plain_iters=PLAIN_ITERS) for w in TIMED_WIDTHS]
    large_cols = time_hash_columns(torch, kernels, dev, TIMED_ROWS, gen)
    parts_s["timed"] = time.perf_counter() - t0 - sum(parts_s.values())
    emit("kernels", hash_string={"exact": exact, "timed": large},
         hash_columns={"exact": exact_cols, "timed": large_cols},
         seconds=parts_s)

    work = os.path.join(ROOT, "spark_rapids_tpu_torch", "_build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as data_dir:
        t0 = time.perf_counter()
        paths = tpch.make_lineitem(data_dir, with_q1_cols=True)
        gen_s = time.perf_counter() - t0
        tables = pa.concat_tables([pq.read_table(p) for p in paths])
        session = TorchSession({TTB: TASK_TARGET_BYTES}, device="cuda")
        n_tasks = tpch.q1_dataframe(session, paths).physical_plan()
        scans = [n for n in n_tasks.walk()
                 if type(n).__name__ == "ParquetScanExec"]
        if scans[0].num_partitions != len(paths):
            raise AssertionError(f"{scans[0].num_partitions} scan tasks, "
                                 f"expected {len(paths)}")
        q6_calls: list = []
        ref6 = reference_q6(pa, pc, tables)
        q6 = run_query(torch, lambda: tpch.q6_dataframe(session, paths),
                       kernels, lambda t: compare(t, ref6, 0), q6_calls)
        emit("q6", rows_in=tables.num_rows, datagen_s=gen_s, **q6)
        q1_calls: list = []
        ref1 = reference_q1(pa, pc, tables)
        q1 = run_query(torch, lambda: tpch.q1_dataframe(session, paths),
                       kernels, lambda t: compare(t, ref1, 2), q1_calls)
        emit("q1", rows_in=tables.num_rows, hash_columns_calls=sorted(
            {(n, signature(cols), parts)
             for cols, n, _, parts in q1_calls}), **q1)
        del tables

        q3_dir = os.path.join(data_dir, "q3")
        os.makedirs(q3_dir)
        t0 = time.perf_counter()
        li_paths = tpch.make_lineitem(q3_dir, with_orderkey=True)
        orders_path = tpch.make_orders(q3_dir)
        gen3_s = time.perf_counter() - t0
        lineitem = pa.concat_tables([pq.read_table(p) for p in li_paths])
        orders = pq.read_table(orders_path)
        ref3 = reference_q3(pa, pc, lineitem, orders).to_pylist()

        q3_runs = {}
        for rf_on in (False, True):
            # the static partition-wise plan; q3_adaptive is the default's
            q3_runs[rf_on] = q3_phase(
                torch, kernels, RF, tpch, TorchSession({
                    TTB: TASK_TARGET_BYTES, RF_ENABLED: rf_on,
                    ADAPTIVE: False}, device="cuda"), li_paths, orders_path,
                ref3, rf_on)
        q3, q3_calls = q3_runs[False]
        q3_rf, q3_rf_calls = q3_runs[True]
        emit("q3", rows_in=lineitem.num_rows, orders_in=orders.num_rows,
             groups=len(ref3), datagen_s=gen3_s, **q3)
        emit("q3_rf_on", rf_off_median_s=q3["median_s"], **q3_rf)
        q3a_session = TorchSession({TTB: TASK_TARGET_BYTES}, device="cuda")
        q3_adaptive = adaptive_sibling(
            torch, kernels, "q3_adaptive",
            lambda: tpch.q3_dataframe(q3a_session, li_paths, orders_path),
            lambda t: compare_ranked(
                t, ref3, 10, ("l_orderkey", "o_orderdate", "o_shippriority"),
                "revenue", "rev_sum"),
            [["TpuAdaptiveJoinExec", "inner", "right"]], q3_rf_calls,
            must_prune=True)
        emit("q3_adaptive", **q3_adaptive)
        del lineitem, orders

        q67_dir = os.path.join(data_dir, "q67")
        os.makedirs(q67_dir)
        t0 = time.perf_counter()
        ss_paths = tpcds.make_store_sales(q67_dir, n_rows=Q67_ROWS,
                                          n_files=Q67_FILES)
        gen67_s = time.perf_counter() - t0
        sales = pa.concat_tables([pq.read_table(p) for p in ss_paths])
        ref67, sums67 = reference_q67(pc, sales)
        session67 = TorchSession({TTB: Q67_TASK_TARGET_BYTES}, device="cuda")

        def q67_df():
            return tpcds.q67_dataframe(session67, ss_paths)

        tasks = [n.num_partitions for n in q67_df().physical_plan().walk()
                 if not n.children]
        if tasks != [Q67_FILES]:
            raise AssertionError(f"q67 scan tasks {tasks}, expected "
                                 f"{[Q67_FILES]}")
        q67_calls: list = []
        q67 = run_query(torch, q67_df, kernels,
                        lambda t: compare_q67(t, ref67, sums67), q67_calls,
                        counted=True)
        emit("q67", rows_in=sales.num_rows, groups=len(sums67),
             rows_out=q67["rows"], file_bytes=[os.path.getsize(p)
                                               for p in ss_paths],
             datagen_s=gen67_s,
             hash_columns_calls=sorted(
                 {(n, signature(cols), parts)
                  for cols, n, _, parts in q67_calls}), **q67)
        del sales

        star = star_tables(pa, pq, data_dir, tpcds)
        q3ds, q3ds_off, q3ds_calls = q3ds_phase(torch, pc, star, kernels,
                                                RF, TorchSession, tpcds, TTB,
                                                RF_ENABLED)
        trace_phase(torch, pc, kernels, TorchSession, tpch, tpcds, TTB,
                    li_paths, orders_path, ref3, star)
        scan_host_phase(torch, pc, TorchSession, tpch, tpcds, TTB, paths,
                        ref6, ref1, star)
        _wire, wire_k1, wire_calls = wire_phase(
            torch, pa, pc, pq, kernels, TorchSession, tpch, tpcds, TTB, paths,
            ref6, ref1, star, li_paths, orders_path)
        q93, q93_calls = q93_phase(torch, pa, pc, pq, star, kernels,
                                   TorchSession, tpcds, TTB)
        _formats, formats_k1 = formats_phase(
            torch, pa, pc, pq, star, kernels, TorchSession, tpch, tpcds,
            TTB, paths)
        _ops, ops_k1 = ops_phase(torch, pa, pc, kernels, TorchSession, tpch,
                                 tpcds, TTB, paths, ref6, ref1, star,
                                 li_paths, orders_path, ref3)
        _surface, surface_k1 = surface_phase(
            torch, np, pa, kernels, TorchSession, tpch, tpcds, TTB, paths,
            ref6, ref1, star, li_paths, orders_path, ref3)
        _spec, spec_k1, spec_calls = speculation_phase(
            torch, pa, pc, kernels, TorchSession, tpch, tpcds, TTB, paths,
            ref1, li_paths, orders_path, ref3, star)
        star_runs, star_calls = star_phase(torch, pc, star, kernels,
                                           TorchSession, tpcds, TTB)
        dimension_tables(pq, star, tpcds)
        q67r, q67r_calls = q67_rollup_phase(torch, pa, pc, pq, star, kernels,
                                            TorchSession, tpcds, TTB)
        q5, q5_calls = q5_phase(torch, pa, pc, pq, star, kernels,
                                TorchSession, tpcds, TTB)
        q27_runs, q27_calls = q27_phase(torch, pa, pc, pq, star, kernels,
                                        TorchSession, tpcds, TTB)
        family, family_calls = agg_family_phase(torch, pa, pc, pq, star,
                                                kernels, TorchSession, TTB)
        sql, sql_calls, store_tables = sql_phase(
            torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB)
        types, types_calls = types_phase(
            torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB,
            store_tables)
        nested, nested_calls = nested_phase(
            torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB,
            store_tables, star.pop("q43_text_rows"))
        long_tail, long_tail_calls = long_tail_phase(
            torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB,
            store_tables)
        python, python_k1, python_calls = python_phase(
            torch, pa, pc, pq, star, kernels, TorchSession, TTB)
        adaptive, adaptive_calls = adaptive_phase(
            torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB)
        channels, channel_calls = channels_phase(
            torch, pa, pc, pq, star, kernels, tpcds, TTB, store_tables)
        fallback, fallback_calls = fallback_phase(
            torch, pa, pc, pq, star, kernels, TorchSession, tpcds, TTB)
        serving, serving_k1 = serving_phase(torch, pa, kernels, TTB,
                                            store_tables)
        _persist, persist_k1 = persist_phase(
            torch, pa, pc, pq, kernels, TorchSession, tpch, TTB, star,
            li_paths, orders_path, ref3, sql, channels)
        memory = memory_phase(torch, pa, pc, pq, star, kernels,
                              TorchSession, tpch, tpcds, TTB, paths)
        dd_path, star_ss, item_path = star["paths"]
        sr_path, reason_path = star["q93_paths"]
        store_path = star["store_path"]
        li8 = {TTB: TASK_TARGET_BYTES}
        ds8 = {TTB: Q3DS_TASK_TARGET_BYTES}
        pairs = CONCURRENCY_PAIRS
        kernels.hash_columns.launches = 0
        kernels.hash_string.launches = 0
        concurrency_phase(torch, kernels, TorchSession, SERIAL, {
            "q6": (li8, lambda s: tpch.q6_dataframe(s, paths), pairs),
            "q1": (li8, lambda s: tpch.q1_dataframe(s, paths), pairs),
            "q3_rf_on": (li8, lambda s: tpch.q3_dataframe(s, li_paths,
                                                          orders_path),
                         pairs),
            "q67": ({TTB: Q67_TASK_TARGET_BYTES},
                    lambda s: tpcds.q67_dataframe(s, ss_paths), pairs),
            "q3ds": (ds8, lambda s: tpcds.q3_dataframe(s, dd_path, star_ss,
                                                       item_path), pairs),
            "q93": (ds8, lambda s: tpcds.q93_dataframe(s, star_ss, sr_path,
                                                       reason_path), pairs),
            "q67_rollup": (ds8, lambda s: tpcds.q67_rollup_dataframe(
                s, dd_path, star_ss, item_path, store_path), NEW_PAIRS),
            "q5": (ds8, lambda s: tpcds.q5_dataframe(
                s, dd_path, star_ss, sr_path, store_path), NEW_PAIRS)})
        conc_launches = {"hash_columns": kernels.hash_columns.launches,
                         "hash_string": kernels.hash_string.launches}
    want = {"hash_columns": q1["runs"] * len(paths), "hash_string": 0}
    if q1["launches"] != want:
        raise AssertionError(f"q1 launched {q1['launches']}, expected "
                             f"{want} (one hash_columns per map batch)")
    if q6["launches"] != {"hash_columns": 0, "hash_string": 0}:
        raise AssertionError(f"q6 launched {q6['launches']}")
    check_launches("q67", q67, q67)

    new_types_mix = new_types_call(torch, dev)
    worst, at_main = at_main_path(torch, kernels, {
        "q1": q1_calls, "q3": q3_calls, "q3_rf_on": q3_rf_calls,
        "q67": q67_calls, "q3ds": q3ds_calls, "q93": q93_calls,
        "star": star_calls, "q67_rollup": q67r_calls, "q5": q5_calls,
        "q27": q27_calls, "agg_family": family_calls, "sql": sql_calls,
        "types": types_calls, "nested": nested_calls,
        "long_tail": long_tail_calls, "python": python_calls,
        "adaptive": adaptive_calls, "channels": channel_calls,
        "fallback": fallback_calls, "speculation": spec_calls,
        "wire": wire_calls, "new_types_mix": [new_types_mix]})
    k1_main = k1_at_main_path(torch, kernels, q1_calls)
    emit("main", hash_columns=at_main, hash_string=k1_main)
    w64 = next(r for r in large if r["w"] == 64)
    runs = (q6, q1, q3, q3_rf, q3_adaptive, q67, q3ds, q3ds_off, q93,
            *star_runs.values(), q67r, q5, *q27_runs.values(),
            *family.values(), *sql.values(), *types.values(),
            *nested.values(), *long_tail.values(), *python.values(),
            *(r for r in adaptive.values() if "launches" in r),
            *channels.values(), *fallback.values())
    summary = [{
        "name": "hash_columns", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/hash_string.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:138",
        "launches": conc_launches["hash_columns"] + sum(
            q["launches"]["hash_columns"] for q in runs) + sum(
            q["launches"]["hash_columns"]
            for q in memory["split"].values()) + python_k1
        + serving_k1["hash_columns"] + spec_k1 + wire_k1 + formats_k1
        + ops_k1 + surface_k1 + persist_k1,
        "max_abs_err": max(r["max_abs_err"] for r in at_main + [large_cols]),
        "ms": worst["ms"], "plain_ms": worst["plain_ms"],
        "bound_ms": worst["bound_ms"], "bound_by": worst["bound_by"],
        "library_ms": None,
        "shape": "the largest of q1's, q3's (filter off and on, and "
                 "adaptive), q67's, "
                 "q3ds's, q93's, q42/q52/q55's, q67_rollup's, q5's, q27's, "
                 "agg_family's, the sql, types and channel texts', the "
                 "nested, long-tail, python and adaptive queries', the "
                 "fallback phase's, the speculation phase's and the wire "
                 "phase's calls, and the new_types mix at "
                 "6 x 2^20 rows; ms is the device's own time per "
                 "launch; launches include the memory phase's split runs "
                 "and the speculation, wire, formats, ops, surface and "
                 "persist phases' runs (persist: its cold-start children's "
                 "too)",
        "formats_launches": formats_k1,
        "ops_launches": ops_k1,
        "surface_launches": surface_k1,
        "persist_launches": persist_k1,
        "concurrency_launches": conc_launches["hash_columns"],
        "host_ms": worst["host_ms"], "main_path_shapes": at_main,
        "large_shape": large_cols,
    }, {
        "name": "hash_string", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/hash_string.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:138",
        "launches": conc_launches["hash_string"] + sum(
            q["launches"]["hash_string"] for q in runs)
        + serving_k1["hash_string"],
        "max_abs_err": max(r["max_abs_err"] for r in large),
        "ms": w64["ms"], "plain_ms": w64["plain_ms"],
        "bound_ms": w64["bound_ms"], "bound_by": w64["bound_by"],
        "library_ms": None,
        "shape": [w64["n"], w64["w"]], "large_shapes": large,
        "q1_shape": k1_main,
    }]
    print(json.dumps({"kernels": summary}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
