#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hyrise_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cells [--kernels-from DIR]
    python3 chip_smoke.py --kernels K2,K3,K8,K9c,K5c [--kernels-from DIR]
    python3 chip_smoke.py --compiled [--kernels-from DIR]
    python3 chip_smoke.py --compiled-streaming
    python3 chip_smoke.py --compiled-distribution
    python3 chip_smoke.py --indexes-and-tools

The second form runs phases 1 and 2, then only K3's and K6's checks and
timings (`cells_phase`); the third builds only the sources of the kernels
named (any of K2, K3, K8, K9c and K5c; KERNEL_SOURCES) and runs only their
checks and timings (`kernels_phase`). With --kernels-from these import the
package of the checkout in DIR instead (an older commit unpacked there), for
its timings beside this one's in the same call; the checks of phase 3 are
then left out, but each timed shape is still held against its plain
version. The fourth runs phases 1 and 2, generates phase 4's SF1 tables,
takes the eager rows and walls of the 22 hand plans and SQL texts that phase
12 compares with, then phase 12 alone (`compiled_only_run`), with DIR's
package where --kernels-from names one. The fifth runs phases 1 and 2,
phase 10's SF10 part (the tables, the eager streamed and resident answers
and medians), then phase 13 alone (`compiled_streaming_only_run`). The
sixth runs phases 1 and 2, phase 4's SF1 tables with phase 6's SQL rows,
phase 10's SF10 tables with their resident answers, phase 11's shard_tpch
and eager distributed runs, then phase 14 alone
(`compiled_distribution_only_run`). The seventh runs phases 1 and 2, phase
4's SF1 tables, then phase 15 alone (`indexes_and_tools_only_run`).

Phases, each printing its lines; any failure raises and exits non-zero:

1. device  — requires CUDA (there is no CPU run) and prints the card's name
             and power limit as nvidia-smi reports them;
2. build   — compiles every CUDA source of hyrise_tpu_torch/kernels/csrc
             with nvcc for sm_90a, one nvcc process per source, all started
             together, and prints the build seconds, each nvcc's own seconds
             and ptxas' register counts;
3. kernels — each kernel against its plain torch version on the card, on
             seeded data at n = 1, 1000, 65,543 and 6,006,330 rows: K1
             (q6_scan) within 1e-5 relative of q6_compute (the bound of
             tests/test_pallas.py); K2 (q6_encoded) equal to the host's
             exact int64 total; K3 (segment_reduce_cells, the one-slot call
             of segment_reduce_cells_many) as sum of float64, float32, int64
             and int32 values, count, min and max into 1, 4, 6, 25 and 64
             cells (6 and 25 are Q1's and Q5's on the main path), integers
             equal and float sums within 1e-12 relative, and the same bits
             from two launches; K4
             (lookup_last_eq_lut: a memset, a build and a probe of four rows
             a thread from one C call) equal and the same bits from two
             launches, at 65,543 and 6,006,330 rows also from views one
             element into their buffers, with every probe key outside the
             range, an empty build side, every build row invalid, a third of
             the build rows on one key, a table of LUT_MAX_ENTRIES entries
             and 0 to 9 build rows against 1 to 9 probes; K5 (expand_pairs:
             a scan of the counts whose tiles hand their sums on through
             status words, then an expansion whose blocks own 2,048 output
             positions) equal, at those two sizes also in 200 launches in a
             row, with all ranges empty but five, as one range over the whole
             build side, as the triangular ranges of a `<` join, as one range
             of 150,000 pairs, at totals of 0, 1, one output tile and one
             more, at range counts around the scan's tile, from views, and
             five kinds of ranges outside the build side must raise; K6
             (fused_cells_reduce, one kernel a call on tiles staged by bulk
             copies) in four shapes and K8 (lookup_last_eq: a memset, a
             build and a probe from one C call) on int64 and float64 keys,
             with a hot key and an empty build side. K2 also at 1 to 17
             rows, around one block's and one grid's step of rows, with the
             int32 products wrapping, from views one element into their
             buffers and in 200 launches in a row at changing lengths (its
             last block's ticket); K8 also with the keys a hash table can
             get wrong (INT64_MIN, whose stored pattern is the empty slot's,
             INT64_MAX, -0.0, NaN, +-inf, subnormals), at 1 and 2^20 - 1 /
             2^20 / 2^20 + 1 distinct build keys, with every build row
             invalid, an empty build side, a third of the build rows on one
             key, from views one element into their buffers, and in 200
             launches in a row at changing lengths; every K2 and K8 case
             also gives the same bits from two launches. K3 and K6
             also at 2,047 / 2,048 / 2,049 rows and over 37 tiles, at 1, 2,
             8, 9, 63 and 64 cells, for the four types and folds, with NaN
             and +-inf in min and max, from columns one element into their
             buffers, and in 200 launches in a row at changing lengths (so
             changing block counts: a ticket left standing shows there; K3
             as three slots and the row count a call, at 6 and 40 cells).
             K3 also as one call of 1, 2, 6 and 18 slots (counts with and
             without a validity column; per type a sum, a sum over a
             validity column, a min and a max) at those sizes and cell
             counts, from aligned columns and from views, in as many
             launches as plan_launches gives (one up to 8 cells), every
             slot's bits the same alone, batched and split over two calls,
             and a call that plan_launches splits (16 folds each over its
             own validity column at 64 cells).
             K7 (segment_reduce_sorted, which works on tiles of 2,048
             positions of the group order): sum, min and max of the four
             types and the count, with and without the permutation and the
             validity column, at about 4 rows a group, at 1,000 groups, as
             one group, with a third of the rows in one group, with every
             boundary on a tile boundary, with runs of empty groups at both
             ends and on a tile boundary, with starts[0] > 0, and as 32 one-row
             groups and one long one (every later tile searches 33 groups);
             integers
             equal, float64 sums within 1e-12 relative (exact binary
             fractions, so any order of summation gives the same sum), and
             the same bits from two launches of every case (no atomics touch
             a result: a sum's order is fixed by the group offsets alone).
             K9 (compact_indices, one pass in one launch whose tiles hand
             their counts on through status words): equal at five
             selectivities, from an aligned mask and from a view one byte
             into it, and at 65,543 and 6,006,330 rows 200 launches in a
             row, each held against the plain version. Then the median
             device ms of each kernel, of its plain version and of the
             PyTorch call that computes the same function where there is one
             (index_add_ for K3's one sum, and for its calls of several
             slots (K3_MANY_TIMED: Q1's and Q5's dense Aggregates, 64 cells
             with three mixed folds over a validity column) the calls of one
             slot each that they replace; for K7 index_add_ and torch.segment_reduce,
             without and with the index_select that gathers the values;
             torch.nonzero for K9), at the largest n and the shapes of the
             main path (K9 also on a 1,000-row mask, as a view of its
             worst-case buffer and as a copy; K5 also with a third of the
             pairs in one range, with ranges and build side in order and at
             100,000 ranges; K4 also with its probe keys in order), each
             timed shape first held against its plain version (K8 also with
             a third of its build rows on one key, with distinct keys and
             at the size of Q20's call); and for K2-K9 the kernels' own device
             time from one torch.profiler run per shape, which for K4, K5
             and K8 must show at most two kernels and a memset a call and
             for K2, K3 and K6 one kernel. K9c and K5c, the capacity forms
             (compact_indices_cap, expand_pairs_cap: every output byte
             written by the kernels, no memset of an output), equal to
             their plain versions at k9c_shapes and k5c_shapes (capacities
             at, around and under the count, a count of 0 under 2^20, one
             row and one entry, the tiles +-1, odd capacities, a third of
             the pairs in one range, views), through the wrappers and
             through the raw C calls into outputs filled with 0xFF and
             guarded on either side, and in 200 raw launches in a row at
             changing (n, cap) into one buffer never cleared; every refused
             kind of range sets K5c's flag and leaves its outputs 0. Then
             timed: K9c at 2 / 50 / 98% True beside
             torch.nonzero_static(fill_value=0), K5c over three kinds of
             ranges beside K5 on the same ranges; torch.profiler must show
             one memset a call, no longer than the scratch (its bytes from
             the trace), and no torch op;
4. data    — all 8 TPC-H tables at SF1 generated and uploaded to the card;
5. main    — all 22 TPC-H queries through the operator DAG on the card at
             SF 0.01 (Q20 at 0.05, where it returns rows) against a sqlite
             database loaded from the same tables: integers and strings
             equal, floats within 1e-6 relative. Then, with every launch
             count at 0, all 22 at SF1: every value finite, rows wherever the
             small run had rows, Q6 and Q1 against numpy oracles computed
             from the same generated arrays, and Q3, Q5, Q9, Q10, Q14 and
             Q18 equal to the same plans run over CPU copies of the same
             tables; then the Q6 bench (hyrise_tpu_torch/bench_q6.py)
             through K1 and K2 on that lineitem. The launch count of each of
             K1-K5 must have risen;
6. sql     — the SQL entry point (SQLPipelineBuilder: parse, LQP, optimize,
             physical plan, execute) on the card: the 22 TPC-H texts at
             SF 0.01 (Q20 at 0.05) against the same sqlite databases as
             phase 5 and the SELECTs of tests/sql_corpus.sql over its four
             small tables against sqlite (integers and strings equal, floats
             within 1e-6 relative; a statement that needs the 1e-4 of
             tests/test_sql_corpus.py is named), with every launch count at 0
             again before them; then the 22 texts at SF1, each equal as a row set
             (1e-6 relative) to the rows phase 5 got from the hand plan of the
             same query: first run and median of 5 with the plan cache on,
             and the stage seconds of StatementMetrics. Q1's and Q6's plans
             must hold a FusedFilterAggregate that did not fall back, and
             the launch count of each of K6-K9 must have risen.

7. dml     — writes on the card (sql/pipeline.py with MVCC, ops/rw_ops.py,
             concurrency/transaction.py, storage/load_table.py), with every
             launch count at 0 again before it. At SF 0.01 (Q20 at 0.05):
             RF1 and RF2 of TPC-H (clause 2.5) in the port and in sqlite,
             the 22 texts with MVCC on after each, against sqlite. At SF1,
             on phase 4's tables: MVCC state on all 8 (its MB printed, its
             tensors on the card); a snapshot before RF1; RF1 (SF x 1,500
             orders with 1 to 7 lineitems each, drawn from SEED, half their
             comments new to the dictionary, written as .tbl files and
             loaded with load_table) as INSERT INTO ... SELECT in one
             transaction; Q1, Q3, Q6 and Q18 in the old snapshot equal
             phase 5's rows; Q1 and Q6 against the numpy oracles over the
             base rows and RF1's, phase 5's six join queries against CPU
             copies of the tables and MVCC state; a second RF1 that rolls
             back; RF2 (DELETE ... WHERE ... IN (SELECT k FROM rf2_keys) on
             lineitem and orders, in one transaction) and the oracles again;
             the 22 texts with MVCC on (first run and median of 5, every
             value finite) beside phase 6's medians; Validate's device ms on
             lineitem; two transactions deleting one order (the second must
             raise TransactionConflict); a table that grows past its
             capacity while a Delete is pending. Each RF statement's host ms,
             which path each join of Q3 and Q18 took before and after RF1
             (Join.path) and the launches of the phase are printed; K3-K7
             and K9 must have launched.
8. physical — the physical design layer on the card (storage/encoding.py,
             tasks.py, storage/block_statistics.py, storage/index.py,
             ops/index_scan.py, JoinIndex), with every launch count at 0
             again before it, on copies of phase 4's SF1 tables in catalogs
             of their own (phases 5-7 see what they saw before). All 8
             tables encoded DICTIONARY, then RUN_LENGTH, then
             FRAME_OF_REFERENCE: at-rest MB beside dense MB, the device ms of
             RLE's decode of l_orderkey and FoR's of l_orderkey and
             l_partkey beside their bounds, and the 22 texts over each equal
             to phase 6's rows (first run and median of 3). RF1 into
             DICTIONARY tables under MVCC: the appended columns come out
             dense, ChunkCompressionTask encodes them again, Q1, Q3 and Q6
             give the same rows before and after, Q1 and Q6 equal the numpy
             oracles over base + RF1. Block statistics on all 8 tables
             (generate's ms, lineitem's device ms and bound), the 22 texts,
             two predicates no block can hold pruned to an empty table, one
             near the largest key kept, and ROADMAP C13, C14 and C15 on
             small tables on the card. Indexes on the 12 columns the texts
             scan and two composite keys (build ms, one build's device ms
             and bound): the 22 texts equal to phase 6's rows with the
             IndexScans of each plan (at least one in all), one IndexScan's
             gather timed against its bound, 1,000 point lookups on
             o_orderkey (100 absent) and 100 on (l_orderkey, l_linenumber)
             (10 absent) through SQL equal to the same statements without
             indexes, host ms a lookup for IndexScan and TableScan, and
             JoinIndex of orders with lineitem in INNER, LEFT, SEMI and
             ANTI equal to Join row for row with index_used, both timed. K5
             and K9 must have launched.
9. frontend — the front ends on the card (server.py, parallel/scheduler.py,
             console.py, tpcc/generator.py), with every launch count at 0
             again before it, on copies of phase 4's SF1 tables in a catalog
             of their own. The PostgreSQL wire server on 127.0.0.1 (a free
             port, a background thread); TPC-H's streams 1 and 2 (Appendix
             A's orders of the 22 texts) sent as SimpleQuery on two
             sessions at the same moment, each of the 44 answers parsed from
             its DataRows and equal to phase 6's rows (ints and strings
             exactly, floats within 1e-6 relative, in order under ORDER BY);
             each stream's wall, the throughput (44 queries over the elapsed
             seconds) and stream 1 alone through the server. Q6 through
             Parse / Bind / Describe / Execute / Sync with its five
             parameters bound as text, equal to phase 6's; ROADMAP C2's
             cases (Bind to an unknown statement, the skip to Sync after an
             error, Describe of a statement, the command tags of writes on
             a table made on the card). The 22 hand plans through
             schedule_plan with PoolScheduler(workers=4), equal to phase 5's
             rows in order, their walls beside phase 5's medians. The
             console's `generate tpcc 10` on the card and a script (the nine
             tables' row counts, a join, a group-by, a join of order_line with
             its orders on three keys, an ORDER BY ... LIMIT)
             whose output equals the same script over CPU copies of the
             tables. K3-K7 and K9 must have launched; the phase's launches
             are added to the kernels line's.

10. streaming — blocked and segmented execution (plan/blocked.py,
             plan/segmented.py), with every launch count at 0 again before
             it. At SF1, on phase 4's tables: the 22 hand plans through
             run_query(via="segmented") with lineitem streamed in blocks of
             2^20 rows (6 blocks) and orders resident, each equal to phase
             5's rows in order (floats within 1e-6 relative); Q1, Q3, Q6
             and Q14 through via="blocked"; ROADMAP C1's shape (an Aggregate
             over a UnionAll of lineitem and a 2-row table) must be refused.
             Then the SF1 tables leave the card and TPC-H at SF10 is
             generated on it (lineitem 59,989,423 rows): the 22 hand plans
             streamed with the JAX package's thresholds (resident_rows 2^24,
             block_rows 2^22: lineitem in 15 blocks, orders resident) equal
             to the same plans run resident, Q1 and Q6 equal to the numpy
             oracles over the host columns, Q4, Q15, Q17, Q18, Q20 and Q21
             in 2 stages or more; per query the stages, the blocks, the
             first-run and median-of-3 host ms and the MB allocated above
             the tables during the first run, streamed and resident. K3,
             K4, K7 and K9 must have launched; the phase's launches are
             added to the kernels line's.
11. distribution — parallel/ on the card, with every launch count at 0
             again before it, on phase 10's SF10 tables and resident answers.
             shard_tpch puts lineitem, orders, customer, part and partsupp
             into 4 shards on the one card (the JAX package's keys; the other
             tables replicated): its seconds, the sharded copies' MB beside
             the tables', each table's shard imbalance, and partition_hash
             of every shard's key column equal to the shard's index. The 22
             hand plans through DistributedQuery (all_to_all) equal phase
             10's resident answers in order (Q11 answers no rows at SF10,
             ROADMAP C24, and is not counted as a check), Q1 and Q6 also the
             numpy oracles: first run and median of 3 beside the resident
             medians, the join decisions, exchange_stats() and the MB above
             the tables. Q3, Q5, Q9, Q18 and Q21 through the ring equal the
             all_to_all answers; dist_q6, dist_q1 and dist_q3_step equal the
             oracles and phase 10's Q3. BlockedDistributedQuery streams
             lineitem per shard in blocks of 2^20 rows for Q1, Q3 and Q6,
             equal to the resident answers. Phase 4's SF1 tables come back
             onto the card from their CPU copies: the 22 SQL texts with
             with_distributed_execution equal phase 6's rows. A shuffle join
             with one hot key (the shape of test_dist_skew.py) must be exact
             and take the split; one PlacementManager.run_once() on a skewed
             table must migrate it with the answers unchanged. Last, a
             process group of one rank with NCCL on the card
             (initialize_from_env on a free local port): Q1, Q3, Q6 and Q18
             over its mesh equal the in-process answers. (NCCL refuses two
             ranks on one card: groups of several ranks run in the CPU tests
             only.) K1, K3, K4, K5, K7 and K9 must have launched; the
             phase's launches are added to the kernels line's.
12. compiled — whole-plan compiled execution (plan/compiler.py), run right
             after phase 9 on copies of phase 4's SF1 tables, with every
             launch count at 0 before it. The 22 hand plans through
             run_query(via="compiled"): each learned under
             set_sync_debug_mode("error"), captured as one CUDA graph and
             equal to phase 5's rows, first run and median of 5 replays
             beside phase 5's eager median, with retries, captures, capacity
             sites, the graph pool's MB and one replay's device events and
             busy ms from torch.profiler. The 22 SQL texts through
             with_compiled_execution() equal phase 6's rows, each compiled.
             A replay makes no eager oracle read; lineitem replaced by its
             first half under Q6 is captured again and answered anew; four
             threads run one cached compiled text three times each. K9c's,
             K5c's and K3's nodes in one replay of each plan beside its busy
             ms (cap_nodes; K3's summed over the traced plans as its share of
             the replays), K9c's and K5c's calls by (n, cap, count) size
             class over the 22 plans (census_line), K3's by (n, cells,
             slots) (k3_census_line). bench/micro.py runs its
             micros as replayed graphs.
             Launches inside graphs count once per replay; K3, K4, K6, K7,
             K8, K9c and K5c must have launched; the phase's launches are
             added to the kernels line's, which lists the two capacity forms
             after K1-K9.
13. compiled streaming — the streamed forms as captured graphs
             (plan/blocked.py BlockedCompiledQuery, plan/segmented.py
             SegmentedQuery(compiled=True)), right after phase 10 on its SF10
             catalog and resident answers, with every launch count at 0
             before it. The 22 hand plans through run_query(
             via="compiled-segmented") with phase 10's thresholds (lineitem
             in 15 blocks), each equal to the resident answer in order on
             each of four runs; the third and fourth capture nothing, retry
             nothing, read the host at most twice per blocked stage, and no
             run after the first reads a count eagerly. Per query: stages,
             blocks, captures, whether the learning runs were sync-checked,
             first run and median of 3 more beside phase 10's eager streamed
             and resident medians, host reads a run, retries, the graphs'
             pool MB and the peak MB above the tables. Q1 and Q6 against the
             numpy oracles; Q1, Q3, Q6 and Q14 through via="compiled-blocked"
             with the builds a run and one profiled run's busy ms a block;
             lineitem replaced by its first half under Q6 and Q18 gives the
             eager streamed answers over it and is captured again, then put
             back. Each query's compiled objects are freed after it is
             measured. K3, K4, K7 and K9c must have launched inside the
             graphs; the phase's launches are added to the kernels line's.
14. compiled distribution — parallel/dist_compiler.py
             DistributedCompiledQuery, right after phase 11 on its 4-shard
             SF10 ShardedCatalog and phase 10's resident answers, with every
             launch count at 0 before it. The 22 hand plans, each pinned by
             an eager run, learned under set_sync_debug_mode("error") and
             captured as one graph over the 4 shards, exchanges included,
             equal to the resident answer in order on each of four runs
             (Q11 answers no rows at SF10, ROADMAP C24), with phase 11's
             join decisions and exchange_stats(); the third and fourth
             capture nothing, retry nothing, read the host once, and no run
             after the first reads a count eagerly. Per query: first run and
             median of 3 more beside phase 11's eager distributed and phase
             10's resident medians, captures, retries, host reads, sites,
             pool MB and the peak MB above the tables and shards. Q1 and Q6
             against the numpy oracles; Q3, Q5 and Q9 through the ring;
             BlockedDistributedQuery(compiled=True) for Q1, Q3 and Q6 in
             blocks of 2^20 rows a shard, its block program captured once
             for every block (twice where the first pass tightened it), one
             profiled run's busy ms a block; the 22 SQL texts over SF1
             shards through with_distributed_execution and
             with_compiled_execution against phase 6's rows, twice each;
             lineitem's shards replaced by those of its first half under
             compiled Q6 (the eager answer over them, a capture again), then
             put back, and a PlacementManager migration under a compiled
             aggregate (a capture again, the same answer); compiled Q1, Q3,
             Q6 and Q18 over a one-rank NCCL group equal the in-process
             answers. Each query's compiled objects are freed after it is
             measured. K3, K4, K7 and K9c must have launched inside the
             graphs; the phase's launches are added to the kernels line's.
15. indexes and tools — right after phase 12, on copies of phase 4's SF1
             tables with phase 8's 14 indexes, with every launch count at 0
             before it. 15a: the 22 texts through with_compiled_execution(),
             each equal to its eager answer through the indexes (and that to
             phase 6's rows); every IndexScan of a compiled plan ran in
             capacity mode (its TableScan fallback), more than none in all;
             runs 2 and 3 capture nothing, retry nothing, read the host once
             and read no count eagerly; first run, replay and eager ms side
             by side; 40 point lookups on o_orderkey and 10 on (l_orderkey,
             l_linenumber), each a new compiled text equal to the eager
             answer through the index. 15b: over 4 SF1 shards on the card,
             the 22 texts through with_distributed_execution, eager and with
             the compiled flag (twice), equal to the eager answers, with the
             compiled form's decisions and exchange_stats() equal to the
             eager form's; JoinIndex of orders with lineitem in INNER, LEFT,
             SEMI and ANTI under COUNT and SUM through DistributedQuery and
             DistributedCompiledQuery equal to single-node Join; the plans
             with an IndexScan or a JoinIndex that ran distributed, counted,
             with their exchange_stats(). 15c: the four tools in process:
             bench/tpch_bench.py's run_suite via compiled over phase 4's
             tables, runs 3 (every query in the report), merge_reports of
             its two halves equal to it; bench/reference_compare.py over the
             22 queries at SF 0.1 (every non-aggregate cell equal to sqlite,
             float aggregates within 1e-6 relative of the sequential fold,
             the largest ULP distance printed); bench/scaling_bench.py with
             Q1, Q3, Q6 and Q12 over 1, 2 and 4 shards at SF1, runs 3, every
             answer equal to one shard's. K3, K4, K6, K7, K8, K9c and K5c
             must have launched; the phase's launches (graph replays
             counted) are added to the kernels line's.

Phases 5 and 6 also print the mean rows per launch of K4, K5, K7 and K9 and
K5's mean pairs per launch (the wrappers count the rows they are given), so
their launch counts can be read against sizes. After phase 11 comes the
script's run time, the build included. The line before the last is
{"kernels": [...]}; the last line is
{"ok": true, "device": {...}} and is printed only when every phase passed.
"""

import gc
import io
import json
import re
import statistics
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SF = 1.0
SMALL_SF = 0.01
SMALL_SF_OF = {20: 0.05}       # scale factors at which every query returns rows
SEED = 19940607
KERNEL_SIZES = (1, 1000, 65_543, 6_006_330)
K3_CELLS = (1, 4, 6, 25, 64)   # 6 and 25: Q1's and Q5's groups on the main path
QUERY_REPS = 5
CPU_CHECKED = (3, 5, 9, 10, 14, 18)
# the kernels phase 7 must launch: group-bys (K3), joins (K4, K5), Q1 and Q6
# (K6), Q18 and Q21 (K7), every filter and compaction (K9)
DML_KERNELS = ("segment_reduce_cells", "lookup_last_eq_lut", "expand_pairs",
               "fused_cells_reduce", "segment_reduce_sorted", "compact_indices")
# NVIDIA H100 SXM data sheet: device memory rate, and the float64 rate
# outside the tensor cores (half the 67 TFLOP/s float32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 33.5e12


def log(*parts) -> None:
    print(*parts, flush=True)


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def kernel_inputs(n: int, device):
    """Seeded Q6 columns in both layouts, as the JAX package's tests make
    them (tests/test_pallas.py, tests/test_q6_encoded.py)."""
    rng = np.random.default_rng(n)
    ship = rng.integers(0, 2557, n).astype(np.int32)
    dense = dict(
        ship=ship,
        disc=(rng.integers(0, 11, n) / 100).astype(np.float32),
        qty=rng.integers(1, 51, n).astype(np.float32),
        price=(rng.random(n) * 1e5).astype(np.float32),
        live=np.arange(n) < n - 3)
    encoded = dict(
        ship=ship.astype(np.int16),
        disc_cents=rng.integers(0, 11, n).astype(np.int8),
        qty=rng.integers(1, 51, n).astype(np.int8),
        price_cents=rng.integers(90_000, 10_495_000, n).astype(np.int32))
    exact = int(np.sum(np.where(
        (encoded["ship"] >= 731) & (encoded["ship"] < 1096)
        & (encoded["disc_cents"] >= 5) & (encoded["disc_cents"] <= 7)
        & (encoded["qty"] < 24),
        encoded["price_cents"].astype(np.int64)
        * encoded["disc_cents"].astype(np.int64), 0)))

    def up(d):
        return {k: torch.as_tensor(v, device=device) for k, v in d.items()}

    return up(dense), up(encoded), exact


def q6_oracle(li, pool) -> float:
    """Q6 revenue in numpy: float32 compares and products, float64 sum."""
    ship, _ = li["l_shipdate"]
    disc, qty, price = li["l_discount"], li["l_quantity"], li["l_extendedprice"]
    # the pool is sorted, so a date compare is a compare of its code
    lo, hi = np.searchsorted(pool, ["1994-01-01", "1995-01-01"])
    m = ((ship >= lo) & (ship < hi)
         & (disc >= np.float32(0.06 - 0.01)) & (disc <= np.float32(0.06 + 0.01001))
         & (qty < np.float32(24)))
    return float(np.sum((price[m] * disc[m]).astype(np.float64)))


def q1_oracle(li, pool):
    """Q1 rows in numpy: float32 expressions, float64 sums, groups in key
    order."""
    ship, _ = li["l_shipdate"]
    rf_codes, rf_pool = li["l_returnflag"]
    ls_codes, ls_pool = li["l_linestatus"]
    m = ship < np.searchsorted(pool, "1998-12-01", side="right")  # the pool is sorted
    qty, price = li["l_quantity"][m], li["l_extendedprice"][m]
    disc, tax = li["l_discount"][m], li["l_tax"][m]
    one = np.float32(1)
    disc_price = price * (one - disc)
    charge = disc_price * (one + tax)
    n_ls = len(ls_pool)
    gid = rf_codes[m].astype(np.int64) * n_ls + ls_codes[m]
    g = len(rf_pool) * n_ls

    def sums(v):
        return np.bincount(gid, weights=v.astype(np.float64), minlength=g)

    counts = np.bincount(gid, minlength=g)
    s_qty, s_price, s_disc = sums(qty), sums(price), sums(disc)
    s_disc_price, s_charge = sums(disc_price), sums(charge)
    rows = []
    for i in np.nonzero(counts)[0]:
        rows.append((str(rf_pool[i // n_ls]), str(ls_pool[i % n_ls]), s_qty[i],
                     s_price[i], s_disc_price[i], s_charge[i],
                     s_qty[i] / counts[i], s_price[i] / counts[i],
                     s_disc[i] / counts[i], int(counts[i])))
    return sorted(rows, key=lambda r: (r[0], r[1]))


def check_q1(actual, expected) -> float:
    """Keys and counts equal, floats within 1e-6 relative; returns the
    largest relative float difference."""
    if len(actual) != len(expected):
        raise AssertionError(f"Q1: {len(actual)} groups, oracle {len(expected)}")
    worst = 0.0
    for a, e in zip(actual, expected):
        if a[0] != e[0] or a[1] != e[1] or int(a[9]) != e[9]:
            raise AssertionError(f"Q1 keys/counts differ: {a} vs {e}")
        for x, y in zip(a[2:9], e[2:9]):
            if not np.isfinite(float(x)):
                raise AssertionError(f"Q1 non-finite value in {a}")
            worst = max(worst, rel_diff(float(x), float(y)))
    if worst > 1e-6:
        raise AssertionError(f"Q1 floats differ by {worst:.3e} relative")
    return worst


def timed_query(run):
    """Host-clock ms of run() (which ends in a host read) over QUERY_REPS
    runs: (first, median), and the last result."""
    times, out = [], None
    for _ in range(QUERY_REPS):
        t0 = time.perf_counter()
        out = run()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[0], statistics.median(times), out


def turns(pairs, device, time_ms):
    """Median device ms per name; `pairs` lists (name, fn) in the order the
    timed blocks run (plain, kernel, kernel, plain), each block timed by
    bench_q6.time_ms."""
    ms = {}
    for name, fn in pairs:
        ms.setdefault(name, []).append(time_ms(fn, device))
    return {k: statistics.median(v) for k, v in ms.items()}


def k3_inputs(n: int, n_cells: int, device):
    """Seeded values of the four types and cell ids for K3. The float values
    are binary fractions small enough that every partial sum is exact in
    float64, so any summation order gives the same sum; `noisy` are
    arbitrary doubles for the run-to-run check."""
    rng = np.random.default_rng(n * 67 + n_cells)
    cell = rng.integers(-1, n_cells + 1, n).astype(np.int32)  # some rows outside
    values = {
        "float64": rng.integers(0, 10**7, n) / 128.0,
        "float32": (rng.integers(0, 2**14, n) / 4.0).astype(np.float32),
        "int64": rng.integers(-10**12, 10**12, n),
        "int32": rng.integers(-10**6, 10**6, n).astype(np.int32),
    }
    noisy = rng.random(n) * 1e5 - 2e4
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {k: up(v) for k, v in values.items()}, up(cell), up(noisy)


def check_k3(n: int, device, group_reduce) -> float:
    """K3 against its plain version at n rows; returns the largest absolute
    difference of a float sum."""
    worst = 0.0
    for n_cells in K3_CELLS:
        values, cell, noisy = k3_inputs(n, n_cells, device)
        cases = [("count", None, None)]
        for name, v in values.items():
            cases.append(("sum", name, v))
            for kind in ("min", "max"):
                cases.append((kind, name, v))
        for kind, name, v in cases:
            sentinel = None
            if kind in ("min", "max"):
                if v.is_floating_point():
                    sentinel = float("inf") if kind == "min" else float("-inf")
                else:
                    info = torch.iinfo(v.dtype)
                    sentinel = info.max if kind == "min" else info.min
            got = group_reduce.segment_reduce_cells(v, cell, n_cells, kind, sentinel)
            ref = group_reduce.segment_reduce_cells_plain(v, cell, n_cells, kind, sentinel)
            torch.cuda.synchronize()
            if got.dtype != ref.dtype or got.shape != ref.shape:
                raise AssertionError(f"K3 {kind} {name} n={n} cells={n_cells}: "
                                     f"{got.dtype}{tuple(got.shape)} vs plain "
                                     f"{ref.dtype}{tuple(ref.shape)}")
            if kind == "sum" and got.dtype == torch.float64:
                diff = (got - ref).abs()
                if bool((diff > 1e-12 * ref.abs().clamp(min=1.0)).any()):
                    raise AssertionError(f"K3 sum {name} n={n} cells={n_cells}: "
                                         f"{got.tolist()} vs plain {ref.tolist()}")
                worst = max(worst, float(diff.max()))
            elif not torch.equal(got, ref):
                raise AssertionError(f"K3 {kind} {name} n={n} cells={n_cells}: "
                                     f"{got.tolist()} vs plain {ref.tolist()}")
        # arbitrary doubles: the same bits from two launches, and the plain
        # version's sum up to its own summation order
        a = group_reduce.segment_reduce_cells(noisy, cell, n_cells, "sum")
        b = group_reduce.segment_reduce_cells(noisy, cell, n_cells, "sum")
        ref = group_reduce.segment_reduce_cells_plain(noisy, cell, n_cells, "sum")
        if not torch.equal(a, b):
            raise AssertionError(f"K3 n={n} cells={n_cells}: two launches differ")
        if bool(((a - ref).abs() > 1e-9 * ref.abs().clamp(min=1.0)).any()):
            raise AssertionError(f"K3 noisy sum n={n} cells={n_cells}: {a.tolist()} "
                                 f"vs plain {ref.tolist()}")
    return worst


def k4_inputs(n: int, device):
    """Build keys (a quarter of n, duplicates, a fifth invalid, some outside
    the range), n probe keys and the key range."""
    rng = np.random.default_rng(n + 4)
    nb = n // 4 + 1
    lo, hi = -7, max(n, 8)
    build_keys = rng.integers(lo - 3, hi + 4, nb)
    valid = rng.random(nb) > 0.2
    probe_keys = rng.integers(lo - 5, hi + 6, n)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(build_keys), up(valid), up(probe_keys), lo, hi


def max_abs_diff(pairs) -> float:
    """Largest absolute difference over (got, plain) tensor pairs."""
    worst = 0.0
    for got, ref in pairs:
        if got.numel():
            worst = max(worst, float((got.to(torch.float64)
                                      - ref.to(torch.float64)).abs().max()))
    return worst


def same_lookup(args, join_probe, what: str) -> float:
    """K4 on `args` equal to its plain version, and the same bits from two
    launches; returns the largest absolute difference."""
    matched, rows = join_probe.lookup_last_eq_lut(*args)
    again = join_probe.lookup_last_eq_lut(*args)
    ref_matched, ref_rows = join_probe.lookup_last_eq_lut_plain(*args)
    torch.cuda.synchronize()
    if matched.dtype != torch.bool or rows.dtype != torch.int64:
        raise AssertionError(f"K4 {what}: {matched.dtype}, {rows.dtype}")
    if not (torch.equal(matched, ref_matched) and torch.equal(rows, ref_rows)):
        raise AssertionError(f"K4 lookup_last_eq_lut {what} differs from its plain version")
    if not (torch.equal(matched, again[0]) and torch.equal(rows, again[1])):
        raise AssertionError(f"K4 lookup_last_eq_lut {what}: two launches differ")
    return max_abs_diff(((matched, ref_matched), (rows, ref_rows)))


def check_k4(n: int, device, join_probe) -> float:
    """K4 against its plain version; returns the largest absolute
    difference (the check itself is equality)."""
    args = k4_inputs(n, device)
    worst = same_lookup(args, join_probe, f"at n={n}")
    if n > 1 and not bool(join_probe.lookup_last_eq_lut(*args)[0].any()):
        raise AssertionError(f"K4 at n={n}: nothing matched, the check is empty")
    return worst


K4_SHAPES = ("views one element into a buffer", "every probe key outside the range",
             "empty build side", "every build row invalid",
             "a third of the build rows on one key", "a table of LUT_MAX_ENTRIES entries",
             "lengths 1 to 9")


def check_k4_shapes(n: int, device, join_probe) -> float:
    """K4 in the K4_SHAPES at n probe rows, each equal to the plain version
    and the same bits from two launches."""
    build_keys, valid, probe_keys, lo, hi = k4_inputs(n + 1, device)
    nb = build_keys.shape[0]
    worst = 0.0
    views = (build_keys[1:], valid[1:], probe_keys[1:], lo, hi)
    if views[0].data_ptr() % 16 == build_keys.data_ptr() % 16:
        raise AssertionError("K4: the view is not off its buffer's 16-byte boundary")
    one_key = torch.where(torch.rand(nb, device=device) < 1 / 3, build_keys[0], build_keys)
    rng = np.random.default_rng(n + 44)
    top = join_probe.LUT_MAX_ENTRIES - 1
    wide = [torch.as_tensor(rng.integers(-3, top + 4, k), device=device) for k in (nb, n)]
    cases = {
        K4_SHAPES[0]: views,
        K4_SHAPES[1]: (build_keys, valid, probe_keys + (hi - lo + 50), lo, hi),
        K4_SHAPES[2]: (build_keys[:0], valid[:0], probe_keys, lo, hi),
        K4_SHAPES[3]: (build_keys, torch.zeros_like(valid), probe_keys, lo, hi),
        K4_SHAPES[4]: (one_key, valid | True, probe_keys, lo, hi),
        K4_SHAPES[5]: (wide[0], valid, wide[1], 0, top),
    }
    for what, args in cases.items():
        worst = max(worst, same_lookup(args, join_probe, f"{what}, n={n}"))
    for shape in (K4_SHAPES[1], K4_SHAPES[2], K4_SHAPES[3]):
        if bool(join_probe.lookup_last_eq_lut(*cases[shape])[0].any()):
            raise AssertionError(f"K4 {shape}: something matched")
    for nb_small in range(0, 10):
        for nq in range(1, 10):
            for off in (0, 1):  # whole buffers, and views one element in
                args = (build_keys[off:off + nb_small], valid[off:off + nb_small],
                        build_keys[off + 3:off + 3 + nq], lo, hi)
                worst = max(worst, same_lookup(args, join_probe,
                                               f"{nb_small} build rows, {nq} probes"))
    return worst


def k5_inputs(n: int, device):
    """n probe ranges of 0 to 3 build rows (one of them long, as a skewed
    key has) over a build side of n // 4 + 4 rows."""
    rng = np.random.default_rng(n + 5)
    nb = n // 4 + 4
    counts = rng.integers(0, 4, n).astype(np.int32)
    counts = np.minimum(counts, nb).astype(np.int32)
    if n > 1000:
        counts[n // 2] = min(100_000, nb)
    lo = (rng.integers(0, nb, n) % (nb - counts + 1)).astype(np.int32)
    perm = rng.permutation(nb).astype(np.int64)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(lo), up(counts), up(perm)


def k5_skewed_inputs(n: int, device):
    """k5_inputs with one range made as long as half of all the others
    together: a third of the pairs come from one probe row."""
    lo, counts, perm = k5_inputs(n, device)
    counts = counts.clone()
    counts[n // 2] = 0
    big = int(counts.sum()) // 2
    perm = torch.cat([perm, torch.arange(big, device=device)])
    lo = lo.clone()
    lo[n // 3], counts[n // 3] = 0, big
    return lo, counts, perm


def same_pairs(args, join_probe, what: str):
    """K5 on `args` equal to its plain version; returns the number of pairs
    and the largest absolute difference."""
    probe, rows = join_probe.expand_pairs(*args)
    ref_probe, ref_rows = join_probe.expand_pairs_plain(*args)
    torch.cuda.synchronize()
    if probe.dtype != torch.int64 or rows.dtype != torch.int64:
        raise AssertionError(f"K5 {what}: {probe.dtype}, {rows.dtype}")
    if not (torch.equal(probe, ref_probe) and torch.equal(rows, ref_rows)):
        raise AssertionError(f"K5 expand_pairs {what} differs from its plain version")
    return probe.shape[0], max_abs_diff(((probe, ref_probe), (rows, ref_rows)))


K5_REPEATS = 200               # launches per size in the repeated check
K5_REPEATED_SIZES = (65_543, 6_006_330)
K5_BAD_RANGES = {"end past build": ([0, 3], [1, 2]), "negative lo": ([-1, 0], [1, 1]),
                 "negative count": ([0, 0], [1, -1]),
                 "empty range past build": ([5, 0], [0, 1]),
                 "end past int32": ([2**31 - 1, 0], [2**31 - 1, 1])}


def check_k5(n: int, device, join_probe):
    """K5 against its plain version; at the K5_REPEATED_SIZES also
    K5_REPEATS launches in a row, each held against the plain version (a
    look-back that misses a tile once in a hundred launches fails here).
    Returns the number of pairs and the largest absolute difference (the
    check itself is equality)."""
    args = k5_inputs(n, device)
    pairs, worst = same_pairs(args, join_probe, f"at n={n}")
    if n in K5_REPEATED_SIZES:
        ref = join_probe.expand_pairs_plain(*args)
        for i in range(K5_REPEATS):
            got = join_probe.expand_pairs(*args)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"K5 expand_pairs at n={n}: launch {i} of "
                                     f"{K5_REPEATS} differs from its plain version")
    return pairs, worst


def check_k5_shapes(n: int, device, join_probe) -> float:
    """K5 in the shapes its two kernels have to get right, each equal to the
    plain version: n ranges of which all but five are empty; one range over
    the whole build side; the triangular ranges of a `<` join; one range of
    150,000 pairs among empty ones; totals of 0, 1, one output tile and one
    more; range counts around the scan's tile; ranges as views one element
    into their buffers; and the K5_BAD_RANGES, which must raise."""
    up = lambda a, dtype=np.int32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, dtype=dtype), device=device)
    scan_tile, out_tile = join_probe.scan_tile_rows(), join_probe.out_tile_pairs()
    rng = np.random.default_rng(n + 55)
    nb = n // 4 + 4
    perm = up(rng.permutation(nb), np.int64)
    cases = {}
    few = np.zeros(n, dtype=np.int32)
    few[rng.integers(0, n, 5)] = rng.integers(1, 4, 5)
    cases[f"{n} ranges, all empty but 5"] = (up(np.minimum(few, 1)), up(few), perm)
    cases["one range over the whole build side"] = (up([0]), up([nb]), perm)
    side = 3000
    cases[f"triangular, {side} ranges"] = (up(np.zeros(side)), up(np.arange(side)),
                                          up(rng.permutation(side), np.int64))
    long_one = np.zeros(1000, dtype=np.int32)
    long_one[500] = min(150_000, nb)
    cases["one range of 150,000 pairs"] = (up(np.zeros(1000)), up(long_one), perm)
    for total in (0, 1, out_tile, out_tile + 1):
        counts = np.zeros(5000, dtype=np.int32)
        for _ in range(total):
            counts[rng.integers(0, 5000)] += 1
        cases[f"a total of {total}"] = (up(rng.integers(0, nb - 8, 5000)), up(counts), perm)
    for ranges in (scan_tile - 1, scan_tile, scan_tile + 1):
        counts = np.minimum(rng.integers(0, 4, ranges + 1), nb)
        lo = rng.integers(0, nb, ranges + 1) % (nb - counts + 1)
        cases[f"{ranges} ranges"] = (up(lo)[:ranges], up(counts)[:ranges], perm)
        counts = np.minimum(counts, nb - 1)  # perm[1:] is one row shorter
        cases[f"{ranges} ranges as views"] = (up(lo % (nb - counts))[1:], up(counts)[1:],
                                              perm[1:])
    worst, totals = 0.0, {}
    for what, args in cases.items():
        totals[what], err = same_pairs(args, join_probe, f"{what}, n={n}")
        worst = max(worst, err)
    for total in (0, 1, out_tile, out_tile + 1):
        if totals[f"a total of {total}"] != total:
            raise AssertionError(f"K5: the case of {total} pairs has another total")
    if totals[f"triangular, {side} ranges"] != side * (side - 1) // 2:
        raise AssertionError("K5: the triangular case has another total")
    small_perm = torch.arange(4, device=device)
    for what, (lo, counts) in K5_BAD_RANGES.items():
        try:
            join_probe.expand_pairs(torch.tensor(lo, dtype=torch.int32, device=device),
                                    torch.tensor(counts, dtype=torch.int32, device=device),
                                    small_perm)
        except ValueError as exc:
            if "outside the build side" not in str(exc):
                raise
        else:
            raise AssertionError(f"K5: ranges with {what} did not raise on the card")
    return worst


def exact_values(rng, n: int, device):
    """Seeded values of the four types. The float values are binary
    fractions small enough that every partial sum is exact in float64, so any
    summation order gives the same sum."""
    values = {
        "float64": rng.integers(0, 10**7, n) / 128.0,
        "float32": (rng.integers(0, 2**14, n) / 4.0).astype(np.float32),
        "int64": rng.integers(-10**12, 10**12, n),
        "int32": rng.integers(-10**6, 10**6, n).astype(np.int32),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in values.items()}


def same_reduction(got, ref, what: str) -> float:
    """Dtype and shape equal; a float64 result within 1e-12 relative, any
    other equal. Returns the largest absolute difference."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
                             f"{ref.dtype}{tuple(ref.shape)}")
    if got.numel() == 0:
        return 0.0
    if got.is_floating_point():  # a NaN of a min or max must be a NaN in both
        nan = torch.isnan(ref)
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(f"{what}: NaN where its plain version has none, or not")
        got, ref = torch.where(nan, 0.0, got), torch.where(nan, 0.0, ref)
    if got.dtype == torch.float64:
        both_inf = torch.isinf(got) & (got == ref)  # an empty group's extreme
        diff = torch.where(both_inf, 0.0, (got - ref).abs())
        if bool((diff > 1e-12 * ref.abs().clamp(min=1.0)).any()):
            raise AssertionError(f"{what}: differs from plain by {float(diff.max())}")
        return float(diff.max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{what}: differs from its plain version")
    return 0.0


def k6_inputs(n: int, shape: str, device):
    """(mask, keys, sizes, slots) for K6. 'q1': Q1's launch, two code
    columns of 3 x 2 cells, the sums of five float32 inputs (two of them
    read by a second slot, as AVG shares SUM's input) and COUNT(*), 98% of
    the rows. 'q6': no key, one float32 sum, 2% of the rows. 'mixed': 64
    cells, the four input types, sum, min, max and count, two validity
    columns. 'split': 64 cells and 16 nullable float64 sums, more
    accumulators than one launch holds."""
    rng = np.random.default_rng(n * 31 + len(shape))
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    v = exact_values(rng, n, device)
    share = {"q1": 0.98, "q6": 0.02}.get(shape, 0.7)
    mask = up(rng.random(n) < share)
    if shape == "q1":
        sizes = [3, 2]
        f = [up((rng.integers(0, 2**14, n) / 4.0).astype(np.float32)) for _ in range(5)]
        slots = [(f[0], None, "sum"), (f[1], None, "sum"), (f[2], None, "sum"),
                 (f[3], None, "sum"), (f[0], None, "sum"), (f[1], None, "sum"),
                 (f[4], None, "sum"), (None, None, "count")]
    elif shape == "q6":
        sizes, slots = [], [(v["float32"], None, "sum")]
    elif shape == "mixed":
        sizes = [4, 4, 4]
        va, vb = up(rng.random(n) < 0.6), up(rng.random(n) < 0.9)
        slots = [(v["float64"], va, "sum"), (v["int64"], None, "sum"),
                 (v["int32"], va, "min"), (v["float32"], None, "max"),
                 (v["int64"], vb, "max"), (v["float64"], vb, "min"),
                 (v["int32"], None, "sum"), (None, va, "count"), (None, None, "count")]
    else:
        sizes = [8, 8]
        slots = [(up(rng.integers(0, 10**7, n) / 128.0), up(rng.random(n) < 0.8), "sum")
                 for _ in range(16)]
    keys = [up(rng.integers(0, size, n).astype(np.int32)) for size in sizes]
    return mask, keys, sizes, slots


def check_k6(n: int, device, fused_reduce) -> float:
    """K6 against its plain version in four shapes; the same bits from two
    launches. Returns the largest absolute difference of a float sum."""
    worst = 0.0
    for shape, launches in (("q1", 1), ("q6", 1), ("mixed", 2), ("split", 6)):
        args = k6_inputs(n, shape, device)
        before = fused_reduce.fused_cells_reduce.launches
        counts, results = fused_reduce.fused_cells_reduce(*args)
        if fused_reduce.fused_cells_reduce.launches - before != launches:
            raise AssertionError(f"K6 {shape}: expected {launches} launch(es)")
        again_counts, again = fused_reduce.fused_cells_reduce(*args)
        ref_counts, ref = fused_reduce.fused_cells_reduce_plain(*args)
        torch.cuda.synchronize()
        same_reduction(counts, ref_counts, f"K6 {shape} n={n} row counts")
        if n > 1000 and int(counts.sum()) == 0:
            raise AssertionError(f"K6 {shape} n={n}: no row passed, the check is empty")
        for i, ((r, c), (r2, c2), (rr, rc)) in enumerate(zip(results, again, ref)):
            worst = max(worst, same_reduction(r, rr, f"K6 {shape} n={n} slot {i}"))
            same_reduction(c, rc, f"K6 {shape} n={n} slot {i} valid counts")
            if not (torch.equal(r, r2) and torch.equal(c, c2)):
                raise AssertionError(f"K6 {shape} n={n} slot {i}: two launches differ")
    return worst


CELLS_EDGE_SIZES = (2047, 2048, 2049, 37 * 2048 + 5)  # a tile -1 / +0 / +1, many tiles
CELLS_EDGE_COUNTS = (1, 2, 8, 9, 63, 64)               # every cell bucket's edges
CELLS_REPEATS = 200
CELLS_REPEAT_ROWS = 1_100_000  # block counts change up to about 130 x 4 tiles


def special_values(rng, n: int, device):
    """exact_values with NaN, +inf and -inf planted in the float columns
    (for min and max), and every column one element into a buffer of n + 1."""
    out = {}
    for name, v in exact_values(rng, n + 1, device).items():
        if v.is_floating_point():
            at = torch.as_tensor(rng.permutation(n + 1)[:3], device=device)
            v[at] = torch.tensor([float("nan"), float("inf"), float("-inf")],
                                 dtype=v.dtype, device=device)[:at.shape[0]]
        out[name] = v[1:]
    return out


def check_cells_edges(device, group_reduce, fused_reduce) -> float:
    """K3 and K6 (unless fused_reduce is None) against their plain versions
    at a tile's size -1 / +0 / +1 and over many tiles, at every cell
    bucket's edges, for the four types and the four folds, with NaN and
    +-inf in min and max, from columns one element into their buffers.
    Returns the largest float64 difference."""
    worst = 0.0
    for n in CELLS_EDGE_SIZES:
        for n_cells in CELLS_EDGE_COUNTS:
            rng = np.random.default_rng(n * 131 + n_cells)
            exact = {k: v[1:] for k, v in exact_values(rng, n + 1, device).items()}
            special = special_values(rng, n, device)
            cell = torch.as_tensor(rng.integers(-1, n_cells + 1, n + 1).astype(np.int32),
                                   device=device)[1:]
            what = f"n={n} cells={n_cells}"
            cases = [("count", None)] + [("sum", v) for v in exact.values()]
            cases += [(kind, v) for v in special.values() for kind in ("min", "max")]
            for kind, v in cases:
                sentinel = None if kind in ("sum", "count") else \
                    group_reduce.extreme(v.dtype, kind == "min")
                got = group_reduce.segment_reduce_cells(v, cell, n_cells, kind, sentinel)
                ref = group_reduce.segment_reduce_cells_plain(v, cell, n_cells, kind,
                                                              sentinel)
                worst = max(worst, same_reduction(
                    got, ref, f"K3 {kind} {None if v is None else v.dtype} {what}"))
            if fused_reduce is None:
                continue
            mask = torch.as_tensor(rng.random(n + 1) < 0.8, device=device)[1:]
            valid = torch.as_tensor(rng.random(n + 1) < 0.6, device=device)[1:]
            key = torch.as_tensor(rng.integers(0, n_cells, n + 1).astype(np.int32),
                                  device=device)[1:]
            slots = [(v, valid if i % 2 else None, "sum")
                     for i, v in enumerate(exact.values())]
            slots += [(v, None if i % 2 else valid, kind) for i, v in enumerate(special.values())
                      for kind in ("min", "max")]
            slots += [(None, valid, "count"), (None, None, "count")]
            counts, results = fused_reduce.fused_cells_reduce(mask, [key], [n_cells], slots)
            ref_counts, ref = fused_reduce.fused_cells_reduce_plain(mask, [key], [n_cells],
                                                                    slots)
            same_reduction(counts, ref_counts, f"K6 {what} row counts")
            for i, ((r, c), (rr, rc)) in enumerate(zip(results, ref)):
                worst = max(worst, same_reduction(r, rr, f"K6 {what} slot {i}"))
                same_reduction(c, rc, f"K6 {what} slot {i} valid counts")
    return worst


def check_cells_repeated(device, group_reduce, fused_reduce) -> None:
    """CELLS_REPEATS launches of K3 (three slots and the row count in one
    call, at 6 cells and at 40) and of K6 (unless fused_reduce is None) in a
    row over prefixes of changing length, so changing block counts, each
    held against its plain version: a ticket left standing would leave a
    launch without its combine."""
    rng = np.random.default_rng(606)
    n_max = CELLS_REPEAT_ROWS
    exact = exact_values(rng, n_max, device)
    valid = torch.as_tensor(rng.random(n_max) < 0.7, device=device)
    cell = torch.as_tensor(rng.integers(-1, 41, n_max).astype(np.int32), device=device)
    mask, keys, sizes, slots = k6_inputs(n_max, "q1", device)
    for i in range(CELLS_REPEATS):
        n = 1 + (i * 104_729) % n_max
        n_cells = 6 if i % 2 else 40
        k3_slots = [(exact["float64"][:n], valid[:n], "sum"), (exact["int32"][:n], None, "min"),
                    (None, valid[:n], "count")]
        counts, got = group_reduce.segment_reduce_cells_many(cell[:n], n_cells, k3_slots)
        ref_counts, ref = group_reduce.segment_reduce_cells_many_plain(cell[:n], n_cells,
                                                                      k3_slots)
        what = f"K3 launch {i} of {CELLS_REPEATS} (n={n}, {n_cells} cells)"
        same_reduction(counts, ref_counts, what)
        for (r, c), (rr, rc) in zip(got, ref):
            same_reduction(r, rr, what)
            same_reduction(c, rc, what)
        if fused_reduce is None:
            continue
        part = (mask[:n], [k[:n] for k in keys], sizes,
                [(None if x is None else x[:n], m, kind) for x, m, kind in slots])
        counts, results = fused_reduce.fused_cells_reduce(*part)
        ref_counts, ref = fused_reduce.fused_cells_reduce_plain(*part)
        same_reduction(counts, ref_counts, f"K6 launch {i} of {CELLS_REPEATS} (n={n})")
        for (r, _), (rr, _) in zip(results, ref):
            same_reduction(r, rr, f"K6 launch {i} of {CELLS_REPEATS} (n={n})")


def same_bits(a, b) -> bool:
    """Equal dtypes, shapes and bits (a NaN equal to the same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {torch.float64: torch.int64, torch.float32: torch.int32}[a.dtype]
        a, b = a.contiguous().view(as_int), b.contiguous().view(as_int)
    return torch.equal(a, b)


def k3_many_slots(rng, n: int, device, offset: int):
    """The slots of K3's many-slot checks: the count over every row and over
    a validity column, and per type a sum, a sum over a validity column, a
    min and a max, the mins and maxes over NaN and +-inf; 16 folds, two
    validity columns, so one launch. Every column starts `offset` elements
    into its buffer (the mins' and maxes' one)."""
    exact = {k: v[offset:] for k, v in exact_values(rng, n + offset, device).items()}
    special = special_values(rng, n, device)
    va = torch.as_tensor(rng.random(n + offset) < 0.6, device=device)[offset:]
    vb = torch.as_tensor(rng.random(n + offset) < 0.9, device=device)[offset:]
    slots = [(None, None, "count"), (None, va, "count")]
    for i, name in enumerate(sorted(exact)):
        slots += [(exact[name], None, "sum"), (exact[name], va if i % 2 else vb, "sum"),
                  (special[name], vb if i % 2 else None, "min"), (special[name], va, "max")]
    return slots


def k3_launches(group_reduce, n_cells: int, slots) -> int:
    """The launches plan_launches gives a many-slot call: its items are the
    distinct folds (values, kind, validity) and the validity columns only
    counted, as segment_reduce_cells_many forms them."""
    validities, folds = [], []
    for values, validity, kind in slots:
        v = next((i for i, m in enumerate(validities) if m is validity), -1)
        if validity is not None and v < 0:
            validities.append(validity)
            v = len(validities) - 1
        if kind != "count" and not any(f[0] is values and f[1:] == (kind, v) for f in folds):
            folds.append((values, kind, v))
    items = [(True, v) for _, _, v in folds]
    items += [(False, v) for v in range(len(validities)) if v not in {f[2] for f in folds}]
    return len(group_reduce.plan_launches(n_cells, items))


def same_many(group_reduce, cell, n_cells: int, slots, what: str):
    """K3's many-slot call against its plain version; it must launch the
    kernel as often as plan_launches says (once unless its accumulators
    leave no room for two blocks an SM). Returns (its results, the largest
    float64 difference)."""
    launches = k3_launches(group_reduce, n_cells, slots)
    before = group_reduce.segment_reduce_cells.launches
    counts, got = group_reduce.segment_reduce_cells_many(cell, n_cells, slots)
    if group_reduce.segment_reduce_cells.launches - before != launches:
        raise AssertionError(f"{what}: {group_reduce.segment_reduce_cells.launches - before} "
                             f"launches, expected {launches}")
    ref_counts, ref = group_reduce.segment_reduce_cells_many_plain(cell, n_cells, slots)
    same_reduction(counts, ref_counts, f"{what}: row counts")
    worst = 0.0
    for i, ((r, c), (rr, rc)) in enumerate(zip(got, ref)):
        worst = max(worst, same_reduction(r, rr, f"{what}: slot {i}"))
        same_reduction(c, rc, f"{what}: slot {i} valid counts")
    return got, worst


def check_k3_many(device, group_reduce) -> float:
    """K3 as one call for several reductions, against its plain version, at
    CELLS_EDGE_SIZES x CELLS_EDGE_COUNTS, from aligned columns and from
    views one element into their buffers: the first 1, 2, 6 and all 18
    slots of k3_many_slots, in as many launches as plan_launches says (one
    up to 8 cells); every slot's bits the same alone, batched
    and with the slots split over two calls; and a call that plan_launches
    splits (16 folds each over its own validity column, 64 cells) against
    its plain version and its slots alone. Returns the largest float64
    difference."""
    worst = 0.0
    many = group_reduce.segment_reduce_cells_many
    for n in CELLS_EDGE_SIZES:
        for n_cells in CELLS_EDGE_COUNTS:
            for offset in (0, 1):
                rng = np.random.default_rng(n * 151 + n_cells * 3 + offset)
                slots = k3_many_slots(rng, n, device, offset)
                cell = torch.as_tensor(rng.integers(-1, n_cells + 1, n + offset)
                                       .astype(np.int32), device=device)[offset:]
                what = f"K3 many n={n} cells={n_cells} offset={offset}"
                for k in (1, 2, 6, len(slots)):
                    got, err = same_many(group_reduce, cell, n_cells, slots[:k],
                                         f"{what}, {k} slots")
                    worst = max(worst, err)
                half = len(slots) // 2
                split = many(cell, n_cells, slots[:half])[1] + many(cell, n_cells,
                                                                    slots[half:])[1]
                for i, slot in enumerate(slots):
                    (alone, _), = many(cell, n_cells, [slot])[1]
                    if not (same_bits(alone, got[i][0]) and same_bits(split[i][0], got[i][0])):
                        raise AssertionError(f"{what}: slot {i} differs in bits alone, "
                                             "batched and split")
    n, n_cells = CELLS_EDGE_SIZES[-1], 64
    rng = np.random.default_rng(1864)
    slots = [(torch.as_tensor(rng.integers(0, 10**7, n) / 128.0, device=device),
              torch.as_tensor(rng.random(n) < 0.8, device=device), "sum") for _ in range(16)]
    cell = torch.as_tensor(rng.integers(-1, n_cells + 1, n).astype(np.int32), device=device)
    if k3_launches(group_reduce, n_cells, slots) < 2:
        raise AssertionError("the split check's call is not split")
    got, err = same_many(group_reduce, cell, n_cells, slots, "K3 many, split by plan_launches")
    for i, slot in enumerate(slots):
        (alone, _), = many(cell, n_cells, [slot])[1]
        if not same_bits(alone, got[i][0]):
            raise AssertionError(f"K3 many split by plan_launches: slot {i} differs in bits "
                                 "from its call alone")
    return max(worst, err)


def check_k3_all(device, group_reduce) -> float:
    """Every K3 check: check_k3 at KERNEL_SIZES, the edge shapes, the
    many-slot calls and CELLS_REPEATS launches in a row."""
    err = check_cells_edges(device, group_reduce, None)
    check_cells_repeated(device, group_reduce, None)
    err = max(err, check_k3_many(device, group_reduce))
    for size in KERNEL_SIZES:
        err = max(err, check_k3(size, device, group_reduce))
    log(f"kernels: K3 equal to plain at {KERNEL_SIZES} rows, at {CELLS_EDGE_SIZES} rows x "
        f"{CELLS_EDGE_COUNTS} cells alone and as 1, 2, 6 and 18 slots in one call from "
        f"aligned columns and views, a slot's bits the same alone, batched and split, in "
        f"{CELLS_REPEATS} launches in a row (largest float64 difference {err!r})")
    return err


# K3's timed calls of several slots: Q1's dense Aggregate (6 cells, COUNT(*),
# SUM and AVG over 4 float32 columns: 7 slots, 4 folds), Q5's (25 cells,
# COUNT(*), one float64 sum) and 64 cells with 3 slots of mixed folds over
# one validity column
K3_MANY_TIMED = ("q1", "q5", "mixed64")


def k3_many_inputs(n: int, shape: str, device):
    """(cell, n_cells, slots) of a K3_MANY_TIMED shape, every row inside the
    cell space."""
    rng = np.random.default_rng(n * 7 + len(shape))
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    if shape == "q1":
        n_cells = 6
        f = [up((rng.integers(0, 2**14, n) / 4.0).astype(np.float32)) for _ in range(4)]
        slots = [(x, None, "sum") for x in f] + [(x, None, "sum") for x in f[:3]]
    elif shape == "q5":
        n_cells = 25
        slots = [(up(rng.integers(0, 10**7, n) / 128.0), None, "sum")]
    else:
        n_cells = 64
        v = exact_values(rng, n, device)
        valid = up(rng.random(n) < 0.7)
        slots = [(v["float64"], valid, "sum"), (v["int32"], None, "min"),
                 (v["float32"], valid, "max")]
    return up(rng.integers(0, n_cells, n).astype(np.int32)), n_cells, slots


def k3_one_call_a_reduction(reduce, extreme, cell, n_cells: int, slots) -> list:
    """The K3 calls of a dense Aggregate that reduces one slot a call
    (`reduce`: segment_reduce_cells, or its plain version): the row count, a
    `where` and a count for each validity column, then one call a slot that
    is not a count (SUM and AVG of a column each their own). Returns their
    results in that order."""
    out = [reduce(None, cell, n_cells, "count")]
    moved = {}
    for values, validity, kind in slots:
        c = cell
        if validity is not None:
            if id(validity) not in moved:
                moved[id(validity)] = torch.where(validity, cell, n_cells)
                out.append(reduce(None, moved[id(validity)], n_cells, "count"))
            c = moved[id(validity)]
        if kind != "count":
            sentinel = None if kind == "sum" else extreme(values.dtype, kind == "min")
            out.append(reduce(values, c, n_cells, kind, sentinel))
    return out


# K3's timed shapes: (label, values type, cells); f32 into 6 and 25 cells are
# Q1's and Q5's on the main path
K3_TIMED = (("f32x6", "float32", 6), ("f32x25", "float32", 25), ("f64x1", "float64", 1),
            ("f64x4", "float64", 4), ("f64x64", "float64", 64))


def time_cells(n: int, device, card: str, time_ms, group_reduce, fused_reduce,
               one_kernel: bool):
    """Median device ms of K3 at K3_TIMED and K3_MANY_TIMED and of K6 in
    Q1's and Q6's shapes (unless fused_reduce is None), beside the plain
    versions and the yardsticks (index_add_ for K3's one sum; for K3's calls
    of several slots the calls of one slot each that they replace; for K6
    the cell column by `where` and the K3 launches it replaces), each shape
    first held against its plain version; and each kernel's own device time
    from torch.profiler, which with `one_kernel` must show one device kernel
    and no memset a call of K3 and of K6. A package without
    segment_reduce_cells_many (an older checkout) times its calls of one
    slot each in the K3_MANY_TIMED rows. Returns ({label: times}, largest
    difference)."""
    out, worst = {}, 0.0

    def record(label, kernel, plain, library, nbytes, note, flops=0):
        t = turns((("plain", plain), ("kernel", kernel), ("library", library),
                   ("kernel", kernel), ("plain", plain)), device, time_ms)
        t["bytes"] = nbytes
        t["bound"] = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_PER_S) * 1e3
        t["kernel_only"], t["per_call"] = kernel_only_ms(kernel, device)
        if one_kernel and label.startswith(("K3", "K6")) and t["per_call"] != 1:
            raise AssertionError(f"{label}: {t['per_call']} device kernels and memsets a "
                                 "call, not one kernel")
        out[label] = t
        log(f"kernels n={n} {label} median device ms {card}: kernel {t['kernel']:.4f}, "
            f"plain {t['plain']:.4f}, {note} {t['library']:.4f}, bound {t['bound']:.4f} "
            f"({nbytes / t['kernel'] / 1e6:.1f} GB/s); kernel-only device ms "
            f"(torch.profiler, {t['per_call']} kernels and memsets a call) "
            + ", ".join(f"{k} {ms:.4f}" for k, ms in t["kernel_only"].items()))

    for label, dtype, n_cells in K3_TIMED:
        values, cell, _ = k3_inputs(n, n_cells, device)
        v = values[dtype]
        cell = cell.clamp(0, n_cells - 1)  # every row inside, as after Q1's scan
        v64, cell64 = v.to(torch.float64), cell.to(torch.int64)
        kernel = lambda i, v=v, c=cell, k=n_cells: (  # noqa: E731
            group_reduce.segment_reduce_cells(v, c, k, "sum"))
        plain = lambda i, v=v, c=cell, k=n_cells: (  # noqa: E731
            group_reduce.segment_reduce_cells_plain(v, c, k, "sum"))
        library = lambda i, v=v64, c=cell64, k=n_cells: (  # noqa: E731
            torch.zeros(k, dtype=torch.float64, device=device).index_add_(0, c, v))
        got, ref = kernel(0), plain(0)
        worst = max(worst, same_reduction(got, ref, f"K3 sum {label} n={n}"))
        if not torch.equal(library(0), ref):
            raise AssertionError(f"K3 {label}: index_add_ is not the same function")
        record(f"K3 {label}", kernel, plain, library,
               n * (v.element_size() + 4) + n_cells * 8, "index_add_", flops=n)

    many = getattr(group_reduce, "segment_reduce_cells_many", None)
    for shape in K3_MANY_TIMED:
        args = k3_many_inputs(n, shape, device)
        cell, n_cells, slots = args
        calls = lambda i, a=args: k3_one_call_a_reduction(  # noqa: E731
            group_reduce.segment_reduce_cells, group_reduce.extreme, *a)
        flat = lambda i, a=args: k3_one_call_a_reduction(  # noqa: E731
            group_reduce.segment_reduce_cells_plain, group_reduce.extreme, *a)
        for i, (got, ref) in enumerate(zip(calls(0), flat(0))):
            worst = max(worst, same_reduction(got, ref, f"K3 {shape} call {i} of one slot"))
        kernel, plain = calls, flat
        if many is not None:
            kernel = lambda i, a=args: many(*a)  # noqa: E731
            plain = lambda i, a=args: group_reduce.segment_reduce_cells_many_plain(*a)  # noqa
            _, err = same_many(group_reduce, *args, f"K3 {shape} timed")
            worst = max(worst, err)
        values = {id(v): v for v, _, _ in slots if v is not None}
        validities = {id(m): m for _, m, _ in slots if m is not None}
        folds = {(id(v), id(m), kind) for v, m, kind in slots if kind != "count"}
        nbytes = n * 4 + sum(v.numel() * v.element_size() for v in values.values()) \
            + n * len(validities) + 8 * n_cells * (1 + len(validities) + len(folds))
        record(f"K3 {shape}", kernel, plain, calls, nbytes,
               f"{len(calls(0))} calls of one slot each")

    if fused_reduce is None:
        return out, worst
    for shape in ("q1", "q6"):
        mask, keys, sizes, slots = k6_inputs(n, shape, device)
        n_cells = int(np.prod(sizes)) if sizes else 1
        got, ref = (f(mask, keys, sizes, slots) for f in
                    (fused_reduce.fused_cells_reduce, fused_reduce.fused_cells_reduce_plain))
        for i, ((r, c), (rr, rc)) in enumerate(zip(got[1], ref[1])):
            worst = max(worst, same_reduction(r, rr, f"K6 {shape} timed slot {i}"))
            same_reduction(c, rc, f"K6 {shape} timed slot {i} valid counts")

        def k3_launches(i, mask=mask, keys=keys, sizes=sizes, slots=slots, k=n_cells):
            cell = torch.zeros(n, dtype=torch.int32, device=device)
            for key, size in zip(keys, sizes):
                cell = cell * size + key
            cell = torch.where(mask, cell, k)
            res = [group_reduce.segment_reduce_cells(None, cell, k, "count")]
            for values, _, kind in slots:
                if kind == "sum":
                    res.append(group_reduce.segment_reduce_cells(values, cell, k, "sum"))
            return res

        lib_out = k3_launches(0)
        same_reduction(lib_out[0], got[0], f"K6 {shape}: the K3 launches' row count")
        same_reduction(lib_out[1], got[1][0][0], f"K6 {shape}: the K3 launches' first sum")
        distinct = {id(v): v for v, _, _ in slots if v is not None}
        nbytes = n * (1 + 4 * len(keys)) + sum(v.element_size() * n for v in
                                               distinct.values()) \
            + 8 * n_cells * (1 + len(slots))
        record(f"K6 {shape}",
               lambda i, a=(mask, keys, sizes, slots): fused_reduce.fused_cells_reduce(*a),
               lambda i, a=(mask, keys, sizes, slots):
                   fused_reduce.fused_cells_reduce_plain(*a),
               k3_launches, nbytes, f"where + {len(lib_out)} K3 launches")
    return out, worst


K7_SHAPES = ("4 rows a group", "1000 groups", "one group", "skewed", "tile boundaries",
             "empty runs", "offset start", "32 short then one long")
K7_TIMED = ("4 rows a group", "1000 groups", "skewed")


def k7_columns(n: int, device):
    """n rows for K7: values of the four types, a permutation, a validity
    column and arbitrary doubles."""
    rng = np.random.default_rng(n * 13 + 7)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (exact_values(rng, n, device), up(rng.permutation(n).astype(np.int64)),
            up(rng.random(n) < 0.7), up(rng.random(n) * 1e5 - 2e4))


def k7_starts(n: int, shape: str, tile: int, device):
    """Offsets of sorted segments over n positions (some groups empty).
    '4 rows a group' and '1000 groups' cut at uniform random places; 'one
    group' holds every row; 'skewed' is n // 4 groups of which one holds a
    third of the rows; 'tile boundaries' puts every boundary on a multiple
    of the kernel's tile; 'empty runs' adds runs of 70 empty groups at the
    first position, on the tile boundary nearest the middle and at the last
    position; 'offset start' begins at n // 3 and ends at n - n // 5; '32
    short then one long' is 32 groups of one row and one group of the rest,
    so every later tile's search for its first group runs over 33 groups and
    finds none (a search that took 33 steps for 32 probes missed it)."""
    rng = np.random.default_rng(n * 13 + K7_SHAPES.index(shape))

    def cut(lo, hi, n_groups):
        cuts = np.sort(rng.integers(lo, hi + 1, max(n_groups - 1, 0)))
        return np.concatenate([[lo], cuts, [hi]])

    if shape == "4 rows a group":
        starts = cut(0, n, n // 4 + 1)
    elif shape == "1000 groups":
        starts = cut(0, n, min(n, 1000))
    elif shape == "one group":
        starts = np.array([0, n])
    elif shape == "skewed":
        big = n // 3
        rest = cut(0, n - big, max(n // 4 - 1, 1))
        at = len(rest) // 2
        starts = np.concatenate([rest[:at + 1], rest[at:] + big])
    elif shape == "tile boundaries":
        starts = np.arange(0, n + 1, tile) if n >= tile else np.array([0, n])
    elif shape == "empty runs":
        starts = cut(0, n, n // 4 + 1)
        middle = (n // 2) // tile * tile
        starts = np.sort(np.concatenate([starts, np.repeat([0, middle, n], 70)]))
    elif shape == "offset start":
        starts = cut(n // 3, n - n // 5, n // 8 + 1)
    else:
        starts = np.append(np.arange(min(33, n)), n)
    return torch.as_tensor(starts.astype(np.int64), device=device)


def check_k7(n: int, device, segment_reduce) -> float:
    """K7 against its plain version in the K7_SHAPES: sum, min and max of the
    four types and the count, with and without the permutation and the
    validity column; the same bits from two launches."""
    worst = 0.0
    tile = segment_reduce.tile_positions()
    values, rows, validity, noisy = k7_columns(n, device)
    cases = [("count", None)]
    for name in values:
        cases += [("sum", name), ("min", name), ("max", name)]
    for shape in K7_SHAPES:
        starts = k7_starts(n, shape, tile, device)
        for kind, name in cases:
            v = None if name is None else values[name]
            for r, m in ((rows, validity), (None, None), (rows, None), (None, validity)):
                got = segment_reduce.segment_reduce_sorted(v, starts, kind, r, m)
                again = segment_reduce.segment_reduce_sorted(v, starts, kind, r, m)
                ref = segment_reduce.segment_reduce_sorted_plain(v, starts, kind, r, m)
                torch.cuda.synchronize()
                what = f"K7 {kind} {name} n={n} {shape}"
                worst = max(worst, same_reduction(got[0], ref[0], what))
                same_reduction(got[1], ref[1], what + " valid counts")
                if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                    raise AssertionError(f"{what}: two launches differ")
        a = segment_reduce.segment_reduce_sorted(noisy, starts, "sum", rows, validity)[0]
        b = segment_reduce.segment_reduce_sorted(noisy, starts, "sum", rows, validity)[0]
        ref = segment_reduce.segment_reduce_sorted_plain(noisy, starts, "sum", rows,
                                                         validity)[0]
        if not torch.equal(a, b):
            raise AssertionError(f"K7 n={n} {shape}: two launches differ")
        if bool(((a - ref).abs() > 1e-9 * ref.abs().clamp(min=1.0)).any()):
            raise AssertionError(f"K7 noisy sum n={n} {shape} differs from plain")
    return worst


def k8_inputs(n: int, kind: str, device):
    """Build keys (a quarter of n; each value about twice, as a join on a
    foreign key finds them, and one value 64 times; a fifth invalid) and n
    probe keys, half of them build keys: int64 keys spread over 2^40 values,
    more than the direct-address table takes, INT64_MIN among them; or
    float64 keys with -0.0, 0.0 and NaN among them."""
    rng = np.random.default_rng(n + 8 + len(kind))
    nb = n // 4 + 1
    pool = rng.integers(-2**39, 2**39, nb // 2 + 1)
    build_keys = rng.choice(pool, nb)
    build_keys[rng.integers(0, nb, min(64, nb))] = pool[0]
    probe_keys = np.where(rng.random(n) < 0.5, rng.choice(build_keys, n),
                          rng.integers(-2**39, 2**39, n))
    if kind == "float64":
        build_keys, probe_keys = build_keys / 8.0, probe_keys / 8.0
        special = np.array([-0.0, 0.0, np.nan, np.inf])
    else:
        special = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1])
    if n >= 1000:
        build_keys[1:5], build_keys[-4:] = special, special
        probe_keys[:4], probe_keys[-4:] = special, special[::-1]
    valid = rng.random(nb) > 0.2
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(build_keys), up(valid), up(probe_keys)


def k8_hot_key_inputs(n: int, device):
    """k8_inputs' int64 keys with a third of the build rows on ONE key: the
    skew that would serialise a build that always used its atomics."""
    build_keys, valid, probe_keys = k8_inputs(n, "int64", device)
    hot = torch.rand(build_keys.shape[0], device=device) < 1 / 3
    return torch.where(hot, build_keys[0], build_keys), valid, probe_keys


def check_k8(n: int, device, hash_lookup) -> float:
    """K8 against its plain version on int64 and float64 keys, and with an
    empty build side; the check is equality."""
    worst = 0.0
    for kind in ("int64", "float64", "hot key"):
        args = k8_hot_key_inputs(n, device) if kind == "hot key" \
            else k8_inputs(n, kind, device)
        for build_keys, valid, probe_keys in (args, (args[0][:0], args[1][:0], args[2])):
            matched, rows = hash_lookup.lookup_last_eq(build_keys, valid, probe_keys)
            ref_matched, ref_rows = hash_lookup.lookup_last_eq_plain(build_keys, valid,
                                                                     probe_keys)
            torch.cuda.synchronize()
            if not (torch.equal(matched, ref_matched) and torch.equal(rows, ref_rows)):
                raise AssertionError(f"K8 lookup_last_eq {kind} at n={n}, "
                                     f"{build_keys.shape[0]} build rows, differs from "
                                     "its plain version")
            worst = max(worst, max_abs_diff(((matched, ref_matched), (rows, ref_rows))))
    return worst


K9_SHARES = (0.0, 0.02, 0.5, 0.98, 1.0)


def k9_mask(n: int, share: float, device):
    rng = np.random.default_rng(n + int(share * 100))
    return torch.as_tensor(rng.random(n) < share, device=device)


K9_REPEATS = 200               # launches per size in the repeated check
K9_REPEATED_SIZES = (65_543, 6_006_330)


def check_k9(n: int, device, compact) -> float:
    """K9 against its plain version at five selectivities and from a view
    that starts one byte into its buffer; at the K9_REPEATED_SIZES also
    K9_REPEATS launches in a row, each held against the plain version (a
    look-back that misses a tile once in a hundred launches fails here). The
    check is equality."""
    worst = 0.0
    masks = []
    for share in K9_SHARES:
        mask = k9_mask(n + 1, share, device)
        for m in (mask[:n], mask[1:]):
            got, ref = compact.compact_indices(m), compact.compact_indices_plain(m)
            torch.cuda.synchronize()
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(f"K9 compact_indices at n={n}, share {share}, "
                                     "differs from its plain version")
            worst = max(worst, max_abs_diff(((got, ref),)))
            masks.append((m, ref))
    if n in K9_REPEATED_SIZES:
        for i in range(K9_REPEATS):
            m, ref = masks[i % len(masks)]
            if not torch.equal(compact.compact_indices(m), ref):
                raise AssertionError(f"K9 compact_indices at n={n}: launch {i} of "
                                     f"{K9_REPEATS} differs from its plain version")
    return worst


PROFILED_CALLS = 20


def kernel_only_ms(fn, device, keep_fills: bool = False):
    """Device ms per call of everything fn(i) runs on the card (kernels,
    memsets, copies), from one torch.profiler run over PROFILED_CALLS calls,
    each after an L2 flush (whose fill kernel is left out; with `keep_fills`
    only that one, so that the fills fn itself runs are counted, each as
    "fill <type>"): {short name: ms, ..., "sum": ms}, and the number of
    device kernels, memsets and copies per call. A profiler run that comes
    back without any device event, or with only a part of them (it happens
    once in some tens of runs), is made again, three times at most."""
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    flush = torch.empty(2 * max(l2, 1 << 20), dtype=torch.uint8, device=device)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    left_out = "FillFunctor<unsigned char>" if keep_fills else "FillFunctor"
    for _ in range(3):
        fn(0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            for i in range(PROFILED_CALLS):
                flush.zero_()
                fn(i)
            torch.cuda.synchronize()
        ms, launched = {}, 0
        for avg in prof.key_averages():
            if avg.device_type != torch.autograd.DeviceType.CUDA or left_out in avg.key:
                continue
            # torch renamed self_cuda_time_total to self_device_time_total
            total_us = getattr(avg, "self_device_time_total", None)
            if total_us is None:
                total_us = avg.self_cuda_time_total
            named = re.search(r"(\w+)(<.*>)?\(", avg.key)
            name = named.group(1) if named else avg.key[:40]
            fill = re.search(r"FillFunctor<([\w ]+)>", avg.key)
            if fill:
                name = f"fill {fill.group(1)}"
            ms[name] = ms.get(name, 0.0) + total_us / 1e3 / PROFILED_CALLS
            launched += avg.count
        # a run that lost part of its device events shows a broken number of
        # launches per call
        if ms and launched % PROFILED_CALLS == 0:
            ms["sum"] = sum(ms.values())
            return ms, launched // PROFILED_CALLS
    raise AssertionError("torch.profiler lost device events in three runs")


def listed(ms) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in ms.items())


# -- K2 and K8: the shapes their designs have to get right ----------------------

K2_RAGGED = tuple(range(1, 18))   # rows 1 to 17: the tail alone, one step and a row
REPEATS = 200                     # launches in a row at changing lengths (K2, K8)
REPEAT_ROWS = 1_100_000


def k2_columns(n: int, device, wrap: bool = False):
    """Seeded encoded Q6 columns of n rows, as kernel_inputs makes them;
    with `wrap`, prices up to 2^31 - 1, so that price * discount wraps in
    int32 on about half the rows."""
    rng = np.random.default_rng(n + 2 + wrap)
    hi = 2**31 - 1 if wrap else 10_495_000
    cols = (rng.integers(0, 2557, n).astype(np.int16),
            rng.integers(0, 11, n).astype(np.int8),
            rng.integers(1, 51, n).astype(np.int8),
            rng.integers(90_000, hi, n).astype(np.int32))
    return [torch.as_tensor(c, device=device) for c in cols]


def same_k2(cols, q6, what: str, lo: int = 731, hi: int = 1096) -> None:
    got, again = q6.q6_encoded(*cols, lo, hi), q6.q6_encoded(*cols, lo, hi)
    ref = q6.q6_encoded_reference(*cols, lo, hi)
    if not (got.dtype == ref.dtype == torch.int64 and got.shape == ref.shape
            and int(got) == int(ref) == int(again)):
        raise AssertionError(f"K2 {what}: {int(got)} (again {int(again)}) vs plain "
                             f"{int(ref)}")


def check_k2_edges(device, q6) -> str:
    """K2 against its plain version (exact int64 equality, and the same value
    from two launches) at 1 to 17 rows, around one block's step and one
    grid's step of rows, with and without int32 wrap of the products, from
    aligned columns and from views one element into their buffers; then
    REPEATS launches in a row at changing lengths (a ticket left standing
    would leave a launch without its total). Returns what it checked."""
    lib = q6._library()
    step = lib.q6_threads_per_block() * lib.q6_encoded_rows_per_step()
    grid_step = step * lib.q6_encoded_blocks_per_sm() * torch.cuda.get_device_properties(
        device).multi_processor_count
    sizes = K2_RAGGED + (step - 1, step, step + 1, grid_step - 1, grid_step,
                         grid_step + 1, 2 * grid_step + 17)
    for n in sizes:
        for wrap in (False, True):
            cols = k2_columns(n + 1, device, wrap)
            same_k2([c[:n] for c in cols], q6, f"n={n} wrap={wrap}")
            same_k2([c[1:] for c in cols], q6, f"n={n} wrap={wrap}, views")
    cols = k2_columns(REPEAT_ROWS, device, wrap=True)
    for i in range(REPEATS):
        n = 1 + (i * 104_729) % REPEAT_ROWS
        same_k2([c[:n] for c in cols], q6, f"launch {i} of {REPEATS} (n={n})",
                lo=700 + i % 40)
    return (f"K2 equal to plain and the same from two launches at {sizes} rows, with "
            f"and without int32 wrap, aligned and from views one element in, and in "
            f"{REPEATS} launches in a row at changing lengths")


K8_EDGE_BITS = 20                 # 2^20 - 1 / 2^20 / 2^20 + 1 build rows, near the timed shape


def k8_special_keys(kind: str):
    """Keys a hash table can get wrong: for int64 the one whose stored
    pattern (key ^ 0x8000000000000000) is the empty slot's, INT64_MIN, and
    INT64_MAX, 0, -1; for float64 -0.0 (the same bits as INT64_MIN) and
    0.0, NaN, +-inf, the largest and the smallest floats."""
    if kind == "int64":
        i = np.iinfo(np.int64)
        return np.array([i.min, i.max, 0, -1, 1, i.min + 1, i.max - 1], dtype=np.int64)
    f = np.finfo(np.float64)
    return np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, f.max, -f.max, 5e-324, -5e-324])


def k8_edge_cases(device):
    """(label, build_keys, build_valid, probe_keys) for check_k8_edges."""
    rng = np.random.default_rng(88)
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    cases = []
    for kind in ("int64", "float64"):
        special = k8_special_keys(kind)
        for nb in (20, 65_543):
            keys = rng.integers(-2**62, 2**62, nb)
            keys = keys.astype(np.float64) if kind == "float64" else keys
            keys[rng.integers(0, nb, 3 * len(special))] = np.tile(special, 3)
            probes = np.concatenate([special, rng.choice(keys, 2 * nb),
                                     rng.integers(-2**62, 2**62, nb).astype(keys.dtype)])
            cases.append((f"{kind} special keys, {nb} build rows", up(keys),
                          up(rng.random(nb) < 0.9), up(probes)))
        # all-distinct keys at the edges of a power of two: the table's fullest
        for nb in (1, 2**K8_EDGE_BITS - 1, 2**K8_EDGE_BITS, 2**K8_EDGE_BITS + 1):
            keys = rng.permutation(rng.integers(-2**62, 2**62, nb) | 1)
            keys = keys.astype(np.float64) if kind == "float64" else keys
            probes = np.concatenate([rng.choice(keys, nb + 7), special,
                                     rng.integers(-2**62, 2**62, nb + 7).astype(keys.dtype)])
            cases.append((f"{kind} {nb} distinct build keys", up(keys),
                          up(np.ones(nb, dtype=bool)), up(probes)))
    keys, valid, probes = k8_inputs(65_543, "int64", device)
    cases.append(("every build row invalid", keys, torch.zeros_like(valid), probes))
    cases.append(("empty build side", keys[:0], valid[:0], probes))
    hot = k8_hot_key_inputs(65_543, device)
    cases.append(("a third of the build rows on one key", *hot))
    for label, *args in list(cases):
        if args[0].shape[0] > 1:  # the same from views one element into their buffers
            cases.append((f"{label}, views", *(a[1:] for a in args)))
    return cases


def same_k8(args, hash_lookup, what: str) -> float:
    """lookup_last_eq on the card equal to its plain version, and the same
    bits from two launches; returns the largest difference (0)."""
    got, again = hash_lookup.lookup_last_eq(*args), hash_lookup.lookup_last_eq(*args)
    ref = hash_lookup.lookup_last_eq_plain(*args)
    torch.cuda.synchronize()
    for a, b in ((got, ref), (again, got)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"K8 {what}: differs from its plain version or between "
                                 "two launches")
    return max_abs_diff(((got[0], ref[0]), (got[1], ref[1])))


def check_k8_edges(device, hash_lookup) -> str:
    """K8 on k8_edge_cases and in REPEATS launches in a row at changing build
    and probe lengths, each held against its plain version. Returns what it
    checked."""
    cases = k8_edge_cases(device)
    for label, *args in cases:
        same_k8(args, hash_lookup, label)
    keys, valid, probes = k8_inputs(4 * REPEAT_ROWS, "int64", device)
    for i in range(REPEATS):
        nb = (i * 7_919) % keys.shape[0]
        nq = 1 + (i * 104_729) % probes.shape[0]
        got = hash_lookup.lookup_last_eq(keys[:nb], valid[:nb], probes[:nq])
        ref = hash_lookup.lookup_last_eq_plain(keys[:nb], valid[:nb], probes[:nq])
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"K8 launch {i} of {REPEATS} ({nb} build rows, {nq} "
                                 "probes) differs from its plain version")
    return (f"K8 equal to plain and bit-stable in {len(cases)} edge cases ("
            + "; ".join(label for label, *_ in cases) + f") and in {REPEATS} launches "
            "in a row at changing lengths")


def k8_distinct_inputs(n: int, device):
    """n // 4 + 1 build rows of distinct int64 keys over 2^62 values, all
    valid, and n probes of which half are build keys: the table at its
    fullest for the timed number of build rows."""
    rng = np.random.default_rng(n + 88)
    nb = n // 4 + 1
    keys = rng.permutation(rng.integers(-2**61, 2**61, nb) * 2 + 1)
    probes = np.where(rng.random(n) < 0.5, rng.choice(keys, n), rng.integers(-2**61, 2**61, n) * 2)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(keys), up(np.ones(nb, dtype=bool)), up(probes)


def k8_q20_inputs(device, nb: int = 541_820, nq: int = 800_000):
    """The main path's K8 call in Q20 at SF1: nb distinct composite keys
    (partkey * 2^20 + suppkey, all valid) on the build side and nq probes
    that find each build key once."""
    rng = np.random.default_rng(20)
    probes = rng.permutation(np.unique(rng.integers(2**20, 2**38, nq + nq // 8))[:nq])
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(rng.permutation(probes[:nb])), up(np.ones(nb, dtype=bool)), up(probes)


def read_flush_ms(fn, device) -> float:
    """bench_q6.time_ms with another L2 flush: before each call it reads
    twice the L2 instead of writing it, so the call finds the L2 holding
    clean lines that it need not write back."""
    from hyrise_tpu_torch import bench_q6
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    flush = torch.zeros(2 * max(l2, 1 << 20), dtype=torch.uint8, device=device)
    for i in range(3):
        fn(i)
    times = []
    for i in range(bench_q6.TIMING_REPS):
        torch.cuda._sleep(bench_q6._HOST_HEADSTART_CYCLES)
        flush.max()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_k2_k8(n: int, device, card: str, time_ms, q6, hash_lookup, checked: bool,
               wanted=("K2", "K8")):
    """Median device ms (CUDA events, L2 flushed; plain, kernel, kernel,
    plain) of K2 at n rows and of K8 in four shapes (k8_inputs' int64 keys,
    the same with a third of the build rows on one key, distinct keys, and
    the size of Q20's call),
    each first held against its plain version, with their bounds and the
    kernels' own device time from one torch.profiler run per shape (table
    fills included). With `checked` (this checkout's kernels) K2 must show
    one device kernel a call and K8 at most a memset and two kernels, and
    K2 is also timed after an L2 flush by reading (read_flush_ms). Returns
    {label: times}."""
    out = {}

    def record(label, kernel, plain, nbytes):
        t = turns((("plain", plain), ("kernel", kernel), ("kernel", kernel),
                   ("plain", plain)), device, time_ms)
        t["library"], t["bytes"] = None, nbytes
        t["bound"] = nbytes / PEAK_BYTES_PER_S * 1e3
        t["kernel_only"], t["per_call"] = kernel_only_ms(kernel, device, keep_fills=True)
        out[label] = t
        log(f"kernels n={n} {label} median device ms {card}: kernel {t['kernel']:.4f}, "
            f"plain {t['plain']:.4f}, bound {t['bound']:.4f} "
            f"({nbytes / t['kernel'] / 1e6:.1f} GB/s); kernel-only device ms "
            f"(torch.profiler, {t['per_call']} kernels, memsets and fills a call) "
            + listed(t["kernel_only"]))

    if "K2" in wanted:
        cols = k2_columns(n, device)
        same_k2(cols, q6, f"timed n={n}")
        record("K2", lambda i: q6.q6_encoded(*cols, 731 - i, 1096),
               lambda i: q6.q6_encoded_reference(*cols, 731 - i, 1096), n * 8)
        if checked:
            if out["K2"]["per_call"] != 1:
                raise AssertionError(f"K2: {out['K2']['per_call']} device kernels a call, "
                                     "not 1")
            # the same call after a flush that reads the L2 full of clean lines
            # instead of writing it full of dirty ones that the call writes back
            t = out["K2"]
            t["read_flush"] = read_flush_ms(lambda i: q6.q6_encoded(*cols, 731 - i, 1096),
                                            device)
            log(f"kernels n={n} K2 median device ms {card} after an L2 flush by reading: "
                f"{t['read_flush']:.4f} (after one by writing {t['kernel']:.4f})")
    if "K8" in wanted:
        shapes = {"K8": k8_inputs(n, "int64", device),
                  "K8 a third on one key": k8_hot_key_inputs(n, device),
                  "K8 distinct keys": k8_distinct_inputs(n, device),
                  "K8 in Q20's size": k8_q20_inputs(device)}
        for label, args in shapes.items():
            same_k8(args, hash_lookup, f"timed, {label}")
            nb, nq = args[0].shape[0], args[2].shape[0]
            record(label, lambda i, a=args: hash_lookup.lookup_last_eq(*a),
                   lambda i, a=args: hash_lookup.lookup_last_eq_plain(*a),
                   nb * (8 + 1) + nq * 8 + nq * (1 + 8))
            if checked and out[label]["per_call"] > 3:
                raise AssertionError(f"{label}: {out[label]['per_call']} device kernels and "
                                     "memsets a call, more than a memset and two kernels")
    return out


def time_k7_k9(n: int, device, card: str, time_ms, segment_reduce, compact):
    """Median device ms of K7 and K9, their plain versions and the PyTorch calls
    that compute the same function, at the shapes of the main path; each
    shape is first held against its plain version. Returns, per label,
    {kernel, plain, library, bytes, bound} (ms; bound: each input read and
    each output written once at the card's memory rate) and the largest
    absolute difference seen."""
    out, worst = {}, 0.0

    def record(label, kernel, plain, library, nbytes, note):
        order = [("plain", plain), ("kernel", kernel)]
        order += [("library", library)] if library is not None else []
        order += [("kernel", kernel), ("plain", plain)]
        t = turns(order, device, time_ms)
        t.setdefault("library", None)
        t["bytes"], t["bound"] = nbytes, nbytes / PEAK_BYTES_PER_S * 1e3
        out[label] = t
        lib = "" if t["library"] is None else f", {note} {t['library']:.4f}"
        log(f"kernels n={n} {label} median device ms {card}: kernel {t['kernel']:.4f}, "
            f"plain {t['plain']:.4f}{lib}, bound {t['bound']:.4f} "
            f"({nbytes / t['kernel'] / 1e6:.1f} GB/s)")

    # K7: a float64 sum through the permutation, at about 4 rows a group (Q18,
    # Q21), at 1,000 groups and with a third of the rows in one group. The
    # library calls are index_add_ and torch.segment_reduce: once given the
    # values already gathered into group order, once with the index_select
    # that gathers them, which is K7's whole function
    values, rows, _, _ = k7_columns(n, device)
    v = values["float64"]
    for label in K7_TIMED:
        starts = k7_starts(n, label, segment_reduce.tile_positions(), device)
        n_groups = starts.shape[0] - 1
        got = segment_reduce.segment_reduce_sorted(v, starts, "sum", rows)
        ref = segment_reduce.segment_reduce_sorted_plain(v, starts, "sum", rows)
        worst = max(worst, same_reduction(got[0], ref[0], f"K7 timed {label}"))
        gathered = v.index_select(0, rows)
        lengths = starts[1:] - starts[:-1]
        gid = torch.repeat_interleave(torch.arange(n_groups, device=device), lengths)

        def index_add(i, d=gathered, g=gid, k=n_groups):
            return torch.zeros(k, dtype=torch.float64, device=device).index_add_(0, g, d)

        def seg_reduce(i, d=gathered, ln=lengths):
            return torch.segment_reduce(d, "sum", lengths=ln)

        library = {
            "index_add_ (gather not included)": index_add,
            "torch.segment_reduce (gather not included)": seg_reduce,
            "index_select + index_add_": lambda i: index_add(i, v.index_select(0, rows)),
            "index_select + torch.segment_reduce":
                lambda i: seg_reduce(i, v.index_select(0, rows)),
        }
        for name, fn in library.items():
            same_reduction(fn(0), ref[0], f"K7 {label}: {name}")
        nbytes = n * (8 + 8) + (n_groups + 1) * 8 + n_groups * 16
        args = (v, starts, "sum", rows)
        kernel = lambda i, a=args: segment_reduce.segment_reduce_sorted(*a)  # noqa: E731
        record(f"K7 {label}", kernel,
               lambda i, a=args: segment_reduce.segment_reduce_sorted_plain(*a),
               index_add, nbytes, "index_add_ (gather not included)")
        t = out[f"K7 {label}"]
        t["libraries"] = {name: time_ms(fn, device) for name, fn in library.items()}
        t["kernel_only"], _ = kernel_only_ms(kernel, device)
        log(f"kernels n={n} K7 {label} ({n_groups} groups) {card}: library ms "
            + ", ".join(f"{name} {ms:.4f}" for name, ms in t["libraries"].items())
            + "; kernel-only device ms (torch.profiler) "
            + ", ".join(f"{k} {ms:.4f}" for k, ms in t["kernel_only"].items()))

    # K9 at Q6's, an even and Q1's selectivity over n rows, and over the 1,000
    # rows of a small mask (such as `rows_per_cell > 0`); the library call is
    # nonzero. Beside each, the two ways to hand out the result: a view of the
    # worst-case buffer, or a copy of the positions
    for rows_in, share in ((n, 0.02), (n, 0.5), (n, 0.98), (1000, 0.5)):
        mask = k9_mask(rows_in, share, device)
        got, ref = compact.compact_indices(mask), compact.compact_indices_plain(mask)
        if not torch.equal(got, ref):
            raise AssertionError(f"K9 timed share {share} differs from its plain version")
        label = f"K9 share {share}" + ("" if rows_in == n else f" of {rows_in} rows")
        kernel = lambda i, m=mask: compact.compact_indices(m)  # noqa: E731
        record(label, kernel,
               lambda i, m=mask: compact.compact_indices_plain(m),
               lambda i, m=mask: torch.nonzero(m), rows_in + 8 * got.shape[0],
               "torch.nonzero")

        def view(i, m=mask):
            buffer, count = compact.select_into_buffer(m)
            return buffer[:count]

        t = out[label]
        t["view"] = time_ms(view, device)
        t["copy"] = time_ms(lambda i: view(i).clone(), device)
        t["kernel_only"], _ = kernel_only_ms(kernel, device)
        log(f"kernels n={rows_in} {label} ({got.shape[0]} True) {card}: K9 view or copy: "
            f"median device ms as a view of the {rows_in}-entry buffer {t['view']:.4f}, "
            f"as a copy {t['copy']:.4f}; kernel-only device ms (torch.profiler) "
            + ", ".join(f"{k} {ms:.4f}" for k, ms in t["kernel_only"].items()))
    return out, worst


SMALL_RANGES = 100_000         # a K5 call of the main path's smaller joins


def k5_ordered_inputs(n: int, device):
    """k5_inputs' counts over ranges that follow one another through a build
    side in its own order, as a join of two tables sorted by the key finds
    them: the gathers of build_perm run through it once."""
    _, counts, _ = k5_inputs(n, device)
    ends = torch.cumsum(counts, 0)
    return ((ends - counts).to(torch.int32), counts,
            torch.arange(int(ends[-1]), device=device))


def time_k4_k5_more(n: int, device, card: str, time_ms, join_probe, k4_args, k5_args):
    """Beside the timed shapes of K4 and K5, each first held against its plain
    version: K5 with a third of the pairs in one range, with ranges and build
    side in order, and at SMALL_RANGES ranges; K4 with its probe keys in
    order; and the kernels' own device time per call from torch.profiler,
    which must show at most two kernels and a memset a call."""
    def profiled(label, fn):
        ms, per_call = kernel_only_ms(fn, device)
        if per_call > 3:
            raise AssertionError(f"{label}: {per_call} device kernels and memsets a call")
        return (f"kernel-only device ms (torch.profiler, {per_call} kernels and "
                f"memsets a call) " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))

    log(f"kernels n={n} K5 expand_pairs {card}: "
        + profiled("K5", lambda i: join_probe.expand_pairs(*k5_args)))
    for label, args in (("a third of the pairs in one range", k5_skewed_inputs(n, device)),
                        ("ranges and build side in order", k5_ordered_inputs(n, device)),
                        (f"{SMALL_RANGES} ranges", k5_inputs(SMALL_RANGES, device))):
        total, _ = same_pairs(args, join_probe, f"timed, {label}")
        kernel = lambda i, a=args: join_probe.expand_pairs(*a)  # noqa: E731
        plain = lambda i, a=args: join_probe.expand_pairs_plain(*a)  # noqa: E731
        t = turns((("plain", plain), ("kernel", kernel), ("kernel", kernel),
                   ("plain", plain)), device, time_ms)
        bound = (args[0].shape[0] * 8 + args[2].shape[0] * 8 + total * 16) \
            / PEAK_BYTES_PER_S * 1e3
        log(f"kernels n={args[0].shape[0]} K5 expand_pairs, {label} ({total} pairs) "
            f"median device ms {card}: kernel {t['kernel']:.4f}, plain {t['plain']:.4f}, "
            f"bound {bound:.4f}; " + profiled("K5 " + label, kernel))

    log(f"kernels n={n} K4 lookup_last_eq_lut {card}: "
        + profiled("K4", lambda i: join_probe.lookup_last_eq_lut(*k4_args)))
    build_keys, valid, probe_keys, key_lo, key_hi = k4_args
    ordered = (build_keys, valid, torch.sort(probe_keys).values, key_lo, key_hi)
    same_lookup(ordered, join_probe, "timed, probe keys in order")
    kernel = lambda i: join_probe.lookup_last_eq_lut(*ordered)  # noqa: E731
    plain = lambda i: join_probe.lookup_last_eq_lut_plain(*ordered)  # noqa: E731
    t = turns((("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)),
              device, time_ms)
    log(f"kernels n={n} K4 lookup_last_eq_lut, probe keys in order, median device ms "
        f"{card}: kernel {t['kernel']:.4f}, plain {t['plain']:.4f}; "
        + profiled("K4 in order", kernel))


# -- K9c and K5c: the capacity forms, each output byte written once ------------

GUARD = -0x5A5A5A5A5A5A5A5B    # the guard words around a raw call's output
CAP_REPEATS = 200              # raw launches in a row into one buffer at changing (n, cap)
K9_TILE, K9C_TILE, K5_OUT_TILE = 8192, 16384, 2048   # K9's, K9c's and K5's tiles
K5_SCAN_TILE = 16384
CAP_KERNELS = {"K9c": ("select_cap_kernel",), "K5c": ("ranges_scan_kernel", "expand_kernel")}
CAP_SHARES = (0.02, 0.5, 0.98)


def guarded_buffer(words: int, device) -> torch.Tensor:
    """`words` int64 with every byte 0xFF, and 64 guard words on either side."""
    buf = torch.full((words + 128,), -1, dtype=torch.int64, device=device)
    buf[:64].fill_(GUARD)
    buf[-64:].fill_(GUARD)
    return buf


def guarded_call(fn, words: int, device) -> torch.Tensor:
    """fn(the middle words of a guarded_buffer); the whole buffer back."""
    buf = guarded_buffer(words, device)
    fn(buf[64:64 + words])
    torch.cuda.synchronize()
    return buf


def check_guards(buf, what: str) -> None:
    if bool((buf[:64] != GUARD).any()) or bool((buf[-64:] != GUARD).any()):
        raise AssertionError(f"{what}: a write landed past the buffer")


def k9c_raw(lib, mask, cap: int, out, count, scratch, stream) -> None:
    """K9c's C call: positions into out[:cap], the count into count[0]."""
    import ctypes
    n = mask.shape[0]
    err = lib.compact_select_cap(mask.view(torch.uint8).data_ptr(), n,
                                 -(-n // lib.compact_cap_tile_rows()), scratch.data_ptr(),
                                 out.data_ptr(), cap, count.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise AssertionError(f"compact_select_cap: CUDA error {err}")


def k5c_raw(lib, args, cap: int, out, stats, scratch, stream) -> None:
    """K5c's C call: probe rows into out[:cap], build rows into
    out[cap + cap % 2:][:cap] (16-byte aligned, as the wrapper lays them out),
    the stats into `stats`."""
    import ctypes
    lo, counts, perm = args
    err = lib.expand_pairs_cap(lo.data_ptr(), counts.data_ptr(), lo.shape[0], perm.data_ptr(),
                               perm.shape[0], scratch.data_ptr(), stats.data_ptr(),
                               out.data_ptr(), out[cap + cap % 2:].data_ptr(), cap,
                               ctypes.c_void_p(stream))
    if err != 0:
        raise AssertionError(f"expand_pairs_cap: CUDA error {err}")


def k9c_shapes(device, bucket_capacity):
    """(what, mask, cap) at the edges of K9c's design: capacities at,
    around, under and over the count, a count of 0 under 2^20 entries, one
    row and one entry, lengths at K9's and K9c's select tiles, capacities at
    K9c's fill slices, masks one byte into their buffers."""
    cases = []
    for n in KERNEL_SIZES:
        mask = k9_mask(n, 0.5, device)
        count = int(mask.sum())
        for cap in sorted({count, count - 1, count + 1, count // 2, bucket_capacity(count + 1)}):
            if cap >= 1:
                cases.append((f"n={n}, cap {cap}", mask, cap))
    for cap in (1 << 20, (1 << 20) + 1):
        cases.append((f"nothing True, cap {cap}", torch.zeros(1000, dtype=torch.bool,
                                                              device=device), cap))
    for n, true, cap in ((1, True, 1), (1, False, 1), (1, True, 5), (7, True, 1),
                         (100_003, True, 1)):
        cases.append((f"n={n} all {true}, cap {cap}",
                      torch.full((n,), true, dtype=torch.bool, device=device), cap))
    for n in (K9_TILE - 1, K9_TILE, K9_TILE + 1, K9C_TILE - 1, K9C_TILE, K9C_TILE + 1,
              2 * K9C_TILE - 1, 2 * K9C_TILE + 1):
        for share in (0.5, 1.0):
            mask = k9_mask(n, share, device)
            count = int(mask.sum())
            for cap in sorted({count, count + 1, K9C_TILE, 2 * K9C_TILE + 1}):
                cases.append((f"n={n} at share {share}, cap {cap}", mask, cap))
    for cap in (K9_TILE - 1, K9_TILE, K9_TILE + 1, K9C_TILE - 1, K9C_TILE, K9C_TILE + 1,
                2 * K9C_TILE - 1, 2 * K9C_TILE, 2 * K9C_TILE + 1):
        for n, share in ((40_000, 0.25), (40_000, 0.5), (70_001, 0.5)):
            cases.append((f"n={n} at share {share}, cap {cap}", k9_mask(n, share, device), cap))
    for n in (65_543, REPEAT_ROWS):
        mask = k9_mask(n + 1, 0.5, device)[1:]
        cases.append((f"n={n} one byte into its buffer", mask, int(mask.sum())))
    return cases


def k5c_ranges(n: int, seed: int, device, max_count: int = 4):
    """n ranges of 0 to max_count - 1 rows over a build side of n // 4 + 4
    (tests/test_torch_kernels_slice14.py's)."""
    rng = np.random.default_rng(seed)
    nb = n // 4 + 4
    counts = np.minimum(rng.integers(0, max_count, n), nb).astype(np.int32)
    lo = (rng.integers(0, nb, n) % (nb - counts + 1)).astype(np.int32)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(lo), up(counts), up(rng.permutation(nb).astype(np.int64))


def k5c_shapes(device, bucket_capacity):
    """(what, (lo, counts, perm), cap) at the edges of K5c's design: the
    capacities of k9c_shapes against the total, no pair under 2^20 entries,
    one range, capacities (odd ones too) at the output tile of 2,048 pairs,
    totals at that tile, range counts at the expansion's chunk and the
    scan's tile, a third of the pairs in one range, ranges one element into
    their buffers."""
    cases = []
    for n in KERNEL_SIZES:
        args = k5_inputs(n, device)
        total = int(args[1].sum())
        for cap in sorted({total, total - 1, total + 1, total // 2, bucket_capacity(total + 1)}):
            if cap >= 1:
                cases.append((f"n={n}, cap {cap}", args, cap))
    lo, _, perm = k5c_ranges(1000, 3, device)
    for cap in (1 << 20, (1 << 20) + 1):
        cases.append((f"no pair, cap {cap}", (lo, torch.zeros_like(lo), perm), cap))
    one = torch.tensor([1], dtype=torch.int32, device=device)
    five = torch.tensor([4, 3, 2, 1, 0], dtype=torch.int64, device=device)
    for count, cap in ((1, 1), (0, 1), (1, 2), (3, 1), (3, 3)):
        cases.append((f"one range of {count}, cap {cap}",
                      (one, torch.tensor([count], dtype=torch.int32, device=device), five),
                      cap))
    for cap in (K5_OUT_TILE - 1, K5_OUT_TILE, K5_OUT_TILE + 1, 2 * K5_OUT_TILE - 1,
                2 * K5_OUT_TILE + 1, 3 * K5_OUT_TILE, 5 * K5_OUT_TILE + 3):
        for n, seed in ((1500, 1), (3000, 2), (8000, 3)):
            cases.append((f"{n} ranges, cap {cap}", k5c_ranges(n, cap + seed, device), cap))
    for total in (K5_OUT_TILE - 1, K5_OUT_TILE, K5_OUT_TILE + 1):
        rng = np.random.default_rng(total)
        counts = np.zeros(5000, dtype=np.int32)
        np.add.at(counts, rng.integers(0, 5000, total), 1)
        args = (torch.as_tensor(rng.integers(0, 1246, 5000).astype(np.int32), device=device),
                torch.as_tensor(counts, device=device),
                torch.as_tensor(rng.permutation(1254).astype(np.int64), device=device))
        for cap in (4 * K5_OUT_TILE + 1, 1 << 15):
            cases.append((f"a total of {total}, cap {cap}", args, cap))
    for n in (K5_OUT_TILE - 1, K5_OUT_TILE, K5_OUT_TILE + 1, K5_SCAN_TILE - 1, K5_SCAN_TILE,
              K5_SCAN_TILE + 1):
        args = k5c_ranges(n, n, device)
        total = int(args[1].sum())
        cases.append((f"{n} ranges, cap {total + 1 + total % 2}", args, total + 1 + total % 2))
    args = k5_skewed_inputs(65_543, device)
    total = int(args[1].sum())
    for cap in (total, total // 3, total + 2049):
        cases.append((f"a third of the pairs in one range, cap {cap}", args, cap))
    lo, counts, perm = k5_inputs(65_544, device)
    args = (lo[1:], counts[1:], perm)
    cases.append(("ranges one element into their buffers", args, int(args[1].sum()) + 1))
    return cases


def same_k9c(lib, mask, cap: int, compact, device, stream, what: str) -> float:
    """The wrapper and the raw C call into a 0xFF-filled guarded buffer, both
    equal to the plain version in every entry of [0, cap); the count exact."""
    ref, ref_n = compact.compact_indices_cap_plain(mask, cap)
    got, got_n = compact.compact_indices_cap(mask, cap)
    torch.cuda.synchronize()
    if int(got_n) != int(ref_n) or not torch.equal(got, ref):
        raise AssertionError(f"K9c at {what}: count {int(got_n)} vs {int(ref_n)}, "
                             "positions differ")
    tiles = -(-mask.shape[0] // lib.compact_cap_tile_rows())
    scratch = torch.empty(lib.compact_scratch_words(tiles), dtype=torch.int64, device=device)
    count = torch.empty(1, dtype=torch.int64, device=device)
    buf = guarded_call(lambda out: k9c_raw(lib, mask, cap, out, count, scratch, stream), cap,
                       device)
    check_guards(buf, f"K9c at {what}")
    if int(count) != int(ref_n) or not torch.equal(buf[64:64 + cap], ref):
        raise AssertionError(f"K9c at {what}: from a 0xFF-filled output, not every entry "
                             "of [0, cap) equals the plain version")
    return float((got - ref).abs().max())


def same_k5c(lib, args, cap: int, join_probe, device, stream, what: str) -> float:
    """As same_k9c for K5c: both outputs in every entry of [0, cap), the
    word between them (an odd cap's) untouched, total and verdict exact."""
    ref = join_probe.expand_pairs_cap_plain(*args, cap)
    got = join_probe.expand_pairs_cap(*args, cap)
    torch.cuda.synchronize()
    # under a refusal the total is not part of the contract
    if (not bool(ref[3]) and int(got[2]) != int(ref[2])) or bool(got[3]) != bool(ref[3]) \
            or not torch.equal(got[0], ref[0]) or not torch.equal(got[1], ref[1]):
        raise AssertionError(f"K5c at {what}: total {int(got[2])} vs {int(ref[2])}, "
                             f"refused {bool(got[3])} vs {bool(ref[3])}, or pairs differ")
    n = args[0].shape[0]
    scratch = torch.empty(lib.expand_scratch_words(n), dtype=torch.int64, device=device)
    stats = torch.empty(lib.expand_stats_words(), dtype=torch.int64, device=device)
    wide = cap + cap % 2
    buf = guarded_call(lambda out: k5c_raw(lib, args, cap, out, stats, scratch, stream),
                       2 * wide, device)
    check_guards(buf, f"K5c at {what}")
    mid = buf[64:64 + 2 * wide]
    refused = int(stats[lib.expand_refused_word()])
    if not (torch.equal(mid[:cap], ref[0]) and torch.equal(mid[wide:wide + cap], ref[1])
            and bool((mid[cap:wide] == -1).all()) and bool((mid[wide + cap:] == -1).all())
            and refused == int(ref[3]) and (refused or int(stats[0]) == int(ref[2]))):
        raise AssertionError(f"K5c at {what}: from 0xFF-filled outputs, not every entry "
                             "of [0, cap) equals the plain version, or one past cap was "
                             "written")
    return float((got[1] - ref[1]).abs().max())


def check_cap_repeats(device, compact, join_probe, bucket_capacity, stream) -> None:
    """CAP_REPEATS raw C calls of each of K9c and K5c in a row, at changing
    (n, cap), into one buffer (and one scratch) that is never cleared: after
    each, the whole buffer must equal what the earlier calls left with
    [0, cap) replaced by the plain version, so an entry the call did not
    write, or one it wrote at or past cap, shows."""
    lib9, lib5 = compact._library(), join_probe._library()
    configs9, configs5 = [], []
    for n in (10_007, 65_543, REPEAT_ROWS):  # one tile (K9c: one block), several, many
        for share in CAP_SHARES:
            mask = k9_mask(n, share, device)
            count = int(mask.sum())
            for cap in (count, count // 2 + 1, bucket_capacity(count), count + 3):
                configs9.append((mask, cap, compact.compact_indices_cap_plain(mask, cap)))
        args = k5_inputs(n, device)
        total = int(args[1].sum())
        for cap in (total, total // 2 + 1, bucket_capacity(total), total + 3):
            configs5.append((args, cap, join_probe.expand_pairs_cap_plain(*args, cap)))
    count = torch.empty(1, dtype=torch.int64, device=device)
    tiles = -(-REPEAT_ROWS // lib9.compact_cap_tile_rows())
    scratch = torch.empty(lib9.compact_scratch_words(tiles), dtype=torch.int64, device=device)
    buf = guarded_buffer(max(cap for _, cap, _ in configs9), device)
    want = buf.clone()
    for i in range(CAP_REPEATS):
        mask, cap, (ref, ref_n) = configs9[(7 * i) % len(configs9)]
        k9c_raw(lib9, mask, cap, buf[64:64 + cap], count, scratch, stream)
        want[64:64 + cap] = ref
        if not torch.equal(buf, want) or int(count) != int(ref_n):
            raise AssertionError(f"K9c: raw launch {i} of {CAP_REPEATS} at n={mask.shape[0]}, "
                                 f"cap {cap} left its buffer unlike the plain version")
    stats = torch.empty(lib5.expand_stats_words(), dtype=torch.int64, device=device)
    scratch = torch.empty(lib5.expand_scratch_words(REPEAT_ROWS), dtype=torch.int64,
                          device=device)
    buf = guarded_buffer(max(2 * (cap + cap % 2) for _, cap, _ in configs5), device)
    want = buf.clone()
    for i in range(CAP_REPEATS):
        args, cap, ref = configs5[(7 * i) % len(configs5)]
        wide = cap + cap % 2
        k5c_raw(lib5, args, cap, buf[64:], stats, scratch, stream)
        want[64:64 + cap] = ref[0]
        want[64 + wide:64 + wide + cap] = ref[1]
        if not torch.equal(buf, want) or int(stats[0]) != int(ref[2]):
            raise AssertionError(f"K5c: raw launch {i} of {CAP_REPEATS} at "
                                 f"n={args[0].shape[0]}, cap {cap} left its buffer unlike "
                                 "the plain version")


def check_cap_forms(device, compact, join_probe, bucket_capacity) -> tuple:
    """K9c and K5c against their plain versions at k9c_shapes and k5c_shapes,
    through the wrappers and through the raw C calls into 0xFF-filled
    guarded buffers; the kinds of refused ranges (K5_BAD_RANGES) under a
    capacity far above the total set the flag and leave every entry 0;
    then check_cap_repeats. Returns the largest differences (both 0 when
    equal) and the number of shapes."""
    lib9, lib5 = compact._library(), join_probe._library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err9 = err5 = 0.0
    shapes9, shapes5 = k9c_shapes(device, bucket_capacity), k5c_shapes(device, bucket_capacity)
    for what, mask, cap in shapes9:
        err9 = max(err9, same_k9c(lib9, mask, cap, compact, device, stream, what))
    for what, args, cap in shapes5:
        err5 = max(err5, same_k5c(lib5, args, cap, join_probe, device, stream, what))
    perm = torch.arange(4, dtype=torch.int64, device=device)
    for what, (lo, counts) in K5_BAD_RANGES.items():
        args = (torch.tensor(lo, dtype=torch.int32, device=device),
                torch.tensor(counts, dtype=torch.int32, device=device), perm)
        for cap in (1 << 12, (1 << 20) + 1):
            same_k5c(lib5, args, cap, join_probe, device, stream, f"{what}, cap {cap}")
            if not bool(join_probe.expand_pairs_cap(*args, cap)[3]):
                raise AssertionError(f"K5c: ranges with {what} were not refused")
    check_cap_repeats(device, compact, join_probe, bucket_capacity, stream)
    return err9, err5, len(shapes9), len(shapes5) + 2 * len(K5_BAD_RANGES)


def memset_bytes(fn, device, calls: int = 5) -> list:
    """The bytes of every memset that `calls` calls of fn(i) enqueue, from a
    torch.profiler trace (each gpu_memset event's "bytes"; None where the
    trace does not give them). The trace is written into the kernels' build
    directory, which git ignores."""
    from hyrise_tpu_torch.kernels import build
    fn(0)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    path = build.BUILD_DIR / "cap_memsets.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e.get("args", {}).get("bytes") for e in events if e.get("cat") == "gpu_memset"]


def cap_profile(label: str, fn, device, cap: int, scratch_bytes, checked: bool):
    """The kernels' own device ms of a K9c or K5c call (kernel_only_ms, fills
    kept) and the bytes of its memsets (memset_bytes). With `checked`
    (this checkout's kernels) a call must run only its kernels
    (CAP_KERNELS) and at most one memset, of no more than `scratch_bytes`:
    no torch op, no memset of an output. Where the trace gives no bytes, the
    memsets must take less time than cap x 8 bytes take at the card's memory
    rate (so they cannot have written an output)."""
    ms, per_call = kernel_only_ms(fn, device, keep_fills=True)
    sizes = memset_bytes(fn, device)
    kernels = CAP_KERNELS[label.split()[0]]
    if checked:
        others = [k for k in ms if k != "sum" and "Memset" not in k and not k.startswith(kernels)]
        if others:
            raise AssertionError(f"{label}: {others} ran inside a call (a torch op?)")
        if per_call > len(kernels) + 1 or len(sizes) > 5:
            raise AssertionError(f"{label}: {per_call} device operations a call, "
                                 f"{len(sizes) / 5} memsets")
        known = [b for b in sizes if b is not None]
        memset_ms = sum(v for k, v in ms.items() if "Memset" in k)
        if known and max(known) > scratch_bytes:
            raise AssertionError(f"{label}: a memset of {max(known)} bytes, more than the "
                                 f"scratch's {scratch_bytes}: an output was cleared")
        if not known and memset_ms >= cap * 8 / PEAK_BYTES_PER_S * 1e3:
            raise AssertionError(f"{label}: memsets of {memset_ms:.4f} ms a call, as long as "
                                 f"clearing cap x 8 bytes takes")
    return ms, per_call, sizes


def time_cap_forms(device, card, time_ms, compact, join_probe, bucket_capacity,
                   checked: bool) -> dict:
    """Median device ms (CUDA events, L2 flushed, in turns) of K9c at
    n = KERNEL_SIZES[-1] at CAP_SHARES True, cap the count's bucket, beside
    its plain version and torch.nonzero_static(mask, size=cap, fill_value=0);
    of K5c over k5_inputs, k5_skewed_inputs and SMALL_RANGES ranges, cap the
    total's bucket, beside its plain version and K5 (expand_pairs) on the
    same ranges; each shape first held against its plain version; with the
    kernels' own device ms and memset bytes (cap_profile). Returns {label:
    times}."""
    n = KERNEL_SIZES[-1]
    out = {}
    for share in CAP_SHARES:
        mask = k9_mask(n, share, device)
        count = int(mask.sum())
        cap = bucket_capacity(count)
        ref, _ = compact.compact_indices_cap_plain(mask, cap)
        got, _ = compact.compact_indices_cap(mask, cap)
        library = torch.nonzero_static(mask, size=cap, fill_value=0)
        if not (torch.equal(got, ref) and torch.equal(library.squeeze(1), ref)):
            raise AssertionError(f"K9c timed at share {share} differs from its plain version "
                                 "or nonzero_static")
        kernel = lambda i, m=mask, c=cap: compact.compact_indices_cap(m, c)  # noqa: E731
        plain = lambda i, m=mask, c=cap: compact.compact_indices_cap_plain(m, c)  # noqa: E731
        lib = lambda i, m=mask, c=cap: torch.nonzero_static(m, size=c, fill_value=0)  # noqa: E731
        t = turns((("plain", plain), ("kernel", kernel), ("library", lib), ("kernel", kernel),
                   ("library", lib), ("plain", plain)), device, time_ms)
        t["bound"] = (n + cap * 8 + 8) / PEAK_BYTES_PER_S * 1e3
        tiles = -(-n // K9C_TILE)
        t["kernel_only"], t["per_call"], sizes = cap_profile(
            f"K9c share {share}", kernel, device, cap, (1 + tiles) * 8, checked)
        label = f"K9c share {share}"
        out[label] = t
        log(f"kernels n={n} {label} ({count} True, cap {cap}) median device ms {card}: "
            f"kernel {t['kernel']:.4f}, plain {t['plain']:.4f}, torch.nonzero_static("
            f"fill_value=0) {t['library']:.4f}, bound {t['bound']:.4f}; kernel-only "
            f"device ms (torch.profiler, {t['per_call']} a call) {listed(t['kernel_only'])}; "
            f"memset bytes {sizes[:1]} x {len(sizes)} in 5 calls")
    for label, args in (("K5c", k5_inputs(n, device)),
                        ("K5c a third of the pairs in one range", k5_skewed_inputs(n, device)),
                        (f"K5c {SMALL_RANGES} ranges", k5_inputs(SMALL_RANGES, device))):
        total = int(args[1].sum())
        cap = bucket_capacity(total)
        ref = join_probe.expand_pairs_cap_plain(*args, cap)
        got = join_probe.expand_pairs_cap(*args, cap)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                and int(got[2]) == total and not bool(got[3])):
            raise AssertionError(f"{label} timed differs from its plain version")
        kernel = lambda i, a=args, c=cap: join_probe.expand_pairs_cap(*a, c)  # noqa: E731
        plain = lambda i, a=args, c=cap: join_probe.expand_pairs_cap_plain(*a, c)  # noqa: E731
        exact = lambda i, a=args: join_probe.expand_pairs(*a)  # noqa: E731
        t = turns((("plain", plain), ("kernel", kernel), ("exact", exact), ("kernel", kernel),
                   ("exact", exact), ("plain", plain)), device, time_ms)
        rows = args[0].shape[0]
        t["bound"] = (rows * 8 + args[2].shape[0] * 8 + cap * 16 + 48) / PEAK_BYTES_PER_S * 1e3
        t["exact_bound"] = (rows * 8 + args[2].shape[0] * 8 + total * 16) \
            / PEAK_BYTES_PER_S * 1e3
        t["library"] = None
        scan_tiles = -(-rows // K5_SCAN_TILE)
        t["kernel_only"], t["per_call"], sizes = cap_profile(
            label, kernel, device, cap, (5 + scan_tiles + -(-rows // 512)) * 8, checked)
        # the exact form's own kernels: its CUDA-event time holds the host's
        # wait for the total between them
        t["exact_only"], _ = kernel_only_ms(exact, device)
        out[label] = t
        log(f"kernels n={rows} {label} ({total} pairs, cap {cap}) median device ms {card}: "
            f"kernel {t['kernel']:.4f}, plain {t['plain']:.4f}, bound {t['bound']:.4f}; "
            f"K5 expand_pairs on the same ranges {t['exact']:.4f} (bound "
            f"{t['exact_bound']:.4f}; kernel-only {listed(t['exact_only'])}); kernel-only "
            f"device ms (torch.profiler, "
            f"{t['per_call']} a call) {listed(t['kernel_only'])}; memset bytes "
            f"{sizes[:1]} x {len(sizes)} in 5 calls")
    return out


def cap_phase(device, card, time_ms, compact, join_probe, checked: bool) -> tuple:
    """Phase 3's part for K9c and K5c: with `checked`, check_cap_forms; then
    time_cap_forms. Returns (timings, (largest K9c difference, K5c's))."""
    from hyrise_tpu_torch.plan.compiler import bucket_capacity
    errs = (0.0, 0.0)
    if checked:
        err9, err5, n9, n5 = check_cap_forms(device, compact, join_probe, bucket_capacity)
        errs = (err9, err5)
        log(f"kernels: K9c equal to plain at {n9} shapes and K5c at {n5} (capacities at, "
            f"around and under the count, a count of 0 under 2^20, one row and one entry, "
            f"lengths and capacities at the tiles +-1, odd capacities, a third of the pairs "
            f"in one range, views, every refused kind of range), through the wrappers and "
            f"through the raw C calls into 0xFF-filled guarded outputs (every entry of "
            f"[0, cap) written, none past it); {CAP_REPEATS} raw launches in a row of each "
            f"at changing (n, cap) into one buffer")
    return time_cap_forms(device, card, time_ms, compact, join_probe, bucket_capacity,
                          checked), errs


def reset_counts(wrappers) -> None:
    """Every wrapper's launch count, and row and pair counts where it keeps
    them, to 0."""
    for w in wrappers.values():
        w.launches = 0
        for count in ("rows_seen", "pairs_out"):
            if hasattr(w, count):
                setattr(w, count, 0)


def rows_per_launch(wrappers) -> str:
    """Mean rows per launch of the wrappers that count their rows (K4: probe
    rows; K5: ranges, and the pairs made of them; K7: the positions a call
    covered; K9: its mask's rows)."""
    return ", ".join(
        f"{name} {w.rows_seen / max(w.launches, 1):.1f}"
        + (f" (and {w.pairs_out / max(w.launches, 1):.1f} pairs)"
           if hasattr(w, "pairs_out") else "") + f" over {w.launches}"
        for name, w in wrappers.items() if hasattr(w, "rows_seen"))


def corpus_tables(device):
    """The four small tables tests/sql_corpus.sql is written against (those
    of tests/test_sql_corpus.py)."""
    from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition as Def
    from hyrise_tpu_torch.types import DataType as T
    rng = np.random.default_rng(5)
    n = 10
    obj = lambda values: np.array(values, dtype=object)  # noqa: E731
    s = ["red", "green", None, "blue", "red", "green", "red", None, "amber", "blue"]
    return {
        "mixed": Table.from_arrays(
            "mixed", [Def("a", T.INT32), Def("b", T.FLOAT32), Def("s", T.STRING, True)],
            [np.arange(1, n + 1, dtype=np.int32), (rng.random(n) * 100).astype(np.float32),
             obj(s)], device=device),
        "lookup": Table.from_arrays(
            "lookup", [Def("k", T.INT32), Def("v", T.STRING)],
            [np.array([1, 2, 2, 5, 11], dtype=np.int32),
             obj(["one", "two", "deux", "five", "eleven"])], device=device),
        "empty_t": Table.from_arrays("empty_t", [Def("x", T.INT32)],
                                     [np.array([], dtype=np.int32)], device=device),
        "nullnum": Table.from_arrays(
            "nullnum", [Def("i", T.INT32, True), Def("f", T.FLOAT64, True),
                        Def("g", T.INT32)],
            [np.array([1, 0, 3, 0, 5, 3, 0, 8], dtype=np.int32),
             np.array([0.5, 1.5, 0, 0, 2.5, 0, 3.5, 4.5]),
             np.arange(1, 9, dtype=np.int32)],
            [np.array([1, 0, 1, 0, 1, 1, 0, 1], dtype=bool),
             np.array([1, 1, 0, 0, 1, 0, 1, 1], dtype=bool), None], device=device),
    }


def corpus_statements():
    import pathlib
    text = (pathlib.Path(__file__).resolve().parent / "tests" / "sql_corpus.sql").read_text()
    lines = [ln for ln in text.splitlines() if not ln.strip().startswith("--")]
    return [q.strip() for q in "\n".join(lines).split(";") if q.strip()]


def operators_of(plan):
    seen = {}

    def walk(op):
        if id(op) not in seen:
            seen[id(op)] = op
            for i in op.inputs:
                walk(i)

    walk(plan)
    return list(seen.values())


def check_rows(got, want, what: str, table_eq) -> None:
    """Integers and strings equal, floats within 1e-6 relative, as row sets
    (ties of an ORDER BY may fall either way)."""
    ok, msg = table_eq.tables_equal(got, want, ordered=False, rel_tol=1e-6,
                                    abs_tol=0.0)
    if not ok:
        raise AssertionError(f"{what}: {msg}")


def check_finite(rows, what: str) -> None:
    for r in rows:
        for v in r:
            if isinstance(v, (float, np.floating)) and not np.isfinite(v):
                raise AssertionError(f"{what}: non-finite value in {r}")


def copy_to(tables, device):
    """The same tables as tensors on `device` (metadata and MVCC state
    kept)."""
    from hyrise_tpu_torch.concurrency.transaction import MvccData
    from hyrise_tpu_torch.storage.column import Column
    from hyrise_tpu_torch.storage.table import Table
    out = {}
    for name, t in tables.items():
        cols = [Column(c.name, c.dtype, c.data.to(device),
                       None if c.validity is None else c.validity.to(device),
                       c.dictionary, unique=c.unique, val_range=c.val_range)
                for c in t.columns]
        out[name] = Table(cols, t.num_rows, name=name)
        if t.mvcc is not None:
            out[name].mvcc = MvccData(*(v[:t.capacity].to(device) for v in (
                t.mvcc.tids, t.mvcc.begin_cids, t.mvcc.end_cids)))
    return out


def catalog_of(tables):
    from hyrise_tpu_torch.storage.catalog import Catalog
    cat = Catalog()
    for name, t in tables.items():
        cat.add_table(name, t)
    return cat


def run_sql_text(sql: str, cat, make_pipeline):
    """(rows, statement metrics, physical plan, wall ms to rows on the host)
    of one statement through the SQL pipeline, the plan cache on."""
    t0 = time.perf_counter()
    pipeline = make_pipeline(sql).with_catalog(cat).create_pipeline()
    rows = pipeline.get_result_table().rows()
    ms = (time.perf_counter() - t0) * 1e3
    statement = pipeline.pipeline_statements[-1]
    return rows, statement.metrics, getattr(statement, "last_plan", None), ms


def sql_phase(device, card, cat, hand_rows, hand_wall, wrappers, sql_kernels, table_eq,
              make_pipeline, fused_operator, oracle_class, tpch_sql):
    """Phase 6 after its TPC-H part at the small scale: the corpus against
    sqlite, then the 22 texts at SF1 against the hand plans' rows, with every
    launch count set to 0 before the two. Returns the launch counts read
    after them, the wall ms of the 22 texts and their rows (of the last
    cached run, in the text's order). (The corpus' EXCEPT and INTERSECT reach
    K8 through Difference; no join of the 22 optimized TPC-H plans takes the
    general lookup.)"""
    reset_counts(wrappers)
    # 6b. the corpus
    tables = corpus_tables(device)
    oracle = oracle_class(tables)
    corpus_cat = catalog_of(tables)
    statements = corpus_statements()
    loose = []
    t0 = time.perf_counter()
    for sql in statements:
        out = make_pipeline(sql).with_catalog(corpus_cat).dont_cache_query_plans() \
            .create_pipeline().get_result_table()
        if out.device != device:
            raise AssertionError(f"corpus statement came out on {out.device}: {sql}")
        rows, want = out.rows(), oracle.query(sql)
        ok, _ = table_eq.tables_equal(rows, want, ordered=False, rel_tol=1e-6, abs_tol=0.0)
        if not ok:
            # sqlite computes a float32 column's arithmetic in float64
            ok, msg = table_eq.tables_equal(rows, want, ordered=False, rel_tol=1e-4,
                                            abs_tol=1e-4)
            if not ok:
                raise AssertionError(f"corpus vs sqlite: {sql}: {msg}")
            loose.append(sql)
    oracle.close()
    log(f"sql: {len(statements)} statements of tests/sql_corpus.sql on {device} match "
        f"sqlite in {time.perf_counter() - t0:.1f} s: ints and strings equal, floats "
        f"within 1e-6 relative, but for {len(loose)} that need 1e-4 (float32 arithmetic "
        f"that sqlite does in float64): {loose}")

    corpus_launches = {name: w.launches for name, w in wrappers.items()}
    # 6c. the 22 texts at SF1
    wall, stages, sql_rows = {}, {}, {}
    for qid in sorted(tpch_sql):
        rows, first_metrics, plan, first_ms = run_sql_text(tpch_sql[qid], cat, make_pipeline)
        if first_metrics.cache_hit:
            raise AssertionError(f"SQL Q{qid}: the first run hit the plan cache")
        check_rows(rows, hand_rows[qid], f"SQL Q{qid} at SF{SF} vs its hand plan", table_eq)
        check_finite(rows, f"SQL Q{qid} at SF{SF}")
        times, execute = [], []
        for _ in range(QUERY_REPS):
            rows, metrics, plan, ms = run_sql_text(tpch_sql[qid], cat, make_pipeline)
            if not metrics.cache_hit:
                raise AssertionError(f"SQL Q{qid}: a repeated run missed the plan cache")
            times.append(ms)
            execute.append(metrics.execute_s * 1e3)
        check_rows(rows, hand_rows[qid], f"SQL Q{qid} at SF{SF}, cached plan", table_eq)
        sql_rows[qid] = rows
        wall[qid] = (first_ms, statistics.median(times))
        stages[qid] = (first_metrics, statistics.median(execute))
        if qid in (1, 6):
            fused = [op for op in operators_of(plan) if isinstance(op, fused_operator)]
            if len(fused) != 1 or fused[0].fell_back is not False:
                raise AssertionError(f"SQL Q{qid}: no FusedFilterAggregate ran fused")
    log(f"sql: SF{SF} wall ms (host clock, to rows on the host; first run, then median "
        f"of {QUERY_REPS} with the plan cached; the hand plan's median beside it) {card}: "
        + "; ".join(f"Q{q} {wall[q][0]:.3f} / {wall[q][1]:.3f} (hand {hand_wall[q][1]:.3f})"
                    for q in sorted(wall)))
    log(f"sql: SF{SF} all 22 texts equal to their hand plans' rows (as sets, floats within "
        f"1e-6 relative); sum of medians {sum(m for _, m in wall.values()):.3f} ms, hand "
        f"plans {sum(m for _, m in hand_wall.values()):.3f} ms {card}")
    log(f"sql: SF{SF} stage ms of the first run (parse / translate / optimize / compile / "
        f"execute; Q1's optimize includes the table statistics), then the median execute "
        f"ms of the cached runs {card}: "
        + "; ".join(f"Q{q} {m.parse_s * 1e3:.3f} / {m.translate_s * 1e3:.3f} / "
                    f"{m.optimize_s * 1e3:.3f} / {m.compile_s * 1e3:.3f} / "
                    f"{m.execute_s * 1e3:.3f}, {e:.3f}"
                    for q, (m, e) in sorted(stages.items())))
    launches = {name: w.launches for name, w in wrappers.items()}
    for name in sql_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the SQL path")
    log(f"sql: launches on the SQL path: the corpus {corpus_launches}, with the 22 "
        f"texts at SF{SF} {launches}")
    log(f"sql: mean rows per launch on the SQL path: {rows_per_launch(wrappers)}")
    return launches, wall, sql_rows


# -- 7. writes: MVCC, TPC-H's refresh functions, transactions ----------------------

RF_STREAM = 7                  # np.random.default_rng([SEED, RF_STREAM]) draws RF1 and RF2
NEW_COMMENT_SHARE = 0.5        # of RF1's comments that are new to their dictionaries
RF1_STATEMENTS = ("INSERT INTO orders SELECT * FROM rf1_orders",
                  "INSERT INTO lineitem SELECT * FROM rf1_lineitem")
RF2_STATEMENTS = ("DELETE FROM lineitem WHERE l_orderkey IN (SELECT k FROM rf2_keys)",
                  "DELETE FROM orders WHERE o_orderkey IN (SELECT k FROM rf2_keys)")
SNAPSHOT_CHECKED = (1, 3, 6, 18)
TBL_TYPES = {"int32": "int", "int64": "long", "float32": "float", "float64": "double",
             "string": "string"}


def spec_payload(specs, table: str, column: str):
    for name, _, payload in specs[table][0]:
        if name == column:
            return payload
    raise KeyError(f"{table}.{column}")


def rf_comments(rng, pool, n: int):
    """n comments: a share drawn from the stored dictionary, the rest new
    to it (random words and a word no generated comment holds)."""
    from hyrise_tpu_torch.tpch import dbgen
    out = np.asarray(pool, dtype=object)[rng.integers(0, len(pool), n)]
    new = rng.random(n) < NEW_COMMENT_SHARE
    words = np.asarray(dbgen.COMMENT_WORDS, dtype=object)
    for i in np.nonzero(new)[0]:
        out[i] = " ".join(words[rng.integers(0, len(words), rng.integers(3, 7))]) + \
            " refreshed"
    return out


def rf1_rows(specs, sf: float, rng):
    """RF1 of TPC-H (clause 2.5.2): SF x 1,500 new orders, each with 1 to 7
    lineitems drawn uniformly, as dbgen.py draws its orders. The keys fill
    gaps of the sparse key space (dbgen.py uses 8 keys of every 32: these
    are the next 8). Returns ({table: [(column, type, values)]}, lineitem's
    columns in the code space of the generated ones, for the oracles)."""
    from hyrise_tpu_torch.tpch import dbgen
    n_orders = max(int(round(1500 * sf)), 1)
    C, P, S = specs["customer"][1], specs["part"][1], specs["supplier"][1]
    retail = spec_payload(specs, "part", "p_retailprice")
    i = np.arange(n_orders, dtype=np.int64)
    keys = ((i // 8) * 32 + 8 + i % 8 + 1).astype(np.int32)
    custkey = dbgen._valid_custkeys(rng, n_orders, C)
    orderdate = rng.integers(0, dbgen.N_DAYS - 151, n_orders).astype(np.int32)
    counts = rng.integers(1, 8, n_orders).astype(np.int32)
    n_lines = int(counts.sum())
    row = np.repeat(np.arange(n_orders), counts)
    linenumber = (np.arange(n_lines) - np.repeat(np.cumsum(counts) - counts, counts) + 1
                  ).astype(np.int32)
    partkey = rng.integers(1, P + 1, n_lines).astype(np.int32)
    suppkey = dbgen._ps_suppkey(partkey, rng.integers(0, 4, n_lines), S)
    qty = rng.integers(1, 51, n_lines).astype(np.float32)
    price = (qty * retail[partkey - 1]).astype(np.float32)
    disc = (rng.integers(0, 11, n_lines) / 100.0).astype(np.float32)
    tax = (rng.integers(0, 9, n_lines) / 100.0).astype(np.float32)
    last = dbgen.N_DAYS - 1
    ship_raw = orderdate[row] + rng.integers(1, 122, n_lines)
    ship = np.minimum(ship_raw, last).astype(np.int32)
    commit = np.minimum(orderdate[row] + rng.integers(30, 91, n_lines), last).astype(np.int32)
    receipt = np.minimum(ship_raw + rng.integers(1, 31, n_lines), last).astype(np.int32)
    returned = receipt <= dbgen.CURRENT_DATE_OFFSET
    rf_codes = np.where(returned, np.where(rng.random(n_lines) < 0.5, 2, 0), 1)
    ls_codes = (ship > dbgen.CURRENT_DATE_OFFSET).astype(np.int32)
    open_lines = np.bincount(row, weights=ls_codes, minlength=n_orders)
    status = np.where(open_lines == 0, "F", np.where(open_lines == counts, "O", "P"))
    total = np.bincount(row, weights=price.astype(np.float64) * (1 + tax) * (1 - disc),
                        minlength=n_orders).astype(np.float32)
    dates = dbgen.date_pool()
    _, clerks = spec_payload(specs, "orders", "o_clerk")
    _, o_comments = spec_payload(specs, "orders", "o_comment")
    _, l_comments = spec_payload(specs, "lineitem", "l_comment")
    _, rf_pool = spec_payload(specs, "lineitem", "l_returnflag")
    _, ls_pool = spec_payload(specs, "lineitem", "l_linestatus")
    obj = lambda a: np.asarray(a, dtype=object)  # noqa: E731
    orders = [
        ("o_orderkey", "int32", keys), ("o_custkey", "int32", custkey),
        ("o_orderstatus", "string", obj(status)), ("o_totalprice", "float32", total),
        ("o_orderdate", "string", obj(dates[orderdate])),
        ("o_orderpriority", "string",
         obj(np.asarray(dbgen.PRIORITIES)[rng.integers(0, 5, n_orders)])),
        ("o_clerk", "string", obj(clerks[rng.integers(0, len(clerks), n_orders)])),
        ("o_shippriority", "int32", np.zeros(n_orders, dtype=np.int32)),
        ("o_comment", "string", rf_comments(rng, o_comments, n_orders)),
    ]
    lineitem = [
        ("l_orderkey", "int32", keys[row]), ("l_partkey", "int32", partkey),
        ("l_suppkey", "int32", suppkey), ("l_linenumber", "int32", linenumber),
        ("l_quantity", "float32", qty), ("l_extendedprice", "float32", price),
        ("l_discount", "float32", disc), ("l_tax", "float32", tax),
        ("l_returnflag", "string", obj(rf_pool[rf_codes])),
        ("l_linestatus", "string", obj(ls_pool[ls_codes])),
        ("l_shipdate", "string", obj(dates[ship])),
        ("l_commitdate", "string", obj(dates[commit])),
        ("l_receiptdate", "string", obj(dates[receipt])),
        ("l_shipinstruct", "string",
         obj(np.asarray(dbgen.SHIP_INSTRUCT)[rng.integers(0, 4, n_lines)])),
        ("l_shipmode", "string", obj(np.asarray(dbgen.SHIP_MODE)[rng.integers(0, 7, n_lines)])),
        ("l_comment", "string", rf_comments(rng, l_comments, n_lines)),
    ]
    li = {"l_orderkey": keys[row], "l_quantity": qty, "l_extendedprice": price,
          "l_discount": disc, "l_tax": tax, "l_shipdate": (ship, dates),
          "l_returnflag": (rf_codes.astype(np.int32), rf_pool),
          "l_linestatus": (ls_codes, ls_pool)}
    return {"rf1_orders": orders, "rf1_lineitem": lineitem}, li


def rf2_keys(specs, sf: float, rng) -> np.ndarray:
    """RF2 (clause 2.5.3): SF x 1,500 order keys of the loaded population."""
    keys = spec_payload(specs, "orders", "o_orderkey")
    return np.sort(rng.choice(keys, max(int(round(1500 * sf)), 1), replace=False))


def write_tbl(path, columns) -> None:
    """A .tbl file (storage/load_table.py): names, types, one row a line."""
    cells = [np.asarray(values).astype(str) for _, _, values in columns]
    lines = ["|".join(name for name, _, _ in columns),
             "|".join(TBL_TYPES[kind] for _, kind, _ in columns)]
    lines += ["|".join(row) for row in zip(*cells)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def stage_rf(cat, rf1, keys, directory, device, oracle=None):
    """RF1's rows written as .tbl files and loaded with load_table, and RF2's
    keys, as the staging tables rf1_orders, rf1_lineitem and rf2_keys in
    `cat` (and the sqlite oracle). Every loaded value must equal the drawn
    one."""
    import os
    from hyrise_tpu_torch.storage.load_table import load_table
    from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
    from hyrise_tpu_torch.types import DataType
    from hyrise_tpu_torch.utils.sqlite_oracle import load_table_into_sqlite
    staged = {}
    for name, columns in rf1.items():
        path = os.path.join(directory, f"{name}.tbl")
        write_tbl(path, columns)
        t = load_table(path, name, device=device)
        for (column, _, values), c in zip(columns, t.columns):
            if c.name != column or not np.array_equal(c.decode(t.num_rows), values):
                raise AssertionError(f"{name}.{column}: loaded values differ from the drawn")
        staged[name] = t
    staged["rf2_keys"] = Table.from_arrays(
        "rf2_keys", [TableColumnDefinition("k", DataType.INT32)], [keys], device=device)
    for name, t in staged.items():
        if cat.has_table(name):
            cat.drop_table(name)
        cat.add_table(name, t)
        if oracle is not None:
            load_table_into_sqlite(oracle.conn, name, t)


def set_mvcc(tables) -> int:
    """Every table's rows visible from commit id 0; the bytes of its MVCC
    tensors."""
    from hyrise_tpu_torch.concurrency.transaction import MvccData
    total = 0
    for t in tables.values():
        t.mvcc = MvccData.for_new_table(t.num_rows, t.capacity, device=t.device)
        if t.mvcc.device != t.device:
            raise AssertionError(f"{t.name}'s MVCC tensors are on {t.mvcc.device}")
        total += 3 * 8 * t.mvcc.capacity
    return total


def run_statements(statements, cat, context, make_pipeline, device):
    """Each statement through the SQL pipeline with MVCC on, in `context`;
    per statement its host ms after the device has finished, and the
    optimize (table statistics included) and execute ms of its
    StatementMetrics."""
    ms = []
    for sql in statements:
        t0 = time.perf_counter()
        pipeline = make_pipeline(sql).with_catalog(cat).with_mvcc(True) \
            .with_transaction_context(context).create_pipeline()
        out = pipeline.get_result_table()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        m = pipeline.pipeline_statements[-1].metrics
        ms.append(((time.perf_counter() - t0) * 1e3, m.optimize_s * 1e3, m.execute_s * 1e3))
        if out.device != device:
            raise AssertionError(f"{sql!r} came out on {out.device}")
    return ms


def statement_ms(statements, ms) -> str:
    return ", ".join(f"{sql!r} {total:.3f} (optimize {optimize:.3f}, execute {execute:.3f})"
                     for sql, (total, optimize, execute) in zip(statements, ms))


def mvcc_rows(sql, cat, make_pipeline, device, context=None):
    """(rows, plan) of a SELECT with MVCC on, in `context` or a new one."""
    b = make_pipeline(sql).with_catalog(cat).with_mvcc(True)
    if context is not None:
        b = b.with_transaction_context(context)
    pipeline = b.create_pipeline()
    out = pipeline.get_result_table()
    if out.device != device:
        raise AssertionError(f"{sql[:40]!r}... came out on {out.device}")
    return out.rows(), pipeline.pipeline_statements[-1].last_plan


def visible_count(table: str, cat, make_pipeline, device, context=None) -> int:
    rows, _ = mvcc_rows(f"SELECT COUNT(*) FROM {table}", cat, make_pipeline, device, context)
    return int(rows[0][0])


def join_paths(plan, join_operator) -> list:
    """The path each Join of the plan took: "lut" (K4), "lookup" (K8) or
    "ranges" (K5)."""
    return sorted(op.path for op in operators_of(plan) if isinstance(op, join_operator))


def small_refresh_run(device, sf: float, qids, make_pipeline, oracle_class, tpch_sql,
                      table_eq, directory) -> str:
    """At a small scale against sqlite: RF1, the texts with MVCC on, RF2,
    the texts again; sqlite runs the same statements on the same rows."""
    from hyrise_tpu_torch.tpch import dbgen
    specs = dbgen.generate_specs(sf, SEED)
    small = dbgen.generate_tables(sf, SEED, device=device)
    oracle = oracle_class(small)
    for ddl in ("CREATE INDEX idx_l_ok ON lineitem(l_orderkey)",
                "CREATE INDEX idx_l_pk ON lineitem(l_partkey)",
                "CREATE INDEX idx_l_ps ON lineitem(l_partkey, l_suppkey)",
                "CREATE INDEX idx_o_ck ON orders(o_custkey)",
                "CREATE INDEX idx_o_ok ON orders(o_orderkey)",
                "CREATE INDEX idx_ps_pk ON partsupp(ps_partkey)"):
        oracle.conn.execute(ddl)
    set_mvcc(small)
    cat = catalog_of(small)
    rng = np.random.default_rng([SEED, RF_STREAM])
    rf1, _ = rf1_rows(specs, sf, rng)
    stage_rf(cat, rf1, rf2_keys(specs, sf, rng), directory, device, oracle)
    rows = {}
    for step, statements in (("RF1", RF1_STATEMENTS), ("RF2", RF2_STATEMENTS)):
        context = cat.transaction_manager.new_transaction_context()
        run_statements(statements, cat, context, make_pipeline, device)
        context.commit()
        for sql in statements:
            oracle.conn.execute(sql)
        for qid in qids:
            got, _ = mvcc_rows(tpch_sql[qid], cat, make_pipeline, device)
            check_rows(got, oracle.query(tpch_sql[qid]),
                       f"Q{qid} at SF{sf} with MVCC after {step} vs sqlite", table_eq)
            rows.setdefault(step, []).append(len(got))
    oracle.close()
    return f"SF{sf}: rows after RF1 {rows['RF1']}, after RF2 {rows['RF2']}"


def dml_phase(device, card, cat, tables, hand_rows, sql_wall, wrappers, table_eq,
              make_pipeline, join_operator, oracle_class, tpch_sql, time_ms):
    """Phase 7: writes on the card. Returns the launch counts of the phase."""
    import tempfile

    from hyrise_tpu_torch.ops.rw_ops import visible_rows
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.concurrency.transaction import TransactionConflict

    reset_counts(wrappers)
    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        # 7a. small scale against sqlite
        t0 = time.perf_counter()
        for sf in sorted({SMALL_SF, *SMALL_SF_OF.values()}):
            qids = [q for q in sorted(tpch_sql) if SMALL_SF_OF.get(q, SMALL_SF) == sf]
            log("dml: " + small_refresh_run(device, sf, qids, make_pipeline, oracle_class,
                                            tpch_sql, table_eq, directory))
        log(f"dml: RF1, the 22 texts with MVCC on, RF2 and the 22 again on {device} match "
            f"sqlite running the same statements at SF{SMALL_SF} (Q20 at "
            f"SF{SMALL_SF_OF[20]}): ints and strings equal, floats within 1e-6 relative; "
            f"{time.perf_counter() - t0:.1f} s")

        # 7b. SF1: every table under MVCC
        specs = dbgen.generate_specs(SF, SEED)
        mvcc_bytes = set_mvcc(tables)
        for name, t in tables.items():
            if t.mvcc.device != device:
                raise AssertionError(f"{name}'s MVCC tensors are on {t.mvcc.device}")
        log(f"dml: MVCC tensors of all {len(tables)} tables on {device}: "
            f"{mvcc_bytes / 1e6:.1f} MB (lineitem {3 * 8 * tables['lineitem'].capacity / 1e6:.1f}"
            f" MB for {tables['lineitem'].num_rows} rows)")
        tm = cat.transaction_manager
        before = tm.new_transaction_context()
        paths = {}
        for qid in SNAPSHOT_CHECKED:
            rows, plan = mvcc_rows(tpch_sql[qid], cat, make_pipeline, device, before)
            check_rows(rows, hand_rows[qid], f"Q{qid} with MVCC before RF1 vs phase 5", table_eq)
            paths[f"Q{qid} before RF1"] = join_paths(plan, join_operator)

        rng = np.random.default_rng([SEED, RF_STREAM])
        rf1, rf1_li = rf1_rows(specs, SF, rng)
        keys = rf2_keys(specs, SF, rng)
        t0 = time.perf_counter()
        stage_rf(cat, rf1, keys, directory, device)
        stage_s = time.perf_counter() - t0
        counts = {name: visible_count(name, cat, make_pipeline, device)
                  for name in ("orders", "lineitem")}
        old_dictionary = tables["lineitem"].column("l_comment").dictionary
        context = tm.new_transaction_context()
        rf1_ms = run_statements(RF1_STATEMENTS, cat, context, make_pipeline, device)
        context.commit()
        n_orders, n_lines = (cat.get_table(n).num_rows for n in ("rf1_orders", "rf1_lineitem"))
        grown = len(cat.get_table("lineitem").column("l_comment").dictionary) - \
            len(old_dictionary)
        if grown <= 0:
            raise AssertionError("RF1 added no string to l_comment's dictionary")
        after = {name: visible_count(name, cat, make_pipeline, device)
                 for name in ("orders", "lineitem")}
        if after != {"orders": counts["orders"] + n_orders,
                     "lineitem": counts["lineitem"] + n_lines}:
            raise AssertionError(f"visible rows after RF1 {after}, before {counts}")
        log(f"dml: RF1 staged from .tbl files by load_table in {stage_s:.2f} s; {n_orders} "
            f"orders and {n_lines} lineitems inserted in one transaction; l_comment's "
            f"dictionary grew by {grown} strings, so its {tables['lineitem'].num_rows} codes "
            f"were rewritten on the card; ms (host clock after synchronize) {card}: "
            + statement_ms(RF1_STATEMENTS, rf1_ms))

        # snapshot isolation: the snapshot taken before RF1 reads phase 5's rows
        for qid in SNAPSHOT_CHECKED:
            rows, plan = mvcc_rows(tpch_sql[qid], cat, make_pipeline, device, before)
            check_rows(rows, hand_rows[qid], f"Q{qid} in the snapshot before RF1", table_eq)
            paths[f"Q{qid} after RF1"] = join_paths(plan, join_operator)
        log(f"dml: Q{', Q'.join(map(str, SNAPSHOT_CHECKED))} in a snapshot taken before "
            f"RF1 equal phase 5's rows after RF1 committed")

        # after RF1: the oracles over base + RF1, and the card against the CPU
        li = {name: payload for name, _, payload in specs["lineitem"][0]}
        pool = dbgen.date_pool()
        base_rf1 = {}
        for name, payload in rf1_li.items():
            if isinstance(payload, tuple):
                base_rf1[name] = (np.concatenate([li[name][0], payload[0]]), payload[1])
            else:
                base_rf1[name] = np.concatenate([li[name], payload])
        check_oracles(cat, make_pipeline, device, tpch_sql, base_rf1, pool, "after RF1")
        context = tm.new_transaction_context()
        cpu_cat = catalog_of(copy_to({name: cat.get_table(name) for name in tables}, "cpu"))
        t0 = time.perf_counter()
        for qid in CPU_CHECKED:
            rows, _ = mvcc_rows(tpch_sql[qid], cat, make_pipeline, device, context)
            want, _ = mvcc_rows(tpch_sql[qid], cpu_cat, make_pipeline, torch.device("cpu"),
                                context)
            check_rows(rows, want, f"Q{qid} with MVCC after RF1, card vs CPU", table_eq)
        log(f"dml: Q{', Q'.join(map(str, CPU_CHECKED))} with MVCC after RF1 equal the same "
            f"texts over CPU copies of the tables and MVCC state "
            f"({time.perf_counter() - t0:.1f} s)")

        # a second RF1 that rolls back leaves the visible rows as they were
        context = tm.new_transaction_context()
        run_statements(RF1_STATEMENTS, cat, context, make_pipeline, device)
        inside = visible_count("lineitem", cat, make_pipeline, device, context)
        context.rollback()
        if inside != after["lineitem"] + n_lines or {
                name: visible_count(name, cat, make_pipeline, device)
                for name in ("orders", "lineitem")} != after:
            raise AssertionError("a rolled-back RF1 changed the visible rows")
        log(f"dml: a second RF1 saw its own {n_lines} lineitems, rolled back and left "
            f"{after} visible")

        # RF2
        context = tm.new_transaction_context()
        rf2_ms = run_statements(RF2_STATEMENTS, cat, context, make_pipeline, device)
        context.commit()
        gone = np.isin(base_rf1["l_orderkey"], keys)
        left = {"orders": after["orders"] - len(keys),
                "lineitem": after["lineitem"] - int(gone.sum())}
        seen = {name: visible_count(name, cat, make_pipeline, device)
                for name in ("orders", "lineitem")}
        if seen != left:
            raise AssertionError(f"visible rows after RF2 {seen}, expected {left}")
        log(f"dml: RF2 deleted {len(keys)} orders and {int(gone.sum())} lineitems in one "
            f"transaction; ms {card}: " + statement_ms(RF2_STATEMENTS, rf2_ms))
        base_rf1_rf2 = {name: ((p[0][~gone], p[1]) if isinstance(p, tuple) else p[~gone])
                        for name, p in base_rf1.items()}
        check_oracles(cat, make_pipeline, device, tpch_sql, base_rf1_rf2, pool, "after RF2")

        # the 22 texts with MVCC on: first run and median, every value finite
        wall = {}
        for qid in sorted(tpch_sql):
            first, median, rows = timed_query(
                lambda: mvcc_rows(tpch_sql[qid], cat, make_pipeline, device)[0])
            check_finite(rows, f"Q{qid} with MVCC after RF2")
            wall[qid] = (first, median)
        log(f"dml: SF{SF} wall ms with MVCC on after RF1 and RF2 (host clock, to rows on "
            f"the host; first run, then median of {QUERY_REPS}; phase 6's median with MVCC "
            f"off beside it) {card}: "
            + "; ".join(f"Q{q} {wall[q][0]:.3f} / {wall[q][1]:.3f} ({sql_wall[q][1]:.3f})"
                        for q in sorted(wall)))
        log(f"dml: sum of medians with MVCC {sum(m for _, m in wall.values()):.3f} ms, "
            f"without (phase 6) {sum(m for _, m in sql_wall.values()):.3f} ms {card}")

        lineitem = cat.get_table("lineitem")
        context = tm.new_transaction_context()
        validate_ms = time_ms(lambda i: visible_rows(lineitem.mvcc, lineitem.capacity,
                                                     context), device)
        bound = lineitem.capacity * (3 * 8 + 1) / PEAK_BYTES_PER_S * 1e3
        log(f"dml: Validate's mask on lineitem ({lineitem.capacity} rows of capacity, "
            f"{lineitem.num_rows} stored) {validate_ms:.4f} device ms (CUDA events), bound "
            f"{bound:.4f} (3 int64 reads and a bool write a row) {card}")

        # two transactions delete the same order: the second conflicts
        key = int(np.setdiff1d(spec_payload(specs, "orders", "o_orderkey")[:100], keys)[0])
        c1, c2 = tm.new_transaction_context(), tm.new_transaction_context()
        run_statements([f"DELETE FROM orders WHERE o_orderkey = {key}"], cat, c1,
                       make_pipeline, device)
        try:
            run_statements([f"DELETE FROM orders WHERE o_orderkey = {key}"], cat, c2,
                           make_pipeline, device)
        except TransactionConflict:
            pass
        else:
            raise AssertionError("a second delete of a locked row did not conflict")
        c2.rollback()
        c1.commit()
        if visible_count("orders", cat, make_pipeline, device) != left["orders"] - 1:
            raise AssertionError("the first delete of the conflict did not commit")
        log(f"dml: two transactions deleted order {key}: the second raised "
            f"TransactionConflict and rolled back, the first committed")

        # growth past capacity while a Delete is pending
        suppliers = tables["supplier"].num_rows
        context = tm.new_transaction_context()
        run_statements(["CREATE TABLE growth (k int, name string, bal float)",
                        "INSERT INTO growth SELECT s_suppkey, s_name, s_acctbal FROM supplier"],
                       cat, context, make_pipeline, device)
        context.commit()
        capacity = cat.get_table("growth").capacity
        context = tm.new_transaction_context()
        run_statements(["DELETE FROM growth WHERE k <= 10"], cat, context, make_pipeline,
                       device)
        inserts = 0
        while cat.get_table("growth").capacity == capacity:  # one at SF1
            inserts += 1
            run_statements([f"INSERT INTO growth SELECT s_suppkey + {inserts * 1_000_000}, "
                            "s_name, s_acctbal FROM supplier"], cat, context,
                           make_pipeline, device)
        grown_table = cat.get_table("growth")
        context.commit()
        if grown_table.mvcc.device != device:
            raise AssertionError(f"growth: MVCC tensors on {grown_table.mvcc.device}")
        rows, _ = mvcc_rows("SELECT COUNT(*), SUM(CASE WHEN k <= 10 THEN 1 ELSE 0 END) "
                            "FROM growth", cat, make_pipeline, device)
        if [tuple(int(v) for v in r) for r in rows] != [((1 + inserts) * suppliers - 10, 0)]:
            raise AssertionError(f"growth with a pending delete: {rows}")
        log(f"dml: a table grew from {capacity} to {grown_table.capacity} rows of capacity "
            f"while a Delete was pending; both the Delete and the Insert committed")

    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"dml: join paths (Join.path) {paths}")
    log(f"dml: launches in phase 7 {launches}")
    log(f"dml: phase 7 took {time.perf_counter() - started:.1f} s")
    return launches


# -- 8. physical design: encodings, block statistics, indexes ----------------------

PHYSICAL_ENCODINGS = ("DICTIONARY", "RUN_LENGTH", "FRAME_OF_REFERENCE")
PHYSICAL_REPS = 3              # median of 3 after the first run
# the stored columns the 22 texts scan, and the two composite keys
INDEXED = (("orders", "o_orderdate"), ("lineitem", "l_shipdate"),
           ("customer", "c_mktsegment"), ("part", "p_size"), ("part", "p_brand"),
           ("part", "p_type"), ("nation", "n_name"), ("region", "r_name"),
           ("supplier", "s_suppkey"), ("customer", "c_custkey"), ("orders", "o_orderkey"),
           ("part", "p_partkey"), ("lineitem", ("l_orderkey", "l_linenumber")),
           ("partsupp", ("ps_partkey", "ps_suppkey")))
LOOKUP_STREAM = 8              # np.random.default_rng([SEED, LOOKUP_STREAM]) draws the keys
POINT_LOOKUPS = 1000
ABSENT_LOOKUPS = 100           # of the point lookups, keys no order has
COMPOSITE_LOOKUPS = 100
ABSENT_COMPOSITE = 10
JOIN_INDEX_MODES = ("INNER", "LEFT", "SEMI", "ANTI")
# the kernels phase 8 must launch: every compaction (K9), JoinIndex's pairs (K5)
PHYSICAL_KERNELS = ("compact_indices", "expand_pairs")


def plain_copies(tables):
    """Phase 4's tables as new Table objects over the same column tensors,
    without the MVCC state phase 7 left on them (and without statistics or
    indexes)."""
    from hyrise_tpu_torch.storage.table import Table
    return {name: Table(t.columns, t.num_rows, name=name) for name, t in tables.items()}


def distinct_operators(plan, cls) -> list:
    return [op for op in operators_of(plan) if isinstance(op, cls)]


def physical_texts(cat, make_pipeline, tpch_sql, hand_rows, table_eq, what: str,
                   reps: int = PHYSICAL_REPS):
    """The 22 texts over `cat`, each equal as a row set to phase 6's rows
    (those of the hand plans, which phase 6 matched): per text (first run
    ms, median ms of `reps` more with the plan cached, the plan)."""
    out = {}
    for qid in sorted(tpch_sql):
        rows, _, plan, first = run_sql_text(tpch_sql[qid], cat, make_pipeline)
        check_rows(rows, hand_rows[qid], f"{what}: SQL Q{qid} vs phase 6", table_eq)
        times = []
        for _ in range(reps):
            rows, _, plan, ms = run_sql_text(tpch_sql[qid], cat, make_pipeline)
            times.append(ms)
        if reps:
            check_rows(rows, hand_rows[qid], f"{what}: SQL Q{qid}, cached plan", table_eq)
        out[qid] = (first, statistics.median(times) if times else first, plan)
    return out


def texts_ms(runs) -> str:
    return "; ".join(f"Q{q} {first:.3f} / {median:.3f}"
                     for q, (first, median, _) in sorted(runs.items()))


def payload_tensors(payload):
    import dataclasses
    return [getattr(payload, f.name) for f in dataclasses.fields(payload)
            if isinstance(getattr(payload, f.name), torch.Tensor)]


def held_mb(tables) -> float:
    """MB the tables' columns hold on the device now, each storage once: an
    encoded column its payload and, once a read has decoded it (the decode
    is cached on the column), its dense form too."""
    storages = {}
    for t in tables.values():
        for c in t.columns:
            tensors = [] if c.encoded is None else payload_tensors(c.encoded)
            tensors += [x for x in (c._data, c._validity) if isinstance(x, torch.Tensor)]
            for x in tensors:
                storages[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
    return sum(storages.values()) / 1e6


def bound_ms(n_bytes: int) -> float:
    return n_bytes / PEAK_BYTES_PER_S * 1e3


def decode_timing(table, column: str, device, time_ms) -> str:
    """Device ms of one column's decode (CUDA events, L2 flushed) beside its
    bound: the payload read once and the dense column written once."""
    from hyrise_tpu_torch.storage.encoding import encoded_memory_bytes
    c = table.column(column)
    dtype = c.dtype.torch_dtype
    ms = time_ms(lambda i: c.encoded.decode(dtype), device)
    out_bytes = c.capacity * torch.tensor([], dtype=dtype).element_size()
    bound = bound_ms(encoded_memory_bytes(c) + out_bytes)
    return (f"{column} ({type(c.encoded).__name__}, {encoded_memory_bytes(c) / 1e6:.2f} MB "
            f"at rest) {ms:.4f} ms, bound {bound:.4f}")


def same_table(got, want, columns, what: str) -> None:
    """The same rows in the same order: the named columns' tensors equal on
    the device, validity included."""
    from hyrise_tpu_torch.ops.materialize import ensure_prefix
    got, want = ensure_prefix(got), ensure_prefix(want)
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} rows vs {want.num_rows}")
    for name in columns:
        a, b = got.column(name), want.column(name)
        n = got.num_rows
        if not torch.equal(a.data[:n], b.data[:n]):
            raise AssertionError(f"{what}: column {name} differs")
        va = torch.ones(n, dtype=torch.bool, device=a.device) if a.validity is None \
            else a.validity[:n]
        vb = torch.ones(n, dtype=torch.bool, device=b.device) if b.validity is None \
            else b.validity[:n]
        if not torch.equal(va, vb):
            raise AssertionError(f"{what}: column {name}'s NULLs differ")


def host_ms(run, device, reps: int = 1):
    """Median host ms of run() over `reps` calls, each ending in a
    synchronize, and the last result."""
    times, out = [], None
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def small_fault_checks(device) -> str:
    """ROADMAP C13 (INT64 above 2^53), C14 (NaN in a block) and C15 (NULL
    and NaN rows against an index) on small tables on the device: the rows
    of the same scan without statistics or index, and the rows expected."""
    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops import IndexScan, TableScan, TableWrapper, execute_plan
    from hyrise_tpu_torch.storage.block_statistics import attach_block_statistics
    from hyrise_tpu_torch.storage.index import create_index
    from hyrise_tpu_torch.storage.interop import table_from_numpy
    from hyrise_tpu_torch.types import PredicateCondition as P

    def scans(t, pred):
        plain = execute_plan(TableScan(TableWrapper(t), pred)).rows()
        attach_block_statistics(t, 64)
        pruned = execute_plan(TableScan(TableWrapper(t), pred)).rows()
        t.block_stats = None
        return pruned, plain

    v = 2**53 + 3
    t = table_from_numpy("c13", [("a", "int64", np.array([v]), None, None)], 1, device=device)
    pruned, plain = scans(t, ast.col("a") < ast.lit(v + 1))
    if [tuple(int(x) for x in r) for r in pruned] != [(v,)] or pruned != plain:
        raise AssertionError(f"C13: {pruned} with statistics, {plain} without")
    t = table_from_numpy("c14", [("a", "float64", np.array([1.0, np.nan]), None, None)], 2,
                         device=device)
    pruned, plain = scans(t, ast.col("a") == ast.lit(1.0))
    if [float(r[0]) for r in pruned] != [1.0] or len(plain) != 1:
        raise AssertionError(f"C14: {pruned} with statistics, {plain} without")
    t = table_from_numpy("c15", [
        ("a", "float64", np.array([1.0, np.nan, 7.0, 0.0]),
         np.array([True, True, True, False]), None),
        ("r", "int32", np.arange(4, dtype=np.int32), None, None)], 4, device=device)
    create_index(t, "a")
    for cond, value in ((P.GREATER_THAN, 5.0), (P.GREATER_THAN_EQUALS, 1.0),
                        (P.LESS_THAN, float("inf")), (P.EQUALS, float("nan"))):
        got = execute_plan(IndexScan(TableWrapper(t), "a", cond, value)).rows()
        want = execute_plan(TableScan(TableWrapper(t), ast.Comparison(
            cond, ast.col("a"), ast.lit(value)))).rows()
        if sorted(int(r[1]) for r in got) != sorted(int(r[1]) for r in want):
            raise AssertionError(f"C15: IndexScan a {cond.value} {value}: {got} vs {want}")
    return ("C13 (INT64 2^53 + 3 against 2^53 + 4), C14 ([1.0, NaN] = 1.0) and C15 "
            "([1.0, NaN, 7.0, NULL] > 5, >= 1, < inf, = NaN through an index) on "
            f"{device} give the rows of the same scans without statistics or index")


def physical_phase(device, card, tables, hand_rows, wrappers, table_eq, make_pipeline,
                   tpch_sql, time_ms):
    """Phase 8: physical design on the card. Returns the launch counts of
    the phase."""
    import tempfile

    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops import (GetTable, IndexScan, Join, JoinIndex, TableScan,
                                      execute_plan)
    from hyrise_tpu_torch.storage.block_statistics import attach_block_statistics
    from hyrise_tpu_torch.storage.encoding import (ChunkEncoder, EncodingType,
                                                   encoded_memory_bytes)
    from hyrise_tpu_torch.storage.index import create_index
    from hyrise_tpu_torch.tasks import ChunkCompressionTask
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.types import JoinMode, PredicateCondition

    reset_counts(wrappers)
    started = time.perf_counter()
    plain = plain_copies(tables)
    dense_mb = {name: sum(encoded_memory_bytes(c) for c in t.columns) / 1e6
                for name, t in plain.items()}

    # 8a. encodings: every table three times, the 22 texts over each
    for enc_name in PHYSICAL_ENCODINGS:
        enc = EncodingType[enc_name]
        encode_s, encoded = host_ms(lambda: {name: ChunkEncoder.encode_table(t, enc)
                                             for name, t in plain_copies(tables).items()},
                                    device)
        n_encoded = 0
        for name, t in encoded.items():
            for c in t.columns:
                if c.encoded is None:
                    continue
                n_encoded += 1
                if any(p.device != device for p in payload_tensors(c.encoded)):
                    raise AssertionError(f"{enc_name} {name}.{c.name}: payload off {device}")
        log(f"physical: {enc_name}: {n_encoded} columns of {len(encoded)} tables encoded on "
            f"{device} in {encode_s:.1f} ms (host clock after synchronize) {card}; at-rest "
            "MB / dense MB: " + ", ".join(
                f"{name} {sum(encoded_memory_bytes(c) for c in t.columns) / 1e6:.1f} / "
                f"{dense_mb[name]:.1f}" for name, t in sorted(encoded.items())))
        if enc is EncodingType.RUN_LENGTH:
            log(f"physical: decode device ms (CUDA events, L2 flushed) {card}: "
                + decode_timing(encoded["lineitem"], "l_orderkey", device, time_ms))
        if enc is EncodingType.FRAME_OF_REFERENCE:
            log(f"physical: decode device ms (CUDA events, L2 flushed) {card}: "
                + "; ".join(decode_timing(encoded["lineitem"], column, device, time_ms)
                            for column in ("l_orderkey", "l_partkey")))
        held_before = held_mb(encoded)
        runs = physical_texts(catalog_of(encoded), make_pipeline, tpch_sql, hand_rows,
                              table_eq, enc_name)
        log(f"physical: {enc_name}: the 22 texts equal phase 6's rows (as sets, floats within "
            f"1e-6 relative); wall ms (host clock, first run / median of {PHYSICAL_REPS}, "
            f"the first decodes what it reads) {card}: {texts_ms(runs)}; sum of medians "
            f"{sum(m for _, m, _ in runs.values()):.3f}; the 8 tables hold {held_before:.1f} MB "
            f"on the card before the texts and {held_mb(encoded):.1f} after (decodes are "
            f"cached on the columns; dense {held_mb(plain):.1f})")
        del encoded, runs

    # 8b. compression after writes: RF1 into a DICTIONARY catalog under MVCC
    encoded = {name: ChunkEncoder.encode_table(t, EncodingType.DICTIONARY)
               for name, t in plain_copies(tables).items()}
    set_mvcc(encoded)
    cat = catalog_of(encoded)
    specs = dbgen.generate_specs(SF, SEED)
    rng = np.random.default_rng([SEED, RF_STREAM])
    rf1, rf1_li = rf1_rows(specs, SF, rng)
    with tempfile.TemporaryDirectory() as directory:
        stage_rf(cat, rf1, rf2_keys(specs, SF, rng), directory, device)
    context = cat.transaction_manager.new_transaction_context()
    rf1_ms = run_statements(RF1_STATEMENTS, cat, context, make_pipeline, device)
    context.commit()
    checked = (1, 3, 6)
    for name in ("orders", "lineitem"):
        t = cat.get_table(name)
        if any(c.encoded is not None for c in t.columns) or \
                t.encoding_spec is not EncodingType.DICTIONARY:
            raise AssertionError(f"{name} after RF1: an appended column is still encoded")
    before = {qid: mvcc_rows(tpch_sql[qid], cat, make_pipeline, device)[0] for qid in checked}
    task_ms = {}
    for name in ("orders", "lineitem"):
        task_ms[name], out = host_ms(lambda: ChunkCompressionTask(name, cat).run(), device)
        if cat.get_table(name) is not out or any(c.encoded is None for c in out.columns):
            raise AssertionError(f"{name}: ChunkCompressionTask left a column dense")
    for qid in checked:
        rows, _ = mvcc_rows(tpch_sql[qid], cat, make_pipeline, device)
        check_rows(rows, before[qid], f"Q{qid} after ChunkCompressionTask vs before", table_eq)
    li = {name: payload for name, _, payload in specs["lineitem"][0]}
    base_rf1 = {name: ((np.concatenate([li[name][0], p[0]]), p[1]) if isinstance(p, tuple)
                       else np.concatenate([li[name], p])) for name, p in rf1_li.items()}
    check_oracles(cat, make_pipeline, device, tpch_sql, base_rf1, dbgen.date_pool(),
                  "after RF1 into DICTIONARY tables and ChunkCompressionTask", tag="physical")
    log(f"physical: RF1 into DICTIONARY-encoded tables under MVCC ("
        + statement_ms(RF1_STATEMENTS, rf1_ms) + f" ms) left orders' and lineitem's columns "
        f"dense; ChunkCompressionTask encoded them again in {task_ms['orders']:.1f} / "
        f"{task_ms['lineitem']:.1f} ms (host clock after synchronize) {card}; "
        f"Q{', Q'.join(map(str, checked))} give the same rows before and after the task")
    del encoded, cat, before

    # 8c. block statistics and scan pruning
    stats_tables = plain_copies(tables)
    generate_ms = {}
    for name, t in stats_tables.items():
        generate_ms[name], _ = host_ms(lambda: attach_block_statistics(t), device)
    li_stats = stats_tables["lineitem"]
    li_bytes = sum(c.data.numel() * c.data.element_size() for c in li_stats.columns)
    from hyrise_tpu_torch.storage.block_statistics import BlockStatistics
    generate_dev = time_ms(lambda i: BlockStatistics.generate(li_stats), device)
    cat = catalog_of(stats_tables)
    physical_texts(cat, make_pipeline, tpch_sql, hand_rows, table_eq, "block statistics",
                   reps=0)
    pruned = []
    for pred, text in ((ast.col("l_shipdate") > ast.lit("1998-12-31"),
                        "l_shipdate > '1998-12-31'"),
                       (ast.col("l_orderkey") > ast.lit(6_000_000), "l_orderkey > 6000000")):
        scan = TableScan(GetTable("lineitem", cat), pred)
        ms, out = host_ms(lambda: execute_plan(scan), device)
        full = TableScan(GetTable("lineitem", catalog_of(plain_copies(tables))), pred)
        full_ms, full_out = host_ms(lambda: execute_plan(full), device)
        if scan.performance_data.extra.get("pruned_all_blocks") is not True or \
                out.num_rows != 0 or full_out.num_rows != 0 or out.rows() != []:
            raise AssertionError(f"{text}: not pruned to an empty table")
        pruned.append(f"{text} pruned all {li_stats.block_stats.n_blocks} blocks in "
                      f"{ms:.3f} ms (scanned without statistics: {full_ms:.3f} ms)")
    near = int(spec_payload(specs, "orders", "o_orderkey").max()) - 1000
    scan = TableScan(GetTable("lineitem", cat), ast.col("l_orderkey") > ast.lit(near))
    kept = execute_plan(scan)
    if "pruned_all_blocks" in scan.performance_data.extra or kept.num_rows == 0:
        raise AssertionError(f"l_orderkey > {near} was pruned")
    # the same through SQL, whose scans read the stored table through an
    # Alias and a column-pruning Projection
    sql_pruned = []
    for sql, want_pruned in (
            ("SELECT l_orderkey, l_quantity FROM lineitem WHERE l_shipdate > '1998-12-31'",
             True),
            ("SELECT l.l_partkey FROM lineitem AS l WHERE l.l_orderkey > 6000000", True),
            (f"SELECT l_orderkey FROM lineitem WHERE l_orderkey > {near}", False)):
        rows, _, plan, ms = run_sql_text(sql, cat, make_pipeline)
        flags = [op.performance_data.extra.get("pruned_all_blocks", False)
                 for op in distinct_operators(plan, TableScan)]
        if not flags or any(flags) is not want_pruned or \
                (len(rows) == 0) is not want_pruned or \
                (not want_pruned and len(rows) != kept.num_rows):
            raise AssertionError(f"SQL {sql!r}: pruned {flags}, {len(rows)} rows")
        sql_pruned.append(f"{sql!r} {'pruned every block' if want_pruned else 'kept'} "
                          f"({len(rows)} rows, {ms:.3f} ms)")
    log(f"physical: block statistics of all {len(stats_tables)} tables on the card; generate "
        f"(host clock after synchronize, the host copy included) "
        f"ms {card}: " + ", ".join(f"{n} {ms:.2f}" for n, ms in sorted(generate_ms.items()))
        + f"; lineitem's device ms (CUDA events, L2 flushed) {generate_dev:.4f}, bound "
        f"{bound_ms(li_bytes):.4f} ({li_bytes / 1e6:.1f} MB read); the 22 texts equal phase "
        f"6's rows; " + "; ".join(pruned) + f"; l_orderkey > {near} kept {kept.num_rows} "
        f"rows; through SQL (host clock, plan cache on): " + "; ".join(sql_pruned))
    log("physical: " + small_fault_checks(device))
    del stats_tables, cat

    # 8d. indexes
    idx_tables = plain_copies(tables)
    builds = []
    for name, column in INDEXED:
        ms, idx = host_ms(lambda: create_index(idx_tables[name], column), device)
        builds.append(f"{name}.{column if isinstance(column, str) else '+'.join(column)} "
                      f"{ms:.2f}")
    build_dev = time_ms(lambda i: create_index(plain_copies(tables)["lineitem"], "l_shipdate"),
                        device)
    n_li = idx_tables["lineitem"].num_rows
    build_bound = bound_ms(n_li * (4 + 4 + 8))  # codes in; codes and rows out
    cat = catalog_of(idx_tables)
    runs = physical_texts(cat, make_pipeline, tpch_sql, hand_rows, table_eq, "indexes")
    scans = {qid: len(distinct_operators(plan, IndexScan)) for qid, (_, _, plan) in runs.items()}
    if sum(scans.values()) <= 0:
        raise AssertionError("no IndexScan ran in the 22 texts with indexes")
    log(f"physical: indexes built (host clock after synchronize, ms) {card}: "
        + ", ".join(builds) + f"; lineitem.l_shipdate's build {build_dev:.4f} device ms "
        f"(CUDA events, L2 flushed), bound {build_bound:.4f}")
    log(f"physical: indexes: the 22 texts equal phase 6's rows; IndexScans a plan {scans} "
        f"({sum(scans.values())} in all); wall ms (first / median of {PHYSICAL_REPS}) "
        f"{card}: {texts_ms(runs)}; sum of medians {sum(m for _, m, _ in runs.values()):.3f}")

    # one IndexScan's gather at SF1: a year of o_orderdate, every orders column
    year = IndexScan(GetTable("orders", cat), "o_orderdate", PredicateCondition.BETWEEN,
                     "1995-01-01", "1995-12-31")
    out = execute_plan(year)
    row_bytes = sum(c.data.element_size() for c in idx_tables["orders"].columns)
    start, end = year.performance_data.extra["index_range"]
    perm = idx_tables["orders"].indexes["o_orderdate"].perm[start:end]
    gather_ms = time_ms(lambda i: [c.data.index_select(0, perm)
                                   for c in idx_tables["orders"].columns], device)
    gather_bound = bound_ms(perm.numel() * (8 + 2 * row_bytes))
    log(f"physical: IndexScan o_orderdate BETWEEN '1995-01-01' AND '1995-12-31': "
        f"{out.num_rows} rows; its gather of all {len(idx_tables['orders'].columns)} columns "
        f"{gather_ms:.4f} device ms (CUDA events, L2 flushed), bound {gather_bound:.4f} {card}")

    # point lookups through SQL, with and without the index
    lookup_rng = np.random.default_rng([SEED, LOOKUP_STREAM])
    keys = spec_payload(specs, "orders", "o_orderkey")
    present = lookup_rng.choice(keys, POINT_LOOKUPS - ABSENT_LOOKUPS, replace=False)
    gaps = lookup_rng.integers(0, len(keys), ABSENT_LOOKUPS)
    absent = ((gaps // 8) * 32 + 8 + gaps % 8 + 1).astype(np.int64)  # RF1's key gaps
    absent[:2] = (keys.max() + 1, -1)
    lookups = lookup_rng.permutation(np.concatenate([present, absent]))
    if np.isin(absent, keys).any():
        raise AssertionError("an absent lookup key is an order's")
    no_index = catalog_of(plain_copies(tables))
    sql = "SELECT o_orderkey, o_custkey, o_totalprice, o_orderdate FROM orders " \
          "WHERE o_orderkey = {}"
    results = {}
    for which, c in (("index", cat), ("scan", no_index)):
        t0 = time.perf_counter()
        rows = [run_sql_text(sql.format(k), c, make_pipeline) for k in lookups]
        results[which] = ((time.perf_counter() - t0) * 1e3 / len(lookups), rows)
    found = 0
    for k, (got, _, plan, _), (want, _, wplan, _) in zip(lookups, results["index"][1],
                                                         results["scan"][1]):
        check_rows(got, want, f"point lookup o_orderkey = {k}", table_eq)
        found += len(got) > 0
        if not distinct_operators(plan, IndexScan) or distinct_operators(wplan, IndexScan):
            raise AssertionError(f"o_orderkey = {k}: the IndexScan is not where it belongs")
    if found != POINT_LOOKUPS - ABSENT_LOOKUPS:
        raise AssertionError(f"{found} point lookups found their order")
    composite = []
    li_keys = spec_payload(specs, "lineitem", "l_orderkey")
    li_lines = spec_payload(specs, "lineitem", "l_linenumber")
    picks = lookup_rng.choice(len(li_keys), COMPOSITE_LOOKUPS, replace=False)
    pairs = [(int(li_keys[p]), int(li_lines[p])) for p in picks]
    pairs[:ABSENT_COMPOSITE] = [(k, 8) for k, _ in pairs[:ABSENT_COMPOSITE]]  # 1 to 7 lines
    csql = "SELECT l_orderkey, l_linenumber, l_quantity, l_extendedprice FROM lineitem " \
           "WHERE l_orderkey = {} AND l_linenumber = {}"
    t0 = time.perf_counter()
    for k, n in pairs:
        got, _, plan, _ = run_sql_text(csql.format(k, n), cat, make_pipeline)
        want, _, _, _ = run_sql_text(csql.format(k, n), no_index, make_pipeline)
        check_rows(got, want, f"composite lookup ({k}, {n})", table_eq)
        composite.append(len(got))
        if not any(op.performance_data.extra.get("composite_index")
                   for op in distinct_operators(plan, IndexScan)):
            raise AssertionError(f"({k}, {n}): no composite IndexScan")
    if composite[:ABSENT_COMPOSITE] != [0] * ABSENT_COMPOSITE or \
            0 in composite[ABSENT_COMPOSITE:]:
        raise AssertionError(f"composite lookups found {composite}")
    composite_s = time.perf_counter() - t0
    orders = idx_tables["orders"]
    op_ms = {}
    for which, make in (
            ("IndexScan", lambda k: IndexScan(GetTable("orders", cat), "o_orderkey",
                                              PredicateCondition.EQUALS, int(k))),
            ("TableScan", lambda k: TableScan(GetTable("orders", no_index),
                                              ast.col("o_orderkey") == ast.lit(int(k))))):
        t0 = time.perf_counter()
        for k in lookups:
            execute_plan(make(k)).rows()
        op_ms[which] = (time.perf_counter() - t0) * 1e3 / len(lookups)
    log(f"physical: {POINT_LOOKUPS} point lookups on o_orderkey ({ABSENT_LOOKUPS} absent keys) "
        f"through SQL equal the same statements without indexes; host ms a lookup (to rows on "
        f"the host, the plan cache missing on every new text) {card}: IndexScan "
        f"{results['index'][0]:.3f}, TableScan {results['scan'][0]:.3f}; the operators alone: "
        f"IndexScan {op_ms['IndexScan']:.3f}, TableScan {op_ms['TableScan']:.3f} over "
        f"{orders.num_rows} rows; {COMPOSITE_LOOKUPS} composite lookups on (l_orderkey, "
        f"l_linenumber) ({ABSENT_COMPOSITE} absent) through SQL equal the same without "
        f"indexes, both in {composite_s:.1f} s")

    # JoinIndex: orders probing lineitem's index on l_orderkey, against Join
    ms, _ = host_ms(lambda: create_index(idx_tables["lineitem"], "l_orderkey"), device)
    joined = []
    for mode in JOIN_INDEX_MODES:
        pair = ("o_orderkey", "l_orderkey")
        make_ji = lambda: JoinIndex(GetTable("orders", cat), GetTable("lineitem", cat),  # noqa
                                    JoinMode[mode], pair)
        make_j = lambda: Join(GetTable("orders", cat), GetTable("lineitem", cat),  # noqa
                              JoinMode[mode], pair)
        ji = make_ji()
        ji_out = execute_plan(ji)
        j = make_j()
        j_out = execute_plan(j)
        columns = ["o_orderkey", "o_custkey"] + (
            [] if mode in ("SEMI", "ANTI") else ["l_orderkey", "l_linenumber", "l_quantity"])
        same_table(ji_out, j_out, columns, f"JoinIndex {mode}")
        if ji.performance_data.extra.get("index_used") is not True or ji.path != "ranges":
            raise AssertionError(f"JoinIndex {mode}: the index did not serve")
        ji_ms, _ = host_ms(lambda: execute_plan(make_ji()).num_rows, device, PHYSICAL_REPS)
        j_ms, _ = host_ms(lambda: execute_plan(make_j()).num_rows, device, PHYSICAL_REPS)
        joined.append(f"{mode} {ji_out.num_rows} rows, JoinIndex {ji_ms:.3f} ms, Join "
                      f"{j_ms:.3f} ms ({j.path})")
    log(f"physical: JoinIndex of orders with lineitem on the order key (lineitem's index "
        f"built in {ms:.2f} ms) equals Join, rows in order, with index_used; host ms after "
        f"synchronize, median of {PHYSICAL_REPS} {card}: " + "; ".join(joined))

    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"physical: launches in phase 8 {launches}")
    log(f"physical: phase 8 took {time.perf_counter() - started:.1f} s")
    return launches


def ran_fused(plan) -> bool:
    """Whether the plan holds one FusedFilterAggregate and it did not fall
    back to a scan and an aggregate."""
    from hyrise_tpu_torch.kernels.fused import FusedFilterAggregate
    fused = [op for op in operators_of(plan) if isinstance(op, FusedFilterAggregate)]
    return len(fused) == 1 and fused[0].fell_back is False


def check_oracles(cat, make_pipeline, device, tpch_sql, li, pool, when: str,
                  tag: str = "dml") -> None:
    """Q6 and Q1 with MVCC on against the numpy oracles over `li`; both plans
    must run their FusedFilterAggregate over Validate's output. `tag` starts
    the line it prints."""
    rows, plan6 = mvcc_rows(tpch_sql[6], cat, make_pipeline, device)
    got, want = float(rows[0][0]), q6_oracle(li, pool)
    if rel_diff(got, want) > 1e-6:
        raise AssertionError(f"Q6 with MVCC {when}: {got} vs numpy oracle {want}")
    rows, plan1 = mvcc_rows(tpch_sql[1], cat, make_pipeline, device)
    worst = check_q1(rows, q1_oracle(li, pool))
    if not (ran_fused(plan6) and ran_fused(plan1)):
        raise AssertionError(f"Q1 or Q6 with MVCC {when}: no FusedFilterAggregate ran fused")
    log(f"{tag}: Q6 with MVCC {when} {got!r} vs oracle {want!r} (rel "
        f"{rel_diff(got, want):.3e}); Q1's groups equal the oracle's (floats within "
        f"{worst:.3e}); both ran a FusedFilterAggregate over Validate's output")


# -- 9. front ends: the wire server, the scheduler, the console ----------------------

# TPC-H's throughput test at SF1 runs at least two query streams at once
# (clause 5.3.4); the orders of streams 1 and 2 (Appendix A)
STREAM_1 = (21, 3, 18, 5, 11, 7, 6, 20, 17, 12, 16, 15, 13, 10, 2, 8, 14, 19, 9, 22, 1, 4)
STREAM_2 = (6, 17, 14, 16, 19, 10, 9, 2, 15, 8, 5, 22, 12, 7, 13, 18, 1, 4, 20, 3, 11, 21)
# Q6's text with its five substitution parameters as placeholders, bound as
# text to the values of TPCH_SQL[6]
Q6_TEMPLATE = ("SELECT sum(l_extendedprice*l_discount) AS revenue FROM lineitem "
               "WHERE l_shipdate >= ? AND l_shipdate < ? "
               "AND l_discount BETWEEN ? - 0.01 AND ? + 0.01001 AND l_quantity < ?")
Q6_PARAMETERS = ("1994-01-01", "1995-01-01", ".06", ".06", "24")
SCHEDULER_WORKERS = 4
TPCC_WAREHOUSES = 10
TPCC_TABLES = ("item", "warehouse", "district", "customer", "history", "stock",
               "tpcc_order", "order_line", "new_order")
CONSOLE_SCRIPT = tuple(f"SELECT COUNT(*) FROM {name}" for name in TPCC_TABLES) + (
    "SELECT ol_w_id, COUNT(*) AS lines, SUM(ol_quantity) AS quantity FROM order_line "
    "JOIN item ON ol_i_id = i_id WHERE i_price > 90 GROUP BY ol_w_id ORDER BY ol_w_id",
    "SELECT ol_w_id, COUNT(*) AS n, SUM(ol_quantity) AS quantity, MAX(ol_number) AS most "
    "FROM order_line GROUP BY ol_w_id ORDER BY ol_w_id",
    "SELECT o_carrier_id, COUNT(*) AS lines, SUM(ol_quantity) AS quantity, MAX(ol_amount) "
    "AS most FROM order_line JOIN tpcc_order ON ol_w_id = o_w_id AND ol_d_id = o_d_id "
    "AND ol_o_id = o_id GROUP BY o_carrier_id ORDER BY o_carrier_id",
    "SELECT i_id, i_name, i_price FROM item ORDER BY i_price DESC, i_id LIMIT 10",
)
# the kernels phase 9 must launch: the SQL path's group-bys (K3), joins (K4,
# K5), Q1 and Q6 (K6), Q18 and Q21 (K7), every filter and compaction (K9)
FRONT_END_KERNELS = DML_KERNELS
def session(port: int):
    """A client session of the port's PostgreSQL client, started."""
    from hyrise_tpu_torch.pg_client import PgClient
    c = PgClient(port, timeout=600)
    c.startup()
    return c


def check_answer(msgs, want, what: str, ordered: bool, table_eq) -> None:
    """One statement's answer: RowDescription, DataRows, CommandComplete
    SELECT n, ReadyForQuery; rows equal to `want`, ints and strings exactly,
    floats within 1e-6 relative, in order where `ordered`."""
    from hyrise_tpu_torch.pg_client import command_tags, tags as wire_tags, typed_rows
    tags = wire_tags(msgs)
    if tags[0] != b"T" or tags[-2:] != [b"C", b"Z"] or set(tags[1:-2]) - {b"D"}:
        raise AssertionError(f"{what}: answered {tags[:3]}...{tags[-3:]}: {msgs[:2]}")
    if command_tags(msgs) != [f"SELECT {len(want)}"]:
        raise AssertionError(f"{what}: command tag {command_tags(msgs)}")
    ok, msg = table_eq.tables_equal(typed_rows(msgs), want, ordered=ordered, rel_tol=1e-6,
                                    abs_tol=0.0)
    if not ok:
        raise AssertionError(f"{what}: {msg}")


def run_stream(port: int, order, tpch_sql, start):
    """One query stream on a session of its own: the answer and the wall ms
    of each query, and the stream's wall s from `start` (a Barrier) on."""
    c = session(port)
    answers, ms = {}, {}
    start.wait()
    t0 = time.perf_counter()
    for qid in order:
        q0 = time.perf_counter()
        answers[qid] = c.query(tpch_sql[qid])
        ms[qid] = (time.perf_counter() - q0) * 1e3
    wall = time.perf_counter() - t0
    c.close()
    return answers, ms, wall


def extended_checks(port: int, sql_rows, table_eq) -> str:
    """Q6 through Parse / Bind / Describe / Execute / Sync with its five
    parameters bound as text, and the answers of ROADMAP C2's cases."""
    from hyrise_tpu_torch.pg_client import (command_tags, row_description, tags as wire_tags,
                                            typed_rows)
    s = session(port)
    s.parse(Q6_TEMPLATE)
    s.bind(Q6_PARAMETERS)
    s.describe(b"P")
    s.execute()
    msgs = s.sync()
    if wire_tags(msgs)[:3] != [b"1", b"2", b"T"]:
        raise AssertionError(f"extended Q6: answered {msgs}")
    check_answer(msgs[2:], sql_rows[6], "extended Q6 vs phase 6", True, table_eq)
    q6 = typed_rows(msgs[2:])[0][0]
    # C2: Bind to a statement never parsed is an error, and what follows it
    # up to Sync is skipped
    s.bind(("1",), statement=b"never_parsed")
    s.describe(b"P")
    s.execute()
    if wire_tags(s.sync()) != [b"E", b"Z"]:
        raise AssertionError("Bind to an unknown statement: not one ErrorResponse")
    s.parse("SELECT FROM WHERE")  # a syntax error at Parse
    s.bind(())
    s.execute()
    if wire_tags(s.sync()) != [b"E", b"Z"]:
        raise AssertionError("after an error the messages up to Sync were not skipped")
    # C2: Describe of a statement gives its parameters' and its rows' types
    s.parse(Q6_TEMPLATE, (25, 25, 701, 701, 23), name=b"q6")
    s.describe(b"S", b"q6")
    msgs = s.sync()
    if wire_tags(msgs) != [b"1", b"t", b"T", b"Z"] or \
            row_description(msgs[2:]) != [("revenue", 701)] or \
            struct.unpack("!H5I", msgs[1][1]) != (5, 25, 25, 701, 701, 23):
        raise AssertionError(f"Describe of Q6's statement: {msgs}")
    # C2: CommandComplete tags of writes, on a table made on the card
    tags = []
    for sql in ("CREATE TABLE smoke (a INT, b DOUBLE)",
                "INSERT INTO smoke VALUES (1, 0.5), (2, 1.5), (3, 2.5)",
                "UPDATE smoke SET b = b + 1.0 WHERE a > 1",
                "DELETE FROM smoke WHERE a = 3", "SELECT a, b FROM smoke ORDER BY a"):
        msgs = s.query(sql)
        if b"E" in wire_tags(msgs):
            raise AssertionError(f"{sql}: {msgs}")
        tags += command_tags(msgs)
    if tags != ["CREATE TABLE", "INSERT 0 3", "UPDATE 2", "DELETE 1", "SELECT 2"] or \
            typed_rows(msgs) != [(1, 0.5), (2, 2.5)]:
        raise AssertionError(f"writes through the server: {tags}, {typed_rows(msgs)}")
    s.close()
    return (f"Q6 through Parse / Bind / Describe / Execute / Sync with its 5 parameters "
            f"as text {q6!r} equal to phase 6's; Bind to an unknown statement and a Parse "
            f"error answer ErrorResponse and skip to Sync; Describe of the statement "
            f"answers ParameterDescription (25, 25, 701, 701, 23) and RowDescription "
            f"revenue float8; tags {tags}")


def console_output(console, lines):
    """What the console prints for each line, its timings taken out."""
    out = []
    for line in lines:
        start = console.out.tell()
        console.handle(line)
        out.append(re.sub(r"\(\d+\.\d+ms\)|in \d+\.\d+s", "(time)",
                          console.out.getvalue()[start:]))
    return out


def front_end_phase(device, card, tables, hand_rows, hand_wall, sql_rows, sql_wall,
                    wrappers, table_eq, tpch_sql):
    """Phase 9: the front ends on the card. Returns the launch counts of the
    phase."""
    import io
    import threading

    from hyrise_tpu_torch.console import Console
    from hyrise_tpu_torch.parallel.scheduler import PoolScheduler, schedule_plan, set_scheduler
    from hyrise_tpu_torch.server import Server
    from hyrise_tpu_torch.storage.catalog import Catalog
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS

    for order in (STREAM_1, STREAM_2):
        if sorted(order) != list(range(1, 23)):
            raise AssertionError(f"stream {order} is not a permutation of 1-22")
    reset_counts(wrappers)
    started = time.perf_counter()
    cat = catalog_of(plain_copies(tables))
    srv = Server(host="127.0.0.1", port=0, catalog=cat)
    srv.serve_background()
    try:
        port = srv.server_address[1]
        # 9a. stream 1 alone, then two query streams at once, then stream 1
        # alone again: the first run on the fresh copies pays what is cached
        # on them (table statistics, dictionaries), so both orders are timed
        alone = [run_stream(port, STREAM_1, tpch_sql, threading.Barrier(1))]
        start = threading.Barrier(3, timeout=120)
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = [pool.submit(run_stream, port, order, tpch_sql, start)
                       for order in (STREAM_1, STREAM_2)]
            start.wait()
            t0 = time.perf_counter()
            streams = [f.result() for f in futures]
            elapsed = time.perf_counter() - t0
        for n, (answers, _, _) in enumerate(streams, 1):
            for qid, msgs in answers.items():
                check_answer(msgs, sql_rows[qid], f"stream {n} Q{qid} vs phase 6",
                             "ORDER BY" in tpch_sql[qid].upper(), table_eq)
        alone.append(run_stream(port, STREAM_1, tpch_sql, threading.Barrier(1)))
        for when, run in zip(("before", "after"), alone):
            for qid, msgs in run[0].items():
                check_answer(msgs, sql_rows[qid], f"stream 1 alone {when} Q{qid} vs phase 6",
                             "ORDER BY" in tpch_sql[qid].upper(), table_eq)
        log(f"frontend: 2 TPC-H streams (TPC-H Appendix A orders) at once through the "
            f"wire server on {device}: all 44 answers equal phase 6's rows (ints and "
            f"strings exactly, floats within 1e-6 relative, in order under ORDER BY)")
        for n, (_, ms, wall) in enumerate(streams, 1):
            log(f"frontend: stream {n} wall {wall * 1e3:.3f} ms (host clock, from the "
                f"common start to its last answer parsed) {card}; per query ms: "
                + ", ".join(f"Q{q} {m:.3f}" for q, m in ms.items()))
        for when, (_, ms, wall) in zip(("before", "after"), alone):
            log(f"frontend: stream 1 alone through the server {when} the 2 streams: "
                f"wall {wall * 1e3:.3f} ms ({22 / wall:.3f} queries/s) {card}; per query "
                f"ms: " + ", ".join(f"Q{q} {m:.3f}" for q, m in ms.items()))
        log(f"frontend: 2 streams: 44 queries in {elapsed:.3f} s, throughput "
            f"{44 / elapsed:.3f} queries/s {card}; stream 1 alone, before / after: "
            f"{22 / alone[0][2]:.3f} / {22 / alone[1][2]:.3f} queries/s; 2 x alone after "
            f"{2 * alone[1][2]:.3f} s against {elapsed:.3f} s together; phase 6's sum of "
            f"medians (in process, plan cached) "
            f"{sum(m for _, m in sql_wall.values()):.3f} ms {card}")
        log("frontend: " + extended_checks(port, sql_rows, table_eq))
    finally:
        srv.shutdown()
        srv.server_close()

    # 9b. the 22 hand plans through the pool scheduler
    set_scheduler(PoolScheduler(workers=SCHEDULER_WORKERS))
    try:
        sched_ms = {}
        for qid in sorted(TPCH_PLANS):
            first, median, rows = timed_query(
                lambda: schedule_plan(TPCH_PLANS[qid](cat)).rows())
            sched_ms[qid] = (first, median)
            ok, msg = table_eq.tables_equal(rows, hand_rows[qid], ordered=True,
                                            rel_tol=1e-6, abs_tol=0.0)
            if not ok:
                raise AssertionError(f"scheduled Q{qid} vs phase 5: {msg}")
    finally:
        set_scheduler(None)
    log(f"frontend: the 22 hand plans through schedule_plan with PoolScheduler("
        f"workers={SCHEDULER_WORKERS}) equal phase 5's rows in order; wall ms (host clock, "
        f"to rows on the host; first run / median of {QUERY_REPS}) beside phase 5's median "
        f"{card}: "
        + "; ".join(f"Q{q} {f:.3f} / {m:.3f} ({hand_wall[q][1]:.3f})"
                    for q, (f, m) in sched_ms.items())
        + f"; sums of medians {sum(m for _, m in sched_ms.values()):.3f} and "
        f"{sum(m for _, m in hand_wall.values()):.3f}")

    # 9c. the console: TPC-C generated on the card, a script against the
    # same script over CPU copies of the same tables
    console = Console(Catalog(device=device), out=io.StringIO())
    t0 = time.perf_counter()
    console.handle(f"generate tpcc {TPCC_WAREHOUSES}")
    generate_s = time.perf_counter() - t0
    tpcc = {name: console.catalog.get_table(name) for name in TPCC_TABLES}
    if any(t.device != device for t in tpcc.values()):
        raise AssertionError("generate tpcc put a table off the card")
    t0 = time.perf_counter()
    got = console_output(console, CONSOLE_SCRIPT)
    script_s = time.perf_counter() - t0
    cpu_console = Console(catalog_of(copy_to(tpcc, "cpu")), out=io.StringIO())
    want = console_output(cpu_console, CONSOLE_SCRIPT)
    for line, g, w in zip(CONSOLE_SCRIPT, got, want):
        if g != w or "error" in g:
            raise AssertionError(f"console {line!r} on the card:\n{g}\non the CPU:\n{w}")
    log(f"frontend: console: generate tpcc {TPCC_WAREHOUSES} on {device} in "
        f"{generate_s:.1f} s ({', '.join(f'{n} {t.num_rows}' for n, t in tpcc.items())} "
        f"rows); {len(CONSOLE_SCRIPT)} script lines (9 row counts, a join, a group-by, a "
        f"join on three keys, an ORDER BY ... LIMIT) in {script_s:.2f} s, output equal to "
        f"the same script over "
        f"CPU tensors {card}")
    del console, cpu_console, tpcc

    launches = {name: w.launches for name, w in wrappers.items()}
    for name in FRONT_END_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 9")
    log(f"frontend: launches in phase 9 {launches}")
    log(f"frontend: phase 9 took {time.perf_counter() - started:.1f} s")
    return launches


# -- 10. streaming: blocked and segmented execution -----------------------------

# phase 4's SF1 tables streamed: lineitem (6,001,215 rows) in 6 blocks,
# orders (1,500,000) resident
SF1_STREAMING = dict(resident_rows=2**21, block_rows=2**20)
BLOCKED_QIDS = (1, 3, 6, 14)
STREAM_SF = 10.0
# the JAX package's configuration (hyrise_tpu/plan/segmented.py): lineitem
# (59,989,423 rows from this generator) in 15 blocks, orders (15,000,000) resident
SF10_STREAMING = dict(resident_rows=2**24, block_rows=2**22)
MULTI_STAGE = (4, 15, 17, 18, 20, 21)  # need at least 2 stages at SF10
STREAM_REPS = 3                 # median of 3 after the first run
# the kernels phase 10 must launch: group-bys (K3), joins (K4), the general
# group-by (K7), every filter and compaction (K9)
STREAM_KERNELS = ("segment_reduce_cells", "lookup_last_eq_lut", "segment_reduce_sorted",
                  "compact_indices")


def stages_of(qid, cat, streaming, plans):
    """(stage count, blocks of the stream tables) of qid's segmented run."""
    from hyrise_tpu_torch.plan.segmented import SegmentedQuery
    sq = SegmentedQuery(plans[qid](cat), cat, **streaming)
    blocks = sum(-(-max(cat.get_table(s.stream).num_rows, 1) // streaming["block_rows"])
                 for s in sq.stages if s.stream)
    return len(sq.stages), blocks


def timed_peak(run, device):
    """(first ms, median ms of STREAM_REPS more, MB the first run allocated
    above what was allocated before it, last rows): host clock to rows on
    the host."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    times, rows = [], None
    for i in range(1 + STREAM_REPS):
        t0 = time.perf_counter()
        rows = run().rows()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            peak = (torch.cuda.max_memory_allocated(device) - base) / 1e6
    return times[0], statistics.median(times[1:]), peak, rows


def streaming_sf1(device, cat, hand_rows, table_eq) -> str:
    """Phase 10 at SF1: the 22 hand plans through run_query(via="segmented")
    and Q1, Q3, Q6, Q14 through via="blocked", each equal to phase 5's rows;
    ROADMAP C1's plan shape refused."""
    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops.aggregate import Aggregate
    from hyrise_tpu_torch.ops.base import execute_plan
    from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
    from hyrise_tpu_torch.ops.misc import UnionAll
    from hyrise_tpu_torch.ops.projection import Projection
    from hyrise_tpu_torch.plan.blocked import BlockedQuery, PlanNotCompilable
    from hyrise_tpu_torch.storage.column import Column
    from hyrise_tpu_torch.storage.table import Table
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, run_query
    from hyrise_tpu_torch.types import DataType

    t0 = time.perf_counter()
    shapes, ms = {}, {}
    for qid in sorted(TPCH_PLANS):
        shapes[qid] = stages_of(qid, cat, SF1_STREAMING, TPCH_PLANS)
        q0 = time.perf_counter()
        rows = run_query(qid, cat, via="segmented", **SF1_STREAMING).rows()
        ms[qid] = (time.perf_counter() - q0) * 1e3
        ok, msg = table_eq.tables_equal(rows, hand_rows[qid], ordered=True, rel_tol=1e-6,
                                        abs_tol=0.0)
        if not ok:
            raise AssertionError(f"segmented Q{qid} at SF{SF} vs phase 5: {msg}")
    for qid in BLOCKED_QIDS:
        rows = run_query(qid, cat, via="blocked",
                         block_rows=SF1_STREAMING["block_rows"]).rows()
        ok, msg = table_eq.tables_equal(rows, hand_rows[qid], ordered=True, rel_tol=1e-6,
                                        abs_tol=0.0)
        if not ok:
            raise AssertionError(f"blocked Q{qid} at SF{SF} vs phase 5: {msg}")
    # ROADMAP C1: a UnionAll on the stream path would count its other input
    # once per block; the port refuses the plan
    two = Table([Column("l_quantity", DataType.FLOAT32,
                        torch.ones(2, dtype=torch.float32, device=device))], 2, name="two")

    def c1_plan():
        union = UnionAll(Projection(GetTable("lineitem", cat), ["l_quantity"]),
                         TableWrapper(two))
        return Aggregate(union, [], [("n", ast.count_())])

    n_eager = execute_plan(c1_plan()).rows()[0][0]
    if n_eager != cat.get_table("lineitem").num_rows + 2:
        raise AssertionError(f"C1 plan, eager: {n_eager} rows")
    try:
        BlockedQuery(c1_plan(), cat, block_rows=SF1_STREAMING["block_rows"])
    except PlanNotCompilable:
        pass
    else:
        raise AssertionError("a UnionAll on the stream path was not refused (ROADMAP C1)")
    return (f"SF{SF}: the 22 hand plans through run_query(via=\"segmented\", "
            f"{SF1_STREAMING}) equal phase 5's rows in order (floats within 1e-6 "
            f"relative); stages/blocks and first-run ms (host clock to rows on the host): "
            + "; ".join(f"Q{q} {shapes[q][0]}/{shapes[q][1]} {ms[q]:.3f}" for q in ms)
            + f"; via=\"blocked\" Q{', Q'.join(map(str, BLOCKED_QIDS))} equal too; ROADMAP "
            f"C1's Aggregate over UnionAll(lineitem, 2 rows) refused (eager {n_eager}); "
            f"{time.perf_counter() - t0:.1f} s")


def sf10_tables(device):
    """TPC-H SF10 generated on the card: (catalog, MB allocated with the
    tables, lineitem's host columns, the date pool)."""
    from hyrise_tpu_torch.tpch import dbgen

    t0 = time.perf_counter()
    specs = dbgen.generate_specs(STREAM_SF, SEED)
    tables = {name: dbgen._make_table(name, cols, n, device)
              for name, (cols, n) in specs.items()}
    torch.cuda.synchronize(device)
    gen_s = time.perf_counter() - t0
    li = {name: payload for name, _, payload in specs["lineitem"][0]}
    del specs
    table_mb = torch.cuda.memory_allocated(device) / 1e6
    log(f"streaming: SF{STREAM_SF} generated and uploaded in {gen_s:.1f} s: "
        + ", ".join(f"{name} {t.num_rows}" for name, t in tables.items())
        + f" rows; {table_mb:.1f} MB allocated on {device} with them")
    return catalog_of(tables), table_mb, li, li["l_shipdate"][1]


def sf10_resident(device, card) -> dict:
    """The SF10 tables and the 22 hand plans' resident answers and medians
    alone: what phase 14 reads of phase 10 under --compiled-distribution."""
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, run_query

    cat, table_mb, li, pool = sf10_tables(device)
    resident, medians = {}, {}
    for qid in sorted(TPCH_PLANS):
        _, medians[qid], _, resident[qid] = timed_peak(lambda: run_query(qid, cat), device)
    log(f"streaming: SF{STREAM_SF} resident medians of {STREAM_REPS} {card}: "
        + ", ".join(f"Q{q} {m:.3f}" for q, m in medians.items()))
    return {"cat": cat, "resident": resident, "medians": medians, "table_mb": table_mb,
            "li": li, "pool": pool}


def streaming_sf10(device, card, table_eq) -> dict:
    """Phase 10 at SF10: TPC-H generated on the card, the 22 hand plans
    streamed (run_query(via="segmented") with the JAX package's thresholds)
    and resident (run_query), equal to each other; Q1 and Q6 equal the numpy
    oracles; walls and peak memory of both forms. Returns what phase 11
    reads: the catalog, the resident rows and medians, the MB the tables
    hold, lineitem's host columns and the date pool; phase 13 reads the
    streamed medians too."""
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, run_query

    cat, table_mb, li, pool = sf10_tables(device)
    t0 = time.perf_counter()
    lines, streamed_rows, resident_rows, shapes, medians = [], {}, {}, {}, {}
    for qid in sorted(TPCH_PLANS):
        shapes[qid] = stages_of(qid, cat, SF10_STREAMING, TPCH_PLANS)
        s_first, s_med, s_peak, streamed = timed_peak(
            lambda: run_query(qid, cat, via="segmented", **SF10_STREAMING), device)
        r_first, r_med, r_peak, resident = timed_peak(lambda: run_query(qid, cat), device)
        check_finite(streamed, f"streamed Q{qid} at SF{STREAM_SF}")
        ok, msg = table_eq.tables_equal(streamed, resident, ordered=True, rel_tol=1e-6,
                                        abs_tol=0.0)
        if not ok:
            raise AssertionError(f"streamed Q{qid} at SF{STREAM_SF} vs resident: {msg}")
        if qid in MULTI_STAGE and shapes[qid][0] < 2:
            raise AssertionError(f"Q{qid} at SF{STREAM_SF} in {shapes[qid][0]} stage")
        streamed_rows[qid], resident_rows[qid], medians[qid] = streamed, resident, (s_med, r_med)
        lines.append(f"Q{qid} {shapes[qid][0]} stages, {shapes[qid][1]} blocks, streamed "
                     f"{s_first:.3f} / {s_med:.3f} ms, {s_peak:.1f} MB; resident "
                     f"{r_first:.3f} / {r_med:.3f} ms, {r_peak:.1f} MB ({len(streamed)} rows)")
    expected6 = q6_oracle(li, pool)
    got6 = float(streamed_rows[6][0][0])
    if rel_diff(got6, expected6) > 1e-6:
        raise AssertionError(f"streamed Q6 at SF{STREAM_SF} {got6} vs numpy {expected6}")
    worst = check_q1(streamed_rows[1], q1_oracle(li, pool))
    log(f"streaming: SF{STREAM_SF} all 22 streamed answers equal the resident ones on the "
        f"card (ints and strings exactly, floats within 1e-6 relative, in order); Q6 "
        f"{got6!r} vs numpy {expected6!r} (rel {rel_diff(got6, expected6):.3e}); Q1's "
        f"groups equal the numpy oracle's (floats within {worst:.3e}); "
        f"Q{', Q'.join(map(str, MULTI_STAGE))} in 2 stages or more; "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"streaming: SF{STREAM_SF} per query (segmented {SF10_STREAMING}; host clock "
        f"to rows on the host, first / median of "
        f"{STREAM_REPS}; MB allocated above the tables during the first run) {card}: "
        + "; ".join(lines))
    log(f"streaming: SF{STREAM_SF} sums of medians: streamed "
        f"{sum(m for m, _ in medians.values()):.3f} ms, resident "
        f"{sum(m for _, m in medians.values()):.3f} ms {card}")
    return {"cat": cat, "resident": resident_rows,
            "medians": {q: r for q, (_, r) in medians.items()},
            "streamed_medians": {q: m for q, (m, _) in medians.items()}, "table_mb": table_mb,
            "li": li, "pool": pool}


# -- 13. compiled streaming: the streamed forms as captured graphs ---------------

# the kernels phase 13 must launch inside its graphs: group-bys (K3), joins
# (K4), the general group-by (K7), every filter and compaction (K9c)
STREAMED_GRAPH_KERNELS = ("segment_reduce_cells", "lookup_last_eq_lut",
                          "segment_reduce_sorted", "compact_indices_cap")
REPLACED_QIDS = (6, 18)        # their lineitem is replaced by half of it


def stage_queries(q) -> list:
    """The compiled queries a streamed query runs: a SegmentedQuery's stage
    queries, or the query itself."""
    return [s.query for s in q.stages] if hasattr(q, "stages") else [q]


def streamed_state(q) -> dict:
    """What phase 13 reads of a compiled streamed query after a run."""
    qs = stage_queries(q)
    blocked = [x for x in qs if hasattr(x, "n_blocks")]
    return {"stages": len(qs), "blocks": sum(x.n_blocks for x in blocked),
            "captures": sum(x.captures for x in qs),
            "sync_checked": all(x.sync_checked for x in qs),
            "reads": sum(x.host_reads for x in qs),
            "blocked_reads": max([x.host_reads for x in blocked], default=0),
            "retries": sum(x.last_retries for x in qs),
            "pool_mb": sum(x.pool_mb for x in qs)}


def add_graph_counts(replayed: dict, captured: dict, queries) -> None:
    """Add what the graphs of `queries` ran in their replays, and what their
    captures recorded without running it, to the two counts by kernel."""
    for cq in queries:
        for out, counts in ((replayed, cq.launches_replayed), (captured, cq.launches_captured)):
            for name, n in counts.items():
                out[name] = out.get(name, 0) + n


def compiled_streamed_run(qid, cat, via, streaming, want, what, table_eq, device,
                          table_bytes):
    """Phase 13 for one query: a first run and STREAM_REPS more through
    run_query(via=...), each equal to `want` in order; the third run and
    those after it capture nothing, retry nothing and read the host at most
    twice per blocked stage; no eager read over the timed runs. Returns
    (first ms, median ms, the state after the first and after the last run,
    MB allocated above the tables at the peak of the first run and of the
    later ones, the rows, the stage queries)."""
    from hyrise_tpu_torch.plan.compiler import eager_reads
    from hyrise_tpu_torch.tpch.queries import run_query, streamed_query

    q = streamed_query(qid, cat, via, streaming["block_rows"], streaming["resident_rows"])
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    times, states = [], []
    for i in range(1 + STREAM_REPS):
        if i == 1:
            reads = eager_reads()
            first_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        rows = run_query(qid, cat, via=via, **streaming).rows()
        times.append((time.perf_counter() - t0) * 1e3)
        check_rows(rows, want, f"{what} run {i + 1}", table_eq)
        states.append(streamed_state(q))
        if i >= 2 and (states[-1]["captures"] != states[-2]["captures"]
                       or states[-1]["retries"] or states[-1]["blocked_reads"] > 2):
            raise AssertionError(f"{what} run {i + 1}: {states[-2]} -> {states[-1]}")
    if eager_reads() != reads:
        raise AssertionError(f"{what}: {eager_reads() - reads} eager reads over the timed runs")
    if device.type == "cuda" and not states[0]["sync_checked"]:
        raise AssertionError(f"{what}: a learning run was not sync-checked")
    peaks = [(b - table_bytes) / 1e6 for b in (first_peak,
                                              torch.cuda.max_memory_allocated(device))]
    return (times[0], statistics.median(times[1:]), states[0], states[-1], peaks, rows,
            stage_queries(q))


def compiled_streaming_phase(device, card, sf10, table_eq, wrappers) -> dict:
    """Phase 13 on phase 10's SF10 catalog and resident answers: the 22 hand
    plans through run_query(via="compiled-segmented") and Q1, Q3, Q6, Q14
    through via="compiled-blocked" with phase 10's thresholds, each answer
    equal to the resident one in order on every run; Q1 and Q6 against the
    numpy oracles; lineitem replaced by half of it under Q6 and Q18 (the
    eager streamed answers over the half table, a capture again); one
    profiled steady run of each compiled-blocked query. Each query's
    compiled objects are freed after it is measured. Returns the launches of
    its runs before the replacement check: the wrappers' counts (uncaptured
    learning runs, and captures, which record launches without running
    them) less what the captures recorded, plus what the replays ran."""
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, run_query

    t_phase = time.perf_counter()
    cat, resident = sf10["cat"], sf10["resident"]
    torch.cuda.synchronize(device)
    table_bytes = torch.cuda.memory_allocated(device)
    start = {name: w.launches for name, w in wrappers.items()}
    replayed, captured, lines, sums = {}, {}, [], [0.0, 0.0, 0.0]
    answers = {}
    for qid in sorted(TPCH_PLANS):
        first, med, s0, s1, peak, rows, queries = compiled_streamed_run(
            qid, cat, "compiled-segmented", SF10_STREAMING, resident[qid],
            f"compiled segmented Q{qid} at SF{STREAM_SF}", table_eq, device, table_bytes)
        answers[qid] = rows
        if qid in MULTI_STAGE and s1["stages"] < 2:
            raise AssertionError(f"compiled segmented Q{qid}: {s1['stages']} stage")
        add_graph_counts(replayed, captured, queries)
        eager_med, res_med = sf10["streamed_medians"][qid], sf10["medians"][qid]
        sums[0] += med
        sums[1] += eager_med
        sums[2] += res_med
        lines.append(f"Q{qid} {s1['stages']} stages, {s1['blocks']} blocks, {s1['captures']} "
                     f"captures (first run {s0['captures']}), sync-checked "
                     f"{s0['sync_checked']}, {first:.3f} / {med:.3f} ms (eager streamed "
                     f"{eager_med:.3f}, resident {res_med:.3f}), host reads {s1['reads']} a run "
                     f"(first {s0['reads']}), retries {s1['retries']} (first {s0['retries']}), "
                     f"pool {s1['pool_mb']:.1f} MB, peak {peak[0]:.1f} / {peak[1]:.1f} MB")
        del cat.compiled[("compiled-segmented", qid, SF10_STREAMING["block_rows"],
                          SF10_STREAMING["resident_rows"])]
        del queries
        gc.collect()
        torch.cuda.empty_cache()
    expected6 = q6_oracle(sf10["li"], sf10["pool"])
    got6 = float(answers[6][0][0])
    if rel_diff(got6, expected6) > 1e-6:
        raise AssertionError(f"compiled segmented Q6 {got6} vs numpy {expected6}")
    worst = check_q1(answers[1], q1_oracle(sf10["li"], sf10["pool"]))
    log(f"compiled streaming: SF{STREAM_SF} all 22 hand plans through run_query("
        f"via=\"compiled-segmented\", {SF10_STREAMING}) equal the resident answers on every "
        f"run (ints and strings exactly, floats within 1e-6 relative, in order); the third "
        f"and fourth runs capture nothing, retry nothing, read the host at most twice per "
        f"blocked stage and make no eager read; Q6 {got6!r} vs numpy {expected6!r} (rel "
        f"{rel_diff(got6, expected6):.3e}); Q1's groups equal the numpy oracle's (floats "
        f"within {worst:.3e})")
    log(f"compiled streaming: SF{STREAM_SF} per query (host clock to rows on the host, first "
        f"run / median of {STREAM_REPS} more; pool: the graphs' reserved MB; peak: MB "
        f"allocated above the tables, first run / later runs) {card}: " + "; ".join(lines))
    log(f"compiled streaming: SF{STREAM_SF} sums of medians: compiled segmented "
        f"{sums[0]:.3f} ms, eager streamed {sums[1]:.3f} ms, resident {sums[2]:.3f} ms {card}")

    lines = []
    for qid in BLOCKED_QIDS:
        first, med, s0, s1, peak, _, queries = compiled_streamed_run(
            qid, cat, "compiled-blocked", SF10_STREAMING, resident[qid],
            f"compiled blocked Q{qid} at SF{STREAM_SF}", table_eq, device, table_bytes)
        bq = queries[0]
        events, busy, _ = replay_profile(
            lambda: run_query(qid, cat, via="compiled-blocked", **SF10_STREAMING).rows(), 1)
        add_graph_counts(replayed, captured, queries)
        lines.append(f"Q{qid} {s1['blocks']} blocks of {bq.block_rows} rows, {s1['captures']} "
                     f"captures, {first:.3f} / {med:.3f} ms (resident "
                     f"{sf10['medians'][qid]:.3f}), host reads {s1['reads']}, builds "
                     f"{bq.builds} a run, pool {s1['pool_mb']:.1f} MB, peak {peak[0]:.1f} / "
                     f"{peak[1]:.1f} MB; "
                     f"one profiled run: {events} device events, busy "
                     + ("not traced" if busy is None else
                        f"{busy:.3f} ms, {busy / bq.n_blocks:.3f} ms a block"))
        del cat.compiled[("compiled-blocked", qid, SF10_STREAMING["block_rows"],
                          SF10_STREAMING["resident_rows"])]
        del queries, bq
        gc.collect()
        torch.cuda.empty_cache()
    log(f"compiled streaming: SF{STREAM_SF} Q{', Q'.join(map(str, BLOCKED_QIDS))} through "
        f"via=\"compiled-blocked\" equal the resident answers {card}: " + "; ".join(lines))
    launches = {name: w.launches - start[name] - captured.get(name, 0) + replayed.get(name, 0)
                for name, w in wrappers.items()}

    # lineitem replaced by its first half: a blocked stage over it streams the
    # new table (a capture again), a stage whose result changed its rows is
    # bound anew and the stages after it are made anew
    li = cat.get_table("lineitem")
    lines = []
    for qid in REPLACED_QIDS:
        key = ("compiled-segmented", qid, SF10_STREAMING["block_rows"],
               SF10_STREAMING["resident_rows"])
        for _ in range(2):
            run_query(qid, cat, via="compiled-segmented", **SF10_STREAMING)
        q = cat.compiled[key]
        before = streamed_state(q)
        queries = stage_queries(q)
        cat.replace_table("lineitem", li.block(0, li.num_rows // 2))
        try:
            got = run_query(qid, cat, via="compiled-segmented", **SF10_STREAMING).rows()
            want = run_query(qid, cat, via="segmented", **SF10_STREAMING).rows()
            after = streamed_state(q)
            remade = sum(a is not b for a, b in zip(stage_queries(q), queries))
        finally:
            cat.replace_table("lineitem", li)
        check_rows(got, want, f"compiled segmented Q{qid} over half of lineitem vs eager",
                   table_eq)
        if device.type == "cuda" and after["captures"] <= before["captures"] and not remade:
            raise AssertionError(f"Q{qid} over half of lineitem was not captured again")
        if got == answers[qid]:
            raise AssertionError(f"Q{qid} over half of lineitem gave the whole table's answer")
        lines.append(f"Q{qid}: {len(got)} rows equal to the eager streamed answer over "
                     f"{li.num_rows // 2} rows, {after['blocks']} blocks, captures "
                     f"{before['captures']} -> {after['captures']}, {remade} of "
                     f"{after['stages']} stage queries made anew")
        del cat.compiled[key], q, queries
        gc.collect()
        torch.cuda.empty_cache()
    log("compiled streaming: lineitem replaced by its first half, then put back: "
        + "; ".join(lines))
    for name in STREAMED_GRAPH_KERNELS:
        if replayed.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched inside phase 13's graphs")
    log(f"compiled streaming: launches before the replacement check {launches}, of them "
        f"inside the graphs (the replays' runs) {replayed}; phase 13 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- 11. distribution: sharded execution on the card ----------------------------

DIST_SHARDS = 4                # in-process shards, all on the one card
DIST_RING_QIDS = (3, 5, 9, 18, 21)
DIST_BLOCK_ROWS = 2**20        # lineitem per shard in blocks (15 a shard at SF10)
DIST_BLOCKED_QIDS = (1, 3, 6)
DIST_GROUP_QIDS = (1, 3, 6, 18)
# the hot-key join of tests/test_dist_skew.py: fact's key 7 on half its rows,
# a dim too large to broadcast, both sharded by columns that are not the key
DIST_SKEW = dict(n_fact=120_000, n_dim=70_000, hot_frac=0.5, seed=5)
# the kernels phase 11 must launch: dist_q6 (K1), group-bys (K3, K7), joins
# (K4, K5), every filter and compaction (K9)
DIST_KERNELS = ("q6_scan", "segment_reduce_cells", "lookup_last_eq_lut", "expand_pairs",
                "segment_reduce_sorted", "compact_indices")


def stats_text(stats) -> str:
    """exchange_stats() as `label sites/rows/moved rows`."""
    return ", ".join(f"{label} {e['sites']}/{e['rows']}/{e['moved_rows']}"
                     for label, e in sorted(stats.items())) or "none"


def same_rows(got, want, what: str, table_eq, ordered: bool = True) -> None:
    """Integers and strings equal, floats within 1e-6 relative (in order,
    unless `ordered` is False)."""
    ok, msg = table_eq.tables_equal(got, want, ordered=ordered, rel_tol=1e-6, abs_tol=0.0)
    if not ok:
        raise AssertionError(f"{what}: {msg}")


def skew_tables(device, n_fact: int, n_dim: int, hot_frac: float, seed: int):
    """fact (n_fact rows, hot_frac of them on key 7) and dim (n_dim rows)."""
    from hyrise_tpu_torch.storage.column import Column
    from hyrise_tpu_torch.storage.table import Table
    from hyrise_tpu_torch.types import DataType

    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_dim, size=n_fact).astype(np.int64)
    k[rng.random(n_fact) < hot_frac] = 7
    col = lambda name, t, v: Column.from_numpy(name, t, v, device=device)  # noqa: E731
    fact = Table([col("k", DataType.INT64, k), col("v", DataType.FLOAT64, rng.normal(size=n_fact))],
                 n_fact, name="fact")
    dim = Table([col("k", DataType.INT64, np.arange(n_dim, dtype=np.int64)),
                 col("w", DataType.FLOAT64, rng.normal(size=n_dim)),
                 col("salt", DataType.INT64, rng.integers(0, 1 << 30, size=n_dim).astype(np.int64))],
                n_dim, name="dim")
    return fact, dim


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def skew_checks(device, mesh, table_eq) -> str:
    """11d: the hot-key split of a shuffle join, exact, and one migration of
    a skewed table by PlacementManager, answers unchanged."""
    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops.aggregate import Aggregate
    from hyrise_tpu_torch.ops.base import execute_plan
    from hyrise_tpu_torch.ops.get_table import GetTable
    from hyrise_tpu_torch.ops.join import Join
    from hyrise_tpu_torch.parallel.dist_compiler import DistributedQuery, ShardedCatalog
    from hyrise_tpu_torch.parallel.placement import PlacementManager
    from hyrise_tpu_torch.parallel.skew import shard_imbalance
    from hyrise_tpu_torch.types import JoinMode

    fact, dim = skew_tables(device, **DIST_SKEW)
    cat = catalog_of({"fact": fact, "dim": dim})
    sc = ShardedCatalog(mesh)
    sc.add_sharded("fact", fact, "v")
    sc.add_sharded("dim", dim, "salt")

    def join_plan():
        j = Join(GetTable("fact", cat), GetTable("dim", cat), JoinMode.INNER, ("k", "k"))
        return Aggregate(j, [], [("s", ast.sum_(ast.col("v"))), ("sw", ast.sum_(ast.col("w"))),
                                 ("n", ast.count_())])

    ref = execute_plan(join_plan()).rows()
    dq = DistributedQuery(join_plan(), sc)
    got = dq.run().rows()
    if not table_eq.tables_equal(got, ref, ordered=True, rel_tol=1e-9, abs_tol=0.0)[0]:
        raise AssertionError(f"hot-key shuffle join {got} vs single node {ref}")
    (hot,) = dq._hot_keys.values()
    if 7 not in hot.tolist() or list(dq._decisions.values()) != ["shuffle"]:
        raise AssertionError(f"the hot-key split did not engage: {dq.join_decisions()} {hot}")
    (probe,) = [c for label, c in dq._sites if label == "join.shuffle_p"]

    sc.add_sharded("fact", fact, "k")  # placed BY the skewed key
    agg_plan = lambda: Aggregate(GetTable("fact", cat), ["k"],  # noqa: E731
                                 [("s", ast.sum_(ast.col("v")))])
    agg_ref = execute_plan(agg_plan()).rows()
    before = shard_imbalance(sc.get("fact"))
    pm = PlacementManager(cat, sc)
    dq = DistributedQuery(agg_plan(), sc)
    same_rows(dq.run().rows(), agg_ref, "skewed aggregate", table_eq, ordered=False)
    pm.observe(dq)
    if pm.run_once() != ["fact"]:
        raise AssertionError("PlacementManager did not migrate the skewed table")
    after = shard_imbalance(sc.get("fact"))
    same_rows(DistributedQuery(agg_plan(), sc).run().rows(), agg_ref, "migrated aggregate",
              table_eq, ordered=False)
    return (f"hot-key shuffle join ({DIST_SKEW}) exact, key 7 split, probe rows received per "
            f"shard {probe}; PlacementManager migrated fact (imbalance {before:.3f} -> "
            f"{after:.3f}), its aggregate unchanged")


def group_checks(device, cat, in_process: dict, table_eq, compiled: bool = False) -> str:
    """11e: a process group of one rank (NCCL on the card, gloo on the CPU)
    on a free local port: Q1, Q3, Q6 and Q18 over its mesh equal the
    in-process answers. With `compiled` (phase 14) through
    DistributedCompiledQuery, twice each, the second run a replay."""
    import datetime
    import os
    import torch.distributed as dist
    from hyrise_tpu_torch.parallel.dist_compiler import (DistributedCompiledQuery,
                                                         DistributedQuery, shard_tpch)
    from hyrise_tpu_torch.parallel.mesh import make_mesh
    from hyrise_tpu_torch.parallel.multihost import initialize_from_env, process_info
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS

    env = {"COORDINATOR": f"127.0.0.1:{free_port()}", "NUM_PROCESSES": "1", "PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not initialize_from_env(device.type, timeout=datetime.timedelta(seconds=120)):
            raise AssertionError("initialize_from_env did not join a group")
        backend = dist.get_backend()
        info = process_info()
        mesh = make_mesh(device=device.type)
        t0 = time.perf_counter()
        sc = shard_tpch(cat, mesh)
        shard_s = time.perf_counter() - t0
        ms, captures = {}, []
        for qid in DIST_GROUP_QIDS:
            q0 = time.perf_counter()
            if compiled:
                cq = DistributedCompiledQuery(TPCH_PLANS[qid](cat), sc)
                rows = cq.run().rows()
                same_rows(cq.run().rows(), in_process[qid], f"compiled Q{qid} over a {backend} "
                          f"group of 1 rank, a replay", table_eq)
                captures.append(cq.captures)
                del cq
            else:
                rows = DistributedQuery(TPCH_PLANS[qid](cat), sc).run().rows()
            ms[qid] = (time.perf_counter() - q0) * 1e3
            same_rows(rows, in_process[qid], f"Q{qid} over a {backend} group of 1 rank",
                      table_eq)
        del sc
        dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return (f"a {backend} process group of 1 rank ({info['local_devices']}): shard_tpch "
            f"{shard_s:.1f} s, Q{', Q'.join(map(str, DIST_GROUP_QIDS))} "
            + (f"through DistributedCompiledQuery (captures {captures}), first run and a "
               f"replay, " if compiled else "")
            + f"equal the in-process answers (ms {', '.join(f'{m:.3f}' for m in ms.values())}"
            + ("" if not compiled else ", both runs") + "); the group is "
            f"destroyed. NCCL refuses two ranks on one card: groups of several ranks run in the "
            f"CPU tests (tests/test_torch_process_group.py, 4 gloo ranks)")


def distribution_sf10(device, card, sf10, table_eq) -> dict:
    """Phase 11a and 11b: shard_tpch of phase 10's SF10 catalog into
    DIST_SHARDS shards on the card, and the 22 hand plans through
    DistributedQuery against the resident answers. Returns what phase 14
    reads: the mesh, the ShardedCatalog, and per query the rows, the median,
    the join decisions and exchange_stats()."""
    from hyrise_tpu_torch.parallel.dist_compiler import (TPCH_PARTITION_KEYS, DistributedQuery,
                                                         shard_tpch)
    from hyrise_tpu_torch.parallel.exchange import partition_hash
    from hyrise_tpu_torch.parallel.mesh import make_mesh
    from hyrise_tpu_torch.parallel.skew import shard_imbalance
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS

    cat, resident = sf10["cat"], sf10["resident"]

    # 11a. partitioning
    mesh = make_mesh(DIST_SHARDS, device=device.type)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    sc = shard_tpch(cat, mesh)
    torch.cuda.synchronize(device)
    shard_s = time.perf_counter() - t0
    sharded = {name: sc.get(name) for name in TPCH_PARTITION_KEYS}
    for name, st in sharded.items():
        key = TPCH_PARTITION_KEYS[name]
        for s, t in enumerate(st.shards):
            if t.device != mesh.devices[s]:
                raise AssertionError(f"{name} shard {s} on {t.device}")
            wrong = int((partition_hash(t.column(key).data, DIST_SHARDS) != s).sum())
            if wrong:
                raise AssertionError(f"{name} shard {s}: {wrong} rows hash elsewhere")
    sharded_mb = sum(st.nbytes() for st in sharded.values()) / 1e6
    log(f"distribution: SF{STREAM_SF} into {DIST_SHARDS} shards on {mesh.devices[0]} by "
        f"shard_tpch in {shard_s:.2f} s {card}: sharded copies {sharded_mb:.1f} MB beside the "
        f"tables' {sf10['table_mb']:.1f} MB; rows per shard and imbalance: "
        + "; ".join(f"{n} {list(map(int, st.counts))} {shard_imbalance(st):.4f}"
                    for n, st in sharded.items())
        + "; partition_hash of every shard's key column equals its index")

    # 11b. the 22 hand plans
    t0 = time.perf_counter()
    dist_rows, lines, medians, decisions, stats = {}, [], {}, {}, {}
    for qid in sorted(TPCH_PLANS):
        last = {}

        def run(qid=qid):
            last["dq"] = DistributedQuery(TPCH_PLANS[qid](cat), sc)
            return last["dq"].run()

        first, med, peak, rows = timed_peak(run, device)
        check_finite(rows, f"distributed Q{qid} at SF{STREAM_SF}")
        same_rows(rows, resident[qid], f"distributed Q{qid} at SF{STREAM_SF} vs resident",
                  table_eq)
        dq = last["dq"]
        dist_rows[qid], medians[qid] = rows, med
        decisions[qid], stats[qid] = dq.join_decisions(), dq.exchange_stats()
        lines.append(f"Q{qid} {first:.3f} / {med:.3f} ms (resident {sf10['medians'][qid]:.3f}), "
                     f"{peak:.1f} MB, {len(rows)} rows; joins [{'; '.join(dq.join_decisions())}]; "
                     f"exchanges {stats_text(dq.exchange_stats())}")
    expected6 = q6_oracle(sf10["li"], sf10["pool"])
    got6 = float(dist_rows[6][0][0])
    if rel_diff(got6, expected6) > 1e-6:
        raise AssertionError(f"distributed Q6 {got6} vs numpy {expected6}")
    worst = check_q1(dist_rows[1], q1_oracle(sf10["li"], sf10["pool"]))
    log(f"distribution: SF{STREAM_SF} all 22 hand plans through DistributedQuery (all_to_all) "
        f"equal phase 10's resident answers in order (ints and strings exactly, floats within "
        f"1e-6 relative; Q11 answers {len(dist_rows[11])} rows as resident does: at SF10 none, "
        f"ROADMAP C24, so it is not counted as a check); Q6 "
        f"{got6!r} vs numpy {expected6!r}; Q1 equals the numpy oracle (floats within "
        f"{worst:.3e}); {time.perf_counter() - t0:.1f} s")
    log(f"distribution: SF{STREAM_SF} per query over {DIST_SHARDS} shards (host clock to rows "
        f"on the host, first / median of {STREAM_REPS}; MB allocated above the tables and their "
        f"shards during the first run; exchanges as label sites/rows/moved rows) {card}: "
        + " | ".join(lines))
    log(f"distribution: SF{STREAM_SF} sums of medians: distributed "
        f"{sum(medians.values()):.3f} ms, resident {sum(sf10['medians'].values()):.3f} ms {card}")
    return {"mesh": mesh, "sc": sc, "rows": dist_rows, "medians": medians,
            "decisions": decisions, "stats": stats}


def distribution_phase(device, card, sf10, sf1_tables, sql_rows, table_eq) -> dict:
    """Phase 11 (see the module docstring), on phase 10's SF10 catalog and
    resident answers and phase 4's SF1 tables (`sf1_tables`, CPU copies).
    Returns distribution_sf10's state, which phase 14 runs on."""
    from hyrise_tpu_torch.parallel.blocked_dist import BlockedDistributedQuery
    from hyrise_tpu_torch.parallel.dist_compiler import DistributedQuery, shard_tpch
    from hyrise_tpu_torch.parallel.dist_query import dist_q1, dist_q3_step, dist_q6
    from hyrise_tpu_torch.parallel.partition import hash_partition
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL

    phase0 = time.perf_counter()
    dist = distribution_sf10(device, card, sf10, table_eq)
    cat, resident, mesh, sc = sf10["cat"], sf10["resident"], dist["mesh"], dist["sc"]
    dist_rows, expected6 = dist["rows"], q6_oracle(sf10["li"], sf10["pool"])

    # 11c. the ring, the hand pipelines, blocked distribution
    t0 = time.perf_counter()
    for qid in DIST_RING_QIDS:
        rows = DistributedQuery(TPCH_PLANS[qid](cat), sc, exchange="ring").run().rows()
        same_rows(rows, dist_rows[qid], f"Q{qid} through the ring vs all_to_all", table_eq)
    li = sc.get("lineitem")
    pool = sf10["pool"]
    lo, hi = int(np.searchsorted(pool, "1994-01-01")), int(np.searchsorted(pool, "1995-01-01"))
    q6 = float(dist_q6(mesh, li, lo, hi))
    if rel_diff(q6, expected6) > 1e-6:
        raise AssertionError(f"dist_q6 {q6} vs numpy {expected6}")
    q1_hi = int(np.searchsorted(pool, "1998-12-01", side="right")) - 1
    counts, sum_qty, _, sum_dp, _, _ = dist_q1(mesh, li, q1_hi)
    rf = li.shards[0].column("l_returnflag")
    ls = li.shards[0].column("l_linestatus")
    for row in resident[1]:
        cell = rf.code_for(row[0]) * len(ls.dictionary) + ls.code_for(row[1])
        if int(counts[cell]) != row[9] or rel_diff(float(sum_dp[cell]), row[4]) > 1e-6:
            raise AssertionError(f"dist_q1 cell {row[:2]}: {int(counts[cell])}, "
                                 f"{float(sum_dp[cell])} vs {row[9]}, {row[4]}")
    t = cat.get_table("customer")
    q3_rev, q3_n = dist_q3_step(mesh, sc.get("customer"),
                                hash_partition(cat.get_table("orders"), "o_custkey", mesh),
                                li, t.column("c_mktsegment").code_for("BUILDING"),
                                int(np.searchsorted(pool, "1995-03-15")))
    want3 = float(sum(r[1] for r in resident[3]))
    if rel_diff(float(q3_rev), want3) > 1e-6:
        raise AssertionError(f"dist_q3_step {float(q3_rev)} vs resident Q3's sum {want3}")
    log(f"distribution: Q{', Q'.join(map(str, DIST_RING_QIDS))} through the ring equal the "
        f"all_to_all answers; dist_q6 {q6!r} (numpy {expected6!r}); dist_q1's cells equal "
        f"resident Q1's counts and sums; dist_q3_step {float(q3_rev)!r} over {int(q3_n)} pairs "
        f"(resident Q3's revenue sum {want3!r}); {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    blocked = []
    for qid in DIST_BLOCKED_QIDS:
        bq = BlockedDistributedQuery(TPCH_PLANS[qid](cat), sc, block_rows=DIST_BLOCK_ROWS)
        q0 = time.perf_counter()
        rows = bq.run().rows()
        blocked.append(f"Q{qid} {bq.n_blocks} blocks {(time.perf_counter() - q0) * 1e3:.3f} ms")
        same_rows(rows, resident[qid], f"blocked distributed Q{qid}", table_eq)
    log(f"distribution: BlockedDistributedQuery, lineitem in blocks of {DIST_BLOCK_ROWS} rows "
        f"a shard, equal to the resident answers {card}: {'; '.join(blocked)}; "
        f"{time.perf_counter() - t0:.1f} s")

    # 11d. SQL at SF1, skew and placement
    t0 = time.perf_counter()
    sf1 = catalog_of(copy_to(sf1_tables, device))
    sc1 = shard_tpch(sf1, mesh)
    sql_ms = {}
    for qid in sorted(TPCH_SQL):
        q0 = time.perf_counter()
        pipeline = SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(sf1) \
            .with_distributed_execution(sc1).create_pipeline()
        rows = pipeline.get_result_table().rows()
        sql_ms[qid] = (time.perf_counter() - q0) * 1e3
        if pipeline.pipeline_statements[-1].last_dist_query is None:
            raise AssertionError(f"SQL Q{qid} did not run distributed")
        check_rows(rows, sql_rows[qid], f"distributed SQL Q{qid} at SF{SF} vs phase 6", table_eq)
    log(f"distribution: SF{SF} (phase 4's tables back on the card) the 22 SQL texts with "
        f"with_distributed_execution over {DIST_SHARDS} shards equal phase 6's rows (as row "
        f"sets: ties of an ORDER BY may fall either way); first-run ms {card}: "
        + ", ".join(f"Q{q} {m:.3f}" for q, m in sql_ms.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    del sc1, sf1
    log("distribution: " + skew_checks(device, mesh, table_eq))

    # 11e. a process group
    log("distribution: " + group_checks(device, cat, dist_rows, table_eq))
    log(f"distribution: phase 11 took {time.perf_counter() - phase0:.1f} s")
    return dist


# -- 14. compiled distribution: the sharded plans as captured graphs -------------

# the kernels phase 14 must launch inside its graphs: group-bys (K3), joins
# (K4), the general group-by (K7), every filter, compaction and exchange (K9c)
DIST_GRAPH_KERNELS = ("segment_reduce_cells", "lookup_last_eq_lut", "segment_reduce_sorted",
                      "compact_indices_cap")
DIST_RING_COMPILED = (3, 5, 9)
DIST_REPLACED_QID = 6          # its lineitem shards are replaced by those of half of it


DIST_PROFILED = (3, 5, 9, 18, 21)   # their exchanges' device ms (exchange_profile)
DIST_EXCHANGES = ("gather_replicated", "repartition_sharded", "localize_by_key",
                  "repartition_build_skew")


def device_kernels(prof) -> list:
    """The device kernels of a torch.profiler run as (name, start us, us),
    without the device spans of record_function ranges."""
    return [(e.name, e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("exchange")]


def exchange_profile(cq) -> tuple:
    """(a replay's device busy ms and its three largest kernels as (name,
    ms, calls); an uncaptured capacity-mode run at the learned capacities,
    which runs the replay's kernels, and the ms of its kernels that ran
    inside the exchanges of parallel/dist_compiler.py) from torch.profiler.
    Each exchange runs in a record_function range, whose device span gives
    the kernels it launched; the gathers of a gathered table are lazy and
    count to the operator that reads them."""
    from hyrise_tpu_torch.parallel import dist_compiler

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        cq.run()
        torch.cuda.synchronize()
    by_name = {}
    for name, _, us in device_kernels(prof):
        ms, calls = by_name.get(name[:40], (0.0, 0))
        by_name[name[:40]] = (ms + us / 1e3, calls + 1)
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda x: -x[1])[:3]

    saved = {name: getattr(dist_compiler, name) for name in DIST_EXCHANGES}
    depth = [0]

    def ranged(fn):
        def run(*args, **kwargs):
            depth[0] += 1
            try:
                if depth[0] > 1:
                    return fn(*args, **kwargs)
                with torch.profiler.record_function("exchange"):
                    return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return run

    for name, fn in saved.items():
        setattr(dist_compiler, name, ranged(fn))
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            cq._execute(learning=False)
            torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(dist_compiler, name, fn)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.name == "exchange"]
    kernels = device_kernels(prof)
    inside = sum(us for _, start, us in kernels if any(a <= start < b for a, b in spans))
    return (sum(ms for ms, _ in by_name.values()), top,
            sum(us for _, _, us in kernels) / 1e3, inside / 1e3, len(spans))


def exchange_design_ms(device, sc, time_ms) -> str:
    """The shuffle's two designs at Q9's largest exchange, lineitem by
    l_partkey over DIST_SHARDS destinations, device ms in turns: a K9c
    compaction a destination over the concatenated targets (the port's),
    against one stable sort by target and a searchsorted of the
    destinations' ranges."""
    from hyrise_tpu_torch.kernels.compact import compact_indices_cap
    from hyrise_tpu_torch.parallel.dist_compiler import bucket_capacity
    from hyrise_tpu_torch.parallel.exchange import partition_hash

    shards = sc.get("lineitem").shards
    tgt = torch.cat([partition_hash(t.column("l_partkey").data, DIST_SHARDS).to(torch.int64)
                     for t in shards])
    cap = bucket_capacity(max(t.num_rows for t in shards))
    dests = torch.arange(DIST_SHARDS + 1, device=device)

    def by_k9c(i):
        return [compact_indices_cap(tgt == j, cap) for j in range(DIST_SHARDS)]

    def by_sort(i):
        order = torch.sort(tgt, stable=True).indices
        return order, torch.searchsorted(tgt.index_select(0, order), dests)

    ms = turns((("sort", by_sort), ("k9c", by_k9c), ("k9c", by_k9c), ("sort", by_sort)),
               device, time_ms)
    return (f"the shuffle of lineitem by l_partkey ({tgt.shape[0]} rows into {DIST_SHARDS} "
            f"destinations, capacity {cap}): a K9c compaction a destination {ms['k9c']:.4f} "
            f"ms, one stable sort and the ranges {ms['sort']:.4f} ms (median device ms, CUDA "
            f"events, in turns)")


def dist_state(q) -> dict:
    """What phase 14 reads of a compiled distributed query after a run."""
    cq = getattr(q, "_block_cq", q)
    return {"captures": cq.captures, "retries": q.last_retries, "reads": q.host_reads,
            "pins": cq.pins, "sync_checked": cq.sync_checked, "pool_mb": q.pool_mb}


def compiled_dist_run(q, want, what, table_eq, device, table_bytes, reads_a_run=1):
    """Phase 14 for one compiled query `q`: a first run and STREAM_REPS
    more, each equal to `want` in order; the third run and those after it
    capture nothing, retry nothing and read the host `reads_a_run` times;
    no run after the first reads a count eagerly. Returns (first ms, median
    ms, the state after the first and after the last run, MB allocated
    above the tables and shards at the peak of the first run and of the
    later ones, the rows)."""
    from hyrise_tpu_torch.plan.compiler import eager_reads

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    times, states = [], []
    for i in range(1 + STREAM_REPS):
        if i == 1:
            reads = eager_reads()
            first_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        rows = q.run().rows()
        times.append((time.perf_counter() - t0) * 1e3)
        same_rows(rows, want, f"{what} run {i + 1}", table_eq)
        states.append(dist_state(q))
        if i >= 2 and (states[-1]["captures"] != states[-2]["captures"]
                       or states[-1]["retries"] or states[-1]["reads"] != reads_a_run):
            raise AssertionError(f"{what} run {i + 1}: {states[-2]} -> {states[-1]}")
    if eager_reads() != reads:
        raise AssertionError(f"{what}: {eager_reads() - reads} eager reads after the first run")
    if device.type == "cuda" and not states[0]["sync_checked"]:
        raise AssertionError(f"{what}: the learning run was not sync-checked")
    peaks = [(b - table_bytes) / 1e6 for b in (first_peak,
                                              torch.cuda.max_memory_allocated(device))]
    return times[0], statistics.median(times[1:]), states[0], states[-1], peaks, rows


def freed() -> None:
    """Drop what the caller deleted: the compiled objects and their pools."""
    gc.collect()
    torch.cuda.empty_cache()


def replacement_checks(device, mesh, cat, sc, table_eq, replayed, captured) -> str:
    """14e: a compiled query over a source the ShardedCatalog replaces is
    captured again, over the new tensors: lineitem's shards replaced by
    those of its first half under Q6 (the eager answer over them), then put
    back; and a skewed table migrated by PlacementManager.run_once()."""
    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops.aggregate import Aggregate
    from hyrise_tpu_torch.ops.base import execute_plan
    from hyrise_tpu_torch.ops.get_table import GetTable
    from hyrise_tpu_torch.parallel.dist_compiler import (DistributedCompiledQuery,
                                                         DistributedQuery, ShardedCatalog)
    from hyrise_tpu_torch.parallel.placement import PlacementManager
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS

    qid = DIST_REPLACED_QID
    cq = DistributedCompiledQuery(TPCH_PLANS[qid](cat), sc)
    whole = [cq.run().rows() for _ in range(2)][-1]
    before = cq.captures
    kept = sc.get("lineitem")
    li = cat.get_table("lineitem")
    sc.add_sharded("lineitem", li.block(0, li.num_rows // 2), "l_orderkey")
    try:
        got = cq.run().rows()
        want = DistributedQuery(TPCH_PLANS[qid](cat), sc).run().rows()
        after = cq.captures
    finally:
        sc.entries["lineitem"] = kept
    same_rows(got, want, f"compiled Q{qid} over half of lineitem vs eager", table_eq)
    if got == whole or (device.type == "cuda" and after <= before) or cq.pins != 2:
        raise AssertionError(f"Q{qid} over half of lineitem: captures {before} -> {after}, "
                             f"pins {cq.pins}, {got} vs {whole}")
    back = cq.run().rows()
    same_rows(back, whole, f"compiled Q{qid} with lineitem put back", table_eq)
    line = (f"lineitem's shards replaced by those of its first {li.num_rows // 2} rows under "
            f"compiled Q{qid}: captured again (captures {before} -> {after}, the decisions "
            f"pinned anew), equal to the eager answer over them {got}; put back: captured "
            f"again (captures {cq.captures}, pins {cq.pins}), the whole table's answer again")
    add_graph_counts(replayed, captured, [cq])
    del cq

    fact, dim = skew_tables(device, **DIST_SKEW)
    skew_cat = catalog_of({"fact": fact, "dim": dim})
    sc2 = ShardedCatalog(mesh)
    sc2.add_sharded("fact", fact, "k")  # placed by the skewed key
    plan = Aggregate(GetTable("fact", skew_cat), ["k"], [("s", ast.sum_(ast.col("v")))])
    want = execute_plan(Aggregate(GetTable("fact", skew_cat), ["k"],
                                  [("s", ast.sum_(ast.col("v")))])).rows()
    cq = DistributedCompiledQuery(plan, sc2)
    same_rows(cq.run().rows(), want, "compiled skewed aggregate", table_eq, ordered=False)
    same_rows(cq.run().rows(), want, "compiled skewed aggregate", table_eq, ordered=False)
    before = cq.captures
    pm = PlacementManager(skew_cat, sc2)
    pm.observe(cq)
    if pm.run_once() != ["fact"]:
        raise AssertionError("PlacementManager did not migrate the skewed table")
    same_rows(cq.run().rows(), want, "compiled migrated aggregate", table_eq, ordered=False)
    if (device.type == "cuda" and cq.captures <= before) or cq.pins != 2:
        raise AssertionError(f"the migrated table was not captured again: {dist_state(cq)}")
    add_graph_counts(replayed, captured, [cq])
    line += (f"; PlacementManager.run_once() migrated the skewed fact table under a compiled "
             f"aggregate: captured again (captures {before} -> {cq.captures}), the same "
             f"{len(want)} groups")
    del cq, sc2, fact, dim, skew_cat
    freed()
    return line


def compiled_distribution_phase(device, card, sf10, dist, sf1_tables, sql_rows, table_eq,
                                wrappers) -> dict:
    """Phase 14 on phase 11's SF10 ShardedCatalog (`dist`) and phase 10's
    resident answers: the 22 hand plans through DistributedCompiledQuery,
    four runs each equal to the resident answer in order, with phase 11's
    decisions and exchange_stats(); Q1 and Q6 against the numpy oracles;
    Q3, Q5 and Q9 through the ring; BlockedDistributedQuery(compiled=True)
    for Q1, Q3 and Q6; the 22 SQL texts over SF1 shards through both
    builder flags against phase 6's rows; a replaced and a migrated source;
    compiled Q1, Q3, Q6 and Q18 over a one-rank NCCL group. Each query's
    compiled objects are freed after it. Returns the launches of the
    phase: the wrappers' counts less what the captures recorded plus what
    the replays ran."""
    from hyrise_tpu_torch.parallel.blocked_dist import BlockedDistributedQuery
    from hyrise_tpu_torch.parallel.dist_compiler import DistributedCompiledQuery, shard_tpch
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL

    t_phase = time.perf_counter()
    cat, resident, sc, mesh = sf10["cat"], sf10["resident"], dist["sc"], dist["mesh"]
    torch.cuda.synchronize(device)
    table_bytes = torch.cuda.memory_allocated(device)
    start = {name: w.launches for name, w in wrappers.items()}
    replayed, captured, lines, sums, answers = {}, {}, [], [0.0, 0.0, 0.0], {}
    profiled = []

    # 14a. the 22 hand plans
    for qid in sorted(TPCH_PLANS):
        what = f"compiled distributed Q{qid} at SF{STREAM_SF}"
        cq = DistributedCompiledQuery(TPCH_PLANS[qid](cat), sc)
        first, med, s0, s1, peak, rows = compiled_dist_run(cq, resident[qid], what, table_eq,
                                                          device, table_bytes)
        if cq.join_decisions() != dist["decisions"][qid] or \
                cq.exchange_stats() != dist["stats"][qid]:
            raise AssertionError(f"{what}: decisions {cq.join_decisions()} and exchanges "
                                 f"{cq.exchange_stats()} vs phase 11's {dist['decisions'][qid]} "
                                 f"{dist['stats'][qid]}")
        answers[qid] = rows
        eager_med, res_med = dist["medians"][qid], sf10["medians"][qid]
        sums[0] += med
        sums[1] += eager_med
        sums[2] += res_med
        lines.append(f"Q{qid} {first:.3f} / {med:.3f} ms (eager distributed {eager_med:.3f}, "
                     f"resident {res_med:.3f}), captures {s1['captures']} (first run "
                     f"{s0['captures']}), retries {s1['retries']} (first {s0['retries']}), host "
                     f"reads {s1['reads']} a run (first {s0['reads']}), sync-checked "
                     f"{s0['sync_checked']}, {len(cq.caps)} sites, pool {s1['pool_mb']:.1f} MB, "
                     f"peak {peak[0]:.1f} / {peak[1]:.1f} MB")
        if qid in DIST_PROFILED:
            busy, top, run_busy, inside, spans = exchange_profile(cq)
            profiled.append(
                f"Q{qid}: a replay busy {busy:.3f} ms, its largest kernels "
                + ", ".join(f"{k} {ms:.3f} ms in {n}" for k, ms, n in top)
                + f"; an uncaptured run at the learned capacities busy {run_busy:.3f} ms, "
                f"{inside:.3f} ms of it inside its {spans} exchanges "
                f"({inside / max(run_busy, 1e-9):.1%})")
        add_graph_counts(replayed, captured, [cq])
        del cq
        freed()
    expected6 = q6_oracle(sf10["li"], sf10["pool"])
    got6 = float(answers[6][0][0])
    if rel_diff(got6, expected6) > 1e-6:
        raise AssertionError(f"compiled distributed Q6 {got6} vs numpy {expected6}")
    worst = check_q1(answers[1], q1_oracle(sf10["li"], sf10["pool"]))
    log(f"compiled distribution: SF{STREAM_SF} all 22 hand plans through "
        f"DistributedCompiledQuery over {DIST_SHARDS} shards on {mesh.devices[0]} equal the "
        f"resident answers on every run (ints and strings exactly, floats within 1e-6 "
        f"relative, in order; Q11 answers {len(answers[11])} rows, ROADMAP C24, not counted "
        f"as a check), with phase 11's join decisions and exchange_stats(); the third and "
        f"fourth runs capture nothing, retry nothing, read the host once, and no run after the "
        f"first reads a count eagerly; Q6 {got6!r} vs numpy {expected6!r} (rel "
        f"{rel_diff(got6, expected6):.3e}); Q1's groups equal the numpy oracle's (floats "
        f"within {worst:.3e})")
    log(f"compiled distribution: SF{STREAM_SF} per query (host clock to rows on the host, "
        f"first run / median of {STREAM_REPS} more; pool: the graph's reserved MB; peak: MB "
        f"allocated above the tables and shards, first run / later runs) {card}: "
        + "; ".join(lines))
    log(f"compiled distribution: SF{STREAM_SF} sums of medians: compiled distributed "
        f"{sums[0]:.3f} ms, eager distributed {sums[1]:.3f} ms, resident {sums[2]:.3f} ms "
        f"{card}")
    log(f"compiled distribution: SF{STREAM_SF} device time of the exchanges (torch.profiler; "
        f"the lazy gathers of a gathered table count to its reader) {card}: "
        + "; ".join(profiled))
    if device.type == "cuda":
        from hyrise_tpu_torch.bench_q6 import time_ms
        log(f"compiled distribution: exchange designs {card}: "
            + exchange_design_ms(device, sc, time_ms))

    # 14b. the ring, and blocked distribution
    t0 = time.perf_counter()
    for qid in DIST_RING_COMPILED:
        cq = DistributedCompiledQuery(TPCH_PLANS[qid](cat), sc, exchange="ring")
        same_rows(cq.run().rows(), resident[qid], f"compiled Q{qid} through the ring", table_eq)
        add_graph_counts(replayed, captured, [cq])
        del cq
        freed()
    blocked = []
    for qid in DIST_BLOCKED_QIDS:
        bq = BlockedDistributedQuery(TPCH_PLANS[qid](cat), sc, block_rows=DIST_BLOCK_ROWS,
                                     compiled=True)
        what = f"compiled blocked distributed Q{qid}"
        first, med, s0, s1, peak, _ = compiled_dist_run(bq, resident[qid], what, table_eq,
                                                        device, table_bytes, reads_a_run=2)
        # one capture serves every block: a first, and one more where the
        # first pass tightened the capacities
        if bq.n_blocks < 2 or (device.type == "cuda" and not 1 <= s1["captures"] <= 2):
            raise AssertionError(f"{what}: {bq.n_blocks} blocks, {s1['captures']} captures "
                                 f"of the block program in {1 + STREAM_REPS} runs")
        events, busy, _ = replay_profile(lambda: bq.run().rows(), 1)
        add_graph_counts(replayed, captured, [bq])
        blocked.append(f"Q{qid} {bq.n_blocks} blocks of {DIST_BLOCK_ROWS} rows a shard, "
                       f"{s1['captures']} captures of the block program in {1 + STREAM_REPS} "
                       f"runs (first run {s0['captures']}), {first:.3f} / "
                       f"{med:.3f} ms (resident {sf10['medians'][qid]:.3f}), host reads "
                       f"{s1['reads']} a run, builds {bq.builds} a run, pool "
                       f"{s1['pool_mb']:.1f} MB, peak {peak[0]:.1f} / {peak[1]:.1f} MB; one "
                       f"profiled run: {events} device events, busy "
                       + ("not traced" if busy is None else
                          f"{busy:.3f} ms, {busy / bq.n_blocks:.3f} ms a block"))
        del bq
        freed()
    log(f"compiled distribution: Q{', Q'.join(map(str, DIST_RING_COMPILED))} through the ring "
        f"equal the resident answers; BlockedDistributedQuery(compiled=True) equal to the "
        f"resident answers, one capture serving every block of every shard {card}: "
        + "; ".join(blocked) + f"; {time.perf_counter() - t0:.1f} s")

    # 14c. SQL over SF1 shards, both builder flags
    t0 = time.perf_counter()
    sf1 = catalog_of(copy_to(sf1_tables, device))
    sc1 = shard_tpch(sf1, mesh)
    sql_ms = {}
    for qid in sorted(TPCH_SQL):
        ms = []
        for _ in range(2):
            q0 = time.perf_counter()
            pipeline = SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(sf1) \
                .with_distributed_execution(sc1).with_compiled_execution().create_pipeline()
            rows = pipeline.get_result_table().rows()
            ms.append((time.perf_counter() - q0) * 1e3)
            stmt = pipeline.pipeline_statements[-1]
            if not isinstance(stmt.last_dist_query, DistributedCompiledQuery):
                raise AssertionError(f"SQL Q{qid} ran as {stmt.last_dist_query!r}")
            check_rows(rows, sql_rows[qid], f"compiled distributed SQL Q{qid} at SF{SF} vs "
                       f"phase 6", table_eq)
        add_graph_counts(replayed, captured, [stmt.last_dist_query])
        sql_ms[qid] = ms
    log(f"compiled distribution: SF{SF} the 22 SQL texts with with_distributed_execution and "
        f"with_compiled_execution over {DIST_SHARDS} shards, each a DistributedCompiledQuery "
        f"cached per text, equal phase 6's rows (as row sets) on both runs; ms first / cached "
        f"{card}: " + ", ".join(f"Q{q} {a:.3f} / {b:.3f}" for q, (a, b) in sql_ms.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    sf1.compiled.clear()
    del sc1, sf1, pipeline, stmt
    freed()

    launches = {name: w.launches - start[name] - captured.get(name, 0) + replayed.get(name, 0)
                for name, w in wrappers.items()}

    # 14d. sources replaced under a compiled query; a process group
    log("compiled distribution: " + replacement_checks(device, mesh, cat, sc, table_eq,
                                                       replayed, captured))
    log("compiled distribution: " + group_checks(device, cat, dist["rows"], table_eq,
                                                 compiled=True))
    for name in DIST_GRAPH_KERNELS:
        if replayed.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched inside phase 14's graphs")
    log(f"compiled distribution: launches before the replacement checks {launches}, of them "
        f"inside the graphs (the replays' runs, all checks) {replayed}; phase 14 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- 12. whole-plan compiled execution: CUDA graphs ----------------------------

COMPILED_REPS = 5              # replays timed after the first run
COMPILED_SQL_REPS = 3          # cached SQL runs timed after the first
COMPILED_THREADS = 4           # callers of one cached compiled text at once
COMPILED_THREAD_QID = 3
COMPILED_REPLACED_QID = 6      # its lineitem is replaced by half of it
COMPILED_KERNELS = ("segment_reduce_cells", "lookup_last_eq_lut", "fused_cells_reduce",
                    "segment_reduce_sorted", "lookup_last_eq", "compact_indices_cap",
                    "expand_pairs_cap")
MICRO_ROWS = 1 << 22
MICRO_RUNS = 3
CAP_NODE_QIDS = (18, 21)       # the device-bound replays: K9c's and K5c's share


CAP_NODE = {"K9c": re.compile(r"\bselect(_cap)?_kernel\b"),
            "K5c": re.compile(r"\branges_scan_kernel\b")}
EXPAND_NODE = re.compile(r"\bexpand_kernel\b")
MEMSETS_BEFORE = {"K9c": 2, "K5c": 3}  # a form that clears its outputs: theirs, the scratch's
# a K3 call: group_reduce_kernel, or the first of the earlier form's two
# kernels, whose combine_kernel followed it
K3_NODE = re.compile(r"\b(group_reduce_kernel|reduce_cells_kernel)\b")
K3_COMBINE = re.compile(r"\bcombine_kernel\b")


def cap_nodes(prof) -> dict:
    """{"K9c": [calls, device ms], "K5c": [...], "K3": [...]} among a
    profiled run's device events in the order they ran: a K9c call is a
    select kernel (select_cap_kernel, or select_kernel in the form before
    it) with the memsets right before it (at most MEMSETS_BEFORE), a K5c
    call a ranges_scan_kernel with the memsets right before it and the
    expand_kernel after it, a K3 call a K3_NODE kernel (with the earlier
    form's combine_kernel). The form before K9c's and K5c's ran two torch
    element-wise ops after the expansion too, which are not counted here
    (they cannot be told from the plan's own)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.events() if e.device_type == cuda),
                    key=lambda e: e.time_range.start)
    out = {"K9c": [0, 0.0], "K5c": [0, 0.0], "K3": [0, 0.0]}
    for i, e in enumerate(events):
        us = e.time_range.end - e.time_range.start
        if EXPAND_NODE.search(e.name):
            out["K5c"][1] += us / 1e3
            continue
        if K3_NODE.search(e.name) or K3_COMBINE.search(e.name):
            out["K3"][0] += 1 if K3_NODE.search(e.name) else 0
            out["K3"][1] += us / 1e3
            continue
        kind = next((k for k, pattern in CAP_NODE.items() if pattern.search(e.name)), None)
        if kind is None:
            continue
        j = i - 1
        while j >= 0 and i - j <= MEMSETS_BEFORE[kind] and "Memset" in events[j].name:
            us += events[j].time_range.end - events[j].time_range.start
            j -= 1
        out[kind][0] += 1
        out[kind][1] += us / 1e3
    return out


def replay_profile(run, floor: int) -> tuple:
    """(device events, device busy ms, cap_nodes) of one run() under
    torch.profiler, or (0, None, None). A profiler run that comes back with
    fewer than `floor` device events (the kernels the wrappers launch in one
    replay) lost some, as it does once in some tens of runs, and is made
    again, three times at most."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
        events, busy_us = 0, 0.0
        for avg in prof.key_averages():
            if avg.device_type != torch.autograd.DeviceType.CUDA:
                continue
            total_us = getattr(avg, "self_device_time_total", None)
            if total_us is None:
                total_us = avg.self_cuda_time_total
            events += avg.count
            busy_us += total_us
        if events >= max(floor, 1):
            return events, busy_us / 1e3, cap_nodes(prof)
    return 0, None, None


def graph_launches(before, wrappers, queries) -> dict:
    """The launches each wrapper's kernels made since `before`: the
    wrappers' own counts (uncaptured runs, and captures, which record
    launches without running them) less what the captures recorded, plus
    what the replays ran."""
    out = {}
    for name, w in wrappers.items():
        n = w.launches - before.get(name, 0)
        for cq in queries:
            n += cq.launches_replayed.get(name, 0) - cq.launches_captured.get(name, 0)
        out[name] = n
    return out


def recording_capacity_calls(calls: list, k3_calls: list):
    """A context in which every K9c and K5c call that a graph capture records
    appends (kind, n, cap, site) to `calls`: n the mask's rows or the
    ranges, site the index of its count among the plan's site counts
    (CompiledQuery.last_counts); and every K3 call of a dense Aggregate
    appends (n, cells, slots) to `k3_calls` (the form that reduces one slot
    a call: 0 slots for a count, else 1). The calls are caught where the
    plan makes them, compiler.oracle_compact, ops/join.py's expand_pairs_cap
    and ops/aggregate.py's K3 entry (the wrappers themselves must stay,
    since they count their own launches)."""
    import contextlib

    from hyrise_tpu_torch.ops import aggregate as aggregate_ops
    from hyrise_tpu_torch.ops import join as join_ops
    from hyrise_tpu_torch.plan import compiler

    k3_name = ("segment_reduce_cells_many" if hasattr(aggregate_ops, "segment_reduce_cells_many")
               else "segment_reduce_cells")
    k3_saved = getattr(aggregate_ops, k3_name)

    def k3_many(cell, n_cells, slots):
        if capturing(cell):
            k3_calls.append((cell.shape[0], n_cells, len(slots)))
        return k3_saved(cell, n_cells, slots)

    def k3_one(values, cell, n_cells, kind, sentinel=None):
        if capturing(cell):
            k3_calls.append((cell.shape[0], n_cells, 0 if kind == "count" else 1))
        return k3_saved(values, cell, n_cells, kind, sentinel)

    def capturing(t) -> bool:
        return (compiler.active() is not None and t.is_cuda
                and torch.cuda.is_current_stream_capturing())

    def oracle_compact(mask, label):
        site = len(compiler.active().counts)
        indices, count = saved[0](mask, label)
        if capturing(mask):
            calls.append(("K9c", mask.shape[0], indices.shape[0], site))
        return indices, count

    def expand_pairs_cap(lo, counts, build_perm, cap):
        if capturing(lo):
            calls.append(("K5c", lo.shape[0], cap, len(compiler.active().counts)))
        return saved[1](lo, counts, build_perm, cap)

    saved = compiler.oracle_compact, join_ops.expand_pairs_cap

    @contextlib.contextmanager
    def recording():
        compiler.oracle_compact, join_ops.expand_pairs_cap = oracle_compact, expand_pairs_cap
        setattr(aggregate_ops, k3_name, k3_many if k3_name.endswith("_many") else k3_one)
        try:
            yield
        finally:
            compiler.oracle_compact, join_ops.expand_pairs_cap = saved
            setattr(aggregate_ops, k3_name, k3_saved)
    return recording()


def pow2_class(v: int) -> int:
    """The least k with v <= 2^k."""
    return max(int(v) - 1, 0).bit_length()


def census_line(census) -> str:
    """K9c's and K5c's calls in one replay of each plan by size class
    (n <= 2^a, cap <= 2^b, count <= 2^c), with the entries they write (cap)
    beside the ones they fill (min(count, cap))."""
    parts = []
    for kind in ("K9c", "K5c"):
        mine = [(n, cap, count) for k, n, cap, count in census if k == kind]
        classes = {}
        for n, cap, count in mine:
            key = (pow2_class(n), pow2_class(cap), pow2_class(count))
            classes[key] = classes.get(key, 0) + 1
        order = sorted(classes.items(), key=lambda kv: (-kv[1], kv[0]))
        written = sum(cap for _, cap, _ in mine)
        filled = sum(min(count, cap) for _, cap, count in mine)
        parts.append(f"{kind} {len(mine)} calls, {written} entries written, {filled} of them "
                     f"positions or pairs; by (n <= 2^a, cap <= 2^b, count <= 2^c): "
                     + ", ".join(f"({a}, {b}, {c}) {k}" for (a, b, c), k in order))
    return "; ".join(parts)


def k3_census_line(census) -> str:
    """K3's calls in one replay of each plan by size class (n <= 2^a, the
    cells, the slots), with the rows they read."""
    classes = {}
    for n, n_cells, slots in census:
        key = (pow2_class(n), n_cells, slots)
        classes[key] = classes.get(key, 0) + 1
    order = sorted(classes.items(), key=lambda kv: (-kv[1], kv[0]))
    return (f"K3 {len(census)} calls over {sum(n for n, _, _ in census)} rows; by (n <= 2^a, "
            f"cells, slots): " + ", ".join(f"({a}, {c}, {k}) {m}" for (a, c, k), m in order))


def compiled_phase(device, card, tables, hand_rows, hand_wall, sql_rows, wrappers,
                   table_eq, tpch_sql) -> tuple:
    """Phase 12 on copies of phase 4's SF1 tables: the 22 hand plans through
    run_query(via="compiled") against phase 5's rows, the 22 SQL texts with
    with_compiled_execution() against phase 6's, that a replay reads no
    count eagerly, that a replaced table is re-captured, four threads on one
    cached text, and bench/micro.py on the card; with each replay's K9c and
    K5c nodes (cap_nodes) and their calls by size class (census_line).
    Returns (the phase's launches, {qid: (busy ms, cap_nodes)} of the
    CAP_NODE_QIDS)."""
    import threading

    from hyrise_tpu_torch.bench import micro
    from hyrise_tpu_torch.ops.base import execute_plan
    from hyrise_tpu_torch.plan.compiler import eager_reads
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, compiled_query, run_query

    t_phase = time.perf_counter()
    cat = catalog_of(plain_copies(tables))
    before = {name: w.launches for name, w in wrappers.items()}
    queries = []
    lines, replay_sum, eager_sum = [], 0.0, 0.0
    calls, census, nodes = [], [], {}
    k3_calls, k3_census = [], []
    for qid in sorted(TPCH_PLANS):
        t0 = time.perf_counter()
        with recording_capacity_calls(calls, k3_calls):
            start, k3_start = len(calls), len(k3_calls)
            rows = run_query(qid, cat, via="compiled").rows()
        first = (time.perf_counter() - t0) * 1e3
        cq = compiled_query(qid, cat)
        queries.append(cq)
        # the calls of the capture whose graph replays: the last capture's
        captured = sum(cq.capture_launches.get(k, 0)
                       for k in ("compact_indices_cap", "expand_pairs_cap"))
        graph_calls = calls[start:][-captured:] if captured else []
        k3_captured = cq.capture_launches.get("segment_reduce_cells", 0)
        k3_census += k3_calls[k3_start:][-k3_captured:] if k3_captured else []
        retries, captures = cq.last_retries, cq.captures
        if not cq.sync_checked:
            raise AssertionError(f"compiled Q{qid}: the learning run was not sync-checked; "
                                 f"threads {[t.name for t in threading.enumerate()]}")
        check_rows(rows, hand_rows[qid], f"compiled Q{qid} at SF{SF} vs phase 5", table_eq)
        times = []
        for _ in range(COMPILED_REPS):
            t0 = time.perf_counter()
            rows = run_query(qid, cat, via="compiled").rows()
            times.append((time.perf_counter() - t0) * 1e3)
        check_rows(rows, hand_rows[qid], f"compiled Q{qid} replayed vs phase 5", table_eq)
        if cq.captures != captures or cq.last_retries:
            raise AssertionError(f"compiled Q{qid}: a replay captured again or retried")
        events, busy, cap_ms = replay_profile(
            lambda: run_query(qid, cat, via="compiled").rows(),
            sum(cq.capture_launches.values()))
        nodes[qid] = (busy, cap_ms)
        site_counts = getattr(cq, "last_counts", None)  # an older tree's has none
        if site_counts is not None:
            census += [(kind, n, cap, site_counts[site]) for kind, n, cap, site in graph_calls]
        med = statistics.median(times)
        replay_sum += med
        eager_sum += hand_wall[qid][1]
        lines.append(f"Q{qid} {first:.3f} / {med:.3f} vs eager {hand_wall[qid][1]:.3f} "
                     f"(retries {retries}, captures {cq.captures}, sites {len(cq.caps)}, pool "
                     f"{cq.pool_mb:.1f} MB, {events} device events, busy "
                     + ("not traced" if busy is None else f"{busy:.3f} ms") + ")")
    log(f"compiled: SF{SF} hand plans through run_query(via='compiled'), every one "
        f"captured and equal to phase 5's rows; host ms to rows on the host, first run "
        f"(learn under set_sync_debug_mode('error'), capture, replay) / median of "
        f"{COMPILED_REPS} replays vs phase 5's eager median {card}: " + "; ".join(lines))
    log(f"compiled: SF{SF} sums of medians: compiled {replay_sum:.3f} ms, eager "
        f"{eager_sum:.3f} ms {card}")
    log(f"compiled: K9c, K5c and K3 nodes in one replay (cap_nodes: calls / device ms, "
        f"torch.profiler) beside the replay's busy ms {card}: " + "; ".join(
            f"Q{q} " + ("not traced" if busy is None else
                        f"K9c {c['K9c'][0]} / {c['K9c'][1]:.4f}, K5c {c['K5c'][0]} / "
                        f"{c['K5c'][1]:.4f}, K3 {c['K3'][0]} / {c['K3'][1]:.4f} of busy "
                        f"{busy:.3f}")
            for q, (busy, c) in sorted(nodes.items())))
    traced = [(busy, c) for busy, c in nodes.values() if busy is not None]
    k3_ms, busy_ms = sum(c["K3"][1] for _, c in traced), sum(b for b, _ in traced)
    log(f"compiled: K3 in one replay of each of the {len(traced)} traced plans {card}: "
        f"{sum(c['K3'][0] for _, c in traced)} calls, {k3_ms:.4f} device ms of "
        f"{busy_ms:.3f} busy ({100 * k3_ms / max(busy_ms, 1e-9):.2f}%)")
    log("compiled: K9c and K5c calls in one replay of each of the 22 hand plans: "
        + (census_line(census) if census else "none counted (no graph captured, or a "
           "CompiledQuery without last_counts)"))
    log("compiled: K3 calls in one replay of each of the 22 hand plans: "
        + (k3_census_line(k3_census) if k3_census else "none counted (no graph captured)"))

    # the 22 SQL texts, compiled and cached
    lines, sql_sum = [], 0.0
    for qid in sorted(tpch_sql):
        def sql_run():
            p = SQLPipelineBuilder(tpch_sql[qid]).with_catalog(cat) \
                .with_compiled_execution().create_pipeline()
            out = p.get_result_table().rows()
            return out, p.pipeline_statements[-1]
        t0 = time.perf_counter()
        rows, st = sql_run()
        first = (time.perf_counter() - t0) * 1e3
        if not st.last_compiled:
            raise AssertionError(f"SQL Q{qid} did not run compiled")
        check_rows(rows, sql_rows[qid], f"compiled SQL Q{qid} vs phase 6", table_eq)
        times = []
        for _ in range(COMPILED_SQL_REPS):
            t0 = time.perf_counter()
            rows, st = sql_run()
            times.append((time.perf_counter() - t0) * 1e3)
            if not st.last_compiled:
                raise AssertionError(f"SQL Q{qid} did not run compiled again")
        check_rows(rows, sql_rows[qid], f"compiled SQL Q{qid} cached vs phase 6", table_eq)
        queries.append(st.last_compiled_query)
        sql_sum += statistics.median(times)
        lines.append(f"Q{qid} {first:.3f} / {statistics.median(times):.3f}")
    log(f"compiled: SF{SF} the 22 SQL texts with with_compiled_execution(), each compiled "
        f"and equal to phase 6's rows; ms first / median of {COMPILED_SQL_REPS} cached "
        f"{card}: " + "; ".join(lines) + f"; sum of medians {sql_sum:.3f}")

    # capture stays honest
    reads = eager_reads()
    cq1 = compiled_query(1, cat)
    replays = cq1.replays
    run_query(1, cat, via="compiled").rows()
    if eager_reads() != reads or cq1.replays != replays + cq1.on_cuda:
        raise AssertionError("a replay read a count eagerly or did not replay")
    qid = COMPILED_REPLACED_QID
    half = catalog_of({name: cat.get_table(name) for name in cat.table_names()})
    first_rows = run_query(qid, half, via="compiled").rows()
    cq = compiled_query(qid, half)
    queries.append(cq)
    li = half.get_table("lineitem")
    half.replace_table("lineitem", li.block(0, li.num_rows // 2))
    want = execute_plan(TPCH_PLANS[qid](half)).rows()
    got = run_query(qid, half, via="compiled").rows()
    check_rows(got, want, f"compiled Q{qid} over a replaced lineitem", table_eq)
    if cq.captures != 2 * cq.on_cuda or got == first_rows:
        raise AssertionError(f"compiled Q{qid}: {cq.captures} captures after replacing "
                             f"lineitem, answer changed: {got != first_rows}")
    sql = tpch_sql[COMPILED_THREAD_QID]
    answers, errors = [], []

    def caller():
        try:
            for _ in range(3):
                answers.append(SQLPipelineBuilder(sql).with_catalog(cat)
                               .with_compiled_execution().create_pipeline()
                               .get_result_table().rows())
        except Exception as exc:  # raised below, in the phase's thread
            errors.append(exc)
    threads = [threading.Thread(target=caller) for _ in range(COMPILED_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for rows in answers:
        check_rows(rows, sql_rows[COMPILED_THREAD_QID],
                   f"compiled SQL Q{COMPILED_THREAD_QID} on {COMPILED_THREADS} threads", table_eq)
    log(f"compiled: a replay reads no count eagerly; replacing lineitem under Q{qid} "
        f"captured again and answered the new table; {COMPILED_THREADS} threads x 3 runs "
        f"of SQL Q{COMPILED_THREAD_QID}, one cached CompiledQuery, all equal to phase 6")
    launches = graph_launches(before, wrappers, queries)
    del cat, half, queries, cq, cq1
    gc.collect()  # a catalog and its CompiledQuerys refer to each other
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out = io.StringIO()
    report = micro.run_micros(MICRO_ROWS, MICRO_RUNS, device, out=out)
    for line in out.getvalue().splitlines():
        log(f"compiled: micro {line}")
    withheld = [r["name"] for r in report if r.get("withheld")]
    log(f"compiled: bench/micro.py at {MICRO_ROWS} rows {card} in "
        f"{time.perf_counter() - t0:.1f} s; withheld: {withheld or 'none'}")
    log(f"compiled: launches in phase 12 (graph replays counted) {launches}")
    log(f"compiled: phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches, {q: nodes[q] for q in CAP_NODE_QIDS}


# -- 15. indexes compiled and over shards; the measurement tools ---------------

INDEX_REPS = 2                 # compiled runs after the first: replays
INDEX_POINT_LOOKUPS = 40       # phase 8's kind of lookup, o_orderkey = k, compiled
INDEX_ABSENT_LOOKUPS = 4       # of them, keys no order has
INDEX_COMPOSITE_LOOKUPS = 10   # (l_orderkey, l_linenumber) = (k, n), compiled
INDEX_ABSENT_COMPOSITE = 2     # of them, line 8 (orders have 1 to 7 lines)
TOOLS_RUNS = 3                 # tpch_bench's and scaling_bench's timed runs
COMPARE_SF = 0.1               # reference_compare's scale factor
SCALING_QIDS = (1, 3, 6, 12)
SCALING_MESHES = (1, 2, 4)
# the compiled path's kernels: K3, K4, K6, K7, K8, K9c and K5c
INDEX_KERNELS = COMPILED_KERNELS


class _GraphCounts:
    """A compiled object's launches inside its graphs, kept after it is
    freed (graph_launches reads them)."""

    def __init__(self, q):
        self.launches_captured = dict(q.launches_captured)
        self.launches_replayed = dict(q.launches_replayed)


def index_lookups(idx_tables, cat, sql, table_eq, counted: list) -> str:
    """15a's point and composite lookups: each text compiled against the
    same text eagerly (through the index), the compiled IndexScan run in
    capacity mode; each compiled query's graph launches go to `counted`.
    Returns the line's text."""
    from hyrise_tpu_torch.ops import IndexScan

    rng = np.random.default_rng([SEED, LOOKUP_STREAM])
    orders, li = idx_tables["orders"], idx_tables["lineitem"]
    keys = orders.column("o_orderkey").data[:orders.num_rows].cpu().numpy()
    absent = keys.max() + 1 + np.arange(INDEX_ABSENT_LOOKUPS, dtype=np.int64)
    absent[0] = -1
    points = rng.permutation(np.concatenate([
        rng.choice(keys, INDEX_POINT_LOOKUPS - INDEX_ABSENT_LOOKUPS, replace=False), absent]))
    li_keys = li.column("l_orderkey").data[:li.num_rows].cpu().numpy()
    li_lines = li.column("l_linenumber").data[:li.num_rows].cpu().numpy()
    picks = rng.choice(len(li_keys), INDEX_COMPOSITE_LOOKUPS, replace=False)
    pairs = [(int(li_keys[p]), 8 if i < INDEX_ABSENT_COMPOSITE else int(li_lines[p]))
             for i, p in enumerate(picks)]
    texts = [("point", f"SELECT o_orderkey, o_custkey, o_totalprice, o_orderdate FROM orders "
                       f"WHERE o_orderkey = {k}") for k in points] + \
            [("composite", f"SELECT l_orderkey, l_linenumber, l_quantity, l_extendedprice "
                           f"FROM lineitem WHERE l_orderkey = {k} AND l_linenumber = {n}")
             for k, n in pairs]
    found = {"point": 0, "composite": 0}
    ms = {"point": [], "composite": [], "eager": []}
    for kind, text in texts:
        want, est, eager_ms = sql(text, cat)
        got, st, first = sql(text, cat, compiled=True)
        check_rows(got, want, f"indexes: compiled {kind} lookup {text!r}", table_eq)
        scans = [op for op in st.last_compiled_query.ops if isinstance(op, IndexScan)] \
            if st.last_compiled else []
        eager_scans = distinct_operators(est.last_plan, IndexScan)
        if not scans or not all(op.performance_data.extra.get("index_fallback") for op in scans) \
                or not eager_scans or (kind == "composite" and not any(
                    op.performance_data.extra.get("composite_index") for op in eager_scans)):
            raise AssertionError(f"indexes: {text!r}: compiled {st.last_compiled}, IndexScans "
                                 f"{len(scans)} compiled and {len(eager_scans)} eager")
        counted.append(_GraphCounts(st.last_compiled_query))
        found[kind] += len(got) > 0
        ms[kind].append(first)
        ms["eager"].append(eager_ms)
    if found != {"point": INDEX_POINT_LOOKUPS - INDEX_ABSENT_LOOKUPS,
                 "composite": INDEX_COMPOSITE_LOOKUPS - INDEX_ABSENT_COMPOSITE}:
        raise AssertionError(f"indexes: lookups found {found}")
    cat.compiled.clear()
    return (f"{INDEX_POINT_LOOKUPS} point lookups on o_orderkey ({INDEX_ABSENT_LOOKUPS} absent) "
            f"and {INDEX_COMPOSITE_LOOKUPS} on (l_orderkey, l_linenumber) "
            f"({INDEX_ABSENT_COMPOSITE} absent), each a new text compiled with its IndexScan "
            f"in capacity mode, equal to the eager answer through the index; median ms a "
            f"lookup, compiled first run (learn, capture, replay): point "
            f"{statistics.median(ms['point']):.3f}, composite "
            f"{statistics.median(ms['composite']):.3f}; eager through the index "
            f"{statistics.median(ms['eager']):.3f}")


def indexes_and_tools_phase(device, card, tables, wrappers, table_eq, tpch_sql,
                            sql_rows=None) -> dict:
    """Phase 15 on copies of phase 4's SF1 tables with phase 8's 14 indexes:
    the 22 texts and the lookups compiled (15a), the 22 texts and JoinIndex
    plans over 4 shards, eager and compiled (15b), then the four tools in
    process (15c). `sql_rows`, where given, are phase 6's rows, which the
    eager answers with indexes must equal. Returns the phase's launches
    (graph replays counted)."""
    import tempfile

    from hyrise_tpu_torch.bench import (merge_reports, reference_compare, scaling_bench,
                                        tpch_bench)
    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops import GetTable, IndexScan, Join, JoinIndex, execute_plan
    from hyrise_tpu_torch.ops.aggregate import Aggregate
    from hyrise_tpu_torch.parallel.dist_compiler import (DistributedCompiledQuery,
                                                         DistributedQuery, shard_tpch)
    from hyrise_tpu_torch.parallel.mesh import make_mesh
    from hyrise_tpu_torch.plan.compiler import eager_reads
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.storage.index import create_index
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.types import JoinMode

    t_phase = time.perf_counter()
    before = {name: w.launches for name, w in wrappers.items()}
    counted = []  # the phase's compiled objects' graph launches

    def sql(text, cat, compiled=False, sc=None):
        """(rows, statement, host ms to rows on the host) of one text, the
        plan cache on."""
        t0 = time.perf_counter()
        builder = SQLPipelineBuilder(text).with_catalog(cat)
        if sc is not None:
            builder = builder.with_distributed_execution(sc)
        if compiled:
            builder = builder.with_compiled_execution()
        pipeline = builder.create_pipeline()
        rows = pipeline.get_result_table().rows()
        return rows, pipeline.pipeline_statements[-1], (time.perf_counter() - t0) * 1e3

    # 15a. the 22 texts with indexes, compiled
    t0 = time.perf_counter()
    idx_tables = plain_copies(tables)
    for name, column in INDEXED:
        create_index(idx_tables[name], column)
    cat = catalog_of(idx_tables)
    eager, eager_ms = {}, {}
    for qid in sorted(tpch_sql):
        eager[qid], _, _ = sql(tpch_sql[qid], cat)
        if sql_rows is not None:
            check_rows(eager[qid], sql_rows[qid], f"indexes: SQL Q{qid} vs phase 6", table_eq)
        _, _, eager_ms[qid] = sql(tpch_sql[qid], cat)
    lines, in_capacity_mode = [], 0
    for qid in sorted(tpch_sql):
        rows, st, first = sql(tpch_sql[qid], cat, compiled=True)
        if not st.last_compiled:
            raise AssertionError(f"indexes: SQL Q{qid} did not run compiled")
        check_rows(rows, eager[qid], f"indexes: compiled SQL Q{qid} vs eager", table_eq)
        cq = st.last_compiled_query
        captures, reads, times = cq.captures, eager_reads(), []
        for i in range(INDEX_REPS):
            rows, st, ms = sql(tpch_sql[qid], cat, compiled=True)
            times.append(ms)
            check_rows(rows, eager[qid], f"indexes: compiled SQL Q{qid} run {i + 2}", table_eq)
            if st.last_compiled_query is not cq or cq.captures != captures or \
                    cq.last_retries or cq.host_reads != 1:
                raise AssertionError(f"indexes: compiled SQL Q{qid} run {i + 2}: captures "
                                     f"{captures} -> {cq.captures}, retries {cq.last_retries}, "
                                     f"host reads {cq.host_reads}")
        if eager_reads() != reads:
            raise AssertionError(f"indexes: compiled SQL Q{qid}: an eager read in a replay")
        scans = [op for op in cq.ops if isinstance(op, IndexScan)]
        if not all(op.performance_data.extra.get("index_fallback") for op in scans):
            raise AssertionError(f"indexes: SQL Q{qid}: an IndexScan left capacity mode")
        in_capacity_mode += len(scans)
        counted.append(cq)
        lines.append(f"Q{qid} {first:.3f} / {statistics.median(times):.3f} / "
                     f"{eager_ms[qid]:.3f}" + (f" ({len(scans)} IndexScans)" if scans else ""))
    if in_capacity_mode <= 0:
        raise AssertionError("indexes: no IndexScan ran in capacity mode")
    log(f"indexes: SF{SF} the 22 texts with the 14 indexes through with_compiled_execution(), "
        f"each equal to the eager rows (phase 8's route); {in_capacity_mode} IndexScans ran in "
        f"capacity mode as TableScans; runs 2 and 3 captured nothing, retried nothing, read the "
        f"host once and read no count eagerly; host ms first run (learn, capture, replay) / "
        f"median of {INDEX_REPS} replays / eager through the indexes {card}: "
        + "; ".join(lines))
    counted = [_GraphCounts(q) for q in counted]
    cat.compiled.clear()
    log("indexes: " + index_lookups(idx_tables, cat, sql, table_eq, counted) + f" {card}; 15a took "
        f"{time.perf_counter() - t0:.1f} s")

    # 15b. the 22 texts and JoinIndex plans over 4 shards
    t0 = time.perf_counter()
    sc = shard_tpch(cat, make_mesh(DIST_SHARDS, device=device.type))
    lines, stats = [], []
    for qid in sorted(tpch_sql):
        rows, st, eager_dist = sql(tpch_sql[qid], cat, sc=sc)
        dq = st.last_dist_query
        if dq is None:
            raise AssertionError(f"indexes: SQL Q{qid} did not run distributed")
        check_rows(rows, eager[qid], f"indexes: distributed SQL Q{qid}", table_eq)
        rows, st, first = sql(tpch_sql[qid], cat, compiled=True, sc=sc)
        cq = st.last_dist_query
        if not isinstance(cq, DistributedCompiledQuery):
            raise AssertionError(f"indexes: compiled distributed SQL Q{qid} ran as {cq!r}")
        check_rows(rows, eager[qid], f"indexes: compiled distributed SQL Q{qid}", table_eq)
        captures = cq.captures
        rows, st, replay = sql(tpch_sql[qid], cat, compiled=True, sc=sc)
        check_rows(rows, eager[qid], f"indexes: compiled distributed SQL Q{qid} again", table_eq)
        if st.last_dist_query is not cq or cq.captures != captures or cq.last_retries or \
                cq.host_reads != 1:
            raise AssertionError(f"indexes: compiled distributed SQL Q{qid} captured again, "
                                 f"retried or read the host more than once")
        if cq.exchange_stats() != dq.exchange_stats() or \
                cq.join_decisions() != dq.join_decisions():
            raise AssertionError(f"indexes: distributed SQL Q{qid}: the compiled form's "
                                 f"decisions or exchanges differ from the eager form's")
        counted.append(_GraphCounts(cq))
        index_ops = [op for op in cq.ops if op.name in ("IndexScan", "JoinIndex")]
        lines.append(f"Q{qid} {eager_dist:.3f} / {first:.3f} / {replay:.3f}")
        if index_ops:
            stats.append(f"Q{qid} ({len(index_ops)} IndexScans) {stats_text(cq.exchange_stats())}")
    joins = []
    for mode in JOIN_INDEX_MODES:
        column = "l_quantity" if mode in ("INNER", "LEFT") else "o_totalprice"

        def plan(join_class, mode=mode, column=column):
            j = join_class(GetTable("orders", cat), GetTable("lineitem", cat), JoinMode[mode],
                           ("o_orderkey", "l_orderkey"))
            return Aggregate(j, [], [("n", ast.count_()), ("s", ast.sum_(ast.col(column)))])

        want = execute_plan(plan(Join)).rows()
        dq = DistributedQuery(plan(JoinIndex), sc)
        eager_ms_, rows = host_ms(lambda: dq.run().rows(), device)
        check_rows(rows, want, f"indexes: distributed JoinIndex {mode}", table_eq)
        cq = DistributedCompiledQuery(plan(JoinIndex), sc)
        first, rows = host_ms(lambda: cq.run().rows(), device)
        check_rows(rows, want, f"indexes: compiled distributed JoinIndex {mode}", table_eq)
        replay, rows = host_ms(lambda: cq.run().rows(), device)
        check_rows(rows, want, f"indexes: compiled distributed JoinIndex {mode} again", table_eq)
        if cq.join_decisions() != dq.join_decisions() or \
                cq.exchange_stats() != dq.exchange_stats():
            raise AssertionError(f"indexes: JoinIndex {mode}: the compiled form's decisions or "
                                 f"exchanges differ from the eager form's")
        counted.append(_GraphCounts(cq))
        joins.append(f"{mode} {dq.join_decisions()} {eager_ms_:.3f} / {first:.3f} / "
                     f"{replay:.3f}, {stats_text(cq.exchange_stats())}")
    log(f"indexes: SF{SF} over {DIST_SHARDS} shards: the 22 texts with indexes through "
        f"with_distributed_execution, eager and compiled, equal the eager single-node rows; "
        f"the compiled form's second run captured nothing, retried nothing, read the host once; "
        f"{len(stats)} of the plans hold an IndexScan and ran distributed; host ms eager / "
        f"compiled first / compiled replay {card}: " + "; ".join(lines))
    log(f"indexes: exchange_stats() (label sites/rows/moved) of the distributed plans with an "
        f"IndexScan: " + "; ".join(stats))
    log(f"indexes: JoinIndex of orders with lineitem under COUNT and SUM over {DIST_SHARDS} "
        f"shards, DistributedQuery and DistributedCompiledQuery equal to single-node Join: "
        f"decisions, host ms eager / compiled first / replay {card}, exchange_stats(): "
        + "; ".join(joins) + f"; {len(stats) + len(joins)} plans with an IndexScan or a "
        f"JoinIndex ran distributed; 15b took {time.perf_counter() - t0:.1f} s")
    del sc, cat, idx_tables, cq, dq
    freed()

    # 15c. the four tools, in process
    t0 = time.perf_counter()
    plain = catalog_of(plain_copies(tables))
    qids = sorted(tpch_sql)
    report = tpch_bench.run_suite(plain, qids, "compiled", runs=TOOLS_RUNS, warmup=1, sf=SF)
    names = [b["name"] for b in report["benchmarks"]]
    if names != [f"TPC-H {q:02d}" for q in qids]:
        raise AssertionError(f"tpch_bench: queries missing from the report: {names}")
    counted += [_GraphCounts(q) for q in plain.compiled.values()]  # run_query's, by query
    plain.compiled.clear()
    with tempfile.TemporaryDirectory() as tmp:
        halves = []
        for i, part in enumerate((report["benchmarks"][:11], report["benchmarks"][11:])):
            halves.append(f"{tmp}/part{i}.json")
            with open(halves[-1], "w") as f:
                json.dump({"context": report["context"], "benchmarks": part}, f)
        merged = merge_reports.main([f"{tmp}/merged.json"] + halves)
    if merged["benchmarks"] != report["benchmarks"]:
        raise AssertionError("merge_reports: the halves do not merge into the report")
    log(f"tools: tpch_bench --via compiled --sf {SF} --runs {TOOLS_RUNS} over phase 4's tables, "
        f"context devices {report['context']['devices']}; median ms: "
        + ", ".join(f"Q{b['name'][-2:]} {b['real_time_ms']:.3f}" for b in report["benchmarks"])
        + f"; sum {sum(b['real_time_ms'] for b in report['benchmarks']):.3f}; merge_reports "
        f"of its two halves equals it")
    t1 = time.perf_counter()
    small = dbgen.generate_tables(COMPARE_SF, SEED, device=device)
    small_cat = catalog_of(small)
    oracle = reference_compare.make_oracle(small)
    load_s = time.perf_counter() - t1
    result = reference_compare.compare(small_cat, oracle, qids, "compiled")
    oracle.close()
    counted += [_GraphCounts(q) for q in small_cat.compiled.values()]
    small_cat.compiled.clear()
    summary = result["summary"]
    if summary["queries"] != len(qids) or not summary["all_int_exact"] or \
            summary["max_rel"] > 1e-6:
        raise AssertionError(f"reference_compare: {summary}; " + json.dumps(result["queries"]))
    log(f"tools: reference_compare --via compiled at SF{COMPARE_SF} {card}: the 22 queries' "
        f"every non-aggregate cell equal to sqlite, float aggregates within "
        f"{summary['max_rel']!r} relative of the sequential float64 fold (limit 1e-6), the "
        f"largest ULP distance {summary['max_ulp']!r}; per query max ULP "
        + ", ".join(f"{q} {r['max_ulp']:.1f}" for q, r in result["queries"].items()
                    if r["float_cells"])
        + f"; {time.perf_counter() - t1:.1f} s ({load_s:.1f} s generating and loading sqlite)")
    del small, small_cat, oracle
    t1 = time.perf_counter()
    scaling = scaling_bench.run_scaling(plain, SCALING_QIDS, SCALING_MESHES, TOOLS_RUNS, device,
                                        on_query=lambda q: counted.append(_GraphCounts(q)))
    cells = []
    for qid, per_mesh in scaling["queries"].items():
        for n, entry in per_mesh.items():
            if not entry["answer_equal"]:
                raise AssertionError(f"scaling_bench: Q{qid} over {n} shards differs")
            eff = entry["efficiency_vs_1_shard"]
            cells.append(f"Q{qid} n={n} {entry['median_ms']:.3f} ms "
                         f"{entry['rows_per_s'] / 1e6:.1f} Mrows/s"
                         + ("" if eff is None else f" eff {eff:.3f}"))
    log(f"tools: scaling_bench --sf {SF} --runs {TOOLS_RUNS} over {SCALING_MESHES} shards on one "
        f"device (no interconnect crossed), every answer equal to one shard's {card}: "
        + "; ".join(cells) + f"; {time.perf_counter() - t1:.1f} s; 15c took "
        f"{time.perf_counter() - t0:.1f} s")
    del plain
    freed()

    launches = graph_launches(before, wrappers, counted)
    log(f"indexes and tools: launches in phase 15 (graph replays counted) {launches}; phase 15 "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return launches


def indexes_and_tools_only_run(device, card, started: float) -> None:
    """`--indexes-and-tools`: phase 4's SF1 tables, then phase 15 (its eager
    answers with indexes stand in for phase 6's rows). Ends with one JSON
    line: phase 15's launches."""
    from hyrise_tpu_torch.kernels import (compact, fused_reduce, group_reduce, hash_lookup,
                                          join_probe, segment_reduce)
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.tpch.queries import TPCH_SQL
    from hyrise_tpu_torch.utils import table_eq

    wrappers = {"segment_reduce_cells": group_reduce.segment_reduce_cells,
                "lookup_last_eq_lut": join_probe.lookup_last_eq_lut,
                "expand_pairs": join_probe.expand_pairs,
                "fused_cells_reduce": fused_reduce.fused_cells_reduce,
                "segment_reduce_sorted": segment_reduce.segment_reduce_sorted,
                "lookup_last_eq": hash_lookup.lookup_last_eq,
                "compact_indices": compact.compact_indices,
                "compact_indices_cap": compact.compact_indices_cap,
                "expand_pairs_cap": join_probe.expand_pairs_cap}
    tables = dbgen.generate_tables(SF, SEED, device=device)
    reset_counts(wrappers)
    launches = indexes_and_tools_phase(device, card, tables, wrappers, table_eq, TPCH_SQL)
    for name in INDEX_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 15")
    log(f"elapsed: {time.perf_counter() - started:.1f} s, the build included")
    log(json.dumps({"indexes_and_tools_launches": launches}))


def compiled_only_run(device, card, started: float) -> None:
    """`--compiled`: phase 4's SF1 tables, the eager rows and walls of phase
    5's hand plans and phase 6's SQL texts that phase 12 compares with, then
    phase 12 (with `--kernels-from DIR`, another checkout's package). Ends
    with one JSON line: the busy ms and K9c's, K5c's and K3's nodes of one
    replay of each of the CAP_NODE_QIDS."""
    from hyrise_tpu_torch.kernels import (compact, fused_reduce, group_reduce, hash_lookup,
                                          join_probe, segment_reduce)
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL, run_query
    from hyrise_tpu_torch.utils import table_eq

    tables = dbgen.generate_tables(SF, SEED, device=device)
    cat = catalog_of(tables)
    results, wall, sql_rows = {}, {}, {}
    for qid in sorted(TPCH_PLANS):
        first, median, rows = timed_query(lambda: run_query(qid, cat).rows())
        results[qid], wall[qid] = rows, (first, median)
        sql_rows[qid] = SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(cat) \
            .create_pipeline().get_result_table().rows()
    log(f"main: SF{SF} eager wall ms (first / median of {QUERY_REPS}) {card}: "
        + "; ".join(f"Q{q} {wall[q][0]:.3f} / {wall[q][1]:.3f}" for q in sorted(wall)))
    wrappers = {"segment_reduce_cells": group_reduce.segment_reduce_cells,
                "lookup_last_eq_lut": join_probe.lookup_last_eq_lut,
                "expand_pairs": join_probe.expand_pairs,
                "fused_cells_reduce": fused_reduce.fused_cells_reduce,
                "segment_reduce_sorted": segment_reduce.segment_reduce_sorted,
                "lookup_last_eq": hash_lookup.lookup_last_eq,
                "compact_indices": compact.compact_indices,
                "compact_indices_cap": compact.compact_indices_cap,
                "expand_pairs_cap": join_probe.expand_pairs_cap}
    reset_counts(wrappers)
    launches, nodes = compiled_phase(device, card, tables, results, wall, sql_rows,
                                     wrappers, table_eq, TPCH_SQL)
    for name in COMPILED_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 12")
    log(f"elapsed: {time.perf_counter() - started:.1f} s, the build included")
    log(json.dumps({"compiled_replays": {
        f"Q{q}": {"busy_ms": busy, "K9c": c and c["K9c"], "K5c": c and c["K5c"],
                  "K3": c and c["K3"]}
        for q, (busy, c) in nodes.items()}}))


def compiled_streaming_only_run(device, card, started: float) -> None:
    """`--compiled-streaming`: phase 10's SF10 part (the tables generated on
    the card, the 22 streamed eagerly and resident), then phase 13. Ends
    with one JSON line: phase 13's launches."""
    from hyrise_tpu_torch.kernels import (compact, group_reduce, hash_lookup, join_probe,
                                          segment_reduce)
    from hyrise_tpu_torch.utils import table_eq

    wrappers = {"segment_reduce_cells": group_reduce.segment_reduce_cells,
                "lookup_last_eq_lut": join_probe.lookup_last_eq_lut,
                "expand_pairs": join_probe.expand_pairs,
                "segment_reduce_sorted": segment_reduce.segment_reduce_sorted,
                "lookup_last_eq": hash_lookup.lookup_last_eq,
                "compact_indices": compact.compact_indices,
                "compact_indices_cap": compact.compact_indices_cap,
                "expand_pairs_cap": join_probe.expand_pairs_cap}
    sf10 = streaming_sf10(device, card, table_eq)
    reset_counts(wrappers)
    launches = compiled_streaming_phase(device, card, sf10, table_eq, wrappers)
    log(f"elapsed: {time.perf_counter() - started:.1f} s, the build included")
    log(json.dumps({"compiled_streaming_launches": launches}))


def compiled_distribution_only_run(device, card, started: float) -> None:
    """`--compiled-distribution`: phase 4's SF1 tables and phase 6's SQL rows
    (kept on the host), phase 10's SF10 tables with their resident answers
    and medians, phase 11's shard_tpch and eager distributed runs, then
    phase 14. Ends with one JSON line: phase 14's launches."""
    from hyrise_tpu_torch.kernels import (compact, group_reduce, hash_lookup, join_probe,
                                          segment_reduce)
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.tpch.queries import TPCH_SQL
    from hyrise_tpu_torch.utils import table_eq

    wrappers = {"segment_reduce_cells": group_reduce.segment_reduce_cells,
                "lookup_last_eq_lut": join_probe.lookup_last_eq_lut,
                "expand_pairs": join_probe.expand_pairs,
                "segment_reduce_sorted": segment_reduce.segment_reduce_sorted,
                "lookup_last_eq": hash_lookup.lookup_last_eq,
                "compact_indices": compact.compact_indices,
                "compact_indices_cap": compact.compact_indices_cap,
                "expand_pairs_cap": join_probe.expand_pairs_cap}
    tables = dbgen.generate_tables(SF, SEED, device=device)
    sf1 = catalog_of(tables)
    sql_rows = {qid: SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(sf1).create_pipeline()
                .get_result_table().rows() for qid in sorted(TPCH_SQL)}
    sf1_tables = copy_to(tables, "cpu")
    del tables, sf1
    freed()
    sf10 = sf10_resident(device, card)
    dist = distribution_sf10(device, card, sf10, table_eq)
    reset_counts(wrappers)
    launches = compiled_distribution_phase(device, card, sf10, dist, sf1_tables, sql_rows,
                                           table_eq, wrappers)
    log(f"elapsed: {time.perf_counter() - started:.1f} s, the build included")
    log(json.dumps({"compiled_distribution_launches": launches}))


def cells_phase(device, card, group_reduce, fused_reduce, checked: bool) -> None:
    """`--cells`: K3 and K6 alone. With `checked` (this checkout's kernels)
    every check of phase 3 for them, then their timed shapes; without (the
    kernels of another checkout, `--kernels-from DIR`, for the same timings
    of an older form in the same run) the timed shapes only, each still held
    against its plain version. Ends with one JSON line of the times."""
    n = KERNEL_SIZES[-1]
    if checked:
        err = check_cells_edges(device, group_reduce, fused_reduce)
        check_cells_repeated(device, group_reduce, fused_reduce)
        err = max(err, check_k3_many(device, group_reduce))
        for size in KERNEL_SIZES:
            err = max(err, check_k3(size, device, group_reduce),
                      check_k6(size, device, fused_reduce))
        log(f"cells: K3 and K6 equal to plain at {CELLS_EDGE_SIZES} rows x "
            f"{CELLS_EDGE_COUNTS} cells and at {KERNEL_SIZES}, in {CELLS_REPEATS} launches "
            f"in a row, and bit-stable; K3 also as 1, 2, 6 and 18 slots in one call, from "
            f"aligned columns and views, a slot's bits the same alone, batched and split "
            f"(largest float64 difference {err!r})")
    cells, _ = time_cells(n, device, card, time_ms_of(), group_reduce, fused_reduce,
                          one_kernel=checked)
    log(json.dumps({"cells": {label: {
        "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
        "bound_ms": t["bound"], "kernel_only_ms": t["kernel_only"]["sum"],
        "kernels_a_call": t["per_call"]} for label, t in cells.items()}}))


# the sources `--kernels` builds for each kernel it takes (K8's plain version
# runs K9 on the card)
KERNEL_SOURCES = {"K2": ("q6_scan",), "K3": ("group_reduce",), "K8": ("hash_lookup", "compact"),
                  "K9c": ("compact",), "K5c": ("join_probe",)}


def kernels_phase(device, card, wanted, modules, time_ms, checked: bool) -> None:
    """`--kernels K2,K3,K8,K9c,K5c` (any of them): the named kernels alone
    (K3: check_k3_all, then time_cells without K6's rows). With
    `checked` (this checkout's kernels) every check of phase 3 for them,
    then their timed shapes; without (the kernels of another checkout,
    `--kernels-from DIR`, for the same timings of an older form in the same
    run) the timed shapes only, each still held against its plain version.
    Ends with one JSON line of the times."""
    q6, hash_lookup = modules.get("q6_scan"), modules.get("hash_lookup")
    timed = {}
    if "K9c" in wanted or "K5c" in wanted:
        timed, _ = cap_phase(device, card, time_ms, modules["compact"], modules["join_probe"],
                             checked)
    if "K3" in wanted:
        if checked:
            check_k3_all(device, modules["group_reduce"])
        k3_timed, _ = time_cells(KERNEL_SIZES[-1], device, card, time_ms,
                                 modules["group_reduce"], None, one_kernel=checked)
        timed.update(k3_timed)
    wanted = [k for k in wanted if k in ("K2", "K8")]
    if checked and wanted:
        for n in KERNEL_SIZES:
            if "K2" in wanted:
                same_k2(k2_columns(n, device), q6, f"n={n}")
            if "K8" in wanted:
                check_k8(n, device, hash_lookup)
        log(f"kernels: {' and '.join(wanted)} equal to plain at {KERNEL_SIZES}")
        if "K2" in wanted:
            log("kernels: " + check_k2_edges(device, q6))
        if "K8" in wanted:
            log("kernels: " + check_k8_edges(device, hash_lookup))
    if wanted:
        timed.update(time_k2_k8(KERNEL_SIZES[-1], device, card, time_ms, q6, hash_lookup,
                                checked, wanted))
    log(json.dumps({"kernels_timed": {label: {
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": t["bound"],
        "library_ms": t.get("library"), "exact_ms": t.get("exact"),
        "kernel_only_ms": t["kernel_only"], "kernels_a_call": t["per_call"]}
        for label, t in timed.items()}}))


def time_ms_of():
    from hyrise_tpu_torch import bench_q6
    return bench_q6.time_ms


def main() -> None:
    # -- 1. device ---------------------------------------------------------
    started = time.perf_counter()
    argv = sys.argv[1:]
    cells_only = "--cells" in argv
    compiled_only = "--compiled" in argv
    streaming_only = "--compiled-streaming" in argv
    distribution_only = "--compiled-distribution" in argv
    indexes_only = "--indexes-and-tools" in argv
    kernels = argv[argv.index("--kernels") + 1].split(",") if "--kernels" in argv else None
    if kernels is not None and not set(kernels) <= set(KERNEL_SOURCES):
        raise SystemExit(f"chip_smoke: --kernels takes {', '.join(KERNEL_SOURCES)}, got "
                         f"{kernels}")
    other = argv[argv.index("--kernels-from") + 1] if "--kernels-from" in argv else None
    if other is not None:
        sys.path.insert(0, other)  # that checkout's hyrise_tpu_torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    log(f"device: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    from hyrise_tpu_torch import bench_q6
    from hyrise_tpu_torch.kernels import (build, compact, fused_reduce, group_reduce,
                                          hash_lookup, join_probe, q6, segment_reduce)
    from hyrise_tpu_torch.kernels.fused import FusedFilterAggregate
    from hyrise_tpu_torch.ops.join import Join
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL, run_query
    from hyrise_tpu_torch.utils import table_eq
    from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    modules = {"q6_scan": q6, "group_reduce": group_reduce, "join_probe": join_probe,
               "fused_reduce": fused_reduce, "segment_reduce": segment_reduce,
               "hash_lookup": hash_lookup, "compact": compact}
    if kernels is None:
        build.build_all()
    else:  # only the sources of the kernels named
        modules = {s: modules[s] for k in kernels for s in KERNEL_SOURCES[k]}
    with ThreadPoolExecutor(max_workers=len(modules)) as pool:  # builds what is missing
        list(pool.map(lambda m: m._library(), modules.values()))
    sources = build.SOURCES if kernels is None else tuple(modules)
    log(f"build: {', '.join(f'{s}.cu' for s in sources)} with nvcc for sm_90a, "
        f"in parallel, in {time.perf_counter() - t0:.2f} s")
    for source in sources:
        text = build.build_log(source)
        registers = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for pair in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text) for b in pair]
        seconds = re.search(r"nvcc seconds: ([\d.]+)", text).group(1)
        log(f"build: {source}.cu: nvcc {seconds} s, {len(registers)} kernels, at most "
            f"{max(registers)} registers, {sum(spills)} bytes of spills (ptxas -v)")

    if kernels is not None:
        kernels_phase(device, card, kernels, modules, bench_q6.time_ms,
                      checked=other is None)
        log(f"elapsed: {time.perf_counter() - started:.1f} s, the build included")
        return
    if cells_only:
        cells_phase(device, card, group_reduce, fused_reduce, checked=other is None)
        log(f"elapsed: {time.perf_counter() - started:.1f} s, the build included")
        return
    if compiled_only:
        compiled_only_run(device, card, started)
        return
    if streaming_only:
        compiled_streaming_only_run(device, card, started)
        return
    if distribution_only:
        compiled_distribution_only_run(device, card, started)
        return
    if indexes_only:
        indexes_and_tools_only_run(device, card, started)
        return

    # -- 3. kernels against their plain versions -----------------------------
    k1_err = k2_err = k3_err = k4_err = k5_err = 0.0
    k6_err = k7_err = k8_err = k9_err = 0.0
    for n in KERNEL_SIZES:
        dense, enc, exact = kernel_inputs(n, device)
        args = (dense["ship"], dense["disc"], dense["qty"], dense["price"],
                dense["live"], 731, 1096)
        got, ref = float(q6.q6_scan(*args)), float(q6.q6_compute(*args))
        eargs = (enc["ship"], enc["disc_cents"], enc["qty"], enc["price_cents"],
                 731, 1096)
        total, plain_total = int(q6.q6_encoded(*eargs)), int(q6.q6_encoded_reference(*eargs))
        torch.cuda.synchronize()
        if not (np.isfinite(got) and rel_diff(got, ref) <= 1e-5):
            raise AssertionError(f"K1 q6_scan at n={n}: {got} vs q6_compute {ref}")
        if total != exact or plain_total != exact:
            raise AssertionError(f"K2 q6_encoded at n={n}: {total} "
                                 f"(plain {plain_total}) vs exact {exact}")
        k1_err = max(k1_err, abs(got - ref))
        k2_err = max(k2_err, float(abs(total - exact)))
        k3_err = max(k3_err, check_k3(n, device, group_reduce))
        k4_err = max(k4_err, check_k4(n, device, join_probe))
        pairs, err = check_k5(n, device, join_probe)
        k5_err = max(k5_err, err)
        shapes = ""
        if n in K5_REPEATED_SIZES:
            k4_err = max(k4_err, check_k4_shapes(n, device, join_probe))
            k5_err = max(k5_err, check_k5_shapes(n, device, join_probe))
            shapes = (f"; K4 also equal and bit-stable in {K4_SHAPES}; K5 also equal in "
                      f"{K5_REPEATS} launches in a row, with all ranges empty but 5, as one "
                      f"range over the build side, as triangular ranges, as one range of "
                      f"150,000 pairs, at totals of 0, 1, one output tile and one more, at "
                      f"range counts around the scan's tile, from views, and the "
                      f"{len(K5_BAD_RANGES)} bad ranges {tuple(K5_BAD_RANGES)} raise")
        log(f"kernels n={n}: K1 {got!r} vs plain {ref!r} "
            f"(rel {rel_diff(got, ref):.3e}); K2 {total} == exact {exact}; "
            f"K3 equal to plain in 13 reductions x {len(K3_CELLS)} cell counts, and bit-stable; "
            f"K4 equal and bit-stable; K5 equal over {pairs} pairs{shapes}")
        k6_err = max(k6_err, check_k6(n, device, fused_reduce))
        k7_err = max(k7_err, check_k7(n, device, segment_reduce))
        k8_err = max(k8_err, check_k8(n, device, hash_lookup))
        k9_err = max(k9_err, check_k9(n, device, compact))
        log(f"kernels n={n}: K6 equal to plain in 4 shapes (1, 1, 2 and 6 launches) and "
            f"bit-stable; K7 equal to plain in 13 reductions x {len(K7_SHAPES)} shapes "
            f"{K7_SHAPES} x with/without rows and validity, and bit-stable; K8 equal on "
            f"int64 and float64 keys, with a hot key and on an empty build side; K9 equal "
            f"at {len(K9_SHARES)} selectivities, aligned and not"
            + (f", and in {K9_REPEATS} launches in a row" if n in K9_REPEATED_SIZES else ""))
    err = check_cells_edges(device, group_reduce, fused_reduce)
    k3_err, k6_err = max(k3_err, err), max(k6_err, err)
    check_cells_repeated(device, group_reduce, fused_reduce)
    k3_err = max(k3_err, check_k3_many(device, group_reduce))
    log(f"kernels: K3 and K6 equal to plain at {CELLS_EDGE_SIZES} rows x "
        f"{CELLS_EDGE_COUNTS} cells (four types, four folds, NaN and +-inf in min and "
        f"max, columns one element into their buffers) and in {CELLS_REPEATS} launches "
        f"in a row at changing lengths up to {CELLS_REPEAT_ROWS} rows; K3 also as 1, 2, 6 "
        f"and 18 slots in one launch from aligned columns and views, split over launches "
        f"by plan_launches, a slot's bits the same alone, batched and split")
    log("kernels: " + check_k2_edges(device, q6))
    log("kernels: " + check_k8_edges(device, hash_lookup))
    # timed at the largest n, in turns: plain, kernel, kernel, plain
    n = KERNEL_SIZES[-1]
    k1_fn = lambda i: q6.q6_scan(*args[:5], 731 - i, 1096)  # noqa: E731
    k1_plain = lambda i: q6.q6_compute(*args[:5], 731 - i, 1096)  # noqa: E731
    ms = turns((("k1_plain", k1_plain), ("k1", k1_fn), ("k1", k1_fn),
                ("k1_plain", k1_plain)), device, bench_q6.time_ms)
    log(f"kernels n={n} median device ms (CUDA events, L2 flushed) {card}: "
        f"K1 q6_scan {ms['k1']:.4f} vs plain q6_compute {ms['k1_plain']:.4f}; "
        f"effective {n * 17 / ms['k1'] / 1e6:.1f} GB/s")
    # K2 and K8 with their own device time
    k2_k8 = time_k2_k8(n, device, card, bench_q6.time_ms, q6, hash_lookup, checked=True)

    # K3 and K6 at the main path's shapes, beside their plain versions and
    # yardsticks, with their own device time
    cells, cells_err = time_cells(n, device, card, bench_q6.time_ms, group_reduce,
                                  fused_reduce, one_kernel=True)
    k3_err, k6_err = max(k3_err, cells_err), max(k6_err, cells_err)
    k3 = cells["K3 f32x6"]
    k4_args = k4_inputs(n, device)
    k5_args = k5_inputs(n, device)
    k5_total = int(k5_args[1].sum())
    jm = turns((("k4_plain", lambda i: join_probe.lookup_last_eq_lut_plain(*k4_args)),
                ("k4", lambda i: join_probe.lookup_last_eq_lut(*k4_args)),
                ("k4", lambda i: join_probe.lookup_last_eq_lut(*k4_args)),
                ("k4_plain", lambda i: join_probe.lookup_last_eq_lut_plain(*k4_args)),
                ("k5_plain", lambda i: join_probe.expand_pairs_plain(*k5_args)),
                ("k5", lambda i: join_probe.expand_pairs(*k5_args)),
                ("k5", lambda i: join_probe.expand_pairs(*k5_args)),
                ("k5_plain", lambda i: join_probe.expand_pairs_plain(*k5_args))),
               device, bench_q6.time_ms)
    nb4 = k4_args[0].shape[0]
    # each input read once, each output written once (the table is scratch)
    k4_bytes = nb4 * (8 + 1) + n * 8 + n * (1 + 8)
    k5_bytes = n * (4 + 4) + k5_args[2].shape[0] * 8 + k5_total * 16
    k4_bound = k4_bytes / PEAK_BYTES_PER_S * 1e3
    k5_bound = k5_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"kernels n={n} median device ms {card}: K4 lookup_last_eq_lut ({nb4} build "
        f"rows, {n} probes, {k4_args[4] - k4_args[3] + 1} table entries) {jm['k4']:.4f} "
        f"vs plain {jm['k4_plain']:.4f}, bound {k4_bound:.4f}; K5 expand_pairs ({n} "
        f"ranges, {k5_total} pairs, scan and range check included) {jm['k5']:.4f} vs "
        f"plain {jm['k5_plain']:.4f}, bound {k5_bound:.4f}")
    time_k4_k5_more(n, device, card, bench_q6.time_ms, join_probe, k4_args, k5_args)

    new, new_err = time_k7_k9(n, device, card, bench_q6.time_ms, segment_reduce, compact)
    k7_err = max(k7_err, new_err)
    cap_timed, (k9c_err, k5c_err) = cap_phase(device, card, bench_q6.time_ms, compact,
                                              join_probe, checked=True)

    # -- 4. data -----------------------------------------------------------
    t0 = time.perf_counter()
    tables = dbgen.generate_tables(SF, SEED, device=device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    total_bytes = 0
    for name, t in tables.items():
        for c in t.columns:
            if c.data.device != device:
                raise AssertionError(f"{name}.{c.name} is on {c.data.device}")
            total_bytes += c.data.numel() * c.data.element_size()
        log(f"data: {name} {t.num_rows} rows, {len(t.columns)} columns on {t.device}")
    log(f"data: SF{SF} generated and uploaded in {gen_s:.1f} s, "
        f"{total_bytes / 1e6:.1f} MB of column tensors on {device}")
    cat = catalog_of(tables)

    # -- 5. main path --------------------------------------------------------
    # 5a. every query on the card at a small scale against sqlite
    small_rows = {}
    t0 = time.perf_counter()
    for sf in sorted({SMALL_SF, *SMALL_SF_OF.values()}):
        qids = [q for q in sorted(TPCH_PLANS) if SMALL_SF_OF.get(q, SMALL_SF) == sf]
        small = dbgen.generate_tables(sf, SEED, device=device)
        oracle = SqliteOracle(small)
        for ddl in ("CREATE INDEX idx_l_ok ON lineitem(l_orderkey)",
                    "CREATE INDEX idx_l_pk ON lineitem(l_partkey)",
                    "CREATE INDEX idx_l_ps ON lineitem(l_partkey, l_suppkey)",
                    "CREATE INDEX idx_o_ck ON orders(o_custkey)",
                    "CREATE INDEX idx_o_ok ON orders(o_orderkey)",
                    "CREATE INDEX idx_ps_pk ON partsupp(ps_partkey)"):
            oracle.conn.execute(ddl)
        small_cat = catalog_of(small)
        for qid in qids:
            out = run_query(qid, small_cat)
            if out.device != device:
                raise AssertionError(f"Q{qid} at SF{sf} came out on {out.device}")
            rows = out.rows()
            want = oracle.query(TPCH_SQL[qid])
            check_rows(rows, want, f"Q{qid} at SF{sf} vs sqlite", table_eq)
            small_rows[qid] = len(rows)
            # phase 6, first part: the same text through the SQL pipeline
            out = SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(small_cat) \
                .create_pipeline().get_result_table()
            if out.device != device:
                raise AssertionError(f"SQL Q{qid} at SF{sf} came out on {out.device}")
            check_rows(out.rows(), want, f"SQL Q{qid} at SF{sf} vs sqlite", table_eq)
        oracle.close()
    log(f"main: all {len(small_rows)} queries on {device} match sqlite at SF{SMALL_SF} "
        f"(Q20 at SF{SMALL_SF_OF[20]}): ints and strings equal, floats within 1e-6 "
        f"relative; rows {small_rows}; {time.perf_counter() - t0:.1f} s")
    log(f"sql: all {len(small_rows)} TPC-H texts through SQLPipelineBuilder on {device} "
        f"match sqlite at the same scale factors and tolerance")

    # 5b. every query at SF1, the launch counts starting from 0
    wrappers = {"q6_scan": q6.q6_scan, "q6_encoded": q6.q6_encoded,
                "segment_reduce_cells": group_reduce.segment_reduce_cells,
                "lookup_last_eq_lut": join_probe.lookup_last_eq_lut,
                "expand_pairs": join_probe.expand_pairs,
                "fused_cells_reduce": fused_reduce.fused_cells_reduce,
                "segment_reduce_sorted": segment_reduce.segment_reduce_sorted,
                "lookup_last_eq": hash_lookup.lookup_last_eq,
                "compact_indices": compact.compact_indices}
    sql_kernels = ("fused_cells_reduce", "segment_reduce_sorted", "lookup_last_eq",
                   "compact_indices")
    reset_counts(wrappers)
    specs, _ = dbgen.generate_specs(SF, SEED)["lineitem"]
    li = {name: payload for name, _, payload in specs}
    pool = li["l_shipdate"][1]
    results, wall = {}, {}
    for qid in sorted(TPCH_PLANS):
        first, median, rows = timed_query(lambda: run_query(qid, cat).rows())
        check_finite(rows, f"Q{qid} at SF{SF}")
        if small_rows[qid] and not rows:
            raise AssertionError(f"Q{qid} at SF{SF} returned no rows")
        results[qid], wall[qid] = rows, (first, median)
    log(f"main: SF{SF} wall ms (host clock, to rows on the host; first run, then "
        f"median of {QUERY_REPS}) {card}: "
        + "; ".join(f"Q{q} {wall[q][0]:.3f} / {wall[q][1]:.3f} ({len(results[q])} rows)"
                    for q in sorted(wall)))
    log(f"main: SF{SF} all 22 queries, sum of medians "
        f"{sum(m for _, m in wall.values()):.3f} ms {card}")

    expected6 = q6_oracle(li, pool)
    if len(results[6]) != 1:
        raise AssertionError(f"Q6 result {results[6]}")
    dag_revenue = float(results[6][0][0])
    if rel_diff(dag_revenue, expected6) > 1e-6:
        raise AssertionError(f"Q6 DAG {dag_revenue} vs numpy oracle {expected6}")
    log(f"main: Q6 DAG revenue {dag_revenue!r} vs oracle {expected6!r} "
        f"(rel {rel_diff(dag_revenue, expected6):.3e})")
    worst = check_q1(results[1], q1_oracle(li, pool))
    log(f"main: Q1 {len(results[1])} groups match the numpy oracle "
        f"(keys and counts equal, floats within {worst:.3e} relative)")

    t0 = time.perf_counter()
    cpu_cat = catalog_of(copy_to(tables, "cpu"))
    before = {name: w.launches for name, w in wrappers.items()}
    for qid in CPU_CHECKED:
        check_rows(results[qid], run_query(qid, cpu_cat).rows(),
                   f"Q{qid} at SF{SF}, card vs CPU tensors", table_eq)
    if before != {name: w.launches for name, w in wrappers.items()}:
        raise AssertionError("a plan over CPU tensors launched a kernel")
    log(f"main: Q{', Q'.join(map(str, CPU_CHECKED))} at SF{SF} equal to the same plans "
        f"over CPU tensors (floats within 1e-6 relative) in "
        f"{time.perf_counter() - t0:.1f} s")

    qcols = bench_q6.prepare(li, device)
    bench = bench_q6.run(qcols)
    if rel_diff(bench["revenue_f32"], dag_revenue) > 1e-6:
        raise AssertionError(f"K1 revenue {bench['revenue_f32']} vs DAG {dag_revenue}")
    log(f"main: bench_q6 SF{SF} {card}: K1 revenue {bench['revenue_f32']!r} "
        f"(DAG {dag_revenue!r}), K2 exact {bench['revenue_encoded']!r}; "
        f"K1 {bench['q6_f32_ms']:.4f} ms ({bench['f32_gb_per_s']:.1f} GB/s), "
        f"K2 {bench['q6_encoded_ms']:.4f} ms ({bench['encoded_gb_per_s']:.1f} GB/s)")

    launches = {name: w.launches for name, w in wrappers.items()}
    for name, count in launches.items():
        if count <= 0 and name not in sql_kernels:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log(f"main: launches on the main path {launches}")
    log(f"main: mean rows per launch on the main path: {rows_per_launch(wrappers)}")

    # -- 6. the SQL entry point ----------------------------------------------
    sql_launches, sql_wall, sql_rows = sql_phase(device, card, cat, results, wall, wrappers,
                                       sql_kernels, table_eq, SQLPipelineBuilder,
                                       FusedFilterAggregate, SqliteOracle, TPCH_SQL)
    launches.update({name: sql_launches[name] for name in sql_kernels})

    # -- 7. writes: MVCC, RF1 and RF2, transactions ----------------------------
    dml_launches = dml_phase(device, card, cat, tables, results, sql_wall, wrappers,
                             table_eq, SQLPipelineBuilder, Join, SqliteOracle, TPCH_SQL,
                             bench_q6.time_ms)
    for name in DML_KERNELS:
        if dml_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 7")

    # -- 8. physical design: encodings, block statistics, indexes -------------
    physical_launches = physical_phase(device, card, tables, results, wrappers, table_eq,
                                       SQLPipelineBuilder, TPCH_SQL, bench_q6.time_ms)
    for name in PHYSICAL_KERNELS:
        if physical_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 8")

    # -- 9. front ends: the wire server, the scheduler, the console -------------
    front_launches = front_end_phase(device, card, tables, results, wall, sql_rows,
                                     sql_wall, wrappers, table_eq, TPCH_SQL)
    for name, count in front_launches.items():
        launches[name] += count

    # -- 12. whole-plan compiled execution: the plans as CUDA graphs ---------
    wrappers.update(compact_indices_cap=compact.compact_indices_cap,
                    expand_pairs_cap=join_probe.expand_pairs_cap)
    reset_counts(wrappers)
    compiled_launches, _ = compiled_phase(device, card, tables, results, wall, sql_rows,
                                          wrappers, table_eq, TPCH_SQL)
    for name in COMPILED_KERNELS:
        if compiled_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 12")
    for name, count in compiled_launches.items():
        launches[name] = launches.get(name, 0) + count

    # -- 15. indexes compiled and over shards; the measurement tools ----------
    reset_counts(wrappers)
    index_launches = indexes_and_tools_phase(device, card, tables, wrappers, table_eq, TPCH_SQL,
                                             sql_rows)
    for name in INDEX_KERNELS:
        if index_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 15")
    for name, count in index_launches.items():
        launches[name] = launches.get(name, 0) + count

    # -- 10. streaming: blocked and segmented execution at SF1 and SF10 --------
    reset_counts(wrappers)
    t0 = time.perf_counter()
    # on phase 4's tables as generated: phase 7 wrote into the catalog's
    log("streaming: " + streaming_sf1(device, catalog_of(plain_copies(tables)), results,
                                      table_eq))
    del tables, cat, qcols  # the SF1 tables leave the card before SF10's come
    torch.cuda.empty_cache()
    sf10 = streaming_sf10(device, card, table_eq)
    stream_launches = {name: w.launches for name, w in wrappers.items()}
    for name in STREAM_KERNELS:
        if stream_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 10")
    log(f"streaming: launches in phase 10 {stream_launches}")
    log(f"streaming: phase 10 took {time.perf_counter() - t0:.1f} s")
    for name, count in stream_launches.items():
        launches[name] += count

    # -- 13. compiled streaming: SF10 through captured block programs ---------
    reset_counts(wrappers)
    for name, count in compiled_streaming_phase(device, card, sf10, table_eq,
                                                wrappers).items():
        launches[name] += count

    # -- 11. distribution: SF10 over four shards on the card, a process group --
    reset_counts(wrappers)
    sf1_tables = {name: cpu_cat.get_table(name) for name in cpu_cat.table_names()}
    dist = distribution_phase(device, card, sf10, sf1_tables, sql_rows, table_eq)
    dist_launches = {name: w.launches for name, w in wrappers.items()}
    for name in DIST_KERNELS:
        if dist_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 11")
    log(f"distribution: launches in phase 11 {dist_launches}")
    for name, count in dist_launches.items():
        launches[name] += count

    # -- 14. compiled distribution: the sharded plans as captured graphs ------
    reset_counts(wrappers)
    for name, count in compiled_distribution_phase(device, card, sf10, dist, sf1_tables,
                                                   sql_rows, table_eq, wrappers).items():
        launches[name] += count
    del dist

    csrc = "hyrise_tpu_torch/kernels/csrc/"

    def entry(name, source, replaces, err, t, plain, bound, library=None):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                "ms": t, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": library}

    def new_entry(name, source, replaces, err, t):
        return entry(name, source, replaces, err, t["kernel"], t["plain"], t["bound"],
                     t["library"])

    log(f"elapsed: {time.perf_counter() - started:.1f} s, the build included")
    log(json.dumps({"kernels": [
        entry("q6_scan", "q6_scan.cu", "hyrise_tpu/kernels/pallas_scan.py:29",
              k1_err, ms["k1"], ms["k1_plain"], n * 17 / PEAK_BYTES_PER_S * 1e3),
        new_entry("q6_encoded", "q6_scan.cu", "hyrise_tpu/kernels/q6.py:87", k2_err,
                  k2_k8["K2"]),
        entry("segment_reduce_cells", "group_reduce.cu",
              "hyrise_tpu/kernels/tpu_prims.py:470", k3_err, k3["kernel"], k3["plain"],
              k3["bound"], k3["library"]),
        entry("lookup_last_eq_lut", "join_probe.cu",
              "hyrise_tpu/kernels/tpu_prims.py:354", k4_err, jm["k4"], jm["k4_plain"],
              k4_bound),
        entry("expand_pairs", "join_probe.cu", "hyrise_tpu/ops/join.py:140", k5_err,
              jm["k5"], jm["k5_plain"], k5_bound),
        new_entry("fused_cells_reduce", "fused_reduce.cu",
                  "hyrise_tpu/kernels/fused.py:101", k6_err, cells["K6 q1"]),
        new_entry("segment_reduce_sorted", "segment_reduce.cu",
                  "hyrise_tpu/kernels/tpu_prims.py:494", k7_err, new["K7 4 rows a group"]),
        new_entry("lookup_last_eq", "hash_lookup.cu",
                  "hyrise_tpu/kernels/tpu_prims.py:383", k8_err, k2_k8["K8"]),
        new_entry("compact_indices", "compact.cu",
                  "hyrise_tpu/kernels/tpu_prims.py:144", k9_err, new["K9 share 0.5"]),
        new_entry("compact_indices_cap", "compact.cu",
                  "hyrise_tpu/kernels/tpu_prims.py:144", k9c_err, cap_timed["K9c share 0.5"]),
        new_entry("expand_pairs_cap", "join_probe.cu", "hyrise_tpu/ops/join.py:140",
                  k5c_err, cap_timed["K5c"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
