#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``reflow_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing its own lines:

1. **Device** — the card's name and power limit; TF32 off for matmul and
   cuDNN (the port's float32 scoring must stay float32).
2. **Build** — ``reflow_tpu_torch/csrc/topk.cu`` and ``scan_score.cu``
   compiled by ``nvcc`` for ``sm_90a`` into the git-ignored
   ``reflow_tpu_torch/_build/``.
3. **Kernels vs their plain versions** — each kernel entry's wrapper
   (``topk``, and the scan step ``topk_merge``) on card tensors at the
   shapes the main path gives it (and at edge shapes), held to exact
   equality with the plain PyTorch version; the scan's scoring kernel
   (``scan_scores``: a corpus chunk's float32 scores, int8 or bf16 docs)
   held to its plain version within ``SCAN_TOL`` (float32 sums in
   another order) at the main shape and at ragged ones, its dequantized
   operands to ``score_form``'s bit for bit (one-hot queries), a launch
   repeated bit for bit; device times (from a
   ``torch.profiler`` trace) and CUDA-event times of each entry, warm
   (back to back, input in L2) and cold (L2 flushed by a 64 MB write
   between calls, the flush left out of both), beside the plain
   version's and the one-call library yardstick's (``torch.topk``; for
   the scoring kernel ``torch.matmul`` of the bf16 operands, which the
   port never calls: it rounds its output to bf16), and the scoring
   kernel's time over the corpus's chunks in turn, as a rescan reads
   them. The cases include the sharded k-NN's shapes (phase 18): the
   ring merge's [256, 32] and an incremental tick's [256, 16 + 8192];
   the first is timed too.
4. **Serving slice at full width** — the k-NN re-index workload
   (BASELINE.md config 4: 256 queries, a 2^20-id corpus of 768-dim int8
   embeddings, k = 16, scan chunk 8192) served through
   ``IngestFrontend`` -> ``DirtyScheduler`` -> the ``cuda`` executor:
   queries, a device-made corpus preload, then host insert batches
   (incremental ticks), a retraction batch and a query update (full
   rescans), every ticket ``applied``; then one more insert tick and one
   more retraction tick under ``torch.profiler`` (device-busy share of
   the tick, top device operations, longest idle gaps, host op counts).
   The table is checked against a brute-force top-k over the same
   corpus, and the kernel launch counts (zeroed just before the path,
   read just after) prove the path ran through the kernels: one ``topk``
   per incremental tick, one ``scan_scores`` and one ``topk_merge`` per
   corpus chunk of a rescan tick. The frontend runs at its default depth 2 with device-keyed
   admission: every host-batch tick is one window staged through the
   ingress queue (``stage_window``/``dispatch_staged``/``retire_staged``),
   the device-made preload runs tick by tick; printed: the
   window counters, the queues' generations and bytes, and the forced
   syncs of each window (one: the lowering's path choice).
5. **PageRank at full width, host-driven loop** — incremental PageRank
   (BASELINE.md config 3: 100k nodes, 1M edges, 1% churn, tol 1e-4,
   seed 7) through ``DirtyScheduler`` -> the ``cuda`` executor (no
   device argument, ``fixpoint=False``) -> the row lowerings (Join with
   its edge arena, GroupBy, Map, Union, the linear Reduce), the
   scheduler driving the fixpoint passes: the full
   initial tick, 8 timed churn ticks and one traced (device-busy share,
   top device ops, idle gaps, host op counts, and device time and ops
   by composition from the lowerings' ``reflow::`` profiler ranges).
   Printed: ms and passes per tick, the churn median, delta-ops/s,
   incremental-vs-full, forced syncs, the arena's ``rcount`` and ``gen``,
   peak device memory. The ranks are checked against the float64 power
   iteration over the final edge set (``max|rank - ref| / max(ref, 1)``
   <= 1e-3), and the final arena is compacted on the card and on the CPU
   (bit-identical).
6. **PageRank at full width, the fused loop** — the executor's default
   path for this graph (``executors/linear_fixpoint.py``, asserted by
   the program's type): the initial tick, 16 churn ticks and one traced.
   Printed per tick: ms, passes, readbacks (held to passes + 3), the CSR
   rebuild cause or "kept", the tail rows, the tier of every pass; the
   rebuilds by cause (the first tick's, a tail overflow and a ``gen``
   bump must all occur), the sticky error flag (must stay clear), peak
   device memory, the error bound of phase 5, the traced tick's device
   time and ops by ``reflow::linear.*`` range, and a full CSR rebuild
   and a tail build timed alone on the final arena. Then two short legs
   at the same width: the row program (``linear_fixpoint=False``, the
   initial tick and 2 churn ticks, same bound) and ``defer_passes=1``
   (8 streamed churn ticks of one pass each, the amortized tick time,
   the mid-stream error, and the drained error, bound 1e-3).

7. **Word-count at full width** (BASELINE.md config 1): 100,000 lines
   from 5,000 words (``default_rng(0)``, 5-14 words a line) as vocabulary
   keys into a key space of 8192, ten ticks of 10,000 lines and a
   retraction tick of the first 10,000, then one traced tick putting them
   back; the sink's view and the Reduce's table equal a host ``Counter``
   exactly after both. Printed: tick ms and median, delta-ops/s, the
   traced tick's device-busy share and compositions.
8. **Streaming TF-IDF at full width** (config 2): 4,096 docs, 2^20 terms
   and pairs, a 250,000-word vocabulary (``default_rng(1)``); 2,048 docs
   loaded, 512 single edits padded to 256 rows in one ``tick_many``
   window, 32 ticks of 64 edits padded to 8,192 rows in another, one
   traced batched tick; every call one window (no fallback) with no
   forced sync or loop read between the stage and ``block()``. A twin
   scheduler takes the same feeds through per-tick ``tick()``s and its
   tables equal the window's exactly. The ``tf``/``df``/``ndocs`` tables
   equal the counts recomputed from the corpus exactly, and the combined
   TF-IDF is within 1e-5 relative of ``Corpus.reference_tfidf``.
   Printed: amortized tick ms of both paths and delta-ops/s (pad rows
   left out) of both phases.
9. **Incremental SSSP** (100,000 nodes, 1,000,000 uniform edges, weights
   1-9, ``default_rng(7)``, source 0, 32 candidates a key): the initial
   tick, 4 insertion and 4 deletion ticks of 10,000 edges (the last
   traced), each table equal to Bellman-Ford exactly with the sticky
   flags clear and readbacks held to the row program's count; a tick
   that reaches the 256-pass cap is repaired through ``affected_set`` and
   ``repair``. Then the repair leg: a deletion tick of 1,024 edges under
   a loop cap of 1 pass must halt, and ``affected_set`` + ``repair``
   (the cap back at 256) bring the table back to Bellman-Ford exactly
   (at least one repair). Then ``refresh_minmax`` over 1,024 keys from a
   host replay of their live candidates must leave the table and the
   error flag as they were. Printed: ms, passes and readbacks a tick,
   the repair's ms and passes, peak memory.
10. **The multiset-left Join**: two multiset sources over 2^20 keys, the
   default merge, a sink; 1,048,576 rows a side in batches of 65,536,
   then 8 churn ticks of 8,192 retractions and 8,192 inserts a side (the
   last traced). Each arena compacts once; the sink's view equals a numpy
   join of the final collections exactly; a tick reads back once a side
   appended. Printed: tick ms, pairs a tick.
11. **Image-embed ETL at full width** (BASELINE.md config 5): ViT-B/16
   with ``init_vit(0)`` weights as the embed Map's ``params``, 256
   images a tick, 2^14 image ids, 64 groups, ``ImageStream`` seed 5,
   through ``DirtyScheduler`` -> the ``cuda`` executor -> the Map
   ``params`` lowering (the ViT forward: cuBLAS bf16 GEMMs with float32
   output, float32 attention) -> GroupBy -> the ``mean`` Reduce. First
   ``_dot`` and ``vit_forward`` are held to their plain versions on the
   card (the real weights, 32 images). Then a warm-up tick, 4 upload
   ticks (host images, feeds built before the clock), 4 ticks of images
   made on the card and pushed as a ``DeviceDelta``, a group move (image
   0 to group 2), an ``update_params`` swap to ``init_vit(1)`` and a tick
   (the centroids must change; no rebind), one traced tick of each leg
   (device-busy share, top device ops, the bf16 GEMMs, the float32
   attention products and the elementwise rest apart, device time by the
   launching op, idle gaps, host op counts). The
   centroid table is held to float64 group means of the plain forward's
   features for every live image, each under the weights it was
   embedded with. Printed: median tick ms and images/s of each leg, MB
   uploaded a tick, model TFLOP/s (``vit_flops`` x images/s), MFU against
   the H100's dense bf16 peak, peak device memory. Then the window leg:
   ``tick_many`` windows of 4 ticks x 256 host images (one warm, two
   timed, one traced), and the pump leg: 8 batches through
   ``IngestFrontend`` at depth 2 (two windows, the second staged while
   the first runs), printed beside the per-tick legs: the amortized
   tick, images/s, MFU and the MB staged a window.
12. **Window parity on the card**: the reference's depth-fuzz graph
   (source -> map -> sum Reduce, small-integer values: every sum exact)
   with 16 batches of 8,192 different rows through ``IngestFrontend`` at
   depths 1, 2 and 4 and windows of 2 and 4 ticks, three rounds with the
   depth order reversed every other round and the median time of each
   depth printed (the window counts, ``windows_pipelined`` and the tables
   checked; every table equals the CPU oracle's); then 4 churn ticks of
   PageRank at config 3's width in one ``tick_many`` on the fused loop,
   the per-tick iters and converged flags as [4] device stacks (host
   values re-uploaded, read back at ``block()``), readbacks held to
   iters + 3 a tick, the ranks within 1e-3 of the float64 reference.
13. **Durable ingestion at full width**, under a ``tempfile.mkdtemp()``
   directory (removed at the end; its filesystem printed beside every
   WAL and checkpoint time). The k-NN leg: config 4 through
   ``IngestFrontend(depth=2, admission="device")`` over
   ``DurableScheduler(fsync="tick", committer="thread")`` beside a
   non-durable twin fed the same host batches in turns: the queries, a
   15 x 65,536-doc preload of random int8 rows, a full
   ``save_checkpoint`` (the covered segments truncated), 5 inserts of
   8,192 docs, a retraction and a query update, every ticket ``applied``
   with an LSN and ``log_readbacks`` 0. The last window dies at the
   ``after_append`` seam; a fresh executor and scheduler ``recover`` from
   checkpoint plus tail, tick the logged window, and take the upstream's
   resend of every batch (all ``deduped``). The table must equal the
   twin's exactly (ids and scores above ``NEG``) and brute force under
   phase 4's limits; the top-k launches are counted tick by tick, live
   and in the replay. Printed: tick ms with the WAL and the twin's, MB
   logged a tick, the WAL's append and fsync p50, checkpoint save ms and
   MB, restore, recover and replay ms, the first tick after recovery.
   The PageRank leg, twice (the second with the chain's final delta
   torn): config 3 on the fused loop through a durable scheduler with a
   ``CheckpointChain`` (a full element after the initial tick, a delta
   after each of 6 churn ticks), killed at ``before_tick_mark`` on churn
   tick 7, recovered from chain plus tail, the resent batch deduped, and
   2 more churn ticks: the first restored tick rebuilds its CSR, every
   tick reads back passes + 3 times, the ranks are within 1e-3 of the
   float64 reference and within ``DURABLE_TWIN_BOUND`` of an uncrashed
   twin; the join's edge arena (keys, values, weights, row count,
   generation, overflow flag) equals the twin's exactly, as restored at
   the checkpoint tick and again after the last tick. Printed: element bytes and save ms, restore and replay ms, the
   post-recovery ticks.

14. **Replication at full width** — config 4's k-NN (phase 13's leader
   setup, with a sink ``nn`` on the index for the read tier, which keeps
   each window on the per-tick path) through ``IngestFrontend`` at depth
   2 over ``DurableScheduler(fsync="tick", committer="thread")``, a
   ``SegmentShipper`` and two ``ReplicaScheduler`` followers, each on a
   ``cuda`` executor of its own: ``r0`` from segment 0 (attached before
   the preload, shipped by ``pump_once`` on the main thread through the
   head), ``r1`` bootstrapped from the leader's full checkpoint after the
   preload; then a tail of 8 inserts, 2 retractions of whole inserted
   batches and 2 query updates shipped by the shipper's thread
   (``start()``). After every leader tick each follower that reached it
   holds the leader's table bit for bit and its sink view. Reads through
   ``ReadTier`` at the leader's tick, and ``StaleRead`` above every
   replica; ``r0`` restarted mid-tail on a fresh executor from its own
   checkpoint; ``WalCompactor`` folds the tail (the retracted rows gone),
   ``recover`` from checkpoint plus folded log equals the leader, and
   ``r1``, detached inside the folded range, re-anchors through the
   checkpoint; the leader stops, ``FailoverCoordinator`` promotes a
   follower at epoch 1 onto a fresh ``cuda`` executor, the old leader's
   append raises ``FencedWrite`` and a shipment of its epoch changes no
   mirror byte, and after an insert and a query update the survivor and
   the new leader equal a non-replicated twin. Printed: ship lag in ticks
   and ms, MB shipped, apply ms a window, bootstrap ms and MB, read p50
   and p95, compaction ms, records and bytes, the fold's and the
   snapshot walk's host loops alone, failover ms by part and the time to
   the first acknowledged write, and the launches by path.

15. **The serving tier and the wire** — one ``ServeTier(pump_threads=2)``
   on the card hosting four tenants: ``knn`` (config 4 at full width over
   ``DurableScheduler(fsync="tick", committer="thread")``, window depth 2,
   device-keyed admission), ``pagerank`` (config 3 on the fused loop: the
   initial batches and 4 churn ticks, from a producer thread of its own
   while the k-NN preload runs), and ``wc_hot`` / ``wc_quiet`` (word-count
   over 1,000 words) under a ``ControlPlane`` with
   ``bench_configs.control_scenario``'s numbers. The k-NN tenant takes the
   queries, phase 13's 15 x 65,536-doc preload and 3 inserts in process,
   then 5 inserts, a retraction and a query update from a
   ``RemoteProducer`` over ``TcpTransport`` (127.0.0.1) to an
   ``RpcIngestServer`` on its handle; the fifth insert's ack is lost on the
   link (``FaultyTransport``, ``drop_s2c``), and the producer's resubmit of
   the same ``batch_id`` resolves ``deduped``. A ``SegmentShipper`` on its
   log feeds a ``RemoteFollower`` over TCP to a ``ReplicaServer`` in front
   of a ``ReplicaScheduler`` on a ``cuda`` executor of its own. After
   every acknowledged tick the tenant's table equals, bit for bit, a twin
   that ticks the same batches in process, and the follower's table equals
   the leader's at that horizon. PageRank's ranks are within 1e-3 of the
   float64 reference. Three paced hammers surge ``wc_hot`` while
   ``wc_quiet`` submits 60 batches: ``wc_hot`` steps down the brownout
   ladder and back within rungs x recover intervals + 12, ``wc_quiet``
   stays at level 0 with its admission p99 at or under 50 ms. Then a crash
   storm through ``pool_window@wc_hot``: the breaker goes open,
   half-open, closed; both word-count tenants equal the CPU oracle fed
   every batch whose ticket applied. The top-k launches are counted by
   path as each executor's calls make them (``tier``: the pool threads on
   the leader; ``tier_replica``: the follower's replay; ``twin``) and held
   to the prediction. Printed: RPC submit -> applied p50/p95 beside the
   in-process submit's, MB over the wire, ship lag over TCP (beside phase
   14's in-process lag), ``summarize_tier``'s rows, windows, scheduling
   delay and admission p99 a tenant and the pool's utilization, the
   control timeline in intervals, the breaker's transitions.

16. **Fleet telemetry, subscriptions and the multi-process harness** —
   leg A on the card: config 4's k-NN at full width over
   ``DurableScheduler(fsync="tick", committer="thread")`` with a sink
   ``nn``, window depth 2, behind an ``RpcIngestServer`` over TCP; a
   ``SegmentShipper`` ships its log over TCP (``RemoteFollower`` ->
   ``ReplicaServer``) to a ``ReplicaScheduler`` on a ``cuda`` executor of
   its own, and a ``SubscriptionHub`` on that follower serves a
   ``SubscriptionServer`` over TCP. A ``RemoteProducer`` submits the
   queries, the 15 x 65,536-doc preload, 5 inserts, a retraction and a
   query update; three wire ``Subscriber``s follow ``nn`` (a ``view``, a
   ``topk`` of 16 by weight, a ``lookup`` of one (query, row) pair present
   after the preload), the view's link partitioned over two insert ticks
   (``FaultyTransport``) and healed. Every write of the insert leg is
   traced. A ``TelemetryShipper`` for the leader's registry and one for
   the follower's ship to a ``FleetAggregator`` behind a
   ``TelemetryServer``. Checked: the follower equals the leader at every
   tick; every subscriber's answer at every horizon it reaches equals
   ``query_value`` over the leader's view bit for bit; after the heal no
   subscriber counts a gap or a duplicate apply and the healed one
   resumed from its cursor; the hub's mirror holds host values only;
   the exported Chrome trace holds a write
   carrying every span of ``obs.export.FULL_CHAIN``; the fleet snapshot
   lists both nodes, none stale; the launches by path (``subs_leader``,
   ``subs_replica``) equal the prediction. Leg B on the host: a
   ``ProcHarness`` fleet (a leader, 3 replica and 4 producer children of
   ``python -m reflow_tpu_torch.proc``, word-count on the CPU oracle, no
   card visible to them); every replica killed -9, respawned and
   rejoined through the barrier; the leader killed -9 and a replica
   promoted across the process boundary, the producers retargeted; no
   acknowledged write lost, the survivors equal at equal horizons, every
   producer's in-doubt set empty, every child in the fleet snapshot.
   Printed: subscription freshness (ack -> subscriber horizon) p50/p95,
   frames, conflations and rebases, the heal's ms, hub fan-out ms a
   window, telemetry bytes; spawn ms a child, respawn -> barrier ms, the
   leader's kill -> first acked write on the promoted leader, the acked
   writes.

17. **The lockcheck leg** — the runtime half of ``python -m
   reflow_tpu_torch.analysis``: a child process (``chip_smoke.py
   --lockcheck-child OUT``) started with ``REFLOW_LOCKCHECK=1`` in its
   environment, so that every ``named_lock`` of the port, module-level
   ones too, reports to the lock-order monitor. The child runs phase 13's
   k-NN leg, phase 14 (followers, compaction, failover) and phase 15 (the
   tier with its PageRank and word-count tenants under the control plane)
   at config 4's full width, the preload cut to 2 chunks, each holding its
   tables to their twins as the full phases do. The script fails if the
   child fails, if any acquisition on any thread raised
   ``LockOrderError``, or if no monitored edge involves a ``serve.tier``,
   a ``wal.*`` or a ``serve.frontend.*`` lock. Printed: the monitor's
   edges, the ones the static lock graph
   (``reflow_tpu_torch.analysis.locks.static_lock_edges``) lacks,
   ``cycles_checked``, the seconds, the child's top-k launches (its own
   paths', the twins' left out: ``lockcheck`` in ``launches_by_path``).

18. **The mesh** — ``reflow_tpu_torch.parallel`` on a mesh of
   ``MESH_SHARDS`` = 4 shards, every one on the card (no shard on the
   CPU). Leg A: config 4 at full width through ``IngestFrontend`` at
   depth 2 over ``ShardedCudaExecutor`` (the corpus row-sharded, the
   queries and the emitted table on every shard), the queries, the
   15 × 65,536-doc preload, 5 inserts, a retraction and a query update,
   each batch also fed to a single-device twin; after every tick the
   two tables must be equal bit for bit (else within config 4's limits,
   which the line then says), the final table is checked against brute
   force, and each tick's launches must be the sharded callers': a
   rescan 4 × 32 ``topk_merge`` (each shard's scan) and 4 × 3 ``topk``
   (the ring merge on [256, 32]), an incremental tick 4 ``topk`` (each
   shard's [256, 16 + 8192]); ``mesh_knn`` in ``launches_by_path``.
   Leg B: config 3 (100k nodes, 1M edges) on the mesh's fused loop, 3
   churn ticks, then ``defer_passes=2`` and a drain, each beside a
   single-device twin: the ranks within 1e-3 relative of the float64
   reference and of the twin; passes and readbacks a tick. Leg C:
   ``dryrun_multichip(8)``; TF-IDF at config 2's widths on
   ``StagedCudaExecutor`` (two stages) equal to a twin's tables; one
   sharded ``tick_many`` window equal to its per-tick twin. Printed:
   each leg's tick ms beside its twin's, the collectives by kind (calls,
   MB), the launches a tick. Legs B and C launch no top-k kernel.

19. **The model axis and a mesh across processes.** Leg A: config 5 at
   full width (ViT-B/16, 256 images a tick, 2^14 ids, 64 groups) on
   ``make_model_mesh(2, 2)`` with ``ShardedCudaExecutor(model_axis=
   "model")``, all four shards on the card, beside a single-device twin
   fed the same stream (an insert tick, then inserts, a move and a
   delete): the centroids within 5e-3 and the features within 2e-2 of
   the twin's, each shard's ``wq`` [768, 384] before and after
   ``update_params``, and 24 psum steps over ``model`` a tick (2 a
   block x 12). Leg B: two ``python -m reflow_tpu_torch.parallel.
   multihost_worker`` children in a ``gloo`` group, each stepping two
   shards of a (dcn 2, delta 2) mesh on the card. B1: config 3 at full
   width, 3 churn ticks, the exactly-once round and a collective
   checkpoint restored into fresh schedulers; the owned ranks within
   1e-3 of the reference and 2 tol (2e-4, relative) of a twin of the
   same mesh shape run here in one process, every tick, while a
   one-tick-stale continuation must lie outside that bound; restored vs
   live within the same 2 tol. B2:
   config 4's k-NN at its widths (the preload cut to 2 x 65,536); every
   tick's table equal to a single-device twin's bit for bit, both top-k
   entries launched in both children. Printed: the backend, the bytes
   staged across the boundary, the boundary exchanges by kind, each
   child's start, its launches. A child that exits non-zero or outlives
   ``MH_LIMIT_S`` fails the phase. ``python3 chip_smoke.py
   --multihost-nccl`` on a machine of several cards runs leg B alone in
   an nccl group, a process a card.
   The window path on both meshes. Leg A-w: config 5 on
   ``make_model_mesh(2, 2)`` as one ``tick_many`` window of 4 ticks,
   then 8 ticks through ``IngestFrontend`` at depth 2 (windows of 2,
   one backlog pumped in the phase's thread), beside the same 8 ticks
   on the same mesh one at a time and on one device: each window
   engaged (``megatick_windows`` and ``window_dispatches`` equal the
   windows sent, no fallback, 3 windows pipelined), the centroids
   within 5e-3 of both. Leg B-w: one more pair of children
   (``--case window``): B1's config 3 churn as one window of 4 ticks, a
   collective checkpoint between windows restored into fresh
   schedulers and one more window on both, held to a one-process twin
   of the same mesh (2 tol); then B2's k-NN through ``IngestFrontend``
   at depth 2, every round's table equal to a single-device twin's
   through the same frontend bit for bit. Printed: the windows, the
   queue's bytes a generation, ``windows_pipelined`` and the ms a tick
   beside the per-tick runs of the same mesh.

20. **Picking the executor from the environment** — every leg's
   scheduler built only through ``ReflowConfig.from_env`` of an explicit
   environment (``CONFIG_ENVS``), never ``os.environ``, each beside a
   twin built by hand. Leg a (``REFLOW_EXECUTOR=cuda``): config 4's k-NN
   at full width with phase 17's preload cut (2 x 65,536 docs): the
   queries with the preload (a rescan), an insert of 8,192 fresh docs
   and a retraction of 1,024; after every tick the table equal bit for
   bit to ``DirtyScheduler(graph, get_executor("cuda"))``'s on the same
   deltas, the (topk, topk_merge, scan_score) launches equal to the
   twin's and not zero, the executor on the card. Leg b (``cuda``,
   ``REFLOW_LINEAR_FIXPOINT=0``, ``REFLOW_MAX_LOOP_ITERS=500``): config 3
   at full width, the initial tick and 2 churn ticks, on the row
   program with no fused-loop CSR rebuild; ranks within 1e-3 relative of
   the float64 reference; ``max_loop_iters`` 500. Leg c
   (``REFLOW_EXECUTOR=sharded``, ``REFLOW_MESH_DEVICES=4``, built on
   ``cuda:0``): leg a's first two ticks on the 4-shard mesh, each table
   bit for bit the twin's. Leg d (``REFLOW_EXECUTOR=tpu``): refused, its
   message printed. Printed: a line a leg, with the ms a tick beside the
   twin's and the launches; ``config`` in ``launches_by_path``.

Every launch count is a triple (``topk``, ``topk_merge``,
``scan_score``): every k-NN corpus here is int8, so a rescan scores each
corpus chunk with one ``scan_scores`` launch before its ``topk_merge``.
Phases 5-12 run no hand-written kernel; the counts, zeroed before them,
must stay 0. Phases 13-16, 18 and 20 zero them again and count their own
paths' launches apart from their twins' (on the replica and follower
threads by the per-thread tallies); phase 17 and phase 19's legs B and
B-w count them in their children (``multihost_knn``,
``multihost_window_knn``); legs A and A-w launch none. Each path's
launches are checked tick by tick against the prediction, and at the
end each path's ``scan_score`` launches against its ``topk_merge``
launches.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from collections import Counter
from typing import Callable, Dict, FrozenSet, List, Set, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType

from reflow_tpu_torch import (CpuExecutor, DeltaBatch, DirtyScheduler,
                              DurableScheduler, FlowGraph, Spec,
                              get_executor, recover)
from reflow_tpu_torch.executors.arena import compact_arena
from reflow_tpu_torch.executors.device_delta import (DeviceDelta,
                                                     bucket_capacity,
                                                     to_device)
from reflow_tpu_torch.executors.fixpoint import FixpointProgram
from reflow_tpu_torch.executors.linear_fixpoint import LinearFixpointProgram
from reflow_tpu_torch.kernels import _build
from reflow_tpu_torch.kernels import topk as topk_mod
from reflow_tpu_torch.kernels.topk import (NEG, scan_scores,
                                           scan_scores_plain, score_form,
                                           scores, topk, topk_merge,
                                           topk_merge_plain, topk_plain)
from reflow_tpu_torch.models import vit
from reflow_tpu_torch.serve import (APPLIED, DEDUPED, CoalesceWindow,
                                    FailoverCoordinator, IngestFrontend,
                                    LeaderReadAdapter, PumpCrashed, ReadTier,
                                    ReplicaScheduler, StaleRead)
from reflow_tpu_torch.utils.checkpoint import (CheckpointChain,
                                               load_checkpoint,
                                               read_chain_manifest,
                                               save_checkpoint)
from reflow_tpu_torch.utils.faults import CrashInjector, CrashPoint
from reflow_tpu_torch.utils.metrics import summarize_wal
from reflow_tpu_torch.utils import tiles
from reflow_tpu_torch.wal import (FencedWrite, SegmentShipper, WalCompactor,
                                  list_segments, scan_wal)
from reflow_tpu_torch.wal.compact import _SourceFold
from reflow_tpu_torch.wal.log import _MAGIC
from reflow_tpu_torch.wal.ship import ShipAck, Shipment, ShipNack
from reflow_tpu_torch.workloads import (image_embed, knn, pagerank, sssp,
                                        tfidf, wordcount)

#: H100 SXM peaks (NVIDIA's data sheet): memory rate, float32 outside
#: the tensor cores and bf16 dense on them, for the kernels' least-time
#: bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989.4e12

#: BASELINE.md config 4 at full width (bench_configs.py's published
#: setting); the corpus preload is cut to 15 x 65536 live docs so the
#: measured inserts land on fresh ids (an insert onto a live id is an
#: update, which rescans)
FULL = dict(Q=256, D=1 << 20, dim=768, k=16, scan_chunk=8192,
            per_tick=8192, preload_chunk=1 << 16, preload_chunks=15,
            insert_ticks=5, retract=1024, query_update=16, trace=True)

#: the main-path shape of the top-k kernel: Q rows of k + 8192
#: candidates (an insert tick's k emitted + 8192 delta docs); the merge
#: entry's is a carry of k plus one 8192-doc chunk (a rescan step)
MAIN_Q, MAIN_N, MAIN_K = 256, 16 + 8192, 16
MAIN_CHUNK = 8192
#: the scoring kernel against its plain version: float32 sums of 768
#: products of unit vectors, taken in another order, differ by a few
#: float32 ulps of 1.0; 1e-5 is half the benchmark's score_gap and
#: rank_gap limit of 2e-5
SCAN_TOL = 1e-5
#: (queries, docs, dim, doc dtype) of the scoring kernel's cases: the
#: main path's shape for both tables, then ragged ones (queries and docs
#: not multiples of the kernel's 128, dim not a multiple of its 64)
SCAN_CASES = [(256, 8192, 768, "int8"), (256, 8192, 768, "bf16"),
              (37, 1000, 768, "int8"), (130, 203, 48, "int8"),
              (37, 1001, 96, "bf16"), (1, 1, 16, "int8")]
#: bytes written between calls to time a kernel with a cold L2 (50 MB)
FLUSH_BYTES = 64 << 20
#: traced runs of one step at most: now and then torch.profiler returns a
#: trace that holds none of the window's device operations (the host ops
#: and launches are there), so a step traced without any is run and traced
#: again, a fresh step where the step changes state
TRACE_TRIES = 3

#: BASELINE.md config 3 at full width (bench.py's setting: 100k nodes,
#: 1M edges, 1% edge churn a tick, tol 1e-4, seed 7; the arena sized as
#: bench.py sizes it); cut: 8 measured churn ticks and one traced
PAGERANK = dict(n_nodes=100_000, n_edges=1_000_000, churn=0.01, tol=1e-4,
                seed=7, churn_ticks=8)
#: phase 6, the fused loop: bench.py's 16 churn ticks, which take the
#: arena past its tail window (163,840 rows: about the 9th tick) and its
#: headroom (310,720 rows: the 16th compacts); the row leg: 2
FUSED = dict(PAGERANK, churn_ticks=16)
ROW_LEG = dict(PAGERANK, churn_ticks=2)
#: the largest max|rank - ref| / max(ref, 1) against the float64 power
#: iteration that phase 5 accepts (tol-suppressed emissions leave errors
#: of order tol; a bound relative to the rank holds at scale)
PAGERANK_MAX_REL_ERR = 1e-3
#: host ops whose counts the traced churn tick reports
PAGERANK_HOST_OPS = ("aten::item", "aten::sort", "aten::index_add_",
                     "aten::nonzero")


#: put before every printed line: the lockcheck leg's child marks its own
LOG_PREFIX = ""


def log(msg: str) -> None:
    print(LOG_PREFIX + msg, flush=True)


def zero_launches(by_thread: bool = False) -> None:
    """Zero the kernels' launch counts (``topk``, ``topk_merge``,
    ``scan_scores``), and with ``by_thread`` their per-thread tallies."""
    topk_mod.TOPK_LAUNCHES = topk_mod.TOPK_MERGE_LAUNCHES = 0
    topk_mod.SCAN_SCORE_LAUNCHES = 0
    if by_thread:
        topk_mod.LAUNCHES_BY_THREAD.clear()
        topk_mod.SCAN_SCORE_BY_THREAD.clear()


# -- phase 1: device ------------------------------------------------------

def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> Dict[str, object]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; nvidia-smi: {card}; tf32 matmul/cudnn off")
    return {"kind": name, "count": torch.cuda.device_count(), "card": card}


# -- phase 2: build -------------------------------------------------------

def phase_build() -> float:
    """Compile the kernels; returns the wall seconds."""
    t0 = time.perf_counter()
    for name in ("topk", "scan_score"):
        t1 = time.perf_counter()
        path = _build.build(name)
        log(f"[build] {name}.cu -> {path.name} in "
            f"{time.perf_counter() - t1:.2f} s")
    return time.perf_counter() - t0


# -- phase 3: kernels vs plain --------------------------------------------

def time_ms(fn: Callable[[], object], iters: int, warmup: int = 5) -> float:
    """Mean milliseconds per call on the card, by CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn: Callable[[], object], iters: int):
    """``iters`` calls of ``fn`` under ``torch.profiler`` (CPU + CUDA),
    profiled again while the trace holds no device operation (at most
    ``TRACE_TRIES`` times; ``fn`` must not change state)."""
    for i in range(TRACE_TRIES):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        if i == TRACE_TRIES - 1 or not trace_lost(prof, "a timed call"):
            return prof


def device_names(fn: Callable[[], object]) -> Set[str]:
    """Names of the device operations one call of ``fn`` runs."""
    fn()
    torch.cuda.synchronize()
    return {e.name for e in _profile(fn, 1).events()
            if e.device_type == DeviceType.CUDA}


def device_ms(fn: Callable[[], object], iters: int, warmup: int = 5,
              exclude: FrozenSet[str] = frozenset()) -> float:
    """Mean milliseconds of device work per call: the summed durations of
    every kernel, copy and fill the card ran during ``iters`` calls, from
    a ``torch.profiler`` trace (host launch costs excluded), leaving out
    operations named in ``exclude``. NaN when the trace holds no device
    activity."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in _profile(fn, iters).events()
             if e.device_type == DeviceType.CUDA and e.name not in exclude)
    return us / 1e3 / iters if us > 0 else float("nan")


def cold_event_ms(fn: Callable[[], object], flush: Callable[[], object],
                  iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call by CUDA events around each call alone,
    with ``flush`` (run before each call, outside the events) evicting
    its inputs from L2."""
    for _ in range(warmup):
        flush()
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def kernel_times(fn: Callable[[], object], flush: Callable[[], object],
                 flush_names: FrozenSet[str]) -> Dict[str, float]:
    """An entry's device and CUDA-event times, warm (back-to-back calls,
    inputs in L2 as the scan finds them after the matmul) and cold (L2
    flushed before each call; the flush is outside the events and left
    out of the profiler sum by name)."""
    return {"warm_dev": device_ms(fn, iters=20),
            "warm_ev": time_ms(fn, iters=100),
            "cold_dev": device_ms(lambda: (flush(), fn()), iters=20,
                                  exclude=flush_names),
            "cold_ev": cold_event_ms(fn, flush, iters=50)}


def topk_cases(device, seed: int = 0) -> List[tuple]:
    """(label, scores, k): the main-path shapes and the edge shapes."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(q, n):
        return torch.randn((q, n), generator=g, device=device)

    partly = randn(32, 513)
    partly[:, 5:] = NEG                    # fewer than k real values
    ties = torch.randint(0, 4, (64, 2000), generator=g,
                         device=device).float()
    return [
        ("main 256x8208 k16", randn(MAIN_Q, MAIN_N), MAIN_K),
        ("preload 256x65552 k16", randn(256, 16 + (1 << 16)), 16),
        ("ragged 37x1000 k7", randn(37, 1000), 7),
        ("k=1 64x4099", randn(64, 4099), 1),
        ("k=N 16x300", randn(16, 300), 300),
        ("all NEG 32x513 k16",
         torch.full((32, 513), NEG, device=device), 16),
        ("partly NEG 32x513 k16", partly, 16),
        ("ties 64x2000 k32", ties, 32),
        ("ragged multi-tile 8x20001 k16", randn(8, 20001), 16),
        # the sharded k-NN's shapes: the ring merge's [Q, 2k], and an
        # incremental tick's [Q, k + Cd] (Cd the gathered delta docs)
        ("mesh ring merge 256x32 k16", randn(256, 32), 16),
        (f"mesh incremental 256x{16 + FULL['per_tick']} k16",
         randn(256, 16 + FULL["per_tick"]), 16),
    ]


def merge_cases(device, seed: int = 2) -> List[tuple]:
    """(label, carry_vals, carry_ids, scores, live, lo): the rescan step's
    shape and the cases that matter for the merge entry."""
    g = torch.Generator(device=device).manual_seed(seed)

    def case(label, q, k, n, ints=False, carry="random", live_p=0.9):
        if ints:                             # exact ties everywhere
            cv = torch.randint(0, 3, (q, k), generator=g,
                               device=device).float()
            s = torch.randint(0, 3, (q, n), generator=g,
                              device=device).float()
        else:
            cv = torch.randn((q, k), generator=g, device=device)
            s = torch.randn((q, n), generator=g, device=device)
        cv = torch.sort(cv, dim=1, descending=True).values
        lo = 37 * n
        ci = torch.randint(0, lo, (q, k), generator=g, device=device,
                           dtype=torch.int32)
        if carry == "neg":
            cv.fill_(NEG)
            ci.fill_(-1)
        elif carry == "best":
            cv += 10.0
        live = torch.rand((n,), generator=g, device=device) < live_p
        return (label, cv, ci, s, live, lo)

    return [
        case(f"main 256x({MAIN_K}+{MAIN_CHUNK})", MAIN_Q, MAIN_K,
             MAIN_CHUNK),
        case("first step: carry (NEG, -1) 256x(16+8192)", 256, 16, 8192,
             carry="neg"),
        case("dead chunk 64x(16+8192)", 64, 16, 8192, live_p=0.0),
        case("ties across carry|chunk 64x(16+2000)", 64, 16, 2000,
             ints=True, live_p=0.5),
        case("carry holds the best 64x(16+8192)", 64, 16, 8192,
             carry="best"),
        case("k=1 64x(1+4099)", 64, 1, 4099),
        case("k=40 32x(40+3000) (rounds path)", 32, 40, 3000),
    ]


def _same(label: str, got, want, n_cols: int = 0) -> float:
    """Exact equality of (values, ids); returns the max abs difference
    (0.0) for the record."""
    (v, i), (pv, pi) = got, want
    torch.cuda.synchronize()
    if v.shape != pv.shape or i.dtype != torch.int32:
        raise AssertionError(f"{label}: kernel output {tuple(v.shape)} "
                             f"{i.dtype}")
    if not (torch.equal(v, pv) and torch.equal(i, pi)):
        bad = (v != pv) | (i != pi)
        raise AssertionError(f"{label}: kernel != plain at "
                             f"{int(bad.sum())} of {bad.numel()} entries")
    if n_cols and (int(i.min()) < 0 or int(i.max()) >= n_cols):
        raise AssertionError(f"{label}: id out of [0, N)")
    return float((v - pv).abs().max())


def _bound(nbytes: int, ops: int,
           ops_per_s: float = F32_OPS_PER_S) -> tuple:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def _times_line(name: str, t: Dict[str, float]) -> str:
    return (f"{name}: warm device {t['warm_dev']:.5f} ms, warm events "
            f"{t['warm_ev']:.5f} ms, cold device {t['cold_dev']:.5f} ms, "
            f"cold events {t['cold_ev']:.5f} ms")


def scan_inputs(nq: int, nd: int, dim: int, doc: str, device,
                seed: int) -> tuple:
    """bf16 unit-vector queries and docs as a table stores them: int8
    (round(unit * 127), the first row holding every byte value it can)
    or bf16; made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)

    def unit(n):
        v = torch.randn((n, dim), generator=g, device=device)
        return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)

    q = unit(nq).to(torch.bfloat16)
    if doc == "bf16":
        return q, unit(nd).to(torch.bfloat16)
    d = torch.round(unit(nd) * 127).to(torch.int8)
    d[0, :min(dim, 256)] = torch.arange(-128, -128 + min(dim, 256),
                                        device=device).to(torch.int8)
    return q, d


def scan_kernel_record(device, flush, flush_names) -> Dict[str, object]:
    """Hold the scoring kernel to its plain version within SCAN_TOL on
    every case, a repeat to the first launch bit for bit, and its
    dequantized operands to ``score_form``'s (a one-hot query's scores
    are the operands themselves); time it at the main shape, warm and
    cold on one chunk and over the corpus's chunks in turn, beside the
    plain version and ``torch.matmul`` of the bf16 operands. Returns the
    kernel's record."""
    err = 0.0
    for nq, nd, dim, doc in SCAN_CASES:
        q, d = scan_inputs(nq, nd, dim, doc, device, seed=nd)
        got = scan_scores(q, d)
        e = float((got - scan_scores_plain(q, d)).abs().max())
        if not e <= SCAN_TOL:
            raise AssertionError(f"scan_scores {nq}x{nd}x{dim} {doc}: "
                                 f"kernel - plain {e:.3g} > {SCAN_TOL}")
        if not torch.equal(scan_scores(q, d), got):
            raise AssertionError(f"scan_scores {nq}x{nd}x{dim} {doc}: a "
                                 f"repeat differs")
        err = max(err, e)
        log(f"[kernels] scan_scores {nq}x{nd}x{dim} {doc} docs: kernel "
            f"within {e:.3g} of plain (limit {SCAN_TOL}), a repeat bit for "
            f"bit")
    eye = torch.eye(FULL["dim"], dtype=torch.bfloat16, device=device)
    for doc in ("int8", "bf16"):
        _, d = scan_inputs(1, 64, FULL["dim"], doc, device, seed=4)
        if not torch.equal(scan_scores(eye, d), score_form(d).float().T):
            raise AssertionError(f"scan_scores' {doc} operands differ from "
                                 f"score_form's")
    log("[kernels] scan_scores one-hot queries: the int8 and bf16 "
        "operands equal score_form's bit for bit")

    Q, C, dim = MAIN_Q, MAIN_CHUNK, FULL["dim"]
    q, d = scan_inputs(Q, C, dim, "int8", device, seed=9)
    out = torch.empty((Q, C), device=device)
    t = kernel_times(lambda: scan_scores(q, d, out), flush, flush_names)
    # a rescan's reads: each launch takes the corpus's next chunk
    _, corpus = scan_inputs(1, FULL["D"], dim, "int8", device, seed=10)
    at = [0]

    def rescan_step():
        scan_scores(q, corpus[at[0]:at[0] + C], out)
        at[0] = (at[0] + C) % FULL["D"]

    scan_dev = device_ms(rescan_step, iters=FULL["D"] // C)
    del corpus
    plain_dev = device_ms(lambda: scan_scores_plain(q, d), iters=20)
    plain_ev = time_ms(lambda: scan_scores_plain(q, d), 50)
    db = score_form(d)
    lib_dev = device_ms(lambda: torch.matmul(q, db.T), iters=20)
    lib_ev = time_ms(lambda: torch.matmul(q, db.T), 100)
    traced = t["warm_dev"] == t["warm_dev"] and plain_dev == plain_dev
    if not traced:
        log("[kernels] scan_score: the profiler trace held no device time; "
            "the record's times are CUDA-event times")
    nbytes = C * dim + Q * dim * 2 + Q * C * 4
    bound_ms, bound_by = _bound(nbytes, 2 * Q * dim * C, BF16_OPS_PER_S)
    rec = {"name": "scan_score", "route": "cuda",
           "source": "reflow_tpu_torch/csrc/scan_score.cu",
           "replaces": "no Pallas kernel: the jnp.dot of "
                       "reflow_tpu/kernels/topk.py chunked_corpus_topk",
           "launches": None, "max_abs_err": err,
           "ms": t["warm_dev"] if traced else t["warm_ev"],
           "rescan_ms": scan_dev,
           "plain_ms": plain_dev if traced else plain_ev,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_dev if traced else lib_ev}
    shape = f"[{Q}, {dim}] x [{C}, {dim}] int8"
    log(f"[kernels] {_times_line('scan_score ' + shape, t)}; over the "
        f"corpus's chunks in turn {scan_dev:.5f} ms (device)")
    log(f"[kernels] scan_score: plain device {plain_dev:.5f} ms, events "
        f"{plain_ev:.5f} ms; torch.matmul of the bf16 operands (the "
        f"dequantization left out) device {lib_dev:.5f} ms, events "
        f"{lib_ev:.5f} ms; bound {bound_ms:.5f} ms ({bound_by}: {nbytes} "
        f"B); warm device time is {bound_ms / rec['ms'] * 100:.1f}% of "
        f"the bound, the corpus's chunks in turn "
        f"{bound_ms / scan_dev * 100:.1f}%")
    return rec


def phase_kernels(device) -> List[Dict[str, object]]:
    """Hold both top-k entries to their plain versions, exactly, on every
    case; time each entry warm and cold at its main-path shape beside
    the plain version and (for ``topk``) ``torch.topk``; then the
    scoring kernel (``scan_kernel_record``). Returns the three kernel
    records."""
    max_err = 0.0
    for label, s, k in topk_cases(device):
        max_err = max(max_err, _same(label, topk(s, k), topk_plain(s, k),
                                     n_cols=s.shape[1]))
        log(f"[kernels] topk {label}: kernel == plain (values and ids "
            f"exact)")
    merge_err = 0.0
    for label, *args in merge_cases(device):
        merge_err = max(merge_err, _same(label, topk_merge(*args),
                                         topk_merge_plain(*args)))
        log(f"[kernels] topk_merge {label}: kernel == plain (values and "
            f"ids exact)")

    # the ring merge's shape, timed warm beside its plain version
    ring = torch.randn((MAIN_Q, 2 * MAIN_K), device=device)
    ring_dev = device_ms(lambda: topk(ring, MAIN_K), iters=50)
    ring_plain = device_ms(lambda: topk_plain(ring, MAIN_K), iters=50)
    ring_ev = time_ms(lambda: topk(ring, MAIN_K), 100)
    log(f"[kernels] topk mesh ring-merge shape [{MAIN_Q}, {2 * MAIN_K}] "
        f"k{MAIN_K}: warm device {ring_dev:.5f} ms, events {ring_ev:.5f} "
        f"ms; plain device {ring_plain:.5f} ms; bound "
        f"{_bound(MAIN_Q * 2 * MAIN_K * 4 + MAIN_Q * MAIN_K * 8, MAIN_Q * 2 * MAIN_K)[0]:.5f} ms")

    l2 = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)

    def flush():
        l2.fill_(1)

    flush_names = frozenset(device_names(flush))
    gen = torch.Generator(device=device).manual_seed(1)
    s = torch.randn((MAIN_Q, MAIN_N), generator=gen, device=device)
    _, *margs = merge_cases(device, seed=3)[0]
    recs = []
    for name, fn, plain, lib, nbytes, ops in [
            ("topk", lambda: topk(s, MAIN_K),
             lambda: topk_plain(s, MAIN_K),
             lambda: torch.topk(s, MAIN_K, dim=1),
             MAIN_Q * MAIN_N * 4 + MAIN_Q * MAIN_K * (4 + 4),
             MAIN_Q * MAIN_N),
            ("topk_merge", lambda: topk_merge(*margs),
             lambda: topk_merge_plain(*margs), None,
             MAIN_Q * MAIN_CHUNK * 4 + MAIN_CHUNK
             + 2 * MAIN_Q * MAIN_K * (4 + 4),
             MAIN_Q * (MAIN_K + MAIN_CHUNK))]:
        t = kernel_times(fn, flush, flush_names)
        plain_dev, plain_ev = device_ms(plain, iters=20), time_ms(plain, 50)
        lib_dev = lib_ev = None
        if lib is not None:
            lib_dev, lib_ev = device_ms(lib, iters=20), time_ms(lib, 100)
        traced = t["warm_dev"] == t["warm_dev"] and plain_dev == plain_dev
        if not traced:
            log(f"[kernels] {name}: the profiler trace held no device "
                f"time; the record's times are CUDA-event times")
        bound_ms, bound_by = _bound(nbytes, ops)
        rec = {"name": name, "route": "cuda",
               "source": "reflow_tpu_torch/csrc/topk.cu",
               "replaces": "reflow_tpu/kernels/topk.py:64",
               "launches": None,
               "max_abs_err": max_err if name == "topk" else merge_err,
               "ms": t["warm_dev"] if traced else t["warm_ev"],
               "plain_ms": plain_dev if traced else plain_ev,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": (lib_dev if traced else lib_ev)
               if lib is not None else None}
        shape = (f"[{MAIN_Q}, {MAIN_N}]" if name == "topk" else
                 f"carry [{MAIN_Q}, {MAIN_K}] + chunk [{MAIN_Q}, "
                 f"{MAIN_CHUNK}] with a live mask")
        log(f"[kernels] {_times_line(name + ' ' + shape, t)}")
        log(f"[kernels] {name}: plain device {plain_dev:.5f} ms, events "
            f"{plain_ev:.5f} ms"
            + (f"; torch.topk device {lib_dev:.5f} ms, events "
               f"{lib_ev:.5f} ms" if lib is not None else "")
            + f"; bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B); warm "
            f"device time is {bound_ms / rec['ms'] * 100:.1f}% of the "
            f"bound")
        recs.append(rec)
    recs.append(scan_kernel_record(device, flush, flush_names))
    return recs


# -- phase 4: the serving slice -------------------------------------------

def _device_chunk(n: int, base: int, dim: int, D: int, seed: int,
                  device) -> DeviceDelta:
    """``n`` corpus inserts made on the card: random vectors quantized
    as ``workloads.knn.quantize_int8`` does (round(unit * 127))."""
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((n, dim), generator=g, device=device)
    unit = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                           min=1e-30)
    rows = torch.clamp(torch.round(unit * 127.0), -127, 127).to(torch.int8)
    keys = ((base + torch.arange(n, device=device)) % D).to(torch.int32)
    return DeviceDelta(keys, rows,
                       torch.ones(n, dtype=torch.int32, device=device))


def tick_profiler():
    """A CPU + CUDA profiler that also records the host ops of threads
    started before it (the frontend's pump runs the tick), where this
    torch can (``profile_all_threads``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=acts)
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def serve_slice(cfg: Dict[str, int], device, seed: int = 0,
                on_phase: Callable[[str], None] = log) -> Dict[str, object]:
    """Serve the k-NN workload through IngestFrontend on ``device`` and
    check the table. Returns the timings, per-tick kernel launches and
    the check's numbers."""
    Q, D, dim, k = cfg["Q"], cfg["D"], cfg["dim"], cfg["k"]
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    kg = knn.build_graph(Q, D, dim, k, scan_chunk=cfg["scan_chunk"],
                         dtype=torch.bfloat16, doc_dtype=torch.int8,
                         precision="default")
    ex = get_executor("cuda", device=device)
    sched = DirtyScheduler(kg.graph, ex)
    fe = IngestFrontend(sched, window=CoalesceWindow(
        max_rows=cfg["per_tick"], max_ticks=8, max_latency_s=0.005),
        max_bytes=1 << 30)
    rng = np.random.default_rng(seed)
    tickets = []
    launches: List[tuple] = []
    syncs: List[int] = []
    traces: List[tuple] = []

    def tick(kind: str, source, batch, trace: bool = False) -> float:
        """One batch through submit, flushed and applied; returns the
        wall seconds from submit to the device finishing. ``trace`` runs
        it under ``torch.profiler`` and keeps the trace."""
        l0 = (topk_mod.TOPK_LAUNCHES, topk_mod.TOPK_MERGE_LAUNCHES,
              topk_mod.SCAN_SCORE_LAUNCHES)
        s0 = sched.forced_syncs
        prof = None
        if trace:
            prof = tick_profiler()
            prof.__enter__()
        try:
            t0 = time.perf_counter()
            t = fe.submit(source, batch)
            fe.flush()
            res = t.result(timeout=600)
            sync()
            wall = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        if res.status != APPLIED:
            raise AssertionError(f"{kind} ticket {res.status}: {res}")
        tickets.append(res)
        launches.append((kind, topk_mod.TOPK_LAUNCHES - l0[0],
                         topk_mod.TOPK_MERGE_LAUNCHES - l0[1],
                         topk_mod.SCAN_SCORE_LAUNCHES - l0[2]))
        syncs.append(sched.forced_syncs - s0)
        if prof is not None:
            traces.append((kind, wall, prof))
        return wall

    try:
        qvecs = rng.standard_normal((Q, dim), dtype=np.float32)
        tick("query insert", kg.queries,
             DeltaBatch(np.arange(Q, dtype=np.int64), qvecs))
        t0 = time.perf_counter()
        n = cfg["preload_chunk"]
        for c in range(cfg["preload_chunks"]):
            tick("preload", kg.docs,
                 _device_chunk(n, c * n, dim, D, seed + 1 + c, device))
        preload_s = time.perf_counter() - t0
        next_id = cfg["preload_chunks"] * n
        on_phase(f"[serve] preload: {next_id} live docs in "
                 f"{cfg['preload_chunks']} device batches of {n}, "
                 f"{preload_s:.3f} s")

        insert_s, insert_ops = [], []
        for _ in range(cfg["insert_ticks"]):
            ids = np.arange(next_id, next_id + cfg["per_tick"],
                            dtype=np.int64)
            next_id += cfg["per_tick"]
            vals = knn.quantize_int8(rng.standard_normal(
                (len(ids), dim), dtype=np.float32))
            insert_s.append(tick("insert", kg.docs, DeltaBatch(ids, vals)))
            insert_ops.append(sched.history[-1].block().delta_ops)
        gone = np.arange(cfg["retract"], dtype=np.int64)
        rescan_s = tick("retract", kg.docs, DeltaBatch(
            gone, np.zeros((len(gone), dim), np.int8),
            -np.ones(len(gone), np.int64)))
        nq = cfg["query_update"]
        qvecs[:nq] = rng.standard_normal((nq, dim), dtype=np.float32)
        qupdate_s = tick("query update", kg.queries, DeltaBatch(
            np.arange(nq, dtype=np.int64), qvecs[:nq]))
        if cfg.get("trace"):
            # one more of each tick kind, traced (not among the timed);
            # a tick whose trace was lost is followed by a fresh one
            next_gone = cfg["retract"]
            for kind in ("insert", "retract"):
                for i in range(TRACE_TRIES):
                    if kind == "insert":
                        ids = np.arange(next_id, next_id + cfg["per_tick"],
                                        dtype=np.int64)
                        next_id += cfg["per_tick"]
                        batch = DeltaBatch(ids, knn.quantize_int8(
                            rng.standard_normal((len(ids), dim),
                                                dtype=np.float32)))
                    else:
                        gone = np.arange(next_gone, next_gone + cfg["retract"],
                                         dtype=np.int64)
                        next_gone += cfg["retract"]
                        batch = DeltaBatch(
                            gone, np.zeros((len(gone), dim), np.int8),
                            -np.ones(len(gone), np.int64))
                    tick(kind, kg.docs, batch, trace=True)
                    if i == TRACE_TRIES - 1 or not trace_lost(
                            traces[-1][2], f"k-NN {kind} tick"):
                        break
                    traces.pop()
        fe.flush()
        table = sched.read_table(kg.index)
    finally:
        fe.close()
    queues = [q for key, q in ex._window_cache.items()
              if key[0] == "ingress_q"]
    window = {"megatick_windows": sched.megatick_windows,
              "megatick_fallbacks": sched.megatick_fallbacks,
              "window_dispatches": ex.window_dispatches,
              "depth": fe.depth, "admission": fe.admission,
              "windows_staged": fe.windows_staged,
              "windows_pipelined": fe.windows_pipelined,
              "stage_overlap_frac": fe.stage_overlap_frac,
              "queues": len(queues),
              "generations": sum(q.generations for q in queues),
              "queue_nbytes": sum(q.nbytes for q in queues),
              "queue_host_nbytes": sum(q.host_nbytes for q in queues),
              "syncs": syncs}
    # the serving path's peak, before the check below allocates its own
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)

    st = ex.states[kg.index.id]
    recall, score_diff = knn_vs_brute_force(st, table, Q, k)
    return {"preload_s": preload_s, "insert_s": insert_s,
            "insert_ops": insert_ops, "rescan_s": rescan_s,
            "query_update_s": qupdate_s, "launches": launches,
            "window": window,
            "traces": traces,
            "tickets": len(tickets), "recall": recall,
            "score_max_abs_diff": score_diff,
            "forced_syncs": sched.forced_syncs, "peak_bytes": peak,
            "live_docs": int(st["dlive"].sum())}


#: a k-NN sink table against brute force: the least recall and the
#: largest score difference it may show
BRUTE_RECALL, BRUTE_SCORE_DIFF = 0.99, 1e-2


def knn_vs_brute_force(st: Dict, table: Dict, Q: int,
                       k: int) -> Tuple[float, float]:
    """Recall and the largest score difference of a k-NN sink table
    against plain torch top-k over the same device tables (``st``'s
    ``qvec``, ``dvec`` and ``dlive``). Raises unless ``table`` holds
    ``Q`` finite ``[k, 2]`` rows."""
    full = scores(st["qvec"], st["dvec"])
    full = torch.where(st["dlive"][None, :], full, NEG)
    bvals, bids = topk_plain(full, k)
    del full
    got = np.stack([table[q] for q in range(Q)]) if len(table) == Q else None
    if got is None or got.shape != (Q, k, 2) or not np.isfinite(got).all():
        raise AssertionError(f"table: {len(table)} rows, expected {Q} "
                             f"finite [k, 2] rows")
    bids_h, bvals_h = bids.cpu().numpy(), bvals.cpu().numpy()
    hits = sum(len(set(got[q, :, 0].astype(np.int64)) & set(bids_h[q]))
               for q in range(Q))
    return hits / (Q * k), float(np.abs(got[:, :, 1] - bvals_h).max())


def check_brute_force(label: str, st: Dict, table: Dict, Q: int,
                      k: int) -> Tuple[float, float]:
    """``knn_vs_brute_force``, raising outside ``BRUTE_RECALL`` and
    ``BRUTE_SCORE_DIFF``."""
    recall, score_diff = knn_vs_brute_force(st, table, Q, k)
    if recall < BRUTE_RECALL or score_diff > BRUTE_SCORE_DIFF:
        raise AssertionError(
            f"{label} vs brute force: recall {recall:.4f} (need >= "
            f"{BRUTE_RECALL}), score max_abs_diff {score_diff:.3g} (need "
            f"<= {BRUTE_SCORE_DIFF})")
    return recall, score_diff


#: host-side ops that chunked_corpus_topk must not issue once per chunk
PER_CHUNK_FORBIDDEN = ("aten::cat", "aten::where", "aten::gather")


def _short(name: str, width: int = 72) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name if len(name) <= width else name[:width - 3] + "..."


def _device_events(prof) -> List[tuple]:
    """(start us, end us, name) of every device operation in a trace,
    sorted; the device-side copies of ``reflow::`` profiler ranges and of
    the window label ``reflow.window[K]`` are spans, not operations, and
    are left out."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("reflow::", "reflow.window")))


def trace_lost(prof, what: str) -> bool:
    """Whether the profiler lost the device side of a trace (no device
    operation in it; see ``TRACE_TRIES``), logged when it did."""
    if _device_events(prof):
        return False
    log(f"[trace] {what}: the trace holds no device operation; tracing "
        f"again")
    return True


def trace_report(kind: str, wall_s: float, prof, card: str,
                 host_ops=()) -> Dict[str, object]:
    """Read one traced tick: the device-busy share of its wall time, the
    top device operations by total time with their launch counts, the
    longest idle gaps between device operations, and the counts of the
    host ops named in ``host_ops``."""
    dev = _device_events(prof)
    host = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    if not dev:
        raise AssertionError(f"traced {kind} tick: no device operation "
                             f"in the trace")
    merged: List[List[float]] = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    span_us = merged[-1][1] - merged[0][0]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], i)
                   for i in range(len(merged) - 1)), reverse=True)[:5]
    by_name: Dict[str, List[float]] = {}
    for a, b, name in dev:
        slot = by_name.setdefault(_short(name), [0, 0.0])
        slot[0] += 1
        slot[1] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    counts = {op: host.count(op) for op in host_ops}
    log(f"[trace] {kind} tick: wall {wall_s * 1e3:.3f} ms (under the "
        f"profiler), device busy {busy_us / 1e3:.3f} ms = "
        f"{busy_us / (wall_s * 1e6) * 100:.1f}% of the wall, "
        f"{busy_us / span_us * 100:.1f}% of the first-to-last device span "
        f"{span_us / 1e3:.3f} ms; {len(dev)} device ops [{card}]")
    for name, (n, us) in top:
        log(f"[trace] {kind} top device op: {us / 1e3:.3f} ms in {n} x "
            f"{name}")
    log(f"[trace] {kind} longest idle gaps between device ops: "
        + ", ".join(f"{g:.1f} us" for g, _ in gaps))
    return {"busy_share": busy_us / (wall_s * 1e6), "busy_us": busy_us,
            "dev": dev, "merged": merged, "span_us": span_us,
            "counts": counts, "gaps_us": [g for g, _ in gaps]}


def knn_trace_report(kind: str, wall_s: float, prof, chunks: int,
                     card: str) -> Dict[str, object]:
    """:func:`trace_report` of a k-NN tick, plus the scan loop's own
    device-busy share and, on a rescan tick, the check that each corpus
    chunk ran one scoring kernel and that no cat, where, gather or
    matmul is issued once per corpus chunk."""
    rep = trace_report(kind, wall_s, prof, card,
                       PER_CHUNK_FORBIDDEN + ("aten::matmul", "aten::empty"))
    dev, merged, span_us = rep["dev"], rep["merged"], rep["span_us"]
    counts = rep["counts"]
    if counts["aten::empty"] == 0:
        # this torch records no host ops of the pump thread
        log(f"[trace] {kind}: host ops of the pump thread not recorded")
        counts = {}
    loop = [(a, b) for a, b, name in dev if "MergeSource" in name]
    if loop:
        # the scan loop alone: from the first merge to the last
        lo, hi = loop[0][0], loop[-1][1]
        inside = sum(min(b, hi) - max(a, lo) for a, b in merged
                     if b > lo and a < hi)
        log(f"[trace] {kind} scan loop ({len(loop)} merges): device busy "
            f"{inside / 1e3:.3f} ms of {(hi - lo) / 1e3:.3f} ms = "
            f"{inside / (hi - lo) * 100:.1f}%; the tick outside it "
            f"{(span_us - (hi - lo)) / 1e3:.3f} ms of the device span")
    if counts:
        log(f"[trace] {kind} host op counts: "
            + ", ".join(f"{op} {n}" for op, n in counts.items()))
    if kind == "retract":
        scored = sum("scan_score_kernel" in name for _a, _b, name in dev)
        if scored != chunks:
            raise AssertionError(f"rescan tick trace: {scored} scoring "
                                 f"kernels over {chunks} chunks")
    if kind == "retract" and counts:
        per_chunk = [op for op in PER_CHUNK_FORBIDDEN + ("aten::matmul",)
                     if counts[op] >= chunks]
        if per_chunk:
            raise AssertionError(
                f"rescan tick trace: {counts} over {chunks} chunks "
                f"({per_chunk} issued once per chunk)")
    return rep


def phase_serve(card: str) -> Dict[str, object]:
    torch.cuda.reset_peak_memory_stats()
    # counts of the main path only
    zero_launches()
    out = serve_slice(FULL, "cuda")
    total = topk_mod.TOPK_LAUNCHES
    total_merge = topk_mod.TOPK_MERGE_LAUNCHES
    total_scan = topk_mod.SCAN_SCORE_LAUNCHES
    mem = out["peak_bytes"]
    chunks = FULL["D"] // FULL["scan_chunk"]
    for kind, n, nm, ns in out["launches"]:
        rescan = kind in ("retract", "query update", "query insert")
        want = (0, chunks, chunks) if rescan else (1, 0, 0)
        if (n, nm, ns) != want:
            raise AssertionError(
                f"{kind} tick launched topk {n}, topk_merge {nm} and "
                f"scan_score {ns} times, expected {want}")
    if (out["recall"] < BRUTE_RECALL
            or out["score_max_abs_diff"] > BRUTE_SCORE_DIFF):
        raise AssertionError(
            f"table vs brute force: recall {out['recall']:.4f} (need >= "
            f"{BRUTE_RECALL}), score max_abs_diff "
            f"{out['score_max_abs_diff']:.3g} (need <= {BRUTE_SCORE_DIFF})")
    win = out["window"]
    kinds = [kind for kind, *_counts in out["launches"]]
    staged = sum(kind != "preload" for kind in kinds)
    # every host-batch tick is one staged window at depth 2; the preload's
    # device-resident batches run tick by tick
    if (win["depth"] != 2 or win["admission"] != "device"
            or win["megatick_windows"] != staged
            or win["windows_staged"] != staged
            or win["megatick_fallbacks"] != 0):
        raise AssertionError(f"serving windows: {win} over {staged} host "
                             f"ticks")
    if any(n != 1 for n in win["syncs"]):
        raise AssertionError(f"forced syncs a window {win['syncs']}, "
                             f"expected one a tick (the path choice)")
    log(f"[serve] window path: depth {win['depth']}, admission "
        f"{win['admission']}; megatick_windows {win['megatick_windows']}, "
        f"megatick_fallbacks {win['megatick_fallbacks']}, windows_staged "
        f"{win['windows_staged']}, windows_pipelined "
        f"{win['windows_pipelined']}, stage_overlap_frac "
        f"{win['stage_overlap_frac']:.3f}; {win['queues']} ingress queues, "
        f"{win['generations']} generations, {win['queue_nbytes']} B on the "
        f"card and {win['queue_host_nbytes']} B pinned; forced syncs a "
        f"window {win['syncs']} [{card}]")
    ins = sorted(out["insert_s"])
    med = ins[len(ins) // 2]
    dops = sum(out["insert_ops"]) / sum(out["insert_s"])
    log(f"[serve] {out['tickets']} tickets applied; {out['live_docs']} live "
        f"docs; (topk, topk_merge, scan_score) launches per tick "
        f"{[tuple(c) for _, *c in out['launches']]} (totals {total}, "
        f"{total_merge}, {total_scan})")
    log(f"[serve] check vs brute force: recall {out['recall']:.6f}, score "
        f"max_abs_diff {out['score_max_abs_diff']:.6g}")
    log(f"[serve] insert tick (8192 int8 docs, incremental) median "
        f"{med * 1e3:.3f} ms of {[round(s * 1e3, 3) for s in out['insert_s']]}"
        f"; rescan tick (retract {FULL['retract']}) "
        f"{out['rescan_s'] * 1e3:.3f} ms; query-update rescan "
        f"{out['query_update_s'] * 1e3:.3f} ms; delta-ops/s {dops:.1f}; "
        f"peak device memory {mem} B; forced syncs {out['forced_syncs']} "
        f"[{card}]")
    for kind, wall, prof in out.pop("traces"):
        knn_trace_report(kind, wall, prof, chunks, card)
    out.update(total_launches=total, total_merge_launches=total_merge,
               total_scan_launches=total_scan, insert_median_s=med,
               delta_ops_per_s=dops)
    return out


# -- phase 5: PageRank ------------------------------------------------------

def _under(e) -> tuple:
    """(device us, device ops) launched inside a CPU event of a trace."""
    us, n = sum(k.duration for k in e.kernels), len(e.kernels)
    for c in e.cpu_children:
        cu, cn = _under(c)
        us, n = us + cu, n + cn
    return us, n


def span_table(prof) -> Dict[str, List[float]]:
    """``{span: [device us, device ops, host us]}`` over the ``reflow::``
    profiler ranges of a trace: the device operations launched inside
    each range (through the trace's CPU op tree) and the host wall time
    spent inside it (under the profiler, which slows the host), summed
    over its occurrences."""
    out: Dict[str, List[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("reflow::"):
            us, n = _under(e)
            slot = out.setdefault(e.name[len("reflow::"):], [0.0, 0, 0.0])
            slot[0] += us
            slot[1] += n
            slot[2] += e.time_range.elapsed_us()
    return out


def pagerank_setup(cfg: Dict[str, object], executor_kw: Dict[str, object],
                   defer=None):
    """The config's graph, web graph and scheduler on the ``cuda``
    executor of the current card (no device argument), the arena sized as
    bench.py sizes it."""
    n, e, churn = cfg["n_nodes"], cfg["n_edges"], cfg["churn"]
    arena = (bucket_capacity(e)
             + 8 * bucket_capacity(2 * int(churn * e) + 2))
    pg = pagerank.build_graph(n, tol=cfg["tol"], arena_capacity=arena,
                              defer_passes=defer)
    web = pagerank.WebGraph.random(n, e, seed=cfg["seed"])
    ex = get_executor("cuda", **executor_kw)
    return pg, web, ex, DirtyScheduler(pg.graph, ex), arena


def rank_error(sched, pg, web, n: int) -> Dict[str, object]:
    """The ranks against the float64 power iteration over the final edge
    set, computed on the host: ``max|rank - ref| / max(ref, 1)``."""
    table = sched.read_table(pg.new_rank)
    ranks = pagerank.ranks_to_array(table, n)
    t0 = time.perf_counter()
    ref = pagerank.reference_ranks(web)
    ref_s = time.perf_counter() - t0
    if ranks.shape != (n,) or not np.isfinite(ranks).all():
        raise AssertionError(f"ranks: shape {ranks.shape}, finite "
                             f"{bool(np.isfinite(ranks).all())}")
    rel = np.abs(ranks - ref) / np.maximum(ref, 1.0)
    return {"rel_err": float(rel.max()), "rel_err_at": int(rel.argmax()),
            "abs_err": float(np.abs(ranks - ref).max()), "ref_s": ref_s,
            "keys": len(table)}


def pagerank_slice(cfg: Dict[str, object], executor_kw: Dict[str, object],
                   tag: str = "pagerank") -> Dict[str, object]:
    """Incremental PageRank through ``DirtyScheduler`` on the ``cuda``
    executor (``executor_kw`` picks the loop), on the current card: the
    teleport and the initial edge batch in one full tick, then
    ``churn_ticks`` measured churn ticks and one more under
    ``torch.profiler``. Each tick is timed by the host clock around push
    -> tick -> synchronize. Returns the timings, passes, readbacks, the
    fused loop's per-tick CSR and tier record, the arena's counters and
    the ranks' error against the float64 reference."""
    n, churn = cfg["n_nodes"], cfg["churn"]
    pg, web, ex, sched, arena = pagerank_setup(cfg, executor_kw)

    def tick(pushes, trace=False) -> Dict[str, object]:
        s0, h0, r0 = sched.forced_syncs, ex.host_syncs, ex.loop_reads
        prof = None
        if trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        try:
            t0 = time.perf_counter()
            for src, batch in pushes:
                sched.push(src, batch)
            res = sched.tick()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        if not res.quiesced:
            raise AssertionError(f"tick {res.tick} did not quiesce")
        syncs, loop_reads = sched.forced_syncs - s0, ex.loop_reads - r0
        last = dict(getattr(ex._fx_program, "last_tick", None) or {})
        return {"s": wall, "passes": res.passes, "delta_ops": res.delta_ops,
                "syncs": syncs, "branch_syncs": ex.host_syncs - h0,
                # the host loop reads each pass's live count back itself
                "readbacks": syncs + (loop_reads if ex._fx_program
                                      is not None else res.passes),
                "csr": last.get("csr"), "tail_rows": last.get("tail_rows"),
                "tiers": last.get("tiers"), "prof": prof}

    init = tick([(pg.teleport, pagerank.teleport_batch(n)),
                 (pg.edges, web.initial_batch())])
    log(f"[{tag}] initial tick: {init['s'] * 1e3:.3f} ms, "
        f"{init['passes']} passes")
    ticks = [tick([(pg.edges, web.churn(churn))])
             for _ in range(cfg["churn_ticks"])]
    lost = []                   # churn ticks whose trace was lost
    for i in range(TRACE_TRIES):
        traced = tick([(pg.edges, web.churn(churn))], trace=True)
        if i == TRACE_TRIES - 1 or not trace_lost(traced["prof"],
                                                  f"{tag} churn tick"):
            break
        lost.append(traced)
    st = ex.states[pg.join.id]
    peak = torch.cuda.max_memory_allocated()
    out = rank_error(sched, pg, web, n)
    out.update(init=init, ticks=ticks, lost=lost, traced=traced, arena=arena,
               rcount=int(st["rcount"]), gen=int(st["gen"]),
               error_flag=bool(st["error"]),
               forced_syncs=sched.forced_syncs, peak_bytes=peak,
               executor=ex, pg=pg,
               join_state={k: st[k] for k in ("rkeys", "rvals", "rw",
                                              "rcount", "gen")})
    return out


def _bit_equal(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if x.dtype.is_floating_point:
            x, y = x.view(torch.uint8), y.view(torch.uint8)
        if not torch.equal(x, y):
            raise AssertionError(f"compact_arena on the card != on the "
                                 f"CPU in {k!r}")


def phase_pagerank(card: str) -> Dict[str, object]:
    torch.cuda.reset_peak_memory_stats()
    # the scheduler's host-driven loop, asked for explicitly: the
    # executor's default is the fused loop (phase 6)
    out = pagerank_slice(PAGERANK, {"fixpoint": False})
    if out.pop("executor")._fx_program is not None:
        raise AssertionError("phase 5 ran a fixpoint program, not the "
                             "host-driven loop")
    cfg = PAGERANK
    init, ticks = out["init"], out["ticks"]
    ms = sorted(t["s"] * 1e3 for t in ticks)
    med = ms[len(ms) // 2]
    dops = sum(t["delta_ops"] for t in ticks) / sum(t["s"] for t in ticks)
    log(f"[pagerank] {cfg['n_nodes']} nodes, {cfg['n_edges']} edges, churn "
        f"{cfg['churn']:g} ({2 * int(cfg['churn'] * cfg['n_edges'])} delta "
        f"rows a tick), tol {cfg['tol']:g}, seed {cfg['seed']}; arena "
        f"{out['arena']} rows [{card}]")
    log(f"[pagerank] churn ticks ms: "
        f"{[round(t['s'] * 1e3, 3) for t in ticks]}; passes: "
        f"{[t['passes'] for t in ticks]}; median {med:.3f} ms")
    log(f"[pagerank] initial tick {init['s'] * 1e3:.3f} ms in "
        f"{init['passes']} passes; incremental-vs-full "
        f"{init['s'] * 1e3 / med:.3f}x (initial over the churn median); "
        f"delta-ops/s over the churn ticks {dops:.1f}")
    log(f"[pagerank] forced syncs {out['forced_syncs']} (per tick: initial "
        f"{init['syncs']}, churn {[t['syncs'] for t in ticks]}; of them "
        f"compact-or-append readbacks {init['branch_syncs']} + "
        f"{sum(t['branch_syncs'] for t in ticks)}); one quiescence "
        f"readback per pass besides")
    log(f"[pagerank] arena rcount {out['rcount']} of {out['arena']}, gen "
        f"{out['gen']} (compactions); peak device memory "
        f"{out['peak_bytes']} B")
    log(f"[pagerank] check vs the float64 reference ({out['ref_s']:.2f} s "
        f"on the host): max|rank - ref| / max(ref, 1) = "
        f"{out['rel_err']:.6g} at node {out['rel_err_at']} (bound "
        f"{PAGERANK_MAX_REL_ERR:g}); max abs {out['abs_err']:.6g}; "
        f"{out['keys']} ranks emitted")
    if out["rel_err"] > PAGERANK_MAX_REL_ERR:
        raise AssertionError(f"PageRank relative error {out['rel_err']:.3g} "
                             f"> {PAGERANK_MAX_REL_ERR:g}")

    traced = out["traced"]
    prof = traced["prof"]
    rep = trace_report("pagerank churn", traced["s"], prof, card,
                       PAGERANK_HOST_OPS)
    log(f"[trace] pagerank churn tick: {traced['passes']} passes; host op "
        f"counts: " + ", ".join(f"{op} {n}"
                                for op, n in rep["counts"].items()))
    spans = span_table(prof)
    total = sum(b - a for a, b, _ in rep["dev"])
    for name, (us, n, host) in sorted(spans.items(),
                                      key=lambda kv: -kv[1][0]):
        log(f"[trace] pagerank composition {name}: device {us / 1e3:.3f} ms "
            f"in {n} device ops ({n / traced['passes']:.1f} a pass); host "
            f"{host / 1e3:.3f} ms")
    log(f"[trace] pagerank outside the compositions (uploads, the "
        f"scheduler's per-pass count and readback): device "
        f"{(total - sum(s[0] for s in spans.values())) / 1e3:.3f} ms of "
        f"{total / 1e3:.3f} ms")

    # compaction at full width: this run's arena compacted on the card and
    # on the CPU, bit for bit; its device time and ops (its main-path
    # trigger lies past the eight churn ticks' headroom)
    js = out.pop("join_state")
    compacted = compact_arena(js)
    _bit_equal(compacted, compact_arena({k: v.cpu() for k, v in js.items()}))
    c_ms = time_ms(lambda: compact_arena(js), iters=5, warmup=2)
    c_prof = _profile(lambda: compact_arena(js), 1)
    c_dev = _device_events(c_prof)
    log(f"[pagerank] compact_arena on the final arena ({int(js['rcount'])} "
        f"rows -> {int(compacted['rcount'])} live): == the CPU's bit for "
        f"bit; {c_ms:.3f} ms by events, device "
        f"{sum(b - a for a, b, _ in c_dev) / 1e3:.3f} ms in {len(c_dev)} "
        f"device ops [{card}]")
    out.update(median_ms=med, delta_ops_per_s=dops,
               incr_vs_full=init["s"] * 1e3 / med, compact_ms=c_ms)
    return out


# -- phase 6: PageRank through the fused delta-vector loop --------------------

def _tier_str(tiers, prog) -> str:
    """A tick's (base, tail) tier per pass: the base budget (or ``D`` for
    the dense tier) and ``+`` the tail budget when the tail ran."""
    def one(ix_b, ix_t):
        b = (str(prog.tiers[ix_b]) if ix_b < len(prog.tiers) else "D")
        return b + (f"+{prog.tail_tiers[ix_t]}" if ix_t is not None else "")
    return " ".join(one(*p) for p in tiers or [])


def _device_call(fn: Callable[[], object]) -> tuple:
    """(ms by CUDA events over 3 calls, device ms and ops of one call
    from a profiler trace) of ``fn``."""
    ms = time_ms(fn, iters=3, warmup=1)
    dev = _device_events(_profile(fn, 1))
    return ms, sum(b - a for a, b, _ in dev) / 1e3, len(dev)


def phase_fused(card: str) -> Dict[str, object]:
    """The executor's default path for PageRank: the fused loop with its
    persistent CSR, the initial tick and 16 churn ticks at full width
    (the tail overflows about the 9th, the arena compacts about the
    16th), one traced churn tick; then the CSR's full and tail builds
    timed alone on the final arena."""
    torch.cuda.reset_peak_memory_stats()
    cfg = FUSED
    out = pagerank_slice(cfg, {}, tag="fused")
    ex, pg = out.pop("executor"), out.pop("pg")
    prog = ex._fx_program
    if not isinstance(prog, LinearFixpointProgram):
        raise AssertionError(f"phase 6 ran {type(prog).__name__}, not the "
                             f"fused loop")
    init, ticks, traced = out["init"], out["ticks"], out["traced"]
    # every tick that ran, in order, for the per-tick lines and checks
    ran = [init] + ticks + out["lost"] + [traced]
    ms = sorted(t["s"] * 1e3 for t in ticks)
    med = ms[len(ms) // 2]
    dops = sum(t["delta_ops"] for t in ticks) / sum(t["s"] for t in ticks)
    log(f"[fused] {cfg['n_nodes']} nodes, {cfg['n_edges']} edges, churn "
        f"{cfg['churn']:g}, tol {cfg['tol']:g}, seed {cfg['seed']}; arena "
        f"{out['arena']} rows; base tiers {prog.tiers}, tail window "
        f"{prog.Ft} rows, tail tiers {prog.tail_tiers} [{card}]")
    for i, t in enumerate(ran):
        kind = ("initial" if i == 0 else "traced" if i == len(ran) - 1
                else f"churn {i}" if i <= len(ticks)
                else f"churn {i} (trace lost)")
        log(f"[fused] {kind} tick: {t['s'] * 1e3:.3f} ms, {t['passes']} "
            f"passes, {t['readbacks']} readbacks, csr "
            f"{t['csr'] or 'kept'} (tail {t['tail_rows']} rows); tiers "
            f"{_tier_str(t['tiers'], prog)}")
    log(f"[fused] churn ticks ms: {[round(t['s'] * 1e3, 3) for t in ticks]}"
        f"; passes {[t['passes'] for t in ticks]}; median {med:.3f} ms; "
        f"initial {init['s'] * 1e3:.3f} ms in {init['passes']} passes; "
        f"incremental-vs-full {init['s'] * 1e3 / med:.3f}x; delta-ops/s "
        f"{dops:.1f}")
    causes = [t["csr"] for t in ran]
    log(f"[fused] CSR rebuilds by cause: {dict(ex.csr_rebuilds)} (per tick "
        f"{causes}); arena rcount {out['rcount']}, gen {out['gen']}; "
        f"stable_key/overflow flag {out['error_flag']}; peak device memory "
        f"{out['peak_bytes']} B; forced syncs {out['forced_syncs']}")
    log(f"[fused] check vs the float64 reference ({out['ref_s']:.2f} s on "
        f"the host): max|rank - ref| / max(ref, 1) = {out['rel_err']:.6g} "
        f"at node {out['rel_err_at']} (bound {PAGERANK_MAX_REL_ERR:g}); max "
        f"abs {out['abs_err']:.6g}")
    if out["rel_err"] > PAGERANK_MAX_REL_ERR:
        raise AssertionError(f"fused PageRank relative error "
                             f"{out['rel_err']:.3g} > "
                             f"{PAGERANK_MAX_REL_ERR:g}")
    if causes[0] != "initial" or "tail" not in causes or "gen" not in causes:
        raise AssertionError(f"CSR rebuilds {causes}: expected the first "
                             f"tick's, a tail overflow and a gen bump")
    if out["error_flag"]:
        raise AssertionError("the join's sticky error flag is set")
    for t in ran:
        # one read a loop pass (the last sees it end), the CSR's
        # (gen, rcount), the compact-or-append, the error check
        if t["readbacks"] != t["passes"] + 3:
            raise AssertionError(f"a fused tick read back {t['readbacks']} "
                                 f"times in {t['passes']} passes")

    prof = traced["prof"]
    rep = trace_report("fused churn", traced["s"], prof, card,
                       PAGERANK_HOST_OPS)
    log(f"[trace] fused churn tick: {traced['passes']} passes; host op "
        f"counts: " + ", ".join(f"{op} {n}"
                                for op, n in rep["counts"].items()))
    spans = span_table(prof)
    total = sum(b - a for a, b, _ in rep["dev"])
    for name, (us, n, host) in sorted(spans.items(),
                                      key=lambda kv: -kv[1][0]):
        log(f"[trace] fused composition {name}: device {us / 1e3:.3f} ms in "
            f"{n} device ops ({n / traced['passes']:.1f} a pass); host "
            f"{host / 1e3:.3f} ms")
    log(f"[trace] fused outside the compositions (uploads, phase A's "
        f"unranged ops): device "
        f"{(total - sum(s[0] for s in spans.values())) / 1e3:.3f} ms of "
        f"{total / 1e3:.3f} ms; {len(rep['dev']) / traced['passes']:.1f} "
        f"device ops a pass")

    # the CSR builds alone on the final arena: a full rebuild (two stable
    # sorts over the arena) and a tail window of Ft rows
    jst = ex.states[pg.join.id]
    rc, gen, K = int(jst["rcount"]), int(jst["gen"]), cfg["n_nodes"]
    b_ms, b_dev, b_n = _device_call(
        lambda: prog._build_base(jst, K, rc, gen))
    t_ms, t_dev, t_n = _device_call(
        lambda: prog._build_tail(jst, K, max(rc - prog.Ft, 0), rc))
    log(f"[fused] CSR full rebuild on {rc} arena rows: {b_ms:.3f} ms by "
        f"events, device {b_dev:.3f} ms in {b_n} ops; tail build of "
        f"{prog.Ft} rows: {t_ms:.3f} ms, device {t_dev:.3f} ms in {t_n} ops "
        f"[{card}]")
    out.update(median_ms=med, delta_ops_per_s=dops,
               incr_vs_full=init["s"] * 1e3 / med, rebuild_ms=b_ms,
               tail_ms=t_ms)
    return out


def phase_row_leg(card: str) -> Dict[str, object]:
    """The row program (``linear_fixpoint=False``) at the same width: the
    initial tick and 2 churn ticks, the same error bound."""
    out = pagerank_slice(ROW_LEG, {"linear_fixpoint": False}, tag="row")
    prog = out.pop("executor")._fx_program
    if not isinstance(prog, FixpointProgram):
        raise AssertionError(f"the row leg ran {type(prog).__name__}")
    ticks = [out["init"]] + out["ticks"] + out["lost"] + [out["traced"]]
    log(f"[row] ticks ms {[round(t['s'] * 1e3, 3) for t in ticks]}, passes "
        f"{[t['passes'] for t in ticks]}, readbacks "
        f"{[t['readbacks'] for t in ticks]}; max|rank - ref| / max(ref, 1) "
        f"= {out['rel_err']:.6g} (bound {PAGERANK_MAX_REL_ERR:g}) [{card}]")
    if out["rel_err"] > PAGERANK_MAX_REL_ERR:
        raise AssertionError(f"row-program relative error "
                             f"{out['rel_err']:.3g}")
    return out


def phase_defer_leg(card: str) -> Dict[str, object]:
    """``defer_passes=1`` at the same width, as bench.py's deferred child
    runs it: the initial tick, a drain (the cold build's residue), 8
    streamed churn ticks of one loop pass each (timed; the amortized tick
    time), the mid-stream error, a drain, the drained error."""
    cfg = PAGERANK
    n, churn = cfg["n_nodes"], cfg["churn"]
    pg, web, ex, sched, _ = pagerank_setup(cfg, {}, defer=1)
    probe = 2 * int(churn * cfg["n_edges"])
    sched.push(pg.teleport, pagerank.teleport_batch(n))
    sched.push(pg.edges, web.initial_batch())
    sched.tick(sync=False)
    t0 = time.perf_counter()
    settle = sched.drain(pg.edges, probe_rows=probe)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    if not isinstance(ex._fx_program, LinearFixpointProgram):
        raise AssertionError("the deferred leg did not run the fused loop")
    walls = []
    for _ in range(8):
        t0 = time.perf_counter()
        sched.push(pg.edges, web.churn(churn))
        r = sched.tick(sync=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r.passes > 2:
            raise AssertionError(f"a deferred tick ran {r.passes} passes")
    mid = rank_error(sched, pg, web, n)
    t0 = time.perf_counter()
    drain = sched.drain(pg.edges, probe_rows=probe)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    done = rank_error(sched, pg, web, n)
    log(f"[defer] defer_passes=1: cold-build drain {settle} ticks in "
        f"{settle_s:.3f} s; churn ticks ms "
        f"{[round(w * 1e3, 3) for w in walls]}, amortized "
        f"{sum(walls) / len(walls) * 1e3:.3f} ms a tick; mid-stream "
        f"max|rank - ref| / max(ref, 1) = {mid['rel_err']:.6g}; drain "
        f"{drain} ticks in {drain_s:.3f} s; drained {done['rel_err']:.6g} "
        f"(bound {PAGERANK_MAX_REL_ERR:g}) [{card}]")
    if done["rel_err"] > PAGERANK_MAX_REL_ERR:
        raise AssertionError(f"drained relative error {done['rel_err']:.3g}")
    return {"amortized_ms": sum(walls) / len(walls) * 1e3,
            "mid_rel_err": mid["rel_err"], "drained_rel_err": done["rel_err"],
            "drain_ticks": drain}


def traced(fn: Callable[[], object]) -> tuple:
    """``fn()`` under ``torch.profiler`` (CPU + CUDA), the card synchronized
    inside: -> (result, wall seconds, profile)."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, wall, prof


def traced_step(prepare: Callable[[], Callable[[], object]],
                what: str) -> tuple:
    """:func:`traced` of the step that ``prepare()`` returns (its inputs
    made outside the trace), prepared and traced anew while the trace holds
    no device operation, at most ``TRACE_TRIES`` times: -> (result, wall
    seconds, profile) of the last."""
    for i in range(TRACE_TRIES):
        res, wall, prof = traced(prepare())
        if i == TRACE_TRIES - 1 or not trace_lost(prof, what):
            return res, wall, prof


def compositions(tag: str, kind: str, wall: float, prof, card: str,
                 passes: int = 1, host_ops=PAGERANK_HOST_OPS
                 ) -> Dict[str, object]:
    """:func:`trace_report` of one traced tick, then its device time,
    device ops and host time by ``reflow::`` range (a nested range, such
    as ``arena.append`` inside ``join.append_left``, counts in its parent
    too), and the device time outside every range."""
    rep = trace_report(f"{tag} {kind}", wall, prof, card, host_ops)
    spans = span_table(prof)
    total = sum(b - a for a, b, _ in rep["dev"])
    for name, (us, n, host) in sorted(spans.items(),
                                      key=lambda kv: -kv[1][0]):
        log(f"[trace] {tag} composition {name}: device {us / 1e3:.3f} ms in "
            f"{n} device ops ({n / passes:.1f} a pass); host "
            f"{host / 1e3:.3f} ms")
    top = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("reflow::"):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("reflow::"):
                p = p.cpu_parent
            if p is None:            # not nested in another range
                top += _under(e)[0]
    log(f"[trace] {tag} outside the compositions (uploads, readbacks, "
        f"unranged ops): device {(total - top) / 1e3:.3f} ms of "
        f"{total / 1e3:.3f} ms; host op counts: "
        + ", ".join(f"{op} {n}" for op, n in rep["counts"].items()))
    rep["spans"] = spans
    return rep


def _median(xs: List[float]) -> float:
    return sorted(xs)[len(xs) // 2]


# -- phase 7: word-count --------------------------------------------------

#: BASELINE.md config 1 at full width (bench_configs.py's setting: 100,000
#: lines drawn with default_rng(0) from 5,000 words, 5-14 words a line,
#: 10 ticks of 10,000 lines, one retraction tick of the first 10,000);
#: integer keys from the vocabulary into a key space of 8192
WORDCOUNT = dict(lines=100_000, words=5_000, per_tick=10_000,
                 key_space=8192, seed=0)


def phase_wordcount(card: str) -> Dict[str, object]:
    """Word-count through ``DirtyScheduler`` on the ``cuda`` executor: ten
    insert ticks and a retraction tick, timed from push to the card
    finishing (host tokenization outside), the sink view held exactly to
    a host ``Counter``; then one traced tick re-inserting the retracted
    lines, checked again."""
    cfg = WORDCOUNT
    rng = np.random.default_rng(cfg["seed"])
    # an array, not a list: rng.choice draws the same ids from either,
    # and converts a list anew on every call
    vocab_words = np.array([f"w{i}" for i in range(cfg["words"])])
    t0 = time.perf_counter()
    lines = [" ".join(rng.choice(vocab_words, size=rng.integers(5, 15)))
             for _ in range(cfg["lines"])]
    gen_s = time.perf_counter() - t0
    g, src, sink = wordcount.build_graph(cfg["key_space"])
    counts = next(n for n in g.nodes if n.kind == "op"
                  and n.op.kind == "reduce")
    sched = DirtyScheduler(g, get_executor("cuda"))
    vocab: Dict[str, int] = {}
    want: Counter = Counter()
    n = cfg["per_tick"]

    def check(label):
        words = {i: w for w, i in vocab.items()}
        got = {words[k]: v for k, v in sched.view_dict(sink).items()}
        table = {words[k]: v for k, v in sched.read_table(counts).items()}
        exp = {w: float(c) for w, c in want.items() if c}
        if got != exp or table != exp:
            raise AssertionError(f"word-count {label}: the view differs from "
                                 f"the host Counter at "
                                 f"{len(set(got.items()) ^ set(exp.items()))}"
                                 f" words")
        return len(exp)

    walls, dops, ingest = [], [], []
    ticks = [(lines[i:i + n], 1) for i in range(0, cfg["lines"], n)]
    ticks.append((lines[:n], -1))
    for chunk, weight in ticks:
        t0 = time.perf_counter()
        batch = wordcount.ingest_lines(chunk, weight, vocab=vocab)
        ingest.append(time.perf_counter() - t0)
        for line in chunk:
            for tok in wordcount.tokenize(line):
                want[tok] += weight
        t0 = time.perf_counter()
        sched.push(src, batch)
        r = sched.tick()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        dops.append(r.delta_ops)
    words = check("after the retraction tick")
    batch = wordcount.ingest_lines(lines[:n], 1, vocab=vocab)

    def one():
        sched.push(src, batch)
        return sched.tick()

    def prepare():
        # each step inserts the retracted lines once more
        for line in lines[:n]:
            for tok in wordcount.tokenize(line):
                want[tok] += 1
        return one

    r, wall, prof = traced_step(prepare, "wordcount insert tick")
    check("after the traced tick")
    rep = compositions("wordcount", "insert", wall, prof, card)
    med = _median(walls)
    log(f"[wordcount] {cfg['lines']} lines from {cfg['words']} words "
        f"(made in {gen_s:.2f} s), {len(vocab)} keys of {cfg['key_space']}; "
        f"tick ms {[round(w * 1e3, 3) for w in walls]} (last: the "
        f"retraction); median {med * 1e3:.3f} ms; delta-ops/s "
        f"{sum(dops) / sum(walls):.1f}; host tokenization median "
        f"{_median(ingest) * 1e3:.3f} ms a tick (outside the tick); the "
        f"view == the host Counter exactly ({words} words); traced tick "
        f"{r.delta_ops} delta-ops, device busy "
        f"{rep['busy_share'] * 100:.1f}% [{card}]")
    return {"median_ms": med * 1e3, "delta_ops_per_s": sum(dops) / sum(walls),
            "busy_share": rep["busy_share"]}


# -- phase 8: streaming TF-IDF ----------------------------------------------

#: BASELINE.md config 2 at full width (bench_configs.py's setting: 4,096
#: docs, 2^20 terms and pairs, a 250,000-word vocabulary, default_rng(1);
#: 2,048 docs loaded, then 512 single edits padded to 256 rows through
#: tick_many, then 32 ticks of 64 edits padded to 8,192 rows)
TFIDF = dict(docs=4096, n_terms=1 << 20, n_pairs=1 << 20, vocab=250_000,
             seed=1, edits=512, edit_rows=256, group=64, group_ticks=32,
             group_rows=8192, warm=16)


def _pad(batch: DeltaBatch, rows: int) -> DeltaBatch:
    """``batch`` padded with weight-0 rows to ``rows`` (one capacity
    bucket for every tick), as bench_configs.py pads it."""
    pad = rows - len(batch)
    if pad <= 0:
        return batch
    return DeltaBatch(
        np.concatenate([batch.keys, np.zeros(pad, np.int64)]),
        np.concatenate([batch.values, np.zeros((pad,) + batch.values.shape[1:],
                                               batch.values.dtype)]),
        np.concatenate([batch.weights, np.zeros(pad, np.int64)]))


def phase_tfidf(card: str) -> Dict[str, object]:
    """Streaming TF-IDF through ``DirtyScheduler`` on the ``cuda``
    executor: the initial load, the single-edit phase and the batched
    phase through ``tick_many`` windows (the ingress queue; no fallback,
    no forced sync between the stage and ``block()``), the same feeds
    through per-tick ``tick()``s on a twin scheduler (amortized tick ms of
    both, delta-ops/s with pad rows left out; the twin's tables equal the
    window's exactly), one traced batched tick; the ``tf``/``df``/``ndocs``
    tables held exactly to counts recomputed from the corpus, and the
    combined TF-IDF to ``Corpus.reference_tfidf`` within 1e-5 relative."""
    cfg = TFIDF
    rng = np.random.default_rng(cfg["seed"])
    words = np.array([f"t{i}" for i in range(cfg["vocab"])])
    corpus = tfidf.Corpus(cfg["n_pairs"], cfg["n_terms"])
    tg = tfidf.build_graph(cfg["n_pairs"], cfg["n_terms"], cfg["docs"])
    ex = get_executor("cuda")
    sched = DirtyScheduler(tg.graph, ex)
    # the per-tick twin: the same graph on its own executor, fed the same
    # deltas one tick at a time
    tg2 = tfidf.build_graph(cfg["n_pairs"], cfg["n_terms"], cfg["docs"])
    twin = DirtyScheduler(tg2.graph, get_executor("cuda"))

    def text():
        return " ".join(rng.choice(words, size=rng.integers(20, 60)))

    def edit():
        return corpus.edit(int(rng.integers(0, cfg["docs"])), text())

    t0 = time.perf_counter()
    load = DeltaBatch.concat(
        [corpus.edit(d, text()) for d in range(cfg["docs"] // 2)])
    sched.push(tg.tokens, load)
    r = sched.tick()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    twin.push(tg2.tokens, load)
    twin.tick()
    log(f"[tfidf] initial load: {cfg['docs'] // 2} docs, {r.deltas_in} rows, "
        f"{load_s * 1e3:.3f} ms (host text and edits included)")

    def make(n_ticks, per_tick, rows):
        batches, pads = [], 0
        for _ in range(n_ticks):
            b = DeltaBatch.concat([edit() for _ in range(per_tick)])
            if len(b) > rows:
                raise AssertionError(f"an edit tick of {len(b)} rows > {rows}")
            pads += rows - len(b)
            batches.append(_pad(b, rows))
        return batches, pads

    windows = {"calls": 0, "syncs": 0, "reads": 0, "traced": 0}

    def window(batches, pads):
        w0, f0 = sched.megatick_windows, sched.megatick_fallbacks
        s0, r0 = sched.forced_syncs, ex.loop_reads
        t0 = time.perf_counter()
        agg = sched.tick_many([{tg.tokens: b} for b in batches])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # between stage_window and block(): no forced sync, no loop read
        windows["syncs"] += sched.forced_syncs - s0
        windows["reads"] += ex.loop_reads - r0
        agg.block()
        windows["calls"] += 1
        if (sched.megatick_windows - w0, sched.megatick_fallbacks - f0) \
                != (1, 0):
            raise AssertionError("a tfidf tick_many call did not take "
                                 "one window")
        return wall, agg.delta_ops - pads

    def per_tick(batches):
        t0 = time.perf_counter()
        for b in batches:
            twin.push(tg2.tokens, b)
            twin.tick(sync=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = make(cfg["warm"], 1, cfg["edit_rows"])
    window(*warm)
    per_tick(warm[0])
    single = make(cfg["edits"], 1, cfg["edit_rows"])
    s_wall, s_ops = window(*single)
    s_tick = per_tick(single[0])
    grouped = make(cfg["group_ticks"], cfg["group"], cfg["group_rows"])
    b_wall, b_ops = window(*grouped)
    b_tick = per_tick(grouped[0])

    def prepare():
        b = _pad(DeltaBatch.concat([edit() for _ in range(cfg["group"])]),
                 cfg["group_rows"])
        twin.push(tg2.tokens, b)
        twin.tick()
        windows["traced"] += 1
        return lambda: sched.tick_many([{tg.tokens: b}])

    _, t_wall, prof = traced_step(prepare, "tfidf batched tick")
    rep = compositions("tfidf", "batched", t_wall, prof, card)
    if windows["syncs"] or windows["reads"] or \
            sched.megatick_fallbacks or \
            sched.megatick_windows != windows["calls"] + windows["traced"]:
        raise AssertionError(f"tfidf windows: {windows}, megatick_windows "
                             f"{sched.megatick_windows}, fallbacks "
                             f"{sched.megatick_fallbacks}")

    # exact tables against counts from the corpus, then the combine
    t0 = time.perf_counter()
    tf_want = {corpus.pairs[(d, t)]: float(c)
               for d, cnt in corpus.docs.items() for t, c in cnt.items()}
    df_want: Counter = Counter()
    for cnt in corpus.docs.values():
        df_want.update(set(cnt))
    tables = [sched.read_table(n) for n in (tg.tf, tg.df, tg.ndocs)]
    for name, got, want in zip(
            ("tf", "df", "ndocs"), tables,
            (tf_want, {t: float(c) for t, c in df_want.items()},
             {0: float(len(corpus.docs))})):
        if {int(k): float(v) for k, v in got.items()} != want:
            raise AssertionError(f"tfidf {name} table != the corpus's counts")
    twin_tables = [twin.read_table(n) for n in (tg2.tf, tg2.df, tg2.ndocs)]
    for name, got, want in zip(("tf", "df", "ndocs"), twin_tables, tables):
        if {int(k): float(v) for k, v in got.items()} != \
                {int(k): float(v) for k, v in want.items()}:
            raise AssertionError(f"tfidf {name}: the per-tick twin's table "
                                 f"!= the window path's")
    got = tfidf.tfidf_view(sched, tg, corpus)
    ref = corpus.reference_tfidf()
    if set(got) != set(ref):
        raise AssertionError("tfidf view keys != the reference's")
    rel = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in ref
              if ref[k] != 0.0)
    zero_ok = all(got[k] == 0.0 for k in ref if ref[k] == 0.0)
    if rel > 1e-5 or not zero_ok:
        raise AssertionError(f"tfidf view vs reference: relative {rel:.3g}")
    check_s = time.perf_counter() - t0
    n_edits = cfg["edits"]
    queues = [q for key, q in ex._window_cache.items()
              if key[0] == "ingress_q"]
    log(f"[tfidf] {cfg['docs']} docs, {cfg['n_terms']} terms, "
        f"{cfg['n_pairs']} pairs, {len(corpus.terms)} terms and "
        f"{len(corpus.pairs)} pairs interned [{card}]")
    log(f"[tfidf] single edits: {n_edits} ticks of {cfg['edit_rows']} "
        f"rows, one window: {s_wall * 1e3:.3f} ms = "
        f"{s_wall / n_edits * 1e3:.4f} ms a tick amortized, "
        f"{s_ops / s_wall:.1f} delta-ops/s (pad rows out); per-tick tick()s "
        f"of the same feeds: {s_tick * 1e3:.3f} ms = "
        f"{s_tick / n_edits * 1e3:.4f} ms a tick [{card}]")
    log(f"[tfidf] batched: {cfg['group_ticks']} ticks of {cfg['group']} "
        f"edits ({cfg['group_rows']} rows), one window: "
        f"{b_wall * 1e3:.3f} ms = "
        f"{b_wall / cfg['group_ticks'] * 1e3:.4f} ms a tick amortized, "
        f"{b_ops / b_wall:.1f} delta-ops/s, "
        f"{cfg['group'] * cfg['group_ticks'] / b_wall:.1f} edits/s; "
        f"per-tick tick()s of the same feeds: {b_tick * 1e3:.3f} ms = "
        f"{b_tick / cfg['group_ticks'] * 1e3:.4f} ms a tick [{card}]")
    log(f"[tfidf] window path: megatick_windows {sched.megatick_windows}, "
        f"megatick_fallbacks {sched.megatick_fallbacks}, forced syncs and "
        f"loop reads between stage and block() {windows['syncs']} and "
        f"{windows['reads']}; {len(queues)} ingress queues, "
        f"{sum(q.nbytes for q in queues)} B on the card")
    log(f"[tfidf] tf ({len(tables[0])} pairs), df ({len(tables[1])} terms) "
        f"and ndocs ({len(corpus.docs)}) == the corpus's counts exactly "
        f"and == the per-tick twin's; "
        f"tfidf view max relative error {rel:.3g} (bound 1e-5) over "
        f"{len(ref)} pairs; check {check_s:.2f} s on the host; traced "
        f"batched tick device busy {rep['busy_share'] * 100:.1f}%; forced "
        f"syncs {sched.forced_syncs} [{card}]")
    return {"single_ms": s_wall / n_edits * 1e3,
            "single_dops": s_ops / s_wall,
            "single_tick_ms": s_tick / n_edits * 1e3,
            "batched_ms": b_wall / cfg["group_ticks"] * 1e3,
            "batched_tick_ms": b_tick / cfg["group_ticks"] * 1e3,
            "batched_dops": b_ops / b_wall, "rel_err": rel}


# -- phase 9: incremental SSSP ----------------------------------------------

#: 100,000 nodes and 1,000,000 uniform edges with integer weights 1-9
#: (default_rng(7)), source node 0; 32 candidates a key (above the
#: distinct candidate distances a node sees at mean in-degree 10); 4
#: insertion ticks and 4 deletion ticks of 10,000 edges; a loop cap of 256
#: passes a tick (a tick that reaches it is repaired through affected_set
#: and repair); the repair leg's deletion tick of 1,024 edges under a cap
#: of one loop pass (its affected set is small enough for the arena's
#: headroom: about 460 nodes and 4,400 in-edges at this size); a refresh
#: of 1,024 keys
SSSP = dict(n_nodes=100_000, n_edges=1_000_000, seed=7, candidates=32,
            churn=10_000, insert_ticks=4, delete_ticks=4, max_iters=256,
            refresh_keys=1024, repair_churn=1024, repair_cap=1)


def phase_sssp(card: str) -> Dict[str, object]:
    """Incremental SSSP through ``DirtyScheduler`` on the ``cuda``
    executor (the row fixpoint program: the loop is a min, not linear):
    the initial tick, insertion and deletion ticks, each table held to
    Bellman-Ford exactly with the sticky flags clear; a halted tick goes
    through ``affected_set`` + ``repair``; the repair leg (a deletion tick
    halted by a loop cap of one pass, then repaired); then
    ``refresh_minmax`` over 1,024 keys from a host replay of their live
    candidates."""
    cfg = SSSP
    n, e = cfg["n_nodes"], cfg["n_edges"]
    rng = np.random.default_rng(cfg["seed"])
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.integers(1, 10, e).astype(np.float32)
    # the edges, then every churn tick's live appends
    arena = (bucket_capacity(e) + (cfg["insert_ticks"] + cfg["delete_ticks"])
             * bucket_capacity(cfg["churn"]))
    sg = sssp.build_graph(n, arena_capacity=arena,
                          candidates=cfg["candidates"])
    torch.cuda.reset_peak_memory_stats()
    ex = get_executor("cuda")
    sched = DirtyScheduler(sg.graph, ex, max_loop_iters=cfg["max_iters"])
    best = sg.best
    join = next(nd for nd in sg.graph.nodes
                if nd.kind == "op" and nd.op.kind == "join")
    ticks: List[Dict[str, object]] = []
    repairs = 0

    def tick(kind, pushes, trace=False):
        s0, r0, h0 = sched.forced_syncs, ex.loop_reads, ex.host_syncs

        def run():
            for node, b in pushes:
                sched.push(node, b)
            return sched.tick()

        if trace:
            r, wall, prof = traced(run)
        else:
            t0 = time.perf_counter()
            r = run()
            torch.cuda.synchronize()
            wall, prof = time.perf_counter() - t0, None
        rec = {"kind": kind, "s": wall, "passes": r.passes,
               "quiesced": r.quiesced, "loop_reads": ex.loop_reads - r0,
               "syncs": sched.forced_syncs - s0,
               "branch": ex.host_syncs - h0, "prof": prof,
               "delta_ops": r.block().delta_ops}
        ticks.append(rec)
        return rec

    def check(label):
        table = sched.read_table(best)
        t0 = time.perf_counter()
        ref = sssp.reference_distances(n, src, dst, w, 0)
        ref_s = time.perf_counter() - t0
        got = {int(k): float(v) for k, v in table.items()}
        if got != ref:
            bad = set(got.items()) ^ set(ref.items())
            raise AssertionError(f"sssp {label}: {len(bad)} distances differ "
                                 f"from Bellman-Ford")
        if bool(ex.states[best.id]["error"]) or \
                bool(ex.states[join.id]["error"]):
            raise AssertionError(f"sssp {label}: a sticky flag is set")
        return got, ref_s

    init = tick("initial", [(sg.seeds, sssp.seed_batch(0)),
                            (sg.edges, sssp.edge_batch(src, dst, w))])
    table, ref_s = check("initial")
    for i in range(cfg["insert_ticks"]):
        ns, nd = rng.integers(0, n, cfg["churn"]), rng.integers(0, n,
                                                                cfg["churn"])
        nw = rng.integers(1, 10, cfg["churn"]).astype(np.float32)
        src, dst, w = (np.concatenate([src, ns]), np.concatenate([dst, nd]),
                       np.concatenate([w, nw]))
        tick("insert", [(sg.edges, sssp.edge_batch(ns, nd, nw))])
        table, _ = check(f"insert tick {i + 1}")
    i = 0
    while True:
        last = i >= cfg["delete_ticks"] - 1      # the traced tick
        ix = rng.choice(len(src), cfg["churn"], replace=False)
        keep = np.setdiff1d(np.arange(len(src)), ix)
        rec = tick("delete", [(sg.edges, sssp.edge_batch(
            src[ix], dst[ix], w[ix], weight=-1))], trace=last)
        prev, (ds, dd, dw) = table, (src[ix], dst[ix], w[ix])
        src, dst, w = src[keep], dst[keep], w[keep]
        if not rec["quiesced"]:
            aff = sssp.affected_set(n, src, dst, w, prev, ds, dd, dw)
            t0 = time.perf_counter()
            r1, r2 = sssp.repair(sched, sg, src, dst, w, aff)
            torch.cuda.synchronize()
            repairs += 1
            log(f"[sssp] delete tick {i + 1} halted at {rec['passes']} "
                f"passes; repaired {len(aff)} affected nodes in "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms ({r1.passes} + "
                f"{r2.passes} passes)")
        table, _ = check(f"delete tick {i + 1}")
        i += 1
        # a traced tick whose trace was lost is followed by another
        if last and (i == cfg["delete_ticks"] - 1 + TRACE_TRIES
                     or not trace_lost(rec["prof"], "sssp delete tick")):
            break

    # the repair leg: a deletion tick under a loop cap it cannot meet
    # halts with its carry pending; affected_set + repair, the cap
    # restored, re-derive the affected region in place (the repair's
    # retract tick resumes the paused carry)
    sched.max_loop_iters = cfg["repair_cap"]
    ix = rng.choice(len(src), cfg["repair_churn"], replace=False)
    keep = np.setdiff1d(np.arange(len(src)), ix)
    t0 = time.perf_counter()
    sched.push(sg.edges, sssp.edge_batch(src[ix], dst[ix], w[ix], weight=-1))
    halted = sched.tick()
    torch.cuda.synchronize()
    halt_ms = (time.perf_counter() - t0) * 1e3
    sched.max_loop_iters = cfg["max_iters"]
    if halted.quiesced:
        raise AssertionError(f"sssp: a deletion tick of {len(ix)} edges "
                             f"under max_loop_iters={cfg['repair_cap']} "
                             f"quiesced; the repair leg needs a halt")
    prev, (ds, dd, dw) = table, (src[ix], dst[ix], w[ix])
    src, dst, w = src[keep], dst[keep], w[keep]
    t0 = time.perf_counter()
    aff = sssp.affected_set(n, src, dst, w, prev, ds, dd, dw)
    aff_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r1, r2 = sssp.repair(sched, sg, src, dst, w, aff)
    torch.cuda.synchronize()
    repair_ms = (time.perf_counter() - t0) * 1e3
    repairs += 1
    if not (r1.quiesced and r2.quiesced):
        raise AssertionError("sssp: a repair tick did not quiesce")
    table, _ = check("after the repair leg")
    peak = torch.cuda.max_memory_allocated()

    # refresh: 1,024 keys' full live candidate multisets from the host
    keys = rng.choice(np.array(sorted(table), np.int64),
                      cfg["refresh_keys"], replace=False)
    dist = np.full(n, np.nan, np.float32)
    for k, v in table.items():
        dist[k] = v
    m = np.isin(dst, keys) & ~np.isnan(dist[src])
    rk = np.concatenate([dst[m], [0] if 0 in keys else []]).astype(np.int64)
    rv = np.concatenate([dist[src[m]] + w[m],
                         [0.0] if 0 in keys else []]).astype(np.float32)
    st = ex.states[best.id]
    latched = int(st["over_maybe_pos"][torch.from_numpy(keys).cuda()].sum())
    t0 = time.perf_counter()
    sched.refresh_minmax(best, DeltaBatch(rk, rv, np.ones(len(rk), np.int64)))
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    st = ex.states[best.id]
    after = int(st["over_maybe_pos"][torch.from_numpy(keys).cuda()].sum())
    if {int(k): float(v) for k, v in sched.read_table(best).items()} != table:
        raise AssertionError("refresh_minmax changed the table")
    if bool(st["error"]):
        raise AssertionError("refresh_minmax set the sticky error")

    for t in ticks:
        # the row program reads once a loop pass and once more to see the
        # loop end (= passes: phase A's pass reads nothing); the tick's
        # forced syncs are the compact-or-append of its edge append and
        # the error check
        if t["loop_reads"] != t["passes"] or t["syncs"] != 1 + t["branch"] \
                or t["branch"] != 1:
            raise AssertionError(f"sssp {t['kind']} tick read back "
                                 f"{t['loop_reads']} + {t['syncs']} times in "
                                 f"{t['passes']} passes")
    churn = [t for t in ticks[1:] if t["prof"] is None]
    log(f"[sssp] {n} nodes, {e} edges (uniform, weights 1-9, seed "
        f"{cfg['seed']}), source 0, {cfg['candidates']} candidates, arena "
        f"{arena} rows, loop cap {cfg['max_iters']} passes [{card}]")
    log(f"[sssp] initial tick {init['s'] * 1e3:.3f} ms in {init['passes']} "
        f"passes; Bellman-Ford {ref_s:.2f} s on the host; {len(table)} "
        f"nodes reached")
    for t in ticks[1:]:
        log(f"[sssp] {t['kind']} tick: {t['s'] * 1e3:.3f} ms, "
            f"{t['passes']} passes, readbacks {t['loop_reads']} loop + "
            f"{t['syncs']} forced ({t['branch']} compact-or-append) = "
            f"passes + {t['loop_reads'] + t['syncs'] - t['passes']}, "
            f"quiesced {t['quiesced']}, {t['delta_ops']} delta-ops")
    log(f"[sssp] churn tick median {_median([t['s'] for t in churn]) * 1e3:.3f}"
        f" ms; every table == Bellman-Ford exactly, sticky flags clear; "
        f"ticks repaired {repairs}; peak device memory {peak} B; forced "
        f"syncs {sched.forced_syncs}")
    log(f"[sssp] repair leg: a deletion tick of {cfg['repair_churn']} "
        f"edges under max_loop_iters={cfg['repair_cap']} halted "
        f"(quiesced {halted.quiesced}, {halted.passes} passes, "
        f"{halt_ms:.3f} ms); affected_set {len(aff)} nodes in "
        f"{aff_ms:.3f} ms on the host; repair ({r1.passes} + {r2.passes} "
        f"passes, {r1.block().delta_ops + r2.block().delta_ops} delta-ops) "
        f"{repair_ms:.3f} ms; the table == Bellman-Ford exactly [{card}]")
    log(f"[sssp] refresh_minmax of {cfg['refresh_keys']} keys ({len(rk)} "
        f"replay rows): {refresh_ms:.3f} ms; latched keys {latched} -> "
        f"{after}; table unchanged, error flag clear [{card}]")
    traced_del = ticks[-1]
    compositions("sssp", "delete", traced_del["s"], traced_del["prof"],
                 card, passes=traced_del["passes"])
    if repairs < 1:
        raise AssertionError("sssp: no tick was repaired")
    return {"init_ms": init["s"] * 1e3, "init_passes": init["passes"],
            "churn_median_ms": _median([t["s"] for t in churn]) * 1e3,
            "repairs": repairs, "repair_ms": repair_ms, "peak_bytes": peak,
            "refresh_ms": refresh_ms}


# -- phase 10: the multiset-left Join ---------------------------------------

#: two multiset sources over 2^20 keys, the default merge, a sink;
#: 1,048,576 rows into each side in batches of 65,536, then 8 churn ticks
#: that retract 8,192 live rows and insert 8,192 new ones on each side.
#: Each arena holds the load plus four churn ticks' appends (65,536
#: rows), so each compacts once during churn; product_slack 4 gives each
#: delta 4 x its capacity in pair slots, against about 1 x at this
#: density (1 row a key a side)
MULTISET = dict(keys=1 << 20, rows=1 << 20, batch=1 << 16, churn_ticks=8,
                churn=8192, product_slack=4, seed=11)


def phase_multiset(card: str) -> Dict[str, object]:
    """A multiset-left Join at full width: load, churn, one traced churn
    tick; the sink's accumulated view held exactly to a numpy join of the
    final collections, the sticky flag clear, readbacks a tick equal to
    the sides appended."""
    cfg = MULTISET
    K = cfg["keys"]
    rng = np.random.default_rng(cfg["seed"])
    arena = cfg["rows"] + 4 * 2 * cfg["churn"]
    g = FlowGraph("multiset_join")
    spec = Spec((), np.float32, key_space=K)
    a = g.source("a", spec)
    b = g.source("b", spec)
    j = g.join(a, b, spec=Spec((2,), np.float32, key_space=K),
               arena_capacity=arena, left_arena_capacity=arena,
               product_slack=cfg["product_slack"], name="mj")
    sink = g.sink(j, "out")
    ex = get_executor("cuda")
    sched = DirtyScheduler(g, ex)
    sides = {"a": [np.empty(0, np.int64), np.empty(0, np.float32)],
             "b": [np.empty(0, np.int64), np.empty(0, np.float32)]}

    def fresh(m):
        return (rng.integers(0, K, m).astype(np.int64),
                rng.integers(0, 1000, m).astype(np.float32))

    recs = []

    def tick(pushes, trace=False):
        h0 = ex.host_syncs

        def run():
            for node, bt in pushes:
                sched.push(node, bt)
            return sched.tick()

        if trace:
            r, wall, prof = traced(run)
        else:
            t0 = time.perf_counter()
            r = run()
            torch.cuda.synchronize()
            wall, prof = time.perf_counter() - t0, None
        if ex.host_syncs - h0 != len(pushes):
            raise AssertionError(f"a tick appending {len(pushes)} sides read "
                                 f"back {ex.host_syncs - h0} times")
        out = r.sink_deltas.get("out")
        recs.append({"s": wall, "pairs": len(out) if out is not None else 0,
                     "prof": prof})
        return recs[-1]

    for _ in range(cfg["rows"] // cfg["batch"]):
        pushes = []
        for name, node in (("a", a), ("b", b)):
            k, v = fresh(cfg["batch"])
            sides[name] = [np.concatenate([sides[name][0], k]),
                           np.concatenate([sides[name][1], v])]
            pushes.append((node, DeltaBatch(k, v)))
        tick(pushes)
    load = list(recs)
    t = 0
    while True:
        last = t >= cfg["churn_ticks"] - 1       # the traced tick
        pushes = []
        for name, node in (("a", a), ("b", b)):
            keys, vals = sides[name]
            gone = rng.choice(len(keys), cfg["churn"], replace=False)
            k, v = fresh(cfg["churn"])
            bt = DeltaBatch(np.concatenate([keys[gone], k]),
                            np.concatenate([vals[gone], v]),
                            np.concatenate([-np.ones(cfg["churn"], np.int64),
                                            np.ones(cfg["churn"], np.int64)]))
            stay = np.ones(len(keys), bool)
            stay[gone] = False
            sides[name] = [np.concatenate([keys[stay], k]),
                           np.concatenate([vals[stay], v])]
            pushes.append((node, bt))
        rec = tick(pushes, trace=last)
        t += 1
        # a traced tick whose trace was lost is followed by another
        if last and (t == cfg["churn_ticks"] - 1 + TRACE_TRIES
                     or not trace_lost(rec["prof"], "multiset churn tick")):
            break
    # the traced ticks left out
    churn = [r for r in recs[len(load):] if r["prof"] is None]
    st = ex.states[j.id]
    gens = (int(st["lgen"]), int(st["gen"]))
    if bool(st["error"]):
        raise AssertionError("multiset join: the sticky flag is set")
    if min(gens) < 1:
        raise AssertionError(f"multiset join: arenas compacted {gens} times, "
                             f"expected at least once each")

    # the numpy join of the final collections against the sink's view
    t0 = time.perf_counter()
    (ka, va), (kb, vb) = sides["a"], sides["b"]
    oa, ob = np.argsort(ka, kind="stable"), np.argsort(kb, kind="stable")
    ka, va, kb, vb = ka[oa], va[oa], kb[ob], vb[ob]
    cb = np.bincount(kb, minlength=K)
    sb = np.cumsum(cb) - cb
    # each left row pairs with the cb[k] right rows of its key
    per = cb[ka]
    li = np.repeat(np.arange(len(ka)), per)
    within = np.arange(per.sum()) - np.repeat(np.cumsum(per) - per, per)
    ri = sb[ka[li]] + within
    want = np.stack([ka[li].astype(np.float64), va[li], vb[ri]], axis=1)
    rows = []
    for (k, v), wt in sched.view(sink).items():
        if wt < 0:
            raise AssertionError("multiset join view: a negative weight")
        rows.extend([(float(k), float(v[0]), float(v[1]))] * wt)
    got = np.array(rows, np.float64).reshape(-1, 3)
    want = want[np.lexsort(want.T[::-1])]
    got = got[np.lexsort(got.T[::-1])]
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"multiset join view ({len(got)} pairs) != the "
                             f"numpy join ({len(want)} pairs)")
    check_s = time.perf_counter() - t0
    log(f"[multiset] {K} keys, {cfg['rows']} rows a side in batches of "
        f"{cfg['batch']}, {cfg['churn_ticks']} churn ticks of "
        f"{cfg['churn']} retracts + {cfg['churn']} inserts a side; arenas "
        f"{arena} rows each, product_slack {cfg['product_slack']} "
        f"[{card}]")
    log(f"[multiset] load ticks ms {[round(r['s'] * 1e3, 1) for r in load]}"
        f"; pairs {[r['pairs'] for r in load]}")
    log(f"[multiset] churn ticks ms {[round(r['s'] * 1e3, 3) for r in churn]}"
        f", median {_median([r['s'] for r in churn]) * 1e3:.3f} ms; pairs a "
        f"tick {[r['pairs'] for r in churn]}; compactions (left, right) "
        f"{gens}; readbacks a tick = sides appended; sticky flag clear")
    log(f"[multiset] the sink's view == the numpy join exactly ({len(want)} "
        f"pairs; check {check_s:.2f} s on the host) [{card}]")
    tr = recs[-1]
    compositions("multiset", "churn", tr["s"], tr["prof"], card)
    return {"churn_median_ms": _median([r["s"] for r in churn]) * 1e3,
            "pairs": len(want), "compactions": gens}


# -- phase 11: image-embed ETL (config 5) -----------------------------------

#: BASELINE.md config 5 at full width (bench_configs.py:565-740): ViT-B/16
#: with init_vit(0) weights, 256 images a tick, 2^14 image ids, 64 groups
#: (id % 64), ImageStream seed 5; cut: 4 upload ticks and 4 on-card ticks
#: one at a time, then the window leg: tick_many windows of 4 ticks of
#: host images (bench_configs.py:586-630's shape), one warm and 2 timed
IMAGE_EMBED = dict(per_tick=256, n_images=1 << 14, n_groups=64, seed=5,
                   ticks=4, window_ticks=4, windows=2, check_images=32,
                   check_batch=256)
#: H100 SXM dense bf16 peak (NVIDIA's data sheet): the MFU denominator
BF16_OPS_PER_S = 989.4e12
#: the card's ViT against its plain version on the same tensors. _dot:
#: max |card - plain| over the product's largest magnitude (the same
#: exact products, summed in another order by the tensor cores); the
#: forward: max abs over features of magnitude 1-2.5 (a summation-order
#: difference can flip a bf16 rounding at the next product, and twelve
#: blocks compound it); the centroids: max abs against float64 group
#: means of the plain forward's features
VIT_DOT_REL_BOUND = 1e-4
VIT_FORWARD_BOUND = 2e-2
VIT_CENTROID_BOUND = 5e-3
#: host ops whose counts the traced image-embed tick reports
VIT_HOST_OPS = ("aten::mm", "aten::bmm", "aten::matmul", "aten::item",
                "aten::copy_")


def _weights(params: Dict) -> Dict:
    return {k: v for k, v in params.items() if k != "_cfg"}


def vit_checks(params: Dict, flat: int, seed: int, card: str
               ) -> Dict[str, float]:
    """``_dot`` and ``vit_forward`` on the card against their plain
    versions on the same tensors: the real weights at the main path's
    product shapes, and 32 images through the whole forward."""
    n = IMAGE_EMBED["check_images"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = n * params["pos"].shape[0]          # images x patches
    blk = params["blocks"][0]
    dot_err = 0.0
    for label, b in [("patch projection", params["proj_w"]),
                     ("wq", blk["wq"]), ("w1", blk["w1"]),
                     ("w2", blk["w2"])]:
        a = torch.randn((rows, b.shape[0]), generator=g, device="cuda")
        got, want = vit._dot(a, b), vit._dot_plain(a, b)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"_dot {label}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        if torch.equal(got, got.bfloat16().float()):
            raise AssertionError(f"_dot {label}: the output is rounded to "
                                 f"bf16")
        rel = float((got - want).abs().max() / want.abs().max())
        dot_err = max(dot_err, rel)
        log(f"[image_embed] _dot {label} [{rows}, {a.shape[1]}] x "
            f"{list(b.shape)}: max |card - plain| / max |plain| = "
            f"{rel:.3g} (bound {VIT_DOT_REL_BOUND:g}); output float32, "
            f"not bf16-rounded [{card}]")
    if dot_err > VIT_DOT_REL_BOUND:
        raise AssertionError(f"_dot vs plain: {dot_err:.3g}")
    px = torch.randint(0, 256, (n, flat), generator=g, device="cuda",
                       dtype=torch.uint8)
    x = image_embed.pixels_to_input(px)
    feats, plain = vit.vit_forward(params, x), vit.vit_forward_plain(params,
                                                                     x)
    fwd_err = float((feats - plain).abs().max())
    finite = bool(torch.isfinite(feats).all())
    log(f"[image_embed] vit_forward on {n} images: features "
        f"{list(feats.shape)} {feats.dtype}, finite {finite}, max |feature| "
        f"{float(plain.abs().max()):.4f}; max |card - plain| = "
        f"{fwd_err:.3g} (bound {VIT_FORWARD_BOUND:g}) [{card}]")
    if not finite or tuple(feats.shape) != (n, params["pos"].shape[1]) or \
            fwd_err > VIT_FORWARD_BOUND:
        raise AssertionError(f"vit_forward vs plain: {fwd_err:.3g}")
    return {"dot_rel_err": dot_err, "forward_err": fwd_err}


def launched_by_op(prof) -> List[tuple]:
    """``[(op, (device us, kernels))]`` over a trace, by the ``aten::`` op
    whose own launches they are (each kernel counted once, under the
    innermost op), largest first."""
    out: Dict[str, List[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("aten::") \
                and e.kernels:
            slot = out.setdefault(e.name, [0.0, 0])
            slot[0] += sum(k.duration for k in e.kernels)
            slot[1] += len(e.kernels)
    return sorted(((k, tuple(v)) for k, v in out.items()),
                  key=lambda kv: -kv[1][0])


def centroid_error(table: Dict[int, np.ndarray], stream, version: Dict,
                   weights: List[Dict]) -> float:
    """The centroid table against float64 group means of the plain
    forward's features (on the card, in batches) of every live image, each
    under the weights it was embedded with."""
    feats: Dict[int, List[np.ndarray]] = {}
    b = IMAGE_EMBED["check_batch"]
    for v, params in enumerate(weights):
        ids = sorted(i for i in stream.images if version[i] == v)
        for lo in range(0, len(ids), b):
            chunk = ids[lo:lo + b]
            px = torch.from_numpy(np.stack([stream.images[i]
                                            for i in chunk])).cuda()
            f = vit.vit_forward_plain(params, image_embed.pixels_to_input(
                px)).double().cpu().numpy()
            for i, row in zip(chunk, f):
                feats.setdefault(stream.groups[i], []).append(row)
    ref = {g: np.mean(rows, axis=0) for g, rows in feats.items()}
    if set(table) != set(ref):
        raise AssertionError(f"centroids: groups {sorted(table)} != "
                             f"{sorted(ref)}")
    return max(float(np.abs(np.asarray(table[g], np.float64) - ref[g]).max())
               for g in ref)


def phase_image_embed(card: str) -> Dict[str, object]:
    """Config 5 through ``DirtyScheduler`` on the ``cuda`` executor: the
    checks of the ViT against its plain version, a warm-up tick, the
    upload leg, the on-card leg, a group move, an ``update_params`` swap
    and a tick, one traced tick of each leg; the centroid table held to
    the plain forward's float64 group means."""
    cfg = IMAGE_EMBED
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = vit.init_vit(0, **vit.VIT_B_16)
    params1 = vit.init_vit(1, **vit.VIT_B_16)
    init_s = time.perf_counter() - t0
    mcfg = params["_cfg"]
    flat = mcfg["img"] * mcfg["img"] * mcfg["chans"]
    n, G, N = cfg["per_tick"], cfg["n_groups"], cfg["n_images"]
    checks = vit_checks(params, flat, cfg["seed"], card)

    ig = image_embed.build_graph(N, G, params)
    ex = get_executor("cuda")
    sched = DirtyScheduler(ig.graph, ex)
    stream = image_embed.ImageStream(params, seed=cfg["seed"])
    version: Dict[int, int] = {}        # image id -> the weights it used
    state = {"next": 0, "weights": 0}

    def host_batch() -> DeltaBatch:
        ids = np.arange(state["next"], state["next"] + n, dtype=np.int64)
        state["next"] += n
        for i in ids:
            version[int(i)] = state["weights"]
        return stream.insert(ids, ids % G)

    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"] + 1)
    made: List[tuple] = []                   # (DeviceDelta, weights)

    def device_batch() -> DeviceDelta:
        base = state["next"]
        state["next"] += n
        ids = torch.arange(base, base + n, device="cuda")
        pix = torch.randint(0, 256, (n, flat), generator=gen, device="cuda",
                            dtype=torch.uint8)
        vals = torch.cat([(ids % G).to(torch.uint8)[:, None], pix], dim=1)
        d = DeviceDelta((ids % N).to(torch.int32), vals,
                        torch.ones(n, dtype=torch.int32, device="cuda"))
        made.append((d, state["weights"]))
        return d

    def tick(make) -> float:
        """One tick of the batch ``make()`` returns, timed from the call
        (host batches are built before it; the on-card leg makes its
        pixels inside the clock, as bench_configs.py's does)."""
        t0 = time.perf_counter()
        sched.push(ig.images, make())
        sched.tick()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def built(batch):
        return lambda: batch

    warm_s = tick(built(host_batch()))       # cuBLAS picks its heuristics
    t0 = time.perf_counter()
    feeds = [host_batch() for _ in range(cfg["ticks"])]
    feed_s = time.perf_counter() - t0
    upload = [tick(built(b)) for b in feeds]
    on_card = [tick(device_batch) for _ in range(cfg["ticks"])]

    # the window leg: tick_many windows of host images through the
    # ingress queue (pinned staging, asynchronous slot copies), feeds
    # built before the clock; the first window allocates the queue
    K = cfg["window_ticks"]
    win_walls: List[float] = []
    for w in range(1 + cfg["windows"]):
        wfeeds = [{ig.images: host_batch()} for _ in range(K)]
        w0 = sched.megatick_windows
        t0 = time.perf_counter()
        sched.tick_many(wfeeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sched.megatick_windows != w0 + 1 or sched.megatick_fallbacks:
            raise AssertionError("an image_embed tick_many call did not "
                                 "take one window")
        if w:
            win_walls.append(wall)
    staged_mb = sum(len(f[ig.images]) * (4 + 4 + f[ig.images].values[0].size
                                          * f[ig.images].values.itemsize)
                    for f in wfeeds) / 1e6
    (queue,) = [q for key, q in ex._window_cache.items()
                if key[0] == "ingress_q"]
    # the same windows through the serving pump at depth 2: every batch
    # submitted while paused, then one backlog of 2 windows, the second
    # staged while the first runs on the card
    pump_batches = [host_batch() for _ in range(2 * K)]
    fe = IngestFrontend(sched, window=CoalesceWindow(
        max_rows=n, max_ticks=K, max_latency_s=0.001), max_bytes=1 << 32)
    try:
        fe.pause()
        tks = [fe.submit(ig.images, b) for b in pump_batches]
        t0 = time.perf_counter()
        fe.resume()
        fe.flush(timeout=120)
        torch.cuda.synchronize()
        pump_wall = time.perf_counter() - t0
        if not all(t.result(timeout=60).applied for t in tks):
            raise AssertionError("an image_embed pump ticket was not "
                                 "applied")
    finally:
        fe.close()
    if (fe.depth, fe.windows_staged, fe.windows_pipelined) != (2, 2, 1):
        raise AssertionError(f"image_embed pump: depth {fe.depth}, staged "
                             f"{fe.windows_staged}, pipelined "
                             f"{fe.windows_pipelined}")
    pump_overlap = fe.stage_overlap_frac
    # the upload leg's host boundary alone: the scheduler's concat of the
    # pending batch, and to_device (the padded host copy and the
    # pageable host-to-card copy)
    t0 = time.perf_counter()
    merged = DeltaBatch.concat([feeds[0]])
    concat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    to_device(merged, ig.images.spec)
    torch.cuda.synchronize()
    to_device_s = time.perf_counter() - t0
    del merged
    move_s = tick(built(stream.move(0, 2)))
    before = {g: np.asarray(v) for g, v in
              sched.read_table(ig.centroids).items()}

    # the swap: same scheduler, same executor, the next tick's features
    # under the new weights
    ex.update_params(ig.embed, _weights(params1))
    state["weights"] = 1
    swap_s = tick(built(host_batch()))
    after = sched.read_table(ig.centroids)
    changed = sum(not np.allclose(after[g], before[g]) for g in before)
    if sched.executor is not ex or changed != len(before):
        raise AssertionError(f"update_params: {changed} of {len(before)} "
                             f"centroids changed")

    # one traced tick of each leg: host images (the upload path in the
    # trace) and images made on the card
    reps = {}
    for kind, make in (("upload", host_batch), ("on-card", device_batch),
                       ("window", None)):
        def prepare(make=make):
            if make is None:
                wf = [{ig.images: host_batch()} for _ in range(K)]
                return lambda: sched.tick_many(wf)
            b = make()

            def one():
                sched.push(ig.images, b)
                return sched.tick()
            return one

        _, t_wall, prof = traced_step(prepare, f"image_embed {kind} tick")
        by_op = launched_by_op(prof)
        if make is None:
            # a K-tick trace: the profiler's range tree (the composition
            # table) counts some kernels of this long trace under two
            # ranges, so the split comes from the launching ops, each
            # kernel counted once: aten::mm the bf16 GEMMs, aten::bmm the
            # float32 attention products
            rep = trace_report(f"image_embed {kind}", t_wall, prof, card,
                               VIT_HOST_OPS)
            ops = dict(by_op)
            total = sum(b - a for a, b, _ in rep["dev"])
            gemm = list(ops.get("aten::mm", (0.0, 0)))
            attn = list(ops.get("aten::bmm", (0.0, 0)))
            log(f"[trace] image_embed {kind} ({K} ticks) split of the "
                f"device time by launching op: bf16 GEMMs "
                f"{gemm[0] / 1e3:.3f} ms in {gemm[1]} ops; float32 "
                f"attention products {attn[0] / 1e3:.3f} ms in {attn[1]} "
                f"ops; the rest (elementwise, slot copies, GroupBy, "
                f"Reduce) {(total - gemm[0] - attn[0]) / 1e3:.3f} ms; all "
                f"{total / 1e3:.3f} ms [{card}]")
        else:
            rep = compositions("image_embed", kind, t_wall, prof, card,
                               host_ops=VIT_HOST_OPS)
            spans = rep["spans"]
            total = sum(b - a for a, b, _ in rep["dev"])
            gemm = spans.get("vit.gemm", [0.0, 0])
            attn = spans.get("vit.attn_products", [0.0, 0])
            fwd = spans.get("map", [0.0, 0])
            elem = [fwd[0] - gemm[0] - attn[0], fwd[1] - gemm[1] - attn[1]]
            log(f"[trace] image_embed {kind} split of the device time: bf16 "
                f"GEMMs {gemm[0] / 1e3:.3f} ms in {gemm[1]} ops; float32 "
                f"attention products {attn[0] / 1e3:.3f} ms in {attn[1]} "
                f"ops; elementwise (LN, bias, GELU, softmax, casts, layout "
                f"copies) {elem[0] / 1e3:.3f} ms in {elem[1]} ops; outside "
                f"the forward (upload, GroupBy, Reduce) "
                f"{(total - fwd[0]) / 1e3:.3f} ms; all {total / 1e3:.3f} ms "
                f"[{card}]")
        log(f"[trace] image_embed {kind} device time by the op that "
            f"launched it: " + "; ".join(
                f"{name} {us / 1e3:.3f} ms in {k}"
                for name, (us, k) in by_op[:12]))
        reps[kind] = rep
    peak = torch.cuda.max_memory_allocated()

    for d, v in made:                        # the check's host mirror
        for i, row in zip(d.keys.cpu().numpy(), d.values.cpu().numpy()):
            stream.images[int(i)] = row[1:]
            stream.groups[int(i)] = int(row[0])
            version[int(i)] = v
    ex.check_errors()
    t0 = time.perf_counter()
    err = centroid_error(sched.read_table(ig.centroids), stream, version,
                         [params, params1])
    check_s = time.perf_counter() - t0
    if err > VIT_CENTROID_BOUND:
        raise AssertionError(f"centroids vs the plain forward: {err:.3g}")

    flops = vit.vit_flops(**mcfg)
    up_mb = sum(t.numel() * t.element_size() for t in made[0][0]) / 1e6
    out = {"init_s": init_s, "warm_ms": warm_s * 1e3,
           "centroid_err": err, "peak_bytes": peak,
           "busy_share": {k: r["busy_share"] for k, r in reps.items()},
           **checks}
    for leg, walls, per in (("upload", upload, 1), ("on-card", on_card, 1),
                            ("window", win_walls, K),
                            ("pump", [pump_wall], 2 * K)):
        med = _median(walls) / per
        ips = n / med
        tflops = ips * flops / 1e12
        log(f"[image_embed] {leg} leg: "
            f"{'wall' if per > 1 else 'tick'} ms "
            f"{[round(w * 1e3, 3) for w in walls]}, median tick "
            f"{med * 1e3:.3f} ms{' amortized' if per > 1 else ''}, "
            f"{ips:.1f} images/s, model {tflops:.2f} TFLOP/s, MFU "
            f"{tflops * 1e12 / BF16_OPS_PER_S * 100:.2f}% of the dense bf16 "
            f"peak {BF16_OPS_PER_S / 1e12:.1f} TFLOP/s [{card}]")
        out[leg] = {"median_ms": med * 1e3, "images_per_s": ips,
                    "tflops": tflops}
    log(f"[image_embed] window leg: {K} ticks x {n} host images a window, "
        f"{staged_mb:.3f} MB staged a window (int32 keys, uint8 rows, "
        f"int32 weights); the queue: {queue.generations} generation(s), "
        f"{queue.nbytes} B on the card, {queue.host_nbytes} B pinned; "
        f"megatick_windows {sched.megatick_windows}, megatick_fallbacks "
        f"{sched.megatick_fallbacks}; the pump leg: {2 * K} batches in 2 "
        f"windows at depth 2 from resume to flushed, stage_overlap_frac "
        f"{pump_overlap:.3f} [{card}]")
    log(f"[image_embed] ViT-B/16 ({flops / 1e9:.2f} GFLOP an image), {n} "
        f"images a tick, {N} ids, {G} groups; weights {init_s:.2f} s on "
        f"the host for two sets; feeds {feed_s:.3f} s (outside the clock); "
        f"warm-up tick {warm_s * 1e3:.3f} ms; {up_mb:.3f} MB uploaded a "
        f"tick (keys, uint8 rows, weights), of which the host boundary "
        f"alone: concat {concat_s * 1e3:.3f} ms, to_device "
        f"{to_device_s * 1e3:.3f} ms; group move tick "
        f"{move_s * 1e3:.3f} ms; swap tick {swap_s * 1e3:.3f} ms, "
        f"{changed} of {len(before)} centroids changed, no rebind; peak "
        f"device memory {peak} B [{card}]")
    log(f"[image_embed] centroids ({len(after)} groups, {len(stream.images)} "
        f"live images, image 0 in group {stream.groups[0]}) vs float64 "
        f"means of the plain forward: max abs {err:.3g} (bound "
        f"{VIT_CENTROID_BOUND:g}; check {check_s:.2f} s); sticky flags "
        f"clear; traced ticks device busy "
        + ", ".join(f"{k} {r['busy_share'] * 100:.1f}%"
                    for k, r in reps.items()) + f" [{card}]")
    return out


# -- phase 12: window parity on the card -------------------------------------

#: the reference's depth-fuzz graph (tests/test_pipeline.py: source -> map
#: -> sum Reduce, small-integer values so every sum is exact in float32 in
#: any order) at a size where the asynchronous slot copies matter: 16
#: batches of 8192 rows a K-tick window, every slot holding different rows
WINDOW_PARITY = dict(key_space=1 << 16, rows=8192, batches=16, seed=12,
                     depths=(1, 2, 4), ks=(2, 4), rounds=3)
#: the PageRank window leg: config 3's width, 4 churn ticks in one window
PAGERANK_WINDOW = dict(PAGERANK, churn_ticks=4)


def _fuzz_graph(key_space: int):
    g = FlowGraph("window_parity")
    s = g.source("s", Spec((), np.float32, key_space=key_space))
    m = g.map(s, lambda v: v * np.float32(2), vectorized=True)
    return g, s, g.reduce(m, "sum", tol=0.0)


def _table_array(sched, node, key_space: int) -> np.ndarray:
    """A Reduce's table as a dense float64 array (absent keys NaN)."""
    out = np.full(key_space, np.nan)
    for k, v in sched.read_table(node).items():
        out[int(k)] = float(np.asarray(v).reshape(()))
    return out


def phase_window_parity(card: str) -> Dict[str, object]:
    """The depth-fuzz graph through ``IngestFrontend`` on the card at
    depths 1, 2 and 4 and windows of 2 and 4 ticks (pause, submit every
    batch, resume, flush: the pump drains one backlog, so every window
    but the first stages while the one before is in flight), each
    (K, depth) leg three times with the depth order reversed every other
    round, and the median time of each printed; every leg's table equals
    the CPU oracle's, so the depths agree. Then a PageRank
    window: 4 churn ticks in one ``tick_many`` on the fused loop at
    config 3's width, the per-tick iters and converged flags back as [4]
    stacks, the ranks within the bound of phase 5."""
    cfg = WINDOW_PARITY
    KS, R, NB = cfg["key_space"], cfg["rows"], cfg["batches"]
    rng = np.random.default_rng(cfg["seed"])
    batches = [DeltaBatch(rng.integers(0, KS, R).astype(np.int64),
                          rng.integers(0, 8, R).astype(np.float32),
                          np.ones(R, np.int64)) for _ in range(NB)]
    g, s, r = _fuzz_graph(KS)
    oracle = DirtyScheduler(g, CpuExecutor())
    t0 = time.perf_counter()
    for b in batches:
        oracle.push(s, b)
        oracle.tick()
    want = _table_array(oracle, r, KS)
    oracle_s = time.perf_counter() - t0
    out: Dict[str, object] = {}

    def leg(k: int, depth: int) -> float:
        g, s, r = _fuzz_graph(KS)
        sched = DirtyScheduler(g, get_executor("cuda"))
        fe = IngestFrontend(sched, depth=depth, window=CoalesceWindow(
            max_rows=R, max_ticks=k, max_latency_s=0.001),
            max_bytes=1 << 30)
        try:
            fe.pause()
            tks = [fe.submit(s, b) for b in batches]
            t0 = time.perf_counter()
            fe.resume()
            fe.flush(timeout=120)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not all(t.result(timeout=60).applied for t in tks):
                raise AssertionError("a window-parity ticket was not "
                                     "applied")
        finally:
            fe.close()
        nw = NB // k
        want_staged = nw if depth > 1 else 0
        want_piped = nw - 1 if depth > 1 else 0
        if (sched.megatick_windows != nw or sched.megatick_fallbacks
                or fe.windows_staged != want_staged
                or fe.windows_pipelined != want_piped):
            raise AssertionError(
                f"depth {depth}, K {k}: windows "
                f"{sched.megatick_windows}, fallbacks "
                f"{sched.megatick_fallbacks}, staged "
                f"{fe.windows_staged}, pipelined {fe.windows_pipelined}")
        # every leg's table, at every depth, equals the CPU oracle's
        if not np.array_equal(_table_array(sched, r, KS), want,
                              equal_nan=True):
            raise AssertionError(f"depth {depth}, K {k}: the table != the "
                                 f"CPU oracle's")
        (q,) = [q for key, q in sched.executor._window_cache.items()
                if key[0] == "ingress_q"]
        log(f"[window] depth {depth}, K {k}: {NB} batches of {R} rows in "
            f"{nw} windows, {wall * 1e3:.3f} ms from resume to flushed "
            f"({wall / NB * 1e3:.4f} ms a tick); windows_staged "
            f"{fe.windows_staged}, windows_pipelined "
            f"{fe.windows_pipelined}, stage_overlap_frac "
            f"{fe.stage_overlap_frac:.3f}; queue generations "
            f"{q.generations}, {q.nbytes} B on the card [{card}]")
        return wall

    # the depths in turn, the order reversed every other round, so that
    # neither warm-up nor drift favours a depth; the median of the rounds
    for k in cfg["ks"]:
        walls: Dict[int, List[float]] = {d: [] for d in cfg["depths"]}
        for rnd in range(cfg["rounds"]):
            order = cfg["depths"][::-1] if rnd % 2 else cfg["depths"]
            for depth in order:
                walls[depth].append(leg(k, depth))
        for depth, ws in walls.items():
            out[(k, depth)] = float(np.median(ws))
        log(f"[window] K {k}: median ms from resume to flushed over "
            f"{cfg['rounds']} rounds, " + ", ".join(
                f"depth {d} {out[(k, d)] * 1e3:.3f} "
                f"({[round(w * 1e3, 3) for w in walls[d]]})"
                for d in cfg["depths"]) + f" [{card}]")
    log(f"[window] depth-fuzz tables ({int(np.isfinite(want).sum())} keys) "
        f"equal across depths {cfg['depths']} and windows {cfg['ks']}, and "
        f"equal to the CPU oracle ({oracle_s:.2f} s on the host) exactly "
        f"[{card}]")

    # PageRank: 4 churn ticks in one window on the fused loop, beside a
    # twin scheduler fed the same batches tick by tick (two rounds, the
    # twin first in the first and second in the second)
    pcfg = PAGERANK_WINDOW
    n, K = pcfg["n_nodes"], pcfg["churn_ticks"]
    legs = {}
    for leg in ("window", "per-tick"):
        pg, web, ex, sched, _arena = pagerank_setup(pcfg, {})
        sched.push(pg.teleport, pagerank.teleport_batch(n))
        sched.push(pg.edges, web.initial_batch())
        sched.tick()
        if not isinstance(ex._fx_program, LinearFixpointProgram):
            raise AssertionError("the PageRank window leg did not take "
                                 "the fused loop")
        legs[leg] = (pg, web, ex, sched)
    churn = [[legs["window"][1].churn(pcfg["churn"]) for _ in range(K)]
             for _ in range(2)]
    for _ in range(2 * K):      # the twin's web takes the same churn
        legs["per-tick"][1].churn(pcfg["churn"])
    walls: Dict[str, List[float]] = {"window": [], "per-tick": []}
    iters_h: List[int] = []
    conv_h: List[bool] = []
    per_passes: List[int] = []
    reads = 0
    for rnd in range(2):
        order = ("per-tick", "window") if rnd == 0 else ("window",
                                                          "per-tick")
        for leg in order:
            pg, web, ex, sched = legs[leg]
            r0 = ex.loop_reads + ex.host_syncs
            t0 = time.perf_counter()
            if leg == "window":
                res = sched.tick_many([{pg.edges: b} for b in churn[rnd]])
            else:
                rs = []
                for b in churn[rnd]:
                    sched.push(pg.edges, b)
                    rs.append(sched.tick(sync=False))
            torch.cuda.synchronize()
            walls[leg].append(time.perf_counter() - t0)
            if leg == "per-tick":
                per_passes += [r.block().passes for r in rs]
                continue
            conv, iters = res.quiesced, res.passes.parts[1]
            if not (isinstance(conv, torch.Tensor)
                    and tuple(conv.shape) == (K,)
                    and isinstance(iters, torch.Tensor)
                    and tuple(iters.shape) == (K,)):
                raise AssertionError(f"PageRank window: iters {iters!r}, "
                                     f"conv {conv!r}")
            it, cv = iters.tolist(), conv.tolist()
            res.block()
            r1 = ex.loop_reads + ex.host_syncs
            if r1 - r0 != sum(it) + 3 * K:
                raise AssertionError(f"PageRank window: {r1 - r0} readbacks "
                                     f"for iters {it} (iters + 3 a tick)")
            reads += r1 - r0
            iters_h += it
            conv_h += cv
    pg, web, ex, sched = legs["window"]
    err = rank_error(sched, pg, web, n)
    twin = legs["per-tick"]
    err_t = rank_error(twin[3], twin[0], twin[1], n)
    if (sched.megatick_windows != 2 or sched.megatick_fallbacks
            or not all(conv_h) or err["rel_err"] > PAGERANK_MAX_REL_ERR
            or err_t["rel_err"] > PAGERANK_MAX_REL_ERR):
        raise AssertionError(f"PageRank window: windows "
                             f"{sched.megatick_windows}, conv {conv_h}, "
                             f"rel err {err['rel_err']:.3g} (twin "
                             f"{err_t['rel_err']:.3g})")
    wall = sum(walls["window"])
    log(f"[window] PageRank: 2 windows of {K} churn ticks of 1% in one "
        f"tick_many each on the fused loop, {[round(w * 1e3, 3) for w in walls['window']]} "
        f"ms = {wall / (2 * K) * 1e3:.3f} ms a tick amortized; the per-tick "
        f"twin, same batches: {[round(w * 1e3, 3) for w in walls['per-tick']]} "
        f"ms = {sum(walls['per-tick']) / (2 * K) * 1e3:.3f} ms a tick; iters "
        f"{iters_h} (twin passes {per_passes}), converged {conv_h} (host "
        f"values re-uploaded as [{K}] device stacks, read back at "
        f"block()); readbacks {reads} = iters + 3 a tick; max|rank - ref| / max(ref, 1) = {err['rel_err']:.3g}, twin "
        f"{err_t['rel_err']:.3g} (bound {PAGERANK_MAX_REL_ERR:g}) [{card}]")
    out["pagerank"] = {"walls_s": walls, "iters": iters_h,
                       "rel_err": err["rel_err"]}
    return out


# -- phase 13: durable ingestion ---------------------------------------------

#: phase 13's PageRank legs: config 3 at full width, 7 churn ticks before
#: the kill (a chain element after each) and 2 after the recovery
DURABLE_PR = dict(PAGERANK, churn_ticks=9, kill_at=7)
#: a restored run against the run never stopped, as max|rank - twin| /
#: max(twin, 1): the restore rebuilds the CSR in one piece, so the float
#: sums add in another order and a tol-gated emission can flip at its
#: edge. Each run's emitted rank lies within tol of its computed one, so
#: two runs part by under 2 tol plus how far their computed ranks part;
#: ten legs on the H100 read 7.9e-6 to 1.0e-4, one flipped gate (PERF.md,
#: PR 8). The integer state is held exactly apart (DURABLE_ARENA), so a
#: lost or doubled edge batch fails there
DURABLE_TWIN_BOUND = 3 * PAGERANK["tol"]
#: the leaves of PageRank's join state that only the edge batches write:
#: a restore and a replay must give the twin's bit for bit
DURABLE_ARENA = ("rkeys", "rvals", "rw", "rcount", "gen", "error")


def fs_line(path: str) -> str:
    """The filesystem ``path`` lies on: its type, mount point and device
    from ``/proc/mounts`` (the longest mount prefix), and its free space
    from ``os.statvfs``."""
    path = os.path.realpath(path)
    best = ("?", "?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            mnt = mnt.replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[1]):
                best = (dev, mnt, fstype)
    st = os.statvfs(path)
    return (f"fs {best[2]} on {best[1]} ({best[0]}), "
            f"{st.f_bavail * st.f_frsize / 2**30:.1f} GiB free")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(path) for f in files)


#: where the k-NN paths of phases 13-15 (and the lockcheck leg, which
#: reuses them) put their executors: None is the card; the leg's CPU run
#: (``--lockcheck-child --device cpu``) sets "cpu", where the top-k
#: wrappers take their plain versions and count no launch
DEVICE = None


def _executor():
    return get_executor("cuda", device=DEVICE)


def _on_card() -> bool:
    return DEVICE is None


def _device_type() -> str:
    return "cuda" if _on_card() else torch.device(DEVICE).type


def _sync() -> None:
    if _on_card():
        torch.cuda.synchronize()


#: a launch count (topk, topk_merge, scan_score) with no launch
NO_LAUNCH = (0, 0, 0)


def _launches() -> tuple:
    return (topk_mod.TOPK_LAUNCHES, topk_mod.TOPK_MERGE_LAUNCHES,
            topk_mod.SCAN_SCORE_LAUNCHES)


def _since(l0: tuple) -> tuple:
    return tuple(b - a for a, b in zip(l0, _launches()))


def _plus(a, b) -> list:
    return [x + y for x, y in zip(a, b)]


def _knn_feed(cfg: Dict[str, int], seed: int) -> List[tuple]:
    """(batch id, source, host batch, kind) in the upstream's order: the
    queries, the preload (random int8 rows), then the inserts on fresh
    ids, the retraction and the query update."""
    Q, dim = cfg["Q"], cfg["dim"]
    rng = np.random.default_rng(seed)

    def docs(lo: int, n: int) -> DeltaBatch:
        return DeltaBatch(np.arange(lo, lo + n, dtype=np.int64),
                          rng.integers(-127, 128, (n, dim), dtype=np.int8))

    n = cfg["preload_chunk"]
    feed = [("q0", "q", DeltaBatch(np.arange(Q, dtype=np.int64),
                                   rng.standard_normal((Q, dim),
                                                       dtype=np.float32)),
             "query insert")]
    feed += [(f"pre{c}", "d", docs(c * n, n), "preload")
             for c in range(cfg["preload_chunks"])]
    lo = cfg["preload_chunks"] * n
    for i in range(cfg["insert_ticks"]):
        feed.append((f"ins{i}", "d", docs(lo, cfg["per_tick"]), "insert"))
        lo += cfg["per_tick"]
    gone = np.arange(cfg["retract"], dtype=np.int64)
    feed.append(("ret", "d", DeltaBatch(
        gone, np.zeros((len(gone), dim), np.int8),
        -np.ones(len(gone), np.int64)), "retract"))
    nq = cfg["query_update"]
    feed.append(("qup", "q", DeltaBatch(
        np.arange(nq, dtype=np.int64),
        rng.standard_normal((nq, dim), dtype=np.float32)), "query update"))
    return feed


def _want_launches(kind: str, chunks: int) -> tuple:
    """(topk, topk_merge, scan_score) launches of one k-NN tick: a rescan
    scores and merges once a corpus chunk, an incremental tick runs one
    top-k."""
    if not _on_card():
        return NO_LAUNCH
    rescan = kind in ("retract", "query update", "query insert")
    return (0, chunks, chunks) if rescan else (1, 0, 0)


def _knn_graph(cfg: Dict[str, int], sink: bool = False):
    """Config 4's k-NN graph (bf16 queries, int8 corpus); ``sink`` adds a
    sink ``nn`` on the index, the view the read tier serves."""
    kg = knn.build_graph(cfg["Q"], cfg["D"], cfg["dim"], cfg["k"],
                         scan_chunk=cfg["scan_chunk"], dtype=torch.bfloat16,
                         doc_dtype=torch.int8, precision="default")
    if sink:
        kg.graph.sink(kg.index, "nn")
    return kg


def _knn_frontend(sched, cfg: Dict[str, int],
                  name=None) -> IngestFrontend:
    """Config 4's frontend; ``name`` names its lock
    (``serve.frontend.<name>``) for the lockcheck leg's monitor."""
    return IngestFrontend(sched, depth=2, admission="device", name=name,
                          window=CoalesceWindow(
                              max_rows=cfg["preload_chunk"], max_ticks=8,
                              max_latency_s=0.005),
                          max_bytes=1 << 30)


def _table_diff(got: Dict, want: Dict) -> List[int]:
    """The queries whose live top-k (ids and scores above ``NEG``) differ
    between two k-NN tables, bit for bit."""
    bad = [q for q in want if q not in got]
    for q in want:
        if q not in got:
            continue
        a, b = got[q], want[q]
        live = a[:, 1] > NEG
        if not np.array_equal(live, b[:, 1] > NEG) \
                or not np.array_equal(a[live], b[live]):
            bad.append(q)
    return bad


def durable_knn(card: str, fs: str, tmp: str,
                cfg: Dict[str, int] = FULL) -> Dict[str, object]:
    """Config 4 served durably at full width beside a non-durable twin,
    killed inside the last window, recovered and resent."""
    Q, D, dim, k = cfg["Q"], cfg["D"], cfg["dim"], cfg["k"]
    chunks = D // cfg["scan_chunk"]
    feed = _knn_feed(cfg, seed=13)
    n_head = 1 + cfg["preload_chunks"]
    wal_dir = os.path.join(tmp, "knn-wal")
    ckpt_dir = os.path.join(tmp, "knn-ckpt")

    def graph():
        return _knn_graph(cfg)

    def frontend(sched, name):
        return _knn_frontend(sched, cfg, name)

    def submit(fe, kg, item):
        bid, src, batch, _kind = item
        l0 = _launches()
        t0 = time.perf_counter()
        ticket = fe.submit(kg.queries if src == "q" else kg.docs, batch,
                           batch_id=bid)
        fe.flush(timeout=600)
        res = ticket.result(timeout=600)
        _sync()
        return res, time.perf_counter() - t0, _since(l0)

    kt, kd = graph(), graph()
    twin = DirtyScheduler(kt.graph, _executor())
    crash = CrashInjector(1 << 62, only="after_append")
    dur = DurableScheduler(kd.graph, _executor(), wal_dir=wal_dir,
                           fsync="tick", committer="thread", crash=crash)
    fe_t, fe_d = frontend(twin, "twin"), frontend(dur, "durable")
    rows: List[Dict[str, object]] = []
    try:
        for i, item in enumerate(feed[:-1]):
            if i == n_head:
                t0 = time.perf_counter()
                meta = save_checkpoint(dur, ckpt_dir)
                save_s = time.perf_counter() - t0
                meta_b = os.path.getsize(os.path.join(ckpt_dir, "meta.pkl"))
                kept = [seq for seq, _p in list_segments(wal_dir)]
                if min(kept) != meta["wal_pos"][0]:
                    raise AssertionError(f"segments {kept} kept after a "
                                         f"checkpoint at {meta['wal_pos']}")
            wal_b0 = dur.wal.bytes_written
            # in turns: durable first on even items, the twin first on odd
            order = ((fe_d, kd), (fe_t, kt)) if i % 2 == 0 else \
                ((fe_t, kt), (fe_d, kd))
            out = {}
            for fe, kg in order:
                out[fe is fe_d] = submit(fe, kg, item)
            (res_d, s_d, l_d), (res_t, s_t, l_t) = out[True], out[False]
            for res in (res_d, res_t):
                if res.status != APPLIED:
                    raise AssertionError(f"{item[0]}: ticket {res}")
            if not res_d.lsn:
                raise AssertionError(f"{item[0]}: durable ticket has no LSN")
            rows.append({"id": item[0], "kind": item[3], "s": s_d,
                         "twin_s": s_t, "launches": l_d,
                         "twin_launches": l_t,
                         "wal_bytes": dur.wal.bytes_written - wal_b0,
                         "lsn": res_d.lsn})
        # the kill: the last window dies after its push records are
        # appended, before its dispatch; the twin takes it whole
        last = feed[-1]
        res_t, s_t, twin_last = submit(fe_t, kt, last)
        if res_t.status != APPLIED:
            raise AssertionError(f"twin {last[0]}: {res_t}")
        crash.remaining = 1
        l0 = _launches()
        ticket = fe_d.submit(kd.queries, last[2], batch_id=last[0])
        try:
            ticket.result(timeout=600)
        except PumpCrashed:
            pass
        else:
            raise AssertionError("the crash seam did not fire")
        killed_launches = _since(l0)
        if crash.fired_seam != "after_append":
            raise AssertionError(f"crashed at {crash.fired_seam}")
        wal = summarize_wal(dur.wal)
        log_readbacks = dur.log_readbacks
        dur.wal.drain()     # what the page cache holds at the kill
    finally:
        fe_t.close()
        fe_d.close(flush=False)
    del fe_d, dur, kd
    torch.cuda.empty_cache()

    # a fresh process: new executor and scheduler on the same dirs
    k2 = graph()
    t0 = time.perf_counter()
    sched2 = DurableScheduler(k2.graph, _executor(),
                              wal_dir=wal_dir, fsync="tick",
                              committer="thread")
    l0 = _launches()
    rep = recover(sched2, wal_dir, ckpt_dir)
    _sync()
    recover_s = time.perf_counter() - t0
    replay_launches = _since(l0)
    pending = sum(len(v) for v in sched2._pending.values())
    l0 = _launches()
    t1 = time.perf_counter()
    sched2.tick()       # the logged, undispatched last window
    _sync()
    first_s = time.perf_counter() - t1
    first_launches = _since(l0)
    fe2 = frontend(sched2, "recovered")
    try:
        l0 = _launches()
        resent = [fe2.submit(k2.queries if src == "q" else k2.docs, b,
                             batch_id=bid) for bid, src, b, _k in feed]
        fe2.flush(timeout=600)
        statuses = Counter(t.result(timeout=600).status for t in resent)
        resend_launches = _since(l0)
    finally:
        fe2.close()
    table = sched2.read_table(k2.index)
    twin_table = twin.read_table(kt.index)

    # checks: the launches, the twin, brute force
    want_live = [_want_launches(r["kind"], chunks) for r in rows]
    if [r["launches"] for r in rows] != want_live:
        raise AssertionError(f"live launches {[r['launches'] for r in rows]}"
                             f", expected {want_live}")
    tail = feed[n_head:-1]
    want_replay = tuple(map(sum, zip(*[_want_launches(kind, chunks)
                                        for *_x, kind in tail])))
    if (rep.replayed_ticks != len(tail) or replay_launches != want_replay
            or pending != 1
            or first_launches != _want_launches(feed[-1][3], chunks)
            or killed_launches != NO_LAUNCH
            or resend_launches != NO_LAUNCH):
        raise AssertionError(
            f"recovery: {rep.as_dict()}, replay launches {replay_launches} "
            f"(expected {want_replay}), pending {pending}, first tick "
            f"launches {first_launches}, killed window {killed_launches}, "
            f"resend {resend_launches}")
    if set(statuses) - {APPLIED, DEDUPED} or log_readbacks:
        raise AssertionError(f"resend statuses {dict(statuses)}, "
                             f"log_readbacks {log_readbacks}")
    bad = _table_diff(table, twin_table)
    if bad:
        raise AssertionError(f"queries {bad[:8]}: the recovered table != "
                             f"the uncrashed twin's")
    live_ids = sum(int((table[q][:, 1] > NEG).sum()) for q in range(Q))
    recall, score_diff = check_brute_force(
        "recovered table", sched2.executor.states[k2.index.id], table, Q, k)

    ins = [r for r in rows[n_head:] if r["kind"] == "insert"]
    med = _median([r["s"] for r in ins])
    med_t = _median([r["twin_s"] for r in ins])
    pre_mb = sum(r["wal_bytes"] for r in rows[1:n_head]) / 1e6
    log(f"[durable] k-NN at full width (Q {Q}, {D} ids x {dim} int8, k {k}, "
        f"chunk {cfg['scan_chunk']}) through IngestFrontend(depth=2, "
        f"admission='device') over DurableScheduler(fsync='tick', "
        f"committer='thread') beside a non-durable twin; {len(feed)} "
        f"batches, every ticket applied with an LSN "
        f"(last {rows[-1]['lsn']}); log_readbacks {log_readbacks} [{card}] "
        f"[{fs}]")
    log(f"[durable] preload: {cfg['preload_chunks']} host batches of "
        f"{cfg['preload_chunk']} docs logged, {pre_mb:.1f} MB; tick ms "
        f"with the WAL {[round(r['s'] * 1e3, 3) for r in rows[:n_head]]}, "
        f"twin {[round(r['twin_s'] * 1e3, 3) for r in rows[:n_head]]}")
    log(f"[durable] checkpoint (full, after the preload): save "
        f"{save_s * 1e3:.1f} ms, {(meta['states_bytes'] + meta_b) / 1e6:.1f} "
        f"MB ({meta['states_bytes'] / 1e6:.1f} MB of device state, "
        f"{meta_b / 1e6:.3f} MB meta); the covered segments truncated, "
        f"the log now starts at segment {meta['wal_pos'][0]} [{fs}]")
    log(f"[durable] insert tick ({cfg['per_tick']} int8 docs) with the WAL "
        f"median "
        f"{med * 1e3:.3f} ms of {[round(r['s'] * 1e3, 3) for r in ins]}; "
        f"non-durable twin median {med_t * 1e3:.3f} ms of "
        f"{[round(r['twin_s'] * 1e3, 3) for r in ins]}; MB logged a tick "
        f"{_median([r['wal_bytes'] for r in ins]) / 1e6:.3f}; retract tick "
        f"{rows[-1]['s'] * 1e3:.3f} ms (twin {rows[-1]['twin_s'] * 1e3:.3f})"
        f" [{card}] [{fs}]")
    log(f"[durable] WAL: {wal.appends} appends, {wal.fsyncs} fsyncs, "
        f"{wal.bytes_written / 1e6:.1f} MB; append p50 "
        f"{wal.append_p50_s * 1e3:.3f} ms (p95 {wal.append_p95_s * 1e3:.3f})"
        f", fsync p50 {wal.fsync_p50_s * 1e3:.3f} ms (p95 "
        f"{wal.fsync_p95_s * 1e3:.3f}) [{fs}]")
    log(f"[durable] kill at after_append in the last window (query "
        f"update); recover: {recover_s * 1e3:.1f} ms in all (restore "
        f"{rep.restore_s * 1e3:.1f} ms, scan + replay {rep.replay_s * 1e3:.1f}"
        f" ms); replayed {rep.replayed_pushes} pushes and "
        f"{rep.replayed_ticks} ticks, deduped {rep.deduped_pushes}; "
        f"{pending} push pending; first tick after recovery "
        f"{first_s * 1e3:.3f} ms, time to it {(recover_s + first_s) * 1e3:.1f}"
        f" ms [{card}] [{fs}]")
    log(f"[durable] resend of all {len(feed)} batches from the upstream's "
        f"cursor: {dict(statuses)}; (topk, topk_merge, scan_score) launches:"
        f" live "
        f"{[r['launches'] for r in rows]}, replay {replay_launches}, first "
        f"tick {first_launches}, killed window {killed_launches}")
    log(f"[durable] recovered table == uncrashed twin exactly ({live_ids} "
        f"live ids and scores); vs brute force: recall {recall:.6f}, score "
        f"max_abs_diff {score_diff:.6g}")
    total = [sum(x) for x in zip(*([r["launches"] for r in rows]
                                   + [replay_launches, first_launches]))]
    twin_total = [sum(x) for x in zip(*([r["twin_launches"] for r in rows]
                                        + [twin_last]))]
    return {"launches": total, "twin_launches": twin_total,
            "recover_s": recover_s,
            "insert_ms": med * 1e3, "twin_insert_ms": med_t * 1e3}


def _pr_tick(sched, ex, pushes) -> Dict[str, object]:
    """One PageRank tick on the card: push, tick, synchronize; its
    readbacks (forced syncs and loop reads) and its CSR cause."""
    s0, r0 = sched.forced_syncs, ex.loop_reads
    t0 = time.perf_counter()
    for src, batch, bid in pushes:
        sched.push(src, batch, batch_id=bid)
    res = sched.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not res.quiesced:
        raise AssertionError(f"tick {res.tick} did not quiesce")
    last = dict(getattr(ex._fx_program, "last_tick", None) or {})
    return {"s": wall, "passes": int(res.passes),
            "readbacks": sched.forced_syncs - s0 + ex.loop_reads - r0,
            "csr": last.get("csr")}


def _arena_state(ex, pg) -> Dict[str, torch.Tensor]:
    st = ex.states[pg.join.id]
    # a copy: the executor writes the arena's rows in place
    return {k: st[k].to("cpu", copy=True) for k in DURABLE_ARENA}


def _arena_diff(got: Dict[str, torch.Tensor],
                want: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in DURABLE_ARENA if got[k].dtype != want[k].dtype
            or not torch.equal(got[k], want[k])]


def durable_pagerank(card: str, fs: str, tmp: str, torn: bool,
                     data: Dict[str, object]) -> Dict[str, object]:
    """Config 3 on the fused loop through a DurableScheduler with a
    CheckpointChain: a full element after the initial tick, a delta after
    each churn tick, a kill at ``before_tick_mark`` on churn tick 7
    (``torn``: the final delta cut short), recovery from chain plus tail,
    the resend deduped, and 2 more churn ticks."""
    cfg = DURABLE_PR
    n, kill = cfg["n_nodes"], cfg["kill_at"]
    arena = (bucket_capacity(cfg["n_edges"])
             + 8 * bucket_capacity(2 * int(cfg["churn"] * cfg["n_edges"])
                                   + 2))
    churns, first = data["churns"], data["first"]

    def build():
        return pagerank.build_graph(n, tol=cfg["tol"], arena_capacity=arena)

    tag = "torn" if torn else "clean"
    wal_dir = os.path.join(tmp, f"pr-{tag}-wal")
    root = os.path.join(tmp, f"pr-{tag}-chain")
    pg = build()
    ex = get_executor("cuda")
    sched = DurableScheduler(pg.graph, ex, wal_dir=wal_dir, fsync="tick",
                             committer="thread",
                             crash=CrashInjector(kill + 1,
                                                 only="before_tick_mark"))
    chain = CheckpointChain(root, delta_every=1 << 20)
    pushes = [(pg.teleport, first[0], "init0"), (pg.edges, first[1], "init1")]
    ticks = [_pr_tick(sched, ex, pushes)]
    saves = []
    for t in range(kill):
        if t:
            ticks.append(_pr_tick(sched, ex, [(pg.edges, churns[t - 1],
                                               f"c{t - 1}")]))
        t0 = time.perf_counter()
        info = chain.save(sched)
        save_s = time.perf_counter() - t0
        saves.append((info["kind"], save_s, info["bytes"] if "bytes" in info
                      else _dir_bytes(os.path.join(root, info["element"]))))
    try:
        _pr_tick(sched, ex, [(pg.edges, churns[kill - 1], f"c{kill - 1}")])
    except CrashPoint:
        pass
    else:
        raise AssertionError("the before_tick_mark seam did not fire")
    sched.close()
    if torn:
        last = os.path.join(root, read_chain_manifest(root)["deltas"][-1])
        with open(last, "r+b") as f:
            f.truncate(os.path.getsize(last) - 9)
    readback_mb = chain.readback_bytes / 1e6
    del sched, ex
    torch.cuda.empty_cache()
    want_ckpt = kill - 1 if torn else kill
    # the chain as a restore leaves it, before any replayed tick
    pg3 = build()
    probe = DirtyScheduler(pg3.graph, get_executor("cuda"))
    load_checkpoint(probe, root)
    restored_diff = _arena_diff(_arena_state(probe.executor, pg3),
                                data["arena"][want_ckpt])
    if probe._tick != want_ckpt or restored_diff:
        raise AssertionError(
            f"PageRank {tag} leg: the chain restored tick {probe._tick} "
            f"(expected {want_ckpt}); arena leaves unlike the twin's: "
            f"{restored_diff}")
    del probe, pg3

    pg2 = build()
    ex2 = get_executor("cuda")
    sched2 = DurableScheduler(pg2.graph, ex2, wal_dir=wal_dir, fsync="tick",
                              committer="thread")
    s0, r0, h0 = sched2.forced_syncs, ex2.loop_reads, len(sched2.history)
    t0 = time.perf_counter()
    rep = recover(sched2, wal_dir, root)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    replayed = sched2.history[h0:]
    replay_reads = sched2.forced_syncs - s0 + ex2.loop_reads - r0
    replay_passes = sum(int(r.passes) for r in replayed)
    first_cause = dict(ex2.csr_rebuilds) if replayed else None
    # the upstream resends its batch of the killed tick: deduped
    if sched2.push(pg2.edges, churns[kill - 1], batch_id=f"c{kill - 1}"):
        raise AssertionError("the resent batch was not deduped")
    after = [_pr_tick(sched2, ex2, [])]
    if first_cause is None:
        first_cause = dict(ex2.csr_rebuilds)
    for t in range(kill, cfg["churn_ticks"]):
        after.append(_pr_tick(sched2, ex2, [(pg2.edges, churns[t],
                                             f"c{t}")]))
    ranks = pagerank.ranks_to_array(sched2.read_table(pg2.new_rank), n)
    final_diff = _arena_diff(_arena_state(ex2, pg2),
                             data["arena"][sched2._tick])
    sched2.close()
    rel = float((np.abs(ranks - data["ref"])
                 / np.maximum(data["ref"], 1.0)).max())
    twin_rel = float((np.abs(ranks - data["twin"])
                      / np.maximum(data["twin"], 1.0)).max())
    bad = [t for t in ticks + after if t["readbacks"] != t["passes"] + 3]
    if (rep.checkpoint_tick != want_ckpt or first_cause != {"initial": 1}
            or bad or replay_reads != replay_passes + 3 * len(replayed)
            or len(replayed) != rep.replayed_ticks
            or rel > PAGERANK_MAX_REL_ERR or twin_rel > DURABLE_TWIN_BOUND
            or final_diff or not np.isfinite(ranks).all()):
        raise AssertionError(
            f"PageRank {tag} leg: {rep.as_dict()}, first CSR {first_cause}, "
            f"readbacks off on {bad}, replay {replay_reads} reads in "
            f"{replay_passes} passes, rel err {rel:.3g}, vs twin "
            f"{twin_rel:.3g}, arena leaves unlike the twin's at tick "
            f"{sched2._tick}: {final_diff}")
    full = [s for s in saves if s[0] == "full"]
    deltas = [s for s in saves if s[0] == "delta"]
    log(f"[durable] PageRank {tag} leg ({n} nodes, {cfg['n_edges']} edges, "
        f"fused loop): chain full element {full[0][2] / 1e6:.2f} MB in "
        f"{full[0][1] * 1e3:.1f} ms; {len(deltas)} delta elements "
        f"{[round(b / 1e6, 2) for _k, _s, b in deltas]} MB in "
        f"{[round(s * 1e3, 1) for _k, s, _b in deltas]} ms; "
        f"{readback_mb:.1f} MB of device state read back by the saves "
        f"[{card}] [{fs}]")
    log(f"[durable] PageRank {tag} leg: kill at before_tick_mark on churn "
        f"tick {kill}{', final delta torn' if torn else ''}; recover "
        f"{recover_s * 1e3:.1f} ms (restore {rep.restore_s * 1e3:.1f} ms, "
        f"scan + replay {rep.replay_s * 1e3:.1f} ms; checkpoint tick "
        f"{rep.checkpoint_tick}, {rep.replayed_ticks} ticks and "
        f"{rep.replayed_pushes} pushes replayed, WAL torn tail "
        f"{rep.torn_tail is not None}); CSR after the first restored tick "
        f"{first_cause}; post-recovery ticks "
        f"{[round(t['s'] * 1e3, 3) for t in after]} ms, passes "
        f"{[t['passes'] for t in after]}, readbacks "
        f"{[t['readbacks'] for t in after]} (passes + 3) [{card}]")
    log(f"[durable] PageRank {tag} leg: max|rank - ref| / max(ref, 1) = "
        f"{rel:.6g} (bound {PAGERANK_MAX_REL_ERR:g}); against the uncrashed "
        f"twin {twin_rel:.6g} (bound {DURABLE_TWIN_BOUND:.3g}); the edge "
        f"arena ({', '.join(DURABLE_ARENA)}) equals the twin's exactly at "
        f"the restored tick {want_ckpt} and at tick {sched2._tick}")
    return {"recover_s": recover_s, "rel_err": rel, "twin_rel": twin_rel}


def phase_durable(card: str) -> Dict[str, object]:
    """Durable ingestion at full width: the k-NN leg (the top-k kernels,
    live and in the replay), then the PageRank chain leg twice (the final
    delta torn on the second)."""
    tmp = tempfile.mkdtemp()
    try:
        fs = fs_line(tmp)
        log(f"[durable] WAL and checkpoints under a temp dir: {fs}")
        zero_launches()
        out = durable_knn(card, fs, tmp)
        # every launch since the zeroing is the durable path's or its
        # twin's (the comparison, left out of the path's count)
        total = _launches()
        if [a - b for a, b in zip(total, out["twin_launches"])] \
                != out["launches"]:
            raise AssertionError(
                f"top-k launches {total}: the durable path's own "
                f"{out['launches']} and the twin's {out['twin_launches']}")
        cfg = DURABLE_PR
        web = pagerank.WebGraph.random(cfg["n_nodes"], cfg["n_edges"],
                                       seed=cfg["seed"])
        first = (pagerank.teleport_batch(cfg["n_nodes"]),
                 web.initial_batch())
        churns = [web.churn(cfg["churn"]) for _ in range(cfg["churn_ticks"])]
        pg, _web, ex, twin, _arena = pagerank_setup(cfg, {})
        twin.push(pg.teleport, first[0])
        twin.push(pg.edges, first[1])
        twin.tick()
        # the arena at both legs' restored ticks and at the last
        arena = {}
        for b in churns:
            if twin._tick in (cfg["kill_at"] - 1, cfg["kill_at"]):
                arena[twin._tick] = _arena_state(ex, pg)
            twin.push(pg.edges, b)
            twin.tick()
        arena[twin._tick] = _arena_state(ex, pg)
        data = {"first": first, "churns": churns, "arena": arena,
                "ref": pagerank.reference_ranks(web),
                "twin": pagerank.ranks_to_array(twin.read_table(pg.new_rank),
                                                cfg["n_nodes"])}
        del twin, ex
        legs = [durable_pagerank(card, fs, tmp, torn, data)
                for torn in (False, True)]
        out["pagerank"] = legs
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 14: replication ----------------------------------------------------

#: phase 14's tail after the leader's checkpoint, in order: 8 inserts of
#: 8,192 fresh docs, 2 retractions of whole inserted batches (their own
#: vectors, so a compaction fold cancels them row for row) and 2 query
#: updates on disjoint queries (a fold keeps one row a key); r1 detaches
#: after the first query update. After the failover the promoted leader
#: takes an insert and a query update
REPLICA_TAIL = ("ins", "ins", "ins", "ret", "qup", "ins", "ins", "ins",
                "ins", "ret", "ins", "qup")
REPLICA_DETACH_AFTER = 4
#: r0 checkpoints and restarts after this tail tick, so that the
#: promotion's recovery (r0 wins the election's tie by name) replays the
#: rest of the tail from that checkpoint
REPLICA_RESTART_AFTER = 7
#: the inserted batch each retraction takes back (indices into the tail)
REPLICA_RETRACTS = {3: 1, 9: 6}
#: a follower that has not reached the leader's tick after this long
#: fails the phase (a replay that raised on the shipper's thread)
REPLICA_WAIT_S = 120.0
#: ReadTier reads timed: lookups and full-view reads at the leader's tick
READ_LOOKUPS, READ_VIEWS = 200, 20


def _replica_feed(cfg: Dict[str, int], seed: int) -> tuple:
    """(head, tail, after): the queries and the preload (phase 13's feed),
    the tail of ``REPLICA_TAIL`` and the two batches after the failover,
    each as (batch id, source, host batch, kind)."""
    Q, dim, per = cfg["Q"], cfg["dim"], cfg["per_tick"]
    head = _knn_feed(cfg, seed)[:1 + cfg["preload_chunks"]]
    rng = np.random.default_rng(seed + 1)
    lo = cfg["preload_chunks"] * cfg["preload_chunk"]
    nq = cfg["query_update"]
    qlo = 0

    def docs(lo: int) -> DeltaBatch:
        return DeltaBatch(np.arange(lo, lo + per, dtype=np.int64),
                          rng.integers(-127, 128, (per, dim),
                                       dtype=np.int8))

    def queries(qlo: int) -> DeltaBatch:
        return DeltaBatch(np.arange(qlo, qlo + nq, dtype=np.int64),
                          rng.standard_normal((nq, dim), dtype=np.float32))

    tail: List[tuple] = []
    for i, kind in enumerate(REPLICA_TAIL):
        if kind == "ins":
            tail.append((f"tins{i}", "d", docs(lo), "insert"))
            lo += per
        elif kind == "ret":
            b = tail[REPLICA_RETRACTS[i]][2]
            tail.append((f"tret{i}", "d", DeltaBatch(
                b.keys, b.values, -np.ones(len(b.keys), np.int64)),
                "retract"))
        else:
            tail.append((f"tqup{i}", "q", queries(qlo), "query update"))
            qlo += nq
    # the corpus is full after the tail (2^20 ids): the insert after the
    # failover lands on the ids the first retraction freed
    freed = tail[min(REPLICA_RETRACTS.values())][2].keys
    after = [("fins", "d", DeltaBatch(
        freed, rng.integers(-127, 128, (len(freed), dim), dtype=np.int8)),
        "insert"), ("fqup", "q", queries(qlo), "query update")]
    if qlo + nq > Q or lo > cfg["D"]:
        raise AssertionError("the feed outran the queries or the corpus")
    return head, tail, after


def _on_thread(ident: int) -> tuple:
    """(topk, topk_merge, scan_score) launches made so far on one host
    thread."""
    return (*topk_mod.LAUNCHES_BY_THREAD.get(ident, (0, 0)),
            topk_mod.SCAN_SCORE_BY_THREAD.get(ident, 0))


def _since_on(ident: int, l0: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_on_thread(ident), l0))


class _Counted:
    """A replica as the shipper, the read tier and the coordinator see it:
    every call passes through to it. The top-k launches made on the
    calling thread inside ``receive`` (the replay of shipped windows)
    and the first ``promote`` (the new leader's recovery) are added up
    here, apart from the leader's on its pump thread; a receive that
    published a new horizon is timed to its synchronize."""

    def __init__(self, inner, replay=NO_LAUNCH):
        self.inner = inner
        self.name = inner.name
        self.replay = list(replay)
        self.apply_s: List[tuple] = []
        #: (start, end, payload bytes) of every receive, host clock
        self.rx: List[tuple] = []
        self.shipped = 0
        self.promote_s = None
        self.promote_t0 = None
        self.promote_launches = NO_LAUNCH
        self.error = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def receive(self, sh):
        me = threading.get_ident()
        l0, h0 = _on_thread(me), self.inner.published_horizon()
        t0 = time.perf_counter()
        try:
            resp = self.inner.receive(sh)
        except BaseException as e:
            self.error = e
            raise
        h1 = self.inner.published_horizon()
        if h1 > h0:
            _sync()
            self.apply_s.append((time.perf_counter() - t0, h1 - h0))
        d = _since_on(me, l0)
        self.replay = _plus(self.replay, d)
        self.rx.append((t0, time.perf_counter(), len(sh.payload)))
        if isinstance(resp, ShipAck):
            self.shipped += len(sh.payload)
        return resp

    def promote(self, **kw):
        me = threading.get_ident()
        first = self.promote_s is None
        l0, t0 = _on_thread(me), time.perf_counter()
        sched = self.inner.promote(**kw)
        _sync()
        if first:
            self.promote_t0 = t0
            self.promote_s = time.perf_counter() - t0
            self.promote_launches = _since_on(me, l0)
        return sched


def _wait_horizon(followers: List[_Counted], tick: int, t0: float
                  ) -> Dict[str, float]:
    """Seconds from ``t0`` until each follower published ``tick``; raises
    what a follower's replay raised, or after ``REPLICA_WAIT_S``."""
    seen: Dict[str, float] = {}
    while len(seen) < len(followers):
        for p in followers:
            if p.error is not None:
                raise AssertionError(f"{p.name}: replay failed") from p.error
            if p.name not in seen and p.published_horizon() >= tick:
                seen[p.name] = time.perf_counter() - t0
        if time.perf_counter() - t0 > REPLICA_WAIT_S:
            raise AssertionError(
                f"followers at {[p.published_horizon() for p in followers]}"
                f", the leader at tick {tick}")
        time.sleep(0.0002)
    return seen


def _mirror_digest(replica) -> Dict[str, tuple]:
    """Each mirrored segment's size, mtime and CRC-32 of its bytes."""
    out = {}
    for _seq, path in list_segments(replica.mirror_dir):
        st = os.stat(path)
        with open(path, "rb") as f:
            out[os.path.basename(path)] = (st.st_size, st.st_mtime_ns,
                                           zlib.crc32(f.read()))
    return out


def _pct(xs: List[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def replicate_knn(card: str, fs: str, tmp: str,
                  cfg: Dict[str, int] = FULL) -> Dict[str, object]:
    """Config 4's k-NN at full width through a durable leader with two
    followers on their own executors (one from segment 0, one from the
    leader's checkpoint), reads through the read tier, a follower's
    restart, a compaction of the tail and a follower re-anchored across
    it, and a failover to a promoted follower, beside a non-replicated
    twin fed the same acknowledged batches."""
    chunks = cfg["D"] // cfg["scan_chunk"]
    main = threading.get_ident()
    head, tail, after = _replica_feed(cfg, seed=14)
    wal_dir = os.path.join(tmp, "leader-wal")
    ckpt_dir = os.path.join(tmp, "leader-ckpt")
    graphs = {n: _knn_graph(cfg, sink=True)
              for n in ("leader", "twin", "r0", "r1")}
    kd, kt = graphs["leader"], graphs["twin"]
    leader = DurableScheduler(kd.graph, _executor(),
                              wal_dir=wal_dir, fsync="tick",
                              committer="thread",
                              segment_bytes=cfg.get("segment_bytes",
                                                    16 << 20))
    twin = DirtyScheduler(kt.graph, _executor())
    fe, fe_t = (_knn_frontend(leader, cfg, "leader"),
                _knn_frontend(twin, cfg, "twin"))
    ship = SegmentShipper(leader.wal, ckpt_dir=ckpt_dir,
                          leader_tick=lambda: leader._tick)
    r0 = _Counted(ReplicaScheduler(graphs["r0"].graph,
                                   os.path.join(tmp, "r0"),
                                   executor=_executor(), name="r0"))
    ship.attach(r0)
    if r0.bootstraps:
        raise AssertionError("r0 bootstrapped: no checkpoint existed yet")
    followers = [r0]
    counts = {key: list(NO_LAUNCH) for key in
              ("leader", "twin", "restart", "recover", "new_leader")}

    def add(key, d):
        counts[key] = _plus(counts[key], d)

    def replayed() -> tuple:
        return tuple(map(sum, zip(*[p.replay for p in live])))

    def submit(front, g, item) -> float:
        bid, src, batch, _kind = item
        ticket = front.submit(g.queries if src == "q" else g.docs, batch,
                              batch_id=bid)
        front.flush(timeout=600)
        res = ticket.result(timeout=600)
        if res.status != APPLIED:
            raise AssertionError(f"{bid}: ticket {res}")
        return time.perf_counter()

    def twin_step(item):
        l0 = _on_thread(fe_t._thread.ident)
        submit(fe_t, kt, item)
        _sync()
        add("twin", _since_on(fe_t._thread.ident, l0))

    def check(tag: str, sched, g, among: List[_Counted]):
        """Each follower in ``among`` that reached ``sched``'s tick holds
        its table and its sink view exactly."""
        tick = sched._tick
        want = sched.read_table(g.index)
        view = {kv: w for kv, w in sched.view("nn").items() if w != 0}
        for p in among:
            if p.published_horizon() < tick:
                continue
            with p.inner._lock:
                got = p.inner.sched.read_table(graphs[p.name].index)
            h, pview = p.inner.view_at("nn")
            bad = _table_diff(got, want)
            if bad or h != tick or pview != view:
                raise AssertionError(
                    f"{tag}: {p.name} at horizon {h} unlike the leader at "
                    f"tick {tick} (queries {bad[:8]}, views equal "
                    f"{pview == view})")
            checks.append((tag, p.name, tick))

    checks: List[tuple] = []
    live = [r0]
    steps: List[Dict[str, object]] = []

    def leader_step(item, threaded: bool) -> Dict[str, object]:
        pump = fe._thread.ident
        l0 = _on_thread(pump)
        t0 = time.perf_counter()
        t_ack = submit(fe, kd, item)
        tick = leader._tick
        at_ack = {p.name: tick - p.published_horizon() for p in followers}
        if not threaded:
            while not ship.fully_shipped():
                ship.pump_once()
        lag = _wait_horizon(followers, tick, t_ack)
        _sync()
        mine = _since_on(pump, l0)
        add("leader", mine)
        want = _want_launches(item[3], chunks)
        if mine != want:
            raise AssertionError(f"{item[0]}: the leader launched {mine}, "
                                 f"expected {want}")
        twin_step(item)
        check(item[0], leader, kd, followers)
        row = {"id": item[0], "kind": item[3], "s": t_ack - t0,
               "lag_s": lag, "lag_ticks": at_ack,
               "rx": [(round((a - t_ack) * 1e3, 2), round((b - a) * 1e3, 2),
                       n) for a, b, n in followers[0].rx if a >= t0]}
        steps.append(row)
        return row

    try:
        # the head, shipped by pump_once on this thread
        for item in head:
            leader_step(item, threaded=False)
        t0 = time.perf_counter()
        meta = save_checkpoint(leader, ckpt_dir)
        ckpt_s = time.perf_counter() - t0
        r1 = _Counted(ReplicaScheduler(graphs["r1"].graph,
                                       os.path.join(tmp, "r1"),
                                       executor=_executor(),
                                       name="r1"))
        l0 = _launches()
        t0 = time.perf_counter()
        ship.attach(r1)
        _sync()
        boot_s = time.perf_counter() - t0
        if _since(l0) != NO_LAUNCH or r1.bootstraps != 1 \
                or r1.published_horizon() != leader._tick:
            raise AssertionError(f"r1's bootstrap: {r1.bootstraps} "
                                 f"bootstraps, horizon "
                                 f"{r1.published_horizon()}")
        followers.append(r1)
        live.append(r1)
        check("bootstrap", leader, kd, [r1])
        # the tail, shipped by the shipper's thread
        ship.start()
        n_head_applies = len(r0.apply_s)
        for i, item in enumerate(tail):
            leader_step(item, threaded=True)
            if i == REPLICA_DETACH_AFTER:
                ship.detach("r1")
                followers.remove(r1)
                r1_cursor = tuple(r1.subscribe())
            if i != REPLICA_RESTART_AFTER:
                continue
            # r0's restart: a checkpoint of its own, then a fresh executor
            ship.detach("r0")
            followers.remove(r0)
            t0 = time.perf_counter()
            r0.inner.checkpoint()
            r0_ckpt_s = time.perf_counter() - t0
            r0_dir, old_replay = r0.inner.replica_dir, tuple(r0.replay)
            r0_boots = r0.bootstraps
            old_apply = r0.apply_s[n_head_applies:]
            old_shipped = r0.shipped
            live.remove(r0)
            del r0
            torch.cuda.empty_cache()
            graphs["r0"] = _knn_graph(cfg, sink=True)
            l0 = _on_thread(main)
            t0 = time.perf_counter()
            inner = ReplicaScheduler(graphs["r0"].graph, r0_dir,
                                     executor=_executor(), name="r0")
            _sync()
            restart_s = time.perf_counter() - t0
            counts["restart"] = _since_on(main, l0)
            r0 = _Counted(inner)
            if inner.restored_from not in ("checkpoint",
                                           "checkpoint+tail", "tail") \
                    or inner.published_horizon() != leader._tick:
                raise AssertionError(f"r0 restarted from "
                                     f"{inner.restored_from} at "
                                     f"{inner.published_horizon()}")
            check("restart", leader, kd, [r0])
            ship.attach(r0)
            followers.append(r0)
            live.append(r0)
            if old_replay != tuple(counts["leader"]):
                raise AssertionError(f"r0 replayed {old_replay}, the leader "
                                     f"launched {counts['leader']}")
        tail_segments = [seq for seq, _p in list_segments(wal_dir)
                         if seq >= meta["wal_pos"][0]]

        # reads through the tier at the leader's tick (read-your-writes)
        tick = leader._tick
        tier = ReadTier([r0, r1], leader=LeaderReadAdapter(leader))
        want_view = {kv: w for kv, w in leader.view("nn").items() if w != 0}
        keys = list(want_view)
        look_s, view_s = [], []
        for j in range(READ_LOOKUPS):
            t0 = time.perf_counter()
            res = tier.lookup("nn", keys[j % len(keys)], min_horizon=tick)
            look_s.append(time.perf_counter() - t0)
            if res.value != 1.0 or res.horizon != tick \
                    or res.source != "r0":
                raise AssertionError(f"lookup: {res}")
        for _ in range(READ_VIEWS):
            t0 = time.perf_counter()
            res = tier.view_at("nn", min_horizon=tick)
            view_s.append(time.perf_counter() - t0)
            if res.value != want_view or res.source != "r0":
                raise AssertionError(f"view_at from {res.source} at "
                                     f"{res.horizon}: unlike the leader's")
        try:
            ReadTier([r0, r1]).lookup("nn", keys[0], min_horizon=tick + 1)
        except StaleRead:
            pass
        else:
            raise AssertionError("a read above every replica was served")
        if tier.leader_fallbacks or tier.stale_reads:
            raise AssertionError("a fresh read fell back to the leader")

        # compaction of the tail, bounded by the checkpoint and by r0
        comp = WalCompactor(leader.wal, shipper=ship, ckpt_dir=ckpt_dir,
                            min_segments=2, keep_segments=0)
        t0 = time.perf_counter()
        ev = comp.compact_once()
        compact_s = time.perf_counter() - t0
        if ev is None or not ev["covers"][0] <= r1_cursor[0] \
                <= ev["covers"][1]:
            raise AssertionError(f"compaction {ev}: r1's cursor "
                                 f"{r1_cursor} outside the folded range")
        folded = [r for _p, r in scan_wal(wal_dir)[0]
                  if r.get("compacted") and r["node"] == kd.docs.id]
        gone = np.concatenate([tail[j][2].keys
                               for j in REPLICA_RETRACTS.values()])
        kept = sum(len(r["keys"]) for r in folded)
        if not folded or any(np.isin(r["keys"], gone).any()
                             or (np.asarray(r["weights"]) == 0).any()
                             for r in folded):
            raise AssertionError("retracted rows survived the fold")
        # the host loops, alone: the fold's rows, the snapshot's walk
        push = [r for _p, r in scan_wal(os.path.join(r0_dir, "wal"),
                                        tuple(meta["wal_pos"]))[0]
                if r.get("kind") == "push" and r["node"] == kd.docs.id]
        fold = _SourceFold(kd.docs.id, push[0])
        rows = sum(len(r["keys"]) for r in push)
        t0 = time.perf_counter()
        for r in push:
            fold.add(r)
        fold_s = time.perf_counter() - t0
        sink_rows = [rw for d in leader.history[-1].sink_deltas.values()
                     for rw in d.rows()]
        t0 = time.perf_counter()
        for kk, vv, _w in sink_rows:
            tiles.bucket_of((kk, vv))
        walk_s = time.perf_counter() - t0
        # recovery from the checkpoint and the compacted log
        gc_ = _knn_graph(cfg, sink=True)
        rc = DirtyScheduler(gc_.graph, _executor())
        l0 = _on_thread(main)
        t0 = time.perf_counter()
        rep = recover(rc, wal_dir, ckpt_dir)
        _sync()
        rc_s = time.perf_counter() - t0
        counts["recover"] = _since_on(main, l0)
        bad = _table_diff(rc.read_table(gc_.index),
                          leader.read_table(kd.index))
        if bad or rc._tick != leader._tick:
            raise AssertionError(f"recovery from the compacted log: tick "
                                 f"{rc._tick}, queries {bad[:8]} unlike "
                                 f"the leader's")
        del rc, gc_
        torch.cuda.empty_cache()
        # r1 comes back with its cursor inside the folded range
        b0 = r1.bootstraps
        t0 = time.perf_counter()
        ship.attach(r1)
        followers.append(r1)
        _wait_horizon([r1], leader._tick, t0)
        _sync()
        reanchor_s = time.perf_counter() - t0
        if r1.bootstraps != b0 + 1:
            raise AssertionError("r1 did not re-anchor on the checkpoint")
        check("re-anchor", leader, kd, [r1])

        # failover: the leader stops without a drain
        fe.close(flush=False)
        tier = ReadTier([r0, r1], leader=LeaderReadAdapter(leader))
        coord = FailoverCoordinator([r0, r1], shipper=ship, read_tier=tier,
                                    durable_kw={"fsync": "tick",
                                                "committer": "thread"})
        l0 = _on_thread(main)
        t0 = time.perf_counter()
        coord.promote_now(reason="leader stopped")
        new = coord.leader_sched
        _sync()
        fail_s = time.perf_counter() - t0
        win = coord.winner
        fail_drain_s = win.promote_t0 - t0
        survivor = r1 if win is r0 else r0
        if new.wal.epoch != 1 or type(new.executor).__name__ \
                != "CudaExecutor" \
                or new.executor.device.type != _device_type() \
                or new.executor is win.inner.sched.executor:
            raise AssertionError(f"the promoted leader: epoch "
                                 f"{new.wal.epoch}, executor "
                                 f"{type(new.executor).__name__} on "
                                 f"{getattr(new.executor, 'device', '?')}")
        if _since_on(main, l0) != win.promote_launches:
            raise AssertionError("launches outside the promotion's "
                                 "recovery during the failover")
        fe2 = _knn_frontend(new, cfg, "promoted")
        try:
            firsts = []
            for item in after:
                l0 = _on_thread(fe2._thread.ident)
                t1 = time.perf_counter()
                t_ack = submit(fe2, graphs[win.name], item)
                firsts.append(t_ack - t1)
                if item is after[0]:
                    to_first_write = t_ack - t0
                _wait_horizon([survivor], new._tick, t_ack)
                _sync()
                add("new_leader", _since_on(fe2._thread.ident, l0))
                twin_step(item)
                check(f"after {item[0]}", new, graphs[win.name],
                      [survivor])
        finally:
            fe2.close()
        # the zombie: its append is fenced, and a shipment of its epoch
        # (the bytes of its last segment) is refused before a byte lands
        digests = {p.name: _mirror_digest(p.inner) for p in (r0, r1)}
        try:
            leader.wal.append({"kind": "tick", "tick": leader._tick + 1})
        except FencedWrite:
            pass
        else:
            raise AssertionError("the old leader's append was not fenced")
        if ship.pump_once():
            raise AssertionError("the old shipper shipped after the fence")
        seq, spath = list_segments(wal_dir)[-1]
        with open(spath, "rb") as f:
            zbytes = f.read()[len(_MAGIC):]
        for p in (r0, r1):
            zombie = p.inner.receive(Shipment(
                seq, len(_MAGIC), zbytes, len(_MAGIC) + len(zbytes), False,
                None, leader._tick + 1, 0))
            if not isinstance(zombie, ShipNack) \
                    or not zombie.reason.startswith("fenced") \
                    or _mirror_digest(p.inner) != digests[p.name]:
                raise AssertionError(f"{p.name}: a zombie shipment was "
                                     f"not fenced out: {zombie}")
        bad = _table_diff(new.read_table(graphs[win.name].index),
                          twin.read_table(kt.index))
        if bad:
            raise AssertionError(f"the promoted leader unlike the twin: "
                                 f"queries {bad[:8]}")
        coord.close()
        new.close()
    finally:
        ship.stop()
        fe.close(flush=False)
        fe_t.close()
        leader.close()

    replica = [sum(x) for x in zip(
        counts["restart"], counts["recover"], win.promote_launches,
        counts["new_leader"])]
    for p in (r1, r0):
        replica = _plus(replica, p.replay)
    replica = _plus(replica, old_replay)
    if _on_card() and not (replica[0] and replica[1]):
        raise AssertionError(f"the replicas launched {replica}: both "
                             f"top-k entries must run on the replica path")
    tail_rows = steps[len(head):]
    lag_ms = {n: [r["lag_s"][n] * 1e3 for r in tail_rows
                  if n in r["lag_s"]] for n in ("r0", "r1")}
    applies = [s * 1e3 / n for s, n in old_apply + r0.apply_s]
    head_lag = [round(r["lag_s"]["r0"] * 1e3, 2) for r in steps[:len(head)]]
    ship_mb = {"r0": (old_shipped + r0.shipped) / 1e6,
               "r1": r1.shipped / 1e6}
    log(f"[replica] k-NN at full width (Q {cfg['Q']}, {cfg['D']} ids x "
        f"{cfg['dim']} int8, k {cfg['k']}, chunk {cfg['scan_chunk']}, a sink "
        f"on the index) through IngestFrontend(depth=2) over "
        f"DurableScheduler(fsync='tick', committer='thread'); r0 from "
        f"segment 0, r1 from the checkpoint, each a ReplicaScheduler on its "
        f"own cuda executor; {len(checks)} follower checks equal to the "
        f"leader (table bit for bit and sink view) [{card}] [{fs}]")
    log(f"[replica] ship lag at the ack, ticks behind (r0, r1) "
        f"{[tuple(r['lag_ticks'].values()) for r in tail_rows]}; ack to "
        f"horizon ms (tail, shipper thread; the first tail tick's receives "
        f"on r0 as (start after the ack, ms, bytes): {tail_rows[0]['rx']}"
        f"): r0 median "
        f"{_median(lag_ms['r0']):.3f} of "
        f"{[round(x, 2) for x in lag_ms['r0']]}, r1 median "
        f"{_median(lag_ms['r1']):.3f} of "
        f"{[round(x, 2) for x in lag_ms['r1']]}; head (pump_once) ack to "
        f"r0's horizon ms {head_lag} [{card}] [{fs}]")
    log(f"[replica] shipped {ship.bytes_total / 1e6:.1f} MB in "
        f"{ship.shipments} shipments (r0 "
        f"{ship_mb['r0']:.1f} MB, r1 {ship_mb['r1']:.1f} MB), "
        f"{ship.nacks} NACKs, {ship.compact_reanchors} compaction "
        f"re-anchors, {r0_boots} bootstrap(s) of r0 (a checkpoint "
        f"truncated the segment its cursor ended); replica apply ms a "
        f"window (r0, the tail): median "
        f"{_median(applies):.3f} of {[round(a, 2) for a in applies]}; "
        f"leader tick ms (tail) "
        f"{[round(r['s'] * 1e3, 2) for r in tail_rows]} [{card}] [{fs}]")
    log(f"[replica] leader checkpoint {ckpt_s * 1e3:.1f} ms "
        f"({meta['states_bytes'] / 1e6:.1f} MB of device state); r1's "
        f"bootstrap {boot_s * 1e3:.1f} ms: {meta['states_bytes'] / 1e6:.1f}"
        f" MB loaded onto the card and saved again as its own checkpoint; "
        f"r0's own checkpoint {r0_ckpt_s * 1e3:.1f} ms, its restart "
        f"{restart_s * 1e3:.1f} ms (restored_from "
        f"{r0.inner.restored_from!r}) [{card}] [{fs}]")
    log(f"[replica] ReadTier at the leader's tick (read-your-writes): "
        f"lookup p50 {_pct(look_s, 0.5) * 1e3:.4f} ms p95 "
        f"{_pct(look_s, 0.95) * 1e3:.4f} ms ({READ_LOOKUPS}); view_at "
        f"p50 {_pct(view_s, 0.5) * 1e3:.3f} ms p95 "
        f"{_pct(view_s, 0.95) * 1e3:.3f} ms ({READ_VIEWS}, "
        f"{len(want_view)} rows); StaleRead above every replica with no "
        f"leader [{card}]")
    log(f"[replica] compaction of segments {ev['covers']} (the tail's "
        f"{len(tail_segments)} segments, rotated at 16 MB): "
        f"{compact_s * 1e3:.1f} ms, records {ev['records_in']} -> "
        f"{ev['records_out']}, {ev['orig_bytes'] / 1e6:.1f} -> "
        f"{ev['bytes'] / 1e6:.1f} MB ({ev['reclaimed_bytes'] / 1e6:.1f} MB "
        f"reclaimed), {kept} doc rows kept, the {len(gone)} retracted rows "
        f"gone; _SourceFold.add alone {fold_s * 1e3:.1f} ms for {rows} "
        f"rows ({rows / max(fold_s, 1e-9) / 1e3:.1f} k rows/s); the "
        f"snapshot's bucket walk {walk_s * 1e3:.3f} ms for "
        f"{len(sink_rows)} sink rows [{card}] [{fs}]")
    log(f"[replica] recover from checkpoint + compacted log "
        f"{rc_s * 1e3:.1f} ms (restore {rep.restore_s * 1e3:.1f}, replay "
        f"{rep.replay_s * 1e3:.1f}; {rep.replayed_ticks} ticks), table == "
        f"the leader's; r1 re-anchored through the checkpoint in "
        f"{reanchor_s * 1e3:.1f} ms, then == the leader's [{card}] [{fs}]")
    log(f"[replica] failover to {win.name} (epoch 1, executor on "
        f"{new.executor.device}): {fail_s * 1e3:.1f} ms in all, of which "
        f"the drain, fence and election {fail_drain_s * 1e3:.1f}, the "
        f"promotion's recovery {win.promote_s * 1e3:.1f}, the survivor's "
        f"re-anchor and the re-point "
        f"{(fail_s - fail_drain_s - win.promote_s) * 1e3:.1f}; first tick "
        f"{firsts[0] * 1e3:.3f} ms; time to the first acknowledged write "
        f"{to_first_write * 1e3:.1f} ms; the old leader's append fenced, "
        f"a zombie shipment NACKed, no mirror byte changed; the survivor "
        f"and the new leader == the twin [{card}] [{fs}]")
    log(f"[replica] (topk, topk_merge, scan_score) launches: leader "
        f"{counts['leader']}"
        f", r0 replay {list(old_replay)} (== the leader's), r1 replay "
        f"{r1.replay}, r0 after its restart {r0.replay}, r0's restart "
        f"{list(counts['restart'])}, recovery from the compacted log "
        f"{list(counts['recover'])}, the promotion's recovery "
        f"{list(win.promote_launches)}, the promoted leader's ticks "
        f"{counts['new_leader']}; twin {counts['twin']}")
    return {"leader": counts["leader"], "replica": replica,
            "twin": counts["twin"], "lag_ms_r0": _median(lag_ms["r0"])}


def phase_replication(card: str) -> Dict[str, object]:
    """Replication at full width (``replicate_knn``); the top-k counts
    zeroed just before its path, and every launch since told apart: the
    leader's, the replica path's and the twin's."""
    tmp = tempfile.mkdtemp()
    try:
        fs = fs_line(tmp)
        log(f"[replica] WAL, mirrors and checkpoints under a temp dir: {fs}")
        zero_launches(by_thread=True)
        out = replicate_knn(card, fs, tmp)
        got = list(_launches())
        want = [a + b + c for a, b, c in zip(out["leader"], out["replica"],
                                            out["twin"])]
        if got != want:
            raise AssertionError(f"top-k launches {got}: the leader's "
                                 f"{out['leader']}, the replicas' "
                                 f"{out['replica']}, the twin's "
                                 f"{out['twin']}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 15: the serving tier and the wire ----------------------------------

#: bench_configs.control_scenario's numbers (bench.py's control mode): the
#: word-count tenants' byte budget (the hot one's ceiling is half of it,
#: the quiet one's floor a quarter), the control interval, the hot
#: tenant's occupancy SLO and its breach/recover intervals, the surge's
#: hammers and the quiet tenant's batches (the smoke setting's 60) and
#: p99 bound, the recovery slack, and the breaker's knobs
CONTROL = dict(budget_bytes=8 << 10, interval_s=0.005, occupancy_slo=0.6,
               breach_intervals=2, recover_intervals=2, hammers=3,
               quiet_batches=60, quiet_p99_bound_s=0.05,
               recovery_slack_ticks=12, max_crashes=3, crash_window_s=30.0,
               respawn_backoff_s=0.0, respawn_backoff_max_s=0.01,
               breaker_cooldown_s=0.02, breaker_cooldown_max_s=0.1,
               probe_intervals=2)
#: each hammer's pause between submits: 3 hammers still offer the hot
#: tenant thousands of batches a second, past what its windows drain
HAMMER_PACE_S = 0.001
#: the k-NN tenant's inserts submitted in process, beside the RPC ones,
#: on the ids phase 13's feed leaves free (3 x 8192 fill the 2^20 ids)
TIER_LOCAL_INSERTS = 3
#: the RPC insert whose response the producer's link loses (it resubmits)
TIER_RESET_AT = 4
TIER_PR_CHURN = 4
#: the word-count tenants' words (the bench's w0..w999) and key space
WC_WORDS, WC_KEYS = 1000, 1024
#: a wait on the tier, the follower or a ticket longer than this fails
TIER_WAIT_S = 120.0


def tier_want(cfg: Dict[str, int]) -> tuple:
    """(topk, topk_merge, scan_score) launches predicted for each k-NN
    path of the tier (the pool threads, the TCP follower's replay, the
    twin): the queries and the retraction and the query update rescan
    (one score and one merge a corpus chunk: 128 each at full width),
    the preload ticks (15) and
    the insert ticks (3 in process, 5 over RPC) run one top-k each; the
    resubmitted insert is deduped and runs no tick. Off the card no
    launch is counted."""
    if not _on_card():
        return NO_LAUNCH
    scans = 3 * (cfg["D"] // cfg["scan_chunk"])
    return (cfg["preload_chunks"] + TIER_LOCAL_INSERTS + cfg["insert_ticks"],
            scans, scans)


class _Meter:
    """The bytes written by every connection of the transports it wraps
    (whole frames, both ends of each link)."""

    def __init__(self):
        self.sent = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> int:
        with self._lock:
            self.sent += n
        return n

    def wrap(self, transport):
        meter = self

        class Conn:
            def __init__(self, inner):
                self.inner = inner

            def send_msg(self, obj, timeout_s=None):
                return meter.add(self.inner.send_msg(obj, timeout_s))

            def send_raw(self, data, timeout_s=None):
                return meter.add(self.inner.send_raw(data, timeout_s))

            def recv_msg(self, timeout_s=None):
                return self.inner.recv_msg(timeout_s)

            def close(self):
                self.inner.close()

            @property
            def alive(self):
                return self.inner.alive

        class Listener:
            def __init__(self, inner):
                self.inner = inner

            @property
            def address(self):
                return self.inner.address

            def accept(self, timeout_s=None):
                return Conn(self.inner.accept(timeout_s))

            def close(self):
                self.inner.close()

        class Transport:
            def listen(self):
                return Listener(transport.listen())

            def connect(self, address, timeout_s=None):
                return Conn(transport.connect(address, timeout_s))

        return Transport()


def _count_path(ex, path: str, tally: Dict[str, List[int]],
                lock: threading.Lock) -> None:
    """Add the top-k launches of ``ex``'s calls to ``tally[path]``,
    whichever host thread makes them: each call's launches on its own
    thread (the kernels' per-thread tallies) are counted at the call, so
    pool threads that come and go are mapped as they come."""
    tally[path] = list(NO_LAUNCH)
    for meth in ("run_pass", "dispatch_window", "run_tick_fixpoint"):
        def counted(*a, _real=getattr(ex, meth), **kw):
            me = threading.get_ident()
            l0 = _on_thread(me)
            try:
                return _real(*a, **kw)
            finally:
                d = _since_on(me, l0)
                with lock:
                    tally[path] = _plus(tally[path], d)
        setattr(ex, meth, counted)


def _wc_lines(tag: int, producer: int, j: int) -> List[str]:
    """bench.py's control-mode line: 8 words of w0..w999, seeded by the
    tenant, the producer and the batch."""
    rng = np.random.default_rng((tag * 101 + producer) * 100_003 + j)
    return [" ".join(f"w{int(x)}" for x in rng.integers(0, WC_WORDS, 8))]


def tier_knn(card: str, fs: str, tmp: str, cfg: Dict[str, int] = FULL,
             pr_cfg: Dict[str, object] = PAGERANK) -> Dict[str, object]:
    """One ``ServeTier(pump_threads=2)`` on the card hosting config 4's
    k-NN (durable, fed in process and over TCP by a ``RemoteProducer``,
    its log shipped over TCP to a follower), config 3's PageRank and two
    word-count tenants under a ``ControlPlane`` (a hot tenant's surge,
    then a crash storm), beside the k-NN tenant's twin."""
    from reflow_tpu_torch.net import (FaultyTransport, RemoteFollower,
                                      ReplicaServer, TcpTransport)
    from reflow_tpu_torch.obs import MetricsRegistry
    from reflow_tpu_torch.serve import (ControlConfig, ControlPlane,
                                        GraphConfig, RemoteProducer,
                                        RpcIngestServer, SLOSpec, ServeTier)
    from reflow_tpu_torch.utils.faults import StormInjector, WireFaults
    from reflow_tpu_torch.utils.metrics import percentile, summarize_tier

    kn = CONTROL
    t_phase = time.perf_counter()
    feed = _knn_feed(cfg, seed=15)
    n_head = 1 + cfg["preload_chunks"]
    head, ins, (ret, qup) = feed[:n_head], feed[n_head:-2], feed[-2:]
    rng = np.random.default_rng(16)
    lo = cfg["preload_chunks"] * cfg["preload_chunk"] \
        + cfg["insert_ticks"] * cfg["per_tick"]
    local = []
    for i in range(TIER_LOCAL_INSERTS):
        local.append((f"lins{i}", "d", DeltaBatch(
            np.arange(lo, lo + cfg["per_tick"], dtype=np.int64),
            rng.integers(-127, 128, (cfg["per_tick"], cfg["dim"]),
                         dtype=np.int8)), "insert"))
        lo += cfg["per_tick"]
    if lo > cfg["D"]:
        raise AssertionError("the local inserts outran the corpus")

    tally: Dict[str, List[int]] = {}
    lock = threading.Lock()
    kd, kt, kr = (_knn_graph(cfg) for _ in range(3))
    leader = DurableScheduler(kd.graph, _executor(),
                              wal_dir=os.path.join(tmp, "knn-wal"),
                              fsync="tick", committer="thread")
    twin = DirtyScheduler(kt.graph, _executor())
    replica = ReplicaScheduler(kr.graph, os.path.join(tmp, "f0"),
                               executor=_executor(), name="f0")
    _count_path(leader.executor, "tier", tally, lock)
    _count_path(replica.sched.executor, "tier_replica", tally, lock)
    _count_path(twin.executor, "twin", tally, lock)
    pg, web, _pex, pr_sched, _arena = pagerank_setup(pr_cfg,
                                                     {"device": DEVICE})
    wc = {}
    for name in ("wc_hot", "wc_quiet"):
        g, src, sink = wordcount.build_graph(WC_KEYS)
        wc[name] = (DirtyScheduler(g, _executor()), src, sink)
    vocab = {f"w{i}": i for i in range(WC_WORDS)}

    storm = StormInjector(only="pool_window@wc_hot")
    storm.disarm()
    tier = ServeTier(max_bytes=1 << 30, pump_threads=2, crash=storm)
    meter = _Meter()
    tcp = meter.wrap(TcpTransport())
    window = CoalesceWindow(max_rows=cfg["preload_chunk"], max_ticks=8,
                            max_latency_s=0.005)
    wc_window = CoalesceWindow(max_rows=4096, max_ticks=8,
                               max_latency_s=0.005)
    budget = kn["budget_bytes"]
    h_knn = tier.register("knn", leader, GraphConfig(
        window=window, admission="device", window_depth=2))
    h_pr = tier.register("pagerank", pr_sched, GraphConfig(
        window=CoalesceWindow(max_rows=2 * pr_cfg["n_edges"], max_ticks=8,
                              max_latency_s=0.005)))
    h_hot = tier.register("wc_hot", wc["wc_hot"][0], GraphConfig(
        weight=1.0, ceiling_bytes=budget // 2, window=wc_window))
    h_quiet = tier.register("wc_quiet", wc["wc_quiet"][0], GraphConfig(
        weight=4.0, floor_bytes=budget // 4, window=wc_window))
    rsrv = ReplicaServer(replica, tcp).start()
    ship = SegmentShipper(leader.wal, leader_tick=lambda: leader._tick)
    link = RemoteFollower(tcp, rsrv.address, name="f0", io_timeout_s=60.0)
    ship.attach(link)
    ship.start()
    rpc = RpcIngestServer(h_knn, tcp).start()
    faults = WireFaults(seed=15)
    prod = RemoteProducer(FaultyTransport(tcp, faults), rpc.address,
                          name="knn-producer", io_timeout_s=60.0)
    cp = None
    errors: List[BaseException] = []
    try:
        for h in (h_knn, h_pr, h_hot, h_quiet):
            ex = h.frontend.sched.executor
            if ex.device.type != _device_type() \
                    or h.device_label != str(ex.device):
                raise AssertionError(f"{h.name}: executor on {ex.device}, "
                                     f"label {h.device_label}")
        for ex in (replica.sched.executor, twin.executor):
            if ex.device.type != _device_type():
                raise AssertionError(f"an executor on {ex.device}")

        # PageRank on its own producer thread, beside the k-NN preload
        pr_ticks: List[float] = []

        def pagerank_producer():
            try:
                t0 = time.perf_counter()
                a = h_pr.submit(pg.teleport,
                                pagerank.teleport_batch(pr_cfg["n_nodes"]))
                b = h_pr.submit(pg.edges, web.initial_batch())
                for t in (a, b):
                    if not t.result(timeout=TIER_WAIT_S).applied:
                        raise AssertionError("pagerank: initial batch")
                pr_ticks.append(time.perf_counter() - t0)
                for _ in range(TIER_PR_CHURN):
                    t0 = time.perf_counter()
                    t = h_pr.submit(pg.edges, web.churn(pr_cfg["churn"]))
                    if not t.result(timeout=TIER_WAIT_S).applied:
                        raise AssertionError("pagerank: churn batch")
                    pr_ticks.append(time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        pr_thread = threading.Thread(target=pagerank_producer,
                                     name="pagerank-producer")
        pr_thread.start()

        rows: List[Dict[str, object]] = []
        follower_checks = 0

        def after_ack(item, t_sub, t_ack, how, res):
            nonlocal follower_checks
            bid, src, batch, kind = item
            if res.status not in (APPLIED, DEDUPED):
                raise AssertionError(f"{bid}: {res}")
            h_knn.flush(timeout=TIER_WAIT_S)
            tick = leader._tick
            while replica.published_horizon() < tick:
                if time.perf_counter() - t_ack > TIER_WAIT_S:
                    raise AssertionError(
                        f"{bid}: the follower at "
                        f"{replica.published_horizon()}, the leader at "
                        f"tick {tick}")
                time.sleep(0.0002)
            lag = time.perf_counter() - t_ack
            if how != "dedup":
                twin.tick_many([{kt.queries if src == "q" else kt.docs:
                                 batch}]).block()
            want = twin.read_table(kt.index)
            bad = _table_diff(leader.read_table(kd.index), want)
            if bad or tick != twin._tick:
                raise AssertionError(
                    f"{bid}: the tier's table at tick {tick} unlike the "
                    f"twin's at {twin._tick} (queries {bad[:8]})")
            with replica._lock:
                got = replica.sched.read_table(kr.index)
                h = replica.published_horizon()
            bad = _table_diff(got, want)
            if bad or h != tick:
                raise AssertionError(
                    f"{bid}: the follower at horizon {h} unlike the "
                    f"leader at tick {tick} (queries {bad[:8]})")
            follower_checks += 1
            rows.append({"id": bid, "kind": kind, "how": how,
                         "status": res.status, "s": t_ack - t_sub,
                         "lag_s": lag, "tick": tick})

        def local_submit(item):
            bid, src, batch, _kind = item
            t0 = time.perf_counter()
            res = h_knn.submit(kd.queries if src == "q" else kd.docs, batch,
                               batch_id=bid).result(timeout=TIER_WAIT_S)
            after_ack(item, t0, time.perf_counter(), "local", res)

        def rpc_submit(item, reset=False):
            bid, src, batch, _kind = item
            fails = prod.link_failures
            t0 = time.perf_counter()
            if reset:
                faults.set_rates(drop_s2c=1.0)
            ticket = prod.submit("queries" if src == "q" else "docs", batch,
                                 batch_id=bid)
            if reset:
                faults.quiesce()
                if prod.link_failures != fails + 1 or ticket.done():
                    raise AssertionError(f"{bid}: the link did not drop the "
                                         f"ack ({prod.link_failures} "
                                         f"failures)")
            res = ticket.result(timeout=TIER_WAIT_S)
            t_ack = time.perf_counter()
            if reset:
                if res.status != DEDUPED \
                        or bid not in prod.last_hello["admitted"] \
                        or ticket.submits < 2:
                    raise AssertionError(
                        f"{bid}: resubmitted after the reset, {res}, "
                        f"admitted {prod.last_hello['admitted']}, "
                        f"{ticket.submits} submits")
                # the first submit applied it; its tick is the twin's now
                twin.tick_many([{kt.queries if src == "q" else kt.docs:
                                 batch}]).block()
                after_ack(item, t0, t_ack, "dedup", res)
            else:
                after_ack(item, t0, t_ack, "rpc", res)

        # a server's boot heap stays out of its full collections: the
        # 14 phases before this one left a heap whose full collection
        # stalls every thread about 95 ms (the tier's admissions too)
        gc.collect()
        gc.freeze()
        # zero the tallies just before the path
        zero_launches(by_thread=True)
        t_knn = time.perf_counter()
        for item in head + local:
            local_submit(item)
        for i, item in enumerate(ins):
            rpc_submit(item, reset=(i == min(TIER_RESET_AT,
                                             len(ins) - 1)))
        for item in (ret, qup):
            rpc_submit(item)
        knn_s = time.perf_counter() - t_knn
        launches = _launches()
        pr_thread.join(timeout=TIER_WAIT_S)
        if errors:
            raise AssertionError("pagerank producer failed") from errors[0]
        if pr_thread.is_alive():
            raise AssertionError("pagerank producer still running")
        h_pr.flush(timeout=TIER_WAIT_S)
        pr_err = rank_error(pr_sched, pg, web, pr_cfg["n_nodes"])
        if pr_err["rel_err"] > PAGERANK_MAX_REL_ERR:
            raise AssertionError(f"pagerank in the tier: relative error "
                                 f"{pr_err['rel_err']:.3g}")

        # the word-count tenants under the control plane
        slo = SLOSpec(budget_occupancy=kn["occupancy_slo"],
                      breach_intervals=kn["breach_intervals"],
                      recover_intervals=kn["recover_intervals"])
        reg = MetricsRegistry()
        cp = ControlPlane(
            tier, specs={"wc_hot": slo, "wc_quiet": slo},
            config=ControlConfig(
                interval_s=kn["interval_s"],
                max_crashes=kn["max_crashes"],
                crash_window_s=kn["crash_window_s"],
                respawn_backoff_s=kn["respawn_backoff_s"],
                respawn_backoff_max_s=kn["respawn_backoff_max_s"],
                breaker_cooldown_s=kn["breaker_cooldown_s"],
                breaker_cooldown_max_s=kn["breaker_cooldown_max_s"],
                probe_intervals=kn["probe_intervals"]),
            registry=reg)
        cp.start()
        hot_tickets: List[tuple] = []
        quiet_batches: List[DeltaBatch] = []
        stop = threading.Event()

        def hammer(pid):
            j = 0
            while not stop.is_set():
                b = wordcount.ingest_lines(_wc_lines(7, pid, j),
                                           vocab=dict(vocab))
                try:
                    t = h_hot.submit(wc["wc_hot"][1], b, timeout=0.2)
                    with lock:
                        hot_tickets.append((t, b))
                except Exception:  # noqa: BLE001 - saturation is the point
                    pass
                j += 1
                # a hammer paces itself: unpaced, three spinning threads
                # take the interpreter lock from every torch call of the
                # pool threads and the quiet tenant's producer
                time.sleep(HAMMER_PACE_S)

        gc_pauses: List[float] = []
        gc_t0 = [0.0]

        def gc_timer(phase, info):
            if info["generation"] != 2:
                return
            if phase == "start":
                gc_t0[0] = time.perf_counter()
            else:
                gc_pauses.append(time.perf_counter() - gc_t0[0])

        gc.callbacks.append(gc_timer)
        t_surge = time.perf_counter()
        cp_t0 = cp._clock()
        hammers = [threading.Thread(target=hammer, args=(p,),
                                    name=f"hammer-{p}")
                   for p in range(kn["hammers"])]
        for t in hammers:
            t.start()
        for j in range(kn["quiet_batches"]):
            b = wordcount.ingest_lines(_wc_lines(6, 0, j), vocab=dict(vocab))
            res = h_quiet.submit(wc["wc_quiet"][1], b).result(
                timeout=TIER_WAIT_S)
            if not res.applied:
                raise AssertionError(f"wc_quiet batch {j}: {res}")
            quiet_batches.append(b)
        surge_s = time.perf_counter() - t_surge
        # each tenant's peak rung, from the control plane's own record of
        # every step it took in the surge: a rung may be held for only a
        # tick or two, which a read after each quiet batch can miss (under
        # CPU contention the control thread ticks a quarter as often)
        surge_end = cp._clock()
        hot_peak, quiet_peak = (max(
            (a["level"] for a in list(cp.actions)
             if a["kind"] == "brownout_step" and a["graph"] == name
             and cp_t0 <= a["now"] <= surge_end), default=0)
            for name in ("wc_hot", "wc_quiet"))
        quiet_adm = list(h_quiet.frontend.admission_s)
        quiet_p99 = percentile(quiet_adm, 99)
        stop.set()
        for t in hammers:
            t.join()
        gc.callbacks.remove(gc_timer)
        log(f"[tier] the surge's host: wc_quiet's slowest admissions ms "
            f"{[round(x * 1e3, 3) for x in sorted(quiet_adm)[-3:]]}; "
            f"{len(gc_pauses)} full garbage collections, ms "
            f"{[round(x * 1e3, 1) for x in gc_pauses]} [{card}]")
        ticks_at_end = cp.ticks
        rungs = len(slo.ladder)
        bound = rungs * kn["recover_intervals"] + kn["recovery_slack_ticks"]
        deadline = time.perf_counter() + 30
        # the ladder's level drops before the control thread takes the
        # tier's lock to set the policy: wait for both
        while ((cp.level("wc_hot") > 0 or h_hot.frontend.policy != "block")
               and time.perf_counter() < deadline):
            time.sleep(kn["interval_s"])
        recovery = cp.ticks - ticks_at_end
        # the admission gate is the card's: a CPU child shares its cores
        # with whatever else runs, and then reports the p99 only
        p99_ok = quiet_p99 <= kn["quiet_p99_bound_s"] or not _on_card()
        if not _on_card():
            log(f"[tier] quiet admission p99 {quiet_p99 * 1e3:.3f} ms "
                f"(the {kn['quiet_p99_bound_s'] * 1e3:.0f} ms gate holds "
                f"on the card only) [{card}]")
        if not (hot_peak > 0 and quiet_peak == 0
                and cp.level("wc_hot") == 0
                and h_hot.frontend.policy == "block"
                and recovery <= bound
                and p99_ok):
            raise AssertionError(
                f"surge: hot peak level {hot_peak}, quiet {quiet_peak}, hot "
                f"policy {h_hot.frontend.policy} after {recovery} intervals "
                f"(bound {bound}), quiet admission p99 {quiet_p99 * 1e3:.3f}"
                f" ms (bound {kn['quiet_p99_bound_s'] * 1e3:.0f} ms)")
        surge_actions = list(cp.actions)

        # the crash storm through pool_window@wc_hot
        storm.rearm()
        t_storm = time.perf_counter()
        j = 0
        while cp.breaker_state("wc_hot") != "open":
            if time.perf_counter() - t_storm > 30:
                raise AssertionError("the breaker never opened")
            b = wordcount.ingest_lines(_wc_lines(5, 0, j), vocab=dict(vocab))
            try:
                t = h_hot.submit(wc["wc_hot"][1], b, timeout=0.1)
                with lock:
                    hot_tickets.append((t, b))
            except Exception:  # noqa: BLE001 - failed or quarantined
                pass
            j += 1
            time.sleep(0.002)
        open_s = time.perf_counter() - t_storm
        sib = h_quiet.submit(wc["wc_quiet"][1], wordcount.ingest_lines(
            _wc_lines(4, 0, 0), vocab=dict(vocab)))
        if not sib.result(timeout=TIER_WAIT_S).applied:
            raise AssertionError("wc_quiet did not apply during the storm")
        quiet_batches.append(wordcount.ingest_lines(_wc_lines(4, 0, 0),
                                                    vocab=dict(vocab)))
        storm.disarm()
        t_heal = time.perf_counter()
        while cp.breaker_state("wc_hot") != "closed":
            if time.perf_counter() - t_heal > 30:
                raise AssertionError("the breaker never closed")
            time.sleep(kn["interval_s"])
        heal_s = time.perf_counter() - t_heal
        for j in range(5):
            b = wordcount.ingest_lines(_wc_lines(5, 1, j), vocab=dict(vocab))
            t = h_hot.submit(wc["wc_hot"][1], b)
            if not t.result(timeout=TIER_WAIT_S).applied:
                raise AssertionError("wc_hot after the storm")
            hot_tickets.append((t, b))
        for h in (h_hot, h_quiet):
            h.flush(timeout=TIER_WAIT_S)
        actions = list(cp.actions)
        breaker = [a["kind"] for a in actions
                   if a.get("graph") == "wc_hot"
                   and a["kind"].startswith("breaker")]
        if breaker[:1] != ["breaker_open"] or breaker[-1:] != \
                ["breaker_close"] or "breaker_probe" not in breaker:
            raise AssertionError(f"breaker transitions {breaker}")
        # the word-count tenants against the CPU oracle: every batch whose
        # ticket applied, once
        statuses: Counter = Counter()
        applied_hot: List[DeltaBatch] = []
        for t, b in hot_tickets:
            try:
                res = t.result(timeout=TIER_WAIT_S)
            except Exception as e:  # noqa: BLE001 - crashed or closed
                statuses[type(e).__name__] += 1
                continue
            statuses[res.status] += 1
            if res.applied:
                applied_hot.append(b)
        for name, batches in (("wc_hot", applied_hot),
                              ("wc_quiet", quiet_batches)):
            g, src, sink = wordcount.build_graph(WC_KEYS)
            oracle = DirtyScheduler(g, CpuExecutor())
            for b in batches:
                oracle.push(src, b)
                oracle.tick()
            sched, _src, tsink = wc[name]
            got = {kv: w for kv, w in sched.view(tsink.name).items() if w}
            want = {kv: w for kv, w in oracle.view(sink.name).items() if w}
            if got != want:
                raise AssertionError(f"{name}: the view != the CPU oracle's "
                                     f"({len(got)} vs {len(want)} rows)")
        control = {k: reg.value(f"control.{k}", 0)
                   for k in ("respawns", "scale_ups", "scale_downs",
                             "brownout_steps", "brownouts_exited")}
        summary = summarize_tier(tier).to_dict()
    finally:
        if cp is not None:
            cp.stop()
        prod.close()
        rpc.close()
        ship.close()
        rsrv.close()
        tier.close()
        replica.close()
        gc.unfreeze()

    # the launches by path, against the prediction and the global counts
    paths = {p: tuple(tally[p]) for p in ("tier", "tier_replica", "twin")}
    want = tier_want(cfg)
    for p, got in paths.items():
        if got != want:
            raise AssertionError(f"top-k launches on the {p} path {got}, "
                                 f"predicted {want}")
    total = tuple(map(sum, zip(*paths.values())))
    if total != launches:
        raise AssertionError(f"top-k launches {launches} != the paths' "
                             f"{paths}")
    phase_s = time.perf_counter() - t_phase

    def ms(xs):
        return [round(x * 1e3, 2) for x in xs]

    rpc_rows = [r for r in rows
                if r["how"] == "rpc" and r["kind"] == "insert"]
    local_rows = [r for r in rows if r["how"] == "local"
                  and r["kind"] == "insert"]
    dedup = [r for r in rows if r["how"] == "dedup"][0]
    rpc_s = [r["s"] for r in rows if r["how"] == "rpc"]
    ins_lag = [r["lag_s"] for r in rows if r["kind"] == "insert"
               and r["how"] != "dedup"]
    log(f"[tier] ServeTier(pump_threads=2) on {card}: knn (config 4 at full "
        f"width, DurableScheduler(fsync='tick', committer='thread'), "
        f"window depth 2), pagerank (config 3, fused loop), wc_hot and "
        f"wc_quiet (word-count, {WC_WORDS} words) under a ControlPlane; a "
        f"follower over TCP (SegmentShipper -> RemoteFollower -> "
        f"ReplicaServer -> ReplicaScheduler on its own cuda executor); "
        f"{len(rows)} k-NN ticks equal to the twin and {follower_checks} "
        f"follower horizons equal to the leader, bit for bit [{fs}]")
    log(f"[tier] RPC submit -> APPLIED over TCP (k-NN, {cfg['per_tick']} "
        f"int8 docs an insert): p50 {_pct(rpc_s, 0.5) * 1e3:.3f} ms p95 "
        f"{_pct(rpc_s, 0.95) * 1e3:.3f} ms of {ms(rpc_s)} (inserts "
        f"{ms([r['s'] for r in rpc_rows])}); in-process submit on the same "
        f"tenant: p50 {_pct([r['s'] for r in local_rows], 0.5) * 1e3:.3f} "
        f"ms p95 {_pct([r['s'] for r in local_rows], 0.95) * 1e3:.3f} ms "
        f"of {ms([r['s'] for r in local_rows])} [{card}]")
    log(f"[tier] reset mid-submit: {dedup['id']}'s ack lost on the link "
        f"(FaultyTransport, drop_s2c), the producer re-dialed "
        f"({prod.reconnects_total} reconnects, {prod.link_failures} link "
        f"failures), hello reported it admitted, the resubmit resolved "
        f"{dedup['status']} in {dedup['s'] * 1e3:.1f} ms, folded once "
        f"(the table == the twin's) [{card}]")
    log(f"[tier] MB over the wire (frames written, both ends, RPC and "
        f"shipping): {meter.sent / 1e6:.1f}; shipped "
        f"{ship.bytes_total / 1e6:.1f} MB of log in {ship.shipments} "
        f"shipments, {ship.nacks} NACKs, "
        f"{ship.retransmit_bytes / 1e6:.1f} MB re-offered; the follower's "
        f"link: {link.reconnects_total} reconnects, {link.link_failures} "
        f"failures; the replica's order and CRC rejects "
        f"{replica.order_rejects}, {replica.crc_rejects} [{card}]")
    log(f"[tier] ship lag over TCP, ms from the ack to the follower's "
        f"horizon: insert ticks median {_median(ins_lag) * 1e3:.3f} of "
        f"{ms(ins_lag)}; preload ticks "
        f"({cfg['preload_chunk'] * cfg['dim'] / 1e6:.1f} MB of docs a "
        f"record) "
        f"{ms([r['lag_s'] for r in rows if r['kind'] == 'preload'])} "
        f"[{card}] [{fs}]")
    log(f"[tier] pagerank in the tier: the initial batches and "
        f"{TIER_PR_CHURN} churn ticks, s from submit to applied "
        f"{[round(x, 3) for x in pr_ticks]}; relative error "
        f"{pr_err['rel_err']:.3g} (bound {PAGERANK_MAX_REL_ERR}) [{card}]")
    for name in ("knn", "pagerank", "wc_hot", "wc_quiet"):
        g = summary["per_graph"][name]
        log(f"[tier] summarize_tier {name}: rows applied "
            f"{g['rows_applied']}, windows {g['windows']}, sched delay p50 "
            f"{g['sched_delay_p50_s'] * 1e3:.3f} ms p99 "
            f"{g['sched_delay_p99_s'] * 1e3:.3f} ms, admission p99 "
            f"{g['admission_p99_s'] * 1e3:.3f} ms, state {g['state']}, "
            f"crashes {g['crashes']}, revives {g['revives']}, device "
            f"{g['device']} [{card}]")
    log(f"[tier] pool: pump_utilization {summary['pump_utilization']:.4f}, "
        f"windows {summary['windows']}, pool crashes "
        f"{summary['pool_crashes']}, device collisions "
        f"{summary['device_collisions']}, live workers "
        f"{summary['live_workers']}, worker deaths "
        f"{summary['worker_deaths']}, respawns "
        f"{summary['worker_respawns']} [{card}]")

    def timeline(acts):
        return [(a["kind"], a.get("graph"),
                 int(round((a["now"] - cp_t0) / kn["interval_s"])))
                for a in acts if a["kind"] != "wal_compact"]

    log(f"[tier] control: surge of {kn['hammers']} hammers on wc_hot "
        f"{surge_s:.2f} s ({kn['quiet_batches']} wc_quiet batches, "
        f"admission p99 {quiet_p99 * 1e3:.3f} ms, bound "
        f"{kn['quiet_p99_bound_s'] * 1e3:.0f} ms); wc_hot peak level "
        f"{hot_peak}, wc_quiet {quiet_peak}; recovered in {recovery} "
        f"intervals (bound {bound}); hot tickets {dict(statuses)} "
        f"[{card}]")
    log(f"[tier] control timeline (kind, graph, interval): "
        f"{timeline(surge_actions)}")
    log(f"[tier] crash storm (pool_window@wc_hot): breaker open after "
        f"{open_s * 1e3:.1f} ms ({storm.crashes} crashes), closed "
        f"{heal_s * 1e3:.1f} ms after the storm ended; transitions "
        f"{breaker}; then: {timeline(actions[len(surge_actions):])}; "
        f"control counters {control}; both word-count tenants == the CPU "
        f"oracle [{card}]")
    log(f"[tier] (topk, topk_merge, scan_score) launches by path: "
        f"{paths} (predicted "
        f"{want} each); k-NN leg {knn_s:.1f} s; phase {phase_s:.1f} s "
        f"[{card}]")
    return {"tier": paths["tier"], "tier_replica": paths["tier_replica"],
            "twin": paths["twin"], "lag_ms": _median(ins_lag) * 1e3}


def phase_tier(card: str) -> Dict[str, object]:
    """The serving tier and the wire (``tier_knn``) under a temp dir; the
    top-k counts are zeroed just before its path."""
    tmp = tempfile.mkdtemp()
    try:
        fs = fs_line(tmp)
        log(f"[tier] WAL and the follower's mirror under a temp dir: {fs}")
        return tier_knn(card, fs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 16: fleet telemetry, subscriptions, the multi-process harness ---

#: (topk, topk_merge, scan_score) launches predicted for each of phase
#: 16's k-NN paths (the leader's pump, the follower's replay): the
#: queries, the retraction and the query update rescan (one score and one
#: merge a corpus chunk), the 15 preload ticks and the 5 insert ticks run
#: one top-k each
SUBS_WANT = (15 + 5, 3 * (FULL["D"] // FULL["scan_chunk"]),
             3 * (FULL["D"] // FULL["scan_chunk"]))
#: the insert ticks during which the view subscriber's link is partitioned
#: (it heals after the second one's ack)
SUBS_PARTITION = (1, 2)
#: a wait on the follower, a subscriber or a ticket longer than this fails
SUBS_WAIT_S = 120.0
#: leg B: bench.py's multi-process numbers (``run_multiproc_bench``): 3
#: replica children, 4 producers, 1.5 s a phase
PROC = dict(replicas=3, producers=4, run_s=1.5)
#: a wait on a child, the barrier or the promotion longer than this fails
PROC_WAIT_S = 60.0


class _Tail:
    """One wire ``Subscriber`` pumped by a thread of its own, noting the
    host time its local horizon first reached each value and the answer
    it held there (read on that thread: the subscriber's lock is the
    pump's, and a reader from another thread would starve behind it)."""

    def __init__(self, sub):
        self.sub = sub
        self.reached: Dict[int, float] = {}
        self.values: Dict[int, object] = {}
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name=f"tail-{sub.name}")
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                self.sub.pump(wait_s=0.05)
                h = self.sub.horizon
                if h not in self.reached:
                    self.values[h] = self.sub.value()
                    self.reached[h] = time.perf_counter()
        except BaseException as e:  # noqa: BLE001 - raised by wait()
            self.error = e

    def wait(self, tick: int, since: float) -> float:
        """Seconds from ``since`` until the horizon reached ``tick``."""
        while True:
            if self.error is not None:
                raise AssertionError(f"{self.sub.name} failed") \
                    from self.error
            hit = [t for h, t in list(self.reached.items()) if h >= tick]
            if hit:
                return min(hit) - since
            if time.perf_counter() - since > SUBS_WAIT_S:
                raise AssertionError(
                    f"{self.sub.name} at horizon {self.sub.horizon}, the "
                    f"leader at tick {tick}")
            time.sleep(0.0002)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=SUBS_WAIT_S)
        self.sub.close()


def _holds_tensor(obj) -> bool:
    """Whether a (nested) tuple holds a torch tensor."""
    return isinstance(obj, torch.Tensor) or (
        isinstance(obj, tuple) and any(map(_holds_tensor, obj)))


def fleet_subs(card: str, fs: str, tmp: str,
               cfg: Dict[str, int] = FULL) -> Dict[str, object]:
    """Leg A: config 4's k-NN leader on the card behind ``RpcIngestServer``
    over TCP, its log shipped over TCP to a follower on its own ``cuda``
    executor, a ``SubscriptionHub`` on the follower behind a
    ``SubscriptionServer``, three wire subscribers (one partitioned and
    healed mid-run), the sampled writes traced end to end, and both nodes'
    registries shipped to a ``FleetAggregator``."""
    from reflow_tpu_torch import obs
    from reflow_tpu_torch.net import (FaultyTransport, RemoteFollower,
                                      ReplicaServer, TcpTransport)
    from reflow_tpu_torch.obs import trace as trace_mod
    from reflow_tpu_torch.obs.export import FULL_CHAIN, full_chains
    from reflow_tpu_torch.obs.fleet import FleetAggregator, TelemetryShipper
    from reflow_tpu_torch.obs.wire import TelemetryServer
    from reflow_tpu_torch.serve import RemoteProducer, RpcIngestServer
    from reflow_tpu_torch.subs import (Subscriber, SubscriptionHub,
                                       SubscriptionServer)
    from reflow_tpu_torch.subs.query import query_value
    from reflow_tpu_torch.utils.faults import WireFaults

    t_phase = time.perf_counter()
    chunks = cfg["D"] // cfg["scan_chunk"]
    feed = _knn_feed(cfg, seed=16)
    head = feed[:1 + cfg["preload_chunks"]]
    tail = feed[1 + cfg["preload_chunks"]:]
    kd, kr = _knn_graph(cfg, sink=True), _knn_graph(cfg, sink=True)
    leader = DurableScheduler(kd.graph, get_executor("cuda"),
                              wal_dir=os.path.join(tmp, "subs-wal"),
                              fsync="tick", committer="thread")
    replica = ReplicaScheduler(kr.graph, os.path.join(tmp, "subs-f0"),
                               executor=get_executor("cuda"), name="f0")
    tally: Dict[str, List[int]] = {}
    lock = threading.Lock()
    _count_path(leader.executor, "subs_leader", tally, lock)
    _count_path(replica.sched.executor, "subs_replica", tally, lock)
    fe = _knn_frontend(leader, cfg)
    meter, tele_meter = _Meter(), _Meter()
    tcp = meter.wrap(TcpTransport())
    rsrv = ReplicaServer(replica, tcp).start()
    ship = SegmentShipper(leader.wal, leader_tick=lambda: leader._tick)
    link = RemoteFollower(tcp, rsrv.address, name="f0", io_timeout_s=60.0)
    ship.attach(link)
    ship.start()
    hub = SubscriptionHub(replica, name="f0")
    replica.attach_hub(hub)
    ssrv = SubscriptionServer(hub, tcp).start()
    rpc = RpcIngestServer(fe, tcp).start()
    prod = RemoteProducer(tcp, rpc.address, name="p-knn", io_timeout_s=60.0)
    # the fleet: each node's own registry, shipped by its own shipper
    regs = {"leader": obs.MetricsRegistry(), "f0": obs.MetricsRegistry()}
    fe.publish_metrics(regs["leader"])
    leader.wal.publish_metrics(regs["leader"])
    ship.publish_metrics(regs["leader"])
    replica.publish_metrics(regs["f0"])
    hub.publish_metrics(regs["f0"])
    agg = FleetAggregator()
    tsrv = TelemetryServer(agg, TcpTransport(), node="aggregator").start()
    shippers = [TelemetryShipper(reg, tele_meter.wrap(TcpTransport()),
                                 tsrv.address, node=node).start()
                for node, reg in regs.items()]
    faults = WireFaults(seed=16)
    sample_every = trace_mod.SAMPLE_EVERY
    tails: List[_Tail] = []
    rows: List[Dict[str, object]] = []
    checks = 0

    def check_follower(tick: int, t_ack: float) -> Dict[str, object]:
        while replica.published_horizon() < tick:
            if time.perf_counter() - t_ack > SUBS_WAIT_S:
                raise AssertionError(
                    f"the follower at {replica.published_horizon()}, the "
                    f"leader at tick {tick}")
            time.sleep(0.0002)
        lag = time.perf_counter() - t_ack
        view = {kv: w for kv, w in leader.view("nn").items() if w}
        with replica._lock:
            got = replica.sched.read_table(kr.index)
        h, fview = replica.view_at("nn")
        bad = _table_diff(got, leader.read_table(kd.index))
        if bad or h != tick or fview != view:
            raise AssertionError(
                f"the follower at horizon {h} unlike the leader at tick "
                f"{tick} (queries {bad[:8]}, views equal {fview == view})")
        return {"lag_s": lag, "view": view}

    def check_subs(tick: int, t_ack: float, view: Dict,
                   skip=()) -> Dict[str, float]:
        nonlocal checks
        fresh = {}
        for t in tails:
            if t.sub.name in skip:
                continue
            fresh[t.sub.name] = t.wait(tick, t_ack)
            if t.values.get(tick) != query_value(t.sub.query, view):
                raise AssertionError(
                    f"{t.sub.name} at horizon {tick}: its "
                    f"{t.sub.query.kind} != the leader's")
            checks += 1
        return fresh

    def rpc_step(item, skip=()):
        bid, src, batch, kind = item
        l0 = _launches()
        t0 = time.perf_counter()
        ticket = prod.submit("queries" if src == "q" else "docs", batch,
                             batch_id=bid)
        res = ticket.result(timeout=SUBS_WAIT_S)
        t_ack = time.perf_counter()
        if res.status != APPLIED:
            raise AssertionError(f"{bid}: {res}")
        tick = leader._tick
        fol = check_follower(tick, t_ack)
        fresh = check_subs(tick, t_ack, fol["view"], skip) if tails else {}
        torch.cuda.synchronize()
        d = _since(l0)
        want = tuple(2 * x for x in _want_launches(kind, chunks))
        if d != want:
            raise AssertionError(f"{bid}: leader and follower launched {d},"
                                 f" predicted {want}")
        rows.append({"id": bid, "kind": kind, "tick": tick,
                     "s": t_ack - t0, "lag_s": fol["lag_s"],
                     "fresh": fresh})
        return tick, t_ack, fol["view"]

    try:
        # the heap the phases before left stays out of full collections
        gc.collect()
        gc.freeze()
        zero_launches(by_thread=True)
        t_leg = time.perf_counter()
        for item in head:
            tick, _t, view = rpc_step(item)
        # the subscribers, after the preload: a view of nn, its top 16
        # (by weight: nn's values are (id, score) pairs, which a rank by
        # value cannot negate; every live row weighs 1, so the rank is
        # the tie-break on the pair's string form), and one (query, row)
        # pair of the view
        pair = sorted(view, key=str)[0]
        part_tcp = FaultyTransport(tcp, faults)
        for name, tr, kind, params in (
                ("sub-view", part_tcp, "view", ()),
                ("sub-topk", tcp, "topk", (cfg["k"], "weight")),
                ("sub-lookup", tcp, "lookup", (pair,))):
            tails.append(_Tail(Subscriber(tr, ssrv.address, "nn",
                                          kind=kind, params=params,
                                          name=name)))
        seed_fresh = check_subs(tick, time.perf_counter(), view)
        # the traced leg: every write sampled
        trace_mod.SAMPLE_EVERY = 1
        trace_mod.reset()
        obs.enable()
        heal = None
        for i, item in enumerate(tail):
            parted = item[3] == "insert" and i in SUBS_PARTITION
            if parted and i == SUBS_PARTITION[0]:
                faults.partition()
            tick, t_ack, view = rpc_step(
                item, skip=("sub-view",) if parted else ())
            if parted and i == SUBS_PARTITION[-1]:
                t_heal = time.perf_counter()
                faults.heal()
                heal = tails[0].wait(tick, t_heal)
                check_subs(tick, t_ack, view)
        leg_s = time.perf_counter() - t_leg
        obs.disable()
        launches = _launches()
        # the kernel's answer itself: the follower (equal to the leader and
        # the subscribers' source) against plain top-k over its own tables
        with replica._lock:
            brute = check_brute_force(
                "the follower's table", replica.sched.executor.states[
                    kr.index.id], replica.sched.read_table(kr.index),
                cfg["Q"], cfg["k"])
        trace_path = obs.export_chrome_trace(os.path.join(tmp, "trace.json"))
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        chains = full_chains(events)
        if not chains:
            raise AssertionError(f"no sampled write carries {FULL_CHAIN}")
        for t in tails:
            s = t.sub
            if s.gaps_total or s.dups_skipped_total:
                raise AssertionError(
                    f"{s.name}: {s.gaps_total} gaps, "
                    f"{s.dups_skipped_total} duplicate applies")
        if tails[0].sub.mode != "resume" or tails[0].sub.rebases_total != 1:
            raise AssertionError(
                f"the healed subscriber came back as {tails[0].sub.mode} "
                f"with {tails[0].sub.rebases_total} rebases")
        mirror = hub._mirrors.get("nn")
        if mirror is None or _holds_tensor(tuple(mirror.view)):
            raise AssertionError("the hub's mirror holds a device tensor "
                                 "(or no mirror of nn)")
        time.sleep(2 * shippers[0].interval_s)
        fleet = agg.fleet_snapshot()
        if not {"leader", "f0"} <= set(fleet["nodes"]) \
                or fleet["gauges"]["nodes_stale"]:
            raise AssertionError(f"the fleet snapshot: nodes "
                                 f"{sorted(fleet['nodes'])}, stale "
                                 f"{fleet['gauges']['nodes_stale']}")
        subs_stats = [(t.sub.name, t.sub.frames_applied_total,
                       t.sub.rebases_total, t.sub.reconnects_total,
                       t.sub.link_failures) for t in tails]
        hub_stats = (hub.frames_total, hub.conflations_total,
                     hub.sheds_total, hub.rebases_total,
                     hub.freshness_pct(0.5), hub.freshness_pct(0.99))
    finally:
        obs.disable()
        trace_mod.SAMPLE_EVERY = sample_every
        for t in tails:
            t.close()
        for s in shippers:
            s.close()
        tsrv.close()
        agg.close()
        prod.close()
        rpc.close()
        ssrv.close()
        hub.close()
        ship.close()
        rsrv.close()
        fe.close()
        replica.close()
        gc.unfreeze()

    paths = {p: tuple(tally[p]) for p in ("subs_leader", "subs_replica")}
    for p, got in paths.items():
        if got != SUBS_WANT:
            raise AssertionError(f"top-k launches on the {p} path {got}, "
                                 f"predicted {SUBS_WANT}")
    if tuple(map(sum, zip(*paths.values()))) != launches:
        raise AssertionError(f"top-k launches {launches} != the paths' "
                             f"{paths}")

    def ms(xs):
        return [round(x * 1e3, 2) for x in xs]

    ins = [r for r in rows if r["kind"] == "insert"]
    fresh = [v for r in ins for v in r["fresh"].values()]
    log(f"[fleet] leg A on {card}: config 4's k-NN leader "
        f"(DurableScheduler(fsync='tick', committer='thread'), window depth "
        f"2) behind RpcIngestServer over TCP, shipped over TCP to a "
        f"follower on its own cuda executor, SubscriptionHub + "
        f"SubscriptionServer on the follower, 3 wire subscribers; "
        f"{len(rows)} RPC writes, the follower equal to the leader at each, "
        f"{checks} subscriber horizons equal to query_value over the "
        f"leader's view, bit for bit; the follower's table vs brute force "
        f"over its tables: recall {brute[0]:.6f}, score max_abs_diff "
        f"{brute[1]:.6g} [{fs}]")
    log(f"[fleet] subscription freshness, ms from the leader's ack to the "
        f"subscriber's horizon (insert ticks, every unpartitioned "
        f"subscriber): p50 {_pct(fresh, 0.5) * 1e3:.3f} p95 "
        f"{_pct(fresh, 0.95) * 1e3:.3f} of {ms(fresh)}; the follower's "
        f"lag, insert ticks: {ms([r['lag_s'] for r in ins])}; first "
        f"snapshot after the preload {ms(seed_fresh.values())} [{card}]")
    log(f"[fleet] subscribers (name, frames applied, rebases, reconnects, "
        f"link failures): {subs_stats}; 0 gaps, 0 duplicate applies; the "
        f"hub: frames {hub_stats[0]}, conflations {hub_stats[1]}, sheds "
        f"{hub_stats[2]}, rebases {hub_stats[3]} [{card}]")
    log(f"[fleet] partition of sub-view's link over insert ticks "
        f"{list(SUBS_PARTITION)}: the heal's ms to resume (to the leader's "
        f"tick, reconnect backoff included) {heal * 1e3:.1f}, mode "
        f"'resume' [{card}]")
    log(f"[fleet] hub fan-out ms a window (window hand-off -> frame emit, "
        f"the hub's reservoir): p50 {hub_stats[4] * 1e3:.3f} p99 "
        f"{hub_stats[5] * 1e3:.3f} [{card}]")
    log(f"[fleet] RPC submit -> APPLIED ms: preload "
        f"{ms([r['s'] for r in rows if r['kind'] == 'preload'])}; inserts "
        f"{ms([r['s'] for r in ins])}; MB over the wire (RPC, shipping, "
        f"subscriptions) {meter.sent / 1e6:.1f}; telemetry bytes "
        f"{tele_meter.sent} ({sum(s.shipped for s in shippers)} snapshots "
        f"shipped, {sum(s.dropped for s in shippers)} dropped) [{card}]")
    log(f"[fleet] trace: {len(chains)} sampled writes carry the full chain "
        f"{'->'.join(FULL_CHAIN)} (obs.export.full_chains over the exported "
        f"Chrome trace, {len(events)} events); fleet snapshot: nodes "
        f"{sorted(fleet['nodes'])}, stale {fleet['gauges']['nodes_stale']},"
        f" lag spread {fleet['gauges']['lag_spread']}, subs active "
        f"{fleet['gauges']['subs_active']} [{card}]")
    log(f"[fleet] (topk, topk_merge, scan_score) launches by path: "
        f"{paths} (predicted "
        f"{SUBS_WANT} each); leg A {leg_s:.1f} s, with set-up "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return dict(paths)


def fleet_proc(card: str, tmp: str, n_replicas: int = PROC["replicas"],
               n_prod: int = PROC["producers"],
               run_s: float = PROC["run_s"]) -> Dict[str, object]:
    """Leg B, on the host: a ``ProcHarness`` fleet of a leader, replica
    and paced producer children (``python -m reflow_tpu_torch.proc``,
    word-count on the CPU oracle, no card visible); every replica killed
    -9, respawned and rejoined through the barrier; the leader killed -9
    and a replica promoted across the process boundary; no acked write
    lost, the survivors equal at equal horizons."""
    from reflow_tpu_torch.net import TcpTransport
    from reflow_tpu_torch.proc import ProcHarness
    from reflow_tpu_torch.proc.harness import ControlClient
    from reflow_tpu_torch.proc.worker import producer_batch_words
    from reflow_tpu_torch.serve import RemoteProducer

    t_leg = time.perf_counter()
    n_procs = 1 + n_replicas + n_prod
    pace_s = 0.02 if (os.cpu_count() or 1) < n_procs else 0.0
    h = ProcHarness(os.path.join(tmp, "proc"),
                    child_env={"CUDA_VISIBLE_DEVICES": ""})
    spawn_s: Dict[str, float] = {}

    def spawn(name, fn, *a, **kw):
        t0 = time.perf_counter()
        fn(*a, **kw)
        spawn_s[name] = time.perf_counter() - t0

    probe = None
    try:
        spawn("leader", h.spawn_leader, fsync="tick", epoch=0)
        rnames = [f"r{i}" for i in range(n_replicas)]
        for nm in rnames:
            spawn(nm, h.spawn_replica, nm)
        h.attach_replicas()
        for i in range(n_prod):
            spawn(f"p{i}", h.spawn_producer, f"p{i}", index=i,
                  pace_s=pace_s)
        if not h.aggregator.await_nodes(n_procs, timeout_s=PROC_WAIT_S):
            raise AssertionError(f"the aggregator saw "
                                 f"{h.aggregator.node_count()} nodes")
        time.sleep(run_s)

        # kill -9 every replica, then respawn them and rejoin the cut
        for nm in rnames:
            h.kill9(nm)
        t_re = time.perf_counter()
        for nm in rnames:
            spawn(f"{nm}'", h.respawn, nm)
        h.attach_replicas(rnames)
        cut = h.barrier(timeout_s=PROC_WAIT_S)
        rejoin_s = time.perf_counter() - t_re
        time.sleep(run_s / 2)

        # kill -9 the leader: promotion across the process boundary
        coord = h.coordinator(epoch=0, confirm_intervals=2,
                              drain_timeout_s=10.0)
        h.kill9("leader")
        t_kill = time.perf_counter()
        promoted, now = None, 0.0
        while promoted is None:
            for e in coord.step(now):
                if e.get("kind") == "failover_promote":
                    promoted = e
            if time.perf_counter() - t_kill > PROC_WAIT_S:
                raise AssertionError("the leader's death never promoted")
            now += 1.0
            time.sleep(0.02)
        promote_s = time.perf_counter() - t_kill
        if promoted["winner"] not in rnames or promoted["epoch"] != 1 \
                or h.leader_name != promoted["winner"]:
            raise AssertionError(f"promotion {promoted}")
        probe = RemoteProducer(TcpTransport(), h.ingest_address,
                               name="probe")
        res = probe.submit("words", wordcount.ingest_lines(
            [" ".join(producer_batch_words(n_prod, 0))]),
            batch_id="probe-0").result(timeout=PROC_WAIT_S)
        first_ack_s = time.perf_counter() - t_kill
        if res.status != APPLIED:
            raise AssertionError(f"the probe write on the promoted leader: "
                                 f"{res}")
        time.sleep(run_s)

        exits = []
        for i in range(n_prod):
            st = h.child(f"p{i}").stop()
            if st is None or not st.get("ok") or st["in_doubt"]:
                raise AssertionError(f"producer p{i} exited {st!r}")
            exits.append(st)
        reconnects = sum(s["reconnects"] for s in exits)
        resubmits = sum(s["resubmits"] for s in exits)
        if reconnects < n_prod or resubmits < 1:
            raise AssertionError(f"the leader's kill forced {reconnects} "
                                 f"reconnects, {resubmits} resubmits")
        g, src, sink = wordcount.build_graph()
        ingest = ControlClient(h.ingest_address, io_timeout_s=30.0)
        ingest.call("flush", 20.0)
        _ok, leader_tick, leader_view = ingest.call("view", sink.name)
        oracle = DirtyScheduler(g)
        acked = [(i, seq) for i, st in enumerate(exits)
                 for seq, _status in st["acked"]] + [(n_prod, 0)]
        for i, seq in acked:
            oracle.push(src, wordcount.ingest_lines(
                [" ".join(producer_batch_words(i, seq))]),
                batch_id=f"p{i}-{seq}")
        oracle.tick()
        want = {kv: w for kv, w in oracle.view(sink.name).items() if w}
        got = {kv: w for kv, w in leader_view.items() if w}
        if got != want:
            raise AssertionError(f"acked writes lost or doubled: "
                                 f"{len(got)} rows, {len(want)} expected")
        survivors = [nm for nm in rnames if nm != h.leader_name]
        h.barrier(names=survivors, min_horizon=leader_tick,
                  timeout_s=PROC_WAIT_S)
        for nm in survivors:
            _ok, rh, rv = h.control(nm).call("view", sink.name)
            if rh != leader_tick or {kv: w for kv, w in rv.items()
                                     if w} != got:
                raise AssertionError(f"{nm} at horizon {rh} unlike the "
                                     f"new leader at {leader_tick}")
        nodes = set(h.aggregator.fleet_snapshot()["nodes"])
        if not {"leader", *rnames, *(f"p{i}" for i in range(n_prod))} \
                <= nodes:
            raise AssertionError(f"the fleet snapshot's nodes {nodes}")
    finally:
        if probe is not None:
            probe.close()
        h.close()
    leg_s = time.perf_counter() - t_leg
    log(f"[fleet] leg B on the host: ProcHarness, a leader, {n_replicas} "
        f"replica and {n_prod} producer children (python -m "
        f"reflow_tpu_torch.proc, word-count on the CPU oracle, "
        f"CUDA_VISIBLE_DEVICES empty), producer pace {pace_s} s, phases of "
        f"{run_s} s; {os.cpu_count()} host cores")
    log(f"[fleet] spawn ms a child (to its ready line): "
        + ", ".join(f"{k} {v * 1e3:.0f}" for k, v in spawn_s.items()))
    log(f"[fleet] kill -9 of every replica: respawn -> barrier "
        f"{rejoin_s * 1e3:.0f} ms (the cut {cut}); the leader's kill -> "
        f"promotion {promote_s * 1e3:.0f} ms (winner {promoted['winner']}, "
        f"epoch {promoted['epoch']}), -> the first acked write on the "
        f"promoted leader {first_ack_s * 1e3:.0f} ms")
    log(f"[fleet] acked writes {len(acked)} (the probe's included), none "
        f"lost (the new leader's view == the fold of every acked batch), "
        f"{len(survivors)} survivors equal at horizon {leader_tick}; "
        f"producers: {reconnects} reconnects, {resubmits} resubmits, "
        f"{sum(s['deduped'] for s in exits)} deduped, in doubt 0; fleet "
        f"nodes {len(nodes)}; leg B {leg_s:.1f} s")
    return {"acked": len(acked), "leg_s": leg_s}


def phase_fleet(card: str) -> Dict[str, object]:
    """Fleet telemetry, standing-query subscriptions (leg A, on the card;
    the top-k counts are zeroed just before its path) and the
    multi-process harness (leg B, on the host), under a temp dir."""
    tmp = tempfile.mkdtemp()
    try:
        fs = fs_line(tmp)
        log(f"[fleet] WAL, mirrors and children's state under a temp dir: "
            f"{fs}")
        subs = fleet_subs(card, fs, tmp)
        fleet_proc(card, tmp)
        return subs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 17: the lockcheck leg ----------------------------------------------

#: phases 13-15's k-NN paths at config 4's full width, the preload cut
#: from 15 chunks to 2 (the inserts, retractions and query updates kept)
LOCKCHECK = dict(FULL, preload_chunks=2)
#: the same leg at a few ticks and small widths, on the CPU
#: (``tests/test_torch_lint.py``); 8 KB log segments give the
#: replication path's compaction sealed segments to fold
LOCKCHECK_CPU = dict(Q=16, D=2048, dim=32, k=4, scan_chunk=512,
                     per_tick=128, preload_chunk=256, preload_chunks=2,
                     insert_ticks=5, retract=64, query_update=4,
                     segment_bytes=8 << 10)
LOCKCHECK_CPU_PAGERANK = dict(n_nodes=2000, n_edges=20_000, churn=0.01,
                              tol=1e-4, seed=7)
#: the child's whole run, build and imports included, may take this long
LOCKCHECK_TIMEOUT_S = 600
#: a lock of each of these families must be on an edge the monitor saw,
#: or the leg held nothing that matters against the monitor
LOCKCHECK_FAMILIES = ("serve.tier", "wal.", "serve.frontend.")


def lockcheck_leg(card: str) -> Dict[str, object]:
    """The tier (phase 15), the durable path (phase 13's k-NN leg) and the
    failover (phase 14) in a process whose locks report to the runtime
    lock-order monitor. Runs in the child that ``phase_lockcheck`` starts
    with ``REFLOW_LOCKCHECK=1`` in its environment, set before the port
    was imported (module-level locks read it at import). Returns the
    monitor's edges, the ``LockOrderError``s raised on any thread (a
    swallowed one counts), ``cycles_checked``, the seconds and the top-k
    launches of the leg's own paths (the twins' left out). On the card
    unless ``DEVICE`` names another device."""
    from reflow_tpu_torch.utils.runtime import (LOCK_MONITOR, LockOrderError,
                                                NamedLock, lockcheck_enabled)

    if not (lockcheck_enabled()
            and isinstance(topk_mod._TALLY_LOCK, NamedLock)):
        raise AssertionError("the lockcheck child's locks are not wrapped: "
                             "REFLOW_LOCKCHECK=1 must be set before the "
                             "port is imported")
    raised: List[str] = []
    real = LOCK_MONITOR.on_acquire

    def on_acquire(lock):
        try:
            return real(lock)
        except LockOrderError as e:
            raised.append(str(e))
            raise

    LOCK_MONITOR.on_acquire = on_acquire
    if _on_card():
        cfg, pr_cfg = LOCKCHECK, PAGERANK
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        cfg, pr_cfg = LOCKCHECK_CPU, LOCKCHECK_CPU_PAGERANK
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        fs = fs_line(tmp)
        dirs = {}
        for leg in ("durable", "replica", "tier"):
            dirs[leg] = os.path.join(tmp, leg)
            os.mkdir(dirs[leg])
        zero_launches()
        dur = durable_knn(card, fs, dirs["durable"], cfg)
        rep = replicate_knn(card, fs, dirs["replica"], cfg)
        tier = tier_knn(card, fs, dirs["tier"], cfg, pr_cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    own = [dur["launches"], rep["leader"], rep["replica"], tier["tier"],
           tier["tier_replica"]]
    return {"edges": {a: sorted(b) for a, b in
                      sorted(LOCK_MONITOR.edges().items())},
            "lock_order_errors": raised,
            "cycles_checked": LOCK_MONITOR.cycles_checked,
            "seconds": time.perf_counter() - t0,
            "launches": [sum(x) for x in zip(*own)]}


def lockcheck_child(argv: List[str]) -> int:
    """``chip_smoke.py --lockcheck-child OUT [--device cpu]``: run
    ``lockcheck_leg`` and write its result to OUT as JSON."""
    global DEVICE, LOG_PREFIX
    out = argv[0]
    if "--device" in argv:
        DEVICE = argv[argv.index("--device") + 1]
    LOG_PREFIX = "[lockcheck] "
    card = card_line() if _on_card() else f"{DEVICE} (no card)"
    res = lockcheck_leg(card)
    with open(out, "w") as f:
        json.dump(res, f)
    return 1 if res["lock_order_errors"] else 0


def _static_match(name: str, nodes: Set[str]) -> Set[str]:
    """The static graph's nodes a runtime lock name falls under: itself,
    or a dynamic family ``prefix*`` it extends."""
    return {n for n in nodes if n == name
            or (n.endswith("*") and name.startswith(n[:-1]))}


def lockcheck_unseen(runtime: Dict[str, List[str]],
                     static: Dict[str, Set[str]]) -> List[tuple]:
    """The runtime held-before edges the static lock graph lacks: the
    orders the AST cannot see (callbacks, calls across modules)."""
    nodes = set(static) | {b for tos in static.values() for b in tos}
    unseen = []
    for a, tos in sorted(runtime.items()):
        for b in tos:
            if not any(bb in static.get(aa, ())
                       for aa in _static_match(a, nodes)
                       for bb in _static_match(b, nodes)):
                unseen.append((a, b))
    return unseen


def phase_lockcheck(card: str) -> Dict[str, object]:
    """The lockcheck leg: ``lockcheck_leg`` in a child process started with
    ``REFLOW_LOCKCHECK=1``; fails unless the child exits 0, no acquisition
    raised ``LockOrderError``, and the monitor saw an edge of every family
    in ``LOCKCHECK_FAMILIES``. Prints the edges, the ones the static lock
    graph lacks, ``cycles_checked`` and the seconds."""
    from reflow_tpu_torch.analysis import Corpus
    from reflow_tpu_torch.analysis.locks import static_lock_edges

    tmp = tempfile.mkdtemp()
    try:
        out = os.path.join(tmp, "lockcheck.json")
        env = dict(os.environ)
        env["REFLOW_LOCKCHECK"] = "1"
        log("[lockcheck] phases 13-15's k-NN paths (config 4 at full width, "
            "the preload cut to 2 chunks), the tier's PageRank and word-count "
            "tenants, in a child process with REFLOW_LOCKCHECK=1")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--lockcheck-child",
             out], env=env, timeout=LOCKCHECK_TIMEOUT_S)
        secs = time.perf_counter() - t0
        res = json.load(open(out)) if os.path.exists(out) else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode != 0 or res is None or res["lock_order_errors"]:
        raise AssertionError(
            f"the lockcheck child exited {proc.returncode}; lock-order "
            f"errors: {res and res['lock_order_errors']}")
    edges = res["edges"]
    missing = [fam for fam in LOCKCHECK_FAMILIES
               if not any(a.startswith(fam) or any(b.startswith(fam)
                                                   for b in tos)
                          for a, tos in edges.items())]
    if missing:
        raise AssertionError(f"no monitored edge involves a {missing} lock: "
                             f"{edges}")
    root = os.path.dirname(os.path.abspath(__file__))
    unseen = lockcheck_unseen(edges, static_lock_edges(Corpus(root)))
    n = sum(len(tos) for tos in edges.values())
    log(f"[lockcheck] held-before edges the monitor recorded ({n}): "
        + "; ".join(f"{a} -> {', '.join(tos)}" for a, tos in edges.items()))
    log(f"[lockcheck] of them not in the static lock graph ({len(unseen)}): "
        + "; ".join(f"{a} -> {b}" for a, b in unseen))
    log(f"[lockcheck] no LockOrderError; cycles_checked "
        f"{res['cycles_checked']}; the leg {res['seconds']:.1f} s in the "
        f"child, {secs:.1f} s with its start; (topk, topk_merge, "
        f"scan_score) launches "
        f"{res['launches']} [{card}]")
    res["unseen"] = unseen
    return res


# -- phase 18: the single-controller mesh -----------------------------------

#: shards of the mesh legs (all on cuda:0 with one card)
MESH_SHARDS = 4
#: leg A: config 4 at full width, the preload and traffic of phase 4
MESH_KNN = FULL
#: leg B: config 3 at full width; churn ticks a run (fused, then deferred)
MESH_PR = dict(PAGERANK, churn_ticks=3)
#: leg C: TF-IDF at config 2's widths on two stages: the initial load of
#: half the docs, then edit ticks of 8 docs
MESH_TFIDF = dict(TFIDF, edit_ticks=8, per_tick=8)
#: leg C: one sharded window of K ticks of the window-parity graph
MESH_WINDOW = dict(WINDOW_PARITY, k=4)


def _mesh():
    from reflow_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MESH_SHARDS, device=DEVICE)
    if _on_card() and any(d.type != "cuda" for d in mesh.device_list):
        raise AssertionError(f"a mesh shard is off the card: {mesh}")
    return mesh


def _mesh_want(kind: str, chunks: int, n: int) -> tuple:
    """(topk, topk_merge, scan_score) launches of one sharded k-NN tick:
    a rescan scans every shard's corpus slice (``chunks / n`` scores and
    merges each) and ring-merges (``n - 1`` top-k each); an incremental
    tick runs one top-k a shard."""
    if not _on_card():
        return NO_LAUNCH
    rescan = kind in ("retract", "query update", "query insert")
    return (n * (n - 1), chunks, chunks) if rescan else (n, 0, 0)


def _tally_lines(tally: Dict, card: str) -> List[str]:
    return [f"{kind} over {'x'.join(axis) or 'host'}: {calls} calls, "
            f"{nbytes / 1e6:.3f} MB" for (kind, axis), (calls, nbytes)
            in sorted(tally.items())]


def mesh_knn(card: str, cfg: Dict[str, int] = MESH_KNN,
             seed: int = 18) -> Dict[str, object]:
    """Leg A: config 4 through ``IngestFrontend`` (depth 2) on a sharded
    executor of ``MESH_SHARDS`` shards and on a single-device twin, the
    same feed; the tables compared bit for bit after every tick."""
    from reflow_tpu_torch.parallel import spmd
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    n = MESH_SHARDS
    chunks = cfg["D"] // cfg["scan_chunk"]
    kg_s, kg_t = _knn_graph(cfg), _knn_graph(cfg)
    ex = ShardedCudaExecutor(_mesh())
    sched_s = DirtyScheduler(kg_s.graph, ex)
    sched_t = DirtyScheduler(kg_t.graph, _executor())
    fe_s, fe_t = _knn_frontend(sched_s, cfg), _knn_frontend(sched_t, cfg)
    feed = _knn_feed(cfg, seed)
    ticks: List[Dict[str, object]] = []
    launches = list(NO_LAUNCH)
    spmd.reset_collective_tally()
    # the main path's counts: zeroed here, read after the last mesh tick
    zero_launches()
    try:
        for bid, src, batch, kind in feed:
            rec: Dict[str, object] = {"kind": kind}
            for tag, fe, kg in (("mesh", fe_s, kg_s), ("twin", fe_t, kg_t)):
                l0 = _launches()
                s0 = fe.sched.forced_syncs
                t0 = time.perf_counter()
                tk = fe.submit(kg.queries if src == "q" else kg.docs, batch,
                               batch_id=bid)
                fe.flush()
                res = tk.result(timeout=600)
                _sync()
                rec[tag + "_ms"] = (time.perf_counter() - t0) * 1e3
                if res.status != APPLIED:
                    raise AssertionError(f"{tag} {kind} ticket {res.status}")
                rec[tag + "_launches"] = _since(l0)
                rec[tag + "_syncs"] = fe.sched.forced_syncs - s0
            got = rec["mesh_launches"]
            launches = _plus(launches, got)
            if got != _mesh_want(kind, chunks, n):
                raise AssertionError(
                    f"mesh {kind} tick launched (topk, topk_merge, "
                    f"scan_score) {got}, "
                    f"expected {_mesh_want(kind, chunks, n)}")
            if rec["twin_launches"] != _want_launches(kind, chunks):
                raise AssertionError(f"twin {kind} tick launched "
                                     f"{rec['twin_launches']}")
            rec["diff"] = _table_diff(sched_s.read_table(kg_s.index),
                                      sched_t.read_table(kg_t.index))
            ticks.append(rec)
        fe_s.flush()
        fe_t.flush()
    finally:
        fe_s.close()
        fe_t.close()
    tally = spmd.collective_tally()
    # every batch is a host batch: each tick is one window staged through
    # the sharded ingress queue (its capacity split over the shards)
    wins = {tag: (sc.megatick_windows, sc.megatick_fallbacks,
                  fe.windows_staged, fe.windows_pipelined)
            for tag, sc, fe in (("mesh", sched_s, fe_s),
                                ("twin", sched_t, fe_t))}
    if wins["mesh"][:3] != (len(feed), 0, len(feed)):
        raise AssertionError(f"mesh windows (windows, fallbacks, staged, "
                             f"pipelined) {wins['mesh']} over {len(feed)} "
                             f"host ticks")
    queues = [q for key, q in ex._window_cache.items()
              if key[0] == "ingress_q"]
    log(f"[mesh] knn window path (windows, fallbacks, staged, pipelined): "
        f"mesh {wins['mesh']}, twin {wins['twin']}; the mesh's "
        f"{len(queues)} ingress queues hold {sum(q.nbytes for q in queues)}"
        f" B on the card in {MESH_SHARDS} shard buffers a source")
    Q, k = cfg["Q"], cfg["k"]
    table_s = sched_s.read_table(kg_s.index)
    table_t = sched_t.read_table(kg_t.index)
    bit_equal = all(not r["diff"] for r in ticks)
    held = "bit for bit at every tick"
    if not bit_equal:
        # a shard's GEMM shapes may pick another cuBLAS kernel: then the
        # twin's own limits (config 4's) hold instead
        recall, diff = knn_vs_brute_force(sched_t.executor.states[
            kg_t.index.id], table_s, Q, k)
        if recall < BRUTE_RECALL or diff > BRUTE_SCORE_DIFF:
            raise AssertionError(
                f"mesh table vs twin: queries differ at ticks "
                f"{[(i, r['diff'][:4]) for i, r in enumerate(ticks) if r['diff']]}"
                f"; recall {recall:.4f}, score diff {diff:.3g}")
        held = (f"within config 4's limits (recall {recall:.6f}, score "
                f"max_abs_diff {diff:.3g}); ticks differing bit-wise "
                f"{[i for i, r in enumerate(ticks) if r['diff']]}")
    st = {key: ex.states[kg_s.index.id][key]
          for key in ("qvec", "dvec", "dlive")}
    recall, score_diff = check_brute_force("mesh k-NN table", st, table_s,
                                           Q, k)
    del st
    if _table_diff(table_s, table_t) and bit_equal:
        raise AssertionError("mesh table drifted from the twin at the end")
    by_kind: Dict[str, List[tuple]] = {}
    for r in ticks:
        by_kind.setdefault(r["kind"], []).append((r["mesh_ms"], r["twin_ms"]))
    for kind, ms in by_kind.items():
        mesh_med = _median([a for a, _ in ms])
        twin_med = _median([b for _, b in ms])
        log(f"[mesh] knn {kind} tick ({len(ms)}): mesh[{n}] median "
            f"{mesh_med:.3f} ms, single-device twin {twin_med:.3f} ms "
            f"({mesh_med / twin_med:.2f}x) [{card}]")
    log(f"[mesh] knn (topk, topk_merge, scan_score) launches a tick, "
        f"mesh: "
        f"{[r['mesh_launches'] for r in ticks]}; twin: "
        f"{[r['twin_launches'] for r in ticks]}; mesh totals {launches}")
    log(f"[mesh] knn forced syncs a tick, mesh {[r['mesh_syncs'] for r in ticks]}"
        f", twin {[r['twin_syncs'] for r in ticks]}")
    log(f"[mesh] knn table vs the single-device twin: {held}; vs brute "
        f"force: recall {recall:.6f}, score max_abs_diff {score_diff:.6g} "
        f"[{card}]")
    for line in _tally_lines(tally, card):
        log(f"[mesh] knn collectives: {line} [{card}]")
    return {"launches": launches, "ticks": ticks, "tally": tally,
            "bit_equal": bit_equal, "recall": recall}


def _mesh_pagerank(card: str, cfg: Dict[str, object], defer=None
                   ) -> Dict[str, object]:
    """Config 3 on the mesh beside a single-device twin: the initial tick
    and ``churn_ticks`` churn ticks (``defer``: streamed, then drained)."""
    from reflow_tpu_torch.parallel import spmd
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    n_nodes, e, churn = cfg["n_nodes"], cfg["n_edges"], cfg["churn"]
    head = 8 * bucket_capacity(2 * int(churn * e) + 2)

    def graph(arena):
        return (pagerank.build_graph(n_nodes, tol=cfg["tol"],
                                     arena_capacity=arena,
                                     defer_passes=defer),
                pagerank.WebGraph.random(n_nodes, e, seed=cfg["seed"]))

    # the sharded executor's static check holds one tick's whole delta
    # against ONE shard's arena slice (worst-case skew), so each shard's
    # slice is bench.py's arena; the twin keeps bench.py's arena
    pg, web = graph(MESH_SHARDS * (bucket_capacity(e) + head))
    ex = ShardedCudaExecutor(_mesh())
    sched = DirtyScheduler(pg.graph, ex)
    pg_t, web_t = graph(bucket_capacity(e) + head)
    ex_t = _executor()
    twin = DirtyScheduler(pg_t.graph, ex_t)
    spmd.reset_collective_tally()
    rows: List[Dict[str, object]] = []
    for t in range(1 + cfg["churn_ticks"]):
        for tag, s, g, w, e in (("mesh", sched, pg, web, ex),
                                ("twin", twin, pg_t, web_t, ex_t)):
            if t == 0:
                s.push(g.teleport, pagerank.teleport_batch(n_nodes))
                s.push(g.edges, w.initial_batch())
            else:
                s.push(g.edges, w.churn(churn))
            r0, h0 = e.loop_reads, e.host_syncs
            t0 = time.perf_counter()
            res = s.tick(sync=defer is None)
            _sync()
            ms = (time.perf_counter() - t0) * 1e3
            if tag == "mesh":
                rows.append({"ms": ms, "passes": res.passes,
                             "reads": e.loop_reads - r0 + e.host_syncs - h0})
            else:
                rows[-1].update(twin_ms=ms, twin_passes=res.passes,
                                twin_reads=e.loop_reads - r0
                                + e.host_syncs - h0)
    if not isinstance(ex._fx_program, LinearFixpointProgram):
        raise AssertionError("the mesh leg did not run the fused loop")
    drain = None
    if defer is not None:
        probe = 2 * int(churn * cfg["n_edges"])
        drain = sched.drain(pg.edges, probe_rows=probe)
        twin.drain(pg_t.edges, probe_rows=probe)
    err = rank_error(sched, pg, web, n_nodes)
    err_t = rank_error(twin, pg_t, web_t, n_nodes)
    a = pagerank.ranks_to_array(sched.read_table(pg.new_rank), n_nodes)
    b = pagerank.ranks_to_array(twin.read_table(pg_t.new_rank), n_nodes)
    vs_twin = float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())
    tag = "fused" if defer is None else f"defer_passes={defer}"
    log(f"[mesh] pagerank {tag} mesh[{MESH_SHARDS}]: tick ms "
        f"{[round(r['ms'], 3) for r in rows]}, twin "
        f"{[round(r['twin_ms'], 3) for r in rows]}; passes "
        f"{[r['passes'] for r in rows]}, twin "
        f"{[r['twin_passes'] for r in rows]}; readbacks a tick "
        f"{[r['reads'] for r in rows]}, twin "
        f"{[r['twin_reads'] for r in rows]}"
        + (f"; drain {drain} ticks" if drain is not None else "")
        + f" [{card}]")
    log(f"[mesh] pagerank {tag}: max|rank - ref| / max(ref, 1) mesh "
        f"{err['rel_err']:.6g}, twin {err_t['rel_err']:.6g}; mesh vs twin "
        f"{vs_twin:.6g} (bound {PAGERANK_MAX_REL_ERR:g}); CSR rebuilds "
        f"{dict(ex.csr_rebuilds)} (per shard) [{card}]")
    for line in _tally_lines(spmd.collective_tally(), card):
        log(f"[mesh] pagerank {tag} collectives: {line} [{card}]")
    if max(err["rel_err"], vs_twin) > PAGERANK_MAX_REL_ERR:
        raise AssertionError(f"mesh pagerank {tag}: rel err {err['rel_err']:.3g}"
                             f", vs twin {vs_twin:.3g}")
    return {"rows": rows, "rel_err": err["rel_err"], "vs_twin": vs_twin}


def mesh_misc(card: str) -> Dict[str, object]:
    """Leg C: ``dryrun_multichip(8)``; TF-IDF on two stages beside a
    single-device twin; one sharded ``tick_many`` window beside its
    per-tick twin."""
    from reflow_tpu_torch.parallel import dryrun_multichip
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor
    from reflow_tpu_torch.parallel.topo import StagedCudaExecutor

    t0 = time.perf_counter()
    dry = dryrun_multichip(8, device=DEVICE)
    log(f"[mesh] dryrun_multichip(8): ranks within {dry['rel_err']:.6g} "
        f"(deferred {dry['rel_err_deferred']:.6g}) of the reference, bound "
        f"5e-4; passes {dry['passes']}; {time.perf_counter() - t0:.3f} s "
        f"[{card}]")

    cfg = MESH_TFIDF
    rng = np.random.default_rng(cfg["seed"])
    words = np.array([f"t{i}" for i in range(cfg["vocab"])])
    corpus = tfidf.Corpus(cfg["n_pairs"], cfg["n_terms"])
    staged = StagedCudaExecutor(device=DEVICE)
    tg = tfidf.build_graph(cfg["n_pairs"], cfg["n_terms"], cfg["docs"])
    for node in tg.graph.nodes:
        if node.kind == "op":
            node.stage = 0 if node.name in ("ones", "tf", "term_of",
                                            "pair_presence") else 1
    sched = DirtyScheduler(tg.graph, staged)
    tg2 = tfidf.build_graph(cfg["n_pairs"], cfg["n_terms"], cfg["docs"])
    twin = DirtyScheduler(tg2.graph, _executor())

    def text():
        return " ".join(rng.choice(words, size=rng.integers(20, 60)))

    feeds = [DeltaBatch.concat([corpus.edit(d, text())
                                for d in range(cfg["docs"] // 2)])]
    feeds += [DeltaBatch.concat([corpus.edit(int(rng.integers(
        0, cfg["docs"])), text()) for _ in range(cfg["per_tick"])])
        for _ in range(cfg["edit_ticks"])]
    ms_s, ms_t = [], []
    for b in feeds:
        for s, g, acc in ((sched, tg, ms_s), (twin, tg2, ms_t)):
            t0 = time.perf_counter()
            s.push(g.tokens, b)
            s.tick()
            _sync()
            acc.append((time.perf_counter() - t0) * 1e3)
    for name in ("tf", "df", "ndocs"):
        a = sched.read_table(getattr(tg, name))
        b = twin.read_table(getattr(tg2, name))
        if set(a) != set(b) or any(float(np.asarray(a[k]).reshape(()))
                                   != float(np.asarray(b[k]).reshape(()))
                                   for k in a):
            raise AssertionError(f"staged tfidf {name} != the twin's")
    log(f"[mesh] staged tfidf (stages 0/1 on {sorted(set(map(str, staged.stage_devices.values())))}"
        f"): load {ms_s[0]:.3f} ms (twin {ms_t[0]:.3f}), edit ticks median "
        f"{_median(ms_s[1:]):.3f} ms (twin {_median(ms_t[1:]):.3f}); tf, df, "
        f"ndocs equal the twin's exactly [{card}]")

    w = MESH_WINDOW
    KS, R, K = w["key_space"], w["rows"], w["k"]
    rng = np.random.default_rng(w["seed"])
    batches = [DeltaBatch(rng.integers(0, KS, R).astype(np.int64),
                          rng.integers(0, 8, R).astype(np.float32),
                          np.ones(R, np.int64)) for _ in range(K)]
    g, s, r = _fuzz_graph(KS)
    msched = DirtyScheduler(g, ShardedCudaExecutor(_mesh()))
    t0 = time.perf_counter()
    msched.tick_many([{s: b} for b in batches]).block()
    _sync()
    win_ms = (time.perf_counter() - t0) * 1e3
    g2, s2, r2 = _fuzz_graph(KS)
    tsched = DirtyScheduler(g2, _executor())
    t0 = time.perf_counter()
    for b in batches:
        tsched.push(s2, b)
        tsched.tick()
    _sync()
    tick_ms = (time.perf_counter() - t0) * 1e3
    if (msched.megatick_windows != 1 or msched.megatick_fallbacks
            or not np.array_equal(_table_array(msched, r, KS),
                                  _table_array(tsched, r2, KS),
                                  equal_nan=True)):
        raise AssertionError("the sharded window != its per-tick twin")
    log(f"[mesh] sharded window: {K} ticks of {R} rows in one tick_many on "
        f"mesh[{MESH_SHARDS}] {win_ms:.3f} ms, the single-device per-tick "
        f"twin {tick_ms:.3f} ms; tables equal exactly [{card}]")
    return {"dryrun": dry, "window_ms": win_ms}


def phase_mesh(card: str) -> Dict[str, object]:
    """Phase 18: leg A (k-NN), leg B (PageRank, fused and deferred), leg
    C (the dry run, the staged executor, a sharded window)."""
    knn_out = mesh_knn(card)
    # legs B and C launch no top-k kernel
    l0 = _launches()
    pr = _mesh_pagerank(card, MESH_PR)
    prd = _mesh_pagerank(card, MESH_PR, defer=2)
    misc = mesh_misc(card)
    if _since(l0) != NO_LAUNCH:
        raise AssertionError("mesh legs B and C launched a top-k kernel")
    return {"launches": knn_out["launches"], "knn": knn_out, "pagerank": pr,
            "deferred": prd, "misc": misc}


# -- phase 19: the model axis and a mesh across processes -------------------

#: leg A: config 5 at full width on a (delta 2, model 2) mesh
TP_EMBED = dict(per_tick=256, n_images=1 << 14, n_groups=64, seed=19)
#: config 5's limits (PERF.md section 2): the centroids and the features
TP_CENT_ATOL, TP_FEAT_ATOL = 5e-3, 2e-2
#: leg A-w: one tick_many window of 4 ticks, and 8 ticks through the
#: depth-2 pump in windows of 2
TP_WINDOW_K, TP_PUMP_TICKS = 4, 8
#: leg B1: config 3 at full width over two processes
MH_PR = dict(PAGERANK, churn_ticks=3)
#: leg B2: config 4's k-NN at its widths, the preload cut to 2 chunks
MH_KNN = dict(FULL, preload_chunks=2, seed=19)
#: seconds a pair of children may take
MH_LIMIT_S = 300
#: B1's ranks against a twin of the same mesh shape run here in one
#: process, and a restored run's against the live one (relative). The
#: runs hold the same shards and rows; only the order of the card's
#: float atomics differs, and each run stops emitting a rank once it
#: moves by no more than tol, so two sound runs may differ by up to their
#: two suppressed residues, 2 tol (on the H100 the twins read 1.2e-4 and
#: the restored runs up to 8.5e-6 at tol 1e-4; a one-tick-stale
#: continuation, checked to lie outside the bound, reads 14: PERF.md)
MH_TWIN_RTOL = 2 * MH_PR["tol"]


def _feature_diff(kind: str, got: DeltaBatch, want: DeltaBatch,
                  dim: int) -> float:
    """Max |diff| of two ticks' embed egress rows ([group, *features],
    paired by key, weight and group): the same rows must come out."""
    def order(b):
        v = np.asarray(b.values)
        return np.lexsort((v[:, 0], np.asarray(b.weights),
                           np.asarray(b.keys)))

    og, ow = order(got), order(want)
    gv, wv = np.asarray(got.values)[og], np.asarray(want.values)[ow]
    if (gv.shape != (len(want), 1 + dim)
            or not np.array_equal(np.asarray(got.keys)[og],
                                  np.asarray(want.keys)[ow])
            or not np.array_equal(np.asarray(got.weights)[og],
                                  np.asarray(want.weights)[ow])
            or not np.array_equal(gv[:, 0], wv[:, 0])):
        raise AssertionError(f"{kind} tick: the embed rows {gv.shape} are "
                             f"not the twin's {wv.shape}")
    return float(np.abs(gv[:, 1:] - wv[:, 1:]).max())


def phase_model_axis(card: str) -> Dict[str, object]:
    """Leg A: config 5 tensor-parallel over a (2, 2) mesh beside a
    single-device twin."""
    from reflow_tpu_torch.parallel import make_model_mesh, spmd
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    cfg = TP_EMBED
    params = vit.init_vit(0, **vit.VIT_B_16, device=DEVICE)
    mcfg = params["_cfg"]
    n, G, N = cfg["per_tick"], cfg["n_groups"], cfg["n_images"]
    ex = ShardedCudaExecutor(make_model_mesh(2, 2, device=DEVICE),
                             model_axis="model")
    if ex.axis != "delta" or ex.n != 2 or ex.m != 2:
        raise AssertionError(f"data axis {ex.axis} of {ex.n}, model {ex.m}")
    ig = image_embed.build_graph(N, G, params, model_axis="model")
    ig_t = image_embed.build_graph(N, G, params)
    # the embed Map's egress rows, read from the ticks themselves
    for e in (ig, ig_t):
        e.graph.sink(e.embed, "feats")
    sched = DirtyScheduler(ig.graph, ex)
    twin = DirtyScheduler(ig_t.graph, _executor())

    def feed(stream):
        ids = np.arange(n)
        b1 = stream.insert(ids, ids % G)
        ids2 = np.arange(n, 2 * n - 3)
        b2 = DeltaBatch.concat([
            stream.insert(ids2, ids2 % G),
            stream.move(3, (stream.groups[3] + 1) % G), stream.delete(7)])
        return [("insert", b1), ("insert+move+delete", b2)]

    stream = image_embed.ImageStream(params, seed=cfg["seed"])
    stream_t = image_embed.ImageStream(params, seed=cfg["seed"])
    rows: List[Dict[str, object]] = []
    tallies = []
    want_psums = 2 * mcfg["depth"]
    feat = 0.0
    for (kind, b), (_, bt) in zip(feed(stream), feed(stream_t)):
        spmd.reset_collective_tally()
        t0 = time.perf_counter()
        sched.push(ig.images, b)
        got_f = sched.tick().sink_deltas["feats"]
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        tally = spmd.collective_tally()
        tallies.append(tally)
        psums = tally.get(("psum", ("model",)), (0, 0))[0]
        if psums != want_psums:
            raise AssertionError(f"{kind} tick: {psums} psum steps over "
                                 f"model, expected {want_psums}")
        t0 = time.perf_counter()
        twin.push(ig_t.images, bt)
        want_f = twin.tick().sink_deltas["feats"]
        _sync()
        rows.append({"kind": kind, "ms": ms, "psums": psums,
                     "twin_ms": (time.perf_counter() - t0) * 1e3})
        feat = max(feat, _feature_diff(kind, got_f, want_f, mcfg["dim"]))
    cent = _cent_diff(sched.read_table(ig.centroids),
                      twin.read_table(ig_t.centroids))
    if not np.isfinite(cent) or cent > TP_CENT_ATOL:
        raise AssertionError(f"centroids differ from the twin's by {cent}")

    if not np.isfinite(feat) or feat > TP_FEAT_ATOL:
        raise AssertionError(f"the embed Map's features differ from the "
                             f"twin's by {feat}")

    def shard_params(r):
        return ex.shard_states(r)[ig.embed.id]["params"]

    def wq_shapes():
        return {tuple(shard_params(r)["blocks"][0]["wq"].shape)
                for r in ex.mesh.local_ranks}

    before = wq_shapes()
    ex.update_params(ig.embed, {k: v for k, v in params.items()
                                if k != "_cfg"})
    after = wq_shapes()
    want_wq = {(mcfg["dim"], mcfg["dim"] // 2)}
    if before != want_wq or after != want_wq:
        raise AssertionError(f"wq per shard {before}, after update_params "
                             f"{after}; expected {want_wq}")
    log(f"[model_axis] config 5 (ViT-B/16, {n} images a tick, {N} ids, {G} "
        f"groups) on make_model_mesh(2, 2), model_axis 'model', the four "
        f"shards on {ex.device}: tick ms "
        + ", ".join(f"{r['kind']} {r['ms']:.3f} (twin {r['twin_ms']:.3f})"
                    for r in rows)
        + f" [{card}]")
    log(f"[model_axis] psum steps over model a tick {[r['psums'] for r in rows]}"
        f" (2 a block x {mcfg['depth']} blocks); centroids max|diff| vs the "
        f"single-device twin {cent:.3g} (bound {TP_CENT_ATOL}), the embed "
        f"Map's egress features of both ticks {feat:.3g} (bound "
        f"{TP_FEAT_ATOL}); wq a shard {sorted(before)[0]}, "
        f"after update_params {sorted(after)[0]}")
    for line in _tally_lines(tallies[-1], card):
        log(f"[model_axis] collectives of the second tick: {line}")
    win = model_axis_windows(card, params)
    return {"ticks": rows, "centroid_diff": cent, "feature_diff": feat,
            "windows": win}


def _cent_diff(got: Dict, want: Dict) -> float:
    if set(got) != set(want):
        raise AssertionError(f"centroid groups {sorted(got)} vs "
                             f"{sorted(want)}")
    return max(float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max())
               for k in want)


def model_axis_windows(card: str, params) -> Dict[str, object]:
    """Leg A-w: config 5 on ``make_model_mesh(2, 2)`` through the window
    path. One ``tick_many`` window of ``TP_WINDOW_K`` ticks, then
    ``TP_PUMP_TICKS`` ticks through an ``IngestFrontend`` at depth 2
    (windows of 2, one backlog pumped in this thread, so every window
    after the first stages while the one before is in flight). Beside
    them the same ticks on the same mesh one at a time, and on one
    device; the window's and the pump's centroids are held to both."""
    from reflow_tpu_torch.parallel import make_model_mesh
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    cfg = TP_EMBED
    n, G, N = cfg["per_tick"], cfg["n_groups"], cfg["n_images"]
    K, T = TP_WINDOW_K, TP_PUMP_TICKS
    stream = image_embed.ImageStream(params, seed=cfg["seed"] + 1)
    feed = [stream.insert(np.arange(t * n, (t + 1) * n),
                          np.arange(t * n, (t + 1) * n) % G)
            for t in range(T)]

    def mesh_sched():
        ig = image_embed.build_graph(N, G, params, model_axis="model")
        ex = ShardedCudaExecutor(make_model_mesh(2, 2, device=DEVICE),
                                 model_axis="model")
        return DirtyScheduler(ig.graph, ex), ig

    def per_tick(sched, ig, at):
        ms, tabs = [], {}
        for t, b in enumerate(feed):
            t0 = time.perf_counter()
            sched.push(ig.images, b)
            sched.tick()
            _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if t + 1 in at:
                tabs[t + 1] = sched.read_table(ig.centroids)
        return ms, tabs

    # the per-tick run of the same mesh, and the single-device twin
    sp, igp = mesh_sched()
    p_ms, p_tab = per_tick(sp, igp, (K, T))
    if not sp.executor.supports_window() or sp.megatick_windows:
        raise AssertionError("the model mesh refused the window path")
    ig_t = image_embed.build_graph(N, G, params)
    twin = DirtyScheduler(ig_t.graph, _executor())
    t_ms, t_tab = per_tick(twin, ig_t, (K, T))

    # one window of K ticks
    sw, igw = mesh_sched()
    t0 = time.perf_counter()
    r = sw.tick_many([{igw.images: b} for b in feed[:K]])
    r.block()
    _sync()
    w_ms = (time.perf_counter() - t0) * 1e3
    (queue,) = [q for key, q in sw.executor._window_cache.items()
                if key[0] == "ingress_q"]
    if (sw.megatick_windows, sw.executor.window_dispatches,
            sw.megatick_fallbacks) != (1, 1, 0):
        raise AssertionError(f"A-w: {sw.megatick_windows} windows, "
                             f"{sw.executor.window_dispatches} dispatches, "
                             f"{sw.megatick_fallbacks} fallbacks")
    w_tab = sw.read_table(igw.centroids)

    # the pump at depth 2
    sf, igf = mesh_sched()
    fe = IngestFrontend(sf, start=False, depth=2, max_bytes=1 << 34,
                        window=CoalesceWindow(max_rows=n, max_ticks=2,
                                              max_latency_s=0.001))
    try:
        tks = [fe.submit(igf.images, b, timeout=60) for b in feed]
        t0 = time.perf_counter()
        with fe._lock:
            drained = fe._take_window()
        fe._run_window(drained)
        with fe._lock:
            fe._finish_window()
        _sync()
        f_ms = (time.perf_counter() - t0) * 1e3
        if not all(t.result(timeout=60).applied for t in tks):
            raise AssertionError("A-w: a pump ticket was not applied")
    finally:
        fe.close()
    want_w = -(-T // 2)
    if (sf.megatick_windows, sf.executor.window_dispatches,
            sf.megatick_fallbacks, fe.windows_staged,
            fe.windows_pipelined) != (want_w, want_w, 0, want_w,
                                      want_w - 1):
        raise AssertionError(
            f"A-w pump: {sf.megatick_windows} windows, "
            f"{sf.executor.window_dispatches} dispatches, "
            f"{sf.megatick_fallbacks} fallbacks, {fe.windows_staged} staged,"
            f" {fe.windows_pipelined} pipelined")
    (fqueue,) = [q for key, q in sf.executor._window_cache.items()
                 if key[0] == "ingress_q"]
    f_tab = sf.read_table(igf.centroids)

    diffs = {"window_vs_per_tick": _cent_diff(w_tab, p_tab[K]),
             "window_vs_twin": _cent_diff(w_tab, t_tab[K]),
             "pump_vs_per_tick": _cent_diff(f_tab, p_tab[T]),
             "pump_vs_twin": _cent_diff(f_tab, t_tab[T]),
             "per_tick_vs_twin": _cent_diff(p_tab[T], t_tab[T])}
    for k, v in diffs.items():
        if not np.isfinite(v) or v > TP_CENT_ATOL:
            raise AssertionError(f"A-w centroids {k}: {v} (bound "
                                 f"{TP_CENT_ATOL})")
    log(f"[model_axis] A-w window: {K} ticks x {n} images in 1 tick_many "
        f"window on make_model_mesh(2, 2) ({sw.megatick_windows} window, "
        f"{sw.executor.window_dispatches} dispatch, "
        f"{sw.megatick_fallbacks} fallbacks), queue {queue.generations} "
        f"generation(s) of {queue.gen_nbytes / 1e6:.1f} MB; "
        f"{w_ms / K:.3f} ms a tick (the same mesh per tick "
        f"{np.median(p_ms[:K]):.3f} ms median of {K}, one device "
        f"{np.median(t_ms[:K]):.3f}) [{card}]")
    log(f"[model_axis] A-w pump: {T} ticks through IngestFrontend(depth 2, "
        f"windows of 2): {sf.megatick_windows} windows, windows_pipelined "
        f"{fe.windows_pipelined}, queue {fqueue.generations} generations "
        f"of {fqueue.gen_nbytes / 1e6:.1f} MB; {f_ms / T:.3f} ms a tick "
        f"(the same mesh per tick {np.median(p_ms):.3f} ms median of {T}, "
        f"one device {np.median(t_ms):.3f}) [{card}]")
    log("[model_axis] A-w centroids max|diff| " + ", ".join(
        f"{k} {v:.3g}" for k, v in diffs.items())
        + f" (bound {TP_CENT_ATOL})")
    return {"window_ms_a_tick": w_ms / K, "pump_ms_a_tick": f_ms / T,
            "per_tick_ms": p_ms, "twin_ms": t_ms, "diffs": diffs,
            "windows_pipelined": fe.windows_pipelined,
            "queue_bytes": queue.gen_nbytes}


def _mh_args(cfg: Dict[str, object], keys) -> List[str]:
    out = []
    for k in keys:
        out += ["--" + k.lower().replace("_", "-"), str(cfg[k])]
    return out


def _mh_lines(tag: str, sums: list, card: str) -> None:
    for s in sums:
        log(f"[multihost] {tag} child {s['pid']}: backend {s['backend']}, "
            f"start {s['start_s']:.2f} s to the group, staged across the "
            f"boundary {s['staged_bytes'] / 1e6:.3f} MB, exchanges by kind "
            + ", ".join(f"{k} {v[0]} ({v[1] / 1e6:.3f} MB)"
                        for k, v in sorted(s["boundary"].items()))
            + f"; (topk, topk_merge, scan_score) launches "
            f"{tuple(s['launches'])} "
            f"[{card}]")


#: leg B's group: two gloo processes sharing the card
MH_GROUP = dict(backend="gloo", nproc=2)


def _mh_group(tmp: str, tag: str, args: List[str],
              group: Dict[str, object]):
    """``group["nproc"]`` ``multihost_worker`` children in one group of
    ``group["backend"]``: gloo children share the card, each nccl child
    takes the card of its index."""
    from reflow_tpu_torch.parallel.multihost_worker import WorkerGroup

    dev = None if group["backend"] == "nccl" else (
        "cuda:0" if DEVICE is None else str(DEVICE))
    return WorkerGroup(group["nproc"], group["backend"], args, out_dir=tmp,
                       tag=tag, device=dev, limit_s=MH_LIMIT_S,
                       timeout_s=240)


def _mh_ranks(tables: list, tag: str, nproc: int) -> np.ndarray:
    """The children's owned ranks of tick ``tag``, joined in rank order."""
    return np.concatenate([tables[r // 2][f"{tag}/r{r}/{nid}/emitted"]
                           for r in range(2 * nproc)
                           for nid in [_rank_nid(tables[r // 2], tag, r)]])


def phase_multihost(card: str, group: Dict[str, object] = MH_GROUP
                    ) -> Dict[str, object]:
    """Leg B: config 3 (B1, two shards a process) beside a twin of the
    same mesh shape in this process, and config 4's k-NN (B2, four
    shards in all) beside a single-device twin; each twin runs here while
    the children run."""
    from reflow_tpu_torch.parallel import make_mesh
    from reflow_tpu_torch.parallel import multihost_worker as mw
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    nproc, where = group["nproc"], (f"{group['nproc']} {group['backend']} "
                                    f"processes")
    kdelta = max(1, 4 // nproc)
    tmp = tempfile.mkdtemp()
    try:
        cfg = MH_PR
        b1 = _mh_group(tmp, "b1", [
            "--case", "pagerank", "--record", "ranks", "--delta", "2",
            "--ckpt", os.path.join(tmp, "ckpt"),
            "--restore-rtol", str(MH_TWIN_RTOL),
            *_mh_args(cfg, ("n_nodes", "n_edges", "churn", "churn_ticks",
                            "tol", "seed"))], group)
        # the twin: the children's mesh shape and row layout in one
        # process (dcn rows of 2 shards, each process's stripe of every
        # batch in its rows), its shards on the card
        twin_out: Dict[str, np.ndarray] = {}
        t0 = time.perf_counter()
        tck = os.path.join(tmp, "twin_ckpt")
        tdev = "cuda:0" if DEVICE is None else DEVICE
        try:
            tsum = mw.drive_pagerank(
                cfg, lambda: ShardedCudaExecutor(make_mesh(
                    2 * nproc, dcn=nproc, device=tdev)),
                lambda s, node, b, cap, batch_id=None: s.push(
                    node, mw.twin_batch(b, node.spec, nproc, cap, tdev),
                    batch_id=batch_id),
                nproc=nproc, out=twin_out, record="ranks",
                save=lambda s: save_checkpoint(s, tck),
                load=lambda s: load_checkpoint(s, tck),
                restore_rtol=MH_TWIN_RTOL)
            twin_s = time.perf_counter() - t0
            sums, tables = b1.wait()
        finally:
            b1.kill()
        n = cfg["n_nodes"]
        worst = {}
        for tag in [t["tag"] for t in sums[0]["ticks"]]:
            want = _mh_ranks([twin_out] * nproc, tag, nproc)
            got = _mh_ranks(tables, tag, nproc)
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
            worst[tag] = float(rel.max())
            if got.shape != (n,) or not np.isfinite(got).all() \
                    or worst[tag] > MH_TWIN_RTOL:
                raise AssertionError(f"B1 {tag}: ranks {got.shape} vs the "
                                     f"twin's, max rel {worst[tag]}")
        # a wrong continuation: the restored run against the twin's tick
        # before it. The bound must tell the two apart
        stale_want = _mh_ranks([twin_out] * nproc, "once", nproc)
        stale = float((np.abs(_mh_ranks(tables, "restored", nproc)
                              - stale_want)
                       / np.maximum(np.abs(stale_want), 1.0)).max())
        if stale <= MH_TWIN_RTOL:
            raise AssertionError(f"B1: a one-tick-stale continuation is "
                                 f"{stale} from the twin, within the bound")
        ref = max(s["vs_reference"] for s in sums)
        if ref > PAGERANK_MAX_REL_ERR:
            raise AssertionError(f"B1 owned ranks vs the reference: {ref}")
        if len({s["digest"] for s in sums} | {tsum["digest"]}) != 1:
            raise AssertionError("B1: the dedup digests differ")
        log(f"[multihost] B1 config 3 ({n} nodes, {cfg['n_edges']} edges, "
            f"{cfg['churn_ticks']} churn ticks, the exactly-once round, a "
            f"collective checkpoint restored into fresh schedulers) on "
            f"(dcn {nproc}, delta 2) over {where}: ranks vs the reference "
            f"{ref:.3g} (bound {PAGERANK_MAX_REL_ERR}), vs the one-process "
            f"twin of the same mesh by tick "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + f" (bound {MH_TWIN_RTOL}); a one-tick-stale continuation "
            f"{stale:.3g}; restored vs live "
            + ", ".join(f"{s['restored_vs_live']:.3g}" for s in sums)
            + f" (twin {tsum['restored_vs_live']:.3g}; bound "
            f"{MH_TWIN_RTOL}); tick "
            f"ms (passes) child 0 "
            + ", ".join(f"{t['tag']} {t['ms']:.1f} ({t['passes']})"
                        for t in sums[0]["ticks"])
            + "; twin " + ", ".join(f"{t['tag']} {t['ms']:.1f} "
                                    f"({t['passes']})"
                                    for t in tsum["ticks"])
            + f" (the twin ran beside the children, {twin_s:.1f} s) "
            f"[{card}]")
        _mh_lines("B1", sums, card)

        kcfg = MH_KNN
        b2 = _mh_group(tmp, "b2", ["--case", "knn", "--delta", str(kdelta),
                                   *_mh_args(kcfg, (
                                       "Q", "D", "dim", "k", "scan_chunk",
                                       "preload_chunk", "preload_chunks",
                                       "insert_ticks", "per_tick", "retract",
                                       "query_update", "seed"))], group)
        ktwin: Dict[str, np.ndarray] = {}
        try:
            ksum = mw.drive_knn(kcfg, _executor(), ktwin)
            ksums, ktables = b2.wait()
        finally:
            b2.kill()
        for i, t in enumerate(ktables):
            diff = [key for key in ktwin
                    if not np.array_equal(t[key], ktwin[key])]
            if set(t) != set(ktwin) or diff:
                raise AssertionError(f"B2 child {i}: tables differ from the "
                                     f"twin's at {diff[:6]}")
        for s in ksums:
            if _on_card() and not all(s["launches"]):
                raise AssertionError(f"B2 child {s['pid']} launched (topk, "
                                     f"topk_merge, scan_score) "
                                     f"{s['launches']}")
        log(f"[multihost] B2 config 4's k-NN (Q {kcfg['Q']}, {kcfg['dim']} "
            f"int8, k {kcfg['k']}, chunk {kcfg['scan_chunk']}, preload 2 x "
            f"{kcfg['preload_chunk']}) on (dcn {nproc}, delta {kdelta}) over "
            f"{where}: every tick's table equal to the single-device "
            f"twin's bit for bit ({len(ksum['ticks'])} ticks); tick ms "
            f"child 0 " + ", ".join(f"{t['kind']} {t['ms']:.1f}"
                                    for t in ksums[0]["ticks"])
            + "; twin " + ", ".join(f"{t['kind']} {t['ms']:.1f}"
                                    for t in ksum["ticks"])
            + f" [{card}]")
        _mh_lines("B2", ksums, card)
        bw = multihost_windows(card, tmp, group, sums, ksums)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"b1": sums, "b2": ksums, "bw": bw}


def multihost_windows(card: str, tmp: str, group: Dict[str, object],
                      b1: list, b2: list) -> Dict[str, object]:
    """Leg B-w: the window path across the processes, in one more pair
    of children (``--case window``): B1's churn as one window of
    ``multihost_worker.WINDOW_K`` ticks, a collective checkpoint between windows
    restored into fresh schedulers and one more window on both, then
    B2's k-NN through an ``IngestFrontend`` at depth 2. Beside them a
    twin of the same mesh shape in this process (the PageRank windows)
    and a single-device twin through the same frontend (the k-NN); the
    per-tick numbers are B1's and B2's children's (``b1``, ``b2``)."""
    from reflow_tpu_torch.parallel import make_mesh
    from reflow_tpu_torch.parallel import multihost_worker as mw
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    nproc = group["nproc"]
    where = f"{nproc} {group['backend']} processes"
    # one --seed reaches both cases of a window child
    cfg, kcfg, K = MH_PR, dict(MH_KNN, seed=MH_PR["seed"]), mw.WINDOW_K
    # both cases on (dcn nproc, delta 2), as B1
    bw = _mh_group(tmp, "bw", [
        "--case", "window", "--record", "ranks", "--delta", "2",
        "--ckpt", os.path.join(tmp, "ckpt_w"),
        "--restore-rtol", str(MH_TWIN_RTOL),
        *_mh_args(cfg, ("n_nodes", "n_edges", "churn", "tol", "seed")),
        *_mh_args(kcfg, ("Q", "D", "dim", "k", "scan_chunk",
                         "preload_chunk", "preload_chunks", "insert_ticks",
                         "per_tick", "retract", "query_update"))], group)
    tdev = "cuda:0" if DEVICE is None else DEVICE
    twin_out: Dict[str, np.ndarray] = {}
    ktwin: Dict[str, np.ndarray] = {}
    tck = os.path.join(tmp, "twin_ckpt_w")
    try:
        tsum = mw.drive_pagerank_windows(
            cfg, lambda: ShardedCudaExecutor(make_mesh(
                2 * nproc, dcn=nproc, device=tdev)),
            save=lambda s: save_checkpoint(s, tck),
            load=lambda s: load_checkpoint(s, tck), out=twin_out,
            record="ranks", restore_rtol=MH_TWIN_RTOL)
        ktsum = mw.drive_knn_frontend(kcfg, _executor(), ktwin)
        sums, tables = bw.wait()
    finally:
        bw.kill()
    n = cfg["n_nodes"]
    worst = {}
    for tag in ("b0", "w1", "cont", "restored"):
        want = _mh_ranks([twin_out] * nproc, tag, nproc)
        got = _mh_ranks(tables, tag, nproc)
        worst[tag] = float((np.abs(got - want)
                            / np.maximum(np.abs(want), 1.0)).max())
        if got.shape != (n,) or not np.isfinite(got).all() \
                or worst[tag] > MH_TWIN_RTOL:
            raise AssertionError(f"B-w {tag}: ranks {got.shape} vs the "
                                 f"twin's, max rel {worst[tag]}")
    for s in sums:
        pr, kn = s["pagerank"], s["knn"]
        if (pr["windows"], pr["window_dispatches"], pr["fallbacks"]) != \
                (2, 2, 0):
            raise AssertionError(f"B-w child {s['pid']}: PageRank windows "
                                 f"{pr['windows']}, dispatches "
                                 f"{pr['window_dispatches']}, fallbacks "
                                 f"{pr['fallbacks']}")
        if pr["vs_reference"] > PAGERANK_MAX_REL_ERR:
            raise AssertionError(f"B-w child {s['pid']}: ranks vs the "
                                 f"reference {pr['vs_reference']}")
        if (kn["windows"], kn["window_dispatches"], kn["fallbacks"]) != \
                (ktsum["windows"], ktsum["windows"], 0) \
                or kn["windows_pipelined"] != ktsum["windows_pipelined"] \
                or not kn["windows_pipelined"]:
            raise AssertionError(f"B-w child {s['pid']}: k-NN windows "
                                 f"{kn['windows']}, dispatches "
                                 f"{kn['window_dispatches']}, pipelined "
                                 f"{kn['windows_pipelined']}; the twin's "
                                 f"{ktsum['windows']}")
        if _on_card() and not all(kn["launches"]):
            raise AssertionError(f"B-w child {s['pid']} launched (topk, "
                                 f"topk_merge, scan_score) {kn['launches']}")
    for i, t in enumerate(tables):
        got = {key: a for key, a in t.items() if key.startswith("f")}
        diff = [key for key in ktwin
                if key not in got or not np.array_equal(got[key],
                                                        ktwin[key])]
        if set(got) != set(ktwin) or diff:
            raise AssertionError(f"B-w child {i}: the k-NN tables differ "
                                 f"from the single-device twin's at "
                                 f"{diff[:6]}")
    if len({s["pagerank"]["digest"] for s in sums}) != 1:
        raise AssertionError("B-w: the dedup digests differ")
    p0, k0 = sums[0]["pagerank"], sums[0]["knn"]
    wt = {t["tag"]: t for t in p0["ticks"]}
    churn_ms = [t["ms"] for t in b1[0]["ticks"]
                if t["tag"] not in ("t0", "once", "cont", "restored")]
    knn_tick_ms = [t["ms"] for t in b2[0]["ticks"]]
    log(f"[multihost] B-w config 3 ({n} nodes, {cfg['n_edges']} edges) on "
        f"(dcn {nproc}, delta 2) over {where}: the churn as windows of {K} "
        f"ticks through tick_many, child 0 {p0['windows']} windows, "
        f"{p0['window_dispatches']} dispatches, {p0['fallbacks']} "
        f"fallbacks, queue {p0['queue_bytes'] / 1e6:.3f} MB a generation "
        f"(this process's shards); window ms a tick (passes a window) "
        + ", ".join(f"{tag} {wt[tag]['ms'] / wt[tag]['ticks']:.1f} "
                    f"({wt[tag]['passes']})"
                    for tag in ("w1", "cont", "restored"))
        + f"; B1's churn ticks one at a time on the same mesh "
        + ", ".join(f"{x:.1f}" for x in churn_ms)
        + f" ms; ranks vs the one-process twin's windows by tag "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (bound {MH_TWIN_RTOL}), restored vs live "
        + ", ".join(f"{s['pagerank']['restored_vs_live']:.3g}"
                    for s in sums)
        + f", vs the reference {p0['vs_reference']:.3g} [{card}]")
    log(f"[multihost] B-w config 4's k-NN through IngestFrontend(depth "
        f"{mw.FRONTEND_DEPTH}, windows of {mw.FRONTEND_TICKS}) on "
        f"(dcn {nproc}, delta 2) over {where}: child 0 {k0['windows']} "
        f"windows, {k0['window_dispatches']} dispatches, "
        f"{k0['fallbacks']} fallbacks, windows_pipelined "
        f"{k0['windows_pipelined']}, queues {k0['queue_bytes'] / 1e6:.3f} "
        f"MB a generation (summed over the window shapes); round ms "
        f"(ticks) "
        + ", ".join(f"{r['ms']:.1f} ({r['ticks']})" for r in k0["rounds"])
        + f", {sum(r['ms'] for r in k0['rounds']) / sum(r['ticks'] for r in k0['rounds']):.1f} ms a tick "
        f"(B2 one tick at a time: " + ", ".join(f"{x:.1f}"
                                               for x in knn_tick_ms)
        + f" ms); every round's table equal to the single-device twin's "
        f"through the same frontend bit for bit; (topk, topk_merge, "
        f"scan_score) "
        f"launches a child " + ", ".join(str(tuple(s["knn"]["launches"]))
                                         for s in sums)
        + f" (B2 per tick: " + ", ".join(str(tuple(s["launches"]))
                                        for s in b2) + f") [{card}]")
    _mh_lines("B-w", sums, card)
    return {"pagerank": [s["pagerank"] for s in sums],
            "knn": [s["knn"] for s in sums], "worst": worst,
            "launches": [sum(x) for x in
                         zip(*(s["knn"]["launches"] for s in sums))]}


# -- phase 20: the executor picked from the environment -----------------------

#: legs a and c: config 4 at full width, the preload cut to 2 x 65,536
#: docs as in phase 17
CONFIG_KNN = dict(FULL, preload_chunks=2, insert_ticks=1)
#: leg b: config 3 at full width, the initial tick and 2 churn ticks
CONFIG_PR = dict(PAGERANK, churn_ticks=2)
#: each leg's environment, handed to ``ReflowConfig.from_env`` (never
#: ``os.environ``)
CONFIG_ENVS = {
    "a": {"REFLOW_EXECUTOR": "cuda"},
    "b": {"REFLOW_EXECUTOR": "cuda", "REFLOW_LINEAR_FIXPOINT": "0",
          "REFLOW_MAX_LOOP_ITERS": "500"},
    "c": {"REFLOW_EXECUTOR": "sharded",
          "REFLOW_MESH_DEVICES": str(MESH_SHARDS)},
    "d": {"REFLOW_EXECUTOR": "tpu"},
}


def _config_knn_ticks(cfg: Dict[str, int], seed: int) -> List[tuple]:
    """(kind, [(source, batch), ...]) of legs a and c: the queries with
    the preload (a rescan), one insert of fresh docs, one retraction."""
    feed = _knn_feed(cfg, seed)
    groups = (("query insert", ("query insert", "preload")),
              ("insert", ("insert",)), ("retract", ("retract",)))
    return [(kind, [(src, batch) for _, src, batch, k in feed if k in ks])
            for kind, ks in groups]


def _config_knn_run(tag: str, sched, kg, ticks: List[tuple],
                    want: Callable[[str], tuple]) -> Dict[str, object]:
    """The ticks through ``sched``, each timed and its (topk, topk_merge,
    scan_score) launches counted and checked against ``want(kind)``; the
    table after every tick."""
    ms, launches, tables = [], [], []
    for kind, pushes in ticks:
        l0 = _launches()
        t0 = time.perf_counter()
        for src, batch in pushes:
            sched.push(kg.queries if src == "q" else kg.docs, batch)
        sched.tick()
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        got = _since(l0)
        if got != want(kind):
            raise AssertionError(f"{tag} {kind} tick launched (topk, "
                                 f"topk_merge, scan_score) {got}, expected "
                                 f"{want(kind)}")
        launches.append(got)
        tables.append(sched.read_table(kg.index))
    return {"ms": ms, "launches": launches, "tables": tables}


def _config_tables(tag: str, got: List[Dict], want: List[Dict]) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        bad = _table_diff(a, b)
        if bad or len(a) != len(b):
            raise AssertionError(f"{tag}: tick {i}'s table differs from the "
                                 f"twin's at queries {bad[:8]}")


def _total(launches: List[tuple]) -> tuple:
    return tuple(map(sum, zip(NO_LAUNCH, *launches)))


def phase_config(card: str, knn_cfg: Dict[str, int] = CONFIG_KNN,
                 pr_cfg: Dict[str, object] = CONFIG_PR,
                 seed: int = 20) -> Dict[str, object]:
    """Phase 20: each leg's scheduler built only through
    ``ReflowConfig.from_env(CONFIG_ENVS[leg])``, beside a twin built by
    hand. Leg a (``cuda``): config 4's k-NN, its tables bit for bit the
    twin's (``DirtyScheduler(graph, get_executor("cuda"))``) after a
    rescan, an insert and a retraction tick, the launches equal and
    non-zero. Leg b (``cuda``, the fused loop off, 500 passes at most):
    config 3 on the row program, ranks within 1e-3 of the reference.
    Leg c (``sharded``, 4 shards on ``cuda:0``): leg a's rescan and
    insert ticks, bit for bit the twin's. Leg d (``tpu``): refused."""
    from reflow_tpu_torch import ReflowConfig
    from reflow_tpu_torch.parallel.shard import ShardedCudaExecutor

    chunks = knn_cfg["D"] // knn_cfg["scan_chunk"]
    ticks = _config_knn_ticks(knn_cfg, seed)
    configs = {leg: ReflowConfig.from_env(env)
               for leg, env in CONFIG_ENVS.items()}
    for leg in "abc":
        log(f"[config] leg {leg}: {CONFIG_ENVS[leg]} -> {configs[leg]}")
    # the main path's counts: zeroed here, read after leg c; the twin's
    # launches are counted apart, tick by tick
    zero_launches()

    # leg a: the cuda executor beside a twin built by hand
    kg, kg_t = _knn_graph(knn_cfg), _knn_graph(knn_cfg)
    sched = configs["a"].scheduler(kg.graph, device=DEVICE)
    if sched.executor.name != "cuda" or \
            sched.executor.device.type != _device_type():
        raise AssertionError(f"leg a built {sched.executor.name} on "
                             f"{sched.executor.device}")
    a = _config_knn_run("leg a", sched, kg, ticks,
                        lambda kind: _want_launches(kind, chunks))
    del sched
    twin = _config_knn_run("leg a's twin", DirtyScheduler(
        kg_t.graph, _executor()), kg_t, ticks,
        lambda kind: _want_launches(kind, chunks))
    _config_tables("leg a", a["tables"], twin["tables"])
    if _total(a["launches"]) != _total(twin["launches"]) or (
            _on_card() and 0 in _total(a["launches"])):
        raise AssertionError(f"leg a launched {_total(a['launches'])}, the "
                             f"twin {_total(twin['launches'])}")
    log(f"[config] leg a (cuda): ms a tick {[round(x, 3) for x in a['ms']]}"
        f" (query insert + preload, insert, retract), twin "
        f"{[round(x, 3) for x in twin['ms']]}; (topk, topk_merge, "
        f"scan_score) "
        f"{a['launches']}, twin {twin['launches']}; tables bit for bit "
        f"[{card}]")

    # leg b: config 3 on the row program, at most 500 passes a tick
    n, e, churn = pr_cfg["n_nodes"], pr_cfg["n_edges"], pr_cfg["churn"]
    arena = bucket_capacity(e) + 8 * bucket_capacity(2 * int(churn * e) + 2)
    pg = pagerank.build_graph(n, tol=pr_cfg["tol"], arena_capacity=arena)
    web = pagerank.WebGraph.random(n, e, seed=pr_cfg["seed"])
    sched = configs["b"].scheduler(pg.graph, device=DEVICE)
    ex = sched.executor
    if sched.max_loop_iters != 500 or ex.linear_fixpoint is not False:
        raise AssertionError(f"leg b: max_loop_iters {sched.max_loop_iters}"
                             f", linear_fixpoint {ex.linear_fixpoint}")
    l0 = _launches()
    b_ms, passes = [], []
    pushes = [[(pg.teleport, pagerank.teleport_batch(n)),
               (pg.edges, web.initial_batch())]]
    pushes += [[(pg.edges, web.churn(churn))]
               for _ in range(pr_cfg["churn_ticks"])]
    for tick_pushes in pushes:
        t0 = time.perf_counter()
        for src, batch in tick_pushes:
            sched.push(src, batch)
        res = sched.tick()
        _sync()
        b_ms.append((time.perf_counter() - t0) * 1e3)
        passes.append(res.passes)
        if not res.quiesced:
            raise AssertionError(f"leg b tick {res.tick} did not quiesce")
    fused = sum(ex.csr_rebuilds.values())
    prog = type(ex._fx_program).__name__
    if not isinstance(ex._fx_program, FixpointProgram) or fused:
        raise AssertionError(f"leg b ran {prog}, fused-loop CSR rebuilds "
                             f"{fused}")
    if _since(l0) != NO_LAUNCH:
        raise AssertionError(f"leg b launched a top-k kernel: {_since(l0)}")
    err = rank_error(sched, pg, web, n)
    if err["rel_err"] > PAGERANK_MAX_REL_ERR:
        raise AssertionError(f"leg b: relative error {err['rel_err']:.3g}")
    del sched, ex
    log(f"[config] leg b (cuda, REFLOW_LINEAR_FIXPOINT=0, "
        f"REFLOW_MAX_LOOP_ITERS=500): the row program ({prog}), fused-loop "
        f"CSR rebuilds {fused}; ms a tick {[round(x, 3) for x in b_ms]} "
        f"(initial, {pr_cfg['churn_ticks']} churn), passes {passes}; "
        f"max|rank - ref| / max(ref, 1) = {err['rel_err']:.6g} (bound "
        f"{PAGERANK_MAX_REL_ERR:g}); no top-k launch [{card}]")

    # leg c: the sharded executor, 4 shards on cuda:0
    kg_c = _knn_graph(knn_cfg)
    sched = configs["c"].scheduler(
        kg_c.graph, device="cuda:0" if _on_card() else DEVICE)
    ex = sched.executor
    if not isinstance(ex, ShardedCudaExecutor) or ex.n != MESH_SHARDS or \
            any(d.type != _device_type() for d in ex.mesh.device_list):
        raise AssertionError(f"leg c built {type(ex).__name__} on "
                             f"{ex.mesh.device_list}")
    c = _config_knn_run("leg c", sched, kg_c, ticks[:2],
                        lambda kind: _mesh_want(kind, chunks, MESH_SHARDS))
    on = ex.mesh.device_list[0]
    del sched, ex
    _config_tables("leg c", c["tables"], twin["tables"][:2])
    log(f"[config] leg c (sharded, {MESH_SHARDS} shards on {on}): ms a "
        f"tick {[round(x, 3) for x in c['ms']]} (query insert + preload, "
        f"insert), twin {[round(x, 3) for x in twin['ms'][:2]]}; "
        f"(topk, topk_merge, scan_score) {c['launches']}; tables bit for "
        f"bit [{card}]")

    # leg d: the JAX package's executor name
    try:
        configs["d"].make_executor(device=DEVICE)
    except ValueError as err_d:
        log(f"[config] leg d (REFLOW_EXECUTOR=tpu) refused: {err_d}")
    else:
        raise AssertionError("leg d: REFLOW_EXECUTOR=tpu was not refused")
    launches = _total(a["launches"] + c["launches"])
    twin_l = _total(twin["launches"])
    if tuple(_plus(launches, twin_l)) != _launches():
        raise AssertionError(f"phase 20's launches {launches} and the "
                             f"twin's {twin_l} do not sum to the counts "
                             f"{_launches()}")
    return {"launches": launches, "a": a, "b_ms": b_ms, "c": c,
            "twin_ms": twin["ms"], "passes": passes, "rel_err": err["rel_err"]}


def _rank_nid(tables: Dict[str, np.ndarray], tag: str, r: int) -> str:
    return next(k.split("/")[2] for k in tables
                if k.startswith(f"{tag}/r{r}/") and k.endswith("/emitted"))


def multihost_nccl() -> int:
    """``python3 chip_smoke.py --multihost-nccl`` on a machine with
    several cards: phase 19's leg B in an nccl group, a process a card
    (not part of the default run, which has one card)."""
    dev = phase_device()
    phase_build()
    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError(f"--multihost-nccl needs 2+ cards, has {cards}")
    t0 = time.perf_counter()
    phase_multihost(dev["card"], dict(backend="nccl", nproc=cards))
    log(f"[time] leg B over nccl {time.perf_counter() - t0:.1f} s")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--lockcheck-child"]:
        return lockcheck_child(sys.argv[2:])
    if sys.argv[1:2] == ["--multihost-nccl"]:
        return multihost_nccl()
    t_start = time.perf_counter()
    spent: Dict[str, float] = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[fn.__name__] = time.perf_counter() - t0
        return out

    dev = timed(phase_device)
    card = dev["card"]
    timed(phase_build)
    recs = timed(phase_kernels, "cuda")
    serve = timed(phase_serve, card)
    # the other paths run no hand-written kernel: their counts stay 0
    zero_launches()
    for phase in (phase_pagerank, phase_fused, phase_row_leg,
                  phase_defer_leg, phase_wordcount, phase_tfidf, phase_sssp,
                  phase_multiset, phase_image_embed, phase_window_parity):
        timed(phase, card)
    if (topk_mod.TOPK_LAUNCHES or topk_mod.TOPK_MERGE_LAUNCHES
            or topk_mod.SCAN_SCORE_LAUNCHES):
        raise AssertionError("a phase after the serving slice launched a "
                             "hand-written kernel")
    # phases 13-16 zero the counts themselves, just before their paths
    durable = timed(phase_durable, card)
    replica = timed(phase_replication, card)
    tier = timed(phase_tier, card)
    fleet = timed(phase_fleet, card)
    lockcheck = timed(phase_lockcheck, card)
    mesh = timed(phase_mesh, card)
    timed(phase_model_axis, card)
    multihost = timed(phase_multihost, card)
    config = timed(phase_config, card)
    log(f"[tier] ship lag, ms from the ack to the follower's horizon "
        f"(insert ticks, median): over TCP {tier['lag_ms']:.3f} (phase 15),"
        f" in process {replica['lag_ms_r0']:.3f} (phase 14, r0) [{card}]")
    log("[time] s a phase: " + ", ".join(
        f"{name[len('phase_'):]} {s:.1f}" for name, s in spent.items())
        + f"; all phases {time.perf_counter() - t_start:.1f} s [{card}]")
    for i, rec in enumerate(recs):
        by_path = {"serve": serve[("total_launches", "total_merge_launches",
                                   "total_scan_launches")[i]],
                   "durable": durable["launches"][i],
                   "replica_leader": replica["leader"][i],
                   "replica": replica["replica"][i],
                   "tier": tier["tier"][i],
                   "tier_replica": tier["tier_replica"][i],
                   "subs_leader": fleet["subs_leader"][i],
                   "subs_replica": fleet["subs_replica"][i],
                   "lockcheck": lockcheck["launches"][i],
                   "mesh_knn": mesh["launches"][i],
                   "multihost_knn": sum(s["launches"][i]
                                        for s in multihost["b2"]),
                   "multihost_window_knn": multihost["bw"]["launches"][i],
                   "config": config["launches"][i]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    # every k-NN corpus is int8: each path scores every chunk it merges
    if recs[2]["launches_by_path"] != recs[1]["launches_by_path"]:
        raise AssertionError(
            f"scan_score launches by path {recs[2]['launches_by_path']} "
            f"!= topk_merge's {recs[1]['launches_by_path']}")
    print(json.dumps({"kernels": recs}), flush=True)
    print(f"card: {dev['card']}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
