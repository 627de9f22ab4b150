#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``reflow_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing its own lines:

1. **Device** — the card's name and power limit; TF32 off for matmul and
   cuDNN (the port's float32 scoring must stay float32).
2. **Build** — ``reflow_tpu_torch/csrc/topk.cu`` compiled by ``nvcc``
   for ``sm_90a`` into the git-ignored ``reflow_tpu_torch/_build/``.
3. **Kernels vs their plain versions** — each kernel entry's wrapper
   (``topk``, and the scan step ``topk_merge``) on card tensors at the
   shapes the main path gives it (and at edge shapes), held to exact
   equality with the plain PyTorch version; device times (from a
   ``torch.profiler`` trace) and CUDA-event times of each entry, warm
   (back to back, input in L2) and cold (L2 flushed by a 64 MB write
   between calls, the flush left out of both), beside the plain
   version's and the one-call library yardstick's.
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
   per incremental tick, one ``topk_merge`` per corpus chunk of a rescan
   tick. The frontend runs at its default depth 2 with device-keyed
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

Phases 5-12 run no hand-written kernel; the top-k counts, zeroed before
them, must stay 0. Phases 13 and 14 zero them again and count their own
paths' launches apart from their twins'.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

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
from typing import Callable, Dict, FrozenSet, List, Set

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
from reflow_tpu_torch.kernels.topk import (NEG, scores, topk, topk_merge,
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

#: H100 SXM peaks (NVIDIA's data sheet): memory rate and float32 outside
#: the tensor cores, for the kernels' least-time bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    """Compile the top-k kernel; returns the wall seconds."""
    t0 = time.perf_counter()
    path = _build.build("topk")
    secs = time.perf_counter() - t0
    log(f"[build] topk.cu -> {path.name} in {secs:.2f} s")
    return secs


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


def _bound(nbytes: int, ops: int) -> tuple:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def _times_line(name: str, t: Dict[str, float]) -> str:
    return (f"{name}: warm device {t['warm_dev']:.5f} ms, warm events "
            f"{t['warm_ev']:.5f} ms, cold device {t['cold_dev']:.5f} ms, "
            f"cold events {t['cold_ev']:.5f} ms")


def phase_kernels(device) -> List[Dict[str, object]]:
    """Hold both top-k entries to their plain versions, exactly, on every
    case; time each entry warm and cold at its main-path shape beside
    the plain version and (for ``topk``) ``torch.topk``. Returns the two
    kernel records."""
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
        l0 = (topk_mod.TOPK_LAUNCHES, topk_mod.TOPK_MERGE_LAUNCHES)
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
                         topk_mod.TOPK_MERGE_LAUNCHES - l0[1]))
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

    # brute force over the same device tables, plain torch
    st = ex.states[kg.index.id]
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
    recall = hits / (Q * k)
    score_diff = float(np.abs(got[:, :, 1] - bvals_h).max())
    return {"preload_s": preload_s, "insert_s": insert_s,
            "insert_ops": insert_ops, "rescan_s": rescan_s,
            "query_update_s": qupdate_s, "launches": launches,
            "window": window,
            "traces": traces,
            "tickets": len(tickets), "recall": recall,
            "score_max_abs_diff": score_diff,
            "forced_syncs": sched.forced_syncs, "peak_bytes": peak,
            "live_docs": int(st["dlive"].sum())}


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
    device-busy share and, on a rescan tick, the check that no cat,
    where or gather is issued once per corpus chunk."""
    rep = trace_report(kind, wall_s, prof, card,
                       PER_CHUNK_FORBIDDEN + ("aten::matmul",))
    dev, merged, span_us = rep["dev"], rep["merged"], rep["span_us"]
    counts = rep["counts"]
    if counts["aten::matmul"] == 0:
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
    if kind == "retract" and counts:
        per_chunk = [op for op in PER_CHUNK_FORBIDDEN
                     if counts[op] >= chunks]
        if per_chunk or counts["aten::matmul"] < chunks:
            raise AssertionError(
                f"rescan tick trace: {counts} over {chunks} chunks "
                f"({per_chunk} issued once per chunk)")
    return rep


def phase_serve(card: str) -> Dict[str, object]:
    torch.cuda.reset_peak_memory_stats()
    # counts of the main path only
    topk_mod.TOPK_LAUNCHES = topk_mod.TOPK_MERGE_LAUNCHES = 0
    out = serve_slice(FULL, "cuda")
    total = topk_mod.TOPK_LAUNCHES
    total_merge = topk_mod.TOPK_MERGE_LAUNCHES
    mem = out["peak_bytes"]
    chunks = FULL["D"] // FULL["scan_chunk"]
    for kind, n, nm in out["launches"]:
        rescan = kind in ("retract", "query update", "query insert")
        want = (0, chunks) if rescan else (1, 0)
        if (n, nm) != want:
            raise AssertionError(
                f"{kind} tick launched topk {n} and topk_merge {nm} times, "
                f"expected {want[0]} and {want[1]}")
    if out["recall"] < 0.99 or out["score_max_abs_diff"] > 1e-2:
        raise AssertionError(
            f"table vs brute force: recall {out['recall']:.4f} (need "
            f">= 0.99), score max_abs_diff {out['score_max_abs_diff']:.3g} "
            f"(need <= 1e-2)")
    win = out["window"]
    kinds = [kind for kind, _, _ in out["launches"]]
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
        f"docs; (topk, topk_merge) launches per tick "
        f"{[(n, nm) for _, n, nm in out['launches']]} (totals {total}, "
        f"{total_merge})")
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
               insert_median_s=med, delta_ops_per_s=dops)
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


def _launches() -> tuple:
    return topk_mod.TOPK_LAUNCHES, topk_mod.TOPK_MERGE_LAUNCHES


def _since(l0: tuple) -> tuple:
    l1 = _launches()
    return l1[0] - l0[0], l1[1] - l0[1]


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
    """(topk, topk_merge) launches of one k-NN tick: a rescan merges once
    a corpus chunk, an incremental tick runs one top-k."""
    rescan = kind in ("retract", "query update", "query insert")
    return (0, chunks) if rescan else (1, 0)


def _knn_graph(cfg: Dict[str, int], sink: bool = False):
    """Config 4's k-NN graph (bf16 queries, int8 corpus); ``sink`` adds a
    sink ``nn`` on the index, the view the read tier serves."""
    kg = knn.build_graph(cfg["Q"], cfg["D"], cfg["dim"], cfg["k"],
                         scan_chunk=cfg["scan_chunk"], dtype=torch.bfloat16,
                         doc_dtype=torch.int8, precision="default")
    if sink:
        kg.graph.sink(kg.index, "nn")
    return kg


def _knn_frontend(sched, cfg: Dict[str, int]) -> IngestFrontend:
    return IngestFrontend(sched, depth=2, admission="device",
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


def durable_knn(card: str, fs: str, tmp: str) -> Dict[str, object]:
    """Config 4 served durably at full width beside a non-durable twin,
    killed inside the last window, recovered and resent."""
    cfg = FULL
    Q, D, dim, k = cfg["Q"], cfg["D"], cfg["dim"], cfg["k"]
    chunks = D // cfg["scan_chunk"]
    feed = _knn_feed(cfg, seed=13)
    n_head = 1 + cfg["preload_chunks"]
    wal_dir = os.path.join(tmp, "knn-wal")
    ckpt_dir = os.path.join(tmp, "knn-ckpt")

    def graph():
        return _knn_graph(cfg)

    def frontend(sched):
        return _knn_frontend(sched, cfg)

    def submit(fe, kg, item):
        bid, src, batch, _kind = item
        l0 = _launches()
        t0 = time.perf_counter()
        ticket = fe.submit(kg.queries if src == "q" else kg.docs, batch,
                           batch_id=bid)
        fe.flush(timeout=600)
        res = ticket.result(timeout=600)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, _since(l0)

    kt, kd = graph(), graph()
    twin = DirtyScheduler(kt.graph, get_executor("cuda"))
    crash = CrashInjector(1 << 62, only="after_append")
    dur = DurableScheduler(kd.graph, get_executor("cuda"), wal_dir=wal_dir,
                           fsync="tick", committer="thread", crash=crash)
    fe_t, fe_d = frontend(twin), frontend(dur)
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
    sched2 = DurableScheduler(k2.graph, get_executor("cuda"),
                              wal_dir=wal_dir, fsync="tick",
                              committer="thread")
    l0 = _launches()
    rep = recover(sched2, wal_dir, ckpt_dir)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    replay_launches = _since(l0)
    pending = sum(len(v) for v in sched2._pending.values())
    l0 = _launches()
    t1 = time.perf_counter()
    sched2.tick()       # the logged, undispatched last window
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    first_launches = _since(l0)
    fe2 = frontend(sched2)
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
            or killed_launches != (0, 0) or resend_launches != (0, 0)):
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
    st = sched2.executor.states[k2.index.id]
    full = scores(st["qvec"], st["dvec"])
    full = torch.where(st["dlive"][None, :], full, NEG)
    bvals, bids = topk_plain(full, k)
    del full
    got = np.stack([table[q] for q in range(Q)])
    bids_h, bvals_h = bids.cpu().numpy(), bvals.cpu().numpy()
    recall = sum(len(set(got[q, :, 0].astype(np.int64)) & set(bids_h[q]))
                 for q in range(Q)) / (Q * k)
    score_diff = float(np.abs(got[:, :, 1] - bvals_h).max())
    if recall < 0.99 or score_diff > 1e-2:
        raise AssertionError(f"recovered table vs brute force: recall "
                             f"{recall:.4f}, score max_abs_diff "
                             f"{score_diff:.3g}")

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
        f"cursor: {dict(statuses)}; (topk, topk_merge) launches: live "
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
        topk_mod.TOPK_LAUNCHES = topk_mod.TOPK_MERGE_LAUNCHES = 0
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
    """(topk, topk_merge) launches made so far on one host thread."""
    return tuple(topk_mod.LAUNCHES_BY_THREAD.get(ident, (0, 0)))


def _since_on(ident: int, l0: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_on_thread(ident), l0))


class _Counted:
    """A replica as the shipper, the read tier and the coordinator see it:
    every call passes through to it. The top-k launches made on the
    calling thread inside ``receive`` (the replay of shipped windows)
    and the first ``promote`` (the new leader's recovery) are added up
    here, apart from the leader's on its pump thread; a receive that
    published a new horizon is timed to its synchronize."""

    def __init__(self, inner, replay=(0, 0)):
        self.inner = inner
        self.name = inner.name
        self.replay = list(replay)
        self.apply_s: List[tuple] = []
        #: (start, end, payload bytes) of every receive, host clock
        self.rx: List[tuple] = []
        self.shipped = 0
        self.promote_s = None
        self.promote_t0 = None
        self.promote_launches = (0, 0)
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
            torch.cuda.synchronize()
            self.apply_s.append((time.perf_counter() - t0, h1 - h0))
        d = _since_on(me, l0)
        self.replay = [self.replay[0] + d[0], self.replay[1] + d[1]]
        self.rx.append((t0, time.perf_counter(), len(sh.payload)))
        if isinstance(resp, ShipAck):
            self.shipped += len(sh.payload)
        return resp

    def promote(self, **kw):
        me = threading.get_ident()
        first = self.promote_s is None
        l0, t0 = _on_thread(me), time.perf_counter()
        sched = self.inner.promote(**kw)
        torch.cuda.synchronize()
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
    leader = DurableScheduler(kd.graph, get_executor("cuda"),
                              wal_dir=wal_dir, fsync="tick",
                              committer="thread")
    twin = DirtyScheduler(kt.graph, get_executor("cuda"))
    fe, fe_t = _knn_frontend(leader, cfg), _knn_frontend(twin, cfg)
    ship = SegmentShipper(leader.wal, ckpt_dir=ckpt_dir,
                          leader_tick=lambda: leader._tick)
    r0 = _Counted(ReplicaScheduler(graphs["r0"].graph,
                                   os.path.join(tmp, "r0"),
                                   executor=get_executor("cuda"), name="r0"))
    ship.attach(r0)
    if r0.bootstraps:
        raise AssertionError("r0 bootstrapped: no checkpoint existed yet")
    followers = [r0]
    counts = {"leader": [0, 0], "twin": [0, 0], "restart": (0, 0),
              "recover": (0, 0), "new_leader": [0, 0]}

    def add(key, d):
        counts[key] = [counts[key][0] + d[0], counts[key][1] + d[1]]

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
        torch.cuda.synchronize()
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
        torch.cuda.synchronize()
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
                                       executor=get_executor("cuda"),
                                       name="r1"))
        l0 = _launches()
        t0 = time.perf_counter()
        ship.attach(r1)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        if _since(l0) != (0, 0) or r1.bootstraps != 1 \
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
                                     executor=get_executor("cuda"), name="r0")
            torch.cuda.synchronize()
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
            if old_replay != (counts["leader"][0], counts["leader"][1]):
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
        rc = DirtyScheduler(gc_.graph, get_executor("cuda"))
        l0 = _on_thread(main)
        t0 = time.perf_counter()
        rep = recover(rc, wal_dir, ckpt_dir)
        torch.cuda.synchronize()
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
        torch.cuda.synchronize()
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
        torch.cuda.synchronize()
        fail_s = time.perf_counter() - t0
        win = coord.winner
        fail_drain_s = win.promote_t0 - t0
        survivor = r1 if win is r0 else r0
        if new.wal.epoch != 1 or type(new.executor).__name__ \
                != "CudaExecutor" or new.executor.device.type != "cuda" \
                or new.executor is win.inner.sched.executor:
            raise AssertionError(f"the promoted leader: epoch "
                                 f"{new.wal.epoch}, executor "
                                 f"{type(new.executor).__name__} on "
                                 f"{getattr(new.executor, 'device', '?')}")
        if _since_on(main, l0) != win.promote_launches:
            raise AssertionError("launches outside the promotion's "
                                 "recovery during the failover")
        fe2 = _knn_frontend(new, cfg)
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
                torch.cuda.synchronize()
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

    replica = [counts["restart"][0] + counts["recover"][0]
               + win.promote_launches[0] + counts["new_leader"][0],
               counts["restart"][1] + counts["recover"][1]
               + win.promote_launches[1] + counts["new_leader"][1]]
    for p in (r1, r0):
        replica = [replica[0] + p.replay[0], replica[1] + p.replay[1]]
    replica = [replica[0] + old_replay[0], replica[1] + old_replay[1]]
    if not replica[0] or not replica[1]:
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
    log(f"[replica] (topk, topk_merge) launches: leader {counts['leader']}"
        f", r0 replay {list(old_replay)} (== the leader's), r1 replay "
        f"{r1.replay}, r0 after its restart {r0.replay}, r0's restart "
        f"{list(counts['restart'])}, recovery from the compacted log "
        f"{list(counts['recover'])}, the promotion's recovery "
        f"{list(win.promote_launches)}, the promoted leader's ticks "
        f"{counts['new_leader']}; twin {counts['twin']}")
    return {"leader": counts["leader"], "replica": replica,
            "twin": counts["twin"]}


def phase_replication(card: str) -> Dict[str, object]:
    """Replication at full width (``replicate_knn``); the top-k counts
    zeroed just before its path, and every launch since told apart: the
    leader's, the replica path's and the twin's."""
    tmp = tempfile.mkdtemp()
    try:
        fs = fs_line(tmp)
        log(f"[replica] WAL, mirrors and checkpoints under a temp dir: {fs}")
        topk_mod.TOPK_LAUNCHES = topk_mod.TOPK_MERGE_LAUNCHES = 0
        topk_mod.LAUNCHES_BY_THREAD.clear()
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


def main() -> int:
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
    topk_mod.TOPK_LAUNCHES = topk_mod.TOPK_MERGE_LAUNCHES = 0
    for phase in (phase_pagerank, phase_fused, phase_row_leg,
                  phase_defer_leg, phase_wordcount, phase_tfidf, phase_sssp,
                  phase_multiset, phase_image_embed, phase_window_parity):
        timed(phase, card)
    if topk_mod.TOPK_LAUNCHES or topk_mod.TOPK_MERGE_LAUNCHES:
        raise AssertionError("a phase after the serving slice launched a "
                             "top-k kernel")
    # phases 13 and 14 zero the counts themselves, just before their paths
    durable = timed(phase_durable, card)
    replica = timed(phase_replication, card)
    log("[time] s a phase: " + ", ".join(
        f"{name[len('phase_'):]} {s:.1f}" for name, s in spent.items())
        + f"; all phases {time.perf_counter() - t_start:.1f} s [{card}]")
    for i, rec in enumerate(recs):
        by_path = {"serve": serve["total_launches" if rec["name"] == "topk"
                                  else "total_merge_launches"],
                   "durable": durable["launches"][i],
                   "replica_leader": replica["leader"][i],
                   "replica": replica["replica"][i]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    print(json.dumps({"kernels": recs}), flush=True)
    print(f"card: {dev['card']}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
