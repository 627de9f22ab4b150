#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``reflow_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing its own lines:

1. **Device** — the card's name and power limit; TF32 off for matmul and
   cuDNN (the port's float32 scoring must stay float32).
2. **Build** — ``reflow_tpu_torch/csrc/topk.cu`` compiled by ``nvcc``
   for ``sm_90a`` into the git-ignored ``reflow_tpu_torch/_build/``.
3. **Kernels vs their plain versions** — each kernel's wrapper on card
   tensors at the shapes the main path gives it (and at edge shapes),
   held to exact equality with the plain PyTorch version; device times
   (from a ``torch.profiler`` trace) of the kernel, the plain version and
   the one-call library yardstick, beside their CUDA-event times.
4. **Serving slice at full width** — the k-NN re-index workload
   (BASELINE.md config 4: 256 queries, a 2^20-id corpus of 768-dim int8
   embeddings, k = 16, scan chunk 8192) served through
   ``IngestFrontend`` -> ``DirtyScheduler`` -> the ``cuda`` executor:
   queries, a device-made corpus preload, then host insert batches
   (incremental ticks), a retraction batch and a query update (full
   rescans), every ticket ``applied``; the table is checked against a
   brute-force top-k over the same corpus, and the kernel launch counts
   (zeroed just before the path, read just after) prove the path ran
   through the kernel.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.autograd import DeviceType

from reflow_tpu_torch import DeltaBatch, DirtyScheduler, get_executor
from reflow_tpu_torch.executors.device_delta import DeviceDelta
from reflow_tpu_torch.kernels import _build
from reflow_tpu_torch.kernels import topk as topk_mod
from reflow_tpu_torch.kernels.topk import NEG, scores, topk, topk_plain
from reflow_tpu_torch.serve import APPLIED, CoalesceWindow, IngestFrontend
from reflow_tpu_torch.workloads import knn

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
            insert_ticks=5, retract=1024, query_update=16)

#: the main-path shape of the top-k kernel: Q rows of k + scan_chunk
#: candidates (insert tick: k + 8192 delta docs; rescan: k + one chunk)
MAIN_Q, MAIN_N, MAIN_K = 256, 16 + 8192, 16


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


def device_ms(fn: Callable[[], object], iters: int,
              warmup: int = 5) -> float:
    """Mean milliseconds of device work per call: the summed durations of
    every kernel, copy and fill the card ran during ``iters`` calls, from
    a ``torch.profiler`` trace (host launch costs excluded). NaN when the
    trace holds no device activity."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else float("nan")


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
    ]


def phase_kernels(device) -> Dict[str, object]:
    """Hold the top-k kernel to its plain version, exactly, on every
    case; time the kernel, the plain version and ``torch.topk`` at the
    main-path shape."""
    max_err = 0.0
    for label, s, k in topk_cases(device):
        v, i = topk(s, k)
        pv, pi = topk_plain(s, k)
        torch.cuda.synchronize()
        if v.shape != (s.shape[0], k) or i.dtype != torch.int32:
            raise AssertionError(f"{label}: kernel output {tuple(v.shape)} "
                                 f"{i.dtype}")
        if not (torch.equal(v, pv) and torch.equal(i, pi)):
            bad = (v != pv) | (i != pi)
            raise AssertionError(
                f"{label}: kernel != plain at {int(bad.sum())} of "
                f"{bad.numel()} entries")
        if int(i.min()) < 0 or int(i.max()) >= s.shape[1]:
            raise AssertionError(f"{label}: id out of [0, N)")
        max_err = max(max_err, float((v - pv).abs().max()))
        log(f"[kernels] topk {label}: kernel == plain (values and ids "
            f"exact)")
    s = torch.randn((MAIN_Q, MAIN_N),
                    generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    calls = {"kernel": lambda: topk(s, MAIN_K),
             "plain": lambda: topk_plain(s, MAIN_K),
             "library": lambda: torch.topk(s, MAIN_K, dim=1)}
    ev = {name: time_ms(fn, iters=100) for name, fn in calls.items()}
    dev = {name: device_ms(fn, iters=20) for name, fn in calls.items()}
    log(f"[kernels] topk device time (profiler) kernel {dev['kernel']:.5f} "
        f"ms, plain {dev['plain']:.5f} ms, torch.topk {dev['library']:.5f} "
        f"ms; CUDA-event time per back-to-back call kernel "
        f"{ev['kernel']:.5f} ms, plain {ev['plain']:.5f} ms, torch.topk "
        f"{ev['library']:.5f} ms")
    traced = all(v == v for v in dev.values())
    if not traced:
        log("[kernels] the profiler trace held no device time; the "
            "record's times are CUDA-event times")
    t = dev if traced else ev
    ms, plain_ms, lib_ms = t["kernel"], t["plain"], t["library"]
    nbytes = MAIN_Q * MAIN_N * 4 + MAIN_Q * MAIN_K * (4 + 4)
    ops = MAIN_Q * MAIN_N                 # one comparison per candidate
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    rec = {"name": "topk", "route": "cuda",
           "source": "reflow_tpu_torch/csrc/topk.cu",
           "replaces": "reflow_tpu/kernels/topk.py:64",
           "launches": None, "max_abs_err": max_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": lib_ms}
    log(f"[kernels] topk [{MAIN_Q}, {MAIN_N}] k={MAIN_K} "
        f"({'profiler' if traced else 'CUDA events'}): kernel "
        f"{ms:.5f} ms, plain (stable sort) {plain_ms:.5f} ms, torch.topk "
        f"{lib_ms:.5f} ms, bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}: {nbytes} B)")
    return rec


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

    def tick(kind: str, source, batch) -> float:
        """One batch through submit, flushed and applied; returns the
        wall seconds from submit to the device finishing."""
        l0 = topk_mod.TOPK_LAUNCHES
        t0 = time.perf_counter()
        t = fe.submit(source, batch)
        fe.flush()
        res = t.result(timeout=600)
        sync()
        wall = time.perf_counter() - t0
        if res.status != APPLIED:
            raise AssertionError(f"{kind} ticket {res.status}: {res}")
        tickets.append(res)
        launches.append((kind, topk_mod.TOPK_LAUNCHES - l0))
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
        fe.flush()
        table = sched.read_table(kg.index)
    finally:
        fe.close()
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
            "tickets": len(tickets), "recall": recall,
            "score_max_abs_diff": score_diff,
            "forced_syncs": sched.forced_syncs, "peak_bytes": peak,
            "live_docs": int(st["dlive"].sum())}


def phase_serve(card: str) -> Dict[str, object]:
    torch.cuda.reset_peak_memory_stats()
    topk_mod.TOPK_LAUNCHES = 0             # counts of the main path only
    out = serve_slice(FULL, "cuda")
    total = topk_mod.TOPK_LAUNCHES
    mem = out["peak_bytes"]
    chunks = FULL["D"] // FULL["scan_chunk"]
    for kind, n in out["launches"]:
        need = chunks if kind in ("retract", "query update",
                                  "query insert") else 1
        if n < need:
            raise AssertionError(f"{kind} tick launched the top-k kernel "
                                 f"{n} times, expected >= {need}")
    if out["recall"] < 0.99 or out["score_max_abs_diff"] > 1e-2:
        raise AssertionError(
            f"table vs brute force: recall {out['recall']:.4f} (need "
            f">= 0.99), score max_abs_diff {out['score_max_abs_diff']:.3g} "
            f"(need <= 1e-2)")
    ins = sorted(out["insert_s"])
    med = ins[len(ins) // 2]
    dops = sum(out["insert_ops"]) / sum(out["insert_s"])
    log(f"[serve] {out['tickets']} tickets applied; {out['live_docs']} live "
        f"docs; top-k launches per tick "
        f"{[n for _, n in out['launches']]} (total {total})")
    log(f"[serve] check vs brute force: recall {out['recall']:.6f}, score "
        f"max_abs_diff {out['score_max_abs_diff']:.6g}")
    log(f"[serve] insert tick (8192 int8 docs, incremental) median "
        f"{med * 1e3:.3f} ms of {[round(s * 1e3, 3) for s in out['insert_s']]}"
        f"; rescan tick (retract {FULL['retract']}) "
        f"{out['rescan_s'] * 1e3:.3f} ms; query-update rescan "
        f"{out['query_update_s'] * 1e3:.3f} ms; delta-ops/s {dops:.1f}; "
        f"peak device memory {mem} B; forced syncs {out['forced_syncs']} "
        f"[{card}]")
    out.update(total_launches=total, insert_median_s=med,
               delta_ops_per_s=dops)
    return out


def main() -> int:
    dev = phase_device()
    phase_build()
    rec = phase_kernels("cuda")
    serve = phase_serve(dev["card"])
    rec["launches"] = serve["total_launches"]
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(f"card: {dev['card']}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
