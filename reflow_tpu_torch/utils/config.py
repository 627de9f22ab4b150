"""The knob registry: every ``REFLOW_*`` environment variable the port
reads is :func:`declare`-d here once, with its type, default and a
one-line docstring, and read through the typed accessors
(:func:`env_flag` / :func:`env_int` / :func:`env_float` /
:func:`env_str`). An accessor read of an undeclared name raises
:class:`KeyError`, so a typo'd name fails loudly instead of silently
reading its default. Discovery: ``python -c "from
reflow_tpu_torch.utils.config import knob_table; print(knob_table())"``.

Only the knobs the ported modules read are declared; their names and
defaults are the JAX package's, so one environment drives both, with
one exception: ``REFLOW_EXECUTOR`` defaults to ``"cuda"`` (the JAX
package's to ``"cpu"``), because the port's entry points run on the card
unless the caller asks for the CPU.

:class:`ReflowConfig` is the executor and scheduler choice read from
these knobs: ``ReflowConfig.from_env().scheduler(graph)``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

__all__ = ["Knob", "KNOBS", "ReflowConfig", "declare", "env_flag",
           "env_float", "env_int", "env_str", "knob_table"]


# -- knob registry ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared environment knob: its type tag (``flag`` / ``int``
    / ``float`` / ``str``), documented default, and one-line doc."""

    name: str
    kind: str
    default: object
    doc: str


#: name -> Knob for every REFLOW_* variable the project reads
KNOBS: Dict[str, Knob] = {}

_KINDS = ("flag", "int", "float", "str")
_UNSET = object()


def declare(name: str, kind: str, default, doc: str) -> str:
    """Register one knob (module import time). Idempotent re-declares
    with identical fields are allowed (reload safety); a conflicting
    re-declare raises."""
    if kind not in _KINDS:
        raise ValueError(f"knob kind {kind!r} not in {_KINDS}")
    if not name.startswith("REFLOW_"):
        raise ValueError(f"knob {name!r} must start with REFLOW_")
    prev = KNOBS.get(name)
    k = Knob(name, kind, default, doc)
    if prev is not None and prev != k:
        raise ValueError(f"knob {name!r} re-declared with different "
                         f"fields: {prev} vs {k}")
    KNOBS[name] = k
    return name


def _raw(name: str, env) -> Optional[str]:
    if name not in KNOBS:
        raise KeyError(
            f"{name!r} is not a declared knob; declare() it in "
            f"reflow_tpu_torch/utils/config.py")
    v = (os.environ if env is None else env).get(name)
    return None if v is None or v == "" else v


def env_flag(name: str, default=_UNSET, *, env=None) -> bool:
    """Boolean knob: unset/empty -> default; else any value but "0" is
    True (so ``REFLOW_X=1`` enables, ``REFLOW_X=0`` disables)."""
    v = _raw(name, env)
    if v is None:
        d = KNOBS[name].default if default is _UNSET else default
        return bool(d)
    return v != "0"


def env_int(name: str, default=_UNSET, *, env=None) -> Optional[int]:
    v = _raw(name, env)
    if v is None:
        d = KNOBS[name].default if default is _UNSET else default
        return None if d is None else int(d)
    return int(v)


def env_float(name: str, default=_UNSET, *, env=None) -> Optional[float]:
    v = _raw(name, env)
    if v is None:
        d = KNOBS[name].default if default is _UNSET else default
        return None if d is None else float(d)
    return float(v)


def env_str(name: str, default=_UNSET, *, env=None) -> Optional[str]:
    v = _raw(name, env)
    if v is None:
        d = KNOBS[name].default if default is _UNSET else default
        return None if d is None else str(d)
    return v


def knob_table() -> str:
    """The knob catalog as a markdown table."""
    rows = ["| knob | type | default | what it does |",
            "|---|---|---|---|"]
    for k in sorted(KNOBS.values(), key=lambda k: k.name):
        rows.append(f"| `{k.name}` | {k.kind} | `{k.default}` | "
                    f"{k.doc} |")
    return "\n".join(rows)


# -- core runtime knobs -----------------------------------------------------

declare("REFLOW_EXECUTOR", "str", "cuda",
        "executor registry name: cpu (the NumPy oracle) / cuda / sharded "
        "/ staged")
declare("REFLOW_MAX_LOOP_ITERS", "int", 10_000,
        "fixpoint pass bound per tick (DirtyScheduler.max_loop_iters)")
declare("REFLOW_DEDUP_WINDOW", "int", 1 << 20,
        "idempotent-push dedup horizon (batch ids remembered)")
declare("REFLOW_MESH_DEVICES", "int", None,
        "mesh size for the sharded executor (unset = all local devices)")
declare("REFLOW_LINEAR_FIXPOINT", "flag", True,
        "fused delta-vector loop on cuda/sharded executors (0 disables)")

# -- the knobs the port reads -----------------------------------------------

declare("REFLOW_TRACE", "flag", False,
        "enable per-ticket trace spans at import time (obs.enable())")
declare("REFLOW_TRACE_RING", "int", 65536,
        "per-thread trace ring-buffer capacity (spans)")
declare("REFLOW_TRACE_SAMPLE", "int", 16,
        "ticket sampling stride: 1-in-N tickets get a span timeline")
declare("REFLOW_WINDOW_DEPTH", "int", 2,
        "pipelined window depth (1 = serial stage->dispatch->retire)")
declare("REFLOW_MEGATICK_WASTE", "float", 0.5,
        "max padded-slot fraction before a fused window falls back")
declare("REFLOW_MEGATICK_MAX_ROWS", "int", 1 << 16,
        "max rows per fused mega-tick window before fallback")
declare("REFLOW_LOCKCHECK", "flag", False,
        "wrap named locks with the runtime lock-order detector; a "
        "held-before cycle raises LockOrderError")
declare("REFLOW_CKPT_DELTA_EVERY", "int", 8,
        "CheckpointChain cadence: every Nth save is promoted to a full "
        "checkpoint; the saves between are cheap delta elements "
        "(1 = every save full, i.e. deltas disabled)")
declare("REFLOW_TILE_BYTES", "int", 0,
        "key-range tile budget (bytes) for O(state) maintenance: "
        "checkpoint elements, compaction folds and replica snapshots "
        "process one tile of roughly this many resident bytes at a time; "
        "the shipper sends a checkpoint file by file. 0 (default) "
        "disables tiling")
declare("REFLOW_TILE_SHIP_RETRIES", "int", 3,
        "per-tile resend attempts when a bootstrap tile unit is NACKed "
        "(CRC mismatch on the follower) before the shipper falls back "
        "to a whole-checkpoint bootstrap")
declare("REFLOW_COMPACT_INTERVAL_S", "float", 2.0,
        "background WAL compactor pass period (seconds)")
declare("REFLOW_COMPACT_MIN_SEGMENTS", "int", 3,
        "minimum eligible sealed segments before a compaction pass "
        "rewrites (smaller ranges are not worth the fold)")
declare("REFLOW_COMPACT_KEEP_SEGMENTS", "int", 1,
        "newest sealed segments a compaction pass leaves untouched "
        "(headroom between the fold and the committer's write head)")
declare("REFLOW_FLEET_NODE", "str", None,
        "this process's node id in causality tokens and flight-recorder "
        "headers (default node-<pid>)")
declare("REFLOW_FLIGHT_BYTES", "int", 1 << 20,
        "flight recorder on-disk budget in bytes, split across two "
        "alternating generation files — the ring rotates, it never "
        "grows")
declare("REFLOW_FLIGHT_FLUSH_EVERY", "int", 64,
        "flight recorder flushes after this many buffered events "
        "(control-plane events — fence/promote/breaker — always "
        "flush eagerly)")
# -- replication over the wire and ingestion RPC ---------------------------
declare("REFLOW_NET_IO_TIMEOUT_S", "float", 5.0,
        "per-operation send/recv/accept timeout on transport "
        "connections; no blocking wire call may wait longer")
declare("REFLOW_NET_CONNECT_TIMEOUT_S", "float", 2.0,
        "TCP connect() deadline when dialing a replica endpoint")
declare("REFLOW_NET_BACKOFF_BASE_S", "float", 0.05,
        "first reconnect delay; doubles per consecutive failure")
declare("REFLOW_NET_BACKOFF_CAP_S", "float", 2.0,
        "ceiling on the exponential reconnect delay")
declare("REFLOW_NET_BACKOFF_JITTER", "float", 0.25,
        "jitter fraction: each delay is scaled by a deterministic "
        "factor in [1-j, 1+j] from the seeded per-link RNG")
declare("REFLOW_NET_DEGRADED_AFTER", "int", 1,
        "consecutive link failures before a follower's connection "
        "state drops healthy -> degraded")
declare("REFLOW_NET_UNREACHABLE_AFTER", "int", 4,
        "consecutive link failures before degraded -> unreachable "
        "(ReadTier ejects the replica; failover may count a "
        "partition)")
declare("REFLOW_NET_FAULT_SEED", "int", 0,
        "seed for the wire fault-injection schedule (WireFaults); "
        "same seed = same drops/corruptions/partitions")
declare("REFLOW_RPC_IO_TIMEOUT_S", "float", 5.0,
        "per-operation send/recv timeout on ingestion RPC "
        "connections (RemoteProducer <-> RpcIngestServer)")
declare("REFLOW_RPC_SUBMIT_TIMEOUT_S", "float", 30.0,
        "server-side cap on how long one RPC submit may block in "
        "frontend admission (policy='block' backpressure) before "
        "the producer is told to retry")
declare("REFLOW_RPC_RESOLVE_WAIT_S", "float", 0.2,
        "server-side cap on one resolve poll's wait for a ticket to "
        "turn terminal (client long-polls in slices of this)")
declare("REFLOW_RPC_TICKETS", "int", 4096,
        "ingest server ticket-table bound; oldest resolved tickets "
        "are evicted first (an evicted in-flight ticket resolves as "
        "'unknown' and the producer resubmits — dedup keeps it "
        "exactly-once)")
declare("REFLOW_TRACE_OUT", "str", None,
        "chrome-trace export path (obs.export_chrome_trace's default)")
# -- fleet telemetry --------------------------------------------------------
declare("REFLOW_FLEET_INTERVAL_S", "float", 0.25,
        "telemetry shipper beat: seconds between registry-snapshot "
        "pushes to the fleet aggregator")
declare("REFLOW_FLEET_RETENTION", "int", 256,
        "fleet aggregator per-node time-series ring length "
        "(snapshots kept)")
declare("REFLOW_FLEET_STALE_S", "float", 2.0,
        "aggregator stale-marks a node whose newest snapshot is older "
        "than this (telemetry-loss display, never an error)")
declare("REFLOW_FLEET_LAG_SPREAD_MAX", "int", 64,
        "fleet lag-spread gauge (max-min follower horizon, ticks) "
        "above which the control plane logs an advisory action")
declare("REFLOW_FLIGHT", "flag", False,
        "per-process flight recorder: tee sampled spans and "
        "control-plane events into a bounded on-disk ring in the "
        "node's disk corner, kill -9 recoverable "
        "(tools/reflow_flight.py merges the corners post-mortem)")
declare("REFLOW_FLIGHT_DIR", "str", None,
        "flight recorder directory override (default: <node "
        "root>/flight when run under proc/, else ./flight)")
# -- the multi-process harness ----------------------------------------------
declare("REFLOW_PROC_READY_TIMEOUT_S", "float", 30.0,
        "harness deadline for a spawned child process to print its "
        "ready line (addresses + pid)")
declare("REFLOW_PROC_REAP_TIMEOUT_S", "float", 10.0,
        "harness deadline for a stopping child to exit before it is "
        "SIGKILLed (a hung child can't wedge the suite)")
declare("REFLOW_PROC_POLL_S", "float", 0.05,
        "harness poll slice for child liveness / barrier probes")
declare("REFLOW_PROC_PYTHON", "str", None,
        "interpreter used to spawn harness children "
        "(default sys.executable)")
# -- reactive reads ---------------------------------------------------------
declare("REFLOW_SUB_OUTBOX", "int", 64,
        "per-subscriber outbox bound (frames); overflow conflates the "
        "backlog into one merged frame, and a backlog too large even "
        "to conflate sheds the subscriber to snapshot semantics")
declare("REFLOW_SUB_CONFLATE_MAX_ROWS", "int", 65536,
        "row bound on a conflated frame; beyond it the subscriber is "
        "shed (outbox cleared, fresh snapshot on the next round)")
declare("REFLOW_SUB_IDLE_POLL_S", "float", 0.05,
        "fan-out thread idle wakeup — the latency floor for reaping "
        "expired subscribers when no windows arrive")
declare("REFLOW_SUB_EXPIRE_S", "float", 30.0,
        "wire subscriptions not polled for this long are reaped (a "
        "reconnecting client re-registers and resumes by cursor)")
declare("REFLOW_SUB_POLL_WAIT_S", "float", 0.2,
        "server-side cap on one subscription long-poll's wait for "
        "frames (clients long-poll in slices of this)")
declare("REFLOW_SUB_MAX_FRAMES", "int", 256,
        "max frames returned by one subscription poll")
declare("REFLOW_SUB_IO_TIMEOUT_S", "float", 5.0,
        "per-operation send/recv timeout on subscription "
        "connections (Subscriber <-> SubscriptionServer)")


# -- the config dataclass ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReflowConfig:
    """The executor and scheduler choice, from the core runtime knobs."""

    #: executor registry name: cpu (the NumPy oracle), cuda, sharded,
    #: staged
    executor: str = "cuda"
    #: fixpoint pass bound per tick (DirtyScheduler.max_loop_iters)
    max_loop_iters: int = 10_000
    #: idempotent-push dedup horizon (batch ids remembered)
    dedup_window: int = 1 << 20
    #: mesh size for the sharded executor (None = one shard per card)
    mesh_devices: Optional[int] = None
    #: False turns off the fused delta-vector loop (cuda/sharded)
    linear_fixpoint: bool = True

    @staticmethod
    def from_env(env=None) -> "ReflowConfig":
        return ReflowConfig(
            executor=env_str("REFLOW_EXECUTOR", env=env),
            max_loop_iters=env_int("REFLOW_MAX_LOOP_ITERS", env=env),
            dedup_window=env_int("REFLOW_DEDUP_WINDOW", env=env),
            mesh_devices=env_int("REFLOW_MESH_DEVICES", env=env),
            linear_fixpoint=env_flag("REFLOW_LINEAR_FIXPOINT", env=env),
        )

    def make_executor(self, *, device=None):
        """A fresh executor of this config's kind, on ``device`` (the
        card unless named; ``cpu`` takes none). With no card and no
        ``device`` a device executor raises: it never falls back to the
        CPU. JAX's name ``"tpu"`` is refused by name; the registry
        refuses any other unknown name, as JAX's does."""
        from reflow_tpu_torch.executors import get_executor

        name = self.executor
        if name == "tpu":
            raise ValueError(
                "REFLOW_EXECUTOR='tpu' is the JAX package's executor; the "
                "port's are cpu, cuda, sharded and staged, and 'cuda' is "
                "the H100's")
        kwargs = {}
        if name == "sharded":
            from reflow_tpu_torch.parallel import make_mesh

            kwargs["mesh"] = make_mesh(self.mesh_devices, device=device)
        elif name != "cpu":
            kwargs["device"] = device
        if name in ("cuda", "sharded"):
            kwargs["linear_fixpoint"] = self.linear_fixpoint
        return get_executor(name, **kwargs)

    def scheduler(self, graph, *, device=None):
        """A ``DirtyScheduler`` over ``graph`` on :meth:`make_executor`'s
        executor, with this config's loop bound and dedup window."""
        from reflow_tpu_torch.scheduler import DirtyScheduler

        return DirtyScheduler(graph, self.make_executor(device=device),
                              max_loop_iters=self.max_loop_iters,
                              dedup_window=self.dedup_window)
