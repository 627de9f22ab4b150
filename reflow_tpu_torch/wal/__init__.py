"""Write-ahead delta log: durable exactly-once ingestion, log shipping
and key-level compaction.

The port's copy of ``reflow_tpu.wal``. Every accepted source batch is
appended to a segmented, CRC-framed log *before* the scheduler accepts
it, so a process crash between checkpoints loses nothing. Recovery
loads the latest checkpoint (``utils.checkpoint``: the ``"cuda"``
executor's device state included) and replays the log tail through the
scheduler's existing ``push(batch_id=...)`` dedup — replay is
idempotent by construction, so exactly-once survives process death,
torn tail writes, and crashes between ``push`` and ``tick``.

:class:`SegmentShipper` streams the synced prefix of the log to read
replicas (``serve.replica``), and :class:`WalCompactor` folds sealed,
fully shipped segments key by key down to O(state). The segment files,
the shipments, the shipper's ``ship-state.json`` and the compaction
manifest are byte-compatible with the JAX package's: either package
recovers, follows or compacts a log the other wrote.
"""

from reflow_tpu_torch.wal.compact import (WalCompactor,
                                          read_compact_manifest)
from reflow_tpu_torch.wal.durable import DurableScheduler
from reflow_tpu_torch.wal.log import (FencedWrite, LogPosition, TornTail,
                                      WalError, WriteAheadLog, list_segments,
                                      scan_wal)
from reflow_tpu_torch.wal.recovery import (RecoveryReport, recover,
                                           replay_records)
from reflow_tpu_torch.wal.ship import (SegmentShipper, ShipAck, Shipment,
                                       ShipNack)

__all__ = [
    "DurableScheduler",
    "FencedWrite",
    "LogPosition",
    "RecoveryReport",
    "SegmentShipper",
    "ShipAck",
    "ShipNack",
    "Shipment",
    "TornTail",
    "WalCompactor",
    "WalError",
    "WriteAheadLog",
    "list_segments",
    "read_compact_manifest",
    "recover",
    "replay_records",
    "scan_wal",
]
