"""Write-ahead delta log: durable exactly-once ingestion.

The port's copy of ``reflow_tpu.wal`` (the log, the durable scheduler and
recovery; log shipping and compaction wait for the replica slice). Every
accepted source batch is appended to a segmented, CRC-framed log
*before* the scheduler accepts it, so a process crash between
checkpoints loses nothing. Recovery loads the latest checkpoint
(``utils.checkpoint``: the ``"cuda"`` executor's device state included)
and replays the log tail through the scheduler's existing
``push(batch_id=...)`` dedup — replay is idempotent by construction, so
exactly-once survives process death, torn tail writes, and crashes
between ``push`` and ``tick``. The segment files are byte-compatible
with the JAX package's: either package recovers a log the other wrote.
"""

from reflow_tpu_torch.wal.durable import DurableScheduler
from reflow_tpu_torch.wal.log import (FencedWrite, LogPosition, TornTail,
                                      WalError, WriteAheadLog, list_segments,
                                      scan_wal)
from reflow_tpu_torch.wal.recovery import (RecoveryReport, recover,
                                           replay_records)

__all__ = [
    "DurableScheduler",
    "FencedWrite",
    "LogPosition",
    "RecoveryReport",
    "TornTail",
    "WalError",
    "WriteAheadLog",
    "list_segments",
    "recover",
    "replay_records",
    "scan_wal",
]
