"""Checkpoint substrate of the PyTorch port: serialization, single-device
save/restore, atomic store with the incremental (delta) chunk pool, async
writer, device-resident delta tracker and the priority codec scheduler."""

from .async_ckpt import AsyncCheckpointer
from .chunkstore import ChunkPool, ChunkRef, DeltaIndex
from .codec_sched import (PERIODIC, RESTORE, URGENT, CodecLane,
                          CodecScheduler)
from .device_delta import DeltaBlocks, DeviceDeltaTracker
from .sharded import (CheckpointReader, Prestaged, Snapshot, TensorSpec,
                      extract_snapshot, prestage, restore_to_template,
                      restore_to_template_streaming)
from .store import CheckpointInfo, CheckpointStore

__all__ = [
    "AsyncCheckpointer", "CheckpointInfo", "CheckpointReader", "CheckpointStore",
    "ChunkPool", "ChunkRef", "CodecLane", "CodecScheduler", "DeltaBlocks",
    "DeltaIndex", "DeviceDeltaTracker", "PERIODIC", "Prestaged", "RESTORE",
    "Snapshot", "TensorSpec", "URGENT", "extract_snapshot", "prestage",
    "restore_to_template", "restore_to_template_streaming",
]
