"""Checkpoint substrate of the PyTorch port: serialization, single-device
save/restore, atomic store with the incremental (delta) chunk pool, async
writer, device-resident delta tracker, the priority codec scheduler and the
peer-to-peer chunk exchange of a fleet."""

from .async_ckpt import AsyncCheckpointer
from .chunkstore import ChunkPool, ChunkRef, DeltaIndex
from .codec_sched import (PERIODIC, RESTORE, URGENT, CodecLane,
                          CodecScheduler)
from .device_delta import DeltaBlocks, DeviceDeltaTracker
from .peer_exchange import (FleetPeerExchange, PeerChunkClient,
                            PeerChunkServer, ReadThroughPool,
                            warm_restore_from_peers)
from .sharded import (CheckpointReader, Prestaged, Snapshot, TensorSpec,
                      extract_snapshot, prestage, restore_to_template,
                      restore_to_template_streaming)
from .store import CheckpointInfo, CheckpointStore

__all__ = [
    "AsyncCheckpointer", "CheckpointInfo", "CheckpointReader", "CheckpointStore",
    "ChunkPool", "ChunkRef", "CodecLane", "CodecScheduler", "DeltaBlocks",
    "DeltaIndex", "DeviceDeltaTracker", "FleetPeerExchange", "PERIODIC",
    "PeerChunkClient", "PeerChunkServer", "Prestaged", "RESTORE",
    "ReadThroughPool", "Snapshot", "TensorSpec", "URGENT", "extract_snapshot",
    "prestage", "restore_to_template", "restore_to_template_streaming",
    "warm_restore_from_peers",
]
