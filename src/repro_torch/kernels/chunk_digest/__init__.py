from .ops import ChunkDigests, chunk_digests, digestible
from .ref import chunk_digests_ref

__all__ = ["ChunkDigests", "chunk_digests", "chunk_digests_ref", "digestible"]
