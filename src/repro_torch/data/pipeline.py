"""Deterministic, checkpointable synthetic data pipeline.

The pipeline is a pure function of (seed, batch_index): batch *i* is always
the same array regardless of process restarts — so its entire mutable state is
one integer. That integer rides inside the transparent checkpoint, which is
what makes resume *bit-exact*: a restored job consumes exactly the batches it
would have consumed, in order. (The application-specific mode deliberately
omits pipeline state — like metaSPAdes re-deriving intra-stage progress — so
its resume replays data from the stage boundary.)

Host-side numpy (as a real input pipeline would be), O(batch) per call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PipelineState:
    next_batch_index: int = 0

    def to_tree(self) -> dict:
        return {"next_batch_index": np.int64(self.next_batch_index)}

    @staticmethod
    def from_tree(tree: dict) -> "PipelineState":
        return PipelineState(next_batch_index=int(tree["next_batch_index"]))

    @staticmethod
    def template() -> dict:
        return {"next_batch_index": np.int64(0)}


class TokenPipeline:
    """Synthetic LM batches: token ids, next-token labels; or frontend
    embeddings for [audio]/[vlm] archs (embed_dim set)."""

    def __init__(self, *, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, embed_dim: int | None = None,
                 embed_dtype=np.float32):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.embed_dim = embed_dim
        self.embed_dtype = embed_dtype

    def batch_at(self, index: int) -> dict:
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([self.seed, index])))
        # token stream with mild structure (Zipf-ish) so losses are non-trivial
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        tokens = (z % self.vocab_size).astype(np.int32)
        labels = tokens[:, 1:]
        if self.embed_dim is not None:
            emb = rng.standard_normal(
                (self.batch, self.seq_len, self.embed_dim)).astype(self.embed_dtype)
            return {"inputs": emb, "labels": labels}
        return {"inputs": tokens[:, :-1], "labels": labels}

    def next(self, state: PipelineState) -> tuple[dict, PipelineState]:
        b = self.batch_at(state.next_batch_index)
        return b, PipelineState(state.next_batch_index + 1)

    def fast_forward(self, batch_index: int) -> PipelineState:
        """Seek to the restored cursor in O(1) — no replay.

        Because every batch is a pure function of (seed, batch_index), a
        resume needs no catch-up iteration over consumed data: the cursor
        from the checkpoint *is* the full pipeline state. A resumed job
        yields exactly the batches an uninterrupted run would have, in
        order. This is the data-pipeline leg of the fast-resume path — in
        MTTR terms it costs nothing, where a stateful loader would replay
        (or re-shard) up to ``batch_index`` batches.
        """
        if batch_index < 0:
            raise ValueError(f"batch index must be >= 0, got {batch_index}")
        return PipelineState(next_batch_index=int(batch_index))
