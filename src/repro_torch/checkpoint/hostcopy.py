"""Device→host copies in flight.

A CUDA tensor is copied ``non_blocking`` into **pinned** host memory on the
current stream, and a CUDA event marks the copy's end; ``wait`` blocks on
that event before any host byte is read. The copy rides the stream the
training step uses, so a later step can never overwrite (or the caching
allocator reuse) the source before the copy has read it. A CPU tensor is
cloned at once — the snapshot freeze.
"""

from __future__ import annotations

import numpy as np
import torch

from . import serialize as ser


class HostCopy:
    def __init__(self, t: torch.Tensor):
        self.src = t                 # the leaf object, for identity checks
        t = t.detach()
        self.event: torch.cuda.Event | None = None
        if t.device.type == "cuda":
            t = t.contiguous()
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.contiguous().clone()

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.host

    def numpy(self) -> np.ndarray:
        """The landed bytes as a host payload array (bfloat16 -> uint16)."""
        return ser.tensor_to_numpy(self.wait())
