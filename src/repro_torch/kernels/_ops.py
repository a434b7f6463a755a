"""The model's kernels as torch ops, in namespace ``repro_torch``.

Each entry point that a model step reaches (the flash forward and its
backward, flash decode, the selective scan, the RG-LRU scan) is an op of
the dispatcher with four parts:

- a CUDA implementation: the kernel launch, with its launch counter;
- a CPU implementation: the kernel's plain version;
- a fake implementation: the output shapes and dtypes, nothing else, so
  ``FakeTensorMode`` and the meta device trace a step through the card's
  path without a card;
- a FLOP formula registered with ``torch.utils.flop_counter``, counting
  the kernel's own work on the shapes it is given.

``PLAIN`` maps each op to its plain version, so a trace of the plain path
(``launch/op_analysis.py``) can count the ops that version runs in place
of the op's formula. Registration happens once, at the import of the
kernel package that defines the op; nothing is built or launched then.
The ops take and return plain tensors; the wrappers in each ``ops.py``
run them on a ``DTensor``'s local shards (``local_region``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "FRAGMENT")
PLAIN: dict = {}          # op overload -> its plain version


def define(name: str, schema: str, *, impl: Callable, plain: Callable,
           fake: Callable, flops: Callable):
    """Define ``repro_torch::name`` with ``schema`` (arguments and returns):
    ``impl`` on CUDA tensors, ``plain`` on CPU tensors, ``fake`` on fake and
    meta tensors, ``flops(*shapes_and_args, out_shape=...)`` its FLOPs.
    Returns the op's default overload."""
    LIB.define(name + schema)
    LIB.impl(name, impl, "CUDA")
    LIB.impl(name, plain, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet)(flops)
    PLAIN[packet.default] = plain
    return packet.default


@contextlib.contextmanager
def autograd_inside():
    """Autograd on inside an op's implementation. A dispatch mode
    (``FakeTensorMode``, ``launch/op_analysis.py``'s analysis) runs an op's
    implementation below autograd, with autograd's dispatch keys excluded,
    so an implementation that differentiates (the scans' backward: autograd
    of their plain versions) takes them back for its own ops."""
    dk = torch._C.DispatchKey
    include = torch._C._dispatch_tls_local_include_set()
    exclude = torch._C._dispatch_tls_local_exclude_set()
    for key in (dk.ADInplaceOrView, dk.AutogradOther, dk.AutogradCPU,
                dk.AutogradCUDA, dk.AutogradMeta):
        exclude = exclude.remove(key)
    with torch._C._ForceDispatchKeyGuard(include, exclude), torch.enable_grad():
        yield


@functools.lru_cache(maxsize=None)
def causal_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the flash kernels do not mask, with query i
    at position i and key j at position j: j <= i when causal, j > i -
    window when windowed (the plain versions' mask)."""
    total = 0
    for i in range(Sq):
        hi = min(i + 1, Skv) if causal else Skv
        lo = max(i - window + 1, 0) if window else 0
        total += max(hi - lo, 0)
    return total
