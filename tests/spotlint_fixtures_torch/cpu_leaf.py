"""Seeded violations: ``.cpu()`` / ``.to("cpu")`` on a tensor already on the
host return the tensor itself, so they copy nothing (SPOT021, the port's
form)."""

import numpy as np


def extract_cpu(leaf):
    return leaf.cpu().numpy()  # SPOTLINT-EXPECT: SPOT021


def extract_to_cpu(leaf):
    host = leaf.to("cpu")
    return host.numpy()  # SPOTLINT-EXPECT: SPOT021


def extract_asarray_cpu(leaf):
    return np.asarray(leaf.detach().cpu())  # SPOTLINT-EXPECT: SPOT021


def extract_cpu_cloned(leaf):
    """Clean twin: the clone is the snapshot's own buffer."""
    return leaf.cpu().clone().numpy()


def extract_host_copy(leaf):
    """Clean twin: HostCopy copies a CUDA tensor and clones a CPU one."""
    return HostCopy(leaf.cpu()).numpy()
