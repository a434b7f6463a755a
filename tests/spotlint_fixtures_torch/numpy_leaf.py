"""Seeded violations: snapshot leaves sharing a CPU tensor's storage through
``.numpy()`` (SPOT021, the port's form)."""

import numpy as np


def extract_aliasing(leaf):
    return leaf.detach().numpy()  # SPOTLINT-EXPECT: SPOT021


def extract_staged(staged, name):
    arr = staged[name].numpy()  # SPOTLINT-EXPECT: SPOT021
    return arr


def extract_through_helper(leaf):
    """serialize.tensor_to_numpy wraps .numpy(): its call site is judged."""
    return ser.tensor_to_numpy(leaf.detach())  # SPOTLINT-EXPECT: SPOT021


def extract_cloned(leaf):
    """Clean twin: the clone is the snapshot's own buffer."""
    return leaf.detach().clone().numpy()


def extract_helper_cloned(leaf):
    """Clean twin: the helper views a clone."""
    return ser.tensor_to_numpy(leaf.detach().clone())


def extract_bound_clone(leaf):
    """Clean twin: the name is bound to a clone only."""
    frozen = leaf.clone()
    return frozen.numpy()


def extract_copied(leaf):
    """Clean twin: the view is copied at once."""
    return leaf.numpy().copy()


def extract_array(leaf):
    """Clean twin: np.array copies by default."""
    return np.array(leaf.numpy())


def extract_host_copy(leaf):
    """Clean twin: HostCopy clones a CPU tensor; its bytes are its own."""
    cp = HostCopy(leaf)
    return cp.numpy()


def scale_of(amax):
    """Clean twin: scalars keep no buffer."""
    return float(amax.numpy()), amax.numpy().item()
