"""Seeded violations: restored leaves sharing the caller's array through
``torch.from_numpy`` (SPOT021, the port's form)."""

import numpy as np
import torch


def restore_shared(arr):
    return torch.from_numpy(arr)  # SPOTLINT-EXPECT: SPOT021


def restore_viewed(arr, np_view, tdt):
    return torch.from_numpy(arr.view(np_view)).view(tdt)  # SPOTLINT-EXPECT: SPOT021


def restore_half_copied(arr):
    """A copy in one branch does not clear the other (unlike np.asarray's
    to_host idiom): a writable ``arr`` still backs the tensor."""
    if not arr.flags.writeable:
        arr = np.array(arr, copy=True)
    return torch.from_numpy(arr)  # SPOTLINT-EXPECT: SPOT021


def restore_through_helper(arr, dtype_name, device):
    """serialize.numpy_to_tensor wraps torch.from_numpy, and .to() of a
    CPU tensor onto the CPU returns it itself."""
    return ser.numpy_to_tensor(arr, dtype_name).to(device)  # SPOTLINT-EXPECT: SPOT021


def restore_helper_owned(arr, dtype_name):
    """Clean twin: the helper takes over a copy."""
    return ser.numpy_to_tensor(np.array(arr, copy=True), dtype_name)


def restore_owned(arr):
    """Clean twin: the tensor gets a buffer of its own."""
    return torch.from_numpy(np.array(arr, copy=True))


def restore_cloned(arr):
    """Clean twin: cloned at once."""
    return torch.from_numpy(arr).clone()


def restore_no_copy(arr):
    """np.array(copy=False) is no copy."""
    return torch.from_numpy(np.array(arr, copy=False))  # SPOTLINT-EXPECT: SPOT021
