"""spotlint — repo-specific static analysis for the Spot-on checkpoint layer.

The checkpoint subsystem enforces three load-bearing invariants purely by
convention: the fsync→rename→dir-fsync commit protocol (a checkpoint the
store reported COMMITTED must survive a crash at any instruction), the
one-copy/no-aliasing rule for snapshot payloads and mmap views (zero-copy
buffers must never alias state a concurrent step could mutate, and mmap
views must not outlive their release scope), and the codec-scheduler lane
discipline (never block a lane on its own lane; periodic encode loops must
yield between chunks). Nothing in the test suite exercises "a new call site
forgot the fsync" — tier-1 stays green until a real eviction corrupts a
pool.

This package closes that gap with two halves:

* **spotlint** (``python -m repro_torch.analysis.spotlint src/``) — an AST
  pass (stdlib ``ast``, no new dependencies) with repo-specific rules grouped in
  four families: crash-consistency (SPOT001/002), scheduler lane discipline
  (SPOT010/011/012), zero-copy lifetimes (SPOT020/021) and lock discipline
  (SPOT030/031). Every finding carries a fix-it message; intentional
  violations are suppressed inline (``# spotlint: ignore[CODE]``) or via a
  committed baseline file whose entries go stale — and fail the run — when
  their target line changes.
* **lock witness** (``analysis.lock_witness``) — an opt-in runtime monitor
  that instruments ``threading`` lock acquisition order while the test
  suite runs and fails on observed order inversions, so the static lock
  graph of SPOT030 is validated against reality instead of trusted.

The analyzer reads the JAX package and the PyTorch port alike: on
``repro.*`` it reports what the JAX package's own analyzer reports, and its
SPOT021 also covers ``repro_torch.checkpoint.*`` with the aliasing forms of
PyTorch (``.numpy()``, ``torch.from_numpy``). The witness watches the locks
the port creates (``lock_witness``; a pytest session installs it with
``-p repro_torch.analysis.pytest_witness``).
"""

from .core import Finding  # noqa: F401
