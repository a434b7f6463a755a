"""Deterministic fault injection for torture-testing the checkpoint stack.

The dynamic twin of the spotlint static rules: where SPOT001/002 prove the
commit protocol is *shaped* right, this package kills it mid-flight — torn
writes, errno storms, rename rollbacks, and process-equivalent crashes at
every enumerated commit point — and the tests assert the recovery
invariant actually holds. See README "Fault injection & torture testing".
"""

from .inject import (active, fault_point, install, response_bytes,
                     send_bytes, snapshot_stats, uninstall, write_bytes)
from .plan import (BACKEND_CRASH_POINTS, COMMIT_CRASH_POINTS, FaultPlan,
                   FaultRule, Injection, SimulatedCrash)

__all__ = [
    "BACKEND_CRASH_POINTS",
    "COMMIT_CRASH_POINTS",
    "FaultPlan",
    "FaultRule",
    "Injection",
    "SimulatedCrash",
    "active",
    "fault_point",
    "install",
    "response_bytes",
    "send_bytes",
    "snapshot_stats",
    "uninstall",
    "write_bytes",
]
