"""Pytest plugin: the port's lock-order witness over a whole session.

    SPOTON_LOCK_WITNESS=1 PYTHONPATH=src python -m pytest \\
        -p repro_torch.analysis.pytest_witness tests/test_torch_*.py

Loaded by ``-p``, it installs ``lock_witness``'s process-wide witness when
the session is configured, before any test module imports the port, so
module-level locks (``codec_sched._sched_lock``, ...) are wrapped too. At
the session's end it prints what the witness saw (sites, edges,
inversions) and fails the session on any lock-order inversion. Under
``pytest-xdist`` every worker runs a witness of its own and ships its sites
and edges to the controller, which judges their union: an order taken one
way in one worker and the other way in another is an inversion too.
Without ``SPOTON_LOCK_WITNESS`` it does nothing.
"""

from __future__ import annotations

import json

import pytest

from . import lock_witness

_KEY = "repro_torch_lock_witness"
_shipped: list[dict] = []       # the workers' graphs, on the controller


def _graph(witness: lock_witness.LockWitness) -> dict:
    with witness._graph_lock:
        edges = [[a, b, desc] for (a, b), desc in sorted(witness.edges.items())]
    return {"sites": sorted(witness.sites), "edges": edges}


def pytest_configure(config):
    lock_witness.install_from_env()


@pytest.hookimpl(optionalhook=True)
def pytest_testnodedown(node, error):
    graph = getattr(node, "workeroutput", {}).get(_KEY)
    if graph is not None:
        _shipped.append(graph)


def pytest_sessionfinish(session, exitstatus):
    witness = lock_witness.active()
    if witness is None:
        return
    lock_witness.uninstall()
    workeroutput = getattr(session.config, "workeroutput", None)
    if workeroutput is not None:            # an xdist worker: ship the graph
        workeroutput[_KEY] = _graph(witness)
        return
    for graph in _shipped:
        witness.sites.update(graph["sites"])
        for a, b, desc in graph["edges"]:
            witness.edges.setdefault((a, b), desc)
    report = witness.report()
    print(f"\nport lock-order witness: {json.dumps(report)}")
    if report["inversions"]:
        print(f"port lock-order witness: {len(report['inversions'])} "
              f"inversion(s) observed during this run:\n")
        for inv in report["inversions"]:
            print(inv + "\n")
        session.exitstatus = 1
