"""SPOT010/011/012 — codec-scheduler lane discipline.

The scheduler is one worker pool with three strict-priority lanes
(URGENT=0 > RESTORE=1 > PERIODIC=2) and *cooperative* preemption: queued
higher-priority jobs jump the queue, but a worker already inside a job is
only reclaimed when that job calls ``maybe_yield()`` between chunks. Three
conventions keep that sound, and each gets a rule:

- **SPOT010** — a function that itself runs as a lane job must never block
  (``.result()`` / ``futures.wait``) on a future it submitted to a lane of
  equal-or-lower priority: with every worker busy, nothing can ever run the
  child job, and the parent holds its worker forever (self-deadlock).
- **SPOT011** — restore-path code must submit to the RESTORE lane;
  submitting MTTR-window work to PERIODIC (or URGENT) either queues it
  behind background encodes or steals the eviction-notice budget.
- **SPOT012** — chunk-granular encode loops (anything calling
  ``store_chunk`` in a loop) must call ``codec_sched.maybe_yield()`` in the
  loop body, or a long periodic encode holds its worker for a whole piece
  and restore/urgent preemption latency degrades from one chunk to one
  piece.

Lane inference is lexical: ``codec_executor()``/``restore_executor()``/
``urgent_executor()`` and ``lane(PERIODIC|RESTORE|URGENT)`` map to lane
numbers; plain local assignments (including the known branch of an
``a if c else b`` executor default) propagate the lane to names.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, ModuleInfo, RepoModel, iter_funcs, terminal_name

LANE_FACTORIES = {
    "codec_executor": 2,
    "restore_executor": 1,
    "urgent_executor": 0,
}
LANE_CONSTANTS = {"URGENT": 0, "RESTORE": 1, "PERIODIC": 2}
LANE_LABEL = {0: "URGENT", 1: "RESTORE", 2: "PERIODIC"}
WAIT_FUNCS = {"futures_wait", "wait"}


def lane_of_expr(expr: ast.AST, env: dict[str, int]) -> Optional[int]:
    """Lane number of an executor-valued expression, if statically known."""
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    if isinstance(expr, ast.Call):
        t = terminal_name(expr.func)
        if t in LANE_FACTORIES:
            return LANE_FACTORIES[t]
        if t == "lane" and expr.args:
            return _lane_const(expr.args[0])
        return None
    if isinstance(expr, ast.IfExp):
        # `executor if executor is not None else codec_executor()` — the
        # fallback branch is the statically known default
        known = [lane_of_expr(expr.body, env), lane_of_expr(expr.orelse, env)]
        known = [k for k in known if k is not None]
        if len(known) == 1:
            return known[0]
        if len(known) == 2 and known[0] == known[1]:
            return known[0]
        return None
    return None


def _lane_const(expr: ast.AST) -> Optional[int]:
    t = terminal_name(expr)
    if t in LANE_CONSTANTS:
        return LANE_CONSTANTS[t]
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
        return expr.value if expr.value in LANE_LABEL else None
    return None


def _lane_env(fn: ast.AST) -> dict[str, int]:
    """Propagate lanes through simple local assignments (one pass is enough
    for the straight-line `ex = ...` idiom used by the encode/restore
    paths)."""
    env: dict[str, int] = {}
    for _ in range(2):  # second pass resolves name-to-name chains
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    lane = lane_of_expr(node.value, env)
                    if lane is not None:
                        env[tgt.id] = lane
    return env


def _submit_lane(call: ast.Call, env: dict[str, int]) -> Optional[int]:
    """Lane of a `<executor>.submit(...)` or `scheduler().submit(PRIO, ...)`
    call, if statically known."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "submit"):
        return None
    recv_lane = lane_of_expr(call.func.value, env)
    if recv_lane is not None:
        return recv_lane
    # CodecScheduler.submit(priority, fn, ...) — receiver is a scheduler
    if call.args:
        return _lane_const(call.args[0])
    return None


def _submitted_callable(call: ast.Call) -> Optional[str]:
    """Bare name of the callable handed to a submit call."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "submit"):
        return None
    args = call.args
    if not args:
        return None
    # scheduler().submit(PRIO, fn, ...) vs lane.submit(fn, ...)
    cand = args[1] if (_lane_const(args[0]) is not None and len(args) > 1) \
        else args[0]
    return terminal_name(cand)


def check_repo(model: RepoModel) -> list[Finding]:
    findings: list[Finding] = []

    # pass 1: which functions are submitted as jobs, and to which lanes
    submitted_to: dict[str, set[int]] = {}
    for mod in model.modules:
        for _cls, fn in iter_funcs(mod.tree):
            env = _lane_env(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                lane = _submit_lane(node, env)
                if lane is None:
                    continue
                callee = _submitted_callable(node)
                if callee:
                    submitted_to.setdefault(callee, set()).add(lane)

    # pass 2: per-function rules
    for mod in model.modules:
        for _cls, fn in iter_funcs(mod.tree):
            env = _lane_env(fn)
            own_lanes = submitted_to.get(fn.name, set())
            findings.extend(_check_fn(mod, fn, env, own_lanes))
    return findings


def _check_fn(mod: ModuleInfo, fn, env: dict[str, int],
              own_lanes: set[int]) -> list[Finding]:
    findings: list[Finding] = []
    is_restore_path = "restore" in fn.name.lower()

    # tainted future names: futures this function submitted to a lane of
    # equal-or-lower priority than the lane(s) the function itself runs on
    tainted: set[str] = set()

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.value, ast.Call):
            lane = _submit_lane(node.value, env)
            if lane is not None and own_lanes \
                    and any(lane >= mine for mine in own_lanes):
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    tainted.add(tgt.id)
        # futs.append(ex.submit(...)) taints the list name
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "append" and node.args \
                and isinstance(node.args[0], ast.Call) \
                and isinstance(node.func.value, ast.Name):
            lane = _submit_lane(node.args[0], env)
            if lane is not None and own_lanes \
                    and any(lane >= mine for mine in own_lanes):
                tainted.add(node.func.value.id)

    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        lane = _submit_lane(node, env)

        if is_restore_path and lane is not None and lane != 1:
            findings.append(Finding(
                path=mod.relpath, line=node.lineno, col=node.col_offset,
                code="SPOT011",
                message=(f"restore-path function {fn.name!r} submits to the "
                         f"{LANE_LABEL[lane]} lane — MTTR-window work belongs "
                         f"on the RESTORE lane; use restore_executor() / "
                         f"lane(RESTORE)"),
            ))

        if tainted:
            # fut.result() on a tainted future
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("result", "wait") \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in tainted:
                findings.append(_spot010(mod, fn, node))
            # futures_wait(futs) / wait(futs) on a tainted list
            elif terminal_name(node.func) in WAIT_FUNCS and node.args \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in tainted:
                findings.append(_spot010(mod, fn, node))

    # SPOT012: encode chunk loops must yield
    for node in ast.walk(fn):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        body_calls = {terminal_name(c.func)
                      for stmt in node.body for c in ast.walk(stmt)
                      if isinstance(c, ast.Call)}
        if "store_chunk" in body_calls and "maybe_yield" not in body_calls:
            findings.append(Finding(
                path=mod.relpath, line=node.lineno, col=node.col_offset,
                code="SPOT012",
                message=("chunk encode loop without codec_sched.maybe_yield() "
                         "in the body — a periodic encode holds its worker "
                         "for the whole piece and restore/urgent preemption "
                         "latency degrades to one piece; yield once per "
                         "chunk"),
            ))
    return findings


def _spot010(mod: ModuleInfo, fn, node: ast.Call) -> Finding:
    return Finding(
        path=mod.relpath, line=node.lineno, col=node.col_offset,
        code="SPOT010",
        message=(f"{fn.name!r} runs as a lane job and blocks on a future "
                 f"submitted to an equal-or-lower-priority lane — with all "
                 f"workers busy the child can never start (lane "
                 f"self-deadlock); restructure to run the work inline or "
                 f"submit strictly higher priority"),
    )
