"""SPOT030/031 — lock discipline across the checkpoint layer.

The checkpoint layer has four modules with internal locks (`codec_sched`'s
scheduler condition, `store`'s pin/stage/commit locks, `device_delta`'s
tracker lock, `async_ckpt`'s writer lock) and threads that cross them: lane
workers run store callbacks, the async writer runs tracker commit
bookkeeping, atexit runs scheduler shutdown. Two static rules:

- **SPOT030** — the static lock-acquisition graph (edge A→B when code
  acquires B while holding A, directly via nested ``with`` or through any
  resolvable call chain) must be acyclic. A cycle is a deadlock waiting for
  the right thread interleaving.
- **SPOT031** — no blocking work while holding a Lock/Condition: fsync,
  rename, rmtree, ``.result()``/``wait()``/``join()`` on futures/threads,
  device fingerprint round-trips. A lock that is held across IO turns every
  other participant (including URGENT-lane work in the eviction-notice
  window) into a queue behind that IO. ``cond.wait()`` on the *held*
  condition is exempt — that is the one blocking call a condition exists
  for, and it releases the lock while waiting.

Lock identity is the *creation site class*: ``self.X = threading.Lock()``
in class C defines lock "module.C.X"; every instance of C shares that node
in the graph (the runtime lock witness in ``lock_witness.py`` keys by
creation site for the same reason, so the static and observed graphs are
comparable).
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import (Finding, FuncEntry, ModuleInfo, RepoModel, dotted,
                   iter_funcs, terminal_name)

LOCK_CTORS = {"Lock", "RLock", "Condition"}

BLOCKING_DOTTED = {
    "os.fsync", "os.replace", "os.rename", "os.remove", "os.unlink",
    "os.listdir", "os.utime", "os.stat", "os.makedirs", "os.scandir",
    "shutil.rmtree", "time.sleep", "socket.create_connection",
}
BLOCKING_BARE = {
    "fsync_dir", "futures_wait", "fingerprint_diff", "fingerprint_blocks",
    "sleep", "open",
}
BLOCKING_METHODS = {
    "result", "wait", "join", "touch", "check", "mark_committed",
    "write_manifest", "readinto", "flush",
    # peer_exchange client/server socket surface: a peer network call under
    # the tracker or pool lock stalls every thread behind a dead peer's
    # timeout — fetch/push (PeerChunkClient), sendall/recv/recv_into/
    # accept/connect (raw sockets) all wait on the network
    "sendall", "recv", "recv_into", "connect", "accept", "fetch", "push",
    # object-store ChunkBackend client surface (checkpoint.backend): every
    # one of these rides the network (or a modeled link) and may burn a full
    # bounded-retry cycle — under the pool's tracker lock that serializes
    # all writers behind one flaky endpoint
    "get_range", "put", "complete_multipart", "create_multipart",
    "upload_part", "head",
}


def _is_lock_ctor(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Call):
        t = terminal_name(expr.func)
        d = dotted(expr.func)
        if t in LOCK_CTORS and (d == t or (d or "").startswith("threading.")):
            return t
    return None


class LockIndex:
    """Creation-site lock identities discovered across the repo."""

    def __init__(self, model: RepoModel):
        # (module_name, classname) -> {attr: key}
        self.class_locks: dict[tuple[str, str], dict[str, str]] = {}
        # (module_name, name) -> key
        self.module_locks: dict[tuple[str, str], str] = {}
        # attr name -> every key using that attr (for obj.attr resolution)
        self.attr_owners: dict[str, set[str]] = {}
        for mod in model.modules:
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and _is_lock_ctor(node.value):
                    name = node.targets[0].id
                    key = f"{mod.module_name}.{name}"
                    self.module_locks[(mod.module_name, name)] = key
            for classname, fn in iter_funcs(mod.tree):
                if classname is None:
                    continue
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                            and isinstance(sub.targets[0], ast.Attribute):
                        tgt = sub.targets[0]
                        if isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self" \
                                and _is_lock_ctor(sub.value):
                            key = f"{mod.module_name}.{classname}.{tgt.attr}"
                            self.class_locks.setdefault(
                                (mod.module_name, classname), {})[tgt.attr] = key
                            self.attr_owners.setdefault(tgt.attr, set()).add(key)

    def resolve(self, expr: ast.AST, mod: ModuleInfo,
                classname: Optional[str]) -> Optional[str]:
        """Lock key of a `with <expr>:` context expression, if known."""
        if isinstance(expr, ast.Name):
            return self.module_locks.get((mod.module_name, expr.id))
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and classname is not None:
                attrs = self.class_locks.get((mod.module_name, classname), {})
                if expr.attr in attrs:
                    return attrs[expr.attr]
            owners = self.attr_owners.get(expr.attr, set())
            if len(owners) == 1:
                return next(iter(owners))
        return None


def check_repo(model: RepoModel) -> list[Finding]:
    index = LockIndex(model)

    entries: list[FuncEntry] = [e for lst in model.functions.values()
                                for e in lst]
    by_node: dict[int, FuncEntry] = {id(e.node): e for e in entries}

    # direct lock acquisitions + resolved callees per function
    direct_acq: dict[int, set[str]] = {}
    callees: dict[int, list[FuncEntry]] = {}
    for e in entries:
        acq: set[str] = set()
        outs: list[FuncEntry] = []
        for node in ast.walk(e.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    key = index.resolve(item.context_expr, e.module, e.classname)
                    if key:
                        acq.add(key)
            elif isinstance(node, ast.Call):
                outs.extend(model.resolve_call(node, e.module, e.classname))
        direct_acq[id(e.node)] = acq
        callees[id(e.node)] = outs

    # fixpoint: locks a function may acquire, transitively through calls
    may_acq: dict[int, set[str]] = {k: set(v) for k, v in direct_acq.items()}
    changed = True
    while changed:
        changed = False
        for e in entries:
            mine = may_acq[id(e.node)]
            before = len(mine)
            for callee in callees[id(e.node)]:
                mine |= may_acq.get(id(callee.node), set())
            if len(mine) != before:
                changed = True

    findings: list[Finding] = []
    # edges: (held, acquired) -> (relpath, line, col, via)
    edges: dict[tuple[str, str], tuple[str, int, int, str]] = {}

    for e in entries:
        for node in ast.walk(e.node):
            if not isinstance(node, ast.With):
                continue
            item_keys = [(item, index.resolve(item.context_expr, e.module,
                                              e.classname))
                         for item in node.items]
            held = [(item, k) for item, k in item_keys if k]
            if not held:
                continue
            # `with a, b:` acquires b while holding a
            for i in range(len(held) - 1):
                for j in range(i + 1, len(held)):
                    a, b = held[i][1], held[j][1]
                    if a != b:
                        edges.setdefault((a, b), (
                            e.module.relpath, node.lineno, node.col_offset,
                            f"`with {a.rsplit('.', 1)[-1]}, "
                            f"{b.rsplit('.', 1)[-1]}` in {e.qualname}"))
            for item, key in held:
                held_dotted = dotted(item.context_expr)
                for sub_stmt in node.body:
                    for sub in ast.walk(sub_stmt):
                        if isinstance(sub, ast.With):
                            for it2 in sub.items:
                                k2 = index.resolve(it2.context_expr, e.module,
                                                   e.classname)
                                if k2 and k2 != key:
                                    edges.setdefault((key, k2), (
                                        e.module.relpath, sub.lineno,
                                        sub.col_offset,
                                        f"nested with in {e.qualname}"))
                        elif isinstance(sub, ast.Call):
                            findings.extend(_check_blocking(
                                e, sub, key, held_dotted))
                            for callee in model.resolve_call(
                                    sub, e.module, e.classname):
                                for k2 in may_acq.get(id(callee.node), set()):
                                    if k2 != key:
                                        edges.setdefault((key, k2), (
                                            e.module.relpath, sub.lineno,
                                            sub.col_offset,
                                            f"call to {callee.qualname} "
                                            f"in {e.qualname}"))

    findings.extend(_cycle_findings(edges))
    return findings


def _check_blocking(e: FuncEntry, call: ast.Call, lock_key: str,
                    held_dotted: Optional[str]) -> list[Finding]:
    d = dotted(call.func)
    t = terminal_name(call.func)
    reason = None
    if d in BLOCKING_DOTTED:
        reason = d
    elif isinstance(call.func, ast.Name) and t in BLOCKING_BARE:
        reason = t
    elif isinstance(call.func, ast.Attribute) and t in BLOCKING_METHODS:
        recv = dotted(call.func.value)
        # cond.wait()/notify patterns on the lock being held are the point
        # of a condition variable, not a violation
        if recv is not None and recv == held_dotted:
            reason = None
        # `os.path.join` and `", ".join(...)` are pure, not thread joins
        elif t == "join" and (recv in ("os.path", "posixpath", "ntpath")
                              or isinstance(call.func.value, ast.Constant)):
            reason = None
        elif isinstance(call.func.value, ast.Constant):
            reason = None
        else:
            reason = f".{t}()"
    if reason is None:
        return []
    return [Finding(
        path=e.module.relpath, line=call.lineno, col=call.col_offset,
        code="SPOT031",
        message=(f"blocking call {reason} while holding {lock_key} — every "
                 f"thread contending for that lock (including urgent-save "
                 f"work in the eviction-notice window) now queues behind "
                 f"this IO; move the blocking work outside the critical "
                 f"section or snapshot state under the lock and operate on "
                 f"the snapshot"),
    )]


def _cycle_findings(
        edges: dict[tuple[str, str], tuple[str, int, int, str]]) -> list[Finding]:
    """Tarjan SCC over the lock graph; any SCC with ≥2 locks is a potential
    deadlock cycle. One finding per SCC, anchored at its lexically-first
    edge."""
    adj: dict[str, set[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())

    idx: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    sccs: list[list[str]] = []

    def strongconnect(v: str) -> None:
        # iterative Tarjan: (node, iterator) frames
        work = [(v, iter(adj.get(v, ())))]
        idx[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == idx[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(scc)

    for v in list(adj):
        if v not in idx:
            strongconnect(v)

    findings: list[Finding] = []
    for scc in sccs:
        members = set(scc)
        cyc_edges = sorted(
            ((site, (a, b)) for (a, b), site in edges.items()
             if a in members and b in members),
            key=lambda x: (x[0][0], x[0][1], x[0][2]))
        site, (a, b) = cyc_edges[0]
        detail = "; ".join(
            f"{a2}→{b2} ({s[3]})" for s, (a2, b2) in cyc_edges)
        findings.append(Finding(
            path=site[0], line=site[1], col=site[2],
            code="SPOT030",
            message=(f"lock-acquisition cycle: {' ↔ '.join(sorted(members))} "
                     f"— edges: {detail}; impose a single acquisition order "
                     f"(or drop to a snapshot-then-operate pattern) to make "
                     f"this deadlock impossible"),
        ))
    return findings
