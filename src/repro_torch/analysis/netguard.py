"""SPOT041/SPOT042 — object-store network-path discipline.

The ChunkBackend contract (``repro_torch.checkpoint.backend``) makes the network
layer survivable the same way SPOT001/002 make the POSIX commit protocol
survivable: content addressing turns every transfer into something that can
be *verified and repeated*. These rules police the two ways call sites
forfeit that property.

SPOT041 — bare or unverified ranged GET. A torn response is re-fetchable by
hash, but only if the caller (a) runs the GET under the bounded-retry
substrate (``core.retry.call_with_retry`` — directly, through a wrapper
that forwards to it, or transitively from a function that is itself
retried) and (b) re-digests the payload against its content address before
trusting a byte (``chunk_content_ok`` / ``chunk_digest``). A one-shot
``backend.get_range(...)`` with no retry is flagged, as is a retried fetch
whose closure never verifies — retrying a corrupt-accepting read just
re-accepts the corruption. Methods *named* ``get_range`` are exempt: a
backend implementation delegating to its transport is the interface seam,
the retry contract binds the consumer.

SPOT042 — chunk-key PUT in a loop without an idempotence guard. Re-driving
an upload loop (reconcile after an outage, a retried save) must be a
verified no-op for chunks that already landed — the key is the content, so
a blind re-PUT wastes the link at best and clobbers a concurrent writer's
committed object at worst. A ``<backendish>.put(...)`` inside a for/while
loop is flagged unless the loop body consults existence first (``head`` /
``check`` / ``exists``). The receiver must look like an object-store client
(``backend``, ``objstore``, ``s3``, ...) so queue/dict ``.put`` stays out
of scope.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import (Finding, ModuleInfo, RepoModel, calls_in, dotted,
                   iter_funcs, terminal_name)

#: the root of the bounded-retry substrate; functions whose bodies call a
#: wrapper are wrappers themselves (fixpoint), so `_backend_retry(...)`
#: style forwarding keeps the property visible
RETRY_ROOT = "call_with_retry"

#: a retried fetch closure must re-digest against the content address with
#: one of these before accepting the payload
VERIFY_TERMINALS = {"chunk_content_ok", "chunk_digest", "verify_digest"}

GET_TERMINALS = {"get_range"}

PUT_TERMINALS = {"put", "put_object"}

#: receiver name segments that mark a call target as an object-store client
#: (deliberately narrow: `queue.put` / `index.put` are not network uploads)
BACKENDISH_SEGMENTS = {
    "backend", "objstore", "object_store", "obj_store", "s3", "gcs",
    "bucket", "remote",
}

GUARD_TERMINALS = {"head", "check", "exists", "head_object"}


def check_repo(model: RepoModel) -> list[Finding]:
    wrappers = _retry_wrappers(model)
    wrapped = _retry_wrapped_functions(model, wrappers)
    findings: list[Finding] = []
    for mod in model.modules:
        findings.extend(_check_gets(mod, wrapped, wrappers))
        findings.extend(_check_put_loops(mod))
    return findings


# -- SPOT041 -------------------------------------------------------------------


def _retry_wrappers(model: RepoModel) -> set[str]:
    """Function names that forward their callable argument into the bounded
    retry substrate: ``call_with_retry`` itself plus any repo function whose
    body reaches a wrapper (fixpoint over one level of forwarding per
    round)."""
    wrappers = {RETRY_ROOT}
    changed = True
    while changed:
        changed = False
        for name, entries in model.functions.items():
            if name in wrappers:
                continue
            for e in entries:
                if any(terminal_name(c.func) in wrappers
                       for c in calls_in(e.node)):
                    wrappers.add(name)
                    changed = True
                    break
    return wrappers


def _retry_wrapped_functions(model: RepoModel,
                             wrappers: set[str]) -> set[str]:
    """Names of functions that execute under a bounded retry: referenced (or
    lambda-called) in the argument list of a wrapper call, closed over the
    calls their bodies make (a retried function's callees are retried too)."""
    wrapped: set[str] = set()
    for mod in model.modules:
        for call in calls_in(mod.tree):
            if terminal_name(call.func) not in wrappers:
                continue
            args = list(call.args) + [kw.value for kw in call.keywords]
            for a in args:
                if isinstance(a, ast.Lambda):
                    for sub in calls_in(a):
                        t = terminal_name(sub.func)
                        if t:
                            wrapped.add(t)
                else:
                    t = terminal_name(a)
                    if t:
                        wrapped.add(t)
    # transitive closure, bounded to repo-defined functions
    changed = True
    while changed:
        changed = False
        for name in list(wrapped):
            for e in model.functions.get(name, []):
                for c in calls_in(e.node):
                    t = terminal_name(c.func)
                    if t and t in model.functions and t not in wrapped:
                        wrapped.add(t)
                        changed = True
    return wrapped


def _own_calls(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[ast.Call]:
    """Call nodes in ``fn``'s own body — nested def subtrees excluded (they
    are analyzed as their own functions), lambdas included (they run in this
    function's dynamic extent for the patterns we police)."""
    out: list[ast.Call] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(child, ast.Call):
                out.append(child)
            walk(child)

    walk(fn)
    out.sort(key=lambda c: (c.lineno, c.col_offset))
    return out


def _check_gets(mod: ModuleInfo, wrapped: set[str],
                wrappers: set[str]) -> list[Finding]:
    findings: list[Finding] = []
    for _classname, fn in iter_funcs(mod.tree):
        if fn.name in GET_TERMINALS:
            continue  # interface delegation inside a backend implementation
        calls = _own_calls(fn)
        is_wrapped = fn.name in wrapped or fn.name in wrappers
        verifies = any(terminal_name(c.func) in VERIFY_TERMINALS
                       for c in calls)
        for call in calls:
            if terminal_name(call.func) not in GET_TERMINALS:
                continue
            if not is_wrapped:
                findings.append(Finding(
                    path=mod.relpath, line=call.lineno,
                    col=call.col_offset, code="SPOT041",
                    message=(
                        "bare one-shot ranged GET: a torn or short response "
                        "is re-fetchable by content address, but only inside "
                        "the bounded retry substrate — run this through "
                        "core.retry.call_with_retry (e.g. "
                        "backend.fetch_chunk_verified) and re-digest before "
                        "accepting"),
                ))
            elif not verifies:
                findings.append(Finding(
                    path=mod.relpath, line=call.lineno,
                    col=call.col_offset, code="SPOT041",
                    message=(
                        "retried but unverified ranged GET: the retry "
                        "closure never re-digests the payload against its "
                        "content address (chunk_content_ok/chunk_digest), "
                        "so a corrupt response is accepted on the first "
                        "try — retrying cannot help what is never checked"),
                ))
    return findings


# -- SPOT042 -------------------------------------------------------------------


def _backendish(call: ast.Call) -> Optional[str]:
    """Receiver dotted name when the call target looks like an object-store
    client method, else None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr not in PUT_TERMINALS:
        return None
    recv = dotted(call.func.value)
    if recv is None:
        return None
    segments = {s.lstrip("_") for s in recv.split(".")}
    if segments & BACKENDISH_SEGMENTS:
        return recv
    return None


def _check_put_loops(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for _classname, fn in iter_funcs(mod.tree):
        for put, loops in _calls_with_loops(fn):
            recv = _backendish(put)
            if recv is None or not loops:
                continue
            guarded = any(
                any(terminal_name(c.func) in GUARD_TERMINALS
                    for c in calls_in(loop))
                for loop in loops)
            if not guarded:
                findings.append(Finding(
                    path=mod.relpath, line=put.lineno,
                    col=put.col_offset, code="SPOT042",
                    message=(
                        f"chunk-key PUT in a loop without an idempotence "
                        f"guard: re-driving this loop re-uploads every "
                        f"object blind — consult `{recv}.head(...)` (or "
                        f"check/exists) first so an already-committed "
                        f"address is a verified no-op, never an append "
                        f"(see backend.upload_chunk)"),
                ))
    return findings


def _calls_with_loops(
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
) -> list[tuple[ast.Call, list[ast.AST]]]:
    """(call, enclosing for/while loops innermost-last) pairs for ``fn``'s
    own body — nested defs excluded, like :func:`_own_calls`."""
    out: list[tuple[ast.Call, list[ast.AST]]] = []

    def walk(node: ast.AST, loops: list[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            child_loops = loops
            if isinstance(child, (ast.For, ast.While)):
                child_loops = loops + [child]
            if isinstance(child, ast.Call):
                out.append((child, list(child_loops)))
            walk(child, child_loops)

    walk(fn, [])
    return out
