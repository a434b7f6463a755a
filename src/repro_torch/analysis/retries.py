"""SPOT040 — unbounded IO retry loops.

The retry substrate (``repro_torch.core.retry``) exists so every retried IO op is
*bounded* and *backed off*: a bare ``while True`` that swallows OSError
around a filesystem or endpoint call retries a dead disk forever, burning
the eviction-notice window and hanging shutdown. The rule flags::

    while True:              # SPOT040
        try:
            os.replace(tmp, path)
            return
        except OSError:
            pass             # no bound, no backoff, swallowed

A loop is flagged when ALL of these hold:

- the loop condition is constantly true (``while True`` / ``while 1``) —
  counter-bounded loops (``for _ in range(n)``, ``while attempts < n``)
  are exits by construction;
- a ``try`` in the loop body wraps a *primitive IO* call (``os.*``,
  ``shutil.*``, bare ``open``, ``fsync``/``replace``/``rename``-style
  terminals, ``urlopen``, ``.poll``) — worker loops that dispatch
  higher-level jobs are not retry loops and are left alone;
- some matching handler catches an IO-ish exception class (``OSError``,
  ``IOError``, ``Exception``, bare except, ...) and its body neither
  re-raises, breaks, nor returns — i.e. it swallows and loops — and
  contains no backoff (a ``sleep``-terminal call exempts: an infinite
  *paced* poll loop is a deliberate design, not an accident).

The fix is ``repro_torch.core.retry.call_with_retry`` (bounded attempts,
exponential backoff, jitter, transient-errno classification) or an explicit
attempt bound with a terminal ``raise``.
"""

from __future__ import annotations

import ast

from .core import Finding, ModuleInfo, RepoModel, dotted, iter_funcs, terminal_name

# primitive-IO call surface: dotted prefixes and terminal names that mark a
# try body as "retrying an IO op" (kept narrow on purpose — flagging job
# dispatch in worker loops would drown the signal)
IO_DOTTED_PREFIXES = ("os.", "shutil.", "urllib.")
IO_TERMINALS = {
    "open", "fsync", "fsync_dir", "replace", "rename", "unlink", "remove",
    "readinto", "urlopen", "poll", "poll_once", "recv", "send", "connect",
    "flush", "stat", "utime",
}

# exception classes whose swallowing inside a retry loop hides IO failure
CAUGHT_IO_CLASSES = {
    "OSError", "IOError", "PermissionError", "TimeoutError",
    "ConnectionError", "Exception", "BaseException",
}

# a call with one of these terminals inside the handler counts as backoff
BACKOFF_TERMINALS = {"sleep", "wait", "maybe_yield"}


def check_repo(model: RepoModel) -> list[Finding]:
    findings: list[Finding] = []
    for mod in model.modules:
        findings.extend(_check_module(mod))
    return findings


def _check_module(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for _classname, fn in iter_funcs(mod.tree):
        for node in ast.walk(fn):
            if isinstance(node, ast.While) and _const_true(node.test):
                hit = _unbounded_retry(node)
                if hit is not None:
                    findings.append(Finding(
                        path=mod.relpath, line=node.lineno,
                        col=node.col_offset, code="SPOT040",
                        message=(
                            f"unbounded retry loop: `while True` re-attempts "
                            f"{hit} with a handler that swallows the failure "
                            f"(no raise/break/return) and never backs off — "
                            f"a persistent fault spins forever; use "
                            f"repro_torch.core.retry.call_with_retry or bound "
                            f"the attempts and re-raise"),
                    ))
    return findings


def _const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _io_call_name(call: ast.Call) -> str | None:
    d = dotted(call.func)
    if d is not None and d.startswith(IO_DOTTED_PREFIXES):
        return d
    t = terminal_name(call.func)
    if t in IO_TERMINALS:
        return d or t
    return None


def _catches_io(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:                      # bare except
        return True
    types = (handler.type.elts if isinstance(handler.type, ast.Tuple)
             else [handler.type])
    return any(terminal_name(t) in CAUGHT_IO_CLASSES for t in types)


def _swallows(handler: ast.ExceptHandler) -> bool:
    """Handler body has no exit (raise/break/return) and no backoff call."""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Break, ast.Return)):
            return False
        if (isinstance(node, ast.Call)
                and terminal_name(node.func) in BACKOFF_TERMINALS):
            return False
    return True


def _unbounded_retry(loop: ast.While) -> str | None:
    """Name of the retried IO call when `loop` is an unbounded swallowing
    retry around primitive IO, else None."""
    for node in ast.walk(loop):
        if not isinstance(node, ast.Try):
            continue
        io_name = None
        for sub in ast.walk(node):
            # only the try body's calls count; walking the whole Try also
            # visits handlers, so filter by position against the handlers
            if isinstance(sub, ast.Call):
                name = _io_call_name(sub)
                if name is not None and _in_try_body(node, sub):
                    io_name = name
                    break
        if io_name is None:
            continue
        for handler in node.handlers:
            if _catches_io(handler) and _swallows(handler):
                return io_name
    return None


def _in_try_body(tr: ast.Try, node: ast.AST) -> bool:
    return any(node is b or any(node is d for d in ast.walk(b))
               for b in tr.body)
