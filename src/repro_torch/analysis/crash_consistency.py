"""SPOT001/SPOT002 — the fsync→rename→dir-fsync commit protocol.

A checkpoint the store reported COMMITTED must survive a crash at any
instruction (the store's durability invariant). Statically that means every
`os.replace` / `os.rename` on a commit path must be *dominated* by an fsync
of the data being renamed (SPOT001) and *followed* by an fsync of the parent
directory so the rename itself is durable (SPOT002).

The analysis is per-function and order-based: a rename at position P needs a
blessed fsync-bearing call lexically before P and a dir-fsync reference
lexically after P in the same function body. `ioutil` helpers and the
manifest commit methods are modeled as blessed because they perform the
fsyncs internally:

- fsync-bearing (satisfy SPOT001): direct ``os.fsync``/``fsync``, plus
  ``write_manifest`` / ``mark_committed`` / ``write_shard_file`` which all
  fsync what they wrote before returning;
- dir-fsync-bearing (satisfy SPOT002): any reference to ``fsync_dir`` or
  ``mark_committed`` after the rename — a *reference* (not only a direct
  call) so `executor.submit(fsync_dir, root)` counts; the store overlaps the
  root dir fsync on an executor lane and joins it before reporting
  COMMITTED.
"""

from __future__ import annotations

import ast

from .core import Finding, ModuleInfo, RepoModel, dotted, iter_funcs, terminal_name

RENAME_CALLS = {"os.replace", "os.rename"}
FSYNC_BEARING = {"fsync", "write_manifest", "mark_committed", "write_shard_file"}
DIRSYNC_BEARING = {"fsync_dir", "mark_committed"}


def _pos(node: ast.AST) -> tuple[int, int]:
    return (node.lineno, node.col_offset)


def check_repo(model: RepoModel) -> list[Finding]:
    findings: list[Finding] = []
    for mod in model.modules:
        findings.extend(_check_module(mod))
    return findings


def _check_module(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for _classname, fn in iter_funcs(mod.tree):
        renames = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = dotted(node.func)
                if name in RENAME_CALLS:
                    renames.append(node)
        if not renames:
            continue
        # gather every call and every bare reference in source order once
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        refs = [n for n in ast.walk(fn)
                if isinstance(n, (ast.Name, ast.Attribute))]
        for rn in renames:
            rp = _pos(rn)
            fsynced = any(
                terminal_name(c.func) in FSYNC_BEARING and _pos(c) < rp
                for c in calls)
            if not fsynced:
                findings.append(Finding(
                    path=mod.relpath, line=rn.lineno, col=rn.col_offset,
                    code="SPOT001",
                    message=(f"{dotted(rn.func)} without a preceding fsync of "
                             f"the source in this function — a crash after the "
                             f"rename can publish an empty/partial file; fsync "
                             f"the data first (os.fsync, or a blessed helper: "
                             f"{', '.join(sorted(FSYNC_BEARING - {'fsync'}))})"),
                ))
            dir_synced = any(
                _name_of(r) in DIRSYNC_BEARING and _pos(r) > rp
                for r in refs)
            if not dir_synced:
                findings.append(Finding(
                    path=mod.relpath, line=rn.lineno, col=rn.col_offset,
                    code="SPOT002",
                    message=(f"{dotted(rn.func)} without a following parent-dir "
                             f"fsync — the rename itself is not durable until "
                             f"the directory is fsynced; call "
                             f"ioutil.fsync_dir(parent) (or mark_committed) "
                             f"after the rename"),
                ))
    return findings


def _name_of(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None
