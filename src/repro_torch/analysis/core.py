"""Shared model for spotlint rules: parsed modules, suppressions, baseline.

Everything here is stdlib-only (``ast`` + ``re``); rule modules consume a
:class:`RepoModel` built once over all analyzed files so cross-module rules
(lock graph, lane taint) see the whole picture.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Iterator, Optional

# `# spotlint: ignore[SPOT001]` or `# spotlint: ignore[SPOT001, SPOT031]`
SUPPRESS_RE = re.compile(r"#\s*spotlint:\s*ignore\[([A-Z0-9,\s]+)\]")

# Attribute-call names too generic to resolve to a repo method: calling
# `obj.get(...)` must not be treated as a call into every class that happens
# to define a `get` method (that is how a lock graph grows phantom cycles).
GENERIC_METHODS = frozenset({
    "get", "put", "pop", "append", "add", "remove", "discard", "clear",
    "update", "items", "keys", "values", "read", "write", "close", "wait",
    "set", "result", "cancel", "join", "start", "submit", "touch", "check",
    "copy", "encode", "decode", "format", "strip", "split", "exists",
    "mkdir", "unlink", "acquire", "release", "notify", "notify_all",
    "task_done", "get_nowait", "put_nowait",
})


@dataclass(frozen=True)
class Finding:
    path: str  # path as given on the command line / relative to cwd
    line: int
    col: int
    code: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.code)


@dataclass
class ModuleInfo:
    path: str  # absolute path on disk
    relpath: str  # as reported in findings
    module_name: str  # dotted, e.g. "repro_torch.checkpoint.store"
    source: str
    lines: list[str]
    tree: ast.Module
    suppressed: dict[int, set[str]] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


@dataclass
class FuncEntry:
    name: str
    classname: Optional[str]
    module: ModuleInfo
    node: ast.FunctionDef | ast.AsyncFunctionDef

    @property
    def qualname(self) -> str:
        if self.classname:
            return f"{self.module.module_name}.{self.classname}.{self.name}"
        return f"{self.module.module_name}.{self.name}"


def parse_suppressions(lines: list[str]) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(line)
        if m:
            codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
            out[i] = codes
    return out


def module_name_for(relpath: str) -> str:
    parts = relpath.replace(os.sep, "/").split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def load_module(path: str, relpath: str) -> Optional[ModuleInfo]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError):
        return None
    lines = source.splitlines()
    return ModuleInfo(
        path=path,
        relpath=relpath,
        module_name=module_name_for(relpath),
        source=source,
        lines=lines,
        tree=tree,
        suppressed=parse_suppressions(lines),
    )


# -- AST helpers ---------------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c"; `name` -> "name"; anything else -> None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        if base is None:
            return None
        return f"{base}.{node.attr}"
    return None


def terminal_name(func: ast.AST) -> Optional[str]:
    """Last path component of a call target: os.replace -> "replace"."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def iter_funcs(tree: ast.Module) -> Iterator[tuple[Optional[str], ast.FunctionDef | ast.AsyncFunctionDef]]:
    """Yield (enclosing class name or None, function node) for every def,
    including nested defs (attributed to the enclosing class, if any)."""

    def walk(node: ast.AST, classname: Optional[str]) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield classname, child
                yield from walk(child, classname)
            else:
                yield from walk(child, classname)

    yield from walk(tree, None)


def calls_in(node: ast.AST) -> list[ast.Call]:
    """All Call nodes under `node`, in source order."""
    out = [n for n in ast.walk(node) if isinstance(n, ast.Call)]
    out.sort(key=lambda c: (c.lineno, c.col_offset))
    return out


class RepoModel:
    """Cross-module index built once and shared by all rules."""

    def __init__(self, modules: list[ModuleInfo]):
        self.modules = modules
        # bare function/method name -> every def with that name
        self.functions: dict[str, list[FuncEntry]] = {}
        # (module_name, classname) of classes that define close()/__exit__
        self.closeable_classes: set[tuple[str, str]] = set()
        for mod in modules:
            for classname, fn in iter_funcs(mod.tree):
                self.functions.setdefault(fn.name, []).append(
                    FuncEntry(name=fn.name, classname=classname, module=mod, node=fn))
                if classname and fn.name in ("close", "__exit__", "release"):
                    self.closeable_classes.add((mod.module_name, classname))

    def resolve_call(self, call: ast.Call, module: ModuleInfo,
                     classname: Optional[str]) -> list[FuncEntry]:
        """Map a call site to candidate FuncEntry targets.

        - bare `name(...)`: a module-level def named `name` — same module
          first, else a unique repo-wide module-level def (covers
          `from .x import name` without import tracking);
        - `self.m(...)`: method `m` of the enclosing class;
        - `obj.m(...)`: any method named `m`, unless `m` is too generic
          (GENERIC_METHODS) to resolve soundly.
        """
        func = call.func
        if isinstance(func, ast.Name):
            cands = self.functions.get(func.id, [])
            local = [e for e in cands
                     if e.module is module and e.classname is None]
            if local:
                return local
            toplevel = [e for e in cands if e.classname is None]
            if len(toplevel) == 1:
                return toplevel
            return []
        if isinstance(func, ast.Attribute):
            name = func.attr
            if isinstance(func.value, ast.Name) and func.value.id == "self" and classname:
                return [e for e in self.functions.get(name, [])
                        if e.module is module and e.classname == classname]
            if name in GENERIC_METHODS:
                return []
            return [e for e in self.functions.get(name, [])
                    if e.classname is not None]
        return []


# -- baseline ------------------------------------------------------------------


@dataclass
class BaselineEntry:
    relpath: str
    code: str
    lineno: int
    content: str  # stripped source line the suppression was recorded against
    used: bool = False

    def key(self) -> tuple[str, str, int]:
        return (self.relpath, self.code, self.lineno)


def load_baseline(path: str) -> list[BaselineEntry]:
    entries: list[BaselineEntry] = []
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t", 3)
            if len(parts) != 4:
                raise ValueError(f"malformed baseline line: {line!r}")
            relpath, code, lineno_s, content = parts
            entries.append(BaselineEntry(relpath=relpath, code=code,
                                         lineno=int(lineno_s), content=content))
    return entries


def stale_baseline_entries(entries: list[BaselineEntry],
                           root: str = ".") -> list[str]:
    """Entries whose target file/line no longer matches the recorded content.

    A baseline suppression is a promise about one specific line; once that
    line moves or changes, the promise must be re-examined, so a stale entry
    fails the run instead of silently suppressing whatever now lives there.
    """
    problems: list[str] = []
    for e in entries:
        path = os.path.join(root, e.relpath)
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            problems.append(f"{e.relpath}: file missing for baseline entry "
                            f"{e.code} line {e.lineno}")
            continue
        if not (1 <= e.lineno <= len(lines)):
            problems.append(f"{e.relpath}:{e.lineno}: baseline entry {e.code} "
                            f"points past end of file ({len(lines)} lines)")
            continue
        if lines[e.lineno - 1].strip() != e.content:
            problems.append(
                f"{e.relpath}:{e.lineno}: baseline entry {e.code} is stale — "
                f"line now reads {lines[e.lineno - 1].strip()!r}, baseline "
                f"recorded {e.content!r}")
    return problems
