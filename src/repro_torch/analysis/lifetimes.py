"""SPOT020/021 — zero-copy buffer lifetimes and the one-copy payload rule.

The read path hands out ``memoryview``s over pool-owned mmaps
(``mmap_view`` / ``ChunkPool.read_view`` / ``read_payload_view``): cheap,
but the mapping behind the view can be unmapped on eviction, so a view must
stay inside a scope that ends with ``release_view`` (or be returned, which
transfers that obligation to the caller, or live on an object that owns the
mapping and exposes ``close``). A view stashed on ``self``/a global with no
close path outlives its mapping and becomes a use-after-unmap (SPOT020).

The write path has the dual rule (the snapshot freeze): snapshot payloads
must be built from *copied* host arrays — ``np.asarray(x)`` on a caller-
owned array is a no-copy alias, and the async writer thread then encodes
memory the training step is concurrently mutating, producing a checkpoint
that is internally torn (SPOT021). Use ``serialize.to_host`` /
``np.array(..., copy=True)``. In the PyTorch port's checkpoint layer the
same rule also knows torch's aliasing forms: ``t.numpy()`` and
``torch.from_numpy(a)`` share memory with their operand, and ``.cpu()`` /
``.to("cpu")`` return the tensor itself when it already lives on the host.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, ModuleInfo, RepoModel, dotted, iter_funcs, terminal_name

# producers of mmap-backed views whose release must be tracked
VIEW_PRODUCERS = {"mmap_view", "read_view", "read_payload_view"}
# additionally forbidden from living on self/globals without a close path
STORED_VIEW_PRODUCERS = VIEW_PRODUCERS | {"memoryview"}


def check_repo(model: RepoModel) -> list[Finding]:
    findings: list[Finding] = []
    for mod in model.modules:
        findings.extend(_check_module(mod, model))
    return findings


def _check_module(mod: ModuleInfo, model: RepoModel) -> list[Finding]:
    findings: list[Finding] = []

    # module-level `NAME = mmap_view(...)` — a global view never dies
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and _producer_of(node.value,
                                                        STORED_VIEW_PRODUCERS):
            findings.append(Finding(
                path=mod.relpath, line=node.lineno, col=node.col_offset,
                code="SPOT020",
                message=("mmap/memoryview stored in a module global — the "
                         "view outlives any release scope and pins (or "
                         "dangles into) its mapping forever; keep views "
                         "function-local with release_view, or on an object "
                         "with close()"),
            ))

    for classname, fn in iter_funcs(mod.tree):
        findings.extend(_check_fn(mod, model, classname, fn))
    return findings


def _producer_of(expr: ast.AST, producers: set[str]) -> Optional[str]:
    if isinstance(expr, ast.Call):
        t = terminal_name(expr.func)
        if t in producers:
            return t
    return None


def _check_fn(mod: ModuleInfo, model: RepoModel, classname: Optional[str],
              fn) -> list[Finding]:
    findings: list[Finding] = []

    locals_to_track: list[tuple[str, ast.Assign]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        producer = _producer_of(node.value, STORED_VIEW_PRODUCERS)
        if producer is None:
            continue
        # self.X = <view producer>: allowed only when the class owns the
        # lifetime, i.e. defines close()/__exit__/release()
        if isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) \
                and tgt.value.id == "self":
            if classname and (mod.module_name, classname) in model.closeable_classes:
                continue
            findings.append(Finding(
                path=mod.relpath, line=node.lineno, col=node.col_offset,
                code="SPOT020",
                message=(f"view stored on self.{tgt.attr} but "
                         f"{classname or 'this class'} has no close()/"
                         f"__exit__ — the view escapes every release scope; "
                         f"give the class a close() that release_view()s it, "
                         f"or keep the view function-local"),
            ))
        elif isinstance(tgt, ast.Name) \
                and _producer_of(node.value, VIEW_PRODUCERS):
            locals_to_track.append((tgt.id, node))

    if locals_to_track:
        released: set[str] = set()
        returned: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and terminal_name(node.func) == "release_view":
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        released.add(arg.id)
            elif isinstance(node, ast.Return) and node.value is not None:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name):
                        returned.add(sub.id)
        for name, assign in locals_to_track:
            if name in released or name in returned:
                continue
            findings.append(Finding(
                path=mod.relpath, line=assign.lineno, col=assign.col_offset,
                code="SPOT020",
                message=(f"mmap-backed view {name!r} is neither "
                         f"release_view()'d nor returned from "
                         f"{fn.name!r} — the mapping leaks and a later "
                         f"eviction turns the view into a use-after-unmap; "
                         f"release it in a finally block or return it to "
                         f"transfer ownership"),
            ))

    # SPOT021: np.asarray on a bare name in the checkpoint layer aliases
    # caller memory into the payload instead of copying it. Scoped to
    # repro.checkpoint.* — elsewhere (kernels, optim) asarray is a
    # device→host materialization, which *does* copy. Exempt:
    #   - jnp/jax.asarray (host→device put, copies);
    #   - float(np.asarray(x)) / int(...) scalar conversions (no buffer
    #     survives);
    #   - functions that also call x.copy() or np.array(x, ...): the
    #     to_host idiom, where asarray is the jax/sequence branch and the
    #     numpy branch is explicitly copied.
    # The port's checkpoint layer has a rule of its own, with torch's
    # aliasing forms (below).
    if mod.module_name.startswith("repro_torch.checkpoint"):
        return findings + _torch_aliases(mod, fn)
    if not mod.module_name.startswith("repro.checkpoint"):
        return findings
    scalar_wrapped: set[int] = set()
    copied_names: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        t = terminal_name(node.func)
        if isinstance(node.func, ast.Name) and node.func.id in ("float", "int"):
            for arg in node.args:
                scalar_wrapped.add(id(arg))
        elif t == "copy" and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name):
            copied_names.add(node.func.value.id)
        elif t == "array" and node.args and isinstance(node.args[0], ast.Name):
            copied_names.add(node.args[0].id)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and terminal_name(node.func) == "asarray" \
                and node.args and isinstance(node.args[0], ast.Name):
            d = dotted(node.func) or ""
            if d.startswith(("jnp.", "jax.")):
                continue
            if id(node) in scalar_wrapped:
                continue
            if node.args[0].id in copied_names:
                continue
            findings.append(Finding(
                path=mod.relpath, line=node.lineno, col=node.col_offset,
                code="SPOT021",
                message=(f"np.asarray({node.args[0].id}) does not copy — a "
                         f"snapshot leaf built from it aliases memory the "
                         f"training step keeps mutating while the writer "
                         f"thread encodes it (torn checkpoint); use "
                         f"serialize.to_host / np.array(..., copy=True)"),
            ))
    return findings


# SPOT021 in the port's checkpoint layer (repro_torch.checkpoint.*): a
# snapshot or restore leaf built from any of these shares memory with its
# operand, which the caller still owns:
#   - x.numpy()            a CPU tensor's own storage;
#   - np.asarray(x)        a tensor or array, uncopied;
#   - torch.from_numpy(a)  the caller's array;
#   - serialize.tensor_to_numpy(x) / serialize.numpy_to_tensor(a, ...), the
#     port's wrappers of the two above (dtypes numpy lacks): their call
#     sites are judged, and their own bodies are not.
# An operand is a candidate when its chain of attribute, subscript and
# method-call links ends at a name (`staged[k].numpy()`,
# `self.diff.numpy()`); a fresh call's result has no other owner.
# Exempt, as copies or no buffer at all:
#   - an operand whose chain holds .clone(), .copy(), HostCopy(...) (which
#     clones a CPU tensor) or np.array(...) with copy left true, or a name
#     every assignment of this function binds to one of those;
#   - np.asarray(x) where the function copies x elsewhere (the to_host
#     idiom, as above; not for .numpy() and from_numpy, whose other
#     branch is then the alias);
#   - the alias consumed at once by one of those (`x.numpy().copy()`,
#     `np.array(t.numpy())`, `HostCopy(torch.from_numpy(a))`);
#   - scalar float(...) / int(...) / .item() (no buffer survives).
# .cpu() and .to("cpu") copy a CUDA tensor but return a CPU tensor itself,
# so they exempt nothing.
ALIAS_COPIES = {"clone", "copy", "HostCopy"}
ALIAS_HELPERS = {"tensor_to_numpy", "numpy_to_tensor"}
ALIAS_HELPERS_MODULE = "repro_torch.checkpoint.serialize"
ALIAS_SCALARS = {"float", "int"}
ARRAY_MODULES = {"np", "numpy", "torch"}
ALLOCATORS = {"empty", "zeros", "ones", "full", "arange", "empty_like",
              "zeros_like", "ones_like", "full_like"}


def _copying_array(call: ast.Call) -> bool:
    """np.array(...) copies unless told `copy=False` / `copy=None`."""
    if terminal_name(call.func) != "array":
        return False
    for kw in call.keywords:
        if kw.arg == "copy":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value in (False, None))
    return True


def _is_copy_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and (
        terminal_name(node.func) in ALIAS_COPIES or _copying_array(node))


def _chain_root(expr: ast.AST) -> tuple[Optional[str], bool]:
    """(root name, whether a copy sits on the chain) of an operand such as
    `staged[k].view(d).numpy`'s receiver; root None for a fresh value. A
    numpy or torch function (`np.array(a, copy=False)`) passes on its first
    argument, unless it allocates."""
    copied = False
    while True:
        if _is_copy_call(expr):
            copied = True
        if isinstance(expr, ast.Call) \
                and (dotted(expr.func) or "").split(".")[0] in ARRAY_MODULES:
            if not expr.args or terminal_name(expr.func) in ALLOCATORS:
                return None, copied
            expr = expr.args[0]
        elif isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
            expr = expr.func.value
        elif isinstance(expr, (ast.Attribute, ast.Subscript)):
            expr = expr.value
        elif isinstance(expr, ast.Name):
            return expr.id, copied
        else:
            return None, copied


def _copied_names(fn) -> tuple[set[str], set[str]]:
    """(names every assignment of this function binds to a copy, as
    `h = t.clone()`, two passes so `g = h` too; names the function copies
    somewhere, `x.clone()` / `x.copy()` / `np.array(x)` / `HostCopy(x)`:
    the to_host idiom, where one branch copies and another normalizes)."""
    idiom: set[str] = set()
    bound: dict[str, list[ast.AST]] = {}
    simple: set[int] = set()        # `name = value` targets
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            simple.add(id(node.targets[0]))
            bound.setdefault(node.targets[0].id, []).append(node.value)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _is_copy_call(node):
            if isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name):
                idiom.add(node.func.value.id)
            if node.args and isinstance(node.args[0], ast.Name):
                idiom.add(node.args[0].id)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store) \
                and id(node) not in simple:     # loops, unpacking: untracked
            bound.setdefault(node.id, []).append(node)
    args = fn.args
    params = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    copies: set[str] = set()
    for _ in range(2):
        for name, values in bound.items():
            if name not in params \
                    and all(_operand_copied(v, copies) for v in values):
                copies.add(name)
    return copies, idiom


def _operand_copied(expr: ast.AST, copied: set[str]) -> bool:
    if isinstance(expr, ast.IfExp):
        return (_operand_copied(expr.body, copied)
                and _operand_copied(expr.orelse, copied))
    root, on_chain = _chain_root(expr)
    return on_chain or (root is not None and root in copied)


def _consumed_as_copy(node: ast.Call, parents: dict[int, ast.AST]) -> bool:
    parent = parents.get(id(node))
    if isinstance(parent, ast.Call) and node in parent.args:
        if isinstance(parent.func, ast.Name) \
                and parent.func.id in ALIAS_SCALARS:
            return True
        return _is_copy_call(parent)
    if isinstance(parent, ast.Attribute) and parent.value is node \
            and parent.attr in ALIAS_COPIES | {"item"}:
        return isinstance(parents.get(id(parent)), ast.Call)
    return False


def _alias_operand(node: ast.Call) -> Optional[tuple[str, ast.AST]]:
    """(form, operand) when `node` is one of the aliasing forms."""
    t = terminal_name(node.func)
    if t == "numpy" and isinstance(node.func, ast.Attribute) \
            and not node.args:
        return "numpy", node.func.value
    if t in ("asarray", "from_numpy") and node.args:
        d = dotted(node.func) or ""
        if t == "asarray" and d.startswith(("jnp.", "jax.")):
            return None
        return t, node.args[0]
    if t in ALIAS_HELPERS and node.args:
        return t, node.args[0]
    return None


def _torch_aliases(mod: ModuleInfo, fn) -> list[Finding]:
    if mod.module_name == ALIAS_HELPERS_MODULE and fn.name in ALIAS_HELPERS:
        return []
    parents: dict[int, ast.AST] = {}
    for node in ast.walk(fn):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    copies, idiom = _copied_names(fn)
    findings: list[Finding] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        hit = _alias_operand(node)
        if hit is None:
            continue
        form, operand = hit
        root, on_chain = _chain_root(operand)
        if root is None or on_chain or root in copies \
                or (form == "asarray" and root in idiom) \
                or _consumed_as_copy(node, parents):
            continue
        findings.append(Finding(
            path=mod.relpath, line=node.lineno, col=node.col_offset,
            code="SPOT021",
            message=(f"{ast.unparse(node)} shares memory with {root!r} — a "
                     f"snapshot leaf built from it is torn by the owner's "
                     f"next in-place write while the writer thread encodes "
                     f"it, and a restored leaf built from it is written "
                     f"through by the buffer's other owner (.cpu() and "
                     f".to('cpu') return a host tensor itself); copy it "
                     f"with .clone(), HostCopy or np.array(..., copy=True)"),
        ))
    return findings
