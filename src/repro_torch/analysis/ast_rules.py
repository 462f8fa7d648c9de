"""AST-level quantlint rules (QL1xx) over ``src/repro_torch/``, port of
``repro/analysis/ast_rules.py`` retargeted at the hazards of PyTorch code
that runs inside CUDA-graph captures:

  QL101 graph-outside-engine   ``torch.cuda.CUDAGraph``/``torch.cuda.graph``
                               /``torch.compile`` outside the engine caches
                               (the reconstruction engine, the probe, the
                               serving engine; allowlisted by file) — an
                               ad-hoc capture or compile is how per-call
                               recompiles and stale graphs creep in.
  QL102 host-sync-in-capture   a host sync inside a captured scope:
                               ``.item()``, ``.tolist()``, ``.cpu()``,
                               ``.numpy()``, ``int()/float()/bool()`` on a
                               value data-dependent on the scope's
                               arguments, or ``torch.as_tensor``/
                               ``torch.tensor`` with ``device=`` (a host
                               copy). Inside a capture a sync raises; in
                               the eager body that shares the code it
                               stalls every step. Taint starts at the
                               scope's arguments, propagates through
                               assignments, arithmetic and method calls,
                               and exits through static metadata
                               (``.shape``/``.dtype``/``.device``/
                               ``.numel()``/...).
  QL103 host-entropy-in-capture ``time.*``/``random.*``/``np.random.*``
                               inside a captured scope: evaluated once at
                               capture, then frozen into every replay.
  QL104 plain-default          a kernel entry in ``repro_torch/kernels/``
                               whose ``backend`` parameter defaults to
                               ``"torch"``: the plain version shipped as
                               the default (the counterpart of the
                               reference's ``interpret=True``).
  QL105 launch-without-guard   a function that launches a CUDA kernel
                               through ``kernels/build.py``'s
                               ``CudaLibrary.call`` with no visible guard:
                               no ``plan(...)`` call, no ``Plan`` argument
                               (its caller planned) and no raise on a
                               shape condition (directly or through a
                               checking helper of the module).
  QL106 adhoc-host-clock       bare ``time.time``/``time.perf_counter``/
                               ``time.monotonic`` in host code outside
                               ``repro_torch/obs/`` — use
                               ``obs.telemetry.Stopwatch``/``now()`` or a
                               span so measurements land in the sink.
                               Clocks inside captured scopes are QL103's.

Captured scopes are detected structurally, per module: the body of a
``with torch.cuda.graph(...)`` block; the functions and methods of the
module that such a body calls by name (``self.step(...)``,
``self.body()``, a closure), and those they call in turn; and the
closures returned by the module's functions that the capturing class or
function calls (the serving engine's ``make_prefill``/``make_decode``,
whose bodies it captures one by one). ``captured_scopes`` names them.

Inline suppression: ``# quantlint: ignore[QL102]`` on the flagged line or
the line above (rule id optional; bare ``quantlint: ignore`` silences all).
Full lint runs audit the suppressions themselves: an ignore comment that
suppressed nothing errors as QL110 (stale-inline-ignore), mirroring the
allowlist staleness audit. Detection is tokenizer-based, so docstrings
quoting the syntax do not count as suppressions.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.report import Report

# Calls that build a CUDA graph or a compiled callable (QL101).
GRAPH_BUILDERS = {"torch.cuda.CUDAGraph", "torch.cuda.graph", "torch.compile",
                  "torch.cuda.make_graphed_callables"}
# Attribute roots whose chains are modules or functions, not data.
_MODULE_ROOTS = {"torch", "F", "np", "numpy", "math", "dist"}
# Methods that copy a device value to the host (QL102).
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# Host clock chains QL106 polices outside repro_torch/obs/ (QL103 owns
# these inside captured scopes).
_HOST_CLOCKS = {"time.time", "time.perf_counter", "time.monotonic",
                "time.process_time", "time.perf_counter_ns",
                "time.monotonic_ns", "time.time_ns"}
_ENTROPY_ROOTS = ("time.", "random.", "np.random.", "numpy.random.")

# Attribute reads and method calls that leave tensor land: static
# metadata, concrete Python values even on a device tensor.
_TAINT_EXIT_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                     "requires_grad", "layout", "itemsize", "nbytes"}
_TAINT_EXIT_CALLS = {"numel", "dim", "size", "element_size", "data_ptr",
                     "is_contiguous", "stride"}

Scope = ast.AST  # a FunctionDef, AsyncFunctionDef, Lambda or With node


def _attr_chain(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for nested Attribute/Name nodes, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_graph_with(node: ast.AST) -> bool:
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(it.context_expr, ast.Call)
        and (_attr_chain(it.context_expr.func) or "").endswith("cuda.graph")
        for it in node.items)


def _expr_tainted(node: ast.AST, tainted: Set[str]) -> bool:
    """Is this expression's value data-dependent on the scope's arguments?

    Taint flows from names in ``tainted`` through arithmetic, subscripts
    and calls; it exits through static metadata (``x.shape[0]``,
    ``x.numel()``). A torch call with no tainted argument
    (``torch.zeros(3)``) is not tainted."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _TAINT_EXIT_ATTRS:
            return False
        chain = _attr_chain(node)
        if chain and chain.split(".")[0] in _MODULE_ROOTS:
            return False   # the module/function object itself, not data
        return _expr_tainted(node.value, tainted)
    if isinstance(node, ast.Call):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _TAINT_EXIT_CALLS):
            return False
        if any(_expr_tainted(a, tainted) for a in node.args):
            return True
        if any(kw.value is not None and _expr_tainted(kw.value, tainted)
               for kw in node.keywords):
            return True
        # method call on a tainted object: x.sum(), x.float()
        if isinstance(node.func, ast.Attribute):
            return _expr_tainted(node.func, tainted)
        return False
    if isinstance(node, ast.Subscript):
        return _expr_tainted(node.value, tainted)
    if isinstance(node, ast.Constant):
        return False
    return any(_expr_tainted(c, tainted)
               for c in ast.iter_child_nodes(node))


def _args_of(fn: ast.AST) -> Set[str]:
    a = fn.args
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def _body(scope: Scope) -> List[ast.AST]:
    return scope.body if isinstance(scope.body, list) else [scope.body]


def _scope_tainted(scope: Scope, seed: Set[str]) -> Set[str]:
    """Names data-dependent on ``seed`` (the scope's arguments): the seed
    plus assignment targets whose RHS is tainted (iterated to a bounded
    fixpoint so chains of assignments propagate)."""
    tainted = set(seed)
    if not isinstance(scope, (ast.With, ast.AsyncWith)):
        tainted |= _args_of(scope)
    for _ in range(4):
        changed = False

        def mark(target):
            nonlocal changed
            for nm in ast.walk(target):
                if isinstance(nm, ast.Name) and nm.id not in tainted:
                    tainted.add(nm.id)
                    changed = True

        for stmt in _body(scope):
            for sub in ast.walk(stmt):
                if (isinstance(sub, ast.Assign)
                        and _expr_tainted(sub.value, tainted)):
                    for t in sub.targets:
                        mark(t)
                elif (isinstance(sub, (ast.AnnAssign, ast.AugAssign))
                      and sub.value is not None
                      and _expr_tainted(sub.value, tainted)):
                    mark(sub.target)
                elif (isinstance(sub, ast.For)
                      and _expr_tainted(sub.iter, tainted)):
                    mark(sub.target)
        if not changed:
            break
    return tainted


# -------------------------------------------------------- captured scopes
def _parents(tree: ast.Module) -> Dict[int, ast.AST]:
    out = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _enclosing(node, parents, kinds):
    cur = parents.get(id(node))
    while cur is not None and not isinstance(cur, kinds):
        cur = parents.get(id(cur))
    return cur


def _returned_closure(fn: ast.AST) -> Optional[ast.AST]:
    """The nested def a function returns by name, if any."""
    nested = {n.name: n for n in fn.body
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Return) and isinstance(node.value, ast.Name)
                and node.value.id in nested):
            return nested[node.value.id]
    return None


def _find_scopes(tree: ast.Module) -> List[Tuple[str, Scope]]:
    """(qualified name, node) of every captured scope of the module: the
    graph-capture with-bodies first, then the functions they reach."""
    parents = _parents(tree)
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, funcs):
            by_name.setdefault(node.name, []).append(node)

    def qualname(fn) -> str:
        parts, cur = [fn.name], parents.get(id(fn))
        while cur is not None:
            if isinstance(cur, (ast.ClassDef,) + funcs):
                parts.append(cur.name)
            cur = parents.get(id(cur))
        return ".".join(reversed(parts))

    out: List[Tuple[str, Scope]] = []
    seen: Set[int] = set()
    todo: List[Tuple[ast.AST, Optional[ast.ClassDef]]] = []

    def add(node, name, cls):
        if id(node) not in seen:
            seen.add(id(node))
            out.append((name, node))
            todo.append((node, cls))

    for node in ast.walk(tree):
        if not _is_graph_with(node):
            continue
        fn = _enclosing(node, parents, funcs)
        cls = _enclosing(node, parents, ast.ClassDef)
        add(node, f"{qualname(fn) if fn else '<module>'}:{node.lineno}", cls)
        # closures the capturing class (or function) builds through the
        # module's factories: their bodies are what it captures
        owner = cls or fn
        if owner is None:
            continue
        for call in ast.walk(owner):
            if isinstance(call, ast.Call) and isinstance(call.func, ast.Name):
                for f in by_name.get(call.func.id, []):
                    if parents.get(id(f)) is tree:
                        inner = _returned_closure(f)
                        if inner is not None:
                            add(inner, qualname(inner), None)
    while todo:  # what the scopes call by name, transitively
        node, cls = todo.pop()
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            f = call.func
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id == "self" and cls is not None):
                for m in cls.body:
                    if isinstance(m, funcs) and m.name == f.attr:
                        add(m, qualname(m), cls)
            elif isinstance(f, ast.Name):
                for d in by_name.get(f.id, []):
                    add(d, qualname(d), _enclosing(d, parents, ast.ClassDef))
    return out


def captured_scopes(src: str) -> List[str]:
    """The qualified names of a module's captured scopes (a with-body as
    ``<function>:<line>``)."""
    return [name for name, _ in _find_scopes(ast.parse(src))]


# ------------------------------------------------------------- suppression
def _ignore_comments(src: str) -> dict:
    """``{lineno: comment text}`` for every *actual* ``# quantlint: ignore``
    comment, via the tokenizer — docstrings and string literals that merely
    contain the phrase are not suppressions and must not look like stale
    ones."""
    import io
    import tokenize

    out = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if (tok.type == tokenize.COMMENT
                    and "quantlint: ignore" in tok.string):
                out[tok.start[0]] = tok.string
    except tokenize.TokenError:  # pragma: no cover - sources always tokenize
        pass
    return out


def _suppressed(ignores: dict, lineno: int, rule: str,
                used: Optional[Set[int]] = None) -> bool:
    """Does an ignore comment on the flagged line (or the line above) cover
    ``rule``? A hit is recorded in ``used`` so full runs can error on
    comments that suppressed nothing (QL110 stale-inline-ignore)."""
    for ln in (lineno, lineno - 1):
        text = ignores.get(ln)
        if text is not None:
            tag = text.split("quantlint: ignore", 1)[1]
            if "[" not in tag or rule in tag:
                if used is not None:
                    used.add(ln)
                return True
    return False


# ------------------------------------------------------------------ guards
def _reads_shape(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "shape":
            return True
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("dim", "numel", "size")):
            return True
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod):
            return True
    return False


def _has_raise(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(fn))


def _guarded(fn: ast.AST, checkers: Set[str]) -> bool:
    """A ``plan(...)`` call, a ``Plan`` argument, or a raise on a shape
    condition (an ``if`` that raises, or a call of one of the module's
    raising ``checkers`` on a shape condition)."""
    for arg in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        if arg.annotation is not None and (
                _attr_chain(arg.annotation) or "").split(".")[-1] == "Plan":
            return True
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call):
            leaf = (_attr_chain(sub.func) or "").split(".")[-1]
            if leaf == "plan":
                return True
            if leaf in checkers and any(_reads_shape(a) for a in sub.args):
                return True
        if (isinstance(sub, ast.If) and _reads_shape(sub.test)
                and any(isinstance(n, ast.Raise) for b in sub.body
                        for n in ast.walk(b))):
            return True
    return False


# ------------------------------------------------------------------- rules
def lint_source(src: str, path: str = "<string>",
                report_stale_ignores: bool = False) -> Report:
    """Run every QL1xx rule over one module's source.

    ``report_stale_ignores=True`` (full runs only — partial layers would
    see false staleness) errors as QL110 on every inline
    ``# quantlint: ignore`` comment that suppressed nothing: a stale ignore
    is a standing blanket waiting to hide an unrelated future finding.
    """
    rep = Report()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:  # pragma: no cover - repo sources always parse
        rep.add("QL100", "syntax-error", "error", f"{path}:{e.lineno or 0}",
                str(e))
        return rep
    ignores = _ignore_comments(src)
    used_ignores: Set[int] = set()
    norm = path.replace(os.sep, "/")

    def add(rule, name, sev, lineno, msg):
        if not _suppressed(ignores, lineno, rule, used_ignores):
            rep.add(rule, name, sev, f"{path}:{lineno}", msg)

    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)

    # ---- QL101: a CUDA graph or torch.compile outside the engines -------
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _attr_chain(node.func) in GRAPH_BUILDERS:
            add("QL101", "graph-outside-engine", "error", node.lineno,
                f"{_attr_chain(node.func)} outside the engine caches; "
                "captures and compiles belong behind core.reconstruct's "
                "engine cache, the probe's cache or the serving engine (or "
                "allowlist with a reason)")
        elif isinstance(node, funcs):
            for d in node.decorator_list:
                target = d.func if isinstance(d, ast.Call) else d
                if _attr_chain(target) in GRAPH_BUILDERS:
                    add("QL101", "graph-outside-engine", "error", d.lineno,
                        f"@{_attr_chain(target)} on {node.name!r} outside "
                        "the engine caches")

    # ---- QL104: backend="torch" as a kernel entry's default -------------
    if "repro_torch/kernels/" in norm:
        for node in ast.walk(tree):
            if not isinstance(node, funcs):
                continue
            a = node.args
            pos = a.posonlyargs + a.args
            defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
            pairs = list(zip(pos, defaults)) + list(zip(a.kwonlyargs,
                                                        a.kw_defaults))
            for arg, default in pairs:
                if (arg.arg == "backend" and isinstance(default, ast.Constant)
                        and default.value == "torch"):
                    add("QL104", "plain-default", "error", node.lineno,
                        f"{node.name!r} defaults backend='torch': the plain "
                        "version is a comparison override, never the "
                        "shipped default (resolve it via resolve_backend)")

    # ---- QL105: a CUDA launch without a guard ---------------------------
    libs = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and (_attr_chain(node.value.func) or "").endswith("CudaLibrary")
            for t in node.targets if isinstance(t, ast.Name)}
    checkers = {n.name for n in tree.body if isinstance(n, funcs)
                and _has_raise(n)}
    if libs:
        for node in ast.walk(tree):
            if not isinstance(node, funcs):
                continue
            launches = any(
                isinstance(s, ast.Call) and isinstance(s.func, ast.Attribute)
                and s.func.attr == "call" and _attr_chain(s.func.value) in libs
                for s in ast.walk(node))
            if launches and not _guarded(node, checkers):
                add("QL105", "launch-without-guard", "warning", node.lineno,
                    f"{node.name!r} launches a CUDA kernel through "
                    "CudaLibrary.call with no visible guard (no plan(...), "
                    "no Plan argument, no raise on a shape condition)")

    # ---- QL102 / QL103: inside captured scopes --------------------------
    scopes = _find_scopes(tree)
    parents = _parents(tree)
    flagged: Set[tuple] = set()   # (rule, lineno): nested scopes overlap
    for _, scope in scopes:
        seed: Set[str] = set()
        if isinstance(scope, (ast.With, ast.AsyncWith)):
            # a with-body's taint starts at its function's arguments
            fn = _enclosing(scope, parents, funcs)
            seed = _args_of(fn) if fn is not None else set()
        tainted = _scope_tainted(scope, seed)
        for stmt in _body(scope):
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    chain = _attr_chain(sub.func)
                    msg = None
                    if (chain in ("int", "float", "bool") and sub.args
                            and _expr_tainted(sub.args[0], tainted)):
                        msg = (f"{chain}() on a value data-dependent on the "
                               "scope's tensors")
                    elif (isinstance(sub.func, ast.Attribute)
                          and sub.func.attr in _SYNC_METHODS
                          and not sub.args):
                        msg = f".{sub.func.attr}() copies a device value out"
                    elif (chain in ("torch.as_tensor", "torch.tensor")
                          and any(kw.arg == "device" for kw in sub.keywords)):
                        msg = f"{chain}(..., device=) copies a host value in"
                    if msg and ("QL102", sub.lineno) not in flagged:
                        flagged.add(("QL102", sub.lineno))
                        add("QL102", "host-sync-in-capture", "error",
                            sub.lineno,
                            f"{msg} inside a captured scope — a host sync: "
                            "the capture raises, the eager body stalls")
                chain = _attr_chain(sub)
                if chain and chain.startswith(_ENTROPY_ROOTS) \
                        and ("QL103", sub.lineno) not in flagged:
                    flagged.add(("QL103", sub.lineno))
                    add("QL103", "host-entropy-in-capture", "error",
                        sub.lineno,
                        f"{chain} inside a captured scope — evaluated once "
                        "at capture, then frozen into every replay")

    # ---- QL106: ad-hoc host clock outside the telemetry layer -----------
    # obs/ is exempt; an ignore there still counts as used: the reference's
    # linter lints src/ too and exempts only repro/obs/
    in_obs = "repro_torch/obs/" in norm
    captured_lines: Set[int] = set()
    for _, scope in scopes:
        end = getattr(scope, "end_lineno", None) or scope.lineno
        captured_lines.update(range(scope.lineno, end + 1))
    for node in ast.walk(tree):
        chain = _attr_chain(node)
        if (chain in _HOST_CLOCKS
                and node.lineno not in captured_lines
                and ("QL106", node.lineno) not in flagged):
            flagged.add(("QL106", node.lineno))
            if in_obs:
                _suppressed(ignores, node.lineno, "QL106", used_ignores)
            else:
                add("QL106", "adhoc-host-clock", "error", node.lineno,
                    f"{chain} outside repro_torch.obs — ad-hoc timing "
                    "bypasses telemetry; use obs.telemetry.Stopwatch/now() "
                    "or a span so the measurement lands in the sink")

    # ---- QL110: inline ignore that suppressed nothing -------------------
    if report_stale_ignores:
        for ln in sorted(set(ignores) - used_ignores):
            rep.add("QL110", "stale-inline-ignore", "error", f"{path}:{ln}",
                    f"inline suppression {ignores[ln].strip()!r} matched no "
                    "finding — the violation it excused is gone; drop the "
                    "comment before it hides an unrelated future finding")
    return rep


def lint_file(path: str) -> Report:
    with open(path) as fh:
        src = fh.read()
    return lint_source(src, path)


def lint_tree(root: str, rel_to: Optional[str] = None,
              report_stale_ignores: bool = False) -> Report:
    """Lint every .py file under ``root``; finding paths are reported
    relative to ``rel_to`` (default: cwd) so allowlist globs like
    ``src/repro_torch/kernels/*`` match regardless of where lint runs."""
    rep = Report()
    rel_to = rel_to or os.getcwd()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith((".", "__")))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            shown = os.path.relpath(full, rel_to)
            with open(full) as fh:
                src = fh.read()
            rep.extend(lint_source(src, shown,
                                   report_stale_ignores=report_stale_ignores))
    return rep
