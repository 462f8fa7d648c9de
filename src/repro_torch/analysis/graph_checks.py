"""Graph-level analyzers (QL2xx) over
:class:`~repro_torch.analysis.trace.TracedEntry` (port of
``repro/analysis/jaxpr_checks.py``; the graphs are ``make_fx`` aten graphs
where the reference reads jaxprs).

  QL201 unused-input        a leaf passed into the traced body is dead in
                            the graph: no live node reads it. This is the
                            analyzer that proves "a_state actually flows
                            into the kernel" — the reference's a_state-drop
                            class of bug.
  QL202 retrace-budget      engines built, graphs captured or compile
                            counters grow with layer count instead of
                            staying flat under the engine cache.
  QL203 alias-unsafe        two labelled inputs share storage where at
                            least one is written in place (what the
                            engines' separate buffers guarantee, and what
                            the reference's ``optim/adam.py:74-76``
                            donation fault broke), or a written input is
                            returned (as itself or a view): the caller
                            would hold a handle the next step overwrites.
  QL204 f64-promotion       a float64 value inside the traced quant path
                            (silent 2x memory, slow path). The plain W8A8
                            accumulator is one on purpose: its location
                            reads ``f64-int-acc/<op>`` and the allowlist
                            excuses it (``kernels/ref.py:qmatmul_int8_ref``).
  QL205 weak-type-output    torch has no weakly typed values: the rule
                            never fires (kept for the catalog's numbering).
  QL206 sharding-unconstrained  an entry that declares ``mesh=`` holds no
                            collective over its data-parallel group —
                            "sharded" in the docstring only.

Liveness: a node is live when the output reads it, when it writes in place
into an input's storage (state the caller keeps), when it is a collective,
or when it writes into a storage some live node reads; everything a live
node reads is live.

``no_retrace`` is the reusable compile-flatness guard: it snapshots
``engine_stats()`` (``compile_count`` and ``engine_builds``) and
``obs.compile_events.captures()``, and raises :class:`RetraceError` if any
of them grows past the budget. ``step_compiles`` counts captures, which
the CPU makes none of, so a guard on ``compile_count`` alone would let a
per-layer retrace through on the CPU; ``engine_builds`` catches it there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
from typing import Dict, Set

import torch

from repro_torch.analysis.report import Report
from repro_torch.analysis.trace import (TracedEntry, alias_roots,
                                        is_collective, op_name, toy_chain,
                                        toy_recipe, written_nodes)
from repro_torch.device import DeviceLike, resolve_device


def where(entry: TracedEntry, tail: str) -> str:
    return f"graph:{entry.name}#{tail}"


# ------------------------------------------------------------ liveness
def live_nodes(gm) -> Set:
    """The nodes whose values reach the output, the caller's state or a
    collective (module docstring)."""
    nodes = list(gm.graph.nodes)
    root = alias_roots(gm)
    inputs = {n for n in nodes if n.op == "placeholder"}
    writes = {n: {root.get(w, w) for w in written_nodes(n)} for n in nodes}
    live: Set = set()

    def mark(stack):
        while stack:
            n = stack.pop()
            if n in live:
                continue
            live.add(n)
            stack.extend(n.all_input_nodes)

    mark([n for n in nodes if n.op == "output" or is_collective(n)
          or writes[n] & inputs])
    changed = True
    while changed:  # a write into a storage a live node reads is live
        live_storages = {root.get(n, n) for n in live}
        pending = [n for n in nodes
                   if n not in live and writes[n] & live_storages]
        changed = bool(pending)
        mark(pending)
    return live


def used_inputs(entry: TracedEntry):
    live = live_nodes(entry.closed)
    return [n in live for n in entry.placeholders]


# --------------------------------------------------------- QL201 unused input
def check_unused_inputs(entry: TracedEntry) -> Report:
    rep = Report()
    for label, u in zip(entry.labels, used_inputs(entry)):
        if u:
            continue
        if any(fnmatch.fnmatch(label, pat) for pat in entry.allow_unused):
            rep.add("QL201", "unused-input", "info", where(entry, label),
                    "dead leaf (explicitly allowed for this entry)")
            continue
        rep.add("QL201", "unused-input", "error", where(entry, label),
                "leaf is passed into the traced body but dead in the graph "
                "— state silently not consumed (the a_state-drop failure "
                "class)")
    return rep


# ------------------------------------------------------------- QL203 aliasing
def _span(t: torch.Tensor):
    st = t.untyped_storage()
    return st.data_ptr(), st.data_ptr() + st.nbytes()


def check_donation(entry: TracedEntry) -> Report:
    """QL203 in its torch meaning (module docstring)."""
    rep = Report()
    written = set(entry.donated)
    spans = []
    for i, t in enumerate(entry.leaves):
        try:
            lo, hi = _span(t)
        except Exception:  # a storage without a pointer
            continue
        if hi > lo:
            spans.append((lo, hi, i))
    spans.sort()
    for a in range(len(spans)):
        lo, hi, i = spans[a]
        for b in range(a + 1, len(spans)):
            lo2, _, j = spans[b]
            if lo2 >= hi:
                break
            if i in written or j in written:
                w, o = (i, j) if i in written else (j, i)
                rep.add("QL203", "alias-unsafe", "error",
                        where(entry, entry.labels[w]),
                        f"written in place but shares its storage with "
                        f"{entry.labels[o]} — one buffer updated through "
                        "two names (give every state its own buffer, as the "
                        "engines' separate static buffers do)")
    root = alias_roots(entry.closed)
    ph = {n: i for i, n in enumerate(entry.placeholders)}
    out = next(n for n in entry.closed.graph.nodes if n.op == "output")
    for n in out.all_input_nodes:
        i = ph.get(root.get(n, n))
        if i is not None and i in written:
            rep.add("QL203", "alias-unsafe", "error",
                    where(entry, entry.labels[i]),
                    "an input written in place is returned (itself or a "
                    "view) — the caller receives a handle to state the next "
                    "step overwrites")
    return rep


# ------------------------------------------------- QL204/QL205 promotion
_CONTRACTIONS = ("mm", "bmm", "addmm", "matmul", "dot", "baddbmm")


def _int_valued(node, memo: Dict) -> bool:
    """Whether a float64 node holds exact integers by construction: a
    conversion of an integer tensor, a view of one, or a contraction of
    such operands (the plain W8A8 accumulator)."""
    if node in memo:
        return memo[node]
    memo[node] = False
    if node.op != "call_function":
        return False
    name = op_name(node)
    ins = node.all_input_nodes
    if name == "_to_copy" and ins:
        src = ins[0].meta.get("val")
        ok = isinstance(src, torch.Tensor) and not (
            src.dtype.is_floating_point or src.dtype.is_complex)
        memo[node] = ok
        return ok
    sch = getattr(node.target, "_schema", None)
    if sch is not None and sch.returns and sch.returns[0].alias_info and ins:
        memo[node] = _int_valued(ins[0], memo)
        return memo[node]
    if name in _CONTRACTIONS and ins:
        memo[node] = all(_int_valued(a, memo) for a in ins)
    return memo[node]


def check_promotion(entry: TracedEntry) -> Report:
    rep = Report()
    flagged = set()
    memo: Dict = {}
    for n in entry.closed.graph.nodes:
        if n.op != "call_function":
            continue
        val = n.meta.get("val")
        vals = val if isinstance(val, (list, tuple)) else [val]
        if not any(isinstance(v, torch.Tensor) and v.dtype == torch.float64
                   for v in vals):
            continue
        tail = op_name(n)
        if _int_valued(n, memo):
            tail = f"f64-int-acc/{tail}"
        if tail in flagged:
            continue
        flagged.add(tail)
        rep.add("QL204", "f64-promotion", "error", where(entry, tail),
                "float64 value inside the traced quant path (unintended "
                "promotion: 2x memory, slow path)")
    return rep


# ------------------------------------------------------------ QL206 sharding
def check_sharding(entry: TracedEntry) -> Report:
    rep = Report()
    if entry.mesh is None or not entry.dp:
        return rep
    if not any(c.data_group for c in entry.collectives):
        rep.add("QL206", "sharding-unconstrained", "error",
                where(entry, "mesh"),
                f"entry declares mesh axes {entry.dp} but its graph holds no "
                "collective over their data-parallel group — the "
                "data-parallel contract exists only in the docstring")
    return rep


def check_entry(entry: TracedEntry) -> Report:
    rep = Report()
    rep.extend(check_unused_inputs(entry))
    rep.extend(check_donation(entry))
    rep.extend(check_promotion(entry))
    rep.extend(check_sharding(entry))
    return rep


# ----------------------------------------------------------- QL202 retrace
class RetraceError(AssertionError):
    """Raised by ``no_retrace`` when the compile counters move past the
    budget."""


@contextlib.contextmanager
def no_retrace(budget: int = 0):
    """Assert compile flatness across the enclosed region: the growth of
    ``engine_stats().compile_count``, of ``engine_stats().engine_builds``
    and of the CUDA-graph captures (``obs.compile_events.captures()``)
    must each stay within ``budget``."""
    from repro_torch.core import reconstruct as rec
    from repro_torch.obs import compile_events

    s0 = dataclasses.replace(rec.engine_stats())
    c0 = compile_events.captures()
    yield
    s1 = rec.engine_stats()
    deltas = {"compile_count": s1.compile_count - s0.compile_count,
              "engine_builds": s1.engine_builds - s0.engine_builds,
              "captures": compile_events.captures() - c0}
    over = {k: v for k, v in deltas.items() if v > budget}
    if over:
        raise RetraceError(
            f"{', '.join(f'{k} grew by {v}' for k, v in over.items())} "
            f"(budget {budget}): step +{s1.step_compiles - s0.step_compiles}"
            f", probe +{s1.probe_compiles - s0.probe_compiles}, engines "
            f"built +{deltas['engine_builds']}, hit "
            f"+{s1.engine_hits - s0.engine_hits}, graph captures "
            f"+{deltas['captures']}")


def _run_chain(blocks, recipe, d: int, mesh=None, device=None):
    from repro_torch.core import reconstruct as rec
    from repro_torch.analysis.trace import _normal
    dev = resolve_device(device)
    x = _normal((recipe.batch_size, d), 31, dev)
    y = _normal((recipe.batch_size, d), 32, dev)
    for b in blocks:
        rec.reconstruct_block(b, recipe, x, y, 0, mesh=mesh)


def check_retrace(per_layer: bool = False, n_small: int = 2,
                  n_large: int = 4, iters: int = 4, d: int = 16, mesh=None,
                  device: DeviceLike = None) -> Report:
    """Compile counts must stay flat across layer count: warm the engine
    cache on a short chain, then demand no new engine, capture or compile
    for a longer chain of structurally identical blocks.

    ``per_layer=True`` is the seeded regression: blocks with ``apply_key=
    None`` defeat engine sharing, so every layer builds (and, on a card,
    captures) an engine of its own — QL202 must fire."""
    rep = Report()
    dev = resolve_device(device)
    token = None if per_layer else "quantlint-retrace"
    recipe = toy_recipe(iters=iters, batch_size=4)
    suffix = "_sharded" if mesh is not None else ""
    tag = f"graph:recon_chain{suffix}#L{n_small}->L{n_large}"
    _run_chain(toy_chain(n_small, token=token, d=d, device=dev), recipe, d,
               mesh, dev)
    try:
        with no_retrace(0):
            _run_chain(toy_chain(n_large, token=token, d=d, device=dev),
                       recipe, d, mesh, dev)
    except RetraceError as e:
        rep.add("QL202", "retrace-budget", "error", tag,
                f"compile counts grew with layer count: {e}")
    else:
        rep.add("QL202", "retrace-budget", "info", tag,
                "compile-flat across layer count")
    return rep


__all__ = ["RetraceError", "check_donation", "check_entry",
           "check_promotion", "check_retrace", "check_sharding",
           "check_unused_inputs", "live_nodes", "no_retrace", "used_inputs",
           "where"]
