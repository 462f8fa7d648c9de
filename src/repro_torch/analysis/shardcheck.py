"""quantcheck layer 3: shard-safety checks (QL305/QL306) over traced graphs
(port of ``repro/analysis/shardcheck.py``).

The port's data parallelism is explicit: the steps call ``torch.distributed``
collectives (``launch.mesh.DataParallel``), which trace as ``c10d`` ops on
the process group they reduce over (read while the group was alive:
``trace.Collective``). So the rules read groups where the reference reads
shard_map axis names:

  QL305 lost-psum / wrong-axis collective
      In a ``mesh=`` entry every collective must reduce over the entry's
      data-parallel group, and the loss must leave the step (through the
      buffers or outputs the entry names) downstream of a reduction over
      that group. Otherwise every rank quietly trains on a different
      objective — the classic lost psum.

  QL306 uncapturable collective
      A collective inside a body that runs in a CUDA graph, over a group
      whose collectives cannot be captured (gloo runs them on the host:
      ``DataParallel.capturable``). The port has no scan with donated
      carries; its loop body is a captured step, and what can go wrong
      there is capture. The engines run such a body eagerly (their
      ``_use_graphs``), which keeps this rule quiet on the shipped code.
"""
from __future__ import annotations

from typing import List, Set

from repro_torch.analysis.report import Report
from repro_torch.analysis.trace import (TracedEntry, alias_roots,
                                        label_matches, written_nodes)


def _reduced_nodes(entry: TracedEntry) -> Set:
    """Nodes downstream of a collective over the entry's data group."""
    reduced = {c.node for c in entry.collectives if c.data_group}
    for n in entry.closed.graph.nodes:
        if n not in reduced and any(a in reduced for a in n.all_input_nodes):
            reduced.add(n)
    return reduced


def _loss_sinks(entry: TracedEntry) -> List:
    """(label, node) pairs the loss leaves through: the graph's outputs
    (``"<out>"``) and the writes into inputs whose label matches a glob of
    ``entry.loss``."""
    nodes = list(entry.closed.graph.nodes)
    sinks = []
    if "<out>" in entry.loss:
        out = next(n for n in nodes if n.op == "output")
        sinks += [("<out>", n) for n in out.all_input_nodes]
    globs = [g for g in entry.loss if g != "<out>"]
    if globs:
        root = alias_roots(entry.closed)
        label_of = dict(zip(entry.placeholders, entry.labels))
        for n in nodes:
            for w in written_nodes(n):
                lbl = label_of.get(root.get(w, w))
                if lbl and any(label_matches(lbl, g) for g in globs):
                    sinks.append((lbl, n))
    return sinks


# ------------------------------------------------------------------- QL305
def check_shard_map(entry: TracedEntry) -> Report:
    rep = Report()
    if entry.mesh is None:
        return rep
    for c in entry.collectives:
        if not c.data_group:
            rep.add("QL305", "collective-wrong-axis", "error",
                    f"graph:{entry.name}#{c.op}",
                    f"{c.op} over a group of {c.group_size} rank(s) that is "
                    f"not the entry's data-parallel group (mesh axes "
                    f"{list(entry.dp)}) — the cross-replica reduction this "
                    "entry promises runs on the wrong axis")
    reduced = _reduced_nodes(entry)
    for label, node in _loss_sinks(entry):
        if node not in reduced:
            rep.add("QL305", "lost-psum", "error",
                    f"graph:{entry.name}#{label}",
                    f"the loss leaves through {label} without a reduction "
                    f"over the data-parallel group (mesh axes "
                    f"{list(entry.dp)}) — each rank keeps a different value "
                    "(lost psum)")
            break
    return rep


# ------------------------------------------------------------------- QL306
def check_scan_collectives(entry: TracedEntry) -> Report:
    rep = Report()
    if not entry.captured:
        return rep
    for c in entry.collectives:
        if c.backend != "nccl":
            rep.add("QL306", "uncapturable-collective", "error",
                    f"graph:{entry.name}#{c.op}",
                    f"{c.op} over a {c.backend} group inside a body captured "
                    f"in a CUDA graph: {c.backend} runs its collectives on "
                    "the host, which a capture cannot hold "
                    "(DataParallel.capturable); run such a body eagerly")
    return rep


def check_shard_safety(entry: TracedEntry) -> Report:
    """QL305 + QL306 for one traced entry."""
    rep = check_shard_map(entry)
    rep.extend(check_scan_collectives(entry))
    return rep


__all__: List[str] = ["check_shard_map", "check_scan_collectives",
                      "check_shard_safety"]
