"""memcheck — graph-level liveness and device-memory budgets (QL4xx), port
of ``repro/analysis/memcheck.py`` over ``make_fx`` aten graphs.

The fourth quantlint layer. The first three prove *value* properties (AST
hygiene, dataflow wiring, interval numerics); this one proves *memory*
properties over the same :class:`~repro_torch.analysis.trace.TracedEntry`
graphs, against the per-entry :class:`MemContract` budgets the trace
entry functions declare:

  QL401 hbm-budget          peak live bytes exceed the entry's declared
                            budget — at the traced window length or scaled
                            to the production envelope (serve_kv seq_max).
  QL402 dead-donation       a carry the graph never writes in place: the
                            step's update lands in a freshly allocated
                            result (or nowhere) and the state the caller
                            keeps never moves — the silent inverse of QL203
                            (which catches *unsafe* in-place state).
  QL403 weight-traffic      the bytes of the graph's live inputs for a
                            labelled group (packed weights, KV state)
                            drifted from what the port's accessors
                            (``tree_weight_bytes``, ``serve/kv.py``'s
                            ``cache_bytes``/``hbm_per_slot_bytes``) claim.
  QL404 cache-growth (info) window state whose footprint scales with the
                            *allocated* ``max_len``, not the used length:
                            the quantified paged-KV gap (``--mem-json``).
  QL405 kv-gap-static       the int8-vs-bf16 per-token KV gap proven (info)
                            or refuted (error) from the two serve_decode
                            graphs alone, each slot's bytes held to
                            ``hbm_per_slot_bytes``.

Liveness model
--------------
Storages, not nodes: a view, an in-place op and a collective allocate
nothing (their result shares an operand's storage, ``trace.alias_roots``);
every other node owns a new storage of ``meta["val"]``'s bytes,
allocated when it runs (while its operands are still held) and freed after
the last node that reads any alias of it, unless the graph returns it. The
inputs are held by the caller for the whole call. This is what FX's
generated code does (each value is released after its last use), so the
static peak above the inputs is what the caching allocator sees, up to its
512-byte block rounding (``peak_rounded_bytes``).

Every storage is classified ``(fixed, per_len)``: carrying the entry's
``max_len`` dim in its shape means its bytes scale with the sequence window,
so one smoke-scale trace yields a *length-parametric* peak — ``peak(L) =
max over boundaries of (fixed + per_len * L)`` — and the same walk proves
the traced window and the production envelope (``ShapeEnvelope.seq_max``).
"""
from __future__ import annotations

import collections
import dataclasses
import fnmatch
import json
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.analysis.report import Report
from repro_torch.analysis.trace import TracedEntry, alias_roots

_MIB = float(2**20)
# the caching allocator's block granularity (c10/cuda/CUDACachingAllocator)
ALLOC_ROUND = 512


def _tensor_bytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _storage_bytes(val) -> int:
    """Bytes a node's new storage(s) occupy."""
    if isinstance(val, torch.Tensor):
        try:
            return int(val.untyped_storage().nbytes())
        except Exception:  # a storage without size (sparse, nested)
            return _tensor_bytes(val)
    if isinstance(val, (list, tuple)):
        return sum(_storage_bytes(v) for v in val)
    return 0


def _split(val, nbytes: int, max_len: int) -> Tuple[int, int]:
    """(fixed, per_len) byte classification: a ``max_len`` dim in the
    shape means the buffer scales with the sequence window."""
    shapes = []
    if isinstance(val, torch.Tensor):
        shapes = [tuple(val.shape)]
    elif isinstance(val, (list, tuple)):
        shapes = [tuple(v.shape) for v in val if isinstance(v, torch.Tensor)]
    if max_len and shapes and all(max_len in s for s in shapes):
        return 0, -(-nbytes // max_len)  # ceil(bytes / max_len) per token
    return nbytes, 0


def _round(b: int) -> int:
    return -(-b // ALLOC_ROUND) * ALLOC_ROUND if b else 0


def _rounded_bytes(val) -> int:
    """A node's storages in the allocator's blocks: each tensor of a
    multi-output op (``_foreach_*``) is a block of its own."""
    if isinstance(val, (list, tuple)):
        return sum(_rounded_bytes(v) for v in val)
    return _round(_storage_bytes(val))


@dataclasses.dataclass
class _Liveness:
    """One graph's liveness walk."""
    boundaries: List[Tuple[int, int]]   # candidate (fixed, per_len) peaks
    inputs: Tuple[int, int]             # the held inputs' (fixed, per_len)
    peak_rounded: int                   # above the inputs, 512-B blocks
    owners: Dict[Any, int]              # new-storage node -> its bytes

    def peak_at(self, length: int) -> int:
        return max(f + le * int(length) for f, le in self.boundaries)

    def argmax_at(self, length: int) -> Tuple[int, int]:
        return max(self.boundaries, key=lambda p: p[0] + p[1] * int(length))


def _needed(gm) -> set:
    """The nodes the graph's outputs and side effects need: a node no
    output, in-place write or collective reads is dead code."""
    seen, stack = set(), [n for n in gm.graph.nodes
                          if n.op == "output" or n.is_impure()]
    while stack:
        n = stack.pop()
        if n not in seen:
            seen.add(n)
            stack.extend(n.all_input_nodes)
    return seen


def _walk(gm, max_len: int, live_only: bool = False) -> _Liveness:
    """Linear liveness walk of one graph (module docstring); with
    ``live_only`` dead code allocates nothing."""
    needed = _needed(gm) if live_only else None
    nodes = list(gm.graph.nodes)
    index = {n: i for i, n in enumerate(nodes)}
    root = alias_roots(gm)
    out = next(n for n in nodes if n.op == "output")
    kept = {root.get(n, n) for n in out.all_input_nodes}
    last: Dict[Any, int] = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            o = root.get(a, a)
            last[o] = max(last.get(o, index[o]), i)
    in_f = in_l = 0
    for n in nodes:
        if n.op in ("placeholder", "get_attr"):
            val = n.meta.get("val")
            if n.op == "get_attr":
                val = getattr(gm, n.target, None)
            if isinstance(val, torch.Tensor):
                f, le = _split(val, _tensor_bytes(val), max_len)
                in_f += f
                in_l += le
    owners: Dict[Any, int] = {}
    free_at: Dict[int, List[Any]] = collections.defaultdict(list)
    for i, n in enumerate(nodes):
        if n.op == "call_function" and root.get(n, n) is n and (
                needed is None or n in needed):
            b = _storage_bytes(n.meta.get("val"))
            if b:
                owners[n] = b
                if n not in kept:
                    free_at[last.get(n, i)].append(n)
    live_f, live_l, live_r = in_f, in_l, 0
    boundaries = [(live_f, live_l)]
    peak_r = 0
    for i, n in enumerate(nodes):
        if n in owners:
            f, le = _split(n.meta.get("val"), owners[n], max_len)
            live_f += f
            live_l += le
            live_r += _rounded_bytes(n.meta.get("val"))
            boundaries.append((live_f, live_l))
            peak_r = max(peak_r, live_r)
        for o in free_at.get(i, ()):
            f, le = _split(o.meta.get("val"), owners[o], max_len)
            live_f -= f
            live_l -= le
            live_r -= _rounded_bytes(o.meta.get("val"))
    return _Liveness(boundaries, (in_f, in_l), peak_r, owners)


def graph_memory(gm) -> Dict[str, int]:
    """Per-device memory of one traced graph as the reference's record of
    ``compiled.memory_analysis()``: ``argument_bytes`` (the inputs; the
    graph's constants are not arguments, the walk holds them as it holds
    the inputs),
    ``output_bytes`` (each returned storage once), ``alias_bytes`` (the
    returned storages that are inputs: a cache or state written in place),
    ``temp_bytes`` (the liveness walk's peak above the inputs and the
    fresh outputs) and ``peak_bytes_per_device`` = argument + output +
    temp - alias, the walk's peak; ``largest``: the three largest
    storages the graph allocates (op, shape, bytes). Dead code allocates
    nothing: DTensor computes an op's global output metadata on fake
    tensors of the global shape, which a CUDA mesh's trace records as
    nodes no output reads (a decode cell's whole cache, 48 GB)."""
    live = _walk(gm, 0, live_only=True)
    root = alias_roots(gm)
    out = next(n for n in gm.graph.nodes if n.op == "output")
    argument = sum(_tensor_bytes(n.meta["val"]) for n in gm.graph.nodes
                   if n.op == "placeholder"
                   and isinstance(n.meta.get("val"), torch.Tensor))
    output = alias = 0
    for o in {root.get(n, n) for n in out.all_input_nodes}:
        val = o.meta.get("val")
        if o.op == "placeholder":
            if isinstance(val, torch.Tensor):
                alias += _tensor_bytes(val)
                output += _tensor_bytes(val)
        else:  # a multi-output op (``_foreach_*``) counts all its results
            output += live.owners.get(o, _storage_bytes(val))
    peak = live.peak_at(0)
    temp = max(peak - argument - (output - alias), 0)  # constants count here
    largest = sorted(live.owners.items(), key=lambda kv: -kv[1])[:3]
    return {"argument_bytes": argument, "output_bytes": output,
            "temp_bytes": temp, "alias_bytes": alias,
            "peak_bytes_per_device": argument + output + temp - alias,
            "largest": [[str(n.target), _shape_of(n.meta.get("val")), b]
                        for n, b in largest]}


def _shape_of(val):
    if isinstance(val, (list, tuple)):
        return [_shape_of(v) for v in val[:2]]
    return list(val.shape) if isinstance(val, torch.Tensor) else None


# --------------------------------------------------------------- carries
def _dead_carries(entry: TracedEntry, live: _Liveness) -> List[Tuple[int, str]]:
    """QL402 reasons for the declared carries the graph never writes."""
    ph = entry.placeholders
    dead = []
    for lbl in entry.carry:
        i = entry.labels.index(lbl)
        if i in entry.donated:
            continue
        val = ph[i].meta.get("val")
        fresh = [n for n in live.owners
                 if isinstance(n.meta.get("val"), torch.Tensor)
                 and tuple(n.meta["val"].shape) == tuple(val.shape)
                 and n.meta["val"].dtype == val.dtype]
        if fresh:
            dead.append((i, (
                "carry never written in place: a result of its shape and "
                f"dtype is allocated fresh ({fresh[0].name}) while the carry "
                "is still read — the lifetimes overlap, so both copies stay "
                "and the state the caller keeps never moves")))
        else:
            dead.append((i, (
                "carry never written in place: no result shares its shape "
                f"{tuple(val.shape)} and dtype "
                f"{str(val.dtype).replace('torch.', '')} — the declared "
                "update frees and moves nothing; drop it, or write the "
                "updated state into the buffer")))
    return dead


# ------------------------------------------------------------- per-entry
def _where(entry: TracedEntry, tail: str = "mem") -> str:
    return f"graph:{entry.name}#{tail}"


def _live_label_bytes(entry: TracedEntry, glob: str) -> int:
    """Bytes of the entry's live inputs whose label matches ``glob`` —
    what the traced body actually reads for that group."""
    from repro_torch.analysis.graph_checks import used_inputs

    return sum(_tensor_bytes(n.meta["val"])
               for n, lbl, u in zip(entry.placeholders, entry.labels,
                                    used_inputs(entry))
               if u and fnmatch.fnmatch(lbl, glob))


def check_memory(entry: TracedEntry) -> Tuple[Report, Dict[str, Any]]:
    """Liveness-walk one entry: QL401/QL402/QL403/QL404 findings plus the
    machine-readable record ``--mem-json`` aggregates."""
    rep = Report()
    mem = entry.mem
    max_len = mem.max_len if mem else 0
    live = _walk(entry.closed, max_len)
    dead = _dead_carries(entry, live)
    for i, reason in dead:
        rep.add("QL402", "dead-donation", "error",
                _where(entry, entry.labels[i]), reason)

    in_f, in_l = live.inputs
    record: Dict[str, Any] = {
        "entry": entry.name,
        "max_len": max_len,
        "donated": len(entry.carry),
        "donation_matched": len(entry.carry) - len(dead),
        "donation_dead": len(dead),
    }
    peak_trace = live.peak_at(max_len)
    pf, pl = live.argmax_at(max_len)
    record.update(peak_trace_bytes=peak_trace, peak_fixed_bytes=pf,
                  peak_bytes_per_token=pl,
                  input_bytes=in_f + in_l * max_len,
                  peak_above_inputs_bytes=peak_trace - in_f - in_l * max_len,
                  peak_rounded_bytes=live.peak_rounded)

    if mem is None:
        rep.add("QL401", "hbm-budget", "info", _where(entry),
                f"no MemContract declared — measured peak-live "
                f"{peak_trace / _MIB:.3f} MiB "
                f"({pf / _MIB:.3f} fixed + {pl} B/token), unenforced")
        return rep, record

    budget_trace = mem.budget_at(max_len)
    record.update(budget_trace_bytes=budget_trace, slots=mem.slots,
                  envelope_len=mem.envelope_len, note=mem.note)
    if peak_trace > budget_trace:
        rep.add("QL401", "hbm-budget", "error", _where(entry),
                f"peak-live {peak_trace / _MIB:.3f} MiB exceeds the "
                f"declared budget {budget_trace / _MIB:.3f} MiB at the "
                f"traced window L={max_len} "
                f"(peak = {pf / _MIB:.3f} MiB fixed + {pl} B/token; "
                f"budget: {mem.note or 'undocumented'})")
    if mem.envelope_len:
        peak_env = live.peak_at(mem.envelope_len)
        budget_env = mem.budget_at(mem.envelope_len)
        record.update(peak_envelope_bytes=peak_env,
                      budget_envelope_bytes=budget_env)
        if peak_env > budget_env:
            ef, el = live.argmax_at(mem.envelope_len)
            rep.add("QL401", "hbm-budget", "error", _where(entry),
                    f"peak-live {peak_env / _MIB:.1f} MiB exceeds the "
                    f"budget {budget_env / _MIB:.1f} MiB at the production "
                    f"envelope L={mem.envelope_len} (scaled from the "
                    f"L={max_len} trace: {ef / _MIB:.3f} MiB fixed + "
                    f"{el} B/token vs budget {mem.per_len_bytes} B/token)")
        elif peak_trace <= budget_trace:
            rep.add("QL401", "hbm-budget", "info", _where(entry),
                    f"peak-live fits the budget at L={max_len} "
                    f"({peak_trace / _MIB:.3f} <= {budget_trace / _MIB:.3f} "
                    f"MiB) and at the envelope L={mem.envelope_len} "
                    f"({peak_env / _MIB:.1f} <= {budget_env / _MIB:.1f} "
                    "MiB) — the smoke trace proves the production window")
    elif peak_trace <= budget_trace:
        rep.add("QL401", "hbm-budget", "info", _where(entry),
                f"peak-live {peak_trace / _MIB:.3f} MiB fits the budget "
                f"{budget_trace / _MIB:.3f} MiB")

    # QL403: the graph's live input bytes per labelled group vs the accessor
    record["expect"] = []
    for measure, glob, expected in mem.expect:
        static = _live_label_bytes(entry, glob)
        record["expect"].append({"measure": measure, "glob": glob,
                                 "expected_bytes": expected,
                                 "static_bytes": static})
        slack = max(4096, int(0.01 * expected))
        if abs(static - expected) > slack:
            rep.add("QL403", "weight-traffic", "error",
                    _where(entry, measure),
                    f"live inputs matching {glob!r} hold {static} B in the "
                    f"graph but the accessor claims {expected} B "
                    f"(drift {static - expected:+d} B > slack {slack} B) — "
                    "a dead/extra buffer, or the accessor and the graph "
                    "disagree about what serving reads")
        else:
            rep.add("QL403", "weight-traffic", "info",
                    _where(entry, measure),
                    f"{measure}: graph-live {static} B matches the "
                    f"accessor's {expected} B (slack {slack} B)")

    # QL404 (info): allocated-window growth — the paged-KV gap, quantified
    if max_len:
        wl = _window_input_bytes(entry, "*")
        record["window_state_bytes_per_token"] = wl
        if wl and mem.envelope_len:
            pinned_env = wl * mem.envelope_len
            per_slot = wl // mem.slots if mem.slots else wl
            record["window_state_envelope_bytes"] = pinned_env
            rep.add("QL404", "cache-growth", "info", _where(entry),
                    f"window state pins {wl} B/token ({per_slot} B/token/"
                    f"slot) scaled by the *allocated* max_len, not the "
                    f"used length — {pinned_env / _MIB:.1f} MiB at the "
                    f"envelope L={mem.envelope_len} even for one-token "
                    "sequences; a paged KV cache reclaims that tail")
    return rep, record


def _window_input_bytes(entry: TracedEntry, glob: str) -> int:
    """Per-token bytes of the window-scaled inputs matching ``glob``."""
    ml = entry.mem.max_len if entry.mem else 0
    total = 0
    for n, lbl in zip(entry.placeholders, entry.labels):
        if fnmatch.fnmatch(lbl, glob):
            val = n.meta["val"]
            total += _split(val, _tensor_bytes(val), ml)[1]
    return total


# ------------------------------------------------- the allocator's view
def replay_peak(entry: TracedEntry, warm: int = 1) -> Dict[str, int]:
    """Replay the entry's traced ``GraphModule`` on its exemplar tensors on
    the card (``warm`` runs first: the CUDA libraries' workspaces are then
    part of the baseline) and read the caching allocator's peak above what
    was allocated before the call, against the static walk's peak above
    the inputs in 512-byte blocks. The replay writes the carries as the
    step would."""
    dev = entry.device
    if dev is None or dev.type != "cuda":
        raise RuntimeError(f"{entry.name}: the allocator's peak is read on "
                           "a CUDA card; trace the entry with device='cuda'")
    gm, leaves = entry.closed, entry.leaves
    for _ in range(warm):
        gm(*leaves)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = gm(*leaves)
    torch.cuda.synchronize(dev)
    measured = torch.cuda.max_memory_allocated(dev) - base
    del out
    live = _walk(gm, entry.mem.max_len if entry.mem else 0)
    return {"measured_bytes": int(measured),
            "static_rounded_bytes": int(live.peak_rounded)}


# ----------------------------------------------------- cross-entry checks
def _kv(entry: TracedEntry) -> Tuple[str, int]:
    """The entry's KV-cache label glob and its accessor bytes."""
    for measure, glob, expected in entry.mem.expect:
        if measure == "kv_cache":
            return glob, expected
    return "*cache*", 0


def check_kv_static_gap(entries: Sequence[TracedEntry]) -> Report:
    """Prove the int8-KV-vs-bf16-KV gap *statically*: the per-token window
    bytes of the two ``serve_decode`` graphs, read off their cache inputs
    alone, must put int8 strictly below bf16, and each slot's bytes must
    equal ``serve/kv.py``'s ``hbm_per_slot_bytes`` (what the serving
    engine reports)."""
    rep = Report()
    int8 = [e for e in entries if e.mem is not None
            and e.name.startswith("serve_decode") and "bf16-kv" not in e.name]
    bf16 = [e for e in entries if e.mem is not None
            and e.name.startswith("serve_decode") and "bf16-kv" in e.name]
    if not int8 or not bf16:
        return rep
    where = "graph:serve_decode#kv-gap"
    per_tok = {}
    for tag, e in (("int8", int8[0]), ("bf16", bf16[0])):
        glob, expected = _kv(e)
        wl = _window_input_bytes(e, glob)
        per_tok[tag] = wl
        slots = max(e.mem.slots, 1)
        static_slot = wl * e.mem.max_len // slots
        if expected and static_slot != expected // slots:
            rep.add("QL405", "kv-gap-static", "error", where,
                    f"{tag} KV: the graph's cache inputs pin {static_slot} "
                    f"B per slot, hbm_per_slot_bytes reports "
                    f"{expected // slots} B — the accessor and the cache "
                    "the step reads disagree")
    bi, bb = per_tok["int8"], per_tok["bf16"]
    if bi < bb:
        rep.add("QL405", "kv-gap-static", "info", where,
                f"int8 KV pins {bi} B/token vs bf16's {bb} B/token "
                f"({bb / max(bi, 1):.2f}x), proven from the graphs alone — "
                "the static counterpart of hbm_per_slot_bytes' gap")
    else:
        rep.add("QL405", "kv-gap-static", "error", where,
                f"int8 KV cache pins {bi} B/token, NOT below bf16's "
                f"{bb} B/token — the int8 cache stopped paying for itself "
                "(scales outgrew the codes, or the bf16 path shrank)")
    return rep


# ------------------------------------------------------------ mem report
def mem_report_json(records: Sequence[Dict[str, Any]], path: str,
                    log=print) -> None:
    """Write the ``--mem-json`` artifact: per-entry liveness records plus
    the aggregate a roofline's peak-memory term would read."""
    envelope_peaks = [r.get("peak_envelope_bytes") for r in records
                      if r.get("peak_envelope_bytes") is not None]
    doc = {
        "entries": list(records),
        "roofline": {
            "peak_hbm_bytes_envelope": max(envelope_peaks, default=0),
            "window_bytes_per_token": {
                r["entry"]: r["window_state_bytes_per_token"]
                for r in records
                if r.get("window_state_bytes_per_token")},
        },
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2)
    log(f"memcheck report written to {path}")


__all__ = ["ALLOC_ROUND", "check_kv_static_gap", "check_memory",
           "mem_report_json", "replay_peak"]
