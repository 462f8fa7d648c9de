"""Entry-point tracers: turn the port's real step bodies into
:class:`TracedEntry` objects the graph analyzers consume (port of
``repro/analysis/trace.py``; its layout table lives in
:mod:`repro_torch.analysis.layouts`).

Each entry function constructs exemplar inputs at smoke scale, traces the body
with ``torch.fx.experimental.proxy_tensor.make_fx(..., tracing_mode=
"fake")`` into an aten-level ``torch.fx.GraphModule``, and labels every
placeholder with a readable path (``astates.~s0.step`` ...) so findings
point at the actual leaf, not "placeholder 17". The bodies traced are the
ones the engines capture in CUDA graphs, which hold no host sync by
construction (QL102 holds them to that):

  recon_chunk      one ``core.reconstruct._Engine.step`` (mesh on/off), its
                   static buffers lifted to labelled inputs
  probe            ``allocate.sensitivity._Probe.body``
  qtensor_matmul   one entry per QTensor layout in the kernel table, on the
                   plain versions (``backend="torch"``: a CUDA kernel bound
                   by ctypes is opaque to the tracer, as a Pallas call is
                   to the reference's xla refs)
  deploy_decode    the smoke LM's deploy-mode decode step (opt-in: builds
                   and quantizes a model)
  serve_prefill /  the serving engine's bucket prefill-insert and slot
  serve_decode     decode bodies (``serve.engine.make_prefill``/
                   ``make_decode``), slot state written in place

Torch has no donation: a step updates its state in place. ``donated`` is
therefore the set of inputs the graph writes in place (an aten op whose
schema marks the argument written, or a collective, on a placeholder or a
view of one), and ``carry`` the inputs the caller declares to be state the
step must update in place (QL402 holds the graph to it).

Seeded-bug variants (``drop_a_state=...``, ``underflow=...`` and the
fixtures at the end) re-introduce known regressions so tests can assert
each analyzer flags exactly them; they are never part of the default lint
run.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.layouts import _gen
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantConfig, QuantRecipe
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MemContract:
    """Per-entry device-memory budget: ``budget(L) = fixed_bytes +
    per_len_bytes*L``.

    memcheck (QL401) proves the entry's static peak of live storages
    against it, at the traced window length and, when ``envelope_len`` is
    declared, scaled up to the production window (every storage carrying a
    ``max_len`` dim scales linearly, everything else is fixed). The peak is
    counted on the traced graph, which FX's generated code runs as it
    stands: each value is freed after its last use, so the caching
    allocator's peak above the inputs matches the static one up to its
    block rounding (``chip_smoke.py`` replays the graphs and checks).
    Budgets carry explicit, documented headroom over their semantic
    components (weights + window state + activation slack); the rule
    exists to catch asymptotic regressions (a dequantized window
    materialized as state, a doubled carry), not 5% drifts.

    ``expect`` rows feed QL403: ``(measure, label_glob, expected_bytes)``,
    the bytes the accessors (``tree_weight_bytes``,
    ``serve.kv.hbm_per_slot_bytes``) report for the exemplar trees, held
    against the bytes of the graph's live inputs matching ``label_glob``.
    """
    fixed_bytes: int              # window-independent budget component
    per_len_bytes: int = 0        # budget bytes per token of the window
    max_len: int = 0              # traced [*, max_len] window (0 = none)
    envelope_len: int = 0         # production window (envelope seq_max)
    slots: int = 0                # decode slots (serve entries)
    note: str = ""                # where the numbers come from
    expect: Tuple[Tuple[str, str, int], ...] = ()

    def budget_at(self, length: int) -> int:
        return self.fixed_bytes + self.per_len_bytes * int(length)


@dataclasses.dataclass
class Collective:
    """One ``c10d`` collective of a traced graph and its group, read while
    the group was alive (the graph holds it only as a torchbind object)."""
    node: Any                    # the torch.fx.Node of the c10d op
    op: str                      # e.g. "allreduce_"
    group_size: int
    backend: str
    data_group: bool             # the entry's data-parallel group


@dataclasses.dataclass
class TracedEntry:
    """One traced entry point, ready for the graph analyzers."""
    name: str
    closed: Any                      # torch.fx.GraphModule
    labels: List[str]                # one per placeholder, in order
    donated: frozenset               # placeholder indices written in place
    allow_unused: Tuple[str, ...] = ()   # fnmatch globs over labels
    mesh: Any = None                 # DeviceMesh when the entry declares one
    dp: Tuple[str, ...] = ()         # data-parallel axis names to honor
    # quantcheck (repro_torch.analysis.intervals) inputs: value-range seeds
    # (label glob, lo, hi), first match wins, and the shape-envelope name
    # whose k_max scales every contraction in the overflow proof
    ranges: Tuple[Tuple[str, float, float], ...] = ()
    envelope: Optional[str] = None
    # memcheck input: the entry's budget; None skips QL401
    mem: Optional[MemContract] = None
    # the port's additions
    carry: Tuple[str, ...] = ()      # labels declared updated in place
    leaves: Tuple[Any, ...] = ()     # exemplar tensors, one per label
    collectives: Tuple[Collective, ...] = ()
    captured: bool = False           # the body runs inside a CUDA graph
    loss: Tuple[str, ...] = ()       # label globs the loss leaves through
    device: Any = None

    @property
    def placeholders(self) -> List[Any]:
        return [n for n in self.closed.graph.nodes if n.op == "placeholder"]


# --------------------------------------------------------- leaves, labels
def _flatten(tree, prefix: str, out: List[Tuple[str, torch.Tensor]]) -> None:
    """Tensor leaves of a nested dict/list/tuple/QTensor with their labels:
    dict keys, ``[i]`` for sequences, ``codes``/``scale``/``zero`` for a
    QTensor (not a torch pytree, so walked here)."""
    def sub(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(tree, torch.Tensor):
        out.append((prefix, tree))
    elif isinstance(tree, QTensor):
        for f in ("codes", "scale", "zero"):
            _flatten(getattr(tree, f), sub(f), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, sub(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, sub(f"[{i}]"), out)


def _rebuild(tree, it):
    """``tree`` with its tensor leaves replaced, in ``_flatten`` order."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, QTensor):
        return dataclasses.replace(
            tree, codes=_rebuild(tree.codes, it),
            scale=_rebuild(tree.scale, it), zero=_rebuild(tree.zero, it))
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


# ------------------------------------------------------------ alias model
C10D_NS = "c10d"
_getitem = operator.getitem


def is_collective(node) -> bool:
    t = getattr(node, "target", None)
    return (node.op == "call_function" and hasattr(t, "namespace")
            and t.namespace == C10D_NS)


def op_name(node) -> str:
    """``aten.mm.default`` -> ``mm``; ``operator.getitem`` -> ``getitem``."""
    t = node.target
    if hasattr(t, "_schema"):
        return t._schema.name.split("::")[-1]
    return getattr(t, "__name__", str(t))


def _tensor_nodes(arg) -> List[Any]:
    if isinstance(arg, torch.fx.Node):
        return [arg]
    if isinstance(arg, (list, tuple)):
        return [a for a in arg if isinstance(a, torch.fx.Node)]
    return []


def _schema_args(node) -> List[Tuple[Any, Any]]:
    """(schema argument, value) pairs of an OpOverload call."""
    sch = node.target._schema
    out = []
    for i, a in enumerate(sch.arguments):
        if i < len(node.args):
            out.append((a, node.args[i]))
        elif a.name in node.kwargs:
            out.append((a, node.kwargs[a.name]))
    return out


# views whose schema does not mark the alias (reshape's decomposition)
_UNMARKED_VIEWS = frozenset({"_unsafe_view"})


def alias_roots(gm) -> Dict[Any, Any]:
    """node -> the node that owns its storage: a view, an in-place op and a
    ``getitem`` of an aliasing result share their operand's storage; a
    collective's results are its (in-place reduced) operands; everything
    else owns a storage of its own (a multi-output op owns the storage of
    all its results)."""
    root: Dict[Any, Any] = {}
    for n in gm.graph.nodes:
        root[n] = n
        if n.op != "call_function":
            continue
        if is_collective(n):  # returns (operands reduced in place, work)
            ops = _tensor_nodes(n.args[0]) if n.args else []
            root[n] = root[ops[0]] if ops else n
            continue
        if n.target is _getitem:
            src, i = n.args
            inner = src.args[0] if src.target is _getitem else None
            if is_collective(src):  # (tensors, work)[i]
                root[n] = root[src] if i == 0 else n
            elif isinstance(inner, torch.fx.Node) and is_collective(inner):
                ops = _tensor_nodes(inner.args[0])  # tensors[i]
                root[n] = root[ops[i]] if i < len(ops) else n
            else:
                root[n] = root.get(src, src)
            continue
        if op_name(n) in _UNMARKED_VIEWS:
            nodes = _tensor_nodes(n.args[0]) if n.args else []
            if nodes:
                root[n] = root[nodes[0]]
            continue
        sch = getattr(n.target, "_schema", None)
        if sch is None or not sch.returns:
            continue
        ret_alias = sch.returns[0].alias_info
        if ret_alias is None:
            continue
        for a, v in _schema_args(n):
            if a.alias_info is not None and set(a.alias_info.before_set) & \
                    set(ret_alias.before_set):
                nodes = _tensor_nodes(v)
                if nodes:
                    root[n] = root[nodes[0]]
                break
    return root


def written_nodes(n) -> List[Any]:
    """The operand nodes an op writes in place: schema-marked writes, and
    every tensor operand of a collective."""
    if n.op != "call_function":
        return []
    if is_collective(n):
        return _tensor_nodes(n.args[0]) if n.args else []
    sch = getattr(n.target, "_schema", None)
    if sch is None:
        return []
    out = []
    for a, v in _schema_args(n):
        if a.alias_info is not None and a.alias_info.is_write:
            out.extend(_tensor_nodes(v))
    return out


# ----------------------------------------------------------------- tracing
def _group_of(obj):
    """The ProcessGroup behind a graph's torchbind object, or None."""
    try:
        import torch.distributed as dist
        return dist.ProcessGroup.unbox(obj)
    except Exception:  # not a process group (the reduce op)
        return None


def _collectives(gm, dp_group) -> Tuple[Collective, ...]:
    import torch.distributed as dist
    out = []
    for n in gm.graph.nodes:
        if not is_collective(n):
            continue
        pg = None
        for a in n.args[1:]:
            if isinstance(a, torch.fx.Node) and a.op == "get_attr":
                pg = _group_of(getattr(gm, a.target))
                if pg is not None:
                    break
        size = pg.size() if pg is not None else 0
        try:
            backend = str(dist.get_backend(pg)) if pg is not None else "?"
        except Exception:
            backend = "?"
        out.append(Collective(n, op_name(n), size, backend,
                              pg is not None and pg is dp_group))
    return tuple(out)


class _DefaultGenerator(torch.overrides.TorchFunctionMode):
    """Drops a ``generator=`` argument while tracing: the draw comes from
    the default generator instead. torch 2.11's ``make_fx`` cannot hold a
    ``torch.Generator`` in a graph (2.13 holds it as an opaque attribute),
    and which stream a draw comes from changes no finding: the QDrop
    streams are not inputs of the step."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(kwargs.get("generator"), torch.Generator):
            kwargs = {k: v for k, v in kwargs.items() if k != "generator"}
        return func(*args, **kwargs)


def trace_entry(fn: Callable, args: Tuple, *, name: str,
                argnames: Sequence[str], carry: Sequence[str] = (),
                allow_unused: Tuple[str, ...] = (),
                mesh=None, dp: Tuple[str, ...] = (), dp_group=None,
                captured: bool = False, loss: Tuple[str, ...] = (),
                ranges: Tuple[Tuple[str, float, float], ...] = (),
                envelope: Optional[str] = None,
                mem: Optional[MemContract] = None) -> TracedEntry:
    """Trace ``fn(*args)`` with fake tensors and label its placeholders
    (the counterpart of the reference's ``trace_jitted``).

    ``argnames`` names each positional argument; labels come out as
    ``<argname>.<path>``. ``carry`` (label globs) declares the inputs the
    step must update in place. ``dp_group`` is the entry's data-parallel
    process group (``mesh=`` entries); ``captured`` whether the body runs
    inside a CUDA graph; ``loss`` the label globs of the buffers the loss
    leaves through (QL305)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if len(argnames) != len(args):
        raise ValueError(f"{name}: {len(argnames)} argnames for "
                         f"{len(args)} arguments; name each one")
    flat: List[Tuple[str, torch.Tensor]] = []
    for aname, arg in zip(argnames, args):
        _flatten(arg, aname, flat)
    labels = [lbl for lbl, _ in flat]
    leaves = [t for _, t in flat]

    def flat_fn(*xs):
        it = iter(xs)
        rebuilt = [_rebuild(a, it) for a in args]
        with _DefaultGenerator():
            return fn(*rebuilt)

    gm = make_fx(flat_fn, tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*leaves)
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(ph) != len(labels):
        raise RuntimeError(
            f"{name}: placeholder labeling out of sync — {len(labels)} "
            f"tensor leaves vs {len(ph)} placeholders; did the body close "
            "over an argument or take kwargs?")
    root = alias_roots(gm)
    index = {n: i for i, n in enumerate(ph)}
    donated = set()
    for n in gm.graph.nodes:
        for w in written_nodes(n):
            r = root.get(w, w)
            if r in index:
                donated.add(index[r])
    return TracedEntry(
        name=name, closed=gm, labels=labels, donated=frozenset(donated),
        allow_unused=tuple(allow_unused), mesh=mesh, dp=tuple(dp),
        ranges=tuple(ranges), envelope=envelope, mem=mem,
        carry=tuple(lbl for lbl in labels
                    if any(fnmatch.fnmatch(lbl, g) for g in carry)),
        leaves=tuple(leaves), collectives=_collectives(gm, dp_group),
        captured=captured, loss=tuple(loss),
        device=leaves[0].device if leaves else None)


# ------------------------------------------------------ memory contracts
def _tree_bytes(tree) -> int:
    """Actual device bytes of a tree's tensor leaves (QTensor fields
    included)."""
    out: List[Tuple[str, torch.Tensor]] = []
    _flatten(tree, "", out)
    return sum(t.numel() * t.element_size() for _, t in out)


def _window_bytes(tree, max_len: int) -> int:
    """Bytes of leaves carrying a ``max_len`` dim (the sequence window)."""
    if not max_len:
        return 0
    out: List[Tuple[str, torch.Tensor]] = []
    _flatten(tree, "", out)
    return sum(t.numel() * t.element_size() for _, t in out
               if max_len in tuple(t.shape))


def mem_contract(args, *, max_len: int = 0, envelope_len: int = 0,
                 slots: int = 0, headroom: float = 2.0,
                 len_headroom: float = 8.0, fixed_extra: int = 1 << 20,
                 note: str = "",
                 expect: Tuple[Tuple[str, str, int], ...] = ()
                 ) -> MemContract:
    """Derive an entry's :class:`MemContract` from its exemplar arguments:
    ``fixed = headroom * (non-window arg bytes) + fixed_extra`` covers the
    arguments, their outputs and smoke-scale temporaries; ``per_len =
    len_headroom * (window arg bytes) / max_len`` covers the window state
    plus the float32 views decode attention takes of it."""
    total = _tree_bytes(args)
    win = _window_bytes(args, max_len)
    per_len = int(len_headroom * win / max_len) if max_len else 0
    return MemContract(
        fixed_bytes=int(headroom * (total - win)) + fixed_extra,
        per_len_bytes=per_len, max_len=max_len, envelope_len=envelope_len,
        slots=slots, note=note, expect=tuple(expect))


# --------------------------------------------------------------- toy blocks
def _normal(shape, seed: int, device, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=_gen(seed, device),
                       device=device) * scale


def toy_block(seed: int, name: str, d: int = 16, h: int = 24, token=None,
              device: DeviceLike = None):
    """Two-linear gelu residual block (the recon-engine test exemplar),
    weights drawn from ``seed`` on ``device``."""
    from repro_torch.core.reconstruct import BlockHandle, Site
    dev = resolve_device(device)
    params = {"w1": _normal((d, h), seed, dev, d**-0.5),
              "w2": _normal((h, d), seed + 1000, dev, h**-0.5)}

    def apply(p, x, ctx, _n=name):
        z = torch.nn.functional.gelu(ctx.linear(f"{_n}.w1", x, p["w1"]),
                                     approximate="tanh")
        return ctx.linear(f"{_n}.w2", z, p["w2"]) + x

    sites = {f"{name}.w1": Site(("w1",)), f"{name}.w2": Site(("w2",))}
    return BlockHandle(name, params, apply, sites, apply_key=token)


def toy_chain(n: int, token: Optional[str] = "quantlint-chain",
              d: int = 16, h: int = 24, device: DeviceLike = None):
    """``token=None`` disables engine sharing — the deliberate per-layer
    retrace used as a seeded bug."""
    return [toy_block(7 + i, f"blk{i}", d, h, token=token, device=device)
            for i in range(n)]


def toy_recipe(iters: int = 6, batch_size: int = 4, w_bits: int = 4,
               a_bits: Optional[int] = 8) -> QuantRecipe:
    return QuantRecipe(method="flexround", w_bits=w_bits, a_bits=a_bits,
                       iters=iters, batch_size=batch_size)


# ------------------------------------------------------------ recon chunk
# the reference's run_chunk arguments; the port's step reads ``step`` (its
# counter), the loss/MSE ``curves`` and the bias-correction tables ``corr``
# where the reference scans ``steps`` and carries its optimizer counts
_RUN_CHUNK_ARGS = ("params", "wstates", "astates", "wopt", "aopt", "x_q",
                   "y_fp", "idx", "step", "curves", "corr")


def recon_chunk_entry(mesh=None, *, n: int = 8, bs: int = 4, iters: int = 6,
                      d: int = 16, h: int = 24,
                      device: DeviceLike = None) -> TracedEntry:
    """One ``_Engine.step`` exactly as ``_run`` drives it, with the
    engine's static buffers lifted to labelled inputs: the rounding and
    LSQ states, the Adam moments, the counter and the curves are carries
    the step writes in place; ``bs < n`` keeps the minibatch gather (and,
    under a mesh, its collective) live. Under ``mesh`` this rank holds its
    rows of the streams and the step reduces over the data group."""
    from repro_torch.core import qdrop
    from repro_torch.core import reconstruct as rec

    assert bs < n, "bs < n keeps the gather (and its collective) live"
    dev = resolve_device(device)
    block = toy_block(3, "entry", d, h, token="quantlint-recon-entry",
                      device=dev)
    recipe = toy_recipe(iters=iters, batch_size=bs)
    plans = rec.site_plans(block, recipe)
    x_all = _normal((n, d), 11, dev)
    y_all = _normal((n, d), 12, dev)
    dp = rec._data_parallel(mesh)
    rows = rec._Rows.of(dp, n)
    x_q, y_fp = rows.take(x_all), rows.take(y_all)
    canon = rec._canon_names(block)
    with torch.no_grad():
        wstates = rec.init_wstates(block, recipe)
    astates = rec.init_astates(block, recipe, x_q, rows=rows)
    c_w = {canon[r]: v for r, v in wstates.items()}
    c_a = {canon[r]: astates[r] for r in block.sites if r in astates}
    idx = rec._batch_schedule(_gen(0, dev), iters, n, bs)
    eng = rec._Engine(block, recipe, {canon[r]: plans[r] for r in block.sites},
                      canon, c_w, c_a, x_q, y_fp, None, idx, rows, None)
    inv = {c: r for r, c in canon.items()}
    eng.load(block.params, c_w, c_a, x_q, y_fp, None, idx,
             {c: qdrop.site_seed(recipe.seed, inv[c]) for c in eng.streams})
    args = (eng.params, eng.ws, eng.as_, {"mu": eng.wmu}, {"mu": eng.amu},
            eng.x_q, eng.y_fp, eng.idx, eng.step_t,
            {"loss": eng.losses, "mse": eng.mses},
            {"w": eng.w_corr, "a": eng.a_corr})

    def run(params, ws, as_, wopt, aopt, x_q, y_fp, idx, step, curves, corr):
        eng.params, eng.ws, eng.as_ = params, ws, as_
        eng.wmu, eng.amu = wopt["mu"], aopt["mu"]
        eng.x_q, eng.y_fp, eng.idx, eng.step_t = x_q, y_fp, idx, step
        eng.losses, eng.mses = curves["loss"], curves["mse"]
        eng.w_corr, eng.a_corr = corr["w"], corr["a"]
        eng.sw_all = eng.sw
        eng.zero_g.clear()
        eng.step(eng.draw)

    carry = [f"wstates.{c}.{k}" for c, m in eng.wmask.items()
             for k, t in m.items() if t]
    carry += [f"astates.{c}.{k}" for c, m in eng.amask.items()
              for k, t in m.items() if t]
    carry += ["wopt.*", "aopt.*", "step", "curves.*"]
    dp_axes: Tuple[str, ...] = ()
    if mesh is not None:
        from repro_torch.launch.mesh import dp_axes as _dp_axes
        dp_axes = _dp_axes(mesh)
    entry = trace_entry(
        run, args,
        name="recon_chunk" + ("_sharded" if mesh is not None else ""),
        argnames=_RUN_CHUNK_ARGS, carry=carry,
        # FlexRound has no step-annealed rounding regularizer (that is
        # AdaRound's b-schedule), so a scanned step index is dead by
        # design under this recipe; the port's counter is read all the
        # same (minibatch rows, bias corrections, curves)
        allow_unused=("steps",),
        mesh=mesh, dp=dp_axes, dp_group=None if dp is None else dp.group,
        captured=dev.type == "cuda" and (dp is None or dp.capturable),
        loss=("curves.*",),
        # the carries are updated in place, so the step's peak is the
        # arguments + its gradient/activation temporaries (grads mirror
        # the carries: 2x argument headroom covers them)
        mem=mem_contract(
            args, headroom=2.0,
            note="in-place Adam/rounding carries + calibration streams; "
                 "grads mirror the carries (2x) + 1 MiB step slack"))
    return entry


# ----------------------------------------------------------------- probe
def probe_entry(bits: int = 4, d: int = 16, h: int = 24,
                device: DeviceLike = None) -> TracedEntry:
    """The sensitivity probe body (``allocate.sensitivity._Probe.body``):
    the one-hot gate vector selects the quantized site, so every leaf,
    the gates included, must stay live in the graph."""
    from repro_torch.allocate import sensitivity as sens
    from repro_torch.core import paths as pth
    from repro_torch.core import reconstruct as rec
    from repro_torch.core import rtn

    dev = resolve_device(device)
    block = toy_block(5, "probe", d, h, token="quantlint-probe-entry",
                      device=dev)
    recipe = toy_recipe()
    plans = rec.site_plans(block, recipe)
    canon = rec._canon_names(block)
    cfgs_c = {canon[rn]: dataclasses.replace(plans[rn].weight, bits=bits)
              for rn in block.sites}
    wstates = {}
    with torch.no_grad():
        for rn, site in block.sites.items():
            w = pth.get_path(block.params, site.path)
            wstates[canon[rn]] = rtn.init(w, cfgs_c[canon[rn]])
    x = _normal((4, d), 21, dev)
    y_fp = _normal((4, d), 22, dev)
    probe = sens._Probe(block, cfgs_c, canon, wstates, x, y_fp,
                        rec._Rows.of(None, 4))
    probe.load(block.params, wstates, x, y_fp)
    probe.gate.copy_(probe.onehot[0])
    args = (probe.params, probe.x, probe.y_fp, probe.wstates, probe.gate,
            probe.mse)

    def run(params, x, y_fp, wstates, gates, mse):
        probe.params, probe.x, probe.y_fp = params, x, y_fp
        probe.wstates, probe.gate, probe.mse = wstates, gates, mse
        probe.body()

    return trace_entry(run, args, name="probe_step",
                       argnames=("params", "x", "y_fp", "wstates", "gates",
                                 "mse"),
                       carry=("mse",), captured=dev.type == "cuda",
                       mem=mem_contract(
                           args, headroom=2.0,
                           note="params + RTN states + probe streams; the "
                                "gated fake-quant materializes one "
                                "quantized weight per site (2x)"))


# --------------------------------------------------------- qtensor_matmul
def qtensor_matmul_entry(layout: str, *, drop_a_state: bool = False,
                         device: DeviceLike = None) -> TracedEntry:
    """One kernel-table layout traced through ``kernels.ops.qtensor_matmul``
    on the plain versions.

    ``drop_a_state=True`` re-introduces the reference's a_state-drop regression —
    the wrapper accepts the activation grid but never hands it to the
    kernel — so the unused-input analyzer has a known-bad fixture."""
    from repro_torch.analysis.layouts import matmul_example
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.envelope import get_envelope

    dev = resolve_device(device)
    x, qt, a_state = matmul_example(layout, device=dev)
    env = get_envelope(layout)
    # value-range contract for the interval interpreter: activation
    # magnitude and grid-scale bounds come from the layout's envelope;
    # codes/zero live on the integer grid
    ranges = (
        ("x*", -env.x_abs_max, env.x_abs_max),
        ("qt.scale*", env.scale_min, env.scale_max),
        ("qt.zero*", 0.0, float(env.code_max)),
        ("a_state.[0]", env.scale_min, env.scale_max),    # deploy a_scale
        ("a_state.[1]", 0.0, 255.0),                      # deploy a_zero
    )

    def run(x, qt, a_state):
        passed = None if drop_a_state else a_state
        return kops.qtensor_matmul(x, qt, a_state=passed, backend="torch")

    args: Tuple[Any, ...] = (x, qt)
    argnames: Tuple[str, ...] = ("x", "qt")
    fn: Callable = lambda x, qt: run(x, qt, None)  # noqa: E731
    if a_state is not None:
        args = (x, qt, tuple(a_state))
        argnames = ("x", "qt", "a_state")
        fn = run
    name = f"qtensor_matmul[{layout}]"
    if drop_a_state:
        name += "[seeded:a_state_drop]"
    return trace_entry(fn, args, name=name, argnames=argnames, ranges=ranges,
                       envelope=layout)


def matmul_entries(device: DeviceLike = None) -> List[TracedEntry]:
    from repro_torch.analysis.layouts import MATMUL_LAYOUTS
    return [qtensor_matmul_entry(row[0], device=device)
            for row in MATMUL_LAYOUTS]


# ----------------------------------------------------------- deploy decode
def deploy_smoke_lm(arch: str = "smollm-135m", device: DeviceLike = None):
    """Quantize the smoke LM (iters=0: export-only) and return the deploy
    pieces — ``(cfg, model, qparams, ctx)`` — that the decode and serving
    entries trace through (the reference's ``_deploy_smoke_lm``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.context import QuantCtx
    from repro_torch.core.reconstruct import quantize_blocks
    from repro_torch.data import CalibrationSet, SyntheticTokens
    from repro_torch.models.model import build_model

    dev = resolve_device(device)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(_gen(0, dev), device=dev)
    recipe = QuantRecipe(method="flexround", w_bits=4, a_bits=8, iters=0,
                         batch_size=4)
    cal = CalibrationSet.build(SyntheticTokens(vocab=cfg.vocab, seq_len=16,
                                               seed=0), 4)
    x0, blocks, assemble = model.quant_blocks(params, cal.tokens.to(dev))
    finalized, astates, _ = quantize_blocks(blocks, recipe, x0)
    qparams = assemble(finalized)
    ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates,
                   backend="torch")
    return cfg, model, qparams, ctx


def _plain(lm):
    """``lm`` with its ctx on the plain versions (what the tracer can see)."""
    cfg, model, qparams, ctx = lm
    return cfg, model, qparams, dataclasses.replace(ctx, backend="torch")


def deploy_decode_entry(arch: str = "smollm-135m",
                        allow_unused: Tuple[str, ...] = (), *, lm=None,
                        device: DeviceLike = None) -> TracedEntry:
    """The LM's deploy-mode decode step (uniform batch, an int position)
    — every QTensor code/scale/zero leaf and every LSQ deploy grid must
    stay live through the serving path. ``lm``: an exported
    ``(cfg, model, qparams, ctx)`` (default: the smoke LM's)."""
    from repro_torch.core.qtensor import tree_weight_bytes
    from repro_torch.kernels.envelope import get_envelope
    from repro_torch.serve import kv as skv

    dev = resolve_device(device)
    cfg, model, qparams, ctx = _plain(lm or deploy_smoke_lm(arch, dev))
    batch, prompt = 2, 8
    max_len = prompt + 4
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=_gen(1, dev),
                        device=dev)
    cache = model.init_cache(batch, max_len, device=dev)

    def step(p, t, c):
        return model.decode_step(p, t, c, prompt, ctx)[0]

    args = (qparams, tok, cache)
    return trace_entry(
        step, args,
        name=f"deploy_decode[{cfg.name}]",
        argnames=("params", "tokens", "cache"), carry=("cache.*",),
        allow_unused=allow_unused,
        mem=mem_contract(
            args, max_len=max_len,
            envelope_len=get_envelope("serve_kv").seq_max, slots=batch,
            note="packed weights + [batch, max_len] fp KV window; len "
                 "headroom covers the attention's f32 window views",
            expect=(("weights", "params*", tree_weight_bytes(qparams)),
                    ("kv_cache", "cache*", skv.cache_bytes(cache)))))


# ------------------------------------------------------------ serve engine
def _serve_smoke_config(*, kv_quant: bool = True, dtype=None):
    """The one smoke-scale ``EngineConfig`` every serve trace entry uses.

    ``max_len=24`` deliberately: memcheck classifies a buffer as
    window-scaled when ``max_len`` appears in its shape, so the window
    length must be unique among the smoke LM's dims (d_model=64, heads=4,
    kv_heads=2, head_dim=16, d_ff=128, vocab=128) — 16 would make every
    attention head-dim buffer look like KV state. Buckets stay [8, 16].
    """
    from repro_torch.serve import engine as seng

    kw = {} if dtype is None else {"dtype": dtype}
    return seng.EngineConfig(slots=2, max_len=24, prefill_group=2,
                             kv_quant=kv_quant, min_bucket=8, **kw)


def _serve_kv_ranges(prefix: str) -> Tuple[Tuple[str, float, float], ...]:
    """Value-range contract for the slot state's int8 KV cache: stored
    scales are floored at kv_quantize's KV_SCALE_MIN (so QL303 can prove no
    divisor over them is subnormal), codes live on the int8 grid. First
    match wins, so scales precede the code catch-all."""
    from repro_torch.kernels.envelope import get_envelope
    env = get_envelope("serve_kv")
    return (
        (f"{prefix}.*scale*", env.scale_min, env.scale_max),
        (f"{prefix}.*", -float(env.code_max), float(env.code_max)),
    )


def _serve_expect(qparams, state, ecfg):
    from repro_torch.core.qtensor import tree_weight_bytes
    from repro_torch.serve import kv as skv
    return (("weights", "params*", tree_weight_bytes(qparams)),
            ("kv_cache", "state.cache*",
             skv.hbm_per_slot_bytes(state["cache"], ecfg.slots)
             * ecfg.slots))


def serve_prefill_entry(arch: str = "smollm-135m", bucket: int = 8, *,
                        lm=None, device: DeviceLike = None) -> TracedEntry:
    """The serving engine's bucket prefill-insert, traced on the body
    ``ServeEngine`` captures: slot state written in place (QL203/QL402),
    every KV scale live (QL201) and the int8 KV scale range contract
    (QL303)."""
    from repro_torch.kernels.envelope import get_envelope
    from repro_torch.serve import engine as seng

    dev = resolve_device(device)
    cfg, model, qparams, ctx = _plain(lm or deploy_smoke_lm(arch, dev))
    ecfg = _serve_smoke_config()
    state = seng.init_state(model, ecfg, dev)
    G = ecfg.prefill_group
    io = {"prompt": {bucket: torch.randint(0, cfg.vocab, (G, bucket),
                                           generator=_gen(2, dev),
                                           device=dev)},
          "true_len": torch.full((G,), bucket, dtype=torch.int64, device=dev),
          "slot_ids": torch.arange(G, dtype=torch.int64, device=dev),
          "max_new": torch.full((G,), 4, dtype=torch.int32, device=dev),
          "first": torch.zeros((G,), dtype=torch.int32, device=dev)}
    args = (qparams, state, io)
    mem = mem_contract(
        args, max_len=ecfg.max_len,
        envelope_len=get_envelope("serve_kv").seq_max, slots=ecfg.slots,
        note="weights + in-place [slots, max_len] slot state; the bucket's "
             "fresh prefill cache and activations are window-independent "
             "(bucket-sized) and ride in the fixed headroom",
        expect=_serve_expect(qparams, state, ecfg))
    return trace_entry(
        seng.make_prefill(model, ctx, ecfg, bucket), args,
        name=f"serve_prefill[{cfg.name}][b{bucket}]",
        argnames=("params", "state", "io"), carry=("state.*", "io.first"),
        captured=dev.type == "cuda", ranges=_serve_kv_ranges("state.cache"),
        envelope="serve_kv", mem=mem)


def serve_decode_entry(arch: str = "smollm-135m", kv_quant: bool = True, *,
                       lm=None, device: DeviceLike = None) -> TracedEntry:
    """The serving engine's slot decode step (KV cache and slot counters
    written in place, active-masked position/budget update) — the loop the
    engine runs once per emitted token, so a dead scale input or an
    aliased state buffer here is a serving bug.

    ``kv_quant=False`` traces the bf16-KV variant of the same step:
    memcheck compares the two entries' per-slot window bytes to prove, from
    the graphs alone, that the int8 cache pins less memory per slot than
    the bf16 one (QL405)."""
    from repro_torch.kernels.envelope import get_envelope
    from repro_torch.serve import engine as seng

    dev = resolve_device(device)
    cfg, model, qparams, ctx = _plain(lm or deploy_smoke_lm(arch, dev))
    ecfg = _serve_smoke_config(
        kv_quant=kv_quant, dtype=None if kv_quant else torch.bfloat16)
    state = seng.init_state(model, ecfg, dev)
    io = {"emitted": torch.zeros((ecfg.slots,), dtype=torch.int32,
                                 device=dev)}
    tag = "" if kv_quant else "[bf16-kv]"
    ranges = (_serve_kv_ranges("state.cache") if kv_quant
              else (("state.cache.*", -64.0, 64.0),))
    args = (qparams, state, io)
    mem = mem_contract(
        args, max_len=ecfg.max_len,
        envelope_len=get_envelope("serve_kv").seq_max, slots=ecfg.slots,
        note="packed weights + in-place [slots, max_len] KV window; len "
             "headroom covers the attention's f32 window views",
        expect=_serve_expect(qparams, state, ecfg))
    return trace_entry(
        seng.make_decode(model, ctx, ecfg), args,
        name=f"serve_decode[{cfg.name}]{tag}",
        argnames=("params", "state", "io"), carry=("state.*", "io.*"),
        captured=dev.type == "cuda", ranges=ranges, envelope="serve_kv",
        mem=mem)


# ------------------------------------------------- quantcheck (QL3xx) entries
def flexround_apply_entry(*, underflow: bool = False, d: int = 32,
                          h: int = 16,
                          device: DeviceLike = None) -> TracedEntry:
    """The PTQ inner loop's fake-quant Ŵ = s1*(clip(round(W/(s1⊙S2⊙s3))+z)-z)
    traced for the interval interpreter.

    The healthy range contract mirrors ``flexround.project``: every divisor
    factor is floored at EPS = 1e-6, so the s1*s2*s3 product is provably
    normal (>= 1e-18 >> float32 tiny) and QL303 stays quiet.
    ``underflow=True`` re-seeds the factors at ~1e-18 each — the projection
    bug quantcheck exists to catch — making the whole divisor interval
    subnormal."""
    from repro_torch.core import flexround
    from repro_torch.kernels.envelope import get_envelope

    dev = resolve_device(device)
    qcfg = QuantConfig(bits=4, symmetric=False, observer="minmax",
                       granularity="per_channel")
    w = _normal((d, h), 17, dev, 0.1)
    state = flexround.init(w, qcfg)
    env = get_envelope("flexround_apply")
    lo, hi = ((1e-20, 1e-18) if underflow
              else (env.scale_min, env.scale_max))
    ranges = (
        ("w*", -env.x_abs_max, env.x_abs_max),
        ("state.s1*", lo, hi),
        ("state.s2*", lo, hi),
        ("state.s3*", lo, hi),
        ("state.zero*", 0.0, float(qcfg.qmax)),
    )
    name = "flexround_apply"
    if underflow:
        name += "[seeded:scale_underflow]"
    return trace_entry(lambda w, state: flexround.apply(w, state, qcfg),
                       (w, state), name=name, argnames=("w", "state"),
                       ranges=ranges, envelope="flexround_apply")


def int8_overflow_entry(device: DeviceLike = None) -> TracedEntry:
    """Seeded QL301 fixture: the W8A8 matmul accumulating in int16.

    int8 x int8 products reach 2^14; even the smoke-scale K = 48
    contraction tops 2^19, and the envelope's k_max = 32768 pushes the
    proof bound to ~2^29 — far past int16 either way. The healthy path
    keeps an int32 accumulator (K3) or its exact float64 image (the plain
    version); this entry re-introduces the narrow accumulator."""
    dev = resolve_device(device)
    g = _gen(23, dev)
    a_q = torch.randint(-128, 128, (8, 48), generator=g, device=dev,
                        dtype=torch.int8)
    b_q = torch.randint(-128, 128, (48, 24), generator=g, device=dev,
                        dtype=torch.int8)

    def bad(a_q, b_q):
        prod = a_q.to(torch.int16)[:, :, None] * b_q.to(torch.int16)[None]
        return prod.sum(dim=1, dtype=torch.int16).float()

    return trace_entry(bad, (a_q, b_q), name="qmatmul_int8[seeded:int16_acc]",
                       argnames=("a_q", "b_q"), envelope="w8a8")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def one_rank_mesh(device: DeviceLike = None):
    """A 1 x 1 mesh with the reference's axis names whose two axes have
    process groups of their own (``init_device_mesh`` would give both the
    default group: a world of one covers each axis); in a larger world each
    rank gets its own. Starts a gloo world of one on a free localhost port
    when no process group runs; returns (mesh, started)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    started = False
    if not dist.is_initialized():
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
        started = True
    # every rank makes its own singleton groups (a collective call)
    data, _ = dist.new_subgroups(group_size=1, backend="gloo")
    model, _ = dist.new_subgroups(group_size=1, backend="gloo")
    mesh = DeviceMesh.from_group([data, model], dev.type,
                                 mesh=[[dist.get_rank()]],
                                 mesh_dim_names=("data", "model"))
    return mesh, started


def lost_psum_entry(mesh=None, device: DeviceLike = None) -> TracedEntry:
    """Seeded QL305 fixture: a sharded loss whose all-reduce runs over the
    *model* group instead of the data group — the per-rank loss is never
    reduced over data parallelism, so every rank trains on a different
    objective (the classic lost psum). Traced on a 1 x 1 mesh
    (``one_rank_mesh``) unless ``mesh`` is given."""
    import torch.distributed as dist

    dev = resolve_device(device)
    started = False
    if mesh is None:
        mesh, started = one_rank_mesh(dev)
    try:
        data, model = mesh.get_group("data"), mesh.get_group("model")

        def local_loss(x, y):
            err = torch.mean((x - y) ** 2)
            # BUG (seeded): reduces over "model", leaving "data" unreduced
            dist.all_reduce(err, group=model)
            return err

        x = torch.ones((8, 16), device=dev)
        y = torch.ones((8, 16), device=dev)
        return trace_entry(local_loss, (x, y),
                           name="sharded_loss[seeded:lost_psum]",
                           argnames=("x", "y"), mesh=mesh, dp=("data",),
                           dp_group=data, loss=("<out>",))
    finally:
        if started:
            dist.destroy_process_group()


# ------------------------------------------------- memcheck (QL4xx) fixtures
def dead_donation_entry(device: DeviceLike = None) -> TracedEntry:
    """Seeded QL402 fixture: an int8 codes buffer declared a carry of a
    reduction that returns only a float32 scalar — the graph never writes
    it, so the state update the caller counts on never happens in place.
    QL203 stays quiet (nothing is written, nothing aliases); this is its
    silent inverse, visible only to the carry accounting."""
    dev = resolve_device(device)
    codes = torch.randint(-127, 128, (64, 64), generator=_gen(31, dev),
                          device=dev, dtype=torch.int8)

    def flush_stats(codes):
        return torch.mean(torch.abs(codes.float()))

    return trace_entry(flush_stats, (codes,),
                       name="kv_flush_stats[seeded:dead_donation]",
                       argnames=("codes",), carry=("codes",))


def hbm_blowout_entry(device: DeviceLike = None) -> TracedEntry:
    """Seeded QL401 fixture: decode attention that dequantizes the *whole*
    int8 KV window to float32 before contracting — the regression
    ``serve.kv.int8_decode_attention`` exists to prevent. The budget is
    the honest dequant-free path's (int8 codes + float32 scales per window
    token, modest slack), so the materialized 4-bytes-per-element window
    blows past it at the traced length, and far worse at the envelope's."""
    dev = resolve_device(device)
    slots, max_len, heads, d = 2, 24, 2, 16
    codes = torch.randint(-127, 128, (slots, max_len, heads, d),
                          generator=_gen(32, dev), device=dev,
                          dtype=torch.int8)
    scale = torch.full((slots, max_len, heads, 1), 1e-2, device=dev)
    q = _normal((slots, 1, heads, d), 33, dev)

    def bad_attention(q, codes, scale):
        # BUG (seeded): rematerializes the full window in float32 as a
        # named intermediate (the healthy path folds scales in after the
        # contraction)
        kv = codes.float() * scale
        s = torch.einsum("bqhd,bkhd->bhqk", q, kv)
        return torch.sum(torch.softmax(s, dim=-1))

    args = (q, codes, scale)
    # tight, int8-sized budget: no 8x float32-view headroom, 2 KiB slack
    mem = mem_contract(args, max_len=max_len, envelope_len=8192, slots=slots,
                       headroom=1.5, len_headroom=1.5, fixed_extra=2048,
                       note="dequant-free budget: int8 codes + scales only")
    return trace_entry(bad_attention, args,
                       name="decode_attention[seeded:hbm_blowout]",
                       argnames=("q", "codes", "scale"), mem=mem)


def label_matches(label: str, glob: str) -> bool:
    """Exact match first: labels like ``a_state.[0]`` contain fnmatch
    character-class metachars."""
    return label == glob or fnmatch.fnmatch(label, glob)


__all__ = ["MemContract", "TracedEntry", "Collective", "trace_entry",
           "mem_contract", "toy_block", "toy_chain", "toy_recipe",
           "recon_chunk_entry", "probe_entry", "qtensor_matmul_entry",
           "matmul_entries", "deploy_smoke_lm", "deploy_decode_entry",
           "serve_prefill_entry", "serve_decode_entry",
           "flexround_apply_entry", "int8_overflow_entry", "one_rank_mesh",
           "lost_psum_entry", "dead_donation_entry", "hbm_blowout_entry"]
