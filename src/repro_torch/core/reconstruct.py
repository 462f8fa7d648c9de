"""Block-wise and layer-wise PTQ reconstruction (port of
``repro/core/reconstruct.py``, paper §3.1, §4).

For each block B (a transformer layer, or one linear for ``recon="layer"``):

    y_fp = B_fp(x_fp)                       teacher on the fp stream
    init every site's rounding state (observer grid) and, from ranges on
    the student stream x_q, the LSQ activation states
    learn the states minimizing ||y_fp - B_recon(x_q)||^2 (+ AdaRound's
    regularizer) with Adam, QDrop dropping activation quantization
    export every site to a QTensor; x_q <- B_deploy(x_q); x_fp <- y_fp

**The engine.** One Adam step of a block is one body (``_Engine.step``):
the recon forward and its backward (``torch.autograd`` on the state
leaves; the block's weights take no gradient), the rounding states' Adam
update at ``AdamConfig(lr=1.0)`` with each site's ``plan.lr`` as the
per-leaf ``lr_scale``, then the LSQ states' at ``recipe.lr_lsq``, each
followed by its ``project``. It reads and writes only static buffers that
the engine owns: the block's params, the rounding and LSQ states and both
Adam moments, ``x_q``, ``y_fp`` and the optional sample weights, the
``(iters, bs)`` minibatch indices, a step counter on the device and the
``(iters,)`` loss and MSE curves. The device step selects the minibatch
row, Adam's bias corrections (``adam.bias_correction_tables``) and
AdaRound's β (``adaround.beta_tables``), places the curves' entries and is
advanced in the body, so a step neither reads the host nor waits on the
device.

**Shared engines.** Site names are rewritten to position tokens ``~s<i>``
at the ctx boundary (``_RenameCtx``), which key the engine's state dicts,
plans and QDrop streams, so structurally identical blocks share one
engine. Its cache key is the reference's (the block's ``apply_key``; the
canonical sites with their plans' cache keys; the recipe) plus what the
buffers fix: the shapes and dtypes of params, states and streams, whether
sample weights and minibatch indices are given, and the device. Models
stamp the layers of one ``quant_blocks`` call with a shared ``apply_key``,
so the 30 layers of smollm-135m under a W4 body with W8 first and last
layers use two engines. Before each block ``_Engine.load`` copies the
block's params, initial states and streams in, zeroes the moments, the
counter and the curves, and seeds the engine's generators (one per
canonical site, seeded ``qdrop.site_seed(seed, real site name)``: the
draws of fresh ``qdrop.SiteStreams``). The step then runs ``recipe.iters``
times; every ``chunk`` steps the host waits for the device (one
``recon.chunk`` span and profiler annotation each); the states are copied
out. ``quantize_blocks`` runs inside ``engine_scope()``, which releases the
engines (and their graphs) built for its blocks when it returns.

**CUDA graphs.** On a card the engine captures the step in a
``torch.cuda.CUDAGraph`` at its first block: ``WARMUP_STEPS`` steps on a
side stream (autograd and cuBLAS set up their workspaces), the block
loaded again so the warm-up leaves no trace, the generators registered
with the graph, one step captured in the graph's own memory pool; then it
replays the graph. Each capture counts in ``engine_stats().step_compiles``
and goes to ``obs.compile_events`` (attributed to the open ``recon.block``
span). A failed capture or replay raises; nothing falls back to eager
steps on its own. On the CPU the same body runs call by call.
``graphs=False`` runs it call by call on a card too: it exists only as the
eager side of a comparison (``chip_smoke.py``, the card tests).

Random draws (the minibatch schedule and QDrop's masks) come from
``torch.Generator`` objects on the run's device, seeded from the block's
seed. A caller may pass its own draws instead (``Schedule``), which is how
the parity tests replay JAX's: each step's given masks are handed to the
body as its QDrop draws, so such a run is not captured.

Per-block checkpoints (``quantize_blocks(checkpoint_dir=)``) resume a
killed run at its first unfinished block with the streams, states, reports
and block seeds of a run without a break, so the resumed run's results
equal that run's bit for bit. (The reference's resume pushes the saved
streams through the finished blocks a second time and draws block 0's key
for the first resumed block; ROADMAP Queue 3 records the fault, which the
port does not copy.) With telemetry enabled each block opens a
``recon.block`` span and every chunk of its steps a ``recon.chunk`` span.

The bit allocator's sensitivity probe (``repro_torch.allocate``) takes
its teacher from ``probe_teacher`` and counts the probe bodies it builds
with ``count_probe_compile``; it keeps its probe cache inside
``engine_scope``. Not ported here (see ROADMAP): data parallelism over a
mesh (``mesh=``, Queue 1 item 11). The teacher, the student pass and
``recon_error`` run eagerly once per block.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from functools import partial
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import lsq, qdrop
from repro_torch.core import paths as pth
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import dequantize_qtensor
from repro_torch.core.quant_config import QuantRecipe, SitePlan
from repro_torch.obs import compile_events, profiler
from repro_torch.obs.telemetry import TELEMETRY, Stopwatch, block_on
from repro_torch.optim.adam import (AdamConfig, adam_init, adam_update_,
                                    bias_correction_tables)

DEFAULT_CHUNK = 100  # steps between host syncs (the reference's scan chunk)
WARMUP_STEPS = 3     # steps run on a side stream before a capture

# Per-site lr rules ride adam_update_'s per-leaf lr_scale tree, so the base
# config carries lr=1.0 and each leaf scales it by its plan's lr.
_W_BASE_CFG = AdamConfig(lr=1.0)

Key = Union[None, int, torch.Generator]


@dataclasses.dataclass
class Site:
    """One quantizable weight inside a block."""
    path: Tuple  # path of the leaf within the block's param subtree
    kind: str = "linear"  # linear | conv
    batch_dims: int = 0


@dataclasses.dataclass
class BlockHandle:
    """A reconstruction unit: params + apply(params, x, ctx) -> y.

    ``apply_key``: optional hashable token naming the computation of
    ``apply`` apart from this block's parameter values and site names.
    Blocks that carry the same token (the layers one ``quant_blocks`` call
    returns) share one engine. The token must be fresh per call: the apply
    closures bake per-call constants (the rope tables). ``None`` shares
    nothing (the engine is still cached per apply function)."""
    name: str
    params: Any
    apply: Callable[[Any, torch.Tensor, QuantCtx], torch.Tensor]
    sites: Dict[str, Site]
    apply_key: Optional[Any] = None


def _empty_curve() -> np.ndarray:
    return np.zeros((0,), np.float32)


@dataclasses.dataclass
class BlockReport:
    name: str
    err_before: float
    err_after: float
    iters: int
    seconds: float
    steps_per_s: float = 0.0
    # per-step loss / MSE trajectories, read from the device once per block
    loss_curve: Any = dataclasses.field(default_factory=_empty_curve)
    mse_curve: Any = dataclasses.field(default_factory=_empty_curve)
    # "graph": the steps replayed a captured CUDA graph; "eager": the body
    # ran call by call
    engine: str = "eager"

    _CURVES = ("loss_curve", "mse_curve")

    def to_json(self) -> dict:
        """JSON-safe dict: trajectories as float lists."""
        d = dataclasses.asdict(self)
        for k in self._CURVES:
            d[k] = np.asarray(getattr(self, k), np.float32).tolist()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "BlockReport":
        """Inverse of ``to_json``; unknown keys are dropped, missing ones
        take the field defaults."""
        known = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in d.items() if k in known}
        for k in cls._CURVES:
            if k in kept:
                kept[k] = np.asarray(kept[k], np.float32)
        return cls(**kept)


@dataclasses.dataclass
class Schedule:
    """Draws for one block's run supplied by the caller in place of the
    run's generators: ``idx`` (iters, bs) minibatch indices, None for the
    full batch; ``masks``, per step, a mapping from site name to a boolean
    QDrop mask (True keeps fp), None to draw them from the site streams."""
    idx: Any = None
    masks: Optional[Sequence[Mapping[str, Any]]] = None


# ------------------------------------------------------------ engine stats
@dataclasses.dataclass
class EngineStats:
    """The engine cache's counters, under the reference's names.
    ``step_compiles`` counts CUDA-graph captures of the step (0 on the
    CPU, which captures nothing); ``engine_builds`` and ``engine_hits``
    count cache misses and hits on every device. The port runs the
    teacher, the student pass, ``recon_error`` and the minibatch schedule
    eagerly once per block, so their counters stay 0. ``probe_compiles``
    counts the sensitivity probe's bodies built (``repro_torch.allocate``),
    one per probe key on every device; on a card each is also one capture.
    It counts builds where ``step_compiles`` counts captures only, so it is
    not 0 on the CPU."""
    step_compiles: int = 0
    schedule_compiles: int = 0
    teacher_compiles: int = 0
    student_compiles: int = 0
    recon_error_compiles: int = 0
    probe_compiles: int = 0
    engine_builds: int = 0
    engine_hits: int = 0

    @property
    def compile_count(self) -> int:
        return (self.step_compiles + self.schedule_compiles +
                self.teacher_compiles + self.student_compiles +
                self.recon_error_compiles + self.probe_compiles)


_STATS = EngineStats()


def engine_stats() -> EngineStats:
    return _STATS


def reset_engine_stats() -> EngineStats:
    """Zero the counters. The engine cache is not cleared: pair with
    ``clear_engine_cache`` to measure cold."""
    for f in dataclasses.fields(EngineStats):
        setattr(_STATS, f.name, f.default)
    return _STATS


def clear_engine_cache() -> None:
    _ENGINE_CACHE.clear()


@contextlib.contextmanager
def engine_scope():
    """Evict the engines built inside the scope when it exits; entries that
    existed before are untouched. ``quantize_blocks`` runs in one: its
    blocks' ``apply_key`` tokens are fresh per call, so its engines can
    never hit again, yet they pin the model, the rope tables, their
    buffers and, on a card, their graphs and memory pools."""
    _SCOPE_STACK.append(set())
    try:
        yield
    finally:
        for k in _SCOPE_STACK.pop():
            _ENGINE_CACHE.pop(k, None)


def site_plans(block: BlockHandle, recipe: QuantRecipe) -> Dict[str, SitePlan]:
    """Resolve the recipe's rules once per block: site name -> SitePlan."""
    return {name: recipe.resolve(name, site)
            for name, site in block.sites.items()}


def init_wstates(block: BlockHandle, recipe: QuantRecipe) -> Dict[str, Any]:
    out = {}
    for name, site in block.sites.items():
        plan = recipe.resolve(name, site)
        w = pth.get_path(block.params, site.path)
        out[name] = plan.method.init(w, plan.weight)
    return out


@torch.no_grad()
def init_astates(block: BlockHandle, recipe: QuantRecipe, x_q: torch.Tensor,
                 prev: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """LSQ init from observed ranges on the student stream (one calib pass,
    skipped when no site of the block quantizes activations)."""
    states = dict(prev or {})
    plans = site_plans(block, recipe)
    if all(p.act is None for p in plans.values()):
        return states
    ctx = QuantCtx(mode="calib", recipe=recipe)
    block.apply(block.params, x_q, ctx)
    for name, (lo, hi) in ctx.records.items():
        plan = plans.get(name) or recipe.resolve(name)
        if plan.act is None:
            continue
        sample = torch.tensor([lo, hi], dtype=torch.float32, device=x_q.device)
        states[name] = lsq.init(sample, plan.act)
    return states


def _trainable_mask(wstates, astates, plans: Dict[str, SitePlan]):
    wmask = {k: plans[k].method.trainable(v) for k, v in wstates.items()}
    amask = {k: lsq.trainable(v) for k, v in astates.items()}
    return wmask, amask


# ------------------------------------------------- canonical names, trees
class _RenameCtx:
    """Ctx proxy translating the model's site names to canonical tokens, so
    one engine serves every structurally identical block: state dicts, plan
    lookups and QDrop streams all key on the token. Names outside the
    mapping pass through (they hold no state here and stay fp)."""
    __slots__ = ("_ctx", "_map")

    def __init__(self, ctx: QuantCtx, mapping: Dict[str, str]):
        self._ctx = ctx
        self._map = mapping

    def linear(self, name, *args, **kwargs):
        return self._ctx.linear(self._map.get(name, name), *args, **kwargs)

    def conv2d(self, name, *args, **kwargs):
        return self._ctx.conv2d(self._map.get(name, name), *args, **kwargs)

    def get_weight(self, name, *args, **kwargs):
        return self._ctx.get_weight(self._map.get(name, name), *args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._ctx, item)


def _canon_names(block: BlockHandle) -> Dict[str, str]:
    """real site name -> position token (in sorted order, so structurally
    identical blocks map corresponding sites to the same token)."""
    return {rn: f"~s{i}" for i, rn in enumerate(sorted(block.sites))}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of a nested dict/list, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _sig(tree):
    """Hashable layout of a tree: its structure and each tensor's shape and
    dtype (other leaves by value)."""
    if isinstance(tree, dict):
        return tuple((k, _sig(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_sig(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return ("~leaf", repr(tree))


def _copy(dst, src) -> None:
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


def _write(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    """Copy the leaves of ``src`` (a ``project`` result) into ``dst``."""
    for k, t in src.items():
        if t is not dst[k]:
            dst[k].copy_(t)


def _grad_leaves(states, mask, tag):
    """States whose trainable leaves are fresh autograd leaves (views of
    the static leaves)."""
    out, leaves = {}, []
    for k, st in states.items():
        out[k] = {}
        for n, t in st.items():
            if mask[k][n]:
                t = t.detach().requires_grad_(True)
                leaves.append((tag, k, n, t))
            out[k][n] = t
    return out, leaves


# ------------------------------------------------------------------ engine
class _Engine:
    """The static buffers and the step body of one equivalence class of
    blocks and, on a card, the step captured in a CUDA graph. Holds the
    exemplar block's apply (so an id()-keyed entry stays valid) with the
    exemplar's name mapping."""

    def __init__(self, block: BlockHandle, recipe: QuantRecipe,
                 plans_c: Dict[str, SitePlan], mapping: Dict[str, str],
                 c_w, c_a, x_q, y_fp, sample_weight, idx):
        dev = x_q.device

        def empty(t):
            return torch.empty_like(t) if isinstance(t, torch.Tensor) else t

        self.apply, self.mapping = block.apply, mapping
        self.recipe, self.plans = recipe, plans_c
        self.a_cfg = AdamConfig(lr=recipe.lr_lsq)
        self.params = _map(empty, block.params)
        self.ws, self.as_ = _map(empty, c_w), _map(empty, c_a)
        # float32 moments (both configs' default): load() zeroes them
        self.wmu = adam_init(self.ws, _W_BASE_CFG)["mu"]
        self.amu = adam_init(self.as_, self.a_cfg)["mu"]
        self.x_q, self.y_fp = empty(x_q), empty(y_fp)
        self.sw = None if sample_weight is None else empty(sample_weight)
        self.idx = None if idx is None else torch.empty_like(idx)
        self.step_t = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.losses = torch.zeros((recipe.iters,), dtype=torch.float32,
                                  device=dev)
        self.mses = torch.zeros_like(self.losses)
        self.w_corr = bias_correction_tables(_W_BASE_CFG, recipe.iters, dev)
        self.a_corr = bias_correction_tables(self.a_cfg, recipe.iters, dev)
        self.wmask, self.amask = _trainable_mask(self.ws, self.as_, plans_c)
        self.w_lr = {k: {n: plans_c[k].lr for n in v}
                     for k, v in self.ws.items()}
        # gradients of leaves that no method trains (or that the forward
        # does not reach): zeros, made at the first step
        self.zero_g: Dict[Tuple[str, str, str], torch.Tensor] = {}
        self.streams = {c: torch.Generator(device=dev) for c in sorted(plans_c)}
        self.graph = None

    # -------------------------------------------------------------- body
    def step(self, drop: Callable[[str], qdrop.MaskOrGenerator]) -> None:
        """One Adam step over the static buffers; ``drop`` maps a canonical
        site to its QDrop draw. The MSE is a weighted mean over the batch
        when sample weights are given, the plain mean otherwise."""
        recipe, plans, step = self.recipe, self.plans, self.step_t
        if self.idx is None:
            xb, yb, wb = self.x_q, self.y_fp, self.sw
        else:
            ix = self.idx.index_select(0, step).reshape(-1)
            xb, yb = self.x_q.index_select(0, ix), self.y_fp.index_select(0, ix)
            wb = None if self.sw is None else self.sw.index_select(0, ix)
        ws, wl = _grad_leaves(self.ws, self.wmask, "w")
        as_, al = _grad_leaves(self.as_, self.amask, "a")
        leaves = wl + al
        with torch.enable_grad():
            ctx = QuantCtx(mode="recon", recipe=recipe, wstates=ws,
                           astates=as_, key=drop, plans=plans)
            y = self.apply(self.params, xb, _RenameCtx(ctx, self.mapping))
            se = torch.square(y.float() - yb.float())
            if wb is None:
                mse = torch.mean(se)
            else:
                per = torch.mean(se.reshape(se.shape[0], -1), dim=1)
                w = wb.float()
                mse = torch.sum(per * w) / torch.clamp(torch.sum(w), min=1e-9)
            reg = torch.zeros((), dtype=torch.float32, device=se.device)
            for name, st in ws.items():
                plan = plans[name]
                reg = reg + plan.method.loss_extra(st, plan.weight, step,
                                                   recipe)
            loss = mse + reg
            grads = (torch.autograd.grad(loss, [t for *_, t in leaves],
                                         allow_unused=True)
                     if leaves and loss.requires_grad else [None] * len(leaves))
        got = {(tag, k, n): g for (tag, k, n, _), g in zip(leaves, grads)
               if g is not None}
        with torch.no_grad():
            c1, c2 = (t.index_select(0, step).reshape(()) for t in self.w_corr)
            adam_update_(self._grads(self.ws, got, "w"), self.wmu, self.ws,
                         _W_BASE_CFG, c1, c2, lr_scale=self.w_lr)
            for k, st in self.ws.items():
                _write(st, plans[k].method.project(st))
            if self.as_:
                c1, c2 = (t.index_select(0, step).reshape(())
                          for t in self.a_corr)
                adam_update_(self._grads(self.as_, got, "a"), self.amu,
                             self.as_, self.a_cfg, c1, c2)
                for st in self.as_.values():
                    _write(st, lsq.project(st))
            self.losses.index_copy_(0, step, loss.detach().reshape(1))
            self.mses.index_copy_(0, step, mse.detach().reshape(1))
            step.add_(1)

    def _grads(self, states, got, tag):
        """The gradient tree of ``states``: autograd's, else zeros (such a
        leaf still rides Adam, as in the reference, and stays put)."""
        out = {}
        for k, st in states.items():
            out[k] = {}
            for n, t in st.items():
                g = got.get((tag, k, n))
                if g is None:
                    g = self.zero_g.get((tag, k, n))
                    if g is None:
                        g = self.zero_g[(tag, k, n)] = torch.zeros_like(t)
                out[k][n] = g
        return out

    # ----------------------------------------------------------- driving
    @torch.no_grad()
    def load(self, params, c_w, c_a, x_q, y_fp, sample_weight, idx,
             seeds: Dict[str, int]) -> None:
        """Copy one block's params, initial states and streams into the
        buffers; zero the moments, the counter and the curves; seed the
        QDrop generators (canonical site -> seed)."""
        _copy(self.params, params)
        _copy(self.ws, c_w)
        _copy(self.as_, c_a)
        for t in _tensors((self.wmu, self.amu)):
            t.zero_()
        self.x_q.copy_(x_q)
        self.y_fp.copy_(y_fp)
        if sample_weight is not None:
            self.sw.copy_(sample_weight)
        if idx is not None:
            self.idx.copy_(idx)
        self.step_t.zero_()
        self.losses.zero_()
        self.mses.zero_()
        for c, gen in self.streams.items():
            gen.manual_seed(seeds[c])

    def capture(self, reload: Callable[[], None]) -> None:
        """Warm the step up on a side stream, ``reload`` the block, capture
        one step in the graph's own memory pool, ``reload`` again. The step
        launches no hand-written kernel (recon mode dequantizes nothing);
        whatever the warm-up and the capture launch stays out of the kernel
        counters all the same."""
        from repro_torch.kernels import ops
        dev = self.x_q.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        drop = self.streams.__getitem__
        with ops.set_aside(), torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                self.step_t.zero_()  # every warm-up step reads row 0
                self.step(drop)
        torch.cuda.current_stream(dev).wait_stream(stream)
        reload()
        graph = torch.cuda.CUDAGraph()
        for gen in self.streams.values():
            graph.register_generator_state(gen)
        sw = Stopwatch()
        with ops.set_aside(), torch.cuda.graph(graph, stream=stream):
            self.step(drop)
        dur = sw.elapsed_s()
        self.graph = graph
        _STATS.step_compiles += 1
        compile_events.record_capture("recon.step", dur)
        reload()

    def run(self, graphed: bool, masks, inv: Dict[str, str], chunk: int,
            name: str) -> None:
        """``recipe.iters`` steps: replays of the captured step, or the body
        called directly; with ``masks`` (a ``Schedule``'s, keyed by real
        site names; ``inv`` maps canonical names back), each step draws its
        own. The host waits for the device at the end of every chunk of
        ``chunk`` steps."""
        iters = self.recipe.iters
        it = n_chunk = 0
        while it < iters:
            n = min(chunk, iters - it)
            with TELEMETRY.span("recon.chunk", block=name, start=it,
                                steps=n) as sp, \
                    profiler.annotate("recon.chunk", n_chunk):
                for t in range(it, it + n):
                    if masks is not None:
                        self.step(lambda c, m=masks[t]: m[inv[c]])
                    elif graphed:
                        self.graph.replay()
                    else:
                        self.step(self.streams.__getitem__)
                sp.block_on(self.mses)  # the span records its sync
                block_on(self.mses)  # and the annotation holds the device's
            it += n
            n_chunk += 1


_ENGINE_CACHE: "collections.OrderedDict[Any, _Engine]" = collections.OrderedDict()
_ENGINE_CACHE_MAX = 64
# Engines built inside a quantize_blocks call are evicted when it returns
# (engine_scope); entries from direct reconstruct_block use stay in the
# bounded LRU.
_SCOPE_STACK: List[set] = []


def _get_engine(block: BlockHandle, recipe: QuantRecipe,
                plans: Dict[str, SitePlan], canon: Dict[str, str],
                c_w, c_a, x_q, y_fp, sample_weight, idx) -> _Engine:
    akey = (block.apply_key if block.apply_key is not None
            else ("~obj", id(block.apply)))
    sites = tuple(sorted(
        (canon[rn], s.kind, s.batch_dims, plans[rn].cache_key())
        for rn, s in block.sites.items()))
    # what the static buffers (and a captured graph) fix
    bufs = (x_q.device, _sig(block.params), _sig(c_w), _sig(c_a),
            _sig(x_q), _sig(y_fp), _sig(sample_weight), _sig(idx))
    key = (akey, sites, recipe, bufs)
    eng = _ENGINE_CACHE.get(key)
    if eng is not None:
        _STATS.engine_hits += 1
        _ENGINE_CACHE.move_to_end(key)
        return eng
    eng = _Engine(block, recipe, {canon[rn]: plans[rn] for rn in block.sites},
                  canon, c_w, c_a, x_q, y_fp, sample_weight, idx)
    _STATS.engine_builds += 1
    _ENGINE_CACHE[key] = eng
    if _SCOPE_STACK:
        _SCOPE_STACK[-1].add(key)
    while len(_ENGINE_CACHE) > _ENGINE_CACHE_MAX:
        _ENGINE_CACHE.popitem(last=False)
    return eng


@torch.no_grad()
def recon_error(block: BlockHandle, recipe: QuantRecipe, wstates, astates,
                x_q, y_fp, plans: Optional[Dict[str, SitePlan]] = None) -> float:
    """Mean squared block-output error of the recon forward, QDrop off."""
    ctx = QuantCtx(mode="recon", recipe=recipe, wstates=wstates,
                   astates=astates, drop_enabled=False, plans=plans)
    y = block.apply(block.params, x_q, ctx)
    return float(torch.mean(torch.square(y.float() - y_fp.float())))


# ------------------------------------------------------------------- seeds
def _seed(key: Key, recipe: QuantRecipe) -> int:
    """An int seed from ``key``: None -> ``recipe.seed``; an int as is; a
    generator gives one draw (a host sync if it lives on the card)."""
    if key is None:
        return int(recipe.seed)
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2**62, (1,), generator=key,
                                 device=key.device))
    return int(key)


def _batch_schedule(gen: torch.Generator, iters: int, n: int, bs: int):
    """(iters, bs) minibatch indices, each row ``bs`` of ``n`` without
    replacement, drawn on the generator's device in one call; None when the
    batch is the whole set."""
    if bs >= n:
        return None
    return torch.argsort(torch.rand((iters, n), generator=gen,
                                    device=gen.device), dim=1)[:, :bs]


def _use_graphs(graphs: Optional[bool], device: torch.device) -> bool:
    """``graphs`` resolved against the run's device: None captures on a
    card; True on the CPU raises, as ``ServeEngine`` does."""
    on_card = device.type == "cuda"
    if graphs and not on_card:
        raise ValueError(f"graphs=True needs a CUDA device, got {device}; on "
                         "the CPU the step runs directly (graphs=None)")
    return on_card if graphs is None else bool(graphs)


def _run(block: BlockHandle, recipe: QuantRecipe, plans: Dict[str, SitePlan],
         wstates, astates_all, x_q, y_fp, seed: int, sample_weight=None,
         schedule: Optional[Schedule] = None, chunk: int = DEFAULT_CHUNK,
         graphs: Optional[bool] = None):
    """The optimization loop of one block: returns (wstates, astates_all,
    err0, err1, loop_seconds, loss_curve, mse_curve, engine)."""
    dev = x_q.device
    graphed = _use_graphs(graphs, dev)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    a_in = {r: astates_all[r] for r in block.sites if r in astates_all}
    err0 = recon_error(block, recipe, wstates, a_in, x_q, y_fp, plans)
    if not recipe.iters:  # nothing to learn: no engine, no draws
        return (wstates, dict(astates_all), err0, err0, 0.0, _empty_curve(),
                _empty_curve(), "eager")

    n = x_q.shape[0]
    bs = min(recipe.batch_size, n)
    masks = None
    if schedule is not None:
        idx = (None if schedule.idx is None
               else torch.as_tensor(np.asarray(schedule.idx), device=dev).long())
        masks = schedule.masks
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        idx = _batch_schedule(gen, recipe.iters, n, bs)
    graphed = graphed and masks is None  # given masks are copied in per step

    canon = _canon_names(block)
    inv = {c: r for r, c in canon.items()}
    c_w = {canon[r]: v for r, v in wstates.items()}
    c_a = {canon[r]: v for r, v in a_in.items()}
    eng = _get_engine(block, recipe, plans, canon, c_w, c_a, x_q, y_fp,
                      sample_weight, idx)
    seeds = {c: qdrop.site_seed(seed, inv[c]) for c in eng.streams}
    reload = partial(eng.load, block.params, c_w, c_a, x_q, y_fp,
                     sample_weight, idx, seeds)
    reload()
    if graphed and eng.graph is None:
        eng.capture(reload)
    sw = Stopwatch()
    eng.run(graphed, masks, inv, chunk, block.name)
    curves = torch.stack([eng.losses, eng.mses]).cpu().numpy()
    loop_s = sw.elapsed_s()

    def out(states):
        return {inv[c]: {k: t.clone() for k, t in st.items()}
                for c, st in states.items()}

    w_out, a_new = out(eng.ws), out(eng.as_)
    err1 = recon_error(block, recipe, w_out, a_new, x_q, y_fp, plans)
    a_out = dict(astates_all)
    a_out.update(a_new)
    return (w_out, a_out, err0, err1, loop_s, curves[0], curves[1],
            "graph" if graphed else "eager")


def reconstruct_block(block: BlockHandle, recipe: QuantRecipe,
                      x_q: torch.Tensor, y_fp: torch.Tensor, key: Key = None,
                      astates: Optional[Dict[str, Any]] = None, *,
                      sample_weight: Optional[torch.Tensor] = None,
                      schedule: Optional[Schedule] = None,
                      chunk: int = DEFAULT_CHUNK,
                      graphs: Optional[bool] = None,
                      ) -> Tuple[Dict[str, Any], Dict[str, Any], BlockReport]:
    """Optimize the rounding (and LSQ) states of one block; returns
    (wstates, astates, report). ``key``: a seed or a ``torch.Generator``
    (None: ``recipe.seed``). ``sample_weight``: optional (N,) per-sample
    loss weights. ``schedule``: the caller's draws (see ``Schedule``).
    ``chunk``: steps between host syncs (one ``recon.chunk`` span each).
    ``graphs``: None replays the step's CUDA graph on a card and runs the
    body directly on the CPU; False runs it directly on a card too (for
    comparisons only); True on the CPU raises."""
    sw = Stopwatch()
    with TELEMETRY.span("recon.block", block=block.name, iters=recipe.iters):
        plans = site_plans(block, recipe)
        with torch.no_grad():
            wstates = init_wstates(block, recipe)
        astates = astates if astates is not None else init_astates(
            block, recipe, x_q)
        (wstates, astates, err0, err1, loop_s, loss_curve, mse_curve,
         engine) = _run(block, recipe, plans, wstates, astates, x_q, y_fp,
                        _seed(key, recipe), sample_weight, schedule, chunk,
                        graphs)
    return wstates, astates, BlockReport(
        block.name, err0, err1, recipe.iters, sw.elapsed_s(),
        steps_per_s=recipe.iters / max(loop_s, 1e-9),
        loss_curve=loss_curve, mse_curve=mse_curve, engine=engine)


@torch.no_grad()
def finalize_block(block: BlockHandle, recipe: QuantRecipe, wstates,
                   as_qtensor: bool = True) -> Any:
    """Replace every site's weight with its exported QTensor (or, with
    ``as_qtensor=False``, its dequantized weight); each site exports with
    its own plan (mixed bit-widths in one block are fine)."""
    params = block.params
    for name, site in block.sites.items():
        plan = recipe.resolve(name, site)
        w = pth.get_path(params, site.path)
        qt = plan.method.export(w, wstates[name], plan.weight, dtype=w.dtype)
        params = pth.set_path(params, site.path,
                              qt if as_qtensor else dequantize_qtensor(qt))
    return params


# --------------------------------------------------------------- probe entry
def probe_teacher(block: BlockHandle, recipe: QuantRecipe, mesh=None):
    """The teacher for sensitivity-probe passes (``repro_torch.allocate``):
    ``(params, x) -> y``, the block's fp forward under ``torch.no_grad``.
    The port runs it eagerly, so it compiles nothing and
    ``teacher_compiles`` stays 0. ``mesh`` (a sharded probe pass) is not
    ported (ROADMAP Queue 1 item 11)."""
    if mesh is not None:
        raise NotImplementedError(
            "probe_teacher(mesh=...): data parallelism over a mesh is not "
            "ported yet (ROADMAP Queue 1 item 11)")
    del recipe  # the fp forward reads no plan

    @torch.no_grad()
    def teacher(params, x):
        return block.apply(params, x, QuantCtx(mode="fp"))

    return teacher


def count_probe_compile() -> None:
    """Called once per probe body built (``repro_torch.allocate``), so
    ``engine_stats().probe_compiles`` counts them."""
    _STATS.probe_compiles += 1


# --------------------------------------------------------------------- driver
@torch.no_grad()
def _explode_layerwise(block: BlockHandle, recipe: QuantRecipe, x_q):
    """Per-site sub-blocks for recon='layer': one capture pass records every
    site's input; each site becomes a standalone linear or conv problem
    (a conv site with the reference's stride 1 and "SAME" padding)."""
    ctx_q = QuantCtx(mode="capture", recipe=recipe)
    block.apply(block.params, x_q, ctx_q)
    subs = []
    for name, site in block.sites.items():
        x_site = ctx_q.records[name][0]
        w = pth.get_path(block.params, site.path)

        if site.kind == "conv":
            def apply_fn(p, x, ctx, _n=name):
                return ctx.conv2d(_n, x, p["w"])
        else:
            def apply_fn(p, x, ctx, _n=name, _bd=site.batch_dims):
                return ctx.linear(_n, x, p["w"], batch_dims=_bd)

        sub = BlockHandle(name=f"{block.name}/{name}", params={"w": w},
                          apply=apply_fn,
                          sites={name: Site(path=("w",), kind=site.kind,
                                            batch_dims=site.batch_dims)},
                          apply_key=("~layerwise", site.kind,
                                     site.batch_dims))
        subs.append((name, sub, x_site))
    return subs


def quantize_blocks(blocks: List[BlockHandle], recipe: QuantRecipe,
                    x0: torch.Tensor, key: Key = None, as_qtensor: bool = True,
                    checkpoint_dir: Optional[str] = None,
                    progress: Optional[Callable[[str], None]] = None, *,
                    allocation: Optional[dict] = None,
                    sample_weight: Optional[torch.Tensor] = None,
                    chunk: int = DEFAULT_CHUNK,
                    graphs: Optional[bool] = None,
                    ) -> Tuple[List[Any], Dict[str, Any], List[BlockReport]]:
    """Sequentially quantize a chain of blocks (the paper's full procedure).

    Returns (per-block finalized params, astates, reports). ``key``: a seed
    or a ``torch.Generator`` (None: ``recipe.seed``); each block takes its
    own seed from it, and in layer-wise mode each site folds its salt into
    its block's. Tensors stay on x0's device.

    ``checkpoint_dir``: after each block the finalized blocks, activation
    states, reports and both streams are saved there (atomically); a run
    that finds a checkpoint resumes at its first unfinished block, taking
    the streams as saved and drawing (and discarding) the seeds of the
    finished blocks. ``allocation``: summary of the bit allocation that
    emitted the recipe's rules, recorded in every checkpoint; a resume
    whose per-site plans or allocation digest differ raises ("PTQ resume
    mismatch"). ``chunk`` and ``graphs`` as in ``reconstruct_block``.

    Structurally identical blocks share one engine (``BlockHandle.apply_key``);
    the engines built here are released when the call returns
    (``engine_scope``)."""
    _use_graphs(graphs, x0.device)  # fail before any work
    with engine_scope():
        return _quantize_blocks(blocks, recipe, x0, key, as_qtensor,
                                checkpoint_dir, progress, allocation,
                                sample_weight, chunk, graphs)


def _quantize_blocks(blocks, recipe, x0, key, as_qtensor, checkpoint_dir,
                     progress, allocation, sample_weight, chunk, graphs):
    seeds = torch.Generator()
    seeds.manual_seed(_seed(key, recipe))
    x_fp = x_q = x0
    astates: Dict[str, Any] = {}
    finalized: List[Any] = []
    reports: List[BlockReport] = []
    ckpt, start = None, 0
    if checkpoint_dir is not None:
        # imported here: the checkpoint module imports core (QTensor)
        from repro_torch.checkpoint.checkpoint import PTQCheckpointer
        ckpt = PTQCheckpointer(checkpoint_dir)
        resumed = ckpt.load(blocks, recipe, allocation=allocation,
                            device=x0.device)
        if resumed is not None:
            start, finalized, astates, reports, x_fp, x_q = resumed
    for i, block in enumerate(blocks):
        bseed = int(torch.randint(0, 2**62, (1,), generator=seeds))
        if i < start:  # finished before the checkpoint: nothing to redo
            continue
        with torch.no_grad():
            y_fp = block.apply(block.params, x_fp, QuantCtx(mode="fp"))
        astates = init_astates(block, recipe, x_q, prev=astates)
        if recipe.recon == "layer":
            wstates: Dict[str, Any] = {}
            for name, sub, x_site in _explode_layerwise(block, recipe, x_q):
                with torch.no_grad():
                    y_site = sub.apply(sub.params, x_site, QuantCtx(mode="fp"))
                ws, a_sub, rep = reconstruct_block(
                    sub, recipe, x_site, y_site,
                    qdrop.fold_in(bseed, qdrop.salt(name)),
                    astates=dict(astates), sample_weight=sample_weight,
                    chunk=chunk, graphs=graphs)
                astates.update(a_sub)
                wstates[name] = ws[name]
                reports.append(rep)
        else:
            wstates, astates, rep = reconstruct_block(
                block, recipe, x_q, y_fp, bseed, astates=astates,
                sample_weight=sample_weight, chunk=chunk, graphs=graphs)
            reports.append(rep)
        new_params = finalize_block(block, recipe, wstates,
                                    as_qtensor=as_qtensor)
        finalized.append(new_params)
        with torch.no_grad():
            student = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
            x_q = block.apply(new_params, x_q, student)
        x_fp = y_fp
        if progress:
            progress(f"[{i + 1}/{len(blocks)}] {block.name} "
                     f"err {reports[-1].err_before:.3e} -> "
                     f"{reports[-1].err_after:.3e}")
        if ckpt is not None:
            plan_meta = [{n: p.summary()
                          for n, p in site_plans(b, recipe).items()}
                         for b in blocks[:i + 1]]
            ckpt.save(i + 1, finalized, astates, reports, x_fp, x_q,
                      plans=plan_meta, allocation=allocation)
    return finalized, astates, reports
