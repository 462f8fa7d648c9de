"""Per-site quantization-sensitivity probes (port of
``repro/allocate/sensitivity.py``, EPTQ-style, paper §3.1 blocks).

Scores every canonical weight site under each candidate bit-width with two
complementary signals, both measured on the calibration set *before* any
rounding is learned:

  mse     block-output MSE with only that site RTN-quantized at ``bits``
          (teacher vs gated student on the full-precision stream) — the
          direct "what breaks if this site goes to b bits" signal.
  fisher  a diagonal-Fisher / loss-perturbation proxy (AdaRound Eq. (3)
          lineage): for y = xW the Gauss–Newton diagonal of the output MSE
          w.r.t. W is E[x_i^2], so the expected perturbation is
          sum_i E[x_i^2] * sum_j dW_ij^2 / d_out with dW the RTN rounding
          error. Needs one capture pass per block and pure weight-space math
          — no extra block forwards.

**The probe body.** The reference jits one probe step per (``apply_key``,
candidate ``bits``) with a traced one-hot gate. The port's counterpart is
one ``_Probe`` per probe key (``_probe_key`` plus the shapes and dtypes of
its buffers and the device, as ``reconstruct._get_engine`` keys engines).
It owns static buffers: the block's params, the RTN states of every
canonical site, ``x``, ``y_fp``, a boolean one-hot gate on the device and a
float32 scalar for the MSE. The body fake-quantizes every site and the gate
selects, per site, the raw weight or its RTN fake-quant (``_ProbeCtx``);
activations stay fp. ``load`` copies one block in; each site then sets the
gate in place (a device copy), runs the body and reads one float. Site
names are canonicalized with the engine's rename machinery, so the L
structurally identical layers of a transformer share one probe per bit
width: the pass builds O(distinct apply_keys x bits) bodies, not O(sites)
(``engine_stats().probe_compiles``, one per body built, on every device).

On a card the body is captured once in a ``torch.cuda.CUDAGraph`` (a
warm-up on a side stream, then the capture in the graph's own memory pool,
recorded in ``obs.compile_events`` as ``alloc.probe``) and replayed for
every site. On the CPU the same body runs call by call. ``graphs=False``
runs it call by call on a card too, only as the eager side of a
comparison. A failed capture or replay raises. The probe cache lives
inside ``reconstruct.engine_scope()`` and is released with it.

Under a data-parallel ``mesh`` (``launch.mesh``) every rank passes the
whole calibration stream and probes its rows of it (``reconstruct``'s
rows, replicated when the ranks do not divide them): the probe MSE is a
sum over the global element count, all-reduced after each replay, and the
fisher proxy's per-feature sums of squares and their counts are
all-reduced once per block, so every rank gets the same scores and the
same allocation. The teacher, the body and the capture pass hand the
model the rank's rows of the global batch (``QuantCtx.rows``): a MoE
block routes the global token groups and gathers them where a rank's rows
split one (``models/moe.py``); its captured expert inputs are then the
global batch's on every rank, which the sums' counts account for. Such a
body holds a collective, so under a gloo group on a card the bodies run
call by call. The bodies stay one per probe key.

RTN is used as the probe quantizer regardless of the recipe's method: every
learnable method starts from the RTN grid, so RTN error ordering is the
method-agnostic sensitivity signal (and it needs no optimization).

Scores also carry a *cascade weight* (L - block_index): sequential
reconstruction feeds each block the already-quantized stream, so damage at
depth i is paid by every later block. The solver multiplies scores by it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import paths as pth
from repro_torch.core import reconstruct as rec
from repro_torch.core import rtn
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantConfig, QuantRecipe
from repro_torch.obs import compile_events
from repro_torch.obs.telemetry import TELEMETRY, Stopwatch, block_on

DEFAULT_BITS = (2, 3, 4, 8)


@dataclasses.dataclass(frozen=True)
class SiteScore:
    """Sensitivity of one site at one candidate bit-width."""
    site: str
    bits: int
    mse: float        # calibration block-output MSE, this site alone quantized
    fisher: float     # diagonal-Fisher / loss-perturbation proxy
    cost_bytes: int   # serving bytes of this site's QTensor at `bits`
    numel: int        # weight elements (cost unit for avg_bits budgets)
    # Cascade weight: block-local damage at depth i corrupts the quantized
    # stream feeding every later block, so sequential reconstruction pays it
    # ~(L - i) times. The solver multiplies scores by this.
    cascade: float = 1.0


@dataclasses.dataclass
class ProbeResult:
    """All probe scores plus the pass's cost accounting. ``init_seconds``
    (the RTN state inits, i.e. the observer, once per site and bit width)
    and ``replay_seconds`` (the probe bodies, each read back) are the
    port's additions; both are synced host time."""
    scores: Dict[str, Dict[int, SiteScore]]  # site -> bits -> score
    steps: int           # probe forward evaluations executed
    seconds: float
    compile_count: int   # probe bodies + teacher compiles this pass triggered
    init_seconds: float = 0.0
    replay_seconds: float = 0.0

    @property
    def steps_per_s(self) -> float:
        return self.steps / max(self.seconds, 1e-9)

    def sites(self) -> Tuple[str, ...]:
        return tuple(sorted(self.scores))


class _ProbeCtx:
    """Gated probe context: each site's effective weight is either the raw
    weight or its RTN fake-quant, selected by a boolean gate on the device;
    all activations stay fp. One-hot gates isolate a single site per call
    while the body stays the same for every site of the block."""

    __slots__ = ("_fp", "_cfgs", "_wstates", "_gates")

    def __init__(self, cfgs: Dict[str, QuantConfig], wstates: Dict[str, Any],
                 gates: Dict[str, torch.Tensor], rows=None):
        self._fp = QuantCtx(mode="fp", rows=rows)
        self._cfgs = cfgs
        self._wstates = wstates
        self._gates = gates

    def _gated(self, name, w):
        cfg = self._cfgs.get(name)
        if cfg is None or name not in self._wstates:
            return w
        w_hat = rtn.apply(w, self._wstates[name], cfg)
        return torch.where(self._gates[name], w_hat, w).to(w.dtype)

    def linear(self, name, x, w, b=None, batch_dims=0):
        return self._fp.linear(name, x, self._gated(name, w), b,
                               batch_dims=batch_dims)

    def conv2d(self, name, x, w, b=None, **kwargs):
        return self._fp.conv2d(name, x, self._gated(name, w), b, **kwargs)

    def get_weight(self, name, w, batch_dims=0):
        return self._gated(name, w)

    def __getattr__(self, item):
        return getattr(self._fp, item)


def _probe_key(block: rec.BlockHandle, plans, canon, bits: int,
               recipe: QuantRecipe):
    akey = (block.apply_key if block.apply_key is not None
            else ("~obj", id(block.apply)))
    sites = tuple(sorted(
        (canon[rn], s.kind, s.batch_dims, plans[rn].cache_key())
        for rn, s in block.sites.items()))
    return (akey, sites, bits, recipe)


class _Probe:
    """The static buffers and the body of one probe key and, on a card, the
    body captured in a CUDA graph. Holds the exemplar block's apply with
    the exemplar's name mapping (as ``reconstruct._Engine`` does)."""

    def __init__(self, block: rec.BlockHandle, cfgs_c: Dict[str, QuantConfig],
                 mapping: Dict[str, str], wstates_c, x, y_fp, rows):
        dev = x.device

        def empty(t):
            return torch.empty_like(t) if isinstance(t, torch.Tensor) else t

        self.apply, self.mapping, self.cfgs = block.apply, mapping, cfgs_c
        self.params = rec._map(empty, block.params)
        self.wstates = rec._map(empty, wstates_c)
        self.x, self.y_fp = torch.empty_like(x), torch.empty_like(y_fp)
        self.slot = {c: i for i, c in enumerate(sorted(cfgs_c))}
        self.gate = torch.zeros((len(self.slot),), dtype=torch.bool,
                                device=dev)
        self.onehot = torch.eye(len(self.slot), dtype=torch.bool, device=dev)
        self.mse = torch.zeros((), dtype=torch.float32, device=dev)
        # the squared errors of every rank's rows
        self.rows = rows
        self.count = rows.n * y_fp[0].numel() if rows.split else y_fp.numel()
        self.graph = None

    @torch.no_grad()
    def body(self) -> None:
        gates = {c: self.gate[i] for c, i in self.slot.items()}
        ctx = _ProbeCtx(self.cfgs, self.wstates, gates, self.rows.batch())
        y = self.apply(self.params, self.x, rec._RenameCtx(ctx, self.mapping))
        self.mse.copy_(torch.sum(torch.square(y.float() - self.y_fp.float()))
                       / self.count)

    @torch.no_grad()
    def load(self, params, wstates_c, x, y_fp) -> None:
        """Copy one block's params, RTN states and streams into the
        buffers."""
        rec._copy(self.params, params)
        rec._copy(self.wstates, wstates_c)
        self.x.copy_(x)
        self.y_fp.copy_(y_fp)

    def capture(self) -> None:
        """Warm the body up on a side stream, then capture it in the graph's
        own memory pool. The body launches no hand-written kernel (fp mode
        dequantizes nothing); whatever the warm-up and the capture launch
        stays out of the kernel counters all the same."""
        from repro_torch.kernels import ops
        dev = self.x.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with ops.set_aside(), torch.cuda.stream(stream):
            for _ in range(rec.WARMUP_STEPS):
                self.body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        sw = Stopwatch()
        # a MoE body under a mesh gathers: NCCL's watchdog polls while the
        # capture runs, which a global capture would refuse
        mode = "thread_local" if self.rows.split else "global"
        with ops.set_aside(), torch.cuda.graph(graph, stream=stream,
                                               capture_error_mode=mode):
            self.body()
        compile_events.record_capture("alloc.probe", sw.elapsed_s())
        self.graph = graph

    def run(self, site_c: str, graphed: bool) -> float:
        """The MSE with only canonical site ``site_c`` quantized."""
        self.gate.copy_(self.onehot[self.slot[site_c]])
        if graphed:
            self.graph.replay()
        else:
            self.body()
        return float(self.rows.sum(self.mse))


def _site_bytes(w: torch.Tensor, state: Dict[str, torch.Tensor], bits: int,
                batch_dims: int) -> int:
    """Serving bytes this site would occupy as a QTensor at ``bits``: packed
    codes + the affine grid, mirroring ``qtensor.from_codes`` storage (<=4
    bits nibble-pack along the first non-batch axis when its dim is even)."""
    numel = w.numel()
    pack_axis = min(batch_dims, w.dim() - 1)
    packed = bits <= 4 and w.shape[pack_axis] % 2 == 0
    code_bytes = numel // 2 if packed else numel
    grid_bytes = 4 * (state["s1"].numel() + state["zero"].numel())
    return int(code_bytes + grid_bytes)


def _fisher_proxy(dw: torch.Tensor, m2: Optional[torch.Tensor]) -> float:
    """sum_i E[x_i^2] sum_j dW_ij^2 / d_out with the input-feature axis at
    -2 (linear (d_in, d_out), conv (kh, kw, cin, cout) and stacked
    experts (E, d_in, d_out) store it there). ``m2`` is the captured per-feature second moment; None (site
    never exercised by the capture pass) degrades to an unweighted squared
    error."""
    dw32 = dw.float()
    if m2 is None:
        return float(torch.sum(dw32 * dw32) / dw.shape[-1])
    return float(torch.sum(m2[:, None] * dw32 * dw32) / dw.shape[-1])


@torch.no_grad()
def _second_moments(block: rec.BlockHandle, recipe: QuantRecipe,
                    x: torch.Tensor, rows) -> Dict[str, torch.Tensor]:
    """One capture pass: each exercised site's per-input-feature E[x^2]
    over its first recorded input. Under a split mesh the sums of squares
    and the counts are all-reduced (one collective) and divided after: a
    record of this rank's rows adds its share, and one that every rank
    holds whole (a gathered MoE's expert input) adds its sums and counts
    once per rank, which the quotient cancels."""
    cap = QuantCtx(mode="capture", recipe=recipe, rows=rows.batch())
    block.apply(block.params, x, cap)
    sums, counts = {}, {}
    for rn in block.sites:
        xs = cap.records.get(rn)
        if xs:
            x32 = xs[0].float()
            sums[rn] = torch.sum(x32 * x32, dim=tuple(range(x32.dim() - 1)))
            counts[rn] = torch.full((1,), float(x32.numel() // x32.shape[-1]),
                                    device=x32.device)
    if rows.split and sums:
        red = rows.dp.all_reduce(list(sums.values()) + list(counts.values()))
        sums = dict(zip(sums, red[:len(sums)]))
        counts = dict(zip(counts, red[len(sums):]))
    return {rn: sums[rn] / counts[rn] for rn in sums}


def probe_blocks(blocks: Sequence[rec.BlockHandle], recipe: QuantRecipe,
                 x0: torch.Tensor, bits: Sequence[int] = DEFAULT_BITS,
                 mesh=None, *, graphs: Optional[bool] = None) -> ProbeResult:
    """Score every site of every block at each candidate bit-width.

    Runs on the full-precision stream (probing happens before any site is
    finalized): block b's probe input is the teacher output of block b-1.
    Per-site rules in ``recipe`` shape the probe configs (granularity,
    symmetry, observer) — only ``bits`` is swept. ``graphs``: None replays
    each probe's CUDA graph on a card and runs the body directly on the
    CPU; False runs it directly on a card too (comparisons only); True on
    the CPU raises. ``mesh``: a ``DeviceMesh``; every rank passes the whole
    ``x0`` and gets every score (module docstring).
    """
    rows = rec._Rows.of(rec._data_parallel(mesh), x0.shape[0])
    # a body may gather (a MoE under the mesh): not captured under gloo
    graphed = rec._use_graphs(graphs, x0.device,
                              rows.dp if rows.split else None)
    stats0 = dataclasses.replace(rec.engine_stats())
    sw = Stopwatch()
    steps = 0
    init_s = replay_s = 0.0
    scores: Dict[str, Dict[int, SiteScore]] = {}
    probe_cache: Dict[Any, _Probe] = {}

    with rec.engine_scope():
        try:
            x = rows.take(x0)
            for bi, block in enumerate(blocks):
                cascade = float(len(blocks) - bi)
                with TELEMETRY.span("alloc.teacher", block=block.name) as tsp:
                    y_fp = rec.probe_teacher(block, recipe, mesh, rows=rows)(
                        block.params, x)
                    tsp.block_on(y_fp)
                plans = rec.site_plans(block, recipe)
                canon = rec._canon_names(block)
                m2 = _second_moments(block, recipe, x, rows)

                for b in bits:
                    cfgs_c = {canon[rn]: dataclasses.replace(plans[rn].weight,
                                                             bits=b)
                              for rn in block.sites}
                    t_init = Stopwatch()
                    weights, wstates = {}, {}
                    with torch.no_grad():
                        for rn, site in block.sites.items():
                            w = pth.get_path(block.params, site.path)
                            weights[rn] = w
                            wstates[canon[rn]] = rtn.init(w, cfgs_c[canon[rn]])
                    block_on(wstates)
                    init_s += t_init.elapsed_s()

                    pkey = (_probe_key(block, plans, canon, b, recipe),
                            (x.device, rec._sig(block.params),
                             rec._sig(wstates), rec._sig(x), rec._sig(y_fp)),
                            rows)
                    probe = probe_cache.get(pkey)
                    if probe is None:
                        probe = _Probe(block, cfgs_c, canon, wstates, x, y_fp,
                                       rows)
                        rec.count_probe_compile()
                        probe_cache[pkey] = probe
                    probe.load(block.params, wstates, x, y_fp)
                    if graphed and probe.graph is None:
                        probe.capture()

                    for rn, site in block.sites.items():
                        # float() syncs, so the probe span needs no block_on
                        with TELEMETRY.span("alloc.probe", block=block.name,
                                            site=rn, bits=b):
                            t_run = Stopwatch()
                            mse = probe.run(canon[rn], graphed)
                            replay_s += t_run.elapsed_s()
                        steps += 1
                        w, st = weights[rn], wstates[canon[rn]]
                        with torch.no_grad():
                            dw = rtn.apply(w, st, cfgs_c[canon[rn]]) - w
                        scores.setdefault(rn, {})[b] = SiteScore(
                            site=rn, bits=b, mse=mse,
                            fisher=_fisher_proxy(dw, m2.get(rn)),
                            cost_bytes=_site_bytes(w, st, b, site.batch_dims),
                            numel=int(w.numel()), cascade=cascade)
                x = y_fp  # advance the fp stream
        finally:
            probe_cache.clear()

    st1 = rec.engine_stats()
    compiles = ((st1.probe_compiles - stats0.probe_compiles) +
                (st1.teacher_compiles - stats0.teacher_compiles))
    return ProbeResult(scores=scores, steps=steps, seconds=sw.elapsed_s(),
                       compile_count=compiles, init_seconds=init_s,
                       replay_seconds=replay_s)
