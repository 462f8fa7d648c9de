"""Block-wise and layer-wise PTQ reconstruction (port of
``repro/core/reconstruct.py``, paper §3.1, §4).

For each block B (a transformer layer, or one linear for ``recon="layer"``):

    y_fp = B_fp(x_fp)                       teacher on the fp stream
    init every site's rounding state (observer grid) and, from ranges on
    the student stream x_q, the LSQ activation states
    learn the states minimizing ||y_fp - B_recon(x_q)||^2 (+ AdaRound's
    regularizer) with Adam, QDrop dropping activation quantization
    export every site to a QTensor; x_q <- B_deploy(x_q); x_fp <- y_fp

The reference runs chunks of steps inside a jitted ``lax.scan``; here one
step is an eager forward and backward (``torch.autograd`` on the state
leaves; the block's weights take no gradient) followed by two Adam updates
under ``no_grad``: the rounding states at ``AdamConfig(lr=1.0)`` with each
site's ``plan.lr`` as the per-leaf ``lr_scale``, then the LSQ states at
``recipe.lr_lsq``, each followed by its ``project``. Loss and MSE stay on
the device in preallocated ``(iters,)`` tensors: the host reads them once
per block, so no step waits on the device.

Random draws (the minibatch schedule and QDrop's masks) come from
``torch.Generator`` objects on the run's device, seeded from the block's
seed; QDrop keeps one stream per site, keyed by the crc32 salt of the site
name (``qdrop.SiteStreams``). A caller may pass its own draws instead
(``Schedule``), which is how the parity tests replay JAX's.

Per-block checkpoints (``quantize_blocks(checkpoint_dir=)``) resume a
killed run at its first unfinished block with the streams, states, reports
and block seeds of a run without a break, so the resumed run's results
equal that run's bit for bit. (The reference's resume pushes the saved
streams through the finished blocks a second time and draws block 0's key
for the first resumed block; ROADMAP Queue 3 records the fault, which the
port does not copy.) With telemetry enabled each block opens a
``recon.block`` span and its Adam loop a ``recon.chunk`` span, synced to the
device at its end.

Not ported here (see ROADMAP): the reference's compiled-engine cache and
its counters (``engine_stats``, ``engine_scope``, ``probe_teacher``; the
eager loop compiles nothing) and data parallelism over a mesh (``mesh=``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import lsq, qdrop
from repro_torch.core import paths as pth
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import dequantize_qtensor
from repro_torch.core.quant_config import QuantRecipe, SitePlan
from repro_torch.obs import profiler
from repro_torch.obs.telemetry import TELEMETRY, Stopwatch
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update

# Per-site lr rules ride adam_update's per-leaf lr_scale tree, so the base
# config carries lr=1.0 and each leaf scales it by its plan's lr.
_W_BASE_CFG = AdamConfig(lr=1.0)

Key = Union[None, int, torch.Generator]


@dataclasses.dataclass
class Site:
    """One quantizable weight inside a block."""
    path: Tuple  # path of the leaf within the block's param subtree
    kind: str = "linear"
    batch_dims: int = 0


@dataclasses.dataclass
class BlockHandle:
    """A reconstruction unit: params + apply(params, x, ctx) -> y."""
    name: str
    params: Any
    apply: Callable[[Any, torch.Tensor, QuantCtx], torch.Tensor]
    sites: Dict[str, Site]


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


# ----------------------------------------------------------- step math
def _make_step_fn(apply_fn: Callable, recipe: QuantRecipe,
                  plans: Dict[str, SitePlan], a_opt_cfg: AdamConfig):
    """One optimization step. Sites may carry different plans (method,
    bits, lr): each site's state is updated by its own method inside one
    tree-wide Adam update whose per-leaf lr_scale carries the rule lrs.

    ``sw`` (optional, per-sample weights) turns the MSE into a weighted
    mean over the batch; ``sw=None`` is the plain mean. A leaf its method
    does not train gets a zero gradient and still rides Adam, as in the
    reference (so it stays where it is)."""
    zeros: Dict[Tuple[str, str, str], torch.Tensor] = {}

    def loss_fn(params, wstates, astates, x_q, y_fp, sw, step, key):
        ctx = QuantCtx(mode="recon", recipe=recipe, wstates=wstates,
                       astates=astates, key=key, plans=plans)
        y = apply_fn(params, x_q, ctx)
        se = torch.square(y.float() - y_fp.float())
        if sw is None:
            mse = torch.mean(se)
        else:
            per = torch.mean(se.reshape(se.shape[0], -1), dim=1)
            w = sw.float()
            mse = torch.sum(per * w) / torch.clamp(torch.sum(w), min=1e-9)
        reg = torch.zeros((), dtype=torch.float32)
        for name, st in wstates.items():
            plan = plans[name]
            reg = reg + plan.method.loss_extra(st, plan.weight, step, recipe)
        return mse + reg, mse

    def _leafs(states, mask, tag):
        """States whose trainable leaves are fresh autograd leaves."""
        out, leaves = {}, []
        for k, st in states.items():
            out[k] = {}
            for n, t in st.items():
                if mask[k][n]:
                    t = t.detach().requires_grad_(True)
                    leaves.append((tag, k, n, t))
                out[k][n] = t
        return out, leaves

    def _grad_tree(states, got, tag):
        out = {}
        for k, st in states.items():
            out[k] = {}
            for n, t in st.items():
                g = got.get((tag, k, n))
                if g is None:
                    z = zeros.get((tag, k, n))
                    if z is None:
                        z = zeros[(tag, k, n)] = torch.zeros_like(t)
                    g = z
                out[k][n] = g
        return out

    def step_fn(params, wstates, astates, wopt, aopt, x_q, y_fp, sw, step,
                key):
        wmask, amask = _trainable_mask(wstates, astates, plans)
        ws, wl = _leafs(wstates, wmask, "w")
        as_, al = _leafs(astates, amask, "a")
        leaves = wl + al
        with torch.enable_grad():
            loss, mse = loss_fn(params, ws, as_, x_q, y_fp, sw, step, key)
            grads = (torch.autograd.grad(loss, [t for *_, t in leaves],
                                         allow_unused=True)
                     if leaves and loss.requires_grad else [None] * len(leaves))
        got = {(tag, k, n): g for (tag, k, n, _), g in zip(leaves, grads)
               if g is not None}
        with torch.no_grad():
            gw = _grad_tree(wstates, got, "w")
            w_lr = {k: {n: plans[k].lr for n in v} for k, v in wstates.items()}
            wstates, wopt, _ = adam_update(gw, wopt, wstates, _W_BASE_CFG,
                                           lr_scale=w_lr)
            wstates = {k: plans[k].method.project(v)
                       for k, v in wstates.items()}
            if astates:
                ga = _grad_tree(astates, got, "a")
                astates, aopt, _ = adam_update(ga, aopt, astates, a_opt_cfg)
                astates = {k: lsq.project(v) for k, v in astates.items()}
        return wstates, astates, wopt, aopt, loss.detach(), mse.detach()

    return step_fn


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


def _run(block: BlockHandle, recipe: QuantRecipe, plans: Dict[str, SitePlan],
         wstates, astates_all, x_q, y_fp, seed: int, sample_weight=None,
         schedule: Optional[Schedule] = None):
    """The optimization loop of one block: returns (wstates, astates_all,
    err0, err1, loop_seconds, loss_curve, mse_curve)."""
    dev = x_q.device
    a_opt_cfg = AdamConfig(lr=recipe.lr_lsq)
    c_a = {r: astates_all[r] for r in block.sites if r in astates_all}
    wopt = adam_init(wstates, _W_BASE_CFG)
    aopt = adam_init(c_a, a_opt_cfg)
    step = _make_step_fn(block.apply, recipe, plans, a_opt_cfg)

    n = x_q.shape[0]
    bs = min(recipe.batch_size, n)
    if schedule is not None:
        idx = (None if schedule.idx is None
               else torch.as_tensor(np.asarray(schedule.idx), device=dev).long())
        masks = schedule.masks
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        idx, masks = _batch_schedule(gen, recipe.iters, n, bs), None
    streams = qdrop.SiteStreams(seed, dev)

    err0 = recon_error(block, recipe, wstates, c_a, x_q, y_fp, plans)
    losses = torch.zeros((recipe.iters,), dtype=torch.float32, device=dev)
    mses = torch.zeros((recipe.iters,), dtype=torch.float32, device=dev)
    sw = Stopwatch()
    with TELEMETRY.span("recon.chunk", block=block.name, start=0,
                        steps=recipe.iters) as sp, \
            profiler.annotate("recon.chunk", 0):
        for it in range(recipe.iters):
            if idx is None:
                xb, yb, wb = x_q, y_fp, sample_weight
            else:
                ix = idx[it]
                xb, yb = x_q.index_select(0, ix), y_fp.index_select(0, ix)
                wb = (None if sample_weight is None
                      else sample_weight.index_select(0, ix))
            key = streams if masks is None else masks[it].__getitem__
            wstates, c_a, wopt, aopt, loss, mse = step(
                block.params, wstates, c_a, wopt, aopt, xb, yb, wb, it, key)
            losses[it] = loss
            mses[it] = mse
        sp.block_on(mses)
    curves = torch.stack([losses, mses]).cpu().numpy()  # the block's one sync
    loop_s = sw.elapsed_s()
    err1 = (recon_error(block, recipe, wstates, c_a, x_q, y_fp, plans)
            if recipe.iters else err0)
    a_out = dict(astates_all)
    a_out.update(c_a)
    return wstates, a_out, err0, err1, loop_s, curves[0], curves[1]


def reconstruct_block(block: BlockHandle, recipe: QuantRecipe,
                      x_q: torch.Tensor, y_fp: torch.Tensor, key: Key = None,
                      astates: Optional[Dict[str, Any]] = None, *,
                      sample_weight: Optional[torch.Tensor] = None,
                      schedule: Optional[Schedule] = None,
                      ) -> Tuple[Dict[str, Any], Dict[str, Any], BlockReport]:
    """Optimize the rounding (and LSQ) states of one block; returns
    (wstates, astates, report). ``key``: a seed or a ``torch.Generator``
    (None: ``recipe.seed``). ``sample_weight``: optional (N,) per-sample
    loss weights. ``schedule``: the caller's draws (see ``Schedule``)."""
    sw = Stopwatch()
    with TELEMETRY.span("recon.block", block=block.name, iters=recipe.iters):
        plans = site_plans(block, recipe)
        with torch.no_grad():
            wstates = init_wstates(block, recipe)
        astates = astates if astates is not None else init_astates(
            block, recipe, x_q)
        wstates, astates, err0, err1, loop_s, loss_curve, mse_curve = _run(
            block, recipe, plans, wstates, astates, x_q, y_fp,
            _seed(key, recipe), sample_weight, schedule)
    return wstates, astates, BlockReport(
        block.name, err0, err1, recipe.iters, sw.elapsed_s(),
        steps_per_s=recipe.iters / max(loop_s, 1e-9),
        loss_curve=loss_curve, mse_curve=mse_curve)


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


# --------------------------------------------------------------------- driver
@torch.no_grad()
def _explode_layerwise(block: BlockHandle, recipe: QuantRecipe, x_q):
    """Per-site sub-blocks for recon='layer': one capture pass records every
    site's input; each site becomes a standalone linear problem."""
    ctx_q = QuantCtx(mode="capture", recipe=recipe)
    block.apply(block.params, x_q, ctx_q)
    subs = []
    for name, site in block.sites.items():
        if site.kind != "linear":
            raise ValueError(f"site {name!r}: layer-wise reconstruction of "
                             f"{site.kind!r} sites is not ported")
        x_site = ctx_q.records[name][0]
        w = pth.get_path(block.params, site.path)

        def apply_fn(p, x, ctx, _n=name, _bd=site.batch_dims):
            return ctx.linear(_n, x, p["w"], batch_dims=_bd)

        sub = BlockHandle(name=f"{block.name}/{name}", params={"w": w},
                          apply=apply_fn,
                          sites={name: Site(path=("w",), kind=site.kind,
                                            batch_dims=site.batch_dims)})
        subs.append((name, sub, x_site))
    return subs


def quantize_blocks(blocks: List[BlockHandle], recipe: QuantRecipe,
                    x0: torch.Tensor, key: Key = None, as_qtensor: bool = True,
                    checkpoint_dir: Optional[str] = None,
                    progress: Optional[Callable[[str], None]] = None, *,
                    allocation: Optional[dict] = None,
                    sample_weight: Optional[torch.Tensor] = None,
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
    mismatch")."""
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
                    astates=dict(astates), sample_weight=sample_weight)
                astates.update(a_sub)
                wstates[name] = ws[name]
                reports.append(rep)
        else:
            wstates, astates, rep = reconstruct_block(
                block, recipe, x_q, y_fp, bseed, astates=astates,
                sample_weight=sample_weight)
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
