"""Block-wise PTQ driver, export-only subset (port of
``repro/core/reconstruct.py``).

For each block B (a transformer layer):

    y_fp = B_fp(x_fp)                       teacher on the fp stream
    FlexRound init of every site            observer s1, s2 = s3 = 1
    LSQ init from ranges on the student stream x_q
    err_before = err_after = ||y_fp - B_recon(x_q)||^2 / n   (no steps taken)
    export every site to a QTensor; x_q <- B_deploy(x_q)     deploy forward

which is the reference's ``quantize_blocks`` with ``iters=0``. The Adam
reconstruction loop (``iters > 0``), QDrop, layer-wise reconstruction and
checkpoints are queued in ROADMAP and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import lsq
from repro_torch.core import paths as pth
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantRecipe, SitePlan


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


@dataclasses.dataclass
class BlockReport:
    name: str
    err_before: float
    err_after: float
    iters: int


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


def recon_error(block: BlockHandle, recipe: QuantRecipe, wstates, astates,
                x_q, y_fp) -> float:
    """Mean squared block-output error of the fake-quant (recon) forward."""
    ctx = QuantCtx(mode="recon", recipe=recipe, wstates=wstates,
                   astates=astates)
    y = block.apply(block.params, x_q, ctx)
    return float(torch.mean(torch.square(y.float() - y_fp.float())))


def finalize_block(block: BlockHandle, recipe: QuantRecipe, wstates) -> Any:
    """Replace every site's weight with its exported QTensor; each site
    exports with its own plan (mixed bit-widths in one block are fine)."""
    params = block.params
    for name, site in block.sites.items():
        plan = recipe.resolve(name, site)
        w = pth.get_path(params, site.path)
        qt = plan.method.export(w, wstates[name], plan.weight, dtype=w.dtype)
        params = pth.set_path(params, site.path, qt)
    return params


def quantize_blocks(blocks: List[BlockHandle], recipe: QuantRecipe,
                    x0: torch.Tensor,
                    progress: Optional[Callable[[str], None]] = None,
                    ) -> Tuple[List[Any], Dict[str, Any], List[BlockReport]]:
    """Sequentially quantize a chain of blocks, export-only.

    Returns (per-block finalized params, astates, reports), as the
    reference. Tensors stay on x0's device."""
    if recipe.iters > 0:
        raise NotImplementedError(
            f"iters={recipe.iters}: the Adam reconstruction loop is not "
            "ported yet (ROADMAP Queue 1, reconstruction engine); use iters=0 "
            "for export-only PTQ")
    if recipe.recon != "block":
        raise NotImplementedError("recon='layer' is not ported yet, see ROADMAP")
    x_fp = x_q = x0
    astates: Dict[str, Any] = {}
    finalized: List[Any] = []
    reports: List[BlockReport] = []
    with torch.no_grad():
        for i, block in enumerate(blocks):
            y_fp = block.apply(block.params, x_fp, QuantCtx(mode="fp"))
            astates = init_astates(block, recipe, x_q, prev=astates)
            wstates = init_wstates(block, recipe)
            err = recon_error(block, recipe, wstates, astates, x_q, y_fp)
            new_params = finalize_block(block, recipe, wstates)
            finalized.append(new_params)
            student = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
            x_q = block.apply(new_params, x_q, student)
            x_fp = y_fp
            reports.append(BlockReport(block.name, err, err, recipe.iters))
            if progress:
                progress(f"[{i + 1}/{len(blocks)}] {block.name} "
                         f"err {err:.3e} -> {err:.3e}")
    return finalized, astates, reports
