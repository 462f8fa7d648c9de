"""The bench LM: a small pretrained LM, its perplexity and the PTQ driver
(the counterpart of ``benchmarks/common.py``, its substrate half: lines
1-90, ``BENCH_CFG`` to ``ptq``).

The paper's metrics need a model whose task loss responds to quantization:
a small transformer is pretrained on the synthetic Markov corpus
(``data.SyntheticTokens``) until it clearly beats the unigram floor, the
checkpoint is cached, and perplexity deltas are measured under each PTQ
method: the scaled-down analogue of the paper's WikiText tables.

The port's token streams are its own draws of the reference's closed form
(``data/pipeline.py``), so its trained LM is not the reference's: the two
agree exactly only on carried weights and batches (``train``,
``eval_ppl(batches=)`` and ``ptq(calib=)`` take them), and by
quality otherwise. The cache lives under ``<checkout>/build/bench_cache``
(``build/`` is not committed); the reference's own files in
``benchmarks/.bench_cache`` are never read or written.

    from repro_torch.launch import bench_lm
    model, params = bench_lm.get_trained_lm()          # on the card
    print(bench_lm.eval_ppl(model, params))
"""
from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ArchConfig
from repro_torch.core import QuantCtx, QuantRecipe, quantize_blocks
from repro_torch.data import CalibrationSet, SyntheticTokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch.optim.adam import tree_leaves, tree_unflatten

CACHE = str(Path(__file__).resolve().parents[3] / "build" / "bench_cache")

BENCH_CFG = ArchConfig(
    name="bench-lm", family="dense", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=256, norm="rmsnorm", act="swiglu",
    dtype="float32", attn_chunk=64, xent_chunk=64, remat=False)

SEQ = 64
TRAIN_STEPS = 300
BATCH = 16
OPT = AdamConfig(lr=3e-3, grad_clip=1.0)


def _device_of(params) -> torch.device:
    return next(t for t in tree_leaves(params)
                if isinstance(t, torch.Tensor)).device


def train(model, params, batches: Iterable[Dict[str, torch.Tensor]],
          log=None) -> Tuple[Dict, list]:
    """Adam (``OPT``) on the fp loss over ``batches`` from ``params`` (left
    untouched); returns (params, the loss of every step as a float).
    ``log(step, loss)`` is called at every step with the step's loss, a
    0-d tensor on the device (the loop itself reads no value back until it
    ends)."""
    dev = _device_of(params)
    opt = adam_init(params, OPT)
    losses = []
    for i, batch in enumerate(batches):
        batch = {k: v.to(dev) for k, v in batch.items()}
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), batch,
                             QuantCtx(mode="fp"))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            params, opt, _ = adam_update(tree_unflatten(params, grads), opt,
                                         params, OPT)
        losses.append(loss.detach())
        if log is not None:
            log(i, losses[-1])
    return params, torch.stack(losses).tolist() if losses else []


def get_trained_lm(steps: int = TRAIN_STEPS, device: DeviceLike = None,
                   cache_dir: Optional[str] = None, log=None
                   ) -> Tuple[object, Dict]:
    """(model, params): the bench LM pretrained ``steps`` Adam steps on
    ``SyntheticTokens(seed=0)`` from ``torch.Generator`` seed 0, on
    ``device`` (None: the card). Cached at ``<cache_dir>/bench_lm_<steps>``
    (default ``CACHE``): a later call loads it. ``log`` as in ``train``."""
    dev = resolve_device(device)
    model = build_model(BENCH_CFG)
    path = os.path.join(cache_dir or CACHE, f"bench_lm_{steps}")
    if ckpt.exists(path):
        params, _ = ckpt.load_pytree(path, device=dev)
        return model, params
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    src = SyntheticTokens(vocab=BENCH_CFG.vocab, seq_len=SEQ, seed=0)
    params, _ = train(model, params, (src.batch(i, BATCH)
                                      for i in range(steps)), log)
    ckpt.save_pytree(path, params, {"steps": steps})
    return model, params


def eval_batches(n_batches: int = 8) -> list:
    """The evaluation batches: ``SyntheticTokens(seed=99)`` at steps
    50,000 + i, ``BATCH`` sequences of ``SEQ``."""
    src = SyntheticTokens(vocab=BENCH_CFG.vocab, seq_len=SEQ, seed=99)
    return [src.batch(50_000 + i, BATCH) for i in range(n_batches)]


def eval_ppl(model, params, n_batches: int = 8,
             ctx: Optional[QuantCtx] = None, astates=None, recipe=None,
             batches: Optional[Iterable[Dict[str, torch.Tensor]]] = None
             ) -> float:
    """exp of the mean loss over ``n_batches`` evaluation batches
    (``eval_batches``, or ``batches`` when given). With ``astates`` the
    forward is the deploy mode's (QTensor weights through
    ``kernels/ops.qtensor_matmul``), else ``ctx`` (default fp)."""
    ctx = ctx or QuantCtx(mode="fp")
    if astates is not None:
        ctx = QuantCtx(mode="deploy", recipe=recipe, astates=astates)
    dev = _device_of(params)
    tot, cnt = 0.0, 0
    with torch.no_grad():
        for batch in (eval_batches(n_batches) if batches is None
                      else batches):
            batch = {k: v.to(dev) for k, v in batch.items()}
            loss, _ = model.loss(params, batch, ctx)
            tot += float(loss)
            cnt += 1
    return math.exp(tot / cnt)


def calib_tokens(n_calib: int = 64) -> torch.Tensor:
    """The calibration set: ``CalibrationSet.build`` of
    ``SyntheticTokens(seed=0)``, (n_calib, SEQ) int64 on the CPU."""
    src = SyntheticTokens(vocab=BENCH_CFG.vocab, seq_len=SEQ, seed=0)
    return CalibrationSet.build(src, n_calib).tokens


def ptq(model, params, recipe: QuantRecipe, n_calib: int = 64,
        as_qtensor: bool = False, calib: Optional[torch.Tensor] = None):
    """Full PTQ of the bench LM; returns (quantized params, astates,
    reports). ``calib``: the calibration tokens (default
    ``calib_tokens(n_calib)``)."""
    tokens = calib_tokens(n_calib) if calib is None else calib
    x0, blocks, assemble = model.quant_blocks(
        params, tokens.to(_device_of(params)))
    finalized, astates, reports = quantize_blocks(
        blocks, recipe, x0, as_qtensor=as_qtensor)
    return assemble(finalized), astates, reports
