"""The training step (port of ``make_train_step`` and ``TRAIN_OPT`` in
``repro/launch/steps.py``).

A step is the fp forward (``model.loss`` under ``QuantCtx(mode="fp")``),
its gradient from ``torch.autograd`` and the functional ``adam_update``
(weight decay, global-norm clipping). The state is ``{"params", "opt",
"step"}`` with the Adam state of ``optim.adam_init`` and a Python int step,
so it round-trips through ``checkpoint.CheckpointManager``. The step
builds a new state and leaves the old one as it was (the reference jits it
with the state donated).

The cell programs (``train_cell``, ``serve_cell``, ``build_cell``) place a
step on a mesh: they come with the dry run (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.core.context import QuantCtx
from repro_torch.optim.adam import (AdamConfig, adam_update, tree_leaves,
                                    tree_unflatten)

TRAIN_OPT = {
    "fsdp": AdamConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0,
                       moment_dtype="bfloat16"),
    "tp": AdamConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0),
    "dp": AdamConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0),
}


def _loss_and_grads(model, params, batch
                    ) -> Tuple[torch.Tensor, Dict[str, Any], List[torch.Tensor]]:
    """(loss, metrics, gradient of every leaf of ``params`` in leaf order);
    a leaf the loss does not reach gets zeros, as ``jax.grad`` gives."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = model.loss(tree_unflatten(params, leaves), batch,
                               QuantCtx(mode="fp"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(model, cfg, opt_cfg: AdamConfig,
                    microbatch: int = 1) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``; metrics are
    ``{"loss", "gnorm"}`` plus the model's own (``ce``, ...) when
    ``microbatch`` is 1. ``microbatch > 1`` splits every batch tensor along
    its first axis into that many microbatches and accumulates their
    gradients in float32, divided by ``microbatch``; the loss is the mean
    of theirs (the same math at ~1/microbatch of the activation memory).
    ``cfg`` is the reference's signature (the model carries its config)."""
    del cfg

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if microbatch == 1:
            loss, metrics, grads = _loss_and_grads(model, params, batch)
        else:
            split = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            gacc = None
            losses = []
            for i in range(microbatch):
                loss_i, _, g = _loss_and_grads(
                    model, params, {k: v[i] for k, v in split.items()})
                if gacc is None:
                    gacc = [x.float() for x in g]
                else:
                    for a, x in zip(gacc, g):
                        a.add_(x.float())
                losses.append(loss_i)
                del g
            grads = [a / microbatch for a in gacc]
            loss = torch.stack(losses).mean()
            metrics = {}
        with torch.no_grad():
            new_params, new_opt, gnorm = adam_update(
                tree_unflatten(params, grads), state["opt"], params, opt_cfg)
        out = {"params": new_params, "opt": new_opt,
               "step": state["step"] + 1}
        return out, {"loss": loss, "gnorm": gnorm, **metrics}

    return train_step
