"""The training step and the cell programs (port of
``repro/launch/steps.py``).

A step is the fp forward (``model.loss`` under ``QuantCtx(mode="fp")``),
its gradient from ``torch.autograd`` and the functional ``adam_update``
(weight decay, global-norm clipping). The state is ``{"params", "opt",
"step"}`` with the Adam state of ``optim.adam_init`` and a Python int step,
so it round-trips through ``checkpoint.CheckpointManager``. The step
builds a new state and leaves the old one as it was (the reference jits it
with the state donated).

A cell program (``CellProgram``, from ``build_cell``) bundles one (arch x
shape x weights) cell: its step function, its arguments as ``specs``
stand-ins (meta tensors), the spec trees of ``launch.sharding`` for the
arguments and the results (the reference's ``NamedSharding.spec`` as
tuples), and the arguments the reference donates. Weight modes for
serving:

  bf16   full-precision serving (the roofline's baseline)
  int8   FlexRound-quantized weight-only (the paper's LLM recipe)
  int4   packed-int4 weight-only

The serve steps run under ``QuantCtx(mode="deploy")``: on the card every
QTensor linear goes through the CUDA kernels (``kernels/ops``); the step
builders' ``backend="torch"`` runs their plain versions.

A program built on an ``AbstractMesh`` takes plain tensors: on a world of
one (``AbstractMesh((1, 1), ("data", "model"))``) every placement is a
whole tensor, and the caller draws real arguments of the stand-ins' shapes
(``specs.materialize``). A program built on a ``DeviceMesh`` takes its
arguments as DTensors on their placements (``sharding.distribute``) and
runs as a DTensor program on every rank (``_on_mesh``): the models' hints
keep it local where GSPMD keeps the reference's, the QTensor matmuls run
the kernels on local shards, and each gradient comes to its parameter's
placements before the Adam update (``_to_param_placements``). The dry run
(``launch.dryrun``) traces such programs on a fake process group. The
training launcher still trains a replicated step (ROADMAP item 14.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.context import QuantCtx
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.core.dist import ambient_mesh, is_dtensor
from repro_torch.models.common import shard_hint
from repro_torch.models.model import build_model
from repro_torch.optim.adam import (AdamConfig, adam_init, adam_update,
                                    tree_leaves, tree_unflatten)

TRAIN_OPT = {
    "fsdp": AdamConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0,
                       moment_dtype="bfloat16"),
    "tp": AdamConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0),
    "dp": AdamConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0),
}


@dataclasses.dataclass
class CellProgram:
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...] = ()


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


def _to_param_placements(grads: List[torch.Tensor],
                         leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient on its parameter's placements: a DTensor gradient
    arrives ``Partial`` over the axes its batch was split on, and the
    redistribution is the data-parallel all-reduce (a replicated parameter)
    or the FSDP reduce-scatter (a sharded one), where GSPMD inserts them for
    the reference's ``out_shardings``. A plain tensor passes unchanged."""
    from torch.distributed.tensor import DTensor
    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(g, DTensor) and isinstance(p, DTensor) else g
            for g, p in zip(grads, leaves)]


def _update(grads, opt, params, opt_cfg: AdamConfig):
    """``adam_update``; on DTensor leaves, on each rank's local shards (the
    update is elementwise, and DTensor's placement search over each
    ``_foreach`` op's leaf list takes minutes to trace on a three-axis
    mesh), with the global norm of ``_sharded_norm``."""
    leaves = tree_leaves(params)
    if not leaves or not is_dtensor(leaves[0]):
        return adam_update(grads, opt, params, opt_cfg)
    gnorm = _sharded_norm(tree_leaves(grads))
    new_p, new_opt, _ = adam_update(_locals(grads), _locals(opt),
                                    _locals(params), opt_cfg, gnorm=gnorm)
    return (_like(params, new_p), {"mu": _like(opt["mu"], new_opt["mu"]),
                                   "count": new_opt["count"]}, gnorm)


def _locals(tree):
    """``tree`` with every DTensor leaf replaced by its local shard."""
    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_locals(v) for v in tree)
    return tree.to_local() if is_dtensor(tree) else tree


def _like(dtree, ltree):
    """The local shards of ``ltree`` as DTensors placed as the leaves of
    ``dtree`` at the same paths."""
    from torch.distributed.tensor import DTensor
    if isinstance(dtree, dict):
        return {k: _like(dtree[k], ltree[k]) for k in dtree}
    if isinstance(dtree, (list, tuple)):
        return type(dtree)(_like(d, t) for d, t in zip(dtree, ltree))
    if is_dtensor(dtree):
        return DTensor.from_local(ltree, dtree.device_mesh, dtree.placements,
                                  run_check=False, shape=dtree.shape,
                                  stride=dtree.stride())
    return ltree


def _sharded_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The global norm of DTensor gradients on their parameters'
    placements: each rank sums the squares of its shards, one partial sum
    per distinct placement, reduced over the axes that shard it (one
    all-reduce each); the norm is the same on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = grads[0].device_mesh
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for g in grads:
        groups.setdefault(tuple(g.placements), []).append(
            torch.sum(torch.square(g.to_local().float())))
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for pl, sq in groups.items():
        part = torch.sum(torch.stack(sq))
        if any(p.is_shard() for p in pl):
            part = DTensor.from_local(
                part, mesh, [Partial() if p.is_shard() else Replicate()
                             for p in pl], run_check=False).redistribute(
                mesh, [Replicate()] * mesh.ndim).to_local()
        total = total + part
    return torch.sqrt(total)


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
        grads = _to_param_placements(grads, tree_leaves(params))
        with torch.no_grad():
            new_params, new_opt, gnorm = _update(
                tree_unflatten(params, grads), state["opt"], params, opt_cfg)
        out = {"params": new_params, "opt": new_opt,
               "step": state["step"] + 1}
        return out, {"loss": loss, "gnorm": gnorm, **metrics}

    return train_step


def train_cell(cfg, shape: ShapeSpec, mesh, mode: Optional[str] = None,
               microbatch: int = 1) -> CellProgram:
    """A training step of ``shape`` (kind train). The state's ``step`` and
    the Adam ``count`` are Python ints, as ``make_train_step`` keeps them."""
    model = build_model(cfg)
    mode = mode or shd.ARCH_MODE.get(cfg.name, "tp")
    opt_cfg = TRAIN_OPT[mode]
    pshapes = sp.param_shapes(model, cfg)
    state_shapes = {"params": pshapes, "opt": adam_init(pshapes, opt_cfg),
                    "step": 0}
    bshapes = sp.batch_shapes(cfg, shape)
    pspec = shd.param_spec_tree(pshapes, cfg, mesh, mode)
    # moments mirror params: same shapes => same specs
    state_spec = {"params": pspec, "opt": shd.opt_spec_tree(None, pspec),
                  "step": shd.P()}
    bspec = shd.batch_spec_tree(bshapes, cfg, mesh)
    return CellProgram(
        name=f"{cfg.name}:{shape.name}" + (
            f":mb{microbatch}" if microbatch > 1 else ""),
        fn=make_train_step(model, cfg, opt_cfg, microbatch=microbatch),
        args=(state_shapes, bshapes),
        in_shardings=(state_spec, bspec),
        out_shardings=(state_spec, None),
        donate_argnums=(0,),
    )


# ------------------------------------------------------------------ serve
def make_prefill_step(model, cfg, backend: str = "auto",
                      logits: bool = False) -> Callable:
    """``prefill_step(params, tokens, cache, extra=None) -> (next token
    (B, 1) int32, cache)``: the prompt through the deploy forward, the
    cache filled in place; ``extra`` is whisper's frames or phi-3's patch
    embeddings. ``backend="torch"`` runs the kernels' plain versions;
    ``logits=True`` also returns the (B, 1, V) logits."""

    def prefill_step(params, tokens, cache, extra=None):
        ctx = QuantCtx(mode="deploy", backend=backend)
        with torch.no_grad():
            if cfg.family == "encdec":
                h, cache = model.prefill(params, tokens, extra, cache, ctx)
            elif cfg.family == "vlm":
                h, cache = model.prefill(params, tokens, cache, ctx,
                                         extra_embeds=extra)
            else:
                h, cache = model.prefill(params, tokens, cache, ctx)
            # the vocab whole for the argmax (a hint: plain tensors pass)
            out = shard_hint(h @ _head(model, params, cfg), "dp")
        tok = torch.argmax(out, dim=-1).to(torch.int32)
        return (tok, cache, out) if logits else (tok, cache)

    return prefill_step


def _head(model, params, cfg):
    w = model.lm_head(params) if hasattr(model, "lm_head") else \
        params["lm_head"]
    return w.to(getattr(torch, cfg.dtype)) * cfg.logit_mult


def make_serve_step(model, cfg, backend: str = "auto",
                    logits: bool = False) -> Callable:
    """One decode step, ``serve_step(params, token, cache, pos) -> (next
    token (B, 1) int32, cache)``: insert ``token`` (B, 1) at ``pos`` (an
    int or a 0-d int tensor), attend against the cache (written in place),
    take the argmax; ``logits=True`` also returns the (B, 1, V) logits."""
    del cfg

    def serve_step(params, token, cache, pos):
        ctx = QuantCtx(mode="deploy", backend=backend)
        with torch.no_grad():
            out, cache = model.decode_step(params, token, cache, pos, ctx)
            out = shard_hint(out, "dp")
        tok = torch.argmax(out[:, -1:], dim=-1).to(torch.int32)
        return (tok, cache, out) if logits else (tok, cache)

    return serve_step


def serve_cell(cfg, shape: ShapeSpec, mesh, weights: str = "int8",
               mode: Optional[str] = None, kv: str = "bf16",
               backend: str = "auto") -> CellProgram:
    model = build_model(cfg)
    mode = mode or shd.serve_mode(cfg.name)
    pshapes = sp.param_shapes(model, cfg)
    if weights in ("int8", "int4"):
        pshapes = sp.quantize_param_shapes(pshapes, cfg,
                                           bits=8 if weights == "int8" else 4)
    cshapes = sp.cache_shapes(model, cfg, shape, kv=kv)
    pspec = shd.param_spec_tree(pshapes, cfg, mesh, mode)
    cspec = shd.cache_spec_tree(cshapes, cfg, mesh)
    B = shape.global_batch
    dp = shd.dp_axes(mesh)
    b_ax = dp if B % shd.axis_size(mesh, dp) == 0 else (
        ("data",) if B % shd.axis_size(mesh, "data") == 0 else None)
    tok_spec = shd.P(b_ax, None)
    name = f"{cfg.name}:{shape.name}:{weights}"

    if shape.kind == "decode":
        return CellProgram(
            name=name,
            fn=make_serve_step(model, cfg, backend=backend),
            args=(pshapes, sp.sds((B, 1), torch.int32), cshapes,
                  sp.sds((), torch.int32)),
            in_shardings=(pspec, tok_spec, cspec, shd.P()),
            out_shardings=(tok_spec, cspec),
            donate_argnums=(2,),
        )

    bshapes = sp.batch_shapes(cfg, shape)
    extra = {"encdec": "frames", "vlm": "patch_embeds"}.get(cfg.family)
    args = (pshapes, bshapes["tokens"], cshapes)
    in_sh = (pspec, tok_spec, cspec)
    if extra is not None:
        args += (bshapes[extra],)
        in_sh += (shd.P(b_ax, None, None),)
    return CellProgram(
        name=name,
        fn=make_prefill_step(model, cfg, backend=backend),
        args=args,
        in_shardings=in_sh,
        out_shardings=(tok_spec, cspec),
        donate_argnums=(2,),
    )


def _on_mesh(fn: Callable, mesh) -> Callable:
    """``fn`` run with ``mesh`` ambient (the models' ``shard_hint``s) and
    plain tensors built inside the program taken as replicated
    (``implicit_replication``): the program's DTensor arguments carry the
    placements, every constant it makes is the same on every rank. The
    data axes, and all axes, get a flattened mesh now (outside any fake
    mode; where none has size 1), which DTensor then uses to reduce a sum
    that is partial over several of them in one collective, as GSPMD does,
    not one per axis."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for axes in {shd.dp_axes(mesh), tuple(sizes)}:
        if len(axes) > 1 and all(sizes[a] > 1 for a in axes):
            mesh[axes]._flatten()

    def on_mesh(*args):
        from torch.distributed.tensor.experimental import implicit_replication
        with ambient_mesh(mesh), implicit_replication():
            return fn(*args)

    return on_mesh


def build_cell(cfg, shape: ShapeSpec, mesh, weights: str = "int8",
               mode: Optional[str] = None, microbatch: int = 1,
               kv: str = "bf16", backend: str = "auto") -> CellProgram:
    """The cell program of (``cfg`` x ``shape``) on ``mesh``; ``weights``,
    ``kv`` and the kernel ``backend`` apply to serve cells only. On a
    ``DeviceMesh`` the program
    runs with the mesh ambient (``_on_mesh``) and takes the arguments as
    DTensors (``launch.sharding.distribute``); on an ``AbstractMesh`` it
    takes plain tensors."""
    if shape.kind == "train":
        prog = train_cell(cfg, shape, mesh, mode, microbatch=microbatch)
    else:
        prog = serve_cell(cfg, shape, mesh, weights, mode, kv=kv,
                          backend=backend)
    if not isinstance(mesh, AbstractMesh):
        prog.fn = _on_mesh(prog.fn, mesh)
    return prog
