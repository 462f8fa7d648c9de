"""AdamW over trees of tensors (port of ``repro/optim/adam.py``).

A tree is a nested dict (or list) of tensors; leaves are visited in the
reference's order (dict keys sorted, as ``jax.tree`` flattens them). The
update is plain tensor arithmetic written in the reference's order of
operations, so that float32 moments round as it does:

    m = b1 m + (1 - b1) g              v = b2 v + ((1 - b2) g) g
    p = p - lr * ((m / c1) / (sqrt(v / c2) + eps) [+ wd p])
    c1 = 1 - b1^count, c2 = 1 - b2^count   (float32)

``torch.optim.Adam`` divides by ``sqrt(v) / sqrt(c2) + eps`` instead, which
rounds differently, and has neither int8 moments nor a per-leaf lr tree.
The arithmetic runs as ``torch._foreach_*`` calls over all leaves at once.

``moment_dtype``: ``float32``, ``bfloat16`` (moments stored rounded), or
``int8`` (128-element blocks with absmax scales; the second moment is
stored in the sqrt domain so small-v blocks do not snap to 0).

Two forms share the arithmetic. ``adam_update`` is functional: the step
count lives in the state as a Python int and the bias corrections are host
scalars (computed in float32), so an update never waits on the device.
``adam_update_`` writes the new parameters and moments into the given
leaves and takes the corrections as device scalars, read from
``bias_correction_tables`` by a step counter on the device: the form a
CUDA graph can capture and replay (the reconstruction engine's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

BLOCK = 128
GROUP_ELEMS = 1 << 27  # leaves per functional update pass, in elements


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    moment_dtype: str = "float32"  # float32 | bfloat16 | int8


# ------------------------------------------------------------------ trees
def tree_leaves(tree: Any, like: Any = None) -> List[Any]:
    """Leaves of ``tree`` in sorted-key order; with ``like``, the subtrees
    of ``tree`` at the leaves of ``like`` (the reference's
    ``flatten_up_to``: a moment entry ``{"m", "v"}`` per parameter)."""
    like = tree if like is None else like
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in tree_leaves(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, l in zip(tree, like) for x in tree_leaves(t, l)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """Rebuild ``like``'s structure from ``leaves``, consumed in leaf
    order (an iterator passes through the recursion unchanged)."""
    it = iter(leaves)
    if isinstance(like, dict):  # keys sorted, as jax.tree rebuilds a dict
        return {k: tree_unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(v, it) for v in like)
    return next(it)


# ----------------------------------------------------------- int8 moments
def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise absmax int8 quantization of a flattened tensor."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = int(np.prod(shape, dtype=np.int64))
    return flat[:n].reshape(shape)


def _encode(x: torch.Tensor, dtype: str, second: bool = False):
    if dtype == "int8":
        q, s = _q8(torch.sqrt(x) if second else x)
        return {"q": q, "s": s}
    return x.to(getattr(torch, dtype))


def _decode(m: Any, dtype: str, shape, second: bool = False) -> torch.Tensor:
    if dtype == "int8":
        d = _dq8(m["q"], m["s"], shape)
        return torch.square(d) if second else d
    return m.float()


# -------------------------------------------------------------------- adam
def adam_init(params: Any, cfg: AdamConfig) -> dict:
    def one(p):
        def z():  # one buffer per moment: adam_update_ writes them in place
            return torch.zeros(tuple(p.shape), dtype=torch.float32,
                               device=p.device)
        return {"m": _encode(z(), cfg.moment_dtype),
                "v": _encode(z(), cfg.moment_dtype, second=True)}

    leaves = tree_leaves(params)
    mu = tree_unflatten(params, [one(p) for p in leaves])
    return {"mu": mu, "count": 0}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = [torch.sum(torch.square(x.float())) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _bias_corrections(cfg: AdamConfig, count: int) -> Tuple[float, float]:
    f32 = np.float32
    c1 = f32(1.0) - f32(cfg.b1) ** f32(count)
    c2 = f32(1.0) - f32(cfg.b2) ** f32(count)
    return float(c1), float(c2)


def bias_correction_tables(cfg: AdamConfig, steps: int,
                           device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(steps,) float32 tables of c1 and c2 on ``device``: entry t holds
    the corrections of count t + 1, rounded as ``_bias_corrections``
    rounds them."""
    c = np.asarray([_bias_corrections(cfg, t + 1) for t in range(steps)],
                   np.float32).reshape(steps, 2)
    t = torch.as_tensor(np.ascontiguousarray(c.T), device=device)
    return t[0], t[1]


def _new_leaves(flat_g, flat_mu, flat_p, flat_s, cfg: AdamConfig, c1, c2):
    """The update of every leaf: (new params in their dtypes, new encoded
    moments). ``c1``/``c2``: numbers or 0-d float32 tensors."""
    dt = cfg.moment_dtype
    m = [_decode(mu["m"], dt, p.shape) for mu, p in zip(flat_mu, flat_p)]
    v = [_decode(mu["v"], dt, p.shape, second=True)
         for mu, p in zip(flat_mu, flat_p)]
    fe = torch
    m = fe._foreach_add(fe._foreach_mul(m, cfg.b1),
                        fe._foreach_mul(flat_g, 1 - cfg.b1))
    gg = fe._foreach_mul(fe._foreach_mul(flat_g, 1 - cfg.b2), flat_g)
    v = fe._foreach_add(fe._foreach_mul(v, cfg.b2), gg)
    den = fe._foreach_div(v, c2)
    fe._foreach_sqrt_(den)
    fe._foreach_add_(den, cfg.eps)
    upd = fe._foreach_div(fe._foreach_div(m, c1), den)
    p32 = [p.float() for p in flat_p]
    if cfg.weight_decay:
        upd = fe._foreach_add(upd, fe._foreach_mul(p32, cfg.weight_decay))
    lrs = [cfg.lr * s for s in flat_s]
    newp = fe._foreach_sub(p32, fe._foreach_mul(upd, lrs))
    newp = [q.to(p.dtype) for q, p in zip(newp, flat_p)]
    new_mu = [{"m": _encode(mm, dt), "v": _encode(vv, dt, second=True)}
              for mm, vv in zip(m, v)]
    return newp, new_mu


def _flat_args(grads, params, lr_scale):
    flat_p = tree_leaves(params)
    flat_g = [g.float() for g in tree_leaves(grads, params)]
    if isinstance(lr_scale, (int, float)):
        flat_s = [float(lr_scale)] * len(flat_p)
    else:
        flat_s = [float(s) for s in tree_leaves(lr_scale, params)]
    return flat_p, flat_g, flat_s


def _clipped(flat_g, cfg: AdamConfig, gnorm):
    if cfg.grad_clip is None:
        return flat_g
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    return [g * clip for g in flat_g]


def _groups(flat_p, max_elems: int):
    """Consecutive index ranges of the leaves, each of at most
    ``max_elems`` elements (a larger leaf alone)."""
    start, n = 0, 0
    for i, p in enumerate(flat_p):
        if i > start and n + p.numel() > max_elems:
            yield range(start, i)
            start, n = i, 0
        n += p.numel()
    if start < len(flat_p):
        yield range(start, len(flat_p))


def adam_update(grads: Any, state: dict, params: Any, cfg: AdamConfig,
                lr_scale: Any = 1.0, gnorm: Optional[torch.Tensor] = None
                ) -> Tuple[Any, dict, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm).

    ``gnorm`` is the gradients' global norm when the caller has it (the
    leaves are shards of a sharded tree: ``launch.steps``); else it is
    ``global_norm`` of ``grads``.

    ``lr_scale`` is a number applied to every leaf or a tree matching
    ``params`` whose leaves scale ``cfg.lr`` per leaf (the reconstruction
    loop's per-site lr rules). Call it under ``torch.no_grad()``. The
    leaves are updated in groups of at most ``GROUP_ELEMS`` elements, so
    the float32 temporaries of the update stay a group's, not the whole
    tree's (a leaf's arithmetic does not depend on its group)."""
    count = state["count"] + 1
    flat_p, flat_g, flat_s = _flat_args(grads, params, lr_scale)
    flat_mu = tree_leaves(state["mu"], params)
    if gnorm is None:
        gnorm = global_norm(flat_g)
    flat_g = _clipped(flat_g, cfg, gnorm)
    c1, c2 = _bias_corrections(cfg, count)
    newp, new_mu = [], []
    for g in _groups(flat_p, GROUP_ELEMS):
        p_g, mu_g = _new_leaves(
            [flat_g[i] for i in g], [flat_mu[i] for i in g],
            [flat_p[i] for i in g], [flat_s[i] for i in g], cfg, c1, c2)
        for i in g:
            flat_g[i] = None  # the clipped float32 gradient is spent
        newp += p_g
        new_mu += mu_g
    return (tree_unflatten(params, newp),
            {"mu": tree_unflatten(params, new_mu), "count": count}, gnorm)


def adam_update_(grads: Any, mu: Any, params: Any, cfg: AdamConfig,
                 c1: torch.Tensor, c2: torch.Tensor,
                 lr_scale: Any = 1.0) -> None:
    """``adam_update`` in place: writes the new parameters into the leaves
    of ``params`` and the new moments into ``mu`` (``adam_init(...)["mu"]``).
    ``c1``/``c2`` are this step's bias corrections as 0-d float32 tensors
    (``bias_correction_tables`` indexed by the step on the device), so the
    call makes no host sync and reads no host step count. Call it under
    ``torch.no_grad()``."""
    flat_p, flat_g, flat_s = _flat_args(grads, params, lr_scale)
    flat_mu = tree_leaves(mu, params)
    if cfg.grad_clip is not None:
        flat_g = _clipped(flat_g, cfg, global_norm(flat_g))
    newp, new_mu = _new_leaves(flat_g, flat_mu, flat_p, flat_s, cfg, c1, c2)
    torch._foreach_copy_(flat_p, newp)
    for dst, src in zip(flat_mu, new_mu):
        for k in ("m", "v"):
            if isinstance(dst[k], dict):  # int8 moments: codes and scales
                for f in dst[k]:
                    dst[k][f].copy_(src[k][f])
            else:
                dst[k].copy_(src[k])
