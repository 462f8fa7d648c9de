"""Gradient compression for a data-parallel all-reduce (port of
``repro/optim/compress.py``).

int8 block-quantized all-reduce with error feedback:
  1. g_eff = g + residual
  2. q = int8_blockquant(g_eff); residual' = g_eff - dequant(q)
  3. all-reduce dequant(q) (a mean over the group)

Error feedback keeps the compression unbiased over time (Seide et al. '14).
The blocks are ``optim.adam``'s int8 moments' (128 elements, absmax scale).

The reference wraps ``compressed_psum`` in ``shard_map`` (``get_shard_map``,
``shard_mapped_psum``) so that each device runs it on its shard with the
axis name bound. With one process per rank there is nothing to wrap: a rank
calling ``compressed_psum`` with the process group of a mesh dim *is* the
shard-mapped call, and ``group`` takes the place of ``axis_name``. As in the
reference, no reconstruction or training path calls it.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.optim.adam import _dq8, _q8, tree_leaves, tree_unflatten


def _is_code(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _codes(tree: Any):
    """The ``{"q", "s"}`` entries of a compressed tree, in leaf order."""
    if _is_code(tree):
        return [tree]
    if isinstance(tree, dict):
        return [c for k in sorted(tree) for c in _codes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [c for v in tree for c in _codes(v)]
    return []


def compress_tree(grads: Any) -> Any:
    """int8-encode every leaf (block absmax): ``{"q", "s"}`` per leaf."""
    return tree_unflatten(grads, [dict(zip(("q", "s"), _q8(g)))
                                  for g in tree_leaves(grads)])


def decompress_tree(comp: Any, like: Any) -> Any:
    return tree_unflatten(like, [_dq8(c["q"], c["s"], g.shape)
                                 for c, g in zip(_codes(comp),
                                                 tree_leaves(like))])


def compressed_psum(grads: Any, group=None, residual: Optional[Any] = None
                    ) -> Tuple[Any, Any]:
    """Compressed all-reduce with error feedback: returns (mean-reduced
    grads, new residual). ``group``: the process group to reduce over (None:
    the default group). Outside a process group the reduce is the identity,
    as the reference's is outside ``shard_map``."""
    import torch.distributed as dist
    leaves = tree_leaves(grads)
    res = (tree_leaves(residual) if residual is not None
           else [torch.zeros_like(g, dtype=torch.float32) for g in leaves])
    g_eff = [g.float() + r for g, r in zip(leaves, res)]
    deq = [_dq8(*_q8(g), g.shape) for g in g_eff]
    new_residual = [g - d for g, d in zip(g_eff, deq)]
    reduced = deq
    if dist.is_initialized() and deq:
        flat = torch.cat([d.reshape(-1) for d in deq])
        dist.all_reduce(flat, group=group)
        flat = flat / dist.get_world_size(group)
        reduced, at = [], 0
        for d in deq:
            reduced.append(flat[at:at + d.numel()].view(d.shape))
            at += d.numel()
    return tree_unflatten(grads, reduced), tree_unflatten(grads, new_residual)


def compression_error(g: torch.Tensor) -> float:
    """Relative L2 error of one int8 round-trip (for tests/benchmarks)."""
    q, s = _q8(g)
    d = _dq8(q, s, g.shape)
    return float(torch.linalg.vector_norm(g - d)
                 / (torch.linalg.vector_norm(g) + 1e-12))
