"""Collective bytes of a traced program (the counterpart of the reference's
``roofline/hlo_parse.py`` and ``analysis.py:collective_bytes``).

The dry run (``launch.dryrun``) traces a cell program on DTensor arguments
with ``make_fx``: the graph is rank 0's, and every collective DTensor
issues is a node of it. This module reads those nodes: the functional
collectives of the ``_c10d_functional`` namespace and the in-place ``c10d``
ops that ``analysis/trace.py:_collectives`` finds. Kinds are the
reference's:

  all-gather          all_gather_into_tensor(_coalesced), c10d allgather_,
                      _allgather_base_
  all-reduce          all_reduce(_), all_reduce_coalesced(_), c10d allreduce_
  reduce-scatter      reduce_scatter_tensor(_coalesced), c10d
                      reduce_scatter_, _reduce_scatter_base_
  all-to-all          all_to_all_single, c10d alltoall_(base_), DTensor's
                      _dtensor::shard_dim_alltoall (a CUDA mesh's
                      Shard(i) -> Shard(j))
  collective-permute  c10d send/recv

Bytes are the result's, once per op, per device (``wait_tensor`` is not
counted): the reference's convention, which reads the result shape of each
HLO collective and skips the ``-done`` half of an async pair. There is no
trip-count correction: ``make_fx`` unrolls the Python layer loops, so a
layer's collectives appear once per layer in the graph, where the
reference multiplies the body of a ``lax.scan`` by its trip count.
"""
from __future__ import annotations

from typing import Dict

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")


def kind_of(node) -> str:
    """The reference's kind of a graph node, or "" for any other node
    (``wait_tensor`` included)."""
    t = getattr(node, "target", None)
    if node.op != "call_function" or getattr(t, "namespace", None) \
            not in _NAMESPACES:
        return ""
    return _KIND_OF.get(t._schema.name.split("::")[-1], "")


def _bytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return int(val.numel()) * val.element_size()
    if isinstance(val, (list, tuple)):
        # an in-place c10d op returns (tensors, work): its tensors
        return sum(_bytes(v) for v in val)
    return 0


def collective_bytes(gm) -> Dict[str, int]:
    """Per-kind byte totals of ``gm``'s collectives (result bytes, per
    device), every kind present."""
    out = {k: 0 for k in KINDS}
    for n in gm.graph.nodes:
        kind = kind_of(n)
        if kind:
            out[kind] += _bytes(n.meta.get("val"))
    return out


def collective_counts(gm) -> Dict[str, int]:
    """Per-kind op counts of ``gm``'s collectives (kinds that occur)."""
    out: Dict[str, int] = {}
    for n in gm.graph.nodes:
        kind = kind_of(n)
        if kind:
            out[kind] = out.get(kind, 0) + 1
    return out


def counts_by_kind(comm_counts) -> Dict[str, int]:
    """``CommDebugMode.get_comm_counts()`` (keyed by op overload packets)
    by the reference's kinds: the eager run's side of a traced count."""
    out: Dict[str, int] = {}
    for op, n in comm_counts.items():
        name = str(op).split(".")[-1]
        kind = _KIND_OF.get(name, "")
        if kind and n:
            out[kind] = out.get(kind, 0) + int(n)
    return out
