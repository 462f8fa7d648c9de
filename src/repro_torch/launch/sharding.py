"""Per-architecture parallelism modes (the tables of
``repro/launch/sharding.py``).

  dp    params replicated, batch over data axes (small models)
  tp    tensor parallel over 'model' (2-10B)
  fsdp  tp + parameters/optimizer sharded over data axes too (>=14B)

The training launcher reads ``ARCH_MODE`` for its optimizer settings
(``launch.steps.TRAIN_OPT``).

The spec functions derive a placement for every leaf of a tree whose leaves
have ``.shape`` (tensors on the ``meta`` device, or any shape record), so no
memory is touched. A spec is the reference's ``PartitionSpec`` as a plain
tuple: one entry per dim, each ``None``, an axis name or a tuple of names
(``tuple(P(...))`` of the reference compares equal; ``P`` builds one). Every rule checks
divisibility against the mesh and degrades an axis to replication when a
dim does not divide (granite's 49155 vocab, mamba's fused projection).
Meshes are read through ``mesh_dim_names`` and ``shape`` only (a
``DeviceMesh``, or a stand-in with those two attributes).

``placements(spec, mesh)`` (from ``core.dist``) turns a spec into DTensor
``Shard``/``Replicate`` placements, one per mesh dim (``named`` maps it
over a tree), and ``distribute(mesh, tree, spec_tree)`` turns a tree into DTensors on
those placements: each rank keeps its slice of a real tensor (every rank
holds the same whole tensor, so no collective moves it), and a stand-in
(a ``meta`` leaf) becomes a DTensor over an empty local shard, which
under ``FakeTensorMode`` allocates nothing (the dry run's arguments). The
data-parallel reconstruction reads ``stream_spec`` only; the cell programs
(``launch.steps.build_cell``) take their arguments through ``distribute``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

from repro_torch.core.dist import is_dtensor, local_slices, placements
from repro_torch.core.qtensor import QTensor
from repro_torch.launch.mesh import axis_size, dp_axes

ARCH_MODE = {
    "qwen2.5-14b": "fsdp",
    "smollm-135m": "dp",
    "granite-3-2b": "tp",
    "olmo-1b": "tp",
    "recurrentgemma-2b": "tp",
    "llama4-scout-17b-a16e": "fsdp",
    "deepseek-v3-671b": "fsdp",
    "mamba2-130m": "dp",
    "whisper-medium": "tp",
    "phi-3-vision-4.2b": "tp",
}

# serving prefers TP everywhere: replicated weights multiply per-device
# weight traffic by the device count, and FSDP-sharded weights would be
# re-gathered every decode step
SERVE_MODE = {
    "smollm-135m": "tp",
    "mamba2-130m": "tp",
    "qwen2.5-14b": "tp",
    "llama4-scout-17b-a16e": "tp",
    "deepseek-v3-671b": "tp",
}


def serve_mode(name: str) -> str:
    return SERVE_MODE.get(name, ARCH_MODE.get(name, "tp"))


_ROW_PARALLEL = re.compile(r"(wo|w_down|out_proj)$")
_REPLICATED = re.compile(
    r"(router|conv_w|conv_b|a_log|dt_bias|d_skip|lam|b_a|b_i|scale|bias|"
    r"bq|bk|bv|bo|b_up|b_down)$")

Spec = Tuple[Any, ...]


def P(*entries) -> Spec:
    """A spec, canonical as the reference's ``PartitionSpec`` is: an entry
    that is a tuple of one name is that name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _path_str(path) -> str:
    return ".".join(str(p) for p in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples
    (dict keys in sorted order, as ``jax.tree`` visits them)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, QTensor):
        return _qtensor_map(lambda _, s: _map_specs(fn, s), tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return fn(tree)


def _qtensor_map(fn, q: QTensor, path=()) -> QTensor:
    """A QTensor whose ``codes``, ``scale`` and ``zero`` are ``fn(path +
    (field,), tensor)``: the reference's QTensor is a pytree over those
    three, so its spec trees hold one spec per field."""
    return dataclasses.replace(
        q, **{f: fn(path + (f,), getattr(q, f))
              for f in ("codes", "scale", "zero")})


def _div(dim: int, mesh, axes) -> bool:
    return axes is not None and dim % axis_size(mesh, axes) == 0


def _matrix_spec(shape, mesh, mode: str, name: str, lead: int) -> Spec:
    """Spec for a (lead..., d_in, d_out) weight matrix."""
    dp = dp_axes(mesh)
    row = bool(_ROW_PARALLEL.search(name))
    specs = [None] * len(shape)
    tp_dim = len(shape) - 2 if row else len(shape) - 1
    fs_dim = len(shape) - 1 if row else len(shape) - 2
    if _div(shape[tp_dim], mesh, ("model",)):
        specs[tp_dim] = "model"
    elif _div(shape[fs_dim], mesh, ("model",)):
        # fall back: shard the other dim over model
        specs[fs_dim] = "model"
        fs_dim = tp_dim
    if mode == "fsdp" and specs[fs_dim] is None and _div(shape[fs_dim], mesh,
                                                         dp):
        specs[fs_dim] = dp
    return P(*specs)


def _expert_spec(shape, mesh, mode: str) -> Spec:
    """(L, E, d_in, d_out) stacked expert weights: full EP when E divides
    data*model, else EP over model (+FSDP of d_in over the data axes)."""
    dp = dp_axes(mesh)
    specs = [None] * len(shape)
    e_dim = len(shape) - 3
    if _div(shape[e_dim], mesh, ("data", "model")):
        specs[e_dim] = ("data", "model")
        return P(*specs)
    if _div(shape[e_dim], mesh, ("model",)):
        specs[e_dim] = "model"
    if mode == "fsdp" and _div(shape[-2], mesh, dp):
        specs[-2] = dp
    return P(*specs)


def _embed_spec(shape, mesh, mode: str, transposed: bool) -> Spec:
    """embed (V, D) / lm_head (D, V): vocab-parallel when divisible."""
    dp = dp_axes(mesh)
    v_dim, d_dim = (1, 0) if transposed else (0, 1)
    specs = [None, None]
    if _div(shape[v_dim], mesh, ("model",)):
        specs[v_dim] = "model"
        if mode == "fsdp" and _div(shape[d_dim], mesh, dp):
            specs[d_dim] = dp
    elif _div(shape[d_dim], mesh, ("model",)):
        specs[d_dim] = "model"  # odd vocab (granite/mamba/whisper)
    return P(*specs)


def param_spec_tree(shapes: Any, cfg, mesh, mode: Optional[str] = None) -> Any:
    """Spec tree matching a params shape tree; a QTensor leaf gets a
    QTensor of specs, one for each of its codes, scale and zero."""
    mode = mode or ARCH_MODE.get(cfg.name, "tp")

    def rule(path, leaf):
        if isinstance(leaf, QTensor):  # a spec per field, named <site>.codes
            return _qtensor_map(rule, leaf, path)
        name = _path_str(path)
        shape = tuple(leaf.shape)
        if mode == "dp" or len(shape) <= 1:
            return P(*([None] * len(shape)))
        short = name.rsplit(".", 1)[-1]
        if _REPLICATED.search(short):
            return P(*([None] * len(shape)))
        if short == "embed":
            return _embed_spec(shape, mesh, mode, transposed=False)
        if short == "lm_head":
            return _embed_spec(shape, mesh, mode, transposed=True)
        if ".experts." in f".{name}." and len(shape) in (3, 4):
            return _expert_spec(shape, mesh, mode)  # (L,)E,d_in,d_out
        return _matrix_spec(shape, mesh, mode, short, lead=len(shape) - 2)

    return _map_with_path(rule, shapes)


def batch_spec_tree(batch_shapes: Any, cfg, mesh) -> Any:
    dp = dp_axes(mesh)

    def rule(path, leaf):
        b = leaf.shape[0]
        lead = dp if _div(b, mesh, dp) else (
            ("data",) if _div(b, mesh, ("data",)) else None)
        return P(lead, *([None] * (len(leaf.shape) - 1)))

    return _map_with_path(rule, batch_shapes)


def cache_spec_tree(cache_shapes: Any, cfg, mesh) -> Any:
    """Decode caches: batch over the data axes, the sequence over model
    (sequence-parallel decode)."""
    dp = dp_axes(mesh)

    def rule(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        specs = [None] * len(shape)
        if name.endswith("kpos"):
            return P(*specs)
        # leading L dim for stacked caches
        b_dim = 1 if (len(shape) >= 3 and shape[0] == cfg.n_layers) else 0
        if _div(shape[b_dim], mesh, dp):
            specs[b_dim] = dp
        elif _div(shape[b_dim], mesh, ("data",)):
            specs[b_dim] = "data"
        # seq axis right after batch for kv/latent caches
        s_dim = b_dim + 1
        if (len(shape) > s_dim + 1 and
                any(t in name for t in ("k", "v", "ckv", "kr"))
                and _div(shape[s_dim], mesh, ("model",))):
            specs[s_dim] = "model"
        return P(*specs)

    return _map_with_path(rule, cache_shapes)


def opt_spec_tree(opt_shapes: Any, param_specs: Any) -> Any:
    """Adam moments mirror parameter sharding; count replicated."""
    mu = _map_specs(lambda ps: {"m": ps, "v": ps}, param_specs)
    return {"mu": mu, "count": ()}


# ---------------------------------------------------- calibration streams
def stream_spec(n_lead: int, mesh) -> Spec:
    """Spec for a calibration stream (x_q / y_fp / gathered minibatches /
    per-sample loss weights): the leading sample axis over the data axes,
    replicated when the sample count does not divide them."""
    dp = dp_axes(mesh)
    return P(dp) if _div(n_lead, mesh, dp) else P()


# ------------------------------------------------------------ placements
def named(mesh, spec_tree) -> Any:
    """``placements`` over a tree of specs."""
    return _map_specs(lambda s: placements(s, mesh), spec_tree)


def stream_sharding(mesh, n_lead: int) -> tuple:
    """Placements of a leading-sample-axis calibration tensor."""
    return placements(stream_spec(n_lead, mesh), mesh)


def replicated(mesh) -> tuple:
    """Fully replicated placements (the carried rounding, Adam and LSQ
    states, minibatch schedules: what every rank must see identically)."""
    return placements((), mesh)


def distribute(mesh, tree: Any, spec_tree: Any) -> Any:
    """``tree`` as DTensors on ``mesh`` by ``spec_tree`` (QTensors field by
    field: codes, scale, zero; ints and None pass through). A real leaf
    keeps a copy of this rank's slice on the mesh's device type (a CPU
    tree goes to the card slice by slice; the caller's tensor is never
    written through it); a ``meta`` stand-in gets
    an empty local shard on the mesh's device type, which is a fake tensor
    under an active ``FakeTensorMode``."""
    import torch
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        if isinstance(t, QTensor):
            return dataclasses.replace(t, **{
                f: one(getattr(t, f), getattr(spec, f))
                for f in ("codes", "scale", "zero")})
        if isinstance(t, dict):
            return {k: one(v, spec[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not _is_spec(spec):
            return type(t)(one(v, sp) for v, sp in zip(t, spec))
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(spec, mesh)
        sl = local_slices(t.shape, mesh, pl)
        if t.is_meta:
            local = torch.empty(tuple(s.stop - s.start for s in sl),
                                dtype=t.dtype, device=mesh.device_type)
        else:
            part = t[sl]
            local = torch.empty(part.shape, dtype=t.dtype,
                                device=mesh.device_type).copy_(part)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=_contiguous(t.shape))

    return one(tree, spec_tree)


def gather(tree: Any) -> Any:
    """``tree`` with every DTensor leaf (QTensor fields too) made whole on
    every rank (``full_tensor``); other leaves as they are."""
    def one(t):
        if isinstance(t, QTensor):
            return dataclasses.replace(t, **{
                f: one(getattr(t, f)) for f in ("codes", "scale", "zero")})
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(one(v) for v in t)
        return t.full_tensor() if is_dtensor(t) else t

    return one(tree)


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


@dataclasses.dataclass(frozen=True)
class Slot:
    """Where a DTensor stood in a tree: its mesh, placements and global
    shape and stride, to rebuild it around a local shard."""
    mesh: Any
    placements: tuple
    shape: tuple
    stride: tuple

    def wrap(self, local):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=self.shape,
                                  stride=self.stride)


def to_local_tree(tree: Any, out: list) -> Any:
    """``tree`` with each DTensor (QTensor fields too) replaced by its
    ``Slot``, its local shard appended to ``out`` in order."""
    if is_dtensor(tree):
        out.append(tree.to_local())
        return Slot(tree.device_mesh, tuple(tree.placements),
                    tuple(tree.shape), tuple(tree.stride()))
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{
            f: to_local_tree(getattr(tree, f), out)
            for f in ("codes", "scale", "zero")})
    if isinstance(tree, dict):
        return {k: to_local_tree(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_local_tree(v, out) for v in tree)
    return tree


def from_local_tree(tree: Any, shards) -> Any:
    """``to_local_tree``'s inverse: each ``Slot`` a DTensor over the next
    shard of the iterator ``shards``."""
    if isinstance(tree, Slot):
        return tree.wrap(next(shards))
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{
            f: from_local_tree(getattr(tree, f), shards)
            for f in ("codes", "scale", "zero")})
    if isinstance(tree, dict):
        return {k: from_local_tree(v, shards) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_local_tree(v, shards) for v in tree)
    return tree
