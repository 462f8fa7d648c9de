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

``placements(spec, mesh)`` turns a spec into DTensor ``Shard``/
``Replicate`` placements, one per mesh dim (``named`` maps it over a tree).
The data-parallel reconstruction reads ``stream_spec`` only; the others are
shape logic for the sharded cell programs (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import re
from typing import Any, Optional, Tuple

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
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return fn(tree)


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
    """Spec tree matching a params shape tree."""
    mode = mode or ARCH_MODE.get(cfg.name, "tp")

    def rule(path, leaf):
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
def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard``
    of the tensor dim whose entry names it, else ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for dim, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        for name in names:
            where[name] = dim
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


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
