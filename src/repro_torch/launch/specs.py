"""Shape stand-ins for every (arch x shape) cell, with no allocation (port
of ``repro/launch/specs.py``).

A stand-in is a tensor on the ``meta`` device: shape and dtype, no storage
(the reference's ``jax.ShapeDtypeStruct``). ``param_shapes`` runs the
model's own ``init`` on the CPU under ``FakeTensorMode``, so no weight is
drawn or stored (the full deepseek-v3-671b tree comes back in seconds),
and hands the leaves back on ``meta``. ``device.resolve_device`` still
refuses ``meta``: only this module makes such trees.

The trees have the port's layout: ``layers`` (deepseek's ``dense_layers``,
whisper's ``enc_layers`` and ``dec_layers``) are lists of per-layer dicts
where the reference stacks them as (L, ...) leaves, so a stacked reference
leaf is L port leaves without the leading L. Caches are the models'
``init_cache`` trees.

``quantize_param_shapes`` turns a tree into its quantized-serving form
(QTensor leaves with uint8 or nibble-packed int4 codes), as
``core.reconstruct``'s export builds it at run time. ``materialize`` draws
real tensors of a stand-in tree from a ``torch.Generator``.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.qtensor import QTensor
from repro_torch.device import DeviceLike, resolve_device

WHISPER_CROSS_LEN = 1504  # ~30s of frames, divisible by 16

_QUANT_SITE = re.compile(
    r"(wq|wk|wv|wo|w_gate|w_up|w_down|in_proj|out_proj|wq_a|wq_b|wkv_a|"
    r"wkv_b|w_x|w_a|w_i)$")
_STACK_KEYS = ("layers", "dense_layers", "enc_layers", "dec_layers")


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in: an empty tensor of ``shape`` and ``dtype`` on ``meta``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def map_with_path(fn: Callable, tree: Any, path=()) -> Any:
    """``fn(path, leaf)`` over nested dicts, lists and tuples; QTensors and
    tensors are leaves, ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _to_meta(tree: Any) -> Any:
    return map_with_path(lambda _, t: sds(t.shape, t.dtype), tree)


def _fake(build: Callable[[], Any]) -> Any:
    """``build()`` on the CPU under ``FakeTensorMode``, leaves on ``meta``."""
    with FakeTensorMode():
        tree = build()
    return _to_meta(tree)


def param_shapes(model, cfg) -> Any:
    """The model's parameter tree as stand-ins (``cfg``: the reference's
    signature; the model carries its config)."""
    del cfg
    return _fake(lambda: model.init(torch.Generator(), device="cpu"))


def quantize_param_shapes(shapes: Any, cfg, bits: int = 8) -> Any:
    """Replace quantizable weight leaves with QTensor stand-ins (per-channel
    asymmetric grid: the paper's LLM serving recipe)."""

    def rule(path, leaf):
        short = str(path[-1]) if path else ""
        is_expert = "experts" in path
        quantizable = (leaf.dim() >= 2
                       and (_QUANT_SITE.search(short) or is_expert)
                       and short not in ("embed", "lm_head", "router"))
        if not quantizable:
            return leaf
        # a stacked (L, ...) leaf of the reference's layout (no list index
        # in its path); the port's own trees hold one layer per leaf
        stacked = (isinstance(path[0], str) and path[0] in _STACK_KEYS
                   and not any(isinstance(p, int) for p in path))
        shape = list(leaf.shape)
        logical = tuple(shape[1:]) if stacked else tuple(shape)
        # nibble-pack along the first non-batch axis of the logical tensor
        # (K for linears; E-stacked experts keep per-expert addressing), the
        # layout core.qtensor.from_codes produces and the kernels consume
        batch_dims = 1 if (is_expert and len(logical) == 3) else 0
        pack_dim = (1 if stacked else 0) + batch_dims
        packed = bits <= 4 and shape[pack_dim] % 2 == 0
        cshape = list(shape)
        if packed:
            cshape[pack_dim] //= 2
        sshape = shape[:-2] + [1, shape[-1]]
        return QTensor(codes=sds(cshape, torch.uint8),
                       scale=sds(sshape, torch.float32),
                       zero=sds(sshape, torch.float32),
                       shape=logical, bits=bits, packed=packed,
                       dtype=cfg.dtype, pack_axis=batch_dims)

    return map_with_path(rule, shapes)


def batch_shapes(cfg, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    d = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        return {"tokens": sds((B, S), torch.int32),
                "labels": sds((B, S), torch.int32),
                "frames": sds((B, S, cfg.d_model), d)}
    if cfg.family == "vlm":
        S_text = S - cfg.n_patches
        return {"tokens": sds((B, S_text), torch.int32),
                "labels": sds((B, S_text), torch.int32),
                "patch_embeds": sds((B, cfg.n_patches, cfg.d_model), d)}
    return {"tokens": sds((B, S), torch.int32),
            "labels": sds((B, S), torch.int32)}


def cache_shapes(model, cfg, shape: ShapeSpec, kv: str = "bf16") -> Any:
    """The decode cache of ``shape`` as stand-ins; ``kv="int8"`` takes the
    int8 cache where the family has one (dense, moe, vlm without MLA)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return _fake(lambda: model.init_cache(B, S, WHISPER_CROSS_LEN,
                                              device="cpu"))
    quant = kv == "int8" and cfg.family in ("dense", "moe", "vlm") \
        and not cfg.use_mla
    return _fake(lambda: model.init_cache(B, S, kv_quant=quant, device="cpu"))


# ------------------------------------------------------------ real values
def _draw(gen: torch.Generator, leaf: torch.Tensor, path, dev) -> torch.Tensor:
    shape, dtype = tuple(leaf.shape), leaf.dtype
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=gen, dtype=dtype,
                             device=gen.device).to(dev)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, dtype=dtype,
                             device=gen.device).to(dev)
    if not dtype.is_floating_point:
        raise TypeError(f"{'.'.join(map(str, path))}: no rule draws {dtype}")
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    if path and str(path[-1]).endswith("scale") and len(shape) >= 2:
        t = t.abs() * 0.01 + 0.01  # an int8 cache's per-(token, head) scale
    return t.to(device=dev, dtype=dtype)


def _draw_qtensor(gen: torch.Generator, q: QTensor, dev) -> QTensor:
    """Uniform codes over the grid, zero at its middle, and a scale that
    gives the dequantized weight a standard deviation of ``K ** -0.5``."""
    levels = 2 ** q.bits
    codes = torch.randint(0, 256 if q.packed else levels, tuple(q.codes.shape),
                          generator=gen, dtype=torch.uint8, device=gen.device)
    if q.packed and levels < 16:  # both nibbles within the grid
        codes = (codes & 0x0F) % levels | ((codes >> 4) % levels) << 4
    K = q.shape[-2]
    scale = torch.full(tuple(q.scale.shape), (12.0 / K) ** 0.5 / levels,
                       dtype=torch.float32)
    zero = torch.full(tuple(q.zero.shape), float((levels - 1) // 2),
                      dtype=torch.float32)
    return QTensor(codes=codes.to(dev), scale=scale.to(dev), zero=zero.to(dev),
                   shape=q.shape, bits=q.bits, packed=q.packed, dtype=q.dtype,
                   pack_axis=q.pack_axis)


def materialize(tree: Any, gen: torch.Generator, device: DeviceLike = None,
                fill: Any = None) -> Any:
    """Real tensors for a stand-in tree, drawn from ``gen`` (on its own
    device) and placed on ``device`` (None means CUDA). QTensor leaves as
    ``_draw_qtensor``. Every other leaf is ``fill``'s tensor at the same
    path when ``fill`` (a real tree of the same structure, such as the
    model's ``init``) is given; else float leaves are N(0, 1) (an int8
    cache's ``*_scale`` leaves in [0.01, 0.03)) and uint8/int8 leaves
    uniform over their range (int8 without -128); other integer leaves
    raise. So a quantized cell's weights are the model's own ``init`` with
    drawn codes, and a cache is drawn as a long prefill would leave it."""
    dev = resolve_device(device)

    def one(path, leaf):
        if isinstance(leaf, QTensor):
            return _draw_qtensor(gen, leaf, dev)
        if fill is not None:
            t = fill
            for p in path:
                t = t[p]
            if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
                raise ValueError(f"{'.'.join(map(str, path))}: fill has "
                                 f"{t.dtype} {tuple(t.shape)}, the tree "
                                 f"{leaf.dtype} {tuple(leaf.shape)}")
            return t.to(dev)
        return _draw(gen, leaf, path, dev)

    return map_with_path(one, tree)
