"""Carry the JAX package's parameter trees, QTensors and activation states
into the port.

Takes numpy arrays (or anything ``np.asarray`` accepts, such as JAX arrays)
and duck-typed QTensor-like objects — anything with ``codes``, ``scale``,
``zero``, ``shape``, ``bits``, ``packed``, ``dtype`` and ``pack_axis`` — and
never imports jax or the reference package. bfloat16 arrives as ml_dtypes'
``bfloat16``; it crosses as its raw ``uint16`` bits and is viewed as
``torch.bfloat16`` on the other side, so no value is rounded on the way.
"""
from __future__ import annotations

import types
from typing import Any

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.device import DeviceLike, resolve_device

_STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers")
_QT_FIELDS = ("codes", "scale", "zero", "shape", "bits", "packed", "dtype",
              "pack_axis")


def tensor(a, device: DeviceLike = None) -> torch.Tensor:
    """One array -> torch tensor on ``device`` (bfloat16 bit-exact)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Torch tensor -> numpy on the host (bfloat16 widened to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _is_qtensor_like(obj) -> bool:
    return all(hasattr(obj, f) for f in _QT_FIELDS)


def qtensor(obj, device: DeviceLike = None) -> QTensor:
    """A QTensor-like object -> the port's QTensor (bytes unchanged)."""
    return QTensor(codes=tensor(obj.codes, device),
                   scale=tensor(obj.scale, device),
                   zero=tensor(obj.zero, device),
                   shape=tuple(int(d) for d in obj.shape), bits=int(obj.bits),
                   packed=bool(obj.packed), dtype=str(obj.dtype),
                   pack_axis=int(obj.pack_axis))


def tree(obj, device: DeviceLike = None) -> Any:
    """Nested dicts/lists of arrays and QTensor-likes -> the same structure
    of torch tensors and QTensors."""
    if _is_qtensor_like(obj):
        return qtensor(obj, device)
    if isinstance(obj, dict):
        return {k: tree(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [tree(v, device) for v in obj]
    if obj is None:
        return None
    return tensor(obj, device)


def _index(obj, i: int):
    """Layer ``i`` of a stacked (L, ...) subtree."""
    if _is_qtensor_like(obj):
        return types.SimpleNamespace(
            codes=np.asarray(obj.codes)[i], scale=np.asarray(obj.scale)[i],
            zero=np.asarray(obj.zero)[i], shape=obj.shape, bits=obj.bits,
            packed=obj.packed, dtype=obj.dtype, pack_axis=obj.pack_axis)
    if isinstance(obj, dict):
        return {k: _index(v, i) for k, v in obj.items()}
    return np.asarray(obj)[i]


def _n_stacked(obj) -> int:
    if _is_qtensor_like(obj):
        return int(np.asarray(obj.codes).shape[0])
    if isinstance(obj, dict):
        return _n_stacked(next(iter(obj.values())))
    return int(np.asarray(obj).shape[0])


def params(p: dict, device: DeviceLike = None) -> dict:
    """A reference parameter tree -> the port's: ``layers`` (and
    deepseek's ``dense_layers``, whisper's ``enc_layers`` and
    ``dec_layers``) stacked as (L, ...) leaves (the reference's scanned
    form) are unstacked into a list of per-layer dicts; a list of layers
    stays a list. Every other subtree (``mtp``, whose ``layer`` is one
    unstacked layer) crosses as it is."""
    out = {}
    for k, v in p.items():
        if k in _STACKED and isinstance(v, dict):
            v = [_index(v, i) for i in range(_n_stacked(v))]
        out[k] = tree(v, device)
    return out


def astates(states: dict, device: DeviceLike = None) -> dict:
    """``{site: {"step", "beta"}}`` activation states -> torch tensors."""
    return {site: {k: tensor(v, device) for k, v in st.items()}
            for site, st in states.items()}
