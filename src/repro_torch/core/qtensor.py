"""QTensor: the serialized form of a quantized weight (port of
``repro/core/qtensor.py``, same fields and byte layout).

  - bits >= 5 .... uint8 codes, one per element
  - bits <= 4 .... two 4-bit codes per byte along ``pack_axis`` (the
                   contraction axis K, axis 0 of ``(d_in, d_out)``): the low
                   nibble holds the even index, the high nibble the odd one
Codes are stored zero-based for asymmetric quantizers (q in [0, 2^b-1]) and
shifted by ``-qmin`` for symmetric ones (still unsigned); ``zero`` carries
the same shift, so ``scale * (codes - zero)`` dequantizes either kind.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.core.quant_config import QuantConfig


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the reference stores names)."""
    return dtype if isinstance(dtype, str) else str(dtype).replace("torch.", "")


@dataclasses.dataclass
class QTensor:
    codes: torch.Tensor  # uint8 storage (possibly nibble-packed)
    scale: torch.Tensor  # float32, broadcastable to logical shape
    zero: torch.Tensor   # float32, broadcastable to logical shape
    shape: Tuple[int, ...]
    bits: int
    packed: bool
    dtype: str = "bfloat16"
    pack_axis: int = 0

    def nbytes_codes(self) -> int:
        return int(self.codes.numel())

    def unpacked_codes(self) -> torch.Tensor:
        """uint8 codes at the logical shape (nibbles expanded if packed)."""
        if not self.packed:
            return self.codes
        return _unpack_nibbles(self.codes, axis=self.pack_axis)


def _pack_nibbles(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """q: uint8 codes in [0, 15]; pack adjacent pairs along ``axis``."""
    if q.shape[axis] % 2 != 0:
        raise ValueError(f"int4 packing needs even dim on axis {axis}, "
                         f"got {tuple(q.shape)}")
    idx = [slice(None)] * q.dim()
    idx[axis] = slice(0, None, 2)
    lo = q[tuple(idx)]
    idx[axis] = slice(1, None, 2)
    hi = q[tuple(idx)]
    return (lo | (hi << 4)).to(torch.uint8)


def _unpack_nibbles(p: torch.Tensor, axis: int = 0) -> torch.Tensor:
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    out = torch.stack([lo, hi], dim=axis + 1)  # (..., n/2, 2, ...)
    shape = p.shape[:axis] + (p.shape[axis] * 2,) + p.shape[axis + 1:]
    return out.reshape(shape)


# elements of the float codes ``from_codes`` rounds at a time
_SLAB_ELEMS = 2**28


def from_codes(q_float: torch.Tensor, scale, zero, qcfg: QuantConfig,
               dtype=torch.bfloat16) -> QTensor:
    """Build a QTensor from float codes in [qmin, qmax] (observer output).
    <=4-bit codes nibble-pack along the first non-batch axis when it is
    even; odd K stays one code per byte."""
    offset = 0 if not qcfg.symmetric else -qcfg.qmin
    # rounded a slab of the first axis at a time: a float32 copy of a whole
    # 256-expert stack (15 GB) is never made
    qu = torch.empty(q_float.shape, dtype=torch.uint8, device=q_float.device)
    step = max(1, _SLAB_ELEMS // max(1, q_float[0].numel()))
    with torch.no_grad():
        for i in range(0, q_float.shape[0], step):
            qu[i:i + step] = torch.round(q_float[i:i + step]).add_(offset)
    pack_axis = min(qcfg.batch_dims, q_float.dim() - 1)
    packed = qcfg.bits <= 4 and q_float.shape[pack_axis] % 2 == 0
    codes = _pack_nibbles(qu, axis=pack_axis) if packed else qu
    return QTensor(
        codes=codes,
        scale=torch.as_tensor(scale, dtype=torch.float32),
        zero=torch.as_tensor(zero + offset, dtype=torch.float32),
        shape=tuple(q_float.shape),
        bits=qcfg.bits,
        packed=packed,
        dtype=dtype_name(dtype),
        pack_axis=pack_axis,
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_weight_bytes(tree) -> int:
    """Effective serving bytes of a param tree: packed integer codes plus the
    affine grid for QTensor leaves, raw bytes for every other tensor."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, QTensor):
            total += (leaf.nbytes_codes()
                      + leaf.scale.numel() * leaf.scale.element_size()
                      + leaf.zero.numel() * leaf.zero.element_size())
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def dequantize_qtensor(qt: QTensor) -> torch.Tensor:
    q = qt.unpacked_codes()
    w = qt.scale * (q.float() - qt.zero)
    return w.to(getattr(torch, qt.dtype))
