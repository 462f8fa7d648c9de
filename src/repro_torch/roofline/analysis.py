"""Roofline terms of a cell on the card (port of
``repro/roofline/analysis.py``).

Terms (per device):

  compute_s    = analytic flops per device / the card's bf16 peak
  memory_s     = analytic HBM bytes per device / the card's memory rate
  collective_s = collective bytes per device / one link's rate

``step_time_bound_s`` is the largest, ``bottleneck`` its name. The flops
and bytes come from ``roofline.analytic``. ``analyze`` gives the first two
terms (the world-of-one cells of ``chip_smoke.py``); ``analyze_traced``
adds the collective term from the bytes of a traced DTensor program
(``roofline.collectives``, the dry run's graph), where the reference reads
the compiled HLO. The HLO's raw flop and byte counts have no counterpart:
a ``make_fx`` graph carries no cost analysis.

Peaks are the card's published ones, one row per
``torch.cuda.get_device_name()``; a card with no row raises, naming it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.shapes import ShapeSpec


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    name: str
    ops: Dict[str, float]      # dense ops/s by input type
    hbm_bytes_per_s: float
    hbm_bytes: float
    link_bytes_per_s: float    # one device's share of the mesh's links


# NVIDIA's H100 SXM data sheet, dense (no sparsity). The link: the DGX
# H100 gives each GPU one ConnectX-7 port of 400 Gb/s NDR InfiniBand; a
# 16 x 16 mesh of 8-card nodes crosses that link on both axes, so it is
# the reference's "one link's worth per chip" on this card
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": CardPeaks(
        name="NVIDIA H100 80GB HBM3",
        ops={"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12},
        hbm_bytes_per_s=3.35e12, hbm_bytes=80e9,
        link_bytes_per_s=400e9 / 8),
}


class UnknownCardError(KeyError):
    """A card with no row in ``CARD_PEAKS``: no default row stands in."""


def peaks(device_name: Optional[str] = None) -> CardPeaks:
    """The row of ``device_name`` (default: ``torch.cuda.get_device_name()``
    of the current card)."""
    name = device_name if device_name is not None else \
        torch.cuda.get_device_name()
    try:
        return CARD_PEAKS[name]
    except KeyError:
        raise UnknownCardError(
            f"no published peaks for the card {name!r}; add its row to "
            f"roofline.analysis.CARD_PEAKS (known: {sorted(CARD_PEAKS)})"
        ) from None


# Bytes per element by torch dtype name; sub-byte packed dtypes take
# fractional entries (two int4 codes per byte)
_DTYPE_BYTES: Dict[str, float] = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2, "int32": 4,
    "uint32": 4, "int64": 8, "uint64": 8, "float16": 2, "bfloat16": 2,
    "float32": 4, "float64": 8, "complex64": 8, "complex128": 16,
    "int4": 0.5, "uint4": 0.5, "float8_e4m3fn": 1, "float8_e5m2": 1,
}


class UnknownDtypeError(ValueError):
    """A dtype with no byte-width entry reached the HBM accounting.
    Defaulting (to 4, say) would mis-size sub-byte packed buffers by 8x:
    add the dtype to ``_DTYPE_BYTES`` instead."""


def dtype_bytes(dtype: Union[str, torch.dtype]) -> float:
    """Bytes per element of a torch dtype or its name (``torch.int8`` or
    ``"int8"``); fractional for sub-byte packed dtypes."""
    key = str(dtype).replace("torch.", "")
    try:
        return _DTYPE_BYTES[key]
    except KeyError:
        raise UnknownDtypeError(
            f"no byte-width entry for dtype {dtype!r}: register it in "
            "roofline.analysis._DTYPE_BYTES (sub-byte packed dtypes take "
            "fractional entries; do not default to 4)") from None


def model_flops(cfg, shape: ShapeSpec, n_devices: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed globally.
    Decode processes global_batch tokens; train/prefill seq*batch. Train
    includes backward (the 6x already covers fwd+bwd); prefill/decode are
    forward-only => 2*N*D."""
    total, active = cfg.param_count()
    n = active if cfg.is_moe else total
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def analyze(cfg, shape: ShapeSpec, n_dev: int, weights: str = "bf16",
            mode: Optional[str] = None, kv: str = "bf16",
            card: Optional[CardPeaks] = None) -> dict:
    """The analytic roofline terms of one cell on ``n_dev`` devices of
    ``card`` (default: the current card's row)."""
    from repro_torch.launch.sharding import ARCH_MODE, serve_mode
    from repro_torch.roofline import analytic

    card = card or peaks()
    if mode is None:
        mode = (ARCH_MODE.get(cfg.name, "tp") if shape.kind == "train"
                else serve_mode(cfg.name))
    # int8 KV is implemented for dense/moe/vlm GQA caches only: the archs
    # that hold bf16 caches (mla/ssm/hybrid/encdec) are not flattered
    if kv == "int8" and not (cfg.family in ("dense", "moe", "vlm")
                             and not cfg.use_mla):
        kv = "bf16"
    flops_dev = analytic.flops_cell_total(cfg, shape) / n_dev
    bytes_dev = analytic.hbm_bytes_cell(cfg, shape, weights, mode=mode,
                                        n_dev=n_dev, kv=kv) / n_dev
    peak = card.ops["bfloat16"]
    terms = {"compute": flops_dev / peak,
             "memory": bytes_dev / card.hbm_bytes_per_s}
    bottleneck = max(terms, key=terms.get)
    bound = terms[bottleneck]
    mf = analytic.model_flops_ideal(cfg, shape)
    mf_dev = mf / n_dev
    return {
        "card": card.name,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "compute_s": terms["compute"],
        "memory_s": terms["memory"],
        "bottleneck": bottleneck,
        "model_flops_global": mf,
        "model_flops_per_device": mf_dev,
        "useful_flops_ratio": (mf_dev / flops_dev) if flops_dev else 0.0,
        "step_time_bound_s": bound,
        "roofline_fraction": (mf_dev / peak) / bound if bound > 0 else 0.0,
    }


def analyze_traced(graph_or_bytes, cfg, shape: ShapeSpec, mesh,
                   weights: str = "bf16", mode: Optional[str] = None,
                   kv: str = "bf16", card: Optional[CardPeaks] = None) -> dict:
    """``analyze``'s terms for ``mesh`` (a ``DeviceMesh`` or an
    ``AbstractMesh``) plus the collective term: ``graph_or_bytes`` is the
    traced rank-0 graph or its ``collectives.collective_bytes``. Adds
    ``collective_bytes_per_device``, ``collective_breakdown`` and
    ``collective_s``; the bound, bottleneck and roofline fraction then
    take all three terms."""
    import math

    from repro_torch.roofline.collectives import collective_bytes

    card = card or peaks()
    coll = (dict(graph_or_bytes) if isinstance(graph_or_bytes, dict)
            else collective_bytes(graph_or_bytes))
    out = analyze(cfg, shape, math.prod(mesh.shape), weights, mode, kv, card)
    coll_dev = float(sum(coll.values()))
    terms = {"compute": out["compute_s"], "memory": out["memory_s"],
             "collective": coll_dev / card.link_bytes_per_s}
    bottleneck = max(terms, key=terms.get)
    bound = terms[bottleneck]
    peak = card.ops["bfloat16"]
    out.update(
        collective_bytes_per_device=coll_dev, collective_breakdown=coll,
        collective_s=terms["collective"], bottleneck=bottleneck,
        step_time_bound_s=bound,
        roofline_fraction=((out["model_flops_per_device"] / peak) / bound
                           if bound > 0 else 0.0))
    return out
