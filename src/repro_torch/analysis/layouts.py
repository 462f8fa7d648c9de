"""The kernel-table layouts and their exemplar inputs: the slice of
``repro/analysis/trace.py`` that the kernel coverage (QL207) and the
kernel differ (QL304) need (``MATMUL_LAYOUTS``, ``_export_qt``,
``_a_state_for``, ``matmul_example``); the traced-graph entries
(:mod:`repro_torch.analysis.trace`) draw their matmul exemplars from it
too.

Weights and activations are drawn from explicit ``torch.Generator``s
(seed 9 for weights, 13 for x) on an explicit device, where the reference
draws ``jax.random.key(9)`` and ``key(13)``: the layouts, shapes, bits,
batch dims and a-state presence are the reference's, the random values
are not. Weights are RTN-exported (minmax, asymmetric, per channel) with
float32 grids.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import lsq, rtn
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantConfig

W_SEED, X_SEED = 9, 13

# (name, weight shape, bits, batch_dims, with_a_state) — one row per QTensor
# layout in the kernel table. Dims are smoke-scale; the layout (pack axis,
# batch dims, a_state presence) is what selects the kernel.
MATMUL_LAYOUTS: Tuple[Tuple[str, Tuple[int, ...], int, int, bool], ...] = (
    ("w4_packed", (64, 32), 4, 0, False),
    ("w4a8_packed", (64, 32), 4, 0, True),
    ("w8a8", (48, 24), 8, 0, True),
    ("w8_weight_only", (48, 24), 8, 0, False),
    ("w4_odd_unpacked", (33, 24), 4, 0, False),
    ("experts_batched", (4, 32, 16), 4, 1, False),
)


def layout_row(layout: str) -> Tuple[Tuple[int, ...], int, int, bool]:
    """(weight shape, bits, batch_dims, with_a_state) of one layout."""
    for name, shape, bits, batch_dims, with_a in MATMUL_LAYOUTS:
        if name == layout:
            return shape, bits, batch_dims, with_a
    raise KeyError(layout)


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def export_qt(w: torch.Tensor, bits: int, granularity: str = "per_channel",
              batch_dims: int = 0) -> QTensor:
    """``w`` RTN-exported as the reference's ``_export_qt`` exports its
    weight: minmax observer, asymmetric, float32 grids."""
    qcfg = QuantConfig(bits=bits, symmetric=False, observer="minmax",
                       granularity=granularity, batch_dims=batch_dims)
    return rtn.export(w, rtn.init(w, qcfg), qcfg, dtype=torch.float32)


def _export_qt(shape, bits: int, granularity: str = "per_channel",
               batch_dims: int = 0, *, device="cpu") -> QTensor:
    """A weight of ``shape`` drawn N(0, 0.1^2) from seed 9 on ``device``,
    RTN-exported (``export_qt``)."""
    w = torch.randn(tuple(shape), generator=_gen(W_SEED, device),
                    device=device) * 0.1
    return export_qt(w, bits, granularity, batch_dims)


def _a_state_for(x: torch.Tensor):
    """The LSQ deploy grid ``(a_scale, a_zero)`` of an 8-bit per-tensor
    asymmetric quantizer initialised from x's min and max."""
    aq = QuantConfig(bits=8, symmetric=False, granularity="per_tensor",
                     observer="minmax")
    x32 = x.float()
    st = lsq.init(torch.stack([x32.min(), x32.max()]), aq)
    return lsq.deploy_astate(st, aq)


def example_x(shape, dtype: torch.dtype = torch.float32, *,
              device="cpu") -> torch.Tensor:
    """Activations of ``shape`` drawn N(0, 1) from seed 13, cast to
    ``dtype``."""
    return torch.randn(tuple(shape), generator=_gen(X_SEED, device),
                       device=device).to(dtype)


def matmul_example(layout: str, *, device="cpu",
                   dtype: torch.dtype = torch.float32,
                   m: int = 5) -> Tuple[torch.Tensor, QTensor,
                                        Optional[tuple]]:
    """(x, qt, a_state) exemplar inputs for one kernel-table layout: x has
    ``m`` rows (per expert for the batched layout)."""
    shape, bits, batch_dims, with_a = layout_row(layout)
    qt = _export_qt(shape, bits, batch_dims=batch_dims, device=device)
    if batch_dims == 1:
        E, K, _ = shape
        x = example_x((E, m, K), dtype, device=device)
    else:
        x = example_x((m, shape[0]), dtype, device=device)
    return x, qt, (_a_state_for(x) if with_a else None)
