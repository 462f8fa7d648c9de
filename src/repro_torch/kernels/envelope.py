"""Shape envelopes: the serving contract each kernel-table layout is held
to (a copy of ``repro/kernels/envelope.py``; the port imports nothing of
``repro``).

A :class:`ShapeEnvelope` bounds what the deploy path may feed a kernel:
shape maxima (tokens per call, contraction size, output width, expert
count) and value bounds for the float operands (activation magnitude,
quantization-grid scale range). The bounds are contracts, not
observations: the reference's static checks prove properties over the
whole envelope (the int8 x int8 accumulator fits int32 for every K up to
``k_max``) and draw their shape lattice from inside it, and the port's
planners refuse what lies outside it (K3's ``qmatmul_int8.K_MAX`` is
``get_envelope("w8a8").k_max``). :func:`check_envelope` makes a call
outside its envelope loud.

Shape maxima come from the model zoo (``repro_torch.configs`` and the
reference's): the largest contraction served is deepseek-v3's d_ff = 18432
(w_down), the widest output the 256000-token vocab head, the deepest expert
stack 256. Each bound keeps ~2x headroom over those; raising one is a
deliberate act that re-runs the proofs against the new region.

:func:`assert_grid_divisible` is the explicit divisibility check a kernel
wrapper runs on its padded dims right before it builds its grid, so an edit
that drops or reorders the padding fails with the offending dim named.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

INT32_MAX = 2**31 - 1
INT16_MAX = 2**15 - 1
# smallest normal float32: below this, values are subnormal (and flush to
# zero where a device flushes them) — a scale product down here zeroes
# gradients through FlexRound's reciprocal rule
F32_TINY = 1.1754944e-38


@dataclasses.dataclass(frozen=True)
class ShapeEnvelope:
    """Verified operating region for one kernel-table layout."""
    layout: str            # kernel-table layout name
    m_max: int             # tokens per matmul call (batch * seq)
    k_max: int             # contraction size (d_in)
    n_max: int             # output width (d_out)
    e_max: int = 1         # stacked expert count (batch_dims=1 layouts)
    x_abs_max: float = 64.0    # |activation| bound entering the matmul
    scale_min: float = 1e-12   # quantization-grid scale lower bound
    scale_max: float = 256.0   # quantization-grid scale upper bound
    code_max: int = 255        # largest integer weight code (2^bits - 1)
    seq_max: int = 0           # production sequence window (serve layouts):
    # the reference's memory-budget proof (QL401) scales every
    # [*, max_len] buffer traced at smoke scale up to this length.
    # 0 = no sequence axis.

    def contains(self, m: int, k: int, n: int, e: int = 1) -> bool:
        return (1 <= m <= self.m_max and 1 <= k <= self.k_max
                and 1 <= n <= self.n_max and 1 <= e <= self.e_max)


# Zoo maxima (see the configs): K = d_ff 18432, N = vocab 256000,
# E = n_experts 256. m_max bounds prefill batch*seq per call.
_M_MAX = 65536
_K_MAX = 32768
_N_MAX = 524288

SHAPE_ENVELOPES: Dict[str, ShapeEnvelope] = {
    "w4_packed": ShapeEnvelope("w4_packed", _M_MAX, _K_MAX, _N_MAX,
                               code_max=15),
    "w4a8_packed": ShapeEnvelope("w4a8_packed", _M_MAX, _K_MAX, _N_MAX,
                                 code_max=15),
    "w8a8": ShapeEnvelope("w8a8", _M_MAX, _K_MAX, _N_MAX),
    "w8_weight_only": ShapeEnvelope("w8_weight_only", _M_MAX, _K_MAX, _N_MAX),
    "w4_odd_unpacked": ShapeEnvelope("w4_odd_unpacked", _M_MAX, _K_MAX,
                                     _N_MAX, code_max=15),
    "experts_batched": ShapeEnvelope("experts_batched", _M_MAX, _K_MAX,
                                     _N_MAX, e_max=256, code_max=15),
    # the PTQ inner loop's fused fake-quant (not a matmul: m/k/n bound the
    # weight dims, scales bound the learned s1*s2*s3 product factors)
    "flexround_apply": ShapeEnvelope("flexround_apply", _K_MAX, _K_MAX,
                                     _N_MAX, x_abs_max=256.0,
                                     scale_min=1e-6, scale_max=256.0),
    # the serve engine's int8 KV cache (serve/kv.py): m bounds queries
    # per decode call (slots), k bounds the attention contractions (cached
    # positions x head_dim — max_len dominates), n bounds d_model. The
    # scale floor is kv_quantize's absmax floor KV_EPS/KV_QMAX = 1e-6/127
    # (~7.9e-9, >> F32_TINY, so QL303 proves the stored scales never go
    # subnormal); the ceiling is x_abs_max/127 for activations inside the
    # |x| <= 64 contract.
    "serve_kv": ShapeEnvelope("serve_kv", _M_MAX, 8192, _N_MAX,
                              x_abs_max=64.0, scale_min=1e-6 / 127.0,
                              scale_max=64.0 / 127.0, code_max=127,
                              seq_max=8192),
}


def get_envelope(layout: str) -> ShapeEnvelope:
    try:
        return SHAPE_ENVELOPES[layout]
    except KeyError:
        raise KeyError(
            f"no shape envelope registered for layout {layout!r} — every "
            "kernel-table layout must declare its verified operating region "
            f"(known: {sorted(SHAPE_ENVELOPES)})") from None


def check_envelope(layout: str, m: int, k: int, n: int, e: int = 1) -> None:
    """Raise when a shape leaves the verified region for its layout."""
    env = get_envelope(layout)
    if not env.contains(m, k, n, e):
        raise ValueError(
            f"shape (m={m}, k={k}, n={n}, e={e}) leaves the verified "
            f"envelope of layout {layout!r} (m<={env.m_max}, k<={env.k_max}, "
            f"n<={env.n_max}, e<={env.e_max}) — the overflow and parity "
            "proofs do not cover it; widen the envelope and re-verify")


def assert_grid_divisible(name: str, **dims: Tuple[int, int]) -> None:
    """Explicit grid-divisibility guard for kernel wrappers.

    ``dims`` maps a dim name to ``(padded_size, block)``; every padded size
    must be an exact block multiple or the grid under-covers the array and
    the kernel silently miscomputes the ragged tail.
    """
    for dim, (size, block) in dims.items():
        if block <= 0 or size % block != 0:
            raise ValueError(
                f"{name}: padded dim {dim}={size} is not a multiple of its "
                f"block {block} — the grid would drop the ragged "
                "tail; pad to a block multiple before building the grid")
