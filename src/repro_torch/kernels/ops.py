"""Deploy-mode QTensor matmul dispatch (port of ``repro/kernels/ops.py``).

Backend policy (shared with ``QuantCtx``): ``backend="auto"|"kernel"|"torch"``.
``resolve_backend`` turns the request into a concrete dispatch against the
device of the tensors:

  auto     the CUDA kernels for CUDA tensors, the plain versions for CPU ones
  kernel   the CUDA kernels; raises for CPU tensors (no kernel runs there)
  torch    the plain versions (``kernels/ref.py``) on any device, on request
           only — the counterpart of the reference's ``xla`` backend

``last_kernel`` names the kernel that served the latest call, with the
names of ``analysis/diffcheck.py:EXPECTED_KERNELS`` in the reference (the
plain versions carry a ``_ref`` suffix; a weight with more than one batch
dim is dequantized, ``dequantize-fallback``). ``launch_counts`` and
``reset_launch_counts`` read and zero the per-kernel launch counters and
their forms: the regime each dequant-matmul took (``dequant_matmul_w4[decode]``,
``[mma]``, ``[fp32]``, the same for ``dequant_matmul_w8`` and
``dequant_matmul_batched``) and K5's codes
(``dequant_matmul_batched[packed]``, ``[unpacked]``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.qtensor import QTensor, dequantize_qtensor
from repro_torch.kernels import ref
from repro_torch.kernels.dequant_matmul_w4 import (dequant_matmul_batched,
                                                   dequant_matmul_w4,
                                                   dequant_matmul_w8)
from repro_torch.kernels.flexround_quant import flexround_quant
from repro_torch.kernels.qmatmul_int8 import qmatmul_int8

BACKENDS = ("auto", "kernel", "torch")
KERNELS = (dequant_matmul_w4, dequant_matmul_w8, qmatmul_int8,
           flexround_quant, dequant_matmul_batched)
FALLBACK = "dequantize-fallback"

last_kernel: Optional[str] = None


def launch_counts() -> Dict[str, int]:
    out = {k.__name__: k.launches for k in KERNELS}
    for k in KERNELS:
        for form, n in getattr(k, "forms", {}).items():
            out[f"{k.__name__}[{form}]"] = n
    return out


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        for form in getattr(k, "forms", {}):
            k.forms[form] = 0


def resolve_backend(backend: str, device: torch.device) -> str:
    """Resolve a backend request against the tensors' device; returns
    "kernel" or "torch"."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        return "kernel" if device.type == "cuda" else "torch"
    if backend == "kernel" and device.type != "cuda":
        raise ValueError(f"backend 'kernel' needs CUDA tensors, got {device}; "
                         "CPU tensors run the plain versions ('auto' or "
                         "'torch')")
    return backend


def _row(v, n: int, device) -> torch.Tensor:
    """Normalize a per-tensor (``()``/``(1,1)``) or per-channel
    (``(n,)``/``(1,n)``) parameter to the kernels' contiguous (1, n) row."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.numel() == 1:
        return v.reshape(1, 1).expand(1, n).contiguous()
    return v.reshape(1, n).contiguous()


def flexround_fake_quant(w, state, qcfg, *, backend: str = "auto"):
    """Kernel-backed equivalent of ``core.flexround.apply`` (forward only,
    no STE), the counterpart of the reference's ``ops.flexround_fake_quant``.

    Accepts the state layouts ``core.flexround.init`` produces for a 2-D
    weight: s1/s3/zero per tensor (shape ``()`` or ``(1, 1)``) or per output
    channel (``(N,)`` or ``(1, N)``), normalized here to contiguous (1, N)
    rows. ``"torch"`` runs the plain version; ``"auto"`` runs K4 for CUDA
    tensors and the plain version for CPU ones."""
    global last_kernel
    n = w.shape[-1]
    s1 = _row(state["s1"], n, w.device)
    s3 = _row(state["s3"], n, w.device)
    zero = _row(state["zero"], n, w.device)
    s2 = state["s2"].float().contiguous()
    if resolve_backend(backend, w.device) == "torch":
        last_kernel = "flexround_quant_ref"
        return ref.flexround_quant_ref(w, s1, s2, s3, zero, qcfg.qmin,
                                       qcfg.qmax)
    last_kernel = "flexround_quant"
    return flexround_quant(w.contiguous(), s1, s2, s3, zero, qmin=qcfg.qmin,
                           qmax=qcfg.qmax)


def _snap_codes(x2, a_scale, a_zero):
    """Unsigned [0, 255] activation codes on the snapped LSQ deploy grid
    (``lsq.deploy_astate``); every activation-quantized path derives from
    it."""
    return torch.clamp(torch.round(x2.float() / a_scale) + a_zero, 0, 255)


def _lsq_int8_codes(x2, a_scale, a_zero):
    """Activations as signed int8 codes on the [0, 255] grid (minus 128)."""
    return (_snap_codes(x2, a_scale, a_zero) - 128).to(torch.int8)


def _static_act_quant(x2, a_state):
    """LSQ fake-quant of activations on the snapped deploy grid: the codes
    the W8A8 kernel consumes, dequantized back to x's dtype for the
    dequant-matmul kernels (W4A8, odd-shape sub-8-bit weights)."""
    a_scale, a_zero = a_state
    return (a_scale * (_snap_codes(x2, a_scale, a_zero) - a_zero)).to(x2.dtype)


def recentre_codes(codes: torch.Tensor) -> torch.Tensor:
    """uint8 weight codes u in [0, 255] as the int8 u - 128, in one pass of
    one byte per code: the byte of u - 128 is u ^ 0x80."""
    return codes.view(torch.int8) ^ -128


def _matmul_2d(x2, qt: QTensor, a_state, backend: str):
    global last_kernel
    N = qt.shape[-1]
    scale = _row(qt.scale, N, x2.device)
    zero = _row(qt.zero, N, x2.device)
    plain = backend == "torch"
    if qt.packed and qt.pack_axis == 0:
        # W4A8: fake-quant the activations on the static grid, then the
        # packed dequant kernel
        if a_state is not None:
            x2 = _static_act_quant(x2, a_state)
        last_kernel = "dequant_matmul_w4_ref" if plain else "dequant_matmul_w4"
        if plain:
            return ref.dequant_matmul_w4_ref(x2, qt.codes, scale, zero)
        return dequant_matmul_w4(x2, qt.codes, scale, zero)
    codes = qt.unpacked_codes().contiguous()  # (K, N) uint8
    if a_state is not None and qt.bits == 8:
        # W8A8: codes re-centred at 128 so both operands fit int8; the
        # affine zero offsets become exact rank-1 corrections
        a_scale, a_zero = a_state
        a_q = _lsq_int8_codes(x2, a_scale, a_zero)
        b_q = recentre_codes(codes)
        b_zero = zero - 128.0
        last_kernel = "qmatmul_int8_ref" if plain else "qmatmul_int8"
        if plain:
            return ref.qmatmul_int8_ref(a_q, b_q, a_scale, a_zero - 128.0,
                                        scale, b_zero=b_zero)
        return qmatmul_int8(a_q, b_q, a_scale, a_zero - 128.0, scale,
                            b_zero=b_zero)
    if a_state is not None:
        # sub-8-bit weights that could not nibble-pack: same static grid in
        # front of the weight-only kernel
        x2 = _static_act_quant(x2, a_state)
    last_kernel = "dequant_matmul_w8_ref" if plain else "dequant_matmul_w8"
    if plain:
        return ref.dequant_matmul_w8_ref(x2, codes, scale, zero)
    return dequant_matmul_w8(x2, codes, scale, zero)


def _matmul_batched(x3, qt: QTensor, backend: str):
    """x3 (E, M, K) @ per-expert dequant(qt (E, K, N)) -> (E, M, N)."""
    global last_kernel
    E, K, N = qt.shape
    dev = x3.device
    scale = torch.broadcast_to(qt.scale.to(dev, torch.float32),
                               (E, 1, N)).contiguous()
    zero = torch.broadcast_to(qt.zero.to(dev, torch.float32),
                              (E, 1, N)).contiguous()
    packed = qt.packed and qt.pack_axis == 1
    codes = (qt.codes if packed else qt.unpacked_codes()).contiguous()
    if backend == "torch":
        last_kernel = "dequant_matmul_batched_ref"
        return ref.dequant_matmul_batched_ref(x3, codes, scale, zero, packed)
    last_kernel = "dequant_matmul_batched"
    return dequant_matmul_batched(x3, codes, scale, zero, packed)


def qtensor_matmul(x, qt: QTensor, *, a_state=None, backend: str = "auto"):
    """x @ dequant(qt), the deploy-mode serving matmul. ``a_state`` is the
    static activation grid ``(a_scale, a_zero)`` from ``lsq.deploy_astate``
    and is honoured on every 2-D path:

    - 4-bit K-packed weights -> W4 dequant-matmul (K1); with a_state the
      activations are first fake-quantized on the static grid (W4A8).
    - 8-bit weights + a_state -> W8A8 integer matmul (K3).
    - 8-bit weights without a_state, and <=4-bit weights that could not
      pack -> W8 dequant-matmul (K2).
    - stacked expert weights (E, K, N) with x (..., E, n, K) -> per-expert
      dequant-matmul (K5), on the K1/K2 kernels with an expert axis; the
      blocks of experts whose rows of x are all zero (no token routed
      there) skip their weights on the card. Activations are quantized by
      the caller.
    - more than one batch dim -> dequantized, then a plain product (no
      kernel, as in the reference).
    """
    global last_kernel
    backend = resolve_backend(backend, x.device)
    n_batch = len(qt.shape) - 2
    if n_batch == 0:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        out = _matmul_2d(x2, qt, a_state, backend)
        return out.reshape(lead + (qt.shape[-1],)).to(x.dtype)
    if n_batch == 1:
        E, K, N = qt.shape
        n = x.shape[-2]
        lead = x.shape[:-3]
        # (..., E, n, K) -> (E, prod(lead) * n, K)
        x3 = x.reshape(-1, E, n, K).transpose(0, 1).reshape(E, -1, K)
        out = _matmul_batched(x3.contiguous(), qt, backend)
        out = out.reshape(E, -1, n, N).transpose(0, 1)
        return out.reshape(lead + (E, n, N)).to(x.dtype)
    last_kernel = FALLBACK
    return (x @ dequantize_qtensor(qt).to(x.dtype)).to(x.dtype)
