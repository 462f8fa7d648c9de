"""Cross-backend differential kernel verification (QL304), port of
``repro/analysis/diffcheck.py``.

Sweeps every kernel-table layout over the reference's shape lattice — edge
K (1–3 rows), odd K, N = 129, M = 33, multi-K-tile cells, 1–5 experts —
and holds the hand-written CUDA kernels (``backend="kernel"``) against
their plain versions (``backend="torch"``, ``kernels/ref.py``), both
through the real dispatcher ``kernels.ops.qtensor_matmul``, on a CUDA
device. Both runs are recorded (the QL207 coverage recorders), so each
parity row also proves which kernel served the layout: a recorded pair
other than ``EXPECTED_KERNELS[layout]`` is a QL304 ``dispatch-drift``
error, not a silently green comparison of the wrong kernel. Each cell runs
in float32 (the reference's dtype; K1/K2/K5 take their ``fp32`` regime)
and in bfloat16, the main path's dtype (M = 1 and 5 take ``decode``,
M = 33 takes ``mma``); each row records the regimes the kernel took.

Tolerance policy. The reference's single-tile bit-exact rule does not
carry over: the CUDA kernels accumulate in another order than torch's
products do. So:

  - w8a8: the int32 accumulator bit for bit (the same int8 operands
    through the kernel with unit scales and zero offsets, against the
    exact float64 product), then the dispatcher's output within the
    epilogue's rounding bound ``int8_epilogue_tol`` (16 float32 roundings
    of the largest term; plus one bfloat16 step, 2^-7 relative, when the
    output is cast to bfloat16);
  - float layouts: ``matmul_tol`` — in float32
    ``1e-5 + 8 sqrt(K) 2^-24 (|x| @ |w|)`` (a few sqrt(K) roundings of
    the sum of |terms|: the kernel accumulates sequentially per thread,
    torch in blocks), in bfloat16 one bfloat16 step
    (``2e-2 + 2e-2 |want|``: both sides round one float32 sum).

The full lattice (>= 20 shapes per layout) runs on the card from
``chip_smoke.py``; the default lint run sweeps a 3-shape smoke subset per
layout and dtype. On the CPU there is nothing to compare (no kernel runs
there): ``run_diffcheck`` and ``check_parity`` raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.coverage import record_one
from repro_torch.analysis.layouts import (MATMUL_LAYOUTS, _a_state_for,
                                          _export_qt, example_x, layout_row)
from repro_torch.analysis.report import Report
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.envelope import check_envelope

#: layout -> (plain version, CUDA kernel) the dispatcher must pick
EXPECTED_KERNELS: Dict[str, Tuple[str, str]] = {
    "w4_packed": ("dequant_matmul_w4_ref", "dequant_matmul_w4"),
    "w4a8_packed": ("dequant_matmul_w4_ref", "dequant_matmul_w4"),
    "w8a8": ("qmatmul_int8_ref", "qmatmul_int8"),
    "w8_weight_only": ("dequant_matmul_w8_ref", "dequant_matmul_w8"),
    "w4_odd_unpacked": ("dequant_matmul_w8_ref", "dequant_matmul_w8"),
    "experts_batched": ("dequant_matmul_batched_ref", "dequant_matmul_batched"),
}
DTYPES = (torch.float32, torch.bfloat16)
BF16_STEP = 2.0**-7  # one bfloat16 step, relative


def _needs_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise RuntimeError(
            "QL304 holds the hand-written CUDA kernels against their plain "
            f"versions: it needs a CUDA card, got device {device} (on the "
            "CPU no kernel runs; run it on the card, e.g. through "
            "chip_smoke.py)")


@dataclasses.dataclass(frozen=True)
class ParityRow:
    """One (layout, shape, dtype) cell of the QL304 parity matrix."""
    layout: str
    shape: Tuple[int, int, int, int]   # (e, m, k, n); e = 1 for 2-D layouts
    dtype: str                         # x's dtype
    kernel_plain: str
    kernel: str
    regimes: Tuple[str, ...]           # launch forms the kernel took
    mode: str                          # "exact-acc" (w8a8) | "tolerance"
    max_abs_err: float
    bound: float                       # the tolerance at the worst element
    ratio: float                       # max of |err| / tolerance
    ok: bool

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ------------------------------------------------------------ shape lattice
def shape_lattice(layout: str) -> List[Tuple[int, int, int, int]]:
    """(e, m, k, n) sweep for one layout: edge K (1-2 rows/cols), odd K,
    non-block-divisible everything, plus multi-K-tile rows. Every shape is
    inside the layout's envelope (asserted)."""
    ms = (1, 5, 33)
    ns = (8, 24, 120, 129)
    if layout in ("w4_packed", "w4a8_packed"):
        ks = (2, 6, 16, 62, 64, 126, 254, 256, 510, 512, 514, 1026)
    elif layout == "w4_odd_unpacked":
        ks = (3, 5, 33, 63, 127, 255, 333, 511, 513, 1025)
    elif layout in ("w8a8", "w8_weight_only"):
        ks = (1, 7, 24, 48, 127, 128, 255, 384, 512, 640, 1024, 1100)
    elif layout == "experts_batched":
        ks = (4, 6, 16, 62, 64, 126, 128, 254, 256, 512)
    else:
        raise KeyError(layout)
    es = (1, 2, 3, 5) if layout == "experts_batched" else (1,)
    shapes: List[Tuple[int, int, int, int]] = []
    for rep in range(2):   # two passes with shifted m/n pairing -> >= 20 rows
        for i, k in enumerate(ks):
            e = es[(i + rep) % len(es)]
            m = ms[(i + rep) % len(ms)]
            n = ns[(i + 2 * rep) % len(ns)]
            if (e, m, k, n) in shapes:
                n = ns[(i + 2 * rep + 1) % len(ns)]
            shapes.append((e, m, k, n))
    for e, m, k, n in shapes:
        check_envelope(layout, m, k, n, e)
    return shapes


def example_at(layout: str, e: int, m: int, k: int, n: int,
               dtype: torch.dtype = torch.float32, *, device="cpu"):
    """(x, qt, a_state) of one lattice cell: the weight from seed 9, x from
    seed 13 (``layouts``), x cast to ``dtype``, the a-state from x."""
    _, bits, batch_dims, with_a = layout_row(layout)
    if batch_dims == 1:
        qt = _export_qt((e, k, n), bits, batch_dims=1, device=device)
        x = example_x((e, m, k), dtype, device=device)
    else:
        qt = _export_qt((k, n), bits, batch_dims=0, device=device)
        x = example_x((m, k), dtype, device=device)
    return x, qt, (_a_state_for(x) if with_a else None)


# -------------------------------------------------------------- tolerances
def matmul_tol(x: torch.Tensor, w: Optional[torch.Tensor],
               want: torch.Tensor, K: int) -> torch.Tensor:
    """The stated tolerance of a dequant matmul (elementwise): at most one
    bf16 step in bfloat16 (both sides round one float32 sum to bfloat16);
    in float32 a few sqrt(K) roundings of the sum of |terms| (the kernel
    accumulates sequentially per thread, torch in blocks). ``w``: the
    dequantized float32 weight ((K, N), or (E, K, N) with x (E, M, K));
    unused in bfloat16."""
    if x.dtype == torch.bfloat16:
        return 2e-2 + 2e-2 * want.float().abs()
    return 1e-5 + 8 * math.sqrt(K) * 2.0**-24 * torch.matmul(
        x.float().abs(), w.abs())


def int8_epilogue_tol(a_q, b_q, acc, a_scale, a_zero, b_scale,
                      b_zero) -> torch.Tensor:
    """K3's epilogue bound (float64, elementwise): the kernel associates
    ``a_scale*b_scale*(acc - (a_zero*colsum + rowsum*b_zero -
    K*a_zero*b_zero))`` as the Pallas kernel does, the plain version as
    ``kernels/ref.py``; each rounds about 5 times at the size of its
    largest term, so 16 float32 roundings of the largest term bound their
    difference. ``acc``: the exact accumulator (M, N)."""
    K = a_q.shape[1]
    cs = b_q.double().sum(0, keepdim=True)
    rs = a_q.double().sum(1, keepdim=True)
    az = torch.as_tensor(a_zero).double()
    bz = torch.as_tensor(b_zero).double()
    terms = (acc.double().abs() + (az * cs).abs() + (rs * bz).abs()
             + (K * az * bz).abs())
    scale = (torch.as_tensor(a_scale).double()
             * torch.as_tensor(b_scale).double()).abs()
    return 16 * 2.0**-24 * scale * terms


def _worst(err: torch.Tensor, tol: torch.Tensor) -> Tuple[float, float, float]:
    """(max |err|, the tolerance where err/tol peaks, that peak)."""
    if err.numel() == 0:
        return 0.0, 0.0, 0.0
    tol = torch.broadcast_to(tol.double(), err.shape)
    r = err.double() / tol
    i = int(torch.argmax(r))
    return (float(err.max()), float(tol.reshape(-1)[i]),
            float(r.reshape(-1)[i]))


def _w8a8_check(x, qt, a_state, got, want):
    """The int32 accumulator bit for bit, then the epilogue bound:
    (ok, max |err|, bound, ratio)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.qmatmul_int8 import qmatmul_int8
    a_scale, a_zero = a_state
    a_q = kops._lsq_int8_codes(x.reshape(-1, x.shape[-1]), a_scale, a_zero)
    b_q = kops.recentre_codes(qt.unpacked_codes().contiguous())
    N = b_q.shape[1]
    one, nil = (torch.ones((), device=x.device),
                torch.zeros((), device=x.device))
    acc = qmatmul_int8(a_q, b_q, one, nil,
                       torch.ones((1, N), device=x.device),
                       torch.zeros((1, N), device=x.device))
    exact = torch.matmul(a_q.double(), b_q.double()).float()
    acc_ok = bool(torch.equal(acc, exact))
    b_scale = kops._row(qt.scale, N, x.device)
    b_zero = kops._row(qt.zero, N, x.device) - 128.0
    tol = int8_epilogue_tol(a_q, b_q, exact, a_scale, a_zero - 128.0,
                            b_scale, b_zero)
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_STEP * want.double().abs()
    err = (got.double() - want.double()).abs()
    e, b, r = _worst(err, tol)
    return acc_ok and bool((err <= tol).all()), e, b, r


def _float_check(x, qt, a_state, got, want, k):
    from repro_torch.core.qtensor import dequantize_qtensor
    from repro_torch.kernels import ops as kops
    x_eff = x
    if a_state is not None:  # W4A8: the product sees the fake-quantized x
        x_eff = kops._static_act_quant(x.reshape(-1, x.shape[-1]),
                                       a_state).reshape(x.shape)
    w = None if x.dtype == torch.bfloat16 else dequantize_qtensor(qt).float()
    tol = matmul_tol(x_eff, w, want, k)
    err = (got.float() - want.float()).abs()
    e, b, r = _worst(err, tol)
    return bool((err <= tol).all()), e, b, r


# ------------------------------------------------------------------ checks
def check_parity(layout: str, e: int, m: int, k: int, n: int, *,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> ParityRow:
    """Run one lattice cell through both backends on the card (``device``
    None: the card; the CPU raises) and compare under the module's
    policy."""
    from repro_torch.kernels import ops as kops
    dev = resolve_device(device)
    _needs_card(dev)
    with torch.no_grad():
        x, qt, a_state = example_at(layout, e, m, k, n, dtype, device=dev)
        want, plain, _ = record_one(lambda: kops.qtensor_matmul(
            x, qt, a_state=a_state, backend="torch"))
        got, kernel, forms = record_one(lambda: kops.qtensor_matmul(
            x, qt, a_state=a_state, backend="kernel"))
        torch.cuda.synchronize(dev)
        shaped = (got.shape == want.shape and got.dtype == want.dtype
                  and bool(torch.isfinite(got).all()))
        if layout == "w8a8":
            ok, err, bound, ratio = _w8a8_check(x, qt, a_state, got, want)
            mode = "exact-acc"
        else:
            ok, err, bound, ratio = _float_check(x, qt, a_state, got, want, k)
            mode = "tolerance"
    return ParityRow(layout=layout, shape=(e, m, k, n),
                     dtype=str(dtype).replace("torch.", ""),
                     kernel_plain=plain, kernel=kernel,
                     regimes=tuple(f[f.index("[") + 1:-1] for f in forms),
                     mode=mode, max_abs_err=err, bound=bound, ratio=ratio,
                     ok=ok and shaped)


def run_diffcheck(layouts: Optional[Sequence[str]] = None, *,
                  smoke: bool = False, dtypes: Sequence[torch.dtype] = DTYPES,
                  device: DeviceLike = None) -> Tuple[Report, List[ParityRow]]:
    """Differential sweep on the card; ``smoke=True`` trims the lattice to
    3 shapes per layout (the default lint run; ``chip_smoke.py`` runs the
    full lattice). Each cell runs in every one of ``dtypes``."""
    dev = resolve_device(device)
    _needs_card(dev)
    rep = Report()
    rows: List[ParityRow] = []
    names = layouts or tuple(r[0] for r in MATMUL_LAYOUTS)
    for layout in names:
        lattice = shape_lattice(layout)
        if smoke:
            # one edge-K, one odd/middle, one grid-non-divisible
            lattice = lattice[:3]
        exp_plain, exp_kernel = EXPECTED_KERNELS[layout]
        for dtype in dtypes:
            for e, m, k, n in lattice:
                row = check_parity(layout, e, m, k, n, dtype=dtype, device=dev)
                rows.append(row)
                where = f"diff:{layout}#e{e}m{m}k{k}n{n}:{row.dtype}"
                if row.kernel_plain != exp_plain or row.kernel != exp_kernel:
                    rep.add("QL304", "dispatch-drift", "error", where,
                            f"layout dispatched to ({row.kernel_plain}, "
                            f"{row.kernel}); the kernel table promises "
                            f"({exp_plain}, {exp_kernel}) — the parity "
                            "result proves the wrong kernel")
                elif not row.ok:
                    rep.add("QL304", "kernel-parity", "error", where,
                            f"the CUDA kernel and its plain version differ "
                            f"by {row.max_abs_err:.3g} (mode {row.mode}, "
                            f"{row.ratio:.3g}x the bound {row.bound:.3g}, "
                            f"regimes {','.join(row.regimes)}) — the kernel "
                            "and its plain version have diverged")
    return rep, rows


def parity_table(rows: List[ParityRow]) -> str:
    head = (f"{'layout':18s} {'(e,m,k,n)':>18s} {'dtype':>8s} {'mode':>9s} "
            f"{'max|err|':>10s} {'bound':>9s} {'ratio':>6s}  kernel")
    lines = [head, "-" * len(head)]
    for r in rows:
        mark = "" if r.ok else "  <- FAIL"
        lines.append(
            f"{r.layout:18s} {str(r.shape):>18s} {r.dtype:>8s} {r.mode:>9s} "
            f"{r.max_abs_err:>10.3g} {r.bound:>9.3g} {r.ratio:>6.3f}  "
            f"{r.kernel}[{','.join(r.regimes)}]{mark}")
    return "\n".join(lines)


def parity_json(rows: List[ParityRow]) -> dict:
    return {
        "rows": [r.to_json() for r in rows],
        "layouts": sorted({r.layout for r in rows}),
        "n_rows": len(rows),
        "n_fail": sum(1 for r in rows if not r.ok),
    }
