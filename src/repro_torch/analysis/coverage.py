"""Kernel-coverage report (QL207), port of ``repro/analysis/coverage.py``:
which kernel actually serves each QTensor layout, proven by recording, not
by reading the dispatch code.

The runner temporarily wraps the plain versions (``kernels/ref.py``'s
``*_ref``, the ``backend="torch"`` targets), the CUDA kernels' wrappers as
``kernels/ops.py`` calls them, and both ``dequantize_qtensor`` import sites
with recorders, then drives every kernel-table layout through
``kernels.ops.qtensor_matmul`` and every known conv frontend site through
``QuantCtx.conv2d`` in deploy mode. The recorded names are
``ops.last_kernel``'s: ``*_ref`` for the plain versions, the kernel names
for the CUDA kernels and ``dequantize-fallback``. On a card each row also
records the regimes that served it, read from ``ops.launch_counts()``'s
forms (``dequant_matmul_w4[decode|mma|fp32]``,
``dequant_matmul_batched[packed|unpacked]``, ...). A layout whose recorded
kernel is the dequantize fallback gets a QL207 warning naming the site,
shape and serving bytes: today that is exactly the conv frontends
(whisper, phi-3-vision).

``kernel_coverage`` runs on the card unless the caller passes
``device="cpu"`` (where ``backend="auto"`` records the plain versions).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Tuple

import torch

from repro_torch.analysis.layouts import (MATMUL_LAYOUTS, _export_qt,
                                          example_x, matmul_example)
from repro_torch.analysis.report import Report
from repro_torch.core.qtensor import tree_weight_bytes
from repro_torch.device import DeviceLike, resolve_device

FALLBACK = "dequantize-fallback"
# the CUDA kernels' wrappers as kernels/ops.py names and calls them
KERNEL_WRAPPERS = ("dequant_matmul_w4", "dequant_matmul_w8",
                   "dequant_matmul_batched", "qmatmul_int8")


@dataclasses.dataclass(frozen=True)
class CoverageRow:
    site: str                # layout name or model-site name
    shape: Tuple[int, ...]   # logical weight shape
    bits: int
    kernel: str              # plain or kernel name, or FALLBACK
    weight_bytes: int
    regimes: Tuple[str, ...] = ()  # launch forms taken (on a card)

    @property
    def fallback(self) -> bool:
        return self.kernel == FALLBACK


def conv_frontend_sites() -> List[Tuple[str, Tuple[int, ...], int]]:
    """(site name, HWIO weight shape, bits) for the stubbed conv frontends,
    at the real architectures' dims (the port's configs): whisper's two
    1-D encoder convs (kernel 3, mel 80 -> d_model) and phi-3-vision's
    14x14 CLIP patch embed. These are the QTensor sites the serving path
    cannot kernel yet."""
    from repro_torch.configs import get_config
    sites = []
    wh = get_config("whisper-medium")
    sites.append((f"{wh.name}.encoder.conv1", (1, 3, 80, wh.d_model), 8))
    sites.append((f"{wh.name}.encoder.conv2",
                  (1, 3, wh.d_model, wh.d_model), 8))
    ph = get_config("phi-3-vision-4.2b")
    sites.append((f"{ph.name}.vision.patch_embed", (14, 14, 3, ph.d_model), 8))
    return sites


@contextlib.contextmanager
def _record_kernels(hits: List[str]):
    """Wrap the plain versions, the kernel wrappers ops calls and both
    dequantize_qtensor import sites, so a run records which implementation
    actually executed."""
    import repro_torch.core.context as qctx
    import repro_torch.kernels.ops as kops
    import repro_torch.kernels.ref as ref

    saved = []

    def wrap(mod, attr, label):
        orig = getattr(mod, attr)

        def rec_fn(*a, _orig=orig, _label=label, **kw):
            hits.append(_label)
            return _orig(*a, **kw)

        saved.append((mod, attr, orig))
        setattr(mod, attr, rec_fn)

    for fname in dir(ref):
        if fname.endswith("_ref"):
            wrap(ref, fname, fname)
    for fname in KERNEL_WRAPPERS:
        wrap(kops, fname, fname)
    wrap(kops, "dequantize_qtensor", FALLBACK)
    wrap(qctx, "dequantize_qtensor", FALLBACK)
    try:
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def first_kernel(hits: List[str]) -> str:
    kernels = [h for h in hits if h != FALLBACK]
    return kernels[0] if kernels else (FALLBACK if hits else "none")


def record_one(fn: Callable[[], torch.Tensor]):
    """Run ``fn`` once: (its output, the kernel that served it, the launch
    forms it added to ``ops.launch_counts()``)."""
    from repro_torch.kernels import ops as kops
    hits: List[str] = []
    before = kops.launch_counts()
    with _record_kernels(hits):
        out = fn()
    after = kops.launch_counts()
    forms = tuple(sorted(k for k in after if "[" in k and after[k] != before[k]))
    return out, first_kernel(hits), forms


def kernel_coverage(device: DeviceLike = None, backend: str = "auto"
                    ) -> Tuple[Report, List[CoverageRow]]:
    """Drive every layout and conv frontend site once on ``device`` (None:
    the card) through the deploy dispatch under ``backend``; returns the
    QL207 findings and one row per site."""
    from repro_torch.core.context import QuantCtx
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    rep = Report()
    rows: List[CoverageRow] = []
    with torch.no_grad():
        for name, shape, bits, _, _ in MATMUL_LAYOUTS:
            x, qt, a_state = matmul_example(name, device=dev)
            _, kernel, forms = record_one(lambda: kops.qtensor_matmul(
                x, qt, a_state=a_state, backend=backend))
            rows.append(CoverageRow(name, shape, bits, kernel,
                                    tree_weight_bytes(qt), forms))

        for site, shape, bits in conv_frontend_sites():
            qt = _export_qt(shape, bits, device=dev)
            kh, kw, cin, _ = shape
            x = example_x((1, max(kh, 2), max(kw * 4, 8), cin), device=dev)
            ctx = QuantCtx(mode="deploy", backend=backend)
            _, kernel, forms = record_one(lambda: ctx.conv2d(site, x, qt))
            rows.append(CoverageRow(site, shape, bits, kernel,
                                    tree_weight_bytes(qt), forms))

    for row in rows:
        if row.fallback:
            rep.add("QL207", "kernel-fallback", "warning",
                    f"coverage:{row.site}",
                    f"QTensor {row.shape} ({row.bits}-bit, "
                    f"{row.weight_bytes / 2**20:.2f} MiB served) dispatches "
                    "to the dequantize fallback — correct but unaccelerated "
                    "(no kernel for this layout yet)")
    return rep, rows


def coverage_table(rows: List[CoverageRow]) -> str:
    head = f"{'site/layout':44s} {'shape':>20s} {'bits':>4s} kernel"
    lines = [head, "-" * len(head)]
    for r in rows:
        mark = "  <- fallback" if r.fallback else ""
        forms = f" {','.join(r.regimes)}" if r.regimes else ""
        lines.append(f"{r.site:44s} {str(r.shape):>20s} {r.bits:>4d} "
                     f"{r.kernel}{forms}{mark}")
    return "\n".join(lines)
