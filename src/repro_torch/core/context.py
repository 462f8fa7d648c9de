"""QuantCtx — the single integration point between models and quantization
(port of ``repro/core/context.py``).

Every linear in the model routes through ``ctx.linear``, every convolution
through ``ctx.conv2d``. Depending on ``mode`` the same model code runs:

  fp       plain full-precision math (the teacher stream, fp serving)
  calib    record activation ranges per site (LSQ init)
  capture  record each site's inputs (layer-wise reconstruction)
  recon    weights fake-quantized through their rounding states, activations
           LSQ-fake-quantized, plus QDrop's random dropping when the recipe's
           setting is ``qdrop``, ``drop_enabled`` holds and ``key`` is set
  deploy   weights are QTensor leaves; every QTensor matmul dispatches
           through ``kernels/ops.qtensor_matmul`` under ``backend``

``key`` is the step's QDrop source, a callable from a site name to that
site's draw: a ``torch.Generator`` (``qdrop.SiteStreams``: one stream per
site, keyed by the crc32 salt of its name, as the reference folds the salt
into its step key) or a boolean mask drawn elsewhere.

Deploy backend policy (``kernels.ops.resolve_backend``): ``auto`` runs the
CUDA kernels for CUDA tensors and the plain versions for CPU tensors;
``kernel`` insists on the CUDA kernels; ``torch`` runs the plain versions.

A deploy site gets the integer activation grid only when ``astates`` holds
its exact name. The serving engine names its sites ``layers.wq`` (no layer
index) while astates are keyed ``layers.<i>.wq``, so it serves W8A8 and
W4A8 checkpoints as W8A16 and W4A16 — the reference does the same, and the
port mirrors it.

Conv QTensors dequantize in deploy mode: neither package has a conv
kernel. Each such site warns once per process with its shape, bits and
bytes, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import lsq, qdrop
from repro_torch.core.dist import einsum, is_dtensor, unshard_dp
from repro_torch.core.qtensor import QTensor, dequantize_qtensor
from repro_torch.core.quant_config import QuantRecipe, SitePlan

MODES = ("fp", "calib", "capture", "recon", "deploy")

# conv sites that already warned about the deploy dequantize (once per
# process, not once per call)
_CONV_FALLBACK_WARNED: set = set()

Padding = Union[str, Sequence[Tuple[int, int]]]


def _warn_conv_fallback(name: str, qt: QTensor) -> None:
    if name in _CONV_FALLBACK_WARNED:
        return
    _CONV_FALLBACK_WARNED.add(name)
    from repro_torch.core.qtensor import tree_weight_bytes
    warnings.warn(
        f"deploy conv site {name!r}: no conv kernel for QTensor shape "
        f"{qt.shape} ({qt.bits}-bit, {tree_weight_bytes(qt)} bytes) — "
        "dequantizing per call (correct but unaccelerated, as in the "
        "reference)", RuntimeWarning, stacklevel=3)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME": the output has ceil(size / s) positions; the padding
    they need is split with the smaller half before (asymmetric for even
    k or stride > 1, which torch's padding="same" does not offer)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                padding: Padding = "SAME") -> torch.Tensor:
    """``lax.conv_general_dilated`` with NHWC x, HWIO w and NHWC out;
    ``padding`` "SAME", "VALID" or ((top, bottom), (left, right))."""
    kh, kw = w.shape[0], w.shape[1]
    sh, sw = stride
    if padding == "SAME":
        (pt, pb), (pl, pr) = (_same_pads(x.shape[1], kh, sh),
                              _same_pads(x.shape[2], kw, sw))
    elif padding == "VALID":
        pt = pb = pl = pr = 0
    else:
        (pt, pb), (pl, pr) = padding
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=(sh, sw))
    return y.permute(0, 2, 3, 1)


# ``records`` key under which capture mode lists the layers whose recorded
# inputs are the global batch's on every rank (``models.moe`` under a mesh)
GATHERED = "~gathered"


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """Under data parallelism: an activation's leading axis holds rows
    [lo, hi) of a global batch of ``total`` rows, the others live on the
    other ranks of ``dp`` (``launch.mesh.DataParallel``). A layer whose
    output row depends on other rows (the MoE's token groups) reads it from
    ``QuantCtx.rows`` to compute the global program."""
    dp: Any
    lo: int
    hi: int
    total: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch: the other ranks' rows of ``x`` (exact, by a
        byte sum; no gradient) around this rank's rows (live)."""
        full = self.dp.gather_rows(x.detach(), self.total)
        return torch.cat([full[:self.lo], x, full[self.hi:]])


@dataclasses.dataclass
class QuantCtx:
    mode: str = "fp"
    recipe: Optional[QuantRecipe] = None
    wstates: Dict[str, Any] = dataclasses.field(default_factory=dict)
    astates: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the step's QDrop source: site name -> torch.Generator or boolean mask
    key: Optional[Callable[[str], qdrop.MaskOrGenerator]] = None
    drop_enabled: bool = True
    # calib mode: site -> (lo, hi) activation range seen so far;
    # capture mode: site -> [inputs]
    records: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # kernel backend for deploy mode: "auto" | "kernel" | "torch"
    backend: str = "auto"
    # pre-resolved per-site plans; names missing here fall back to the recipe
    plans: Optional[Dict[str, SitePlan]] = None
    # under data parallelism: the rows of the global batch the activations
    # hold (None: the whole batch, one process)
    rows: Optional[BatchRows] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")

    def _plan(self, name: str, batch_dims: int = 0) -> Optional[SitePlan]:
        if self.plans is not None and name in self.plans:
            return self.plans[name]
        if self.recipe is None:
            return None
        return self.recipe.resolve(name, batch_dims=batch_dims)

    def _act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Activation quantization before a linear (paper §4.3)."""
        if self.mode == "fp":
            return x
        if self.mode == "calib":
            x32 = x.float()
            lo, hi = float(x32.min()), float(x32.max())
            if name in self.records:
                plo, phi = self.records[name]
                lo, hi = min(lo, plo), max(hi, phi)
            self.records[name] = (lo, hi)
            return x
        plan = self._plan(name)
        if plan is None or plan.act is None or name not in self.astates:
            return x
        x_hat = lsq.apply(x, self.astates[name], plan.act)
        if (self.mode == "recon" and self.recipe.setting == "qdrop"
                and self.drop_enabled and self.key is not None):
            return qdrop.qdrop(x, x_hat, self.recipe.drop_prob, self.key(name))
        return x_hat

    def _weight(self, name: str, w: Any, batch_dims: int) -> torch.Tensor:
        if isinstance(w, QTensor):
            return dequantize_qtensor(w)
        # FSDP: a DTensor weight whole over the data axes (its experts not)
        w = unshard_dp(w, keep=tuple(range(batch_dims)))
        if self.mode == "recon" and name in self.wstates:
            plan = self._plan(name, batch_dims)
            return plan.method.apply(w, self.wstates[name], plan.weight)
        return w

    def _deploy_matmul(self, name: str, x: torch.Tensor, qt: QTensor,
                       batch_dims: int) -> torch.Tensor:
        """Serving-path matmul: a 2-D site with an 8-bit LSQ state hands the
        kernels its snapped integer activation grid; any other site
        (stacked experts included) quantizes (or passes) activations the
        usual way."""
        from repro_torch.kernels import ops as kops
        a_state = None
        if batch_dims == 0:
            plan = self._plan(name)
            if (plan is not None and plan.act is not None
                    and name in self.astates):
                a_state = lsq.deploy_astate(self.astates[name], plan.act)
        if a_state is None:
            x = self._act(name, x)
        return kops.qtensor_matmul(x, qt, a_state=a_state,
                                   backend=self.backend)

    def get_weight(self, name: str, w: Any, batch_dims: int = 0) -> torch.Tensor:
        """Effective (fake-quant / dequantized) weight for custom einsums."""
        return self._weight(name, w, batch_dims)

    def linear(self, name: str, x: torch.Tensor, w: Any,
               b: Optional[torch.Tensor] = None,
               batch_dims: int = 0) -> torch.Tensor:
        """y = act_quant(x) @ weight_quant(w) + b.

        w: (d_in, d_out), or (E, d_in, d_out) with batch_dims=1: then x has
        shape (..., E, N, d_in) and the contraction is a per-expert matmul.
        """
        if self.mode == "capture":
            self.records.setdefault(name, []).append(x)
        if (self.mode == "deploy" and isinstance(w, QTensor)
                and batch_dims in (0, 1)):
            y = self._deploy_matmul(name, x, w, batch_dims)
        else:
            x_eff = self._act(name, x)
            w_eff = self._weight(name, w, batch_dims).to(x_eff.dtype)
            if batch_dims == 0:
                y = x_eff @ w_eff
            elif is_dtensor(w_eff):  # per expert on each rank's experts
                lead = "abcdfgh"[:x_eff.dim() - 3]  # the "..." below
                y = einsum(f"{lead}eni,eio->{lead}eno", x_eff, w_eff)
            else:
                y = torch.einsum("...eni,eio->...eno", x_eff, w_eff)
        if b is not None:
            y = y + b.to(y.dtype)
        return y

    def conv2d(self, name: str, x: torch.Tensor, w: Any,
               b: Optional[torch.Tensor] = None, stride=(1, 1),
               padding: Padding = "SAME") -> torch.Tensor:
        """x: (N, H, W, Cin), w: (kh, kw, Cin, Cout). Runs in every mode
        (capture records x; recon fake-quantizes both operands); a deploy
        conv QTensor dequantizes and its site warns once per process."""
        if self.mode == "capture":
            self.records.setdefault(name, []).append(x)
        if self.mode == "deploy" and isinstance(w, QTensor):
            _warn_conv_fallback(name, w)
        x_eff = self._act(name, x)
        w_eff = self._weight(name, w, 0)
        y = conv2d_nhwc(x_eff, w_eff.to(x_eff.dtype), stride, padding)
        if b is not None:
            y = y + b.to(y.dtype)
        return y


FP_CTX = QuantCtx(mode="fp")


def fp() -> QuantCtx:
    """A fresh full-precision context."""
    return QuantCtx(mode="fp")
