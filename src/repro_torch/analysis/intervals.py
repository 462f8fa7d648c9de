"""quantcheck layer 1: interval abstract interpretation over traced graphs
(port of ``repro/analysis/intervals.py``, over ``make_fx`` aten graphs).

Runs every :class:`~repro_torch.analysis.trace.TracedEntry` through a sound
interval interpreter and proves (or refutes) three numerics properties over
the entry's *shape envelope* (``repro_torch.kernels.envelope``), not just
the smoke shapes it was traced at:

  QL301 int-overflow       an integer node's value interval leaves its dtype
                           range — e.g. an int8 x int8 contraction
                           accumulating in int16. Contractions and sums are
                           scaled up to the envelope's ``k_max`` so the
                           proof covers every serving shape, and a fitting
                           accumulator is reported as an explicit proof
                           (info). The plain W8A8 version forms its
                           accumulator in float64 (torch has no int32
                           matmul on CUDA, ``kernels/ref.py``): a float64
                           contraction of integer-valued operands is read
                           as the int32 accumulator K3 keeps
                           (``csrc/qmatmul_int8.cu``), held to the int32
                           range and to float64's exact integers (< 2^53).
  QL302 grid-saturation    a clamp bound is *provably always* active: the
                           clamped operand's interval lies entirely beyond
                           one bound, so the quantization grid collapses to
                           a constant. Straddling intervals (ordinary
                           clipping) never fire.
  QL303 scale-underflow    a division's divisor interval is entirely
                           subnormal (|d| < float32 tiny). On this card
                           torch's ops and K4 keep float32 subnormals (no
                           ``-ftz`` in ``kernels/build.py``), so the hazard
                           is W/(s1*s2*s3) overflowing to inf, and inf/NaN
                           gradients through the reciprocal rule.

Soundness over silence: placeholders are seeded from the entry's declared
value ranges (``TracedEntry.ranges``), from narrow integer dtype bounds and
from constant values; everything else is TOP and marked *unknown*. The
three rules only fire on intervals whose every input was known — an
unknown op (TOP, as in the reference) can never produce a false positive,
only a missed proof.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.analysis.report import Report
from repro_torch.analysis.trace import (TracedEntry, _getitem, is_collective,
                                        label_matches, op_name)
from repro_torch.kernels.envelope import F32_TINY, ShapeEnvelope, get_envelope

NEG_INF = float("-inf")
POS_INF = float("inf")
F64_EXACT = float(2**53)


@dataclasses.dataclass(frozen=True)
class Interval:
    """A closed real interval [lo, hi] with a knownness bit.

    ``known=False`` marks fallback bounds (unknown op, unseeded float
    input); the QL30x rules never fire on them."""
    lo: float
    hi: float
    known: bool = True

    def __post_init__(self):
        assert self.lo <= self.hi, (self.lo, self.hi)

    @property
    def abs_max(self) -> float:
        return max(abs(self.lo), abs(self.hi))

    @property
    def finite(self) -> bool:
        return math.isfinite(self.lo) and math.isfinite(self.hi)

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi),
                        self.known and other.known)

    def clip_to(self, lo: float, hi: float) -> "Interval":
        nlo = min(max(self.lo, lo), hi)
        nhi = max(min(self.hi, hi), lo)
        return Interval(nlo, nhi, self.known)


TOP = Interval(NEG_INF, POS_INF, known=False)


def _point(v) -> Interval:
    v = float(v)
    return TOP if math.isnan(v) else Interval(v, v)


def _mul1(a: float, b: float) -> float:
    # IEEE inf * 0 is nan; the correct interval endpoint product is 0
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


def _imul(a: Interval, b: Interval) -> Interval:
    ps = (_mul1(a.lo, b.lo), _mul1(a.lo, b.hi),
          _mul1(a.hi, b.lo), _mul1(a.hi, b.hi))
    return Interval(min(ps), max(ps), a.known and b.known)


def _idiv(a: Interval, b: Interval) -> Interval:
    # division where the divisor interval may include 0 is unbounded
    if b.lo <= 0.0 <= b.hi:
        return Interval(NEG_INF, POS_INF, a.known and b.known)
    inv = Interval(1.0 / b.hi, 1.0 / b.lo, b.known)
    return _imul(a, inv)


def _add(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo + b.lo, a.hi + b.hi, a.known and b.known)


def _neg(a: Interval) -> Interval:
    return Interval(-a.hi, -a.lo, a.known)


def _dtype_interval(dtype) -> Interval:
    if dtype is None:
        return TOP
    if dtype == torch.bool:
        return Interval(0.0, 1.0, known=True)
    if dtype.is_floating_point or dtype.is_complex:
        return TOP
    info = torch.iinfo(dtype)
    # dtype bounds are always true bounds, but only the narrow code dtypes
    # (int8/uint8/int16) carry *meaningful* range information — full-range
    # int32/int64 counters and indices would turn every add into a
    # may-overflow false positive, so they stay unknown
    return Interval(float(info.min), float(info.max),
                    known=torch.tensor([], dtype=dtype).element_size() <= 2)


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _dtype(node):
    v = _val(node)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _fallback_dtype(dtype) -> Interval:
    return dataclasses.replace(_dtype_interval(dtype), known=False)


def _fallback(node) -> Interval:
    return _fallback_dtype(_dtype(node))


def _const_interval(t) -> Interval:
    if not isinstance(t, torch.Tensor) or t.numel() == 0:
        return Interval(0.0, 0.0) if isinstance(t, torch.Tensor) else TOP
    if t.is_complex() or type(t) is not torch.Tensor:  # fake: no values
        return TOP
    if t.numel() > 1 << 22:
        return _fallback_dtype(t.dtype)
    lo, hi = float(t.min()), float(t.max())
    if math.isnan(lo) or math.isnan(hi):
        return TOP
    return Interval(lo, hi)


def _round_iv(iv: Interval, fn) -> Interval:
    lo = fn(iv.lo) if math.isfinite(iv.lo) else iv.lo
    hi = fn(iv.hi) if math.isfinite(iv.hi) else iv.hi
    return Interval(float(lo), float(hi), iv.known)


def _sqrt(iv: Interval) -> Interval:
    if iv.lo < 0.0:
        return TOP
    return Interval(math.sqrt(iv.lo), math.sqrt(iv.hi), iv.known)


def _exp(x: float) -> float:
    return math.exp(min(x, 700.0)) if x != NEG_INF else 0.0


# --------------------------------------------------------------- interpreter
class _Ctx:
    """Per-entry interpreter state: envelope, report sink, proof ledger."""

    def __init__(self, entry: TracedEntry, rep: Report):
        self.entry = entry
        self.rep = rep
        self.env: Optional[ShapeEnvelope] = (
            get_envelope(entry.envelope) if entry.envelope else None)
        self.proofs: List[str] = []
        self.fired: set = set()   # dedup (rule, op, detail) per entry

    def where(self, node) -> str:
        return f"graph:{self.entry.name}#{op_name(node)}"

    def add_once(self, key, rule, name, severity, where, message):
        if key in self.fired:
            return
        self.fired.add(key)
        self.rep.add(rule, name, severity, where, message)


def _reduction_count(shape, dims, ctx: _Ctx) -> int:
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        dims = range(len(shape))
    elif isinstance(dims, int):
        dims = (dims,)
    n = 1
    for ax in dims:
        n *= int(shape[ax])
    if ctx.env is not None:
        # prove over the envelope's largest contraction, not the smoke shape
        n = max(n, ctx.env.k_max)
    return max(n, 1)


def _scaled_sum(iv: Interval, n: int) -> Interval:
    return Interval(_mul1(float(n), iv.lo), _mul1(float(n), iv.hi), iv.known)


_VALUE_KEEPING = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select",
    "index_select", "index", "_unsafe_index", "gather", "clone", "detach",
    "alias", "contiguous", "lift_fresh_copy", "repeat", "flip", "roll",
    "narrow", "as_strided", "unfold", "amax", "amin", "mean", "movedim",
    "diagonal", "take_along_dim", "split", "unbind", "chunk",
    "split_with_sizes", "sort", "topk", "cummax", "cummin", "_reshape_alias",
    "squeeze_copy", "view_copy", "permute_copy", "expand_copy",
    "slice_copy", "select_copy", "transpose_copy", "unsqueeze_copy", "tile",
})
_COMPARE = frozenset({"eq", "ne", "lt", "le", "gt", "ge", "logical_and",
                      "logical_or", "logical_not", "logical_xor", "isnan",
                      "isinf", "isfinite", "any", "all", "isin"})
_CONTRACTIONS = frozenset({"mm", "bmm", "matmul", "dot"})


def _base(node) -> str:
    """The op's name without the in-place suffix (``add_`` -> ``add``)."""
    name = op_name(node)
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _clamp_args(node, base):
    """The (lower, upper) bound arguments of a clamp-like op, None where it
    has none."""
    if base == "clamp_min":
        return _arg(node, 1, "min"), None
    if base == "clamp_max":
        return None, _arg(node, 1, "max")
    return _arg(node, 1, "min"), _arg(node, 2, "max")


def _arg(node, i, key=None, default=None):
    if i < len(node.args):
        return node.args[i]
    if key is not None and key in node.kwargs:
        return node.kwargs[key]
    return default


def _eval_node(node, read, ctx: _Ctx):
    """The interval (or list of intervals) of one call_function node, or
    None for the dtype fallback."""
    if node.target is _getitem:
        src, i = node.args
        v = read(src)
        if isinstance(v, list):
            return v[i] if i < len(v) else None
        return v
    if is_collective(node):
        # a cross-rank sum widens by the group size: unknown-scaled
        v = read(node.args[0])
        ivs = v if isinstance(v, list) else [v]
        return [Interval(min(iv.lo * 64, iv.lo), max(iv.hi * 64, iv.hi),
                         False) for iv in ivs]
    name, base = op_name(node), _base(node)
    a0 = _arg(node, 0)

    def iv(x) -> Interval:
        if isinstance(x, torch.fx.Node):
            v = read(x)
            return v if isinstance(v, Interval) else TOP
        if isinstance(x, bool):
            return _point(int(x))
        if isinstance(x, (int, float)):
            return _point(x)
        return TOP

    if base in ("add", "sub", "rsub"):
        a, b = iv(a0), iv(_arg(node, 1))
        alpha = _arg(node, 2, "alpha", 1)
        b = _imul(b, _point(alpha)) if alpha != 1 else b
        if base == "add":
            return _add(a, b)
        if base == "sub":
            return _add(a, _neg(b))
        return _add(b, _neg(a))
    if base == "mul":
        return _imul(iv(a0), iv(_arg(node, 1)))
    if base == "div":
        out = _idiv(iv(a0), iv(_arg(node, 1)))
        mode = _arg(node, 2, "rounding_mode")
        if mode == "floor":
            out = _round_iv(out, math.floor)
        elif mode == "trunc":
            out = _round_iv(out, math.trunc)
        return out
    if base == "reciprocal":
        return _idiv(_point(1.0), iv(a0))
    if base == "neg":
        return _neg(iv(a0))
    if base == "abs":
        a = iv(a0)
        lo = 0.0 if a.lo <= 0.0 <= a.hi else min(abs(a.lo), abs(a.hi))
        return Interval(lo, a.abs_max, a.known)
    overload = getattr(node.target, "_overloadname", "")
    if base == "maximum" or (base == "max" and overload == "other"):
        a, b = iv(a0), iv(_arg(node, 1))
        return Interval(max(a.lo, b.lo), max(a.hi, b.hi), a.known and b.known)
    if base == "minimum" or (base == "min" and overload == "other"):
        a, b = iv(a0), iv(_arg(node, 1))
        return Interval(min(a.lo, b.lo), min(a.hi, b.hi), a.known and b.known)
    if base in ("clamp", "clip", "clamp_min", "clamp_max"):
        x = iv(a0)
        lo, hi = _clamp_args(node, base)
        lo_i = iv(lo) if lo is not None else Interval(NEG_INF, NEG_INF)
        hi_i = iv(hi) if hi is not None else Interval(POS_INF, POS_INF)
        return Interval(min(max(x.lo, lo_i.lo), hi_i.hi),
                        max(min(x.hi, hi_i.hi), lo_i.lo),
                        x.known and (lo is None or lo_i.known)
                        and (hi is None or hi_i.known))
    if base == "round":
        return _round_iv(iv(a0), round)
    if base == "floor":
        return _round_iv(iv(a0), math.floor)
    if base == "ceil":
        return _round_iv(iv(a0), math.ceil)
    if base == "trunc":
        return _round_iv(iv(a0), math.trunc)
    if base == "sign":
        return Interval(-1.0, 1.0, iv(a0).known)
    if base == "exp":
        a = iv(a0)
        return Interval(_exp(a.lo), _exp(a.hi) if a.hi != POS_INF else POS_INF,
                        a.known)
    if base == "sqrt":
        return _sqrt(iv(a0))
    if base in ("sigmoid",):
        return Interval(0.0, 1.0, iv(a0).known)
    if base == "tanh":
        return Interval(-1.0, 1.0, iv(a0).known)
    if base == "relu":
        a = iv(a0)
        return Interval(max(a.lo, 0.0), max(a.hi, 0.0), a.known)
    if base in ("_softmax", "softmax"):
        return Interval(0.0, 1.0, iv(a0).known)
    if base == "pow" and isinstance(_arg(node, 1), (int, float)):
        y, a = _arg(node, 1), iv(a0)
        if y == 2:
            lo = 0.0 if a.lo <= 0.0 <= a.hi else min(a.lo**2, a.hi**2)
            return Interval(lo, a.abs_max**2, a.known)
        if isinstance(y, int) and y % 2 == 1 and a.finite:
            return Interval(a.lo**y, a.hi**y, a.known)
        return None
    if base in _VALUE_KEEPING:
        if name == "view" and isinstance(_arg(node, 1), torch.dtype):
            return None  # a reinterpreting view: the dtype fallback
        a = read(a0) if isinstance(a0, torch.fx.Node) else TOP
        if isinstance(a, list):
            return None
        val = _val(node)
        if isinstance(val, (list, tuple)):
            return [a] * len(val)
        return a
    if base in ("max", "min"):  # reductions; .dim gives (values, indices)
        return [iv(a0), None] if overload == "dim" else iv(a0)
    if base in ("cat", "stack"):
        vs = [iv(x) for x in a0]
        out = vs[0]
        for v in vs[1:]:
            out = out.hull(v)
        return out
    if base == "where" and len(node.args) == 3:
        return iv(_arg(node, 1)).hull(iv(_arg(node, 2)))
    if base == "masked_fill":
        return iv(a0).hull(iv(_arg(node, 2)))
    if base in ("index_copy", "index_put", "scatter", "index_add"):
        src = _arg(node, 3) if base in ("index_copy", "scatter") else \
            _arg(node, 2)
        out = iv(a0).hull(iv(src))
        return out if base != "index_add" else None
    if base == "copy":
        return iv(_arg(node, 1))
    if base in ("zero", "zeros", "zeros_like", "new_zeros"):
        return Interval(0.0, 0.0)
    if base in ("ones", "ones_like", "new_ones"):
        return Interval(1.0, 1.0)
    if base in ("full", "new_full"):
        return iv(_arg(node, 1, "fill_value"))
    if base in ("full_like", "fill"):
        return iv(_arg(node, 1, "fill_value"))
    if base == "scalar_tensor":
        return iv(a0)
    if base == "arange":
        args = [a for a in node.args if isinstance(a, (int, float))]
        if len(args) == 1:
            return Interval(0.0, max(float(args[0]) - 1, 0.0))
        if len(args) >= 2:
            return Interval(float(args[0]), max(float(args[1]) - 1,
                                                float(args[0])))
        return None
    if base in ("rand", "rand_like", "bernoulli", "uniform"):
        return Interval(0.0, 1.0)
    if base == "_to_copy":
        a = iv(a0)
        d = node.kwargs.get("dtype")
        if d is not None and not (d.is_floating_point or d.is_complex) \
                and d != torch.bool and a.finite:
            a = _round_iv(a, math.trunc)  # float -> int truncates
        if d == torch.bool:
            return Interval(0.0, 1.0, a.known)
        return a
    if base in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        a, b = iv(a0), iv(_arg(node, 1))
        if a.lo >= 0.0 and b.lo >= 0.0 and a.finite and b.finite:
            hi = min(a.hi, b.hi) if base == "bitwise_and" else \
                float((1 << int(max(a.hi, b.hi)).bit_length()) - 1)
            return Interval(0.0, hi, a.known and b.known)
        return _dtype_interval(_dtype(node))
    if base in ("__rshift__", "bitwise_right_shift"):
        a, s = iv(a0), iv(_arg(node, 1))
        if a.lo >= 0.0 and a.finite and s.known and s.lo >= 0.0:
            return Interval(0.0, float(int(a.hi) >> int(s.lo)), a.known)
        return _dtype_interval(_dtype(node))
    if base in ("__lshift__", "bitwise_left_shift"):
        a, s = iv(a0), iv(_arg(node, 1))
        if a.lo >= 0.0 and a.finite and s.finite:
            return Interval(0.0, float(int(a.hi) << int(s.hi)), a.known)
        return _dtype_interval(_dtype(node))
    if base == "sum":
        shape = tuple(_val(a0).shape)
        n = _reduction_count(shape, _arg(node, 1, "dim"), ctx)
        return _scaled_sum(iv(a0), n)
    if base in _CONTRACTIONS or base in ("addmm", "baddbmm"):
        x, y = ((_arg(node, 1), _arg(node, 2)) if base in ("addmm", "baddbmm")
                else (a0, _arg(node, 1)))
        k = int(_val(x).shape[-1])
        n = max(k, ctx.env.k_max) if ctx.env is not None else k
        out = _scaled_sum(_imul(iv(x), iv(y)), n)
        return _add(iv(a0), out) if base in ("addmm", "baddbmm") else out
    if base in _COMPARE:
        return Interval(0.0, 1.0)
    if base in ("argmax", "argmin"):
        return Interval(0.0, float(max(_val(a0).numel() - 1, 0)))
    return None  # caller applies the dtype-range fallback


def _check_node(node, ins: Dict, out, ctx: _Ctx, int_acc):
    """Run QL301/302/303 on one node; returns ``out`` with integer results
    clipped to their dtype range (overflow already reported)."""
    name, base = op_name(node), _base(node)

    def iv(x) -> Interval:
        if isinstance(x, torch.fx.Node):
            v = ins.get(x)
            return v if isinstance(v, Interval) else TOP
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            return _point(x)
        return TOP

    # ---- QL303: provably subnormal divisor (FlexRound reciprocal rule)
    if base == "div" and len(node.args) >= 2:
        d, dv = iv(node.args[1]), node.args[1]
        dt = _dtype(dv) if isinstance(dv, torch.fx.Node) else None
        if (d.known and dt is not None and dt.is_floating_point and d.finite
                and 0.0 < d.abs_max < F32_TINY):
            ctx.add_once(("QL303", name), "QL303", "scale-underflow", "error",
                         ctx.where(node),
                         f"divisor interval [{d.lo:.3g}, {d.hi:.3g}] is "
                         "entirely subnormal (< float32 tiny "
                         f"{F32_TINY:.3g}) — this card keeps float32 "
                         "subnormals (no -ftz in kernels/build.py), so "
                         "W/(s1*S2*s3) overflows to inf and the reciprocal "
                         "rule's gradients go inf/NaN; check the EPS "
                         "projection on s1/s2/s3")

    # ---- QL302: clamp bound provably always active
    def _sat(xi: Interval, bound: Interval, side: str, kind: str):
        if not (xi.known and bound.known and xi.finite and bound.finite):
            return
        hit = (side == "low" and xi.hi < bound.lo) or \
              (side == "high" and xi.lo > bound.hi)
        if hit:
            ctx.add_once(("QL302", kind, side), "QL302", "grid-saturation",
                         "error", ctx.where(node),
                         f"{kind}: operand interval [{xi.lo:.4g}, "
                         f"{xi.hi:.4g}] lies entirely beyond the "
                         f"{side} clamp bound [{bound.lo:.4g}, "
                         f"{bound.hi:.4g}] — the quantization grid is "
                         "provably saturated to a constant (scale/zero "
                         "badly calibrated for the declared ranges)")

    args = node.args
    if base in ("maximum", "minimum") and len(args) == 2:
        a, b = iv(args[0]), iv(args[1])
        side = "low" if base == "maximum" else "high"
        if b.lo == b.hi:
            _sat(a, b, side, base)
        elif a.lo == a.hi:
            _sat(b, a, side, base)
    if base in ("clamp", "clip", "clamp_min", "clamp_max") and args:
        x = iv(args[0])
        lo, hi = _clamp_args(node, base)
        if lo is not None:
            _sat(x, iv(lo), "low", "clamp")
        if hi is not None:
            _sat(x, iv(hi), "high", "clamp")

    # ---- QL301: integer interval leaves its dtype range
    outs = out if isinstance(out, list) else [out]
    vals = _val(node)
    vals = list(vals) if isinstance(vals, (list, tuple)) else [vals]
    clipped = []
    contraction = base in _CONTRACTIONS or base in ("addmm", "baddbmm")
    for v, o in zip(vals, outs):
        if not isinstance(v, torch.Tensor) or not isinstance(o, Interval):
            clipped.append(o)
            continue
        d = v.dtype
        scaled = (f" (envelope-scaled to k_max={ctx.env.k_max})"
                  if ctx.env is not None and (contraction or base == "sum")
                  else "")
        if d == torch.float64 and contraction and int_acc(node):
            # the plain W8A8 accumulator: K3's int32 sum, formed in float64
            info = torch.iinfo(torch.int32)
            if o.known and o.finite and (o.lo < info.min or o.hi > info.max
                                         or o.abs_max >= F64_EXACT):
                ctx.add_once(("QL301", name, "f64-acc"), "QL301",
                             "int-overflow", "error", ctx.where(node),
                             f"{name}: integer accumulator interval "
                             f"[{o.lo:.4g}, {o.hi:.4g}]{scaled} exceeds the "
                             "int32 range K3 accumulates in "
                             f"[{info.min}, {info.max}] — integer overflow "
                             "in the kernel")
            elif o.known and o.finite and ctx.env is not None:
                ctx.proofs.append(
                    f"{name}->float64 (the int32 accumulator of K3, "
                    f"csrc/qmatmul_int8.cu): interval [{o.lo:.4g}, "
                    f"{o.hi:.4g}] fits int32 for every K <= "
                    f"{ctx.env.k_max}, and float64 holds it exactly "
                    "(< 2^53)")
            clipped.append(o)
            continue
        if d.is_floating_point or d.is_complex or d == torch.bool:
            clipped.append(o)
            continue
        info = torch.iinfo(d)
        if o.known and o.finite and (o.lo < info.min or o.hi > info.max):
            ctx.add_once(("QL301", name, str(d)), "QL301", "int-overflow",
                         "error", ctx.where(node),
                         f"{name}: value interval [{o.lo:.4g}, {o.hi:.4g}]"
                         f"{scaled} exceeds {str(d).replace('torch.', '')} "
                         f"range [{info.min}, {info.max}] — integer "
                         "overflow; widen the accumulator (int32)")
        elif o.known and o.finite and contraction and ctx.env is not None:
            ctx.proofs.append(
                f"{name}->{str(d).replace('torch.', '')}: accumulator "
                f"interval [{o.lo:.4g}, {o.hi:.4g}] fits for every K <= "
                f"{ctx.env.k_max}")
        clipped.append(o.clip_to(float(info.min), float(info.max)))
    return clipped if isinstance(out, list) else clipped[0]


# ------------------------------------------------------------------ public
def seed_invars(entry: TracedEntry) -> List[Interval]:
    """Initial intervals for the entry's placeholders: declared range glob
    (first match wins), else narrow integer dtype bounds, else unknown
    TOP."""
    out: List[Interval] = []
    for node, label in zip(entry.placeholders, entry.labels):
        iv: Optional[Interval] = None
        for glob, lo, hi in entry.ranges:
            if label_matches(label, glob):
                iv = Interval(float(lo), float(hi))
                break
        if iv is None:
            base = _dtype_interval(_dtype(node))
            iv = base if base.finite else dataclasses.replace(base,
                                                              known=False)
        out.append(iv)
    return out


def check_intervals(entry: TracedEntry) -> Report:
    """Abstract-interpret one traced entry; QL301/302/303 findings plus an
    info-level proof line when an envelope-scaled accumulator fits."""
    from repro_torch.analysis.graph_checks import _int_valued

    rep = Report()
    ctx = _Ctx(entry, rep)
    env: Dict[Any, Any] = dict(zip(entry.placeholders, seed_invars(entry)))
    gm = entry.closed
    memo: Dict = {}

    def int_acc(node) -> bool:
        return _int_valued(node, memo)

    def read(x):
        if x in env:
            return env[x]
        return _fallback(x)

    for node in gm.graph.nodes:
        if node.op == "get_attr":
            env[node] = _const_interval(getattr(gm, node.target, None))
            continue
        if node.op != "call_function":
            continue
        out = _eval_node(node, read, ctx)
        val = _val(node)
        if isinstance(val, (list, tuple)):
            outs = out if isinstance(out, list) and len(out) == len(val) \
                else [None] * len(val)
            out = [o if isinstance(o, Interval) else
                   (_fallback_dtype(v.dtype) if isinstance(v, torch.Tensor)
                    else TOP) for o, v in zip(outs, val)]
        elif not isinstance(out, Interval):
            out = _fallback(node)
        ins = {a: env.get(a) for a in node.all_input_nodes}
        env[node] = _check_node(node, ins, out, ctx, int_acc)
    if ctx.proofs and not rep.errors():
        e = ctx.env
        rep.add("QL301", "int-overflow", "info", f"graph:{entry.name}",
                f"proven: {ctx.proofs[0]}" + (
                    f" (envelope {e.layout!r})" if e else ""))
    return rep


__all__ = ["Interval", "TOP", "check_intervals", "seed_invars"]
