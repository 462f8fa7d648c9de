"""RoundingMethod protocol + the single method registry (port of
``repro/core/method_api.py``).

A method is a bundle of plain functions over (weight tensor, state dict,
QuantConfig):

    init(w, qcfg, key=None) -> state            dict of tensors
    apply(w, state, qcfg) -> w_hat              differentiable fake-quant
    codes(w, state, qcfg, ste=True) -> q        float integer codes (optional)
    loss_extra(state, qcfg, step, recipe) -> r  regularizer (0 by default);
                                                step: (1,) int64 tensor
    trainable(state) -> {leaf: bool}            which state leaves get grads
    project(state) -> state                     post-step feasibility clamp
    export(w, state, qcfg, dtype=...) -> QTensor  hard integer export

Registering a method makes it valid for ``QuantRecipe`` validation and
per-site rule resolution at once. The port registers the reference's
built-ins: ``adaquant``, ``adaround``, ``flexround`` and ``rtn`` (weights)
and ``lsq`` (activations).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

WEIGHT_REQUIRED = ("init", "apply", "trainable", "project", "export")
ACT_REQUIRED = ("init", "apply", "trainable", "project")
KINDS = ("weight", "activation")


def _zero_loss_extra(state, qcfg, step, recipe):
    import torch

    return torch.zeros((), dtype=torch.float32,
                       device=next(iter(state.values())).device)


@dataclasses.dataclass(frozen=True)
class RoundingMethod:
    """A registered rounding scheme (weight) or activation quantizer."""

    name: str
    kind: str
    init: Callable[..., Any]
    apply: Callable[..., Any]
    trainable: Callable[[Any], Dict[str, bool]]
    project: Callable[[Any], Any]
    loss_extra: Callable[..., Any] = _zero_loss_extra
    codes: Optional[Callable[..., Any]] = None
    export: Optional[Callable[..., Any]] = None

    def __repr__(self) -> str:
        return f"RoundingMethod({self.name!r}, kind={self.kind!r})"


_REGISTRY: Dict[str, RoundingMethod] = {}
_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    """Import the built-in method modules so they self-register (lazy to
    avoid the import cycle method module -> quant_config -> this module)."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    try:
        from repro_torch.core import (adaquant, adaround, flexround,  # noqa: F401
                                      lsq, rtn)
    except BaseException:
        _BUILTINS_LOADED = False  # retry next call instead of caching a
        raise                     # partial registry behind an empty error


def register_method(name: str, kind: str = "weight", override: bool = False):
    """Decorator registering a class, instance or module under ``name``.

    Re-registering an existing name raises unless ``override=True``."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")

    def deco(obj):
        if name in _REGISTRY and not override:
            raise ValueError(f"method {name!r} is already registered; pass "
                             "override=True to replace it")
        impl = obj() if isinstance(obj, type) else obj
        required = WEIGHT_REQUIRED if kind == "weight" else ACT_REQUIRED
        missing = [a for a in required if not callable(getattr(impl, a, None))]
        if missing:
            raise TypeError(
                f"method {name!r} is missing required callables {missing}; "
                f"the RoundingMethod protocol needs {required}")
        _REGISTRY[name] = RoundingMethod(
            name=name,
            kind=kind,
            init=impl.init,
            apply=impl.apply,
            trainable=impl.trainable,
            project=impl.project,
            loss_extra=getattr(impl, "loss_extra", None) or _zero_loss_extra,
            codes=getattr(impl, "codes", None),
            export=getattr(impl, "export", None),
        )
        return obj

    return deco


def get_method(name: str) -> RoundingMethod:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown rounding method {name!r}; "
                       f"have {sorted(_REGISTRY)}") from None


def available_methods(kind: str = "weight") -> Tuple[str, ...]:
    """Registered method names (registration order)."""
    _ensure_builtins()
    return tuple(n for n, m in _REGISTRY.items() if m.kind == kind)
