"""Quantization configuration: per-quantizer, per-run, and per-site (port of
``repro/core/quant_config.py``; framework-free, kept as a copy because the
port imports nothing of ``repro``).

  ``QuantConfig``   one uniform affine quantizer (bits, symmetry, granularity,
                    observer); ``per_channel`` means one (s1, z) pair per
                    output channel, the last axis of ``W[d_in, d_out]``.
  ``QuantRecipe``   a full PTQ run plus an ordered tuple of ``rules``.
  ``SiteRule``      a glob over site names (``"layers.0.*"``) and recipe-field
  + ``SitePlan``    overrides; ``recipe.resolve(site_name)`` folds the
                    matching rules (later rules win) into a ``SitePlan``.

The standard LLM recipe (W4 body, W8 first and last layers):
``QuantRecipe(w_bits=4, rules=("layers.0.*:w_bits=8", "layers.29.*:w_bits=8"))``.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Any, Mapping, Optional, Tuple

from repro_torch.core import method_api

GRANULARITIES = ("per_tensor", "per_channel")
OBSERVERS = ("minmax", "mse")
SETTINGS = ("brecq", "qdrop")  # activation handling during reconstruction
RECON_UNITS = ("layer", "block")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static description of one uniform affine quantizer."""

    bits: int = 8
    symmetric: bool = False
    granularity: str = "per_tensor"
    channel_axis: int = -1  # output-channel axis of the tensor being quantized
    observer: str = "mse"
    # Leading axes treated as independent sub-tensors (stacked expert weights).
    batch_dims: int = 0

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"granularity {self.granularity!r} not in {GRANULARITIES}")
        if self.observer not in OBSERVERS:
            raise ValueError(f"observer {self.observer!r} not in {OBSERVERS}")
        if not (2 <= self.bits <= 8):
            raise ValueError(f"bits must be in [2, 8], got {self.bits}")

    @property
    def qmin(self) -> int:
        if self.symmetric:
            return -(2 ** (self.bits - 1) - 1)
        return 0

    @property
    def qmax(self) -> int:
        if self.symmetric:
            return 2 ** (self.bits - 1) - 1
        return 2**self.bits - 1

    @property
    def n_levels(self) -> int:
        return self.qmax - self.qmin + 1


# ------------------------------------------------------------ per-site rules
# Recipe fields a SiteRule may override.
RULE_KEYS = ("method", "w_bits", "w_symmetric", "w_granularity", "w_observer",
             "a_bits", "a_symmetric", "lr")

_BOOL_KEYS = ("w_symmetric", "a_symmetric")
_INT_KEYS = ("w_bits",)
_FLOAT_KEYS = ("lr",)


def _coerce(key: str, value: Any) -> Any:
    """Parse a string override value to its typed form (CLI / text rules)."""
    if not isinstance(value, str):
        return value
    v = value.strip()
    if key == "a_bits":
        return None if v.lower() in ("none", "off") else int(v)
    if key in _INT_KEYS:
        return int(v)
    if key in _FLOAT_KEYS:
        return float(v)
    if key in _BOOL_KEYS:
        if v.lower() in ("1", "true", "yes"):
            return True
        if v.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"rule override {key}={v!r} is not a boolean")
    return v


@dataclasses.dataclass(frozen=True)
class SiteRule:
    """One per-site override: glob ``pattern`` over site names + overrides,
    stored as a sorted tuple of (key, value) pairs so rules stay hashable."""

    pattern: str
    overrides: Tuple[Tuple[str, Any], ...]

    def __post_init__(self):
        bad = [k for k, _ in self.overrides if k not in RULE_KEYS]
        if bad:
            raise ValueError(f"rule {self.pattern!r} overrides unknown recipe "
                             f"fields {bad}; allowed: {RULE_KEYS}")

    @classmethod
    def make(cls, pattern: str, **overrides) -> "SiteRule":
        items = tuple(sorted((k, _coerce(k, v)) for k, v in overrides.items()))
        return cls(pattern=pattern, overrides=items)

    @classmethod
    def parse(cls, text: str) -> "SiteRule":
        """Parse ``"glob:key=value[,key=value...]"`` (the CLI ``--rule``
        form), e.g. ``"layers.0.*:w_bits=8"``."""
        pattern, sep, body = text.partition(":")
        if not sep or not pattern or not body:
            raise ValueError(f"rule {text!r} is not of the form "
                             "'glob:key=value[,key=value...]'")
        kv = {}
        for part in body.split(","):
            k, eq, v = part.partition("=")
            if not eq:
                raise ValueError(f"rule {text!r}: override {part!r} has no '='")
            kv[k.strip()] = v
        return cls.make(pattern.strip(), **kv)

    def matches(self, site_name: str) -> bool:
        if fnmatch.fnmatchcase(site_name, self.pattern):
            return True
        # "*.w_up" also matches a prefix-less top-level site "w_up"
        return (self.pattern.startswith("*.")
                and fnmatch.fnmatchcase(site_name, self.pattern[2:]))


@dataclasses.dataclass(frozen=True)
class SitePlan:
    """Fully resolved quantization plan for one weight site."""

    site_name: str
    method: method_api.RoundingMethod
    weight: QuantConfig          # batch_dims already patched for the site
    act: Optional[QuantConfig]   # None => activations stay fp at this site
    lr: float

    def summary(self) -> dict:
        """JSON-able description covering every rule-overridable field."""
        return {"method": self.method.name, "w_bits": self.weight.bits,
                "w_symmetric": self.weight.symmetric,
                "w_granularity": self.weight.granularity,
                "w_observer": self.weight.observer,
                "a_bits": self.act.bits if self.act is not None else None,
                "a_symmetric": (self.act.symmetric
                                if self.act is not None else None),
                "lr": self.lr}

    def cache_key(self) -> Tuple:
        """Hashable, site-name-independent summary of the resolved plan: two
        sites with equal keys quantize identically up to their weights."""
        return (self.method.name, self.weight, self.act, self.lr)


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """A full PTQ run description (paper section 4 experimental setups)."""

    method: str = "flexround"
    setting: str = "qdrop"
    recon: str = "block"

    w_bits: int = 8
    w_symmetric: bool = False
    w_granularity: str = "per_tensor"
    w_observer: str = "mse"

    a_bits: Optional[int] = 8  # None => weight-only quantization
    a_symmetric: bool = False

    iters: int = 500
    lr: float = 3e-3
    lr_lsq: float = 4e-5
    batch_size: int = 8
    drop_prob: float = 0.5  # QDrop: probability of *dropping* activation quant
    seed: int = 0

    # AdaRound regularizer schedule (Nagel et al. 2020 defaults)
    ada_lambda: float = 0.01
    ada_beta_start: float = 20.0
    ada_beta_end: float = 2.0
    ada_warmup: float = 0.2

    # Ordered per-site overrides; later matches win. Entries may be SiteRule
    # objects or "glob:key=value[,...]" strings (parsed on construction).
    rules: Tuple[SiteRule, ...] = ()

    def __post_init__(self):
        if self.method not in method_api.available_methods():
            raise ValueError(f"method {self.method!r} not registered; "
                             f"have {method_api.available_methods()}")
        if self.setting not in SETTINGS:
            raise ValueError(f"setting {self.setting!r} not in {SETTINGS}")
        if self.recon not in RECON_UNITS:
            raise ValueError(f"recon {self.recon!r} not in {RECON_UNITS}")
        rules = tuple(SiteRule.parse(r) if isinstance(r, str) else r
                      for r in self.rules)
        for r in rules:
            m = dict(r.overrides).get("method")
            if m is not None and m not in method_api.available_methods():
                raise ValueError(f"rule {r.pattern!r}: method {m!r} not "
                                 f"registered; have "
                                 f"{method_api.available_methods()}")
        object.__setattr__(self, "rules", rules)

    def resolve(self, site_name: str, site: Any = None, *,
                batch_dims: int = 0) -> SitePlan:
        """Fold all matching rules (last match wins) into a SitePlan.
        ``site`` may be anything with a ``batch_dims`` attribute."""
        if site is not None:
            batch_dims = getattr(site, "batch_dims", batch_dims)
        return _resolve_cached(self, site_name, batch_dims)

    def with_rules(self, *extra) -> "QuantRecipe":
        """New recipe with ``extra`` rules appended (later rules win)."""
        return dataclasses.replace(self, rules=self.rules + tuple(extra))

    def overrides_for(self, site_name: str) -> Mapping[str, Any]:
        out: dict = {}
        for rule in self.rules:
            if rule.matches(site_name):
                out.update(rule.overrides)
        return out

    def weight_qconfig(self) -> QuantConfig:
        """Recipe-default weight quantizer (no per-site rules applied)."""
        return QuantConfig(bits=self.w_bits, symmetric=self.w_symmetric,
                           granularity=self.w_granularity,
                           observer=self.w_observer)

    def act_qconfig(self) -> Optional[QuantConfig]:
        """Recipe-default activation quantizer (see ``weight_qconfig``)."""
        if self.a_bits is None:
            return None
        return QuantConfig(bits=self.a_bits, symmetric=self.a_symmetric,
                           granularity="per_tensor", observer="minmax")


@functools.lru_cache(maxsize=8192)
def _resolve_cached(recipe: QuantRecipe, site_name: str,
                    batch_dims: int) -> SitePlan:
    o = dict(recipe.overrides_for(site_name))
    weight = QuantConfig(
        bits=o.get("w_bits", recipe.w_bits),
        symmetric=o.get("w_symmetric", recipe.w_symmetric),
        granularity=o.get("w_granularity", recipe.w_granularity),
        observer=o.get("w_observer", recipe.w_observer),
        batch_dims=batch_dims,
    )
    a_bits = o.get("a_bits", recipe.a_bits)
    act = None if a_bits is None else QuantConfig(
        bits=a_bits,
        symmetric=o.get("a_symmetric", recipe.a_symmetric),
        granularity="per_tensor",
        observer="minmax",
    )
    return SitePlan(
        site_name=site_name,
        method=method_api.get_method(o.get("method", recipe.method)),
        weight=weight,
        act=act,
        lr=o.get("lr", recipe.lr),
    )
