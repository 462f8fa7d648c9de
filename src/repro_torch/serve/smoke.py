"""Machine-readable serve-capability probe (port of
``repro/serve/smoke.py``): ``(ok, reason)`` with the reference's stable
``key:detail`` reason strings."""
from __future__ import annotations

from typing import Tuple

OK = "ok"
ENGINE_FAMILIES = ("dense", "moe", "vlm")


def serve_capability(model, *, engine: bool = False,
                     kv_quant: bool = False) -> Tuple[bool, str]:
    """Can ``model`` be served? ``engine=False`` asks only for the plain
    uniform-batch decode loop; ``engine=True`` for the slot-based engine."""
    cfg = model.cfg
    family = getattr(cfg, "family", "?")
    if not hasattr(model, "decode_step"):
        return False, f"no_decode_path:{family}"
    if not engine:
        if kv_quant and family in ("ssm", "hybrid"):
            return False, f"kv_quant_unsupported:{family}"
        if kv_quant and getattr(cfg, "use_mla", False):
            return False, "kv_quant_unsupported:mla"
        return True, OK
    if family not in ENGINE_FAMILIES:
        return False, f"unsupported_family:{family}"
    if getattr(cfg, "use_mla", False):
        return False, "unsupported_layout:mla"
    return True, OK
