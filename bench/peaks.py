"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates), frozen here so that no later change to the program
moves the yardstick. The card's power limit is read beside them at run
time (``power_limit``): a card set below 700 W runs slower under load."""
from __future__ import annotations

import subprocess
from typing import Dict, Optional

CARD_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12, "int8": 1979e12, "float32": 67e12,
        "hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9,
    },
}


def peaks(card: str) -> Dict[str, float]:
    try:
        return CARD_PEAKS[card]
    except KeyError:
        raise SystemExit(f"bench: no published peaks for the card {card!r} "
                         f"(known: {sorted(CARD_PEAKS)})") from None


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None
