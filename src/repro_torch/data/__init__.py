"""Calibration data of the port (``repro/data``'s counterpart)."""
from repro_torch.data.pipeline import (  # noqa: F401
    CalibrationSet,
    StragglerPolicy,
    SyntheticTokens,
    assemble_global_batch,
)
