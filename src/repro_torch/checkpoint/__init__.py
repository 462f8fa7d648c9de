"""Checkpoints of the port (``repro/checkpoint``'s counterpart, in the
port's own format)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    PTQCheckpointer,
    exists,
    load_allocation,
    load_pytree,
    save_allocation,
    save_pytree,
)
