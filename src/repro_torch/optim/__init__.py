"""Optimizers (port of ``repro/optim``): Adam over trees of tensors."""
from repro_torch.optim.adam import (AdamConfig, adam_init,  # noqa: F401
                                    adam_update, global_norm)
