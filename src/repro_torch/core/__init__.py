"""Quantization core: configs and rules, the method registry, FlexRound,
LSQ, QTensor export, QuantCtx and the export-only reconstruction driver."""
