"""Model zoo of the port: the decoder-only transformer (dense, moe, vlm),
the encoder-decoder (encdec) and mamba2 (ssm)."""
