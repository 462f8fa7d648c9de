"""Model zoo of the port: the decoder-only transformer (dense, moe, vlm),
the encoder-decoder (encdec), mamba2 (ssm) and RecurrentGemma (hybrid)."""
