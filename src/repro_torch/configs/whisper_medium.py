"""whisper-medium — encoder-decoder backbone; the conv/audio frontend is a
stub [arXiv:2212.04356; hf openai/whisper-medium].

Callers pass precomputed frame embeddings (B, S_enc, d_model) to the
encoder, as in the reference. ``WHISPER_CROSS_LEN`` is the reference's
encoder length for serving (~30 s of frames, divisible by 16).
"""
from repro_torch.configs.base import ArchConfig

WHISPER_CROSS_LEN = 1504

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, enc_layers=24,
    norm="layernorm", act="gelu", frontend="audio_stub")
